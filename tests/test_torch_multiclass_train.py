"""Multiclass training end to end: ``lgt.train`` (device_type=cpu, every
kernel as its plain version) against the JAX package's ``train``
(``tpu_learner="masked"``) with ``objective=multiclass`` (softmax) and
``multiclassova`` at K = 3, on the per-iteration path the JAX package
takes for every multiclass run:

- on a fixture whose split gains are well separated, every tree's
  structure (integer arrays and the model text's structural lines)
  equals the JAX package's at 31 leaves (the strict grower) and at 40
  leaves (batched, K = 8), and the valid multi_logloss and multi_error
  agree within ``METRIC_RTOL_TIGHT``: both packages take the host metric
  on f32 scores that agree to their last bits;
- with exact gradients (a custom objective rounding the softmax gradient
  to a multiple of 1/8, hessians 1) every sum is exact in both packages,
  so the whole model text equals the JAX package's, at 31, 40 and 255
  leaves (K = 16), with the gradients as [N, K] or flat class-major;
- at 255 leaves with the softmax objective the first 64 splits of the
  first iteration's K trees equal the JAX package's (deeper down,
  candidates of one super-step tie to 1e-6 relative on gradients that
  round differently in the two packages), and the best valid
  multi_logloss stays within ``METRIC_RTOL`` (ROADMAP C: multi-tree
  equality at 255 leaves is no oracle);
- ``fused_eval=true`` reports the traced multi_logloss (B12c's plain
  version, f32) within ``TRACED_RTOL`` of the host values (the fixture
  keeps every label's probability above the traced clip, 1e-7) and grows
  the same trees; ``fused_chunk``/``superepoch`` settings keep the
  per-iteration path, and ``fused_reasons()`` names ``num_class``;
- with bagging, GOSS, feature_fraction, feature_fraction_bynode with
  extra_trees, or a categorical column, the first iteration's K trees
  equal the JAX package's (one bagging and one feature mask an
  iteration, GOSS per class, every draw keyed by the iteration), and
  the valid multi_logloss after five iterations is within
  ``METRIC_RTOL``."""

import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    multiclass_problem, pin_torch_threads, pin_torch_threads_module)

K = 3
# host metrics on scores equal to the last bits of their leaf values
METRIC_RTOL_TIGHT = 1e-5
# the traced f32 multi_logloss against the host metric (f32 numpy ops in
# another order)
TRACED_RTOL = 1e-5
# metrics of models whose later trees may break near-ties either way
METRIC_RTOL = 0.02
PER_ITERATION = {"superepoch": -1, "fused_chunk": 1}
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
METRICS = ["multi_logloss", "multi_error"]


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(tree_text):
    return [ln for ln in tree_text.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _data(seed=21, n=6000, nv=800, f=6, nan_frac=0.0):
    x, y = multiclass_problem(seed, n=n, f=f, k=K, nan_frac=nan_frac)
    xv, yv = multiclass_problem(seed + 1, n=nv, f=f, k=K, nan_frac=nan_frac)
    return x, y, xv, yv


def _train(mod, params, data, rounds, fobj=None, valid=True, **kw):
    x, y, xv, yv = data
    p = {"verbosity": -1, "max_bin": 31, "num_class": K,
         "metric": METRICS, **PER_ITERATION, **params}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y, **kw)
    ev = {}
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid else None
    bst = mod.train(p, tr, rounds, valid_sets=vs, fobj=fobj,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


def _softmax(s):
    e = np.exp(s - s.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _exact_softmax(preds, ds, flat=False):
    """The softmax gradient rounded to a multiple of 1/8, hessian 1: every
    histogram, prefix and leaf sum is exact in both packages."""
    y = np.asarray(ds.get_label()).astype(int)
    p = _softmax(np.asarray(preds, np.float64))
    g = np.round(8.0 * (p - np.eye(K)[y])) / 8.0
    h = np.ones_like(g)
    if flat:      # class-major, as the reference's C API lays them out
        return g.T.reshape(-1), h.T.reshape(-1)
    return g, h


def _exact_flat(preds, ds):
    return _exact_softmax(preds, ds, flat=True)


# leaves of at least 60 rows: a 31- or 40-leaf tree's last splits stay
# well above the rounding of the two packages' softmax gradients
SOFTMAX = {"objective": "multiclass", "learning_rate": 0.3,
           "min_data_in_leaf": 60}
OVA = {**SOFTMAX, "objective": "multiclassova"}
LEAVES = {"strict31": 31, "batched40": 40}


@pytest.fixture(scope="module")
def separated_runs():
    data = _data()
    return {(obj, lv, mod.__name__): _train(
        mod, {**params, "num_leaves": LEAVES[lv]}, data, 5)
        for obj, params in (("multiclass", SOFTMAX), ("multiclassova", OVA))
        for lv in LEAVES for mod in (lgt, lgb)}


@pytest.mark.parametrize("leaves", sorted(LEAVES))
@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
def test_trees_equal_jax(separated_runs, obj, leaves):
    (bt, evt), (bj, evj) = separated_runs[(obj, leaves, "lightgbm_torch")], \
        separated_runs[(obj, leaves, "lightgbm_tpu")]
    assert bt.num_trees() == bj.num_trees() == 5 * K
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert [_structure(t) for t in tt] == [_structure(t) for t in tj]
    # the integer arrays of every tree
    for a, b in zip(bt.trees, bj.trees):
        for f in ("split_feature", "threshold_bin", "decision_type",
                  "left_child", "right_child", "leaf_count",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    want_split_batch = 1 if LEAVES[leaves] < 64 else 8
    assert bt._model.split_batch == want_split_batch
    for m in METRICS:
        np.testing.assert_allclose(evt["valid_0"][m], evj["valid_0"][m],
                                   rtol=METRIC_RTOL_TIGHT)
    assert evt["valid_0"]["multi_logloss"][-1] \
        < evt["valid_0"]["multi_logloss"][0]


@pytest.mark.parametrize("leaves", [31, 40, 255])
def test_exact_gradients_give_the_jax_model_text(leaves):
    data = _data(31)
    params = {"objective": "custom", "num_leaves": leaves,
              "learning_rate": 0.5, "min_data_in_leaf": 5,
              "metric": "multi_logloss"}
    bt, evt = _train(lgt, params, data, 4, fobj=_exact_softmax)
    bj, evj = _train(lgb, params, data, 4, fobj=_exact_softmax)
    assert bt.num_trees() == 4 * K
    assert _trees(bt.model_to_string()) == _trees(bj.model_to_string())
    np.testing.assert_array_equal(evt["valid_0"]["multi_logloss"],
                                  evj["valid_0"]["multi_logloss"])
    if leaves == 31:
        # flat class-major gradients train the same model
        bf, _ = _train(lgt, params, data, 4, fobj=_exact_flat)
        assert bf.model_to_string() == bt.model_to_string()


def test_wide_softmax_top_of_the_trees_equals_jax():
    data = _data(41)
    params = {**SOFTMAX, "num_leaves": 255, "min_data_in_leaf": 5}
    (bt, evt), (bj, evj) = (_train(mod, params, data, 4)
                            for mod in (lgt, lgb))
    assert bt._model.split_batch == 16
    assert bt.num_trees() == bj.num_trees() == 4 * K
    # the first four super-steps (64 splits) of each class's first tree:
    # deeper down, candidates tie to 1e-6 and break either way
    for a, b in zip(bt.trees[:K], bj.trees[:K]):
        assert a.num_leaves == b.num_leaves == 255
        for f in ("split_feature", "threshold_bin"):
            np.testing.assert_array_equal(getattr(a, f)[:64],
                                          getattr(b, f)[:64])
    a, b = min(evt["valid_0"]["multi_logloss"]), \
        min(evj["valid_0"]["multi_logloss"])
    assert abs(a - b) <= METRIC_RTOL * b, (a, b)


@pytest.mark.parametrize("obj", ["multiclass", "multiclassova"])
def test_fused_eval_reports_the_traced_metric(separated_runs, obj):
    data = _data()
    params = {**(SOFTMAX if obj == "multiclass" else OVA),
              "num_leaves": 31, "fused_eval": "true",
              "metric": "multi_logloss"}
    bt, evt = _train(lgt, params, data, 5)
    host, _ = separated_runs[(obj, "strict31", "lightgbm_torch")]
    host_ev = separated_runs[(obj, "strict31", "lightgbm_torch")][1]
    assert _norm(bt.model_to_string()).split("parameters:")[0] \
        == _norm(host.model_to_string()).split("parameters:")[0]
    assert bt._model.fetch_counts == {"tree": 5, "traced_eval": 5}
    traced = evt["valid_0"]["multi_logloss"]
    # the traced metric clips the label's probability at 1e-7 and the host
    # one at 1e-15: on this fixture no valid row gets past 1e-7, so the
    # two agree
    m = bt._model
    s = m.valid_score(0).astype(np.float64)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    assert p[np.arange(len(s)), data[3].astype(int)].min() > 1e-7
    np.testing.assert_allclose(traced, host_ev["valid_0"]["multi_logloss"],
                               rtol=TRACED_RTOL)
    # the reported values are the traced kernel's own
    want = float(lgt.metrics.traced_multi_logloss(
        m.valid_sets[0][2], *m.valid_ops(0)))
    assert traced[-1] == want
    # and within TRACED_RTOL of the JAX package's host values (its own
    # fused_eval=true run hands its traced multi_logloss one column of
    # the scores and raises: ROADMAP C)
    jax_ev = separated_runs[(obj, "strict31", "lightgbm_tpu")][1]
    np.testing.assert_allclose(traced, jax_ev["valid_0"]["multi_logloss"],
                               rtol=TRACED_RTOL)


@pytest.mark.parametrize("paths", [{}, {"superepoch": 4},
                                   {"fused_chunk": 3, "superepoch": 0}])
def test_fused_settings_keep_the_per_iteration_path(separated_runs, paths):
    data = _data()
    x, y, _, _ = data
    params = {**SOFTMAX, "num_leaves": 31, "verbosity": -1,
              "device_type": "cpu", "num_class": K, "max_bin": 31,
              "metric": METRICS, **paths}
    # with and without a valid set
    for valid in (True, False):
        tr = lgt.Dataset(x, y)
        vs = [lgt.Dataset(data[2], data[3], reference=tr)] if valid \
            else None
        bst = lgt.train(params, tr, 5, valid_sets=vs)
        m = bst._model
        assert not m.supports_fused() and not m._programs.get(
            ((), "None")).graph
        assert any("num_class=3" in r for r in bst.fused_reasons())
        assert m.fetch_counts["tree"] == 5
        assert "epoch" not in m.fetch_counts
    host, _ = separated_runs[("multiclass", "strict31", "lightgbm_torch")]
    assert _trees(bst.model_to_string()) == _trees(host.model_to_string())
    with pytest.raises(ValueError, match="num_class"):
        m.train_chunk(2)


def test_early_stopping_on_multi_logloss():
    data = _data(51, nv=600)
    params = {**SOFTMAX, "num_leaves": 31, "learning_rate": 0.8,
              "early_stopping_round": 3, "metric": "multi_logloss"}
    (bt, evt), (bj, evj) = (_train(mod, params, data, 60)
                            for mod in (lgt, lgb))
    assert 0 < bt.best_iteration == bj.best_iteration < 60
    assert bt.current_iteration == bj.current_iteration \
        == bt.best_iteration + 3
    assert bt.num_trees() == K * bt.current_iteration
    np.testing.assert_allclose(evt["valid_0"]["multi_logloss"],
                               evj["valid_0"]["multi_logloss"],
                               rtol=METRIC_RTOL_TIGHT)


COMPOSE = {
    "bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
    "goss": {"data_sample_strategy": "goss", "top_rate": 0.3,
             "other_rate": 0.2},
    "feature_fraction": {"feature_fraction": 0.7},
    "bynode_extra": {"feature_fraction_bynode": 0.7, "extra_trees": True,
                     "extra_seed": 3},
    "categorical": {"min_data_per_group": 20},
}


@pytest.mark.parametrize("mode", sorted(COMPOSE))
def test_sampling_and_categorical_compose(mode):
    x, y, xv, yv = _data(61, n=4000)
    kw = {}
    if mode == "categorical":
        # the last column as 8 categories that move class 2
        for a, lab in ((x, y), (xv, yv)):
            a[:, 5] = np.floor(np.abs(a[:, 5]) * 3) % 8
        rs = np.random.RandomState(62)
        flip = rs.rand(len(y)) < 0.3
        y[flip & np.isin(x[:, 5], (1, 4, 6))] = 2
        kw["categorical_feature"] = [5]
    params = {**SOFTMAX, "num_leaves": 15, "metric": "multi_logloss",
              **COMPOSE[mode]}
    data = (x, y, xv, yv)
    (bt, evt), (bj, evj) = (_train(mod, params, data, 5, **kw)
                            for mod in (lgt, lgb))
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 5 * K
    assert [_structure(t) for t in tt[:K]] == \
        [_structure(t) for t in tj[:K]]
    if mode == "categorical":
        assert "cat_threshold=" in bt.model_to_string()
    a, b = evt["valid_0"]["multi_logloss"][-1], \
        evj["valid_0"]["multi_logloss"][-1]
    assert abs(a - b) <= METRIC_RTOL * b, (a, b)
