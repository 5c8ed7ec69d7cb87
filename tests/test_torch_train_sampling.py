"""GOSS, feature_fraction_bynode and extra_trees end to end: ``lgt.train``
(device_type=cpu, every kernel as its plain version) against the JAX
package's ``train`` (``tpu_learner="masked"``) on each of the three paths
(per-iteration, fused chunks, super-epochs), each against the JAX
package's same path:

- at 31 leaves (the strict grower) on a binary problem whose gains stay
  well separated, every tree's structure equals the JAX package's on
  every path and the valid logloss and AUC agree to ``LOGLOSS_RTOL`` and
  ``AUC_ATOL``: GOSS's weights
  (keyed by ``PRNGKey(bagging_seed + it)``), the per-child masks and the
  random bins of every iteration agree with the JAX package's;
- at 255 leaves (the batched grower, K = 16) on a fixture whose first
  histograms are exact (L2 on integer labels without BoostFromAverage),
  the first tree's model text equals the JAX package's on every path;
  later trees sum inexact leaf values in another order, so near-ties
  deep in the tree break either way, and GOSS's threshold, on which whole
  leaves of rows tie, moves with the last bits of the previous tree's
  leaf values: the best valid l2 is held within ``METRIC_RTOL`` (the
  final one moves by several percent with GOSS's seed alone);
- the port's three paths write the same model text;
- GOSS with bagging parameters trains as GOSS alone (GOSS turns bagging
  off, as in the JAX package), and L2 with all three on equals the JAX
  package's trees;
- categorical features and multiclass train under GOSS and
  extra_trees."""

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module, raw_problem)

# leaf values agree to the last bits, so the logloss agrees closely; the
# AUC of a 31-leaf model's few distinct scores moves where rows tie in one
# package and not in the other
LOGLOSS_RTOL = 1e-5
AUC_ATOL = 5e-4
METRIC_RTOL = 0.02
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {}, "superepoch": {}}
MODES = {"goss": {"data_sample_strategy": "goss"},
         "bynode": {"feature_fraction_bynode": 0.6},
         "extra": {"extra_trees": True, "extra_seed": 11}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(text):
    return [ln for ln in text.split("end of trees")[0].splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _iteration0_ties(env):
    """Before the port's first per-iteration step: every row of one label
    must get one (g, h) from the iteration-0 score, since every row starts
    from the same BoostFromAverage bias.  The check adds the bias to the
    model's own score buffer as ``_boost_from_average`` does, takes the
    gradients from it, and takes the bias off again (0 + b - b is 0
    exactly).  On failure it names the distinct score and label values,
    the (g, h) of each label and the buffers' addresses, so a recurrence
    shows whether the score, the label or the gradient pass went wrong."""
    if env.iteration != 0:
        return
    m = env.model._model
    obj = m.objective
    if obj is None or m.iter_ != 0:
        return
    bias = torch.tensor(obj.boost_from_score(0), dtype=torch.float32)
    before = torch.unique(m.score).tolist()
    m.score += bias
    biased = torch.unique(m.score).tolist()
    g, h = obj.get_gradients(m.score)
    m.score -= bias
    label = obj.label
    split = {}
    for v in torch.unique(label).tolist():
        rows = label == v
        gh = torch.stack([g[rows].reshape(-1), h[rows].reshape(-1)], 1)
        vals, counts = torch.unique(gh, dim=0, return_counts=True)
        if len(vals) > 1:
            split[v] = list(zip(vals.tolist(), counts.tolist()))

    def where(t):
        return f"{t.data_ptr():#x} (mod 64: {t.data_ptr() % 64})"
    assert not split and len(before) == 1 and len(biased) == 1, (
        f"iteration-0 gradients not tied within a label: score before the "
        f"bias {before}, after {biased}, labels "
        f"{torch.unique(label).tolist()}, (g, h) by label {split}; score "
        f"at {where(m.score)}, label at {where(label)}, g at {where(g)}, "
        f"h at {where(h)}, torch threads {torch.get_num_threads()}")


_iteration0_ties.before_iteration = True


def _train(mod, params, data, rounds, path):
    x, y, xv, yv = data
    p = {"verbosity": -1, "max_bin": 31, "fused_chunk": 3, **params,
         **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y)
    ev = {}
    vs = None
    if path != "fused_chunk":
        vs = [mod.Dataset(xv, yv, reference=tr)]
    cbs = [mod.record_evaluation(ev)]
    if mod is lgt and path == "per_iteration":
        cbs.append(_iteration0_ties)
    bst = mod.train(p, tr, rounds, valid_sets=vs, callbacks=cbs)
    return bst, ev


def _binary():
    # six features, two of them noise: deep gains stay separated in every
    # mode (with more noise features, near-ties between them break
    # either way in one mode or another)
    x, y = raw_problem(61, n=6000, f=6, task="binary", nan_frac=0.0)
    xv, yv = raw_problem(62, n=1500, f=6, task="binary", nan_frac=0.0)
    return x, y, xv, yv


BINARY = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.3,
          "min_data_in_leaf": 20, "metric": ["auc", "binary_logloss"]}


@pytest.fixture(scope="module")
def strict_runs():
    data = _binary()
    return {(mode, path, mod.__name__): _train(
        mod, {**BINARY, **MODES[mode]}, data, 5, path)
        for mode in MODES for path in PATHS for mod in (lgt, lgb)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_strict_trees_equal_jax(strict_runs, mode, path):
    (bt, evt), (bj, evj) = strict_runs[(mode, path, "lightgbm_torch")], \
        strict_runs[(mode, path, "lightgbm_tpu")]
    assert bt.num_trees() == bj.num_trees() == 5
    st, sj = _structure(bt.model_to_string()), \
        _structure(bj.model_to_string())
    assert len(st) == 8 * 5 and st == sj
    if path != "fused_chunk":
        np.testing.assert_allclose(evt["valid_0"]["binary_logloss"],
                                   evj["valid_0"]["binary_logloss"],
                                   rtol=LOGLOSS_RTOL)
        np.testing.assert_allclose(evt["valid_0"]["auc"],
                                   evj["valid_0"]["auc"], atol=AUC_ATOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_strict_paths_write_the_same_model(strict_runs, mode):
    texts = {p: _norm(strict_runs[(mode, p, "lightgbm_torch")][0]
                      .model_to_string()) for p in PATHS}
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]
    # the mode changed the trees
    plain = _norm(strict_runs[("goss" if mode != "goss" else "bynode",
                               "superepoch", "lightgbm_torch")][0]
                  .model_to_string())
    assert _trees(texts["superepoch"]) != _trees(plain)


def _exact():
    x, _ = raw_problem(51, n=4000, f=8, task="regression", nan_frac=0.0)
    xv, _ = raw_problem(52, n=1000, f=8, task="regression", nan_frac=0.0)
    y = np.round(2 * x[:, 0] - x[:, 1] + x[:, 2] * x[:, 3]).astype(
        np.float32)
    yv = np.round(2 * xv[:, 0] - xv[:, 1]).astype(np.float32)
    return x, y, xv, yv


WIDE = {"objective": "regression", "num_leaves": 255, "learning_rate": 0.5,
        "boost_from_average": False, "min_data_in_leaf": 5, "metric": "l2"}


@pytest.fixture(scope="module")
def wide_runs():
    data = _exact()
    return {(mode, path, mod.__name__): _train(
        mod, {**WIDE, **MODES[mode]}, data, 3, path)
        for mode in MODES for path in PATHS for mod in (lgt, lgb)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_wide_first_tree_equals_jax(wide_runs, mode, path):
    (bt, evt), (bj, evj) = wide_runs[(mode, path, "lightgbm_torch")], \
        wide_runs[(mode, path, "lightgbm_tpu")]
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 3
    assert tt[0] == tj[0] and "num_leaves=255" in tt[0]
    assert bt._model.split_batch == 16
    if path != "fused_chunk":
        a, b = min(evt["valid_0"]["l2"]), min(evj["valid_0"]["l2"])
        assert abs(a - b) <= METRIC_RTOL * b, (a, b)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_wide_paths_write_the_same_model(wide_runs, mode):
    texts = [_norm(wide_runs[(mode, p, "lightgbm_torch")][0]
                   .model_to_string()) for p in PATHS]
    assert texts[0] == texts[1] == texts[2]


def test_goss_turns_bagging_off():
    data = _binary()
    goss = {**BINARY, **MODES["goss"]}
    bag = {**goss, "bagging_fraction": 0.5, "bagging_freq": 1,
           "pos_bagging_fraction": 0.7}
    bt, _ = _train(lgt, bag, data, 4, "superepoch")
    bj, _ = _train(lgb, bag, data, 4, "superepoch")
    b0, _ = _train(lgt, goss, data, 4, "superepoch")
    m = bt._model
    assert m._goss and m._bagging_active and not m._use_bagging
    assert m.bag_positive is None
    assert _structure(bt.model_to_string()) \
        == _structure(bj.model_to_string())
    assert _trees(bt.model_to_string()) == _trees(b0.model_to_string())
    prog = next(iter(m._programs.values()))
    assert prog.goss and not prog.bagging and prog.keyed


@pytest.mark.parametrize("path", ["per_iteration", "superepoch"])
def test_l2_all_three_equal_jax(path):
    x, y = raw_problem(71, n=5000, f=8, task="regression", nan_frac=0.02)
    xv, yv = raw_problem(72, n=1000, f=8, task="regression", nan_frac=0.02)
    params = {"objective": "regression", "num_leaves": 15,
              "learning_rate": 0.3, "min_data_in_leaf": 30, "metric": "l2",
              "data_sample_strategy": "goss", "top_rate": 0.3,
              "other_rate": 0.2, "feature_fraction_bynode": 0.7,
              "extra_trees": True, "feature_fraction": 0.9}
    (bt, evt), (bj, evj) = (_train(mod, params, (x, y, xv, yv), 5, path)
                            for mod in (lgt, lgb))
    assert bt._model.node_sampling.bynode \
        and bt._model.node_sampling.extra_trees
    assert _structure(bt.model_to_string()) \
        == _structure(bj.model_to_string())
    np.testing.assert_allclose(evt["valid_0"]["l2"], evj["valid_0"]["l2"],
                               rtol=1e-5)


@pytest.mark.parametrize("what", ["categorical", "multiclass"])
def test_categorical_and_multiclass_still_raise(what):
    """Categorical features and multiclass both train under GOSS and
    extra_trees (neither raises any more): the categorical model splits
    on the categorical column; the multiclass model grows three trees an
    iteration, the first iteration's equal to the JAX package's."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 5, size=(400, 3)).astype(np.float64)
    params = {"verbosity": -1, "device_type": "cpu", **MODES["goss"],
              "extra_trees": True}
    if what == "categorical":
        params.update(objective="binary", min_data_per_group=10,
                      min_data_in_leaf=5)
        ds = lgt.Dataset(x, np.isin(x[:, 0], (1, 3)).astype(np.float32),
                         categorical_feature=[0])
        bst = lgt.train(params, ds, 2)
        assert "cat_threshold=" in bst.model_to_string()
        return
    # the label is a function of column 0: gains past its splits are
    # rounding residue, which min_gain_to_split keeps out of the trees
    params.update(objective="multiclass", num_class=3, min_data_in_leaf=5,
                  min_gain_to_split=1.0)
    bt = lgt.train(params, lgt.Dataset(x, x[:, 0] % 3), 2)
    bj = lgb.train({**params, "device_type": "cpu", "tpu_learner": "masked"},
                   lgb.Dataset(x, x[:, 0] % 3), 2)
    assert bt.num_trees() == bj.num_trees() == 6
    first = [_structure("Tree=" + t) for t in _trees(bt.model_to_string())]
    assert first[:3] == [_structure("Tree=" + t)
                         for t in _trees(bj.model_to_string())][:3]
    assert all("num_leaves=1" not in t for t in first[:3])
