"""Wide trees with row and feature sampling, end to end: ``lgt.train``
(device_type=cpu, every kernel as its plain version) at 255 and 100
leaves (batched growth, K = 16 and 8) with bagging and feature_fraction,
against the JAX package's ``train`` (``tpu_learner="masked"``) on each of
the three paths (per-iteration, fused chunks, super-epochs):

- on a fixture whose first histograms are exact (L2 on integer labels
  without BoostFromAverage: gradients are integers and hessians 1), the
  first tree's model text equals the JAX package's on every path: the
  bagging mask and feature mask of iteration 0 and the batched grower
  agree bit for bit;
- the port's three paths write the same model text, and leave the
  feature_fraction stream where the JAX package's same path leaves it
  (the fused paths draw k masks an epoch up front, also when early
  stopping ends the epoch);
- at widths whose gains stay well separated (40 leaves, K = 16, and 31
  leaves, K = 8) every tree's structure equals the JAX package's on
  every path, early stopping included;
- later trees of a 255-leaf model sum inexact gradients in another order
  than the JAX package, so near-ties deep in the tree break either way
  (the strict grower shows the same at 255 leaves): the best valid
  metrics are held within ``METRIC_RTOL``;
- the wide model round-trips through its text and predicts by the
  engine route as by the host walk;
- GOSS, feature_fraction_bynode and extra_trees train (their parity is
  tests/test_torch_train_sampling.py); with a parameter whose module is
  still to port (DART, monotone constraints, linear trees) they still
  raise, naming ROADMAP A9."""

import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, pin_torch_threads, pin_torch_threads_module, raw_problem)

METRIC_RTOL = 0.02
SAMPLING = {"bagging_fraction": 0.8, "bagging_freq": 3,
            "feature_fraction": 0.8, "verbosity": -1, "max_bin": 31,
            "min_data_in_leaf": 5, "fused_chunk": 4}
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {}, "superepoch": {}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _tree(text, i):
    return text.split("Tree=")[i + 1].split("\n\n")[0]


def _train(mod, params, data, rounds, path, es=0):
    x, y, xv, yv = data
    p = {**SAMPLING, **params, **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y)
    ev = {}
    cbs = [mod.record_evaluation(ev)]
    vs = None
    if path != "fused_chunk":
        vs = [mod.Dataset(xv, yv, reference=tr)]
        if es:
            cbs.append(mod.early_stopping(es, verbose=False))
    bst = mod.train(p, tr, rounds, valid_sets=vs, callbacks=cbs)
    return bst, ev


def _exact_data():
    x, _ = raw_problem(51, n=4000, f=8, task="regression", nan_frac=0.0)
    xv, _ = raw_problem(52, n=1000, f=8, task="regression", nan_frac=0.0)
    y = np.round(2 * x[:, 0] - x[:, 1] + x[:, 2] * x[:, 3]).astype(
        np.float32)
    yv = np.round(2 * xv[:, 0] - xv[:, 1]).astype(np.float32)
    return x, y, xv, yv


@pytest.fixture(scope="module")
def exact_runs():
    data = _exact_data()
    out = {}
    for leaves in (255, 100):
        params = {"objective": "regression", "num_leaves": leaves,
                  "boost_from_average": False, "learning_rate": 0.5,
                  "metric": "l2"}
        for path in PATHS:
            for mod in (lgt, lgb):
                bst, _ = _train(mod, params, data, 4, path)
                out[(leaves, path, mod.__name__)] = bst
    return out


@pytest.mark.parametrize("leaves", [255, 100])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_first_tree_equals_jax(exact_runs, leaves, path):
    bt = exact_runs[(leaves, path, "lightgbm_torch")]
    bj = exact_runs[(leaves, path, "lightgbm_tpu")]
    assert bt.num_trees() == bj.num_trees() == 4
    t0 = _tree(bt.model_to_string(), 0)
    assert t0 == _tree(bj.model_to_string(), 0)
    assert f"num_leaves={leaves}" in t0
    # the fused paths consumed the feature_fraction stream as the JAX
    # package's same path did
    st, sj = bt._model._rng_feat.get_state(), bj._model._rng_feat.get_state()
    assert st[2] == sj[2] and np.array_equal(st[1], sj[1])


@pytest.mark.parametrize("leaves", [255, 100])
def test_paths_write_the_same_model(exact_runs, leaves):
    texts = {p: _norm(exact_runs[(leaves, p, "lightgbm_torch")]
                      .model_to_string()) for p in PATHS}
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]
    model = exact_runs[(leaves, "superepoch", "lightgbm_torch")]._model
    assert model.split_batch == (16 if leaves == 255 else 8)


def _noisy_binary():
    x, y = raw_problem(61, n=6000, f=10, task="binary", nan_frac=0.0)
    xv, yv = raw_problem(62, n=1500, f=10, task="binary", nan_frac=0.0)
    rs = np.random.RandomState(63)
    y = np.where(rs.rand(len(y)) < 0.2, 1 - y, y).astype(np.float32)
    return x, y, xv, yv


@pytest.fixture(scope="module")
def es_runs():
    data = _noisy_binary()
    params = {"objective": "binary", "num_leaves": 255,
              "learning_rate": 0.3, "metric": ["auc", "binary_logloss"]}
    return {(path, mod.__name__): _train(mod, params, data, 24, path, es=3)
            for path in ("per_iteration", "superepoch")
            for mod in (lgt, lgb)}


def test_early_stopping_paths_and_streams(es_runs):
    (bp, evp), (bs, evs) = es_runs[("per_iteration", "lightgbm_torch")], \
        es_runs[("superepoch", "lightgbm_torch")]
    assert 3 < bp.best_iteration < 21        # stopped inside an epoch
    assert bp.best_iteration == bs.best_iteration
    assert _norm(bp.model_to_string()) == _norm(bs.model_to_string())
    for name, vals in evs["valid_0"].items():
        np.testing.assert_allclose(vals, evp["valid_0"][name], rtol=1e-6)
    # per-iteration: one mask per iteration; super-epochs: k = 4 masks per
    # dispatched epoch, the whole last epoch included
    iters = len(evp["valid_0"]["auc"])
    epochs = -(-iters // 4)
    for bst, draws in ((bp, iters), (bs, 4 * epochs)):
        rs = np.random.RandomState(SAMPLING.get("feature_fraction_seed", 2))
        for _ in range(draws):
            rs.choice(10, size=8, replace=False)
        st = bst._model._rng_feat.get_state()
        assert st[2] == rs.get_state()[2] \
            and np.array_equal(st[1], rs.get_state()[1])


@pytest.mark.parametrize("path", ["per_iteration", "superepoch"])
def test_wide_metrics_close_to_jax(es_runs, path):
    (bt, evt), (bj, evj) = es_runs[(path, "lightgbm_torch")], \
        es_runs[(path, "lightgbm_tpu")]
    for name, best in (("auc", max), ("binary_logloss", min)):
        a, b = best(evt["valid_0"][name]), best(evj["valid_0"][name])
        assert abs(a - b) <= METRIC_RTOL * abs(b), (name, a, b)


STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")


def _structure(text):
    return [ln for ln in text.split("end of trees")[0].splitlines()
            if ln.split("=")[0] in STRUCTURAL]


@pytest.mark.parametrize("leaves,k", [(40, 16), (31, 8)])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_separated_gains_trees_equal_jax(leaves, k, path):
    data = _noisy_binary()
    params = {"objective": "binary", "num_leaves": leaves, "split_batch": k,
              "learning_rate": 0.3, "min_data_in_leaf": 20,
              "metric": ["auc", "binary_logloss"]}
    (bt, evt), (bj, evj) = (_train(mod, params, data, 10, path, es=3)
                            for mod in (lgt, lgb))
    assert bt._model.split_batch == k
    assert bt.best_iteration == bj.best_iteration
    st, sj = _structure(bt.model_to_string()), \
        _structure(bj.model_to_string())
    assert len(st) == 8 * bt.num_trees() and st == sj
    # leaf values agree to the last bits, so the logloss agrees closely;
    # the AUC of a 40-leaf model's few distinct scores moves where rows
    # tie in one package and not in the other
    for name, tol in (("binary_logloss", {"rtol": 1e-5}),
                      ("auc", {"atol": 5e-4})):
        if path != "fused_chunk":
            np.testing.assert_allclose(evt["valid_0"][name],
                                       evj["valid_0"][name], **tol)


def test_regression_fused_chunks_close_to_jax():
    x, y = raw_problem(71, n=5000, f=8, task="regression", nan_frac=0.02)
    data = (x, y, None, None)
    params = {"objective": "regression", "num_leaves": 100,
              "learning_rate": 0.2, "pos_bagging_fraction": 1.0}
    bt, _ = _train(lgt, params, data, 8, "fused_chunk")
    bj, _ = _train(lgb, params, data, 8, "fused_chunk")
    pt, pj = bt.predict(x), np.asarray(bj.predict(x))
    l2t, l2j = np.mean((pt - y) ** 2), np.mean((pj - y) ** 2)
    assert abs(l2t - l2j) <= METRIC_RTOL * l2j
    assert bt._model.split_batch == 8
    assert max(t.num_leaves for t in bt._model.models) == 100


def test_wide_model_round_trip_and_engine(es_runs):
    bst, _ = es_runs[("superepoch", "lightgbm_torch")]
    x, _ = raw_problem(62, n=1500, f=10, task="binary", nan_frac=0.0)
    text = bst.model_to_string()
    assert max(t.num_leaves for t in bst._model.models) == 255
    again = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    trees = text.split("\nTree=", 1)[1].split("end of trees")[0]
    assert again.model_to_string().split("\nTree=", 1)[1].split(
        "end of trees")[0] == trees
    np.testing.assert_array_equal(
        again.predict(x, raw_score=True),
        bst.predict(x, raw_score=True, num_iteration=-1))
    old = again.config.predict_bucketed
    again.config.predict_bucketed = "true"
    try:
        eng = again.predict(x, raw_score=True)
    finally:
        again.config.predict_bucketed = old
    np.testing.assert_array_equal(eng, host_walk(again, x, raw_score=True))
    np.testing.assert_allclose(
        np.asarray(lgb.Booster(model_str=text).predict(x, raw_score=True)),
        eng, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("params", [
    {"data_sample_strategy": "goss", "boosting": "dart"},
    {"feature_fraction_bynode": 0.5, "monotone_constraints": [1, 0, 0, 0],
     "linear_tree": True},
    {"extra_trees": True, "linear_tree": True},
])
def test_remaining_sampling_raises(params):
    x, y = raw_problem(4, n=400, f=4)
    with pytest.raises(NotImplementedError, match="A9"):
        lgt.train({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu", "num_leaves": 255, **SAMPLING,
                   **params}, lgt.Dataset(x, y), 2)
