"""Categorical training end to end: ``lgt.train`` (device_type=cpu, every
kernel as its plain version) on an airline-shaped set (Month, DayofMonth,
DayOfWeek, UniqueCarrier, Origin and Dest categorical, DepTime and
Distance numerical) against the JAX package's ``train``
(``tpu_learner="masked"``):

- with exact gradients (a custom L2 objective rounding each gradient to a
  multiple of 1/8, hessians 1) every histogram and prefix sum is exact in
  both packages, so every tree's model text, ``cat_boundaries`` and
  ``cat_threshold`` included, equals the JAX package's: on the strict
  grower (15 leaves; with ``feature_fraction_bynode`` too, and with other
  categorical parameters) and on the batched one (64 leaves, K = 8; 255,
  K = 16);
- binary at 64 leaves (split_batch auto -> 8) without BoostFromAverage
  (first gradients +-0.5, hessians 0.25: exact): the first tree equals the
  JAX package's on each path, and the valid metric stays within
  ``METRIC_RTOL`` (later trees sum inexact gradients in another order, so
  near-equal category ratios may order either way);
- the three paths (per-iteration, fused chunks, super-epochs) write the
  same model text within the port;
- categories unseen in training, negative and NaN ones go right at
  predict, as in the JAX package; the model round-trips through its text;
  the predictor engine, ``fused_predict`` and the ``Server`` on both
  binning settings answer as the host walk;
- a valid set added after training replays the trees without the
  BoostFromAverage bias, as the JAX package's ``add_valid_set``."""

import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.serve import Server

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, pin_torch_threads, pin_torch_threads_module, raw_problem)

METRIC_RTOL = 0.02
CAT_COLS = [0, 1, 2, 3, 4, 5]
CARDS = (12, 31, 7, 22, 60, 60)
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 4}, "superepoch": {"fused_chunk": 4}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")


def airline(seed, n, task="binary"):
    """Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin, Dest (Zipf-
    skewed airports) as integer categories, DepTime and Distance, and a
    label from seeded per-category effects."""
    rs = np.random.RandomState(seed)
    eff = np.random.RandomState(1000)
    x = np.zeros((n, 8))
    logit = np.zeros(n)
    for j, c in enumerate(CARDS):
        p = 1.0 / np.arange(1, c + 1) ** (1.1 if j >= 4 else 0.3)
        col = rs.choice(c, size=n, p=p / p.sum())
        x[:, j] = col
        logit += (1.5 if j in (3, 4) else 0.8) * eff.randn(c)[col]
    x[:, 6] = rs.randint(0, 2400, n)
    x[:, 7] = rs.gamma(2.0, 400.0, n)
    logit += 0.8 * (x[:, 6] > 1700) + 0.3 * np.log(x[:, 7] / 800.0)
    logit += 0.5 * rs.randn(n)
    if task == "binary":
        y = (logit > np.quantile(logit, 0.8)).astype(np.float32)
    else:
        y = np.round(2.0 * logit).astype(np.float32)
    return x, y


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return [t.split("\n\n")[0] for t in text.split("Tree=")[1:]]


def _exact_l2(preds, ds):
    g = np.round(8.0 * (np.asarray(preds, np.float64) - ds.get_label())) / 8
    return g.astype(np.float32), np.ones(len(g), np.float32)


def _train(mod, params, rounds, data, fobj=None, valid=True):
    x, y, xv, yv = data
    p = {"verbosity": -1, "max_bin": 63, "min_data_in_leaf": 10,
         "min_data_per_group": 20, **params}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y, categorical_feature=CAT_COLS)
    ev = {}
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid else None
    bst = mod.train(p, tr, rounds, valid_sets=vs, fobj=fobj,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


@pytest.fixture(scope="module")
def reg_data():
    x, y = airline(1, 4000, "regression")
    xv, yv = airline(2, 1000, "regression")
    return x, y, xv, yv


@pytest.fixture(scope="module")
def bin_data():
    x, y = airline(3, 5000)
    xv, yv = airline(4, 1500)
    return x, y, xv, yv


EXACT = {
    "strict": {"num_leaves": 15},
    "strict_bynode": {"num_leaves": 15, "feature_fraction_bynode": 0.6},
    "strict_cat_params": {"num_leaves": 15, "cat_l2": 1.0,
                          "cat_smooth": 4.0, "max_cat_threshold": 6,
                          "max_cat_to_onehot": 8},
    "batched_k8": {"num_leaves": 64},
    "batched_k16": {"num_leaves": 255, "min_data_in_leaf": 5},
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_trees_equal_jax(reg_data, case):
    params = {"objective": "none", "learning_rate": 0.5, "metric": "l2",
              **EXACT[case]}
    bt, evt = _train(lgt, params, 5, reg_data, fobj=_exact_l2)
    bj, evj = _train(lgb, params, 5, reg_data, fobj=_exact_l2)
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 5
    for i, (a, b) in enumerate(zip(tt, tj)):
        assert a == b, f"tree {i}"
        assert "cat_threshold=" in a
    assert evt["valid_0"]["l2"] == evj["valid_0"]["l2"]
    cats = [t.num_cat for t in bt._model.models]
    assert min(cats) > 0
    if case.startswith("batched"):
        assert bt._model.split_batch == (8 if case == "batched_k8" else 16)


@pytest.fixture(scope="module")
def bin_runs(bin_data):
    params = {"objective": "binary", "num_leaves": 64,
              "boost_from_average": False, "learning_rate": 0.3,
              "metric": ["binary_logloss", "auc"]}
    out = {}
    for path in PATHS:
        for mod in (lgt, lgb):
            out[(path, mod.__name__)] = _train(
                mod, {**params, **PATHS[path]}, 8, bin_data,
                valid=path != "fused_chunk")
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_batched_first_tree_equal_jax_and_metric_close(bin_runs, bin_data,
                                                       path):
    bt, evt = bin_runs[(path, "lightgbm_torch")]
    bj, evj = bin_runs[(path, "lightgbm_tpu")]
    assert bt._model.split_batch == 8
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 8
    assert tt[0] == tj[0] and "num_leaves=64" in tt[0]
    if path == "fused_chunk":
        x, y = bin_data[2], bin_data[3]
        lt = np.mean(-y * np.log(bt.predict(x))
                     - (1 - y) * np.log(1 - bt.predict(x)))
        lj = np.mean(-y * np.log(np.asarray(bj.predict(x)))
                     - (1 - y) * np.log(1 - np.asarray(bj.predict(x))))
        assert abs(lt - lj) <= METRIC_RTOL * lj
        return
    for name in ("binary_logloss", "auc"):
        a, b = evt["valid_0"][name][-1], evj["valid_0"][name][-1]
        assert abs(a - b) <= METRIC_RTOL * b, name


@pytest.mark.parametrize("leaves", [15, 64])
def test_paths_write_the_same_model(bin_data, leaves):
    params = {"objective": "binary", "num_leaves": leaves,
              "learning_rate": 0.3, "metric": "auc"}
    texts = {path: _norm(_train(lgt, {**params, **PATHS[path]}, 6,
                                bin_data, valid=path != "fused_chunk")[0]
                         .model_to_string())
             for path in PATHS}
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]
    assert "cat_threshold=" in texts["superepoch"]


@pytest.fixture(scope="module")
def cat_model(bin_data):
    bst, _ = _train(lgt, {"objective": "binary", "num_leaves": 31,
                          "learning_rate": 0.3}, 10, bin_data, valid=False)
    return bst


def _unseen_rows(bin_data):
    x = np.array(bin_data[2][:600], np.float64)
    rs = np.random.RandomState(5)
    for j in CAT_COLS:
        rows = rs.rand(len(x)) < 0.2
        x[rows, j] = rs.choice([999.0, -3.0, np.nan, 61.0], rows.sum())
    return x


def test_unseen_categories_go_right(cat_model, bin_data):
    """A category the model never saw (unseen, negative, NaN) goes right
    at every categorical node: the port's predictions equal the JAX
    package's on the same model text, and a root split on a categorical
    feature sends such a row to its right child."""
    x = _unseen_rows(bin_data)
    text = cat_model.model_to_string()
    pt = cat_model.predict(x, raw_score=True)
    pj = np.asarray(lgb.Booster(model_str=text).predict(x, raw_score=True))
    np.testing.assert_allclose(pt, pj, rtol=1e-6, atol=1e-6)
    t0 = cat_model._model.models[0]
    ti = next(i for i, t in enumerate(cat_model._model.models)
              if int(t.decision_type[0]) & 1)
    t = cat_model._model.models[ti]
    f = int(t.split_feature[0])
    row = np.array(bin_data[2][:1], np.float64)
    row[0, f] = 999.0
    leaf = cat_model.predict(row, pred_leaf=True)[0, ti]
    right = t.right_child[0]
    assert t0.num_leaves > 1
    # the leaf lies under the root's right child
    under = {~right} if right < 0 else _leaves_under(t, right)
    assert leaf in under


def _leaves_under(t, node):
    out, stack = set(), [node]
    while stack:
        n = stack.pop()
        for c in (t.left_child[n], t.right_child[n]):
            if c < 0:
                out.add(~c)
            else:
                stack.append(c)
    return out


def test_model_text_round_trip(cat_model, bin_data):
    x = _unseen_rows(bin_data)
    text = cat_model.model_to_string()
    again = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    assert again.model_to_string().split("\nTree=", 1)[1] \
        .split("end of trees")[0] == text.split("\nTree=", 1)[1] \
        .split("end of trees")[0]
    np.testing.assert_array_equal(again.predict(x), cat_model.predict(x))


def test_engine_route_and_fused_predict_equal_host_walk(cat_model, bin_data):
    x = _unseen_rows(bin_data)
    bst = lgt.Booster(params={"device_type": "cpu",
                              "predict_bucketed": "true"},
                      model_str=cat_model.model_to_string())
    eng_pred = bst.predict(x, raw_score=True)
    np.testing.assert_array_equal(eng_pred,
                                  host_walk(bst, x, raw_score=True))
    eng = bst.predict_engine(len(x))
    assert eng is not None and eng.fused_ok
    mask = eng._f32_consensus_mask(x)
    got = eng.fused_predict(x, raw_score=True)
    np.testing.assert_array_equal(got[mask],
                                  eng._fused_reference(x[mask],
                                                       raw_score=True))
    np.testing.assert_allclose(got, eng_pred, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("device_binning", [False, True])
def test_server_answers_as_the_host_walk(cat_model, bin_data,
                                         device_binning):
    x = _unseen_rows(bin_data)
    text = cat_model.model_to_string()
    srv = Server({"device_type": "cpu", "serve_max_batch": 64,
                  "serve_max_wait_ms": 2.0,
                  "serve_device_binning": device_binning}, model_str=text)
    try:
        eng = srv.registry.current().engine
        rows = x[eng._f32_consensus_mask(x)] if device_binning else x
        futs = [srv.submit(rows[i:i + 37]) for i in range(0, len(rows), 37)]
        got = np.concatenate([f.result(30) for f in futs])
    finally:
        srv.close()
    want = eng._fused_reference(rows) if device_binning \
        else host_walk(cat_model, rows)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("task", ["binary", "regression"])
def test_valid_set_added_after_training_matches_jax(task):
    """BoostFromAverage on, 3 iterations, then a valid set: its scores are
    the trees' replay without the bias, as in the JAX package."""
    x, y = raw_problem(81, n=3000, f=6, task=task, nan_frac=0.0)
    xv, yv = raw_problem(82, n=800, f=6, task=task, nan_frac=0.0)
    scores = {}
    for mod in (lgt, lgb):
        p = {"objective": task, "num_leaves": 15, "verbosity": -1,
             "max_bin": 31, "boost_from_average": True,
             "superepoch": -1, "fused_chunk": 1}
        p.update({"device_type": "cpu"} if mod is lgt
                 else {"tpu_learner": "masked"})
        tr = mod.Dataset(x, y)
        bst = mod.train(p, tr, 3, keep_training_booster=True)
        bst.add_valid(mod.Dataset(xv, yv, reference=tr), "late")
        scores[mod.__name__] = np.asarray(
            bst._model.valid_score(0)).reshape(-1)[:len(yv)]
    st, sj = scores["lightgbm_torch"], scores["lightgbm_tpu"]
    np.testing.assert_allclose(st, sj, rtol=1e-5,
                               atol=1e-5 * np.abs(sj).max())
