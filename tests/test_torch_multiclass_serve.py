"""Multiclass iteration bookkeeping and serving in lightgbm_torch
(device_type=cpu, every kernel as its plain version) against the JAX
package (``tpu_learner="masked"``):

- a class whose gradients are zero grows a stump that adds nothing while
  the other classes train on; an iteration of K stumps stops training;
  both as in the JAX package (the same trees, the same tree count);
- ``drop_iterations(n)`` takes back n * K trees, each from its own class
  column: the model equals a run of fewer rounds and the scores agree
  with that run's to ``DROP_ATOL`` (add-then-subtract is not bit exact);
- a valid set added after training replays tree t into column t % K,
  without the BoostFromAverage bias, equal to the JAX package's
  ``add_valid`` on exact gradients;
- ``init_score`` of N * K values is reshaped (N, K) row-major and added
  to the scores, as in the JAX package;
- model text round trips: the port's text loads in both packages and the
  JAX package's text in the port, and ``predict`` (raw bit for bit,
  probabilities within ``PROB_RTOL``: the two packages' ``exp`` differ by
  an ulp) agrees, softmax and one-vs-all; the predictor engine's route
  equals the host walk bit for bit, ``fused_predict`` equals
  ``_fused_reference`` (raw and transformed), and a ``Server`` answers
  every request with [rows, K] probabilities on both binning routes."""

import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.serve import Server

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, multiclass_problem, pin_torch_threads,
    pin_torch_threads_module)

K = 3
DROP_ATOL = 1e-5
PROB_RTOL, PROB_ATOL = 2e-6, 1e-7
PER_ITERATION = {"superepoch": -1, "fused_chunk": 1}


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _params(mod, **kw):
    p = {"objective": "multiclass", "num_class": K, "num_leaves": 15,
         "learning_rate": 0.3, "min_data_in_leaf": 40, "max_bin": 31,
         "verbosity": -1, **PER_ITERATION, **kw}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    return p


def _exact(zero_classes=()):
    """A custom objective: the softmax gradient rounded to 1/8, hessian
    1, with the classes in ``zero_classes`` given zero gradients."""
    def fobj(preds, ds):
        y = np.asarray(ds.get_label()).astype(int)
        s = np.asarray(preds, np.float64)
        e = np.exp(s - s.max(axis=1, keepdims=True))
        p = e / e.sum(axis=1, keepdims=True)
        g = np.round(8.0 * (p - np.eye(K)[y])) / 8.0
        g[:, list(zero_classes)] = 0.0
        return g, np.ones_like(g)
    return fobj


@pytest.fixture(scope="module")
def data():
    x, y = multiclass_problem(71, n=3000, f=6, k=K)
    xv, yv = multiclass_problem(72, n=700, f=6, k=K)
    return x, y, xv, yv


def test_a_stump_class_adds_nothing_and_training_goes_on(data):
    x, y, _, _ = data
    out = {}
    for mod in (lgt, lgb):
        bst = mod.train(_params(mod, objective="custom"),
                        mod.Dataset(x, y), 4, fobj=_exact((1,)))
        out[mod.__name__] = bst
    bt, bj = out["lightgbm_torch"], out["lightgbm_tpu"]
    assert bt.num_trees() == bj.num_trees() == 4 * K
    assert _trees(bt.model_to_string()) == _trees(bj.model_to_string())
    assert [t.num_leaves for t in bt.trees[1::K]] == [1] * 4
    assert all(t.num_leaves > 1 for i, t in enumerate(bt.trees)
               if i % K != 1)
    # the stump class's score column never moved
    score = bt._model.train_score()
    np.testing.assert_array_equal(score[:, 1], np.zeros(len(x)))
    assert np.abs(score[:, 0]).max() > 0


def test_all_k_stumps_stop_training(data):
    x, y, _, _ = data
    counts = {}
    for mod in (lgt, lgb):
        bst = mod.train(_params(mod, objective="custom"),
                        mod.Dataset(x, y), 5, fobj=_exact(range(K)))
        counts[mod.__name__] = (bst.num_trees(), bst.current_iteration)
    assert counts["lightgbm_torch"] == counts["lightgbm_tpu"]
    assert counts["lightgbm_torch"][0] == K


def test_drop_iterations_takes_back_k_trees_a_round(data):
    x, y, xv, yv = data
    runs = {}
    for rounds in (5, 3):
        tr = lgt.Dataset(x, y)
        bst = lgt.train(_params(lgt), tr, rounds,
                        valid_sets=[lgt.Dataset(xv, yv, reference=tr)])
        runs[rounds] = bst
    b5, b3 = runs[5], runs[3]
    b5._model.drop_iterations(2)
    b5._sync_trees()
    assert b5.num_trees() == 3 * K and b5.current_iteration == 3
    assert _trees(b5.model_to_string()) == _trees(b3.model_to_string())
    for got, want in ((b5._model.train_score(), b3._model.train_score()),
                      (b5._model.valid_score(0), b3._model.valid_score(0))):
        assert got.shape[1] == K
        np.testing.assert_allclose(got, want, rtol=0, atol=DROP_ATOL)
    # the JAX package's trees of the same three rounds
    bj = lgb.train(_params(lgb), lgb.Dataset(x, y), 3)
    assert [t.split_feature.tolist() for t in b3.trees] == \
        [t.split_feature.tolist() for t in bj.trees]


@pytest.mark.parametrize("objective", ["multiclass", "custom"])
def test_valid_set_added_after_training_matches_jax(data, objective):
    x, y, xv, yv = data
    scores = {}
    for mod in (lgt, lgb):
        tr = mod.Dataset(x, y)
        fobj = _exact() if objective == "custom" else None
        bst = mod.train(_params(mod, objective=objective), tr, 3,
                        fobj=fobj, keep_training_booster=True)
        bst.add_valid(mod.Dataset(xv, yv, reference=tr), "late")
        scores[mod.__name__] = np.asarray(bst._model.valid_score(0))
    st, sj = scores["lightgbm_torch"], scores["lightgbm_tpu"]
    assert st.shape == sj.shape == (len(yv), K)
    if objective == "custom":
        np.testing.assert_array_equal(st, sj)
    else:
        np.testing.assert_allclose(st, sj, rtol=1e-5,
                                   atol=1e-5 * np.abs(sj).max())


def test_init_score_is_reshaped_row_major(data):
    x, y, xv, yv = data
    rs = np.random.RandomState(73)
    init = (0.3 * rs.randn(len(x) * K)).astype(np.float32)
    vinit = (0.3 * rs.randn(len(xv) * K)).astype(np.float32)
    out = {}
    for mod in (lgt, lgb):
        tr = mod.Dataset(x, y, init_score=init)
        bst = mod.train(_params(mod, objective="custom"), tr, 2,
                        valid_sets=[mod.Dataset(xv, yv, reference=tr,
                                                init_score=vinit)],
                        fobj=_exact())
        out[mod.__name__] = bst
    bt, bj = out["lightgbm_torch"], out["lightgbm_tpu"]
    assert _trees(bt.model_to_string()) == _trees(bj.model_to_string())
    for f in ("train_score", "valid_score"):
        args = () if f == "train_score" else (0,)
        np.testing.assert_array_equal(
            getattr(bt._model, f)(*args),
            np.asarray(getattr(bj._model, f)(*args)))


@pytest.fixture(scope="module", params=["multiclass", "multiclassova"])
def model(request, data):
    x, y, _, _ = data
    return lgt.train(_params(lgt, objective=request.param),
                     lgt.Dataset(x, y), 6)


def test_text_round_trips_with_the_jax_package(model, data):
    _, _, xv, _ = data
    text = model.model_to_string()
    loaded_t = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    loaded_j = lgb.Booster(model_str=text)
    raw = host_walk(model, xv, raw_score=True)
    assert raw.shape == (len(xv), K)
    np.testing.assert_array_equal(host_walk(loaded_t, xv, raw_score=True),
                                  raw)
    np.testing.assert_array_equal(
        np.asarray(loaded_j.predict(xv, raw_score=True)), raw)
    prob = host_walk(loaded_t, xv)
    np.testing.assert_allclose(prob, np.asarray(loaded_j.predict(xv)),
                               rtol=PROB_RTOL, atol=PROB_ATOL)
    if model.config.objective == "multiclass":
        np.testing.assert_allclose(prob.sum(axis=1), 1.0, rtol=1e-6)
    # the JAX package's own text loads in the port and predicts with its
    # transform
    x, y, _, _ = data
    bj = lgb.train(_params(lgb, objective=model.config.objective),
                   lgb.Dataset(x, y), 3)
    from_j = lgt.Booster(params={"device_type": "cpu"},
                         model_str=bj.model_to_string())
    np.testing.assert_allclose(host_walk(from_j, xv),
                               np.asarray(bj.predict(xv)), rtol=PROB_RTOL,
                               atol=PROB_ATOL)
    assert _trees(loaded_t.model_to_string()) == _trees(text)


def test_engine_and_fused_predict(model, data):
    _, _, xv, _ = data
    bst = lgt.Booster(params={"device_type": "cpu",
                              "predict_bucketed": "true"},
                      model_str=model.model_to_string())
    for raw in (True, False):
        got = bst.predict(xv, raw_score=raw)
        assert got.shape == (len(xv), K)
        np.testing.assert_array_equal(got, host_walk(bst, xv,
                                                     raw_score=raw))
    eng = bst.predict_engine(len(xv))
    assert eng is not None and eng.fused_reason is None
    mask = eng._f32_consensus_mask(xv)
    for raw in (True, False):
        got = eng.fused_predict(xv, raw_score=raw)
        assert got.shape == (len(xv), K)
        np.testing.assert_array_equal(
            got[mask], eng._fused_reference(xv[mask], raw_score=raw))
    assert eng.self_check(device_binning=True)


@pytest.mark.parametrize("device_binning", [False, True])
def test_server_answers_k_columns(model, data, device_binning):
    _, _, xv, _ = data
    srv = Server({"device_type": "cpu", "serve_max_batch": 64,
                  "serve_max_wait_ms": 2.0,
                  "serve_device_binning": device_binning},
                 model_str=model.model_to_string())
    try:
        eng = srv.registry.current().engine
        rows = xv[eng._f32_consensus_mask(xv)] if device_binning else xv
        futs = [srv.submit(rows[i:i + 29]) for i in range(0, len(rows), 29)]
        got = [f.result(30) for f in futs]
    finally:
        srv.close()
    assert all(g.shape == (min(29, len(rows) - 29 * i), K)
               for i, g in enumerate(got))
    got = np.concatenate(got)
    want = eng._fused_reference(rows) if device_binning \
        else host_walk(model, rows)
    np.testing.assert_array_equal(got, want)
