"""The default ``train`` path: fused chunks and super-epochs (the port's
CUDA-graph loop, run uncaptured through the plain versions on the CPU).

- Against the JAX package, both at default path parameters: equal
  ``best_iteration``, the model text's lines equal once the path
  parameters are dropped, except the float fields of the trees (their
  last digits differ: histogram sums run in another order), which are
  held through the predictions (1e-5 relative, as test_torch_train
  holds them), and ``record_evals`` within 1e-6; the port took the
  super-epoch route (one counted host fetch per epoch) and reports f32
  values, as the JAX package's traced metrics are.
- Within the port: super-epoch ``record_evals`` are bitwise those of a
  ``fused_eval=true`` per-iteration run, and super-epoch, fused-chunk and
  per-iteration runs write the same model text (minus the path
  parameters)."""

import math

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb

from torch_port_fixtures import raw_problem

torch.set_num_threads(2)

_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
# model-text lines that carry f32 sums of the trees, or are derived from
# them (block sizes, importances)
FLOAT_LINES = ("split_gain", "leaf_value", "leaf_weight", "internal_value",
               "internal_weight", "tree_sizes")
PER_ITER = {"superepoch": -1, "fused_chunk": 1}


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _data(task="binary", n=4000, seed=41):
    x, y = raw_problem(seed, n=n, f=10, task=task, nan_frac=0.0)
    xv, yv = raw_problem(seed + 1, n=1500, f=10, task=task, nan_frac=0.0)
    # label noise so that the valid metric turns early
    rs = np.random.RandomState(seed + 2)
    if task == "binary":
        y = np.where(rs.rand(len(y)) < 0.3, 1 - y, y).astype(np.float32)
    else:
        y = (y + 3.0 * rs.randn(len(y))).astype(np.float32)
    return x, y, xv, yv


BASE = {
    "binary": {"objective": "binary", "learning_rate": 0.3,
               "metric": ["binary_logloss", "auc"]},
    "regression": {"objective": "regression", "learning_rate": 0.3,
                   "metric": ["l2", "l1", "rmse"]},
}


def _train(mod, task, extra, rounds=40, es=5, valid=True, data=None,
           callbacks=True):
    x, y, xv, yv = data if data is not None else _data(task)
    params = {**BASE[task], "num_leaves": 15, "max_bin": 31,
              "min_data_in_leaf": 30, "verbosity": -1, **extra}
    if mod is lgt:
        params["device_type"] = "cpu"
    tr = mod.Dataset(x, y)
    ev = {}
    cbs = [mod.record_evaluation(ev)] if callbacks else []
    if es:
        cbs.append(mod.early_stopping(es, verbose=False))
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid else None
    bst = mod.train(params, tr, rounds, valid_sets=vs, callbacks=cbs)
    return bst, ev


@pytest.fixture(scope="module")
def default_runs():
    """Both packages at their default path parameters (the JAX side on
    its masked learner)."""
    bt, evt = _train(lgt, "binary", {})
    bj, evj = _train(lgb, "binary", {"tpu_learner": "masked"})
    return bt, evt, bj, evj


def test_default_path_matches_jax(default_runs):
    bt, evt, bj, evj = default_runs
    assert bt.best_iteration == bj.best_iteration
    assert 1 < bt.best_iteration < 40       # early stopping really stopped
    assert bt.num_trees() == bj.num_trees()
    lt = _norm(bt.model_to_string()).split("feature_importances:")[0]
    lj = _norm(bj.model_to_string()).split("feature_importances:")[0]

    def exact(text):
        return [ln for ln in text.splitlines()
                if ln.split("=")[0] not in FLOAT_LINES]
    assert exact(lt) == exact(lj)
    _, _, xv, _ = _data("binary")
    pt, pj = bt.predict(xv), np.asarray(bj.predict(xv))
    np.testing.assert_allclose(pt, pj, rtol=1e-5,
                               atol=1e-5 * np.abs(pj).max())
    for name, vals in evj["valid_0"].items():
        tol = {"atol": 1e-6} if name == "auc" else {"rtol": 1e-6}
        np.testing.assert_allclose(evt["valid_0"][name], vals, **tol)


def test_default_path_takes_the_super_epoch_route(default_runs):
    bt, evt, _, _ = default_runs
    # traced metrics report f32 values, as the JAX package's do
    for vals in evt["valid_0"].values():
        assert all(float(np.float32(v)) == v for v in vals)
    m = bt._model
    # k = max(2, min(fused_chunk=25, early_stopping_round=5)) = 5
    epochs = math.ceil(m.num_iterations_trained / 5)
    assert m.fetch_counts == {"epoch": epochs}


@pytest.mark.parametrize("task", sorted(BASE))
def test_super_epoch_evals_equal_traced_per_iteration(task):
    bs, evs = _train(lgt, task, {})
    bp, evp = _train(lgt, task, {**PER_ITER, "fused_eval": "true"})
    assert bs._model.fetch_counts.keys() == {"epoch"}
    assert bp._model.fetch_counts.keys() == {"tree", "traced_eval"}
    assert bs.best_iteration == bp.best_iteration
    assert bs.best_score == bp.best_score
    for name, vals in evp["valid_0"].items():
        assert evs["valid_0"][name] == vals        # bitwise
    assert _norm(bs.model_to_string()) == _norm(bp.model_to_string())


def test_three_paths_write_the_same_model():
    data = _data("binary")
    # super-epochs: a valid set, no early stopping (k = fused_chunk = 6)
    bs, _ = _train(lgt, "binary", {"fused_chunk": 6}, rounds=14, es=0,
                   data=data)
    # fused chunks: no valid set and no callback (6 + 6, then a 2-round
    # super-epoch for the remainder)
    bc, _ = _train(lgt, "binary", {"fused_chunk": 6}, rounds=14, es=0,
                   valid=False, callbacks=False, data=data)
    bp, _ = _train(lgt, "binary", PER_ITER, rounds=14, es=0, valid=False,
                   data=data)
    assert bs._model.fetch_counts == {"epoch": 3}
    assert bc._model.fetch_counts == {"epoch": 3}
    assert bp._model.fetch_counts == {"tree": 14}
    text = _norm(bp.model_to_string())
    assert _norm(bs.model_to_string()) == text
    assert _norm(bc.model_to_string()) == text
    np.testing.assert_array_equal(bs._model.train_score(),
                                  bp._model.train_score())


def test_explicit_superepoch_with_a_remainder():
    # superepoch=4 over 9 rounds: epochs of 4 and 4, then one round per
    # iteration that keeps reporting the traced values
    bs, evs = _train(lgt, "binary", {"superepoch": 4}, rounds=9, es=0)
    bp, evp = _train(lgt, "binary", {**PER_ITER, "fused_eval": "true"},
                     rounds=9, es=0)
    assert bs._model.fetch_counts == {"epoch": 2, "tree": 1,
                                      "traced_eval": 1}
    assert bs.num_trees() == 9
    assert evs == evp
    assert _norm(bs.model_to_string()) == _norm(bp.model_to_string())


def test_mid_epoch_stump_stops_training():
    # a large min_gain_to_split leaves no split once the first trees have
    # fit the signal: the stump ends training in the middle of an epoch,
    # and the epoch's later trees are discarded
    data = _data("regression")
    extra = {"learning_rate": 1.0, "min_gain_to_split": 3000.0,
             "fused_chunk": 6}
    bs, evs = _train(lgt, "regression", extra, rounds=30, es=0, data=data)
    bc, _ = _train(lgt, "regression", extra, rounds=30, es=0, valid=False,
                   callbacks=False, data=data)
    bp, evp = _train(lgt, "regression", {**extra, **PER_ITER,
                                         "fused_eval": "true"},
                     rounds=30, es=0, data=data)
    n = bp.num_trees()
    assert 1 < n < 30 and n % 6 != 0, "test setup: expected a mid-epoch stump"
    assert bp.trees[-1].num_leaves == 1
    assert bs.num_trees() == bc.num_trees() == n
    text = _norm(bp.model_to_string())
    assert _norm(bs.model_to_string()) == text
    assert _norm(bc.model_to_string()) == text
    assert evs == evp
    assert bs._model.fetch_counts == {"epoch": math.ceil(n / 6)}


def test_one_fetch_per_epoch_and_per_tree():
    bp, _ = _train(lgt, "regression", PER_ITER, rounds=7, es=0, valid=False)
    assert bp._model.fetch_counts == {"tree": 7}
    bc, _ = _train(lgt, "regression", {"fused_chunk": 3}, rounds=9, es=0,
                   valid=False, callbacks=False)
    assert bc._model.fetch_counts == {"epoch": 3}
    assert _norm(bc.model_to_string()) == _norm(
        _train(lgt, "regression", PER_ITER, rounds=9, es=0,
               valid=False)[0].model_to_string())


def test_fused_reasons_name_the_blocker():
    x, y, _, _ = _data("regression", n=600)

    def fobj(preds, ds):
        return preds - ds.get_label(), np.ones_like(preds)

    params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
              "device_type": "cpu"}
    bst = lgt.train({**params, "objective": "custom"}, lgt.Dataset(x, y), 3,
                    fobj=fobj)
    assert not bst.supports_fused()
    assert any("custom objective" in r for r in bst.fused_reasons())
    assert bst._model.fetch_counts["tree"] == 3
    bst = lgt.train({**params, "fused_chunk": 1}, lgt.Dataset(x, y), 2)
    assert bst.fused_reasons() == ["fused_chunk=1 (set > 1 to enable "
                                   "fusion)"]
    bst = lgt.train(params, lgt.Dataset(x, y), 2)
    assert bst.supports_fused() and bst.fused_reasons() == []
    with pytest.raises(ValueError, match="custom objective"):
        lgt.Booster(params={**params, "objective": "custom"},
                    train_set=lgt.Dataset(x, y))._model.train_chunk(2)


def test_drop_iterations_takes_trees_and_scores_back():
    data = _data("regression")
    b6, _ = _train(lgt, "regression", {}, rounds=6, es=0, data=data)
    b4, _ = _train(lgt, "regression", {}, rounds=4, es=0, data=data)
    b6._model.drop_iterations(2)
    b6._sync_trees()
    assert b6.num_trees() == 4
    assert b6.model_to_string().split("parameters:")[0] \
        == b4.model_to_string().split("parameters:")[0]
    np.testing.assert_allclose(b6._model.train_score(),
                               b4._model.train_score(), atol=1e-5)
    np.testing.assert_allclose(b6._model.valid_score(0),
                               b4._model.valid_score(0), atol=1e-5)
