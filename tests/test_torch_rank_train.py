"""Ranking training: lambdarank (B13a) and rank_xendcg (B13b) through
``lightgbm_torch.train`` on the CPU, against the JAX package
(``tpu_learner="masked"``) on the same query groups.

About 4,000 rows in 200 queries of 5 to 35 documents, labels 0-4 from a
hidden relevance of the features.  The gradients are f32 sums that the two
packages take in other orders, so the histograms part in their last bits:
the first tree of a 31-leaf run is held by structure (every split, count
and threshold) and by its leaf values within ``LEAF_RTOL`` of the
largest, and its predictions within ``PRED_RTOL`` of the largest;
the later trees, and the 255-leaf runs (whose small leaves have near-tied
gains), by the valid NDCG within ``NDCG_ATOL``: a near-tied split that
the two decide the other way changes a few trees, and a 60-query NDCG@k
moves in steps of about 1/60 as a query's top k reorders.  The port's
three paths write equal model text, the fused paths refuse rank_xendcg
with the JAX package's text, and the model text round-trips.
"""

import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

ROUNDS = 6
LEAF_RTOL = 1e-5
PRED_RTOL = 1e-5
NDCG_ATOL = 0.03
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
# the three paths of ``train``, without a valid set: the per-iteration
# loop, fused chunks of 3, and one super-epoch of every round
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 3},
         "superepoch": {"fused_chunk": 25}}


def rank_data(seed: int, nq: int = 200):
    rs = np.random.RandomState(seed)
    sizes = rs.randint(5, 36, nq)
    n = int(sizes.sum())
    x = rs.randn(n, 8).astype(np.float32)
    rel = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] ** 2 + 0.3 * rs.randn(n)
    y = np.digitize(rel, [0.0, 0.8, 1.5, 2.2]).astype(np.float32)
    return x, y, sizes


def _params(obj, leaves, **kw):
    return {"objective": obj, "num_leaves": leaves, "verbosity": -1,
            "min_data_in_leaf": 5, "eval_at": [1, 3, 5], **kw}


def _train_both(obj, leaves, rounds=ROUNDS, **kw):
    x, y, sizes = rank_data(0)
    xv, yv, sv = rank_data(1, nq=60)
    p = _params(obj, leaves, **kw)
    et, ej = {}, {}
    bt = lgt.train({**p, "device_type": "cpu"},
                   lgt.Dataset(x, y, group=sizes), rounds,
                   valid_sets=[lgt.Dataset(xv, yv, group=sv)],
                   valid_names=["v"],
                   callbacks=[lgt.record_evaluation(et)])
    bj = lgb.train({**p, "device_type": "cpu", "tpu_learner": "masked"},
                   lgb.Dataset(x, label=y, group=sizes), rounds,
                   valid_sets=[lgb.Dataset(xv, label=yv, group=sv)],
                   valid_names=["v"],
                   callbacks=[lgb.record_evaluation(ej)])
    return bt, bj, et, ej, x


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(tree_text):
    return [ln for ln in tree_text.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _field(tree_text, name):
    for ln in tree_text.splitlines():
        if ln.startswith(name + "="):
            return np.asarray(ln.split("=")[1].split(), np.float64)
    raise KeyError(name)


def _without_paths(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


@pytest.mark.parametrize("obj", ["lambdarank", "rank_xendcg"])
@pytest.mark.parametrize("leaves", [31, 255])
def test_ranking_trains_as_jax(obj, leaves):
    bt, bj, et, ej, x = _train_both(obj, leaves)
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == ROUNDS
    if leaves == 31:
        assert _structure(tt[0]) == _structure(tj[0])
        lj = _field(tj[0], "leaf_value")
        np.testing.assert_allclose(_field(tt[0], "leaf_value"), lj,
                                   rtol=0, atol=LEAF_RTOL * np.abs(lj).max())
        p1 = np.asarray(bj.predict(x, num_iteration=1))
        np.testing.assert_allclose(bt.predict(x, num_iteration=1), p1,
                                   rtol=0, atol=PRED_RTOL * np.abs(p1).max())
    for k in ("ndcg@1", "ndcg@3", "ndcg@5"):
        np.testing.assert_allclose(et["v"][k], ej["v"][k], rtol=0,
                                   atol=NDCG_ATOL)
    # NDCG on the valid queries learns
    assert et["v"]["ndcg@5"][-1] > et["v"]["ndcg@5"][0]
    # an ndcg valid set has no traced metric: the per-iteration loop
    assert bt._model.fetch_counts.get("tree", 0) == ROUNDS


def test_lambdarank_paths_write_the_same_model():
    x, y, sizes = rank_data(0)
    texts = {}
    for path, extra in PATHS.items():
        bst = lgt.train({**_params("lambdarank", 31, **extra),
                         "device_type": "cpu"},
                        lgt.Dataset(x, y, group=sizes), ROUNDS)
        m = bst._model
        site = "tree" if path == "per_iteration" else "epoch"
        assert m.fetch_counts.get(site, 0) >= 1, path
        assert bst.supports_fused() == (path != "per_iteration")
        texts[path] = _without_paths(bst.model_to_string())
    assert texts["fused_chunk"] == texts["per_iteration"]
    assert texts["superepoch"] == texts["per_iteration"]


def test_xendcg_refuses_fusion_as_jax():
    x, y, sizes = rank_data(2, nq=30)
    p = _params("rank_xendcg", 7)
    bt = lgt.train({**p, "device_type": "cpu"},
                   lgt.Dataset(x, y, group=sizes), 2)
    bj = lgb.train({**p, "device_type": "cpu", "tpu_learner": "masked"},
                   lgb.Dataset(x, label=y, group=sizes), 2)
    reason = "objective=rank_xendcg mutates host state every iteration"
    assert reason in bt._model.fused_reasons()
    assert reason in bj._model.fused_reasons()
    assert not bt.supports_fused()
    with pytest.raises(ValueError, match="mutates host state"):
        bt._model.train_chunk(2)
    # its draws are keyed: a second run writes the same text
    bt2 = lgt.train({**p, "device_type": "cpu"},
                    lgt.Dataset(x, y, group=sizes), 2)
    assert bt2.model_to_string() == bt.model_to_string()


@pytest.mark.parametrize("obj", ["lambdarank", "rank_xendcg"])
def test_ranking_model_text_round_trips(obj):
    x, y, sizes = rank_data(3, nq=40)
    bst = lgt.train({**_params(obj, 15), "device_type": "cpu"},
                    lgt.Dataset(x, y, group=sizes), 3)
    text = bst.model_to_string()
    assert f"objective={obj}" in text.splitlines()
    loaded = lgt.Booster(model_str=text, params={"device_type": "cpu"})
    assert _trees(loaded.model_to_string()) == _trees(text)
    assert f"objective={obj}" in loaded.model_to_string().splitlines()
    # a ranker predicts its raw scores (in f32, as the JAX package's
    # output transform runs)
    np.testing.assert_array_equal(loaded.predict(x), bst.predict(x))
    np.testing.assert_array_equal(
        bst.predict(x), bst.predict(x, raw_score=True).astype(np.float32))


def test_ranking_needs_query_groups():
    x, y, _ = rank_data(4, nq=10)
    with pytest.raises(ValueError, match="query"):
        lgt.train({**_params("lambdarank", 7), "device_type": "cpu"},
                  lgt.Dataset(x, y), 1)
