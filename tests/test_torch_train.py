"""End to end: ``lightgbm_torch.train`` (device_type=cpu, every kernel as
its plain version) against the JAX package's per-iteration masked learner
(``tpu_learner="masked"``, ``fused_chunk=1``, ``superepoch=-1``) on the
same data, with a valid set and early stopping.  Tree structures, the
structural lines of the model text and ``best_iteration`` are equal;
predictions agree to 1e-5 relative (gradients, histograms and leaf values
round differently in the last bits)."""

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.objectives import BinaryLogloss, RegressionL2
from lightgbm_tpu import objectives as jobj

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module, raw_problem)

PRED_RTOL = 1e-5
STRUCTURAL = ("Tree", "num_leaves", "num_cat", "split_feature", "threshold",
              "decision_type", "left_child", "right_child", "leaf_count",
              "internal_count", "is_linear", "shrinkage")

TASKS = {
    "binary": {"objective": "binary", "metric": ["binary_logloss", "auc"],
               "learning_rate": 0.5},
    "regression": {"objective": "regression", "metric": "l2",
                   "learning_rate": 0.6},
}


def _train(mod, task, x, y, xv, yv, extra):
    params = {**TASKS[task], "num_leaves": 15, "max_bin": 31,
              "min_data_in_leaf": 30, "verbosity": -1, **extra}
    tr = mod.Dataset(x, y)
    ev = {}
    bst = mod.train(params, tr, 10,
                    valid_sets=[mod.Dataset(xv, yv, reference=tr)],
                    callbacks=[mod.early_stopping(2, verbose=False),
                               mod.record_evaluation(ev)])
    return bst, ev


def _structure(text):
    body = text.split("end of trees")[0]
    return [ln for ln in body.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


@pytest.fixture(scope="module", params=sorted(TASKS))
def trained(request):
    task = request.param
    # no NaN here: a leaf whose NA bin is empty gets that bin's sums by
    # parent-minus-sibling subtraction, so its two NA directions tie up to
    # rounding residue and either package may pick either (ROADMAP C).
    # NA handling is held bin by bin in test_torch_split/test_torch_grower.
    x, y = raw_problem(41, n=4000, f=10, task=task, nan_frac=0.0)
    xv, yv = raw_problem(42, n=1500, f=10, task=task, nan_frac=0.0)
    # label noise so that the valid metric turns within 10 rounds
    rs = np.random.RandomState(43)
    if task == "binary":
        flip = rs.rand(len(y)) < 0.3
        y = np.where(flip, 1 - y, y).astype(np.float32)
    else:
        y = (y + 3.0 * rs.randn(len(y))).astype(np.float32)
    bt, evt = _train(lgt, task, x, y, xv, yv, {"device_type": "cpu"})
    bj, evj = _train(lgb, task, x, y, xv, yv,
                     {"tpu_learner": "masked", "fused_chunk": 1,
                      "superepoch": -1})
    return task, xv, bt, evt, bj, evj


def test_early_stopping_and_trees_equal(trained):
    task, xv, bt, evt, bj, evj = trained
    assert bt.best_iteration == bj.best_iteration
    assert 1 < bt.best_iteration < 10     # early stopping really stopped
    assert bt.num_trees() == bj.num_trees()
    assert _structure(bt.model_to_string()) \
        == _structure(bj.model_to_string())
    for name, metrics in evj["valid_0"].items():
        np.testing.assert_allclose(evt["valid_0"][name], metrics, rtol=1e-5)


def test_predictions_close(trained):
    task, xv, bt, evt, bj, evj = trained
    for raw in (False, True):
        pt = bt.predict(xv, raw_score=raw)
        pj = np.asarray(bj.predict(xv, raw_score=raw))
        np.testing.assert_allclose(pt, pj, rtol=PRED_RTOL,
                                   atol=PRED_RTOL * np.abs(pj).max())


def test_jax_model_text_predicts_the_same(trained):
    task, xv, bt, evt, bj, evj = trained
    text = bj.model_to_string()
    port = lgt.Booster(model_str=text)
    # a loaded booster has no best_iteration: both predict with all trees
    np.testing.assert_array_equal(
        port.predict(xv, raw_score=True),
        np.asarray(bj.predict(xv, raw_score=True, num_iteration=-1)))
    np.testing.assert_allclose(
        port.predict(xv), np.asarray(bj.predict(xv, num_iteration=-1)),
        rtol=1e-6)
    assert port.model_to_string() \
        == lgb.Booster(model_str=text).model_to_string()


def test_round_trip_and_rerun_are_byte_identical(trained):
    task, xv, bt, evt, bj, evj = trained
    text = bt.model_to_string()
    again = lgt.Booster(model_str=text)
    np.testing.assert_array_equal(again.predict(xv),
                                  bt.predict(xv, num_iteration=-1))
    x, y = raw_problem(44, n=1500, f=6, task=task)
    params = {**TASKS[task], "num_leaves": 7, "max_bin": 15,
              "verbosity": -1, "device_type": "cpu"}
    t1 = lgt.train(params, lgt.Dataset(x, y), 4).model_to_string()
    t2 = lgt.train(params, lgt.Dataset(x, y), 4).model_to_string()
    assert t1 == t2


@pytest.mark.parametrize("task", sorted(TASKS))
def test_gradients_match_jax(task):
    from lightgbm_torch.config import Config as TConfig
    from lightgbm_torch.dataset import Metadata as TMeta
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.dataset import Metadata as JMeta
    import jax.numpy as jnp
    rs = np.random.RandomState(45)
    n = 2000
    label = (rs.rand(n) < 0.4).astype(np.float32) if task == "binary" \
        else rs.randn(n).astype(np.float32)
    weight = (0.5 + rs.rand(n)).astype(np.float32)
    score = (2.0 * rs.randn(n)).astype(np.float32)
    cls_t = BinaryLogloss if task == "binary" else RegressionL2
    cls_j = jobj.BinaryLogloss if task == "binary" else jobj.RegressionL2
    ot, oj = cls_t(TConfig({"objective": task})), \
        cls_j(JConfig({"objective": task}))
    for meta_cls, obj in ((TMeta, ot), (JMeta, oj)):
        md = meta_cls(n)
        md.set_label(label)
        md.set_weight(weight)
        obj.init(md, n)
    gt, ht = ot.get_gradients(torch.as_tensor(score))
    gj, hj = oj.get_gradients(jnp.asarray(score))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=2e-6,
                               atol=1e-7)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=2e-6,
                               atol=1e-7)
    assert ot.boost_from_score(0) == pytest.approx(oj.boost_from_score(0),
                                                   rel=1e-6)
