"""The ten pointwise objectives of the JAX package that the port adds
(regression_l1, huber, fair, poisson, quantile, mape, gamma, tweedie,
cross_entropy, cross_entropy_lambda), their leaf renewal and the metrics,
against the JAX package on the CPU.

- Gradients and hessians agree within ``GRAD_RTOL`` of each array's
  largest magnitude: the same f32 formulas, whose transcendental functions
  (exp, sigmoid, softplus) round differently in the two libraries by an
  ulp or two.  cross_entropy_lambda, whose JAX form is ``jax.grad`` of
  the clipped loss and whose port is its closed form, within
  ``XENT_LAMBDA_RTOL``.
- The renewed leaf values and the percentile ``boost_from_score`` (l1,
  quantile, mape) are the same numpy code on the same f32 arrays: equal
  bit for bit; the mean-based ``boost_from_score`` takes the f32 label
  mean, which the two libraries sum in other orders, through a log or a
  logit: within ``BOOST_ATOL``.  ``convert_output`` within ``GRAD_RTOL``.
- Training (15 leaves, 5 rounds, ``tpu_learner="masked"`` for the JAX
  package): the first tree's structure is equal and its leaf values within
  ``LEAF_RTOL`` of the largest; the predictions after 5 rounds within
  ``PRED_RTOL`` of the largest (the histograms' f32 sums part in their
  last bits).  The port's paths write equal model text, and l1, quantile
  and mape refuse fusion with the JAX package's reason.
- Each metric's value equals the JAX package's (the same numpy code).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.dataset import Metadata as TMetadata
from lightgbm_torch.metrics import create_metric as t_metric
from lightgbm_torch.objectives import create_objective as t_objective
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metric as j_metric
from lightgbm_tpu.objectives import create_objective as j_objective

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

GRAD_RTOL = 2e-6
BOOST_ATOL = 2e-6
XENT_LAMBDA_RTOL = 1e-5
LEAF_RTOL = 1e-5
PRED_RTOL = 1e-4
RENEWING = ("regression_l1", "quantile", "mape")
OBJECTIVES = ("regression_l1", "huber", "fair", "poisson", "quantile",
              "mape", "gamma", "tweedie", "cross_entropy",
              "cross_entropy_lambda")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")


def target(obj: str, n: int, seed: int):
    """Features and a label in the objective's domain, from a hidden
    function of the features."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype(np.float32)
    base = x[:, 0] + 0.5 * x[:, 1] ** 2 - 0.4 * x[:, 2] + 0.3 * rs.randn(n)
    if obj == "poisson":
        y = rs.poisson(np.exp(0.4 * base))
    elif obj == "gamma":
        y = rs.gamma(2.0, np.exp(0.3 * base) / 2.0)
    elif obj == "tweedie":
        y = rs.poisson(np.exp(0.3 * base)) * rs.gamma(2.0, 1.0, n)
    elif obj in ("cross_entropy", "cross_entropy_lambda"):
        y = 1.0 / (1.0 + np.exp(-base))
    elif obj == "mape":
        y = 5.0 + base
    else:
        y = base
    return x, np.asarray(y, np.float32)


def _pair(obj, label, weight=None, **params):
    cfg = {"objective": obj, **params}
    jo, to = j_objective(JConfig(cfg)), t_objective(
        TConfig({**cfg, "device_type": "cpu"}))
    for o, md_cls in ((jo, JMetadata), (to, TMetadata)):
        md = md_cls(len(label))
        md.set_label(label)
        if weight is not None:
            md.set_weight(weight)
        o.init(md, len(label))
    return jo, to


def _close(t, j, rtol):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert np.all(np.isfinite(t)) and np.all(np.isfinite(j))
    assert float(np.abs(t - j).max()) <= rtol * max(float(np.abs(j).max()),
                                                    1e-30)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("obj", OBJECTIVES)
def test_gradients_match_jax(obj, weighted):
    _, y = target(obj, 3000, 0)
    rs = np.random.RandomState(1)
    w = (0.5 + rs.rand(len(y))).astype(np.float32) if weighted else None
    jo, to = _pair(obj, y, w)
    score = (4.0 * rs.randn(len(y))).astype(np.float32)
    if obj == "cross_entropy_lambda":
        # lambda w below about 16.6, where p = 1 - exp(-lambda w) stays
        # under 1 in f32 (past it the JAX package's autodiff of log1p(-p)
        # is not finite; the port gives the clip's flat 0 and 1e-9), and
        # a few rows deep in the clip's lower end (p < 1e-12: grad 0)
        score = np.clip(score, -8.0, 8.0)
        score[::97] = -40.0
    gj, hj = jo.get_gradients(jnp.asarray(score))
    gt, ht = to.get_gradients(torch.as_tensor(score))
    rtol = XENT_LAMBDA_RTOL if obj == "cross_entropy_lambda" else GRAD_RTOL
    _close(gt, gj, rtol)
    _close(ht, hj, rtol)
    if obj in RENEWING:              # a percentile: the same numpy code
        assert to.boost_from_score(0) == jo.boost_from_score(0)
    else:                            # the f32 label mean, summed in another
        np.testing.assert_allclose(  # order by the two libraries
            to.boost_from_score(0), jo.boost_from_score(0), rtol=0,
            atol=BOOST_ATOL)
    raw = np.linspace(-6, 6, 101).astype(np.float32)
    _close(to.convert_output(torch.as_tensor(raw)),
           jo.convert_output(jnp.asarray(raw)), GRAD_RTOL)


@pytest.mark.parametrize("params", [{}, {"alpha": 0.3}])
@pytest.mark.parametrize("obj", RENEWING)
def test_renewal_matches_jax(obj, params):
    _, y = target(obj, 2000, 2)
    rs = np.random.RandomState(3)
    w = (0.5 + rs.rand(len(y))).astype(np.float32)
    for weight in (None, w):
        jo, to = _pair(obj, y, weight, **params)
        score = (0.3 * rs.randn(len(y))).astype(np.float32)
        leaf_of_row = rs.randint(0, 9, len(y)).astype(np.int32)
        leaf_of_row[leaf_of_row == 4] = 3      # leaf 4 without rows keeps
        values = rs.randn(9)
        np.testing.assert_array_equal(
            to.renew_leaf_values(score, leaf_of_row, 9, values.copy()),
            jo.renew_leaf_values(score, leaf_of_row, 9, values.copy()))


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _field(tree_text, name):
    for ln in tree_text.splitlines():
        if ln.startswith(name + "="):
            return np.asarray(ln.split("=")[1].split(), np.float64)
    raise KeyError(name)


def _without_paths(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


@pytest.mark.parametrize("obj", OBJECTIVES)
def test_training_matches_jax_on_every_path(obj):
    x, y = target(obj, 2500, 4)
    p = {"objective": obj, "num_leaves": 15, "verbosity": -1,
         "learning_rate": 0.1}
    bj = lgb.train({**p, "device_type": "cpu", "tpu_learner": "masked"},
                   lgb.Dataset(x, label=y), 5)
    paths = {"per_iteration": {"superepoch": -1, "fused_chunk": 1}}
    if obj not in RENEWING:
        paths["fused_chunk"] = {"fused_chunk": 5}
    texts = {}
    for path, extra in paths.items():
        bt = lgt.train({**p, **extra, "device_type": "cpu"},
                       lgt.Dataset(x, y), 5)
        texts[path] = _without_paths(bt.model_to_string())
        assert bt._model.fetch_counts.get(
            "tree" if path == "per_iteration" else "epoch", 0) >= 1
    assert len(set(texts.values())) == 1
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 5
    assert [ln for ln in tt[0].splitlines()
            if ln.split("=")[0] in STRUCTURAL] == \
        [ln for ln in tj[0].splitlines() if ln.split("=")[0] in STRUCTURAL]
    lj = _field(tj[0], "leaf_value")
    np.testing.assert_allclose(_field(tt[0], "leaf_value"), lj, rtol=0,
                               atol=LEAF_RTOL * np.abs(lj).max())
    pj = np.asarray(bj.predict(x))
    np.testing.assert_allclose(bt.predict(x), pj, rtol=0,
                               atol=PRED_RTOL * np.abs(pj).max())
    assert f"objective={obj}" in "\n".join(
        ln.split(" ")[0] for ln in bt.model_to_string().splitlines())
    reason = (f"objective={obj} renews leaf outputs host-side "
              "(RenewTreeOutput)")
    assert (reason in bt._model.fused_reasons()) == (obj in RENEWING)
    assert (reason in bj._model.fused_reasons()) == (obj in RENEWING)


@pytest.mark.parametrize("name", [
    "quantile", "huber", "fair", "poisson", "mape", "gamma",
    "gamma_deviance", "tweedie", "average_precision", "cross_entropy",
    "cross_entropy_lambda", "kldiv"])
def test_metrics_match_jax(name):
    obj = {"poisson": "poisson", "gamma": "gamma", "gamma_deviance": "gamma",
           "tweedie": "tweedie", "mape": "mape", "average_precision":
           "cross_entropy", "cross_entropy": "cross_entropy",
           "cross_entropy_lambda": "cross_entropy", "kldiv":
           "cross_entropy"}.get(name, "huber")
    _, y = target(obj, 3000, 5)
    if name == "average_precision":
        y = (y > 0.5).astype(np.float32)
    rs = np.random.RandomState(6)
    score = rs.randn(len(y))
    for weight in (None, (0.5 + rs.rand(len(y))).astype(np.float32)):
        vals = []
        for create, md_cls, cfg in ((j_metric, JMetadata, JConfig),
                                    (t_metric, TMetadata, TConfig)):
            m = create(name, cfg({"alpha": 0.7}))
            md = md_cls(len(y))
            md.set_label(y)
            if weight is not None:
                md.set_weight(weight)
            m.init(md, len(y))
            vals.append(m.eval(score))
        assert vals[0] == vals[1]


def test_every_objective_and_metric_is_ported():
    from lightgbm_torch import metrics as tm, objectives as to
    from lightgbm_tpu import metrics as jm, objectives as jo
    assert sorted(to._OBJECTIVES) == sorted(jo._OBJECTIVES)
    assert sorted(tm._METRICS) == sorted(jm._METRICS)
