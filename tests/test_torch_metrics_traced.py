"""Traced metrics (kernel B12): the port's plain versions against the JAX
package's ``_t_*`` functions on the same numpy-made inputs, with tie
groups and zero-weight rows.  AUC agrees within 1e-6 absolute, the
pointwise metrics within 1e-6 relative (f32 sums taken in another
order).  On the CPU the wrappers run the plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch import metrics as tm
from lightgbm_torch.config import Config as TConfig
from lightgbm_tpu import metrics as jm
from lightgbm_tpu.config import Config as JConfig

torch.set_num_threads(2)

AUC_ATOL = 1e-6
RTOL = 1e-6

CASES = [
    # (seed, rows, score rounding step (ties), share of zero weights)
    (1, 7, 0.0, 0.0),
    (2, 300, 0.25, 0.2),
    (3, 3000, 0.05, 0.1),
    (4, 5000, 0.0, 0.5),
    (5, 2048, 1.0, 0.0),
]


def _inputs(seed, n, step, zero_share, binary=True):
    rs = np.random.RandomState(seed)
    score = (1.5 * rs.randn(n)).astype(np.float32)
    if step > 0:
        score = (np.round(score / step) * step).astype(np.float32)
    label = ((rs.rand(n) < 0.4).astype(np.float32) if binary
             else (score + rs.randn(n)).astype(np.float32))
    weight = (0.5 + rs.rand(n)).astype(np.float32)
    weight[rs.rand(n) < zero_share] = 0.0
    return score, label, weight


def _both(score, label, weight):
    t = tuple(torch.as_tensor(a) for a in (score, label, weight))
    j = tuple(jnp.asarray(a) for a in (score, label, weight))
    return t, j


@pytest.mark.parametrize("seed,n,step,zero_share", CASES)
def test_auc_matches_jax(seed, n, step, zero_share):
    score, label, weight = _inputs(seed, n, step, zero_share)
    t, j = _both(score, label, weight)
    want = float(jm._t_auc(JConfig({}))(*j))
    got = tm.traced_auc_plain(*t)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= AUC_ATOL
    # the wrapper runs the plain version on CPU tensors
    assert float(tm.traced_auc(*t)) == float(got)


@pytest.mark.parametrize("metric", ["binary_logloss", "l2", "rmse", "l1"])
@pytest.mark.parametrize("seed,n,step,zero_share", CASES[1:])
def test_pointwise_matches_jax(metric, seed, n, step, zero_share):
    score, label, weight = _inputs(seed, n, step, zero_share,
                                   binary=metric == "binary_logloss")
    t, j = _both(score, label, weight)
    want = float(jm.traced_metric_fn(metric, JConfig({}))(*j))
    got = tm.traced_metric_fn(metric, TConfig({}))(*t)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=RTOL, atol=0)


def test_auc_degenerate_sets_are_one():
    # no negative (or no positive) mass: the JAX function returns 1
    score, _, weight = _inputs(6, 50, 0.0, 0.0)
    for label in (np.ones(50, np.float32), np.zeros(50, np.float32)):
        t, j = _both(score, label, weight)
        assert float(tm.traced_auc_plain(*t)) == 1.0 \
            == float(jm._t_auc(JConfig({}))(*j))


def test_all_scores_tied_is_one_half():
    _, label, weight = _inputs(7, 400, 0.0, 0.3)
    score = np.full(400, 0.25, np.float32)
    t, j = _both(score, label, weight)
    assert float(tm.traced_auc_plain(*t)) == pytest.approx(0.5, abs=1e-7)
    assert abs(float(tm.traced_auc_plain(*t))
               - float(jm._t_auc(JConfig({}))(*j))) <= AUC_ATOL


def test_traced_eval_stacks_entries_and_refuses_untraced_metrics():
    score, label, weight = _inputs(8, 500, 0.1, 0.1)
    t, _ = _both(score, label, weight)
    spec = ((0, "valid_0", "auc", True), (0, "valid_0", "l1", False),
            (1, "valid_1", "binary_logloss", False))
    cfg = TConfig({})
    teval = tm.build_traced_eval(spec, cfg)
    svecs = [t[0], t[0] * 0.5]
    ops = [(t[1], t[2]), (t[1], t[2])]
    ev = teval(svecs, ops)
    assert ev.dtype == torch.float32 and ev.shape == (3,)
    assert float(ev[0]) == float(tm.traced_auc_plain(t[0], t[1], t[2]))
    assert float(ev[2]) == float(tm.traced_pointwise_plain(
        svecs[1], t[1], t[2], metric="binary_logloss"))
    # multiclass waits for ROADMAP A9: no traced form, so the engine
    # takes the per-iteration host path
    assert tm.traced_metric_fn("multi_logloss", cfg) is None
    assert tm.build_traced_eval(((0, "v", "multi_logloss", False),),
                                cfg) is None


def test_wrappers_check_inputs():
    x = torch.zeros(4)
    with pytest.raises(TypeError):
        tm.traced_auc(x, x, torch.zeros(3))
    with pytest.raises(TypeError):
        tm.traced_pointwise(x.double(), x, x, metric="l2")
