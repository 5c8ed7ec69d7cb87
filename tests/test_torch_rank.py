"""B13a and B13b (``lightgbm_torch/ops/rank.py``): the plain versions that
the CPU runs, against the JAX package's ``LambdarankNDCG.get_gradients``
and ``RankXENDCG.get_gradients``, and the ranking metrics against the JAX
package's.

Queries of 1, 2, 16, 17, 64, 65, 256, 257 and 300 documents straddle the
JAX package's bucket widths (16, 64, 256, then the true maximum).  The
gradients and hessians agree within ``RTOL`` of the largest magnitude of
each array: both are f32 sums of the same pair terms in another order
(the JAX package's ``sum(axis)`` over padded buckets, the port's
``sum(dim)`` over chunks of queries).  ``inverse_max_dcg`` is the same
numpy code, bit for bit; XE-NDCG's draws are the bits of ``jax.random``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.dataset import Metadata as TMetadata
from lightgbm_torch.metrics import create_metric as t_metric
from lightgbm_torch.objectives import (LambdarankNDCG as TLambdarank,
                                       RankXENDCG as TXendcg)
from lightgbm_torch.ops import rank as trank
from lightgbm_torch.ops import random as trnd
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu.metrics import create_metric as j_metric
from lightgbm_tpu.objectives import LambdarankNDCG, RankXENDCG

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

SIZES = (1, 2, 16, 17, 64, 65, 256, 257, 300)
RTOL = 1e-5


def ranking_problem(seed: int, zero_query: bool = True):
    """Labels 0-4 over queries of ``SIZES`` (shuffled), one all-zero-label
    query (no gain) among them when ``zero_query``."""
    rs = np.random.RandomState(seed)
    sizes = np.asarray(SIZES)[rs.permutation(len(SIZES))]
    n = int(sizes.sum())
    label = rs.choice(5, n, p=[0.5, 0.3, 0.12, 0.05, 0.03]).astype(
        np.float32)
    if zero_query:
        q = int(np.nonzero(sizes == 17)[0][0])
        b = np.concatenate([[0], np.cumsum(sizes)])
        label[b[q]:b[q + 1]] = 0.0
    return sizes, label, rs


def _metadata(cls, sizes, label):
    md = cls(int(sizes.sum()))
    md.set_label(label)
    md.set_group(sizes)
    return md


def _objectives(name, sizes, label, **params):
    cfg = {"objective": name, **params}
    jo = {"lambdarank": LambdarankNDCG,
          "rank_xendcg": RankXENDCG}[name](JConfig(cfg))
    to = {"lambdarank": TLambdarank,
          "rank_xendcg": TXendcg}[name](TConfig({**cfg,
                                                 "device_type": "cpu"}))
    jo.init(_metadata(JMetadata, sizes, label), int(sizes.sum()))
    to.init(_metadata(TMetadata, sizes, label), int(sizes.sum()))
    return jo, to


def _close(t, j):
    t, j = np.asarray(t), np.asarray(j)
    scale = max(float(np.abs(j).max()), 1e-30)
    assert float(np.abs(t - j).max()) <= RTOL * scale


def _scores(kind: str, n: int, rs):
    if kind == "tied":           # iteration 0: every score equal
        return np.zeros(n, np.float32)
    if kind == "ties":           # random scores with many forced ties
        return (np.round(rs.randn(n) * 2) / 2).astype(np.float32)
    return rs.randn(n).astype(np.float32)


@pytest.mark.parametrize("kind", ["tied", "random", "ties"])
@pytest.mark.parametrize("params", [
    {}, {"lambdarank_truncation_level": 3}, {"lambdarank_norm": False},
    {"sigmoid": 2.0}], ids=["default", "trunc3", "no_norm", "sigmoid2"])
def test_lambdarank_matches_jax(kind, params):
    sizes, label, rs = ranking_problem(0)
    jo, to = _objectives("lambdarank", sizes, label, **params)
    score = _scores(kind, len(label), rs)
    gj, hj = jo.get_gradients(jnp.asarray(score))
    gt, ht = to.get_gradients(torch.as_tensor(score))
    _close(gt, gj)
    _close(ht, hj)
    # the all-zero-label query has no valid pair: g = 0, h at its floor
    b = np.concatenate([[0], np.cumsum(sizes)])
    q = int(np.nonzero(sizes == 17)[0][0])
    assert np.all(gt.numpy()[b[q]:b[q + 1]] == 0.0)
    assert np.all(ht.numpy()[b[q]:b[q + 1]] == np.float32(1e-9))


def test_inverse_max_dcg_bit_for_bit():
    sizes, label, _ = ranking_problem(1)
    for trunc in (30, 3, 1):
        jo, to = _objectives("lambdarank", sizes, label,
                             lambdarank_truncation_level=trunc)
        np.testing.assert_array_equal(to.inverse_max_dcg_np,
                                      np.asarray(jo.inverse_max_dcg))
        np.testing.assert_array_equal(to.label_gain.numpy(),
                                      np.asarray(jo.label_gain))


@pytest.mark.parametrize("kind", ["tied", "random", "ties"])
def test_ranks_are_the_stable_descending_argsort(kind):
    sizes, label, rs = ranking_problem(2)
    score = _scores(kind, len(label), rs)
    b = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    _, _, rank = trank.lambdarank_grad(
        torch.as_tensor(score), torch.as_tensor(label), torch.as_tensor(b),
        torch.tensor([0.0, 1.0, 3.0, 7.0, 15.0]),
        torch.ones(len(sizes)), trunc=30, norm=True, sigmoid=1.0,
        with_ranks=True)
    for q in range(len(sizes)):
        s = score[b[q]:b[q + 1]]
        want = np.argsort(np.argsort(-s, kind="stable"), kind="stable")
        np.testing.assert_array_equal(rank.numpy()[b[q]:b[q + 1]], want)


@pytest.mark.parametrize("kind", ["tied", "random"])
def test_xendcg_matches_jax_over_iterations(kind):
    sizes, label, rs = ranking_problem(3)
    jo, to = _objectives("rank_xendcg", sizes, label, objective_seed=11)
    for _ in range(3):                 # iterations 1, 2, 3: their own draws
        score = _scores(kind, len(label), rs)
        gj, hj = jo.get_gradients(jnp.asarray(score))
        gt, ht = to.get_gradients(torch.as_tensor(score))
        _close(gt, gj)
        _close(ht, hj)
    assert to._iter == jo._iter == 3


def test_xendcg_gamma_is_jax_random():
    sizes, label, _ = ranking_problem(4)
    b = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    key_it = trnd.fold_in(trnd.prng_key(5), 1)
    _, _, gamma = trank.xendcg_grad(
        torch.zeros(len(label)), torch.as_tensor(label), torch.as_tensor(b),
        key_it, with_gamma=True)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 1)
    for q in range(len(sizes)):
        m = int(sizes[q])
        want = np.asarray(jax.random.uniform(jax.random.fold_in(jkey, q),
                                             (m,)))
        np.testing.assert_array_equal(gamma.numpy()[b[q]:b[q + 1]], want)
        # the stream is partitionable: a longer draw starts the same
        longer = np.asarray(jax.random.uniform(jax.random.fold_in(jkey, q),
                                               (m + 40,)))
        np.testing.assert_array_equal(longer[:m], want)


def test_wrappers_check_inputs():
    b = torch.tensor([0, 2], dtype=torch.int32)
    s = torch.zeros(2)
    with pytest.raises(TypeError):
        trank.xendcg_grad(s, s, b.to(torch.int64), (0, 1))
    with pytest.raises(TypeError):
        trank.xendcg_grad(s.double(), s, b, (0, 1))
    with pytest.raises(TypeError):
        trank.lambdarank_grad(s, s, b, torch.ones(3), torch.ones(2),
                              trunc=3, norm=True, sigmoid=1.0)


@pytest.mark.parametrize("name,eval_at", [
    ("ndcg", None), ("ndcg", [1, 3, 10]), ("map", None), ("map", [2, 7])])
def test_ranking_metrics_match_jax(name, eval_at):
    sizes, label, rs = ranking_problem(6)
    params = {"metric": name}
    if eval_at is not None:
        params["eval_at"] = eval_at
    jm, tm = j_metric(name, JConfig(params)), t_metric(name,
                                                       TConfig(params))
    jm.init(_metadata(JMetadata, sizes, label), len(label))
    tm.init(_metadata(TMetadata, sizes, label), len(label))
    for kind in ("tied", "ties", "random"):
        score = _scores(kind, len(label), rs).astype(np.float64)
        assert tm.eval(score) == jm.eval(score)
