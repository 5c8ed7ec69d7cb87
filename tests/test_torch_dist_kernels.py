"""The distributed learners' kernels (B16a-c) as their plain versions on
the CPU, against the JAX package's functions on the same inputs:

- B16a (``ops/split.gather_best``) against ``gather_best(
  globalize_feature(...))`` under ``shard_map`` on S = 2, 4 and 8 of the
  conftest's 8 virtual CPU devices (vmapped over the children, as the JAX
  grower calls it), and against the feature-parallel offset form: cross-
  rank gain ties, a pad slot and categorical rank rows; exact;
- B16b (``ops/vote.vote_gains``) against ``_local_feature_gains`` and
  ``lax.top_k`` with L1/L2, rescaled constraints and a dequantized int32
  input: gains within ``GAIN_RTOL``, votes exact;
- B16c (``ops/vote.vote_select``) against ``lax.top_k(votes * 1e12 +
  gain_sum, 2k)`` with tied scores, and the masked histogram: exact, f32
  and int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import PartitionSpec as P

from lightgbm_torch.ops import split as tsp
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_torch.ops.vote import (vote_gains, vote_gains_plain,
                                     vote_select)
from lightgbm_torch.parallel.mesh import owner_shard_plan as t_plan
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.ops.split import (SplitResult, dequantize_hist,
                                    gather_best, globalize_feature)
from lightgbm_tpu.parallel.mesh import make_mesh
from lightgbm_tpu.parallel.mesh import owner_shard_plan as j_plan
from lightgbm_tpu.parallel.voting_parallel import _local_feature_gains
from lightgbm_tpu.utils.jax_compat import shard_map

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

GAIN_RTOL = 1e-6
B = 8


def _records(S, C, fmax, seed, pad_slot):
    """S ranks' best-split records of C children: gains with cross-rank
    ties (children 0 and 1), an all -inf child (2), a winning pad slot on
    the last rank (child 3, with ``pad_slot``), categorical flags and
    rank rows."""
    rs = np.random.RandomState(seed)
    gain = rs.uniform(0.5, 2.0, (S, C)).astype(np.float32)
    gain[:, 0] = 1.75                        # every rank ties
    gain[1::2, 1] = 3.0                      # the odd ranks tie
    gain[:, 2] = -np.inf
    feat = rs.randint(0, fmax, (S, C)).astype(np.int32)
    if pad_slot is not None:
        gain[:, 3] = -np.inf
        feat[-1, 3] = pad_slot
    thr = rs.randint(0, B, (S, C)).astype(np.int32)
    dl = rs.rand(S, C) < 0.5
    ls = rs.uniform(-5, 5, (S, C, 3)).astype(np.float32)
    rsum = rs.uniform(-5, 5, (S, C, 3)).astype(np.float32)
    lo = rs.randn(S, C).astype(np.float32)
    ro = rs.randn(S, C).astype(np.float32)
    cat = rs.rand(S, C) < 0.3
    rank = np.stack([[rs.permutation(B) for _ in range(C)]
                     for _ in range(S)]).astype(np.int32)
    return gain, feat, thr, dl, ls, rsum, lo, ro, cat, rank


def _port_recs(gain, feat, thr, dl, ls, rsum, lo, ro):
    S, C = gain.shape
    rec = np.zeros((S, C, tsp.RECORD), np.float32)
    rec[..., tsp.GAIN] = gain
    rec[..., tsp.FEATURE] = feat
    rec[..., tsp.THRESHOLD] = thr
    rec[..., tsp.DEFAULT_LEFT] = dl
    rec[..., tsp.LEFT_SUM] = ls
    rec[..., tsp.RIGHT_SUM] = rsum
    rec[..., tsp.LEFT_OUTPUT] = lo
    rec[..., tsp.RIGHT_OUTPUT] = ro
    return torch.as_tensor(rec)


def _jax_select(S, arrays, gfid=None, f_local=None):
    """The JAX package's select on S virtual devices: per rank and child
    ``globalize_feature`` (or the offset), then ``gather_best`` vmapped
    over the children."""
    mesh = make_mesh((S,), ("data",), jax.devices()[:S])
    gain, feat, thr, dl, ls, rsum, lo, ro, cat, rank = arrays

    def body(*a):
        a = [x[0] for x in a]
        res = SplitResult(gain=a[0], feature=a[1], threshold=a[2],
                          default_left=a[3], left_sum=a[4], right_sum=a[5],
                          left_output=a[6], right_output=a[7], is_cat=a[8],
                          bin_rank=a[9])
        idx = lax.axis_index("data")
        if gfid is not None:
            g = jnp.asarray(gfid)[idx]
            res = jax.vmap(lambda r: globalize_feature(r, g))(res)
        else:
            res = res._replace(feature=res.feature + idx * f_local)
        out = jax.vmap(lambda r: gather_best(r, "data"))(res)
        return jax.tree.map(lambda x: x[None], out)

    fn = shard_map(body, mesh=mesh, in_specs=(P("data"),) * 10,
                   out_specs=P("data"), check_vma=False)
    out = jax.jit(fn)(*(jnp.asarray(x) for x in arrays))
    return jax.tree.map(lambda x: np.asarray(x)[0], out)


def _assert_select_equal(t, j):
    rec, cat, rank = (x.numpy() for x in t)
    np.testing.assert_array_equal(rec[:, tsp.GAIN], j.gain)
    np.testing.assert_array_equal(rec[:, tsp.FEATURE].astype(np.int32),
                                  j.feature)
    np.testing.assert_array_equal(rec[:, tsp.THRESHOLD].astype(np.int32),
                                  j.threshold)
    np.testing.assert_array_equal(rec[:, tsp.DEFAULT_LEFT] != 0,
                                  j.default_left)
    np.testing.assert_array_equal(rec[:, tsp.LEFT_SUM], j.left_sum)
    np.testing.assert_array_equal(rec[:, tsp.RIGHT_SUM], j.right_sum)
    np.testing.assert_array_equal(rec[:, tsp.LEFT_OUTPUT], j.left_output)
    np.testing.assert_array_equal(rec[:, tsp.RIGHT_OUTPUT],
                                  j.right_output)
    np.testing.assert_array_equal(cat != 0, j.is_cat)
    np.testing.assert_array_equal(rank, j.bin_rank)


@pytest.mark.parametrize("S", [2, 4, 8])
def test_gather_best_owner_plan_equals_jax(S):
    F = 3 * S - 1                 # the last rank owns a pad slot
    jp = j_plan(np.arange(F), S)
    tp = t_plan(np.arange(F), S)
    np.testing.assert_array_equal(tp.shard_feat, jp.shard_feat)
    pad = int(np.argmax(jp.shard_feat[-1] < 0))
    assert jp.shard_feat[-1, pad] == -1
    arrays = _records(S, 6, jp.fmax, seed=S, pad_slot=pad)
    j = _jax_select(S, arrays, gfid=jp.shard_feat)
    gain, feat, thr, dl, ls, rsum, lo, ro, cat, rank = arrays
    t = tsp.gather_best(
        _port_recs(gain, feat, thr, dl, ls, rsum, lo, ro),
        torch.as_tensor(cat.astype(np.int32)), torch.as_tensor(rank),
        shard_feat=torch.as_tensor(tp.shard_feat))
    _assert_select_equal(t, j)
    # the all -inf pad child resolves to feature 0 (the serial argmax's)
    assert int(t[0][3, tsp.FEATURE]) == int(j.feature[3])


@pytest.mark.parametrize("S", [2, 4, 8])
def test_gather_best_offset_form_equals_jax(S):
    f_local = 3
    arrays = _records(S, 5, f_local, seed=10 + S, pad_slot=None)
    j = _jax_select(S, arrays, f_local=f_local)
    gain, feat, thr, dl, ls, rsum, lo, ro, cat, rank = arrays
    t = tsp.gather_best(
        _port_recs(gain, feat, thr, dl, ls, rsum, lo, ro),
        torch.as_tensor(cat.astype(np.int32)), torch.as_tensor(rank),
        f_local=f_local)
    _assert_select_equal(t, j)


def test_gather_best_numerical_records_and_inactive_step():
    S, C = 4, 3
    arrays = _records(S, C + 1, 5, seed=3, pad_slot=None)
    gain, feat, thr, dl, ls, rsum, lo, ro, _, _ = arrays
    recs = _port_recs(gain, feat, thr, dl, ls, rsum, lo, ro)
    plan = torch.as_tensor(t_plan(np.arange(20), S).shard_feat)
    rec = tsp.gather_best(recs, shard_feat=plan)
    full = tsp.gather_best(recs, torch.zeros((S, C + 1), dtype=torch.int32),
                           torch.zeros((S, C + 1, B), dtype=torch.int32),
                           shard_feat=plan)
    assert torch.equal(rec, full[0])
    # a dead step's select computes nothing
    dead = tsp.gather_best(recs, shard_feat=plan,
                           active=torch.zeros(1, dtype=torch.int32))
    assert dead.shape == rec.shape
    live = tsp.gather_best(recs, shard_feat=plan,
                           active=torch.ones(1, dtype=torch.int32))
    assert torch.equal(live, rec)


def _hist(seed, F, nb=16):
    """A histogram [F, nb, 3] of dyadic sums (every prefix sum exact in
    f32, so the order of the sums does not matter): gradient eighths,
    positive hessian sixteenths, integer counts."""
    rs = np.random.RandomState(seed)
    g = rs.randint(-40, 40, (F, nb)) / 8.0
    h = rs.randint(1, 30, (F, nb)) / 16.0
    c = rs.randint(0, 9, (F, nb)).astype(np.float64)
    return np.stack([g, h, c], -1).astype(np.float32)


@pytest.mark.parametrize("S,l1,l2,md,mh", [
    (2, 0.0, 0.0, 20, 1e-3),
    (4, 0.5, 1.5, 11, 0.25),
    (8, 2.0, 0.0, 3, 2.0),
])
def test_vote_gains_equal_jax(S, l1, l2, md, mh):
    F, k = 28, 4
    h = _hist(S, F)
    jp = JParams(lambda_l1=l1, lambda_l2=l2, min_data_in_leaf=md,
                 min_sum_hessian_in_leaf=mh)
    tp = TParams(lambda_l1=l1, lambda_l2=l2, min_data_in_leaf=md,
                 min_sum_hessian_in_leaf=mh)
    jg = np.asarray(_local_feature_gains(jnp.asarray(h), jp, S))
    _, jtop = lax.top_k(jnp.asarray(jg), k)
    jvotes = np.zeros(F, np.float32)
    jvotes[np.asarray(jtop)] = 1.0
    votes, fin = vote_gains(torch.as_tensor(h), tp, S, k)
    assert np.isfinite(jg).sum() > k
    np.testing.assert_array_equal(votes.numpy(), jvotes)
    want = np.where(np.isfinite(jg), jg, 0.0).astype(np.float32)
    np.testing.assert_allclose(fin.numpy(), want, rtol=GAIN_RTOL, atol=0)


def test_vote_gains_dequantized_int32_equals_jax():
    F, S, k = 20, 4, 5
    rs = np.random.RandomState(7)
    hi = np.stack([rs.randint(-300, 300, (F, 32)),
                   rs.randint(1, 200, (F, 32)),
                   rs.randint(0, 9, (F, 32))], -1).astype(np.int32)
    scales = np.asarray([2.0 ** -6, 2.0 ** -7, 1.0], np.float32)
    jp = JParams(lambda_l2=1.0, min_data_in_leaf=8)
    jg = np.asarray(_local_feature_gains(
        dequantize_hist(jnp.asarray(hi), jnp.asarray(scales)), jp, S))
    _, jtop = lax.top_k(jnp.asarray(jg), k)
    votes, fin = vote_gains(torch.as_tensor(hi), TParams(
        lambda_l2=1.0, min_data_in_leaf=8), S, k,
        scales=torch.as_tensor(scales))
    np.testing.assert_array_equal(np.nonzero(votes.numpy())[0],
                                  np.sort(np.asarray(jtop)))
    np.testing.assert_allclose(
        fin.numpy(), np.where(np.isfinite(jg), jg, 0.0), rtol=GAIN_RTOL)
    # the f32 and the folded-scale int32 forms read the same values
    vf, ff = vote_gains_plain(torch.as_tensor(hi).float()
                              * torch.as_tensor(scales),
                              TParams(lambda_l2=1.0, min_data_in_leaf=8),
                              S, k)
    assert torch.equal(vf, votes) and torch.equal(ff, fin)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_vote_select_equals_jax_top_k(dtype):
    F, k2 = 12, 4
    rs = np.random.RandomState(1)
    votes = rs.randint(0, 2, F).astype(np.float32)
    gsum = rs.uniform(0, 4, F).astype(np.float32)
    # tied scores across the cut: at 2e12 an f32 score has no room for
    # the gains, so features 3, 7 and 9 (two votes each) tie
    votes[[3, 7, 9]] = 2.0
    votes[[0, 1]] = 3.0
    score = votes * np.float32(1e12) + gsum
    _, sel = lax.top_k(jnp.asarray(score), k2)
    mask = np.zeros(F, bool)
    mask[np.asarray(sel)] = True
    assert mask[[3, 7]].all() and not mask[9]
    h = rs.randint(-50, 50, (F, 6, 3)).astype(dtype)
    want = np.asarray(jnp.where(jnp.asarray(mask)[:, None, None],
                                jnp.asarray(h), jnp.zeros((), h.dtype)))
    got = vote_select(torch.as_tensor(votes), torch.as_tensor(gsum),
                      torch.as_tensor(h.copy()), k2)
    np.testing.assert_array_equal(got.numpy(), want)


def test_vote_select_zeroes_non_finite_rows():
    h = torch.full((4, 3, 3), float("inf"))
    out = vote_select(torch.tensor([1.0, 0.0, 0.0, 0.0]), torch.zeros(4),
                      h, 1)
    assert torch.isinf(out[0]).all() and bool((out[1:] == 0).all())
