"""B2 with per-child operands, and the growers' per-node draws, against the
JAX package on the CPU (every kernel as its plain version):

- ``find_best_split`` with a [K, F] feature mask (``feature_fraction_bynode``)
  and a [K, F] ``rand_bin`` (``extra_trees``) against the JAX
  ``find_best_split`` leaf by leaf and against the JAX grower's ``_best2``
  (its vmap over a step's children) on the same histograms: the chosen
  (feature, threshold, direction) equal, float fields within ``RTOL``
  (only the prefix-sum order differs);
- an [F] mask equals the same mask repeated per child, and without the
  new operands the records are unchanged;
- whole trees of the strict (31 leaves) and batched (255 leaves, K = 16)
  growers with bynode and extra_trees against ``make_grower(...,
  bynode_frac, extra_trees)`` at two device iterations: the integer tree
  arrays and the row -> leaf vector equal.  The fixtures' gradients are
  multiples of 1/8 and their hessians 1, so both packages' histograms are
  exact and every draw meets the same gains."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.grower import (GrowWorkspace, fetch_tree, grow_tree,
                                   grow_tree_batched)
from lightgbm_torch.ops import split as ts
from lightgbm_torch.ops.random import NodeSampling
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import compute_histogram

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

RTOL = 1e-5
PARAMS = {"default": {}, "l1_l2": {"lambda_l1": 1.0, "lambda_l2": 2.0},
          "smooth": {"path_smooth": 3.0, "max_delta_step": 0.4,
                     "min_data_in_leaf": 40}}


def _leaves(K, seed=3, f=8, bins=31):
    """K leaves' histograms from random row subsets of one problem."""
    binned, vals, num_bin, na_bin = binned_problem(seed, n=5000, f=f,
                                                   bins=bins)
    rs = np.random.RandomState(seed)
    hists, totals = [], []
    for _ in range(K):
        rows = rs.rand(len(binned)) < rs.uniform(0.2, 0.9)
        h = np.asarray(compute_histogram(jnp.asarray(binned[rows]),
                                         jnp.asarray(vals[rows]),
                                         num_bins=bins))
        hists.append(h)
        totals.append(vals[rows].sum(axis=0))
    return (np.stack(hists), np.stack(totals).astype(np.float32), num_bin,
            na_bin)


def _operands(K, f, num_bin, seed):
    rs = np.random.RandomState(seed)
    mask = rs.rand(K, f) < 0.6
    mask[:, 0] = rs.rand(K) < 0.5
    rand_bin = np.minimum((rs.rand(K, f) * np.maximum(num_bin - 1, 1)
                           ).astype(np.int32), num_bin - 2)
    return mask, rand_bin


def _port(hist, total, parent, num_bin, na_bin, mask, params, rand_bin):
    rec = ts.find_best_split(
        torch.as_tensor(hist), torch.as_tensor(total),
        torch.as_tensor(parent), torch.as_tensor(num_bin),
        torch.as_tensor(na_bin), torch.as_tensor(mask),
        ts.SplitParams(**params),
        rand_bin=None if rand_bin is None else torch.as_tensor(rand_bin))
    return ts.unpack(rec)


def _same(rt, k, feature, threshold, default_left, floats):
    assert int(rt.feature[k]) == int(feature)
    assert int(rt.threshold[k]) == int(threshold)
    assert bool(rt.default_left[k]) == bool(default_left)
    got = (rt.gain[k], rt.left_sum[k], rt.right_sum[k], rt.left_output[k],
           rt.right_output[k])
    for a, b in zip(got, floats):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if np.isinf(b).any():
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max())


@pytest.mark.parametrize("params", sorted(PARAMS))
@pytest.mark.parametrize("operands", ["mask", "rand_bin", "both"])
def test_per_child_operands_match_jax_leaf_by_leaf(params, operands):
    K = 8
    hist, total, num_bin, na_bin = _leaves(K)
    f = hist.shape[1]
    mask, rand_bin = _operands(K, f, num_bin, seed=len(params) + K)
    if operands == "rand_bin":
        mask = np.ones((K, f), bool)
    rb = None if operands == "mask" else rand_bin
    parent = np.linspace(-0.2, 0.2, K).astype(np.float32)
    rt = _port(hist, total, parent, num_bin, na_bin, mask, PARAMS[params],
               rb)
    pj = js.SplitParams(**PARAMS[params])
    found = 0
    for k in range(K):
        kw = {} if rb is None else {"rand_bin": jnp.asarray(rb[k])}
        rj = js.find_best_split(jnp.asarray(hist[k]), jnp.asarray(total[k]),
                                jnp.asarray(num_bin), jnp.asarray(na_bin),
                                jnp.asarray(mask[k]), pj,
                                jnp.float32(parent[k]), **kw)
        _same(rt, k, rj.feature, rj.threshold, rj.default_left,
              (rj.gain, rj.left_sum, rj.right_sum, rj.left_output,
               rj.right_output))
        if np.isfinite(float(rj.gain)):
            found += 1
            assert mask[k, int(rj.feature)]
            if rb is not None:
                assert int(rj.threshold) == rb[k, int(rj.feature)]
    assert found >= K // 2


def _closure(fn, name):
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


@pytest.mark.parametrize("K", [2, 32])
def test_per_child_operands_match_jax_best2(K):
    """The JAX grower's own batch of a step's children (``_best2`` with
    ``rand2`` and ``fmask2``), with NA features in both directions."""
    hist, total, num_bin, na_bin = _leaves(K, seed=K)
    f = hist.shape[1]
    mask, rand_bin = _operands(K, f, num_bin, seed=K)
    parent = np.zeros(K, np.float32)
    grow = make_grower(num_leaves=7, num_bins=31, params=js.SplitParams(),
                       bynode_frac=0.5, extra_trees=True, jit=False)
    best2 = _closure(grow, "_best2")
    rj = best2(jnp.asarray(hist), jnp.asarray(total), jnp.asarray(num_bin),
               jnp.asarray(na_bin), jnp.ones(f, bool), jnp.asarray(parent),
               None, jnp.asarray(rand_bin), fmask2=jnp.asarray(mask))
    rt = _port(hist, total, parent, num_bin, na_bin, mask, {}, rand_bin)
    for k in range(K):
        _same(rt, k, rj.feature[k], rj.threshold[k], rj.default_left[k],
              (rj.gain[k], rj.left_sum[k], rj.right_sum[k],
               rj.left_output[k], rj.right_output[k]))
    if K > 2:
        # some child takes its split with NA rows sent left
        assert bool(rt.default_left.any())


def test_one_mask_row_equals_the_repeated_row():
    K = 4
    hist, total, num_bin, na_bin = _leaves(K, seed=9)
    f = hist.shape[1]
    row = np.random.RandomState(1).rand(f) < 0.7
    parent = np.zeros(K, np.float32)
    a = _port(hist, total, parent, num_bin, na_bin, row, {}, None)
    b = _port(hist, total, parent, num_bin, na_bin,
              np.broadcast_to(row, (K, f)).copy(), {}, None)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_rand_bin_out_of_range_leaves_no_split():
    """A one-bin feature's random bin is -1 (num_bin - 2): no threshold
    is valid, in either direction."""
    K = 2
    hist, total, num_bin, na_bin = _leaves(K, seed=4)
    f = hist.shape[1]
    rb = np.full((K, f), -1, np.int32)
    rt = _port(hist, total, np.zeros(K, np.float32), num_bin, na_bin,
               np.ones((K, f), bool), {}, rb)
    assert torch.isneginf(rt.gain).all()


def _exact_problem(seed, f=8):
    binned, vals, num_bin, na_bin = binned_problem(seed, n=6000, f=f,
                                                   bins=31)
    out = np.ones_like(vals)
    out[:, 0] = np.round(8.0 * vals[:, 0]) / 8.0
    return binned, out, num_bin, na_bin


@pytest.mark.parametrize("L,K", [(31, 1), (255, 16)])
@pytest.mark.parametrize("mode", ["bynode", "extra", "both"])
def test_grower_node_draws_match_jax(L, K, mode):
    binned, vals, num_bin, na_bin = _exact_problem(21)
    n, f = binned.shape
    frac = 0.6 if mode != "extra" else 1.0
    extra = mode != "bynode"
    samp = NodeSampling(bynode_frac=frac, bynode_seed=5, extra_trees=extra,
                        extra_seed=7)
    mask = np.ones(f, bool)
    mask[3] = False                    # the tree's feature_fraction mask
    params = {"min_data_in_leaf": 8}
    grow = make_grower(num_leaves=L, num_bins=31,
                       params=js.SplitParams(**params), split_batch=K,
                       bynode_frac=frac, bynode_seed=5, extra_trees=extra,
                       extra_seed=7)
    ws = GrowWorkspace(n, f, 31, L, torch.device("cpu"), split_batch=K)
    port = grow_tree if K == 1 else grow_tree_batched
    kw = {} if K == 1 else {"split_batch": K}
    leaves = []
    for it in (0, 3):
        tj = grow(*(jnp.asarray(a) for a in (binned, vals, mask, num_bin,
                                             na_bin)),
                  rng_iter=jnp.int32(it))
        port(*(torch.as_tensor(a) for a in (binned, vals, mask, num_bin,
                                            na_bin)),
             num_leaves=L, num_bins=31, params=ts.SplitParams(**params),
             workspace=ws, sampling=samp,
             rng_iter=torch.tensor([it], dtype=torch.int32), **kw)
        tt = fetch_tree(ws)
        nl = int(tj.num_leaves)
        assert tt.num_leaves == nl and nl > L // 2
        nn = nl - 1
        for name in ("split_feature", "threshold_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(
                getattr(tt, name)[:nn], np.asarray(getattr(tj, name))[:nn],
                err_msg=f"{name} at iteration {it}")
        np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                      np.asarray(tj.leaf_of_row))
        assert not (tt.split_feature[:nn] == 3).any()
        leaves.append(tt.split_feature[:nn].copy())
    # the device iteration keys the draws
    assert not np.array_equal(leaves[0], leaves[1])
