"""The port's threefry stream and row/feature sampling against the JAX
package, bit for bit: ``prng_key``, ``fold_in`` and ``uniform`` equal to
``jax.random`` (seeds past 2^31 and negative ones included, 2-D shapes as
the flat counter stream), ``goss_key`` and ``node_key`` equal to the JAX
package's key forms (the Python-int and the traced int32 iteration), the
B6 plain version's bagging masks equal to the JAX model's ``_bagging_w``
(plain and pos/neg fractions), the GOSS weights equal to the JAX model's
``_goss_vals`` (tie-heavy gradients and a seed near 2^31 included), the
bynode masks and random bins equal to the JAX grower's ``_bynode_mask``
and ``_rand_bins`` (the rank step on crafted ties), and the
feature_fraction mask stream equal to the JAX model's ``_feature_mask``
sequence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.ops import random as trandom
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams as JParams

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module, raw_problem)

SEEDS = [0, 3, 42, -1, -7, 2**31 + 5, 2**32 + 9, 2**40 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    kj = jax.random.PRNGKey(seed)
    assert trandom.prng_key(seed) == tuple(np.asarray(kj).tolist())
    for data in (0, 1, 5, 12345, 2**31 + 3):
        assert trandom.fold_in(trandom.prng_key(seed), data) \
            == tuple(np.asarray(jax.random.fold_in(kj, data)).tolist())


@pytest.mark.parametrize("n", [1, 1000, 65537])
@pytest.mark.parametrize("seed,epoch", [(3, 0), (3, 5), (-1, 10),
                                        (2**32 + 9, 2**31 + 1)])
def test_uniform_bitwise_equal_jax(seed, epoch, n):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    uj = np.asarray(jax.random.uniform(kj, (n,)))
    ut = trandom.uniform(trandom.bagging_key(seed, epoch), n).numpy()
    assert ut.dtype == np.float32 and uj.tobytes() == ut.tobytes()
    assert (ut >= 0).all() and (ut < 1).all()


def _models(params, n=3000):
    x, y = raw_problem(11, n=n, f=9, task="binary")
    base = {"objective": "binary", "verbosity": -1, "num_leaves": 7, **params}
    mt = lgt.Booster(base | {"device_type": "cpu"}, lgt.Dataset(x, y))._model
    mj = lgb.Booster(base | {"tpu_learner": "masked"},
                     lgb.Dataset(x, y))._model
    return mt, mj


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.8, "bagging_freq": 5},
    {"bagging_fraction": 0.5, "bagging_freq": 5, "bagging_seed": 2**31 + 1},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9,
     "bagging_freq": 5},
])
def test_bagging_masks_equal_jax(params):
    mt, mj = _models(params)
    assert mt._bagging_active and mj._bagging_active
    masks = []
    for it in range(12):
        wt = mt._bagging_w(it).numpy()
        wj = np.asarray(mj._bagging_w(jax.numpy.int32(it)))
        assert wt.dtype == np.float32 and wt.tobytes() == wj.tobytes(), it
        masks.append(wt)
    # the mask holds for bagging_freq iterations and then changes
    assert all(np.array_equal(masks[0], masks[i]) for i in range(5))
    assert not np.array_equal(masks[4], masks[5])
    assert 0.4 < masks[0].mean() < 0.95


def test_bag_vals_stack_equals_mask_times_gradients():
    mt, _ = _models({"pos_bagging_fraction": 0.5, "bagging_freq": 2})
    rs = np.random.RandomState(2)
    g = torch.as_tensor(rs.randn(mt.num_data).astype(np.float32))
    h = torch.as_tensor(rs.rand(mt.num_data).astype(np.float32))
    for it in (0, 3):
        vals = trandom.bag_vals(g, h, torch.tensor([it], dtype=torch.int32),
                                **mt.bagging_args())
        w = mt._bagging_w(it)
        want = torch.stack([g * w, h * w, w], dim=1)
        assert torch.equal(vals.view(torch.int32), want.view(torch.int32))


def test_feature_masks_equal_jax():
    mt, mj = _models({"feature_fraction": 0.6, "feature_fraction_seed": 9})
    for _ in range(20):
        a, b = mt._feature_mask(), mj._feature_mask()
        assert a.dtype == bool and np.array_equal(a, b)
        assert a.sum() == max(1, int(round(mt.num_features * 0.6)))
    # an epoch's masks are drawn up front, k at a time, from the same stream
    np.testing.assert_array_equal(mt._feature_masks(4),
                                  np.stack([mj._feature_mask()
                                            for _ in range(4)]))


@pytest.mark.parametrize("shape", [(2, 28), (32, 28), (3, 5, 7), (1, 25)])
def test_uniform_2d_bitwise_equal_jax(shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    uj = np.asarray(jax.random.uniform(kj, shape))
    ut = trandom.uniform(trandom.fold_in(trandom.prng_key(7), 3), shape)
    assert tuple(ut.shape) == shape
    assert uj.tobytes() == ut.numpy().tobytes()


@pytest.mark.parametrize("seed", [0, 3, -5, 2**31 - 3, 2**31 + 5, 2**32 + 9])
def test_goss_and_node_keys_equal_jax(seed):
    for it in (0, 1, 7, 1000):
        want = np.asarray(jax.random.PRNGKey(seed + it)).tolist()
        assert list(trandom.goss_key(seed, it)) == want
        if -2**31 <= seed < 2**31:
            # the fused paths add a traced int32 (wrapping past 2^31)
            traced = jax.jit(lambda i: jax.random.PRNGKey(seed + i))
            assert np.asarray(traced(jnp.int32(it))).tolist() == want
        nj = jax.random.fold_in(jax.random.PRNGKey(seed), it)
        assert trandom.node_key(seed, it) == tuple(np.asarray(nj).tolist())


def _goss_models(params):
    return _models({"data_sample_strategy": "goss", **params})


def _tied_gradients(n, rs):
    """Binary gradients at iteration 0 (p = 0.3 after BoostFromAverage):
    two values of |g| * h, the larger on 30% of the rows."""
    p = np.float32(0.3)
    g = np.where(rs.rand(n) < 0.3, p - np.float32(1.0), p).astype(np.float32)
    return g, np.full(n, p * (np.float32(1.0) - p), np.float32)


@pytest.mark.parametrize("params", [
    {},
    {"top_rate": 0.3, "other_rate": 0.15, "bagging_seed": 2**31 - 2},
    {"top_rate": 0.07, "other_rate": 0.33, "bagging_seed": 11},
])
@pytest.mark.parametrize("ties", [False, True])
def test_goss_weights_equal_jax(params, ties):
    mt, mj = _goss_models(params)
    n = mt.num_data
    rs = np.random.RandomState(5)
    if ties:
        g, h = _tied_gradients(n, rs)
    else:
        g = rs.randn(n).astype(np.float32)
        h = (0.05 + rs.rand(n)).astype(np.float32)
    gt, ht = torch.as_tensor(g), torch.as_tensor(h)
    seen = []
    for it in (0, 1, 2, 9):
        wt = trandom.goss_weights_plain(gt, ht, it, **mt.goss_args()).numpy()
        wj = np.asarray(mj._goss_vals(jnp.asarray(g), jnp.asarray(h),
                                      jnp.int32(it)))
        assert wt.dtype == np.float32 and wt.tobytes() == wj.tobytes(), it
        # the per-iteration form: the JAX model's host counter
        mj.iter_ = it
        assert wt.tobytes() == np.asarray(
            mj._goss_vals(jnp.asarray(g), jnp.asarray(h))).tobytes()
        seen.append(wt)
    top_k, _, amp = trandom.goss_constants(n, mt.config.top_rate,
                                           mt.config.other_rate)
    a = np.abs(g) * h
    thresh = -np.sort(-a)[top_k - 1]
    for wt in seen:
        assert set(np.unique(wt)) <= {0.0, 1.0, float(amp)}
        # every row at or above the threshold is in the top set
        np.testing.assert_array_equal(wt == 1.0, a >= thresh)
    if ties:
        assert (seen[0] == 1.0).sum() > top_k      # ties all go to the top
    # the draw is keyed by the iteration
    assert not np.array_equal(seen[0], seen[1])


@pytest.mark.parametrize("n,top_rate,other_rate", [
    (3000, 0.2, 0.1), (1_000_003, 0.2, 0.1), (999_999, 0.37, 0.21),
    (7, 0.5, 0.3), (1000, 0.9, 0.3)])
def test_goss_constants_equal_jax(n, top_rate, other_rate):
    top_k, p_other, amp = trandom.goss_constants(n, top_rate, other_rate)
    assert top_k == max(1, int(n * top_rate))
    other_k = max(1, int(n * other_rate))
    pj = np.asarray(other_k / jnp.maximum(n - top_k, 1))
    assert pj.dtype == np.float32 and p_other.tobytes() == pj.tobytes()
    ampj = (1.0 - top_rate) / other_rate
    wj = np.asarray(jnp.where(jnp.array([False]), 1.0,
                              jnp.where(jnp.array([True]), ampj, 0.0))
                    .astype(jnp.float32))
    assert amp.tobytes() == wj[0].tobytes()


def test_goss_vals_stack_and_device_iteration():
    mt, _ = _goss_models({})
    rs = np.random.RandomState(8)
    g = torch.as_tensor(rs.randn(mt.num_data).astype(np.float32))
    h = torch.as_tensor(rs.rand(mt.num_data).astype(np.float32))
    out = torch.empty((mt.num_data, 3))
    buffers = trandom.goss_buffers(mt.num_data, "cpu")
    for it in (0, 4):
        vals = trandom.goss_vals(g, h, torch.tensor([it], dtype=torch.int32),
                                 out=out, buffers=buffers, **mt.goss_args())
        w = trandom.goss_weights_plain(g, h, it, **mt.goss_args())
        assert vals.data_ptr() == out.data_ptr()
        want = torch.stack([g * w, h * w, w], dim=1)
        assert torch.equal(vals.view(torch.int32), want.view(torch.int32))
    # scratch of another row count is refused
    with pytest.raises(TypeError, match="goss_buffers"):
        trandom.goss_vals(g, h, torch.tensor([0], dtype=torch.int32),
                          buffers=trandom.goss_buffers(mt.num_data + 1,
                                                       "cpu"),
                          **mt.goss_args())


def _closure(fn, name):
    """A named closure of the JAX package's (unjitted) grower."""
    for var, cell in zip(fn.__code__.co_freevars, fn.__closure__):
        if var == name:
            return cell.cell_contents
    raise KeyError(name)


def _jax_draws(frac):
    grow = make_grower(num_leaves=7, num_bins=15, params=JParams(),
                       bynode_frac=frac, extra_trees=True, jit=False)
    return _closure(grow, "_bynode_mask"), _closure(grow, "_rand_bins")


def test_bynode_count_is_f32():
    # f32(25) * f32(0.6) rounds up past 15; in f64 it is 15.000000000000002
    # and ceil gives 16 too, but 15 for f64(0.6) * 25 = 15.0
    assert trandom.bynode_count(25, 0.6) == 16
    assert int(np.ceil(25 * 0.6)) == 15
    assert trandom.bynode_count(0, 0.5) == 1
    assert trandom.bynode_count(28, 0.8) == 23


@pytest.mark.parametrize("frac,f", [(0.6, 25), (0.3, 28), (0.85, 28),
                                    (0.05, 40), (0.5, 3)])
def test_bynode_masks_equal_jax(frac, f):
    bynode_mask, _ = _jax_draws(frac)
    rs = np.random.RandomState(f)
    for d in range(16):
        base = rs.rand(f) < 0.8
        base[d % f] = True
        kj = jax.random.fold_in(jax.random.PRNGKey(3), d)
        mj = np.asarray(bynode_mask(kj, jnp.asarray(base)))
        mt = trandom.bynode_mask_plain(trandom.fold_in(trandom.prng_key(3),
                                                       d),
                                       torch.as_tensor(base), frac).numpy()
        np.testing.assert_array_equal(mt, mj)
        assert mt.sum() == trandom.bynode_count(base.sum(), frac)
        assert not (mt & ~base).any()


def test_bynode_rank_step_on_ties():
    """Tied uniforms, as two of 28 23-bit uniforms are about once in
    20,000 draws: the lower index wins, and masked-out features (+inf)
    never displace a valid one."""
    u = np.array([0.5, 0.5, 0.125, 0.5, 0.125, 0.25, 0.5, 0.0],
                 np.float32)
    for base_bits in (0xff, 0b10111110, 0b01011011, 0b00000001):
        base = np.array([(base_bits >> i) & 1 for i in range(8)], bool)
        for k in range(1, 9):
            uj = jnp.where(jnp.asarray(base), jnp.asarray(u), jnp.inf)
            want = base & (np.asarray(jnp.argsort(jnp.argsort(uj))) < k)
            got = trandom.bynode_keep(torch.as_tensor(u),
                                      torch.as_tensor(base), k).numpy()
            np.testing.assert_array_equal(got, want)
    # per-row counts over a [C, F] batch of tied rows
    ub = torch.as_tensor(np.stack([u, u[::-1].copy()]))
    kb = torch.tensor([2, 5])
    got = trandom.bynode_keep(ub, torch.ones((2, 8), dtype=torch.bool), kb)
    assert got.sum(dim=1).tolist() == [2, 5]
    assert got[0].nonzero().flatten().tolist() == [2, 7]


@pytest.mark.parametrize("shape", ["F", "2F", "2KF"])
def test_rand_bins_equal_jax(shape):
    _, rand_bins = _jax_draws(0.5)
    f = 28
    num_bin = np.random.RandomState(2).randint(1, 64, f).astype(np.int32)
    num_bin[:4] = (1, 2, 3, 255)
    full = {"F": (f,), "2F": (2, f), "2KF": (32, f)}[shape]
    for d in (0, 1, 17):
        kj = jax.random.fold_in(jax.random.PRNGKey(6), d)
        bj = np.asarray(rand_bins(kj, full, jnp.asarray(num_bin)))
        bt = trandom.rand_bins_plain(trandom.fold_in(trandom.prng_key(6), d),
                                     full, torch.as_tensor(num_bin)).numpy()
        assert bt.dtype == np.int32
        np.testing.assert_array_equal(bt, bj)
        assert (bt <= num_bin - 2).all() and (bt >= np.minimum(
            0, num_bin - 2)).all()


@pytest.mark.parametrize("K,s", [(1, 0), (1, 5), (16, 0), (16, 3)])
def test_node_draws_equal_jax_step_ids(K, s):
    """One grower step's draws: children ids and the extra_trees step as
    the JAX growers fold them (strict step s: 2(s+1) + c and s + 1;
    batched super-step s: (s+1)·2K + j and s + 1)."""
    frac, seeds, it = 0.6, (12, 6), 9
    bynode_mask, rand_bins = _jax_draws(frac)
    f = 25
    rs = np.random.RandomState(K + s)
    base = rs.rand(f) < 0.9
    num_bin = rs.randint(2, 40, f).astype(np.int32)
    samp = trandom.NodeSampling(bynode_frac=frac, bynode_seed=seeds[0],
                                extra_trees=True, extra_seed=seeds[1])
    C = 2 * K
    id0 = (s + 1) * C
    masks = torch.zeros((C, f), dtype=torch.bool)
    bins = torch.zeros((C, f), dtype=torch.int32)
    args = (torch.as_tensor(base), torch.as_tensor(num_bin),
            torch.tensor([it], dtype=torch.int32))
    kw = dict(count=C, bynode_id0=id0, extra_step=s + 1, sampling=samp)
    trandom.node_draws(*args, **kw, masks=masks, bins=bins)
    bn = jax.random.fold_in(jax.random.PRNGKey(seeds[0]), it)
    et = jax.random.fold_in(jax.random.PRNGKey(seeds[1]), it)
    mj = np.stack([np.asarray(bynode_mask(jax.random.fold_in(bn, id0 + c),
                                          jnp.asarray(base)))
                   for c in range(C)])
    bj = np.asarray(rand_bins(jax.random.fold_in(et, s + 1), (C, f),
                              jnp.asarray(num_bin)))
    np.testing.assert_array_equal(masks.numpy(), mj)
    np.testing.assert_array_equal(bins.numpy(), bj)
    # an inactive step writes nothing
    m2, b2 = masks.clone(), bins.clone()
    trandom.node_draws(*args, **{**kw, "bynode_id0": id0 + 1}, masks=m2,
                       bins=b2, active=torch.tensor([0], dtype=torch.int32))
    assert torch.equal(m2, masks) and torch.equal(b2, bins)
