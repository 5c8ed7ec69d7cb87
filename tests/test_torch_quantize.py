"""Quantized training's kernels (B7a-c and the integer B1/B1-K) as their
plain PyTorch versions on the CPU, against the JAX package's functions on
the same inputs, bit for bit:

- ``counter_uniform``, ``quant_scales`` and ``quantize_stack`` at int8
  and int16, stochastic and nearest rounding, several iteration keys,
  seeds and row offsets; zero rows stay zero and a channel of zeros
  dequantizes to zeros;
- ``dequantize_hist``;
- the integer ``compute_histogram`` (no slot, the strict grower's
  ``slot``, K slots, a grouped EFB matrix) against the JAX
  ``compute_histogram`` on int8/int16 vals: exact int32 both;
- the wrappers' device tensors (the iteration as a [1] int32, ``out=``,
  an inactive step) and the integer forms' launch shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import histogram as th
from lightgbm_torch.ops import quantize as tq
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops.histogram import compute_histogram as jhist
from lightgbm_tpu.ops.split import dequantize_hist as jdequant

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)


def _vals(seed, n=4000):
    """(g, h, w) rows with zero rows, exact ties at a channel's max, a
    bag mask in w and a wide spread of magnitudes."""
    rs = np.random.RandomState(seed)
    g = (rs.randn(n) * np.exp(rs.randn(n))).astype(np.float32)
    h = rs.rand(n).astype(np.float32)
    w = (rs.rand(n) < 0.8).astype(np.float32)
    v = np.stack([g * w, h * w, w], axis=1)
    v[::11] = 0.0
    v[3, 0] = -np.abs(v[:, 0]).max()       # the max magnitude twice
    return v


def _it(k):
    """A device iteration, as the trainer's ``it_cur``."""
    return torch.tensor([k], dtype=torch.int32)


def _bits(a):
    return np.asarray(a).view(np.int32) if np.asarray(a).dtype == \
        np.float32 else np.asarray(a)


@pytest.mark.parametrize("seed,iter_key,offset", [
    (0, 0, 0), (7, 3, 0), (123456789, 2 ** 31 - 1, 1000), (5, 40, -7)])
def test_counter_uniform_equals_jax(seed, iter_key, offset):
    rows = (np.arange(3000) + offset).astype(np.int32)
    uj = np.asarray(jq.counter_uniform(jnp.asarray(rows), 3, iter_key, seed))
    ut = tq.counter_uniform(torch.as_tensor(rows), 3, iter_key, seed)
    np.testing.assert_array_equal(_bits(ut.numpy()), _bits(uj))
    assert (ut >= 0).all() and (ut < 1).all()


@pytest.mark.parametrize("bits", [8, 16])
def test_quant_scales_equal_jax(bits):
    v = _vals(1)
    spec = tq.QuantSpec(bits=bits)
    sj = np.asarray(jq.quant_scales(jnp.asarray(v), spec.qmax))
    st = tq.quant_scales(torch.as_tensor(v), spec.qmax)
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    # an all-zero channel takes the floor and dequantizes to exact zeros
    z = v.copy()
    z[:, 1] = 0.0
    sz = tq.quant_scales(torch.as_tensor(z), spec.qmax)
    np.testing.assert_array_equal(
        _bits(sz.numpy()),
        _bits(np.asarray(jq.quant_scales(jnp.asarray(z), spec.qmax))))
    q = tq.quantize_stack(torch.as_tensor(z), sz, spec, _it(3))
    assert (q[:, 1] == 0).all()
    h = th.compute_histogram(torch.zeros((len(z), 1), dtype=torch.uint8), q,
                             num_bins=2)
    assert (tq.dequantize_hist(h, sz)[..., 1] == 0).all()


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("iter_key,seed,offset", [
    (0, 0, 0), (1, 0, 0), (17, 5, 0), (99, 2 ** 40 + 3, 2500)])
def test_quantize_stack_equals_jax(bits, stochastic, iter_key, seed, offset):
    v = _vals(2)
    js = jq.QuantSpec(bits=bits, stochastic=stochastic, seed=seed)
    ts = tq.QuantSpec(bits=bits, stochastic=stochastic, seed=seed)
    s = np.asarray(jq.quant_scales(jnp.asarray(v), js.qmax))
    qj = np.asarray(jq.quantize_stack(jnp.asarray(v), jnp.asarray(s), js,
                                      jnp.int32(iter_key), offset))
    qt = tq.quantize_stack_plain(torch.as_tensor(v), torch.as_tensor(s), ts,
                                 iter_key, offset).numpy()
    assert qt.dtype == qj.dtype == (np.int8 if bits == 8 else np.int16)
    np.testing.assert_array_equal(qt, qj)
    # zero rows stay zero; the channel maxima reach +-qmax
    assert (qt[::11] == 0).all()
    assert np.abs(qt).max() == ts.qmax


def test_stochastic_rounding_depends_on_iteration_and_seed():
    v = torch.as_tensor(_vals(3))
    spec = tq.QuantSpec()
    s = tq.quant_scales(v, spec.qmax)
    a = tq.quantize_stack(v, s, spec, _it(1))
    assert not torch.equal(a, tq.quantize_stack(v, s, spec, _it(2)))
    assert not torch.equal(a, tq.quantize_stack(v, s, spec._replace(seed=9),
                                                _it(1)))
    # nearest rounding has no key
    near = spec._replace(stochastic=False)
    assert torch.equal(tq.quantize_stack(v, s, near, _it(1)),
                       tq.quantize_stack(v, s, near, _it(2)))
    # unbiased: the mean of the dequantized stack tracks the f32 one
    # within about four standard errors (a rounding error is under one
    # scale step, sd at most s / 2, over 4,000 rows)
    deq = tq.dequantize_hist(a.to(torch.int32), s)
    assert ((deq.mean(0) - v.mean(0)).abs() <= 0.04 * s).all()


def test_quantize_stack_reads_the_device_iteration():
    v = torch.as_tensor(_vals(4))
    spec = tq.QuantSpec(bits=16, seed=3)
    s = tq.quant_scales(v, spec.qmax)
    out = torch.empty((len(v), 3), dtype=torch.int16)
    got = tq.quantize_stack(v, s, spec, _it(6), out=out)
    assert got is out
    assert torch.equal(out, tq.quantize_stack_plain(v, s, spec, 6))
    # no iteration: the JAX grower's default key 0
    assert torch.equal(tq.quantize_stack(v, s, spec),
                       tq.quantize_stack_plain(v, s, spec, 0))
    with pytest.raises(TypeError):
        tq.quantize_stack(v, s, spec, torch.tensor([6]))


@pytest.mark.parametrize("shape", [(3,), (28, 15, 3), (4, 6, 31, 3)])
def test_dequantize_hist_equals_jax(shape):
    rs = np.random.RandomState(5)
    h = rs.randint(-2 ** 31, 2 ** 31 - 1, size=shape, dtype=np.int64) \
        .astype(np.int32)
    s = np.asarray(jq.quant_scales(jnp.asarray(_vals(6)), 127))
    dj = np.asarray(jdequant(jnp.asarray(h), jnp.asarray(s)))
    dt = tq.dequantize_hist(torch.as_tensor(h), torch.as_tensor(s))
    np.testing.assert_array_equal(_bits(dt.numpy()), _bits(dj))


def test_dequantize_hist_inactive_step_writes_nothing():
    h = torch.ones((2, 3, 4, 3), dtype=torch.int32)
    s = torch.ones(3)
    out = torch.full((2, 3, 4, 3), 7.0)
    tq.dequantize_hist(h, s, active=torch.zeros(1, dtype=torch.int32),
                       out=out)
    assert (out == 7.0).all()
    tq.dequantize_hist(h, s, active=torch.ones(1, dtype=torch.int32),
                       out=out)
    assert (out == 1.0).all()


def _int_vals(seed, n, bits):
    rs = np.random.RandomState(seed)
    qmax = (1 << (bits - 1)) - 1
    v = rs.randint(-qmax, qmax + 1, size=(n, 3))
    v[rs.rand(n) < 0.2] = 0
    return v.astype(np.int8 if bits == 8 else np.int16)


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("form", ["all", "slot", "slots", "grouped"])
def test_integer_histogram_equals_jax(bits, form):
    rs = np.random.RandomState(8)
    n, f, B = 3000, 7, 31
    binned = rs.randint(0, B, size=(n, f)).astype(np.uint8)
    if form == "grouped":
        # an EFB group matrix: bundle bins up to 64, most rows at bin 0
        B = 64
        binned = np.where(rs.rand(n, f) < 0.7, 0,
                          rs.randint(1, B, size=(n, f))).astype(np.uint8)
    vals = _int_vals(9, n, bits)
    tb, tv = torch.as_tensor(binned), torch.as_tensor(vals)
    jb, jv = jnp.asarray(binned), jnp.asarray(vals)
    if form == "slots":
        K = 5
        slot = rs.randint(-1, K, size=n).astype(np.int32)
        hj = np.asarray(jhist(jb, jv, num_bins=B, slot=jnp.asarray(slot),
                              num_slots=K))
        ht = th.compute_histogram(tb, tv, num_bins=B,
                                  slot=torch.as_tensor(slot), num_slots=K,
                                  slots_used=torch.tensor([K],
                                                          dtype=torch.int32))
        # the JAX layout [F, B, 3K], channel c of slot k at c*K + k
        hj = hj.reshape(f, B, 3, K).transpose(3, 0, 1, 2)
    elif form == "slot":
        slot = np.where(rs.rand(n) < 0.4, 0, -1).astype(np.int32)
        hj = np.asarray(jhist(jb, jv, num_bins=B, slot=jnp.asarray(slot),
                              num_slots=1))
        ht = th.compute_histogram(tb, tv, num_bins=B,
                                  slot=torch.as_tensor(slot),
                                  active=torch.ones(1, dtype=torch.int32))
    else:
        hj = np.asarray(jhist(jb, jv, num_bins=B))
        ht = th.compute_histogram(tb, tv, num_bins=B)
    assert ht.dtype == torch.int32 and hj.dtype == np.int32
    np.testing.assert_array_equal(ht.numpy(), hj)


def test_integer_histogram_inactive_step_and_dtypes():
    binned = torch.zeros((10, 2), dtype=torch.uint8)
    vals = torch.ones((10, 3), dtype=torch.int8)
    slot = torch.zeros(10, dtype=torch.int32)
    off = torch.zeros(1, dtype=torch.int32)
    h = th.compute_histogram(binned, vals, num_bins=4, slot=slot, active=off)
    assert h.dtype == torch.int32 and (h == 0).all()
    h = th.compute_histogram(binned, vals, num_bins=4, slot=slot,
                             num_slots=2, active=off,
                             slots_used=torch.tensor([2], dtype=torch.int32))
    assert h.shape == (2, 2, 4, 3) and h.dtype == torch.int32
    with pytest.raises(TypeError):
        th.compute_histogram(binned, vals.to(torch.int32), num_bins=4)


@pytest.mark.parametrize("n,f,B,K", [
    (1_000_000, 28, 64, None), (1_000_000, 28, 63, 16),
    (2_270_296, 136, 255, None), (2_270_296, 136, 255, 16),
    (500_000, 584, 255, None), (500_000, 8, 256, 16), (100, 3, 7, 4)])
def test_integer_launch_shapes_fit(n, f, B, K):
    rows, tile_f, tile_k = th.int_launch_shape(n, f, B, K)
    assert tile_k * tile_f * B * 3 * 4 <= th._SMEM_BYTES
    assert 1 <= tile_f <= f and 1 <= tile_k <= (K or 1)
    assert rows * -(-n // rows) >= n and (rows >= 1024 or rows == n)
