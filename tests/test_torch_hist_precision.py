"""B1's precision on a heavy bin: a bin that holds nearly every row.

The port's B1 and B1-K (and their plain versions, which these tests run)
sum each bin in f64 and round it once to f32, so a bin of about 198,000
rows of non-exact, near-constant hessians (0.2) errs by no more than the
JAX package's one-hot matmul (``_compute_histogram_matmul``) does against
the f64 sum of the same f32 values, or 1e-6 of the bin's size, whichever
is larger.  An f32 running sum of the same rows, one row at a time (the
former plain version, ``index_add_`` into f32), drifts by about 1e-4:
the test would see it.  Sums that are exact in f32 stay bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import histogram as th
from lightgbm_tpu.ops.histogram import _compute_histogram_matmul

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

N, F, BINS = 200_000, 3, 16
# the floor of the allowed error, relative to the bin's f64 sum
REL_FLOOR = 1e-6


def heavy_problem(seed: int):
    """binned [N, F]: about 99% of each feature's rows in bin 0, the rest
    spread; vals (g, h, 1) with g ~ N(0, 1) and h = 0.2 plus a jitter of
    2e-5 (no sum of them exact in f32: a running f32 sum of them rounds
    the same way at every add)."""
    rs = np.random.RandomState(seed)
    binned = np.where(rs.rand(N, F) < 0.99, 0,
                      rs.randint(1, BINS, size=(N, F))).astype(np.uint8)
    g = rs.randn(N).astype(np.float32)
    h = (0.2 + 2e-5 * rs.rand(N)).astype(np.float32)
    vals = np.stack([g, h, np.ones(N, np.float32)], axis=1)
    return binned, vals


def f64_hist(binned, vals, slot=None, num_slots=1):
    """[K, F, B, 3] f64 sums of the f32 values."""
    out = np.zeros((num_slots, F, BINS, 3))
    slot = np.zeros(N, np.int64) if slot is None else slot
    for f in range(F):
        for k in range(num_slots):
            m = slot == k
            for c in range(3):
                out[k, f, :, c] = np.bincount(
                    binned[m, f], weights=vals[m, c].astype(np.float64),
                    minlength=BINS)
    return out


def rel_err(h, ref):
    """Largest error of each bin's sum, relative to that bin's |sum| (the
    hessian and count channels, where every term is positive)."""
    h = np.asarray(h, np.float64)[..., 1:]
    ref = ref[..., 1:]
    nz = np.abs(ref) > 0
    return float((np.abs(h - ref)[nz] / np.abs(ref)[nz]).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_heavy_bin_b1_within_matmul_error(seed):
    binned, vals = heavy_problem(seed)
    ref = f64_hist(binned, vals)[0]
    ht = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vals),
                              num_bins=BINS).numpy()
    hj = np.asarray(_compute_histogram_matmul(
        jnp.asarray(binned), jnp.asarray(vals), num_bins=BINS))
    bound = max(rel_err(hj, ref), REL_FLOOR)
    assert rel_err(ht, ref) <= bound
    # the gradient channel (mixed signs): within the f32 rounding of the
    # bin's sum of magnitudes
    mag = f64_hist(binned, np.abs(vals))[0][..., 0]
    assert np.all(np.abs(ht[..., 0] - ref[..., 0]) <= 2 ** -23 * mag + 1e-6)
    # the former f32 running sum errs far beyond the bound on this bin
    drift = torch.zeros((F * BINS, 3), dtype=torch.float32)
    idx = (torch.as_tensor(binned, dtype=torch.int64)
           + torch.arange(F) * BINS).reshape(-1)
    drift.index_add_(0, idx, torch.as_tensor(vals).repeat_interleave(F, 0))
    assert rel_err(drift.reshape(F, BINS, 3).numpy(), ref) > 10 * bound


@pytest.mark.parametrize("num_slots", [1, 4])
def test_heavy_bin_b1k_within_matmul_error(num_slots):
    binned, vals = heavy_problem(2)
    slot = np.random.RandomState(3).randint(0, num_slots, N).astype(np.int32)
    ref = f64_hist(binned, vals, slot.astype(np.int64), num_slots)
    ht = th.compute_histogram(
        torch.as_tensor(binned), torch.as_tensor(vals), num_bins=BINS,
        slot=torch.as_tensor(slot), num_slots=num_slots,
        slots_used=torch.tensor([num_slots], dtype=torch.int32)).numpy()
    # the JAX package lays the K-slot form out as [F, B, 3K], channel c of
    # slot k at c * K + k
    hj = np.asarray(_compute_histogram_matmul(
        jnp.asarray(binned), jnp.asarray(vals), num_bins=BINS,
        slot=jnp.asarray(slot), num_slots=num_slots))
    hj = hj.reshape(F, BINS, 3, num_slots).transpose(3, 0, 1, 2)
    bound = max(rel_err(hj, ref), REL_FLOOR)
    assert rel_err(ht, ref) <= bound


def test_exact_sums_bit_for_bit():
    # dyadic values: every partial sum exact in f32, so the f64 sum
    # rounds to the same f32 as any order, the JAX matmul's included
    binned, _ = heavy_problem(4)
    rs = np.random.RandomState(5)
    g = (rs.randint(-64, 64, N) / 8.0).astype(np.float32)
    h = np.full(N, 0.25, np.float32)
    vals = np.stack([g, h, np.ones(N, np.float32)], axis=1)
    ht = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vals),
                              num_bins=BINS).numpy()
    hj = np.asarray(_compute_histogram_matmul(
        jnp.asarray(binned), jnp.asarray(vals), num_bins=BINS))
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(
        ht, f64_hist(binned, vals)[0].astype(np.float32))


@pytest.mark.parametrize("n,f,bins,k", [
    (2_270_296, 136, 255, 16), (1_000_000, 28, 63, 16),
    (1_000_000, 8, 255, 16),
    (500_000, 584, 255, 16), (581_012, 12, 256, 8), (4000, 3, 16, 2)])
def test_f64_slices_fit_shared_memory(n, f, bins, k):
    # the f64 slices take twice the shared memory of f32 ones: the K-slot
    # kernel's block (whole warps, one slice a thread, beside its staged
    # chunk of rows) and the one-slot kernel's tile must still fit the
    # 227 KB a block may have
    smem = 227 * 1024
    rows, pairs, chunk = th.slots_launch_shape(n, f, bins, k)
    threads = -(-pairs // 32) * 32
    staged = chunk * 16 + -(-chunk * f // 16) * 16 + chunk // 32 * k * 4
    assert 32 <= threads <= 1024
    assert threads * bins * 3 * 8 + staged <= smem
    assert rows % chunk == 0 and rows * 132 >= n
    _, tile_f, sub = th.launch_shape(n, f, bins)
    assert tile_f * sub * bins * 3 * 8 <= smem
