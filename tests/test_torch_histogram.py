"""B1 histogram: the port's plain version against the JAX package's
``compute_histogram`` on the CPU, with and without the strict grower's
``slot`` form.  The two sum in different orders (index_add_ over rows
against the JAX one-hot matmul over row blocks), so f32 values agree to
``RTOL`` relative to the largest bin magnitude; the count channel, a sum
of ones, is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import histogram as th
from lightgbm_tpu.ops.histogram import compute_histogram

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

RTOL = 2e-6


def _close(ht, hj):
    hj = np.asarray(hj)
    scale = max(1.0, np.abs(hj).max())
    assert np.abs(ht - hj).max() <= RTOL * scale
    np.testing.assert_array_equal(ht[..., 2], hj[..., 2])


@pytest.mark.parametrize("seed,bins", [(0, 31), (1, 15), (2, 8)])
def test_histogram_matches_jax(seed, bins):
    binned, vals, _, _ = binned_problem(seed, n=3000, f=6, bins=bins)
    ht = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vals),
                              num_bins=bins).numpy()
    hj = compute_histogram(jnp.asarray(binned), jnp.asarray(vals),
                           num_bins=bins)
    _close(ht, hj)


@pytest.mark.parametrize("seed", [3, 4])
def test_histogram_slot_matches_jax(seed):
    binned, vals, _, _ = binned_problem(seed, n=2500, f=5, bins=31)
    rs = np.random.RandomState(seed)
    slot = np.where(rs.rand(len(binned)) < 0.4, 0, -1).astype(np.int32)
    ht = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vals),
                              num_bins=31,
                              slot=torch.as_tensor(slot)).numpy()
    hj = compute_histogram(jnp.asarray(binned), jnp.asarray(vals),
                           num_bins=31, slot=jnp.asarray(slot), num_slots=1)
    _close(ht, hj)
    assert ht[0, :, 2].sum() == (slot >= 0).sum()


def test_bins_past_num_bins_add_nothing():
    binned = np.array([[0], [3], [7]], np.uint8)
    vals = np.ones((3, 3), np.float32)
    h = th.histogram_plain(torch.as_tensor(binned), torch.as_tensor(vals),
                           num_bins=4).numpy()
    assert h[:, :, 2].tolist() == [[1.0, 0.0, 0.0, 1.0]]


@pytest.mark.parametrize("n,f,bins", [(1_000_000, 28, 63), (1000, 3, 16),
                                      (50_000, 400, 255), (10, 1, 4096)])
def test_kernel_launch_shape_fits_the_card(n, f, bins):
    rows, tile_f, sub = th.launch_shape(n, f, bins)
    assert tile_f * sub <= 1024
    assert tile_f * sub * bins * 3 * 8 <= 227 * 1024
    assert rows % sub == 0 and rows * 132 >= n
    assert 1 <= tile_f <= f


def test_wrapper_checks_inputs():
    with pytest.raises(TypeError):
        th.compute_histogram(torch.zeros((4, 2), dtype=torch.int32),
                             torch.zeros((4, 3)), num_bins=4)
    with pytest.raises(TypeError):
        th.compute_histogram(torch.zeros((4, 2), dtype=torch.uint8),
                             torch.zeros((4, 3)), num_bins=4,
                             slot=torch.zeros(4, dtype=torch.int64))
