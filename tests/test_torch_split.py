"""B2 split scan: the port's plain version against the JAX package's
``find_best_split`` (numerical features) on the CPU.  Both compute the
same f32 formulas on the same histogram; only the prefix-sum order may
differ (torch.cumsum against XLA's), so the chosen (feature, threshold,
direction) must be equal and the float fields agree to ``RTOL``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import split as ts
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import compute_histogram

from torch_port_fixtures import binned_problem

torch.set_num_threads(2)

RTOL = 1e-5

CASES = {
    "default": {},
    "l1": {"lambda_l1": 2.0},
    "l2": {"lambda_l2": 5.0},
    "min_data": {"min_data_in_leaf": 400},
    "min_hess": {"min_sum_hessian_in_leaf": 900.0},
    "max_delta": {"max_delta_step": 0.05},
    "path_smooth": {"path_smooth": 20.0},
    "min_gain": {"min_gain_to_split": 5.0},
    "all": {"lambda_l1": 1.0, "lambda_l2": 2.0, "max_delta_step": 0.3,
            "path_smooth": 3.0, "min_data_in_leaf": 50},
}


def _compare(hist, total, num_bin, na_bin, mask, params, parent):
    pj = js.SplitParams(**params)
    pt = ts.SplitParams(**params)
    rj = js.find_best_split(jnp.asarray(hist), jnp.asarray(total),
                            jnp.asarray(num_bin), jnp.asarray(na_bin),
                            jnp.asarray(mask), pj, jnp.float32(parent))
    rec = ts.find_best_split(torch.as_tensor(hist)[None],
                             torch.as_tensor(total)[None],
                             torch.tensor([parent], dtype=torch.float32),
                             torch.as_tensor(num_bin), torch.as_tensor(na_bin),
                             torch.as_tensor(mask), pt)
    rt = ts.unpack(rec[0])
    assert int(rt.feature) == int(rj.feature)
    assert int(rt.threshold) == int(rj.threshold)
    assert bool(rt.default_left) == bool(rj.default_left)
    for a, b in ((rt.gain, rj.gain), (rt.left_sum, rj.left_sum),
                 (rt.right_sum, rj.right_sum),
                 (rt.left_output, rj.left_output),
                 (rt.right_output, rj.right_output)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if np.isinf(b).any():
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max())
    return rt


@pytest.mark.parametrize("with_na", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_matches_jax(case, with_na):
    binned, vals, num_bin, na_bin = binned_problem(
        11, n=3000, f=6, bins=31, na_features=(2, 4) if with_na else ())
    hist = np.array(compute_histogram(jnp.asarray(binned),
                                        jnp.asarray(vals), num_bins=31))
    total = vals.sum(axis=0, dtype=np.float32)
    mask = np.ones(6, bool)
    mask[5] = False
    rt = _compare(hist, total, num_bin, na_bin, mask, CASES[case],
                  parent=0.1)
    if case in ("default", "all"):
        assert float(rt.gain) > 0


def test_no_valid_split_is_minus_inf():
    binned, vals, num_bin, na_bin = binned_problem(12, n=300, f=3, bins=15)
    hist = np.array(compute_histogram(jnp.asarray(binned),
                                        jnp.asarray(vals), num_bins=15))
    total = vals.sum(axis=0, dtype=np.float32)
    rt = _compare(hist, total, num_bin, na_bin, np.ones(3, bool),
                  {"min_data_in_leaf": 10_000}, parent=0.0)
    assert float(rt.gain) == float("-inf")


def test_ties_pick_the_smallest_direction_feature_bin():
    """Features 1 and 3 carry the same histogram, and so the same gains:
    both packages must pick feature 1, as jnp.argmax over the flattened
    [direction, feature, bin] axis does."""
    binned, vals, num_bin, na_bin = binned_problem(13, n=2000, f=4, bins=15,
                                                   na_features=())
    binned[:, 3] = binned[:, 1]
    binned[:, 0] = 0                       # constant: never splits
    hist = np.array(compute_histogram(jnp.asarray(binned),
                                        jnp.asarray(vals), num_bins=15))
    np.testing.assert_array_equal(hist[1], hist[3])
    total = vals.sum(axis=0, dtype=np.float32)
    rt = _compare(hist, total, num_bin, na_bin, np.ones(4, bool), {},
                  parent=0.0)
    assert int(rt.feature) == 1


def test_batched_leaves_match_one_by_one():
    binned, vals, num_bin, na_bin = binned_problem(14, n=2000, f=5, bins=31)
    tb = torch.as_tensor(binned)
    tv = torch.as_tensor(vals)
    half = torch.as_tensor(np.arange(2000) % 2 == 0)
    from lightgbm_torch.ops.histogram import compute_histogram as th
    h2 = torch.stack([th(tb[half], tv[half], num_bins=31),
                      th(tb[~half], tv[~half], num_bins=31)])
    tot = torch.stack([tv[half].sum(0), tv[~half].sum(0)])
    po = torch.tensor([0.2, -0.1])
    args = (torch.as_tensor(num_bin), torch.as_tensor(na_bin),
            torch.ones(5, dtype=torch.bool), ts.SplitParams(path_smooth=2.0))
    both = ts.find_best_split(h2, tot, po, *args)
    for k in range(2):
        one = ts.find_best_split(h2[k:k + 1].contiguous(), tot[k:k + 1],
                                 po[k:k + 1], *args)
        torch.testing.assert_close(both[k], one[0], rtol=0, atol=0)
