"""The port's device-resident strict grower (B1-B3s plain versions on the
CPU) against the JAX package's masked ``make_grower`` on the same
``vals``.  On fixtures whose split gains are well separated the integer
tree arrays and the row -> leaf vector are equal; f32 fields agree to
``RTOL`` (histogram sums are taken in another order).  The tree stays on
the device until one fetch brings it to the host."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.grower import (STEP_RECORD, GrowWorkspace, fetch_tree,
                                   grow_tree, partition_plain)
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams as JParams

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

RTOL = 1e-5

CASES = [
    (15, -1, {}),
    (8, 3, {"min_data_in_leaf": 40}),
    (12, -1, {"lambda_l2": 1.0, "path_smooth": 5.0, "max_delta_step": 2.0}),
    (6, -1, {"lambda_l1": 0.5, "min_sum_hessian_in_leaf": 20.0}),
]


@pytest.mark.parametrize("leaves,depth,params", CASES)
def test_grower_matches_jax(leaves, depth, params):
    binned, vals, num_bin, na_bin = binned_problem(21, n=4000, f=8, bins=31)
    mask = np.ones(8, bool)
    grow = make_grower(num_leaves=leaves, num_bins=31,
                       params=JParams(**params), max_depth=depth,
                       hist_overlap=True)
    tj = grow(jnp.asarray(binned), jnp.asarray(vals), jnp.asarray(mask),
              jnp.asarray(num_bin), jnp.asarray(na_bin))
    ws = GrowWorkspace(4000, 8, 31, leaves, torch.device("cpu"))
    args = [torch.as_tensor(a) for a in (binned, vals, mask, num_bin,
                                         na_bin)]
    grow_tree(*args, num_leaves=leaves, num_bins=31,
              params=TParams(**params), max_depth=depth, workspace=ws)
    # the tree stays in the workspace until this one fetch (one fetch per
    # tree in training: tests/test_torch_fused.py)
    tt = fetch_tree(ws)
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl and nl > 2
    assert tt.n_steps == int(tj.n_steps)
    n = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n],
                                      np.asarray(getattr(tj, name))[:n],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_depth[:nl],
                                  np.asarray(tj.leaf_depth)[:nl])
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    for name, k in (("split_gain", n), ("internal_value", n),
                    ("internal_weight", n), ("internal_count", n),
                    ("leaf_value", nl), ("leaf_weight", nl),
                    ("leaf_count", nl)):
        b = np.asarray(getattr(tj, name), np.float64)[:k]
        np.testing.assert_allclose(getattr(tt, name)[:k], b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max(),
                                   err_msg=name)
    if depth > 0:
        assert tt.leaf_depth[:nl].max() <= depth


def _rec(leaf, new_leaf, feature, threshold, default_left, na_bin,
         smaller, active=1):
    rec = torch.tensor([leaf, new_leaf, feature, threshold, default_left,
                        na_bin, smaller, active], dtype=torch.int32)
    assert rec.shape == (STEP_RECORD,)
    return rec


def test_partition_plain_moves_right_rows_and_slots():
    binned = torch.tensor([[0], [5], [9], [9], [2]], dtype=torch.uint8)
    lor = torch.tensor([0, 0, 0, 1, 1], dtype=torch.int32)
    rank = torch.arange(10, dtype=torch.int32)
    # threshold 4 on feature 0, bin 9 is the NA bin and goes left
    slot = partition_plain(binned, lor, _rec(0, 2, 0, 4, 1, 9, 2), rank)
    assert lor.tolist() == [0, 2, 0, 1, 1]
    assert slot.tolist() == [-1, 0, -1, -1, -1]
    slot = partition_plain(binned, lor, _rec(1, 3, 0, 4, 0, 9, 1), rank)
    assert lor.tolist() == [0, 2, 0, 3, 1]
    assert slot.tolist() == [-1, -1, -1, -1, 0]
    # an inactive step (the tree is done) moves no row
    partition_plain(binned, lor, _rec(0, 4, 0, 0, 0, -1, 4, active=0), rank)
    assert lor.tolist() == [0, 2, 0, 3, 1]
