"""B4 tree walk and score update: the port's plain version against the
JAX package's ``traverse_tree_binned`` / ``add_tree_score`` on one
reference tree (grown by the JAX package, carried over with
``convert.tree_arrays_from_numpy``).  The walk is integer work, so the
leaves are equal.  The update is a multiply and an add; with weight 1 (the
trainer's valid-set update) the product is exact and the scores are equal.
For other weights XLA's CPU backend fuses the two into one rounding while
the port rounds twice, so scores agree to a few f32 ulps of their size."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch import convert
from lightgbm_torch.predict_device import (add_tree_score,
                                           traverse_tree_plain)
from lightgbm_torch.utils.shapes import round_up_pow2
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams
from lightgbm_tpu.predict_device import add_tree_score as j_add_tree_score
from lightgbm_tpu.predict_device import traverse_tree_binned

from torch_port_fixtures import binned_problem

torch.set_num_threads(2)


def _reference_tree(seed, leaves):
    binned, vals, num_bin, na_bin = binned_problem(seed, n=3000, f=6, bins=31)
    grow = make_grower(num_leaves=leaves, num_bins=31,
                       params=SplitParams(min_data_in_leaf=20))
    tj = grow(jnp.asarray(binned), jnp.asarray(vals), jnp.ones(6, bool),
              jnp.asarray(num_bin), jnp.asarray(na_bin))
    fields = {k: np.asarray(v) for k, v in tj._asdict().items()}
    return tj, fields, num_bin, na_bin


def _depth(tree):
    nl = tree.num_leaves
    return int(tree.leaf_depth[:nl].max())


@pytest.mark.parametrize("seed,leaves,weight", [(31, 15, 1.0), (32, 7, 0.1),
                                                (33, 4, -2.5)])
def test_add_tree_score_matches_jax(seed, leaves, weight):
    tj, fields, num_bin, na_bin = _reference_tree(seed, leaves)
    tree = convert.tree_arrays_from_numpy(fields)
    steps = round_up_pow2(max(_depth(tree), 1))
    # rows the tree never saw, with NA bins
    vb, _, _, _ = binned_problem(seed + 100, n=2000, f=6, bins=31)
    data = convert.dataset_from_numpy(vb, num_bin, na_bin,
                                      [np.arange(31.0)] * 6)
    rs = np.random.RandomState(seed)
    score0 = rs.randn(2000).astype(np.float32)

    node = [torch.as_tensor(getattr(tree, k)) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    lt = traverse_tree_plain(data.binned, *node, data.na_bin, steps=steps)
    lj = traverse_tree_binned(
        jnp.asarray(vb), tj.split_feature, tj.threshold_bin, tj.default_left,
        tj.left_child, tj.right_child, jnp.asarray(na_bin), tj.is_cat_node,
        tj.cat_rank, steps=steps)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))

    st = add_tree_score(torch.as_tensor(score0.copy()), data.binned, *node,
                        data.na_bin, torch.as_tensor(tree.leaf_value),
                        weight, steps=steps)
    sj = j_add_tree_score(
        jnp.asarray(score0), jnp.asarray(vb), tj.split_feature,
        tj.threshold_bin, tj.default_left, tj.left_child, tj.right_child,
        jnp.asarray(na_bin), tj.is_cat_node, tj.cat_rank, tj.leaf_value,
        jnp.float32(weight), steps=steps)
    sj = np.asarray(sj)
    if weight == 1.0:
        np.testing.assert_array_equal(st.numpy(), sj)
    else:
        tol = 4 * np.finfo(np.float32).eps * np.abs(sj).max()
        np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=tol)


def test_convert_refuses_categorical_nodes():
    _, fields, _, _ = _reference_tree(34, 4)
    fields["is_cat_node"] = np.ones_like(fields["is_cat_node"])
    with pytest.raises(NotImplementedError, match="A9"):
        convert.tree_arrays_from_numpy(fields)


def test_short_walk_ends_at_leaf_zero():
    binned = torch.zeros((3, 1), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    leaf = traverse_tree_plain(binned, one, one, torch.zeros(1, dtype=bool),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.full((1,), -1, dtype=torch.int32),
                               steps=2)
    assert leaf.tolist() == [0, 0, 0]
