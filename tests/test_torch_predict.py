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

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)


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
    """Categorical nodes are no longer refused: a JAX-grown tree with
    categorical splits (features 0 and 1 categorical, NA bins in the
    numerical features 2 and 5) converts with its ``is_cat_node`` and
    ``cat_rank`` and walks to the JAX package's leaves."""
    binned, vals, num_bin, na_bin = binned_problem(34, n=3000, f=6, bins=31)
    is_cat = np.array([True, True, False, False, False, False])
    grow = make_grower(num_leaves=15, num_bins=31,
                       params=SplitParams(min_data_in_leaf=20,
                                          min_data_per_group=20))
    tj = grow(jnp.asarray(binned), jnp.asarray(vals), jnp.ones(6, bool),
              jnp.asarray(num_bin), jnp.asarray(na_bin),
              is_cat=jnp.asarray(is_cat))
    tree = convert.tree_arrays_from_numpy(
        {k: np.asarray(v) for k, v in tj._asdict().items()})
    nn = tree.num_leaves - 1
    assert tree.is_cat_node[:nn].any()
    np.testing.assert_array_equal(tree.cat_rank, np.asarray(tj.cat_rank))
    vb, _, _, _ = binned_problem(134, n=2000, f=6, bins=31)
    steps = 16
    node = [torch.as_tensor(getattr(tree, k)) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    lt = traverse_tree_plain(
        torch.as_tensor(vb), *node, torch.as_tensor(na_bin), steps=steps,
        is_cat_node=torch.as_tensor(tree.is_cat_node),
        cat_rank=torch.as_tensor(tree.cat_rank))
    lj = traverse_tree_binned(
        jnp.asarray(vb), tj.split_feature, tj.threshold_bin, tj.default_left,
        tj.left_child, tj.right_child, jnp.asarray(na_bin), tj.is_cat_node,
        tj.cat_rank, steps=steps)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_short_walk_ends_at_leaf_zero():
    binned = torch.zeros((3, 1), dtype=torch.uint8)
    one = torch.zeros(1, dtype=torch.int32)
    leaf = traverse_tree_plain(binned, one, one, torch.zeros(1, dtype=bool),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32),
                               torch.full((1,), -1, dtype=torch.int32),
                               steps=2)
    assert leaf.tolist() == [0, 0, 0]
