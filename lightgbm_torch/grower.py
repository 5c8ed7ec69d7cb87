"""Strict leaf-wise tree grower.

Counterpart of the JAX package's ``grower.py`` ``grow_tree`` (the masked
one-program learner at ``split_batch=1``).  The JAX package runs the whole
tree build as one ``lax.while_loop``; PyTorch runs the split loop in
Python:

- the root pass builds the histogram of all rows (kernel B1) and finds the
  root's best split (kernel B2);
- each step takes the leaf with the largest cached gain (first on ties,
  as ``jnp.argmax``), stops when that gain is not positive, partitions the
  rows of the leaf (kernel B3, which also writes the smaller child's slot
  vector), builds the smaller child's histogram (B1 with ``slot``),
  derives the larger child's as parent minus smaller, and finds both
  children's best splits (B2 on the pair).

The per-leaf histograms and best-split records stay on the device.  Each
step reads the [L, 12] record table, fetched to the host in one copy after
the previous step (the chosen leaf's gain, feature, threshold and sums);
the tree arrays are kept on the host from those records, where the JAX
trainer fetches them once per tree.  ``GrowStats.fetches`` counts the
copies: one per split, plus one when the tree stops before its budget.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .ops import split as sp
from .ops.histogram import compute_histogram
from .ops.split import SplitParams, find_best_split, leaf_output
from . import _kernels


class TreeArrays(NamedTuple):
    """Array-encoded tree (the JAX package's ``grower.TreeArrays``).

    Internal nodes are 0..num_leaves-2; a child pointer < 0 encodes leaf
    ``~child``.  Tree-sized fields are host numpy arrays sized to the leaf
    budget L; ``leaf_of_row`` stays on the training device."""
    num_leaves: int              # actual number of leaves
    split_feature: np.ndarray    # [L-1] int32 (used-feature slot)
    threshold_bin: np.ndarray    # [L-1] int32
    default_left: np.ndarray     # [L-1] bool
    left_child: np.ndarray       # [L-1] int32
    right_child: np.ndarray      # [L-1] int32
    split_gain: np.ndarray       # [L-1] f32
    leaf_value: np.ndarray       # [L] f32
    leaf_weight: np.ndarray      # [L] f32 (sum hessian)
    leaf_count: np.ndarray       # [L] f32
    internal_value: np.ndarray   # [L-1] f32
    internal_weight: np.ndarray  # [L-1] f32
    internal_count: np.ndarray   # [L-1] f32
    leaf_depth: np.ndarray       # [L] int32
    leaf_of_row: torch.Tensor    # [N] int32 — final row -> leaf
    is_cat_node: np.ndarray      # [L-1] bool (all False: numerical only)
    cat_rank: np.ndarray         # [L-1, B] int32 (identity rank)
    n_steps: int                 # grower loop steps (== splits)


@dataclass
class GrowStats:
    """Host round trips of the split loop (one table fetch per step)."""
    fetches: int = 0
    splits: int = 0


def _fetch(t: torch.Tensor, stats: GrowStats) -> np.ndarray:
    stats.fetches += 1
    return t.cpu().numpy()


def grow_tree(binned: torch.Tensor, vals: torch.Tensor,
              feature_mask: torch.Tensor, num_bin: torch.Tensor,
              na_bin: torch.Tensor, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int = -1,
              na_bin_host: np.ndarray | None = None,
              stats: GrowStats | None = None) -> TreeArrays:
    """Grow one tree on ``binned`` [N, F] uint8 with per-row ``vals``
    [N, 3] f32 = (grad, hess, weight), all on one device.
    ``na_bin_host``: a host copy of ``na_bin`` (saves a fetch per tree)."""
    stats = stats if stats is not None else GrowStats()
    dev = binned.device
    n, f = binned.shape
    L, B = int(num_leaves), int(num_bins)
    na_host = na_bin.cpu().numpy() if na_bin_host is None else na_bin_host
    rank_iota = torch.arange(B, dtype=torch.int32, device=dev)

    # --- root: histogram, aggregates, best split -------------------------
    hist = torch.zeros((L, f, B, 3), dtype=torch.float32, device=dev)
    hist[0] = compute_histogram(binned, vals, num_bins=B)
    total0 = vals.sum(dim=0)
    root_out = leaf_output(total0[0], total0[1], params)
    table = torch.zeros((L, sp.RECORD), dtype=torch.float32, device=dev)
    table[:, sp.GAIN] = float("-inf")
    table[0] = find_best_split(hist[0:1], total0[None], root_out[None],
                               num_bin, na_bin, feature_mask, params)[0]
    # one copy brings the root's sums and the table of the first step
    flat = _fetch(torch.cat([total0, root_out[None], table.reshape(-1)]),
                  stats)
    root, tab = flat[:4], flat[4:].reshape(L, sp.RECORD)

    # --- host tree arrays ----------------------------------------------
    nn = max(L - 1, 0)
    split_feature = np.zeros(nn, np.int32)
    threshold_bin = np.zeros(nn, np.int32)
    default_left = np.zeros(nn, bool)
    left_child = np.zeros(nn, np.int32)
    right_child = np.zeros(nn, np.int32)
    split_gain = np.zeros(nn, np.float32)
    internal_value = np.zeros(nn, np.float32)
    internal_weight = np.zeros(nn, np.float32)
    internal_count = np.zeros(nn, np.float32)
    leaf_value = np.zeros(L, np.float32)
    leaf_weight = np.zeros(L, np.float32)
    leaf_count = np.zeros(L, np.float32)
    leaf_depth = np.zeros(L, np.int32)
    leaf_parent = np.full(L, -1, np.int32)
    leaf_value[0], leaf_weight[0], leaf_count[0] = root[3], root[1], root[2]

    leaf_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
    pair = torch.empty((2, f, B, 3), dtype=torch.float32, device=dev)
    nl = 1
    while nl < L:
        leaf = int(np.argmax(tab[:, sp.GAIN]))
        rec = tab[leaf]
        if not rec[sp.GAIN] > 0.0:
            break
        i, new_leaf = nl - 1, nl
        feat, thr = int(rec[sp.FEATURE]), int(rec[sp.THRESHOLD])
        dleft = bool(rec[sp.DEFAULT_LEFT])
        lsum, rsum = rec[sp.LEFT_SUM], rec[sp.RIGHT_SUM]

        # tree bookkeeping (Tree::Split, src/io/tree.cpp)
        parent = leaf_parent[leaf]
        if parent >= 0:
            if left_child[parent] == ~leaf:
                left_child[parent] = i
            if right_child[parent] == ~leaf:
                right_child[parent] = i
        left_child[i], right_child[i] = ~leaf, ~new_leaf

        # partition rows (B3) and the smaller child's histogram (B1)
        smaller_left = lsum[2] <= rsum[2]
        smaller = leaf if smaller_left else new_leaf
        slot = partition(binned, leaf_of_row, feat, thr, dleft,
                         int(na_host[feat]), rank_iota, leaf, new_leaf,
                         smaller)
        small, large = (0, 1) if smaller_left else (1, 0)
        pair[small] = compute_histogram(binned, vals, num_bins=B, slot=slot)
        torch.sub(hist[leaf], pair[small], out=pair[large])
        hist[leaf] = pair[0]
        hist[new_leaf] = pair[1]

        # leaf stats
        d = leaf_depth[leaf] + 1
        internal_value[i] = leaf_value[leaf]
        internal_weight[i] = leaf_weight[leaf]
        internal_count[i] = leaf_count[leaf]
        leaf_value[leaf], leaf_value[new_leaf] = rec[sp.LEFT_OUTPUT], \
            rec[sp.RIGHT_OUTPUT]
        leaf_weight[leaf], leaf_weight[new_leaf] = lsum[1], rsum[1]
        leaf_count[leaf], leaf_count[new_leaf] = lsum[2], rsum[2]
        leaf_depth[leaf] = leaf_depth[new_leaf] = d
        leaf_parent[leaf] = leaf_parent[new_leaf] = i
        split_feature[i], threshold_bin[i] = feat, thr
        default_left[i], split_gain[i] = dleft, rec[sp.GAIN]

        # best splits of both children (B2 on the pair)
        sums = table[leaf, 4:10].reshape(2, 3)
        outs = table[leaf, 10:12]
        children = find_best_split(pair, sums, outs, num_bin, na_bin,
                                   feature_mask, params)
        if max_depth > 0 and d >= max_depth:
            children[:, sp.GAIN] = float("-inf")
        table[leaf] = children[0]
        table[new_leaf] = children[1]
        nl += 1
        stats.splits += 1
        if nl < L:
            tab = _fetch(table, stats)

    return TreeArrays(
        num_leaves=nl, split_feature=split_feature,
        threshold_bin=threshold_bin, default_left=default_left,
        left_child=left_child, right_child=right_child,
        split_gain=split_gain, leaf_value=leaf_value,
        leaf_weight=leaf_weight, leaf_count=leaf_count,
        internal_value=internal_value, internal_weight=internal_weight,
        internal_count=internal_count, leaf_depth=leaf_depth,
        leaf_of_row=leaf_of_row, is_cat_node=np.zeros(nn, bool),
        cat_rank=np.broadcast_to(np.arange(B, dtype=np.int32),
                                 (nn, B)).copy(),
        n_steps=nl - 1)


def partition(binned: torch.Tensor, leaf_of_row: torch.Tensor, feature: int,
              threshold: int, default_left: bool, na_bin: int,
              rank_vec: torch.Tensor, leaf: int, new_leaf: int,
              smaller: int) -> torch.Tensor:
    """Row partition (kernel B3), in place on ``leaf_of_row``: rows of
    ``leaf`` that go right move to ``new_leaf`` (go left iff NA bin ?
    default_left : rank_vec[bin] <= threshold).  Returns the slot vector
    of the next histogram pass (0 where the row is in ``smaller``, else
    -1).  CUDA tensors launch the kernel of ``csrc/partition.cu``, CPU
    tensors run ``partition_plain``."""
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, F] uint8 tensor")
    if leaf_of_row.shape != (binned.shape[0],) \
            or leaf_of_row.dtype != torch.int32:
        raise TypeError("leaf_of_row must be a [N] int32 tensor")
    if rank_vec.dtype != torch.int32 or rank_vec.dim() != 1:
        raise TypeError("rank_vec must be an int32 vector")
    if not 0 <= feature < binned.shape[1]:
        raise ValueError(f"feature {feature} out of range")
    if leaf_of_row.device != binned.device \
            or rank_vec.device != binned.device:
        raise ValueError("partition inputs must be on one device")
    if binned.device.type == "cpu":
        return partition_plain(binned, leaf_of_row, feature, threshold,
                               default_left, na_bin, rank_vec, leaf,
                               new_leaf, smaller)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and leaf_of_row.is_contiguous()
            and rank_vec.is_contiguous()):
        raise ValueError("partition needs contiguous tensors")
    n, f = binned.shape
    slot = torch.empty(n, dtype=torch.int32, device=binned.device)
    if n == 0:
        return slot
    err = _kernels.lib("partition").lgbt_partition(
        binned.data_ptr(), n, f, int(feature), int(threshold),
        int(bool(default_left)), int(na_bin), rank_vec.data_ptr(), int(leaf),
        int(new_leaf), int(smaller), leaf_of_row.data_ptr(), slot.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.check(err, "partition")
    _kernels.LAUNCHES["partition"] += 1
    return slot


def partition_plain(binned, leaf_of_row, feature: int, threshold: int,
                    default_left: bool, na_bin: int, rank_vec, leaf: int,
                    new_leaf: int, smaller: int) -> torch.Tensor:
    """Plain PyTorch version of B3 (``torch.where``), same contract."""
    col = binned[:, feature].to(torch.int64)
    is_na = (col == na_bin) if na_bin >= 0 else torch.zeros_like(
        col, dtype=torch.bool)
    go_left = torch.where(is_na, bool(default_left), rank_vec[col] <= threshold)
    moved = torch.where((leaf_of_row == leaf) & ~go_left,
                        torch.full_like(leaf_of_row, new_leaf), leaf_of_row)
    leaf_of_row.copy_(moved)
    return torch.where(leaf_of_row == smaller, 0, -1).to(torch.int32)
