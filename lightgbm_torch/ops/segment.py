"""The partitioned learner's segment programs (kernels B11a, B11b, B11c).

Counterparts of the JAX package's ``grower_partitioned.py``
``_hist_segment``, ``_partition_segment`` and ``_leaf_of_row``.  The
learner (``grower_partitioned.py``) keeps one device permutation
``order`` [N] int32 of the rows, grouped by leaf; a leaf's rows are the
segment ``order[begin:begin + count]``, with ``begin`` and ``count`` on
the host.  The TPU programs pad every segment to a power of two so that
each jitted shape is static; these take the segment's true count.

- ``segment_histogram`` (B11a): the [F, B, 3] histogram of the segment's
  rows, f32 in an order fixed by the count and the shapes, or exact int32
  on int8/int16 vals (quantized training).  Its launch is B1's over the
  segment's count, so ``rows_per_block`` (the JAX package's ``block_rows``,
  which its ``_hist_segment`` hands to ``compute_histogram``) is B1's
  knob: the rows of one row block of the segment, rounded up as B1 and
  B1-int round it (``histogram.launch_shape``, ``int_launch_shape``), 0
  the automatic shape;
- ``partition_segment`` (B11b): the stable in-place partition of a
  segment by a split (left rows first, each side in its former order);
  returns the left count as a [1] int32 device tensor, which the grower
  fetches (the split's one sync);
- ``leaf_of_row`` (B11c): every row's leaf from ``order`` and the host's
  sorted segment table.

On CUDA tensors each launches its kernel of ``csrc/segment.cu`` (and
counts it in ``_kernels.LAUNCHES``); on CPU tensors it runs its plain
PyTorch version below, and nowhere else.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from .histogram import (INT_VALS, form_launch_shape, histogram_int_plain,
                        histogram_plain, int_launch_shape, launch_shape)


def _check_order(order: torch.Tensor, n: int, begin: int,
                 count: int) -> None:
    if order.shape != (n,) or order.dtype != torch.int32:
        raise TypeError("order must be a [N] int32 tensor")
    if begin < 0 or count < 0 or begin + count > n:
        raise ValueError(f"segment [{begin}, {begin + count}) is outside "
                         f"the {n} rows")


def _device(*ts) -> str:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError("the segment kernels' inputs must be on one "
                         "device")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError("the segment kernels need contiguous tensors")
    return dev.type


def segment_histogram(binned: torch.Tensor, vals: torch.Tensor,
                      order: torch.Tensor, begin: int, count: int, *,
                      num_bins: int,
                      rows_per_block: int = 0) -> torch.Tensor:
    """B11a: the [F, num_bins, 3] histogram of the rows
    ``order[begin:begin + count]`` of ``binned`` [N, F] uint8 (the EFB
    groups on a bundled matrix) with ``vals`` [N, 3]: f32 for f32 vals,
    exact int32 for int8/int16 vals.  Bins >= num_bins add nothing.
    ``rows_per_block``: the rows of a row block on the card (0 =
    automatic; module docstring)."""
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, F] uint8 tensor")
    n, f = binned.shape
    if vals.shape != (n, 3) or vals.dtype not in (torch.float32,) + INT_VALS:
        raise TypeError("vals must be a [N, 3] float32, int8 or int16 "
                        "tensor")
    begin, count = int(begin), int(count)
    _check_order(order, n, begin, count)
    integer = vals.dtype in INT_VALS
    if _device(binned, vals, order) == "cpu":
        if rows_per_block > 0:
            # the cap of an explicit row block, which a launch shape
            # checks on the card
            form_launch_shape(count, f, num_bins, None, integer,
                              rows_per_block)
        return segment_histogram_plain(binned, vals, order, begin, count,
                                       num_bins=num_bins)
    dev = binned.device
    out = torch.empty((f, num_bins, 3),
                      dtype=torch.int32 if integer else torch.float32,
                      device=dev)
    if count == 0:
        return out.zero_()
    lib = _kernels.lib("segment")
    stream = _kernels.stream_ptr(dev)
    if integer:
        rows, tile_f, _ = int_launch_shape(count, f, num_bins,
                                           rows_per_block=rows_per_block)
        partial = torch.empty((-(-count // rows), f, num_bins, 3),
                              dtype=torch.int32, device=dev)
        err = lib.lgbt_segment_histogram_int(
            binned.data_ptr(), vals.data_ptr(),
            8 if vals.dtype == torch.int8 else 16, order.data_ptr(), begin,
            count, f, num_bins, rows, tile_f, partial.data_ptr(),
            out.data_ptr(), stream)
        _kernels.launched("segment_histogram_int", err)
        return out
    rows, tile_f, subranges = launch_shape(count, f, num_bins,
                                           rows_per_block)
    partial = torch.empty((-(-count // rows), f, num_bins, 3),
                          dtype=torch.float32, device=dev)
    err = lib.lgbt_segment_histogram(
        binned.data_ptr(), vals.data_ptr(), order.data_ptr(), begin, count,
        f, num_bins, rows, tile_f, subranges, partial.data_ptr(),
        out.data_ptr(), stream)
    _kernels.launched("segment_histogram", err)
    return out


def segment_histogram_plain(binned, vals, order, begin: int, count: int, *,
                            num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of B11a: B1's plain version (or B1-int's) on
    the segment's gathered rows, in segment order."""
    idx = order[begin:begin + count].to(torch.int64)
    rows, v = binned.index_select(0, idx), vals.index_select(0, idx)
    if vals.dtype in INT_VALS:
        return histogram_int_plain(rows, v, num_bins=num_bins)
    return histogram_plain(rows, v, num_bins=num_bins)


def partition_segment(binned: torch.Tensor, order: torch.Tensor, begin: int,
                      count: int, *, col: int, na_bin: int, goff: int,
                      nbm1: int, threshold: int, default_left: bool,
                      rank: torch.Tensor,
                      scratch: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """B11b: partition ``order[begin:begin + count]`` in place, stably,
    left rows first; returns the left count, a [1] int32 device tensor.
    A row goes left iff its bin is ``na_bin`` (>= 0) ? ``default_left`` :
    ``rank[bin] <= threshold``, the bin being ``binned[row, col]``, or,
    with ``goff`` >= 0 (a bundled feature of the EFB group column
    ``col``), ``goff <= v < goff + nbm1 ? v - goff + 1 : 0``.  A
    categorical split passes ``na_bin`` -1 and its decision ``rank`` [B]
    int32; a numerical one the identity.  ``scratch``: a [N] int32 device
    buffer the kernel may use (a new one when None)."""
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, C] uint8 tensor")
    n, cols = binned.shape
    begin, count = int(begin), int(count)
    _check_order(order, n, begin, count)
    if rank.dim() != 1 or rank.dtype != torch.int32 or rank.numel() == 0:
        raise TypeError("rank must be a non-empty [B] int32 tensor")
    if not 0 <= int(col) < cols:
        raise ValueError(f"column {col} is outside the {cols} columns")
    kind = _device(binned, order, rank)
    if kind == "cpu":
        return partition_segment_plain(
            binned, order, begin, count, col=col, na_bin=na_bin, goff=goff,
            nbm1=nbm1, threshold=threshold, default_left=default_left,
            rank=rank)
    dev = binned.device
    left = torch.empty(1, dtype=torch.int32, device=dev)
    if count == 0:
        return left.zero_()
    if scratch is None:
        scratch = torch.empty(n, dtype=torch.int32, device=dev)
    elif scratch.shape != (n,) or scratch.dtype != torch.int32 \
            or scratch.device != dev:
        raise TypeError("scratch must be a [N] int32 tensor on the rows' "
                        "device")
    tiles = torch.empty(-(-count // 1024), dtype=torch.int32, device=dev)
    err = _kernels.lib("segment").lgbt_partition_segment(
        binned.data_ptr(), cols, order.data_ptr(), begin, count, int(col),
        int(na_bin), int(goff), int(nbm1), int(threshold),
        int(bool(default_left)), rank.data_ptr(), rank.numel(),
        tiles.data_ptr(), scratch.data_ptr(), left.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.launched("partition_segment", err)
    return left


def partition_segment_plain(binned, order, begin: int, count: int, *,
                            col: int, na_bin: int, goff: int, nbm1: int,
                            threshold: int, default_left: bool,
                            rank: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B11b: the predicate on the gathered
    column, then the left rows and the right rows each in segment order
    (boolean selection keeps order)."""
    seg = order[begin:begin + count]
    g = binned[seg.to(torch.int64), int(col)].to(torch.int64)
    if goff >= 0:
        g = torch.where((g >= goff) & (g < goff + nbm1), g - goff + 1, 0)
    r = rank.to(torch.int64)[g.clamp_max(rank.numel() - 1)]
    left = r <= int(threshold)
    if na_bin >= 0:
        left = torch.where(g == int(na_bin), bool(default_left), left)
    order[begin:begin + count] = torch.cat([seg[left], seg[~left]])
    return left.sum(dtype=torch.int32).reshape(1)


def leaf_of_row(order: torch.Tensor, seg_begin: torch.Tensor,
                seg_leaf: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B11c: the [N] int32 leaf of every row: ``out[order[p]] =
    seg_leaf[s]``, s the last segment with ``seg_begin[s] <= p``
    (``seg_begin`` [S] int32 ascending from 0).  ``out``: the [N] int32
    tensor to write into (a new one when None)."""
    n = order.shape[0]
    if order.dim() != 1 or order.dtype != torch.int32:
        raise TypeError("order must be a [N] int32 tensor")
    s = seg_begin.shape[0]
    if seg_begin.shape != (s,) or seg_leaf.shape != (s,) or s == 0 \
            or seg_begin.dtype != torch.int32 \
            or seg_leaf.dtype != torch.int32:
        raise TypeError("seg_begin and seg_leaf must be non-empty [S] int32 "
                        "tensors")
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=order.device)
    elif out.shape != (n,) or out.dtype != torch.int32:
        raise TypeError("out must be a [N] int32 tensor")
    if _device(order, seg_begin, seg_leaf, out) == "cpu":
        return out.copy_(leaf_of_row_plain(order, seg_begin, seg_leaf))
    err = _kernels.lib("segment").lgbt_leaf_of_row(
        order.data_ptr(), n, seg_begin.data_ptr(), seg_leaf.data_ptr(), s,
        out.data_ptr(), _kernels.stream_ptr(order.device))
    _kernels.launched("leaf_of_row", err)
    return out


def leaf_of_row_plain(order, seg_begin, seg_leaf) -> torch.Tensor:
    """Plain PyTorch version of B11c (``torch.searchsorted`` and a
    scatter, the JAX program's own steps)."""
    n = order.shape[0]
    pos = torch.arange(n, dtype=torch.int32, device=order.device)
    seg = torch.searchsorted(seg_begin, pos, right=True) - 1
    out = torch.zeros(n, dtype=torch.int32, device=order.device)
    out[order.to(torch.int64)] = seg_leaf[seg]
    return out
