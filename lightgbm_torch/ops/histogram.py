"""Histogram construction (kernel B1), the hot pass of GBDT training.

Counterpart of the JAX package's ``ops/histogram.py`` ``compute_histogram``
(``_compute_histogram_matmul``):

    hist[f, b, c] = sum over rows n of [binned[n, f] == b] * vals[n, c]

over the rows whose ``slot`` is >= 0 (every row when ``slot`` is None).
Channels are (grad*w, hess*w, w).  On a CUDA tensor this launches the
hand-written kernel of ``csrc/histogram.cu`` (deterministic: its summation
order is fixed by the shapes alone); on a CPU tensor it runs
``histogram_plain``, the kernel's plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels

# shared memory a block may use on Hopper (227 KB, raised once at load),
# and the caps of the kernel's launch shape (see csrc/histogram.cu)
_SMEM_BYTES = _kernels.HIST_SMEM_BYTES
_MAX_SUBRANGES = 8
_MAX_THREADS = 1024
# row blocks: about one per SM of an H100 (132), but never under 1024 rows.
# A constant, not the device's SM count, so the summation order — and the
# trained model — depends on the shapes alone.
_ROW_BLOCKS = 132
_MIN_ROWS_PER_BLOCK = 1024


def launch_shape(n: int, num_features: int,
                 num_bins: int) -> Tuple[int, int, int]:
    """(rows_per_block, tile_f, subranges) of the B1 kernel for these
    shapes: as many features per block as fit in shared memory with up to
    ``_MAX_SUBRANGES`` row sub-ranges each."""
    slice_bytes = num_bins * 3 * 4
    tile_f = min(num_features, _SMEM_BYTES // slice_bytes, _MAX_THREADS)
    if tile_f < 1:
        raise ValueError(f"num_bins={num_bins} is too large for one "
                         "feature's histogram in shared memory")
    subranges = max(1, min(_MAX_SUBRANGES,
                           _SMEM_BYTES // (tile_f * slice_bytes),
                           _MAX_THREADS // tile_f))
    rows = max(-(-n // _ROW_BLOCKS), _MIN_ROWS_PER_BLOCK)
    rows = -(-rows // subranges) * subranges
    return rows, tile_f, subranges


def _check(binned: torch.Tensor, vals: torch.Tensor,
           slot: Optional[torch.Tensor],
           active: Optional[torch.Tensor] = None) -> None:
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, F] uint8 tensor")
    if vals.dim() != 2 or vals.shape != (binned.shape[0], 3) \
            or vals.dtype != torch.float32:
        raise TypeError("vals must be a [N, 3] float32 tensor")
    tensors = [binned, vals]
    if slot is not None:
        if slot.shape != (binned.shape[0],) or slot.dtype != torch.int32:
            raise TypeError("slot must be a [N] int32 tensor")
        tensors.append(slot)
    if active is not None:
        if active.shape != (1,) or active.dtype != torch.int32:
            raise TypeError("active must be a [1] int32 tensor")
        tensors.append(active)
    if any(t.device != binned.device for t in tensors):
        raise ValueError("binned, vals, slot and active must be on one "
                         "device")


def compute_histogram(binned: torch.Tensor, vals: torch.Tensor, *,
                      num_bins: int,
                      slot: Optional[torch.Tensor] = None,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[F, num_bins, 3] f32 histogram of ``vals`` over ``binned``; rows
    whose ``slot`` is negative add nothing.  The strict grower passes
    ``slot`` = 0 for the smaller child's rows and -1 elsewhere (the JAX
    package's ``num_slots=1`` form; multi-slot is ROADMAP A8), and its
    step's ``active`` flag (a [1] int32 device tensor): where it is 0 the
    pass does nothing and the result is unspecified."""
    _check(binned, vals, slot, active)
    if binned.device.type == "cpu":
        return histogram_plain(binned, vals, num_bins=num_bins, slot=slot,
                               active=active)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and vals.is_contiguous()
            and (slot is None or slot.is_contiguous())):
        raise ValueError("compute_histogram needs contiguous tensors")
    n, f = binned.shape
    out = torch.empty((f, num_bins, 3), dtype=torch.float32,
                      device=binned.device)
    if n == 0:
        return out.zero_()
    rows, tile_f, subranges = launch_shape(n, f, num_bins)
    nblocks = -(-n // rows)
    partial = torch.empty((nblocks, f, num_bins, 3), dtype=torch.float32,
                          device=binned.device)
    lib = _kernels.lib("histogram")
    err = lib.lgbt_histogram(
        binned.data_ptr(), vals.data_ptr(),
        None if slot is None else slot.data_ptr(), n, f, num_bins, rows,
        tile_f, subranges, None if active is None else active.data_ptr(),
        partial.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("histogram", err)
    return out


def histogram_plain(binned: torch.Tensor, vals: torch.Tensor, *,
                    num_bins: int,
                    slot: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of B1: ``index_add_`` over ``f*B + bin``.
    Bins >= num_bins add nothing, as in the kernel; an inactive step
    returns zeros."""
    if active is not None and not bool(active[0]):
        return torch.zeros((binned.shape[1], num_bins, 3),
                           dtype=torch.float32, device=binned.device)
    if slot is not None:
        keep = slot >= 0
        binned, vals = binned[keep], vals[keep]
    n, f = binned.shape
    b = binned.to(torch.int64)
    offs = torch.arange(f, device=binned.device, dtype=torch.int64) * num_bins
    idx = (b + offs).reshape(-1)
    ok = (b < num_bins).reshape(-1)
    src = vals.repeat_interleave(f, dim=0)
    out = torch.zeros((f * num_bins, 3), dtype=torch.float32,
                      device=binned.device)
    out.index_add_(0, idx[ok], src[ok])
    return out.reshape(f, num_bins, 3)
