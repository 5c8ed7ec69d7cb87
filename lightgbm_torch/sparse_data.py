"""Sparse binned storage (kernel B8): the padded k-hot row layout.

Counterpart of the JAX package's ``sparse_data.py`` (the analog of the
reference's ``SparseBin``, sparse_bin.hpp:73, and ``MultiValSparseBin``).
A wide sparse matrix (Allstate-shaped: 4,228 dummy columns, about 35
stored values a row) keeps, per row, only the entries whose bin differs
from the feature's *default bin* (the bin of the absent value 0.0):

    flat[n, k] = f * stride + b        the k-th stored entry of row n
    flat[n, k] = -1                    padding

an ``[N, K]`` int32 matrix, K the most entries of a row, beside the
``[F]`` default bins.  At 1M x 4,228 with K = 35 that is 140 MB where the
dense ``[N, F]`` uint8 matrix is 4.23 GB.

The host half (``SparseBinnedHost``, ``collect_entries_csc``,
``build_khot``) is the JAX package's, line for line, so a Dataset of either
package holds the same arrays.  The device half is ``SparseBinned``, which
the trainer keeps in the place of the dense matrix, and its functions:

- ``column`` / ``column_per_row``: a feature's bin of every row, or of
  each row's own feature, from the row's entries (the default bin where
  none is stored);
- ``histogram`` (kernel B8a, ``csrc/sparse.cu``): the histogram of the
  stored entries, then each feature's default bin filled with the slot's
  total minus its stored mass (FixHistogram, dataset.cpp:1292), in the
  three forms of ``ops/histogram.compute_histogram`` (all rows; the strict
  grower's ``slot`` with its ``active`` flag; K slots with ``slots_used``);
- the tree walk over k-hot rows (B8c) is B4 itself: ``predict_device``'s
  ``add_tree_score`` and ``traverse_tree_plain`` take a ``SparseBinned``
  where they take the binned matrix, and the row partition (B8b) is
  B3/B3-K: ``grower.partition`` and ``partition_slots`` take it too.  On
  the card the decode is one device function (``csrc/rowbin.cuh``) shared
  by ``partition.cu`` and ``predict.cu``.

On a CUDA tensor ``histogram`` launches its kernel; on a CPU tensor it
runs ``histogram_plain``.  The kernel sums in 64-bit fixed point (each
value scaled by a power of two chosen from the largest magnitude of all N
rows of vals so that no sum can overflow, then rounded to an integer), so
its sums do not depend on the order or grouping of the adds: every rerun,
launch shape and tile plan gives the same bits.  The plain version sums
in f64 in row order.  Both round each bin once to f32.  The host computes
the kernel's workspace size (``ws_words``, from the layout
``ws_layout``) and the root pass's plan of feature tiles and row ranges
(``root_plan``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import _kernels

# the scale's partial maxima (csrc/fixed.cuh ``absmax_parts``): blocks of
# the prep kernel, rows of its [parts, 3] table
SCALE_PARTS = 128
# the root pass's tiles (csrc/sparse.cu ``root_tile``): bytes ahead of a
# tile in shared memory, the bytes of a (feature, bin) cell's three 64-bit
# counters, and the most tiles before the root pass takes the row pass
# instead (each tile reads every entry once more)
ROOT_TILE_HEAD = 64
ROOT_CELL_BYTES = 3 * 8
MAX_ROOT_TILES = 16
# root-pass blocks an SM (a tile of up to 227 KB keeps one block an SM)
ROOT_BLOCKS_PER_SM = 1
# the most slots of the K form on the card (csrc/sparse.cu kMaxRowSlots;
# the batched grower's K is at most 64)
MAX_SLOTS = 64

class SparseBinned:
    """Device-side padded k-hot binned matrix.

    flat:         [N, K] int32, ``f * stride + b`` or -1 padding
    default_bin:  [F] int32, the bin of the absent value, per used feature
    stride:       the bin-axis stride (>= every feature's num_bin)
    num_features: F
    """

    __slots__ = ("flat", "default_bin", "stride", "num_features")

    def __init__(self, flat: torch.Tensor, default_bin: torch.Tensor,
                 stride: int, num_features: int):
        if flat.dim() != 2 or flat.dtype != torch.int32:
            raise TypeError("flat must be an [N, K] int32 tensor")
        if default_bin.shape != (int(num_features),) \
                or default_bin.dtype != torch.int32:
            raise TypeError("default_bin must be an [F] int32 tensor")
        if default_bin.device != flat.device:
            raise ValueError("flat and default_bin must be on one device")
        self.flat = flat
        self.default_bin = default_bin
        self.stride = int(stride)
        self.num_features = int(num_features)

    @property
    def shape(self):
        """(N, F): the dense binned matrix's shape contract."""
        return (self.flat.shape[0], self.num_features)

    @property
    def k(self) -> int:
        return self.flat.shape[1]

    @property
    def device(self) -> torch.device:
        return self.flat.device

    def is_contiguous(self) -> bool:
        return self.flat.is_contiguous() and self.default_bin.is_contiguous()

    def take_rows(self, idx: torch.Tensor) -> "SparseBinned":
        """Row gather (the JAX package's ``take_rows``)."""
        return SparseBinned(self.flat.index_select(0, idx), self.default_bin,
                            self.stride, self.num_features)


def khot_args(binned) -> tuple:
    """The k-hot arguments of the C entry points that read rows (B3,
    B3-K, B4): (flat, K, stride, default_bin) of ``SparseBinned`` rows, or
    nulls for a dense matrix."""
    if not isinstance(binned, SparseBinned):
        return None, 0, 0, None
    return (binned.flat.data_ptr(), binned.k, binned.stride,
            binned.default_bin.data_ptr())


def column(sp: SparseBinned, feat) -> torch.Tensor:
    """[N] int32 bin of feature ``feat`` (an int or a 0-dim tensor) for
    every row: the matching entry's bin, else the default bin (the JAX
    package's ``column``)."""
    f = torch.as_tensor(feat, device=sp.device).to(torch.int64)
    return column_per_row(sp, f.expand(sp.flat.shape[0]))


def column_per_row(sp: SparseBinned, feat_r: torch.Tensor) -> torch.Tensor:
    """[N] int32 bin of feature ``feat_r[n]`` for row n: the sum of the
    matching entries' bins (a row stores a feature at most once), else the
    default bin (the JAX package's ``column_per_row``)."""
    f = feat_r.to(torch.int64)
    lo = (f * sp.stride)[:, None]
    fl = sp.flat.to(torch.int64)
    m = (fl >= lo) & (fl < lo + sp.stride)
    binv = torch.where(m, fl - lo, 0).sum(dim=1)
    return torch.where(m.any(dim=1), binv,
                       sp.default_bin.to(torch.int64)[f]).to(torch.int32)


def _check_hist(sp, vals, slot, active, num_slots, slots_used) -> None:
    if not isinstance(sp, SparseBinned):
        raise TypeError("sp must be a SparseBinned")
    n = sp.flat.shape[0]
    if vals.dtype != torch.float32:
        # quantized training on sparse storage is refused, as in the JAX
        # package
        raise TypeError("the k-hot histogram takes float32 vals (quantized "
                        "training needs dense binned storage)")
    if vals.shape != (n, 3):
        raise TypeError("vals must be a [N, 3] float32 tensor")
    tensors = [vals]
    if slot is not None:
        if slot.shape != (n,) or slot.dtype != torch.int32:
            raise TypeError("slot must be a [N] int32 tensor")
        tensors.append(slot)
    if active is not None:
        if active.shape != (1,) or active.dtype != torch.int32:
            raise TypeError("active must be a [1] int32 tensor")
        tensors.append(active)
    if num_slots is not None:
        if slot is None or int(num_slots) < 1:
            raise ValueError("the K-slot form needs slot and num_slots >= 1")
        if slots_used is None or slots_used.shape != (1,) \
                or slots_used.dtype != torch.int32:
            raise TypeError("the K-slot form needs slots_used, a [1] int32 "
                            "tensor")
        tensors.append(slots_used)
    if any(t.device != sp.device for t in tensors):
        raise ValueError("the k-hot matrix, vals, slot and active must be "
                         "on one device")


def ws_layout(num_slots: int, num_features: int, stride: int) -> dict:
    """The regions of B8a's workspace (csrc/sparse.cu ``sparse_ws``) as
    byte ranges [start, end): ``acc`` [S, F, stride, 3] and ``tot`` [S, 3]
    int64, ``side_acc`` and ``side_tot`` of the same shapes in f32, and
    ``mxp`` [SCALE_PARTS, 3] uint32 (the scale's partial maxima);
    ``words``, the int64 words of the whole."""
    a = num_slots * num_features * stride * 3
    t = num_slots * 3
    ints = a + t
    f0 = 8 * ints
    m0 = 8 * (ints + -(-ints // 2))
    return {"acc": (0, 8 * a), "tot": (8 * a, 8 * ints),
            "side_acc": (f0, f0 + 4 * a), "side_tot": (f0 + 4 * a,
                                                       f0 + 4 * ints),
            "mxp": (m0, m0 + 4 * 3 * SCALE_PARTS),
            "words": m0 // 8 + -(-SCALE_PARTS * 3 // 2)}


def ws_words(num_slots: int, num_features: int, stride: int) -> int:
    """int64 words of one B8a workspace (``ws_layout``)."""
    return ws_layout(num_slots, num_features, stride)["words"]


def root_plan(n: int, num_features: int, stride: int, sms: int = 132,
              smem_bytes: int = _kernels.SMEM_BYTES) -> tuple:
    """The root pass's launch plan: (tile_f, ranges).  The feature axis is
    cut into the fewest tiles whose [tile_f, stride, 3] 64-bit counters
    (and ROOT_TILE_HEAD bytes) fit ``smem_bytes``, of equal size but the
    last, tile t holding features [t * tile_f, min((t + 1) * tile_f, F));
    the rows into ``ranges`` ranges so that ranges x tiles blocks fill the
    card's ``sms`` at ROOT_BLOCKS_PER_SM.  (0, 0) when more than
    MAX_ROOT_TILES tiles would be needed: the root pass then runs the row
    pass with global atomics.  The launch plan changes no bit."""
    cap = (smem_bytes - ROOT_TILE_HEAD) // (stride * ROOT_CELL_BYTES)
    if cap < 1 or num_features < 1:
        return 0, 0
    tiles = -(-num_features // cap)
    if tiles > MAX_ROOT_TILES:
        return 0, 0
    tile_f = -(-num_features // tiles)
    ranges = max(1, min(-(-sms * ROOT_BLOCKS_PER_SM // tiles), -(-n // 32)))
    return tile_f, ranges


def histogram(sp: SparseBinned, vals: torch.Tensor, *, num_bins: int,
              slot: Optional[torch.Tensor] = None,
              num_slots: Optional[int] = None,
              active: Optional[torch.Tensor] = None,
              slots_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B8a: the histogram of ``vals`` over the k-hot rows, with the
    contract of ``ops/histogram.compute_histogram``: [F, num_bins, 3] f32
    over the rows whose ``slot`` is >= 0 (every row without ``slot``), or
    with ``num_slots=K`` [K, F, num_bins, 3], one histogram per slot
    0..K-1 (rows whose slot is outside add nothing).  Each feature's
    default bin receives the slot's total minus the feature's stored mass.
    ``active`` (a [1] int32 device flag): where it is 0 the pass does
    nothing and the result is unspecified.  ``slots_used`` as B1-K's (a
    [1] int32 device count that promises no row's slot is at or past
    it): the kernel touches the accumulators of the slots below it only
    and writes zeros for the others.  CUDA tensors launch the kernel of
    ``csrc/sparse.cu``, counted as ``histogram_sparse`` or
    ``histogram_slots_sparse``; CPU tensors run ``histogram_plain``."""
    _check_hist(sp, vals, slot, active, num_slots, slots_used)
    dev = sp.device
    if dev.type == "cpu":
        return histogram_plain(sp, vals, num_bins=num_bins, slot=slot,
                               num_slots=num_slots, active=active)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not (sp.is_contiguous() and vals.is_contiguous()
            and (slot is None or slot.is_contiguous())):
        raise ValueError("the k-hot histogram needs contiguous tensors")
    if num_slots is not None and int(num_slots) > MAX_SLOTS:
        raise ValueError(f"the k-hot histogram takes at most {MAX_SLOTS} "
                         "slots on the card")
    n, k = sp.flat.shape
    f, st = sp.num_features, sp.stride
    s = 1 if num_slots is None else int(num_slots)
    shape = (f, num_bins, 3) if num_slots is None else (s, f, num_bins, 3)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if n == 0:
        return out.zero_()
    ws = torch.empty(ws_words(s, f, st), dtype=torch.int64, device=dev)
    tile_f, ranges = root_plan(
        n, f, st, torch.cuda.get_device_properties(dev).multi_processor_count
    ) if slot is None else (0, 0)
    err = _kernels.lib("sparse").lgbt_sparse_histogram(
        sp.flat.data_ptr(), n, k, vals.data_ptr(),
        None if slot is None else slot.data_ptr(),
        0 if num_slots is None else s, f, st, int(num_bins),
        sp.default_bin.data_ptr(),
        None if active is None else active.data_ptr(),
        None if num_slots is None else slots_used.data_ptr(), SCALE_PARTS,
        tile_f, ranges, ws.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.launched("histogram_sparse" if num_slots is None
                      else "histogram_slots_sparse", err)
    return out


def histogram_plain(sp: SparseBinned, vals: torch.Tensor, *, num_bins: int,
                    slot: Optional[torch.Tensor] = None,
                    num_slots: Optional[int] = None,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of B8a (the JAX package's ``histogram``,
    sparse_data.py:108-175): the stored entries' vals summed by (slot,
    feature, bin) and each slot's totals, both in f64 in row order
    (``index_add_``); each feature's default bin then takes the slot's
    total minus the feature's stored mass; rounded once to f32.  An
    inactive step returns zeros."""
    f, st = sp.num_features, sp.stride
    s = 1 if num_slots is None else int(num_slots)
    dev = sp.device
    shape = (f, num_bins, 3) if num_slots is None else (s, f, num_bins, 3)
    if active is not None and not bool(active[0]):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    n = sp.flat.shape[0]
    if slot is None:
        sl = torch.zeros(n, dtype=torch.int64, device=dev)
    elif num_slots is None:
        sl = torch.where(slot >= 0, 0, -1).to(torch.int64)
    else:
        sl = slot.to(torch.int64)
    keep = (sl >= 0) & (sl < s)
    v64 = vals.to(torch.float64)
    tot = torch.zeros((s, 3), dtype=torch.float64, device=dev)
    tot.index_add_(0, sl[keep], v64[keep])
    fl = sp.flat.to(torch.int64)
    ok = (fl >= 0) & (fl < f * st) & keep[:, None]
    rows, ks = torch.nonzero(ok, as_tuple=True)
    cell = sl[rows] * (f * st) + fl[rows, ks]
    acc = torch.zeros((s * f * st, 3), dtype=torch.float64, device=dev)
    acc.index_add_(0, cell, v64[rows])
    acc = acc.view(s, f, st, 3)
    absent = tot[:, None, :] - acc.sum(dim=2)                  # [S, F, 3]
    feats = torch.arange(f, device=dev)
    acc[:, feats, sp.default_bin.to(torch.int64)] += absent
    b = min(int(num_bins), st)
    out = torch.zeros((s, f, num_bins, 3), dtype=torch.float32, device=dev)
    out[:, :, :b] = acc[:, :, :b].to(torch.float32)
    return out[0] if num_slots is None else out


# ----------------------------------------------------------------------
# host-side construction (the JAX package's, sparse_data.py:220-306)
# ----------------------------------------------------------------------

class SparseBinnedHost:
    """Construction product kept on the Dataset (numpy; the trainer makes
    the device copy)."""

    def __init__(self, flat: np.ndarray, default_bin: np.ndarray,
                 stride: int, num_features: int):
        self.flat = flat                    # [N, K] int32
        self.default_bin = default_bin      # [F] int32
        self.stride = int(stride)
        self.num_features = int(num_features)

    @property
    def k(self) -> int:
        return self.flat.shape[1]

    def nbytes(self) -> int:
        return self.flat.nbytes

    def to_device(self, device="cpu") -> SparseBinned:
        return SparseBinned(
            torch.as_tensor(np.ascontiguousarray(self.flat,
                                                 np.int32)).to(device),
            torch.as_tensor(np.ascontiguousarray(self.default_bin,
                                                 np.int32)).to(device),
            self.stride, self.num_features)

    def subset_rows(self, idx: np.ndarray) -> "SparseBinnedHost":
        return SparseBinnedHost(self.flat[idx], self.default_bin,
                                self.stride, self.num_features)

    def densify(self) -> np.ndarray:
        """[N, F] dense bins — for paths that need the flat layout
        (add_features_from).  O(N*F) memory: callers guard on size."""
        n, _ = self.flat.shape
        dtype = np.uint8 if self.stride <= 256 else np.uint16
        out = np.broadcast_to(self.default_bin.astype(dtype),
                              (n, self.num_features)).copy()
        rows, ks = np.nonzero(self.flat >= 0)
        fl = self.flat[rows, ks]
        out[rows, fl // self.stride] = (fl % self.stride).astype(dtype)
        return out


def collect_entries_csc(csc, mappers, used_features, stride: int):
    """The non-default-bin entries straight off a scipy CSC layout —
    O(nnz_col) per column, no N-length dense intermediate (the
    LGBM_DatasetCreateFromCSC discipline, c_api.h:281).  Returns (rows,
    flat entries, default bins)."""
    rows_l, flat_l = [], []
    default_bin = np.zeros(len(used_features), np.int32)
    for j, f in enumerate(used_features):
        m = mappers[f]
        db = int(m.value_to_bin(np.zeros(1))[0])
        default_bin[j] = db
        lo, hi = csc.indptr[f], csc.indptr[f + 1]
        idx, dat = csc.indices[lo:hi], np.asarray(csc.data[lo:hi],
                                                  np.float64)
        b = m.value_to_bin(dat).astype(np.int32)
        keep = np.nonzero(b != db)[0]
        if len(keep):
            rows_l.append(idx[keep].astype(np.int64))
            flat_l.append(j * stride + b[keep])
    if rows_l:
        rows = np.concatenate(rows_l)
        flat = np.concatenate(flat_l)
    else:
        rows = np.zeros(0, np.int64)
        flat = np.zeros(0, np.int32)
    return rows, flat, default_bin


def build_khot(rows: np.ndarray, flat: np.ndarray, default_bin: np.ndarray,
               num_data: int, stride: int, num_features: int,
               counts: Optional[np.ndarray] = None) -> SparseBinnedHost:
    """Assemble the padded [N, K] layout from entry streams.  ``counts``
    (per-row entry counts) may be passed by a caller that already
    bincounted the stream for the layout decision."""
    if counts is None:
        counts = np.bincount(rows, minlength=num_data) if len(rows) \
            else np.zeros(num_data, np.int64)
    k = int(max(counts.max() if num_data else 0, 1))
    out = np.full((num_data, k), -1, np.int32)
    if len(rows):
        order = np.argsort(rows, kind="stable")
        r_s, f_s = rows[order], flat[order]
        offs = np.zeros(num_data + 1, np.int64)
        np.cumsum(counts, out=offs[1:])
        pos = np.arange(len(r_s)) - offs[r_s]
        out[r_s, pos] = f_s
    return SparseBinnedHost(out, default_bin, stride, num_features)
