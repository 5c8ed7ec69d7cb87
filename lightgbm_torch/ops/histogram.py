"""Histogram construction (kernel B1), the hot pass of GBDT training.

Counterpart of the JAX package's ``ops/histogram.py`` ``compute_histogram``
(``_compute_histogram_matmul``):

    hist[f, b, c] = sum over rows n of [binned[n, f] == b] * vals[n, c]

over the rows whose ``slot`` is >= 0 (every row when ``slot`` is None),
and its K-slot form (``num_slots=K``, the batched grower's child pass),
one histogram per slot over the rows whose ``slot`` is that slot.
Channels are (grad*w, hess*w, w).  On a CUDA tensor this launches the
hand-written kernel of ``csrc/histogram.cu`` (deterministic: B1's
summation order is fixed by the shapes alone, B1-K's fixed-point sums
need no order); on a CPU tensor it runs
``histogram_plain``, the kernel's plain PyTorch version.  With int8 or
int16 ``vals`` (quantized training, ``ops/quantize.py``) both forms
return exact int32 histograms (B1-int, B1-K-int; the JAX package's
integer branch): the kernels add in shared-memory int32 atomics, the
plain versions in int64, and the two agree bit for bit.  Neither sums a
bin in one long f32 run, so a bin that holds nearly every row is as exact
as a pairwise sum: B1 sums in f64 (its per-block partials rounded once to
f32 before their f64 total), B1-K in exact 64-bit fixed point, each cell
rounded once to f32; a NaN or +-Inf in a row's vals gives that row's
cells the plain version's non-finite value; the plain version adds each bin's
rows in row order in f32 runs of ``PLAIN_RUN`` rows and the runs in f64
(``_bin_sums``), so a bin of at most ``PLAIN_RUN`` rows is the plain f32
sum of its rows in row order.

On sparse binned storage (``binned`` a ``sparse_data.SparseBinned``, the
padded k-hot rows) ``compute_histogram`` is the k-hot histogram B8a
(``sparse_data.histogram``), with the same forms and output, as the JAX
grower's ``_hist`` dispatches (grower.py:360-362).

``compute_histogram_members`` is the member axis of the fleet (B1-M,
B1-K-M, B1-int-M; the JAX package's ``build_fleet_superepoch`` vmaps the
contraction over members that share one matrix): N members' passes over
one shared dense ``binned``, each with its own vals, slot, active flag
and slot count, in one launch on the card, each member's histogram
bitwise the solo pass's.  Its plain version is the solo plain version
member by member.

Every dense form takes ``rows_per_block`` (the JAX package's
``block_rows``; the ``rows_per_block`` parameter, or ``hist_tune``'s
choice): 0 keeps the automatic launch shape of ``launch_shape``,
``slots_launch_shape`` and ``int_launch_shape``; a positive value sets the
rows of one row block (for B1-K the rows of one row range, which a
block of each tile adds), rounded up to the kernel's granularity (a multiple of the B1 kernel's row sub-ranges, a
whole warp's 32 rows of B1-K and of the integer forms).  The B1 kernel
rounds each block's partial to f32 before its f64 total, so another row
block gives a histogram a few ulps away (runs at one value stay bitwise
equal); B1-K sums in 64-bit fixed point (``csrc/fixed.cuh``: integers
whose sum does not depend on the order, at a scale fixed by ``vals``
alone) and the integer forms in int32, so both are bitwise equal at
every value.  The plain versions ignore it.  A value whose partial buffer
[row blocks, K, F, B, 3] would pass ``PARTIAL_CAP_BYTES`` is refused (B1
and the integer forms; B1-K keeps no partial).  The k-hot form B8a keeps
its own blocking, as the JAX package's sparse histogram does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from .. import _kernels
from ..sparse_data import SparseBinned
from ..sparse_data import histogram as sparse_histogram

# shared memory a block may use on Hopper (227 KB, raised once at load),
# the bytes of one accumulator (the kernel's per-thread slices are f64),
# and the caps of the kernel's launch shape (see csrc/histogram.cu)
_SMEM_BYTES = _kernels.SMEM_BYTES
_ACC_BYTES = 8
_MAX_SUBRANGES = 8
_MAX_THREADS = 1024
# row blocks: about one per SM of an H100 (132), but never under 1024 rows.
# A constant, not the device's SM count, so the summation order — and the
# trained model — depends on the shapes alone.
_ROW_BLOCKS = 132
_MIN_ROWS_PER_BLOCK = 1024
# B1-K (csrc/histogram.cu `hist_slots_tile`): a 64-bit counter of its
# tile (two 32-bit words), the shared memory before the tile, the blocks
# the automatic row ranges are dealt to (one an SM of an H100, the tiles
# of a range together), the partial maxima of the scale, and the rows of
# a warp (a row range's granularity)
_COUNTER_BYTES = 8
_SLOT_HEADER = 16
_SLOT_BLOCKS = 132
_SCALE_PARTS = 128
_WARP_ROWS = 32
# the integer forms: blocks in all (two an SM of an H100; an integer sum
# does not depend on the launch shape), the bytes of a counter, and the
# rows of a warp (an explicit row block's granularity)
_INT_BLOCKS = 264
_INT_BYTES = 4
# the largest partial buffer an explicit ``rows_per_block`` may ask for
# (1 GiB; the automatic shapes stay under it at the port's shapes: 179 MB
# at 1M x 28, 63 bins and K = 64)
PARTIAL_CAP_BYTES = 1 << 30
# vals dtypes of the integer forms
INT_VALS = (torch.int8, torch.int16)
# rows of one f32 run of a bin in the plain versions (``_bin_sums``): a
# bin of up to this many rows is the f32 sum of its rows in row order, as
# the plain versions summed every bin before runs (so small problems keep
# their former rounding, and the trees of the CPU parity tests, whose
# near-ties the JAX package breaks by its own rounding, stay as they
# were); a heavy bin's drift stays under 1e-6 of the bin
# (tests/test_torch_hist_precision.py; runs of 1,024 rows reach 2e-6)
PLAIN_RUN = 768


def _auto_rows(n: int) -> int:
    """The automatic rows of a row block of the f32 forms: about
    ``_ROW_BLOCKS`` blocks, never under ``_MIN_ROWS_PER_BLOCK`` rows."""
    return max(-(-n // _ROW_BLOCKS), _MIN_ROWS_PER_BLOCK)


def _check_partial(n: int, rows: int, num_slots: int, num_features: int,
                   num_bins: int, rows_per_block: int) -> None:
    """Refuse an explicit ``rows_per_block`` whose partial buffer would
    pass ``PARTIAL_CAP_BYTES``."""
    if rows_per_block <= 0:
        return
    nbytes = -(-n // rows) * num_slots * num_features * num_bins * 12
    if nbytes > PARTIAL_CAP_BYTES:
        raise ValueError(
            f"rows_per_block={rows_per_block} gives {-(-n // rows)} row "
            f"blocks over {n} rows, whose partial histograms ({num_slots} "
            f"slot(s) x {num_features} columns x {num_bins} bins) would "
            f"take {nbytes} bytes, past the {PARTIAL_CAP_BYTES}-byte cap; "
            "set a larger rows_per_block, or 0 for the automatic shape")


def launch_shape(n: int, num_features: int, num_bins: int,
                 rows_per_block: int = 0) -> Tuple[int, int, int]:
    """(rows_per_block, tile_f, subranges) of the B1 kernel for these
    shapes: as many features per block as fit in shared memory with up to
    ``_MAX_SUBRANGES`` row sub-ranges each; rows per block automatic at
    ``rows_per_block`` 0, else that value rounded up to a multiple of the
    sub-ranges."""
    slice_bytes = num_bins * 3 * _ACC_BYTES
    tile_f = min(num_features, _SMEM_BYTES // slice_bytes, _MAX_THREADS)
    if tile_f < 1:
        raise ValueError(f"num_bins={num_bins} is too large for one "
                         "feature's histogram in shared memory")
    subranges = max(1, min(_MAX_SUBRANGES,
                           _SMEM_BYTES // (tile_f * slice_bytes),
                           _MAX_THREADS // tile_f))
    rows = _auto_rows(n) if rows_per_block <= 0 else int(rows_per_block)
    rows = -(-rows // subranges) * subranges
    _check_partial(n, rows, 1, num_features, num_bins, rows_per_block)
    return rows, tile_f, subranges


def slots_launch_shape(n: int, num_features: int, num_bins: int,
                       num_slots: int,
                       rows_per_block: int = 0) -> Tuple[int, int, int]:
    """(rows, tile_k, tile_f) of the B1-K kernel: a block's tile [tile_k,
    tile_f, B, 3] of 64-bit counters fills the shared memory a block has,
    as many slots as fit when one slot's features do (spread evenly over
    the slot tiles), else one slot and as many features as fit, spread
    evenly; ``rows`` the rows of one row range, a whole warp's 32
    (automatic at ``rows_per_block`` 0: about ``_SLOT_BLOCKS`` blocks in
    all, never under ``_MIN_ROWS_PER_BLOCK`` rows a range)."""
    f, k = int(num_features), int(num_slots)
    slot_row = num_bins * 3 * _COUNTER_BYTES    # one (slot, feature)
    room = _SMEM_BYTES - _SLOT_HEADER
    tf_max = room // slot_row
    if tf_max < 1:
        raise ValueError(f"num_bins={num_bins} is too large for one "
                         "feature's histogram in shared memory")
    if f <= tf_max:
        tile_f, tile_k = f, min(k, room // (f * slot_row))
    else:
        tile_f, tile_k = -(-f // -(-f // tf_max)), 1
    tile_k = -(-k // -(-k // tile_k))
    tiles = -(-k // tile_k) * -(-f // tile_f)
    if rows_per_block > 0:
        rows = int(rows_per_block)
    else:
        ranges = max(1, _SLOT_BLOCKS // tiles)
        rows = max(-(-n // ranges), _MIN_ROWS_PER_BLOCK)
    return -(-rows // _WARP_ROWS) * _WARP_ROWS, tile_k, tile_f


def int_launch_shape(n: int, num_features: int, num_bins: int,
                     num_slots: Optional[int] = None,
                     rows_per_block: int = 0) -> Tuple[int, int, int]:
    """(rows_per_block, tile_f, tile_k) of the integer forms: a tile of
    ``tile_k`` slots (1 without slots) by ``tile_f`` features whose int32
    [tile_k, tile_f, B, 3] fits in shared memory, tiles balanced, and row
    blocks so that about ``_INT_BLOCKS`` blocks run in all, never under
    1024 rows a block (``rows_per_block`` 0), or of ``rows_per_block``
    rows rounded up to a whole warp's."""
    cap = _SMEM_BYTES // (num_bins * 3 * _INT_BYTES)
    if cap < 1:
        raise ValueError(f"num_bins={num_bins} is too large for one "
                         "feature's histogram in shared memory")
    f, k = int(num_features), int(num_slots or 1)
    if f <= cap:
        tile_f, tile_k = f, min(k, cap // f)
    else:
        tile_f, tile_k = -(-f // -(-f // cap)), 1
    tile_k = -(-k // -(-k // tile_k))
    tiles = -(-f // tile_f) * -(-k // tile_k)
    if rows_per_block > 0:
        rows = -(-int(rows_per_block) // _WARP_ROWS) * _WARP_ROWS
        _check_partial(n, rows, k, f, num_bins, rows_per_block)
        return rows, tile_f, tile_k
    blocks = max(1, min(-(-_INT_BLOCKS // tiles), -(-n // 1024)))
    return -(-n // blocks), tile_f, tile_k


def form_launch_shape(n: int, num_features: int, num_bins: int,
                      num_slots: Optional[int], integer: bool,
                      rows_per_block: int = 0) -> Tuple[int, int, int]:
    """The launch shape of the dense form that ``compute_histogram`` takes
    for these operands: B1 (``num_slots`` None, f32), B1-K (f32) or the
    integer forms (the ``rows_per_block`` check of every launch)."""
    if integer:
        return int_launch_shape(n, num_features, num_bins, num_slots,
                                rows_per_block)
    if num_slots is None:
        return launch_shape(n, num_features, num_bins, rows_per_block)
    return slots_launch_shape(n, num_features, num_bins, int(num_slots),
                              rows_per_block)


def _check(binned: torch.Tensor, vals: torch.Tensor,
           slot: Optional[torch.Tensor],
           active: Optional[torch.Tensor] = None) -> None:
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, F] uint8 tensor")
    if vals.dim() != 2 or vals.shape != (binned.shape[0], 3) \
            or vals.dtype not in (torch.float32,) + INT_VALS:
        raise TypeError("vals must be a [N, 3] float32, int8 or int16 "
                        "tensor")
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
                      num_slots: Optional[int] = None,
                      active: Optional[torch.Tensor] = None,
                      slots_used: Optional[torch.Tensor] = None,
                      rows_per_block: int = 0,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[F, num_bins, 3] f32 histogram of ``vals`` over ``binned`` (int32
    for int8/int16 ``vals``, exact); rows whose ``slot`` is negative add
    nothing (in the integer form, rows whose ``slot`` is not 0).  The strict grower passes
    ``slot`` = 0 for the smaller child's rows and -1 elsewhere (the JAX
    package's ``num_slots=1`` form), and its step's ``active`` flag (a [1]
    int32 device tensor): where it is 0 the pass does nothing and the
    result is unspecified.  With ``num_slots=K`` (``slot`` required) the
    result is [K, F, num_bins, 3], one histogram per slot 0..K-1 (the JAX
    package's [F, B, 3K] with channel c of slot k at c*K + k, in the
    grower's per-leaf layout); the batched grower's pass.  That form
    also needs ``slots_used``, a [1] int32 device count that promises no
    row's slot is at or past it (the super-step's valid count; a [1]
    tensor holding K for all slots): the kernel spreads the rows of the
    slots in use over the threads of the others.  ``rows_per_block``:
    the rows of a row block on the card (0 = automatic; module
    docstring).  On k-hot ``SparseBinned`` rows this is B8a (module
    docstring), which keeps its own blocking.  ``out``: a contiguous [F,
    num_bins, 3] tensor of the result's dtype to write into (the one-slot
    dense forms; the data-parallel learner passes a view of its padded
    reduce-scatter buffer)."""
    if out is not None:
        if num_slots is not None or isinstance(binned, SparseBinned):
            raise TypeError("out is taken by the one-slot dense forms")
        want = torch.int32 if vals.dtype in INT_VALS else torch.float32
        if out.shape != (binned.shape[1], num_bins, 3) \
                or out.dtype != want or not out.is_contiguous() \
                or out.device != binned.device:
            raise TypeError(f"out must be a contiguous [F, {num_bins}, 3] "
                            f"{want} tensor on the binned matrix's device")
    if isinstance(binned, SparseBinned):
        return sparse_histogram(binned, vals, num_bins=num_bins, slot=slot,
                                num_slots=num_slots, active=active,
                                slots_used=slots_used)
    _check(binned, vals, slot, active)
    integer = vals.dtype in INT_VALS
    if rows_per_block > 0 and binned.device.type == "cpu":
        # the cap of an explicit row block, which a launch shape checks
        # on the card
        form_launch_shape(binned.shape[0], binned.shape[1], num_bins,
                          num_slots, integer, rows_per_block)
    if num_slots is not None:
        if slots_used is None or slots_used.shape != (1,) \
                or slots_used.dtype != torch.int32 \
                or slots_used.device != binned.device:
            raise TypeError("the K-slot form needs slots_used, a [1] int32 "
                            "tensor on the binned matrix's device")
        return _histogram_slots(binned, vals, slot, int(num_slots),
                                num_bins, active, slots_used,
                                rows_per_block)
    if binned.device.type == "cpu":
        plain = histogram_int_plain if integer else histogram_plain
        res = plain(binned, vals, num_bins=num_bins, slot=slot,
                    active=active)
        return res if out is None else out.copy_(res)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and vals.is_contiguous()
            and (slot is None or slot.is_contiguous())):
        raise ValueError("compute_histogram needs contiguous tensors")
    if integer:
        return _histogram_int(binned, vals, slot, 1, num_bins, active, None,
                              "histogram_int", rows_per_block,
                              None if out is None else out[None])[0]
    n, f = binned.shape
    if out is None:
        out = torch.empty((f, num_bins, 3), dtype=torch.float32,
                          device=binned.device)
    if n == 0:
        return out.zero_()
    rows, tile_f, subranges = launch_shape(n, f, num_bins, rows_per_block)
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


def compute_histogram_members(binned: torch.Tensor,
                              vals: Sequence[torch.Tensor], *,
                              num_bins: int,
                              slots: Optional[Sequence[torch.Tensor]] = None,
                              num_slots: Optional[int] = None,
                              actives: Optional[Sequence[torch.Tensor]] = None,
                              slots_used: Optional[
                                  Sequence[torch.Tensor]] = None,
                              rows_per_block: int = 0) -> torch.Tensor:
    """``compute_histogram`` of N members over one shared dense
    ``binned`` (B1-M; B1-K-M with ``num_slots``; B1-int-M and B1-K-int-M
    on int8/int16 vals): member j's pass takes ``vals[j]``, ``slots[j]``,
    ``actives[j]`` and ``slots_used[j]`` as the solo form takes them, and
    its result is row j of the [N, F, num_bins, 3] (or [N, K, F,
    num_bins, 3]) output, bitwise the solo form's at the same
    ``rows_per_block`` (unspecified where its ``active`` is 0).  CUDA tensors launch the member form of
    ``csrc/histogram.cu`` once for all members, CPU tensors run
    ``histogram_members_plain``."""
    if isinstance(binned, SparseBinned):
        raise TypeError("the member forms take a dense binned matrix "
                        "(k-hot rows train solo)")
    m = len(vals)
    if m < 1:
        raise ValueError("compute_histogram_members needs a member")
    for name, ops in (("slots", slots), ("actives", actives),
                      ("slots_used", slots_used)):
        if ops is not None and len(ops) != m:
            raise ValueError(f"{name} must have one entry a member")
    if num_slots is not None and (slots is None or slots_used is None):
        raise TypeError("the K-slot form needs slots and slots_used")
    if any(v.dtype != vals[0].dtype for v in vals):
        raise TypeError("the members' vals must share one dtype")
    for j in range(m):
        _check(binned, vals[j], None if slots is None else slots[j],
               None if actives is None else actives[j])
        if slots_used is not None and (
                slots_used[j].shape != (1,)
                or slots_used[j].dtype != torch.int32
                or slots_used[j].device != binned.device):
            raise TypeError("slots_used must be [1] int32 tensors on the "
                            "binned matrix's device")
    n, f = binned.shape
    integer = vals[0].dtype in INT_VALS
    if rows_per_block > 0 and binned.device.type == "cpu":
        # the cap of an explicit row block, which a launch shape checks
        # on the card
        form_launch_shape(n, f, num_bins, num_slots, integer,
                          rows_per_block)
    if binned.device.type == "cpu":
        return histogram_members_plain(
            binned, vals, num_bins=num_bins, slots=slots,
            num_slots=num_slots, actives=actives)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and all(v.is_contiguous() for v in vals)
            and (slots is None or all(s.is_contiguous() for s in slots))):
        raise ValueError("compute_histogram_members needs contiguous "
                         "tensors")
    k = 1 if num_slots is None else int(num_slots)
    kdim = () if num_slots is None else (k,)
    dt = torch.int32 if integer else torch.float32
    out = torch.empty((m,) + kdim + (f, num_bins, 3), dtype=dt,
                      device=binned.device)
    if n == 0:
        return out.zero_()
    rows, shape1, shape2 = form_launch_shape(n, f, num_bins, num_slots,
                                             integer, rows_per_block)
    if integer:
        form, counter = 2, ("histogram_int_members" if num_slots is None
                            else "histogram_slots_int_members")
    elif num_slots is None:
        form, counter = 0, "histogram_members"
    else:
        form, counter = 1, "histogram_slots_members"
    shape3 = 0
    if form == 1:
        # B1-K-M: each member's workspace in place of a partial
        partial = torch.empty((m, _slot_ws_words(k, f, num_bins)),
                              dtype=torch.int64, device=binned.device)
        shape3 = _SCALE_PARTS
    else:
        partial = torch.empty((m, -(-n // rows)) + kdim + (f, num_bins, 3),
                              dtype=dt, device=binned.device)
    none = [None] * m
    table = _kernels.pointer_table((
        vals, none if slots is None else slots,
        none if actives is None else actives,
        none if slots_used is None else slots_used,
        list(partial), list(out)))
    err = _kernels.lib("histogram").lgbt_histogram_members(
        binned.data_ptr(), table, m, form,
        _bits(vals[0]) if integer else 0, n, f, num_bins, k, rows, shape1,
        shape2, shape3, _kernels.stream_ptr(binned.device))
    _kernels.launched(counter, err)
    return out


def histogram_members_plain(binned: torch.Tensor,
                            vals: Sequence[torch.Tensor], *, num_bins: int,
                            slots: Optional[Sequence[torch.Tensor]] = None,
                            num_slots: Optional[int] = None,
                            actives: Optional[Sequence[torch.Tensor]] = None
                            ) -> torch.Tensor:
    """Plain PyTorch version of the member forms: the solo plain version
    of each member's pass, stacked."""
    outs = []
    for j, v in enumerate(vals):
        slot = None if slots is None else slots[j]
        active = None if actives is None else actives[j]
        integer = v.dtype in INT_VALS
        if num_slots is not None:
            plain = histogram_slots_int_plain if integer \
                else histogram_slots_plain
            outs.append(plain(binned, v, slot, num_slots=num_slots,
                              num_bins=num_bins, active=active))
        else:
            plain = histogram_int_plain if integer else histogram_plain
            outs.append(plain(binned, v, num_bins=num_bins, slot=slot,
                              active=active))
    return torch.stack(outs)


def _bits(vals: torch.Tensor) -> int:
    return 8 if vals.dtype == torch.int8 else 16


def _histogram_int(binned, vals, slot, num_slots: int, num_bins: int,
                   active, slots_used, counter: str,
                   rows_per_block: int = 0,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1-int (``num_slots`` 1, ``slot`` None for every row) and B1-K-int
    on the card: [num_slots, F, num_bins, 3] int32 (into ``out`` when
    given)."""
    n, f = binned.shape
    if out is None:
        out = torch.empty((num_slots, f, num_bins, 3), dtype=torch.int32,
                          device=binned.device)
    if n == 0:
        return out.zero_()
    rows, tile_f, tile_k = int_launch_shape(n, f, num_bins, num_slots,
                                            rows_per_block)
    partial = torch.empty((-(-n // rows), num_slots, f, num_bins, 3),
                          dtype=torch.int32, device=binned.device)
    err = _kernels.lib("histogram").lgbt_histogram_int(
        binned.data_ptr(), vals.data_ptr(), _bits(vals),
        None if slot is None else slot.data_ptr(), n, f, num_bins,
        num_slots, rows, tile_f, tile_k,
        None if active is None else active.data_ptr(),
        None if slots_used is None else slots_used.data_ptr(),
        partial.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.launched(counter, err)
    return out


def _histogram_slots(binned, vals, slot, num_slots: int, num_bins: int,
                     active, slots_used,
                     rows_per_block: int = 0) -> torch.Tensor:
    if slot is None or num_slots < 1:
        raise ValueError("the K-slot form needs slot and num_slots >= 1")
    integer = vals.dtype in INT_VALS
    if binned.device.type == "cpu":
        plain = histogram_slots_int_plain if integer \
            else histogram_slots_plain
        return plain(binned, vals, slot, num_slots=num_slots,
                     num_bins=num_bins, active=active)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and vals.is_contiguous()
            and slot.is_contiguous()):
        raise ValueError("compute_histogram needs contiguous tensors")
    n, f = binned.shape
    if integer:
        return _histogram_int(binned, vals, slot, num_slots, num_bins,
                              active, slots_used, "histogram_slots_int",
                              rows_per_block)
    out = torch.empty((num_slots, f, num_bins, 3), dtype=torch.float32,
                      device=binned.device)
    if n == 0:
        return out.zero_()
    rows, tile_k, tile_f = slots_launch_shape(n, f, num_bins, num_slots,
                                              rows_per_block)
    ws = torch.empty(_slot_ws_words(num_slots, f, num_bins),
                     dtype=torch.int64, device=binned.device)
    err = _kernels.lib("histogram").lgbt_histogram_slots(
        binned.data_ptr(), vals.data_ptr(), slot.data_ptr(), n, f, num_bins,
        num_slots, rows, tile_k, tile_f, _SCALE_PARTS,
        None if active is None else active.data_ptr(),
        slots_used.data_ptr(), ws.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("histogram_slots", err)
    return out


def _slot_ws_words(num_slots: int, f: int, num_bins: int) -> int:
    """int64 words of one B1-K workspace: the accumulator, its f32 side
    buffer and the scale's partial maxima (``csrc/histogram.cu``
    ``slot_ws``)."""
    cells3 = num_slots * f * num_bins * 3
    return cells3 + -(-cells3 // 2) + -(-_SCALE_PARTS * 3 // 2)


def histogram_slots_plain(binned: torch.Tensor, vals: torch.Tensor,
                          slot: torch.Tensor, *, num_slots: int,
                          num_bins: int,
                          active: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of B1-K: ``_bin_sums`` over
    ``(slot * F + f) * B + bin``; an inactive step returns zeros."""
    f = binned.shape[1]
    if active is not None and not bool(active[0]):
        return torch.zeros((num_slots, f, num_bins, 3), dtype=torch.float32,
                           device=binned.device)
    keep = (slot >= 0) & (slot < num_slots)
    b = binned[keep].to(torch.int64)
    s = slot[keep].to(torch.int64)
    offs = torch.arange(f, device=binned.device, dtype=torch.int64) * num_bins
    idx = (b + offs + (s * (f * num_bins))[:, None]).reshape(-1)
    ok = (b < num_bins).reshape(-1)
    src = vals[keep].repeat_interleave(f, dim=0)
    out = _bin_sums(idx[ok], src[ok], num_slots * f * num_bins)
    return out.reshape(num_slots, f, num_bins, 3)


def histogram_slots_int_plain(binned: torch.Tensor, vals: torch.Tensor,
                              slot: torch.Tensor, *, num_slots: int,
                              num_bins: int,
                              active: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch version of B1-K-int: [K, F, num_bins, 3] int32 sums
    in int64 over ``(slot * F + f) * B + bin``; an inactive step returns
    zeros."""
    f = binned.shape[1]
    if active is not None and not bool(active[0]):
        return torch.zeros((num_slots, f, num_bins, 3), dtype=torch.int32,
                           device=binned.device)
    keep = (slot >= 0) & (slot < num_slots)
    b = binned[keep].to(torch.int64)
    s = slot[keep].to(torch.int64)
    offs = torch.arange(f, device=binned.device, dtype=torch.int64) * num_bins
    idx = b + offs + (s * (f * num_bins))[:, None]
    ok = (b < num_bins).reshape(-1)
    src = vals[keep].to(torch.int64).repeat_interleave(f, dim=0)
    out = torch.zeros((num_slots * f * num_bins, 3), dtype=torch.int64,
                      device=binned.device)
    out.index_add_(0, idx.reshape(-1)[ok], src[ok])
    return out.to(torch.int32).reshape(num_slots, f, num_bins, 3)


def histogram_int_plain(binned: torch.Tensor, vals: torch.Tensor, *,
                        num_bins: int,
                        slot: Optional[torch.Tensor] = None,
                        active: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of B1-int: B1-K-int's with one slot, over
    the rows whose ``slot`` is 0 (every row without ``slot``)."""
    if slot is None:
        slot = torch.zeros(binned.shape[0], dtype=torch.int32,
                           device=binned.device)
    return histogram_slots_int_plain(binned, vals, slot, num_slots=1,
                                     num_bins=num_bins, active=active)[0]


def histogram_plain(binned: torch.Tensor, vals: torch.Tensor, *,
                    num_bins: int,
                    slot: Optional[torch.Tensor] = None,
                    active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of B1: ``_bin_sums`` over ``f*B + bin``.
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
    return _bin_sums(idx[ok], src[ok], f * num_bins).reshape(f, num_bins, 3)


def _bin_sums(idx: torch.Tensor, src: torch.Tensor,
              size: int) -> torch.Tensor:
    """[size, 3] f32 sums of the rows of ``src`` by cell ``idx``: each
    cell's rows in row order, in f32 runs of ``PLAIN_RUN`` rows (an
    ``index_add_``, which adds each cell's rows in index order on the
    CPU), the runs summed in f64 and rounded once to f32.  A cell of at
    most ``PLAIN_RUN`` rows is the f32 sum of its rows in row order; a
    cell of nearly every row (a heavy bin) errs about as a pairwise sum
    does, where one f32 run would drift by about n * 2^-25."""
    dev = src.device
    if idx.numel() == 0:
        return torch.zeros((size, 3), dtype=torch.float32, device=dev)
    # each row's position among its cell's rows, in row order
    order = torch.sort(idx, stable=True).indices
    sidx = idx[order]
    counts = torch.bincount(sidx, minlength=size)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(idx)
    pos[order] = torch.arange(idx.numel(), device=dev) - start[sidx]
    # one accumulator a (cell, run) that has rows
    cell_run, inv = torch.unique(idx + size * (pos // PLAIN_RUN),
                                 return_inverse=True)
    runs = torch.zeros((cell_run.numel(), 3), dtype=torch.float32,
                       device=dev)
    runs.index_add_(0, inv, src)
    out = torch.zeros((size, 3), dtype=torch.float64, device=dev)
    out.index_add_(0, cell_run % size, runs.to(torch.float64))
    return out.to(torch.float32)


# B17c's row blocks (a constant, so the kernel's summation order depends
# on the shapes alone) and its channel limit (csrc/integrity.cu)
_RESIDUAL_BLOCKS = 264
_RESIDUAL_MAX_CHANNELS = 8
# vals dtypes of B17c and their codes in csrc/integrity.cu, by hist dtype
_RESIDUAL_VALS = {torch.float32: {torch.float32: 0},
                  torch.int32: {torch.int8: 1, torch.int16: 2,
                                torch.int32: 3}}


def _check_residual(hist: torch.Tensor, vals: torch.Tensor) -> None:
    if hist.dim() != 3 or vals.dim() != 2 \
            or hist.shape[2] != vals.shape[1]:
        raise TypeError("feature_totals_residual needs hist [F, B, C] and "
                        "vals [N, C]")
    ok = _RESIDUAL_VALS.get(hist.dtype, {})
    if vals.dtype not in ok:
        raise TypeError(f"feature_totals_residual takes an f32 histogram "
                        f"with f32 vals or an int32 one with int8/int16/"
                        f"int32 vals (got {hist.dtype}, {vals.dtype})")
    if not 1 <= hist.shape[2] <= _RESIDUAL_MAX_CHANNELS:
        raise ValueError(f"feature_totals_residual takes 1 to "
                         f"{_RESIDUAL_MAX_CHANNELS} channels")
    if hist.device != vals.device:
        raise ValueError("feature_totals_residual inputs must be on one "
                         "device")


def feature_totals_residual(hist: torch.Tensor,
                            vals: torch.Tensor) -> torch.Tensor:
    """Max absolute residual of the histogram's defining invariant,
    ``max_{f,c} |sum_b hist[f, b, c] - sum_n vals[n, c]|``, as a [] f64
    tensor (kernel B17c; the JAX package's ``ops/histogram.py``
    ``feature_totals_residual`` :242): every row lands in one bin of
    every feature, so a healthy f32 histogram leaves a rounding-sized
    residual and an integer one exactly 0; a flipped bit anywhere in the
    pass shows as a residual of the flipped magnitude.  Sums are f64 for
    an f32 ``hist`` (with f32 ``vals``) and exact int64 for an int32 one
    (with int8/int16/int32 ``vals``, the packed stack of quantized
    training).  The JAX package calls it from its tests only, and so does
    the port: the tests and ``chip_smoke.py``, as an oracle on B1.  CUDA
    tensors launch the kernel of ``csrc/integrity.cu``, CPU tensors run
    ``feature_totals_residual_plain``."""
    _check_residual(hist, vals)
    if hist.device.type == "cpu":
        return feature_totals_residual_plain(hist, vals)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    if not (hist.is_contiguous() and vals.is_contiguous()):
        raise ValueError("feature_totals_residual needs contiguous tensors")
    f, b, c = hist.shape
    n = vals.shape[0]
    blocks = max(1, min(_RESIDUAL_BLOCKS, n))
    rows = -(-n // blocks) if n else 0
    acc = torch.float64 if hist.dtype == torch.float32 else torch.int64
    partial = torch.empty((blocks, c), dtype=acc, device=hist.device)
    out = torch.empty((), dtype=torch.float64, device=hist.device)
    err = _kernels.lib("integrity").lgbt_totals_residual(
        hist.data_ptr(), int(hist.dtype == torch.int32), vals.data_ptr(),
        _RESIDUAL_VALS[hist.dtype][vals.dtype], f, b, c, n, blocks, rows,
        partial.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(hist.device))
    _kernels.launched("totals_residual", err)
    return out


def feature_totals_residual_plain(hist: torch.Tensor,
                                  vals: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of B17c: the bin sums and the column totals
    in f64 (f32 ``hist``) or int64 (int32 ``hist``), the residual's
    maximum as a [] f64 tensor."""
    _check_residual(hist, vals)
    acc = torch.float64 if hist.dtype == torch.float32 else torch.int64
    tot = hist.to(acc).sum(dim=1)
    col = vals.to(acc).sum(dim=0)
    return (tot - col[None, :]).abs().amax().to(torch.float64)
