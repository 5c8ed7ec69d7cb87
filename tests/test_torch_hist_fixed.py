"""The 64-bit fixed-point rule of the f32 histogram kernels B1-K and B11a
(and B8a), ``lightgbm_torch/csrc/fixed.cuh``, held on the CPU.

A CUDA kernel cannot run here, so ``fixed_hist`` below is an int64 torch
model of the kernels' arithmetic, step for step: each channel's exponent
e = 62 - x - ceil(log2 N) from the frexp exponent x of its largest finite
|value| over all N rows of vals; each finite value times 2^e rounded half
to even to an int64; the cells' integer sums (exact, so in any order);
non-finite values summed apart in f32 into a side buffer; each cell
v * 2^-e rounded once to f32, or the side value where one is set.  On
data made from a seed with numpy, the model is held to the plain
versions the CPU path runs (``histogram_slots_plain``,
``segment_histogram_plain``) within ``HIST_RTOL`` of each channel's
largest cell (``chip_smoke.py``'s tolerance, as its ``_hist_rel``
measures it) and to f64 sums within the rule's own bound: a heavy bin of
a million rows of mixed signs, values spanning 2^-30 to 1 of the
channel's largest, the exponent up to N = 2^31 (every sum under 2^63),
NaN / +Inf / -Inf rows (their cells exactly the plain versions'), and
the sums' independence of the rows' order and blocking."""

import math

import numpy as np
import pytest
import torch

from lightgbm_torch.ops import histogram as th
from lightgbm_torch.ops import segment as seg

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

HIST_RTOL = 1e-5


def log2_ceil(n: int) -> int:
    lg = 0
    while (1 << lg) < n:
        lg += 1
    return lg


def exponents(vals: torch.Tensor, n: int = None):
    """Each channel's e (fixed.cuh ``scale_exp``): 62 - x - ceil(log2 N),
    x the frexp exponent of the largest finite |value| (M < 2^x); 0 for a
    channel with no non-zero finite value."""
    n = vals.shape[0] if n is None else n
    a = vals.abs()
    a = torch.where(torch.isfinite(a), a, torch.zeros_like(a))
    out = []
    for c in range(vals.shape[1]):
        m = float(a[:, c].max()) if a.shape[0] else 0.0
        out.append(62 - math.frexp(m)[1] - log2_ceil(n) if m > 0 else 0)
    return out


def quantize(vals: torch.Tensor, e) -> torch.Tensor:
    """[N, 3] int64: v * 2^e rounded half to even, 0 where not finite."""
    scale = torch.tensor([2.0 ** x for x in e], dtype=torch.float64)
    q = torch.round(vals.to(torch.float64) * scale)
    return torch.where(torch.isfinite(vals), q, 0.0).to(torch.int64)


def fixed_hist(vals, rows, cells, size, e=None):
    """The kernels' result [size, 3] f32 for the (row, cell) pairs: int64
    sums of the quantized rows, non-finite values in an f32 side sum."""
    e = exponents(vals) if e is None else e
    q = quantize(vals, e)
    acc = torch.zeros((size, 3), dtype=torch.int64)
    acc.index_add_(0, cells, q[rows])
    v = vals[rows]
    side = torch.zeros((size, 3), dtype=torch.float32)
    side.index_add_(0, cells, torch.where(torch.isfinite(v), 0.0, v))
    inv = torch.tensor([2.0 ** -x for x in e], dtype=torch.float64)
    return torch.where(side != 0, side,
                       (acc.to(torch.float64) * inv).to(torch.float32))


def slots_pairs(binned, slot, num_slots, num_bins):
    """B1-K's (row, cell) pairs: cell (slot * F + f) * B + bin for rows
    with 0 <= slot < K and bins < B."""
    n, f = binned.shape
    rows = torch.arange(n)[:, None].expand(n, f)
    b = binned.to(torch.int64)
    cell = (slot.to(torch.int64)[:, None] * f + torch.arange(f)) \
        * num_bins + b
    ok = (slot >= 0)[:, None] & (slot < num_slots)[:, None] & (b < num_bins)
    return rows[ok], cell[ok]


def model_slots(binned, vals, slot, num_slots, num_bins):
    f = binned.shape[1]
    rows, cells = slots_pairs(binned, slot, num_slots, num_bins)
    return fixed_hist(vals, rows, cells, num_slots * f * num_bins) \
        .reshape(num_slots, f, num_bins, 3)


def model_segment(binned, vals, order, begin, count, num_bins):
    """B11a: the segment's rows, the scale from all N rows of vals."""
    f = binned.shape[1]
    seg_rows = order[begin:begin + count].to(torch.int64)
    b = binned[seg_rows].to(torch.int64)
    rows = seg_rows[:, None].expand(count, f)
    cell = torch.arange(f) * num_bins + b
    ok = b < num_bins
    return fixed_hist(vals, rows[ok], cell[ok], f * num_bins) \
        .reshape(f, num_bins, 3)


def hist_rel(a, b) -> float:
    """Largest |a - b| over b's finite cells relative to b's largest
    finite |cell|, channel by channel (``chip_smoke.py`` ``_hist_rel``)."""
    worst = 0.0
    for c in range(3):
        ac, bc = a[..., c].to(torch.float64), b[..., c].to(torch.float64)
        fin = torch.isfinite(bc)
        if not bool(fin.any()):
            continue
        scale = float(bc[fin].abs().max())
        err = float((ac[fin] - bc[fin]).abs().max())
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def same_nonfinite(a, b) -> bool:
    na, nb = ~torch.isfinite(a), ~torch.isfinite(b)
    return torch.equal(na, nb) \
        and torch.equal(torch.isnan(a), torch.isnan(b)) \
        and torch.equal(a[na & ~torch.isnan(a)], b[nb & ~torch.isnan(b)])


def f64_slots(binned, vals, slot, num_slots, num_bins):
    rows, cells = slots_pairs(binned, slot, num_slots, num_bins)
    out = torch.zeros((num_slots * binned.shape[1] * num_bins, 3),
                      dtype=torch.float64)
    out.index_add_(0, cells, vals[rows].to(torch.float64))
    return out.reshape(num_slots, binned.shape[1], num_bins, 3)


def heavy_problem(seed: int, n: int, f: int, bins: int):
    """About 99% of every feature's rows in bin 0; g ~ N(0, 1) (mixed
    signs), h = |g| / 4 + 0.01, w = 1."""
    rs = np.random.RandomState(seed)
    binned = np.where(rs.rand(n, f) < 0.99, 0,
                      rs.randint(1, bins, size=(n, f))).astype(np.uint8)
    g = rs.randn(n).astype(np.float32)
    vals = np.stack([g, np.abs(g) / 4 + 0.01, np.ones(n, np.float32)], 1)
    return torch.as_tensor(binned), torch.as_tensor(vals)


@pytest.mark.parametrize("num_slots", [1, 4])
def test_heavy_bin_of_a_million_rows(num_slots):
    n, f, bins = 1_000_000, 2, 8
    binned, vals = heavy_problem(num_slots, n, f, bins)
    slot = torch.as_tensor(np.random.RandomState(7).randint(
        -1, num_slots, n).astype(np.int32))
    got = model_slots(binned, vals, slot, num_slots, bins)
    ref = f64_slots(binned, vals, slot, num_slots, bins)
    # the rule's bound: a value errs by at most 2^-(e+1), then one f32
    # rounding of the cell
    e = exponents(vals)
    rows_in = (slot >= 0).sum().item()
    for c in range(3):
        bound = rows_in * 2.0 ** -(e[c] + 1) \
            + 2.0 ** -24 * ref[..., c].abs()
        assert bool(((got[..., c].double() - ref[..., c]).abs()
                     <= bound).all())
    # the heavy bin holds nearly every row of its slot
    assert float(ref[..., 0, 2].max()) > 0.98 * rows_in / num_slots
    plain = th.histogram_slots_plain(binned, vals, slot,
                                     num_slots=num_slots, num_bins=bins)
    assert hist_rel(got, plain) <= HIST_RTOL
    # the count channel is exact
    assert torch.equal(got[..., 2], ref[..., 2].to(torch.float32))


def test_heavy_segment_of_a_million_rows():
    n, f, bins = 1_000_000, 3, 16
    binned, vals = heavy_problem(11, n, f, bins)
    order = torch.as_tensor(np.random.RandomState(12).permutation(n)
                            .astype(np.int32))
    for begin, count in ((0, n), (250_000, 600_000)):
        got = model_segment(binned, vals, order, begin, count, bins)
        plain = seg.segment_histogram_plain(binned, vals, order, begin,
                                            count, num_bins=bins)
        assert hist_rel(got, plain) <= HIST_RTOL
        assert torch.equal(got[..., 2], plain[..., 2])


@pytest.mark.parametrize("seed", [0, 1])
def test_magnitudes_spanning_2_pow_30(seed):
    rs = np.random.RandomState(seed)
    n, f, bins, k = 200_000, 4, 31, 8
    binned = torch.as_tensor(rs.randint(0, bins, (n, f)).astype(np.uint8))
    # |v| = 2^(-30 u) of the channel's largest, u uniform, random signs
    mag = np.exp2(-30.0 * rs.rand(n, 3))
    sign = np.where(rs.rand(n, 3) < 0.5, -1.0, 1.0)
    sign[:, 2] = 1.0
    vals = torch.as_tensor((mag * sign).astype(np.float32))
    slot = torch.as_tensor(rs.randint(-1, k, n).astype(np.int32))
    got = model_slots(binned, vals, slot, k, bins)
    plain = th.histogram_slots_plain(binned, vals, slot, num_slots=k,
                                     num_bins=bins)
    assert hist_rel(got, plain) <= HIST_RTOL
    ref = f64_slots(binned, vals, slot, k, bins)
    e = exponents(vals)
    for c in range(3):
        assert float((got[..., c].double() - ref[..., c]).abs().max()) <= \
            n * 2.0 ** -(e[c] + 1) + 2.0 ** -24 * float(ref[..., c]
                                                          .abs().max())


@pytest.mark.parametrize("n", [1, 2, 3, 1000, 1 << 20, 2_270_296,
                               (1 << 31) - 1, 1 << 31])
@pytest.mark.parametrize("m", [1.0, 0.75, 3.0e38, 1.0e-30, 1.4e-45,
                               float(2 ** -126)])
def test_exponent_keeps_every_sum_under_2_pow_63(n, m):
    vals = torch.tensor([[m, -m, m], [0.5 * m, 0.0, -0.25 * m]],
                        dtype=torch.float32)
    e = exponents(vals, n)
    q = quantize(vals, e)
    big = int(q.abs().max())
    # N values of the largest magnitude sum under 2^62 (so under 2^63
    # with room for the sign), and the largest keeps 61 - ceil(log2 N)
    # bits or more
    assert n * big < 1 << 62
    if float(vals.abs().max()) > 0:
        assert big >= 1 << (61 - log2_ceil(n))
    # the kernels' pow2 takes e and -e as a double's exponent
    assert all(-1022 <= x <= 1023 for x in e)


NONFINITE = {"nan": float("nan"), "inf": float("inf"),
             "-inf": float("-inf")}


def poisoned(vals, rows_by_kind):
    v = vals.clone()
    for kind, rows in rows_by_kind.items():
        for r, c in rows:
            v[r, c] = NONFINITE[kind]
    return v


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nonfinite_rows_slots(seed):
    rs = np.random.RandomState(seed)
    n, f, bins, k = 20_000, 5, 15, 4
    binned = torch.as_tensor(rs.randint(0, bins, (n, f)).astype(np.uint8))
    g = rs.randn(n).astype(np.float32)
    vals = torch.as_tensor(np.stack([g, np.abs(g) + 0.1,
                                     np.ones(n, np.float32)], 1))
    slot = torch.as_tensor(rs.randint(-1, k, n).astype(np.int32))
    kept = np.nonzero(slot.numpy() >= 0)[0]
    # row pairs that share a cell: +Inf and -Inf in one channel give NaN
    same = torch.nonzero((binned[kept[0]] == binned[kept[1:]]).any(1)
                         & (slot[kept[1:]] == slot[kept[0]])).flatten()
    partner = int(kept[1 + int(same[0])])
    pv = poisoned(vals, {"nan": [(int(kept[2]), 0)],
                         "inf": [(int(kept[3]), 1), (int(kept[0]), 0)],
                         "-inf": [(int(kept[4]), 2), (partner, 0)]})
    got = model_slots(binned, pv, slot, k, bins)
    plain = th.histogram_slots_plain(binned, pv, slot, num_slots=k,
                                     num_bins=bins)
    assert int((~torch.isfinite(plain)).sum()) > 0
    assert bool(torch.isnan(plain).any())
    assert same_nonfinite(got, plain)
    assert hist_rel(got, plain) <= HIST_RTOL
    # the other cells are those of the unpoisoned model
    clean = model_slots(binned, vals, slot, k, bins)
    fin = torch.isfinite(plain)
    assert hist_rel(got[fin], clean[fin]) <= HIST_RTOL


@pytest.mark.parametrize("count", [1, 33, 7_500])
def test_nonfinite_rows_segment(count):
    rs = np.random.RandomState(count)
    n, f, bins = 30_000, 6, 31
    binned = torch.as_tensor(rs.randint(0, bins, (n, f)).astype(np.uint8))
    g = rs.randn(n).astype(np.float32)
    vals = torch.as_tensor(np.stack([g, np.abs(g) + 0.1,
                                     np.ones(n, np.float32)], 1))
    order = torch.as_tensor(rs.permutation(n).astype(np.int32))
    begin = 1_000
    rows = order[begin:begin + count].tolist()
    pv = poisoned(vals, {"nan": [(rows[0], 2)],
                         "inf": [(rows[min(1, count - 1)], 0)],
                         "-inf": [(rows[-1], 1)]})
    got = model_segment(binned, pv, order, begin, count, bins)
    plain = seg.segment_histogram_plain(binned, pv, order, begin, count,
                                        num_bins=bins)
    assert int((~torch.isfinite(plain)).sum()) > 0
    assert same_nonfinite(got, plain)
    assert hist_rel(got, plain) <= HIST_RTOL
    # a non-finite value outside the segment sets no scale and no cell
    outside = order[:begin].tolist()
    pv2 = poisoned(vals, {"nan": [(outside[0], 0)],
                          "inf": [(outside[1], 1)]})
    got2 = model_segment(binned, pv2, order, begin, count, bins)
    assert torch.equal(got2, model_segment(binned, vals, order, begin,
                                           count, bins))


@pytest.mark.parametrize("blocks", [1, 7, 132])
def test_sums_free_of_order_and_blocking(blocks):
    rs = np.random.RandomState(3)
    n, f, bins, k = 50_000, 4, 15, 8
    binned = torch.as_tensor(rs.randint(0, bins, (n, f)).astype(np.uint8))
    vals = torch.as_tensor(rs.randn(n, 3).astype(np.float32))
    slot = torch.as_tensor(rs.randint(-1, k, n).astype(np.int32))
    want = model_slots(binned, vals, slot, k, bins)
    # the rows dealt to `blocks` blocks in a shuffled order, each block's
    # integer tile flushed into one accumulator: the same bits
    e = exponents(vals)
    rows, cells = slots_pairs(binned, slot, k, bins)
    perm = torch.as_tensor(rs.permutation(rows.numel()))
    q = quantize(vals, e)
    acc = torch.zeros((k * f * bins, 3), dtype=torch.int64)
    for part in torch.chunk(perm, blocks):
        tile = torch.zeros_like(acc)
        tile.index_add_(0, cells[part], q[rows[part]])
        acc += tile
    inv = torch.tensor([2.0 ** -x for x in e], dtype=torch.float64)
    got = (acc.to(torch.float64) * inv).to(torch.float32) \
        .reshape(k, f, bins, 3)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
