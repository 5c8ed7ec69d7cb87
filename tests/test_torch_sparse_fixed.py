"""The 64-bit fixed-point rule of B8a, the k-hot histogram
(``lightgbm_torch/csrc/sparse.cu``), held on the CPU.

A CUDA kernel cannot run here, so ``khot_fixed`` below is an int64 torch
model of the kernel's arithmetic, step for step: each channel's exponent
from its largest finite |value| over all N rows of vals and ceil(log2 N)
(``test_torch_hist_fixed.exponents``); each finite value of a row in the
pass rounded to an int64 at that scale; the integer sums of the stored
entries by (slot, feature, bin) and the slots' integer totals; each
feature's default bin filled with the total minus the feature's stored
mass (an exact integer subtraction); each cell rounded once to f32;
non-finite values summed apart in f32 (cells and totals), a cell whose
side value is set taking it.  The model can split its work the way the
kernel's launch plan does, into row ranges and feature tiles
(``sparse_data.root_plan``), with the tile-0 parts summing the totals.

On an Allstate-like k-hot set made from a seed with numpy (2,000 rows,
300 columns, 3 bins, up to 12 entries a row, padding, mixed default
bins), the model is held to ``sparse_data.histogram_plain`` (the CPU path
and the kernel's oracle on the card) and to the JAX package's
``sparse_data.histogram`` within ``HIST_RTOL`` in the three forms (every
row, the strict grower's slot, K slots, also with ``slots_used`` below
K), with NaN / +-Inf rows (their cells exactly the plain version's); it
gives the same bytes whatever the order of a row's entries and however
the rows and features are split, which is what the kernel's bitwise
claim (reruns, launch plans, its parent's design) rests on.  The host's
launch plan and workspace layout (``root_plan``, ``ws_layout``) are
pinned: every feature in exactly one tile, each tile within the shared
memory a block has, and a workspace of the size the kernel indexes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch import _kernels, convert
from lightgbm_torch import sparse_data as tspd
from lightgbm_tpu import sparse_data as jspd

from test_torch_hist_fixed import (HIST_RTOL, exponents, hist_rel,
                                   quantize, same_nonfinite)
from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

N, F, STRIDE, NNZ = 2_000, 300, 3, 12


def allstate_like(seed: int, n: int = N, f: int = F, nnz: int = NNZ):
    """k-hot rows of both packages: each row stores up to ``nnz`` distinct
    features (a tenth of the rows fewer, so rows carry padding), at a bin
    other than the feature's default bin (0 for most features, 1 or 2 for
    a fifth of them)."""
    rs = np.random.RandomState(seed)
    db = np.where(rs.rand(f) < 0.8, 0, rs.randint(1, STRIDE, f)) \
        .astype(np.int32)
    counts = np.where(rs.rand(n) < 0.1, rs.randint(0, nnz, n), nnz)
    rows = np.repeat(np.arange(n), counts)
    feats = np.concatenate([rs.choice(f, c, replace=False) for c in counts])
    bins = (db[feats] + rs.randint(1, STRIDE, feats.size)) % STRIDE
    flat = (feats * STRIDE + bins).astype(np.int32)
    host = jspd.build_khot(rows.astype(np.int64), flat, db, n, STRIDE, f)
    tsp = convert.sparse_from_numpy(host.flat, host.default_bin,
                                    host.stride, host.num_features)
    return host, tsp


def grad_vals(seed: int, n: int = N) -> torch.Tensor:
    rs = np.random.RandomState(seed)
    g = rs.randn(n).astype(np.float32)
    return torch.as_tensor(np.stack([g, np.abs(g) / 4 + 0.01,
                                     np.ones(n, np.float32)], 1))


def pass_slots(n, slot, num_slots, slots_used) -> torch.Tensor:
    """Each row's slot in the pass, -1 outside: every row (no slot
    vector); slot >= 0 as slot 0 (the strict form); slot in [0,
    slots_used) (the K form)."""
    if slot is None:
        return torch.zeros(n, dtype=torch.int64)
    s = slot.to(torch.int64)
    if num_slots is None:
        return torch.where(s >= 0, 0, -1)
    used = num_slots if slots_used is None else int(slots_used[0])
    return torch.where((s >= 0) & (s < used), s, -1)


def khot_fixed(sp, vals, *, num_bins, slot=None, num_slots=None,
               slots_used=None, active=None, ranges=1, tile_f=None):
    """The kernel's result [F, num_bins, 3] (or [K, F, num_bins, 3]) on
    a live pass (``active`` is taken and not read): the work split into
    ``ranges`` row ranges x feature tiles of ``tile_f`` (every feature
    when None), each part's int64 sums added into one accumulator; the
    tile-0 parts sum the totals."""
    n, k = sp.flat.shape
    f, st = sp.num_features, sp.stride
    s_count = 1 if num_slots is None else int(num_slots)
    cells = f * st
    e = exponents(vals)
    q = quantize(vals, e)
    fin = torch.isfinite(vals)
    side_v = torch.where(fin, 0.0, vals)
    sl = pass_slots(n, slot, num_slots, slots_used)
    acc = torch.zeros((s_count * cells, 3), dtype=torch.int64)
    tot = torch.zeros((s_count, 3), dtype=torch.int64)
    side = torch.zeros((s_count * cells, 3), dtype=torch.float32)
    side_tot = torch.zeros((s_count, 3), dtype=torch.float32)
    tile_f = f if tile_f is None else tile_f
    rows_per = -(-n // ranges)
    fl = sp.flat.to(torch.int64)
    for r0 in range(0, n, rows_per):
        rr = torch.arange(r0, min(r0 + rows_per, n))
        rr = rr[sl[rr] >= 0]
        for f0 in range(0, f, tile_f):
            e0, e1 = f0 * st, min(f0 + tile_f, f) * st
            ent = fl[rr]
            ok = (ent >= e0) & (ent < e1)
            ri, ki = torch.nonzero(ok, as_tuple=True)
            rows = rr[ri]
            cell = sl[rows] * cells + ent[ri, ki]
            part = torch.zeros_like(acc)
            part.index_add_(0, cell, q[rows])
            acc += part
            side.index_add_(0, cell, side_v[rows])
            if f0 == 0:
                tot.index_add_(0, sl[rr], q[rr])
                side_tot.index_add_(0, sl[rr], side_v[rr])
    acc = acc.view(s_count, f, st, 3)
    side = side.view(s_count, f, st, 3)
    feats = torch.arange(f)
    db = sp.default_bin.to(torch.int64)
    acc[:, feats, db] += tot[:, None, :] - acc.sum(dim=2)
    side[:, feats, db] += side_tot[:, None, :] - side.sum(dim=2)
    inv = torch.tensor([2.0 ** -x for x in e], dtype=torch.float64)
    val = torch.where(side != 0, side,
                      (acc.to(torch.float64) * inv).to(torch.float32))
    out = torch.zeros((s_count, f, num_bins, 3), dtype=torch.float32)
    b = min(num_bins, st)
    out[:, :, :b] = val[:, :, :b]
    return out[0] if num_slots is None else out


def form_args(form: str, n: int, seed: int) -> dict:
    """The histogram arguments of a form: ``root`` (every row),
    ``strict`` (about 40% of the rows in slot 0, the others -1), ``k8``
    (rows in 8 slots and -1), ``k8_used3`` (8 slots, 3 in use: no row's
    slot at or past 3)."""
    rs = np.random.RandomState(seed)
    if form == "root":
        return {}
    if form == "strict":
        slot = np.where(rs.rand(n) < 0.4, 0, -1)
        return {"slot": torch.as_tensor(slot.astype(np.int32)),
                "active": torch.ones(1, dtype=torch.int32)}
    hi = 8 if form == "k8" else 3
    slot = rs.randint(-1, hi, n).astype(np.int32)
    return {"slot": torch.as_tensor(slot), "num_slots": 8,
            "slots_used": torch.tensor([hi], dtype=torch.int32)}


def jax_hist(host, vals, num_bins, kw):
    jsp = host.to_device()
    v = jnp.asarray(vals.numpy())
    if "slot" not in kw:
        return np.asarray(jspd.histogram(jsp, v, num_bins=num_bins))
    slot = jnp.asarray(kw["slot"].numpy())
    if "num_slots" not in kw:
        return np.asarray(jspd.histogram(jsp, v, num_bins=num_bins,
                                         slot=slot, num_slots=1))
    k = kw["num_slots"]
    h = np.asarray(jspd.histogram(jsp, v, num_bins=num_bins, slot=slot,
                                  num_slots=k))
    return h.reshape(host.num_features, num_bins, 3, k) \
        .transpose(3, 0, 1, 2)


def plain_args(kw: dict) -> dict:
    return {k: v for k, v in kw.items() if k != "slots_used"}


@pytest.mark.parametrize("form", ["root", "strict", "k8", "k8_used3"])
def test_khot_model_equals_plain_and_jax(form):
    host, sp = allstate_like(1)
    vals = grad_vals(2)
    kw = form_args(form, N, 3)
    got = khot_fixed(sp, vals, num_bins=STRIDE, **kw)
    plain = tspd.histogram_plain(sp, vals, num_bins=STRIDE,
                                 **plain_args(kw))
    assert got.shape == plain.shape and got.dtype == torch.float32
    assert hist_rel(got, plain) <= HIST_RTOL
    # the count channel is exact in both
    assert torch.equal(got[..., 2], plain[..., 2])
    want = torch.as_tensor(jax_hist(host, vals, STRIDE, kw).copy())
    assert hist_rel(got, want) <= HIST_RTOL
    # the CPU path of the wrapper is the plain version
    assert torch.equal(tspd.histogram(sp, vals, num_bins=STRIDE, **kw),
                       plain)
    if form == "k8_used3":
        assert float(got[3:].abs().max()) == 0.0
        assert float(plain[3:].abs().max()) == 0.0
        assert float(got[:3].abs().max()) > 0.0


def test_khot_model_zero_past_slots_used_whatever_the_rows():
    # rows left in slots at or past slots_used (a broken promise) add
    # nothing: the kernel writes zeros there and keeps the slots below
    _, sp = allstate_like(4)
    vals = grad_vals(5)
    slot = torch.as_tensor(np.random.RandomState(6).randint(-1, 8, N)
                           .astype(np.int32))
    got = khot_fixed(sp, vals, num_bins=STRIDE, slot=slot, num_slots=8,
                     slots_used=torch.tensor([5], dtype=torch.int32))
    assert float(got[5:].abs().max()) == 0.0
    clipped = torch.where(slot >= 5, -1, slot)
    plain = tspd.histogram_plain(sp, vals, num_bins=STRIDE, slot=clipped,
                                 num_slots=8)
    assert hist_rel(got, plain) <= HIST_RTOL


@pytest.mark.parametrize("num_bins", [2, 3, 5])
def test_khot_model_num_bins_around_the_stride(num_bins):
    _, sp = allstate_like(7)
    vals = grad_vals(8)
    kw = form_args("k8", N, 9)
    got = khot_fixed(sp, vals, num_bins=num_bins, **kw)
    plain = tspd.histogram_plain(sp, vals, num_bins=num_bins,
                                 **plain_args(kw))
    assert got.shape == plain.shape
    assert hist_rel(got, plain) <= HIST_RTOL
    if num_bins > STRIDE:
        assert float(got[..., STRIDE:, :].abs().max()) == 0.0


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def permuted_entries(sp, seed: int):
    """The same rows with each row's entries (padding included) in a
    random order."""
    rs = np.random.RandomState(seed)
    flat = sp.flat.numpy()
    order = np.argsort(rs.rand(*flat.shape), axis=1)
    return tspd.SparseBinned(
        torch.as_tensor(np.take_along_axis(flat, order, 1).copy()),
        sp.default_bin, sp.stride, sp.num_features)


@pytest.mark.parametrize("form", ["root", "strict", "k8_used3"])
@pytest.mark.parametrize("ranges,tile_f", [(7, None), (1, 41), (5, 100),
                                           (64, 7), (2_000, 300)])
def test_khot_bytes_free_of_entry_order_ranges_and_tiles(form, ranges,
                                                         tile_f):
    _, sp = allstate_like(10)
    vals = grad_vals(11)
    kw = form_args(form, N, 12)
    want = khot_fixed(sp, vals, num_bins=STRIDE, **kw)
    got = khot_fixed(permuted_entries(sp, ranges), vals, num_bins=STRIDE,
                     ranges=ranges, tile_f=tile_f, **kw)
    assert torch.equal(bits(got), bits(want))


def test_khot_bytes_at_the_root_plan():
    # the plan the card would take for this shape, with the shared memory
    # cut so that the 300 features take several tiles
    _, sp = allstate_like(13)
    vals = grad_vals(14)
    cap = tspd.ROOT_TILE_HEAD + 64 * STRIDE * tspd.ROOT_CELL_BYTES
    tile_f, ranges = tspd.root_plan(N, F, STRIDE, smem_bytes=cap)
    assert tile_f == 60 and ranges == 27
    want = khot_fixed(sp, vals, num_bins=STRIDE)
    got = khot_fixed(sp, vals, num_bins=STRIDE, ranges=ranges,
                     tile_f=tile_f)
    assert torch.equal(bits(got), bits(want))


NONFINITE = ((0, float("nan")), (1, float("inf")), (2, float("-inf")),
             (0, float("inf")), (0, float("-inf")))


@pytest.mark.parametrize("form", ["root", "strict", "k8"])
def test_khot_nonfinite_rows(form):
    _, sp = allstate_like(15)
    vals = grad_vals(16)
    kw = form_args(form, N, 17)
    rows = torch.nonzero(pass_slots(N, kw.get("slot"), kw.get("num_slots"),
                                    kw.get("slots_used")) >= 0).flatten()
    pv = vals.clone()
    for (c, x), r in zip(NONFINITE, rows[:5].tolist()):
        pv[r, c] = x
    got = khot_fixed(sp, pv, num_bins=STRIDE, **kw)
    plain = tspd.histogram_plain(sp, pv, num_bins=STRIDE, **plain_args(kw))
    assert int((~torch.isfinite(plain)).sum()) > 0
    assert same_nonfinite(got, plain)
    assert hist_rel(got, plain) <= HIST_RTOL
    # the finite cells are those of the unpoisoned model: a non-finite
    # value sets no scale
    clean = khot_fixed(sp, vals, num_bins=STRIDE, **kw)
    fin = torch.isfinite(plain)
    assert hist_rel(got[fin], clean[fin]) <= HIST_RTOL
    # and the split work gives the same bytes, NaN cells included
    split = khot_fixed(permuted_entries(sp, 3), pv, num_bins=STRIDE,
                       ranges=9, tile_f=37, **kw)
    assert torch.equal(bits(split), bits(got))


@pytest.mark.parametrize("stride", [3, 4, 16, 63, 64, 255, 256])
@pytest.mark.parametrize("num_features", [1, 300, 1_410, 4_228])
def test_root_plan_tiles_cover_every_feature_once(stride, num_features):
    n = 1_000_000
    tile_f, ranges = tspd.root_plan(n, num_features, stride)
    cap = _kernels.SMEM_BYTES
    per = stride * tspd.ROOT_CELL_BYTES
    need = -(-num_features // ((cap - tspd.ROOT_TILE_HEAD) // per))
    if tile_f == 0:
        # more tiles than MAX_ROOT_TILES: the row pass takes the root
        assert ranges == 0 and need > tspd.MAX_ROOT_TILES
        return
    tiles = -(-num_features // tile_f)
    assert tiles <= tspd.MAX_ROOT_TILES
    # every feature in exactly one tile [t * tile_f, min((t+1) * tile_f, F))
    owner = np.zeros(num_features, np.int64)
    for t in range(tiles):
        owner[t * tile_f:min((t + 1) * tile_f, num_features)] += 1
    assert (owner == 1).all()
    assert (tiles - 1) * tile_f < num_features
    # each tile within the shared memory a block has (csrc/sparse.cu
    # launches ROOT_TILE_HEAD + tile_f * stride * 24 bytes)
    assert tspd.ROOT_TILE_HEAD + tile_f * per <= cap
    # the fewest tiles, and the blocks fill the card
    assert tiles == need
    assert ranges * tiles >= 132 * tspd.ROOT_BLOCKS_PER_SM
    assert ranges * tiles < 132 * tspd.ROOT_BLOCKS_PER_SM + tiles
    if (num_features, stride) == (4_228, 3):
        assert (tile_f, tiles, ranges) == (2_114, 2, 66)


def test_root_plan_few_rows():
    # no more ranges than 32-row groups
    assert tspd.root_plan(100, 300, 3) == (300, 4)
    assert tspd.root_plan(1, 300, 3) == (300, 1)


@pytest.mark.parametrize("slots,num_features,stride",
                         [(1, 4_228, 3), (16, 4_228, 3), (64, 4_228, 3),
                          (1, 1, 1), (3, 7, 5), (8, 300, 256)])
def test_ws_layout_is_what_the_kernel_indexes(slots, num_features, stride):
    lay = tspd.ws_layout(slots, num_features, stride)
    cells3 = slots * num_features * stride * 3
    # csrc/sparse.cu `sparse_ws`: acc and tot int64, their side sums f32,
    # the partial maxima uint32
    sizes = {"acc": 8 * cells3, "tot": 8 * slots * 3,
             "side_acc": 4 * cells3, "side_tot": 4 * slots * 3,
             "mxp": 4 * 3 * tspd.SCALE_PARTS}
    order = ["acc", "tot", "side_acc", "side_tot", "mxp"]
    end = 0
    for name in order:
        lo, hi = lay[name]
        assert hi - lo == sizes[name]
        assert lo >= end
        assert lo % (8 if name in ("acc", "tot") else 4) == 0
        end = hi
    assert lay["acc"][0] == 0 and lay["tot"][0] == lay["acc"][1]
    assert lay["side_tot"][0] == lay["side_acc"][1]
    # the kernel places the side sums and mxp at whole int64 words
    for name in ("side_acc", "mxp"):
        assert lay[name][0] % 8 == 0
    assert end <= 8 * lay["words"] < end + 8
    assert tspd.ws_words(slots, num_features, stride) == lay["words"]
