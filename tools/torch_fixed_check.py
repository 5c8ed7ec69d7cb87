#!/usr/bin/env python3
"""Check lightgbm_torch's fixed-point histogram kernels on one CUDA card:
B1-K (``compute_histogram`` with ``num_slots``), B1-K-M (the member form),
B11a (``segment_histogram``, f32) and B8a (``sparse_data.histogram``).

    python3 tools/torch_fixed_check.py [--sass]

Inputs are made from a seed.  Each check prints one JSON line and the
script exits 1 at the first failure:

- B1-K at K = 8, 16, 32 and 64 on 1,000,000 x 28 rows at 63 bins (slots
  uniform over [-1, K)), at 2,270,296 x 136 at 255 bins and K = 16, and on
  a binned matrix 3 bytes into its allocation (each block stages its own
  rows): within ``HIST_RTOL`` of the largest cell of the plain version,
  bitwise on a rerun and at three ``rows_per_block`` values, zero past
  ``slots_used``, nothing written on a dead step (the C entry point into
  sentinel-filled buffers), and NaN / +Inf / -Inf rows giving exactly the
  plain version's non-finite cells with every other cell within the
  tolerance;
- B1-K-M: four members bit for bit equal to four solo calls;
- B11a on the root segment, a 7,500-row segment and segments of 1 and 33
  rows of a permuted order, with its scale computed by the root pass and
  reused: within ``HIST_RTOL``, bitwise on a rerun and at three
  ``rows_per_block`` values, and the same non-finite check;
- B8a (one slot and K = 4) on k-hot rows with NaN / +Inf / -Inf rows.

Each B1-K and B11a check also gives the median ms of a call and the
device microseconds by kernel (``torch.profiler``).  ``--sass`` also
prints the shared-memory atomic instructions that
``cuobjdump -sass`` finds in ``hist_slots_tile`` and ``seg_hist_tile``
(32-bit ``ATOMS.ADD``; a 64-bit shared add would be a compare-and-swap
loop, ``ATOMS.CAST.SPIN.64``).  The card's name and
power limit come first; without a CUDA card it exits with 2.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

HIST_RTOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(torch, a, b) -> float:
    """Largest |a - b| over the finite cells of b, relative to the
    largest finite |b| (the chip smoke's ``_hist_rel``)."""
    fin = torch.isfinite(b)
    scale = float(b[fin].abs().max()) if bool(fin.any()) else 0.0
    err = float((a[fin].double() - b[fin].double()).abs().max()) \
        if bool(fin.any()) else 0.0
    return err / max(scale, 1e-30)


def same_nonfinite(torch, a, b) -> bool:
    """The non-finite cells of a and b are the same cells, NaN where NaN
    and the same infinity elsewhere."""
    na, nb = ~torch.isfinite(a), ~torch.isfinite(b)
    if not torch.equal(na, nb):
        return False
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        a[na & ~torch.isnan(a)], b[nb & ~torch.isnan(b)])


def bits_equal(torch, a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def poison(torch, vals, rows):
    """vals with NaN, +Inf and -Inf in the given rows' channels (two
    rows share +Inf and -Inf in one channel, so some cells get NaN from
    +Inf + -Inf)."""
    v = vals.clone()
    r = rows
    v[r[0], 0] = float("nan")
    v[r[1], 1] = float("inf")
    v[r[2], 2] = float("-inf")
    v[r[3], 0] = float("inf")
    v[r[4], 0] = float("-inf")
    return v


def median_ms(torch, fn, reps: int = 20) -> float:
    """Median ms of a call over ``reps`` calls after 3 warm-up calls
    (CUDA events around each)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_us(torch, fn, reps: int = 5) -> dict:
    """Device microseconds a call by kernel name (torch.profiler over
    ``reps`` calls)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t:
            out[ev.key[:60]] = round(t / reps, 2)
    return out


def fail(what: str, **info) -> None:
    emit({"check": what, "ok": False, **info})
    sys.exit(1)


def check_slots(torch, th, kernels, binned, vals, slot, K, B, name):
    n, f = binned.shape
    used = torch.tensor([K], dtype=torch.int32, device=binned.device)

    def run(v=vals, rpb=0, u=used):
        return th.compute_histogram(binned, v, num_bins=B, slot=slot,
                                    num_slots=K, slots_used=u,
                                    rows_per_block=rpb)
    a = run()
    b = th.histogram_slots_plain(binned, vals, slot, num_slots=K,
                                 num_bins=B)
    err = rel_err(torch, a, b)
    rerun = bits_equal(torch, a, run())
    auto = th.slots_launch_shape(n, f, B, K)[0]
    rpb_equal = all(bits_equal(torch, a, run(rpb=r))
                    for r in (auto // 2, 2 * auto, 4096))
    # slots past slots_used: the rows of slots >= K // 2 moved to -1
    half = torch.tensor([K // 2], dtype=torch.int32, device=binned.device)
    s2 = torch.where(slot >= K // 2, -1, slot)
    h2 = th.compute_histogram(binned, vals, num_bins=B, slot=s2,
                              num_slots=K, slots_used=half)
    zero_past = bool((h2[K // 2:] == 0).all())
    p2 = th.histogram_slots_plain(binned, vals, s2, num_slots=K, num_bins=B)
    err_half = rel_err(torch, h2, p2)
    # dead step: sentinel-filled out and workspace stay as they were
    out = torch.full((K, f, B, 3), -7.0, device=binned.device)
    ws = torch.full((th._slot_ws_words(K, f, B),), -7, dtype=torch.int64,
                    device=binned.device)
    off = torch.zeros(1, dtype=torch.int32, device=binned.device)
    err_c = kernels.lib("histogram").lgbt_histogram_slots(
        binned.data_ptr(), vals.data_ptr(), slot.data_ptr(), n, f, B, K,
        *th.slots_launch_shape(n, f, B, K), th._SCALE_PARTS, off.data_ptr(),
        used.data_ptr(), ws.data_ptr(), out.data_ptr(),
        kernels.stream_ptr(binned.device))
    kernels.check(err_c, "B1-K on a dead step")
    torch.cuda.synchronize()
    dead_clean = bool((out == -7.0).all()) and bool((ws == -7).all())
    # non-finite rows
    kept = torch.nonzero(slot >= 0).flatten()[:5].tolist()
    pv = poison(torch, vals, kept)
    an = run(v=pv)
    bn = th.histogram_slots_plain(binned, pv, slot, num_slots=K,
                                  num_bins=B)
    nonfin_ok = same_nonfinite(torch, an, bn)
    err_nonfin = rel_err(torch, an, bn)
    rec = {"check": name, "K": K, "rows": n, "features": f, "bins": B,
           "shape": list(th.slots_launch_shape(n, f, B, K)),
           "ms": median_ms(torch, run), "device_us": device_us(torch, run),
           "max_rel_err": err, "rerun_bitwise": rerun,
           "rows_per_block_bitwise": rpb_equal, "zero_past_used": zero_past,
           "max_rel_err_half_used": err_half, "dead_step_clean": dead_clean,
           "nonfinite_cells_equal": nonfin_ok,
           "nonfinite_cells": int((~torch.isfinite(bn)).sum()),
           "max_rel_err_nonfinite": err_nonfin}
    ok = (err <= HIST_RTOL and rerun and rpb_equal and zero_past
          and err_half <= HIST_RTOL and dead_clean and nonfin_ok
          and err_nonfin <= HIST_RTOL and torch.equal(a[..., 2], b[..., 2]))
    if not ok:
        fail(name, **rec)
    emit({**rec, "ok": True})


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_fixed_check: no CUDA card", file=sys.stderr)
        return 2
    from lightgbm_torch import _kernels as kernels
    from lightgbm_torch import sparse_data
    from lightgbm_torch.ops import histogram as th
    from lightgbm_torch.ops import segment as seg

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    emit({"card": smi.strip(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    kernels.lib("histogram")
    kernels.lib("segment")
    kernels.lib("sparse")
    emit({"build_s": time.perf_counter() - t0})
    if "--sass" in sys.argv:
        path = kernels._lib_path("histogram")
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass",
                               str(path)], capture_output=True,
                              text=True).stdout
        body, cur = {}, None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
            elif cur is not None:
                body.setdefault(cur, []).append(line)
        seg_sass = subprocess.run(
            ["/usr/local/cuda/bin/cuobjdump", "-sass",
             str(kernels._lib_path("segment"))], capture_output=True,
            text=True).stdout
        for line in seg_sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
            elif cur is not None:
                body.setdefault(cur, []).append(line)
        tile = [k for k in body
                if "hist_slots_tile" in k or "seg_hist_tile" in k]
        ops = {}
        for k in tile:
            for line in body[k]:
                m = re.search(r"\b(ATOMS\.[A-Z0-9.]+|ATOMS)\b", line)
                if m:
                    ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        emit({"sass_kernel": tile, "shared_atomics": ops})

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    n, f, B = 1_000_000, 28, 63
    binned = torch.as_tensor(rs.randint(0, B, (n, f)).astype(np.uint8)) \
        .to(dev)
    g = torch.as_tensor(rs.randn(n).astype(np.float32)).to(dev)
    vals = torch.stack([g, g.abs() * 0.25 + 0.01, torch.ones_like(g)],
                       dim=1).contiguous()
    for K in (8, 16, 32, 64):
        slot = torch.as_tensor(rs.randint(-1, K, n).astype(np.int32)).to(dev)
        check_slots(torch, th, kernels, binned, vals, slot, K, B,
                    f"b1k_main_k{K}")
    # a matrix 3 bytes into its allocation: each block stages its rows
    on, of_, ob = 50_001, 13, 255
    raw = torch.as_tensor(rs.randint(0, ob, on * of_ + 3).astype(np.uint8))
    obinned = raw.to(dev)[3:].view(on, of_)
    og = torch.as_tensor(rs.randn(on).astype(np.float32)).to(dev)
    ovals = torch.stack([og, og.abs() + 0.1, torch.ones_like(og)], dim=1)
    oslot = torch.as_tensor(rs.randint(-2, 8, on).astype(np.int32)).to(dev)
    check_slots(torch, th, kernels, obinned, ovals, oslot, 8, ob,
                "b1k_unaligned")

    # B1-K-M: four members against solo calls
    K = 16
    slots = [torch.as_tensor(rs.randint(-1, K, n).astype(np.int32)).to(dev)
             for _ in range(4)]
    mv = [vals * (j + 1) for j in range(4)]
    used = [torch.tensor([K], dtype=torch.int32, device=dev)] * 4
    mem = th.compute_histogram_members(binned, mv, num_bins=B, slots=slots,
                                       num_slots=K, slots_used=used)
    solo = [th.compute_histogram(binned, mv[j], num_bins=B, slot=slots[j],
                                 num_slots=K, slots_used=used[j])
            for j in range(4)]
    members_ok = all(bits_equal(torch, mem[j], solo[j]) for j in range(4))
    emit({"check": "b1k_members", "members": 4, "K": K,
          "bit_equal_to_solo": members_ok, "ok": members_ok})
    if not members_ok:
        return 1

    # B11a: segments of a permuted order, one scale a tree
    perm = torch.as_tensor(rs.permutation(n).astype(np.int32)).to(dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    scale = seg.new_scale(dev)
    for name, order, begin, count in (("root", iota, 0, n),
                                      ("small", perm, 123_457, 7_500),
                                      ("one", perm, 5, 1),
                                      ("thirty_three", perm, 999_000, 33)):
        fill = name == "root"
        a = seg.segment_histogram(binned, vals, order, begin, count,
                                  num_bins=B, scale=scale, fill_scale=fill)
        b = seg.segment_histogram_plain(binned, vals, order, begin, count,
                                        num_bins=B)
        own = seg.segment_histogram(binned, vals, order, begin, count,
                                    num_bins=B)
        rerun = bits_equal(torch, a, seg.segment_histogram(
            binned, vals, order, begin, count, num_bins=B, scale=scale))
        rpb_equal = all(bits_equal(torch, a, seg.segment_histogram(
            binned, vals, order, begin, count, num_bins=B, scale=scale,
            rows_per_block=r)) for r in (32, 1000, 65_536))
        rows = order[begin:begin + count].long()
        kept = rows[:min(5, count)].tolist()
        kept = (kept * 5)[:5]
        pv = poison(torch, vals, kept)
        an = seg.segment_histogram(binned, pv, order, begin, count,
                                   num_bins=B)
        bn = seg.segment_histogram_plain(binned, pv, order, begin, count,
                                         num_bins=B)
        rec = {"check": f"b11a_{name}", "count": count,
               "shape": list(seg.segment_launch_shape(count, f, B)),
               "max_rel_err": rel_err(torch, a, b),
               "own_scale_bitwise": bits_equal(torch, a, own),
               "rerun_bitwise": rerun, "rows_per_block_bitwise": rpb_equal,
               "nonfinite_cells_equal": same_nonfinite(torch, an, bn),
               "max_rel_err_nonfinite": rel_err(torch, an, bn)}
        ok = (rec["max_rel_err"] <= HIST_RTOL and rec["own_scale_bitwise"]
              and rerun and rpb_equal and rec["nonfinite_cells_equal"]
              and rec["max_rel_err_nonfinite"] <= HIST_RTOL
              and torch.equal(a[..., 2], b[..., 2]))
        if not ok:
            fail(rec["check"], **rec)

        def call():
            return seg.segment_histogram(binned, vals, order, begin, count,
                                         num_bins=B, scale=scale)
        rec.update(ms=median_ms(torch, call), device_us=device_us(torch, call))
        emit({**rec, "ok": True})

    # B8a: k-hot rows with non-finite vals, one slot and K = 4
    sn, sk, sf, sst = 200_000, 6, 40, 16
    flat = rs.randint(0, sf * sst, (sn, sk)).astype(np.int32)
    flat[rs.rand(sn, sk) < 0.3] = -1
    db = rs.randint(0, sst, sf).astype(np.int32)
    sp = sparse_data.SparseBinned(torch.as_tensor(flat).to(dev),
                                  torch.as_tensor(db).to(dev), sst, sf)
    sg = torch.as_tensor(rs.randn(sn).astype(np.float32)).to(dev)
    svals = torch.stack([sg, sg.abs() + 0.1, torch.ones_like(sg)], dim=1)
    sslot = torch.as_tensor(rs.randint(-1, 4, sn).astype(np.int32)).to(dev)
    for name, kw in (("one", {}), ("k4", {
            "slot": sslot, "num_slots": 4,
            "slots_used": torch.tensor([4], dtype=torch.int32,
                                       device=dev)})):
        kept = torch.nonzero(sslot >= 0).flatten()[:5].tolist() \
            if kw else [1, 2, 3, 4, 5]
        pv = poison(torch, svals, kept)
        a = sparse_data.histogram(sp, svals, num_bins=sst, **kw)
        an = sparse_data.histogram(sp, pv, num_bins=sst, **kw)
        kw.pop("slots_used", None)
        b = sparse_data.histogram_plain(sp, svals, num_bins=sst, **kw)
        bn = sparse_data.histogram_plain(sp, pv, num_bins=sst, **kw)
        rec = {"check": f"b8a_{name}", "max_rel_err": rel_err(torch, a, b),
               "nonfinite_cells_equal": same_nonfinite(torch, an, bn),
               "nonfinite_cells": int((~torch.isfinite(bn)).sum()),
               "max_rel_err_nonfinite": rel_err(torch, an, bn)}
        ok = (rec["max_rel_err"] <= HIST_RTOL
              and rec["nonfinite_cells_equal"]
              and rec["max_rel_err_nonfinite"] <= HIST_RTOL)
        if not ok:
            fail(rec["check"], **rec)
        emit({**rec, "ok": True})

    # the rank shape, last (2,270,296 x 136 at 255 bins, K = 16)
    del binned, vals
    rn, rf, rb = 2_270_296, 136, 255
    rbin = rs.randint(1, rb, (rn, rf)).astype(np.uint8)
    rbin[rs.rand(rn, rf) < 0.7] = 0
    rbinned = torch.as_tensor(rbin).to(dev)
    del rbin
    rg = torch.as_tensor(rs.randn(rn).astype(np.float32)).to(dev)
    rvals = torch.stack([rg, rg.abs() + 0.1, torch.ones_like(rg)], dim=1)
    rslot = torch.as_tensor(rs.randint(-1, 16, rn).astype(np.int32)).to(dev)
    check_slots(torch, th, kernels, rbinned, rvals, rslot, 16, rb,
                "b1k_rank_k16")
    emit({"ok": True, "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
