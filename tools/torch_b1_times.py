#!/usr/bin/env python3
"""Time lightgbm_torch's B1, B1-K (``ops.histogram.compute_histogram``)
and B11a (``ops.segment.segment_histogram``, f32) on one CUDA card, for
one or more checkouts of the repository, so that two versions of the
kernels compare within one call.

    python3 tools/torch_b1_times.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``lightgbm_torch`` package; each is
timed in its own process, in the order given (give parent, change,
change, parent to see the spread).  Shapes, with inputs made from a seed:

- ``main``: the HIGGS-shaped main path, 1,000,000 x 28 at 63 bins, the
  strict grower's smaller-child pass (about half the rows in slot 0);
- ``main_k16``, ``main_k32``, ``main_k64``: the batched grower's pass at
  K = 16, 32 and 64, every slot in use; ``main_k64_one``: K = 64 with one
  slot in use holding every row (a tree's first super-step);
- ``efb_unbundled``: the root pass of a Flight-Delay-shaped one-hot set
  without bundles, 500,000 x 584 at 255 bins (six one-hot blocks of 12,
  31, 7, 22, 255 and 255 columns, each row with one hot column a block,
  and two numerical columns): bin 0 of every one-hot column holds nearly
  every row;
- ``rank_root``: the root pass of an MSLR-WEB30K-shaped matrix, 2,270,296
  x 136 at 255 bins, each feature zero (bin 0) for 70% of the rows;
- ``rank_k16``: the batched pass at K = 16 on that matrix, every slot in
  use;
- ``seg_root`` and ``seg_small``: B11a on the main matrix, the root
  segment (every row, in order) and a 7,500-row segment of a permuted
  order; a checkout whose ``segment_histogram`` takes the fixed point's
  ``scale`` gets it as the partitioned learner hands it (computed once,
  by a root pass, before the timing).

Each prints one JSON line: the root, the shape, the median ms of a call
over 20 calls after 3 warm-up calls (CUDA events around each call), the
least time the card could take (``bound_ms``: the larger of the bytes the
function must move at 3.35 TB/s and its f32 adds at 67 TFLOP/s, and
which one bounds it), the median ms of one ``index_add_`` over the same
cells and values precomputed (``library_ms``; the B1-K and B11a shapes),
and the card's name and power limit.  Without a CUDA card it exits
with 2.
"""

from __future__ import annotations

import inspect
import json
import os
import statistics
import subprocess
import sys


def _median_ms(torch, call) -> float:
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(nbytes: float, adds: float):
    t_b, t_o = nbytes / 3.35e12 * 1e3, adds / 67e12 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from lightgbm_torch.ops import histogram as th
    from lightgbm_torch.ops import segment as seg

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout

    def onehot(n):
        cards = (12, 31, 7, 22, 255, 255)
        cols = [(rs.randint(0, c, n)[:, None] == np.arange(c)[None, :])
                .astype(np.uint8) for c in cards]
        cols.append(rs.randint(0, 255, (n, 2)).astype(np.uint8))
        return np.ascontiguousarray(np.concatenate(cols, axis=1))

    def sparse(n, f):
        b = rs.randint(1, 255, (n, f)).astype(np.uint8)
        b[rs.rand(n, f) < 0.7] = 0
        return b

    def library(binned, vals, slot, bins, k):
        """index_add_ of the pass's kept rows over precomputed cells"""
        f = binned.shape[1]
        keep = slot >= 0 if slot is not None else \
            torch.ones(binned.shape[0], dtype=torch.bool, device=dev)
        sl = (slot[keep] if slot is not None
              else torch.zeros(int(keep.sum()), dtype=torch.int32,
                               device=dev)).to(torch.int64)
        idx = (binned[keep].to(torch.int64)
               + torch.arange(f, device=dev) * bins
               + (sl * (f * bins))[:, None]).reshape(-1)
        src = vals[keep].repeat_interleave(f, dim=0)
        acc = torch.zeros(((k or 1) * f * bins, 3), device=dev)
        ms = _median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))
        del idx, src, acc
        return ms

    main_binned = rs.randint(0, 63, (1_000_000, 28)).astype(np.uint8)
    rank_binned = sparse(2_270_296, 136)
    cases = {
        "main": (main_binned, 63,
                 np.where(rs.rand(1_000_000) < 0.5, 0, -1), None),
        "main_k16": (main_binned, 63, rs.randint(0, 16, 1_000_000), 16),
        "main_k32": (main_binned, 63, rs.randint(0, 32, 1_000_000), 32),
        "main_k64": (main_binned, 63, rs.randint(0, 64, 1_000_000), 64),
        "main_k64_one": (main_binned, 63, np.zeros(1_000_000, np.int32),
                         64),
        "efb_unbundled": (onehot(500_000), 255, None, None),
        "rank_root": (rank_binned, 255, None, None),
        "rank_k16": (rank_binned, 255, rs.randint(0, 16, 2_270_296), 16),
    }
    for name, (binned_np, bins, slot_np, k) in cases.items():
        binned = torch.as_tensor(binned_np).to(dev)
        n, f = binned.shape
        vals = torch.rand((n, 3), device=dev)
        slot = None if slot_np is None else torch.as_tensor(
            slot_np.astype(np.int32)).to(dev)
        used = 1 if name.endswith("_one") else k
        kw = {} if k is None else {
            "num_slots": k,
            "slots_used": torch.tensor([used], dtype=torch.int32,
                                       device=dev)}

        def call():
            th.compute_histogram(binned, vals, num_bins=bins, slot=slot,
                                 **kw)
        kept = n if slot is None else int((slot >= 0).sum())
        bms, by = _bound(n * f + 12 * n + (0 if slot is None else 4 * n)
                         + (k or 1) * f * bins * 12, 3 * kept * f)
        print(json.dumps({
            "root": root, "shape": name, "rows": n, "columns": f,
            "bins": bins, "slots": k or 1, "ms": _median_ms(torch, call),
            "bound_ms": bms, "bound_by": by,
            "library_ms": library(binned, vals, slot, bins, k)
            if k is not None else None,
            "card": smi.strip()}), flush=True)
        del binned, vals, slot

    # B11a on the main matrix
    binned = torch.as_tensor(main_binned).to(dev)
    n, f = binned.shape
    vals = torch.rand((n, 3), device=dev)
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    perm = torch.as_tensor(rs.permutation(n).astype(np.int32)).to(dev)
    handed = "scale" in inspect.signature(seg.segment_histogram).parameters
    kw = {}
    if handed:
        kw["scale"] = seg.new_scale(dev)
        seg.segment_histogram(binned, vals, iota, 0, n, num_bins=63,
                              fill_scale=True, **kw)
    for name, order, begin, count in (("seg_root", iota, 0, n),
                                      ("seg_small", perm, 123_457, 7_500)):
        def call():
            seg.segment_histogram(binned, vals, order, begin, count,
                                  num_bins=63, **kw)
        rows = order[begin:begin + count].to(torch.int64)
        cells = (binned.index_select(0, rows).to(torch.int64)
                 + torch.arange(f, device=dev) * 63).reshape(-1)
        src = vals.index_select(0, rows).repeat_interleave(f, dim=0)
        acc = torch.zeros((f * 63, 3), device=dev)
        bms, by = _bound(count * (4 + f + 12) + f * 63 * 12, 3 * count * f)
        print(json.dumps({
            "root": root, "shape": name, "rows": count, "columns": f,
            "bins": 63, "ms": _median_ms(torch, call), "bound_ms": bms,
            "bound_by": by, "scale": "handed" if handed else "none",
            "library_ms": _median_ms(
                torch, lambda: acc.zero_().index_add_(0, cells, src)),
            "card": smi.strip()}), flush=True)


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        _child(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_b1_times: no CUDA card", file=sys.stderr)
        return 2
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", os.path.abspath(root)])
        if r.returncode != 0:
            return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
