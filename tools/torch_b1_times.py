#!/usr/bin/env python3
"""Time lightgbm_torch's B1 and B1-K (``ops.histogram.compute_histogram``)
on one CUDA card, for one or more checkouts of the repository, so that
two versions of the kernels compare within one call.

    python3 tools/torch_b1_times.py ROOT [ROOT ...]

Each ROOT is a directory that holds a ``lightgbm_torch`` package; each is
timed in its own process, in the order given (give parent, change,
change, parent to see the spread).  Shapes, with inputs made from a seed:

- ``main``: the HIGGS-shaped main path, 1,000,000 x 28 at 63 bins, the
  strict grower's smaller-child pass (about half the rows in slot 0);
- ``main_k16``: the batched grower's pass at K = 16, every slot in use;
- ``efb_unbundled``: the root pass of a Flight-Delay-shaped one-hot set
  without bundles, 500,000 x 584 at 255 bins (six one-hot blocks of 12,
  31, 7, 22, 255 and 255 columns, each row with one hot column a block,
  and two numerical columns): bin 0 of every one-hot column holds nearly
  every row;
- ``rank_root``: the root pass of an MSLR-WEB30K-shaped matrix, 2,270,296
  x 136 at 255 bins, each feature zero (bin 0) for 70% of the rows.

Each prints one JSON line: the root, the shape, the median ms of a call
over 20 calls after 3 warm-up calls (CUDA events around each call), and
the card's name and power limit.  Without a CUDA card it exits with 2.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys


def _child(root: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from lightgbm_torch.ops import histogram as th

    dev = torch.device("cuda")
    rs = np.random.RandomState(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    used16 = torch.tensor([16], dtype=torch.int32, device=dev)

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

    cases = {
        "main": (rs.randint(0, 63, (1_000_000, 28)).astype(np.uint8), 63,
                 np.where(rs.rand(1_000_000) < 0.5, 0, -1), None),
        "main_k16": (rs.randint(0, 63, (1_000_000, 28)).astype(np.uint8), 63,
                     rs.randint(0, 16, 1_000_000), 16),
        "efb_unbundled": (onehot(500_000), 255, None, None),
        "rank_root": (sparse(2_270_296, 136), 255, None, None),
    }
    for name, (binned_np, bins, slot_np, k) in cases.items():
        binned = torch.as_tensor(binned_np).to(dev)
        n = binned.shape[0]
        vals = torch.rand((n, 3), device=dev)
        slot = None if slot_np is None else torch.as_tensor(
            slot_np.astype(np.int32)).to(dev)
        kw = {} if k is None else {"num_slots": k, "slots_used": used16}

        def call():
            th.compute_histogram(binned, vals, num_bins=bins, slot=slot,
                                 **kw)
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
        print(json.dumps({"root": root, "shape": name,
                          "rows": n, "columns": int(binned.shape[1]),
                          "bins": bins, "slots": k or 1,
                          "ms": statistics.median(times),
                          "card": smi.strip()}), flush=True)
        del binned, vals, slot


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
