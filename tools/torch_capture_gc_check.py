#!/usr/bin/env python3
"""Check on one CUDA card what Python's cyclic collector does to the
CUDA graph capture of lightgbm_torch's fused iteration
(``models/fused.IterationProgram._capture``).

A trained model and its ``IterationProgram`` refer to each other, so a
dropped booster is freed only by the cyclic collector, and with it the
program's instantiated ``torch.cuda.CUDAGraph``.  ``_capture`` holds the
collector off while it captures.  This script trains a small model
(binary, 20,000 x 28 rows made from a seed, 31 leaves, a valid set, so
the default path captures the iteration), keeps it, then trains another
and, at the start of that capture, drops the first (its cycle is then
garbage) and runs a collection wherever the collector is on, as an
automatic collection would.  Three cases, each in its own process:

- ``hold``: the port as it is (the collector off during the capture);
- ``no_hold``: the hold replaced by a no-op, a dropped program pending;
- ``no_hold_nothing_pending``: the same with the first booster still
  referenced (a collection alone during the capture).

Each prints one JSON line: the case, whether the second training ran,
the error it raised if not, and the card's name and power limit.  The
expectation, if the hold repairs what it is meant to: ``hold`` and
``no_hold_nothing_pending`` train, ``no_hold`` fails with an
invalidated capture.  Without a CUDA card it exits with 2.

    python3 tools/torch_capture_gc_check.py
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys

CASES = ("hold", "no_hold", "no_hold_nothing_pending")


def _train(lgt, x, y, xv, yv):
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.1, "verbosity": -1, "metric": "auc"}
    train = lgt.Dataset(x, y, params=params)
    valid = lgt.Dataset(xv, yv, reference=train, params=params)
    return lgt.train(params, train, 10, valid_sets=[valid])


def _child(case: str) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    import torch
    import lightgbm_torch as lgt
    from lightgbm_torch.models import fused

    rng = np.random.RandomState(0)
    x = rng.randn(22_000, 28).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] + rng.randn(22_000) > 0).astype(np.float32)
    xv, yv, x, y = x[20_000:], y[20_000:], x[:20_000], y[:20_000]

    first = _train(lgt, x, y, xv, yv)
    keep = [first]
    # the control keeps the first booster referenced past the drop
    alive = first if case == "no_hold_nothing_pending" else None
    del first
    gc.collect()                 # no garbage pending before the capture
    real_body = fused.IterationProgram.body
    hook = {"armed": True, "collected": None}

    def body(self, *args, **kwargs):
        if hook["armed"] and torch.cuda.is_current_stream_capturing():
            hook["armed"] = False
            keep.clear()
            hook["collected"] = gc.collect() if gc.isenabled() else None
        return real_body(self, *args, **kwargs)

    fused.IterationProgram.body = body
    if case != "hold":
        class NoHold:
            isenabled = staticmethod(gc.isenabled)
            enable = staticmethod(gc.enable)

            @staticmethod
            def disable():
                return None
        fused.gc = NoHold
    error = None
    try:
        _train(lgt, x, y, xv, yv)
        torch.cuda.synchronize()
    except Exception as e:       # the capture's failure is the reading
        error = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({"case": case, "trained": error is None,
                      "first_kept": alive is not None,
                      "error": error,
                      "collected_during_capture": hook["collected"],
                      "capture_reached": not hook["armed"],
                      "card": smi.strip().splitlines()[0] if smi else None}),
          flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        _child(sys.argv[2])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    rc = 0
    for case in CASES:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", case])
        rc = rc or r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
