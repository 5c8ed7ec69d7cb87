#!/usr/bin/env python3
"""The integrity layer's phases of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built, the shadow set
included), data (the HIGGS-shaped 1M x 28 set), integrity_kernels (B17a,
B17b and B17c against their plain versions, the shadow set's trees
against the primary set's, each timed) and integrity_train (the main
configuration per-iteration with ``integrity_check_freq=1`` against the
unchecked run, the injected transients and sticky failures, the 255-leaf
``quant_train`` checked run), one JSON line each, then the card's name
and power limit.  A quick check of the layer without the whole script:

    python3 tools/torch_integrity_check.py [kernels | builds]

With ``kernels`` only the environment, data and integrity_kernels run.
With ``builds`` it times the builds alone instead, each into an empty
directory under ``lightgbm_torch/_build/``: the primary set, the shadow
set, and both together (as ``chip_smoke.py`` builds them), one JSON line.
Exits non-zero without a card.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def build_times(k) -> dict:
    """Wall seconds of the primary set's build, the shadow set's and both
    together, each into an empty directory (every ``nvcc`` of a build
    started together, as ``_kernels.build_all`` starts them)."""
    base = k.BUILD_DIR
    sets = {"primary": [(n, False) for n in k.SOURCES],
            "shadow": [(n, True) for n in k.SHADOW_LIBS]}
    sets["both"] = sets["primary"] + sets["shadow"]
    out = {"phase": "build_times"}
    try:
        for name, libs in sets.items():
            k.BUILD_DIR = base / f"build_times_{name}"
            shutil.rmtree(k.BUILD_DIR, ignore_errors=True)
            t0 = time.perf_counter()
            k._build(libs)
            out[f"{name}_s"] = time.perf_counter() - t0
            out[f"{name}_libraries"] = len(libs)
            shutil.rmtree(k.BUILD_DIR, ignore_errors=True)
    finally:
        k.BUILD_DIR = base
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_integrity_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    if "builds" in sys.argv[1:]:
        print(json.dumps(build_times(lgt_kernels)), flush=True)
        print(card(), flush=True)
        return 0
    smi = cs.phase_environment(torch, lgt_kernels)
    _, _, _, _, train, valid = cs.phase_data(lgt)
    cs.phase_integrity_kernels(torch, lgt, lgt_kernels, train)
    if "kernels" not in sys.argv[1:]:
        cs.phase_integrity_train(torch, lgt, lgt_kernels, train, valid)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
