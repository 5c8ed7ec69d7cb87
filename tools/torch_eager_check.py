#!/usr/bin/env python3
"""The eager paths' phases of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built), data (the
HIGGS-shaped 1M x 28 set), kernels (the solo kernels' wrapper times
beside their plain versions), fleet_kernels (the member forms beside
four solo launches), main_path and per_iteration (the same training
launched eagerly, twice), one JSON line each, then the card's name and
power limit.  The wrapper times and the per-iteration loop carry the
host's launch path, which moves between machines; to compare two trees,
run this script of one tree in both, in one call, in the order A B B A:

    python3 tools/torch_eager_check.py

Exits non-zero without a card.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_eager_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    smi = cs.phase_environment(torch, lgt_kernels)
    _, _, _, _, train, valid = cs.phase_data(lgt)
    cs.phase_kernels(torch, lgt, train, valid)
    cs.phase_fleet_kernels(torch, lgt, train, valid)
    bst, ev, _, _ = cs.phase_main_path(torch, lgt, lgt_kernels, train, valid)
    for _ in range(2):
        cs.phase_per_iteration(torch, lgt, lgt_kernels, train, valid, bst,
                               ev)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
