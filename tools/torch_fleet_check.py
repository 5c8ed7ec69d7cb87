#!/usr/bin/env python3
"""The fleet's phases of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built), data (the
HIGGS-shaped 1M x 28 set), fleet_kernels (B1-M, B1-K-M, B1-int-M,
B1-K-int-M, B3-M, B3-K-M and B4-M bitwise against solo launches and
against their plain versions, timed at four members) and the fleet cells
(``FLEET_CELLS``: each member's model text held to its solo run), one
JSON line each, then the card's name and power limit.  A quick check of
the member forms without the whole script's 15 minutes:

    python3 tools/torch_fleet_check.py [cell ...]

With cell names (``fleet_train``, ``fleet_sweep_train``,
``fleet_ragged_train``, ``fleet_quant_train``, ``fleet_wide_train``)
only those cells run.
Exits non-zero without a card.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fleet_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    smi = cs.phase_environment(torch, lgt_kernels)
    _, _, _, _, train, valid = cs.phase_data(lgt)
    cs.phase_fleet_kernels(torch, lgt, train, valid)
    wanted = set(sys.argv[1:])
    for name, extra, rounds in cs.FLEET_CELLS:
        if not wanted or name in wanted:
            cs.phase_fleet_train(torch, lgt, lgt_kernels, train, valid,
                                 name, extra, rounds)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
