#!/usr/bin/env python3
"""The distributed-training phases of ``chip_smoke.py`` alone, on one
CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built), data (the
HIGGS-shaped 1M x 28 set), dist_kernels (B16a, B16b and B16c against
their plain versions), dist_nccl1 (a one-rank NCCL group running every
communicator operation on card tensors) and dist_train (two ranks
sharing the card over gloo, every cell of ``DIST_CELLS``), one JSON line
each, then the card's name and power limit.  A quick check of this slice
without the whole script:

    python3 tools/torch_dist_check.py [kernels]

With ``kernels`` only the environment, data and dist_kernels run.  Exits
non-zero without a card.
"""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_dist_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    smi = cs.phase_environment(torch, lgt_kernels)
    _, _, _, _, train, valid = cs.phase_data(lgt)
    cs.phase_dist_kernels(torch, lgt, train)
    if "kernels" not in sys.argv[1:]:
        cs.phase_dist_nccl1(torch)
        cs.phase_dist_train(torch, lgt, lgt_kernels, train, valid)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
