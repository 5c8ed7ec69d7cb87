#!/usr/bin/env python3
"""The sparse phases of ``chip_smoke.py`` alone, on one CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built), sparse_data
(the Allstate-shaped 1M x 4,228 set as k-hot rows), sparse_kernels (B8a
in its forms against its plain version at every live pass of three
whole trees, reruns, dead steps, empty slots, ``slots_used`` below K,
NaN / +-Inf rows, each form timed with its device time, bound and
``index_add_``; B3/B3-K and B4 on k-hot rows) and, unless ``--kernels``
is given, sparse_train and sparse_wide_train, one JSON line each, then
the card's name and power limit:

    python3 tools/torch_sparse_check.py [--kernels]

Exits non-zero without a card.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_sparse_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    smi = cs.phase_environment(torch, lgt_kernels)
    train, valid, _, y, xv, _ = cs.phase_sparse_data(lgt)
    cs.phase_sparse_kernels(torch, lgt, lgt_kernels, train, valid)
    if "--kernels" not in sys.argv[1:]:
        cs.phase_sparse_train(torch, lgt, lgt_kernels, train, valid, y, xv)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
