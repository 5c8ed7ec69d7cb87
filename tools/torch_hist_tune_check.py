#!/usr/bin/env python3
"""The autotuner's and the wide widths' phases of ``chip_smoke.py`` alone,
on one CUDA card.

Runs ``chip_smoke.py``'s environment (every kernel built), data (the
HIGGS-shaped 1M x 28 set), wide_k_kernels (every K-shaped kernel at K = 32
and 64 against its plain version), rows_per_block (B1, B1-K and their
integer forms at two explicit row blocks, the shadow grower at one),
hist_tune_train (``hist_tune=on`` at the wide configuration on a cold
table, against the untuned run at the record), and the wide-K cells
(quant_wide_k32/k64_train on the HIGGS-shaped rows, cat_k32/k64_train on
the airline-shaped set), one JSON line each, then the card's name and
power limit.  A quick check of this slice without the whole script:

    python3 tools/torch_hist_tune_check.py [kernels]

With ``kernels`` only the environment, data, wide_k_kernels and
rows_per_block run.  Exits non-zero without a card.
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
        print("torch_hist_tune_check: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels
    smi = cs.phase_environment(torch, lgt_kernels)
    _, _, _, _, train, valid = cs.phase_data(lgt)
    cs.phase_wide_k_kernels(torch, lgt, train)
    cs.phase_rows_per_block(torch, lgt, lgt_kernels, train)
    if "kernels" not in sys.argv[1:]:
        cs.phase_hist_tune_train(torch, lgt, lgt_kernels, train, valid,
                                 None)
        for K in cs.WIDE_KS:
            cs.phase_wide_k_train(
                torch, lgt, lgt_kernels, train, valid,
                f"quant_wide_k{K}_train", cs.QUANT_WIDE_PARAMS,
                cs.QUANT_WIDE_PER_ITERATION, K)
        _, cat_train, cat_valid = cs.phase_cat_data(lgt)
        for K in cs.WIDE_KS:
            cs.phase_wide_k_train(
                torch, lgt, lgt_kernels, cat_train, cat_valid,
                f"cat_k{K}_train",
                {**cs.CAT_PARAMS, "feature_fraction_bynode": 0.8},
                {**cs.CAT_PER_ITERATION, "node_draws": cs.WIDE_LEAVES}, K)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
