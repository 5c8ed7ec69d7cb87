#!/usr/bin/env python3
"""Time ``lightgbm_torch.Dataset`` construction of the Allstate-shaped
wide sparse set on the host, with and without the EFB bundle search.

    python3 tools/torch_sparse_build_times.py ROWS [ROWS ...]

For each row count the set is drawn as ``chip_smoke.make_allstate_like``
draws it (4,228 columns, 35 stored values a row on two levels) and built
twice, at the default ``enable_bundle`` and with ``enable_bundle=false``.
Each build prints one JSON line: the rows, the parameter, the host
seconds and the layout taken (k-hot K, or the dense matrix's columns).
No card is needed: construction runs on the host alone.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    import lightgbm_torch as lgt
    for rows in (int(a) for a in argv):
        x, y = chip_smoke.make_allstate_like(rows, seed=50)
        for bundle in (True, False):
            t0 = time.perf_counter()
            ds = lgt.Dataset(x, y, params={"verbosity": -1,
                                           "enable_bundle": bundle})
            ds.construct()
            secs = time.perf_counter() - t0
            sp = ds.binned_sparse
            print(json.dumps({
                "rows": rows, "enable_bundle": bundle, "seconds": secs,
                "layout": "k-hot" if sp is not None else "dense",
                "k": None if sp is None else sp.k,
                "dense_columns": None if ds.binned is None
                else int(ds.binned.shape[1]),
                "host_cpus": os.cpu_count()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
