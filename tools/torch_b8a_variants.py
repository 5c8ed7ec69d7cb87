#!/usr/bin/env python3
"""Time variants of B8a's kernels (``lightgbm_torch/csrc/sparse.cu``)
beside the shipped build on one CUDA card, on the real passes of
``chip_smoke.py``'s sparse_kernels phase (``torch_b8a_times.real_passes``),
each variant's output held byte for byte to the shipped kernel's:

    python3 tools/torch_b8a_variants.py

A variant is the shipped source with one text replaced (``VARIANTS``),
built with the port's flags into ``lightgbm_torch/_build/variants/`` and
launched through ``sparse_data.histogram`` itself (its library swapped
in for the call).  The passes: the root pass, a mid-tree strict child
(7,532 rows), the same number of rows drawn at random (rows that share no
leaf path), and the K = 16 super-step with every slot in use.  Each
prints one JSON line: the variant, the pass, the device microseconds of
each kernel a call (``torch.profiler`` over 10 calls) and whether its
output equals the shipped kernel's.  Exits with 1 when a variant's
output differs, with 2 without a card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# variant -> (text of the shipped source, its replacement)
VARIANTS = {
    # every kept entry of a slotted pass a 64-bit global atomic
    "no_cell_cache": (
        "cell < kEmptyKey ? cache_entry(key, (unsigned int)cell) : -1",
        "-1"),
    # four entry loads in flight a lane in the slotted passes, not one
    "row_batch_4": ("constexpr int kRowBatch = 1;",
                    "constexpr int kRowBatch = 4;"),
    # one or two in the root pass, not four
    "tile_batch_1": ("constexpr int kTileBatch = 4;",
                     "constexpr int kTileBatch = 1;"),
    "tile_batch_2": ("constexpr int kTileBatch = 4;",
                     "constexpr int kTileBatch = 2;"),
}


def build(kernels, name: str, old: str, new: str) -> ctypes.CDLL:
    src = (ROOT / "lightgbm_torch/csrc/sparse.cu").read_text()
    if old not in src:
        raise SystemExit(f"variant {name}: its text is not in sparse.cu")
    out = ROOT / "lightgbm_torch/_build/variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"sparse_{name}.cu"
    cu.write_text(src.replace(old, new).replace(
        '#include "fixed.cuh"',
        f'#include "{ROOT / "lightgbm_torch/csrc/fixed.cuh"}"'))
    so = cu.with_suffix(".so")
    subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in kernels._SIGNATURES["sparse"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    kernels.check(lib.lgbt_sparse_setup(kernels.SMEM_BYTES), name)
    return lib


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_b8a_variants: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels, sparse_data as sd
    from torch_b8a_times import _device_us, real_passes

    libs = {"shipped": _kernels.lib("sparse")}
    libs.update({name: build(_kernels, name, *v)
                 for name, v in VARIANTS.items()})
    rp = real_passes(torch, cs, lgt)
    sp, vals, B, forms = rp["sp"], rp["vals"], rp["B"], dict(rp["forms"])
    n = sp.shape[0]
    kept = int((forms["strict"]["slot"] >= 0).sum())
    rnd = np.where(np.random.RandomState(0).rand(n) < kept / n, 0, -1)
    forms["strict_random"] = {
        **forms["strict"],
        "slot": torch.as_tensor(rnd.astype(np.int32)).to(sp.device)}
    del forms["k8"]
    lib_of = _kernels.lib
    ok = True
    try:
        for form, kw in forms.items():
            ref = None
            for name, lib in libs.items():
                _kernels.lib = lambda *a, _l=lib, **k: _l

                def call():
                    return sd.histogram(sp, vals, num_bins=B, **kw)
                out = call()
                torch.cuda.synchronize()
                if ref is None:
                    ref = out
                same = torch.equal(out.view(torch.int32),
                                   ref.view(torch.int32))
                ok &= same
                print(json.dumps({
                    "variant": name, "pass": form,
                    "device_us": _device_us(torch, call, reps=10),
                    "bitwise_shipped": same, "card": rp["card"]}),
                    flush=True)
    finally:
        _kernels.lib = lib_of
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
