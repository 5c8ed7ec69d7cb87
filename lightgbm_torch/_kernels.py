"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``lightgbm_torch/_build/`` under a
name that carries a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing is built or
loaded when this module is imported: the first launch of a kernel builds
its library, or ``build_all`` builds every library at once, one ``nvcc``
process per source, all started together.  When a library is loaded, its
``lgbt_<name>_setup`` entry point runs once: it loads the kernels on the
device and sets per-kernel attributes, so that no launch makes such a
call (a CUDA graph captures launches only).

Every C entry point launches on the stream it is given and returns the
value of ``cudaGetLastError()`` after the launch; ``check`` raises on a
non-zero value.  Each kernel wrapper counts its launches in ``LAUNCHES``
(one per wrapper call that launches, whatever the number of CUDA kernels
behind it), so a run can show that it went through the kernels.  A CUDA
graph replay calls no wrapper and counts nothing: the fused trainer
records what it captured and how often it replayed it
(``models/fused.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# library -> CUDA source
SOURCES: Dict[str, str] = {
    "histogram": "histogram.cu",    # B1
    "split": "split.cu",            # B2
    "partition": "partition.cu",    # B3
    "grow_step": "grow_step.cu",    # B3s
    "predict": "predict.cu",        # B4
    "metrics": "metrics.cu",        # B12a, B12b
}

# kernel (launch-counter key) -> library
KERNELS: Dict[str, str] = {
    "histogram": "histogram", "split": "split", "partition": "partition",
    "grow_step": "grow_step", "predict": "predict", "auc": "metrics",
    "pointwise": "metrics",
}

# dynamic shared memory the B1 kernel may use (227 KB, all a block may
# have on Hopper), set once at load
HIST_SMEM_BYTES = 227 * 1024

# -fmad=false: no multiply-add contraction, so a kernel's f32 arithmetic
# rounds at the same places as the op-by-op plain PyTorch version
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "histogram": {
        "lgbt_histogram": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P),
        "lgbt_histogram_setup": (_I,),
    },
    "split": {
        "lgbt_split": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _F,
                       _F, _F, _F, _P, _P, _P, _P, _P),
        "lgbt_split_setup": (),
    },
    "partition": {
        "lgbt_partition": (_P, _I, _I, _P, _P, _P, _P, _P),
        "lgbt_partition_setup": (),
    },
    "grow_step": {
        "lgbt_grow_step": (_P, _P, _P, _I, _I, _P, _P, _P, _P, _P),
        "lgbt_grow_step_setup": (),
    },
    "predict": {
        "lgbt_add_tree_score": (_P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                                _F, _I, _P),
        "lgbt_predict_setup": (),
    },
    "metrics": {
        "lgbt_auc": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
        "lgbt_pointwise": (_P, _P, _P, _I, _I, _F, _P, _P, _P),
        "lgbt_metrics_setup": (),
    },
}

# arguments of each library's setup entry point
_SETUP_ARGS: Dict[str, tuple] = {"histogram": (HIST_SMEM_BYTES,)}

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home) / "bin" / "nvcc" if home else None
        if p is not None and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the lightgbm_torch CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (_CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{h}.so"


def _nvcc_cmd(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out),
            str(_CSRC / SOURCES[name])]


def _build(names) -> Dict[str, float]:
    """Build the missing libraries of ``names``, one ``nvcc`` per source,
    all started together.  Returns the wall seconds from the start until
    each build ended (0.0 where the library was already built).  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            _nvcc_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} "
                          f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_all() -> Dict[str, float]:
    """Build every kernel library (see ``_build``)."""
    return _build(list(SOURCES))


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        handle = _libs.get(name)
        if handle is not None:
            return handle
        _build([name])
        handle = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            cfn = getattr(handle, fn)
            cfn.argtypes = list(argtypes)
            cfn.restype = ctypes.c_int
        check(getattr(handle, f"lgbt_{name}_setup")(
            *_SETUP_ARGS.get(name, ())), f"{name} setup")
        _libs[name] = handle
        return handle


def load_all() -> None:
    """Build and load every library (and run its setup) now: a caller
    that is about to capture a CUDA graph does this first."""
    build_all()
    for name in SOURCES:
        lib(name)


def check(err: int, what: str) -> None:
    """Raise if a launch (or a setup call) returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {what} failed to launch: "
                           f"cudaError {err}")


def launched(kernel: str, err: int) -> None:
    """Check a launch's error code and count the launch."""
    check(err, kernel)
    LAUNCHES[kernel] += 1


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
