"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Libraries go to ``lightgbm_torch/_build/`` under a
name that carries a hash of the source, the shared headers and the flags,
so an edited source or header is rebuilt and a stale library is never
loaded.  Nothing is built or loaded when this module is imported: the
first launch of a kernel builds
its library, or ``build_all`` builds every library at once, one ``nvcc``
process per source, all started together.  When a library is loaded, its
``lgbt_<name>_setup`` entry point runs once: it loads the kernels on the
device and sets per-kernel attributes, so that no launch makes such a
call (a CUDA graph captures launches only).

Every C entry point launches on the stream it is given and returns the
value of ``cudaGetLastError()`` after the launch; ``check`` raises
:class:`KernelError` on a non-zero value, as a failed build does.  Each
kernel wrapper counts its launches in ``LAUNCHES`` (one per wrapper call
that launches, whatever the number of CUDA kernels behind it), so a run
can show that it went through the kernels.  The count is taken under a
lock: the serving batcher's worker thread, HTTP handler threads and the
caller's thread all launch.  A CUDA graph replay calls no wrapper and
counts nothing: the fused trainer records what it captured and how often
it replayed it (``models/fused.py``).

The shadow set (the computation-integrity layer's twin of the grower,
``grower.make_shadow_grower``; the JAX package's ``make_shadow_grower``
is an independently compiled copy of the grower's program) is a second
build of the libraries the grower launches (``SHADOW_LIBS``), from the
same sources with one more define (``SHADOW_DEFINE``, which no source
reads: the kernels and their launch geometry are the primary set's, so a
healthy card gives the same bits), into ``lib<name>_shadow-<hash>.so``,
loaded as libraries of their own: a wrong answer has to come out of two
separately built and loaded copies of the kernels to pass the compare.
A launch inside ``with shadow_set():`` takes the shadow library (``lib``
reads the set from that context, never from a switch left on) and counts
under ``shadow:<kernel>``.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# library -> CUDA source
SOURCES: Dict[str, str] = {
    "histogram": "histogram.cu",    # B1, B1-K (and their member forms)
    "split": "split.cu",            # B2, B2-cat
    "partition": "partition.cu",    # B3, B3-K (and their member forms)
    "grow_step": "grow_step.cu",    # B3s, B3s-K
    "sample": "sample.cu",          # B6 (bagging, GOSS, node draws)
    "predict": "predict.cu",        # B4, B4-M
    "metrics": "metrics.cu",        # B12a, B12b, B12c
    "forest": "forest.cu",          # B10a, B10b, B10c
    "efb": "efb.cu",                # B9
    "rank": "rank.cu",              # B13a, B13b
    "quantize": "quantize.cu",      # B7a, B7b, B7c
    "sparse": "sparse.cu",          # B8a
    "segment": "segment.cu",        # B11a, B11b, B11c
    "integrity": "integrity.cu",    # B17a, B17b, B17c
    "dist": "dist.cu",              # B16a
    "vote": "vote.cu",              # B16b, B16c
}

# the libraries the grower launches, built a second time as the shadow
# set (module docstring), and the define that keeps the two builds apart
SHADOW_LIBS = ("histogram", "split", "partition", "grow_step", "sample",
               "efb", "quantize", "sparse")
SHADOW_DEFINE = "-DLGBT_SHADOW_BUILD=1"
SHADOW_PREFIX = "shadow:"
# set in the environment of ``distributed.run``'s workers: they load the
# libraries their launcher built and never build one themselves
NO_BUILD_ENV = "LGBT_NO_BUILD"

# kernel (launch-counter key) -> library
KERNELS: Dict[str, str] = {
    "histogram": "histogram", "split": "split", "split_cat": "split",
    "partition": "partition",
    "grow_step": "grow_step", "histogram_slots": "histogram",
    "partition_slots": "partition", "grow_step_batched": "grow_step",
    "bag_vals": "sample", "goss_vals": "sample", "node_draws": "sample",
    "predict": "predict", "auc": "metrics",
    "pointwise": "metrics", "multi_logloss": "metrics",
    "forest_walk": "forest", "bin_rows": "forest",
    "fused_predict": "forest", "expand_group_hist": "efb",
    "lambdarank": "rank", "xendcg": "rank",
    "histogram_int": "histogram", "histogram_slots_int": "histogram",
    "quant_scales": "quantize", "quantize_stack": "quantize",
    "dequant_hist": "quantize", "histogram_sparse": "sparse",
    "histogram_slots_sparse": "sparse",
    "segment_histogram": "segment", "segment_histogram_int": "segment",
    "partition_segment": "segment", "leaf_of_row": "segment",
    # the member forms of the fleet (B1-M, B1-K-M, B1-int-M, B1-K-int-M,
    # B3-M, B3-K-M, B4-M): one launch for every member
    "histogram_members": "histogram",
    "histogram_slots_members": "histogram",
    "histogram_int_members": "histogram",
    "histogram_slots_int_members": "histogram",
    "partition_members": "partition",
    "partition_slots_members": "partition", "predict_members": "predict",
    # the integrity layer's checks (B17a, B17b, B17c)
    "invariant_flags": "integrity", "score_recheck": "integrity",
    "totals_residual": "integrity",
    # the sharded learners' device work around their collectives (B16a,
    # B16b, B16c)
    "gather_best": "dist", "vote_gains": "vote", "vote_select": "vote",
}

# dynamic shared memory the B1, B10c and B11a kernels may use (227 KB, all a
# block may have on Hopper), set once at load
SMEM_BYTES = 227 * 1024

# -fmad=false: no multiply-add contraction, so a kernel's f32 arithmetic
# rounds at the same places as the op-by-op plain PyTorch version
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# B2's and B2-cat's split controls (csrc/split.cu Cons): mono, lo, hi,
# depth, factor, n_factor, contri, slope, coupled, cuse, pen, lo_l,
# hi_l, lo_r, hi_r
_SPLIT_CONS = (_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P)
# B3s's and B3s-K's split-control state (csrc/grow_step.cu
# StepCons): mono, olo, ohi, clo, chi, cdepth, groups, G, F,
# feature_mask, fallow, cmask, cuse
_STEP_CONS = (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P, _P)
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "histogram": {
        "lgbt_histogram": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P),
        "lgbt_histogram_slots": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P),
        "lgbt_histogram_int": (_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I,
                               _P, _P, _P, _P, _P),
        "lgbt_histogram_members": (_P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _I, _I, _I, _I, _P),
        "lgbt_histogram_setup": (_I,),
    },
    "split": {
        "lgbt_split": (_P, _P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _F,
                       _F, _F, _F, _F, _F, _F, *_SPLIT_CONS, _P, _P, _P, _P,
                       _P),
        "lgbt_split_cat": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                           _F, _F, _F, _F, _F, _F, _I, _I, *_SPLIT_CONS, _P,
                           _P, _P, _P, _P, _P, _P, _P),
        "lgbt_split_setup": (),
    },
    "partition": {
        "lgbt_partition": (_P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                           _P, _P, _P, _P),
        "lgbt_partition_slots": (_P, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                                 _P, _P, _I, _I, _P, _P, _P, _P),
        "lgbt_partition_members": (_P, _I, _I, _P, _I, _I, _I, _P, _P, _P,
                                   _P, _I, _I, _P, _P),
        "lgbt_partition_setup": (),
    },
    "grow_step": {
        "lgbt_grow_step": (_P, _P, _P, _I, _I, _P, _P, _I, *_STEP_CONS, _P,
                           _P, _P, _P, _P),
        "lgbt_grow_step_batched": (_P, _P, _P, _I, _I, _I, _P, _P, _I,
                                   *_STEP_CONS, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _P),
        "lgbt_grow_step_setup": (),
    },
    "sample": {
        "lgbt_bag_vals": (_P, _P, _P, ctypes.c_longlong, _P, _U, _U, _I, _I,
                          _F, _F, _F, _P, _P),
        "lgbt_goss_vals": (_P, _P, ctypes.c_longlong, _P, _U, _U, _F, _F, _P,
                           _P, _P, _P, _P),
        "lgbt_node_draws": (_P, _I, _P, _I, _I, _P, _P, _I, _U, _U, _U, _F,
                            _I, _U, _U, _U, _P, _P, _P),
        "lgbt_sample_setup": (),
    },
    "predict": {
        "lgbt_add_tree_score": (_P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                                _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                                _P, _P, _F, _I, _P),
        "lgbt_add_tree_score_members": (_I, _I, _P, _I, _I, _P, _I, _P,
                                        _P, _P, _P, _I, _I, _P, _F, _P, _P,
                                        _I, _P),
        "lgbt_predict_setup": (),
    },
    "metrics": {
        "lgbt_auc": (_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P),
        "lgbt_pointwise": (_P, _P, _P, _I, _I, _F, _P, _P, _P),
        "lgbt_multi_logloss": (_P, _P, _P, _I, _I, _P, _P, _P),
        "lgbt_metrics_setup": (),
    },
    "forest": {
        "lgbt_forest_walk": (_P, _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _I,
                             _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _P),
        "lgbt_bin_rows": (_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P),
        "lgbt_fused_predict": (_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P,
                               _I, _P, _I, _P, _P, _P, _I, _P, _P, _I, _P,
                               _I, _I, _I, _I, _I, _P, _I, _P, _F, _I, _P,
                               _I, _I, _P, _P),
        "lgbt_forest_setup": (_I,),
    },
    "efb": {
        "lgbt_expand_group_hist": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                   _P, _P, _P),
        "lgbt_efb_setup": (),
    },
    "rank": {
        "lgbt_lambdarank": (_P, _P, _P, _P, _I, _P, _I, _I, _I, _F, _F, _P,
                            _P, _P, _P),
        "lgbt_xendcg": (_P, _P, _P, _I, _U, _U, _P, _P, _P, _P),
        "lgbt_rank_setup": (),
    },
    "quantize": {
        "lgbt_quant_scales": (_P, _I, _F, _P, _P, _P),
        "lgbt_quantize_stack": (_P, _P, _I, _P, _U, _I, _I, _I, _P, _P),
        "lgbt_dequant_hist": (_P, _P, ctypes.c_longlong, _P, _P, _P),
        "lgbt_quantize_setup": (),
    },
    "sparse": {
        "lgbt_sparse_histogram": (_P, ctypes.c_longlong, _I, _P, _P, _I, _I,
                                  _I, _I, _P, _P, _P, _P, _P),
        "lgbt_sparse_setup": (),
    },
    "segment": {
        "lgbt_segment_histogram": (_P, _P, ctypes.c_longlong, _P,
                                   ctypes.c_longlong, _I, _I, _I, _I, _I, _I,
                                   _P, _I, _I, _P, _P, _P),
        "lgbt_segment_histogram_int": (_P, _P, _I, _P, ctypes.c_longlong,
                                       _I, _I, _I, _I, _I, _P, _P, _P),
        "lgbt_partition_segment": (_P, _I, _P, ctypes.c_longlong, _I, _I,
                                   _I, _I, _I, _I, _I, _P, _I, _P, _P, _P,
                                   _P),
        "lgbt_leaf_of_row": (_P, _I, _P, _P, _I, _P, _P),
        "lgbt_segment_setup": (_I,),
    },
    "integrity": {
        "lgbt_invariant_flags": (_P, _I, _I, _I, _I, _I, _I, _I, _P, _P),
        "lgbt_score_check": (_P, _I, _P, _P, ctypes.c_longlong, _I, _P,
                             _P),
        "lgbt_totals_residual": (_P, _I, _P, _I, _I, _I, _I,
                                 ctypes.c_longlong, _I, ctypes.c_longlong,
                                 _P, _P, _P),
        "lgbt_integrity_setup": (),
    },
    "dist": {
        "lgbt_gather_best": (_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P, _P,
                             _P, _P, _P),
        "lgbt_dist_setup": (),
    },
    "vote": {
        "lgbt_vote_gains": (_P, _P, _I, _I, _F, _F, _F, _F, _I, _P, _P, _P,
                            _P),
        "lgbt_vote_select": (_P, _P, _I, _I, _I, _P, _I, _P),
        "lgbt_vote_setup": (),
    },
}

# arguments of each library's setup entry point
_SETUP_ARGS: Dict[str, tuple] = {"histogram": (SMEM_BYTES,),
                                  "forest": (SMEM_BYTES,),
                                  "segment": (SMEM_BYTES,)}

# every kernel's count, and the shadow set's under ``shadow:<kernel>``
LAUNCHES: Dict[str, int] = {
    **{name: 0 for name in KERNELS},
    **{SHADOW_PREFIX + name: 0 for name, lib_name in KERNELS.items()
       if lib_name in SHADOW_LIBS}}

# loaded libraries by (name, shadow)
_libs: Dict[Tuple[str, bool], ctypes.CDLL] = {}
# whether launches in this context take the shadow set (``shadow_set``)
_SHADOW = contextvars.ContextVar("lgbt_shadow_set", default=False)
_lock = threading.Lock()
# guards LAUNCHES: a count is a read-modify-write and several threads
# launch (the serving batcher's worker, HTTP handlers, the caller)
_count_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel library did not build, did not load, or a launch returned
    a CUDA error.  Never a reason to fall back to another path: callers
    let it propagate."""


def is_kernel_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a kernel's failure to build or launch, or a CUDA
    fault surfacing at a later synchronise (PyTorch raises those as
    ``RuntimeError`` with "CUDA error" in the message).  Serving code
    re-raises such an error instead of treating it as a failed check."""
    if isinstance(exc, KernelError):
        return True
    msg = str(exc)
    return isinstance(exc, RuntimeError) and ("CUDA error" in msg
                                              or "cudaError" in msg)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    with _count_lock:
        return dict(LAUNCHES)


def nvcc_path() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for home in cands:
        p = Path(home) / "bin" / "nvcc" if home else None
        if p is not None and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the lightgbm_torch CUDA kernels cannot be built")
    return found


def _flags(shadow: bool) -> Tuple[str, ...]:
    return NVCC_FLAGS + ((SHADOW_DEFINE,) if shadow else ())


def _lib_path(name: str, shadow: bool = False) -> Path:
    # the source, every shared header (``*.cuh``) and the flags
    src = (_CSRC / SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    h = hashlib.sha256(src + " ".join(_flags(shadow)).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{_key(name, shadow)}-{h}.so"


def _nvcc_cmd(name: str, out: Path, shadow: bool = False) -> list:
    return [nvcc_path(), *_flags(shadow), "-o", str(out),
            str(_CSRC / SOURCES[name])]


def _key(name: str, shadow: bool) -> str:
    """A library's name in file names and build reports: ``<name>`` or
    ``<name>_shadow``."""
    return f"{name}_shadow" if shadow else name


def _build(libs) -> Dict[str, float]:
    """Build the missing libraries of ``libs`` ((name, shadow) pairs),
    one ``nvcc`` per library, all started together.  Returns the wall
    seconds from the start until each build ended (0.0 where the library
    was already built), keyed as ``_key``.  Raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, shadow in libs:
        out = _lib_path(name, shadow)
        if out.exists():
            continue
        if os.environ.get(NO_BUILD_ENV):
            raise KernelError(
                f"{_key(name, shadow)} is not built and {NO_BUILD_ENV} is "
                "set (a spawned worker loads what its launcher built)")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[_key(name, shadow)] = (subprocess.Popen(
            _nvcc_cmd(name, tmp, shadow), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out, name)
    times = {_key(name, shadow): 0.0 for name, shadow in libs}
    errors = []
    for key, (proc, tmp, out, name) in procs.items():
        log, _ = proc.communicate()
        times[key] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} ({key}, "
                          f"exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise KernelError("\n".join(errors))
    return times


def build_all() -> Dict[str, float]:
    """Build every kernel library, the primary set and the shadow set
    (see ``_build``)."""
    return _build([(name, False) for name in SOURCES]
                  + [(name, True) for name in SHADOW_LIBS])


@contextlib.contextmanager
def shadow_set():
    """Launches inside the block take the shadow set's libraries and
    count under ``shadow:<kernel>`` (module docstring); the set before
    the block is restored on exit."""
    token = _SHADOW.set(True)
    try:
        yield
    finally:
        _SHADOW.reset(token)


def lib(name: str, shadow: Optional[bool] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed: the
    primary set's, or the shadow set's when ``shadow`` is True (None:
    the set of this context, ``shadow_set``).  A library outside
    ``SHADOW_LIBS`` has no shadow build: asking for one raises."""
    if shadow is None:
        shadow = _SHADOW.get()
    if shadow and name not in SHADOW_LIBS:
        raise KernelError(f"the shadow set has no {name} library (it "
                          f"holds {', '.join(SHADOW_LIBS)})")
    with _lock:
        handle = _libs.get((name, shadow))
        if handle is not None:
            return handle
        _build([(name, shadow)])
        handle = ctypes.CDLL(str(_lib_path(name, shadow)))
        for fn, argtypes in _SIGNATURES[name].items():
            cfn = getattr(handle, fn)
            cfn.argtypes = list(argtypes)
            cfn.restype = ctypes.c_int
        check(getattr(handle, f"lgbt_{name}_setup")(
            *_SETUP_ARGS.get(name, ())), f"{_key(name, shadow)} setup")
        _libs[(name, shadow)] = handle
        return handle


def load_all() -> None:
    """Build every library and load the primary set (and run its setup)
    now: a caller that is about to capture a CUDA graph does this first.
    The shadow set is never captured; it loads at its first launch."""
    build_all()
    for name in SOURCES:
        lib(name, shadow=False)


def check(err: int, what: str) -> None:
    """Raise if a launch (or a setup call) returned a CUDA error code."""
    if err != 0:
        raise KernelError(f"CUDA kernel {what} failed to launch: "
                          f"cudaError {err}")


def launched(kernel: str, err: int) -> None:
    """Check a launch's error code and count the launch (under
    ``shadow:<kernel>`` inside ``shadow_set``)."""
    key = SHADOW_PREFIX + kernel if _SHADOW.get() else kernel
    check(err, key)
    with _count_lock:
        LAUNCHES[key] += 1


def pointer_table(rows) -> ctypes.Array:
    """A host table of pointers for a member form's C entry point: the
    rows (one a per-member operand, each a list with one tensor or None
    per member) laid end to end, None as a null pointer.  The caller
    keeps the tensors alive across the launch."""
    ptrs = [None if t is None else t.data_ptr() for row in rows for t in row]
    return (ctypes.c_void_p * len(ptrs))(*ptrs)


def stream_ptr(device) -> int:
    """Raw handle of PyTorch's current stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
