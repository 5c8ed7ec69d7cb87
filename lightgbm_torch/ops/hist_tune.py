"""Measured (K, rows-per-block) autotuner of the histogram kernels (B15).

Counterpart of the JAX package's ``ops/hist_tune.py``.  The histogram
pass has two knobs that shapes alone do not settle: the super-step width
K (``split_batch``: how many leaves share one B1-K pass) and the rows of
one row block of the kernels (``rows_per_block``).  Under
``hist_tune=on`` the trainer asks :func:`ensure` for them:

- **one-shot sweep** (:func:`tune`): it times the SHIPPED
  ``ops.histogram.compute_histogram`` (never a sweep-local variant) in
  its K-slot form, B1-K on f32 vals or B1-K-int on int8/int16 vals, over
  the eligible widths (:func:`candidate_widths`) and three row blocks
  each (:func:`_block_candidates`), on synthetic operands: at most
  ``_SAMPLE_ROWS_CAP`` rows of uint8 bins from ``RandomState(0)``, f32 or
  integer vals by ``itemsize``, slots uniform over K.  The score is ms
  per leaf slot (ms per pass / K): a K = 32 pass may take longer than a
  K = 16 one and still win, because it retires twice the leaves per read
  of the binned matrix.
- **the knobs are the Hopper kernels' own.**  The row-block candidates
  are the automatic row block ``b0`` of the form under test at the
  training's row count (``slots_launch_shape``, B1-K's row range of one
  cluster, or ``int_launch_shape`` for itemsize 1 or 2), ``b0 / 2`` and
  ``2 b0``, each rounded up to the kernel's granularity (a warp's 32
  rows); a candidate of the integer form whose partial buffer would pass
  ``histogram.PARTIAL_CAP_BYTES`` is dropped (B1-K keeps no partial).
  The port's automatic row block grows with the row count, which the
  JAX package's VMEM budget does not, so the sample runs each candidate
  at the candidate's count of row blocks (its rows scaled by sample rows
  / training rows): the block count sets the kernel's parallelism (and
  the integer form's partial buffer and reduce), and the record keeps
  the training-scale rows.
- **timing.**  On the card CUDA events on the current stream: one warm
  call, then ``reps`` calls back to back between two events.  On the CPU
  ``time.perf_counter`` around the plain version (the wrapper's CPU
  path), as the JAX package's sweep runs on the CPU in its tests.
- **persisted** (:func:`ensure`): the winning record is keyed by
  :func:`shape_key` (platform, pow2 row bucket, histogram columns, padded
  bins, vals itemsize, eligible-K ceiling) and merged into ``TUNE_FILE``
  in :func:`tune_dir`, so the first fit per (card model, shape bucket)
  pays the sweep and every later one, in this process or another, reads
  the choice.  The platform is ``"cpu"`` on the CPU and the card's name
  on the card, so a table measured on one card model is not applied to
  another.

``hist_tune=off`` (the default) never imports this module.  The tuned K
changes the grown trees (another, equally valid, growth order), and the
tuned row block re-partitions B1's f32 sums (a histogram a few ulps
away; B1-K's fixed-point sums and the integer forms keep their bits), so
a tuned model equals the untuned run at the record's ``split_batch`` and
``rows_per_block``, not the default run.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

_LOCK = threading.Lock()
_COUNTS = {"sweeps": 0, "hits": 0}
_MEM: Dict[str, dict] = {}          # process-level merged table view
# every candidate of this process's last sweep (k, block_rows,
# sample_block_rows, ms_per_pass, ms_per_leaf), for reports
_LAST_SWEEP: List[dict] = []

TUNE_FILE = "hist_tune.json"

# sweep bounds: the sample is big enough that each candidate runs several
# row blocks and small enough that a full sweep stays a few seconds on the
# CPU
_SAMPLE_ROWS_CAP = 1 << 17
_SWEEP_REPS = 3


def tune_counts() -> Dict[str, int]:
    """Process-wide sweep/lookup counters (a second process against a warm
    table must report ``sweeps == 0``)."""
    with _LOCK:
        return dict(_COUNTS)


def last_sweep() -> List[dict]:
    """Every candidate the last sweep of this process measured."""
    with _LOCK:
        return [dict(c) for c in _LAST_SWEEP]


def tune_dir(config=None) -> str:
    """Directory the tune table lives in: the ``compile_cache_dir``
    parameter when set, else the kernels' build directory
    (``_kernels.BUILD_DIR``, git-ignored), whose lifetime is that of the
    kernels the table measured."""
    d = getattr(config, "compile_cache_dir", "") if config is not None \
        else ""
    if d:
        return d
    from .. import _kernels
    return str(_kernels.BUILD_DIR)


def platform_name(device) -> str:
    """The key's platform: ``"cpu"``, or the card's name."""
    device = torch.device(device)
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)


def shape_key(platform: str, n_rows: int, n_cols: int, num_bins: int,
              itemsize: int, kmax: int) -> str:
    """Bucketed lookup key: rows round to pow2 (one sweep covers a whole
    row bucket), the rest are exact."""
    from ..utils.shapes import padded_bins, round_up_pow2
    return (f"{platform}|r{round_up_pow2(max(int(n_rows), 1))}"
            f"|c{int(n_cols)}|b{padded_bins(num_bins)}"
            f"|i{int(itemsize)}|kmax{int(kmax)}")


def _load_table(path: str) -> Dict[str, dict]:
    try:
        with open(path) as f:
            obj = json.load(f)
        return obj if isinstance(obj, dict) else {}
    except (OSError, ValueError):
        return {}


def _store(dir_path: str, key: str, rec: dict) -> None:
    """Read-merge-replace under the process lock; atomic on disk (temp +
    os.replace) so concurrent writers can interleave but never tear the
    JSON."""
    from ..utils.resilience import atomic_write
    path = os.path.join(dir_path, TUNE_FILE)
    os.makedirs(dir_path, exist_ok=True)
    with _LOCK:
        table = _load_table(path)
        table[key] = rec
        atomic_write(path, json.dumps(table, indent=1, sort_keys=True))


def candidate_widths(kmax: int) -> List[int]:
    """Eligible super-step widths: the shipped set above 1, capped by the
    leaf budget's ceiling (``kmax`` keys the sweep, so 31-leaf and
    255-leaf shapes tune their own eligible sets)."""
    from ..utils.shapes import SPLIT_BATCH_SET
    return [k for k in SPLIT_BATCH_SET if 1 < k <= int(kmax)]


def _launch_rows(n_rows: int, n_cols: int, num_bins: int, itemsize: int,
                 k: int, rows_per_block: int = 0) -> int:
    """Rows of one row block of the K-slot form of this itemsize at
    ``rows_per_block`` (0 = automatic), rounded up to its granularity;
    ValueError past the partial buffer's cap."""
    from .histogram import int_launch_shape, slots_launch_shape
    shape = int_launch_shape if int(itemsize) in (1, 2) \
        else slots_launch_shape
    return shape(int(n_rows), int(n_cols), int(num_bins), int(k),
                 rows_per_block)[0]


def _block_candidates(n_rows: int, n_cols: int, num_bins: int,
                      itemsize: int, k: int) -> List[int]:
    """The automatic row block b0 of the form under test at ``n_rows``,
    b0 / 2 and 2 b0, each rounded up to the kernel's granularity, without
    those whose partial buffer would pass the cap (the integer form)."""
    b0 = _launch_rows(n_rows, n_cols, num_bins, itemsize, k)
    cands = set()
    for b in (b0, max(1, b0 // 2), 2 * b0):
        try:
            cands.add(_launch_rows(n_rows, n_cols, num_bins, itemsize, k, b))
        except ValueError:
            continue
    return sorted(cands)


def _measure_ms(binned, vals, slot, k: int, rows_per_block: int,
                num_bins: int, reps: int) -> float:
    """Milliseconds of one K-slot pass of the shipped
    ``compute_histogram``: on the card CUDA events around ``reps`` calls
    after one warm call, on the CPU the host clock."""
    from .histogram import compute_histogram
    used = torch.tensor([k], dtype=torch.int32, device=binned.device)

    def one():
        return compute_histogram(binned, vals, num_bins=num_bins, slot=slot,
                                 num_slots=k, slots_used=used,
                                 rows_per_block=rows_per_block)

    one()
    if binned.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            one()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        one()
    return (time.perf_counter() - t0) / reps * 1e3


def tune(n_rows: int, n_cols: int, num_bins: int, itemsize: int = 4,
         kmax: int = 64, reps: int = _SWEEP_REPS,
         sample_rows: Optional[int] = None, device="cuda") -> dict:
    """Run the sweep on ``device`` and return the winning record (no
    persistence: :func:`ensure` owns the table).  Synthetic operands at
    the training dtypes: uint8 bins, f32 or int8/int16 vals by
    ``itemsize``, uniform random slots so every width does real
    multi-leaf work."""
    import numpy as np

    from ..utils.shapes import round_up_pow2

    widths = candidate_widths(kmax)
    if not widths:
        raise ValueError(
            f"no eligible super-step width under kmax={kmax} (the leaf "
            "budget admits only strict growth — nothing to tune)")
    dev = torch.device(device)
    n_real = max(int(n_rows), 1)
    n = int(sample_rows) if sample_rows else \
        min(_SAMPLE_ROWS_CAP, round_up_pow2(n_real))
    rng = np.random.RandomState(0)
    binned = torch.as_tensor(rng.randint(0, max(int(num_bins), 2),
                                         size=(n, int(n_cols)),
                                         dtype=np.uint8)).to(dev)
    if int(itemsize) == 4:
        vals = torch.as_tensor(rng.randn(n, 3).astype(np.float32)).to(dev)
    else:
        dt = np.int8 if int(itemsize) == 1 else np.int16
        vals = torch.as_tensor(rng.randint(-100, 100, size=(n, 3),
                                           dtype=dt)).to(dev)
    best, sweep = None, []
    for k in widths:
        slot = torch.as_tensor(rng.randint(0, k, size=n,
                                           dtype=np.int32)).to(dev)
        for blk in _block_candidates(n_real, n_cols, num_bins, itemsize, k):
            # the candidate's count of row blocks over the sample
            sblk = max(1, -(-blk * n // n_real))
            ms = _measure_ms(binned, vals, slot, k, sblk, int(num_bins),
                             int(reps))
            sweep.append({"k": k, "block_rows": blk,
                          "sample_block_rows": sblk, "ms_per_pass": ms,
                          "ms_per_leaf": ms / k})
            if best is None or ms / k < best["ms_per_leaf"]:
                best = {"k": k, "block_rows": blk,
                        "ms_per_pass": round(ms, 4),
                        "ms_per_leaf": round(ms / k, 5)}
    best.update(platform=platform_name(dev), sample_rows=n,
                n_cols=int(n_cols), num_bins=int(num_bins),
                itemsize=int(itemsize), kmax=int(kmax), reps=int(reps))
    with _LOCK:
        _COUNTS["sweeps"] += 1
        _LAST_SWEEP[:] = sweep
    return best


def ensure(n_rows: int, n_cols: int, num_bins: int, itemsize: int = 4,
           kmax: int = 64, dir_path: Optional[str] = None, config=None,
           device="cuda") -> dict:
    """Lookup-or-tune, the trainer's entry: process memo -> on-disk table
    -> fresh sweep on ``device`` (persisted).  Returns the winning record;
    the caller snaps and fits ``record["k"]`` under the leaf budget."""
    d = dir_path or tune_dir(config)
    key = shape_key(platform_name(device), n_rows, n_cols, num_bins,
                    itemsize, kmax)
    with _LOCK:
        rec = _MEM.get(key)
        if rec is not None:
            _COUNTS["hits"] += 1
            return rec
    table = _load_table(os.path.join(d, TUNE_FILE))
    rec = table.get(key)
    if isinstance(rec, dict) and "k" in rec and "block_rows" in rec:
        with _LOCK:
            _MEM[key] = rec
            _COUNTS["hits"] += 1
        return rec
    rec = tune(n_rows, n_cols, num_bins, itemsize=itemsize, kmax=kmax,
               device=device)
    _store(d, key, rec)
    with _LOCK:
        _MEM[key] = rec
    return rec
