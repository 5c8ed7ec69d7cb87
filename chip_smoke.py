#!/usr/bin/env python3
"""Start-up, kernel and main-path check of lightgbm_torch on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, one JSON line each:

1. environment: torch, CUDA and nvcc versions, the card's name and power
   limit, the digest of the measured sources (``source_digest``), and the
   build of every kernel from ``lightgbm_torch/csrc``;
2. data: a synthetic HIGGS-shaped set (1,000,000 x 28 train, 200,000 x 28
   valid, 63 bins), binned by ``lightgbm_torch.Dataset``;
3. kernels: B1-B4, B3s and B12 at the main path's shapes, each held
   against its plain PyTorch version on the card (B3, B3s and B4 bit for
   bit, B1, B2 and B12 within the tolerances below; B3 from the root and
   from a mid-tree state with an NA bin, B2 field by field with each
   regularisation term on in turn, B4 with NA bins, B3s at every step of
   whole 31-leaf trees, a max_depth tree and a stump, B12a with forced
   ties and zero-weight rows, B12b for each metric id), with the
   kernel's, the plain version's and the library call's median times
   from CUDA events, and the bound from the bytes and operations of this
   run's inputs;
4. main path: the default ``lightgbm_torch.train`` (binary, 31 leaves, 63
   bins, 50 rounds, one valid set, metrics auc and binary_logloss, early
   stopping at 10 on the first metric), which takes the super-epoch
   route: epochs of k = 10 iterations, each k replays of one captured
   CUDA graph and one host fetch.  It reports iterations/s, epoch
   milliseconds, epochs, host fetches (checked equal to the epochs),
   graph replays, the valid AUC and best iteration, and the launches of
   every kernel (captured launches times replays, checked against the
   per-iteration count the grower's fixed step sequence gives; no eager
   launch beyond the warm-up before capture);
5. per_iteration: the same training with ``superepoch=-1, fused_chunk=1``
   and the traced metrics (``fused_eval=true``), with per-phase
   milliseconds; its model text equals the main path's (minus the path
   parameter lines), it fetches once per tree and once per eval, and its
   launches are PER_ITERATION per iteration.  The ``fused_loop`` line
   then sets the captured iteration's (B14) steady milliseconds per
   iteration beside this path's and beside the bound of the work the
   main path's own trees needed (``iteration_bound``);
6. fused_chunk: no valid set, 50 rounds as chunks of 25 replays; its model
   text equals a per-iteration run's without a valid set, and both runs'
   launches are PER_ITERATION_NO_VALID per iteration (captured and
   warm-up, or eager);
7. reference: on a small input, training on the card agrees with the
   port's CPU path (plain versions);
8. round trip and determinism: predict, model text -> Booster -> equal
   predictions, and a second training run gives byte-identical model text.

9. profile: one more main-path training traced with ``torch.profiler``:
   the device time of each kernel and the device's busy share inside the
   steady epochs.

Then the ``kernels`` summary line, the card line, and the last line
``{"ok": true, "device": {...}}``.  Any failure raises, exits non-zero and
prints no ``ok`` line.  Without a CUDA card it exits with code 2.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_TRAIN, N_VALID, N_FEAT = 1_000_000, 200_000, 28
NUM_LEAVES, MAX_BIN, ROUNDS, ES_ROUNDS = 31, 63, 50, 10
HBM_BYTES_PER_S = 3.35e12          # H100 SXM (NVIDIA data sheet)
F32_OPS_PER_S = 67e12              # f32 outside the tensor cores
# B1 and B2 sum in another order than their plain versions (index_add_
# and torch.cumsum): f32 agreement relative to the largest magnitude of
# the histogram (B1) or of each field of the split records (B2)
HIST_RTOL = 1e-5
SPLIT_RTOL = 1e-4
# B12 sums f32 terms in blocks of 2048 in another order than the plain
# version (torch.sum, index_add_ and cumsum over 200,000 rows)
AUC_ATOL = 1e-5
POINTWISE_RTOL = 1e-5
METRICS = ["auc", "binary_logloss"]
PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
# launches of each kernel in one iteration: the root pass and L - 1 steps
# of the grower (every step launches; a dead step's kernels exit at once),
# one valid walk and one kernel per metric
PER_ITERATION = {"histogram": NUM_LEAVES, "split": NUM_LEAVES,
                 "partition": NUM_LEAVES - 1, "grow_step": NUM_LEAVES - 1,
                 "predict": 1, "auc": 1, "pointwise": 1}
# without a valid set: no walk and no metric
PER_ITERATION_NO_VALID = {**PER_ITERATION, "predict": 0, "auc": 0,
                          "pointwise": 0}
KERNEL_ORDER = ("histogram", "split", "partition", "grow_step", "predict",
                "auc", "pointwise")


def times(counts, n: int):
    return {k: n * v for k, v in counts.items()}


def source_digest(root: Path = Path(__file__).resolve().parent) -> str:
    """sha256 over the relative path and bytes of this script and every
    ``.py`` and ``.cu`` file of ``lightgbm_torch``: names the code a run
    measured.  Raises if the package is not beside the script."""
    pkg = root / "lightgbm_torch"
    files = sorted(p for p in pkg.rglob("*") if p.suffix in (".py", ".cu")
                   and "_build" not in p.relative_to(pkg).parts)
    if not files:
        raise FileNotFoundError(f"no lightgbm_torch sources under {root}")
    h = hashlib.sha256()
    for p in [root / "chip_smoke.py", *files]:
        h.update(str(p.relative_to(root)).encode() + b"\0")
        h.update(p.read_bytes() + b"\0")
    return h.hexdigest()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def make_higgs_like(n: int, f: int, seed: int):
    """bench.py's synthetic HIGGS-shaped recipe."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    logit = (1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.6 * x[:, 2] * x[:, 3]
             + 0.4 * np.abs(x[:, 4]) + 0.5 * rng.randn(n))
    return x, (logit > 0).astype(np.float32)


def median_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median milliseconds of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def iteration_bound(trees, n: int, f: int, B: int, L: int, nv: int):
    """The least time of one boosting iteration of the main path, from
    its own trees: the bytes and operations each step needs at the row
    counts that tree gave it, averaged over the trees.  Per iteration:
    gradients (score, label, weight read, [N, 3] vals written), the
    root's histogram pass (every row's bins and vals), the train-score
    update (score read and written, row -> leaf read), the valid walk
    (B4's bytes) and the two metrics (B12's).  Per active split step: B3s
    (table, tree buffer read and written), B3 over the split leaf's rows
    (column byte and leaf id read, leaf id written), B1 over the smaller
    child's rows (bins and vals) and its histogram out, the subtraction
    (three histograms), B2 on the pair (two histograms in, two records
    out).  A dead step needs nothing.  Returns (ms, by, bytes)."""
    from lightgbm_torch.grower import tree_words
    hist = f * B * 12
    rec = 12 * 4
    fixed = (24 * n + n * (f + 12) + hist + hist + rec + 12 * n
             + nv * f + 8 * nv + 2 * (12 * nv + 4))
    fixed_ops = (12 * n + 3 * n * f + 40 * 2 * f * B + 2 * n + 7 * nv
                 + nv * float(np.log2(nv)) + 10 * nv + 30 * nv)
    step = L * rec + 2 * tree_words(L) * 4 + 6 * hist + 2 * rec
    step_ops = 40 * 2 * 2 * f * B + 3 * f * B
    total = ops = 0.0
    for t in trees:
        for s in range(t.num_leaves - 1):
            kids = [t.internal_count[c] if c >= 0 else t.leaf_count[~c]
                    for c in (t.left_child[s], t.right_child[s])]
            parent, small = int(t.internal_count[s]), int(min(kids))
            total += step + 9 * parent + small * (f + 12)
            ops += step_ops + 2 * parent + 3 * small * f
    nbytes = fixed + total / len(trees)
    ms, by = bound_ms(nbytes, fixed_ops + ops / len(trees))
    return ms, by, nbytes


def check_partition(torch, lor_k, lor_p, slot_k, slot_p, what: str) -> None:
    """B3 against its plain version: leaf_of_row and slot bit for bit."""
    bad = max(int((lor_k != lor_p).sum()), int((slot_k != slot_p).sum()))
    if bad != 0:
        raise AssertionError(f"B3 ({what}) differs from its plain version "
                             f"in {bad} rows")


def check_split(torch, sp, r_k, r_p, what: str):
    """B2 records against the plain version's, field by field: feature,
    threshold and direction equal; -inf gains equal; every other float
    field finite in both, its error within SPLIT_RTOL times the largest
    magnitude of that field.  Returns (max abs, max relative) error."""
    ints = [sp.FEATURE, sp.THRESHOLD, sp.DEFAULT_LEFT]
    if not torch.equal(r_k[:, ints], r_p[:, ints]):
        raise AssertionError(f"B2 ({what}) picks another split: "
                             f"{r_k[:, ints].tolist()} vs "
                             f"{r_p[:, ints].tolist()}")
    none_k = torch.isneginf(r_k[:, sp.GAIN])
    none_p = torch.isneginf(r_p[:, sp.GAIN])
    if not torch.equal(none_k, none_p):
        raise AssertionError(f"B2 ({what}) finds a split where the plain "
                             f"version finds none, or the reverse")
    worst_abs = worst_rel = 0.0
    for col in range(sp.RECORD):
        if col in ints:
            continue
        a, b = r_k[:, col], r_p[:, col]
        if col == sp.GAIN:
            a, b = a[~none_p], b[~none_p]
        if a.numel() == 0:
            continue
        if not (bool(torch.isfinite(a).all())
                and bool(torch.isfinite(b).all())):
            raise AssertionError(f"B2 ({what}) field {col} not finite: "
                                 f"{a.tolist()} vs {b.tolist()}")
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if err > SPLIT_RTOL * scale:
            raise AssertionError(f"B2 ({what}) field {col}: max abs error "
                                 f"{err} against scale {scale}")
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale if scale > 0 else 0.0)
    return worst_abs, worst_rel


def split_cases(torch, sp, tot, base):
    """Split parameters that each turn on one term of the gain, validity
    or leaf output, sized from the leaves' sums ``tot`` [2, 3]
    and the default parameters' records ``base`` so that each term moves
    the result by far more than SPLIT_RTOL at any data size, while both
    leaves keep a valid split; then all terms at once with the CPU test's
    values.  Each case maps to (SplitParams,
    parent_output [2])."""
    g = float(tot[:, 0].abs().min())
    h = float(tot[:, 1].min())
    c = float(tot[:, 2].min())
    side = torch.stack([base[:, sp.LEFT_SUM], base[:, sp.RIGHT_SUM]], 1)
    outs = base[:, [sp.LEFT_OUTPUT, sp.RIGHT_OUTPUT]].abs()
    out_min = float(outs.min())
    po = torch.tensor([0.5, -0.5], device=tot.device) * out_min
    zero = torch.zeros(2, device=tot.device)
    gain = max(0.0, float(base[:, sp.GAIN].min()))
    terms = {
        "l1": {"lambda_l1": 0.1 * g},
        "l2": {"lambda_l2": 0.2 * h},
        # one more row / a little more hessian than the default pick's
        # smaller side has, so that its split is no longer valid
        "min_data": {"min_data_in_leaf": int(side[:, :, 2].min()) + 1},
        "min_hess": {"min_sum_hessian_in_leaf":
                     1.01 * float(side[:, :, 1].min())},
        "max_delta": {"max_delta_step": 0.5 * out_min},
        "path_smooth": {"path_smooth": 0.2 * c},
        "min_gain": {"min_gain_to_split": 0.2 * gain},
    }
    cases = {k: (sp.SplitParams(**v), po if k == "path_smooth" else zero)
             for k, v in terms.items()}
    # every term at once, with the CPU test's "all" values
    cases["all"] = (sp.SplitParams(lambda_l1=1.0, lambda_l2=2.0,
                                   max_delta_step=0.3, path_smooth=3.0,
                                   min_data_in_leaf=50), po)
    return cases


def check_grow_step(torch, binned, vals, fmask, num_bin, na_bin, B, params,
                    max_depth, case, snap):
    """Grow one tree on the card with the B3s kernel, and at every step
    run its plain version on copies of the step's inputs: the step record,
    index, sums, flags and the whole tree buffer must be bit-equal.  Keeps
    the state before the middle step in ``snap`` (for timing).  Returns
    (steps, active steps)."""
    from lightgbm_torch import grower as gr
    n, f = binned.shape
    ws = gr.GrowWorkspace(n, f, B, NUM_LEAVES, binned.device)
    kernel = gr.grow_step
    seen = {"steps": 0, "active": 0}

    def both(table, tree, na, **kw):
        if seen["steps"] == NUM_LEAVES // 2 and "state" not in snap:
            snap["state"] = {"table": table.clone(), "tree0": tree.clone(),
                             "tree": tree.clone(),
                             **{k: kw[k].clone() for k in
                                ("rec", "idx", "fstep", "flags")}}
        tree_p = tree.clone()
        kw_p = {k: (v.clone() if torch.is_tensor(v) else v)
                for k, v in kw.items()}
        gr.grow_step_plain(table, tree_p, na, **kw_p)
        kernel(table, tree, na, **kw)
        for k in ("rec", "idx", "fstep", "flags"):
            if not torch.equal(kw[k], kw_p[k]):
                raise AssertionError(f"B3s ({case}, step {seen['steps']}) "
                                     f"{k}: {kw[k].tolist()} vs plain "
                                     f"{kw_p[k].tolist()}")
        if not torch.equal(tree, tree_p):
            raise AssertionError(f"B3s ({case}, step {seen['steps']}) "
                                 "tree buffer differs from the plain "
                                 "version's")
        seen["steps"] += 1
        seen["active"] += int(kw["rec"][gr.ACTIVE])

    gr.grow_step = both
    try:
        gr.grow_tree(binned, vals, fmask, num_bin, na_bin,
                     num_leaves=NUM_LEAVES, num_bins=B, params=params,
                     max_depth=max_depth, workspace=ws)
    finally:
        gr.grow_step = kernel
    tree = gr.fetch_tree(ws)
    if tree.num_leaves != seen["active"] + 1:
        raise AssertionError(f"B3s ({case}): {tree.num_leaves} leaves "
                             f"after {seen['active']} active steps")
    return seen["steps"], seen["active"]


def phase_environment(torch, lgt_kernels):
    nvcc = subprocess.run([lgt_kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    per_kernel = lgt_kernels.build_all()
    build_s = time.perf_counter() - t0
    emit({"phase": "environment", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.stdout.strip().splitlines()[-1],
          "card": smi, "device": torch.cuda.get_device_name(0),
          "source_sha256": source_digest(), "build_s": build_s, "build_s_by_kernel": per_kernel})
    return smi


def phase_data(lgt):
    t0 = time.perf_counter()
    x, y = make_higgs_like(N_TRAIN, N_FEAT, seed=0)
    xv, yv = make_higgs_like(N_VALID, N_FEAT, seed=1)
    params = {"max_bin": MAX_BIN, "verbosity": -1}
    train = lgt.Dataset(x, y, params=params).construct()
    valid = lgt.Dataset(xv, yv, reference=train, params=params).construct()
    if train.binned.shape != (N_TRAIN, N_FEAT) \
            or train.binned.dtype != np.uint8:
        raise AssertionError(f"unexpected binned matrix {train.binned.shape}")
    emit({"phase": "data", "seconds": time.perf_counter() - t0,
          "train": list(train.binned.shape), "valid": list(valid.binned.shape),
          "max_bin": int(train.max_bin)})
    return x, y, xv, yv, train, valid


def phase_kernels(torch, lgt, train, valid):
    """Each kernel against its plain version at the main path's shapes."""
    from lightgbm_torch.grower import partition, partition_plain
    from lightgbm_torch.ops import split as sp
    from lightgbm_torch.ops.histogram import compute_histogram, histogram_plain
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_plain)
    dev = torch.device("cuda", 0)
    binned = torch.as_tensor(train.binned).to(dev)
    vbinned = torch.as_tensor(valid.binned).to(dev)
    n, f = binned.shape
    nv = vbinned.shape[0]
    B = int(train.max_bin)
    mappers = [train.bin_mappers[i] for i in train.used_features]
    num_bin = torch.tensor([m.num_bin for m in mappers], dtype=torch.int32,
                           device=dev)
    na_bin = torch.tensor([m.na_bin for m in mappers], dtype=torch.int32,
                          device=dev)
    fmask = torch.ones(f, dtype=torch.bool, device=dev)
    # binary-objective gradients at a random score (at score 0 they are
    # exactly +-0.5 and 0.25, and every sum would be exact)
    y = torch.as_tensor(train.metadata.label).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    p = torch.sigmoid(torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([p - y, p * (1 - p), torch.ones_like(y)], dim=1)
    params = sp.SplitParams()
    rows = []

    def rec(leaf, new_leaf, feat, thr, dleft, na, smaller):
        return torch.tensor([leaf, new_leaf, feat, thr, int(dleft), na,
                             smaller, 1], dtype=torch.int32, device=dev)

    # B3 at the root split of feature 0, threshold mid-range
    lor = torch.zeros(n, dtype=torch.int32, device=dev)
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    thr = int(num_bin[0].item()) // 2
    args = (rec(0, 1, 0, thr, False, int(na_bin[0].item()), 1), iota)
    lor_k, lor_p = lor.clone(), lor.clone()
    slot_k = partition(binned, lor_k, *args)
    slot_p = partition_plain(binned, lor_p, *args)
    check_partition(torch, lor_k, lor_p, slot_k, slot_p, "root")
    # and mid-tree: rows spread over 17 leaves, leaf 5 split into leaf 17,
    # a bin of the column taken as the NA bin, both NA directions, the
    # identity and a permuted rank vector
    lor_mid = torch.randint(0, 17, (n,), dtype=torch.int32, device=dev,
                            generator=gen)
    perm = torch.randperm(B, device=dev, generator=gen).to(torch.int32)
    for feat, dleft, na, rank, smaller in ((3, False, "top", iota, 17),
                                           (7, True, 0, perm, 5)):
        na = int(num_bin[feat].item()) - 1 if na == "top" else na
        margs = (rec(5, 17, feat, int(num_bin[feat].item()) // 2, dleft, na,
                     smaller), rank)
        in_leaf = lor_mid == 5
        if int(((binned[:, feat] == na) & in_leaf).sum()) == 0 \
                or int((~in_leaf).sum()) == 0:
            raise AssertionError("B3 mid-tree check takes no NA row or no "
                                 "row of another leaf")
        lk, lp = lor_mid.clone(), lor_mid.clone()
        sk = partition(binned, lk, *margs)
        sp_ = partition_plain(binned, lp, *margs)
        check_partition(torch, lk, lp, sk, sp_, f"mid-tree feature {feat}")
    # every timed call starts from the root state again (a 4 MB fill,
    # counted in both times)
    t_k = median_ms(torch, lambda: partition(binned, lor.fill_(0), *args))
    t_p = median_ms(torch, lambda: partition_plain(binned, lor.fill_(0),
                                                   *args))
    b3_bytes = n * f + 12 * n
    rows.append(("partition", "B3 row partition",
                 "lightgbm_torch/csrc/partition.cu",
                 "lightgbm_tpu/grower.py:768", 0.0, 0.0, t_k, t_p,
                 bound_ms(b3_bytes, 2 * n), None))

    # B1: the smaller child's pass (slot from B3) and the root pass
    h_k = compute_histogram(binned, vals, num_bins=B, slot=slot_k)
    h_p = histogram_plain(binned, vals, num_bins=B, slot=slot_k)
    h_k2 = compute_histogram(binned, vals, num_bins=B, slot=slot_k)
    torch.cuda.synchronize()
    if not torch.equal(h_k, h_k2):
        raise AssertionError("B1 is not bitwise reproducible")
    if not torch.equal(h_k[..., 2], h_p[..., 2]):
        raise AssertionError("B1 count channel differs from its plain version")
    err1 = float((h_k - h_p).abs().max())
    scale1 = float(h_p.abs().max())
    if err1 > HIST_RTOL * max(1.0, scale1):
        raise AssertionError(f"B1 max abs error {err1} (scale {scale1})")
    t_k = median_ms(torch, lambda: compute_histogram(binned, vals, num_bins=B,
                                                     slot=slot_k))
    t_p = median_ms(torch, lambda: histogram_plain(binned, vals, num_bins=B,
                                                   slot=slot_k))
    # library yardstick: one index_add_ over precomputed (f*B + bin) indices
    keep = slot_k >= 0
    idx = (binned[keep].to(torch.int64)
           + torch.arange(f, device=dev) * B).reshape(-1)
    src = vals[keep].repeat_interleave(f, dim=0)
    acc = torch.zeros((f * B, 3), device=dev)
    t_lib = median_ms(torch, lambda: acc.zero_().index_add_(0, idx, src))
    b1_bytes = n * f + 12 * n + 4 * n + f * B * 12
    rows.append(("histogram", "B1 histogram", "lightgbm_torch/csrc/histogram.cu",
                 "lightgbm_tpu/ops/histogram.py:129", err1,
                 err1 / max(scale1, 1e-30), t_k, t_p,
                 bound_ms(b1_bytes, 3 * n * f), t_lib))

    # B2 on the two children of that split: the default parameters (timed),
    # then each regularisation term alone and all together
    root = compute_histogram(binned, vals, num_bins=B)
    pair = torch.stack([h_k, root - h_k]).contiguous()
    tot = pair[:, 0].sum(dim=1).contiguous()            # [2, 3]
    po = torch.zeros(2, device=dev)
    r_k = sp.find_best_split(pair, tot, po, num_bin, na_bin, fmask, params)
    r_p = sp.find_best_split_plain(pair, tot, po, num_bin, na_bin, fmask,
                                   params)
    err2, rel2 = check_split(torch, sp, r_k, r_p, "default")
    for case, (prm, po_c) in split_cases(torch, sp, tot, r_p).items():
        r_k = sp.find_best_split(pair, tot, po_c, num_bin, na_bin, fmask,
                                 prm)
        r_p2 = sp.find_best_split_plain(pair, tot, po_c, num_bin, na_bin,
                                        fmask, prm)
        if bool(torch.isneginf(r_p2[:, sp.GAIN]).any()):
            raise AssertionError(f"B2 case {case} finds no split, so it "
                                 "checks no gain")
        e, r = check_split(torch, sp, r_k, r_p2, case)
        err2, rel2 = max(err2, e), max(rel2, r)
    t_k = median_ms(torch, lambda: sp.find_best_split(
        pair, tot, po, num_bin, na_bin, fmask, params))
    t_p = median_ms(torch, lambda: sp.find_best_split_plain(
        pair, tot, po, num_bin, na_bin, fmask, params))
    # one launch of an empty kernel: the floor of a kernel this small
    launch_ms = median_ms(torch, lambda: torch.cuda._sleep(0))
    cand = 2 * 2 * f * B
    b2_bytes = pair.numel() * 4 + 2 * 3 * 4 + 2 * 4 + 2 * f * 4 + f \
        + 2 * sp.RECORD * 4
    rows.append(("split", "B2 split scan", "lightgbm_torch/csrc/split.cu",
                 "lightgbm_tpu/ops/split.py:343", err2, rel2, t_k, t_p,
                 bound_ms(b2_bytes, 40 * cand), None))

    # a wide input, checked and not timed: 100 features x 255 bins takes
    # B1's feature tiling (F*B*12 bytes exceed shared memory) and B2's
    # 256-thread blocks
    wf, wb_ = 100, 255
    wbinned = torch.randint(0, wb_, (50_000, wf), dtype=torch.uint8,
                            device=dev, generator=gen)
    wg = torch.randn(50_000, device=dev, generator=gen)
    wvals = torch.stack([wg, wg.abs() + 0.1, torch.ones_like(wg)], dim=1)
    wh_k = compute_histogram(wbinned, wvals, num_bins=wb_)
    wh_p = histogram_plain(wbinned, wvals, num_bins=wb_)
    werr = float((wh_k - wh_p).abs().max())
    if not torch.equal(wh_k[..., 2], wh_p[..., 2]) \
            or werr > HIST_RTOL * max(1.0, float(wh_p.abs().max())):
        raise AssertionError(f"B1 (wide) differs from its plain version: "
                             f"{werr}")
    wpair = torch.stack([wh_k, wh_k * 0.5]).contiguous()
    wtot = wpair[:, 0].sum(dim=1).contiguous()
    wnb = torch.full((wf,), wb_, dtype=torch.int32, device=dev)
    wna = torch.full((wf,), -1, dtype=torch.int32, device=dev)
    wna[::3] = wb_ - 1
    wm = torch.ones(wf, dtype=torch.bool, device=dev)
    wr_k = sp.find_best_split(wpair, wtot, po, wnb, wna, wm, params)
    wr_p = sp.find_best_split_plain(wpair, wtot, po, wnb, wna, wm, params)
    werr2, _ = check_split(torch, sp, wr_k, wr_p, "wide")
    emit({"phase": "kernel_wide", "features": wf, "bins": wb_,
          "hist_max_abs_err": werr, "split_max_abs_err": werr2})

    # B4: a depth-5 tree over the valid rows
    nodes = 2 ** 5 - 1
    rng = np.random.RandomState(3)
    sf = rng.randint(0, f, nodes).astype(np.int32)
    th = rng.randint(0, B - 1, nodes).astype(np.int32)
    lc = np.where(np.arange(nodes) * 2 + 1 < nodes,
                  np.arange(nodes) * 2 + 1, 0).astype(np.int32)
    rc = np.where(np.arange(nodes) * 2 + 2 < nodes,
                  np.arange(nodes) * 2 + 2, 0).astype(np.int32)
    leaves = np.arange(nodes + 1)
    first_leaf = nodes // 2
    for node in range(first_leaf, nodes):            # bottom level -> leaves
        lc[node] = ~leaves[2 * (node - first_leaf)]
        rc[node] = ~leaves[2 * (node - first_leaf) + 1]
    tree = [torch.as_tensor(a).to(dev) for a in (sf, th)]
    # int32 default_left, as the grower's device tree arrays carry it
    dl = torch.as_tensor((rng.rand(nodes) < 0.5).astype(np.int32)).to(dev)
    lct, rct = torch.as_tensor(lc).to(dev), torch.as_tensor(rc).to(dev)
    lv = torch.as_tensor(rng.randn(nodes + 1).astype(np.float32)).to(dev)
    # a bin of each of half the features taken as its NA bin, so that
    # rows take the default_left branch
    vna = na_bin.clone()
    vna[0::2] = num_bin[0::2] - 1
    vna[1::4] = 0
    score0 = torch.as_tensor(rng.randn(nv).astype(np.float32)).to(dev)
    s_k, s_p = score0.clone(), score0.clone()
    add_tree_score(s_k, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1,
                   steps=5)
    add_tree_score_plain(s_p, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv,
                         0.1, steps=5)
    torch.cuda.synchronize()
    if not torch.equal(s_k, s_p):
        raise AssertionError(f"B4 differs from its plain version: max "
                             f"{float((s_k - s_p).abs().max())}")
    s = score0.clone()
    t_k = median_ms(torch, lambda: add_tree_score(
        s, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1, steps=5))
    t_p = median_ms(torch, lambda: add_tree_score_plain(
        s, vbinned, tree[0], tree[1], dl, lct, rct, vna, lv, 0.1, steps=5))
    b4_bytes = nv * f + 8 * nv
    rows.append(("predict", "B4 tree score update",
                 "lightgbm_torch/csrc/predict.cu",
                 "lightgbm_tpu/predict_device.py:72", 0.0, 0.0, t_k, t_p,
                 bound_ms(b4_bytes, 2 * nv + 5 * nv), None))

    # B3s: whole trees at the main path's shape, with the plain version run
    # on copies of the same inputs at every step (records and tree buffer
    # bit for bit): the default parameters, max_depth 3, and a stump
    snap = {}
    cases = {"full": (params, -1), "max_depth_3": (params, 3),
             "stump": (sp.SplitParams(min_gain_to_split=1e30), -1)}
    b3s_steps = {}
    for case, (prm, depth) in cases.items():
        steps, active = check_grow_step(torch, binned, vals, fmask, num_bin,
                                        na_bin, B, prm, depth, case, snap)
        b3s_steps[case] = {"steps": steps, "active": active}
    if b3s_steps["full"]["active"] != NUM_LEAVES - 1 \
            or not 0 < b3s_steps["max_depth_3"]["active"] < NUM_LEAVES - 1 \
            or b3s_steps["stump"]["active"] != 0:
        raise AssertionError(f"B3s cases do not cover active, dead and "
                             f"stump steps: {b3s_steps}")
    from lightgbm_torch import grower as gr
    st = snap["state"]

    def b3s_call(fn):
        st["tree"].copy_(st["tree0"])
        fn(st["table"], st["tree"], na_bin, num_leaves=NUM_LEAVES,
           max_depth=-1, rec=st["rec"], idx=st["idx"], fstep=st["fstep"],
           flags=st["flags"])
    t_k = median_ms(torch, lambda: b3s_call(gr.grow_step))
    t_p = median_ms(torch, lambda: b3s_call(gr.grow_step_plain))
    words = st["tree"].numel()
    b3s_bytes = st["table"].numel() * 4 + 2 * words * 4 + f * 4 \
        + 8 * 4 + 2 * 8 + 8 * 4 + 2
    rows.append(("grow_step", "B3s split step", "lightgbm_torch/csrc/"
                 "grow_step.cu", "lightgbm_tpu/grower.py:742", 0.0, 0.0,
                 t_k, t_p, bound_ms(b3s_bytes, 2 * NUM_LEAVES), None))
    emit({"phase": "kernel_grow_step", "cases": b3s_steps,
          "timed_ms_includes": "a copy of the tree buffer to reset it"})

    # B12a on the valid set's shape: random scores, scores with forced
    # ties (the 32 values of one tree, as early in training), and the tied
    # scores with zero-weight rows
    from lightgbm_torch import metrics as tm
    yv = torch.as_tensor(np.asarray(valid.metadata.label, np.float32)).to(dev)
    ones = torch.ones(nv, device=dev)
    sv = torch.randn(nv, device=dev, generator=gen)
    tied = add_tree_score(torch.zeros(nv, device=dev), vbinned, tree[0],
                          tree[1], dl, lct, rct, vna, lv, 1.0, steps=5)
    zw = ones.clone()
    zw[::7] = 0.0
    err12a = 0.0
    for case, (sc, w) in {"random": (sv, ones), "ties": (tied, ones),
                          "ties_zero_weights": (tied, zw)}.items():
        a = float(tm.traced_auc(sc, yv, w))
        b = float(tm.traced_auc_plain(sc, yv, w))
        if not abs(a - b) <= AUC_ATOL:
            raise AssertionError(f"B12a ({case}): {a} vs plain {b}")
        err12a = max(err12a, abs(a - b))
    if int(torch.unique(tied).numel()) > 2 ** 5:
        raise AssertionError("B12a tie case has no ties")
    t_k = median_ms(torch, lambda: tm.traced_auc(sv, yv, ones))
    t_p = median_ms(torch, lambda: tm.traced_auc_plain(sv, yv, ones))
    t_lib = median_ms(torch, lambda: torch.sort(sv, stable=True))
    lg = float(np.log2(nv))
    rows.append(("auc", "B12a traced AUC", "lightgbm_torch/csrc/metrics.cu",
                 "lightgbm_tpu/metrics.py:402", err12a, err12a, t_k, t_p,
                 bound_ms(12 * nv + 4, nv * lg + 10 * nv), t_lib))

    # B12b, each metric id on the valid set's shape
    err12b = rel12b = 0.0
    per_metric = {}
    for metric in tm.POINTWISE_IDS:
        a = float(tm.traced_pointwise(sv, yv, zw, metric=metric))
        b = float(tm.traced_pointwise_plain(sv, yv, zw, metric=metric))
        rel = abs(a - b) / abs(b)
        if not rel <= POINTWISE_RTOL:
            raise AssertionError(f"B12b {metric}: {a} vs plain {b}")
        err12b, rel12b = max(err12b, abs(a - b)), max(rel12b, rel)
        per_metric[metric] = {
            "value": a, "plain": b,
            "ms": median_ms(torch, lambda: tm.traced_pointwise(
                sv, yv, ones, metric=metric)),
            "plain_ms": median_ms(torch, lambda: tm.traced_pointwise_plain(
                sv, yv, ones, metric=metric))}
    import torch.nn.functional as F
    t_lib = median_ms(torch, lambda: F.binary_cross_entropy_with_logits(
        sv, yv, weight=ones))
    lm = per_metric["binary_logloss"]
    rows.append(("pointwise", "B12b traced pointwise metrics "
                 "(binary_logloss timed)", "lightgbm_torch/csrc/metrics.cu",
                 "lightgbm_tpu/metrics.py:391", err12b, rel12b, lm["ms"],
                 lm["plain_ms"], bound_ms(12 * nv + 4, 30 * nv), t_lib))
    emit({"phase": "kernel_pointwise", "metrics": per_metric})

    # B5 (torch ops, no kernel of its own): the binary gradients and the
    # [N, 3] vals stack at the training shape; bound: score, label and
    # label weight read, vals written
    from lightgbm_torch.config import Config
    from lightgbm_torch.objectives import BinaryLogloss
    obj = BinaryLogloss(Config({"objective": "binary"}))
    obj.init(train.metadata, n, dev)
    score5 = torch.randn(n, device=dev, generator=gen)

    def b5():
        g, h = obj.get_gradients(score5)
        return torch.stack([g, h, torch.ones_like(g)], dim=1)
    b5_bound, b5_by = bound_ms(12 * n + 12 * n, 12 * n)
    emit({"phase": "b5_gradients", "ms": median_ms(torch, b5),
          "bound_ms": b5_bound, "bound_by": b5_by})

    out = {}
    for key, name, src_path, replaces, err, rel, tk, tp, (bms, by), tl \
            in rows:
        out[key] = {"name": name, "route": "cuda", "source": src_path,
                    "replaces": replaces, "max_abs_err": err, "ms": tk,
                    "plain_ms": tp, "bound_ms": bms, "bound_by": by,
                    "library_ms": tl}
        extra = {"empty_launch_ms": launch_ms} if key == "split" else {}
        emit({"phase": "kernel", **out[key], "max_rel_err": rel,
              "kernel_ms": tk, **extra})
    return out


def _attach_timer(env):
    from lightgbm_torch.models.gbdt import PhaseTimer
    m = env.model._model
    if m.phase_timer is None:
        m.phase_timer = PhaseTimer(m.device)


_attach_timer.before_iteration = True


def train_main(lgt, train, valid, extra=None, timed=False, rounds=ROUNDS):
    """The main path's training: default path parameters unless ``extra``
    says otherwise."""
    ev = {}
    cbs = [lgt.early_stopping(ES_ROUNDS, first_metric_only=True,
                              verbose=False),
           lgt.record_evaluation(ev)]
    if timed:
        cbs.append(_attach_timer)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1, "metric": METRICS,
              "verbosity": -1, **(extra or {})}
    t0 = time.perf_counter()
    bst = lgt.train(params, train, rounds, valid_sets=[valid],
                    callbacks=cbs)
    return bst, ev, time.perf_counter() - t0


def without_path_params(text: str) -> str:
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(PATH_PARAMS))


def fused_program(m):
    """The one captured program of a fused run."""
    progs = [p for p in m._programs.values() if p.graph is not None]
    if len(progs) != 1:
        raise AssertionError(f"expected one captured program, found "
                             f"{len(progs)}")
    return progs[0]


def phase_main_path(torch, lgt, lgt_kernels, train, valid):
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid)
    torch.cuda.synchronize()
    eager = lgt_kernels.launch_counts()
    m = bst._model
    prog = fused_program(m)
    iters = m.num_iterations_trained
    epochs = len(m.epoch_ms)
    k = max(2, min(25, ES_ROUNDS))
    if m.fetch_counts != {"epoch": epochs}:
        raise AssertionError(f"host fetches {m.fetch_counts} are not one "
                             f"per epoch ({epochs} epochs)")
    if prog.replays != k * epochs or iters > prog.replays:
        raise AssertionError(f"{prog.replays} replays for {epochs} epochs "
                             f"of {k} and {iters} iterations")
    # wrapper calls: the warm-up before capture and the capture, nothing
    # eager besides
    if prog.captured != PER_ITERATION or prog.warmup != PER_ITERATION \
            or eager != {kk: 2 * v for kk, v in PER_ITERATION.items()}:
        raise AssertionError(f"launches: captured {prog.captured}, warm-up "
                             f"{prog.warmup}, wrapper calls {eager}, "
                             f"expected {PER_ITERATION} each")
    device = {kk: prog.warmup[kk] + v for kk, v in prog.launches().items()}
    auc = ev["valid_0"]["auc"]
    best = bst.best_iteration
    best_auc = auc[best - 1]
    if not 0.5 < best_auc <= 1.0:
        raise AssertionError(f"valid AUC {best_auc}")
    steady = m.epoch_ms[1:] if epochs > 1 else m.epoch_ms
    emit({"phase": "main_path", "path": "super-epoch", "k": k,
          "iterations": iters, "best_iteration": best,
          "valid_auc": best_auc, "seconds": secs,
          "iterations_per_s": iters / secs, "epochs": epochs,
          "epoch_ms": m.epoch_ms,
          "steady_epoch_ms_median": statistics.median(steady),
          "steady_iterations_per_s": 1e3 * k / statistics.median(steady),
          "host_fetches": m.fetches, "graph_replays": prog.replays,
          "active_split_steps": sum(m.step_counts),
          "split_steps_launched": (prog.replays + 1) * (NUM_LEAVES - 1),
          "captured_launches_per_replay": prog.captured,
          "capture_ms": prog.capture_ms, "device_launches": device})
    return bst, ev, device, statistics.median(steady) / k


def phase_per_iteration(torch, lgt, lgt_kernels, train, valid, main_bst,
                        main_ev):
    """The same training on the per-iteration path, with the traced
    metrics so that it makes the same early-stopping decisions: the same
    model text and values, one fetch per tree and one per eval, and every
    kernel launched eagerly PER_ITERATION times per iteration."""
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, timed=True, extra={
        "superepoch": -1, "fused_chunk": 1, "fused_eval": "true"})
    torch.cuda.synchronize()
    launches = lgt_kernels.launch_counts()
    m = bst._model
    n = m.num_iterations_trained
    if launches != times(PER_ITERATION, n):
        raise AssertionError(f"per-iteration launches {launches} for {n} "
                             f"iterations, expected {PER_ITERATION} each")
    same = without_path_params(bst.model_to_string()) \
        == without_path_params(main_bst.model_to_string())
    if not same or ev != main_ev:
        raise AssertionError("per-iteration model text or evals differ "
                             "from the main path's")
    if m.fetch_counts != {"tree": n, "traced_eval": n} or m._programs and \
            any(p.graph is not None for p in m._programs.values()):
        raise AssertionError(f"per-iteration fetches {m.fetch_counts}")
    eval_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        bst.eval_valid()
        eval_s.append(time.perf_counter() - t0)
    emit({"phase": "per_iteration", "iterations": n, "seconds": secs,
          "iterations_per_s": n / secs,
          "phase_ms": m.phase_timer.totals_ms(),
          "host_fetches": m.fetch_counts, "model_text_equal": same,
          "launches": launches,
          "host_eval_ms_per_iteration": 1e3 * statistics.median(eval_s)})
    return 1e3 * secs / n, launches


def phase_fused_chunk(torch, lgt, lgt_kernels, train):
    """No valid set: 50 rounds as fused chunks of 25, against a
    per-iteration run; each run's launches are PER_ITERATION_NO_VALID per
    iteration (captured once and replayed, or eagerly).  Returns the
    fused run's device launches."""
    texts, info = {}, {}
    for name, extra in (("fused_chunk", {}),
                        ("per_iteration", {"superepoch": -1,
                                           "fused_chunk": 1})):
        params = {"objective": "binary", "num_leaves": NUM_LEAVES,
                  "max_bin": MAX_BIN, "learning_rate": 0.1,
                  "verbosity": -1, **extra}
        lgt_kernels.reset_launch_counts()
        t0 = time.perf_counter()
        bst = lgt.train(params, train, ROUNDS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        eager = lgt_kernels.launch_counts()
        m = bst._model
        n = m.num_iterations_trained
        texts[name] = without_path_params(bst.model_to_string())
        info[name] = {"seconds": secs, "iterations_per_s": ROUNDS / secs,
                      "host_fetches": m.fetch_counts}
        if name == "fused_chunk":
            prog = fused_program(m)
            device = {kk: prog.warmup[kk] + v
                      for kk, v in prog.launches().items()}
            info[name].update(graph_replays=prog.replays,
                              epoch_ms=m.epoch_ms,
                              capture_ms=prog.capture_ms,
                              captured_launches_per_replay=prog.captured,
                              launches=device)
            if m.fetch_counts != {"epoch": 2} or prog.replays != ROUNDS:
                raise AssertionError(f"fused chunks: {m.fetch_counts}, "
                                     f"{prog.replays} replays")
            # wrapper calls: the warm-up before capture and the capture
            if prog.captured != PER_ITERATION_NO_VALID \
                    or prog.warmup != PER_ITERATION_NO_VALID \
                    or eager != times(PER_ITERATION_NO_VALID, 2):
                raise AssertionError(
                    f"fused-chunk launches: captured {prog.captured}, "
                    f"warm-up {prog.warmup}, wrapper calls {eager}, "
                    f"expected {PER_ITERATION_NO_VALID} each")
        else:
            info[name]["launches"] = eager
            if eager != times(PER_ITERATION_NO_VALID, n):
                raise AssertionError(
                    f"per-iteration launches without a valid set {eager} "
                    f"for {n} iterations, expected "
                    f"{PER_ITERATION_NO_VALID} each")
    if texts["fused_chunk"] != texts["per_iteration"]:
        raise AssertionError("fused-chunk model text differs from the "
                             "per-iteration run's")
    emit({"phase": "fused_chunk", "rounds": ROUNDS, "model_text_equal": True,
          **info})
    return info["fused_chunk"]["launches"]


def phase_reference(torch, lgt):
    """The card's training against the port's CPU path on a small input."""
    x, y = make_higgs_like(20_000, N_FEAT, seed=7)
    xv, yv = make_higgs_like(5_000, N_FEAT, seed=8)
    preds, aucs = [], []
    for device in ("cuda", "cpu"):
        params = {"objective": "binary", "num_leaves": 15, "max_bin": MAX_BIN,
                  "metric": "auc", "verbosity": -1, "device_type": device}
        # the default path on both devices: a super-epoch of 10 replays on
        # the card, the same epoch run eagerly through the plain versions
        # on the CPU
        tr = lgt.Dataset(x, y)
        ev = {}
        bst = lgt.train(params, tr, 10,
                        valid_sets=[lgt.Dataset(xv, yv, reference=tr)],
                        callbacks=[lgt.record_evaluation(ev)])
        preds.append(bst.predict(xv))
        aucs.append(ev["valid_0"]["auc"][-1])
    diff = float(np.abs(preds[0] - preds[1]).mean())
    if not (np.isfinite(preds[0]).all() and preds[0].shape == (5_000,)):
        raise AssertionError("non-finite or misshapen predictions")
    if diff > 1e-3 or abs(aucs[0] - aucs[1]) > 2e-3:
        raise AssertionError(f"card vs CPU: mean |dp| {diff}, AUC {aucs}")
    emit({"phase": "reference", "mean_abs_pred_diff": diff,
          "auc_cuda": aucs[0], "auc_cpu": aucs[1]})


def phase_roundtrip(lgt, bst, train, valid, xv):
    pred = bst.predict(xv)
    if pred.shape != (N_VALID,) or not np.isfinite(pred).all() \
            or pred.min() <= 0.0 or pred.max() >= 1.0:
        raise AssertionError("predictions are not finite probabilities")
    text = bst.model_to_string()
    again = lgt.Booster(model_str=text).predict(xv)
    if not np.array_equal(pred, again):
        raise AssertionError("model text round trip changed predictions")
    bst2, _, secs = train_main(lgt, train, valid)
    same = bst2.model_to_string() == text
    if not same:
        raise AssertionError("a second training run gave other model text")
    emit({"phase": "roundtrip", "trees": bst.num_trees(),
          "model_text_bytes": len(text), "byte_identical_rerun": same,
          "rerun_seconds": secs})


def phase_profile(torch, lgt, train, valid):
    """One more main-path training under ``torch.profiler``: device time
    by kernel name, and the share of the steady epochs' wall time that
    the device is busy (kernel time per iteration over the epoch
    milliseconds per iteration)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst, _, secs = train_main(lgt, train, valid)
        torch.cuda.synchronize()
    m = bst._model
    prog = fused_program(m)

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, name, None)
            if v is not None:
                return float(v)
        return 0.0
    # device kernels only: not the host ops' attributed time nor the
    # dataset's upload, which happen outside the epochs
    kernels = sorted(((e.key, dev_us(e), e.count)
                      for e in prof.key_averages() if dev_us(e) > 0
                      and not e.key.startswith(("aten::", "Memcpy HtoD"))),
                     key=lambda r: -r[1])
    total_ms = sum(r[1] for r in kernels) / 1e3
    # the warm-up and every replay ran the body once each
    per_iter_ms = total_ms / (prog.replays + 1) if kernels else None
    steady = m.epoch_ms[1:]
    k = prog.replays // len(m.epoch_ms)
    busy = per_iter_ms * k / statistics.median(steady) \
        if kernels and steady else None
    emit({"phase": "profile", "seconds": secs,
          "device_kernel_ms_total": total_ms if kernels else None,
          "device_kernel_ms_per_iteration": per_iter_ms,
          "steady_epoch_ms": steady,
          "steady_busy_share": busy,
          "top_kernels": [{"name": n[:90], "device_ms": us / 1e3,
                           "count": c} for n, us, c in kernels[:20]]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import lightgbm_torch as lgt
    from lightgbm_torch import _kernels as lgt_kernels

    smi = phase_environment(torch, lgt_kernels)
    x, y, xv, yv, train, valid = phase_data(lgt)
    kernels = phase_kernels(torch, lgt, train, valid)
    bst, ev, counts, epoch_ms_per_it = phase_main_path(
        torch, lgt, lgt_kernels, train, valid)
    eager_ms_per_it, per_it_counts = phase_per_iteration(
        torch, lgt, lgt_kernels, train, valid, bst, ev)
    # B14, the captured iteration: its steady time per iteration against
    # the same body run eagerly (its plain version) and against the bound
    # of the work the main path's own trees needed
    b14_ms, b14_by, b14_bytes = iteration_bound(
        bst._model.models, N_TRAIN, N_FEAT, int(train.max_bin), NUM_LEAVES,
        N_VALID)
    emit({"phase": "fused_loop", "ms_per_iteration": epoch_ms_per_it,
          "plain_ms_per_iteration": eager_ms_per_it,
          "bound_ms_per_iteration": b14_ms, "bound_by": b14_by,
          "bound_bytes_per_iteration": b14_bytes, "library_ms": None})
    chunk_counts = phase_fused_chunk(torch, lgt, lgt_kernels, train)
    phase_reference(torch, lgt)
    phase_roundtrip(lgt, bst, train, valid, xv)
    phase_profile(torch, lgt, train, valid)
    emit({"kernels": [{**kernels[k], "launches": counts[k],
                       "launches_by_path": {
                           "main_path": counts[k],
                           "per_iteration": per_it_counts[k],
                           "fused_chunk": chunk_counts[k]}}
                      for k in KERNEL_ORDER]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
