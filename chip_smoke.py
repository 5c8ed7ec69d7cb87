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
3. kernels: B1-B4 at the main path's shapes, each held against its plain
   PyTorch version on the card (B3 and B4 bit for bit, B1 and B2 within the
   tolerances below; B3 from the root and from a mid-tree state with an NA
   bin, B2 field by field with each regularisation term on in turn, B4
   with NA bins), with the kernel's, the plain version's and (B1) the
   library call's median times from CUDA events, and the bound from the
   bytes and operations of this run's inputs;
4. main path: ``lightgbm_torch.train`` (binary, 31 leaves, 63 bins, 50
   rounds, one valid set, early stopping) with iterations/s, per-phase
   milliseconds, host fetches per split, the valid AUC, and the launch
   count of every kernel during that run against the count the trees
   predict;
5. reference: on a small input, training on the card agrees with the
   port's CPU path (plain versions);
6. round trip and determinism: predict, model text -> Booster -> equal
   predictions, and a second training run gives byte-identical model text.

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

    # B3 at the root split of feature 0, threshold mid-range
    lor = torch.zeros(n, dtype=torch.int32, device=dev)
    iota = torch.arange(B, dtype=torch.int32, device=dev)
    thr = int(num_bin[0].item()) // 2
    args = (0, thr, False, int(na_bin[0].item()), iota, 0, 1, 1)
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
        margs = (feat, int(num_bin[feat].item()) // 2, dleft, na, rank, 5,
                 17, smaller)
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
    dl = torch.as_tensor(rng.rand(nodes) < 0.5).to(dev)
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


def train_main(lgt, train, valid, timed: bool):
    ev = {}
    cbs = [lgt.early_stopping(ES_ROUNDS, verbose=False),
           lgt.record_evaluation(ev)]
    if timed:
        cbs.append(_attach_timer)
    params = {"objective": "binary", "num_leaves": NUM_LEAVES,
              "max_bin": MAX_BIN, "learning_rate": 0.1, "metric": "auc",
              "verbosity": -1}
    t0 = time.perf_counter()
    bst = lgt.train(params, train, ROUNDS, valid_sets=[valid],
                    callbacks=cbs)
    return bst, ev, time.perf_counter() - t0


def phase_main_path(torch, lgt, lgt_kernels, train, valid):
    lgt_kernels.reset_launch_counts()
    bst, ev, secs = train_main(lgt, train, valid, timed=True)
    torch.cuda.synchronize()
    counts = lgt_kernels.launch_counts()
    m = bst._model
    iters = m.num_iterations_trained
    splits = sum(m.step_counts)
    expect = {"histogram": iters + splits, "split": iters + splits,
              "partition": splits, "predict": iters}
    if counts != expect:
        raise AssertionError(f"kernel launches {counts} != expected {expect}")
    auc = ev["valid_0"]["auc"]
    best = bst.best_iteration
    best_auc = auc[best - 1]
    if not 0.5 < best_auc <= 1.0:
        raise AssertionError(f"valid AUC {best_auc}")
    eval_s = []
    for _ in range(5):
        t0 = time.perf_counter()
        bst.eval_valid()
        eval_s.append(time.perf_counter() - t0)
    emit({"phase": "main_path", "iterations": iters,
          "best_iteration": best, "valid_auc": best_auc,
          "seconds": secs, "iterations_per_s": iters / secs,
          "phase_ms": m.phase_timer.totals_ms(),
          "valid_eval_ms_per_iteration": 1e3 * statistics.median(eval_s),
          "splits": splits, "host_fetches": m.grow_stats.fetches,
          "host_fetches_per_split": m.grow_stats.fetches / max(splits, 1),
          "launches": counts})
    return bst, counts


def phase_reference(torch, lgt):
    """The card's training against the port's CPU path on a small input."""
    x, y = make_higgs_like(20_000, N_FEAT, seed=7)
    xv, yv = make_higgs_like(5_000, N_FEAT, seed=8)
    preds, aucs = [], []
    for device in ("cuda", "cpu"):
        params = {"objective": "binary", "num_leaves": 15, "max_bin": MAX_BIN,
                  "metric": "auc", "verbosity": -1, "device_type": device}
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
    bst2, _, secs = train_main(lgt, train, valid, timed=False)
    same = bst2.model_to_string() == text
    if not same:
        raise AssertionError("a second training run gave other model text")
    emit({"phase": "roundtrip", "trees": bst.num_trees(),
          "model_text_bytes": len(text), "byte_identical_rerun": same,
          "rerun_seconds": secs})


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
    bst, counts = phase_main_path(torch, lgt, lgt_kernels, train, valid)
    phase_reference(torch, lgt)
    phase_roundtrip(lgt, bst, train, valid, xv)
    emit({"kernels": [{**kernels[k], "launches": counts[k]}
                      for k in ("histogram", "split", "partition",
                                "predict")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
