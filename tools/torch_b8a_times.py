#!/usr/bin/env python3
"""Time and compare lightgbm_torch's B8a (``sparse_data.histogram``, the
k-hot histogram) of one or more checkouts of the repository on one CUDA
card, so that two versions of the kernel compare within one call and
their outputs byte for byte.

    python3 tools/torch_b8a_times.py [--no-train] [--sweep] ROOT [ROOT ...]

Each ROOT is a directory that holds ``lightgbm_torch`` and
``chip_smoke.py``; each runs in its own process, in the order given
(give parent, change, change, parent to see the spread).  In each, on
``chip_smoke.py``'s Allstate-shaped set (``make_allstate_like``, 1M rows
x 4,228 columns, 35 stored a row) and its sparse_kernels phase's vals
(seeded on the card):

- the phase's three whole trees (strict at 31 leaves, K = 16 at 255, K =
  8 at 64) are grown with the root's own grower, and every live B8a pass
  (the roots' included) is hashed (sha256 of its output bytes);
- each form (``root``, ``strict``: a mid-tree smaller child, ``k16`` and
  ``k8``: the super-step with the most slots in use) on those passes:
  the median ms of 20 calls after 3 warm-up calls (CUDA events around
  each), the device microseconds of each kernel a call (``torch.profiler``
  over 5 calls), the least time the card could take (``chip_smoke.py``
  ``khot_pass_bound``) and the median ms of one f32 ``index_add_`` of the
  same stored entries (``_khot_library``);
- without ``--no-train``: sparse_train (31 leaves, ``ROUNDS`` rounds) and
  sparse_wide_train (255 leaves with bagging and feature_fraction,
  ``CUT_ROUNDS`` rounds) as super-epochs of 10, as ``chip_smoke.py``
  trains them: the steady iterations/s (10 / median epoch ms after the
  first) and the sha256 of the model text;
- with ``--sweep`` (a checkout with ``sparse_data.root_plan``): the root
  pass at 0.5, 1, 2 and 4 times the planned row ranges, each timed and
  hashed against the planned one.

Each child prints JSON lines; the run ends with a ``compare`` line, and
exits with 1 when any pass or model text of a root differs from the first
root's.  The whole log goes to ``chiprun_out/b8a_times.jsonl`` and the
model texts to ``chiprun_out/b8a_models/``.  Without a CUDA card it exits
with 2.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

OUT = Path("chiprun_out")


def _median_ms(torch, call, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_us(torch, call, reps: int = 5) -> dict:
    """Device microseconds a call by kernel name (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0.0)
        if t:
            out[ev.key[:60]] = round(t / reps, 2)
    return out


def _digest(torch, t) -> str:
    torch.cuda.synchronize()
    return hashlib.sha256(t.detach().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def real_passes(torch, cs, lgt):
    """``chip_smoke.py``'s Allstate-shaped set and its sparse_kernels
    phase's vals on the card, and that phase's three trees grown with
    this process's grower: every live B8a pass hashed, and the forms'
    timed passes kept (as ``chip_smoke.py`` ``_grow_checked`` keeps them:
    a mid-tree strict child, the super-step with the most slots in use).
    Returns a dict of the set (``train``, ``sp``, ``vals``, ``B``), the
    digests by tree (``passes``), the forms' keyword arguments of
    ``sparse_data.histogram`` (``forms``) and the card (``card``)."""
    import numpy as np
    from lightgbm_torch import grower as gr
    from lightgbm_torch.ops.split import SplitParams

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    x, y_np = cs.make_allstate_like(cs.SPARSE_TRAIN, seed=50)
    train = lgt.Dataset(x, y_np, params=cs.SPARSE_DATA_PARAMS).construct()
    sp = train.binned_sparse.to_device(dev)
    n, F = sp.shape
    nb_np = np.asarray([train.bin_mappers[i].num_bin
                        for i in train.used_features], np.int32)
    na_np = np.asarray([train.bin_mappers[i].na_bin
                        for i in train.used_features], np.int32)
    B = int(nb_np.max())
    nb, na = (torch.as_tensor(a).to(dev) for a in (nb_np, na_np))
    fmask = torch.ones(F, dtype=torch.bool, device=dev)
    y = torch.as_tensor(np.asarray(train.metadata.label, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(50)
    pr = torch.sigmoid(0.3 * torch.randn(n, device=dev, generator=gen))
    vals = torch.stack([pr - y, pr * (1 - pr), torch.ones_like(y)], 1)
    params = SplitParams(min_data_in_leaf=20)

    hist_k = gr.compute_histogram
    passes, snaps = {}, {}
    for case, L, K in (("strict", cs.NUM_LEAVES, 1),
                       ("wide", cs.WIDE_LEAVES, cs.WIDE_K), ("k8", 64, 8)):
        digests, snap = [], {}

        def hist(binned, vals_, *, num_bins, slot=None, num_slots=None,
                 active=None, slots_used=None, rows_per_block=0):
            h = hist_k(binned, vals_, num_bins=num_bins, slot=slot,
                       num_slots=num_slots, active=active,
                       slots_used=slots_used, rows_per_block=rows_per_block)
            if active is not None and not bool(active[0]):
                return h
            digests.append(_digest(torch, h))
            if slot is not None and (
                    "slot" not in snap and len(digests) > L // 2
                    if num_slots is None
                    else int(slots_used[0]) > snap.get("used_n", 0)):
                snap.update(slot=slot.clone(), active=active.clone(),
                            used=None if slots_used is None
                            else slots_used.clone())
                if num_slots is not None:
                    snap["used_n"] = int(slots_used[0])
            return h
        gr.compute_histogram = hist
        try:
            ws = gr.GrowWorkspace(n, F, B, L, dev, split_batch=K)
            if K == 1:
                gr.grow_tree(sp, vals, fmask, nb, na, num_leaves=L,
                             num_bins=B, params=params, workspace=ws)
            else:
                gr.grow_tree_batched(sp, vals, fmask, nb, na, num_leaves=L,
                                     num_bins=B, params=params,
                                     split_batch=K, workspace=ws)
        finally:
            gr.compute_histogram = hist_k
        passes[case] = digests
        snaps[case] = snap
    one = torch.ones(1, dtype=torch.int32, device=dev)
    forms = {
        "root": dict(),
        "strict": dict(slot=snaps["strict"]["slot"],
                       active=snaps["strict"]["active"]),
        "k16": dict(slot=snaps["wide"]["slot"], num_slots=cs.WIDE_K,
                    active=one, slots_used=snaps["wide"]["used"]),
        "k8": dict(slot=snaps["k8"]["slot"], num_slots=8, active=one,
                   slots_used=snaps["k8"]["used"])}
    return {"train": train, "sp": sp, "vals": vals, "B": B,
            "passes": passes, "forms": forms, "card": smi}


def _child(root: str, train_cells: bool, sweep: bool) -> None:
    sys.path.insert(0, root)
    import torch
    import chip_smoke as cs
    import lightgbm_torch as lgt
    from lightgbm_torch import sparse_data as sd

    dev = torch.device("cuda", 0)
    rp = real_passes(torch, cs, lgt)
    train, sp, vals, B, smi = (rp[k] for k in ("train", "sp", "vals", "B",
                                                "card"))
    n, F = sp.shape
    passes = rp["passes"]
    _emit({"root": root, "what": "passes", "card": smi,
           "rows": n, "features": F, "k": sp.k, "stride": sp.stride,
           "bins": B, "live_passes": {c: len(d) for c, d in passes.items()},
           "digests": passes})

    for form, kw in rp["forms"].items():
        def call():
            return sd.histogram(sp, vals, num_bins=B, **kw)
        slot = kw.get("slot")
        S = kw.get("num_slots", 1)
        kept = n if slot is None else int(((slot >= 0) & (slot < S)).sum())
        bms, by = cs.khot_pass_bound(n, sp.k, F, B, kept, S,
                                     slot is not None)
        _emit({"root": root, "what": "form", "form": form,
               "rows_in_pass": kept, "slots": S,
               "slots_used": None if kw.get("slots_used") is None
               else int(kw["slots_used"][0]),
               "digest": _digest(torch, call()),
               "ms": _median_ms(torch, call),
               "device_us": _device_us(torch, call),
               "bound_ms": bms, "bound_by": by,
               "library_ms": cs._khot_library(torch, sp, vals, slot, S),
               "card": smi})

    if sweep and hasattr(sd, "root_plan"):
        planned = sd.root_plan
        tile_f, ranges = planned(n, F, sp.stride, torch.cuda
                                 .get_device_properties(dev)
                                 .multi_processor_count)
        want = _digest(torch, sd.histogram(sp, vals, num_bins=B))
        for mult in (0.5, 1, 2, 4):
            r = max(1, int(ranges * mult))
            sd.root_plan = lambda *a, _r=r, **k: (tile_f, _r)
            try:
                def call():
                    return sd.histogram(sp, vals, num_bins=B)
                got = _digest(torch, call())
                _emit({"root": root, "what": "sweep", "tile_f": tile_f,
                       "tiles": -(-F // tile_f), "ranges": r,
                       "bitwise_planned": got == want,
                       "ms": _median_ms(torch, call),
                       "device_us": _device_us(torch, call), "card": smi})
            finally:
                sd.root_plan = planned

    if train_cells:
        base = {"objective": "binary", "learning_rate": 0.1,
                "verbosity": -1}
        models = OUT / "b8a_models"
        models.mkdir(parents=True, exist_ok=True)
        tag = hashlib.sha256(root.encode()).hexdigest()[:8]
        for name, prm, rounds in (
                ("sparse_train", cs.SPARSE_PARAMS, cs.ROUNDS),
                ("sparse_wide_train", cs.WIDE_PARAMS, cs.CUT_ROUNDS)):
            bst = lgt.train({**base, **prm, "superepoch": 10,
                             "fused_chunk": rounds + 1}, train, rounds)
            torch.cuda.synchronize()
            m = bst._model
            steady = m.epoch_ms[1:] if len(m.epoch_ms) > 1 else m.epoch_ms
            ms_it = statistics.median(steady) / 10
            text = bst.model_to_string()
            (models / f"{name}-{tag}.txt").write_text(text)
            _emit({"root": root, "what": "train", "cell": name,
                   "rounds": rounds, "epoch_ms": m.epoch_ms,
                   "steady_ms_per_iteration": ms_it,
                   "steady_iterations_per_s": 1e3 / ms_it,
                   "model_sha256": hashlib.sha256(text.encode())
                   .hexdigest(), "model_file": f"{name}-{tag}.txt",
                   "card": smi})


def _compare(lines) -> dict:
    """Every root's pass digests, form digests and model texts against
    the first root's."""
    by_root = {}
    for ln in lines:
        by_root.setdefault(ln["root"], []).append(ln)
    roots = list(by_root)

    def key(ln):
        w = ln["what"]
        if w == "passes":
            return ("passes",), ln["digests"]
        if w == "form":
            return ("form", ln["form"]), ln["digest"]
        if w == "train":
            return ("train", ln["cell"]), ln["model_sha256"]
        return None, None
    ref = dict(key(ln) for ln in by_root[roots[0]] if key(ln)[0])
    differ = []
    for r in roots[1:]:
        got = dict(key(ln) for ln in by_root[r] if key(ln)[0])
        for k, v in ref.items():
            if k in got and got[k] != v:
                if k == ("passes",):
                    first = {c: next((i for i, (a, b) in enumerate(
                        zip(v[c], got[k][c])) if a != b), None)
                        for c in v}
                    differ.append({"root": r, "what": "passes",
                                   "first_differing": first})
                else:
                    differ.append({"root": r, "what": list(k)})
    sweep_ok = all(ln["bitwise_planned"] for ln in lines
                   if ln["what"] == "sweep")
    return {"what": "compare", "roots": roots, "differ": differ,
            "sweep_bitwise": sweep_ok,
            "bitwise_equal": not differ and sweep_ok}


def main() -> int:
    args = sys.argv[1:]
    if len(args) > 1 and args[0] == "--child":
        _child(args[1], "--no-train" not in args, "--sweep" in args)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_b8a_times: no CUDA card", file=sys.stderr)
        return 2
    flags = [a for a in args if a.startswith("--")]
    roots = [a for a in args if not a.startswith("--")]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    OUT.mkdir(exist_ok=True)
    lines = []
    with open(OUT / "b8a_times.jsonl", "w") as log:
        for root in roots:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child", os.path.abspath(root), *flags],
                               stdout=subprocess.PIPE, text=True)
            for ln in r.stdout.splitlines():
                log.write(ln + "\n")
                try:
                    obj = json.loads(ln)
                except ValueError:
                    print(ln)
                    continue
                if obj.get("what") != "passes":
                    print(ln, flush=True)
                lines.append(obj)
            if r.returncode != 0:
                print(f"torch_b8a_times: {root} failed ({r.returncode})",
                      file=sys.stderr)
                return r.returncode
        cmp = _compare(lines)
        log.write(json.dumps(cmp) + "\n")
    print(json.dumps(cmp), flush=True)
    return 0 if cmp["bitwise_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
