"""One boosting iteration on static device tensors, replayed as a CUDA
graph: the port's counterpart of the JAX package's fused programs (B14,
``models/gbdt.py`` ``_fused_chunk_fn`` :1529 and
``_build_superepoch_body`` :1938).

The JAX package runs k iterations in one ``lax.scan``.  Here one
iteration — gradients, the device-resident tree build (B1-B3s), the f32
shrinkage, the train-score update, each valid set's tree walk (B4), the
traced metrics (B12) and the early-stop vote — is ``IterationProgram.body``
over tensors allocated once.  On the card the body is captured once as a
``torch.cuda.CUDAGraph`` and an epoch of k iterations is k replays: the
iteration index lives in a device counter (``row``), and each iteration
writes its outputs to row ``row`` of the static ``out`` buffer (its tree
buffer, shrunk leaf values, eval values and stop flag, packed in int32
words), which the host fetches in one copy per epoch.  On the CPU (the
tests) the same body runs uncaptured through the kernels' plain versions,
with the same fetch count.  The per-iteration path runs the same body
eagerly for one row, so both paths run the same kernels with the same
launch shapes and give the same bits.

Semantics follow the JAX scan body: ``dead`` (a stump was grown this
epoch) and ``stop`` (the early-stop vote tripped) block every later
iteration's contribution to the scores; the vote is update-then-check of
``callback.early_stopping`` at ``min_delta == 0``.  The JAX package
re-evaluates its reported metrics after the scan because XLA may fuse a
reduction differently inside it; the port's metric kernels sum in an
order fixed by the shapes, so the in-graph values are reported directly
(tests/test_torch_fused.py pins them to the ``fused_eval=true``
per-iteration values).

A failed capture, build or launch raises; nothing falls back to eager
launches, the plain versions or the CPU.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..grower import grow_tree, tree_fields, tree_words
from ..metrics import build_traced_eval
from ..predict_device import add_tree_score


class IterationProgram:
    """The body of one boosting iteration for one model and one eval spec
    (``(valid_idx, set_name, metric, higher_better)`` entries) and
    early-stop spec, with the static buffers it writes, and its CUDA graph
    once captured."""

    def __init__(self, model, eval_spec: Tuple = (), es_spec=None,
                 rows: int = 1):
        m = self.model = model
        dev = m.device
        self.eval_spec = tuple(eval_spec)
        self.es_spec = es_spec
        L = m.config.num_leaves
        self.W, self.L, self.E = tree_words(L), L, len(self.eval_spec)
        self.width = self.W + L + self.E + 1
        self.rows = 0
        self.out = torch.empty(0)
        self._ensure_rows(rows)
        # one row of outputs, copied to out[row] at the end of the body
        self.cur = torch.zeros(self.width, dtype=torch.int32, device=dev)
        W, E = self.W, self.E
        self.cur_tree = self.cur[:W]
        self.cur_lv = self.cur[W:W + L].view(torch.float32)
        self.cur_ev = self.cur[W + L:W + L + E].view(torch.float32)
        self.cur_stop = self.cur[W + L + E:]
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        self.es_base = torch.zeros((), dtype=torch.int32, device=dev)
        self.dead = torch.zeros((), dtype=torch.bool, device=dev)
        self.zero = torch.zeros((), dtype=torch.float32, device=dev)
        self.teval = build_traced_eval(self.eval_spec, m.config) \
            if self.E else None
        if es_spec is not None:
            self.es_rounds = int(es_spec["stopping_rounds"])
            self.es_elig = torch.as_tensor(
                np.asarray(es_spec["eligible"], bool)).to(dev)
            self.es_hib = torch.as_tensor(np.asarray(
                [hib for (_, _, _, hib) in self.eval_spec], bool)).to(dev)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.captured: Dict[str, int] = {}
        self.warmup: Dict[str, int] = {}
        self.replays = 0
        # host milliseconds of the warm-up run and of the capture
        self.capture_ms: Dict[str, float] = {}

    def _ensure_rows(self, rows: int) -> None:
        if rows > self.rows:
            self.out = torch.zeros((rows, self.width), dtype=torch.int32,
                                   device=self.model.device)
            self.rows = rows
            self.graph = None       # the graph wrote the old buffer

    # -- the iteration -----------------------------------------------------
    def body(self, gh=None, mark=None) -> None:
        """One boosting iteration, entirely on the device.  ``gh``: host
        gradients (custom objective, per-iteration path only); ``mark``:
        the model's phase marker (per-iteration path only)."""
        m = self.model
        cfg = m.config
        mark = mark or (lambda phase: None)
        stop = m.es_state[3] if self.es_spec is not None else None
        blocked = self.dead.clone() if stop is None else self.dead | stop
        mark("gradients")
        g, h = m.objective.get_gradients(m.score) if gh is None else gh
        # (grad*w, hess*w, w) with w = 1: no bagging/GOSS in this slice
        vals = torch.stack([g, h, torch.ones_like(g)], dim=1)
        mark("grow")
        arrays = grow_tree(m.binned_dev, vals, m.feature_mask,
                           m.num_bin_dev, m.na_bin_dev,
                           num_leaves=cfg.num_leaves, num_bins=m.max_bin,
                           params=m.split_params, max_depth=cfg.max_depth,
                           workspace=m.grow_ws)
        mark("score")
        nl = arrays.num_leaves[0]
        lv = m.shrink(arrays.leaf_value)
        ok = ~blocked & (nl > 1)
        lv_ok = torch.where(ok, lv, self.zero)
        m.score.add_(lv_ok.index_select(0, arrays.leaf_of_row))
        torch.logical_or(self.dead, nl <= 1, out=self.dead)
        mark("valid")
        for _, vbinned, vscore in m.valid_sets:
            add_tree_score(vscore, vbinned, arrays.split_feature,
                           arrays.threshold_bin, arrays.default_left,
                           arrays.left_child, arrays.right_child,
                           m.na_bin_dev, lv_ok, 1.0, steps=m.walk_steps)
        if self.E:
            ev = self.teval([vs for _, _, vs in m.valid_sets],
                            [m.valid_ops(vi)
                             for vi in range(len(m.valid_sets))])
            self.cur_ev.copy_(ev)
            if self.es_spec is not None:
                self._vote(ev, blocked)
        mark("")
        self.cur_tree.copy_(m.grow_ws.tree)
        self.cur_lv.copy_(lv)
        if stop is not None:
            self.cur_stop.copy_(stop)
        self.out.index_copy_(0, self.row, self.cur[None])
        self.row.add_(1)

    def _vote(self, ev: torch.Tensor, blocked: torch.Tensor) -> None:
        """callback.early_stopping's update-then-check, traced
        (min_delta == 0): entries outside ``eligible`` update their best
        but never trip."""
        esb, esi, esh, stop = self.model.es_state
        eit = self.es_base + self.row[0].to(torch.int32)
        fin = torch.isfinite(ev)
        better = torch.where(self.es_hib, ev > esb, ev < esb)
        improved = fin & (~esh | better) & ~blocked
        esb.copy_(torch.where(improved, ev, esb))
        esi.copy_(torch.where(improved, eit, esi))
        esh.logical_or_(improved)
        trip = self.es_elig & ((eit - esi) >= self.es_rounds) & ~blocked
        stop.logical_or_(trip.any())

    # -- running it ----------------------------------------------------------
    def _mutable(self) -> List[torch.Tensor]:
        """Every tensor the body changes that outlives it."""
        m = self.model
        ts = [m.score, self.dead, self.row]
        ts += [vs for _, _, vs in m.valid_sets]
        if self.es_spec is not None:
            ts += list(m.es_state)
        return ts

    def _capture(self) -> None:
        """Capture the body as a CUDA graph.  The kernels are built and
        loaded first and the body runs once eagerly on a side stream (so
        lazy initialisation happens outside the capture); the state it
        changed is then restored.  The capture runs on the side stream
        through ``capture_begin``/``capture_end``, without the
        ``torch.cuda.graph`` context's garbage collection and cache
        emptying, which cost more than the capture itself."""
        _kernels.load_all()
        t0 = time.perf_counter()
        saved = [t.clone() for t in self._mutable()]
        before = _kernels.launch_counts()
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.body()
        main.wait_stream(side)
        for t, s in zip(self._mutable(), saved):
            t.copy_(s)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mid = _kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                self.body()
            finally:
                graph.capture_end()
        main.wait_stream(side)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = _kernels.launch_counts()
        self.warmup = {k: mid[k] - before[k] for k in mid}
        self.captured = {k: after[k] - mid[k] for k in after}
        self.capture_ms = {"warmup": 1e3 * (t1 - t0),
                           "capture": 1e3 * (t2 - t1)}
        self.graph = graph

    def run(self, k: int, es_it0: int = 0, *, eager: bool,
            gh=None, mark=None) -> torch.Tensor:
        """Run k iterations into ``out[:k]`` and return that (device)
        slice.  ``eager``: call the body (the per-iteration path, and every
        path on the CPU); else replay the captured graph (CUDA only)."""
        self._ensure_rows(k)
        self.row.zero_()
        self.dead.zero_()
        self.es_base.fill_(int(es_it0))
        if eager:
            for _ in range(k):
                self.body(gh, mark)
        else:
            if self.model.device.type != "cuda":
                raise ValueError("graph replay needs a CUDA device")
            if self.graph is None:
                self._capture()
            for _ in range(k):
                self.graph.replay()
            self.replays += k
        return self.out[:k]

    def launches(self) -> Dict[str, int]:
        """Kernel launches on the device so far through this program's
        graph: captured launches times replays (the warm-up's eager
        launches are in ``_kernels.LAUNCHES``)."""
        return {k: n * self.replays for k, n in self.captured.items()}

    def row_fields(self, rows: torch.Tensor, j: int) -> Dict[str, object]:
        """Views of row j of a fetched or device ``out`` block: the tree
        fields, ``lv`` (shrunk leaf values), ``ev`` and ``stop``."""
        r = rows[j]
        W, L, E = self.W, self.L, self.E
        f32 = torch.float32 if isinstance(r, torch.Tensor) else np.float32
        out = tree_fields(r[:W], L)
        out["lv"] = r[W:W + L].view(f32)
        out["ev"] = r[W + L:W + L + E].view(f32)
        out["stop"] = r[W + L + E]
        return out
