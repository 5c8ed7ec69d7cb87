"""One boosting iteration on static device tensors, replayed as a CUDA
graph: the port's counterpart of the JAX package's fused programs (B14,
``models/gbdt.py`` ``_fused_chunk_fn`` :1529 and
``_build_superepoch_body`` :1938).

The JAX package runs k iterations in one ``lax.scan``.  Here one
iteration — gradients, the row weights (B6: the bagging draw or GOSS),
the device-resident tree build (the strict grower B1-B3s, or the batched
one B1-K/B3-K/B3s-K from ``split_batch`` 2 on, with the per-node draws
B6-node, B9 on an EFB-bundled matrix, B7 with the integer B1/B1-K
under ``quant_train``, and the k-hot histogram B8a with the k-hot decode
in B3/B3-K on sparse binned storage, the split controls inside B2,
B3s/B3s-K and B6-node), the f32 shrinkage, the
train-score update, each valid set's tree walk (B4), the traced metrics
(B12) and the early-stop vote — is
``IterationProgram.body`` over tensors allocated once.  The
iteration that keys the bagging, GOSS and per-node draws (and the
stochastic rounding of quantized training) and the
feature_fraction mask come from device tensors set before the first
replay (``it0``, ``fmasks``) and the row counter, so every replay draws
its own; CEGB's used features (the workspace's ``cuse``) are set from
the host state before the first replay and carried from replay to
replay by the trees that mark them.  On the card the body is captured
once as a ``torch.cuda.CUDAGraph`` and an epoch of k iterations is k replays: the
iteration index lives in a device counter (``row``), and each iteration
writes its outputs to row ``row`` of the static ``out`` buffer (its tree
buffer, shrunk leaf values, eval values and stop flag, packed in int32
words), which the host fetches in one copy per epoch.  On the CPU (the
tests) the same body runs uncaptured through the kernels' plain versions,
with the same fetch count.  The per-iteration path runs the same body
eagerly for one row, so both paths run the same kernels with the same
launch shapes and give the same bits.

A multiclass model (K trees an iteration) never fuses: the JAX package
grows its class trees in its host loop (``train_one_iter`` :2554-2935),
and so does the port, through ``IterationProgram.body`` run eagerly for
one iteration.  That body takes the [N, K] gradients once, then grows
class k's tree on column k for k = 0..K-1 on one feature_fraction mask
and one iteration key (so the bagging draw is the same mask for every
class, GOSS runs on each class's g and h, and the per-node draws repeat),
and writes the K trees to K rows of ``out``: one host fetch an
iteration.  A class's stump adds nothing and does not stop the later
classes.

Semantics follow the JAX scan body: ``dead`` (a stump was grown this
epoch) and ``stop`` (the early-stop vote tripped) block every later
iteration's contribution to the scores; the vote is update-then-check of
``callback.early_stopping`` at ``min_delta == 0``.  The JAX package
re-evaluates its reported metrics after the scan because XLA may fuse a
reduction differently inside it; the port's metric kernels sum in an
order fixed by the shapes, so the in-graph values are reported directly
(tests/test_torch_fused.py pins them to the ``fused_eval=true``
per-iteration values).

A model on the partitioned learner (``grower_partitioned.py``: forced
splits, monotone ``intermediate``/``advanced``, or ``tpu_learner=
partitioned``) runs the body eagerly only, as the JAX package runs it in
its host loop: its tree comes from the host-orchestrated split loop
(B11a-c, B2 and one host sync a split), which takes the iteration's
feature_fraction mask from the host copy of ``fmasks`` and the device
iteration ``it_cur`` for the quantizer's key; the rest of the body is
the same.

An objective that renews its leaf values (l1, quantile, mape) runs the
body eagerly only: after growth it calls ``model.renew_leaves``, which
fetches the tree and the score, renews the values on the host and
returns them for the score update and the valid walks.

A fleet (``FleetProgram``, the JAX package's ``build_fleet_superepoch``
:2184) runs N members' iterations in lockstep in one body: each member's
phases of ``IterationProgram.body`` on its own tensors, with the passes
that read the shared matrices (B1-M, B3-M and their K-slot and integer
forms in the growers, B4-M on each valid set) launched once for all
members.  One graph replay is one iteration of every member, and the
epoch's rows of every member come back in one fetch.

With the computation-integrity layer on (``integrity_check_freq`` > 0,
``model._integrity``; the per-iteration loop only, as in the JAX
package's ``train_one_iter`` :2685-2753, :2860-2880) each tree's growth
is the checked grow (``_grow_checked``): the primary grow, the
``hist_sdc`` injection site on its ``leaf_count[0]`` word, the tree
invariants (B17a), on check iterations the shadow grow
(``grower.make_shadow_grower``: the grower's kernels from their second,
separately built libraries), one fetch of the tree words, the flag and
the shadow's words, and ``IntegrityChecker.verify_grow`` (a mismatch is
grown once more, primary and shadow); then the score update takes a
materialised delta, the ``score_sdc`` site, and on check iterations
``verify_score`` (B17b).  An armed injection site fires on the unchecked
path too, as in the JAX package.  Without the layer and without armed
sites the iteration is unchanged.

A failed capture, build or launch raises; nothing falls back to eager
launches, the plain versions or the CPU.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..grower import (GrowMember, grow_tree, grow_tree_batched,
                      grow_trees_lockstep, tree_fields, tree_words)
from ..integrity import invariant_flags
from ..metrics import build_traced_eval
from ..ops.random import bag_vals, goss_buffers, goss_vals
from ..predict_device import add_tree_score, add_tree_score_members, \
    walk_maps
from ..utils import faultinject


def _no_mark(phase: str) -> None:
    """The phase marker of a run that times no phase."""


def capture_graph(body, mutable):
    """Capture ``body()`` as a CUDA graph; ``mutable()`` lists every tensor
    the body changes that outlives it.  The kernels are built and loaded
    first and the body runs once eagerly on a side stream (so lazy
    initialisation happens outside the capture); the state it changed is
    then restored.  The capture runs on the side stream through
    ``capture_begin``/``capture_end``, without the ``torch.cuda.graph``
    context's garbage collection and cache emptying, which cost more than
    the capture itself; Python's cyclic collector is held off during the
    capture instead, so that the graph of an earlier, unreachable program
    is never destroyed on the capturing stream (which would invalidate
    the capture).  Returns (graph, the warm-up's launch counts, the
    captured launch counts, host ms of the warm-up and the capture)."""
    _kernels.load_all()
    t0 = time.perf_counter()
    saved = [t.clone() for t in mutable()]
    before = _kernels.launch_counts()
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        body()
    main.wait_stream(side)
    for t, s in zip(mutable(), saved):
        t.copy_(s)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mid = _kernels.launch_counts()
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(main)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                body()
            finally:
                graph.capture_end()
    finally:
        if collecting:
            gc.enable()
    main.wait_stream(side)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    after = _kernels.launch_counts()
    warmup = {k: mid[k] - before[k] for k in mid}
    captured = {k: after[k] - mid[k] for k in after}
    return graph, warmup, captured, {"warmup": 1e3 * (t1 - t0),
                                     "capture": 1e3 * (t2 - t1)}


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
        # the histogram passes' row block its launches (and graph) take
        self.rows_per_block = m.grow_ws.rows_per_block
        L = m.config.num_leaves
        # trees an iteration, one output row each
        self.K = m.num_class
        self.cat_bins = m.grow_ws.cat_bins
        self.W, self.L, self.E = tree_words(L, self.cat_bins), L, \
            len(self.eval_spec)
        self.width = self.W + L + self.E + 1
        self.rows = 0
        self.out = torch.empty(0)
        self._ensure_rows(rows * self.K)
        # one row of outputs, copied to out[row] at the end of the body
        self.cur = torch.zeros(self.width, dtype=torch.int32, device=dev)
        W, E = self.W, self.E
        self.cur_tree = self.cur[:W]
        self.cur_lv = self.cur[W:W + L].view(torch.float32)
        self.cur_ev = self.cur[W + L:W + L + E].view(torch.float32)
        self.cur_stop = self.cur[W + L + E:]
        self.row = torch.zeros(1, dtype=torch.int64, device=dev)
        # sampling: the epoch's first iteration (the iteration that keys
        # the bagging, GOSS and per-node draws is it0 + row) and the
        # feature_fraction mask of the current row, selected from
        # ``fmasks`` [rows, F]
        self.it0 = torch.zeros(1, dtype=torch.int32, device=dev)
        self.it_cur = torch.zeros(1, dtype=torch.int32, device=dev)
        self.goss = m._goss
        self.bagging = m._use_bagging
        # quant: the iteration keys the stochastic rounding, so fused and
        # per-iteration runs quantize identically (the JAX package's
        # models/gbdt.py:1584-1588)
        self.keyed = self.goss or self.bagging \
            or m.node_sampling is not None or m.quant is not None
        self.sample_features = m.config.feature_fraction < 1.0
        self.fmask_cur = torch.ones((1, m.num_features), dtype=torch.bool,
                                    device=dev)
        # the partitioned learner's host copy of the iteration's mask (it
        # runs one iteration a run)
        self.fmask_host = np.ones(m.num_features, bool)
        self.vals = torch.zeros((m.num_data, 3), dtype=torch.float32,
                                device=dev) \
            if self.bagging or self.goss else None
        self.goss_buffers = goss_buffers(m.num_data, dev) \
            if self.goss else None
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
            dev = self.model.device
            self.out = torch.zeros((rows, self.width), dtype=torch.int32,
                                   device=dev)
            self.fmasks = torch.ones((rows, self.model.num_features),
                                     dtype=torch.bool, device=dev)
            self.rows = rows
            self.graph = None       # the graph used the old buffers

    # -- the iteration -----------------------------------------------------
    def body(self, gh=None, mark=None) -> None:
        """One boosting iteration, entirely on the device.  ``gh``: host
        gradients (custom objective, per-iteration path only); ``mark``:
        the model's phase marker (per-iteration path only).  Its phases
        (``_begin``, ``_vals``, ``_grow``, ``_apply``, ``_walk_valid``,
        ``_finish``) are the ones ``FleetProgram.body`` runs for each
        member."""
        if self.K > 1:
            self._body_multiclass(gh, mark)
            return
        mark = mark or _no_mark
        blocked, stop, g, h, fmask = self._begin(gh, mark)
        vals = self._vals(g, h)
        mark("grow")
        arrays, check = self._grown(vals, fmask, mark)
        lv, lv_ok = self._apply(arrays, blocked, mark, check)
        mark("valid")
        self._walk_valid(arrays, lv_ok)
        self._finish(lv, blocked, stop, mark)

    def _begin(self, gh=None, mark=_no_mark):
        """The iteration's start: the blocked flag (a stump this epoch or
        the tripped vote), the gradients, the device iteration ``it_cur``
        and the feature_fraction mask of the current row.  Returns
        (blocked, stop, g, h, fmask)."""
        m = self.model
        stop = m.es_state[3] if self.es_spec is not None else None
        blocked = self.dead.clone() if stop is None else self.dead | stop
        mark("gradients")
        g, h = m.objective.get_gradients(m.score) if gh is None else gh
        # (grad*w, hess*w, w): w the GOSS weights or the in-bag mask of
        # this iteration (B6), keyed by the device iteration it0 + row, or
        # 1 without sampling
        if self.keyed:
            torch.add(self.it0, self.row.to(torch.int32), out=self.it_cur)
        fmask = m.feature_mask
        if self.sample_features:
            torch.index_select(self.fmasks, 0, self.row, out=self.fmask_cur)
            fmask = self.fmask_cur[0]
        return blocked, stop, g, h, fmask

    def _vals(self, g, h) -> torch.Tensor:
        """The row weights of g, h (B6: GOSS, the bagging draw, or none)
        keyed by ``it_cur``: the [N, 3] (grad*w, hess*w, w)."""
        m = self.model
        if self.goss:
            return goss_vals(g.contiguous(), h.contiguous(), self.it_cur,
                             out=self.vals, buffers=self.goss_buffers,
                             **m.goss_args())
        if self.bagging:
            return bag_vals(g.contiguous(), h.contiguous(), self.it_cur,
                            out=self.vals, **m.bagging_args())
        return torch.stack([g, h, torch.ones_like(g)], dim=1)

    def grow_member(self, vals, fmask) -> GrowMember:
        """This model's operands of the fleet's lockstep grower."""
        m = self.model
        return GrowMember(ws=m.grow_ws, vals=vals, feature_mask=fmask,
                          params=m.split_params,
                          max_depth=m.config.max_depth,
                          sampling=m.node_sampling,
                          rng_iter=self.it_cur if self.keyed else None)

    def _grow(self, vals, fmask):
        """One tree from the grower (B1-B3s, or B1-K/B3-K/B3s-K, with the
        per-node draws B6-node, and B9 on an EFB-bundled matrix; or the
        partitioned learner, on the host mask)."""
        m = self.model
        if m.partitioned is not None:
            return m.partitioned.grow(
                m.binned_dev, vals, self.fmask_host, is_cat=m.is_cat_dev,
                forced=m.forced, cegb_state=m.cegb,
                rng_iter=self.it_cur if m.quant is not None else None,
                workspace=m.grow_ws)
        grow, kw = self._grower()
        return grow(m.binned_dev, vals, fmask, m.num_bin_dev,
                    m.na_bin_dev, workspace=m.grow_ws, **kw)

    def _grower(self):
        """The masked learner's grower and its keyword arguments but the
        workspace: ``(grow_tree or grow_tree_batched, kwargs)``, or a
        distributed learner's ``grow`` (``parallel/``)."""
        m = self.model
        cfg = m.config
        grow = grow_tree if m.split_batch == 1 else grow_tree_batched
        kw = {} if m.split_batch == 1 else {"split_batch": m.split_batch}
        if m.dist_grower is not None:
            # a distributed learner's grow (its hooks, its K)
            grow, kw = m.dist_grower, {}
        if self.keyed:
            kw["rng_iter"] = self.it_cur
        if m.node_sampling is not None:
            kw["sampling"] = m.node_sampling
        if m.quant is not None:
            kw["quant"] = m.quant
        if m.is_cat_dev is not None:
            kw["is_cat"] = m.is_cat_dev
        if m.efb_dev is not None:
            kw["efb"] = m.efb_dev
        if m.constraints is not None:
            kw["constraints"] = m.constraints
        kw.update(num_leaves=cfg.num_leaves, num_bins=m.max_bin,
                  params=m.split_params, max_depth=cfg.max_depth)
        return grow, kw

    def _grown(self, vals, fmask, mark=_no_mark):
        """The iteration's tree: ``_grow``, or the checked grow with the
        integrity layer on (``_grow_checked``); an armed ``hist_sdc``
        site flips a bit of its ``leaf_count[0]`` word.  Returns (arrays,
        whether this is a check iteration)."""
        m = self.model
        if m._integrity is not None:
            return self._grow_checked(vals, fmask, mark)
        arrays = self._grow(vals, fmask)
        if faultinject.enabled():
            faultinject.maybe_bitflip("hist_sdc", arrays.leaf_count, index=0)
        return arrays, False

    def _grow_checked(self, vals, fmask, mark=_no_mark):
        """The checked grow (module docstring): the primary grow and the
        ``hist_sdc`` site, B17a on its tree buffer, on check iterations
        the shadow grow from the same operands (CEGB's used features as
        the primary's tree started from them), one fetch of the three,
        and ``verify_grow``, whose re-run grows the primary again into
        its workspace.  Returns (the primary's arrays, whether this is a
        check iteration)."""
        m = self.model
        ichk = m._integrity
        ws = m.grow_ws
        it = m.it_global
        grow, kw = self._grower()
        args = (m.binned_dev, vals, fmask, m.num_bin_dev, m.na_bin_dev)
        cuse0 = ws.cuse.clone() if ws.cons is not None else None

        def primary():
            if cuse0 is not None:
                ws.cuse.copy_(cuse0)
            arrays = grow(*args, workspace=ws, **kw)
            if faultinject.enabled():
                faultinject.maybe_bitflip("hist_sdc", arrays.leaf_count,
                                          index=0)
            return ws.tree, invariant_flags(ws.tree, self.L)

        def shadow():
            return ichk.shadow_fn.grow(grow, *args, cuse=cuse0, **kw)

        tree, flag = primary()
        mark("integrity")
        check = ichk.should_check(it)
        sh = shadow() if check else None
        host, inv_ok, shadow_host = ichk.fetch(m, "integrity", tree, flag,
                                               sh)
        ichk.verify_grow(m, it, primary, shadow, host, inv_ok, shadow_host)
        return ws.arrays(), check

    def _add_score(self, score, lv_ok, leaf_of_row, check: bool) -> None:
        """``score += lv_ok[leaf_of_row]`` (the primary gather).  With the
        integrity layer on or injection armed the delta is materialised:
        the ``score_sdc`` site, then on check iterations ``verify_score``
        (B17b), which may hand back a re-gathered delta."""
        m = self.model
        if m._integrity is None and not faultinject.enabled():
            score.add_(lv_ok.index_select(0, leaf_of_row))
            return
        delta = lv_ok.index_select(0, leaf_of_row)
        if faultinject.enabled():
            faultinject.maybe_bitflip("score_sdc", delta)
        if check:
            delta = m._integrity.verify_score(m, lv_ok, leaf_of_row, delta,
                                              m.it_global)
        score.add_(delta)

    def _apply(self, arrays, blocked, mark=_no_mark, check: bool = False):
        """The tree's shrunk (or renewed) leaf values ``lv``, and the
        train-score update by ``lv_ok`` (zero when blocked or a stump),
        which latches ``dead`` on a stump; ``check``: a check iteration
        of the integrity layer (``_add_score``).  Returns (lv, lv_ok)."""
        m = self.model
        nl = arrays.num_leaves[0]
        if m.objective is not None and m.objective.need_renew_tree_output:
            # per-iteration only: the leaf values renewed on the host
            mark("renew")
            lv = m.renew_leaves(arrays)
        else:
            lv = m.shrink(arrays.leaf_value)
        mark("score")
        ok = ~blocked & (nl > 1)
        lv_ok = torch.where(ok, lv, self.zero)
        self._add_score(m.score, lv_ok, arrays.leaf_of_row, check)
        torch.logical_or(self.dead, nl <= 1, out=self.dead)
        return lv, lv_ok

    def _walk_valid(self, arrays, lv_ok) -> None:
        """Every valid score += the tree's walk (B4)."""
        m = self.model
        for _, vbinned, vscore in m.valid_sets:
            add_tree_score(vscore, vbinned, arrays.split_feature,
                           arrays.threshold_bin, arrays.default_left,
                           arrays.left_child, arrays.right_child,
                           m.na_bin_dev, lv_ok, 1.0, steps=m.walk_steps,
                           is_cat_node=arrays.is_cat_node,
                           cat_rank=arrays.cat_rank,
                           efb_maps=walk_maps(vbinned, m.efb_maps))

    def _finish(self, lv, blocked, stop, mark=_no_mark) -> None:
        """The traced metrics (B12) and the vote, then the iteration's
        output row (tree buffer, shrunk leaf values, eval values, stop
        flag) into ``out[row]``."""
        m = self.model
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

    def _body_multiclass(self, gh=None, mark=None) -> None:
        """One multiclass iteration, eagerly (module docstring): the
        [N, K] gradients once, then K trees, each into its score column
        and its own row of ``out``."""
        m = self.model
        mark = mark or _no_mark
        mark("gradients")
        g_all, h_all = m.objective.get_gradients(m.score) if gh is None \
            else gh
        # one iteration a run: every class's draws take the iteration
        # it0, and its feature_fraction mask is fmasks[0]
        if self.keyed:
            self.it_cur.copy_(self.it0)
        fmask = self.fmasks[0] if self.sample_features else m.feature_mask
        for c in range(self.K):
            vals = self._vals(g_all[:, c], h_all[:, c])
            mark("grow")
            arrays, check = self._grown(vals, fmask, mark)
            mark("score")
            lv = m.shrink(arrays.leaf_value)
            lv_ok = torch.where(arrays.num_leaves[0] > 1, lv, self.zero)
            self._add_score(m.score[:, c], lv_ok, arrays.leaf_of_row, check)
            mark("valid")
            for _, vbinned, vscore in m.valid_sets:
                add_tree_score(vscore, vbinned, arrays.split_feature,
                               arrays.threshold_bin, arrays.default_left,
                               arrays.left_child, arrays.right_child,
                               m.na_bin_dev, lv_ok, 1.0, steps=m.walk_steps,
                               is_cat_node=arrays.is_cat_node,
                               cat_rank=arrays.cat_rank, column=c,
                               efb_maps=walk_maps(vbinned, m.efb_maps))
            mark("")
            self.cur_tree.copy_(m.grow_ws.tree)
            self.cur_lv.copy_(lv)
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
        ts = [m.score, self.dead, self.row, self.it_cur, self.fmask_cur]
        if m.constraints is not None:
            ts.append(m.grow_ws.cuse)
        ts += [vs for _, _, vs in m.valid_sets]
        if self.es_spec is not None:
            ts += list(m.es_state)
        return ts

    def _capture(self) -> None:
        """Capture the body as a CUDA graph (``capture_graph``)."""
        (self.graph, self.warmup, self.captured,
         self.capture_ms) = capture_graph(self.body, self._mutable)

    def run(self, k: int, es_it0: int = 0, *, eager: bool,
            gh=None, mark=None, fmasks=None, it0: int = 0) -> torch.Tensor:
        """Run k iterations into ``out[:k]`` and return that (device)
        slice.  ``eager``: call the body (the per-iteration path, and every
        path on the CPU); else replay the captured graph (CUDA only).
        ``fmasks``: the [k, F] host feature masks of the k iterations
        (feature_fraction < 1), copied to the device before the first;
        ``it0``: the first iteration's number, which keys the bagging,
        GOSS and per-node draws.  A multiclass program writes K rows an
        iteration, eagerly only."""
        if self.K > 1 and (k != 1 or not eager):
            raise ValueError("a multiclass iteration runs eagerly, one "
                             "at a time")
        self.prepare(k, es_it0, fmasks=fmasks, it0=it0)
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
        return self.out[:k * self.K]

    def prepare(self, k: int, es_it0: int = 0, *, fmasks=None,
                it0: int = 0) -> None:
        """Set the device state a run of k iterations starts from: the row
        counter and ``dead`` cleared, the vote's first iteration
        ``es_it0``, the keying iteration ``it0``, the [k, F] feature
        masks ``fmasks`` and CEGB's used features."""
        self._ensure_rows(k * self.K)
        self.row.zero_()
        self.dead.zero_()
        self.es_base.fill_(int(es_it0))
        self.it0.fill_(int(it0))
        if fmasks is not None:
            self.fmask_host = np.asarray(fmasks[0], bool)
        if self.sample_features:
            self.fmasks[:k].copy_(torch.as_tensor(np.asarray(fmasks, bool)))
        if self.model.cegb is not None:
            # CEGB's used features as the host has them; the trees of the
            # run mark the device copy, which no tree resets
            self.model.grow_ws.cuse.copy_(
                torch.as_tensor(self.model.cegb.used))

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
        out = tree_fields(r[:W], L, self.cat_bins)
        out["lv"] = r[W:W + L].view(f32)
        out["ev"] = r[W + L:W + L + E].view(f32)
        out["stop"] = r[W + L + E]
        return out


class FleetProgram:
    """One boosting iteration of every member of a fleet, in lockstep (the
    port's ``build_fleet_superepoch``, the JAX package's models/gbdt.py
    :2184, which vmaps the super-epoch body over a member axis).

    It holds the members' ``IterationProgram``s (one eval spec and
    early-stop spec, one epoch shape) and runs, for one iteration: each
    member's start, gradients and row weights (B5, B6 / B6-GOSS) keyed by
    its own seed, learning rate and ``it_cur``; the lockstep growers
    (``grower.grow_trees_lockstep``: B1-M and B3-M, or B1-K-M and B3-K-M,
    once for all members, the rest a member at a time); each member's
    shrinkage and score update; one B4-M a valid set for all members; and
    each member's traced metrics (B12), vote and output row.  Each member
    runs its solo phases on its own tensors in its solo order, so its rows
    are its solo run's.  The members must share their binned matrix, NA
    table, categorical flags, EFB maps and valid matrices
    (``GBDTModel.share_from``).  On the card the body is captured once as
    a CUDA graph and an epoch of k iterations is k replays; on the CPU it
    runs eagerly through the plain versions.  A member that has left the
    fleet rides its lane with ``dead`` set, so it changes no state."""

    def __init__(self, programs):
        self.programs = list(programs)
        if len(self.programs) < 1:
            raise ValueError("a fleet program needs a member")
        m0 = self.programs[0].model
        for p in self.programs:
            m = p.model
            if p.K != 1 or m.partitioned is not None \
                    or m.split_batch != m0.split_batch \
                    or not isinstance(m.binned_dev, torch.Tensor):
                raise ValueError("fleet members run the masked grower on "
                                 "one dense matrix, one tree an "
                                 "iteration, with one split batch")
            if m.objective is None or m.objective.need_renew_tree_output:
                raise ValueError("fleet members need an objective with "
                                 "device leaf values")
            shared = (m.binned_dev is m0.binned_dev
                      and m.num_bin_dev is m0.num_bin_dev
                      and m.na_bin_dev is m0.na_bin_dev
                      and m.is_cat_dev is m0.is_cat_dev
                      and m.efb_dev is m0.efb_dev
                      and len(m.valid_sets) == len(m0.valid_sets)
                      and all(v[1] is v0[1] for v, v0 in
                              zip(m.valid_sets, m0.valid_sets)))
            if not shared or p.eval_spec != self.programs[0].eval_spec:
                raise ValueError("fleet members must share their matrices "
                                 "(GBDTModel.share_from) and eval spec")
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._outs: List[torch.Tensor] = []
        self.captured: Dict[str, int] = {}
        self.warmup: Dict[str, int] = {}
        self.replays = 0
        self.capture_ms: Dict[str, float] = {}

    def body(self) -> None:
        """One iteration of every member (class docstring)."""
        ps = self.programs
        m0 = ps[0].model
        begun = [p._begin() for p in ps]
        members = [p.grow_member(p._vals(b[2], b[3]), b[4])
                   for p, b in zip(ps, begun)]
        arrays = grow_trees_lockstep(m0.binned_dev, members, m0.num_bin_dev,
                                     m0.na_bin_dev, is_cat=m0.is_cat_dev,
                                     efb=m0.efb_dev)
        applied = [p._apply(a, b[0]) for p, a, b in zip(ps, arrays, begun)]
        for vi, (_, vbinned, _) in enumerate(m0.valid_sets):
            add_tree_score_members(
                [p.model.valid_sets[vi][2] for p in ps], vbinned,
                [p.model.grow_ws.fields for p in ps], m0.na_bin_dev,
                [a[1] for a in applied], 1.0,
                steps=[p.model.walk_steps for p in ps],
                efb_maps=walk_maps(vbinned, m0.efb_maps))
        for p, a, b in zip(ps, applied, begun):
            p._finish(a[0], b[0], b[1])

    def _mutable(self) -> List[torch.Tensor]:
        return [t for p in self.programs for t in p._mutable()]

    def run(self, k: int, es_it0s, fmasks, it0s, *, eager: bool,
            exited=None) -> List[torch.Tensor]:
        """Run k iterations of every member into its ``out[:k]`` and
        return those (device) slices.  Per member j: ``es_it0s[j]`` the
        vote's first iteration, ``fmasks[j]`` its [k, F] host feature
        masks, ``it0s[j]`` its keying iteration, ``exited[j]`` whether it
        has left the fleet (its lane rides with ``dead`` set).  ``eager``
        as ``IterationProgram.run``."""
        ps = self.programs
        exited = exited or [False] * len(ps)
        for j, p in enumerate(ps):
            p.prepare(k, es_it0s[j], fmasks=fmasks[j], it0=it0s[j])
            if exited[j]:
                p.dead.fill_(True)
        if eager:
            for _ in range(k):
                self.body()
        else:
            if ps[0].model.device.type != "cuda":
                raise ValueError("graph replay needs a CUDA device")
            if self.graph is None or any(
                    p.out is not o for p, o in zip(ps, self._outs)):
                (self.graph, self.warmup, self.captured,
                 self.capture_ms) = capture_graph(self.body, self._mutable)
                self._outs = [p.out for p in ps]
            for _ in range(k):
                self.graph.replay()
            self.replays += k
        return [p.out[:k] for p in ps]

    def fetch(self, blocks: List[torch.Tensor], site: str = "fleet_fetch"):
        """Every member's rows in one host copy, counted under ``site`` on
        member 0's model: returns (host rows, device rows), one [k, width]
        array and tensor a member; the device rows are views of one new
        buffer, so the next epoch leaves them alone."""
        flat = torch.cat([b.reshape(-1) for b in blocks])
        host = self.programs[0].model._fetch(flat, site)
        hosts, devs, off = [], [], 0
        for b in blocks:
            n = b.numel()
            hosts.append(host[off:off + n].reshape(b.shape))
            devs.append(flat[off:off + n].view(b.shape))
            off += n
        return hosts, devs

    def launches(self) -> Dict[str, int]:
        """Kernel launches on the device so far through the fleet's graph:
        captured launches times replays."""
        return {k: n * self.replays for k, n in self.captured.items()}
