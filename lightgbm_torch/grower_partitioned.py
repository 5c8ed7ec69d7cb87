"""Partitioned leaf-wise grower: the learner whose histogram work grows
with the smaller child.

Counterpart of the JAX package's ``grower_partitioned.py``
``PartitionedGrower`` (the reference's DataPartition and subtraction
shape, serial_tree_learner.cpp:283-323).  The rows of each leaf are a
segment of one device permutation ``order``, whose bounds ``begins`` and
``counts`` the host keeps; the host runs the split loop:

- the root's histogram is the segment histogram of every row (kernel
  B11a), its totals and output one fetch;
- each split partitions its leaf's segment in place, stably (kernel
  B11b), and fetches the left count: the split's one sync of the row
  partition (with bagging, out-of-bag rows follow the split too, so a
  segment's count is not its leaf's in-bag count);
- the smaller child's histogram is built from its segment (B11a) and the
  larger one's is the parent's minus it (a torch subtraction); with
  ``histogram_pool_size`` a least-recently-used pool keeps a bounded
  number of leaf histograms, and an evicted one is rebuilt from its
  segment (then the larger child is built directly);
- both children's best splits, and those of the leaves a monotone
  refresh changed, come from one B2 launch over their histograms
  (dequantized by B7c under ``quant_train``, expanded by B9 on an
  EFB-bundled matrix) and one fetch of their records;
- after the last split the row -> leaf vector is rebuilt from ``order``
  and the sorted segment table (kernel B11c), and the tree's arrays are
  written into the workspace's tree buffer (``grower.tree_layout``), so
  the trainer's score update, valid walks and host fetch read it as they
  read the masked growers' trees.

The per-node controls are host bookkeeping, as in the JAX package:
interaction branch sets, monotone ``basic`` (midpoint ranges),
``intermediate`` (ranges from the opposite subtrees' outputs, the whole
frontier refreshed after each split) and ``advanced`` (per-(feature,
threshold) bounds from the leaves' boxes, B2's ``mono_bounds`` form),
the monotone penalty by depth, ``feature_contri``, CEGB (each leaf's
penalty vector, B2's ``penalty`` form; the features of best-first splits
marked before they apply, forced splits never), forced splits (a BFS
pre-pass with host f64 outputs), ``max_depth``, and the node draws of
``feature_fraction_bynode`` and ``extra_trees`` from host
``np.random.RandomState`` streams that live across trees (the grower
lives on the model).  The numpy helpers ``_leaf_boxes``,
``_advanced_bounds``, ``_mono_intervals`` and ``_forced_record`` are
copies of the JAX package's, held equal to them by
tests/test_torch_partitioned.py.

Quantized training packs (g, h, w) once per tree (B7a, B7b, keyed by
``rng_iter``, row offset 0), every segment histogram is exact int32
(B11a's integer form) and is dequantized only at scan time, and for a
forced split's record.

Every fetch goes through the ``fetch`` callable given at construction
(the trainer's counting fetch), by site: ``root``, ``split_count``,
``split_records``, ``forced``.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .constraints import CEGBState, monotone_penalty_factor
from .efb import EFBDevice, expand_group_hist
from .grower import GrowWorkspace, TreeArrays, tree_fields
from .ops.quantize import QuantSpec, dequantize_hist, quant_scales, \
    quantize_stack
from .ops.segment import (leaf_of_row, new_scale, partition_segment,
                          segment_histogram)
from .ops.split import (FEATURE, GAIN, LEFT_OUTPUT, LEFT_SUM, RECORD,
                        RIGHT_OUTPUT, RIGHT_SUM, THRESHOLD, DEFAULT_LEFT,
                        SplitConstraints, SplitParams, find_best_split,
                        leaf_output)


class _HostSplit(NamedTuple):
    gain: float
    feature: int
    threshold: int
    default_left: bool
    left_sum: np.ndarray
    right_sum: np.ndarray
    left_output: float
    right_output: float
    is_cat: bool
    bin_rank: np.ndarray


def _host_fetch(t: torch.Tensor, site: str) -> np.ndarray:
    return t.cpu().numpy()


class PartitionedGrower:
    """Host-orchestrated, device-resident leaf-wise learner (module
    docstring).  ``num_bin``/``na_bin``: the features' bins and NA bins
    on the host ([F] int arrays); ``mono`` [F] -1/0/+1, ``mono_method``
    basic | intermediate | advanced, ``mono_penalty``;
    ``interaction_groups`` [G, F] bool; ``bynode_frac`` with
    ``bynode_seed``, ``extra_trees`` with ``extra_seed``;
    ``feature_contri`` [F]; ``efb`` (an ``EFBDevice``) with ``efb_host``
    (the host (group_of_feat, off_of_feat) of the bundles);
    ``pool_entries`` the histogram pool's size (0: unbounded);
    ``quant`` a ``QuantSpec``; ``rows_per_block`` the segment histograms'
    row block (0 = automatic)."""

    def __init__(self, *, num_leaves: int, num_bins: int,
                 params: SplitParams, num_bin, na_bin, device,
                 max_depth: int = -1, mono=None, mono_method: str = "basic",
                 mono_penalty: float = 0.0, interaction_groups=None,
                 bynode_frac: float = 1.0, bynode_seed: int = 0,
                 efb: Optional[EFBDevice] = None, efb_host=None,
                 pool_entries: int = 0, feature_contri=None,
                 extra_trees: bool = False, extra_seed: int = 6,
                 quant: Optional[QuantSpec] = None,
                 rows_per_block: int = 0,
                 fetch: Callable[[torch.Tensor, str], np.ndarray]
                 = _host_fetch):
        self.L = int(num_leaves)
        # the segment histograms' row block (ops/segment.py; the JAX
        # package's block_rows, grower_partitioned.py:55-66)
        self.rows_per_block = int(rows_per_block)
        self.B = int(num_bins)
        self.params = params
        self.max_depth = max_depth
        self.device = torch.device(device)
        dev = self.device
        self.nb_host = np.asarray(num_bin, np.int32)
        self.na_host = np.asarray(na_bin, np.int32)
        self.num_bin_dev = torch.as_tensor(self.nb_host).to(dev)
        self.na_bin_dev = torch.as_tensor(self.na_host).to(dev)
        self.F = len(self.nb_host)
        self.mono = None if mono is None or not np.any(mono) else \
            np.asarray(mono, np.int32)
        self.mono_method = mono_method
        self.mono_penalty = float(mono_penalty)
        self.mono_dev = self.factor_dev = None
        if self.mono is not None:
            self.mono_dev = torch.as_tensor(self.mono.astype(np.int8)).to(dev)
            if self.mono_penalty > 0.0:
                self.factor_dev = torch.as_tensor(monotone_penalty_factor(
                    self.mono_penalty, np.arange(self.L + 1))).to(dev)
        self.interaction_groups = None if interaction_groups is None \
            else np.asarray(interaction_groups, bool)
        self.bynode_frac = bynode_frac
        self._bynode_rng = np.random.RandomState(bynode_seed)
        self.contri_dev = None if feature_contri is None else \
            torch.as_tensor(np.asarray(feature_contri, np.float32)).to(dev)
        self.extra_trees = bool(extra_trees)
        self._extra_rng = np.random.RandomState(extra_seed)
        self.quant = quant
        self.pool_entries = max(2, int(pool_entries)) if pool_entries > 0 \
            else 0
        self.efb = efb
        if efb is not None:
            self.group_host = np.asarray(efb_host[0], np.int32)
            self.off_host = np.asarray(efb_host[1], np.int32)
        # histogram axis: group bins when bundled, feature bins otherwise
        self.BH = efb.group_bins if efb is not None else self.B
        self._fetch = fetch
        self._rank_iota = torch.arange(self.B, dtype=torch.int32,
                                       device=dev)
        self._iota = self._order = self._scratch = None

    def _buffers(self, n: int):
        """The order permutation (reset to the identity) and B11b's
        scratch, allocated once for n rows."""
        if self._iota is None or self._iota.shape[0] != n:
            kw = {"dtype": torch.int32, "device": self.device}
            self._iota = torch.arange(n, **kw)
            self._order = torch.empty(n, **kw)
            self._scratch = torch.empty(n, **kw)
        self._order.copy_(self._iota)
        return self._order

    def grow(self, binned: torch.Tensor, vals: torch.Tensor, feature_mask,
             is_cat: Optional[torch.Tensor] = None, forced=None,
             cegb_state: Optional[CEGBState] = None,
             rng_iter: Optional[torch.Tensor] = None,
             workspace: Optional[GrowWorkspace] = None) -> TreeArrays:
        """One tree on ``binned`` [N, F] uint8 (the bundled [N, G] matrix
        with EFB) and ``vals`` [N, 3] f32 (g*w, h*w, w), on the grower's
        device.  ``feature_mask``: the host [F] bool feature_fraction
        mask; ``is_cat`` the device [F] bool categorical features;
        ``forced`` the parsed forced-splits tree (slot and bin space);
        ``cegb_state`` CEGB's host state, whose ``used`` the tree updates;
        ``rng_iter`` the [1] int32 device iteration that keys the
        quantizer's rounding.  Writes the tree into ``workspace``'s tree
        buffer and row -> leaf vector and returns their device views."""
        L, B = self.L, self.B
        n = binned.shape[0]
        dev = self.device
        ws = workspace if workspace is not None else GrowWorkspace(
            n, self.F, B, L, dev, categorical=is_cat is not None,
            efb=self.efb, quant=self.quant)
        order = self._buffers(n)
        nb_host, na_host = self.nb_host, self.na_host
        fetch = self._fetch

        scales = None
        if self.quant is not None:
            # pack once per tree; every segment histogram below is then
            # an exact int32 accumulation, dequantized only at scan time
            scales = quant_scales(vals, self.quant.qmax, out=ws.qscales)
            vals = quantize_stack(vals, scales, self.quant, rng_iter,
                                  out=ws.qvals)

        # the fixed point's scale of the f32 segment histograms: the
        # root pass computes it from vals once a tree, every later pass
        # of the tree takes it (the bits depend on vals alone)
        scale = new_scale(dev) if scales is None and dev.type == "cuda" \
            else None

        def seg_hist(begin: int, count: int,
                     fill: bool = False) -> torch.Tensor:
            return segment_histogram(binned, vals, order, begin, count,
                                     num_bins=self.BH,
                                     rows_per_block=self.rows_per_block,
                                     scale=scale, fill_scale=fill)

        # root histogram + split (over EFB groups when bundled)
        hist0 = seg_hist(0, n, fill=True)
        if scales is None:
            total0_dev = hist0[0].sum(dim=0)
        else:
            total0_dev = torch.sum(hist0[0], dim=0, dtype=torch.int32).to(
                torch.float32) * scales
        root_out_dev = leaf_output(total0_dev[0], total0_dev[1], self.params)
        got = fetch(torch.cat([total0_dev, root_out_dev.reshape(1)]), "root")
        total0 = np.asarray(got[:3], np.float32)
        root_out = float(got[3])
        base_mask = np.asarray(feature_mask, bool)
        if self.interaction_groups is not None:
            # GetByNode (col_sampler.hpp:91-111): per-leaf branch sets;
            # allowed = branch ∪ (groups that contain the whole branch).
            # Root branch is empty -> union of all groups.
            def _inter_allowed(branch):
                g = self.interaction_groups
                contains = (g | ~branch[None, :]).all(axis=1)
                return (g & contains[:, None]).any(axis=0) | branch
            leaf_branch = {0: np.zeros(base_mask.shape[0], bool)}
            leaf_mask = {0: base_mask & _inter_allowed(leaf_branch[0])}
        else:
            leaf_mask = {0: base_mask}
        inf = np.float32(np.finfo(np.float32).max)
        leaf_lo = {0: -inf}
        leaf_hi = {0: inf}
        use_advanced = self.mono is not None \
            and self.mono_method == "advanced"
        adv_bounds: dict = {}
        adv_prev_boxes: list = [None]
        if use_advanced:
            nf_adv = len(nb_host)
            adv_bounds[0] = (np.full((nf_adv, B), -np.inf, np.float32),
                             np.full((nf_adv, B), np.inf, np.float32),
                             np.full((nf_adv, B), -np.inf, np.float32),
                             np.full((nf_adv, B), np.inf, np.float32))

        def _node_mask(mask: np.ndarray) -> np.ndarray:
            if self.bynode_frac < 1.0:
                f_all = len(mask)
                k = max(1, int(round(mask.sum() * self.bynode_frac)))
                on = np.nonzero(mask)[0]
                keep = self._bynode_rng.choice(on, size=min(k, len(on)),
                                               replace=False)
                m = np.zeros(f_all, bool)
                m[keep] = True
                return m
            return mask

        cand_rank_dev: dict = {}

        def _find_leaves(items) -> List[_HostSplit]:
            """Best splits of ``items`` [(hist, total, parent output,
            leaf)], in order: the host draws leaf by leaf (extra_trees
            first, then the bynode subset, as the JAX package's
            ``_find_leaf``), then one B2 launch over the K leaves and one
            fetch of their records."""
            k = len(items)
            F = self.F
            masks = np.zeros((k, F), bool)
            rbins = np.zeros((k, F), np.int32) if self.extra_trees else None
            for j, (_, _, _, leaf) in enumerate(items):
                if self.extra_trees:
                    # one random threshold bin per feature per candidate
                    # evaluation (extremely randomized trees)
                    u = self._extra_rng.rand(len(nb_host))
                    rbins[j] = np.minimum(
                        (u * np.maximum(nb_host - 1, 1)).astype(np.int32),
                        nb_host - 2)
                masks[j] = _node_mask(leaf_mask[leaf])
            totals = np.stack([np.asarray(t, np.float32)
                               for _, t, _, _ in items])
            tot_dev = self._h2d(totals)
            hist = torch.stack([h for h, _, _, _ in items])
            if scales is not None:
                # quantized training: dequantize AT SCAN TIME only
                hist = dequantize_hist(hist, scales)
            if self.efb is not None:
                hist = expand_group_hist(hist, tot_dev, self.efb)
            leaves = [leaf for _, _, _, leaf in items]
            cons = {}
            if self.mono is not None:
                # each scalar rounded to f32, as jnp.float32 rounds the JAX
                # package's
                cons.update(
                    mono=self.mono_dev,
                    out_lo=self._h2d(np.asarray(
                        [leaf_lo[lf] for lf in leaves], np.float32)),
                    out_hi=self._h2d(np.asarray(
                        [leaf_hi[lf] for lf in leaves], np.float32)))
                if use_advanced:
                    for name, a in zip(("lo_l", "hi_l", "lo_r", "hi_r"),
                                       zip(*(adv_bounds[lf]
                                             for lf in leaves))):
                        cons[name] = self._h2d(np.stack(a))
                if self.factor_dev is not None:
                    cons.update(factor=self.factor_dev, depth=self._h2d(
                        np.asarray([depth.get(lf, 0) for lf in leaves],
                                   np.int32)))
            if cegb_state is not None and cegb_state.active:
                cons["penalty"] = self._h2d(np.stack(
                    [cegb_state.penalty_vector(t[2]) for t in totals]))
            if self.contri_dev is not None:
                cons["contri"] = self.contri_dev
            res = find_best_split(
                hist.contiguous(), tot_dev,
                self._h2d(np.asarray([p for _, _, p, _ in items],
                                     np.float32)),
                self.num_bin_dev, self.na_bin_dev, self._h2d(masks),
                self.params,
                rand_bin=None if rbins is None else self._h2d(rbins),
                is_cat=is_cat,
                cons=SplitConstraints(**cons) if cons else None)
            if is_cat is None:
                host = fetch(res, "split_records")
                cats, ranks = np.zeros(k, bool), None
            else:
                rec, cat, rank = res
                packed = torch.cat([rec.view(torch.int32), cat[:, None],
                                    rank], dim=1)
                got = fetch(packed, "split_records")
                host = np.ascontiguousarray(got[:, :RECORD]).view(np.float32)
                cats, ranks = got[:, RECORD] != 0, got[:, RECORD + 1:]
                for j, lf in enumerate(leaves):
                    cand_rank_dev[lf] = rank[j]
            out = []
            for j in range(k):
                r = host[j]
                out.append(_HostSplit(
                    gain=float(r[GAIN]), feature=int(r[FEATURE]),
                    threshold=int(r[THRESHOLD]),
                    default_left=bool(r[DEFAULT_LEFT] != 0),
                    left_sum=np.asarray(r[LEFT_SUM], np.float32),
                    right_sum=np.asarray(r[RIGHT_SUM], np.float32),
                    left_output=float(r[LEFT_OUTPUT]),
                    right_output=float(r[RIGHT_OUTPUT]),
                    is_cat=bool(cats[j]),
                    bin_rank=np.arange(B, dtype=np.int32) if ranks is None
                    else np.asarray(ranks[j], np.int32)))
            return out

        depth = {0: 0}
        hists = {0: hist0}
        lru: List[int] = [0]

        def _store(l: int, h) -> None:
            hists[l] = h
            if self.pool_entries <= 0:
                return
            if l in lru:
                lru.remove(l)
            lru.append(l)
            live = [k for k in lru if hists.get(k) is not None]
            while len(live) > self.pool_entries:
                victim = live.pop(0)
                hists[victim] = None
                lru.remove(victim)

        def _get_hist(l: int):
            """Pool fetch; evicted leaves rebuilt from their row segment."""
            h = hists.get(l)
            if h is None:
                h = seg_hist(begins[l], counts[l])
            _store(l, h)
            return h

        cand = {0: _find_leaves([(hist0, total0, root_out, 0)])[0]}
        totals = {0: total0}
        parent_out = {0: root_out}

        # host tree state
        begins = {0: 0}
        counts = {0: n}
        leaf_parent = {0: -1}
        split_feature = np.zeros(L - 1, np.int32)
        threshold_bin = np.zeros(L - 1, np.int32)
        default_left = np.zeros(L - 1, bool)
        left_child = np.zeros(L - 1, np.int32)
        right_child = np.zeros(L - 1, np.int32)
        split_gain = np.zeros(L - 1, np.float32)
        leaf_value = np.zeros(L, np.float32)
        leaf_weight = np.zeros(L, np.float32)
        leaf_count = np.zeros(L, np.float32)
        internal_value = np.zeros(L - 1, np.float32)
        internal_weight = np.zeros(L - 1, np.float32)
        internal_count = np.zeros(L - 1, np.float32)
        leaf_depth_arr = np.zeros(L, np.int32)
        is_cat_node = np.zeros(L - 1, bool)
        cat_rank = np.broadcast_to(np.arange(B, dtype=np.int32)[None],
                                   (L - 1, B)).copy()
        leaf_value[0] = root_out
        leaf_weight[0] = total0[1]
        leaf_count[0] = total0[2]

        num_leaves = 1

        def apply_split(i: int, leaf: int, rec: _HostSplit) -> None:
            nonlocal num_leaves
            new = num_leaves

            # tree bookkeeping (Tree::Split)
            parent = leaf_parent[leaf]
            if parent >= 0:
                if left_child[parent] == ~leaf:
                    left_child[parent] = i
                else:
                    right_child[parent] = i
            left_child[i] = ~leaf
            right_child[i] = ~new
            split_feature[i] = rec.feature
            threshold_bin[i] = rec.threshold
            default_left[i] = rec.default_left
            split_gain[i] = rec.gain
            internal_value[i] = leaf_value[leaf]
            internal_weight[i] = leaf_weight[leaf]
            internal_count[i] = leaf_count[leaf]
            leaf_parent[leaf] = i
            leaf_parent[new] = i
            is_cat_node[i] = rec.is_cat
            cat_rank[i] = rec.bin_rank

            # partition the leaf's segment (B11b)
            begin, cnt = begins[leaf], counts[leaf]
            if self.efb is not None:
                col = int(self.group_host[rec.feature])
                goff = int(self.off_host[rec.feature])
            else:
                col, goff = rec.feature, -1
            rank = cand_rank_dev.get(leaf) if rec.is_cat else None
            cl_dev = partition_segment(
                binned, order, begin, cnt, col=col,
                na_bin=-1 if rec.is_cat else int(na_host[rec.feature]),
                goff=goff, nbm1=int(nb_host[rec.feature]) - 1,
                threshold=rec.threshold, default_left=rec.default_left,
                rank=self._rank_iota if rank is None else rank,
                scratch=self._scratch)
            # actual moved-row count (with bagging, out-of-bag rows follow
            # the split too, so segment size != in-bag left_sum count):
            # the split's one sync of the partition
            cl = int(fetch(cl_dev, "split_count")[0])
            cr = cnt - cl
            begins[leaf], counts[leaf] = begin, cl
            begins[new], counts[new] = begin + cl, cr
            d = depth[leaf] + 1
            depth[leaf] = d
            depth[new] = d
            leaf_value[leaf] = rec.left_output
            leaf_value[new] = rec.right_output
            leaf_weight[leaf] = rec.left_sum[1]
            leaf_weight[new] = rec.right_sum[1]
            leaf_count[leaf] = rec.left_sum[2]
            leaf_count[new] = rec.right_sum[2]
            leaf_depth_arr[leaf] = d
            leaf_depth_arr[new] = d

            # histogram: smaller child constructed (B11a), larger by
            # subtraction (falls back to direct construction on a
            # histogram-pool miss — the parent's rows are already
            # re-partitioned by now)
            sm, lg = (leaf, new) if cl <= cr else (new, leaf)
            parent_hist = hists.get(leaf)
            hist_sm = seg_hist(begins[sm], counts[sm])
            if parent_hist is not None:
                hist_lg = parent_hist - hist_sm
            else:
                hist_lg = seg_hist(begins[lg], counts[lg])
            _store(sm, hist_sm)
            _store(lg, hist_lg)
            totals[leaf] = rec.left_sum
            totals[new] = rec.right_sum
            parent_out[leaf] = rec.left_output
            parent_out[new] = rec.right_output

            # constraint propagation to children
            if self.interaction_groups is not None:
                child_branch = leaf_branch[leaf].copy()
                child_branch[rec.feature] = True
                leaf_branch[leaf] = leaf_branch[new] = child_branch
                child_mask = base_mask & _inter_allowed(child_branch)
            else:
                child_mask = leaf_mask[leaf]
            leaf_mask[leaf] = child_mask
            leaf_mask[new] = child_mask
            lo_p, hi_p = leaf_lo[leaf], leaf_hi[leaf]
            mc = 0 if self.mono is None else int(self.mono[rec.feature])
            use_intermediate = (self.mono is not None
                                and self.mono_method == "intermediate")
            refresh = []
            if use_advanced:
                # recompute per-threshold bounds ONLY for leaves this
                # split can affect (the JAX package's box-overlap filter)
                num_leaves_next = new + 1
                boxes_int, boxes_wide = self._leaf_boxes(
                    num_leaves_next, split_feature, threshold_bin,
                    left_child, right_child, is_cat_node,
                    np.asarray(nb_host), default_left=default_left,
                    na_host=na_host)
                mono_np = np.asarray(self.mono)
                cand_boxes = [boxes_wide[leaf], boxes_wide[new]]
                if adv_prev_boxes[0] is not None \
                        and leaf < len(adv_prev_boxes[0]):
                    cand_boxes.append(adv_prev_boxes[0][leaf])

                # a changed box can constrain leaf l iff l's box overlaps
                # it in every dim except possibly ONE monotone feature
                mono_mask = mono_np != 0
                could = np.zeros(num_leaves_next, bool)
                bw = boxes_wide[:num_leaves_next]
                for cb in cand_boxes:
                    nonov = ~((cb[None, :, 0] <= bw[:, :, 1])
                              & (bw[:, :, 0] <= cb[None, :, 1]))  # [M, F]
                    cnt_ov = nonov.sum(axis=1)
                    mono_nonov = (nonov & mono_mask[None, :]).sum(axis=1)
                    could |= (cnt_ov == 0) | ((cnt_ov == 1)
                                              & (mono_nonov == 1))

                for l in range(num_leaves_next):
                    if l in (leaf, new) or l not in adv_bounds \
                            or could[l]:
                        nbnd = self._advanced_bounds(
                            boxes_int, boxes_wide, leaf_value, l, B,
                            na_host=na_host)
                        old = adv_bounds.get(l)
                        if l not in (leaf, new) and (
                                old is None or any(
                                    not np.array_equal(a, b)
                                    for a, b in zip(old, nbnd))):
                            refresh.append(l)
                        adv_bounds[l] = nbnd
                    # scalar range is unused under advanced (the per-bin
                    # bounds replace it) but must exist for _find_leaves
                    leaf_lo.setdefault(l, -inf)
                    leaf_hi.setdefault(l, inf)
                adv_prev_boxes[0] = boxes_wide
            elif use_intermediate:
                # recompute the whole frontier's intervals from the actual
                # opposite-subtree outputs (IntermediateLeafConstraints)
                num_leaves_next = new + 1
                iv = self._mono_intervals(
                    num_leaves_next, split_feature, left_child, right_child,
                    leaf_value, is_cat_node)
                for l in range(num_leaves_next):
                    lo2, hi2 = iv[l]
                    if l not in (leaf, new) and (
                            abs(lo2 - leaf_lo.get(l, -inf)) > 1e-12
                            or abs(hi2 - leaf_hi.get(l, inf)) > 1e-12):
                        refresh.append(l)
                    leaf_lo[l], leaf_hi[l] = lo2, hi2
            elif mc != 0 and not rec.is_cat:
                mid = 0.5 * (rec.left_output + rec.right_output)
                if mc > 0:   # left (smaller values) must output <= right
                    leaf_lo[leaf], leaf_hi[leaf] = lo_p, min(hi_p, mid)
                    leaf_lo[new], leaf_hi[new] = max(lo_p, mid), hi_p
                else:
                    leaf_lo[leaf], leaf_hi[leaf] = max(lo_p, mid), hi_p
                    leaf_lo[new], leaf_hi[new] = lo_p, min(hi_p, mid)
            else:
                leaf_lo[new], leaf_hi[new] = lo_p, hi_p

            # new candidates for both children and the refreshed leaves:
            # one B2 launch, ONE fetch of the records
            items = [(hists[leaf], totals[leaf], parent_out[leaf], leaf),
                     (hists[new], totals[new], parent_out[new], new)]
            items += [(_get_hist(l), totals[l], parent_out[l], l)
                      for l in refresh]
            got = _find_leaves(items)
            for (_, _, _, l), r in zip(items, got):
                cand[l] = r
            num_leaves = new + 1

        # forced splits pre-pass (ForceSplits, serial_tree_learner.cpp:455):
        # apply the forced tree top regardless of gain, in BFS order
        node_budget = L - 1
        next_node = 0
        if forced is not None:
            queue = [(forced, 0)]
            while queue and next_node < node_budget:
                spec, leaf = queue.pop(0)
                ph = _get_hist(leaf)
                if scales is not None:
                    ph = dequantize_hist(ph, scales)
                if self.efb is not None:
                    ph = expand_group_hist(
                        ph[None], self._h2d(np.asarray(
                            totals[leaf], np.float32)[None]), self.efb)[0]
                f = int(spec["feature"])
                fh = {f: fetch(ph[f], "forced")}
                rec = self._forced_record(spec, fh, totals[leaf],
                                          parent_out[leaf], B)
                if rec is None:
                    continue
                new = num_leaves
                apply_split(next_node, leaf, rec)
                next_node += 1
                if isinstance(spec.get("left"), dict):
                    queue.append((spec["left"], leaf))
                if isinstance(spec.get("right"), dict):
                    queue.append((spec["right"], new))

        for i in range(next_node, L - 1):
            # pick best leaf (host argmax — the per-leaf candidates are here)
            ok = [l for l in range(num_leaves)
                  if cand[l].gain > 0
                  and (self.max_depth <= 0 or depth[l] < self.max_depth)]
            if not ok:
                break
            leaf = max(ok, key=lambda l: cand[l].gain)
            if cegb_state is not None:
                cegb_state.mark_used(cand[leaf].feature)
            apply_split(i, leaf, cand[leaf])

        # row -> leaf from the segments (B11c)
        seg = sorted(((begins[l], l) for l in range(num_leaves)))
        table = self._h2d(np.asarray(seg, np.int32).T.copy())
        leaf_of_row(order, table[0], table[1], out=ws.leaf_of_row)

        words = np.zeros(ws.tree.shape[0], np.int32)
        v = tree_fields(words, L, ws.cat_bins)
        v["num_leaves"][0] = num_leaves
        v["done"][0] = 1
        v["n_steps"][0] = num_leaves - 1
        for name, arr in (("split_feature", split_feature),
                          ("threshold_bin", threshold_bin),
                          ("default_left", default_left),
                          ("left_child", left_child),
                          ("right_child", right_child),
                          ("split_gain", split_gain),
                          ("internal_value", internal_value),
                          ("internal_weight", internal_weight),
                          ("internal_count", internal_count),
                          ("leaf_value", leaf_value),
                          ("leaf_weight", leaf_weight),
                          ("leaf_count", leaf_count),
                          ("leaf_depth", leaf_depth_arr)):
            v[name][:] = arr
        v["leaf_parent"][:] = -1
        for l, p in leaf_parent.items():
            v["leaf_parent"][l] = p
        if ws.cat_bins:
            v["is_cat_node"][:] = is_cat_node
            v["cat_rank"][:] = cat_rank
        ws.tree.copy_(self._h2d(words))
        return ws.arrays()

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the grower's device: through pinned memory and
        without a synchronisation on the card (the copy is ordered on the
        stream), as is on the CPU."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    # -- the JAX package's numpy helpers, copied as they are ---------------
    @staticmethod
    def _leaf_boxes(num_leaves, split_feature, threshold_bin, left_child,
                    right_child, is_cat_node, nb_host, default_left=None,
                    na_host=None):
        """Per-leaf bin-range boxes from the numerical split structure,
        as TWO [M, F, 2] arrays:

        - ``box_int``: the pure interval part (may be empty, lo > hi, for
          a child whose only rows are NA-routed).  Used for ORDERING
          along a monotone feature — NaN values are unordered, so only
          interval parts create left-of/right-of relations.
        - ``box_wide``: widened over the NaN bin for the child that
          receives NA rows by default_left, and over the full range for
          categorical splits — used for region-OVERLAP tests, where
          over-approximation can only ADD constraints (safe)."""
        nf = len(nb_host)
        box_i = np.zeros((num_leaves, nf, 2), np.int32)
        box_w = np.zeros((num_leaves, nf, 2), np.int32)
        lo0 = np.zeros(nf, np.int32)
        hi0 = np.asarray(nb_host, np.int32) - 1
        if num_leaves <= 1:
            for b in (box_i, box_w):
                b[0, :, 0], b[0, :, 1] = lo0, hi0
            return box_i, box_w
        stack = [(0, lo0, hi0, lo0, hi0)]
        while stack:
            node, lo, hi, wlo, whi = stack.pop()
            f = int(split_feature[node])
            t = int(threshold_bin[node])
            na = -1 if na_host is None else int(na_host[f])
            dl = bool(default_left[node]) if default_left is not None \
                else False
            for child, is_left in ((int(left_child[node]), True),
                                   (int(right_child[node]), False)):
                l2, h2, wl2, wh2 = lo, hi, wlo, whi
                if not is_cat_node[node]:
                    if is_left:
                        h2, wh2 = hi.copy(), whi.copy()
                        h2[f] = min(h2[f], t)
                        wh2[f] = min(wh2[f], t)
                    else:
                        l2, wl2 = lo.copy(), wlo.copy()
                        l2[f] = max(l2[f], t + 1)
                        wl2[f] = max(wl2[f], t + 1)
                    if na >= 0 and (dl == is_left):
                        wl2 = wl2.copy()
                        wh2 = wh2.copy()
                        wl2[f] = min(wl2[f], na)
                        wh2[f] = max(wh2[f], na)
                if child < 0:
                    box_i[~child, :, 0], box_i[~child, :, 1] = l2, h2
                    box_w[~child, :, 0], box_w[~child, :, 1] = wl2, wh2
                else:
                    stack.append((child, l2, h2, wl2, wh2))
        return box_i, box_w

    def _advanced_bounds(self, boxes_int, boxes_wide, leaf_value, y,
                         num_bins_total, na_host=None):
        """Per-(candidate-feature s, threshold-bin b) allowed output
        ranges of the two children of leaf ``y`` ('advanced' method).

        A leaf L' constrains a child C through monotone feature f iff
        their regions overlap in every dim except f (then point pairs
        differing only in f exist across them).  C's box equals y's box
        except in the split feature s, so the qualification is
        b-dependent exactly when s != f; because tree leaves partition
        the space, qualifying leaves' interval parts are f-disjoint from
        y's, making the s == f contribution b-independent.

        Ordering along f uses INTERVAL boxes (NaN is unordered, so only
        finite f-ranges create left-of/right-of relations; leaves whose
        f-interval is empty impose nothing through f), while every
        overlap test uses the NA-WIDENED boxes, plus an escape that keeps
        a constraint active at all thresholds of s when both regions
        cover s's NaN bin (NA rows follow default_left regardless of the
        threshold)."""
        nf, B = boxes_int.shape[1], int(num_bins_total)
        mono_np = np.asarray(self.mono)
        neg, pos = -np.inf, np.inf
        lo_l = np.full((nf, B), neg, np.float32)
        lo_r = np.full((nf, B), neg, np.float32)
        hi_l = np.full((nf, B), pos, np.float32)
        hi_r = np.full((nf, B), pos, np.float32)
        m = boxes_int.shape[0]
        if m <= 1:
            return lo_l, hi_l, lo_r, hi_r
        ybi, ybw = boxes_int[y], boxes_wide[y]
        ov = (boxes_wide[:, :, 0] <= ybw[None, :, 1]) \
            & (ybw[None, :, 0] <= boxes_wide[:, :, 1])    # [M, F]
        ids = np.arange(m)
        bgrid = np.arange(B)
        vals_all = np.asarray(leaf_value[:m], np.float64)
        if na_host is not None:
            na_s = np.asarray(na_host)
            cov_nb = (na_s[None, :] >= 0) \
                & (boxes_wide[:, :, 0] <= na_s[None, :]) \
                & (na_s[None, :] <= boxes_wide[:, :, 1])  # [M, F]
            cov_y = (na_s >= 0) & (ybw[:, 0] <= na_s) & (na_s <= ybw[:, 1])
            na_escape = cov_nb & cov_y[None, :]
        else:
            na_escape = np.zeros((m, nf), bool)
        for f in np.nonzero(mono_np != 0)[0]:
            mc = int(mono_np[f])
            q = (ov | (np.arange(nf) == f)[None, :]).all(axis=1) \
                & (ids != y)
            nonempty = boxes_int[:, f, 0] <= boxes_int[:, f, 1]
            right_nb = q & nonempty & (boxes_int[:, f, 0] > ybi[f, 1])
            left_nb = q & nonempty & (boxes_int[:, f, 1] < ybi[f, 0])
            ub_nb, lb_nb = (right_nb, left_nb) if mc > 0 \
                else (left_nb, right_nb)
            for nb_mask, is_min in ((ub_nb, True), (lb_nb, False)):
                vals = vals_all[nb_mask]
                if vals.size == 0:
                    continue
                sb = boxes_wide[nb_mask]
                ext = vals.min() if is_min else vals.max()
                fill = pos if is_min else neg
                # broadcast pass over (s, b), chunked over the s axis
                k_nb = len(vals)
                vb = vals.astype(np.float32)[:, None, None]
                esc_all = na_escape[nb_mask]
                c_l = np.empty((nf, B), np.float32)
                c_r = np.empty((nf, B), np.float32)
                s_chunk = max(1, (1 << 21) // max(k_nb * B, 1))
                for s0 in range(0, nf, s_chunk):
                    sl = slice(s0, min(s0 + s_chunk, nf))
                    m_l = sb[:, sl, 0][:, :, None] <= bgrid[None, None, :]
                    m_r = sb[:, sl, 1][:, :, None] \
                        >= (bgrid + 1)[None, None, :]
                    esc = esc_all[:, sl, None]
                    m_l = m_l | esc
                    m_r = m_r | esc
                    if is_min:
                        c_l[sl] = np.where(m_l, vb, fill).min(axis=0)
                        c_r[sl] = np.where(m_r, vb, fill).min(axis=0)
                    else:
                        c_l[sl] = np.where(m_l, vb, fill).max(axis=0)
                        c_r[sl] = np.where(m_r, vb, fill).max(axis=0)
                # splits ON f itself: qualifying leaves are f-disjoint
                # from y, so the bound is b-independent for both children
                c_l[f, :] = ext
                c_r[f, :] = ext
                if is_min:
                    hi_l = np.minimum(hi_l, c_l)
                    hi_r = np.minimum(hi_r, c_r)
                else:
                    lo_l = np.maximum(lo_l, c_l)
                    lo_r = np.maximum(lo_r, c_r)
        return lo_l, hi_l, lo_r, hi_r

    def _mono_intervals(self, num_leaves, split_feature, left_child,
                        right_child, leaf_value, is_cat_node):
        """Per-leaf allowed output intervals from the current tree shape
        ('intermediate' method): walking root->leaf, a monotone split bounds
        the leaf by the extremum of the *opposite* subtree's current leaf
        outputs (tighter than the 'basic' midpoint; the analog of
        IntermediateLeafConstraints keeping constraints equal to actual
        sibling outputs, monotone_constraints.hpp:543-556)."""
        inf = float(np.finfo(np.float32).max)
        mono_np = np.asarray(self.mono)
        iv = {l: (-inf, inf) for l in range(num_leaves)}
        if num_leaves <= 1:
            return iv
        minmax_cache = {}

        def subtree_minmax(child):
            if child in minmax_cache:
                return minmax_cache[child]
            if child < 0:
                v = float(leaf_value[~child])
                r = (v, v)
            else:
                l0, l1 = subtree_minmax(int(left_child[child]))
                r0, r1 = subtree_minmax(int(right_child[child]))
                r = (min(l0, r0), max(l1, r1))
            minmax_cache[child] = r
            return r

        stack = [(0, -inf, inf)]
        while stack:
            node, lo, hi = stack.pop()
            lc, rc = int(left_child[node]), int(right_child[node])
            mc = 0 if is_cat_node[node] else \
                int(mono_np[int(split_feature[node])])
            llo, lhi, rlo, rhi = lo, hi, lo, hi
            if mc > 0:
                lhi = min(lhi, subtree_minmax(rc)[0])
                rlo = max(rlo, subtree_minmax(lc)[1])
            elif mc < 0:
                llo = max(llo, subtree_minmax(rc)[1])
                rhi = min(rhi, subtree_minmax(lc)[0])
            for child, clo, chi in ((lc, llo, lhi), (rc, rlo, rhi)):
                if child < 0:
                    iv[~child] = (clo, chi)
                else:
                    stack.append((child, clo, chi))
        return iv

    def _forced_record(self, spec, hist, total, pout, B
                       ) -> Optional[_HostSplit]:
        """Build a split record for a forced (feature, threshold) node
        (forcedsplits_filename, serial_tree_learner.cpp ForceSplits)."""
        f = int(spec["feature"])
        t = int(spec["threshold_bin"])
        h = np.asarray(hist[f])                         # [B, 3]
        lsum = h[:t + 1].sum(axis=0)
        rsum = np.asarray(total, np.float64) - lsum
        if lsum[2] < 1 or rsum[2] < 1:
            return None
        p = self.params

        def out(s):
            g, hh = float(s[0]), float(s[1])
            tl1 = np.sign(g) * max(0.0, abs(g) - p.lambda_l1) \
                if p.lambda_l1 > 0 else g
            o = -tl1 / (hh + p.lambda_l2 + 1e-15)
            if p.max_delta_step > 0:
                o = float(np.clip(o, -p.max_delta_step, p.max_delta_step))
            return float(o)

        return _HostSplit(
            gain=0.0, feature=f, threshold=t, default_left=False,
            left_sum=lsum.astype(np.float32), right_sum=rsum.astype(np.float32),
            left_output=out(lsum), right_output=out(rsum),
            is_cat=False, bin_rank=np.arange(B, dtype=np.int32))

