"""Tree growers resident on the device: strict leaf-wise, and batched.

Counterpart of the JAX package's ``grower.py`` ``grow_tree`` (the masked
one-program learner at ``split_batch=1``) and ``grow_tree_batched`` (K =
``split_batch`` > 1 splits a super-step, at the end of this module).  The JAX package runs the tree
build as one ``lax.while_loop`` over ``split_step``; here a tree is a
fixed sequence of L - 1 steps whose every value stays on the device, so
the whole tree, and a whole boosting iteration around it, can be captured
in one CUDA graph (``models/fused.py``):

- the root pass builds the histogram of all rows (kernel B1), the root's
  sums and output, and its best split (kernel B2);
- each step runs the split-step kernel (B3s, ``grow_step``), which picks
  the leaf with the largest cached gain (first on ties, as
  ``jnp.argmax``), writes the split into the tree arrays, and writes the
  step record the rest of the step reads: the row partition (B3), the
  smaller child's histogram (B1 with ``slot``), the larger child's as
  parent minus smaller (torch ops indexed by the record), both children's
  best splits (B2 on the pair), and the ``max_depth`` mask.

With EFB (``efb``, an ``efb.EFBDevice``) ``binned`` is the bundled
[N, G] matrix, as in the JAX package's masked grower: B1/B1-K build group
histograms [G, Bg, 3], the per-leaf histograms and the subtraction stay
in group space, and kernel B9 (``efb.expand_group_hist``) expands the
root's and each step's children's histograms to feature space [F, B, 3],
with each child's totals from its step record, just before the node
draws and B2; B3/B3-K decode each feature's bin from its bundle column.

With sparse binned storage ``binned`` is a ``sparse_data.SparseBinned``
(the padded k-hot rows; the JAX package's masked grower takes it the same
way, grower.py:360-362, :772-773, :1036-1037): B1/B1-K are the k-hot
histogram B8a (``compute_histogram`` dispatches on it), and B3/B3-K read a
feature's bin from the row's entries, or its default bin (B8b); the
histograms, the workspace and every other kernel are the dense ones.

With quantized training (``quant``, an ``ops.quantize.QuantSpec``; the
JAX package's ``_quant_prepare``, grower.py:369-397) the root pass first
takes the tree's shared scales (B7a) and packs (g, h, w) into int8 or
int16 (B7b, keyed by ``rng_iter``); the histogram passes then give exact
int32 histograms (B1-int, B1-K-int), the per-leaf histograms and their
subtraction stay int32, the root's totals are the int32 sum of the packed
stack dequantized, and each child pair's histograms are dequantized (B7c)
into the f32 ``GrowWorkspace.pair`` (or, with EFB, the f32 group buffer
B9 expands) just before B2.

With ``feature_fraction_bynode`` or ``extra_trees`` (``NodeSampling``)
the root and every step also draw their children's feature subsets and
random threshold bins on the device (kernel B6-node, ``node_draws``),
keyed by the device iteration ``rng_iter`` and the step's fixed position
(the JAX grower's ids: the root 0, strict step i its two children 2(i+1)
and 2(i+1)+1 and the extra_trees step i+1, batched super-step s its 2K
children (s+1)·2K + j and step s+1), and B2 takes them per child.

With the split controls (``constraints``, a ``constraints.GrowConstraints``:
monotone ``basic``, interaction constraints, ``feature_contri``, CEGB;
the JAX package's masked grower, grower.py:258-273, :457-489) the
workspace also holds each leaf's output range and branch feature set,
each step's children's ranges, depths and allowed masks, and the used
features ``cuse``: B3s/B3s-K update them in the step's one launch (range
propagation, branch sets and subset containment against the groups,
CEGB marks), B6-node draws each child's bynode subset from its allowed
features, and B2/B2-cat take the ranges, depths and used features as
per-child operands.  The root's allowed features are ``feature_mask``
and the union of the groups (one torch op a tree); its range is the
whole line at depth 0.  ``cuse`` is never reset by a tree: the trainer
sets it from its host state before a tree or an epoch of trees.

``make_shadow_grower`` (``ShadowGrower``) is the computation-integrity
layer's twin of a trainer's grower: the same grower over a workspace of
its own, its kernels from the separately built shadow libraries
(``_kernels.shadow_set``).

``grow_trees_lockstep`` grows one tree for each member of a fleet over one
shared matrix: each member's root pass and steps in its solo order (the
phases ``_root_vals``/``_root_finish`` and ``_step_begin``/``_step_finish``
or ``_super_begin``/``_super_finish`` that the solo growers call), with the
passes that read the shared matrix (B1-M, B3-M and their K-slot and
integer forms) launched once for every member.

With ``dist`` (a ``DistHooks``: the distributed learners of
``parallel/``, the JAX package's ``make_grower`` hooks ``hist_reduce``,
``hist_view``, ``hist_expand``, ``select_best``, ``mono_view``,
``sum_reduce``, ``scale_reduce``, ``row_offset`` and ``subtract``,
grower.py:168-329) each rank grows the same tree over its own rows or
features: every histogram pass reads ``dist.view(binned)`` (a
feature-parallel rank's column slice), and its result goes through
``dist.reduce`` before the workspace keeps it (the owner-shard
reduce-scatter leaves the rank only its chunk of the features, the full
all-reduce all of them, the PV-tree vote the voted ones); the root's sums
and the quantization scales are all-reduced, the stochastic rounding is
keyed by global row ids (``dist.row_offset``); B2 scans the rank's scan
features (``dist.scan_meta``, ``dist.scan_mono``), and its records go
through ``dist.select`` (the best-split all-gather and B16a) before the
table takes them; without subtraction (``dist.subtract`` False, voting)
the larger child's histogram is a pass of its own.  B3s, B3 and B3-K
read the global feature of the selected split on the full matrix.  Every
rank runs the fixed step sequence, dead steps included, so every rank
runs the same collectives in the same order.

A step that cannot split (no positive gain) sets the tree's ``done`` flag;
every later step's kernels then exit at once, as the reference's loop exit
(grower.py:908-915).  The tree arrays live in one int32 buffer (f32 fields
by bit pattern, layout ``TREE_FIELDS``), so the trainer fetches a tree in
one copy: once per tree on the per-iteration path, once per epoch of trees
on the fused path.  Every tensor of a tree build lives in a
``GrowWorkspace`` allocated once, so a captured graph's pointers stay
valid.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .constraints import GrowConstraints, check_operands
from .efb import EFBDevice, expand_group_hist
from .ops import split as sp
from .ops.histogram import compute_histogram, compute_histogram_members
from .ops.quantize import QuantSpec, dequantize_hist, quant_scales, \
    quantize_stack
from .ops.random import NodeSampling, node_draws
from .ops.split import SplitConstraints, SplitParams, find_best_split, \
    leaf_output
from .sparse_data import SparseBinned, column_per_row, khot_args
from . import _kernels

# the tree buffer's fields in order: (name, length, "i" int32 | "f" f32),
# length "n" = L - 1 nodes, "L" = leaves (csrc/grow_step.cu reads the same)
TREE_FIELDS = (
    ("num_leaves", 1, "i"), ("done", 1, "i"),
    ("split_feature", "n", "i"), ("threshold_bin", "n", "i"),
    ("default_left", "n", "i"), ("left_child", "n", "i"),
    ("right_child", "n", "i"), ("split_gain", "n", "f"),
    ("internal_value", "n", "f"), ("internal_weight", "n", "f"),
    ("internal_count", "n", "f"), ("leaf_value", "L", "f"),
    ("leaf_weight", "L", "f"), ("leaf_count", "L", "f"),
    ("leaf_depth", "L", "i"), ("leaf_parent", "L", "i"),
    ("n_steps", 1, "i"),
)
# appended when the dataset has a categorical feature ("nB" = L - 1 rows
# of the B bins): each node's is-categorical flag and rank row
CAT_FIELDS = (("is_cat_node", "n", "i"), ("cat_rank", "nB", "i"))
# step record (int32) columns, written by B3s and read by B3, B1 and B2
LEAF, NEW_LEAF, FEATURE, THRESHOLD, DEFAULT_LEFT, NA_BIN, SMALLER, ACTIVE = \
    range(8)
STEP_RECORD = 8


def tree_layout(num_leaves: int, cat_bins: int = 0) -> Dict[str, tuple]:
    """name -> (offset, length, kind) of the tree buffer for L leaves;
    ``cat_bins`` B > 0 adds ``CAT_FIELDS``."""
    L = int(num_leaves)
    sizes = {1: 1, "n": L - 1, "L": L, "nB": (L - 1) * int(cat_bins)}
    out, off = {}, 0
    for name, size, kind in TREE_FIELDS + (CAT_FIELDS if cat_bins else ()):
        out[name] = (off, sizes[size], kind)
        off += sizes[size]
    return out


def tree_words(num_leaves: int, cat_bins: int = 0) -> int:
    """Length of the tree buffer in int32 words."""
    return sum(n for _, n, _ in tree_layout(num_leaves, cat_bins).values())


def tree_fields(words, num_leaves: int, cat_bins: int = 0
                ) -> Dict[str, object]:
    """Views of every field of a tree buffer ``words`` (a torch int32
    tensor or a numpy int32 array); f32 fields are views by bit pattern,
    ``cat_rank`` a [L - 1, B] view."""
    f32 = torch.float32 if isinstance(words, torch.Tensor) else np.float32
    out = {}
    for name, (off, n, kind) in tree_layout(num_leaves, cat_bins).items():
        v = words[off:off + n]
        out[name] = v.view(f32) if kind == "f" else v
    if cat_bins:
        out["cat_rank"] = out["cat_rank"].reshape(-1, int(cat_bins))
    return out


class TreeArrays(NamedTuple):
    """Array-encoded tree (the JAX package's ``grower.TreeArrays``).

    Internal nodes are 0..num_leaves-2; a child pointer < 0 encodes leaf
    ``~child``; tree-sized fields are sized to the leaf budget L.  From
    ``grow_tree`` every field is a device tensor (a view of the
    workspace's tree buffer; ``num_leaves`` is a [1] tensor, ``n_steps``
    is None, and so are ``is_cat_node`` and ``cat_rank`` when the
    workspace has no categorical fields); from ``host_tree`` they are
    numpy arrays and ``num_leaves``/``n_steps`` ints."""
    num_leaves: object           # actual number of leaves
    split_feature: object        # [L-1] int32 (used-feature slot)
    threshold_bin: object        # [L-1] int32
    default_left: object         # [L-1] int32 on the device, bool on host
    left_child: object           # [L-1] int32
    right_child: object          # [L-1] int32
    split_gain: object           # [L-1] f32
    leaf_value: object           # [L] f32
    leaf_weight: object          # [L] f32 (sum hessian)
    leaf_count: object           # [L] f32
    internal_value: object       # [L-1] f32
    internal_weight: object      # [L-1] f32
    internal_count: object       # [L-1] f32
    leaf_depth: object           # [L] int32
    leaf_of_row: Optional[torch.Tensor]  # [N] int32 — final row -> leaf
    is_cat_node: object          # [L-1] (int32 on the device, bool on
                                 # host; None on the device without a
                                 # categorical feature)
    cat_rank: object             # [L-1, B] int32 (go left iff
                                 # cat_rank[node, bin] <= threshold)
    n_steps: object              # live steps: splits (strict), live
                                 # super-steps (batched)


def host_tree(words: np.ndarray, num_leaves: int, num_bins: int,
              leaf_of_row: Optional[torch.Tensor] = None,
              cat_bins: int = 0) -> TreeArrays:
    """Host ``TreeArrays`` from a fetched tree buffer (numpy int32) of
    ``tree_layout(num_leaves, cat_bins)``; without categorical fields
    every node is numerical (identity rank rows)."""
    v = tree_fields(np.asarray(words, np.int32), num_leaves, cat_bins)
    nl = int(v["num_leaves"][0])
    nn = max(int(num_leaves) - 1, 0)
    if cat_bins:
        is_cat, rank = v["is_cat_node"] != 0, v["cat_rank"]
    else:
        is_cat = np.zeros(nn, bool)
        rank = np.broadcast_to(np.arange(num_bins, dtype=np.int32),
                               (nn, num_bins)).copy()
    return TreeArrays(
        num_leaves=nl, split_feature=v["split_feature"],
        threshold_bin=v["threshold_bin"],
        default_left=v["default_left"] != 0, left_child=v["left_child"],
        right_child=v["right_child"], split_gain=v["split_gain"],
        leaf_value=v["leaf_value"], leaf_weight=v["leaf_weight"],
        leaf_count=v["leaf_count"], internal_value=v["internal_value"],
        internal_weight=v["internal_weight"],
        internal_count=v["internal_count"], leaf_depth=v["leaf_depth"],
        leaf_of_row=leaf_of_row, is_cat_node=is_cat, cat_rank=rank,
        n_steps=int(v["n_steps"][0]))


def fetch_tree(ws: "GrowWorkspace") -> TreeArrays:
    """The workspace's last tree on the host, in one copy."""
    return host_tree(ws.tree.cpu().numpy(), ws.num_leaves, ws.num_bins,
                     ws.leaf_of_row, ws.cat_bins)


class DistHooks:
    """The grower's distribution hooks (module docstring), as the serial
    grower would have them: every hook the identity.  The learners of
    ``parallel/`` subclass it.  ``hist_cols``: the histograms' feature
    axis (the rank's owned chunk, its feature slice, or every feature);
    ``scan_features``: B2's; ``subtract``: the larger child by
    subtraction; ``row_offset``: this rank's first global row."""

    subtract = True
    row_offset = 0

    def __init__(self, hist_cols: int, scan_features: int):
        self.hist_cols = int(hist_cols)
        self.scan_features = int(scan_features)

    def view(self, binned):
        """The matrix the histogram passes read."""
        return binned

    def hist_out(self, dtype: torch.dtype):
        """A tensor the one-slot pass writes into (None: a new one)."""
        return None

    def reduce(self, h: torch.Tensor, scales=None) -> torch.Tensor:
        """A pass's histograms ([F, B, 3], or [K, F, B, 3]) in the carry's
        layout; ``scales`` the tree's quantization scales (quant)."""
        return h

    def sum_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The root's [3] sums over every rank (in place)."""
        return t

    def scale_reduce(self, s: torch.Tensor) -> torch.Tensor:
        """The tree's [3] quantization scales, maxed over every rank (in
        place)."""
        return s

    def scan_meta(self, feature_mask, num_bin, na_bin, is_cat):
        """B2's feature_mask, num_bin, na_bin and is_cat in scan space."""
        return feature_mask, num_bin, na_bin, is_cat

    def scan_mono(self, mono: torch.Tensor) -> torch.Tensor:
        """The monotone constraint vector in scan space."""
        return mono

    def select(self, res, active=None):
        """B2's records (or records, cat, rank) of this rank's scan, as
        the winners over every rank with global features."""
        return res


class GrowWorkspace:
    """Every device tensor of a tree build, allocated once for the
    shapes (N rows, F features, B bins, L leaves, split batch K): the tree
    buffer and its reset image, the best-split table, the per-leaf
    histograms, the row -> leaf vector, the step outputs, and the
    children's histograms.  The batched grower (K > 1) has 2K scratch rows
    past L in the table and the histograms (an invalid slot's leaf and new
    leaf) and K-wide step outputs (``grow_step_batched``).  With
    ``categorical`` the table has two companions, each leaf's best split's
    is-categorical flag (``leaf_cat``) and rank row (``leaf_rank``, [rows,
    B]: the JAX grower's ``bic``/``brank``), and the tree buffer the
    ``CAT_FIELDS``; without it B3 and B3-K read one identity rank.  With
    ``efb`` the per-leaf histograms are group histograms [rows, G, Bg, 3]
    and ``gpair`` holds a step's children's in group space, ``pair``
    their expansion; without it ``gpair`` is ``pair``.  With ``quant`` (a
    ``QuantSpec``) the per-leaf histograms and ``gpair`` are int32, the
    workspace holds the packed stack ``qvals`` [N, 3] and the tree's
    scales ``qscales`` [3], and ``pair`` (with EFB, ``gpair_f``, the f32
    group histograms B9 reads) receives each child pair dequantized.
    With ``constraints`` (a ``GrowConstraints``) it holds the split
    controls' state (``step_cons``, ``split_cons``): per-leaf output
    ranges ``olo``/``ohi`` and branch sets ``fallow`` [rows, F], the
    children's ranges ``clo``/``chi``, depths ``cdepth`` and allowed
    masks ``cmask`` [C + 1, F] (C = 2, or 2K batched; the last row the
    root's) and the used features ``cuse`` [F].  ``rows_per_block`` is
    the row block of every histogram pass of its trees (the JAX package's
    ``block_rows``; 0 = automatic, ``ops/histogram.py``).  With ``dist``
    (a ``DistHooks``) the per-leaf histograms and ``gpair`` hold
    ``dist.hist_cols`` features and ``pair`` ``dist.scan_features``."""

    def __init__(self, n: int, num_features: int, num_bins: int,
                 num_leaves: int, device: torch.device, split_batch: int = 1,
                 categorical: bool = False,
                 efb: Optional[EFBDevice] = None,
                 quant: Optional[QuantSpec] = None,
                 constraints: Optional[GrowConstraints] = None,
                 rows_per_block: int = 0,
                 dist: Optional[DistHooks] = None):
        L, F, B = int(num_leaves), int(num_features), int(num_bins)
        K = batch_width(split_batch, L)
        self.num_leaves, self.num_bins, self.split_batch = L, B, K
        self.rows_per_block = max(0, int(rows_per_block))
        self.efb = efb
        self.quant = quant
        self.dist = dist
        if dist is not None and efb is not None:
            raise ValueError("the distributed learners take the unbundled "
                             "matrix")
        # exact int32 histograms under quantized training
        hdt = torch.float32 if quant is None else torch.int32
        # the histograms' columns and bin axis: groups or features
        HF, HB = (F, B) if efb is None else (efb.num_groups, efb.group_bins)
        # B2's features
        SF = F
        if dist is not None:
            HF, SF = dist.hist_cols, dist.scan_features
            if quant is None and HF != SF:
                raise ValueError("the carry and the scan must have one "
                                 "feature axis")
        self.hist_bins = HB
        self.cat_bins = B if categorical else 0
        rows = L + 2 * K if K > 1 else L
        kw = {"device": device}
        init = torch.zeros(tree_words(L, self.cat_bins), dtype=torch.int32)
        tree_fields(init, L, self.cat_bins)["leaf_parent"].fill_(-1)
        self.tree_init = init.to(device)
        self.tree = self.tree_init.clone()
        self.fields = tree_fields(self.tree, L, self.cat_bins)
        table_init = torch.zeros((rows, sp.RECORD), dtype=torch.float32)
        table_init[:, sp.GAIN] = float("-inf")
        self.table_init = table_init.to(device)
        self.table = self.table_init.clone()
        self.hist = torch.zeros((rows, HF, HB, 3), dtype=hdt, **kw)
        self.leaf_of_row = torch.zeros(n, dtype=torch.int32, **kw)
        self.rank_iota = torch.arange(B, dtype=torch.int32, **kw)
        self.leaf_cat = self.leaf_rank = None
        if categorical:
            self.leaf_cat = torch.zeros(rows, dtype=torch.int32, **kw)
            self.leaf_rank = torch.zeros((rows, B), dtype=torch.int32, **kw)
        self.neg_inf = torch.full((), float("-inf"), **kw)
        # the per-node draws of a step's 2K children (the root uses row 0)
        self.node_mask = torch.ones((2 * K, F), dtype=torch.bool, **kw)
        self.node_bins = torch.zeros((2 * K, F), dtype=torch.int32, **kw)
        C = 2 if K == 1 else 2 * K
        self.cons = constraints
        if constraints is not None:
            inf = float("inf")
            self.olo = torch.full((rows,), -inf, **kw)
            self.ohi = torch.full((rows,), inf, **kw)
            self.fallow = torch.zeros((rows, F), dtype=torch.bool, **kw)
            # the children's rows 0..C-1, then the root's (the whole
            # line at depth 0), which no kernel writes
            self.clo = torch.full((C + 1,), -inf, **kw)
            self.chi = torch.full((C + 1,), inf, **kw)
            self.cdepth = torch.zeros(C + 1, dtype=torch.int32, **kw)
            self.cmask = torch.ones((C + 1, F), dtype=torch.bool, **kw)
            self.cuse = torch.zeros(F, dtype=torch.bool, **kw)
        self.pair = torch.zeros((C, SF, B, 3), dtype=torch.float32, **kw)
        self.gpair = self.pair if efb is None and quant is None else \
            torch.zeros((C, HF, HB, 3), dtype=hdt, **kw)
        self.gpair_f = self.qvals = self.qscales = None
        if quant is not None:
            self.qvals = torch.zeros((n, 3), dtype=quant.dtype, **kw)
            self.qscales = torch.ones(3, dtype=torch.float32, **kw)
            if efb is not None:
                self.gpair_f = torch.zeros((C, HF, HB, 3),
                                           dtype=torch.float32, **kw)
        if K == 1:
            self.rec = torch.zeros(STEP_RECORD, dtype=torch.int32, **kw)
            self.idx = torch.zeros(2, dtype=torch.int64, **kw)
            self.fstep = torch.zeros(8, dtype=torch.float32, **kw)
            self.flags = torch.zeros(2, dtype=torch.bool, **kw)
            return
        self.step = BatchedStep(
            recs=torch.zeros((K, STEP_RECORD), dtype=torch.int32, **kw),
            slot_of_leaf=torch.full((L,), -1, dtype=torch.int32, **kw),
            idx2=torch.zeros(2 * K, dtype=torch.int64, **kw),
            tot2=torch.zeros((2 * K, 3), dtype=torch.float32, **kw),
            po2=torch.zeros(2 * K, dtype=torch.float32, **kw),
            small_left=torch.zeros(K, dtype=torch.bool, **kw),
            keep2=torch.zeros(2 * K, dtype=torch.bool, **kw),
            status=torch.zeros(2, dtype=torch.int32, **kw))

    def arrays(self) -> TreeArrays:
        """The tree just grown, as device views."""
        v = self.fields
        return TreeArrays(
            num_leaves=v["num_leaves"], split_feature=v["split_feature"],
            threshold_bin=v["threshold_bin"],
            default_left=v["default_left"], left_child=v["left_child"],
            right_child=v["right_child"], split_gain=v["split_gain"],
            leaf_value=v["leaf_value"], leaf_weight=v["leaf_weight"],
            leaf_count=v["leaf_count"], internal_value=v["internal_value"],
            internal_weight=v["internal_weight"],
            internal_count=v["internal_count"], leaf_depth=v["leaf_depth"],
            leaf_of_row=self.leaf_of_row, is_cat_node=v.get("is_cat_node"),
            cat_rank=v.get("cat_rank"), n_steps=None)

    @property
    def rank(self) -> torch.Tensor:
        """B3's and B3-K's rank operand: the per-leaf rank table, or the
        one identity rank when no feature is categorical."""
        return self.rank_iota if self.leaf_rank is None else self.leaf_rank

    def cat_state(self) -> dict:
        """The categorical keyword arguments of B3s and B3s-K."""
        return {} if self.leaf_rank is None else {
            "leaf_cat": self.leaf_cat, "leaf_rank": self.leaf_rank}

    def step_cons(self, feature_mask: torch.Tensor
                  ) -> Optional["StepConstraints"]:
        """B3s's and B3s-K's split-control state, None without controls."""
        c = self.cons
        if c is None:
            return None
        mono = c.mono is not None
        inter = c.groups is not None
        return StepConstraints(
            mono=c.mono, olo=self.olo if mono else None,
            ohi=self.ohi if mono else None,
            clo=self.clo[:-1] if mono else None,
            chi=self.chi[:-1] if mono else None,
            cdepth=self.cdepth[:-1] if mono else None, groups=c.groups,
            feature_mask=feature_mask if inter else None,
            fallow=self.fallow if inter else None,
            cmask=self.cmask[:-1] if inter else None,
            cuse=self.cuse if c.cegb else None)

    def split_cons(self, count: int, root: bool = False
                   ) -> Optional[SplitConstraints]:
        """B2's split controls for the root (``root``) or a step's
        ``count`` children, None without controls."""
        c = self.cons
        if c is None:
            return None
        rows = slice(-1, None) if root else slice(0, count)
        lo, hi, depth = self.clo[rows], self.chi[rows], self.cdepth[rows]
        mono = c.mono is not None
        return SplitConstraints(
            mono=c.mono if self.dist is None or not mono
            else self.dist.scan_mono(c.mono), out_lo=lo if mono else None,
            out_hi=hi if mono else None,
            depth=depth if c.mono_factor is not None else None,
            factor=c.mono_factor, contri=c.contri, cegb_slope=c.cegb_slope,
            cegb_coupled=c.cegb_coupled,
            cuse=self.cuse if c.cegb_coupled is not None else None)

    def put_best(self, rows, res) -> None:
        """Write B2's result ``res`` (records, or records, cat flags and
        rank rows) into the table rows ``rows`` (an index tensor or a
        slice)."""
        parts = (res,) if self.leaf_rank is None else res
        for dst, src in zip((self.table, self.leaf_cat, self.leaf_rank),
                            parts):
            if isinstance(rows, slice):
                dst[rows].copy_(src)
            else:
                dst.index_copy_(0, rows, src)


class BatchedStep(NamedTuple):
    """The outputs of one batched super-step (B3s-K), which the rest of
    the super-step reads from the device (layouts in csrc/grow_step.cu)."""
    recs: torch.Tensor           # [K, 8] int32 step records
    slot_of_leaf: torch.Tensor   # [L] int32
    idx2: torch.Tensor           # [2K] int64 leaves, then new leaves
    tot2: torch.Tensor           # [2K, 3] f32 children's totals
    po2: torch.Tensor            # [2K] f32 children's parent outputs
    small_left: torch.Tensor     # [K] bool
    keep2: torch.Tensor          # [2K] bool the child may split further
    status: torch.Tensor         # [2] int32 active, valid count


class StepConstraints(NamedTuple):
    """The split controls' state that B3s and B3s-K update (layouts in
    csrc/grow_step.cu), each None when its control is off: ``mono`` [F]
    int8 with the leaves' ranges ``olo``/``ohi`` [rows] f32 and the
    children's ``clo``/``chi`` [C] f32 and ``cdepth`` [C] int32;
    ``groups`` [G, F] bool with ``feature_mask`` [F], the branch sets
    ``fallow`` [rows, F] and the children's allowed masks ``cmask`` [C, F]
    (bool); ``cuse`` [F] bool (CEGB)."""
    mono: Optional[torch.Tensor] = None
    olo: Optional[torch.Tensor] = None
    ohi: Optional[torch.Tensor] = None
    clo: Optional[torch.Tensor] = None
    chi: Optional[torch.Tensor] = None
    cdepth: Optional[torch.Tensor] = None
    groups: Optional[torch.Tensor] = None
    feature_mask: Optional[torch.Tensor] = None
    fallow: Optional[torch.Tensor] = None
    cmask: Optional[torch.Tensor] = None
    cuse: Optional[torch.Tensor] = None


def _check_step_cons(cons: Optional[StepConstraints], rows: int, C: int,
                     device) -> None:
    if cons is None:
        return
    i8, f32, u8 = torch.int8, torch.float32, torch.bool
    ts = check_operands(
        cons, {"mono": ((None,), i8), "olo": ((rows,), f32),
               "ohi": ((rows,), f32), "clo": ((C,), f32),
               "chi": ((C,), f32), "cdepth": ((C,), torch.int32),
               "groups": ((None, None), u8), "feature_mask": ((None,), u8),
               "fallow": ((rows, None), u8), "cmask": ((C, None), u8),
               "cuse": ((None,), u8)},
        together=(("mono", "olo", "ohi", "clo", "chi", "cdepth"),
                  ("groups", "feature_mask", "fallow", "cmask")))
    if any(t.device != device for t in ts):
        raise ValueError("the split controls' state must be on the "
                         "table's device")
    if cons.groups is not None and any(
            t.shape[-1] != cons.groups.shape[1]
            for t in (cons.feature_mask, cons.fallow, cons.cmask)):
        raise TypeError("groups, feature_mask, fallow and cmask must have "
                        "one feature count")


def _step_cons_args(cons: Optional[StepConstraints]) -> tuple:
    """The kernels' split-control arguments (csrc/grow_step.cu
    ``StepCons``, in its field order)."""
    c = cons if cons is not None else StepConstraints()
    g, f = (0, 0) if c.groups is None else tuple(c.groups.shape)
    return (_ptr(c.mono), _ptr(c.olo), _ptr(c.ohi), _ptr(c.clo),
            _ptr(c.chi), _ptr(c.cdepth), _ptr(c.groups), int(g), int(f),
            _ptr(c.feature_mask), _ptr(c.fallow), _ptr(c.cmask),
            _ptr(c.cuse))


_CONS_INPUTS = ("mono", "groups", "feature_mask")


def _cons_plain(cons: Optional[StepConstraints], splits: List[tuple],
                first: bool) -> None:
    """The plain versions' update of the split controls' state for a
    step's slots ``splits``: (on, leaf, new leaf, feature, is
    categorical, depth, left output, right output) each; the children of
    slot k are rows k and n + k (csrc/grow_step.cu), in place on
    ``cons``."""
    if cons is None:
        return
    h = {k: v.cpu().numpy().copy() for k, v in cons._asdict().items()
         if v is not None}
    n = len(splits)
    inf = np.float32(np.inf)
    if "mono" in h:
        for k, (on, leaf, new, feat, icat, depth, lo, ro) in \
                enumerate(splits):
            l_lo, l_hi, r_lo, r_hi, d = -inf, inf, -inf, inf, 0
            if on:
                lo_p = -inf if first else h["olo"][leaf]
                hi_p = inf if first else h["ohi"][leaf]
                mc = int(h["mono"][feat])
                apply, up = mc != 0 and not icat, mc > 0
                mid = np.float32(0.5) * (np.float32(lo) + np.float32(ro))
                l_lo = np.maximum(lo_p, mid) if apply and not up else lo_p
                l_hi = np.minimum(hi_p, mid) if apply and up else hi_p
                r_lo = np.maximum(lo_p, mid) if apply and up else lo_p
                r_hi = np.minimum(hi_p, mid) if apply and not up else hi_p
                d = depth
            h["olo"][leaf], h["ohi"][leaf] = l_lo, l_hi
            h["olo"][new], h["ohi"][new] = r_lo, r_hi
            h["clo"][k], h["chi"][k] = l_lo, l_hi
            h["clo"][n + k], h["chi"][n + k] = r_lo, r_hi
            h["cdepth"][k] = h["cdepth"][n + k] = d
    if "cuse" in h:
        for on, _, _, feat, *_ in splits:
            if on:
                h["cuse"][feat] = True
    if "groups" in h:
        g, fm = h["groups"], h["feature_mask"]
        branches = []
        for on, leaf, _, feat, *_ in splits:
            br = np.zeros(g.shape[1], bool)
            if on:
                if not first:
                    br |= h["fallow"][leaf]
                br[feat] = True
            branches.append(br)
        for k, ((on, leaf, new, *_), br) in enumerate(zip(splits,
                                                           branches)):
            a = fm.copy()
            if on:
                contains = (g | ~br[None]).all(axis=1)
                a = ((g & contains[:, None]).any(axis=0) | br) & fm
            h["fallow"][leaf] = h["fallow"][new] = br
            h["cmask"][k] = h["cmask"][n + k] = a
    for name, arr in h.items():
        if name not in _CONS_INPUTS:
            t = getattr(cons, name)
            t.copy_(torch.from_numpy(arr).to(t.device))


def batch_width(split_batch: int, num_leaves: int) -> int:
    """The super-step width K the grower runs: the JAX package's clamp
    ``max(1, min(split_batch, num_leaves - 1))``."""
    L = int(num_leaves)
    return max(1, min(int(split_batch), L - 1)) if L > 1 else 1


def _draws(ws: GrowWorkspace, feature_mask, num_bin, sampling, rng_iter,
           count: int, bynode_id0: int, extra_step: int, active=None):
    """The per-node draws of ``count`` children (B6-node) into the
    workspace, and B2's mask and random-bin operands: (mask, rand_bin),
    ``(feature_mask, None)`` when no draw is on.  ``feature_mask`` is
    [F], or the children's own allowed masks [count, F] (interaction
    constraints), from which each child's subset is drawn."""
    if sampling is None or not sampling.on:
        return feature_mask, None
    masks, bins = ws.node_mask[:count], ws.node_bins[:count]
    node_draws(feature_mask, num_bin, rng_iter, count=count,
               bynode_id0=bynode_id0, extra_step=extra_step,
               sampling=sampling, masks=masks, bins=bins, active=active)
    return (masks if sampling.bynode else feature_mask,
            bins if sampling.extra_trees else None)


def _check_grow(ws: GrowWorkspace, sampling, rng_iter, is_cat,
                efb=None, quant=None, constraints=None, dist=None) -> None:
    if ws.dist is not dist:
        raise ValueError("the workspace must be made with the grower's "
                         "distribution hooks")
    if dist is not None and sampling is not None and sampling.on:
        raise ValueError("the distributed learners take no per-node draws")
    if ws.cons is not constraints:
        raise ValueError("the workspace must be made with the grower's "
                         "constraints")
    if ws.efb is not efb:
        raise ValueError("the workspace must be made with the grower's "
                         "efb maps")
    if ws.quant != quant:
        raise ValueError("the workspace must be made with the grower's "
                         "quant spec")
    if sampling is not None and sampling.on and rng_iter is None:
        raise ValueError("feature_fraction_bynode and extra_trees need the "
                         "device iteration rng_iter")
    if (is_cat is None) != (ws.leaf_rank is None):
        raise ValueError("is_cat needs a workspace with categorical "
                         "fields, and such a workspace needs is_cat")


def _scan_hist(ws: GrowWorkspace, hist, total, active=None):
    """The children's histograms ``hist`` [C, ...] (a view of the
    workspace's ``gpair`` or the root's) as B2 reads them, in feature
    space: dequantized (B7c) under quant, expanded (B9, with the
    children's ``total`` [C, 3]) with EFB, into ``ws.pair[:C]``."""
    c = hist.shape[0]
    if ws.quant is not None:
        dst = ws.pair if ws.efb is None else ws.gpair_f
        hist = dequantize_hist(hist, ws.qscales, active=active, out=dst[:c])
    if ws.efb is not None:
        hist = expand_group_hist(hist, total, ws.efb, active=active,
                                 out=ws.pair[:c])
    return hist


def _root(ws: GrowWorkspace, binned, vals, feature_mask, num_bin, na_bin,
          params, sampling=None, rng_iter=None, is_cat=None):
    """The root pass of either grower: under quant the scales (B7a) and
    the packed stack (B7b), then the histogram of all rows (B1), sums,
    output, the root's node draws (B6-node) and best split (B2, with
    B2-cat; with interaction constraints on ``feature_mask`` and the union
    of the groups, the JAX package's :628-632), and the reset of the tree,
    the table and the row -> leaf vector.  Returns the vals the steps'
    histogram passes take (the packed stack under quant)."""
    dist = ws.dist
    vals = _root_vals(ws, vals, rng_iter)
    if dist is None:
        h0 = compute_histogram(binned, vals, num_bins=ws.hist_bins,
                               rows_per_block=ws.rows_per_block)
    else:
        h0 = dist.reduce(compute_histogram(
            dist.view(binned), vals, num_bins=ws.hist_bins,
            rows_per_block=ws.rows_per_block,
            out=dist.hist_out(ws.hist.dtype)), ws.qscales)
    _root_finish(ws, h0, vals, feature_mask, num_bin, na_bin, params,
                 sampling, rng_iter, is_cat)
    return vals


def _root_vals(ws: GrowWorkspace, vals, rng_iter):
    """The vals of the tree's histogram passes: under quant the tree's
    scales (B7a; maxed over the ranks with ``dist``) and the packed stack
    (B7b, keyed by ``rng_iter`` and the rows' global ids), else
    ``vals``."""
    if ws.quant is not None:
        scales = quant_scales(vals, ws.quant.qmax, out=ws.qscales)
        offset = 0
        if ws.dist is not None:
            ws.dist.scale_reduce(scales)
            offset = ws.dist.row_offset
        vals = quantize_stack(vals, scales, ws.quant, rng_iter,
                              out=ws.qvals, row_offset=offset)
    return vals


def _root_finish(ws: GrowWorkspace, h0, vals, feature_mask, num_bin,
                 na_bin, params, sampling=None, rng_iter=None,
                 is_cat=None) -> None:
    """The root pass after its histogram ``h0`` (B1): sums, output, node
    draws, best split and the resets (``_root``)."""
    v = ws.fields
    dist = ws.dist
    ws.hist[0].copy_(h0)
    if ws.quant is None:
        total0 = vals.sum(dim=0)
        if dist is not None:
            total0 = dist.sum_reduce(total0)
    else:
        # the exact int32 sums of the packed stack, dequantized as B7c
        # does (the JAX package's _root_eval, grower.py:590-602); the
        # ranks all-reduce the integers
        ti = torch.sum(vals, dim=0, dtype=torch.int32)
        if dist is not None:
            ti = dist.sum_reduce(ti)
        total0 = ti.to(torch.float32) * ws.qscales
    root_out = leaf_output(total0[0], total0[1], params)
    fh0 = _scan_hist(ws, h0[None], total0[None])
    base = feature_mask
    if ws.cons is not None and ws.cons.groups is not None:
        base = torch.logical_and(feature_mask, ws.cons.root_allow,
                                 out=ws.cmask[-1])[None]
    fm, rb = _draws(ws, base, num_bin, sampling, rng_iter, 1, 0, 0)
    res0 = find_best_split(fh0, total0[None], root_out[None], num_bin,
                           na_bin, fm, params, rand_bin=rb, is_cat=is_cat,
                           cons=ws.split_cons(1, root=True))
    if dist is not None:
        res0 = dist.select(res0)
    ws.table.copy_(ws.table_init)
    ws.put_best(slice(0, 1), res0)
    ws.tree.copy_(ws.tree_init)
    v["num_leaves"].fill_(1)
    v["leaf_value"][0:1].copy_(root_out[None])
    v["leaf_weight"][0:1].copy_(total0[1:2])
    v["leaf_count"][0:1].copy_(total0[2:3])
    ws.leaf_of_row.zero_()


def grow_tree(binned: torch.Tensor, vals: torch.Tensor,
              feature_mask: torch.Tensor, num_bin: torch.Tensor,
              na_bin: torch.Tensor, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int = -1,
              workspace: Optional[GrowWorkspace] = None,
              sampling: Optional[NodeSampling] = None,
              rng_iter: Optional[torch.Tensor] = None,
              is_cat: Optional[torch.Tensor] = None,
              efb: Optional[EFBDevice] = None,
              quant: Optional[QuantSpec] = None,
              constraints: Optional[GrowConstraints] = None,
              dist: Optional[DistHooks] = None) -> TreeArrays:
    """Grow one tree on ``binned`` [N, F] uint8 with per-row ``vals``
    [N, 3] f32 = (grad, hess, weight), all on one device, with no host
    round trip.  ``sampling``: the per-node draws, keyed by ``rng_iter``
    (a [1] int32 device tensor).  ``is_cat`` [F] bool: the categorical
    features (the workspace then has categorical fields).  ``efb``: the
    EFB maps, ``binned`` then the bundled [N, G] matrix.  ``quant``:
    quantized training, the stochastic rounding keyed by ``rng_iter``
    (iteration 0 when None).  ``constraints``: the split controls (the
    workspace's ``cuse`` holds the used features on entry).  ``dist``:
    the distribution hooks of a distributed learner (module docstring;
    the workspace is then made with them).  Returns device views of
    ``workspace`` (a new one when None); ``fetch_tree`` brings the tree
    to the host."""
    n, f = binned.shape[0], num_bin.shape[0]
    L, B = int(num_leaves), int(num_bins)
    ws = workspace if workspace is not None else GrowWorkspace(
        n, f, B, L, binned.device, categorical=is_cat is not None, efb=efb,
        quant=quant, constraints=constraints, dist=dist)
    if ws.split_batch != 1:
        raise ValueError("grow_tree needs a workspace of split_batch 1")
    _check_grow(ws, sampling, rng_iter, is_cat, efb, quant, constraints,
                dist)
    scan = _scan(dist, feature_mask, num_bin, na_bin, is_cat)
    vals = _root(ws, binned, vals, *scan[:3], params, sampling, rng_iter,
                 scan[3])
    for i in range(L - 1):
        _split_step(ws, binned, vals, feature_mask, num_bin, na_bin, params,
                    max_depth, i, sampling, rng_iter, is_cat, scan)
    return ws.arrays()


def _scan(dist, feature_mask, num_bin, na_bin, is_cat) -> tuple:
    """B2's (feature_mask, num_bin, na_bin, is_cat): the rank's scan space
    with ``dist``, else the arguments."""
    if dist is None:
        return feature_mask, num_bin, na_bin, is_cat
    return dist.scan_meta(feature_mask, num_bin, na_bin, is_cat)


def _larger_slot(ws: GrowWorkspace) -> torch.Tensor:
    """The slot vector of a strict step's larger child (0 on its rows,
    else -1), for a learner that builds both children (``dist.subtract``
    False): the step record's leaf and new leaf less the smaller one."""
    r = ws.rec
    larger = r[LEAF] + r[NEW_LEAF] - r[SMALLER]
    return torch.where(ws.leaf_of_row == larger, 0, -1).to(torch.int32)


def _split_step(ws: GrowWorkspace, binned, vals, feature_mask, num_bin,
                na_bin, params, max_depth, i=0, sampling=None,
                rng_iter=None, is_cat=None, scan=None) -> None:
    """Step ``i``: B3s, B3, B1 on the smaller child, the subtraction (B7c
    after it under quant, then B9 with EFB), the children's node draws
    (B6-node), B2 on the pair and the depth mask, all indexed by the
    device step record.  With the workspace's ``dist`` the passes go
    through its hooks and B2 takes ``scan`` (``_scan``)."""
    dist = ws.dist
    _step_begin(ws, feature_mask, na_bin, max_depth)
    slot = partition(binned, ws.leaf_of_row, ws.rec, ws.rank, ws.efb)
    active = ws.rec[ACTIVE:ACTIVE + 1]
    if dist is None:
        small = compute_histogram(binned, vals, num_bins=ws.hist_bins,
                                  slot=slot, active=active,
                                  rows_per_block=ws.rows_per_block)
        _step_finish(ws, small, feature_mask, num_bin, na_bin, params, i,
                     sampling, rng_iter, is_cat)
        return
    view = dist.view(binned)

    def child(sl):
        return dist.reduce(compute_histogram(
            view, vals, num_bins=ws.hist_bins, slot=sl, active=active,
            rows_per_block=ws.rows_per_block,
            out=dist.hist_out(ws.hist.dtype)), ws.qscales)

    small = child(slot)
    large = None if dist.subtract else child(_larger_slot(ws))
    _step_finish(ws, small, *scan[:3], params, i, sampling, rng_iter,
                 scan[3], large)


def _step_begin(ws: GrowWorkspace, feature_mask, na_bin,
                max_depth) -> None:
    """A strict step's split (B3s), which writes the step record."""
    grow_step(ws.table, ws.tree, na_bin, num_leaves=ws.num_leaves,
              max_depth=max_depth, rec=ws.rec, idx=ws.idx, fstep=ws.fstep,
              flags=ws.flags, cons=ws.step_cons(feature_mask),
              **ws.cat_state())


def _step_finish(ws: GrowWorkspace, small, feature_mask, num_bin, na_bin,
                 params, i=0, sampling=None, rng_iter=None,
                 is_cat=None, large=None) -> None:
    """A strict step after the smaller child's histogram ``small`` (B1):
    the subtraction (or the larger child's own pass ``large``), B7c and
    B9, the node draws, B2 on the pair (and the workspace's
    ``dist.select``) and the depth mask (``_split_step``)."""
    active = ws.rec[ACTIVE:ACTIVE + 1]
    if large is None:
        large = ws.hist.index_select(0, ws.idx[0:1])[0] - small
    smaller_left = ws.flags[0]
    torch.where(smaller_left, small, large, out=ws.gpair[0])
    torch.where(smaller_left, large, small, out=ws.gpair[1])
    ws.hist.index_copy_(0, ws.idx, ws.gpair)
    # the children's totals: the split's left and right sums
    _scan_hist(ws, ws.gpair, ws.fstep[0:6].view(2, 3), active)
    fm, rb = _draws(ws, _child_base(ws, feature_mask, 2), num_bin, sampling,
                    rng_iter, 2, 2 * (i + 1), i + 1, active)
    res = find_best_split(ws.pair, ws.fstep[0:6].view(2, 3), ws.fstep[6:8],
                          num_bin, na_bin, fm, params, active=active,
                          rand_bin=rb, is_cat=is_cat, cons=ws.split_cons(2))
    if ws.dist is not None:
        res = ws.dist.select(res, active)
    children = res if is_cat is None else res[0]
    children[:, sp.GAIN] = torch.where(ws.flags[1], children[:, sp.GAIN],
                                       ws.neg_inf)
    ws.put_best(ws.idx, res)


def _child_base(ws: GrowWorkspace, feature_mask, count: int):
    """The features a step's ``count`` children may split on: their
    allowed masks [count, F] under interaction constraints (written by
    B3s/B3s-K), else ``feature_mask``."""
    if ws.cons is not None and ws.cons.groups is not None:
        return ws.cmask[:count]
    return feature_mask


def _cat_bins(table, leaf_cat, leaf_rank) -> int:
    """B of the categorical state (0 without it), checked against the
    table's rows."""
    if leaf_rank is None and leaf_cat is None:
        return 0
    rows = table.shape[0]
    if leaf_cat is None or leaf_rank is None or leaf_cat.shape != (rows,) \
            or leaf_cat.dtype != torch.int32 or leaf_rank.dim() != 2 \
            or leaf_rank.shape[0] != rows or leaf_rank.dtype != torch.int32 \
            or not (leaf_cat.is_contiguous() and leaf_rank.is_contiguous()):
        raise TypeError("leaf_cat and leaf_rank must be contiguous int32 "
                        "[rows] and [rows, B] tensors beside the table")
    if leaf_cat.device != table.device or leaf_rank.device != table.device:
        raise ValueError("the categorical state must be on the table's "
                         "device")
    return int(leaf_rank.shape[1])


def _check_step(table, tree, na_bin, num_leaves, rec, idx, fstep, flags,
                cat_bins):
    L = int(num_leaves)
    if table.shape != (L, sp.RECORD) or table.dtype != torch.float32:
        raise TypeError("table must be a [L, 12] float32 tensor")
    if tree.shape != (tree_words(L, cat_bins),) or tree.dtype != torch.int32:
        raise TypeError("tree must be the int32 tree buffer of L leaves")
    for name, t, shape, dtype in (
            ("na_bin", na_bin, None, torch.int32),
            ("rec", rec, (STEP_RECORD,), torch.int32),
            ("idx", idx, (2,), torch.int64),
            ("fstep", fstep, (8,), torch.float32),
            ("flags", flags, (2,), torch.bool)):
        if t.dtype != dtype or (shape is not None and t.shape != shape) \
                or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype} tensor"
                            + (f" of shape {shape}" if shape else ""))
        if t.device != table.device:
            raise ValueError("grow_step inputs must be on one device")
    if not (table.is_contiguous() and tree.is_contiguous()):
        raise ValueError("grow_step needs contiguous tensors")


def grow_step(table: torch.Tensor, tree: torch.Tensor, na_bin: torch.Tensor,
              *, num_leaves: int, max_depth: int, rec: torch.Tensor,
              idx: torch.Tensor, fstep: torch.Tensor, flags: torch.Tensor,
              leaf_cat: Optional[torch.Tensor] = None,
              leaf_rank: Optional[torch.Tensor] = None,
              cons: Optional[StepConstraints] = None) -> None:
    """One split step's bookkeeping (kernel B3s), in place on ``tree`` and
    the step outputs ``rec``, ``idx``, ``fstep`` and ``flags`` (layouts in
    csrc/grow_step.cu).  With the table's categorical companions
    ``leaf_cat`` [L] and ``leaf_rank`` [L, B] (the tree buffer then has
    ``CAT_FIELDS``) the new node takes the leaf's flag and rank row, and a
    categorical split's record has NA_BIN -1.  ``cons``: the split
    controls' state (``StepConstraints``),
    updated for the split in the same launch.  CUDA tensors launch the
    kernel, CPU tensors run ``grow_step_plain``."""
    cat_bins = _cat_bins(table, leaf_cat, leaf_rank)
    _check_step(table, tree, na_bin, num_leaves, rec, idx, fstep, flags,
                cat_bins)
    _check_step_cons(cons, int(num_leaves), 2, table.device)
    if table.device.type == "cpu":
        return grow_step_plain(table, tree, na_bin, num_leaves=num_leaves,
                               max_depth=max_depth, rec=rec, idx=idx,
                               fstep=fstep, flags=flags, leaf_cat=leaf_cat,
                               leaf_rank=leaf_rank, cons=cons)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    err = _kernels.lib("grow_step").lgbt_grow_step(
        table.data_ptr(), tree.data_ptr(), na_bin.data_ptr(),
        int(num_leaves), int(max_depth), _ptr(leaf_cat), _ptr(leaf_rank),
        cat_bins, *_step_cons_args(cons), rec.data_ptr(), idx.data_ptr(),
        fstep.data_ptr(), flags.data_ptr(),
        _kernels.stream_ptr(table.device))
    _kernels.launched("grow_step", err)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _copy_cat(v, node: int, leaf: int, leaf_cat, leaf_rank) -> bool:
    """The plain versions' copy of a leaf's categorical state into node
    ``node`` of the tree fields ``v``; returns the leaf's flag."""
    icat = bool(leaf_cat[leaf])
    v["is_cat_node"][node] = int(icat)
    v["cat_rank"][node] = leaf_rank[leaf]
    return icat


def grow_step_plain(table, tree, na_bin, *, num_leaves: int,
                    max_depth: int, rec, idx, fstep, flags, leaf_cat=None,
                    leaf_rank=None, cons=None) -> None:
    """Plain version of B3s: the same step on host copies (numpy), copied
    back in place."""
    L = int(num_leaves)
    tab = table.cpu().numpy()
    words = tree.cpu().numpy().copy()
    cat_bins = 0 if leaf_rank is None else int(leaf_rank.shape[1])
    v = tree_fields(words, L, cat_bins)
    nl, done = int(v["num_leaves"][0]), int(v["done"][0])
    leaf = int(np.argmax(tab[:, sp.GAIN]))      # first maximum
    best = tab[leaf, sp.GAIN]
    can = done == 0 and nl < L and best > 0.0
    new_leaf = nl if nl < L else L - 1
    r = np.zeros(STEP_RECORD, np.int32)
    ix = np.array([leaf, new_leaf if new_leaf != leaf else (leaf + 1) % L],
                  np.int64)
    fs = np.zeros(8, np.float32)
    fl = np.zeros(2, bool)
    r[LEAF], r[NEW_LEAF], r[ACTIVE] = leaf, new_leaf, int(can)
    if not can:
        v["done"][0] = 1
    else:
        rw = tab[leaf]
        feat, thr = int(rw[sp.FEATURE]), int(rw[sp.THRESHOLD])
        dleft = int(rw[sp.DEFAULT_LEFT] != 0)
        i = nl - 1
        parent = int(v["leaf_parent"][leaf])
        if parent >= 0:
            if v["left_child"][parent] == ~leaf:
                v["left_child"][parent] = i
            if v["right_child"][parent] == ~leaf:
                v["right_child"][parent] = i
        v["left_child"][i], v["right_child"][i] = ~leaf, ~new_leaf
        v["split_feature"][i], v["threshold_bin"][i] = feat, thr
        v["default_left"][i], v["split_gain"][i] = dleft, best
        for src, dst in (("leaf_value", "internal_value"),
                         ("leaf_weight", "internal_weight"),
                         ("leaf_count", "internal_count")):
            v[dst][i] = v[src][leaf]
        v["leaf_value"][leaf] = rw[sp.LEFT_OUTPUT]
        v["leaf_value"][new_leaf] = rw[sp.RIGHT_OUTPUT]
        v["leaf_weight"][leaf], v["leaf_weight"][new_leaf] = rw[5], rw[8]
        v["leaf_count"][leaf], v["leaf_count"][new_leaf] = rw[6], rw[9]
        d = int(v["leaf_depth"][leaf]) + 1
        v["leaf_depth"][leaf] = v["leaf_depth"][new_leaf] = d
        v["leaf_parent"][leaf] = v["leaf_parent"][new_leaf] = i
        v["num_leaves"][0] = nl + 1
        v["n_steps"][0] += 1
        smaller_left = rw[6] <= rw[9]
        icat = cat_bins and _copy_cat(v, i, leaf, leaf_cat.cpu().numpy(),
                                      leaf_rank.cpu().numpy())
        r[FEATURE], r[THRESHOLD], r[DEFAULT_LEFT] = feat, thr, dleft
        r[NA_BIN] = -1 if icat else int(na_bin[feat])
        r[SMALLER] = leaf if smaller_left else new_leaf
        fs[:] = rw[4:12]
        fl[:] = (smaller_left, max_depth <= 0 or d < max_depth)
        _cons_plain(cons, [(1, leaf, new_leaf, feat, bool(icat), d,
                            rw[sp.LEFT_OUTPUT], rw[sp.RIGHT_OUTPUT])],
                    nl == 1)
    dev = tree.device
    tree.copy_(torch.from_numpy(words).to(dev))
    rec.copy_(torch.from_numpy(r).to(dev))
    idx.copy_(torch.from_numpy(ix).to(dev))
    fstep.copy_(torch.from_numpy(fs).to(dev))
    flags.copy_(torch.from_numpy(fl).to(dev))


def _check_rank(rank: torch.Tensor) -> int:
    """The row stride of a rank operand: 0 for one [B] rank for every
    split, B for a [R, B] table indexed by the split's leaf."""
    if rank.dtype != torch.int32 or rank.dim() not in (1, 2):
        raise TypeError("rank must be an int32 [B] vector or [R, B] table")
    return 0 if rank.dim() == 1 else int(rank.shape[1])


def _efb_ptrs(efb) -> tuple:
    """B3's and B3-K's decode maps: (group_of_feat, off_of_feat, nbm1)
    data pointers, or nulls without EFB."""
    if efb is None:
        return None, None, None
    return (efb.group_of_feat.data_ptr(), efb.off_of_feat.data_ptr(),
            efb.nbm1.data_ptr())


def _check_rows(binned, what: str) -> None:
    """A dense [N, F] uint8 matrix or k-hot ``SparseBinned`` rows."""
    if isinstance(binned, SparseBinned):
        return
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError(f"{what}: binned must be a [N, F] uint8 tensor or "
                        "SparseBinned rows")


def _dense_ptr(binned):
    """The dense matrix's data pointer and columns (null for k-hot
    rows)."""
    if isinstance(binned, SparseBinned):
        return None, binned.num_features
    return binned.data_ptr(), binned.shape[1]


def _check_efb(efb, binned) -> None:
    if efb is not None and isinstance(binned, SparseBinned):
        raise ValueError("k-hot rows hold features, never EFB bundles")
    if efb is not None and (binned.shape[1] != efb.num_groups
                            or efb.group_of_feat.device != binned.device):
        raise ValueError(f"binned has {binned.shape[1]} columns on "
                         f"{binned.device}; the EFB maps need "
                         f"{efb.num_groups} on {efb.group_of_feat.device}")


def _feature_column(binned, feat, efb) -> torch.Tensor:
    """The plain versions' bins of feature ``feat`` ([N] int64 feature
    ids): its column, or decoded from its EFB bundle column as the JAX
    package's ``do_split`` does (grower.py:780-785), or from k-hot rows
    (``sparse_data.column_per_row``)."""
    if isinstance(binned, SparseBinned):
        return column_per_row(binned, feat).to(torch.int64)
    if efb is None:
        return torch.gather(binned, 1, feat[:, None])[:, 0].to(torch.int64)
    grp = efb.group_of_feat.to(torch.int64)[feat]
    gcol = torch.gather(binned, 1, grp[:, None])[:, 0].to(torch.int64)
    off = efb.off_of_feat.to(torch.int64)[feat]
    nb = efb.num_bin.to(torch.int64)[feat]
    in_range = (gcol >= off) & (gcol < off + nb - 1)
    return torch.where(off < 0, gcol,
                       torch.where(in_range, gcol - off + 1, 0))


def partition(binned: torch.Tensor, leaf_of_row: torch.Tensor,
              rec: torch.Tensor, rank: torch.Tensor,
              efb=None) -> torch.Tensor:
    """Row partition (kernel B3), in place on ``leaf_of_row``, of the
    split named by the device step record ``rec`` (int32 [8], columns
    ``LEAF`` .. ``ACTIVE``): rows of the leaf that go right move to the new
    leaf (go left iff NA bin ? default_left : r[bin] <= threshold, r =
    ``rank`` [B], or the split leaf's row of ``rank`` [R, B]; a
    categorical split's record has NA bin -1).  With ``efb`` (an
    ``efb.EFBDevice``) ``binned`` is the bundled [N, G] matrix and the
    bin is decoded from the feature's bundle column; ``binned`` may also
    be k-hot ``SparseBinned`` rows (B8b).  Returns the slot
    vector of the next histogram pass (0 where the row is in the smaller
    child, else -1); an inactive step changes nothing and its slot vector
    is unspecified.  CUDA tensors launch the kernel of
    ``csrc/partition.cu``, CPU tensors run ``partition_plain``."""
    _check_rows(binned, "partition")
    if leaf_of_row.shape != (binned.shape[0],) \
            or leaf_of_row.dtype != torch.int32:
        raise TypeError("leaf_of_row must be a [N] int32 tensor")
    stride = _check_rank(rank)
    if rec.shape != (STEP_RECORD,) or rec.dtype != torch.int32:
        raise TypeError("rec must be an int32 step record of 8 columns")
    if any(t.device != binned.device for t in (leaf_of_row, rank, rec)):
        raise ValueError("partition inputs must be on one device")
    _check_efb(efb, binned)
    if binned.device.type == "cpu":
        return partition_plain(binned, leaf_of_row, rec, rank, efb)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and leaf_of_row.is_contiguous()
            and rank.is_contiguous() and rec.is_contiguous()):
        raise ValueError("partition needs contiguous tensors")
    n = binned.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=binned.device)
    if n == 0:
        return slot
    ptr, cols = _dense_ptr(binned)
    err = _kernels.lib("partition").lgbt_partition(
        ptr, n, cols, rec.data_ptr(), rank.data_ptr(), stride,
        *_efb_ptrs(efb), *khot_args(binned), leaf_of_row.data_ptr(),
        slot.data_ptr(), _kernels.stream_ptr(binned.device))
    _kernels.launched("partition", err)
    return slot


def _members_check(binned, leaf_of_rows, ranks, what: str) -> int:
    """The members' count, their rank operands' one stride, and the
    checks the member forms of B3/B3-K make on the shared matrix."""
    if isinstance(binned, SparseBinned):
        raise TypeError(f"{what}: the member forms take a dense binned "
                        "matrix (k-hot rows train solo)")
    _check_rows(binned, what)
    if len(leaf_of_rows) < 1 or len(ranks) != len(leaf_of_rows):
        raise ValueError(f"{what}: one leaf_of_row and rank a member")
    strides = {_check_rank(r) for r in ranks}
    if len(strides) != 1:
        raise ValueError(f"{what}: the members' rank operands must share "
                         "one row stride")
    return strides.pop()


def partition_members(binned: torch.Tensor,
                      leaf_of_rows: Sequence[torch.Tensor],
                      recs: Sequence[torch.Tensor],
                      ranks: Sequence[torch.Tensor],
                      efb=None) -> torch.Tensor:
    """``partition`` of N members over one shared matrix (B3-M): member j
    partitions ``leaf_of_rows[j]`` in place by its step record ``recs[j]``
    and rank ``ranks[j]``; row j of the [N, N_rows] int32 result is its
    slot vector, bitwise the solo form's.  CUDA tensors launch the member
    form of ``csrc/partition.cu`` once for all members, CPU tensors run
    ``partition_members_plain``."""
    stride = _members_check(binned, leaf_of_rows, ranks,
                            "partition_members")
    if len(recs) != len(leaf_of_rows):
        raise ValueError("partition_members: one record a member")
    for lor, rec, rank in zip(leaf_of_rows, recs, ranks):
        _check_member_rows(binned, lor, (rec, rank))
        if rec.shape != (STEP_RECORD,) or rec.dtype != torch.int32:
            raise TypeError("rec must be an int32 step record of 8 columns")
    _check_efb(efb, binned)
    if binned.device.type == "cpu":
        return partition_members_plain(binned, leaf_of_rows, recs, ranks,
                                       efb)
    n = binned.shape[0]
    slot = torch.empty((len(recs), n), dtype=torch.int32,
                       device=binned.device)
    if n == 0:
        return slot
    none = [None] * len(recs)
    table = _kernels.pointer_table((recs, none, none, ranks, leaf_of_rows,
                                    list(slot)))
    err = _kernels.lib("partition").lgbt_partition_members(
        binned.data_ptr(), n, binned.shape[1], table, len(recs), 0, stride,
        *_efb_ptrs(efb), *khot_args(binned),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("partition_members", err)
    return slot


def _check_member_rows(binned, leaf_of_row, tensors) -> None:
    """One member's operands of B3-M/B3-K-M: shapes, one device, and
    contiguous tensors on the card."""
    if leaf_of_row.shape != (binned.shape[0],) \
            or leaf_of_row.dtype != torch.int32:
        raise TypeError("leaf_of_row must be a [N] int32 tensor")
    if binned.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {binned.device}")
    ts = (binned, leaf_of_row) + tuple(tensors)
    if any(t.device != binned.device for t in ts):
        raise ValueError("the member forms' inputs must be on one device")
    if binned.device.type == "cuda" and not all(t.is_contiguous()
                                                for t in ts):
        raise ValueError("the member forms need contiguous tensors")


def partition_members_plain(binned, leaf_of_rows, recs, ranks, efb=None
                            ) -> torch.Tensor:
    """Plain PyTorch version of B3-M: the solo plain version member by
    member, the slot vectors stacked."""
    return torch.stack([partition_plain(binned, lor, rec, rank, efb)
                        for lor, rec, rank in zip(leaf_of_rows, recs,
                                                  ranks)])


def partition_plain(binned, leaf_of_row, rec, rank, efb=None
                    ) -> torch.Tensor:
    """Plain PyTorch version of B3 (``torch.where``, reading the record on
    the device), same contract."""
    r = rec.to(torch.int64)
    col = _feature_column(binned, r[FEATURE].expand(binned.shape[0]), efb)
    is_na = (r[NA_BIN] >= 0) & (col == r[NA_BIN])
    rv = rank[col] if rank.dim() == 1 else rank[r[LEAF], col]
    go_left = torch.where(is_na, r[DEFAULT_LEFT] != 0, rv <= r[THRESHOLD])
    move = (leaf_of_row == r[LEAF]) & ~go_left & (r[ACTIVE] != 0)
    leaf_of_row.copy_(torch.where(move, rec[NEW_LEAF], leaf_of_row))
    return torch.where(leaf_of_row == r[SMALLER], 0, -1).to(torch.int32)


# --- the batched grower (split_batch = K > 1) -------------------------------

def grow_tree_batched(binned: torch.Tensor, vals: torch.Tensor,
                      feature_mask: torch.Tensor, num_bin: torch.Tensor,
                      na_bin: torch.Tensor, *, num_leaves: int,
                      num_bins: int, params: SplitParams,
                      max_depth: int = -1, split_batch: int = 8,
                      workspace: Optional[GrowWorkspace] = None,
                      sampling: Optional[NodeSampling] = None,
                      rng_iter: Optional[torch.Tensor] = None,
                      is_cat: Optional[torch.Tensor] = None,
                      efb: Optional[EFBDevice] = None,
                      quant: Optional[QuantSpec] = None,
                      constraints: Optional[GrowConstraints] = None,
                      dist: Optional[DistHooks] = None) -> TreeArrays:
    """Grow one tree with K splits per super-step (the JAX package's
    ``grow_tree_batched``, grower.py:945): each super-step takes the top K
    leaves by cached gain and splits the valid prefix of them (B3s-K),
    partitions the rows of all K in one pass (B3-K), builds the K smaller
    children's histograms in one pass (B1-K), the larger ones by
    subtraction, and the 2K children's best splits (B2).

    The JAX package loops while the tree can grow; here the tree is a
    fixed sequence of L - 1 super-steps (a chain-shaped tree splits one
    leaf a step, so no smaller count is safe), so that a whole iteration
    can be captured.  Once a super-step finds nothing to split the tree is
    done, and every kernel of a later super-step exits at once; its torch
    ops write only the scratch rows.  ``sampling``/``rng_iter`` as
    ``grow_tree``; the draws of invalid slots keep their places in the
    stream.  ``is_cat``, ``efb``, ``quant``, ``constraints`` and ``dist``
    as ``grow_tree`` (a learner without subtraction grows strictly).
    Returns device views of ``workspace``, as ``grow_tree``."""
    n, f = binned.shape[0], num_bin.shape[0]
    L, B = int(num_leaves), int(num_bins)
    K = batch_width(split_batch, L)
    ws = workspace if workspace is not None else GrowWorkspace(
        n, f, B, L, binned.device, split_batch=K,
        categorical=is_cat is not None, efb=efb, quant=quant,
        constraints=constraints, dist=dist)
    if ws.split_batch != K or K < 2:
        raise ValueError(f"grow_tree_batched needs K > 1 and a workspace "
                         f"of split_batch {K} (has {ws.split_batch})")
    _check_grow(ws, sampling, rng_iter, is_cat, efb, quant, constraints,
                dist)
    if dist is not None and not dist.subtract:
        raise ValueError("a learner without subtraction grows strictly")
    scan = _scan(dist, feature_mask, num_bin, na_bin, is_cat)
    vals = _root(ws, binned, vals, *scan[:3], params, sampling, rng_iter,
                 scan[3])
    for s in range(L - 1):
        _super_step(ws, binned, vals, feature_mask, num_bin, na_bin, params,
                    max_depth, s, sampling, rng_iter, is_cat, scan)
    return ws.arrays()


def _super_step(ws: GrowWorkspace, binned, vals, feature_mask, num_bin,
                na_bin, params, max_depth, s=0, sampling=None,
                rng_iter=None, is_cat=None, scan=None) -> None:
    """Super-step ``s``: B3s-K, B3-K, B1-K over the K smaller children,
    the K subtractions (B7c after them under quant, then B9 with EFB), the
    2K children's node
    draws (B6-node), B2 on the 2K children with the depth mask, and the
    table update, all indexed by the device step outputs.  With the
    workspace's ``dist`` the pass reads ``dist.view(binned)`` and goes
    through ``dist.reduce``, and B2 takes ``scan``."""
    K, st = ws.split_batch, ws.step
    dist = ws.dist
    _super_begin(ws, feature_mask, na_bin, max_depth)
    tslot = partition_slots(binned, ws.leaf_of_row, st, ws.rank, ws.efb)
    small = compute_histogram(binned if dist is None else dist.view(binned),
                              vals, num_bins=ws.hist_bins,
                              slot=tslot, num_slots=K, active=st.status[0:1],
                              slots_used=st.status[1:2],
                              rows_per_block=ws.rows_per_block)
    if dist is not None:
        small = dist.reduce(small, ws.qscales)
        feature_mask, num_bin, na_bin, is_cat = scan
    _super_finish(ws, small, feature_mask, num_bin, na_bin, params, s,
                  sampling, rng_iter, is_cat)


def _super_begin(ws: GrowWorkspace, feature_mask, na_bin,
                 max_depth) -> None:
    """A super-step's splits (B3s-K), which write the step outputs."""
    grow_step_batched(ws.table, ws.tree, na_bin, num_leaves=ws.num_leaves,
                      split_batch=ws.split_batch, max_depth=max_depth,
                      step=ws.step, cons=ws.step_cons(feature_mask),
                      **ws.cat_state())


def _super_finish(ws: GrowWorkspace, small, feature_mask, num_bin, na_bin,
                  params, s=0, sampling=None, rng_iter=None,
                  is_cat=None) -> None:
    """A super-step after the K smaller children's histograms ``small``
    (B1-K): the subtractions, B7c and B9, the node draws, B2 on the 2K
    children with the depth mask, and the table update
    (``_super_step``)."""
    K, st = ws.split_batch, ws.step
    active = st.status[0:1]
    large = ws.hist.index_select(0, st.idx2[:K]) - small
    sel = st.small_left[:, None, None, None]
    torch.where(sel, small, large, out=ws.gpair[:K])
    torch.where(sel, large, small, out=ws.gpair[K:])
    ws.hist.index_copy_(0, st.idx2, ws.gpair)
    _scan_hist(ws, ws.gpair, st.tot2, active)
    fm, rb = _draws(ws, _child_base(ws, feature_mask, 2 * K), num_bin,
                    sampling, rng_iter, 2 * K, (s + 1) * 2 * K, s + 1,
                    active)
    res = find_best_split(ws.pair, st.tot2, st.po2, num_bin, na_bin, fm,
                          params, active=active, rand_bin=rb, is_cat=is_cat,
                          cons=ws.split_cons(2 * K))
    if ws.dist is not None:
        res = ws.dist.select(res, active)
    children = res if is_cat is None else res[0]
    children[:, sp.GAIN] = torch.where(st.keep2, children[:, sp.GAIN],
                                       ws.neg_inf)
    ws.put_best(st.idx2, res)


# --- the integrity layer's shadow grower -----------------------------------

class ShadowGrower:
    """The computation-integrity layer's twin of the grower (the JAX
    package's ``make_shadow_grower``, grower.py:1284: a second trace and a
    second compiled executable of the same grower): ``grow`` runs the
    same ``grow_tree``/``grow_tree_batched`` call as the trainer, over a
    ``GrowWorkspace`` of its own and, on the card, inside
    ``_kernels.shadow_set()``, so every kernel it launches comes from the
    separately built and loaded shadow libraries (counted under
    ``shadow:<kernel>``).  Its workspace copies the primary's shapes and
    ``rows_per_block``: the same launch geometry, so its histograms are
    the primary's bit for bit.  It writes nothing of the primary's: its tree
    buffer, row -> leaf vector, split-control state and CEGB marks are
    its workspace's.  On the CPU it is the plain grower run again
    (``independent`` False, as the JAX package's re-run shadows)."""

    def __init__(self, primary: GrowWorkspace):
        p = primary
        self.ws = GrowWorkspace(
            p.leaf_of_row.numel(), p.node_mask.shape[1], p.num_bins,
            p.num_leaves, p.leaf_of_row.device, split_batch=p.split_batch,
            categorical=p.leaf_rank is not None, efb=p.efb, quant=p.quant,
            constraints=p.cons, rows_per_block=p.rows_per_block)
        self.independent = p.leaf_of_row.device.type == "cuda"

    def grow(self, grow_fn, binned, vals, feature_mask, num_bin, na_bin, *,
             cuse: Optional[torch.Tensor] = None, **kw) -> torch.Tensor:
        """``grow_fn(binned, vals, feature_mask, num_bin, na_bin,
        workspace=<the shadow's>, **kw)`` through the shadow set; ``cuse``:
        the used features the primary's tree started from (CEGB), set
        into the shadow's workspace first.  Returns the shadow's tree
        buffer."""
        ws = self.ws
        if cuse is not None:
            ws.cuse.copy_(cuse)
        if self.independent:
            with _kernels.shadow_set():
                grow_fn(binned, vals, feature_mask, num_bin, na_bin,
                        workspace=ws, **kw)
        else:
            grow_fn(binned, vals, feature_mask, num_bin, na_bin,
                    workspace=ws, **kw)
        return ws.tree


def make_shadow_grower(primary: GrowWorkspace) -> ShadowGrower:
    """The shadow twin of the grower that grows into ``primary``
    (``ShadowGrower``)."""
    return ShadowGrower(primary)


# --- lockstep growth of a fleet's members ----------------------------------

class GrowMember(NamedTuple):
    """One fleet member's operands of ``grow_trees_lockstep``: its
    workspace (its leaf budget, split batch, quant spec and split controls
    with it), its row weights ``vals`` [N, 3], feature mask, split
    parameters, depth limit and node draws keyed by ``rng_iter``."""
    ws: GrowWorkspace
    vals: torch.Tensor
    feature_mask: torch.Tensor
    params: SplitParams
    max_depth: int = -1
    sampling: Optional[NodeSampling] = None
    rng_iter: Optional[torch.Tensor] = None


def grow_trees_lockstep(binned: torch.Tensor, members: Sequence[GrowMember],
                        num_bin: torch.Tensor, na_bin: torch.Tensor, *,
                        is_cat: Optional[torch.Tensor] = None,
                        efb: Optional[EFBDevice] = None
                        ) -> List[TreeArrays]:
    """One tree for each fleet member over the shared dense ``binned``,
    the members in lockstep (the member form of ``grow_tree`` and
    ``grow_tree_batched``; the JAX package's ``build_fleet_superepoch``
    vmaps the grower over the member axis).  Each member runs its solo
    grower's steps in its solo order on its own operands, so its tree is
    the solo tree bit for bit; the passes that read the shared matrix go
    out once for every member: the root pass and each step's histogram
    (B1-M, B1-K-M, or B1-int-M/B1-K-int-M under quant) and partition (B3-M,
    B3-K-M).  B7a/B7b, B3s/B3s-K, the subtraction, B7c, B9, B6-node and
    B2/B2-cat stay one launch a member, in member order.  Every member
    has one split batch K; with different leaf budgets the lockstep runs
    the largest budget's steps, and a member past its own last step has
    its step record's active flag (K > 1: its status) zeroed, which the
    shared passes read per member.  Returns each member's device tree
    views."""
    if not members:
        raise ValueError("grow_trees_lockstep needs a member")
    K = members[0].ws.split_batch
    if any(m.ws.split_batch != K for m in members):
        raise ValueError("the members must share one split batch K")
    if len({m.ws.hist_bins for m in members}) != 1:
        raise ValueError("the members' histograms must share one bin axis")
    if len({m.ws.rows_per_block for m in members}) != 1:
        raise ValueError("the members must share one rows_per_block")
    for m in members:
        _check_grow(m.ws, m.sampling, m.rng_iter, is_cat, efb, m.ws.quant,
                    m.ws.cons)
    hist_bins = members[0].ws.hist_bins
    rpb = members[0].ws.rows_per_block
    vals = [_root_vals(m.ws, m.vals, m.rng_iter) for m in members]
    h0 = compute_histogram_members(binned, vals, num_bins=hist_bins,
                                   rows_per_block=rpb)
    for j, m in enumerate(members):
        _root_finish(m.ws, h0[j], vals[j], m.feature_mask, num_bin, na_bin,
                     m.params, m.sampling, m.rng_iter, is_cat)
    last = [m.ws.num_leaves - 1 for m in members]
    for i in range(max(last)):
        for m, n_steps in zip(members, last):
            if i < n_steps:
                begin = _step_begin if K == 1 else _super_begin
                begin(m.ws, m.feature_mask, na_bin, m.max_depth)
            elif i == n_steps:
                # past its budget: its shared passes exit at once
                if K == 1:
                    m.ws.rec[ACTIVE].zero_()
                else:
                    m.ws.step.status.zero_()
        wss = [m.ws for m in members]
        lors = [ws.leaf_of_row for ws in wss]
        ranks = [ws.rank for ws in wss]
        if K == 1:
            slots = partition_members(binned, lors, [ws.rec for ws in wss],
                                      ranks, efb)
            small = compute_histogram_members(
                binned, vals, num_bins=hist_bins, slots=list(slots),
                actives=[ws.rec[ACTIVE:ACTIVE + 1] for ws in wss],
                rows_per_block=rpb)
        else:
            steps = [ws.step for ws in wss]
            slots = partition_slots_members(binned, lors, steps, ranks, efb)
            small = compute_histogram_members(
                binned, vals, num_bins=hist_bins, slots=list(slots),
                num_slots=K, actives=[st.status[0:1] for st in steps],
                slots_used=[st.status[1:2] for st in steps],
                rows_per_block=rpb)
        finish = _step_finish if K == 1 else _super_finish
        for j, (m, n_steps) in enumerate(zip(members, last)):
            if i < n_steps:
                finish(m.ws, small[j], m.feature_mask, num_bin, na_bin,
                       m.params, i, m.sampling, m.rng_iter, is_cat)
    return [m.ws.arrays() for m in members]


def _check_batched(table, tree, na_bin, L, K, step: BatchedStep,
                   cat_bins: int) -> None:
    if table.shape != (L + 2 * K, sp.RECORD) or table.dtype != torch.float32:
        raise TypeError("table must be a [L + 2K, 12] float32 tensor")
    if tree.shape != (tree_words(L, cat_bins),) or tree.dtype != torch.int32:
        raise TypeError("tree must be the int32 tree buffer of L leaves")
    want = {"recs": ((K, STEP_RECORD), torch.int32),
            "slot_of_leaf": ((L,), torch.int32),
            "idx2": ((2 * K,), torch.int64),
            "tot2": ((2 * K, 3), torch.float32),
            "po2": ((2 * K,), torch.float32),
            "small_left": ((K,), torch.bool),
            "keep2": ((2 * K,), torch.bool),
            "status": ((2,), torch.int32)}
    for name, (shape, dtype) in want.items():
        t = getattr(step, name)
        if t.shape != shape or t.dtype != dtype or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {dtype} tensor "
                            f"of shape {shape}")
        if t.device != table.device:
            raise ValueError("grow_step_batched inputs must be on one "
                             "device")
    if na_bin.dtype != torch.int32 or na_bin.device != table.device:
        raise TypeError("na_bin must be an int32 tensor on the table's "
                        "device")
    if not (table.is_contiguous() and tree.is_contiguous()):
        raise ValueError("grow_step_batched needs contiguous tensors")
    if not 1 < K < L or K > 256:
        raise ValueError(f"split_batch {K} must be in 2..min(L - 1, 256)")


def grow_step_batched(table: torch.Tensor, tree: torch.Tensor,
                      na_bin: torch.Tensor, *, num_leaves: int,
                      split_batch: int, max_depth: int, step: BatchedStep,
                      leaf_cat: Optional[torch.Tensor] = None,
                      leaf_rank: Optional[torch.Tensor] = None,
                      cons: Optional[StepConstraints] = None) -> None:
    """One batched super-step's bookkeeping (kernel B3s-K), in place on
    ``tree`` and the step outputs ``step`` (layouts in
    csrc/grow_step.cu).  A super-step that finds the tree already done
    changes nothing: the outputs of the super-step that found it done
    stay.  ``leaf_cat``/``leaf_rank`` [L + 2K, ..] as ``grow_step``: each
    valid slot's node takes its leaf's flag and rank row.  ``cons`` as
    ``grow_step`` (rows L + 2K, 2K children).  CUDA tensors launch the
    kernel, CPU tensors run ``grow_step_batched_plain``."""
    L, K = int(num_leaves), int(split_batch)
    cat_bins = _cat_bins(table, leaf_cat, leaf_rank)
    _check_batched(table, tree, na_bin, L, K, step, cat_bins)
    _check_step_cons(cons, L + 2 * K, 2 * K, table.device)
    if table.device.type == "cpu":
        return grow_step_batched_plain(table, tree, na_bin, num_leaves=L,
                                       split_batch=K, max_depth=max_depth,
                                       step=step, leaf_cat=leaf_cat,
                                       leaf_rank=leaf_rank, cons=cons)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    err = _kernels.lib("grow_step").lgbt_grow_step_batched(
        table.data_ptr(), tree.data_ptr(), na_bin.data_ptr(), L, K,
        int(max_depth), _ptr(leaf_cat), _ptr(leaf_rank), cat_bins,
        *_step_cons_args(cons),
        *[getattr(step, name).data_ptr() for name in BatchedStep._fields],
        _kernels.stream_ptr(table.device))
    _kernels.launched("grow_step_batched", err)


def grow_step_batched_plain(table, tree, na_bin, *, num_leaves: int,
                            split_batch: int, max_depth: int,
                            step: BatchedStep, leaf_cat=None,
                            leaf_rank=None, cons=None) -> None:
    """Plain version of B3s-K: the same super-step on host copies (numpy),
    copied back in place."""
    L, K = int(num_leaves), int(split_batch)
    words = tree.cpu().numpy().copy()
    cat_bins = 0 if leaf_rank is None else int(leaf_rank.shape[1])
    v = tree_fields(words, L, cat_bins)
    if int(v["done"][0]):
        return               # the first dead super-step's outputs stay
    tab = table.cpu().numpy()
    nl = int(v["num_leaves"][0])
    g = tab[:L, sp.GAIN]
    key = np.where(np.isnan(g), -np.inf, g)
    top = np.lexsort((np.arange(L), -key))[:K]     # lax.top_k's order
    nvalid = 0
    while nvalid < K and nvalid < L - nl and tab[top[nvalid], 0] > 0.0:
        nvalid += 1
    nab = na_bin.cpu().numpy()
    if cat_bins:
        lcat, lrank = leaf_cat.cpu().numpy(), leaf_rank.cpu().numpy()
    recs = np.zeros((K, STEP_RECORD), np.int32)
    slot_of_leaf = np.full(L, -1, np.int32)
    idx2 = np.zeros(2 * K, np.int64)
    tot2 = np.zeros((2 * K, 3), np.float32)
    po2 = np.zeros(2 * K, np.float32)
    small_left = np.zeros(K, bool)
    keep2 = np.zeros(2 * K, bool)
    splits = []
    for k in range(K):
        valid = k < nvalid
        leaf = int(top[k]) if valid else L + k
        new_leaf = nl + k if valid else L + K + k
        splits.append((0, leaf, new_leaf, 0, False, 0, 0.0, 0.0))
        r = tab[leaf]
        idx2[k], idx2[K + k] = leaf, new_leaf
        tot2[k], tot2[K + k] = r[4:7], r[7:10]
        po2[k], po2[K + k] = r[10], r[11]
        sleft = bool(r[6] <= r[9])
        small_left[k] = sleft
        recs[k, LEAF], recs[k, NEW_LEAF] = leaf, new_leaf
        recs[k, ACTIVE] = int(valid)
        if not valid:
            recs[k, NA_BIN], recs[k, SMALLER] = -1, leaf
            continue
        feat, thr = int(r[sp.FEATURE]), int(r[sp.THRESHOLD])
        dleft = int(r[sp.DEFAULT_LEFT] != 0)
        node = nl - 1 + k
        parent = int(v["leaf_parent"][leaf])
        if parent >= 0:
            if v["left_child"][parent] == ~leaf:
                v["left_child"][parent] = node
            if v["right_child"][parent] == ~leaf:
                v["right_child"][parent] = node
        v["left_child"][node], v["right_child"][node] = ~leaf, ~new_leaf
        v["split_feature"][node], v["threshold_bin"][node] = feat, thr
        v["default_left"][node], v["split_gain"][node] = dleft, r[sp.GAIN]
        for src, dst in (("leaf_value", "internal_value"),
                         ("leaf_weight", "internal_weight"),
                         ("leaf_count", "internal_count")):
            v[dst][node] = v[src][leaf]
        v["leaf_value"][leaf], v["leaf_value"][new_leaf] = r[10], r[11]
        v["leaf_weight"][leaf], v["leaf_weight"][new_leaf] = r[5], r[8]
        v["leaf_count"][leaf], v["leaf_count"][new_leaf] = r[6], r[9]
        d = int(v["leaf_depth"][leaf]) + 1
        v["leaf_depth"][leaf] = v["leaf_depth"][new_leaf] = d
        v["leaf_parent"][leaf] = v["leaf_parent"][new_leaf] = node
        icat = cat_bins and _copy_cat(v, node, leaf, lcat, lrank)
        recs[k, FEATURE], recs[k, THRESHOLD] = feat, thr
        recs[k, DEFAULT_LEFT] = dleft
        recs[k, NA_BIN] = -1 if icat else int(nab[feat])
        recs[k, SMALLER] = leaf if sleft else new_leaf
        keep2[k] = keep2[K + k] = max_depth <= 0 or d < max_depth
        slot_of_leaf[leaf] = k
        splits[k] = (1, leaf, new_leaf, feat, bool(icat), d, r[10], r[11])
    _cons_plain(cons, splits, nl == 1)
    if nvalid > 0:
        v["num_leaves"][0] = nl + nvalid
        v["n_steps"][0] += 1
    else:
        v["done"][0] = 1
    dev = tree.device
    tree.copy_(torch.from_numpy(words).to(dev))
    for name, arr in (("recs", recs), ("slot_of_leaf", slot_of_leaf),
                      ("idx2", idx2), ("tot2", tot2), ("po2", po2),
                      ("small_left", small_left), ("keep2", keep2),
                      ("status", np.array([int(nvalid > 0), nvalid],
                                          np.int32))):
        getattr(step, name).copy_(torch.from_numpy(arr).to(dev))


def partition_slots(binned: torch.Tensor, leaf_of_row: torch.Tensor,
                    step: BatchedStep, rank: torch.Tensor,
                    efb=None) -> torch.Tensor:
    """The batched row partition (kernel B3-K), in place on
    ``leaf_of_row``: a row of a leaf that splits in this super-step (slot
    ``step.slot_of_leaf[leaf] = k``) takes record k's split (go left iff
    NA bin ? default_left : r[bin] <= threshold, r = ``rank`` [B] or the
    row of record k's leaf in ``rank`` [R, B]; right rows move to the new
    leaf).  Returns the [N] int32 target slots of the K-slot
    histogram pass: k where the row ends in slot k's smaller child, else
    -1; a dead super-step (``step.status[0] == 0``) changes nothing and
    its target slots are unspecified.  ``efb``: the bundled matrix's
    decode maps, as ``partition``; k-hot ``SparseBinned`` rows as
    ``partition``.  CUDA tensors launch the kernel of
    ``csrc/partition.cu``, CPU tensors run ``partition_slots_plain``."""
    _check_rows(binned, "partition_slots")
    if leaf_of_row.shape != (binned.shape[0],) \
            or leaf_of_row.dtype != torch.int32:
        raise TypeError("leaf_of_row must be a [N] int32 tensor")
    stride = _check_rank(rank)
    if step.recs.dim() != 2 or step.recs.shape[1] != STEP_RECORD \
            or step.recs.dtype != torch.int32 \
            or step.slot_of_leaf.dtype != torch.int32 \
            or step.status.dtype != torch.int32:
        raise TypeError("step must hold int32 records, slots and status")
    tensors = (leaf_of_row, rank, step.recs, step.slot_of_leaf,
               step.status)
    if any(t.device != binned.device for t in tensors):
        raise ValueError("partition_slots inputs must be on one device")
    _check_efb(efb, binned)
    if binned.device.type == "cpu":
        return partition_slots_plain(binned, leaf_of_row, step, rank, efb)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and all(t.is_contiguous()
                                           for t in tensors)):
        raise ValueError("partition_slots needs contiguous tensors")
    n = binned.shape[0]
    tslot = torch.empty(n, dtype=torch.int32, device=binned.device)
    if n == 0:
        return tslot
    ptr, cols = _dense_ptr(binned)
    err = _kernels.lib("partition").lgbt_partition_slots(
        ptr, n, cols, step.recs.data_ptr(),
        step.slot_of_leaf.data_ptr(), step.status.data_ptr(),
        rank.data_ptr(), stride, *_efb_ptrs(efb), *khot_args(binned),
        leaf_of_row.data_ptr(), tslot.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("partition_slots", err)
    return tslot


def partition_slots_members(binned: torch.Tensor,
                            leaf_of_rows: Sequence[torch.Tensor],
                            steps: Sequence[BatchedStep],
                            ranks: Sequence[torch.Tensor],
                            efb=None) -> torch.Tensor:
    """``partition_slots`` of N members over one shared matrix (B3-K-M):
    member j partitions ``leaf_of_rows[j]`` in place by its super-step
    outputs ``steps[j]`` (records, slot_of_leaf, status) and rank
    ``ranks[j]``; row j of the [N, N_rows] int32 result is its target
    slots, bitwise the solo form's.  CUDA tensors launch the member form of
    ``csrc/partition.cu`` once for all members, CPU tensors run
    ``partition_slots_members_plain``."""
    stride = _members_check(binned, leaf_of_rows, ranks,
                            "partition_slots_members")
    if len(steps) != len(leaf_of_rows):
        raise ValueError("partition_slots_members: one step a member")
    for st in steps:
        if st.recs.dim() != 2 or st.recs.shape[1] != STEP_RECORD \
                or st.recs.dtype != torch.int32 \
                or st.slot_of_leaf.dtype != torch.int32 \
                or st.status.dtype != torch.int32:
            raise TypeError("step must hold int32 records, slots and "
                            "status")
    if len({st.recs.shape[0] for st in steps}) != 1:
        raise ValueError("the members must share one split batch K")
    for lor, st, rank in zip(leaf_of_rows, steps, ranks):
        _check_member_rows(binned, lor, (rank, st.recs, st.slot_of_leaf,
                                         st.status))
    _check_efb(efb, binned)
    if binned.device.type == "cpu":
        return partition_slots_members_plain(binned, leaf_of_rows, steps,
                                             ranks, efb)
    n = binned.shape[0]
    tslot = torch.empty((len(steps), n), dtype=torch.int32,
                        device=binned.device)
    if n == 0:
        return tslot
    table = _kernels.pointer_table((
        [st.recs for st in steps], [st.slot_of_leaf for st in steps],
        [st.status for st in steps], ranks, leaf_of_rows, list(tslot)))
    err = _kernels.lib("partition").lgbt_partition_members(
        binned.data_ptr(), n, binned.shape[1], table, len(steps), 1, stride,
        *_efb_ptrs(efb), *khot_args(binned),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("partition_slots_members", err)
    return tslot


def partition_slots_members_plain(binned, leaf_of_rows, steps, ranks,
                                  efb=None) -> torch.Tensor:
    """Plain PyTorch version of B3-K-M: the solo plain version member by
    member, the target slots stacked."""
    return torch.stack([partition_slots_plain(binned, lor, st, rank, efb)
                        for lor, st, rank in zip(leaf_of_rows, steps,
                                                 ranks)])


def partition_slots_plain(binned, leaf_of_row, step: BatchedStep,
                          rank, efb=None) -> torch.Tensor:
    """Plain PyTorch version of B3-K (gathers and ``torch.where``), same
    contract."""
    if not bool(step.status[0]):
        return torch.full_like(leaf_of_row, -1)
    lor = leaf_of_row.to(torch.int64)
    k = step.slot_of_leaf.to(torch.int64)[lor]
    on = k >= 0
    r = step.recs.to(torch.int64)[k.clamp_min(0)]           # [N, 8]
    col = _feature_column(binned, r[:, FEATURE], efb)
    is_na = (r[:, NA_BIN] >= 0) & (col == r[:, NA_BIN])
    rv = rank[col] if rank.dim() == 1 else rank[r[:, LEAF], col]
    go_left = torch.where(is_na, r[:, DEFAULT_LEFT] != 0,
                          rv <= r[:, THRESHOLD])
    new = torch.where(on & ~go_left, r[:, NEW_LEAF], lor)
    leaf_of_row.copy_(new.to(torch.int32))
    tslot = torch.where(on & (new == r[:, SMALLER]), k, -1)
    return tslot.to(torch.int32)
