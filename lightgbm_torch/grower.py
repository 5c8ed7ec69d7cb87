"""Strict leaf-wise tree grower, resident on the device.

Counterpart of the JAX package's ``grower.py`` ``grow_tree`` (the masked
one-program learner at ``split_batch=1``).  The JAX package runs the tree
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

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from .ops import split as sp
from .ops.histogram import compute_histogram
from .ops.split import SplitParams, find_best_split, leaf_output
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
)
# step record (int32) columns, written by B3s and read by B3, B1 and B2
LEAF, NEW_LEAF, FEATURE, THRESHOLD, DEFAULT_LEFT, NA_BIN, SMALLER, ACTIVE = \
    range(8)
STEP_RECORD = 8


def tree_layout(num_leaves: int) -> Dict[str, tuple]:
    """name -> (offset, length, kind) of the tree buffer for L leaves."""
    L = int(num_leaves)
    sizes = {1: 1, "n": L - 1, "L": L}
    out, off = {}, 0
    for name, size, kind in TREE_FIELDS:
        out[name] = (off, sizes[size], kind)
        off += sizes[size]
    return out


def tree_words(num_leaves: int) -> int:
    """Length of the tree buffer in int32 words."""
    return sum(n for _, n, _ in tree_layout(num_leaves).values())


def tree_fields(words, num_leaves: int) -> Dict[str, object]:
    """Views of every field of a tree buffer ``words`` (a torch int32
    tensor or a numpy int32 array); f32 fields are views by bit
    pattern."""
    f32 = torch.float32 if isinstance(words, torch.Tensor) else np.float32
    out = {}
    for name, (off, n, kind) in tree_layout(num_leaves).items():
        v = words[off:off + n]
        out[name] = v.view(f32) if kind == "f" else v
    return out


class TreeArrays(NamedTuple):
    """Array-encoded tree (the JAX package's ``grower.TreeArrays``).

    Internal nodes are 0..num_leaves-2; a child pointer < 0 encodes leaf
    ``~child``; tree-sized fields are sized to the leaf budget L.  From
    ``grow_tree`` every field is a device tensor (a view of the
    workspace's tree buffer; ``num_leaves`` is a [1] tensor and
    ``n_steps``, ``is_cat_node`` and ``cat_rank`` are None); from
    ``host_tree`` they are numpy arrays and ``num_leaves``/``n_steps``
    ints."""
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
    is_cat_node: object          # [L-1] bool (all False: numerical only)
    cat_rank: object             # [L-1, B] int32 (identity rank)
    n_steps: object              # split steps taken (== splits)


def host_tree(words: np.ndarray, num_leaves: int, num_bins: int,
              leaf_of_row: Optional[torch.Tensor] = None) -> TreeArrays:
    """Host ``TreeArrays`` from a fetched tree buffer (numpy int32)."""
    v = tree_fields(np.asarray(words, np.int32), num_leaves)
    nl = int(v["num_leaves"][0])
    nn = max(int(num_leaves) - 1, 0)
    return TreeArrays(
        num_leaves=nl, split_feature=v["split_feature"],
        threshold_bin=v["threshold_bin"],
        default_left=v["default_left"] != 0, left_child=v["left_child"],
        right_child=v["right_child"], split_gain=v["split_gain"],
        leaf_value=v["leaf_value"], leaf_weight=v["leaf_weight"],
        leaf_count=v["leaf_count"], internal_value=v["internal_value"],
        internal_weight=v["internal_weight"],
        internal_count=v["internal_count"], leaf_depth=v["leaf_depth"],
        leaf_of_row=leaf_of_row, is_cat_node=np.zeros(nn, bool),
        cat_rank=np.broadcast_to(np.arange(num_bins, dtype=np.int32),
                                 (nn, num_bins)).copy(),
        n_steps=nl - 1)


def fetch_tree(ws: "GrowWorkspace") -> TreeArrays:
    """The workspace's last tree on the host, in one copy."""
    return host_tree(ws.tree.cpu().numpy(), ws.num_leaves, ws.num_bins,
                     ws.leaf_of_row)


class GrowWorkspace:
    """Every device tensor of a tree build, allocated once for the
    shapes (N rows, F features, B bins, L leaves): the tree buffer and its
    reset image, the [L, 12] best-split table, the per-leaf histograms,
    the row -> leaf vector, the step record and its companions, and the
    children's histogram pair."""

    def __init__(self, n: int, num_features: int, num_bins: int,
                 num_leaves: int, device: torch.device):
        L, F, B = int(num_leaves), int(num_features), int(num_bins)
        self.num_leaves, self.num_bins = L, B
        kw = {"device": device}
        init = torch.zeros(tree_words(L), dtype=torch.int32)
        tree_fields(init, L)["leaf_parent"].fill_(-1)
        self.tree_init = init.to(device)
        self.tree = self.tree_init.clone()
        self.fields = tree_fields(self.tree, L)
        table_init = torch.zeros((L, sp.RECORD), dtype=torch.float32)
        table_init[:, sp.GAIN] = float("-inf")
        self.table_init = table_init.to(device)
        self.table = self.table_init.clone()
        self.hist = torch.zeros((L, F, B, 3), dtype=torch.float32, **kw)
        self.pair = torch.zeros((2, F, B, 3), dtype=torch.float32, **kw)
        self.leaf_of_row = torch.zeros(n, dtype=torch.int32, **kw)
        self.rank_iota = torch.arange(B, dtype=torch.int32, **kw)
        self.rec = torch.zeros(STEP_RECORD, dtype=torch.int32, **kw)
        self.idx = torch.zeros(2, dtype=torch.int64, **kw)
        self.fstep = torch.zeros(8, dtype=torch.float32, **kw)
        self.flags = torch.zeros(2, dtype=torch.bool, **kw)
        self.neg_inf = torch.full((), float("-inf"), **kw)

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
            leaf_of_row=self.leaf_of_row, is_cat_node=None, cat_rank=None,
            n_steps=None)


def grow_tree(binned: torch.Tensor, vals: torch.Tensor,
              feature_mask: torch.Tensor, num_bin: torch.Tensor,
              na_bin: torch.Tensor, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int = -1,
              workspace: Optional[GrowWorkspace] = None) -> TreeArrays:
    """Grow one tree on ``binned`` [N, F] uint8 with per-row ``vals``
    [N, 3] f32 = (grad, hess, weight), all on one device, with no host
    round trip.  Returns device views of ``workspace`` (a new one when
    None); ``fetch_tree`` brings the tree to the host."""
    n, f = binned.shape
    L, B = int(num_leaves), int(num_bins)
    ws = workspace if workspace is not None else GrowWorkspace(
        n, f, B, L, binned.device)
    v = ws.fields

    # --- root: histogram, sums, output, best split ------------------------
    h0 = compute_histogram(binned, vals, num_bins=B)
    ws.hist[0].copy_(h0)
    total0 = vals.sum(dim=0)
    root_out = leaf_output(total0[0], total0[1], params)
    rec0 = find_best_split(h0[None], total0[None], root_out[None], num_bin,
                           na_bin, feature_mask, params)
    ws.table.copy_(ws.table_init)
    ws.table[0:1].copy_(rec0)
    ws.tree.copy_(ws.tree_init)
    v["num_leaves"].fill_(1)
    v["leaf_value"][0:1].copy_(root_out[None])
    v["leaf_weight"][0:1].copy_(total0[1:2])
    v["leaf_count"][0:1].copy_(total0[2:3])
    ws.leaf_of_row.zero_()

    for _ in range(L - 1):
        _split_step(ws, binned, vals, feature_mask, num_bin, na_bin, params,
                    max_depth)
    return ws.arrays()


def _split_step(ws: GrowWorkspace, binned, vals, feature_mask, num_bin,
                na_bin, params, max_depth) -> None:
    """One step: B3s, B3, B1 on the smaller child, the subtraction, B2 on
    the pair and the depth mask, all indexed by the device step record."""
    grow_step(ws.table, ws.tree, na_bin, num_leaves=ws.num_leaves,
              max_depth=max_depth, rec=ws.rec, idx=ws.idx, fstep=ws.fstep,
              flags=ws.flags)
    active = ws.rec[ACTIVE:ACTIVE + 1]
    slot = partition(binned, ws.leaf_of_row, ws.rec, ws.rank_iota)
    small = compute_histogram(binned, vals, num_bins=ws.num_bins, slot=slot,
                              active=active)
    large = ws.hist.index_select(0, ws.idx[0:1])[0] - small
    smaller_left = ws.flags[0]
    torch.where(smaller_left, small, large, out=ws.pair[0])
    torch.where(smaller_left, large, small, out=ws.pair[1])
    ws.hist.index_copy_(0, ws.idx, ws.pair)
    children = find_best_split(ws.pair, ws.fstep[0:6].view(2, 3),
                               ws.fstep[6:8], num_bin, na_bin, feature_mask,
                               params, active=active)
    children[:, sp.GAIN] = torch.where(ws.flags[1], children[:, sp.GAIN],
                                       ws.neg_inf)
    ws.table.index_copy_(0, ws.idx, children)


def _check_step(table, tree, na_bin, num_leaves, rec, idx, fstep, flags):
    L = int(num_leaves)
    if table.shape != (L, sp.RECORD) or table.dtype != torch.float32:
        raise TypeError("table must be a [L, 12] float32 tensor")
    if tree.shape != (tree_words(L),) or tree.dtype != torch.int32:
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
              idx: torch.Tensor, fstep: torch.Tensor,
              flags: torch.Tensor) -> None:
    """One split step's bookkeeping (kernel B3s), in place on ``tree`` and
    the step outputs ``rec``, ``idx``, ``fstep`` and ``flags`` (layouts in
    csrc/grow_step.cu).  CUDA tensors launch the kernel, CPU tensors run
    ``grow_step_plain``."""
    _check_step(table, tree, na_bin, num_leaves, rec, idx, fstep, flags)
    if table.device.type == "cpu":
        return grow_step_plain(table, tree, na_bin, num_leaves=num_leaves,
                               max_depth=max_depth, rec=rec, idx=idx,
                               fstep=fstep, flags=flags)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    err = _kernels.lib("grow_step").lgbt_grow_step(
        table.data_ptr(), tree.data_ptr(), na_bin.data_ptr(),
        int(num_leaves), int(max_depth), rec.data_ptr(), idx.data_ptr(),
        fstep.data_ptr(), flags.data_ptr(),
        _kernels.stream_ptr(table.device))
    _kernels.launched("grow_step", err)


def grow_step_plain(table, tree, na_bin, *, num_leaves: int,
                    max_depth: int, rec, idx, fstep, flags) -> None:
    """Plain version of B3s: the same step on host copies (numpy), copied
    back in place."""
    L = int(num_leaves)
    tab = table.cpu().numpy()
    words = tree.cpu().numpy().copy()
    v = tree_fields(words, L)
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
        smaller_left = rw[6] <= rw[9]
        r[FEATURE], r[THRESHOLD], r[DEFAULT_LEFT] = feat, thr, dleft
        r[NA_BIN] = int(na_bin[feat])
        r[SMALLER] = leaf if smaller_left else new_leaf
        fs[:] = rw[4:12]
        fl[:] = (smaller_left, max_depth <= 0 or d < max_depth)
    dev = tree.device
    tree.copy_(torch.from_numpy(words).to(dev))
    rec.copy_(torch.from_numpy(r).to(dev))
    idx.copy_(torch.from_numpy(ix).to(dev))
    fstep.copy_(torch.from_numpy(fs).to(dev))
    flags.copy_(torch.from_numpy(fl).to(dev))


def partition(binned: torch.Tensor, leaf_of_row: torch.Tensor,
              rec: torch.Tensor, rank_vec: torch.Tensor) -> torch.Tensor:
    """Row partition (kernel B3), in place on ``leaf_of_row``, of the
    split named by the device step record ``rec`` (int32 [8], columns
    ``LEAF`` .. ``ACTIVE``): rows of the leaf that go right move to the new
    leaf (go left iff NA bin ? default_left : rank_vec[bin] <= threshold).
    Returns the slot vector of the next histogram pass (0 where the row is
    in the smaller child, else -1); an inactive step changes nothing and
    its slot vector is unspecified.  CUDA tensors launch the kernel of
    ``csrc/partition.cu``, CPU tensors run ``partition_plain``."""
    if binned.dim() != 2 or binned.dtype != torch.uint8:
        raise TypeError("binned must be a [N, F] uint8 tensor")
    if leaf_of_row.shape != (binned.shape[0],) \
            or leaf_of_row.dtype != torch.int32:
        raise TypeError("leaf_of_row must be a [N] int32 tensor")
    if rank_vec.dtype != torch.int32 or rank_vec.dim() != 1:
        raise TypeError("rank_vec must be an int32 vector")
    if rec.shape != (STEP_RECORD,) or rec.dtype != torch.int32:
        raise TypeError("rec must be an int32 step record of 8 columns")
    if any(t.device != binned.device for t in (leaf_of_row, rank_vec, rec)):
        raise ValueError("partition inputs must be on one device")
    if binned.device.type == "cpu":
        return partition_plain(binned, leaf_of_row, rec, rank_vec)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if not (binned.is_contiguous() and leaf_of_row.is_contiguous()
            and rank_vec.is_contiguous() and rec.is_contiguous()):
        raise ValueError("partition needs contiguous tensors")
    n, f = binned.shape
    slot = torch.empty(n, dtype=torch.int32, device=binned.device)
    if n == 0:
        return slot
    err = _kernels.lib("partition").lgbt_partition(
        binned.data_ptr(), n, f, rec.data_ptr(), rank_vec.data_ptr(),
        leaf_of_row.data_ptr(), slot.data_ptr(),
        _kernels.stream_ptr(binned.device))
    _kernels.launched("partition", err)
    return slot


def partition_plain(binned, leaf_of_row, rec, rank_vec) -> torch.Tensor:
    """Plain PyTorch version of B3 (``torch.where``, reading the record on
    the device), same contract."""
    r = rec.to(torch.int64)
    col = binned.index_select(1, r[FEATURE:FEATURE + 1])[:, 0].to(
        torch.int64)
    is_na = (r[NA_BIN] >= 0) & (col == r[NA_BIN])
    go_left = torch.where(is_na, r[DEFAULT_LEFT] != 0,
                          rank_vec[col] <= r[THRESHOLD])
    move = (leaf_of_row == r[LEAF]) & ~go_left & (r[ACTIVE] != 0)
    leaf_of_row.copy_(torch.where(move, rec[NEW_LEAF], leaf_of_row))
    return torch.where(leaf_of_row == r[SMALLER], 0, -1).to(torch.int32)
