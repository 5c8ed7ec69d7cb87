"""Tree walk over binned rows and the score update (kernel B4).

Counterpart of the JAX package's ``predict_device.py``
``traverse_tree_binned`` / ``add_tree_score``: every row walks one tree
over its bins (at a numerical node NA bin -> ``default_left``, else
``bin <= threshold``; at a categorical node ``cat_rank[node, bin] <=
threshold``, never the NA branch) and ``score += weight *
leaf_value[leaf]``.  The trainer runs it once per
iteration on each validation set (the ScoreUpdater::AddScore path); the
training score takes the leaf of each row from the grower instead.  The
node tables are the grower's device tree arrays (int32, ``default_left``
too; a bool ``default_left`` is also taken) and the leaf values the f32
shrinkage left on the device: no tree is uploaded from the host.

On CUDA tensors ``add_tree_score`` launches the kernel of
``csrc/predict.cu``; on CPU tensors it runs ``add_tree_score_plain``.  Both
update ``score`` in place.  ``is_cat_node`` and ``cat_rank`` are None for a
tree without categorical nodes, whose launches stay as they were.  A
multiclass model's scores are [N, K] row-major and its tree t adds into
column ``t % K``: the ``column`` form (the kernel's row stride K and
column), whose column 0 of a [N] score is the one-column call.
With ``efb_maps`` (the JAX package's ``(group_of_feat, off_of_feat,
num_bin - 1)``, each [F] int32) the rows are the EFB-bundled [N, G]
matrix and each node's bin is decoded from its feature's bundle column
(``predict_device.py:49-57``).  ``binned`` may also be k-hot
``sparse_data.SparseBinned`` rows (B8c: the JAX package's
``traverse_tree_sparse`` and ``add_tree_score_sparse``, sparse_data.py
:178-213): each node's bin is the row's entry of its feature, else the
feature's default bin; ``efb_maps`` do not apply to such rows.

``add_tree_score_members`` is B4-M, the member axis of the fleet (the
JAX package's ``build_fleet_superepoch`` walks every member's tree over
the one shared valid matrix): N members' scores, trees and leaf values
over one shared dense ``binned``, in one launch on the card, each
member's update bitwise the solo call's; its plain version is the solo
plain version member by member.

The whole-forest serving functions (kernel B10, ``csrc/forest.cu``; the
JAX package's ``traverse_forest_binned``, ``bin_rows_device``,
``bin_rows_device_full`` and the raw part of ``fused_forest_predict``)
take the serving engine's structure-of-arrays tables (serve/engine.py):

- ``traverse_forest_binned`` (B10a): leaf id per (row, tree) of a binned
  matrix, [N, F] -> [N, T] int32;
- ``bin_rows_device_full`` (B10b): the model-derived binning of raw f32
  rows, [N, F] -> [N, F] int32 (``bin_rows_device``: numerical only);
- ``fused_forest_predict`` (B10c): raw rows -> bins -> walk -> f32 leaf
  gather times tree weight -> tree-order f32 sum per class -> divided by
  ``avg_denom``, [N, F] -> [N] or [N, k] f32 raw scores (the objective's
  output transform is applied after it, by the engine, as torch ops).

Each launches its kernel on CUDA tensors and runs its plain PyTorch
version (``*_plain``) on CPU tensors; the plain versions compute what the
JAX functions compute, op for op.  The node tables arrive packed
(thresholds uint8/uint16/int32, children int8/int16/int32, split features
and categorical row indices uint8/uint16/int32, rank table uint8 or
int32).  A uint16 table travels as an int16 tensor of the same bits
(``torch.uint16`` has few CUDA ops): in the unsigned roles an int16 tensor
is read as uint16.  The JAX package's trace counters
(``forest_trace_count``, ``fused_trace_count``) have no counterpart: a
CUDA kernel does not recompile per shape; the launches are counted in
``_kernels.LAUNCHES`` instead.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _kernels
from .sparse_data import SparseBinned, column_per_row, khot_args


def _check(score, binned, split_feature, threshold_bin, default_left,
           left_child, right_child, na_bin, leaf_value, is_cat_node,
           cat_rank, column=0, efb_maps=None):
    if score.dim() not in (1, 2) or score.dtype != torch.float32:
        raise TypeError("score must be a [N] or [N, K] float32 tensor")
    width = 1 if score.dim() == 1 else score.shape[1]
    if not 0 <= column < width:
        raise ValueError(f"column {column} is outside the score's "
                         f"{width} column(s)")
    sparse = isinstance(binned, SparseBinned)
    if sparse and efb_maps is not None:
        raise ValueError("k-hot rows hold features: efb_maps do not apply")
    if (not sparse and (binned.dim() != 2 or binned.dtype != torch.uint8)) \
            or binned.shape[0] != score.shape[0]:
        raise TypeError("binned must be a [N, F] uint8 tensor or "
                        "SparseBinned rows of the score's length")
    nodes = split_feature.shape
    for name, t in (("split_feature", split_feature),
                    ("threshold_bin", threshold_bin),
                    ("left_child", left_child), ("right_child", right_child)):
        if t.dtype != torch.int32 or t.shape != nodes:
            raise TypeError(f"{name} must be an int32 tensor of the "
                            "split_feature shape")
    if default_left.dtype not in (torch.bool, torch.int32) \
            or default_left.shape != nodes:
        raise TypeError("default_left must be a bool or int32 tensor of "
                        "the split_feature shape")
    nf = binned.shape[1] if efb_maps is None else na_bin.shape[0]
    if na_bin.dtype != torch.int32 or na_bin.shape != (nf,) \
            or na_bin.dim() != 1:
        raise TypeError("na_bin must be a [F] int32 tensor")
    maps = () if efb_maps is None else tuple(efb_maps)
    if efb_maps is not None and (len(maps) != 3 or any(
            t.dtype != torch.int32 or t.shape != (nf,) for t in maps)):
        raise TypeError("efb_maps must be three [F] int32 tensors "
                        "(group_of_feat, off_of_feat, num_bin - 1)")
    if leaf_value.dtype != torch.float32 or leaf_value.dim() != 1:
        raise TypeError("leaf_value must be a float32 vector")
    cat = () if is_cat_node is None else (is_cat_node, cat_rank)
    if is_cat_node is not None and (
            is_cat_node.dtype not in (torch.bool, torch.int32)
            or is_cat_node.shape != nodes or cat_rank is None
            or cat_rank.dtype != torch.int32 or cat_rank.dim() != 2
            or cat_rank.shape[0] != nodes[0]):
        raise TypeError("is_cat_node must be a bool or int32 tensor of the "
                        "split_feature shape and cat_rank an int32 [nodes, "
                        "B] tensor")
    if any(t.device != score.device for t in
           (binned, split_feature, threshold_bin, default_left, left_child,
            right_child, na_bin, leaf_value) + cat + maps):
        raise ValueError("add_tree_score inputs must be on one device")


def add_tree_score(score: torch.Tensor, binned: torch.Tensor,
                   split_feature: torch.Tensor, threshold_bin: torch.Tensor,
                   default_left: torch.Tensor, left_child: torch.Tensor,
                   right_child: torch.Tensor, na_bin: torch.Tensor,
                   leaf_value: torch.Tensor, weight: float, *,
                   steps: int, is_cat_node: torch.Tensor | None = None,
                   cat_rank: torch.Tensor | None = None,
                   column: int = 0, efb_maps=None) -> torch.Tensor:
    """``score += weight * tree(binned)`` in place; returns ``score``.
    On an [N, K] score, ``score[:, column]`` takes the update.

    Node tables are [L-1] (child < 0 encodes leaf ``~child``); ``steps``
    must be at least the tree's depth.  ``is_cat_node`` [L-1] and
    ``cat_rank`` [L-1, B] (None: every node numerical) give the
    categorical nodes and their rank rows.  ``efb_maps``: the decode maps
    of the bundled [N, G] ``binned`` (module docstring), or None."""
    _check(score, binned, split_feature, threshold_bin, default_left,
           left_child, right_child, na_bin, leaf_value, is_cat_node,
           cat_rank, column, efb_maps)
    if score.device.type == "cpu":
        return add_tree_score_plain(score, binned, split_feature,
                                    threshold_bin, default_left, left_child,
                                    right_child, na_bin, leaf_value, weight,
                                    steps=steps, is_cat_node=is_cat_node,
                                    cat_rank=cat_rank, column=column,
                                    efb_maps=efb_maps)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    maps = (None,) * 3 if efb_maps is None else tuple(efb_maps)
    tensors = (score, binned, split_feature, threshold_bin, default_left,
               left_child, right_child, na_bin, leaf_value) + tuple(
                   t for t in (is_cat_node, cat_rank) + maps
                   if t is not None)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("add_tree_score needs contiguous tensors")
    n, f = binned.shape
    sparse = isinstance(binned, SparseBinned)
    if n == 0:
        return score
    if default_left.dtype == torch.bool:
        default_left = default_left.to(torch.int32)
    if is_cat_node is not None and is_cat_node.dtype == torch.bool:
        is_cat_node = is_cat_node.to(torch.int32)
    stride = 1 if score.dim() == 1 else int(score.shape[1])
    err = _kernels.lib("predict").lgbt_add_tree_score(
        score.data_ptr(), stride, int(column),
        None if sparse else binned.data_ptr(), n, f,
        split_feature.data_ptr(),
        threshold_bin.data_ptr(), default_left.data_ptr(),
        left_child.data_ptr(), right_child.data_ptr(), na_bin.data_ptr(),
        None if is_cat_node is None else is_cat_node.data_ptr(),
        None if cat_rank is None else cat_rank.data_ptr(),
        0 if cat_rank is None else int(cat_rank.shape[1]),
        *(None if t is None else t.data_ptr() for t in maps),
        *khot_args(binned),
        leaf_value.data_ptr(), float(weight), int(steps),
        _kernels.stream_ptr(score.device))
    _kernels.launched("predict", err)
    return score


_TREE_KEYS = ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child", "is_cat_node", "cat_rank")


def add_tree_score_members(scores: Sequence[torch.Tensor], binned,
                           trees: Sequence, na_bin: torch.Tensor,
                           leaf_values: Sequence[torch.Tensor],
                           weight: float, *, steps: Sequence[int],
                           efb_maps=None) -> None:
    """``add_tree_score`` of N members over one shared dense ``binned``
    (B4-M), in place: member j adds ``weight * leaf_values[j][leaf]`` of
    its tree ``trees[j]`` (a mapping of the node tables ``split_feature``,
    ``threshold_bin``, ``default_left``, ``left_child``, ``right_child``
    and, with categorical nodes, ``is_cat_node`` and ``cat_rank``: the
    grower's tree fields) walked ``steps[j]`` levels into ``scores[j]``
    ([N] f32).  CUDA tensors launch the member form of
    ``csrc/predict.cu`` once for all members, CPU tensors run
    ``add_tree_score_members_plain``."""
    m = len(scores)
    if m < 1 or len(trees) != m or len(leaf_values) != m \
            or len(steps) != m:
        raise ValueError("add_tree_score_members needs one score, tree, "
                         "leaf value vector and level count a member")
    if isinstance(binned, SparseBinned):
        raise TypeError("the member form takes a dense binned matrix "
                        "(k-hot valid sets run solo)")
    nodes = [tuple(t.get(k) for k in _TREE_KEYS) for t in trees]
    for sc, nd, lv in zip(scores, nodes, leaf_values):
        if sc.dim() != 1:
            raise TypeError("the member form takes [N] scores")
        _check(sc, binned, *nd[:5], na_bin, lv, nd[5], nd[6], 0, efb_maps)
    cat = {nd[6] is None for nd in nodes}
    if len(cat) != 1 or (not cat.pop() and len(
            {int(nd[6].shape[1]) for nd in nodes}) != 1):
        raise TypeError("the members' trees must all have categorical "
                        "fields of one width, or none")
    if binned.device.type == "cpu":
        return add_tree_score_members_plain(scores, binned, trees, na_bin,
                                            leaf_values, weight,
                                            steps=steps, efb_maps=efb_maps)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    maps = (None,) * 3 if efb_maps is None else tuple(efb_maps)
    rows = [list(scores)] + [[nd[i] for nd in nodes] for i in range(7)] \
        + [list(leaf_values)]
    if any(t is not None and (not t.is_contiguous()
                              or t.dtype not in (torch.int32,
                                                 torch.float32))
           for row in rows for t in row):
        raise ValueError("add_tree_score_members needs contiguous int32 "
                         "node tables (default_left and is_cat_node too) "
                         "and f32 scores and leaf values")
    n, f = binned.shape
    if n == 0:
        return None
    table = _kernels.pointer_table(rows)
    levels = (ctypes.c_int * m)(*[int(x) for x in steps])
    cat_bins = 0 if nodes[0][6] is None else int(nodes[0][6].shape[1])
    err = _kernels.lib("predict").lgbt_add_tree_score_members(
        1, 0, binned.data_ptr(), n, f, na_bin.data_ptr(), cat_bins,
        *(None if t is None else t.data_ptr() for t in maps),
        *khot_args(binned), float(weight), table, levels, m,
        _kernels.stream_ptr(binned.device))
    _kernels.launched("predict_members", err)
    return None


def add_tree_score_members_plain(scores, binned, trees, na_bin, leaf_values,
                                 weight: float, *, steps, efb_maps=None
                                 ) -> None:
    """Plain PyTorch version of B4-M: the solo plain version member by
    member."""
    for sc, tr, lv, st in zip(scores, trees, leaf_values, steps):
        nd = [tr.get(k) for k in _TREE_KEYS]
        add_tree_score_plain(sc, binned, *nd[:5], na_bin, lv, weight,
                             steps=int(st), is_cat_node=nd[5],
                             cat_rank=nd[6], efb_maps=efb_maps)


def walk_maps(binned, efb_maps):
    """The EFB maps a tree walk over ``binned`` takes: none for k-hot rows
    (they hold features), ``efb_maps`` otherwise (the JAX package's
    ``_apply_tree`` branch, models/gbdt.py:74-93)."""
    return None if isinstance(binned, SparseBinned) else efb_maps


def traverse_tree_plain(binned, split_feature, threshold_bin, default_left,
                        left_child, right_child, na_bin, *, steps: int,
                        is_cat_node=None, cat_rank=None,
                        efb_maps=None) -> torch.Tensor:
    """Leaf index of every row (a gather loop, one level per step); a walk
    cut short by too few steps ends at leaf 0, as in the kernel.  With
    ``efb_maps`` each level decodes the bin from the feature's bundle
    column, as the JAX package's ``traverse_tree_binned``; on k-hot
    ``SparseBinned`` rows from the row's entries (``column_per_row``), as
    its ``traverse_tree_sparse``."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    sparse = isinstance(binned, SparseBinned)
    for _ in range(steps):
        internal = node >= 0
        nid = node.clamp_min(0).to(torch.int64)
        f = split_feature[nid].to(torch.int64)
        if sparse:
            v = column_per_row(binned, f)
        else:
            col = f if efb_maps is None else efb_maps[0][f].to(torch.int64)
            v = torch.gather(binned, 1, col[:, None])[:, 0].to(torch.int32)
        if efb_maps is not None:
            off, nbm1 = efb_maps[1][f], efb_maps[2][f]
            v = torch.where(off < 0, v,
                            torch.where((v >= off) & (v < off + nbm1),
                                        v - off + 1, 0)).to(torch.int32)
        nb = na_bin[f]
        is_na = (nb >= 0) & (v == nb)
        rank = v
        if is_cat_node is not None:
            icat = is_cat_node[nid] != 0
            is_na = is_na & ~icat
            rank = torch.where(icat, cat_rank[nid, v.to(torch.int64)], v)
        go_left = torch.where(is_na, default_left[nid] != 0,
                              rank <= threshold_bin[nid])
        nxt = torch.where(go_left, left_child[nid], right_child[nid])
        node = torch.where(internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def add_tree_score_plain(score, binned, split_feature, threshold_bin,
                         default_left, left_child, right_child, na_bin,
                         leaf_value, weight: float, *, steps: int,
                         is_cat_node=None, cat_rank=None,
                         column: int = 0, efb_maps=None) -> torch.Tensor:
    """Plain PyTorch version of B4: the gather walk, then a multiply and an
    add, in place (into ``score[:, column]`` of an [N, K] score)."""
    leaf = traverse_tree_plain(binned, split_feature, threshold_bin,
                               default_left, left_child, right_child, na_bin,
                               steps=steps, is_cat_node=is_cat_node,
                               cat_rank=cat_rank, efb_maps=efb_maps)
    target = score if score.dim() == 1 else score[:, column]
    target.add_(leaf_value[leaf.to(torch.int64)] * float(weight))
    return score


# ---------------------------------------------------------------------------
# Whole-forest serving (B10a-c)
# ---------------------------------------------------------------------------

# width codes of the C interface (csrc/forest.cu ``with_unsigned`` /
# ``with_signed``)
_UNSIGNED_CODES = {torch.uint8: 0, torch.int16: 1, torch.int32: 2}
_SIGNED_CODES = {torch.int8: 0, torch.int16: 1, torch.int32: 2}
_TABLE_CODES = {torch.uint8: 0, torch.int32: 2}
if hasattr(torch, "uint16"):
    _UNSIGNED_CODES[torch.uint16] = 1


def _code(t: torch.Tensor, codes: dict, name: str) -> int:
    c = codes.get(t.dtype)
    if c is None:
        raise TypeError(f"{name} has dtype {t.dtype}; the forest kernels "
                        f"take {sorted(str(d) for d in codes)}")
    return c


def widen_unsigned(t: torch.Tensor) -> torch.Tensor:
    """int32 values of a table in an unsigned role (an int16 tensor holds
    uint16 bits)."""
    if t.dtype == torch.int16 or t.dtype == getattr(torch, "uint16", None):
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t.to(torch.int32)


_NODE_FIELDS = ("split_feature", "threshold_bin", "default_left",
                "left_child", "right_child", "is_cat_node", "cat_index")


def _check_forest(split_feature, threshold_bin, default_left, left_child,
                  right_child, na_bin, is_cat_node, cat_index, cat_table,
                  device) -> dict:
    """Validate the node tables; returns their width codes."""
    tables = dict(zip(_NODE_FIELDS, (split_feature, threshold_bin,
                                     default_left, left_child, right_child,
                                     is_cat_node, cat_index)))
    shape = split_feature.shape
    if split_feature.dim() != 2:
        raise TypeError("split_feature must be a [T, M] tensor")
    for name, t in tables.items():
        if t.shape != shape:
            raise TypeError(f"{name} must have the split_feature shape "
                            f"{tuple(shape)}, not {tuple(t.shape)}")
    for name in ("default_left", "is_cat_node"):
        if tables[name].dtype not in (torch.bool, torch.uint8):
            raise TypeError(f"{name} must be bool or uint8")
    if na_bin.dtype != torch.int32 or na_bin.dim() != 1:
        raise TypeError("na_bin must be a [F] int32 tensor")
    if cat_table.dim() != 2:
        raise TypeError("cat_table must be a [C, W] tensor")
    if left_child.dtype != right_child.dtype:
        raise TypeError("left_child and right_child must share a dtype")
    everything = (*tables.values(), na_bin, cat_table)
    if any(t.device != device for t in everything):
        raise ValueError("forest inputs must be on one device")
    return {"feat": _code(split_feature, _UNSIGNED_CODES, "split_feature"),
            "thr": _code(threshold_bin, _UNSIGNED_CODES, "threshold_bin"),
            "child": _code(left_child, _SIGNED_CODES, "left_child"),
            "ci": _code(cat_index, _UNSIGNED_CODES, "cat_index"),
            "ct": _code(cat_table, _TABLE_CODES, "cat_table")}


def _contiguous(tensors: Sequence[torch.Tensor], what: str) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} needs contiguous tensors")


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A bool table as the uint8 bytes the kernels read."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def traverse_forest_plain(binned, split_feature, threshold_bin,
                          default_left, left_child, right_child, na_bin,
                          is_cat_node, cat_index, cat_table, *,
                          steps: int) -> torch.Tensor:
    """Plain PyTorch version of B10a: the JAX package's ``_forest_walk``
    op for op — every (row, tree) pair walks ``steps`` levels of gathers,
    a finished pair keeps its ~leaf."""
    n = binned.shape[0]
    t, m = split_feature.shape
    dev = binned.device
    bins = widen_unsigned(binned)
    sf = widen_unsigned(split_feature).reshape(-1)
    thr = widen_unsigned(threshold_bin).reshape(-1)
    dl = default_left.reshape(-1) != 0
    lc = left_child.to(torch.int32).reshape(-1)
    rc = right_child.to(torch.int32).reshape(-1)
    cat_node = is_cat_node.reshape(-1) != 0
    ci_all = widen_unsigned(cat_index).reshape(-1)
    ct = cat_table.to(torch.int32)
    node = torch.zeros((n, t), dtype=torch.int32, device=dev)
    base = (torch.arange(t, dtype=torch.int64, device=dev) * m)[None, :]
    for _ in range(steps):
        internal = node >= 0
        idx = base + node.clamp_min(0).to(torch.int64)        # [N, T]
        f = sf[idx].to(torch.int64)
        v = torch.gather(bins, 1, f)
        cat = cat_node[idx]
        nb = na_bin[f]
        is_na = (nb >= 0) & (v == nb) & ~cat
        ci = ci_all[idx].to(torch.int64)
        # the JAX gather clamps out-of-range indices; only categorical
        # nodes read the rank, so the clamp changes nothing they use
        vc = v.clamp(0, ct.shape[1] - 1).to(torch.int64)
        rank = torch.where(cat, ct[ci.clamp(0, ct.shape[0] - 1), vc], v)
        go_left = torch.where(is_na, dl[idx], rank <= thr[idx])
        nxt = torch.where(go_left, lc[idx], rc[idx])
        node = torch.where(internal, nxt, node)
    return ~node


def traverse_forest_binned(binned, split_feature, threshold_bin,
                           default_left, left_child, right_child, na_bin,
                           is_cat_node, cat_index, cat_table, *,
                           steps: int) -> torch.Tensor:
    """Leaf index for every (row, tree) pair (B10a): ``binned`` [N, F]
    (uint8, uint16 as int16, or int32) -> [N, T] int32.  Node tables are
    [T, M]; ``cat_index`` maps a categorical node to its row of
    ``cat_table`` [C, W] (0 = the bin's category goes left, 1 = not),
    numerical nodes compare the bin itself with ``threshold_bin``."""
    if binned.dim() != 2:
        raise TypeError("binned must be a [N, F] tensor")
    codes = _check_forest(split_feature, threshold_bin, default_left,
                          left_child, right_child, na_bin, is_cat_node,
                          cat_index, cat_table, binned.device)
    bin_code = _code(binned, _UNSIGNED_CODES, "binned")
    if na_bin.shape[0] != binned.shape[1]:
        raise TypeError("na_bin must have one entry per column of binned")
    if binned.device.type == "cpu":
        return traverse_forest_plain(
            binned, split_feature, threshold_bin, default_left, left_child,
            right_child, na_bin, is_cat_node, cat_index, cat_table,
            steps=steps)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    tables = (binned, split_feature, threshold_bin, default_left, left_child,
              right_child, na_bin, is_cat_node, cat_index, cat_table)
    _contiguous(tables, "traverse_forest_binned")
    n, nf = binned.shape
    t, m = split_feature.shape
    out = torch.empty((n, t), dtype=torch.int32, device=binned.device)
    if n == 0 or t == 0:
        return out
    err = _kernels.lib("forest").lgbt_forest_walk(
        binned.data_ptr(), n, nf, bin_code, split_feature.data_ptr(),
        codes["feat"], threshold_bin.data_ptr(), codes["thr"],
        _bytes(default_left).data_ptr(), left_child.data_ptr(),
        right_child.data_ptr(), codes["child"], na_bin.data_ptr(),
        _bytes(is_cat_node).data_ptr(), cat_index.data_ptr(), codes["ci"],
        cat_table.data_ptr(), codes["ct"], cat_table.shape[1], t, m,
        int(steps), out.data_ptr(), _kernels.stream_ptr(binned.device))
    _kernels.launched("forest_walk", err)
    return out


def _check_bins(x, thresholds, na_bin, zero_bin, cat_values, cat_len):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError("x must be a [N, F] float32 tensor")
    nf = x.shape[1]
    if thresholds.dtype != torch.float32 or thresholds.dim() != 2 \
            or thresholds.shape[0] != nf:
        raise TypeError("thresholds must be a [F, B] float32 tensor")
    if cat_values.dtype != torch.float32 or cat_values.dim() != 2 \
            or cat_values.shape[0] != nf:
        raise TypeError("cat_values must be a [F, C] float32 tensor")
    for name, t in (("na_bin", na_bin), ("zero_bin", zero_bin),
                    ("cat_len", cat_len)):
        if t.dtype != torch.int32 or t.shape != (nf,):
            raise TypeError(f"{name} must be a [F] int32 tensor")
    if any(t.device != x.device for t in (thresholds, na_bin, zero_bin,
                                          cat_values, cat_len)):
        raise ValueError("binning inputs must be on one device")


def bin_rows_plain(x, thresholds, na_bin, zero_bin, cat_values,
                   cat_len) -> torch.Tensor:
    """Plain PyTorch version of B10b: the JAX package's
    ``bin_rows_device_full`` op for op (comparison sums)."""
    isnan = torch.isnan(x)
    bins = (x[:, :, None] > thresholds[None, :, :]).sum(
        dim=-1, dtype=torch.int32)
    fallback = torch.where(na_bin >= 0, na_bin, zero_bin)[None, :]
    bins = torch.where(isnan, fallback, bins)
    if cat_values.shape[1] > 0:
        iv = torch.where(torch.isfinite(x), torch.trunc(x),
                         torch.full_like(x, -1.0))
        pos = (cat_values[None, :, :] < iv[:, :, None]).sum(
            dim=-1, dtype=torch.int32)
        hi = (cat_len - 1).clamp_min(0)[None, :]
        posc = torch.minimum(pos.clamp_min(0), hi).to(torch.int64)
        hit = torch.gather(cat_values, 1, posc.t().contiguous()).t()
        cat_bin = torch.where(hit == iv, posc.to(torch.int32),
                              cat_len[None, :].expand_as(pos))
        bins = torch.where((cat_len > 0)[None, :], cat_bin, bins)
    return bins


def bin_rows_device_full(x, thresholds, na_bin, zero_bin, cat_values,
                         cat_len) -> torch.Tensor:
    """Model-derived binning of raw f32 rows, both feature kinds (B10b):
    [N, F] float32 -> [N, F] int32.  ``thresholds`` [F, B] and
    ``cat_values`` [F, C] are each feature's sorted f32 table padded with
    +inf; ``cat_len[f] > 0`` marks a categorical feature."""
    _check_bins(x, thresholds, na_bin, zero_bin, cat_values, cat_len)
    if x.device.type == "cpu":
        return bin_rows_plain(x, thresholds, na_bin, zero_bin, cat_values,
                              cat_len)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _contiguous((x, thresholds, na_bin, zero_bin, cat_values, cat_len),
                "bin_rows_device_full")
    n, nf = x.shape
    out = torch.empty((n, nf), dtype=torch.int32, device=x.device)
    if n == 0 or nf == 0:
        return out
    err = _kernels.lib("forest").lgbt_bin_rows(
        x.data_ptr(), n, nf, thresholds.data_ptr(), thresholds.shape[1],
        na_bin.data_ptr(), zero_bin.data_ptr(), cat_values.data_ptr(),
        cat_values.shape[1], cat_len.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(x.device))
    _kernels.launched("bin_rows", err)
    return out


def bin_rows_device(x, thresholds, na_bin, zero_bin) -> torch.Tensor:
    """Model-derived binning of raw numerical f32 rows (B10b without
    categorical features)."""
    nf = x.shape[1] if x.dim() == 2 else 0
    return bin_rows_device_full(
        x, thresholds, na_bin, zero_bin,
        torch.empty((nf, 0), dtype=torch.float32, device=x.device),
        torch.zeros(nf, dtype=torch.int32, device=x.device))


def fused_forest_plain(x, thresholds, na_bin, zero_bin, cat_values, cat_len,
                       split_feature, threshold_bin, default_left,
                       left_child, right_child, is_cat_node, cat_index,
                       cat_table, leaf_value, tree_weight,
                       avg_denom: float, *, steps: int,
                       num_class: int) -> torch.Tensor:
    """Plain PyTorch version of B10c: bin, walk, gather, multiply, then
    add in tree order per class and divide, each a separate f32 op as in
    the JAX package's ``fused_forest_predict`` (raw scores)."""
    binned = bin_rows_plain(x, thresholds, na_bin, zero_bin, cat_values,
                            cat_len)
    leaves = traverse_forest_plain(
        binned, split_feature, threshold_bin, default_left, left_child,
        right_child, na_bin, is_cat_node, cat_index, cat_table, steps=steps)
    n, t = leaves.shape
    leaves = leaves.clamp(0, leaf_value.shape[1] - 1).to(torch.int64)
    vals = torch.gather(leaf_value, 1, leaves.t().contiguous()).t()
    prods = vals * tree_weight[None, :]
    k = max(1, int(num_class))
    score = torch.zeros((n, k), dtype=torch.float32, device=x.device)
    for ti in range(t):
        score[:, ti % k] += prods[:, ti]
    score = score / torch.tensor(avg_denom, dtype=torch.float32,
                                 device=x.device)
    return score if k > 1 else score[:, 0]


def fused_forest_predict(x, thresholds, na_bin, zero_bin, cat_values,
                         cat_len, split_feature, threshold_bin,
                         default_left, left_child, right_child,
                         is_cat_node, cat_index, cat_table, leaf_value,
                         tree_weight, avg_denom: float, *, steps: int,
                         num_class: int) -> torch.Tensor:
    """Raw rows [N, F] f32 -> raw scores, one kernel (B10c): the bins of
    B10b, the walk of B10a, ``leaf_value`` [T, Lp] f32 times
    ``tree_weight`` [T] f32, summed per class in tree order, divided by
    ``avg_denom``.  Returns [N] f32 for one class, else [N, k]."""
    _check_bins(x, thresholds, na_bin, zero_bin, cat_values, cat_len)
    codes = _check_forest(split_feature, threshold_bin, default_left,
                          left_child, right_child, na_bin, is_cat_node,
                          cat_index, cat_table, x.device)
    t = split_feature.shape[0]
    if leaf_value.dtype != torch.float32 or leaf_value.dim() != 2 \
            or leaf_value.shape[0] != t or leaf_value.shape[1] < 1:
        raise TypeError("leaf_value must be a [T, L] float32 tensor")
    if tree_weight.dtype != torch.float32 or tree_weight.shape != (t,):
        raise TypeError("tree_weight must be a [T] float32 tensor")
    if any(v.device != x.device for v in (leaf_value, tree_weight)):
        raise ValueError("fused_forest_predict inputs must be on one device")
    args = (x, thresholds, na_bin, zero_bin, cat_values, cat_len,
            split_feature, threshold_bin, default_left, left_child,
            right_child, is_cat_node, cat_index, cat_table, leaf_value,
            tree_weight)
    if x.device.type == "cpu":
        return fused_forest_plain(*args, avg_denom, steps=steps,
                                  num_class=num_class)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _contiguous(args, "fused_forest_predict")
    n, nf = x.shape
    k = max(1, int(num_class))
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0:
        return out if k > 1 else out[:, 0]
    if t == 0:
        out.zero_()
        return out if k > 1 else out[:, 0]
    # the row's bins in shared memory: 128 threads a block while they fit,
    # fewer for wide rows, a global scratch row each beyond 32 threads'
    # worth
    row_bytes = 4 * max(nf, 1)
    threads = min(128, _kernels.SMEM_BYTES // row_bytes // 32 * 32)
    scratch = None
    if threads < 32:
        threads = 128
        scratch = torch.empty((n, nf), dtype=torch.int32, device=x.device)
    smem = 0 if scratch is not None else threads * row_bytes
    m = split_feature.shape[1]
    err = _kernels.lib("forest").lgbt_fused_predict(
        x.data_ptr(), n, nf, thresholds.data_ptr(), thresholds.shape[1],
        na_bin.data_ptr(), zero_bin.data_ptr(), cat_values.data_ptr(),
        cat_values.shape[1], cat_len.data_ptr(), split_feature.data_ptr(),
        codes["feat"], threshold_bin.data_ptr(), codes["thr"],
        _bytes(default_left).data_ptr(), left_child.data_ptr(),
        right_child.data_ptr(), codes["child"],
        _bytes(is_cat_node).data_ptr(), cat_index.data_ptr(), codes["ci"],
        cat_table.data_ptr(), codes["ct"], cat_table.shape[1], t, m,
        int(steps), leaf_value.data_ptr(), leaf_value.shape[1],
        tree_weight.data_ptr(), float(avg_denom), k,
        None if scratch is None else scratch.data_ptr(), threads, smem,
        out.data_ptr(), _kernels.stream_ptr(x.device))
    _kernels.launched("fused_predict", err)
    return out if k > 1 else out[:, 0]
