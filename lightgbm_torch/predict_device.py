"""Tree walk over binned rows and the score update (kernel B4).

Counterpart of the JAX package's ``predict_device.py``
``traverse_tree_binned`` / ``add_tree_score``: every row walks one tree
over its bins (NA bin -> ``default_left``, else ``bin <= threshold``) and
``score += weight * leaf_value[leaf]``.  The trainer runs it once per
iteration on each validation set (the ScoreUpdater::AddScore path); the
training score takes the leaf of each row from the grower instead.  The
node tables are the grower's device tree arrays (int32, ``default_left``
too; a bool ``default_left`` is also taken) and the leaf values the f32
shrinkage left on the device: no tree is uploaded from the host.

On CUDA tensors ``add_tree_score`` launches the kernel of
``csrc/predict.cu``; on CPU tensors it runs ``add_tree_score_plain``.  Both
update ``score`` in place.  Numerical nodes only: categorical decisions are
ROADMAP A9, EFB-bundled rows A9, the whole-forest serving walk A14.
"""

from __future__ import annotations

import torch

from . import _kernels


def _check(score, binned, split_feature, threshold_bin, default_left,
           left_child, right_child, na_bin, leaf_value):
    if score.dim() != 1 or score.dtype != torch.float32:
        raise TypeError("score must be a [N] float32 tensor")
    if binned.dim() != 2 or binned.dtype != torch.uint8 \
            or binned.shape[0] != score.shape[0]:
        raise TypeError("binned must be a [N, F] uint8 tensor")
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
    if na_bin.dtype != torch.int32 or na_bin.shape != (binned.shape[1],):
        raise TypeError("na_bin must be a [F] int32 tensor")
    if leaf_value.dtype != torch.float32 or leaf_value.dim() != 1:
        raise TypeError("leaf_value must be a float32 vector")
    if any(t.device != score.device for t in
           (binned, split_feature, threshold_bin, default_left, left_child,
            right_child, na_bin, leaf_value)):
        raise ValueError("add_tree_score inputs must be on one device")


def add_tree_score(score: torch.Tensor, binned: torch.Tensor,
                   split_feature: torch.Tensor, threshold_bin: torch.Tensor,
                   default_left: torch.Tensor, left_child: torch.Tensor,
                   right_child: torch.Tensor, na_bin: torch.Tensor,
                   leaf_value: torch.Tensor, weight: float, *,
                   steps: int) -> torch.Tensor:
    """``score += weight * tree(binned)`` in place; returns ``score``.

    Node tables are [L-1] (child < 0 encodes leaf ``~child``); ``steps``
    must be at least the tree's depth."""
    _check(score, binned, split_feature, threshold_bin, default_left,
           left_child, right_child, na_bin, leaf_value)
    if score.device.type == "cpu":
        return add_tree_score_plain(score, binned, split_feature,
                                    threshold_bin, default_left, left_child,
                                    right_child, na_bin, leaf_value, weight,
                                    steps=steps)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    tensors = (score, binned, split_feature, threshold_bin, default_left,
               left_child, right_child, na_bin, leaf_value)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("add_tree_score needs contiguous tensors")
    n, f = binned.shape
    if n == 0:
        return score
    if default_left.dtype == torch.bool:
        default_left = default_left.to(torch.int32)
    err = _kernels.lib("predict").lgbt_add_tree_score(
        score.data_ptr(), binned.data_ptr(), n, f, split_feature.data_ptr(),
        threshold_bin.data_ptr(), default_left.data_ptr(),
        left_child.data_ptr(), right_child.data_ptr(), na_bin.data_ptr(),
        leaf_value.data_ptr(), float(weight), int(steps),
        _kernels.stream_ptr(score.device))
    _kernels.launched("predict", err)
    return score


def traverse_tree_plain(binned, split_feature, threshold_bin, default_left,
                        left_child, right_child, na_bin, *,
                        steps: int) -> torch.Tensor:
    """Leaf index of every row (a gather loop, one level per step); a walk
    cut short by too few steps ends at leaf 0, as in the kernel."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    for _ in range(steps):
        internal = node >= 0
        nid = node.clamp_min(0).to(torch.int64)
        f = split_feature[nid].to(torch.int64)
        v = torch.gather(binned, 1, f[:, None])[:, 0].to(torch.int32)
        nb = na_bin[f]
        is_na = (nb >= 0) & (v == nb)
        go_left = torch.where(is_na, default_left[nid] != 0,
                              v <= threshold_bin[nid])
        nxt = torch.where(go_left, left_child[nid], right_child[nid])
        node = torch.where(internal, nxt, node)
    return torch.where(node < 0, ~node, torch.zeros_like(node))


def add_tree_score_plain(score, binned, split_feature, threshold_bin,
                         default_left, left_child, right_child, na_bin,
                         leaf_value, weight: float, *,
                         steps: int) -> torch.Tensor:
    """Plain PyTorch version of B4: the gather walk, then a multiply and an
    add, in place."""
    leaf = traverse_tree_plain(binned, split_feature, threshold_bin,
                               default_left, left_child, right_child, na_bin,
                               steps=steps)
    score.add_(leaf_value[leaf.to(torch.int64)] * float(weight))
    return score
