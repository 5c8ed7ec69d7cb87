"""Best-split search over histograms (kernel B2).

Counterpart of the numerical part of the JAX package's ``ops/split.py``
``find_best_split``: the two directional scans (missing -> right,
missing -> left) become prefix sums over the bin axis, the regularised gain
is evaluated for every (direction, feature, bin) candidate, and the argmax
picks the winner, the smallest (direction, feature, bin) on ties as
``jnp.argmax`` does.  Gain and leaf-output math follow
``feature_histogram.hpp`` with lambda_l1 / lambda_l2 / max_delta_step /
path_smooth, in the same f32 formulas as the JAX package.

The result is one 12-float record per leaf (layout below), so that the
strict grower keeps its per-leaf best-split table in one device tensor and
fetches it in one copy.  Integer fields (feature, threshold, default_left)
are stored exactly as floats (< 2**24).  ``unpack`` gives the named form.

The feature mask is one [F] row for every leaf, or one row a leaf ([K,
F]: ``feature_fraction_bynode``'s per-child subsets), and an optional
``rand_bin`` [K, F] (``extra_trees``) leaves one threshold bin a (leaf,
feature) valid, in both NA directions, as the JAX package's
``_numerical_candidates`` does.

On a CUDA tensor ``find_best_split`` launches the kernel of
``csrc/split.cu``; on a CPU tensor it runs ``find_best_split_plain``.
Categorical splits are ROADMAP A9.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _kernels

kEpsilon = 1e-15
kMinScore = float("-inf")

# split record columns
GAIN, FEATURE, THRESHOLD, DEFAULT_LEFT = 0, 1, 2, 3
LEFT_SUM = slice(4, 7)       # (g, h, count)
RIGHT_SUM = slice(7, 10)
LEFT_OUTPUT, RIGHT_OUTPUT = 10, 11
RECORD = 12


class SplitParams(NamedTuple):
    """Split hyperparameters (the numerical subset of the JAX package's
    ``SplitParams``)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0


class SplitResult(NamedTuple):
    """Named view of split records (leading axis = leaf)."""
    gain: torch.Tensor           # f32; -inf when no valid split
    feature: torch.Tensor        # int32 (used-feature slot)
    threshold: torch.Tensor      # int32 bin threshold: go left iff bin <= it
    default_left: torch.Tensor   # bool: where NA rows go
    left_sum: torch.Tensor       # [.., 3] (g, h, count)
    right_sum: torch.Tensor      # [.., 3]
    left_output: torch.Tensor    # f32
    right_output: torch.Tensor   # f32


def unpack(rec: torch.Tensor) -> SplitResult:
    return SplitResult(
        gain=rec[..., GAIN], feature=rec[..., FEATURE].to(torch.int32),
        threshold=rec[..., THRESHOLD].to(torch.int32),
        default_left=rec[..., DEFAULT_LEFT] != 0,
        left_sum=rec[..., LEFT_SUM], right_sum=rec[..., RIGHT_SUM],
        left_output=rec[..., LEFT_OUTPUT],
        right_output=rec[..., RIGHT_OUTPUT])


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """ThresholdL1 (feature_histogram.hpp:751)."""
    if l1 <= 0.0:
        return s
    return torch.sign(s) * torch.clamp_min(s.abs() - l1, 0.0)


def leaf_output(sum_g, sum_h, p: SplitParams, parent_output=None,
                count=None):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:742-764): Newton
    step -> L1 threshold -> max_delta_step clamp -> path smoothing by the
    leaf's data count (only when ``parent_output`` is given)."""
    num = -threshold_l1(sum_g, p.lambda_l1)
    out = num / torch.clamp_min(sum_h + p.lambda_l2, kEpsilon)
    if p.max_delta_step > 0.0:
        out = torch.clamp(out, -p.max_delta_step, p.max_delta_step)
    if p.path_smooth > 0.0 and parent_output is not None:
        n_data = sum_h if count is None else count
        smooth_w = n_data / (n_data + p.path_smooth)
        out = out * smooth_w + parent_output * (1.0 - smooth_w)
    return out


def leaf_gain(sum_g, sum_h, p: SplitParams, parent_output=None, count=None):
    """GetLeafGain (feature_histogram.hpp:790-820)."""
    if p.max_delta_step <= 0.0 and p.path_smooth <= 0.0:
        t = threshold_l1(sum_g, p.lambda_l1)
        return t * t / torch.clamp_min(sum_h + p.lambda_l2, kEpsilon)
    out = leaf_output(sum_g, sum_h, p, parent_output, count)
    tg = threshold_l1(sum_g, p.lambda_l1)
    return -(2.0 * tg * out + (sum_h + p.lambda_l2) * out * out)


def _check(hist, total, parent_output, num_bin, na_bin, feature_mask,
           active=None, rand_bin=None):
    if hist.dim() != 4 or hist.shape[-1] != 3 \
            or hist.dtype != torch.float32:
        raise TypeError("hist must be a [K, F, B, 3] float32 tensor")
    k, f = hist.shape[0], hist.shape[1]
    if total.shape != (k, 3) or total.dtype != torch.float32:
        raise TypeError("total must be a [K, 3] float32 tensor")
    if parent_output.shape != (k,) or parent_output.dtype != torch.float32:
        raise TypeError("parent_output must be a [K] float32 tensor")
    for name, t in (("num_bin", num_bin), ("na_bin", na_bin)):
        if t.shape != (f,) or t.dtype != torch.int32:
            raise TypeError(f"{name} must be a [F] int32 tensor")
    if feature_mask.shape not in ((f,), (k, f)) \
            or feature_mask.dtype != torch.bool:
        raise TypeError("feature_mask must be a [F] or [K, F] bool tensor")
    others = [total, parent_output, num_bin, na_bin, feature_mask]
    if rand_bin is not None:
        if rand_bin.shape != (k, f) or rand_bin.dtype != torch.int32:
            raise TypeError("rand_bin must be a [K, F] int32 tensor")
        others.append(rand_bin)
    if active is not None:
        if active.shape != (1,) or active.dtype != torch.int32:
            raise TypeError("active must be a [1] int32 tensor")
        others.append(active)
    if any(t.device != hist.device for t in others):
        raise ValueError("find_best_split inputs must be on one device")


def find_best_split(hist: torch.Tensor, total: torch.Tensor,
                    parent_output: torch.Tensor, num_bin: torch.Tensor,
                    na_bin: torch.Tensor, feature_mask: torch.Tensor,
                    params: SplitParams,
                    active: torch.Tensor | None = None,
                    rand_bin: torch.Tensor | None = None) -> torch.Tensor:
    """Best numerical split of each of K leaves.

    hist [K, F, B, 3] f32, total [K, 3] (the leaves' g/h/count sums),
    parent_output [K] (path-smoothing anchor), num_bin / na_bin [F] int32
    (na_bin -1 = no NA bin), feature_mask [F] or [K, F] bool, rand_bin
    None or [K, F] int32 (the one valid threshold bin of each leaf and
    feature).  Returns [K, 12] split records.  ``active`` (a [1] int32
    device tensor, the grower's step flag): where it is 0 nothing is
    computed and the records are unspecified."""
    _check(hist, total, parent_output, num_bin, na_bin, feature_mask, active,
           rand_bin)
    if hist.device.type == "cpu":
        if active is not None and not bool(active[0]):
            return torch.zeros((hist.shape[0], RECORD), dtype=torch.float32)
        return find_best_split_plain(hist, total, parent_output, num_bin,
                                     na_bin, feature_mask, params, rand_bin)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    tensors = (hist, total, parent_output, num_bin, na_bin, feature_mask) \
        + (() if rand_bin is None else (rand_bin,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("find_best_split needs contiguous tensors")
    k, f, b, _ = hist.shape
    if b > 1024:
        raise ValueError("the split kernel takes at most 1024 bins")
    dev = hist.device
    gains = torch.empty((k, 2, f, b), dtype=torch.float32, device=dev)
    cum = torch.empty((k, f, b, 3), dtype=torch.float32, device=dev)
    out = torch.empty((k, RECORD), dtype=torch.float32, device=dev)
    p = params
    err = _kernels.lib("split").lgbt_split(
        hist.data_ptr(), total.data_ptr(), parent_output.data_ptr(),
        num_bin.data_ptr(), na_bin.data_ptr(), feature_mask.data_ptr(),
        f if feature_mask.dim() == 2 else 0,
        None if rand_bin is None else rand_bin.data_ptr(),
        k, f, b, p.lambda_l1, p.lambda_l2,
        float(p.min_data_in_leaf) - 0.5, p.min_sum_hessian_in_leaf,
        p.min_gain_to_split, p.max_delta_step, p.path_smooth,
        None if active is None else active.data_ptr(), gains.data_ptr(),
        cum.data_ptr(), out.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.launched("split", err)
    return out


def find_best_split_plain(hist: torch.Tensor, total: torch.Tensor,
                          parent_output: torch.Tensor, num_bin: torch.Tensor,
                          na_bin: torch.Tensor, feature_mask: torch.Tensor,
                          params: SplitParams,
                          rand_bin: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of B2 (cumsum-based), same records."""
    k, f, b, _ = hist.shape
    dev = hist.device
    cum = torch.cumsum(hist, dim=2)                         # [K, F, B, 3]
    has_na = na_bin >= 0
    na_idx = na_bin.clamp_min(0).to(torch.int64)
    na_vals = hist[:, torch.arange(f, device=dev), na_idx]  # [K, F, 3]
    na_vals = torch.where(has_na[None, :, None], na_vals,
                          torch.zeros((), device=dev))
    lefts = torch.stack([cum, cum + na_vals[:, :, None, :]], dim=1)
    rights = total[:, None, None, None, :] - lefts          # [K, 2, F, B, 3]
    po = parent_output[:, None, None, None]
    gl, hl, cl = lefts[..., 0], lefts[..., 1], lefts[..., 2]
    gr, hr, cr = rights[..., 0], rights[..., 1], rights[..., 2]
    gain_shift = leaf_gain(total[:, 0], total[:, 1], params, parent_output,
                           total[:, 2])
    split_gain = leaf_gain(gl, hl, params, po, cl) \
        + leaf_gain(gr, hr, params, po, cr) \
        - (gain_shift + params.min_gain_to_split)[:, None, None, None]

    md = float(params.min_data_in_leaf) - 0.5
    mh = params.min_sum_hessian_in_leaf
    bins = torch.arange(b, device=dev, dtype=torch.int32)
    valid = bins[None, :] <= (num_bin - 2)[:, None]         # [F, B]
    fm = feature_mask if feature_mask.dim() == 2 else feature_mask[None]
    valid = valid[None] & fm[:, :, None]                    # [K|1, F, B]
    if rand_bin is not None:
        valid = valid & (bins[None, None, :] == rand_bin[:, :, None])
    valid = torch.stack([valid, valid & has_na[:, None]], dim=1)
    valid = valid & (cl >= md) & (cr >= md) & (hl >= mh) & (hr >= mh)
    valid = valid & (split_gain > kEpsilon)
    gains = torch.where(valid, split_gain,
                        torch.full((), kMinScore, device=dev))

    best = torch.argmax(gains.reshape(k, -1), dim=1)        # first max
    d, rem = best // (f * b), best % (f * b)
    bf, bb = rem // b, rem % b
    ks = torch.arange(k, device=dev)
    left = lefts[ks, d, bf, bb]                             # [K, 3]
    right = total - left
    out = torch.empty((k, RECORD), dtype=torch.float32, device=dev)
    out[:, GAIN] = gains.reshape(k, -1)[ks, best]
    out[:, FEATURE] = bf.to(torch.float32)
    out[:, THRESHOLD] = bb.to(torch.float32)
    out[:, DEFAULT_LEFT] = (d == 1).to(torch.float32)
    out[:, LEFT_SUM] = left
    out[:, RIGHT_SUM] = right
    out[:, LEFT_OUTPUT] = leaf_output(left[:, 0], left[:, 1], params,
                                      parent_output, left[:, 2])
    out[:, RIGHT_OUTPUT] = leaf_output(right[:, 0], right[:, 1], params,
                                       parent_output, right[:, 2])
    return out
