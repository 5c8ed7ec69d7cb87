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

With ``is_cat`` [F] (the categorical features) the numerical scan runs on
``feature_mask & ~is_cat`` and the categorical scan (kernel B2-cat, the
JAX package's ``_categorical_candidates`` and the categorical half of
``find_best_split``) on ``feature_mask & is_cat``: one-vs-rest when a
feature has at most ``max_cat_to_onehot`` used categories, else prefixes
of the used bins sorted by g / (h + cat_smooth), ascending and
descending, with ``lambda_l2 + cat_l2``.  The numerical winner is taken on
``>=``.  Every split is then "go left iff rank[bin] <= threshold" over a
rank row [B] int32: the identity for a numerical winner, the bins' places
in the winning order for a subset, 0 for the chosen bin and B elsewhere
(threshold 0) for one-vs-rest.  ``rand_bin`` does not touch the
categorical scan, as in the JAX package.

The split controls (``SplitConstraints``; the rest of the JAX package's
``find_best_split``, :343-485) are per-leaf operands: with ``mono`` (the
monotone ``basic`` method) every numerical candidate's child outputs are
clamped to the leaf's output range [``out_lo``, ``out_hi``], its gain
recomputed from the clamped outputs where they moved, and candidates
against the feature's direction dropped (``_monotone_adjust``, :301);
then every valid gain, numerical and categorical, is scaled by the
feature's ``monotone_penalty`` factor at the leaf's ``depth`` (monotone
features only) times its ``contri``, and the CEGB penalty ``cegb_slope *
count + cegb_coupled * (not cuse)`` is subtracted (a gain left at or
below kEpsilon is invalid); the winner's outputs are clipped to the
range.  The partitioned learner (``grower_partitioned.py``) gives two more
forms: ``penalty`` [K, F], each leaf's CEGB penalty vector as that learner
computes it on the host, subtracted in place of the slope and coupled
terms; and the ``mono_bounds`` form of the monotone ``advanced`` method
(the JAX package's :318-324, :462-481), four [K, F, B] bound arrays
``lo_l``, ``hi_l``, ``lo_r``, ``hi_r`` that clip each candidate's left
and right outputs at its (feature, threshold bin) in place of the leaf's
range, a categorical winner's to the tightest bound over its feature's
bins.

On a CUDA tensor ``find_best_split`` launches the kernels of
``csrc/split.cu``; on a CPU tensor it runs ``find_best_split_plain``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import _kernels
from ..constraints import check_operands

kEpsilon = 1e-15
kMinScore = float("-inf")

# split record columns
GAIN, FEATURE, THRESHOLD, DEFAULT_LEFT = 0, 1, 2, 3
LEFT_SUM = slice(4, 7)       # (g, h, count)
RIGHT_SUM = slice(7, 10)
LEFT_OUTPUT, RIGHT_OUTPUT = 10, 11
RECORD = 12


class SplitParams(NamedTuple):
    """Split hyperparameters (the JAX package's ``SplitParams``)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    path_smooth: float = 0.0
    # categorical (feature_histogram.hpp:278
    # FindBestThresholdCategoricalInner)
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    min_data_per_group: int = 100

    def categorical(self) -> "SplitParams":
        """The parameters of a categorical split's gains and outputs:
        ``lambda_l2 + cat_l2``."""
        return self._replace(lambda_l2=self.lambda_l2 + self.cat_l2)


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


class SplitConstraints(NamedTuple):
    """B2's and B2-cat's split-control operands for K leaves, each None
    when off: ``mono`` [F] int8 with the leaves' output ranges
    ``out_lo``/``out_hi`` [K] f32; ``factor`` [T] f32, the monotone
    penalty factor of each depth, with the leaves' ``depth`` [K] int32
    (needs ``mono``); ``contri`` [F] f32; ``cegb_slope`` [F] f32, and
    ``cegb_coupled`` [F] f32 with the used features ``cuse`` [F] bool;
    ``penalty`` [K, F] f32, the leaves' whole CEGB penalty vectors (in
    place of ``cegb_slope``); ``lo_l``, ``hi_l``, ``lo_r``, ``hi_r`` [K,
    F, B] f32, the ``mono_bounds`` of each candidate's children (needs
    ``mono``)."""
    mono: Optional[torch.Tensor] = None
    out_lo: Optional[torch.Tensor] = None
    out_hi: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    factor: Optional[torch.Tensor] = None
    contri: Optional[torch.Tensor] = None
    cegb_slope: Optional[torch.Tensor] = None
    cegb_coupled: Optional[torch.Tensor] = None
    cuse: Optional[torch.Tensor] = None
    penalty: Optional[torch.Tensor] = None
    lo_l: Optional[torch.Tensor] = None
    hi_l: Optional[torch.Tensor] = None
    lo_r: Optional[torch.Tensor] = None
    hi_r: Optional[torch.Tensor] = None

    @property
    def bounds(self) -> bool:
        """Whether the ``mono_bounds`` form is on."""
        return self.lo_l is not None


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
           active=None, rand_bin=None, is_cat=None, cons=None):
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
    if is_cat is not None:
        if is_cat.shape != (f,) or is_cat.dtype != torch.bool:
            raise TypeError("is_cat must be a [F] bool tensor")
        others.append(is_cat)
    if active is not None:
        if active.shape != (1,) or active.dtype != torch.int32:
            raise TypeError("active must be a [1] int32 tensor")
        others.append(active)
    if cons is not None:
        others += _check_cons(cons, k, f, hist.shape[2])
    if any(t.device != hist.device for t in others):
        raise ValueError("find_best_split inputs must be on one device")


def _check_cons(cons: SplitConstraints, k: int, f: int, b: int) -> list:
    """Shapes, types and pairings of the split controls; returns the
    tensors."""
    f32 = torch.float32
    if cons.penalty is not None and cons.cegb_slope is not None:
        raise ValueError("penalty replaces cegb_slope: pass one of them")
    return check_operands(
        cons, {"mono": ((f,), torch.int8), "out_lo": ((k,), f32),
               "out_hi": ((k,), f32), "depth": ((k,), torch.int32),
               "factor": (None, f32), "contri": ((f,), f32),
               "cegb_slope": ((f,), f32), "cegb_coupled": ((f,), f32),
               "cuse": ((f,), torch.bool), "penalty": ((k, f), f32),
               "lo_l": ((k, f, b), f32), "hi_l": ((k, f, b), f32),
               "lo_r": ((k, f, b), f32), "hi_r": ((k, f, b), f32)},
        together=(("mono", "out_lo", "out_hi"), ("factor", "depth"),
                  ("cegb_coupled", "cuse"),
                  ("lo_l", "hi_l", "lo_r", "hi_r")),
        needs=(("factor", "mono"), ("cegb_coupled", "cegb_slope"),
               ("lo_l", "mono")))


def _cons_args(cons: Optional[SplitConstraints]) -> tuple:
    """The kernels' split-control arguments (csrc/split.cu ``Cons``, in
    its field order)."""
    c = cons if cons is not None else SplitConstraints()

    def ptr(t):
        return None if t is None else t.data_ptr()
    n_factor = 0 if c.factor is None else int(c.factor.shape[0])
    return (ptr(c.mono), ptr(c.out_lo), ptr(c.out_hi), ptr(c.depth),
            ptr(c.factor), n_factor, ptr(c.contri), ptr(c.cegb_slope),
            ptr(c.cegb_coupled), ptr(c.cuse), ptr(c.penalty), ptr(c.lo_l),
            ptr(c.hi_l), ptr(c.lo_r), ptr(c.hi_r))


def find_best_split(hist: torch.Tensor, total: torch.Tensor,
                    parent_output: torch.Tensor, num_bin: torch.Tensor,
                    na_bin: torch.Tensor, feature_mask: torch.Tensor,
                    params: SplitParams,
                    active: torch.Tensor | None = None,
                    rand_bin: torch.Tensor | None = None,
                    is_cat: torch.Tensor | None = None,
                    cons: SplitConstraints | None = None):
    """Best split of each of K leaves.

    hist [K, F, B, 3] f32, total [K, 3] (the leaves' g/h/count sums),
    parent_output [K] (path-smoothing anchor), num_bin / na_bin [F] int32
    (na_bin -1 = no NA bin), feature_mask [F] or [K, F] bool, rand_bin
    None or [K, F] int32 (the one valid threshold bin of each leaf and
    numerical feature), is_cat None or [F] bool (the categorical
    features).  Returns [K, 12] split records; with ``is_cat``, the tuple
    (records, cat [K] int32 = 1 where the winner is categorical, rank
    [K, B] int32 = the winner's rank row).  ``active`` (a [1] int32
    device tensor, the grower's step flag): where it is 0 nothing is
    computed and the outputs are unspecified.  ``cons``: the split
    controls (``SplitConstraints``), None for none."""
    _check(hist, total, parent_output, num_bin, na_bin, feature_mask, active,
           rand_bin, is_cat, cons)
    k, f, b, _ = hist.shape
    if hist.device.type == "cpu":
        if active is not None and not bool(active[0]):
            rec = torch.zeros((k, RECORD), dtype=torch.float32)
            return rec if is_cat is None else (
                rec, torch.zeros(k, dtype=torch.int32),
                torch.zeros((k, b), dtype=torch.int32))
        return find_best_split_plain(hist, total, parent_output, num_bin,
                                     na_bin, feature_mask, params, rand_bin,
                                     is_cat, cons)
    if hist.device.type != "cuda":
        raise ValueError(f"unsupported device {hist.device}")
    tensors = (hist, total, parent_output, num_bin, na_bin, feature_mask) \
        + tuple(t for t in (rand_bin, is_cat) if t is not None) \
        + tuple(t for t in (cons or ()) if t is not None)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("find_best_split needs contiguous tensors")
    if b > 1024:
        raise ValueError("the split kernel takes at most 1024 bins")
    dev = hist.device
    gains = torch.empty((k, 2, f, b), dtype=torch.float32, device=dev)
    cum = torch.empty((k, f, b, 3), dtype=torch.float32, device=dev)
    out = torch.empty((k, RECORD), dtype=torch.float32, device=dev)
    p = params
    mask_stride = f if feature_mask.dim() == 2 else 0
    act = None if active is None else active.data_ptr()
    err = _kernels.lib("split").lgbt_split(
        hist.data_ptr(), total.data_ptr(), parent_output.data_ptr(),
        num_bin.data_ptr(), na_bin.data_ptr(), feature_mask.data_ptr(),
        mask_stride, None if rand_bin is None else rand_bin.data_ptr(),
        None if is_cat is None else is_cat.data_ptr(),
        k, f, b, p.lambda_l1, p.lambda_l2,
        float(p.min_data_in_leaf) - 0.5, p.min_sum_hessian_in_leaf,
        p.min_gain_to_split, p.max_delta_step, p.path_smooth,
        *_cons_args(cons), act, gains.data_ptr(), cum.data_ptr(),
        out.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.launched("split", err)
    if is_cat is None:
        return out
    return _split_cat(hist, total, parent_output, feature_mask, mask_stride,
                      is_cat, p, act, out, cons)


def _split_cat(hist, total, parent_output, feature_mask, mask_stride,
               is_cat, p: SplitParams, act, out, cons=None):
    """Kernel B2-cat: the categorical scan of every (leaf, categorical
    feature) and its merge into the numerical records ``out`` (in place).
    Returns (out, cat, rank)."""
    k, f, b, _ = hist.shape
    if b > 256:
        raise ValueError("the categorical split kernel takes at most 256 "
                         "bins")
    dev = hist.device
    cat = torch.empty(k, dtype=torch.int32, device=dev)
    rank = torch.empty((k, b), dtype=torch.int32, device=dev)
    fbest = torch.empty((k, f, 4), dtype=torch.float32, device=dev)
    fidx = torch.empty((k, f), dtype=torch.int32, device=dev)
    frank = torch.empty((k, f, b), dtype=torch.int32, device=dev)
    pc = p.categorical()
    err = _kernels.lib("split").lgbt_split_cat(
        hist.data_ptr(), total.data_ptr(), parent_output.data_ptr(),
        is_cat.data_ptr(), feature_mask.data_ptr(), mask_stride, k, f, b,
        pc.lambda_l1, pc.lambda_l2, float(p.min_data_in_leaf) - 0.5,
        p.min_sum_hessian_in_leaf, p.min_gain_to_split, p.max_delta_step,
        p.path_smooth, p.cat_smooth, _used_min(p), int(p.max_cat_threshold),
        int(p.max_cat_to_onehot), *_cons_args(cons), act,
        fbest.data_ptr(), fidx.data_ptr(),
        frank.data_ptr(), out.data_ptr(), cat.data_ptr(), rank.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.launched("split_cat", err)
    return out, cat, rank


def _used_min(p: SplitParams) -> float:
    """A category's bin is used when its count reaches this."""
    return max(0.5, float(p.min_data_per_group) - 0.5)


def find_best_split_plain(hist: torch.Tensor, total: torch.Tensor,
                          parent_output: torch.Tensor, num_bin: torch.Tensor,
                          na_bin: torch.Tensor, feature_mask: torch.Tensor,
                          params: SplitParams,
                          rand_bin: torch.Tensor | None = None,
                          is_cat: torch.Tensor | None = None,
                          cons: SplitConstraints | None = None):
    """Plain PyTorch version of B2 and B2-cat (cumsum-based), same
    outputs."""
    num_mask = feature_mask if is_cat is None else feature_mask & ~is_cat
    rec = _numerical_plain(hist, total, parent_output, num_bin, na_bin,
                           num_mask, params, rand_bin, cons)
    if is_cat is not None:
        rec, cat, rank = _categorical_plain(
            hist, total, parent_output, feature_mask & is_cat, params, rec,
            cons)
    if cons is not None and cons.mono is not None:
        # the winner's outputs within the leaf's range, or its
        # mono_bounds (:462-485)
        bounds = _winner_bounds(rec, None if is_cat is None else cat, cons)
        for col, (lo, hi) in zip((LEFT_OUTPUT, RIGHT_OUTPUT), bounds):
            rec[:, col] = torch.minimum(torch.maximum(rec[:, col], lo), hi)
    return rec if is_cat is None else (rec, cat, rank)


def _winner_bounds(rec, cat, cons: SplitConstraints):
    """((lo, hi) of the left output, (lo, hi) of the right) [K] each, for
    the winners ``rec``: the leaves' ranges, or the ``mono_bounds`` at
    the winner's (feature, threshold), or for a categorical winner
    (``cat`` != 0) the tightest bound over its feature's bins: lower
    max(lo), upper max(min(hi), max(lo)) (the JAX package's :466-479)."""
    if not cons.bounds:
        return (cons.out_lo, cons.out_hi), (cons.out_lo, cons.out_hi)
    k = rec.shape[0]
    ks = torch.arange(k, device=rec.device)
    f = rec[:, FEATURE].to(torch.int64)
    t = rec[:, THRESHOLD].to(torch.int64)
    out = []
    for lo_b, hi_b in ((cons.lo_l, cons.hi_l), (cons.lo_r, cons.hi_r)):
        lo, hi = lo_b[ks, f, t], hi_b[ks, f, t]
        if cat is not None:
            mx_lo = lo_b[ks, f].amax(dim=1)
            c_hi = torch.maximum(hi_b[ks, f].amin(dim=1), mx_lo)
            lo = torch.where(cat != 0, mx_lo, lo)
            hi = torch.where(cat != 0, c_hi, hi)
        out.append((lo, hi))
    return out


def _monotone_plain(gains, lefts, total, parent_output, params, cons):
    """The JAX package's ``_monotone_adjust`` (ops/split.py:301) over K
    leaves: ``gains`` [K, 2, F, B], ``lefts`` [K, 2, F, B, 3]."""
    rights = total[:, None, None, None, :] - lefts
    po = parent_output[:, None, None, None]
    out_l = leaf_output(lefts[..., 0], lefts[..., 1], params, po,
                        lefts[..., 2])
    out_r = leaf_output(rights[..., 0], rights[..., 1], params, po,
                        rights[..., 2])
    if cons.bounds:
        # [K, 1, F, B]: the same bounds in both NA directions
        lo_l, hi_l, lo_r, hi_r = (b[:, None] for b in (
            cons.lo_l, cons.hi_l, cons.lo_r, cons.hi_r))
    else:
        lo_l = lo_r = cons.out_lo[:, None, None, None]
        hi_l = hi_r = cons.out_hi[:, None, None, None]
    cl_l = torch.minimum(torch.maximum(out_l, lo_l), hi_l)
    cl_r = torch.minimum(torch.maximum(out_r, lo_r), hi_r)

    def gain_given(sums, out):
        tg = threshold_l1(sums[..., 0], params.lambda_l1)
        return -(2.0 * tg * out + (sums[..., 1] + params.lambda_l2)
                 * out * out)

    mono_f = cons.mono.to(torch.int32)[None, None, :, None]
    was_valid = gains > kMinScore
    clamped = (cl_l != out_l) | (cl_r != out_r)
    shift = leaf_gain(total[:, 0], total[:, 1], params) \
        + params.min_gain_to_split
    new_gain = gain_given(lefts, cl_l) + gain_given(rights, cl_r) \
        - shift[:, None, None, None]
    gains = torch.where(was_valid & clamped, new_gain, gains)
    ok = torch.where(mono_f > 0, cl_l <= cl_r,
                     torch.where(mono_f < 0, cl_l >= cl_r, True))
    return torch.where(was_valid & ok & (gains > kEpsilon), gains,
                       torch.full((), kMinScore, device=gains.device))


def _scale_penalise_plain(gains, total, cons):
    """The gain scale (monotone penalty by depth on monotone features,
    times ``contri``) and the CEGB penalty of ``find_best_split``
    (:380-392, :401-409) on valid gains [K, M, F, B]."""
    if cons is None:
        return gains
    k, f = gains.shape[0], gains.shape[2]
    dev = gains.device
    scale = None
    if cons.factor is not None:
        d = cons.depth.to(torch.int64).clamp(0, cons.factor.shape[0] - 1)
        scale = torch.where(cons.mono[None] != 0, cons.factor[d][:, None],
                            torch.ones((), device=dev))         # [K, F]
    if cons.contri is not None:
        scale = cons.contri[None].expand(k, f) if scale is None \
            else scale * cons.contri[None]
    if scale is not None:
        gains = torch.where(gains > kMinScore,
                            gains * scale[:, None, :, None], gains)
    if cons.penalty is not None or cons.cegb_slope is not None:
        if cons.penalty is not None:
            pen = cons.penalty                                   # [K, F]
        else:
            pen = cons.cegb_slope[None] * total[:, 2:3]
            if cons.cegb_coupled is not None:
                pen = pen + cons.cegb_coupled[None] \
                    * (~cons.cuse).to(torch.float32)[None]
        pen = pen[:, None, :, None]
        gains = torch.where(
            gains > kMinScore,
            torch.where(gains - pen > kEpsilon, gains - pen,
                        torch.full((), kMinScore, device=dev)), gains)
    return gains


def _numerical_plain(hist, total, parent_output, num_bin, na_bin,
                     feature_mask, params, rand_bin, cons=None):
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
    if cons is not None and cons.mono is not None:
        gains = _monotone_plain(gains, lefts, total, parent_output, params,
                                cons)
    gains = _scale_penalise_plain(gains, total, cons)

    best = torch.argmax(gains.reshape(k, -1), dim=1)        # first max
    d, rem = best // (f * b), best % (f * b)
    bf, bb = rem // b, rem % b
    ks = torch.arange(k, device=dev)
    left = lefts[ks, d, bf, bb]                             # [K, 3]
    return _record(gains.reshape(k, -1)[ks, best], bf, bb, d == 1, left,
                   total, parent_output, params)


def _record(gain, feature, threshold, default_left, left, total,
            parent_output, params) -> torch.Tensor:
    k = gain.shape[0]
    right = total - left
    out = torch.empty((k, RECORD), dtype=torch.float32, device=gain.device)
    out[:, GAIN] = gain
    out[:, FEATURE] = feature.to(torch.float32)
    out[:, THRESHOLD] = threshold.to(torch.float32)
    out[:, DEFAULT_LEFT] = default_left.to(torch.float32)
    out[:, LEFT_SUM] = left
    out[:, RIGHT_SUM] = right
    out[:, LEFT_OUTPUT] = leaf_output(left[:, 0], left[:, 1], params,
                                      parent_output, left[:, 2])
    out[:, RIGHT_OUTPUT] = leaf_output(right[:, 0], right[:, 1], params,
                                       parent_output, right[:, 2])
    return out


def _order_key(key: torch.Tensor) -> torch.Tensor:
    """The sort key of a categorical scan order: NaN sorts with +inf (so
    every order is a permutation), then the bin index breaks ties."""
    return torch.where(torch.isnan(key), float("inf"), key)


def _categorical_plain(hist, total, parent_output, cat_mask, params, nrec,
                       cons=None):
    """The JAX package's ``_categorical_candidates`` over K leaves and the
    merge into the numerical records ``nrec``: (records, cat, rank)."""
    k, f, b, _ = hist.shape
    dev = hist.device
    pc = params.categorical()
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    used = c >= _used_min(params)                           # [K, F, B]
    n_used = used.sum(dim=2)                                # [K, F]
    pos = torch.arange(b, device=dev)
    ratio = g / (h + params.cat_smooth)
    big = torch.full((), 1e30, device=dev)
    orders = [pos.expand(k, f, b)] + [
        torch.argsort(_order_key(torch.where(used, key, big)), dim=2,
                      stable=True) for key in (ratio, -ratio)]
    orders = torch.stack(orders, dim=1)                     # [K, 3, F, B]
    hist3 = hist[:, None].expand(k, 3, f, b, 3)
    sorted_hist = torch.gather(hist3, 3, orders[..., None].expand(
        k, 3, f, b, 3))
    # prefix sums accumulated in f64, each rounded to f32 (as the kernel)
    lefts = torch.cumsum(sorted_hist.double(), dim=3).float()
    lefts[:, 0] = sorted_hist[:, 0]        # one-vs-rest: the bin alone
    rights = total[:, None, None, None, :] - lefts
    po = parent_output[:, None, None, None]
    gl, hl, cl = lefts[..., 0], lefts[..., 1], lefts[..., 2]
    gr, hr, cr = rights[..., 0], rights[..., 1], rights[..., 2]
    gain_shift = leaf_gain(total[:, 0], total[:, 1], pc, parent_output,
                           total[:, 2])
    split_gain = leaf_gain(gl, hl, pc, po, cl) + leaf_gain(gr, hr, pc, po, cr) \
        - (gain_shift + params.min_gain_to_split)[:, None, None, None]

    md = float(params.min_data_in_leaf) - 0.5
    mh = params.min_sum_hessian_in_leaf
    few = (n_used <= params.max_cat_to_onehot)[..., None]   # [K, F, 1]
    used3 = torch.gather(used[:, None].expand(k, 3, f, b), 3, orders)
    k_max = torch.clamp_max(n_used - 1, params.max_cat_threshold)[..., None]
    prefix_ok = (pos < k_max) & ~few
    valid = torch.stack([few & used3[:, 0], prefix_ok & used3[:, 1],
                         prefix_ok & used3[:, 2]], dim=1)
    cm = cat_mask if cat_mask.dim() == 2 else cat_mask[None]
    valid = valid & cm[:, None, :, None]
    valid = valid & (cl >= md) & (cr >= md) & (hl >= mh) & (hr >= mh)
    valid = valid & (split_gain > kEpsilon)
    gains = torch.where(valid, split_gain,
                        torch.full((), kMinScore, device=dev))
    gains = _scale_penalise_plain(gains, total, cons)

    flat = gains.reshape(k, -1)
    best = torch.argmax(flat, dim=1)                        # first max
    ks = torch.arange(k, device=dev)
    cgain = flat[ks, best]
    mode, rem = best // (f * b), best % (f * b)
    bf, bp = rem // b, rem % b
    order = orders[ks, mode, bf]                            # [K, B] pos->bin
    rank = torch.empty_like(order).scatter_(
        1, order, pos.expand(k, b).contiguous())            # bin -> pos
    ovr = torch.where(pos[None] == order[ks, bp][:, None], 0, b)
    rank = torch.where((mode == 0)[:, None], ovr, rank)
    thr = torch.where(mode == 0, 0, bp)
    crec = _record(cgain, bf, thr, torch.zeros_like(bf), lefts[ks, mode, bf, bp],
                   total, parent_output, pc)
    take_cat = ~(nrec[:, GAIN] >= cgain)
    rec = torch.where(take_cat[:, None], crec, nrec)
    rank = torch.where(take_cat[:, None], rank, pos[None])
    return rec, take_cat.to(torch.int32), rank.to(torch.int32)


# --- B16a: the best-split select of the sharded learners --------------------

def _check_gather(recs, cat, rank, shard_feat, f_local, active):
    if recs.dim() != 3 or recs.shape[2] != RECORD \
            or recs.dtype != torch.float32:
        raise TypeError("recs must be an [S, C, 12] float32 tensor")
    s, c, _ = recs.shape
    if (cat is None) != (rank is None):
        raise TypeError("cat and rank come together (categorical records)")
    if cat is not None and (cat.shape != (s, c) or cat.dtype != torch.int32
                            or rank.dim() != 3 or rank.shape[:2] != (s, c)
                            or rank.dtype != torch.int32):
        raise TypeError("cat must be [S, C] and rank [S, C, B] int32")
    if (shard_feat is None) == (f_local is None):
        raise ValueError("give the owner plan's shard_feat or f_local")
    if shard_feat is not None and (shard_feat.dim() != 2
                                   or shard_feat.shape[0] != s
                                   or shard_feat.dtype != torch.int32):
        raise TypeError("shard_feat must be an [S, fmax] int32 tensor")
    if active is not None and (active.shape != (1,)
                               or active.dtype != torch.int32):
        raise TypeError("active must be a [1] int32 tensor")
    ts = [t for t in (recs, cat, rank, shard_feat, active) if t is not None]
    if any(t.device != recs.device for t in ts):
        raise ValueError("gather_best inputs must be on one device")


def gather_best(recs: torch.Tensor, cat: torch.Tensor | None = None,
                rank: torch.Tensor | None = None, *,
                shard_feat: torch.Tensor | None = None,
                f_local: int | None = None,
                active: torch.Tensor | None = None):
    """Kernel B16a (the JAX package's ``gather_best`` with
    ``globalize_feature``, ``ops/split.py`` :92-121): the all-gathered
    best-split records ``recs`` [S, C, 12] of S ranks' scans of C
    children (with ``cat`` [S, C] and ``rank`` [S, C, B] for categorical
    records), each naming its feature by the rank's local scan slot, to
    the winner of each child with its global feature: slot -> global id
    through ``shard_feat`` [S, fmax] (the owner plan; a pad slot -1 is
    feature 0), or ``slot + s * f_local`` (feature-parallel slices); the
    largest gain wins, ties to the lowest global feature, then to the
    lowest rank.  Returns the [C, 12] records, or (records, cat [C],
    rank [C, B]).  ``active`` (a [1] int32 step flag): where it is 0
    nothing is computed and the result is unspecified.  CUDA tensors
    launch the kernel of ``csrc/dist.cu``, CPU tensors run
    ``gather_best_plain``."""
    _check_gather(recs, cat, rank, shard_feat, f_local, active)
    s, c, _ = recs.shape
    if recs.device.type == "cpu":
        if active is not None and not bool(active[0]):
            rec = torch.zeros((c, RECORD))
            return rec if cat is None else (
                rec, torch.zeros(c, dtype=torch.int32),
                torch.zeros((c, rank.shape[2]), dtype=torch.int32))
        return gather_best_plain(recs, cat, rank, shard_feat=shard_feat,
                                 f_local=f_local)
    if recs.device.type != "cuda":
        raise ValueError(f"unsupported device {recs.device}")
    dev = recs.device
    out = (torch.empty((c, RECORD), dtype=torch.float32, device=dev),) \
        + (() if cat is None else (
            torch.empty(c, dtype=torch.int32, device=dev),
            torch.empty((c, rank.shape[2]), dtype=torch.int32, device=dev)))
    ts = [t for t in (recs, cat, rank, shard_feat, *out) if t is not None]
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("gather_best needs contiguous tensors")
    b = 0 if rank is None else int(rank.shape[2])
    err = _kernels.lib("dist").lgbt_gather_best(
        recs.data_ptr(), None if cat is None else cat.data_ptr(),
        None if rank is None else rank.data_ptr(), s, c, RECORD, b,
        None if shard_feat is None else shard_feat.data_ptr(),
        0 if shard_feat is None else int(shard_feat.shape[1]),
        0 if f_local is None else int(f_local),
        None if active is None else active.data_ptr(), out[0].data_ptr(),
        None if cat is None else out[1].data_ptr(),
        None if cat is None else out[2].data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.launched("gather_best", err)
    return out[0] if cat is None else tuple(out)


def gather_best_plain(recs, cat=None, rank=None, *, shard_feat=None,
                      f_local=None):
    """Plain PyTorch version of B16a, the JAX package's ``jnp.max``, tie
    mask and ``jnp.argmin`` over the gathered records."""
    s, c, _ = recs.shape
    dev = recs.device
    local = recs[..., FEATURE].to(torch.int64)                 # [S, C]
    ranks = torch.arange(s, device=dev)[:, None]
    if shard_feat is None:
        gf = local + ranks * int(f_local)
    else:
        slot = local.clamp(0, shard_feat.shape[1] - 1)
        gf = torch.clamp_min(shard_feat.to(torch.int64)[ranks, slot], 0)
    gain = recs[..., GAIN]
    tie = gain == torch.amax(gain, dim=0, keepdim=True)
    win = torch.argmin(torch.where(tie, gf, 2 ** 30), dim=0)   # [C]
    cs = torch.arange(c, device=dev)
    rec = recs[win, cs].clone()
    rec[:, FEATURE] = gf[win, cs].to(torch.float32)
    if cat is None:
        return rec
    return rec, cat[win, cs].clone(), rank[win, cs].clone()
