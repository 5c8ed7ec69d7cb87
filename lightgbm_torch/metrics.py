"""Evaluation metrics (reference: src/metric/*.hpp).

Two families, as in the JAX package's ``metrics.py``:

- the host-side NumPy metric classes, every metric of the JAX package
  (the regression losses, binary_logloss, binary_error, auc,
  average_precision, the cross-entropy family and kldiv; over [N, K]
  scores multi_logloss, multi_error and auc_mu; over query groups ndcg
  and map at ``eval_at``), copies of the JAX package's NumPy code, on
  scores fetched from the device, which the per-iteration path reports
  by default: in f64, but multi_logloss's softmax in the scores' f32, as
  the JAX package's.  All support sample weights; each reports ``(name,
  value, is_higher_better)``;
- the traced metrics (kernel B12, ``csrc/metrics.cu``): f32
  ``(score, label, weight) -> value`` functions on device tensors that
  the fused training loop evaluates inside its captured iteration, for
  the early-stop vote and the reported values, and that
  ``fused_eval=true`` per-iteration runs report through.  AUC (B12a) and
  the pointwise metrics binary_logloss, l2, rmse and l1 (B12b) each have
  a CUDA kernel and a plain PyTorch version (``*_plain``), the JAX
  package's ``_t_*`` formulas in f32 (logloss clipped at 1e-7, since
  ``1 - 1e-15`` rounds to 1 in f32); multi_logloss over [N, K] raw
  scores (B12c) likewise, clipped at 1e-7.  ``traced_metric_fn`` returns
  None for a metric without a traced form, which sends the engine to the
  per-iteration host path.  The ranking metrics have no traced form (the
JAX package has none), so a run that reports them on a valid set trains
on the per-iteration loop.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from .config import Config
from .dataset import Metadata


class Metric:
    name = "metric"
    is_higher_better = False

    def __init__(self, config: Config):
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.label = np.asarray(metadata.label)
        self.weight = (np.asarray(metadata.weight)
                       if metadata.weight is not None else None)
        self.boundaries = metadata.query_boundaries
        self.num_data = num_data

    def _avg(self, per_row: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(per_row * self.weight) / np.sum(self.weight))
        return float(np.mean(per_row))

    def eval(self, score: np.ndarray) -> List[Tuple[str, float, bool]]:
        raise NotImplementedError


# ---- regression metrics (regression_metric.hpp:322) -----------------------

class _PointwiseMetric(Metric):
    def point(self, y, s):
        raise NotImplementedError

    def transform(self, s):
        return s

    def eval(self, score):
        s = self.transform(score)
        return [(self.name, self._avg(self.point(self.label, s)),
                 self.is_higher_better)]


class L2Metric(_PointwiseMetric):
    name = "l2"
    def point(self, y, s): return (y - s) ** 2


class RMSEMetric(_PointwiseMetric):
    name = "rmse"
    def point(self, y, s): return (y - s) ** 2
    def eval(self, score):
        return [(self.name, float(np.sqrt(self._avg(self.point(self.label, score)))),
                 False)]


class L1Metric(_PointwiseMetric):
    name = "l1"
    def point(self, y, s): return np.abs(y - s)


class QuantileMetric(_PointwiseMetric):
    name = "quantile"
    def point(self, y, s):
        a = self.config.alpha
        d = y - s
        return np.where(d >= 0, a * d, (a - 1.0) * d)


class HuberMetric(_PointwiseMetric):
    name = "huber"
    def point(self, y, s):
        a = self.config.alpha
        d = np.abs(y - s)
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseMetric):
    name = "fair"
    def point(self, y, s):
        c = self.config.fair_c
        d = np.abs(y - s)
        return c * c * (d / c - np.log1p(d / c))


class PoissonMetric(_PointwiseMetric):
    name = "poisson"
    def transform(self, s): return np.exp(s)
    def point(self, y, s):
        eps = 1e-10
        return s - y * np.log(np.maximum(s, eps))


class MAPEMetric(_PointwiseMetric):
    name = "mape"
    def point(self, y, s):
        return np.abs(y - s) / np.maximum(np.abs(y), 1.0)


class GammaMetric(_PointwiseMetric):
    name = "gamma"
    def transform(self, s): return np.exp(s)
    def point(self, y, s):
        eps = 1e-10
        psi = y / np.maximum(s, eps)
        theta = -1.0 / np.maximum(s, eps)
        a = -np.log(-theta)
        return -np.log(np.maximum(y, eps)) - theta * y + a + psi * 0  # deviance core
    def eval(self, score):
        s = self.transform(score)
        eps = 1e-10
        ll = (self.label / np.maximum(s, eps) + np.log(np.maximum(s, eps)))
        return [(self.name, self._avg(ll), False)]


class GammaDevianceMetric(_PointwiseMetric):
    name = "gamma_deviance"
    def transform(self, s): return np.exp(s)
    def point(self, y, s):
        eps = 1e-10
        f = y / np.maximum(s, eps)
        return 2.0 * (np.log(np.maximum(1.0 / np.maximum(f, eps), eps)) + f - 1.0)


class TweedieMetric(_PointwiseMetric):
    name = "tweedie"
    def transform(self, s): return np.exp(s)
    def point(self, y, s):
        rho = self.config.tweedie_variance_power
        eps = 1e-10
        s = np.maximum(s, eps)
        a = y * np.power(s, 1.0 - rho) / (1.0 - rho)
        b = np.power(s, 2.0 - rho) / (2.0 - rho)
        return -a + b


# ---- binary metrics (binary_metric.hpp:388) -------------------------------

def _sigmoid(x, k=1.0):
    return 1.0 / (1.0 + np.exp(-k * x))


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score):
        p = np.clip(_sigmoid(score, self.config.sigmoid), 1e-15, 1 - 1e-15)
        ll = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [(self.name, self._avg(ll), False)]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score):
        pred = (score > 0).astype(np.float64)
        return [(self.name, self._avg((pred != self.label).astype(np.float64)),
                 False)]


def _auc(label: np.ndarray, score: np.ndarray,
         weight: Optional[np.ndarray]) -> float:
    """Rank-based weighted AUC (binary_metric.hpp AUCMetric, O(n log n))."""
    order = np.argsort(score, kind="mergesort")
    s, y = score[order], label[order]
    w = weight[order] if weight is not None else np.ones_like(y)
    # tie-aware: average rank within tied score groups
    pos_w = (y > 0) * w
    neg_w = (y <= 0) * w
    cum_neg = np.cumsum(neg_w)
    # group by unique score: within a tie group use half of the group's negatives
    _, first_idx, inv = np.unique(s, return_index=True, return_inverse=True)
    grp_neg = np.bincount(inv, weights=neg_w)
    cum_before = np.concatenate([[0.0], np.cumsum(grp_neg)[:-1]])
    rank_neg = cum_before[inv] + 0.5 * grp_neg[inv]
    area = float(np.sum(pos_w * rank_neg))
    tot_pos, tot_neg = float(pos_w.sum()), float(neg_w.sum())
    if tot_pos <= 0 or tot_neg <= 0:
        return 1.0
    return area / (tot_pos * tot_neg)


class AUCMetric(Metric):
    name = "auc"
    is_higher_better = True

    def eval(self, score):
        return [(self.name, _auc(self.label, score, self.weight), True)]


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    is_higher_better = True

    def eval(self, score):
        order = np.argsort(-score, kind="mergesort")
        y = self.label[order]
        w = self.weight[order] if self.weight is not None else np.ones_like(y)
        tp = np.cumsum(y * w)
        all_ = np.cumsum(w)
        precision = tp / np.maximum(all_, 1e-15)
        ap = float(np.sum(precision * y * w) / max(np.sum(y * w), 1e-15))
        return [(self.name, ap, True)]


# ---- multiclass metrics (multiclass_metric.hpp:368) -----------------------

class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score):
        # score: [N, K] raw; softmax here
        s = score - score.max(axis=1, keepdims=True)
        p = np.exp(s)
        p /= p.sum(axis=1, keepdims=True)
        idx = self.label.astype(np.int64)
        ll = -np.log(np.clip(p[np.arange(len(idx)), idx], 1e-15, None))
        return [(self.name, self._avg(ll), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score):
        k = self.config.multi_error_top_k
        idx = self.label.astype(np.int64)
        true_score = score[np.arange(len(idx)), idx]
        rank = (score >= true_score[:, None]).sum(axis=1)
        err = (rank > k).astype(np.float64)
        # top-k > 1 reports as multi_error@k (multiclass_metric.hpp
        # MultiErrorMetric::Name)
        name = self.name if k <= 1 else f"{self.name}@{k}"
        return [(name, self._avg(err), False)]


class AucMuMetric(Metric):
    """auc_mu: the mean AUC over class pairs (a, b), rows of the two
    classes scored by ``s[:, a] - s[:, b]``, as the JAX package computes
    it."""
    name = "auc_mu"
    is_higher_better = True

    def eval(self, score):
        k = score.shape[1]
        idx = self.label.astype(np.int64)
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                m = (idx == a) | (idx == b)
                if not m.any():
                    continue
                y = (idx[m] == a).astype(np.float64)
                s = score[m, a] - score[m, b]
                w = self.weight[m] if self.weight is not None else None
                aucs.append(_auc(y, s, w))
        return [(self.name, float(np.mean(aucs)) if aucs else 1.0, True)]


# ---- ranking metrics (rank_metric.hpp:169, dcg_calculator.cpp) ------------

class NDCGMetric(Metric):
    name = "ndcg"
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lg = self.config.label_gain
        max_label = int(self.label.max()) if len(self.label) else 0
        if lg is None:
            lg = [(1 << i) - 1 for i in range(max_label + 2)]
        self.label_gain = np.asarray(lg, np.float64)

    def eval(self, score):
        if self.boundaries is None:
            raise ValueError("ndcg metric requires query information")
        eval_at = [int(k) for k in self.config.eval_at]
        b = self.boundaries
        sums = np.zeros(len(eval_at))
        cnt = 0
        for qi in range(len(b) - 1):
            y = self.label[b[qi]:b[qi + 1]].astype(np.int64)
            s = score[b[qi]:b[qi + 1]]
            order = np.argsort(-s, kind="mergesort")
            ideal = np.sort(y)[::-1]
            cnt += 1
            for j, k in enumerate(eval_at):
                kk = min(k, len(y))
                disc = 1.0 / np.log2(np.arange(2, kk + 2))
                dcg = float((self.label_gain[y[order[:kk]]] * disc).sum())
                idcg = float((self.label_gain[ideal[:kk]] * disc).sum())
                sums[j] += dcg / idcg if idcg > 0 else 1.0
        return [(f"ndcg@{k}", sums[j] / max(cnt, 1), True)
                for j, k in enumerate(eval_at)]


class MAPMetric(Metric):
    name = "map"
    is_higher_better = True

    def eval(self, score):
        if self.boundaries is None:
            raise ValueError("map metric requires query information")
        eval_at = [int(k) for k in self.config.eval_at]
        b = self.boundaries
        sums = np.zeros(len(eval_at))
        cnt = 0
        for qi in range(len(b) - 1):
            y = (self.label[b[qi]:b[qi + 1]] > 0).astype(np.float64)
            s = score[b[qi]:b[qi + 1]]
            order = np.argsort(-s, kind="mergesort")
            ys = y[order]
            cnt += 1
            hits = np.cumsum(ys)
            prec = hits / np.arange(1, len(ys) + 1)
            for j, k in enumerate(eval_at):
                kk = min(k, len(ys))
                npos = ys[:kk].sum()
                sums[j] += (prec[:kk] * ys[:kk]).sum() / npos if npos > 0 else 0.0
        return [(f"map@{k}", sums[j] / max(cnt, 1), True)
                for j, k in enumerate(eval_at)]


# ---- cross-entropy metrics (xentropy_metric.hpp:358) ----------------------

class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, score):
        p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
        ll = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [(self.name, self._avg(ll), False)]


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score):
        lam = np.log1p(np.exp(score))
        p = np.clip(-np.expm1(-lam), 1e-15, 1 - 1e-15)
        ll = -(self.label * np.log(p) + (1 - self.label) * np.log(1 - p))
        return [(self.name, self._avg(ll), False)]


class KLDivMetric(Metric):
    name = "kldiv"

    def eval(self, score):
        p = np.clip(_sigmoid(score), 1e-15, 1 - 1e-15)
        y = np.clip(self.label, 1e-15, 1 - 1e-15)
        kl = (y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p)))
        return [(self.name, self._avg(kl), False)]


# ---- traced metrics (kernel B12) -------------------------------------------

# B12b metric ids (csrc/metrics.cu `point_loss`)
POINTWISE_IDS = {"binary_logloss": 0, "l2": 1, "rmse": 2, "l1": 3}
# sorted positions (B12a) or rows (B12b) per block of the kernels
# (csrc/metrics.cu kChunk)
_METRIC_CHUNK = 2048


def _check_traced(score, label, weight) -> None:
    for name, t in (("score", score), ("label", label), ("weight", weight)):
        if t.dim() != 1 or t.dtype != torch.float32 \
                or t.shape != score.shape:
            raise TypeError(f"{name} must be a [N] float32 tensor of the "
                            "score's length")
        if t.device != score.device:
            raise ValueError("score, label and weight must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def traced_auc(score: torch.Tensor, label: torch.Tensor,
               weight: torch.Tensor) -> torch.Tensor:
    """Weighted, tie-aware AUC as a 0-d f32 tensor (kernel B12a).  The
    scores are sorted by ``torch.sort`` (stable); the kernel gathers by the
    order and scans the tie groups.  CUDA tensors launch the kernel of
    ``csrc/metrics.cu``, CPU tensors run ``traced_auc_plain``."""
    _check_traced(score, label, weight)
    if score.device.type == "cpu":
        return traced_auc_plain(score, label, weight)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    n = score.shape[0]
    dev = score.device
    if n == 0:
        return torch.ones((), dtype=torch.float32, device=dev)
    order = torch.sort(score, stable=True).indices
    nb = -(-n // _METRIC_CHUNK)
    f32 = {"dtype": torch.float32, "device": dev}
    s_sorted, pos_sorted, ploc = (torch.empty(n, **f32) for _ in range(3))
    blk_f = torch.empty(4 * nb, **f32)
    blk_i = torch.empty(4 * nb, dtype=torch.int32, device=dev)
    totals = torch.empty(2, **f32)
    out = torch.empty(1, **f32)
    err = _kernels.lib("metrics").lgbt_auc(
        score.data_ptr(), label.data_ptr(), weight.data_ptr(),
        order.data_ptr(), n, s_sorted.data_ptr(), pos_sorted.data_ptr(),
        ploc.data_ptr(), blk_f.data_ptr(), blk_i.data_ptr(),
        totals.data_ptr(), out.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.launched("auc", err)
    return out[0]


def traced_auc_plain(score, label, weight) -> torch.Tensor:
    """Plain PyTorch version of B12a: the JAX package's ``_t_auc``
    (stable sort, tie groups by a cumsum of score changes, per-group
    negative mass by a segment sum)."""
    n = score.shape[0]
    order = torch.sort(score, stable=True).indices
    s, y, w = score[order], label[order], weight[order]
    zero = torch.zeros((), dtype=torch.float32, device=score.device)
    pos_w = torch.where(y > 0, w, zero)
    neg_w = torch.where(y <= 0, w, zero)
    newgrp = torch.cat([torch.zeros(1, dtype=torch.int64,
                                    device=score.device),
                        (s[1:] != s[:-1]).to(torch.int64)])
    gid = torch.cumsum(newgrp, 0)
    grp_neg = torch.zeros(n, dtype=torch.float32,
                          device=score.device).index_add_(0, gid, neg_w)
    cum_before = torch.cumsum(grp_neg, 0) - grp_neg
    rank_neg = cum_before[gid] + 0.5 * grp_neg[gid]
    area = torch.sum(pos_w * rank_neg)
    tp, tn = torch.sum(pos_w), torch.sum(neg_w)
    return torch.where((tp > 0) & (tn > 0), area / (tp * tn),
                       torch.ones_like(area))


def traced_pointwise(score: torch.Tensor, label: torch.Tensor,
                     weight: torch.Tensor, *, metric: str,
                     sigmoid: float = 1.0) -> torch.Tensor:
    """Weighted mean of a pointwise loss (binary_logloss, l2, rmse, l1) as
    a 0-d f32 tensor (kernel B12b).  CUDA tensors launch the kernel of
    ``csrc/metrics.cu``, CPU tensors run ``traced_pointwise_plain``."""
    _check_traced(score, label, weight)
    mid = POINTWISE_IDS[metric]
    if score.device.type == "cpu":
        return traced_pointwise_plain(score, label, weight, metric=metric,
                                      sigmoid=sigmoid)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    n = score.shape[0]
    dev = score.device
    nb = max(-(-n // _METRIC_CHUNK), 1)
    partial = torch.zeros(2 * nb, dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    err = _kernels.lib("metrics").lgbt_pointwise(
        score.data_ptr(), label.data_ptr(), weight.data_ptr(), n, mid,
        float(sigmoid), partial.data_ptr(), out.data_ptr(),
        _kernels.stream_ptr(dev))
    _kernels.launched("pointwise", err)
    return out[0]


def traced_pointwise_plain(score, label, weight, *, metric: str,
                           sigmoid: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of B12b: the JAX package's ``_t_*`` formulas
    (``_t_binary_logloss``, ``_t_l2``, ``_t_rmse``, ``_t_l1``)."""
    if metric == "binary_logloss":
        p = 1.0 / (1.0 + torch.exp(-sigmoid * score))
        p = torch.clamp(p, 1e-7, 1.0 - 1e-7)
        loss = -(label * torch.log(p) + (1.0 - label) * torch.log(1.0 - p))
    elif metric == "l1":
        loss = torch.abs(label - score)
    else:
        d = label - score
        loss = d * d
    r = torch.sum(loss * weight) / torch.sum(weight)
    return torch.sqrt(r) if metric == "rmse" else r


def check_class_labels(label: np.ndarray, num_class: int) -> None:
    """Raise unless every label is a class index in [0, num_class): the
    host-side refusal of B12c's labels (the kernel itself answers NaN)."""
    lbl = np.asarray(label, np.float64)
    if lbl.size and not (np.isfinite(lbl).all()
                         and lbl.min() > -1 and lbl.max() < num_class):
        raise ValueError(f"multiclass labels must be in [0, {num_class})")


def traced_multi_logloss(score: torch.Tensor, label: torch.Tensor,
                         weight: torch.Tensor) -> torch.Tensor:
    """Weighted mean of ``-log(max(softmax(score)[label], 1e-7))`` over
    [N, K] raw scores, as a 0-d f32 tensor (kernel B12c).  A label outside
    [0, K) (after truncation to an integer) makes the value NaN.  CUDA
    tensors launch the kernel of ``csrc/metrics.cu``, CPU tensors run
    ``traced_multi_logloss_plain``."""
    if score.dim() != 2 or score.dtype != torch.float32:
        raise TypeError("score must be an [N, K] float32 tensor")
    if not score.is_contiguous():
        raise ValueError("score must be contiguous")
    for name, t in (("label", label), ("weight", weight)):
        if t.dim() != 1 or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a [N] float32 tensor")
        if t.shape[0] != score.shape[0] or t.device != score.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous, with the score's "
                             "rows and device")
    if score.device.type == "cpu":
        return traced_multi_logloss_plain(score, label, weight)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    n, k = score.shape
    dev = score.device
    nb = max(-(-n // _METRIC_CHUNK), 1)
    partial = torch.zeros(2 * nb, dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    err = _kernels.lib("metrics").lgbt_multi_logloss(
        score.data_ptr(), label.data_ptr(), weight.data_ptr(), n, k,
        partial.data_ptr(), out.data_ptr(), _kernels.stream_ptr(dev))
    _kernels.launched("multi_logloss", err)
    return out[0]


def traced_multi_logloss_plain(score, label, weight) -> torch.Tensor:
    """Plain PyTorch version of B12c: the JAX package's
    ``_t_multi_logloss`` in f32 (softmax as exponentials of ``s - max``
    over their sum, the label's probability clipped at 1e-7); a label
    outside [0, K) gives NaN, as the JAX gather's fill does."""
    k = score.shape[1]
    s = score - torch.amax(score, dim=1, keepdim=True)
    p = torch.exp(s)
    p = p / torch.sum(p, dim=1, keepdim=True)
    idx = label.to(torch.int32).to(torch.int64)
    ok = (idx >= 0) & (idx < k) & torch.isfinite(label)
    picked = torch.gather(p, 1, idx.clamp(0, k - 1)[:, None])[:, 0]
    picked = torch.where(ok, picked, torch.full_like(picked, float("nan")))
    ll = -torch.log(torch.clamp(picked, min=1e-7))
    return torch.sum(ll * weight) / torch.sum(weight)


def traced_metric_fn(name: str, config: Config) -> Optional[Callable]:
    """``(score, label, weight) -> 0-d f32 tensor`` of metric ``name`` on
    the device, or None when it has no traced form here."""
    if name == "auc":
        return traced_auc
    if name == "multi_logloss":
        return traced_multi_logloss
    if name in POINTWISE_IDS:
        sig = float(config.sigmoid)
        return lambda s, y, w: traced_pointwise(s, y, w, metric=name,
                                                sigmoid=sig)
    return None


def build_traced_eval(eval_spec: Sequence[Tuple],
                      config: Config) -> Optional[Callable]:
    """The one eval function both fused paths report through.
    ``eval_spec``: ``(valid_idx, set_name, metric_name, higher_better)``
    entries in ``booster.eval_valid()`` order; ``teval(svecs, ops)``
    evaluates every entry on score vectors ``svecs[vi]`` with
    ``ops[vi] = (label, weight)`` and returns an f32 [E] tensor.  The
    kernels' sums run in an order fixed by the shapes, so the values are
    the same inside and outside a CUDA graph.  None when a metric has no
    traced form."""
    spec = tuple(eval_spec)
    fns = tuple(traced_metric_fn(mn, config) for (_v, _n, mn, _h) in spec)
    if any(f is None for f in fns):
        return None

    def teval(svecs, ops) -> torch.Tensor:
        return torch.stack([f(svecs[vi], ops[vi][0], ops[vi][1])
                            for f, (vi, _n, _m, _h) in zip(fns, spec)])
    return teval


_METRICS = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "huber": HuberMetric, "fair": FairMetric,
    "poisson": PoissonMetric, "mape": MAPEMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric,
    "ndcg": NDCGMetric, "map": MAPMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kldiv": KLDivMetric,
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Metric factory (metric.cpp:16-66)."""
    if name in ("custom", "none", ""):
        return None
    cls = _METRICS.get(name)
    if cls is None:
        raise ValueError(f"Unknown metric: {name}")
    return cls(config)
