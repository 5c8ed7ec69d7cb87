"""Evaluation metrics (reference: src/metric/*.hpp).

The host-side NumPy metric classes of the JAX package's ``metrics.py``
that this slice runs: l2, rmse, l1, binary_logloss, binary_error and auc.
Metrics run once per iteration on scores fetched from the device (the
reference's metrics are likewise CPU-side).  All support sample weights.
Each reports ``(name, value, is_higher_better)``.  The other metrics raise
``NotImplementedError`` naming their ROADMAP item; the traced on-device
metrics of the fused loop are ROADMAP A13 (B12).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

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


_METRICS = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
}

# metrics of the JAX package that this slice does not port yet
_UNPORTED = {
    "quantile", "huber", "fair", "poisson", "mape", "gamma",
    "gamma_deviance", "tweedie", "average_precision", "multi_logloss",
    "multi_error", "auc_mu", "ndcg", "map", "cross_entropy",
    "cross_entropy_lambda", "kldiv",
}


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Metric factory (metric.cpp:16-66)."""
    if name in ("custom", "none", ""):
        return None
    cls = _METRICS.get(name)
    if cls is not None:
        return cls(config)
    if name in _UNPORTED:
        raise NotImplementedError(
            f"metric={name} is not ported to lightgbm_torch yet (ROADMAP A9)")
    raise ValueError(f"Unknown metric: {name}")
