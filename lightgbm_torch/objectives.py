"""Objective functions: per-row (gradient, hessian) on the device (B5, B13).

Counterpart of the JAX package's ``objectives.py``, every objective of its
``_OBJECTIVES``: the regression family (``regression`` L2, ``regression_l1``,
``huber``, ``fair``, ``poisson``, ``quantile``, ``mape``, ``gamma``,
``tweedie``), ``binary``, ``cross_entropy`` and ``cross_entropy_lambda``,
the multiclass pair ``multiclass`` (softmax) and ``multiclassova`` (one
sigmoid per class), and the ranking pair ``lambdarank`` and
``rank_xendcg``.  Pointwise gradients are f32 PyTorch ops in the same
formulas as the JAX package (and the reference ``regression_objective.hpp``
/ ``binary_objective.hpp`` / ``xentropy_objective.hpp`` /
``multiclass_objective.hpp``); a multiclass objective takes the [N, K]
score and returns [N, K] gradients and hessians.  The ranking gradients
are kernels B13a and B13b (``ops/rank.py``, ``csrc/rank.cu``), one block a
query straight from the query boundaries, where the JAX package pads
queries into size buckets.  ``boost_from_score`` stays on the host (f64,
or the JAX package's f32 average), and ``regression_l1``, ``quantile`` and
``mape`` renew their leaf values on the host after each tree
(``renew_leaf_values``, RenewTreeOutput) with the JAX package's NumPy code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata
from .ops import random as rnd
from .ops.rank import lambdarank_grad, xendcg_grad


class ObjectiveFunction:
    """Base objective (include/LightGBM/objective_function.h analog)."""

    name = "custom"
    is_ranking = False
    num_model_per_iteration = 1
    need_renew_tree_output = False
    # True when get_gradients advances host state per call (XE-NDCG's
    # iteration counter): such an objective never runs in a captured
    # graph, which would freeze one draw for every replay
    host_state_per_iter = False

    def __init__(self, config: Config):
        self.config = config
        self.device = torch.device("cpu")

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.device = torch.device(device)
        self.num_data = num_data
        # torch allocations (``torch.tensor`` copies), never views of the
        # Dataset's numpy arrays
        self._label_np = np.asarray(metadata.label, np.float32)
        self.label = torch.tensor(self._label_np, device=self.device)
        w = metadata.weight
        self._weight_np_f32 = None if w is None else \
            np.asarray(w, np.float32)
        self.weight = None if w is None else torch.tensor(
            self._weight_np_f32, device=self.device)
        # the f32 average of the JAX package's ``_wmean``, read here, at
        # set-up, so that training itself makes no host read
        if self.weight is not None:
            avg = torch.sum(self.label * self.weight) / torch.sum(self.weight)
        else:
            avg = torch.mean(self.label)
        self._label_mean = float(avg)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """BoostFromScore: initial raw score (objective-specific average)."""
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    # leaf renewal (RenewTreeOutput): objectives override when needed
    def renew_leaf_values(self, score: np.ndarray, leaf_of_row: np.ndarray,
                          num_leaves: int, leaf_values: np.ndarray
                          ) -> np.ndarray:
        return leaf_values

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess

    def _host(self):
        """(label, weight) as the f32 NumPy arrays the JAX package's host
        code reads (``np.asarray`` of its f32 device arrays)."""
        return self._label_np, self._weight_np_f32

    def _wmean(self) -> float:
        """The f32 (weighted) label mean, as the JAX package's ``_wmean``
        takes it on its device; read at set-up."""
        return self._label_mean


class RegressionL2(ObjectiveFunction):
    name = "regression"

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return self._wmean()


class RegressionL1(ObjectiveFunction):
    name = "regression_l1"
    need_renew_tree_output = True

    def get_gradients(self, score):
        grad = torch.sign(score - self.label)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        lbl, w = self._host()
        return float(_weighted_percentile(lbl, w, 0.5))

    def renew_leaf_values(self, score, leaf_of_row, num_leaves, leaf_values):
        # RenewTreeOutput (regression_objective.hpp L1): leaf value = the
        # weighted median of the residuals in the leaf
        lbl, w = self._host()
        return _per_leaf_percentile(lbl - score, w, leaf_of_row, num_leaves,
                                    leaf_values, 0.5)


class RegressionHuber(RegressionL2):
    name = "huber"

    def get_gradients(self, score):
        diff = score - self.label
        a = self.config.alpha
        grad = torch.where(torch.abs(diff) <= a, diff, a * torch.sign(diff))
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)


class RegressionFair(ObjectiveFunction):
    name = "fair"

    def get_gradients(self, score):
        c = self.config.fair_c
        diff = score - self.label
        grad = c * diff / (torch.abs(diff) + c)
        hess = c * c / (torch.abs(diff) + c) ** 2
        return self._apply_weight(grad, hess)


class _LogLink:
    """boost_from_score and output of the log-link objectives (poisson,
    gamma, tweedie): log of the mean label, and exp."""

    def boost_from_score(self, class_id=0):
        return float(np.log(max(self._wmean(), 1e-20)))

    def convert_output(self, raw):
        return torch.exp(raw)


class RegressionPoisson(_LogLink, ObjectiveFunction):
    name = "poisson"

    def get_gradients(self, score):
        # score is the log intensity (regression_objective.hpp PoissonLoss)
        grad = torch.exp(score) - self.label
        hess = torch.exp(score + self.config.poisson_max_delta_step)
        return self._apply_weight(grad, hess)


class RegressionQuantile(ObjectiveFunction):
    name = "quantile"
    need_renew_tree_output = True

    def get_gradients(self, score):
        a = self.config.alpha
        delta = self.label - score
        grad = torch.where(delta >= 0, -a, 1.0 - a).to(torch.float32)
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        lbl, w = self._host()
        return float(_weighted_percentile(lbl, w, self.config.alpha))

    def renew_leaf_values(self, score, leaf_of_row, num_leaves, leaf_values):
        lbl, w = self._host()
        return _per_leaf_percentile(lbl - score, w, leaf_of_row, num_leaves,
                                    leaf_values, self.config.alpha)


class RegressionMAPE(ObjectiveFunction):
    name = "mape"
    need_renew_tree_output = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        self.label_weight = 1.0 / torch.clamp(torch.abs(self.label), min=1.0)
        self._label_weight_np = self.label_weight.cpu().numpy()

    def get_gradients(self, score):
        grad = torch.sign(score - self.label) * self.label_weight
        return self._apply_weight(grad, self.label_weight)

    def _renew_weight(self) -> np.ndarray:
        w = self._label_weight_np
        if self._weight_np_f32 is not None:
            w = w * self._weight_np_f32
        return w

    def boost_from_score(self, class_id=0):
        return float(_weighted_percentile(self._label_np,
                                          self._renew_weight(), 0.5))

    def renew_leaf_values(self, score, leaf_of_row, num_leaves, leaf_values):
        return _per_leaf_percentile(self._label_np - score,
                                    self._renew_weight(), leaf_of_row,
                                    num_leaves, leaf_values, 0.5)


class RegressionGamma(_LogLink, ObjectiveFunction):
    name = "gamma"

    def get_gradients(self, score):
        # the gamma deviance with a log link
        grad = 1.0 - self.label * torch.exp(-score)
        hess = self.label * torch.exp(-score)
        return self._apply_weight(grad, hess)


class RegressionTweedie(_LogLink, ObjectiveFunction):
    name = "tweedie"

    def get_gradients(self, score):
        rho = self.config.tweedie_variance_power
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return self._apply_weight(grad, hess)


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        # reference positivity rule (binary_objective.hpp:37 is_pos_):
        # label > 0 is positive — {0, 10} labels train like {0, 1}
        lbl = (np.asarray(metadata.label) > 0).astype(np.float64)
        self.label = torch.tensor(lbl.astype(np.float32),
                                  device=self.device)
        cnt_pos = float(lbl.sum()) if metadata.weight is None else \
            float((lbl * metadata.weight).sum())
        cnt_neg = (float(len(lbl) - lbl.sum()) if metadata.weight is None
                   else float(((1 - lbl) * metadata.weight).sum()))
        self._cnt_pos, self._cnt_neg = cnt_pos, cnt_neg
        # is_unbalance / scale_pos_weight -> per-class label weights
        # (binary_objective.hpp:52-70)
        if self.config.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                self.label_weight = (1.0, cnt_pos / cnt_neg)
            else:
                self.label_weight = (cnt_neg / cnt_pos, 1.0)
        else:
            self.label_weight = (self.config.scale_pos_weight, 1.0)
        wpos, wneg = self.label_weight
        self._lw = torch.where(self.label > 0, wpos, wneg).to(torch.float32)

    def get_gradients(self, score):
        y = self.label * 2.0 - 1.0          # {0,1} -> {-1,+1}
        sig = self.sigmoid
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        grad = response * self._lw
        absr = torch.abs(response)
        hess = absr * (sig - absr) * self._lw
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        wpos, wneg = self.label_weight
        pos, neg = self._cnt_pos * wpos, self._cnt_neg * wneg
        if pos <= 0 or neg <= 0:
            return 0.0
        pavg = pos / (pos + neg)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))


class CrossEntropy(ObjectiveFunction):
    """Cross-entropy on labels in [0, 1] (xentropy_objective.hpp)."""

    name = "cross_entropy"

    def get_gradients(self, score):
        p = torch.sigmoid(score)
        grad = p - self.label
        hess = p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._wmean(), 1e-9), 1 - 1e-9)
        return float(np.log(pavg / (1 - pavg)))

    def convert_output(self, raw):
        return torch.sigmoid(raw)


class CrossEntropyLambda(ObjectiveFunction):
    """Bernoulli with the complementary log-log parametrisation
    (xentropy_objective.hpp CrossEntropyLambda): lambda = softplus(s), p =
    1 - exp(-lambda w), loss = -(y log p + (1 - y) log(1 - p)) with p
    clipped to [1e-12, 1 - 1e-12].  The JAX package differentiates that
    loss with ``jax.grad`` twice; this is the closed form of the same
    chain, with e = exp(-lambda w) = 1 - p, dp/ds = w sigma(s) e:

        grad = (-y / p + (1 - y) / (1 - p)) * dp/ds
        hess = (y / p^2 + (1 - y) / (1 - p)^2) * (dp/ds)^2
               + (-y / p + (1 - y) / (1 - p)) * dp/ds * (1 - sigma - w sigma)

    where the clip is active (p outside the interval, or at 1 - 1e-12,
    which is 1 in f32) the loss is flat in s: grad 0 and hess 0, then
    hess = max(hess, 1e-9) as in the JAX package.  (Where p rounds to 1,
    lambda w above about 16.6, the JAX package's autodiff of log1p(-p) is
    not finite; the port keeps the clip's flat values.)  The weights enter the
    loss (w), not the result.  Agreement with the JAX package's autodiff:
    within 1e-5 of the largest magnitude of each array, f32 roundings of a
    different operation order (tests/test_torch_objectives.py)."""

    name = "cross_entropy_lambda"

    def get_gradients(self, score):
        w = self.weight if self.weight is not None else \
            torch.ones_like(score)
        y = self.label
        sig = torch.sigmoid(score)
        lam = torch.nn.functional.softplus(score)
        p = -torch.expm1(-lam * w)
        inside = (p > 1e-12) & (p < np.float32(1 - 1e-12))
        # e = 1 - p as f32 forms it (as JAX's derivative of expm1, its
        # value plus 1): e / (1 - p) is then exactly 1 where p is near 1
        q = 1.0 - p
        gp = -(y / p) + (1.0 - y) / q
        gpp = y / (p * p) + (1.0 - y) / (q * q)
        dp = w * sig * q
        grad = gp * dp
        hess = gpp * dp * dp + gp * dp * ((1.0 - sig) - w * sig)
        zero = torch.zeros((), dtype=score.dtype, device=score.device)
        grad = torch.where(inside, grad, zero)
        hess = torch.where(inside, hess, zero)
        return grad, torch.clamp(hess, min=1e-9)

    def boost_from_score(self, class_id=0):
        pavg = min(max(self._wmean(), 1e-9), 1 - 1e-9)
        return float(np.log(np.expm1(-np.log1p(-pavg))))

    def convert_output(self, raw):
        return torch.nn.functional.softplus(raw)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis as ``jax.nn.softmax`` forms it: the
    exponentials of ``x - max``, divided by their sum."""
    e = torch.exp(x - torch.amax(x, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


class MulticlassSoftmax(ObjectiveFunction):
    """Softmax cross-entropy over K classes (multiclass_objective.hpp:279),
    with the reference's factor-2 hessian ``2 p (1 - p)``."""

    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = config.num_class
        self.num_model_per_iteration = config.num_class

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        lbl = np.asarray(metadata.label).astype(np.int32)
        if lbl.min() < 0 or lbl.max() >= self.num_class:
            raise ValueError("multiclass labels must be in [0, num_class)")
        self._onehot_np = np.eye(self.num_class, dtype=np.float32)[lbl]
        self.onehot = torch.tensor(self._onehot_np, device=self.device)
        self._weight_np = None if metadata.weight is None else \
            np.asarray(metadata.weight, np.float32)

    def get_gradients(self, score):
        p = _softmax(score)
        grad = p - self.onehot
        hess = 2.0 * p * (1.0 - p)
        return self._apply_weight(grad, hess)

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            return grad * self.weight[:, None], hess * self.weight[:, None]
        return grad, hess

    def boost_from_score(self, class_id=0):
        # the log class prior (multiclass_objective.hpp:155
        # class_init_probs_), in the JAX package's numpy ops and f32 types
        oh = self._onehot_np
        w = self._weight_np[:, None] if self._weight_np is not None else 1.0
        probs = (oh * w).sum(axis=0)
        probs = probs / max(probs.sum(), 1e-15)
        return float(np.log(max(1e-15, probs[class_id])))

    def convert_output(self, raw):
        return _softmax(raw)


class MulticlassOVA(MulticlassSoftmax):
    """One-vs-all: K binary logloss problems, one sigmoid per class
    (multiclass_objective.hpp:206)."""

    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = config.sigmoid

    def init(self, metadata, num_data, device=torch.device("cpu")):
        ObjectiveFunction.init(self, metadata, num_data, device)
        # no range check, as in the JAX package: a label past K fails the
        # one-hot lookup
        lbl = np.asarray(metadata.label).astype(np.int32)
        self._onehot_np = np.eye(self.num_class, dtype=np.float32)[lbl]
        self.onehot = torch.tensor(self._onehot_np, device=self.device)
        self._weight_np = None if metadata.weight is None else \
            np.asarray(metadata.weight, np.float32)

    def get_gradients(self, score):
        y = self.onehot * 2.0 - 1.0
        sig = self.sigmoid
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        absr = torch.abs(response)
        hess = absr * (sig - absr)
        return self._apply_weight(response, hess)

    def boost_from_score(self, class_id=0):
        # each class's binary BoostFromScore (multiclass_objective.hpp:261)
        oh = self._onehot_np
        w = self._weight_np if self._weight_np is not None \
            else np.ones(len(oh))
        pos = float((oh[:, class_id] * w).sum())
        p = pos / max(float(w.sum()), 1e-15)
        if p <= 0.0 or p >= 1.0:
            return 0.0
        return float(np.log(p / (1.0 - p)) / self.sigmoid)

    def convert_output(self, raw):
        return 1.0 / (1.0 + torch.exp(-self.sigmoid * raw))


class _QueryObjective(ObjectiveFunction):
    """A ranking objective's query groups on the device: the boundaries
    [Q+1] int32, sent once; no padded buckets (the JAX package's
    ``_pad_queries`` is its static-shape workaround).  Boost from score
    0 (rank_objective.hpp)."""

    is_ranking = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name} requires query/group information")
        self._boundaries_np = np.asarray(metadata.query_boundaries,
                                         np.int64)
        self.boundaries = torch.tensor(
            self._boundaries_np.astype(np.int32), device=self.device)
        self.num_queries = len(self._boundaries_np) - 1


def inverse_max_dcg(labels: np.ndarray, boundaries: np.ndarray,
                    gains: np.ndarray, trunc: int) -> np.ndarray:
    """Per-query 1 / max DCG at the truncation level, 0 for a query
    without gain: the JAX package's numpy code
    (``LambdarankNDCG.init``), so that the values are equal bit for
    bit."""
    b = boundaries
    inv = np.zeros(len(b) - 1, np.float32)
    for qi in range(len(b) - 1):
        ql = np.sort(labels[b[qi]:b[qi + 1]])[::-1][:trunc]
        dcg = (gains[ql.astype(np.int32)] /
               np.log2(np.arange(2, len(ql) + 2))).sum()
        inv[qi] = 1.0 / dcg if dcg > 0 else 0.0
    return inv


def default_label_gain(labels: np.ndarray, label_gain) -> np.ndarray:
    """``label_gain``, or 2^i - 1 for i up to the largest label + 1, as
    f32."""
    lg = label_gain
    if lg is None:
        lg = [(1 << i) - 1 for i in range(int(np.asarray(labels).max()) + 2)]
    return np.asarray(lg, np.float32)


class LambdarankNDCG(_QueryObjective):
    """LambdaRank with NDCG deltas (rank_objective.hpp:97+ LambdarankNDCG):
    pairwise lambdas weighted by |delta NDCG|, sigmoid clip and
    truncation level as the JAX package's ``_bucket_gradients``, computed
    by kernel B13a (``ops.rank.lambdarank_grad``)."""

    name = "lambdarank"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        labels = np.asarray(metadata.label)
        gains = default_label_gain(labels, self.config.label_gain)
        self.trunc = int(self.config.lambdarank_truncation_level)
        self.norm = bool(self.config.lambdarank_norm)
        self.sigmoid = self.config.sigmoid
        self.label_gain = torch.tensor(gains, device=self.device)
        self.inverse_max_dcg_np = inverse_max_dcg(
            labels, self._boundaries_np, gains, self.trunc)
        self.inverse_max_dcg = torch.tensor(self.inverse_max_dcg_np,
                                            device=self.device)

    def get_gradients(self, score):
        return lambdarank_grad(score, self.label, self.boundaries,
                               self.label_gain, self.inverse_max_dcg,
                               trunc=self.trunc, norm=self.norm,
                               sigmoid=self.sigmoid)


class RankXENDCG(_QueryObjective):
    """Listwise XE-NDCG (rank_objective.hpp RankXENDCG): a softmax ranking
    loss with a relevance transform drawn anew each iteration, computed by
    kernel B13b (``ops.rank.xendcg_grad``).  The draw of iteration t is
    keyed ``fold_in(fold_in(PRNGKey(objective_seed), t), query id)``, t
    counted from 1 by the host (the JAX package's ``_iter``), so the
    objective runs on the per-iteration loop only."""

    name = "rank_xendcg"
    host_state_per_iter = True

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        self._key = rnd.prng_key(self.config.objective_seed)
        self._iter = 0

    def get_gradients(self, score):
        self._iter += 1
        return xendcg_grad(score, self.label, self.boundaries,
                           rnd.fold_in(self._key, self._iter))


def _weighted_percentile(x: np.ndarray, w: Optional[np.ndarray],
                         alpha: float) -> float:
    """Weighted percentile (PercentileFun/WeightedPercentileFun analog,
    regression_objective.hpp:30-80): the JAX package's numpy code."""
    if len(x) == 0:
        return 0.0
    order = np.argsort(x, kind="stable")
    xs = x[order]
    if w is None:
        # reference PercentileFun: position alpha*(n-1) with
        # interpolation-free upper selection
        pos = alpha * (len(xs) - 1)
        lo = int(np.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return float(xs[lo] * (1 - frac) + xs[hi] * frac)
    ws = w[order]
    cum = np.cumsum(ws) - 0.5 * ws
    cum /= ws.sum()
    return float(np.interp(alpha, cum, xs))


def _per_leaf_percentile(resid: np.ndarray, w: Optional[np.ndarray],
                         leaf_of_row: np.ndarray, num_leaves: int,
                         leaf_values: np.ndarray, alpha: float) -> np.ndarray:
    out = leaf_values.copy()
    for leaf in range(num_leaves):
        m = leaf_of_row == leaf
        if m.any():
            out[leaf] = _weighted_percentile(
                resid[m], w[m] if w is not None else None, alpha)
    return out


_OBJECTIVES = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": RegressionHuber,
    "fair": RegressionFair,
    "poisson": RegressionPoisson,
    "quantile": RegressionQuantile,
    "mape": RegressionMAPE,
    "gamma": RegressionGamma,
    "tweedie": RegressionTweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Objective factory (objective_function.cpp:15-53).  ``custom``
    returns None — gradients then come from the caller."""
    if config.objective == "custom":
        return None
    cls = _OBJECTIVES.get(config.objective)
    if cls is None:
        raise ValueError(f"Unknown objective: {config.objective}")
    return cls(config)
