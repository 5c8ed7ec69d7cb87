"""Objective functions: per-row (gradient, hessian) on the device (B5).

Counterpart of the JAX package's ``objectives.py`` for the objectives this
slice ports, ``regression`` (L2) and ``binary``.  Gradients are elementwise
f32 PyTorch ops in the same formulas as the JAX package (and the reference
``regression_objective.hpp`` / ``binary_objective.hpp``); ``boost_from_score``
stays in float64 on the host.  The other objectives raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .config import Config
from .dataset import Metadata


class ObjectiveFunction:
    """Base objective (include/LightGBM/objective_function.h analog)."""

    name = "custom"
    is_ranking = False
    num_model_per_iteration = 1
    need_renew_tree_output = False

    def __init__(self, config: Config):
        self.config = config
        self.device = torch.device("cpu")

    def init(self, metadata: Metadata, num_data: int,
             device: torch.device = torch.device("cpu")) -> None:
        self.device = torch.device(device)
        self.num_data = num_data
        self.label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                     device=self.device)
        w = metadata.weight
        self.weight = None if w is None else torch.as_tensor(
            np.asarray(w, np.float32), device=self.device)

    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        """BoostFromScore: initial raw score (objective-specific average)."""
        return 0.0

    def convert_output(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def _apply_weight(self, grad, hess):
        if self.weight is not None:
            return grad * self.weight, hess * self.weight
        return grad, hess


class RegressionL2(ObjectiveFunction):
    name = "regression"

    def init(self, metadata, num_data, device=torch.device("cpu")):
        super().init(metadata, num_data, device)
        # the f32 average, as the JAX package takes it on its device; read
        # here, at set-up, so that training itself makes no host read
        if self.weight is not None:
            avg = torch.sum(self.label * self.weight) / torch.sum(self.weight)
        else:
            avg = torch.mean(self.label)
        self._label_avg = float(avg)

    def get_gradients(self, score):
        grad = score - self.label
        hess = torch.ones_like(score)
        return self._apply_weight(grad, hess)

    def boost_from_score(self, class_id=0):
        if not self.config.boost_from_average:
            return 0.0
        return self._label_avg


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
        self.label = torch.as_tensor(lbl.astype(np.float32),
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


_OBJECTIVES = {"regression": RegressionL2, "binary": BinaryLogloss}

# objectives of the JAX package that this slice does not port yet
_UNPORTED = {
    "regression_l1": "A9", "huber": "A9", "fair": "A9", "poisson": "A9",
    "quantile": "A9", "mape": "A9", "gamma": "A9", "tweedie": "A9",
    "cross_entropy": "A9", "cross_entropy_lambda": "A9",
    "multiclass": "A9", "multiclassova": "A9",
    "lambdarank": "A9 (B13)", "rank_xendcg": "A9 (B13)",
}


def create_objective(config: Config) -> Optional[ObjectiveFunction]:
    """Objective factory (objective_function.cpp:15-53).  ``custom``
    returns None — gradients then come from the caller."""
    if config.objective == "custom":
        return None
    cls = _OBJECTIVES.get(config.objective)
    if cls is not None:
        return cls(config)
    if config.objective in _UNPORTED:
        raise NotImplementedError(
            f"objective={config.objective} is not ported to lightgbm_torch "
            f"yet (ROADMAP {_UNPORTED[config.objective]})")
    raise ValueError(f"Unknown objective: {config.objective}")
