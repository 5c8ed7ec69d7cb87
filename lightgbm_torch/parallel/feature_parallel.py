"""Feature-parallel tree learner: the split search split over features.

Counterpart of the JAX package's ``parallel/feature_parallel.py`` (the
reference's FeatureParallelTreeLearner,
feature_parallel_tree_learner.cpp:13-83), on one process per rank: every
rank holds every row; the feature axis is padded to a multiple of the
rank count with masked dummy features (two bins, no NA bin), and each
rank builds histograms and scans thresholds only for its own contiguous
slice of ``f_local`` features.  The slice of the binned matrix is copied
once, when the learner is made (``hist_view``), and every histogram pass
reads it; B3 partitions the full matrix by the winner's global feature.
The winner is agreed by one all-gather of the records and B16a with the
offset ``slot + rank * f_local`` (the JAX package's ``select_best``,
:111-117).  Rows are replicated, so quantized training needs no scale
reduction or row offset: every rank computes the same scales and
rounding.
"""

from __future__ import annotations

import torch

from ..grower import DistHooks
from ..obs.comm import CommLedger
from .data_parallel import DistGrower, _CollectiveGate, select_best
from .mesh import ProcessMesh


class FeatureHooks(DistHooks):
    """The feature-parallel learner's hooks (module docstring)."""

    def __init__(self, mesh: ProcessMesh, binned: torch.Tensor,
                 num_features: int):
        S = mesh.world_size
        self.f_local = -(-int(num_features) // S)
        super().__init__(self.f_local, self.f_local)
        self.mesh, self.ledger = mesh, CommLedger(S)
        self.num_features = int(num_features)
        self.pad = S * self.f_local - self.num_features
        lo = mesh.rank * self.f_local
        hi = min(lo + self.f_local, self.num_features)
        local = torch.zeros((binned.shape[0], self.f_local),
                            dtype=binned.dtype, device=binned.device)
        if hi > lo:
            local[:, :hi - lo].copy_(binned[:, lo:hi])
        self._binned = binned
        self.local = local
        self._lo = lo

    def view(self, binned):
        if binned is not self._binned:
            raise ValueError("the feature-parallel learner was made for "
                             "another binned matrix")
        return self.local

    def _slice(self, t, fill):
        if self.pad:
            t = torch.cat([t, torch.full((self.pad,), fill, dtype=t.dtype,
                                         device=t.device)])
        return t[self._lo:self._lo + self.f_local].contiguous()

    def scan_meta(self, feature_mask, num_bin, na_bin, is_cat):
        return (self._slice(feature_mask, False), self._slice(num_bin, 2),
                self._slice(na_bin, -1),
                None if is_cat is None else self._slice(is_cat, False))

    def select(self, res, active=None):
        return select_best(self.mesh, self.ledger, "fp.best_split", res,
                           active, f_local=self.f_local)


def make_fp_grower(mesh: ProcessMesh, binned: torch.Tensor, *,
                   num_features: int,
                   split_batch: int = 1) -> _CollectiveGate:
    """The feature-parallel ``grow`` over ``mesh`` for the replicated
    ``binned`` [N, F] (``DistGrower`` behind the ``collective`` gate)."""
    return _CollectiveGate(DistGrower(
        FeatureHooks(mesh, binned, num_features), split_batch))
