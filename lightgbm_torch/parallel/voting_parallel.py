"""Voting-parallel learner: communication-compressed data parallelism.

Counterpart of the JAX package's ``parallel/voting_parallel.py`` (the
reference's VotingParallelTreeLearner, PV-tree,
voting_parallel_tree_learner.cpp:15-507), on one process per rank: rows
are split as under data-parallel, but each histogram pass is reduced by
the vote (``vote_reduce``, :126-148):

- B16b (``ops/vote.vote_gains``): every rank's best local gain per
  feature, with ``min_data_in_leaf`` and ``min_sum_hessian_in_leaf``
  divided by the rank count, its top ``k = min(top_k, F)`` as a vote
  vector, and its finite gains;
- the votes and the gains are SUM all-reduced (sites ``voting.votes``,
  ``voting.gains``);
- B16c (``ops/vote.vote_select``): the global top ``2k`` by ``votes *
  1e12 + gain_sum`` keep their histogram rows, the rest are zeroed in
  place;
- the histogram is SUM all-reduced (``voting.hist``): f32, or exact int32
  under quantized training, where B16b reads it with the tree's scales.

The voted set changes from one pass to the next, so there is no
subtraction: both children of a split are built by passes of their own,
as the reference syncs both.  The learner grows strictly (one split a
step), as the JAX package's does.  The root's sums are a [3] all-reduce
of their own (``voting.root_sum``), never the vote-filtered histogram;
the quantization hooks are data-parallel's under ``voting.quant_scale``.
"""

from __future__ import annotations

import torch

from ..obs.comm import CommLedger
from ..ops.split import SplitParams
from ..ops.vote import vote_gains, vote_select
from .data_parallel import DistGrower, RowShardHooks, _CollectiveGate
from .mesh import ProcessMesh


class VotingHooks(RowShardHooks):
    """The voting-parallel learner's hooks (module docstring)."""

    subtract = False

    def __init__(self, mesh: ProcessMesh, num_features: int,
                 params: SplitParams, top_k: int, row_offset: int):
        super().__init__(mesh, CommLedger(mesh.world_size), num_features,
                         num_features, row_offset, "voting")
        self.params = params
        self.k = max(1, min(int(top_k), int(num_features)))
        self.k2 = min(2 * self.k, int(num_features))

    def reduce(self, h, scales=None):
        m, led = self.mesh, self.ledger
        # under quant the int32 histogram is read with the tree's scales
        votes, gains = vote_gains(
            h, self.params, m.world_size, self.k,
            scales=None if h.dtype == torch.float32 else scales)
        m.all_reduce(votes, "sum", ledger=led, site="voting.votes")
        m.all_reduce(gains, "sum", ledger=led, site="voting.gains")
        vote_select(votes, gains, h, self.k2)
        return m.all_reduce(h, "sum", ledger=led, site="voting.hist")


def make_voting_grower(mesh: ProcessMesh, *, num_features: int,
                       params: SplitParams, top_k: int = 20,
                       row_offset: int = 0) -> _CollectiveGate:
    """The voting-parallel ``grow`` over ``mesh`` (strict growth;
    ``DistGrower`` behind the ``collective`` gate)."""
    return _CollectiveGate(DistGrower(
        VotingHooks(mesh, num_features, params, top_k, row_offset), 1))
