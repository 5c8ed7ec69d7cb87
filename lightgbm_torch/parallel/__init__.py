"""Distributed training, one process per rank over ``torch.distributed``
(the JAX package's ``parallel/``):

- ``mesh``: the process group as a ``ProcessMesh`` (its collectives,
  through an ``obs.comm.CommLedger``), ``owner_shard_plan``,
  ``init_distributed``;
- ``data_parallel``, ``feature_parallel``, ``voting_parallel``: the
  ``tree_learner=data|feature|voting`` learners, hooks into the port's
  grower (``grower.DistHooks``) with kernels B16a-c around their
  collectives;
- ``launch`` and ``dist_data``: bring-up, row shards and globally
  consistent bin mappers;
- ``elastic``: the failure classification and suspect-device quarantine
  the computation-integrity layer needs.  Heartbeats, ``guarded_get``,
  the collective deadline and the recovery ladder are ROADMAP A16b.
"""

from .mesh import (OwnerShardPlan, ProcessMesh, default_mesh,
                   init_distributed, make_mesh, owner_shard_plan)

__all__ = ["OwnerShardPlan", "ProcessMesh", "default_mesh",
           "init_distributed", "make_mesh", "owner_shard_plan"]
