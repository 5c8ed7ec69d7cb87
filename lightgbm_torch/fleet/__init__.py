"""Fleet training and fleet serving.

Training (``fleet/trainer.py``): N boosters (seed replicas, a
hyperparameter grid, or explicit member overrides) over one shared
``Dataset``, their super-epochs in lockstep as one program a CUDA graph
replay an iteration (``models/fused.py`` ``FleetProgram``), with one host
fetch an epoch for every member; each member's model is byte-identical to
a solo ``train`` with its params.

Serving (``fleet/router.py``): per-request ``segment`` keys map to model
versions co-resident in the serve registry.
"""

from .router import SegmentRouter
from .trainer import FleetResult, expand_members, fleet_train, parse_sweep

__all__ = ["FleetResult", "SegmentRouter", "expand_members",
           "fleet_train", "parse_sweep"]
