"""Fleet training: N boosters over one shared dataset, grown in lockstep.

Counterpart of the JAX package's ``fleet/trainer.py``.  ``fleet_train``
grows N boosters (seed replicas, a hyperparameter grid, or explicit
member overrides) over ONE ``Dataset``: the members' super-epochs run as
one program (``models/fused.py`` ``FleetProgram``, the counterpart of the
JAX package's ``build_fleet_superepoch``), one CUDA graph replay an
iteration for every member, whose passes over the shared binned matrix
and valid matrices (B1-M, B3-M and their K-slot and integer forms, B4-M)
go out once for all members; one host fetch an epoch (site
``"fleet_fetch"`` of member 0's model) carries every member's trees, eval
block and stop flags.

The contract:

- **Byte identity.**  Every member's model is byte-identical to a solo
  ``lightgbm_torch.train`` with that member's params
  (``FleetResult.member_params[j]``): each member runs its solo phases on
  its own tensors and RNG streams (bagging, GOSS and stochastic rounding
  keyed by its own seed and iteration; feature_fraction masks drawn from
  its own host stream, member by member).
- **Masked, not branched, early stop.**  A member whose vote trips, or
  that grows a stump, rides its lane with the block latched and changes
  no state; a member that has left the fleet rides with ``dead`` set,
  and the host stops ingesting its rows.
- **Ragged progress.**  Members at different absolute iterations keep
  their own vote and keying iterations; when fewer than two remain, the
  rest finish through the solo path's own loop (``engine.boost_rounds``),
  and every fetched block is replayed through the solo path's
  ``engine.replay_block``.

Snapshots and resume (``snapshot_freq``, ``resume``) are ROADMAP A12 and
are refused.  This module imports nothing of the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .. import callback as callback_mod
from ..booster import Booster
from ..config import _ALIASES, _PARAMS, Config, _coerce, canonical_params
from ..dataset import Dataset
from ..engine import _superepoch_plan, boost_rounds, replay_block
from ..models.fused import FleetProgram
from ..utils.shapes import bucket_leaves, traversal_steps

# params allowed to differ between fleet members: everything else must be
# uniform, because the members share one epoch shape.  num_leaves may
# differ only where the JAX package's padded leaf budgets are equal
# (``_check_models``).
MEMBER_AXIS_PARAMS = frozenset({
    "learning_rate", "seed", "bagging_seed", "feature_fraction_seed",
    "num_leaves", "output_model"})


def parse_sweep(spec: str) -> List[Dict[str, Any]]:
    """``"learning_rate=0.05|0.1;num_leaves=31|63"`` -> the cartesian grid
    as member override dicts (4 members here), values coerced to the
    parameter's declared type.  Only member-axis params may be swept;
    aliases resolve (``eta=...`` sweeps learning_rate)."""
    spec = (spec or "").strip()
    if not spec:
        return []
    axes: List[tuple] = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"fleet_sweep: malformed entry {part!r} "
                             "(want param=v1|v2|...)")
        name, vals = part.split("=", 1)
        name = _ALIASES.get(name.strip(), name.strip())
        if name not in _PARAMS:
            raise ValueError(f"fleet_sweep: unknown parameter {name!r}")
        if name not in MEMBER_AXIS_PARAMS:
            raise ValueError(
                f"fleet_sweep: {name!r} is not a member-axis parameter "
                f"(sweepable: {sorted(MEMBER_AXIS_PARAMS - {'output_model'})})")
        typ = _PARAMS[name][0]
        axes.append((name, [_coerce(name, typ, v.strip())
                            for v in vals.split("|") if v.strip()]))
    if not axes:
        return []
    return [dict(zip([n for n, _ in axes], combo))
            for combo in itertools.product(*[vs for _, vs in axes])]


def expand_members(params: Dict[str, Any],
                   members: Optional[Sequence[Dict[str, Any]]] = None,
                   ) -> List[Dict[str, Any]]:
    """Resolve the fleet roster into full per-member param dicts.

    Precedence: an explicit ``members=`` override list > the
    ``fleet_sweep`` grid > ``fleet_members`` seed replicas (member j trains
    with ``seed+j`` / ``bagging_seed+j`` / ``feature_fraction_seed+j``).
    Each member gets its own ``output_model`` (``<output_model>.member<j>``)
    unless its overrides name one."""
    cfg = Config(params)
    if members is not None:
        over = [dict(m) for m in members]
    elif cfg.fleet_sweep:
        over = parse_sweep(cfg.fleet_sweep)
    elif cfg.fleet_members > 0:
        over = [{"seed": cfg.seed + j,
                 "bagging_seed": cfg.bagging_seed + j,
                 "feature_fraction_seed": cfg.feature_fraction_seed + j}
                for j in range(cfg.fleet_members)]
    else:
        over = []
    out = []
    for j, ov in enumerate(over):
        mp = dict(params)
        explicit_out = False
        for k, v in ov.items():
            name = _ALIASES.get(k, k)
            if name not in MEMBER_AXIS_PARAMS:
                raise ValueError(
                    f"fleet member {j}: {name!r} is not a member-axis "
                    "parameter — fleet members must share every "
                    "structural param (the one-program contract)")
            mp[name] = v
            explicit_out = explicit_out or name == "output_model"
        if not explicit_out:
            mp["output_model"] = f"{cfg.output_model}.member{j}"
        out.append(mp)
    return out


class FleetResult:
    """What ``fleet_train`` returns: the trained boosters plus the
    per-member params and stop bookkeeping, in roster order."""

    def __init__(self, boosters, member_params, stopped, epochs,
                 program=None, epoch_ms=None):
        self.boosters: List[Booster] = boosters
        self.member_params: List[Dict[str, Any]] = member_params
        self.stopped: List[bool] = stopped       # ES/stump per member
        self.epochs: int = epochs                # fleet epochs dispatched
        # the fleet's program (its graph's captured launches and replays)
        # and the device milliseconds of each fleet epoch (CUDA events;
        # empty on the CPU)
        self.program: Optional[FleetProgram] = program
        self.epoch_ms: List[float] = list(epoch_ms or [])

    def __len__(self) -> int:
        return len(self.boosters)

    def __getitem__(self, j: int) -> Booster:
        return self.boosters[j]


def _check_uniform(member_params: List[Dict[str, Any]]) -> None:
    """Every canonical param outside MEMBER_AXIS_PARAMS must be equal
    across the roster."""
    base = None
    for j, mp in enumerate(member_params):
        cp = {k: repr(v) for k, v in sorted(canonical_params(mp).items())
              if k not in MEMBER_AXIS_PARAMS}
        if base is None:
            base = cp
        elif cp != base:
            diff = sorted(set(cp.items()) ^ set(base.items()))
            raise ValueError(
                f"fleet member {j} differs from member 0 outside the "
                f"member axis: {sorted({k for k, _ in diff})} — fleet "
                "members must share every structural param")


def leaf_pad(cfg: Config, learner: str) -> Optional[int]:
    """The JAX package's padded leaf budget (its models/gbdt.py:569-578):
    ``bucket_leaves(num_leaves)`` under ``trace_buckets`` on the masked
    learner, where that pads at most 4x; else None."""
    if not cfg.trace_buckets or learner != "masked":
        return None
    lp = bucket_leaves(cfg.num_leaves)
    return lp if cfg.num_leaves < lp <= 4 * cfg.num_leaves else None


def _check_models(boosters: List[Booster]) -> None:
    """Structural uniformity the members' one epoch shape needs beyond the
    param surface, by the JAX package's rule (its ``_check_models``):
    dense binned data, no CEGB, and an equal signature of padded leaf
    budget, split batch, histogram row block, learner, valid-walk levels,
    bins, valid sets and objective.  So ``num_leaves`` 31 and 63 (both
    padded to 64) share a fleet, 15 and 31 (15 is not padded) do not."""
    from ..sparse_data import SparseBinned
    sig0 = None
    for j, b in enumerate(boosters):
        m = b._model
        if m is None or not hasattr(m, "train_superepoch"):
            raise ValueError(f"fleet member {j}: boosting type "
                             "does not support the super-epoch trainer")
        if m.cegb is not None:
            raise ValueError("fleet_train does not support cegb_* "
                             "(per-member host feature-cost state)")
        if isinstance(m.binned_dev, SparseBinned):
            raise ValueError("fleet_train needs dense device binned "
                             "data (sparse_data is solo-only)")
        cfg = m.config
        pad = leaf_pad(cfg, m.learner)
        sig = (pad, m.split_batch, m.rows_per_block, m.learner,
               traversal_steps(cfg.max_depth, pad or max(cfg.num_leaves, 2)),
               m.max_bin, len(m.valid_sets), type(m.objective).__name__)
        if sig0 is None:
            sig0 = sig
        elif sig != sig0:
            raise ValueError(
                f"fleet member {j} compiles a different program shape "
                f"than member 0 ({sig} vs {sig0}): num_leaves may only "
                "differ under padded_leaves bucketing with equal "
                "split_batch width (the solo trace-sharing rule)")


def fleet_train(params: Dict[str, Any], train_set: Dataset,
                num_boost_round: int = 100,
                valid_sets: Optional[List[Dataset]] = None,
                valid_names: Optional[List[str]] = None,
                callbacks: Optional[Callable[[int], list]] = None,
                members: Optional[Sequence[Dict[str, Any]]] = None,
                ) -> FleetResult:
    """Train a fleet of N boosters over ONE shared dataset, their
    super-epochs in lockstep (module docstring).  Runs on the card unless
    the params say ``device_type=cpu``.

    ``callbacks`` is a FACTORY ``f(member_index) -> [callback, ...]`` (not
    a list): callbacks carry per-run state, so members must not share
    instances.  Early stopping from ``early_stopping_round`` is made per
    member.  Every member's config must qualify for the super-epoch plan
    (``engine._superepoch_plan``); anything else raises rather than
    training a different program than solo would."""
    params = dict(params or {})
    resume_req = False
    for k in list(params):
        if _ALIASES.get(k, k) == "resume":
            resume_req = bool(_coerce("resume", bool, params.pop(k)))
    base_cfg = Config(params)
    if "num_iterations" in canonical_params(params):
        num_boost_round = base_cfg.num_iterations

    member_params = expand_members(params, members)
    N = len(member_params)
    if N < 2:
        raise ValueError(
            "fleet_train needs >= 2 members — set fleet_members, "
            "fleet_sweep, or pass members=[...] overrides")
    for mp in member_params:
        mp["num_iterations"] = num_boost_round
    _check_uniform(member_params)
    if callbacks is not None and not callable(callbacks):
        raise ValueError("fleet_train callbacks must be a factory "
                         "f(member_index) -> [callback, ...] — a shared "
                         "list would share callback state across members")
    if valid_sets is not None and not isinstance(valid_sets,
                                                 (list, tuple)):
        valid_sets = [valid_sets]
    if valid_sets and any(vs is train_set for vs in valid_sets):
        raise ValueError("fleet_train does not support the training "
                         "set in valid_sets (training-metric replay is "
                         "a solo-path feature)")
    member_cfgs = [Config(mp) for mp in member_params]
    if resume_req or any(c.snapshot_freq > 0 for c in member_cfgs):
        raise NotImplementedError(
            "fleet snapshots and resume are not ported to lightgbm_torch "
            "yet (ROADMAP A12)")

    # the members over the SHARED dataset; each member's shared operands
    # then point at member 0's tensors
    boosters: List[Booster] = []
    for mp in member_params:
        b = Booster(params=mp, train_set=train_set)
        if valid_sets:
            names = valid_names or [f"valid_{i}"
                                    for i in range(len(valid_sets))]
            for vs, name in zip(valid_sets, names):
                b.add_valid(vs, name)
        boosters.append(b)
    _check_models(boosters)
    m0 = boosters[0]._model
    for b in boosters[1:]:
        b._model.share_from(m0)

    # per-member callbacks + the shared super-epoch plan
    plans = []
    cbs_after_all: List[list] = []
    for j, b in enumerate(boosters):
        cfg_j = member_cfgs[j]
        cbs = list(callbacks(j)) if callbacks is not None else []
        if cfg_j.early_stopping_round and cfg_j.early_stopping_round > 0:
            cbs.append(callback_mod.early_stopping(
                cfg_j.early_stopping_round, cfg_j.first_metric_only,
                cfg_j.verbosity > 0))
        cbs_before = sorted((c for c in cbs
                             if getattr(c, "before_iteration", False)),
                            key=lambda c: getattr(c, "order", 0))
        cbs_after = sorted((c for c in cbs
                            if not getattr(c, "before_iteration", False)),
                           key=lambda c: getattr(c, "order", 0))
        plan = _superepoch_plan(cfg_j, b, None, None, cbs_before,
                                cbs_after, None)
        if plan is None:
            raise ValueError(
                f"fleet member {j}: config does not qualify for the "
                "super-epoch trainer (custom fobj/feval, non-replayable "
                "callbacks, sparse valid sets, or untraced metrics) — "
                "fleet_train has no per-iteration fallback")
        plans.append(plan)
        cbs_after_all.append(cbs_after)
    base_k, eval_spec, es_spec = plans[0]
    for j, p in enumerate(plans[1:], 1):
        if p != plans[0]:
            raise ValueError(f"fleet member {j}: super-epoch plan "
                             f"differs from member 0 ({p} vs "
                             f"{plans[0]}) — members must share one "
                             "epoch shape")
    E = len(eval_spec)

    fleet: Optional[FleetProgram] = None
    cuda = m0.device.type == "cuda"
    rounds = [0] * N                  # absolute boosting rounds done
    exited = [False] * N              # lane no longer ingests
    stopped_f = [False] * N           # ES raised / stump (final stop)
    epochs = 0
    epoch_ms: List[float] = []
    while True:
        active = [j for j in range(N) if not exited[j]]
        if len(active) < 2:
            break
        k_eff = min(base_k,
                    min(num_boost_round - rounds[j] for j in active))
        if k_eff < 2:
            break

        # per-member prologue + operands: member order is the RNG
        # contract (_se_operands draws each member's feature masks)
        init0s, start_iters, progs, fmasks, it0s = [], [], [], [], []
        for b in boosters:
            m = b._model
            start_iters.append(m.iter_)
            init0s.append(m._se_begin(E, es_spec))
            progs.append(m._program(eval_spec, es_spec, k_eff))
            fm, it0 = m._se_operands(k_eff)
            fmasks.append(fm)
            it0s.append(it0)
        if fleet is None or any(p is not q for p, q in
                                zip(progs, fleet.programs)):
            fleet = FleetProgram(progs)
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        blocks = fleet.run(k_eff, list(rounds), fmasks, it0s,
                           eager=not cuda, exited=exited)
        if cuda:
            t1.record()
        # the ONE host sync of the epoch: every member's trees, eval
        # block and stop flags in a single fetch
        hosts, devs = fleet.fetch(blocks)
        if cuda:
            epoch_ms.append(t0.elapsed_time(t1))
        epochs += 1

        for j, b in enumerate(boosters):
            if exited[j]:
                continue
            m = b._model
            res = m._se_ingest(progs[j], hosts[j], devs[j], k_eff,
                               start_iters[j], init0s[j])
            b._sync_trees()
            if replay_block(b, member_params[j], cbs_after_all[j],
                            eval_spec, res, rounds[j], num_boost_round,
                            f"fleet member {j}:"):
                exited[j] = stopped_f[j] = True
            rounds[j] = b.current_iteration
            if rounds[j] >= num_boost_round:
                exited[j] = True

    # stragglers (odd remainders, or a fleet reduced below two members)
    # finish through the solo path's own loop: byte-identical by
    # construction
    for j in range(N):
        if not exited[j]:
            stopped_f[j] = boost_rounds(
                boosters[j], member_params[j], member_cfgs[j], rounds[j],
                num_boost_round, None, None, [], cbs_after_all[j],
                plans[j], None) or stopped_f[j]
    return FleetResult(boosters, member_params, stopped_f, epochs, fleet,
                       epoch_ms)

