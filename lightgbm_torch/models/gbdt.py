"""GBDT boosting loop.

Counterpart of the JAX package's ``models/gbdt.py`` ``GBDTModel`` for the
slice this port runs: the masked learner on one device, one tree an
iteration, or K for a multiclass objective.  One iteration (gbdt.cpp:371
``TrainOneIter``) is:
BoostFromAverage on the first iteration -> gradients (B5) -> the row
weights (B6: the bagging mask, or GOSS's top-k and keyed draw) -> one tree
from the device-resident grower (with the per-node draws of
``feature_fraction_bynode`` and ``extra_trees``, B6-node)
(strict B1-B3s below 64 leaves, batched B1-K/B3-K/B3s-K with K =
``split_batch`` from there, resolved as the JAX package resolves it; on
an EFB-bundled matrix with B9 before each split scan; with
``quant_train`` on packed int8/int16 rows, B7, and exact int32
histograms, B1-int/B1-K-int, dequantized by B7c; on sparse binned storage
over the k-hot rows, B8a-c; with the split controls, monotone ``basic``,
interaction constraints, ``feature_contri`` and CEGB, inside B2, B3s/B3s-K
and B6-node, CEGB's used features carried from tree to tree) ->
f32 shrinkage -> train score += leaf value gathered through the grower's
row -> leaf vector -> every valid score += tree walk (B4).  With
``tpu_learner=partitioned`` (or forced splits, or monotone
``intermediate``/``advanced``, which promote ``auto`` to it) the tree
comes from the partitioned learner (``grower_partitioned.py``: B11a-c,
histogram work that grows with the smaller child, the per-node controls
on the host), on the per-iteration path only.  The iteration
is ``models/fused.py``'s ``IterationProgram.body``, and three paths run
it, as in the JAX package:

- ``train_one_iter``, the per-iteration path: the body once, then one
  host fetch of the tree;
- ``train_chunk``, fused chunks (no valid set): k iterations as k
  replays of the body's CUDA graph, one fetch per chunk;
- ``train_superepoch``: k iterations with the valid walks, the traced
  metrics (B12) and the early-stop vote in the graph, one fetch per
  epoch.

A multiclass model (``num_class`` K > 1, softmax, one-vs-all or a custom
objective) runs the per-iteration path only, as the JAX package's
``train_one_iter`` (:2554-2935) does: its scores are [N, K], the
gradients [N, K] are taken once an iteration, and K trees grow one after
the other on one bagging and one feature_fraction mask (GOSS per class,
every draw keyed by the same iteration), each shrunk in f64 and added to
its class column of the train and valid scores (B4's column form); the
iteration stops training only when all K trees are stumps.  Tree ``t``
belongs to class ``t % K``.

An objective that renews its leaf values on the host (l1, quantile,
mape: RenewTreeOutput) or that advances host state each iteration
(rank_xendcg's draws) has no fused-path semantics, as in the JAX package:
it runs the per-iteration path, the renewal between growth and the score
update (``renew_leaves``).  lambdarank's gradients (B13a) run inside the
captured iteration like any other objective's.

A fleet (``fleet/trainer.py``) runs the super-epoch path of N models
over one Dataset in lockstep: each model's epoch prologue, operands and
ingest are ``_se_begin``, ``_se_operands`` and ``_se_ingest``, the calls
``train_superepoch`` makes, and ``share_from`` points a member's shared
matrices at member 0's.

The three give the same trees.  The reported metric values are not the
same: the fused paths (and ``fused_eval=true`` per-iteration runs) report
the traced f32 metrics, the per-iteration path by default the host f64
metrics (``metrics.py``), as the JAX package does.  Every training fetch
goes through ``_fetch``, which counts it by site.  Trees are kept on the
host (``Tree``) for the model text and on the device (``_DeviceTree``,
views of the fetched block's device copy) for later tree walks.

With ``integrity_check_freq`` > 0 (policies ``raise`` and ``quarantine``)
the computation-integrity layer (``integrity.py``; the JAX package's
:724-748) checks every tree on the per-iteration loop: the tree
invariants (B17a) every iteration, the shadow grower
(``grower.make_shadow_grower``, a second, separately built set of the
grower's kernels) and the score re-gather (B17b) every
``integrity_check_freq``-th; ``models/fused.py`` runs the checked
iteration.  The fused paths refuse it, and armed fault injection, as the
JAX package's do (``fused_reasons``).

With ``tree_learner=data|feature|voting`` (or ``num_machines`` > 1,
which promotes ``serial`` to ``data``) and a ``torch.distributed``
process group of at least two ranks, the tree comes from a distributed
learner of ``parallel/`` (the JAX package's :231-276, :598-636), one
process per rank: data- and voting-parallel ranks hold their own rows,
feature-parallel ranks every row; every rank grows the same tree (the
grower's ``DistHooks``) and updates its own rows' scores and its own
valid sets.  BoostFromScore reads the global label statistics, each
data-parallel rank draws its own bagging mask (``fold_in`` by rank),
quantized training checks the global row count and keys its rounding by
global row ids.  Distributed learners run the per-iteration loop
(``fused_reasons``).  Without such a group (a lone rank) the learner
warns as the JAX package does and trains serially
(``resolve_distribution``).

Parameter values that need modules the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item (``_refuse_unported``,
``distributed_refusals``).
"""

from __future__ import annotations

import json
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..basic import LightGBMError
from ..binning import BinType
from ..config import Config
from ..constraints import (contri_vector, device_constraints,
                           interaction_allow, make_cegb, monotone_vector)
from ..dataset import Dataset
from ..efb import bin_grouped, make_device_efb
from ..grower import GrowWorkspace, batch_width, host_tree, \
    make_shadow_grower
from ..grower_partitioned import PartitionedGrower
from ..metrics import check_class_labels
from ..objectives import ObjectiveFunction
from ..ops.histogram import form_launch_shape
from ..ops.quantize import QuantSpec, max_rows
from ..ops.random import NodeSampling, bag_mask_plain
from ..ops.split import SplitParams
from ..predict_device import add_tree_score, walk_maps
from ..tree_model import Tree
from ..utils import faultinject
from ..utils.log import Log
from ..utils.shapes import (SPLIT_BATCH_SET, fit_split_batch, round_up_pow2,
                            snap_split_batch, traversal_steps)
from .fused import IterationProgram


def resolve_device(config: Config) -> torch.device:
    """The training device: the CUDA card unless ``device_type=cpu``.
    With ``device_type=cuda`` and no card this raises; it never carries on
    on the CPU."""
    return device_for(config.device_type)


def device_for(device_type: str) -> torch.device:
    """The device of ``device_type`` (``cuda`` or ``cpu``; see
    ``resolve_device``)."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise LightGBMError(
            "device_type=cuda, but no CUDA card is available "
            "(torch.cuda.is_available() is False); pass device_type=cpu to "
            "run lightgbm_torch on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _unported(config: Config, ds: Dataset) -> List[Tuple[str, str]]:
    """(what, ROADMAP item) of every parameter value whose module the
    port does not have yet."""
    c = config
    checks = [
        (c.boosting not in ("gbdt", "gbrt"), f"boosting={c.boosting}", "A9"),
        (c.linear_tree, "linear_tree", "A9"),
        (c.snapshot_freq > 0 or c.resume, "snapshots and resume", "A12"),
        (c.integrity_check_freq > 0 and c.integrity_policy == "rewind",
         "integrity_policy=rewind", "A12"),
        (c.finite_check_freq > 0, "finite checks", "A12"),
        (c.telemetry or c.telemetry_blackbox, "telemetry", "A15"),
        (ds.binned_sparse.stride > 256 if ds.binned_sparse is not None
         else ds.binned is None or ds.binned.dtype != np.uint8,
         "more than 256 bins per feature or per EFB bundle", "A9.5"),
    ]
    return [(what, item) for hit, what, item in checks if hit]


def load_forced(config: Config, ds: Dataset):
    """``forcedsplits_filename``'s JSON tree in used-feature slot and bin
    space (the JAX package's ``_load_forced``, models/gbdt.py:908-933):
    each node's threshold is ``value_to_bin`` of its feature's mapper;
    a node on a feature the dataset does not use is dropped with its
    subtree.  None without a file."""
    if not config.forcedsplits_filename:
        return None
    with open(config.forcedsplits_filename) as f:
        spec = json.load(f)
    slot_of_orig = {f: i for i, f in enumerate(ds.used_features)}

    def conv(node):
        if not isinstance(node, dict) or "feature" not in node:
            return None
        orig = int(node["feature"])
        if orig not in slot_of_orig:
            return None
        mapper = ds.bin_mappers[orig]
        thr_bin = int(mapper.value_to_bin(
            np.asarray([float(node["threshold"])]))[0])
        out = {"feature": slot_of_orig[orig], "threshold_bin": thr_bin}
        for side in ("left", "right"):
            c = conv(node.get(side))
            if c is not None:
                out[side] = c
        return out

    return conv(spec)


def resolve_learner(config: Config, ds: Dataset, forced) -> str:
    """``masked`` or ``partitioned``, by the JAX package's rules
    (models/gbdt.py:144-165, :200-229, :659-666): ``auto`` is ``masked``
    on both devices (the JAX package's rule for a non-CPU backend, and
    the port's CPU path is the card path's twin); sparse binned storage
    overrides an explicit ``partitioned`` with the JAX package's warning;
    forced splits (``forced``, the parsed tree) and the monotone methods
    ``intermediate``/``advanced`` promote ``auto`` to ``partitioned`` and
    raise the JAX package's ``ValueError`` on sparse storage or with an
    explicit ``masked``."""
    learner = "partitioned" if config.tpu_learner == "partitioned" \
        else "masked"
    if ds.binned_sparse is not None:
        if learner == "partitioned":
            Log.warning(
                "tpu_learner=partitioned overridden to masked: the "
                "dataset chose sparse binned storage (pass "
                "enable_sparse=false to keep the partitioned learner)")
        learner = "masked"
    node_controls = (monotone_vector(config, ds) is not None
                     and config.monotone_constraints_method != "basic") \
        or forced is not None
    if node_controls and ds.binned_sparse is not None:
        raise ValueError(
            "forced splits and monotone intermediate/advanced need the "
            "host-orchestrated learner, which requires dense binned "
            "storage; construct the Dataset with enable_sparse=false")
    if node_controls and config.tpu_learner == "auto":
        learner = "partitioned"
    if node_controls and learner != "partitioned":
        raise ValueError(
            "monotone intermediate/advanced and forced splits "
            "currently require the partitioned learner "
            "(tpu_learner=partitioned, single-chip); monotone "
            "basic, interaction constraints, CEGB and "
            "feature_fraction_bynode work on the masked learner")
    return learner


def pool_entries(config: Config, num_features: int, max_bin: int,
                 efb) -> int:
    """``histogram_pool_size`` (MB) as the partitioned learner's count of
    cached leaf histograms (the JAX package's ``_pool_entries``,
    models/gbdt.py:935-950): 0 (unbounded) when not set; ``efb`` the
    host ``EFBInfo`` or None."""
    if config.histogram_pool_size <= 0:
        return 0
    cols = efb.max_group_bin if efb is not None else max_bin
    nf = (int(np.max(efb.group_of_feat)) + 1 if efb is not None
          else num_features)
    bytes_per_leaf = max(nf, 1) * max(cols, 2) * 3 * 4
    return max(2, int(config.histogram_pool_size * 1024 * 1024
                      / bytes_per_leaf))


def hist_tune_record(config: Config, learner: str, sparse: bool,
                     n_rows: int, n_cols: int, num_bins: int,
                     itemsize: int, device: torch.device) -> Optional[dict]:
    """The autotuner's record (``ops/hist_tune.py``, B15) when
    ``hist_tune=on`` engages, else None, by the JAX package's rule
    (models/gbdt.py:472-525): only with ``split_batch`` 0 (auto), on the
    masked learner and dense storage, and when the leaf budget admits a
    width above 1 (``kmax = fit_split_batch(64, num_leaves)``).  ``n_cols``
    and ``num_bins`` are the histograms' axes (EFB groups and group bins on
    a bundled matrix), ``itemsize`` the vals' (4, or 1/2 under
    ``quant_train``).  A failure of the table's I/O (or of the sweep
    other than a kernel's) logs a warning and keeps the untuned shapes; a
    kernel's failure to build or launch propagates."""
    if config.hist_tune != "on" or config.split_batch >= 1 \
            or learner != "masked" or sparse:
        return None
    kmax = fit_split_batch(SPLIT_BATCH_SET[-1], config.num_leaves)
    if kmax <= 1:
        return None
    from ..ops.hist_tune import ensure
    try:
        rec = ensure(n_rows, n_cols, num_bins, itemsize=itemsize, kmax=kmax,
                     config=config, device=device)
    except Exception as e:        # the table is best-effort
        if _kernels.is_kernel_fault(e):
            raise
        Log.warning(f"hist_tune failed ({type(e).__name__}: {e}); "
                    "keeping untuned shapes")
        return None
    Log.info(f"hist_tune: measured choice K={rec['k']} "
             f"block_rows={rec['block_rows']} "
             f"({rec['ms_per_leaf']} ms/leaf-slot at "
             f"{rec.get('sample_rows')} sampled rows)")
    return rec


def resolve_rows_per_block(config: Config,
                           tuned: Optional[dict] = None) -> int:
    """The histogram passes' row block: ``rows_per_block``, or where it
    is 0 (automatic) the autotuner's ``block_rows`` (the JAX package's
    :485, :516-517); 0 = the kernels' automatic shape."""
    if config.rows_per_block > 0:
        return int(config.rows_per_block)
    return int(tuned["block_rows"]) if tuned is not None else 0


def resolve_split_batch(config: Config,
                        tuned: Optional[dict] = None) -> int:
    """The batched grower's width K for this configuration, by the JAX
    package's rules (models/gbdt.py:451-553): ``split_batch`` 0 (auto) is
    16 from 128 leaves, 8 from 64, else 1, or the autotuner's K when
    ``tuned`` (``hist_tune_record``); under ``trace_buckets`` a width is
    snapped into ``SPLIT_BATCH_SET``, and a width past 16 fitted under the
    leaf budget.  The grower then clamps K to ``num_leaves - 1``
    (``grower.batch_width``)."""
    sb, L = config.split_batch, config.num_leaves
    k = sb if sb >= 1 else (16 if L >= 128 else 8 if L >= 64 else 1)
    if sb < 1 and k > 1:
        Log.info(
            f"num_leaves={L} auto-selects split_batch={k} (top-K batched "
            "growth; trees differ slightly from strict leaf-wise order — "
            "set split_batch=1 for exact reference growth)")
    if tuned is not None:
        k = int(tuned["k"])
    if config.trace_buckets and k > 1:
        snapped = k if k in SPLIT_BATCH_SET else snap_split_batch(k)
        if snapped > 16:
            snapped = fit_split_batch(snapped, L)
        if snapped != k:
            Log.info(
                f"split_batch={k} snapped to the shipped super-step width "
                f"{snapped} (trace_buckets=true pins the trace family to K "
                f"in {SPLIT_BATCH_SET}, fitted under num_leaves={L}; set "
                "trace_buckets=false to keep an off-set width)")
            k = snapped
    return batch_width(k, L)


def quant_spec(config: Config, num_data: int) -> Optional[QuantSpec]:
    """The ``QuantSpec`` of ``quant_train`` (None when off), as the JAX
    package builds it (models/gbdt.py:346-362): ``quant_bits`` lanes,
    stochastic or nearest rounding, keyed by ``seed``.  Refuses a row
    count whose int32 histograms could overflow (:580-601): one bin may
    collect every row, each adding up to ``qmax`` a channel."""
    if not config.quant_train:
        return None
    spec = QuantSpec(bits=int(config.quant_bits),
                     stochastic=config.quant_round == "stochastic",
                     seed=int(config.seed))
    if num_data > max_rows(spec):
        hint = "quant_bits=8 (bound ~16.9M rows) or " \
            if spec.bits == 16 else ""
        raise ValueError(
            f"quant_bits={spec.bits} can overflow the int32 histogram "
            f"accumulator at {num_data} rows: a single bin may collect "
            f"every row, so rows * qmax ({spec.qmax}) must stay under 2^31 "
            f"(at most {max_rows(spec)} rows).  Use {hint}quant_train="
            "false.")
    return spec


def _refuse_unported(config: Config, ds: Dataset) -> None:
    """NotImplementedError for the first parameter value whose module the
    port does not have yet, naming the ROADMAP item that ports it."""
    for what, item in _unported(config, ds):
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_torch yet (ROADMAP {item})")


DIST_LEARNERS = ("data", "feature", "voting")


def resolve_distribution(config: Config, device: torch.device):
    """The distributed learner and its ``ProcessMesh``, or (None, None):
    the JAX package's ``_resolve_mesh`` (models/gbdt.py:953-1060) over the
    ranks of the default ``torch.distributed`` group.  ``mesh_shape`` >
    ``num_machines`` > every rank gives the size; a size above the
    group's raises, a lone rank warns and trains serially."""
    kind = config.tree_learner if config.tree_learner in DIST_LEARNERS \
        else None
    if kind is None:
        return None, None
    import torch.distributed as tdist
    world = tdist.get_world_size() if tdist.is_available() \
        and tdist.is_initialized() else 1
    if config.mesh_shape and len(config.mesh_shape) > 1:
        raise ValueError(
            f"mesh_shape={config.mesh_shape}: tree_learner="
            f"{config.tree_learner} shards a single axis; pass a "
            "one-element mesh_shape (e.g. [8])")
    if config.mesh_shape:
        n = int(np.prod(config.mesh_shape))
    elif config.num_machines > 1:
        n = config.num_machines
    else:
        n = world
    if n > world:
        raise ValueError(
            f"tree_learner={config.tree_learner} needs {n} ranks "
            f"(mesh_shape/num_machines), only {world} in the "
            "torch.distributed process group")
    if n <= 1:
        Log.warning(
            f"tree_learner={config.tree_learner} requested but only one "
            "device is visible; training serially")
        return None, None
    if n != world:
        raise ValueError(
            f"tree_learner={config.tree_learner}: the learner spans the "
            f"whole process group ({world} ranks), not {n}")
    from ..parallel.mesh import ProcessMesh
    axis = "feature" if kind == "feature" else "data"
    return kind, ProcessMesh(None, axis, device)


def distributed_checks(config: Config, ds: Dataset, kind: str,
                       objective) -> None:
    """The JAX package's ``ValueError``s for the controls a distributed
    learner cannot take (models/gbdt.py:255-276), then
    ``NotImplementedError`` naming ROADMAP A16b for what the port's
    learners do not take yet."""
    mono = monotone_vector(config, ds)
    if (mono is not None and config.monotone_constraints_method != "basic") \
            or config.forcedsplits_filename \
            or interaction_allow(config, ds) is not None \
            or config.feature_fraction_bynode < 1.0 \
            or make_cegb(config, ds) is not None:
        raise ValueError(
            "monotone intermediate/advanced, interaction "
            "constraints, CEGB, forced splits and "
            "feature_fraction_bynode are not supported with "
            f"tree_learner={kind} (they require a single-chip "
            "learner); monotone basic IS supported")
    if contri_vector(config, ds) is not None or config.extra_trees:
        raise ValueError(
            "feature_contri and extra_trees are not yet supported "
            f"with tree_learner={kind}")
    if mono is not None and kind in ("feature", "voting"):
        raise ValueError(
            f"monotone constraints with tree_learner={kind} are "
            "not supported (the [F] constraint vector would need "
            "feature-axis sharding); use tree_learner=data")
    refusals = [
        (ds.efb is not None and kind == "data",
         "EFB bundles under tree_learner=data (the owned-group "
         "expansion)"),
        (ds.binned_sparse is not None,
         "sparse k-hot storage under a distributed learner"),
        (config.data_sample_strategy == "goss",
         "GOSS's global threshold across ranks"),
        (config.num_model_per_iteration > 1,
         "multiclass under a distributed learner"),
        (objective is not None and getattr(objective, "is_ranking", False),
         "ranking under a distributed learner"),
        (config.integrity_check_freq > 0,
         "the integrity layer under a distributed learner"),
        (config.elastic_enable,
         "the elastic layer (heartbeats, guarded_get, the collective "
         "deadline, the recovery ladder)"),
    ]
    for hit, what in refusals:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to lightgbm_torch yet (ROADMAP "
                "A16b)")


class PhaseTimer:
    """Per-phase time of the per-iteration loop.  On the card it records
    CUDA events on the stream (no synchronisation while training) and sums
    the spans between consecutive marks when read; on the CPU it reads
    the host clock.  Off unless a caller sets ``GBDTModel.phase_timer``.
    A fused epoch is one graph replay per iteration, inside which no
    phase can be timed: ``GBDTModel.epoch_ms`` times whole epochs."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._marks: List[Tuple[str, object]] = []

    def mark(self, phase: str) -> None:
        """Close the current phase and open ``phase`` ("" = none)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((phase, ev))
        else:
            self._marks.append((phase, time.perf_counter()))

    def totals_ms(self) -> Dict[str, float]:
        if self.cuda:
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for (phase, a), (_, b) in zip(self._marks, self._marks[1:]):
            if not phase:
                continue
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out[phase] = out.get(phase, 0.0) + ms
        return out


_NODE_TABLES = ("split_feature", "threshold_bin", "default_left",
                "left_child", "right_child", "is_cat_node", "cat_rank")


class _DeviceTree:
    """A tree's node tables and shrunk leaf values on the device (views
    of a fetched block's device copy), for B4; ``is_cat_node`` and
    ``cat_rank`` are None without a categorical feature."""

    __slots__ = _NODE_TABLES + ("leaf_value", "steps")

    def __init__(self, fields: Dict[str, torch.Tensor],
                 leaf_value: torch.Tensor, steps: int):
        for name in _NODE_TABLES:
            setattr(self, name, fields.get(name))
        self.leaf_value = leaf_value
        self.steps = steps


def _apply_tree(score: torch.Tensor, binned, dt: _DeviceTree,
                na_bin: torch.Tensor, weight: float, column: int = 0,
                efb_maps=None) -> torch.Tensor:
    """score += weight * tree(binned), in place (kernel B4), into
    ``score[:, column]`` of a multiclass [N, K] score; ``efb_maps`` for
    the bundled matrix; ``binned`` dense rows or k-hot ``SparseBinned``
    ones."""
    return add_tree_score(score, binned, dt.split_feature, dt.threshold_bin,
                          dt.default_left, dt.left_child, dt.right_child,
                          na_bin, dt.leaf_value, weight, steps=dt.steps,
                          is_cat_node=dt.is_cat_node, cat_rank=dt.cat_rank,
                          column=column,
                          efb_maps=walk_maps(binned, efb_maps))


def _init_scores(init_score, n: int, k: int) -> np.ndarray:
    """The f32 starting scores of n rows: [n] for one class, [n, k] for
    k; a given ``init_score`` is reshaped ``(n, -1)`` row-major, as the
    JAX package reshapes it."""
    init = np.zeros(n if k == 1 else (n, k), np.float32)
    if init_score is not None:
        s = np.asarray(init_score, np.float32)
        init += s.reshape(-1) if k == 1 else s.reshape(n, -1)
    return init


class GBDTModel:
    """Boosting state machine (boosting.h:27-319 interface analog)."""

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[ObjectiveFunction]):
        self.config = config
        self.train_set = train_set.construct(config)
        self.objective = objective
        self.learning_rate = config.learning_rate
        self.iter_ = 0
        # trees an iteration: K for a multiclass objective, else 1
        self.num_class = config.num_model_per_iteration
        ds = self.train_set
        self.num_data = ds.num_data
        self.num_features = ds.num_features
        if self.num_features == 0:
            raise ValueError("Dataset has no usable (non-trivial) features")
        # the learner (``resolve_learner``): sparse k-hot storage rides the
        # masked grower; forced splits and the monotone methods past
        # basic need the partitioned one
        sparse = ds.binned_sparse is not None
        self.forced = load_forced(config, ds)
        # a distributed learner (None on a lone rank, which trains
        # serially) over the ranks of the process group
        self.device = resolve_device(config)
        self.dist, self.mesh = resolve_distribution(config, self.device)
        if self.dist is not None:
            distributed_checks(config, ds, self.dist, objective)
        self.learner = "masked" if self.dist is not None else \
            resolve_learner(config, ds, self.forced)
        _refuse_unported(config, ds)
        if config.integrity_check_freq > 0 and self.learner == "partitioned":
            raise ValueError(
                "integrity_check_freq > 0 is unsupported with "
                "tpu_learner=partitioned: its grower keeps host-side "
                "pool/RNG state, so a shadow re-execution is not a "
                "pure recompute.  Use the masked learner")
        if sparse and config.quant_train:
            raise ValueError(
                "quant_train requires dense binned storage (the "
                "sparse k-hot segment-sum histogram has no integer "
                "formulation yet); construct the Dataset with "
                "enable_sparse=false")

        self.split_params = SplitParams(
            lambda_l1=config.lambda_l1,
            lambda_l2=config.lambda_l2,
            min_data_in_leaf=config.min_data_in_leaf,
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            max_delta_step=config.max_delta_step,
            path_smooth=config.path_smooth,
            cat_l2=config.cat_l2,
            cat_smooth=config.cat_smooth,
            max_cat_threshold=config.max_cat_threshold,
            max_cat_to_onehot=config.max_cat_to_onehot,
            min_data_per_group=config.min_data_per_group,
        )
        num_bin = np.asarray([ds.bin_mappers[f].num_bin
                              for f in ds.used_features], np.int32)
        na_bin = np.asarray([ds.bin_mappers[f].na_bin
                             for f in ds.used_features], np.int32)
        self.max_bin = int(num_bin.max())
        dev = self.device
        self.num_bin_dev = torch.as_tensor(num_bin).to(dev)
        self.na_bin_dev = torch.as_tensor(na_bin).to(dev)
        # the categorical features (B2-cat and the rank rows), None
        # without one
        is_cat = np.asarray([ds.bin_mappers[f].bin_type
                             == BinType.CATEGORICAL
                             for f in ds.used_features], bool)
        self.is_cat_dev = torch.as_tensor(is_cat).to(dev) \
            if is_cat.any() else None
        self.feature_mask = torch.ones(self.num_features, dtype=torch.bool,
                                       device=dev)
        # EFB (the JAX package's :289-291, :381-389; the port has the
        # masked learner on one device only): the device matrix stays
        # bundled, [N, G]; the growers expand histograms (B9) and B3/B3-K
        # and B4 decode bins through the maps
        # the distributed learners take the flat matrix (feature and
        # voting vote per feature, as the JAX package's :294-298; EFB
        # under data is A16b)
        self.efb_dev = make_device_efb(ds.efb, num_bin, self.max_bin, dev) \
            if self.dist is None else None
        self.efb_maps = None if self.efb_dev is None else self.efb_dev.maps
        # sparse binned storage: the k-hot rows on the card (the JAX
        # package's :364-365, :443-449); B8a builds the histograms and
        # B3/B3-K and B4 decode a feature's bin from a row's entries
        if sparse:
            self.binned_dev = ds.binned_sparse.to_device(dev)
        else:
            self.binned_dev = torch.as_tensor(np.ascontiguousarray(
                ds.binned if ds.efb is None or self.efb_dev is not None
                else ds.feature_binned())).to(dev)
        partitioned = self.learner == "partitioned"
        # the ranks' row counts: the global count, this rank's first
        # global row (data and voting; feature-parallel replicates rows)
        self.rank_rows = None
        self.row_offset = 0
        n_global = self.num_data
        if self.dist in ("data", "voting"):
            self.rank_rows = [int(n) for n in
                              self.mesh.all_gather_object(self.num_data)]
            self.row_offset = sum(self.rank_rows[:self.mesh.rank])
            n_global = sum(self.rank_rows)
        self.quant = quant_spec(config, n_global)
        # the histogram autotuner (B15; None unless hist_tune=on engages)
        # over the histograms' axes: EFB groups at group-bin width, else
        # the features
        hist_cols = self.num_features if sparse else \
            int(self.binned_dev.shape[1])
        hist_bins = self.efb_dev.group_bins if self.efb_dev is not None \
            else self.max_bin
        # a distributed learner takes no rank-local sweep: the ranks must
        # grow with one K
        self.hist_tuned = None if self.dist is not None else \
            hist_tune_record(
                config, self.learner, sparse, self.num_data, hist_cols,
                hist_bins, 4 if self.quant is None else self.quant.bits // 8,
                dev)
        if self.dist is not None and config.hist_tune == "on":
            Log.warning(f"hist_tune=on ignored under tree_learner="
                        f"{self.dist}: every rank must grow with one K")
        # the partitioned and voting learners grow strictly leaf-wise
        self.split_batch = 1 if partitioned or self.dist == "voting" else \
            resolve_split_batch(config, self.hist_tuned)
        # every dense histogram pass's row block (0 = automatic); an
        # explicit value past the partial buffer's cap is refused here,
        # for the root pass's form and the super-steps'
        self.rows_per_block = resolve_rows_per_block(config,
                                                     self.hist_tuned)
        if self.rows_per_block > 0 and not sparse:
            widths = (None,) if self.split_batch == 1 \
                else (None, self.split_batch)
            for k in widths:
                form_launch_shape(self.num_data, hist_cols, hist_bins, k,
                                  self.quant is not None,
                                  self.rows_per_block)
        # the split controls (the JAX package's :176-195, :883-906,
        # :1207-1234): monotone basic with its penalty, interaction
        # groups, feature_contri and CEGB, whose cross-tree used features
        # ``cegb.used`` the trainer keeps on the host and sets into the
        # workspace's ``cuse`` before each tree or epoch
        self.cegb = make_cegb(config, ds)
        self.constraints = device_constraints(
            config.num_leaves, dev, mono=monotone_vector(config, ds),
            mono_penalty=config.monotone_penalty,
            contri=contri_vector(config, ds),
            groups=interaction_allow(config, ds), cegb=self.cegb)
        # the distributed learner's grow (None on a single device)
        self.dist_grower = self._make_dist_grower()
        self.grow_ws = GrowWorkspace(self.num_data, self.num_features,
                                     self.max_bin, config.num_leaves, dev,
                                     split_batch=self.split_batch,
                                     categorical=self.is_cat_dev is not None,
                                     efb=self.efb_dev, quant=self.quant,
                                     constraints=self.constraints,
                                     rows_per_block=self.rows_per_block,
                                     dist=None if self.dist_grower is None
                                     else self.dist_grower.hooks)
        # the computation-integrity layer (integrity.py): None unless
        # integrity_check_freq > 0, and then the masked learner's checker
        # with its shadow grower (the partitioned learner raised above)
        self._integrity = None
        if config.integrity_check_freq > 0:
            from ..integrity import IntegrityChecker
            shadow = make_shadow_grower(self.grow_ws)
            self._integrity = IntegrityChecker(
                config, shadow, shadow.independent,
                (config.num_leaves, self.max_bin, self.grow_ws.cat_bins))
        # the partitioned learner (its host RNG streams live across trees)
        self.partitioned: Optional[PartitionedGrower] = None
        if partitioned:
            self.partitioned = PartitionedGrower(
                num_leaves=config.num_leaves, num_bins=self.max_bin,
                params=self.split_params, num_bin=num_bin, na_bin=na_bin,
                device=dev, max_depth=config.max_depth,
                mono=monotone_vector(config, ds),
                mono_method=config.monotone_constraints_method,
                mono_penalty=config.monotone_penalty,
                interaction_groups=interaction_allow(config, ds),
                bynode_frac=config.feature_fraction_bynode,
                bynode_seed=config.feature_fraction_seed + 1,
                efb=self.efb_dev,
                efb_host=None if ds.efb is None else (
                    ds.efb.group_of_feat, ds.efb.off_of_feat),
                pool_entries=pool_entries(config, self.num_features,
                                          self.max_bin, ds.efb),
                feature_contri=contri_vector(config, ds),
                extra_trees=bool(config.extra_trees),
                extra_seed=config.extra_seed, quant=self.quant,
                rows_per_block=self.rows_per_block, fetch=self._fetch)
        # the valid walk's level count: the configuration's worst case, on
        # every path (a row stops at its leaf, so the result is the same)
        self.walk_steps = traversal_steps(config.max_depth,
                                          config.num_leaves)
        self._lr32 = torch.tensor(np.float32(self.learning_rate),
                                  device=dev)

        if self.objective is not None:
            self.objective.init(ds.metadata, self.num_data, dev)

        # sampling: the iteration keys' offset (0 until resume, ROADMAP
        # A12, sets it), the feature_fraction mask stream, GOSS (which
        # turns bagging off) and the growers' per-node draws
        self._iter_rng_offset = 0
        self._rng_feat = np.random.RandomState(config.feature_fraction_seed)
        self._goss = config.data_sample_strategy == "goss"
        sampling = NodeSampling(
            bynode_frac=config.feature_fraction_bynode,
            bynode_seed=config.feature_fraction_seed + 1,
            extra_trees=bool(config.extra_trees),
            extra_seed=config.extra_seed)
        # the partitioned learner draws its nodes from host streams
        self.node_sampling = sampling if sampling.on and not partitioned \
            else None
        self.bag_positive: Optional[torch.Tensor] = None
        if self._use_bagging and self._pos_neg_bagging:
            label = np.asarray(ds.metadata.label).reshape(-1)
            self.bag_positive = torch.as_tensor(
                (label > 0).astype(np.uint8)).to(dev)

        # a torch allocation (``torch.tensor`` copies), never a view of
        # numpy-owned memory: every buffer the gradients read is torch's
        self.score = torch.tensor(_init_scores(
            ds.metadata.init_score, self.num_data, self.num_class),
            device=dev)
        self._init_applied = ds.metadata.init_score is not None

        # validation sets: (dataset, device binned, device score)
        self.valid_sets: List[Tuple[Dataset, torch.Tensor,
                                    torch.Tensor]] = []
        self._valid_ops: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.models: List[Tree] = []
        # called after the model drops trees on its own (the booster's
        # predictor-cache invalidation)
        self.on_change: Optional[Callable[[], None]] = None
        self.device_trees: List[_DeviceTree] = []
        self.tree_weights: List[float] = []
        self.step_counts: List[int] = []
        self.phase_timer: Optional[PhaseTimer] = None
        # host fetches of training, by site (``_fetch``)
        self.fetch_counts: Dict[str, int] = {}
        # (eval_spec, es key) -> IterationProgram
        self._programs: Dict[tuple, IterationProgram] = {}
        # traced early-stop vote state (best, best iter, has best, stop)
        self.es_state: Optional[Tuple[torch.Tensor, ...]] = None
        # device milliseconds of every fused epoch (CUDA events)
        self.epoch_ms: List[float] = []
        # the renewed, shrunk f64 leaf values of the iteration in flight
        # (``renew_leaves``), for its host tree
        self._renewed_lv: Optional[np.ndarray] = None
        self._fusable = not self._config_blockers()

    # -- sampling (gbdt.cpp:230 Bagging; the JAX package's :1297-1404) -------
    @property
    def _bagging_active(self) -> bool:
        cfg = self.config
        return cfg.bagging_freq > 0 and (
            cfg.bagging_fraction < 1.0 or cfg.pos_bagging_fraction < 1.0
            or cfg.neg_bagging_fraction < 1.0)

    @property
    def _use_bagging(self) -> bool:
        """The bagging draw runs: bagging is active and GOSS is off (the
        JAX package's ``use_bag``)."""
        return self._bagging_active and not self._goss

    @property
    def _pos_neg_bagging(self) -> bool:
        """pos/neg fractions apply: a binary objective with either < 1."""
        cfg = self.config
        return (cfg.pos_bagging_fraction < 1.0
                or cfg.neg_bagging_fraction < 1.0) \
            and self.objective is not None \
            and self.objective.name == "binary"

    def bagging_args(self) -> dict:
        """Keyword arguments of ``ops.random.bag_vals`` for this model."""
        cfg = self.config
        return dict(seed=cfg.bagging_seed, freq=cfg.bagging_freq,
                    fraction=cfg.bagging_fraction,
                    pos_fraction=cfg.pos_bagging_fraction,
                    neg_fraction=cfg.neg_bagging_fraction,
                    positive=self.bag_positive, fold=self.bag_fold)

    @property
    def bag_fold(self) -> Optional[int]:
        """The rank a row-sharded learner folds into its bagging key (the
        JAX package's multi-process ``_bagging_w``, :1320-1326: each rank
        draws its own rows' mask); None otherwise (feature-parallel ranks
        hold the same rows and must draw the same mask)."""
        return self.mesh.rank if self.dist in ("data", "voting") else None

    def _make_dist_grower(self):
        """The distributed learner's ``grow`` (``parallel/``), None without
        one."""
        cfg = self.config
        if self.dist is None:
            return None
        if self.dist == "data":
            from ..parallel.data_parallel import make_dp_grower
            return make_dp_grower(
                self.mesh, num_features=self.num_features,
                num_bins=self.max_bin, split_batch=self.split_batch,
                owner_shard=cfg.dp_owner_shard, row_offset=self.row_offset)
        if self.dist == "voting":
            from ..parallel.voting_parallel import make_voting_grower
            return make_voting_grower(
                self.mesh, num_features=self.num_features,
                params=self.split_params, top_k=cfg.top_k,
                row_offset=self.row_offset)
        from ..parallel.feature_parallel import make_fp_grower
        return make_fp_grower(self.mesh, self.binned_dev,
                              num_features=self.num_features,
                              split_batch=self.split_batch)

    def _bagging_w(self, it: int) -> torch.Tensor:
        """The [N] f32 in-bag mask of iteration ``it`` (the JAX package's
        ``_bagging_w``: keyed by the refresh epoch ``(it // bagging_freq)
        * bagging_freq``), in plain PyTorch.  Training draws it inside the
        iteration through kernel B6 (``models/fused.py``)."""
        return bag_mask_plain(self.num_data, it, device=self.device,
                              **self.bagging_args())

    def _boost_score(self, class_id: int) -> float:
        """BoostFromScore with the reference's multi-machine semantics
        (the JAX package's ``_boost_from_score``, :1155-1185): under a
        row-sharded learner the initial score comes from the GLOBAL label
        and weight statistics (every rank's rows gathered, a fresh
        objective initialised on them), not this rank's."""
        if self.dist not in ("data", "voting"):
            return self.objective.boost_from_score(class_id)
        from ..dataset import Metadata
        md_local = self.train_set.metadata
        parts = self.mesh.all_gather_object(
            (np.asarray(md_local.label, np.float32),
             None if md_local.weight is None
             else np.asarray(md_local.weight, np.float32)))
        md = Metadata(sum(len(lab) for lab, _ in parts))
        md.label = np.concatenate([lab for lab, _ in parts])
        if md_local.weight is not None:
            md.weight = np.concatenate([w for _, w in parts])
        gobj = type(self.objective)(self.config)
        gobj.init(md, md.num_data, torch.device("cpu"))
        return gobj.boost_from_score(class_id)

    def goss_args(self) -> dict:
        """Keyword arguments of ``ops.random.goss_vals`` for this model."""
        cfg = self.config
        return dict(seed=cfg.bagging_seed, top_rate=cfg.top_rate,
                    other_rate=cfg.other_rate)

    def _feature_mask(self) -> np.ndarray:
        """The next feature_fraction mask of the host stream (the JAX
        package's ``_feature_mask``, :1395): ones without a draw when the
        fraction is 1."""
        frac = self.config.feature_fraction
        f = self.num_features
        if frac >= 1.0:
            return np.ones(f, bool)
        k = max(1, int(round(f * frac)))
        idx = self._rng_feat.choice(f, size=k, replace=False)
        mask = np.zeros(f, bool)
        mask[idx] = True
        return mask

    def _feature_masks(self, k: int) -> np.ndarray:
        """The [k, F] masks of a fused epoch of k iterations, drawn up
        front as the JAX package's fused paths draw them (:1720-1724,
        :2358-2362), whether or not the epoch ends early."""
        if self.config.feature_fraction < 1.0:
            return np.stack([self._feature_mask() for _ in range(k)])
        return np.ones((k, self.num_features), bool)

    # -- plumbing ----------------------------------------------------------
    def _valid_binned(self, valid: Dataset):
        """The valid set's rows on the device: its own k-hot rows when it
        chose sparse binned storage (the JAX package's :1239-1240), else
        in the train matrix's dense layout, bundled by the train set's EFB
        groups (its own matrix when a ``reference=`` set shares them, as
        the JAX package reads ``valid.binned``, :1242), else per feature
        (also for a sparse train set)."""
        if valid.binned_sparse is not None:
            return valid.binned_sparse.to_device(self.device)
        efb = self.train_set.efb if self.efb_dev is not None else None
        if efb is None:
            vb = valid.feature_binned()
        elif valid.efb is efb:
            vb = valid.binned
        else:
            flat = valid.feature_binned()
            vb = bin_grouped(lambda j: flat[:, j].astype(np.int64), efb,
                             valid.num_data)
        if vb.dtype != np.uint8:
            raise NotImplementedError(
                "valid sets with more than 256 bins per feature or per EFB "
                "bundle are not ported to lightgbm_torch yet (ROADMAP "
                "A9.5)")
        return torch.as_tensor(np.ascontiguousarray(vb)).to(self.device)

    def add_valid_set(self, valid: Dataset) -> None:
        valid.construct(self.config)
        nv = valid.num_data
        binned = self._valid_binned(valid)
        init = _init_scores(valid.metadata.init_score, nv, self.num_class)
        # the trees' replay, without the BoostFromAverage bias, tree t
        # into class column t % K, as the JAX package's add_valid_set (its
        # models/gbdt.py:1235-1290)
        score = torch.tensor(init, device=self.device)
        for ti, dt in enumerate(self.device_trees):
            _apply_tree(score, binned, dt, self.na_bin_dev,
                        self.tree_weights[ti], ti % self.num_class,
                        self.efb_maps)
        self.valid_sets.append((valid, binned, score))
        # captured programs hold the old list of valid sets
        self._programs.clear()
        self.es_state = None

    def valid_ops(self, vi: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device (label, weight) of valid set ``vi`` for the traced
        metrics (weight 1 where the set has none)."""
        ops = self._valid_ops.get(vi)
        if ops is None:
            md = self.valid_sets[vi][0].metadata
            label = np.asarray(md.label, np.float32).reshape(-1)
            if self.num_class > 1:
                check_class_labels(label, self.num_class)
            weight = (np.ones_like(label) if md.weight is None else
                      np.asarray(md.weight, np.float32).reshape(-1))
            ops = (torch.tensor(label, device=self.device),
                   torch.tensor(weight, device=self.device))
            self._valid_ops[vi] = ops
        return ops

    def _fetch(self, t: torch.Tensor, site: str) -> np.ndarray:
        """The one host fetch of training (the JAX package's ``_eget``):
        copies ``t`` to the host and counts the fetch under ``site``."""
        self.fetch_counts[site] = self.fetch_counts.get(site, 0) + 1
        return t.cpu().numpy()

    @property
    def it_global(self) -> int:
        """The 0-based number of the iteration in flight, counted from
        the first iteration of the run it continues (the keys' offset)."""
        return self.iter_ + self._iter_rng_offset

    @property
    def fetches(self) -> int:
        """Host fetches of training so far, over all sites."""
        return sum(self.fetch_counts.values())

    def _mark(self, phase: str) -> None:
        if self.phase_timer is not None:
            self.phase_timer.mark(phase)

    def shrink(self, leaf_value: torch.Tensor) -> torch.Tensor:
        """Leaf values times the learning rate, on the device.  f32, as
        the JAX package shrinks on every configuration its fused path
        accepts; a configuration it never fuses (a custom objective,
        multiclass) shrinks in f64 and rounds once to f32, as the JAX
        package's host does."""
        if self._fusable_config():
            return leaf_value * self._lr32
        return (leaf_value.double() * self.learning_rate).float()

    def renew_leaves(self, arrays) -> torch.Tensor:
        """RenewTreeOutput (the JAX package's ``train_one_iter``
        :2806-2814), for an objective that renews (l1, quantile, mape):
        fetch the tree's leaf values, its rows' leaves and the score before
        the tree, renew the values on the host, shrink them in f64 (such a
        configuration never fuses), keep them for the host tree and return
        them as the f32 device vector the score update and the valid walks
        add.  A stump keeps its values (they are zeroed later)."""
        lv = self._fetch(arrays.leaf_value, "renew").astype(np.float64)
        nl = int(self._fetch(arrays.num_leaves, "renew")[0])
        if nl > 1:
            score = self._fetch(self.score, "renew")
            lor = self._fetch(arrays.leaf_of_row, "renew")
            lv[:nl] = self.objective.renew_leaf_values(score, lor, nl,
                                                       lv[:nl].copy())
        lv *= self.learning_rate
        self._renewed_lv = lv
        return torch.tensor(lv.astype(np.float32), device=self.device)

    def _program(self, eval_spec: Tuple = (), es_spec=None,
                 rows: int = 1) -> IterationProgram:
        key = (tuple(eval_spec), repr(es_spec))
        prog = self._programs.get(key)
        # a program captures the workspace's row block (the JAX package's
        # fused cache key, :1932): another row block is another capture
        if prog is None \
                or prog.rows_per_block != self.grow_ws.rows_per_block:
            prog = self._programs[key] = IterationProgram(
                self, eval_spec, es_spec, rows)
        return prog

    def _boost_from_average(self) -> List[float]:
        """BoostFromAverage (gbdt.cpp:346): before the first gradients,
        add each class's init score to its column of the train and every
        valid scorer, in place; class k's first saved tree gets it as a
        bias (AddBias, gbdt.cpp:416-418).  Returns the K biases of this
        iteration's trees."""
        cfg = self.config
        K = self.num_class
        if not (self.iter_ == 0 and self.objective is not None
                and cfg.boost_from_average and not self._init_applied):
            return [0.0] * K
        init = [self._boost_score(k) for k in range(K)]
        if any(v != 0.0 for v in init):
            bias = torch.tensor(init if K > 1 else init[0],
                                dtype=torch.float32, device=self.device)
            self.score += bias
            for _, _, vscore in self.valid_sets:
                vscore += bias
        return init

    # -- the fused path's eligibility ----------------------------------------
    def _fusable_config(self) -> bool:
        """Whether this configuration has fused-path semantics (whether or
        not fusion is on); it also selects the f32 shrinkage on every
        path, so that toggling ``fused_chunk`` never changes the model."""
        return self._fusable

    def supports_fused(self) -> bool:
        """True when whole iterations can run as graph replays: a fusable
        configuration, ``fused_chunk`` > 1, and none of the host-driven
        work of ``_host_driven`` (path choice only: the numerics stay
        ``_fusable_config``'s, so checked or injected runs train the same
        trees as clean ones)."""
        return self.config.fused_chunk > 1 and self._fusable_config() \
            and not self._host_driven()

    @staticmethod
    def _faults_active() -> bool:
        return faultinject.enabled()

    def _host_driven(self) -> List[str]:
        """The JAX package's blockers of the fused paths that are not the
        configuration's semantics (its :1518-1526): armed fault injection
        and the integrity layer; and a distributed learner (its
        :1507-1510), whose trees the port shrinks in f32 as a serial run's,
        so that a data-parallel quantized model equals the serial one."""
        reasons = []
        if self.dist is not None:
            reasons.append(
                f"tree_learner={self.dist}: distributed growers "
                "re-materialize tree arrays per iteration")
        if self._faults_active():
            reasons.append(
                "fault injection active: host-side injection sites "
                "cannot fire inside a fused device program")
        if self._integrity is not None:
            reasons.append(
                "integrity_check_freq > 0: the computation-integrity "
                "layer's shadow compares and transient re-runs are "
                "host-driven (docs/Fault-Tolerance.md layer 7)")
        return reasons

    def _config_blockers(self) -> List[str]:
        """Why this configuration has no fused-path semantics: every
        parameter value the port refuses, and the JAX package's blockers
        that the port can meet."""
        reasons = [f"{what} is not ported to lightgbm_torch yet (ROADMAP "
                   f"{item})" for what, item in _unported(self.config,
                                                          self.train_set)]
        if self.objective is None:
            reasons.append("custom objective (fobj): gradients arrive from "
                           "the host every iteration")
        else:
            if self.objective.need_renew_tree_output:
                reasons.append(f"objective={self.objective.name} renews "
                               "leaf outputs host-side (RenewTreeOutput)")
            if self.objective.host_state_per_iter:
                reasons.append(f"objective={self.objective.name} mutates "
                               "host state every iteration")
        if self.num_class != 1:
            reasons.append(f"num_class={self.num_class}: multiclass grows "
                           "one tree per class per iteration through the "
                           "host loop")
        if self.partitioned is not None:
            reasons.append(f"tpu_learner={self.learner}: only the "
                           "one-program masked grower runs inside a fused "
                           "scan")
        if self.forced is not None:
            reasons.append("forced_splits need host node bookkeeping")
        return reasons

    def fused_reasons(self) -> List[str]:
        """Every reason ``supports_fused()`` is False, empty when the fused
        path is eligible."""
        reasons = self._config_blockers()
        if self.config.fused_chunk <= 1:
            reasons.append(f"fused_chunk={self.config.fused_chunk} (set > 1 "
                           "to enable fusion)")
        return reasons + self._host_driven()

    def _require_fusable(self, what: str) -> None:
        reasons = self._config_blockers() + self._host_driven()
        if reasons:
            raise ValueError(f"{what}: config not fusable: "
                             + "; ".join(reasons))

    # -- training ----------------------------------------------------------
    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (gbdt.cpp:371 TrainOneIter), with one
        host fetch of its tree (of its K trees, multiclass).  Returns True
        if training should stop (no split was possible; for multiclass,
        in none of the K trees).  Custom gradients of a multiclass model
        are N * K values, reshaped (N, K) row-major."""
        dev = self.device
        start_iter = self.iter_
        init0 = self._boost_from_average()
        gh = None
        if grad is not None:
            shape = (-1,) if self.num_class == 1 else (self.num_data,
                                                      self.num_class)
            gh = tuple(torch.as_tensor(np.ascontiguousarray(
                np.asarray(a, np.float32).reshape(shape))).to(dev)
                for a in (grad, hess))
        elif self.objective is None:
            raise ValueError("a custom objective needs grad and hess")
        prog = self._program()
        block = prog.run(1, eager=True, gh=gh, mark=self._mark,
                         fmasks=self._feature_mask()[None],
                         it0=start_iter + self._iter_rng_offset)
        host = self._fetch(block, "tree")
        out = self._se_ingest(prog, host, block.clone(), 1, start_iter,
                              init0)
        return out["stump"]

    def train_chunk(self, k: int) -> bool:
        """Run ``k`` iterations as graph replays with one host fetch of
        the k tree records (the JAX package's ``train_chunk``; no valid
        sets).  Returns True when a no-split iteration occurred."""
        if self.valid_sets:
            raise ValueError(
                "train_chunk requires no validation sets: per-iteration "
                "eval/early-stop runs go through train_superepoch")
        self._require_fusable("train_chunk")
        return self._epoch(k, 0, (), None)["stump"]

    def train_superepoch(self, k: int, es_it0: int, eval_spec=(),
                         es_spec=None) -> dict:
        """Run ``k`` full iterations — grow, score update, valid walks,
        traced metrics and the early-stop vote — as graph replays, with
        exactly one host fetch (trees, eval block, stop flags).
        ``engine.train`` replays the block through the real callbacks.
        ``es_it0``: the ``env.iteration`` of the epoch's first row.
        Returns ``{"evals": f32 [done, E], "done", "stump",
        "stop_row"}``."""
        self._require_fusable("train_superepoch")
        return self._epoch(k, es_it0, tuple(eval_spec), es_spec)

    def _epoch(self, k: int, es_it0: int, eval_spec, es_spec) -> dict:
        start_iter = self.iter_
        init0 = self._se_begin(len(eval_spec), es_spec)
        prog = self._program(eval_spec, es_spec, k)
        fmasks, it0 = self._se_operands(k)
        cuda = self.device.type == "cuda"
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            t0 = time.perf_counter()
        block = prog.run(k, es_it0, eager=not cuda, fmasks=fmasks, it0=it0)
        if cuda:
            t1.record()
        # the one sync of the epoch (trees + eval block + stop flags)
        host = self._fetch(block, "epoch")
        self.epoch_ms.append(t0.elapsed_time(t1) if cuda else
                             (time.perf_counter() - t0) * 1e3)
        return self._se_ingest(prog, host, block.clone(), k, start_iter,
                               init0)

    def _se_begin(self, num_evals: int, es_spec) -> List[float]:
        """An epoch's prologue (the JAX package's ``_se_begin``): the
        boost-from-average bias on the first iteration (returned, one a
        class) and the traced early-stop state for ``num_evals`` eval
        entries, made on first use."""
        init0 = self._boost_from_average()
        if es_spec is not None and (self.es_state is None
                                    or self.es_state[0].shape[0]
                                    != num_evals):
            dev, E = self.device, num_evals
            self.es_state = (torch.zeros(E, dtype=torch.float32, device=dev),
                             torch.zeros(E, dtype=torch.int32, device=dev),
                             torch.zeros(E, dtype=torch.bool, device=dev),
                             torch.zeros((), dtype=torch.bool, device=dev))
        return init0

    def _se_operands(self, k: int) -> Tuple[np.ndarray, int]:
        """An epoch's operands (the JAX package's ``_se_operands``): the
        [k, F] feature masks drawn from this model's host stream, and the
        iteration ``it0`` that keys the epoch's first draws.  A fleet
        calls it member by member, in member order."""
        return self._feature_masks(k), self.iter_ + self._iter_rng_offset

    def _se_ingest(self, prog: IterationProgram, host: np.ndarray,
                   block: torch.Tensor, k: int, start_iter: int,
                   init0: List[float]) -> dict:
        """Host ``Tree`` and ``_DeviceTree`` of each fetched row (K rows,
        one a class, for each of the k iterations), up to and including
        the first iteration whose trees are all stumps or that the stop
        vote ends (the JAX package's ``_se_ingest``), from this model's
        rows ``host`` (numpy) and their device copy ``block``."""
        lr = self.learning_rate
        L = self.config.num_leaves
        K = self.num_class
        fusable = self._fusable_config()
        stopped, stop_row = False, None
        for j in range(k):
            stopped = True
            for c in range(K):
                r = j * K + c
                fields = prog.row_fields(host, r)
                tj = host_tree(host[r][:prog.W], L, self.max_bin,
                               cat_bins=self.grow_ws.cat_bins)
                nl = tj.num_leaves
                self.step_counts.append(tj.n_steps)
                if self.cegb is not None and nl > 1 \
                        and self.partitioned is None:
                    # the tree's split features into the cross-tree used
                    # set that the next tree or epoch starts from (the
                    # JAX package's :2762-2764, :2466-2468); the
                    # partitioned learner marks its best-first splits
                    # itself and never a forced one
                    self.cegb.used[np.asarray(tj.split_feature)[:nl - 1]] \
                        = True
                if fusable:
                    lvj = fields["lv"].astype(np.float64)
                elif self._renewed_lv is not None:
                    lvj, self._renewed_lv = self._renewed_lv, None
                else:
                    lvj = np.asarray(tj.leaf_value, np.float64) * lr
                if nl <= 1:
                    lvj = np.zeros_like(lvj)  # a stump contributes nothing
                else:
                    stopped = False
                ht = Tree.from_arrays(tj, self.train_set.used_features,
                                      self.train_set.bin_mappers)
                ht.internal_value = ht.internal_value * lr
                ht.shrinkage = lr
                bias = init0[c] if (start_iter == 0 and j == 0) else 0.0
                ht.leaf_value = lvj[:max(nl, 1)] + bias   # Tree::AddBias
                self.models.append(ht)
                dfields = prog.row_fields(block, r)
                dev_lv = dfields["lv"] if nl > 1 else \
                    torch.zeros_like(dfields["lv"])
                steps = round_up_pow2(max(ht.max_depth(), 1))
                self.device_trees.append(_DeviceTree(dfields, dev_lv,
                                                     steps))
                self.tree_weights.append(1.0)
            self.iter_ += 1
            stop = bool(prog.row_fields(host, j * K)["stop"])
            if stopped or stop:
                if stop:
                    stop_row = j
                break
        done = self.iter_ - start_iter
        evals = np.stack([prog.row_fields(host, j * K)["ev"]
                          for j in range(done)]) if done else \
            np.zeros((0, prog.E), np.float32)
        return {"evals": evals.reshape(done, prog.E), "done": done,
                "stump": stopped, "stop_row": stop_row}

    def share_from(self, other: "GBDTModel") -> None:
        """Point this model's shared operands at ``other``'s tensors, for
        fleet members built from one training Dataset and one set of valid
        Datasets (the JAX package's ``in_axes=None`` operands of
        ``build_fleet_superepoch``): the binned (or EFB-bundled) matrix,
        ``num_bin``, ``na_bin``, the categorical flags, the EFB maps, the
        bagging label mask, the objective's arrays, and each valid set's
        binned matrix, label and weight.  Raises ``ValueError`` if any
        differs in value."""
        def same(a, b, what):
            if a is None and b is None:
                return None
            if (a is None) != (b is None) or a.shape != b.shape \
                    or a.dtype != b.dtype or a.device != b.device \
                    or not torch.equal(a, b):
                raise ValueError(f"fleet members must share {what}")
            return b

        if isinstance(self.binned_dev, torch.Tensor) != isinstance(
                other.binned_dev, torch.Tensor):
            raise ValueError("fleet members must share one binned layout")
        self.binned_dev = same(self.binned_dev, other.binned_dev,
                               "the binned matrix")
        self.num_bin_dev = same(self.num_bin_dev, other.num_bin_dev,
                                "num_bin")
        self.na_bin_dev = same(self.na_bin_dev, other.na_bin_dev, "na_bin")
        self.is_cat_dev = same(self.is_cat_dev, other.is_cat_dev,
                               "the categorical features")
        self.feature_mask = same(self.feature_mask, other.feature_mask,
                                 "the feature set")
        self.bag_positive = same(self.bag_positive, other.bag_positive,
                                 "the bagging label mask")
        if (self.efb_dev is None) != (other.efb_dev is None):
            raise ValueError("fleet members must share the EFB bundles")
        if other.efb_dev is not None:
            for a, b in zip(self.efb_dev, other.efb_dev):
                if isinstance(a, torch.Tensor):
                    same(a, b, "the EFB maps")
                elif a != b:
                    raise ValueError("fleet members must share the EFB "
                                     "bundles")
            self.efb_dev, self.efb_maps = other.efb_dev, other.efb_maps
            self.grow_ws.efb = other.efb_dev
        if self.objective is not None and other.objective is not None:
            for name, t in vars(self.objective).items():
                ot = getattr(other.objective, name, None)
                if isinstance(t, torch.Tensor) and isinstance(
                        ot, torch.Tensor):
                    setattr(self.objective, name,
                            same(t, ot, f"the objective's {name}"))
        if len(self.valid_sets) != len(other.valid_sets):
            raise ValueError("fleet members must share the valid sets")
        for vi, ((ds, vb, vs), (_, ovb, _)) in enumerate(
                zip(self.valid_sets, other.valid_sets)):
            if not isinstance(vb, torch.Tensor):
                raise ValueError("fleet valid sets must be dense")
            self.valid_sets[vi] = (ds, same(vb, ovb, "the valid matrix"),
                                   vs)
            label, weight = self.valid_ops(vi)
            olabel, oweight = other.valid_ops(vi)
            self._valid_ops[vi] = (same(label, olabel, "the valid labels"),
                                   same(weight, oweight,
                                        "the valid weights"))
        self._programs.clear()

    def integrity_boundary_check(self) -> None:
        """Shadow-verify the newest committed tree right before a snapshot
        is written (the JAX package's :1073-1081; ROADMAP A12 calls it
        ahead of the snapshot write).  No-op when the integrity layer is
        off or the newest tree already passed a check; raises
        ``IntegrityFailure`` on a sticky boundary mismatch."""
        if self._integrity is not None:
            self._integrity.boundary_check(self)

    def integrity_manifest(self, iteration: int):
        """The snapshot manifest's ``integrity`` stamp dict, or None when
        the integrity layer is off (the JAX package's :1083-1089)."""
        if self._integrity is None:
            return None
        return self._integrity.manifest(iteration)

    def eval_traced(self, eval_spec) -> np.ndarray:
        """Every entry of ``eval_spec`` by the traced metric kernels on
        the current valid scores, in one host fetch (the ``fused_eval=
        true`` per-iteration path; the same kernels as the fused
        epochs)."""
        prog = self._program(eval_spec)
        ev = prog.teval([vs for _, _, vs in self.valid_sets],
                        [self.valid_ops(vi)
                         for vi in range(len(self.valid_sets))])
        return self._fetch(ev, "traced_eval")

    def drop_iterations(self, n: int) -> None:
        """Take back the last ``n`` iterations (super-epoch replay
        healing, when the host callbacks stop before the traced vote): the
        n * K trees go, and each one's contribution is subtracted from its
        class column of every score by a tree walk with weight -1
        (add-then-subtract is not bit exact, but nothing trains on the
        healed score)."""
        n = int(n)
        if n <= 0:
            return
        K = self.num_class
        nt = n * K
        first = len(self.device_trees) - nt
        for ti, dt in enumerate(self.device_trees[first:], first):
            _apply_tree(self.score, self.binned_dev, dt, self.na_bin_dev,
                        -1.0, ti % K, self.efb_maps)
            for _, vb, vs in self.valid_sets:
                _apply_tree(vs, vb, dt, self.na_bin_dev, -1.0, ti % K,
                            self.efb_maps)
        del self.models[-nt:]
        del self.device_trees[-nt:]
        del self.tree_weights[-nt:]
        del self.step_counts[-nt:]
        self.iter_ -= n
        if self.on_change is not None:
            self.on_change()

    def clear_es_stop(self) -> None:
        """Reset the traced early-stop vote's stop latch (the vote tripped
        but the host replay did not: trust the host, keep training)."""
        if self.es_state is not None:
            self.es_state[3].zero_()

    # -- scores ------------------------------------------------------------
    @property
    def num_iterations_trained(self) -> int:
        return self.iter_

    def train_score(self) -> np.ndarray:
        """The train scores on the host: [N], or [N, K] for multiclass."""
        return self._fetch(self.score, "train_score")

    def valid_score(self, i: int) -> np.ndarray:
        return self._fetch(self.valid_sets[i][2], "valid_score")


def create_boosting(config: Config, train_set: Dataset,
                    objective) -> GBDTModel:
    """Boosting factory (boosting.cpp:35-68 CreateBoosting analog)."""
    if config.boosting in ("gbdt", "gbrt"):
        return GBDTModel(config, train_set, objective)
    raise NotImplementedError(
        f"boosting={config.boosting} is not ported to lightgbm_torch yet "
        "(ROADMAP A9)")
