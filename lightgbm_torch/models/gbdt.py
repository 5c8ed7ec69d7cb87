"""GBDT boosting loop.

Counterpart of the JAX package's ``models/gbdt.py`` ``GBDTModel`` for the
slice this port runs: the masked (one tree per iteration, strict
leaf-wise) learner on one device.  One iteration (gbdt.cpp:371
``TrainOneIter``) is: BoostFromAverage on the first iteration ->
gradients (B5) -> one tree from the device-resident grower (B1-B3s) ->
f32 shrinkage -> train score += leaf value gathered through the grower's
row -> leaf vector -> every valid score += tree walk (B4).  The iteration
is ``models/fused.py``'s ``IterationProgram.body``, and three paths run
it, as in the JAX package:

- ``train_one_iter``, the per-iteration path: the body once, then one
  host fetch of the tree;
- ``train_chunk``, fused chunks (no valid set): k iterations as k
  replays of the body's CUDA graph, one fetch per chunk;
- ``train_superepoch``: k iterations with the valid walks, the traced
  metrics (B12) and the early-stop vote in the graph, one fetch per
  epoch.

The three give the same trees.  The reported metric values are not the
same: the fused paths (and ``fused_eval=true`` per-iteration runs) report
the traced f32 metrics, the per-iteration path by default the host f64
metrics (``metrics.py``), as the JAX package does.  Every training fetch
goes through ``_fetch``, which counts it by site.  Trees are kept on the
host (``Tree``) for the model text and on the device (``_DeviceTree``,
views of the fetched block's device copy) for later tree walks.

Parameter values that need modules the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item (``_refuse_unported``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..basic import LightGBMError
from ..binning import BinType
from ..config import Config
from ..dataset import Dataset
from ..grower import GrowWorkspace, host_tree
from ..objectives import ObjectiveFunction
from ..ops.split import SplitParams
from ..predict_device import add_tree_score
from ..tree_model import Tree
from ..utils.shapes import round_up_pow2, traversal_steps
from .fused import IterationProgram


def resolve_device(config: Config) -> torch.device:
    """The training device: the CUDA card unless ``device_type=cpu``.
    With ``device_type=cuda`` and no card this raises; it never carries on
    on the CPU."""
    if config.device_type == "cpu":
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
        (c.num_model_per_iteration > 1, "multiclass objectives", "A9"),
        (c.tree_learner != "serial" or c.num_machines > 1,
         "distributed training (tree_learner/num_machines)", "A16"),
        (c.bagging_freq > 0, "bagging", "A9 (B6)"),
        (c.data_sample_strategy == "goss", "GOSS", "A9 (B6)"),
        (c.feature_fraction < 1.0, "feature_fraction < 1", "A9"),
        (c.feature_fraction_bynode < 1.0, "feature_fraction_bynode < 1",
         "A9 (B6)"),
        (c.extra_trees, "extra_trees", "A9 (B6)"),
        (bool(c.monotone_constraints) and any(c.monotone_constraints),
         "monotone constraints", "A9"),
        (bool(c.interaction_constraints), "interaction constraints", "A9"),
        (c.cegb_penalty_split > 0 or bool(c.cegb_penalty_feature_coupled)
         or bool(c.cegb_penalty_feature_lazy), "CEGB", "A9"),
        (bool(c.feature_contri), "feature_contri", "A9"),
        (bool(c.forcedsplits_filename), "forced splits", "A11"),
        (c.linear_tree, "linear_tree", "A9"),
        (c.quant_train, "quantized training", "A10 (B7)"),
        (c.tpu_learner == "partitioned", "tpu_learner=partitioned",
         "A11 (B11)"),
        (c.split_batch > 1 or (c.split_batch < 1 and c.num_leaves >= 64),
         "split_batch > 1 (num_leaves >= 64 selects it automatically)",
         "A8"),
        (c.snapshot_freq > 0 or c.resume, "snapshots and resume", "A12"),
        (c.integrity_check_freq > 0, "integrity checks", "A17 (B17)"),
        (c.finite_check_freq > 0, "finite checks", "A12"),
        (c.telemetry or c.telemetry_blackbox, "telemetry", "A15"),
        (c.hist_tune == "on", "hist_tune", "A17 (B15)"),
        (ds.efb is not None, "EFB feature bundling (pass enable_bundle=false)",
         "A9 (B9)"),
        (ds.binned is None or ds.binned.dtype != np.uint8,
         "more than 256 bins per feature", "A9"),
        (any(ds.bin_mappers[f].bin_type == BinType.CATEGORICAL
             for f in ds.used_features), "categorical features", "A9"),
    ]
    return [(what, item) for hit, what, item in checks if hit]


def _refuse_unported(config: Config, ds: Dataset) -> None:
    """NotImplementedError for the first parameter value whose module the
    port does not have yet, naming the ROADMAP item that ports it."""
    for what, item in _unported(config, ds):
        raise NotImplementedError(
            f"{what} is not ported to lightgbm_torch yet (ROADMAP {item})")


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


class _DeviceTree:
    """A tree's node tables and shrunk leaf values on the device (views
    of a fetched block's device copy), for B4."""

    __slots__ = ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "leaf_value", "steps")

    def __init__(self, fields: Dict[str, torch.Tensor],
                 leaf_value: torch.Tensor, steps: int):
        for name in ("split_feature", "threshold_bin", "default_left",
                     "left_child", "right_child"):
            setattr(self, name, fields[name])
        self.leaf_value = leaf_value
        self.steps = steps


def _apply_tree(score: torch.Tensor, binned: torch.Tensor, dt: _DeviceTree,
                na_bin: torch.Tensor, weight: float) -> torch.Tensor:
    """score += weight * tree(binned), in place (kernel B4)."""
    return add_tree_score(score, binned, dt.split_feature, dt.threshold_bin,
                          dt.default_left, dt.left_child, dt.right_child,
                          na_bin, dt.leaf_value, weight, steps=dt.steps)


class GBDTModel:
    """Boosting state machine (boosting.h:27-319 interface analog)."""

    def __init__(self, config: Config, train_set: Dataset,
                 objective: Optional[ObjectiveFunction]):
        self.config = config
        self.train_set = train_set.construct(config)
        self.objective = objective
        self.learning_rate = config.learning_rate
        self.iter_ = 0
        ds = self.train_set
        self.num_data = ds.num_data
        self.num_features = ds.num_features
        if self.num_features == 0:
            raise ValueError("Dataset has no usable (non-trivial) features")
        _refuse_unported(config, ds)
        self.device = resolve_device(config)

        self.split_params = SplitParams(
            lambda_l1=config.lambda_l1,
            lambda_l2=config.lambda_l2,
            min_data_in_leaf=config.min_data_in_leaf,
            min_sum_hessian_in_leaf=config.min_sum_hessian_in_leaf,
            min_gain_to_split=config.min_gain_to_split,
            max_delta_step=config.max_delta_step,
            path_smooth=config.path_smooth,
        )
        num_bin = np.asarray([ds.bin_mappers[f].num_bin
                              for f in ds.used_features], np.int32)
        na_bin = np.asarray([ds.bin_mappers[f].na_bin
                             for f in ds.used_features], np.int32)
        self.max_bin = int(num_bin.max())
        dev = self.device
        self.num_bin_dev = torch.as_tensor(num_bin).to(dev)
        self.na_bin_dev = torch.as_tensor(na_bin).to(dev)
        self.feature_mask = torch.ones(self.num_features, dtype=torch.bool,
                                       device=dev)
        self.binned_dev = torch.as_tensor(
            np.ascontiguousarray(ds.binned)).to(dev)
        self.grow_ws = GrowWorkspace(self.num_data, self.num_features,
                                     self.max_bin, config.num_leaves, dev)
        # the valid walk's level count: the configuration's worst case, on
        # every path (a row stops at its leaf, so the result is the same)
        self.walk_steps = traversal_steps(config.max_depth,
                                          config.num_leaves)
        self._lr32 = torch.tensor(np.float32(self.learning_rate),
                                  device=dev)

        if self.objective is not None:
            self.objective.init(ds.metadata, self.num_data, dev)

        init = np.zeros(self.num_data, np.float32)
        if ds.metadata.init_score is not None:
            init += np.asarray(ds.metadata.init_score,
                               np.float32).reshape(-1)
        self.score = torch.as_tensor(init).to(dev)
        self._init_applied = ds.metadata.init_score is not None
        self._init_scores = [0.0]

        # validation sets: (dataset, device binned, device score)
        self.valid_sets: List[Tuple[Dataset, torch.Tensor,
                                    torch.Tensor]] = []
        self._valid_ops: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.models: List[Tree] = []
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
        self._fusable = not self._config_blockers()

    # -- plumbing ----------------------------------------------------------
    def add_valid_set(self, valid: Dataset) -> None:
        valid.construct(self.config)
        if valid.binned is None or valid.binned.dtype != np.uint8 \
                or valid.efb is not None:
            raise NotImplementedError(
                "valid sets need dense uint8 bins in lightgbm_torch "
                "(ROADMAP A9/A11)")
        nv = valid.num_data
        binned = torch.as_tensor(np.ascontiguousarray(valid.binned)
                                 ).to(self.device)
        init = np.zeros(nv, np.float32)
        if valid.metadata.init_score is not None:
            init += np.asarray(valid.metadata.init_score,
                               np.float32).reshape(-1)
        score = torch.as_tensor(init).to(self.device)
        if self.iter_ > 0 and self._init_scores[0] != 0.0:
            # the BoostFromAverage bias was added to every scorer at the
            # first iteration; device trees carry unbiased values
            score += torch.tensor(self._init_scores[0], dtype=torch.float32,
                                  device=self.device)
        for ti, dt in enumerate(self.device_trees):
            _apply_tree(score, binned, dt, self.na_bin_dev,
                        self.tree_weights[ti])
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
            weight = (np.ones_like(label) if md.weight is None else
                      np.asarray(md.weight, np.float32).reshape(-1))
            ops = (torch.as_tensor(label).to(self.device),
                   torch.as_tensor(weight).to(self.device))
            self._valid_ops[vi] = ops
        return ops

    def _fetch(self, t: torch.Tensor, site: str) -> np.ndarray:
        """The one host fetch of training (the JAX package's ``_eget``):
        copies ``t`` to the host and counts the fetch under ``site``."""
        self.fetch_counts[site] = self.fetch_counts.get(site, 0) + 1
        return t.cpu().numpy()

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
        accepts; a custom objective (not fusable) shrinks in f64 and
        rounds once to f32, as the JAX package's host does."""
        if self._fusable_config():
            return leaf_value * self._lr32
        return (leaf_value.double() * self.learning_rate).float()

    def _program(self, eval_spec: Tuple = (), es_spec=None,
                 rows: int = 1) -> IterationProgram:
        key = (tuple(eval_spec), repr(es_spec))
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = IterationProgram(
                self, eval_spec, es_spec, rows)
        return prog

    def _boost_from_average(self) -> float:
        """BoostFromAverage (gbdt.cpp:346): before the first gradients,
        add the init score to the train and every valid scorer, in place;
        the first saved tree gets it as a bias (AddBias, gbdt.cpp:416-418).
        Returns the bias of this iteration's tree."""
        cfg = self.config
        if not (self.iter_ == 0 and self.objective is not None
                and cfg.boost_from_average and not self._init_applied):
            return 0.0
        init = self.objective.boost_from_score(0)
        self._init_scores = [init]
        if init != 0.0:
            bias = torch.tensor(init, dtype=torch.float32,
                                device=self.device)
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
        """True when whole iterations can run as graph replays."""
        return self.config.fused_chunk > 1 and self._fusable_config()

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
        elif self.objective.need_renew_tree_output:
            reasons.append(f"objective={self.objective.name} renews leaf "
                           "outputs host-side (RenewTreeOutput)")
        return reasons

    def fused_reasons(self) -> List[str]:
        """Every reason ``supports_fused()`` is False, empty when the fused
        path is eligible."""
        reasons = self._config_blockers()
        if self.config.fused_chunk <= 1:
            reasons.append(f"fused_chunk={self.config.fused_chunk} (set > 1 "
                           "to enable fusion)")
        return reasons

    def _require_fusable(self, what: str) -> None:
        if not self._fusable_config():
            raise ValueError(f"{what}: config not fusable: "
                             + "; ".join(self._config_blockers()))

    # -- training ----------------------------------------------------------
    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (gbdt.cpp:371 TrainOneIter), with one
        host fetch of the tree.  Returns True if training should stop (no
        split was possible)."""
        dev = self.device
        start_iter = self.iter_
        init0 = self._boost_from_average()
        gh = None
        if grad is not None:
            gh = (torch.as_tensor(np.asarray(grad, np.float32).reshape(-1)
                                  ).to(dev),
                  torch.as_tensor(np.asarray(hess, np.float32).reshape(-1)
                                  ).to(dev))
        elif self.objective is None:
            raise ValueError("a custom objective needs grad and hess")
        prog = self._program()
        block = prog.run(1, eager=True, gh=gh, mark=self._mark)
        host = self._fetch(block, "tree")
        out = self._ingest(prog, host, block.clone(), 1, start_iter, init0)
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
        init0 = self._boost_from_average()
        E = len(eval_spec)
        if es_spec is not None and (self.es_state is None
                                    or self.es_state[0].shape[0] != E):
            dev = self.device
            self.es_state = (torch.zeros(E, dtype=torch.float32, device=dev),
                            torch.zeros(E, dtype=torch.int32, device=dev),
                            torch.zeros(E, dtype=torch.bool, device=dev),
                            torch.zeros((), dtype=torch.bool, device=dev))
        prog = self._program(eval_spec, es_spec, k)
        cuda = self.device.type == "cuda"
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            t0 = time.perf_counter()
        block = prog.run(k, es_it0, eager=not cuda)
        if cuda:
            t1.record()
        # the one sync of the epoch (trees + eval block + stop flags)
        host = self._fetch(block, "epoch")
        self.epoch_ms.append(t0.elapsed_time(t1) if cuda else
                             (time.perf_counter() - t0) * 1e3)
        return self._ingest(prog, host, block.clone(), k, start_iter, init0)

    def _ingest(self, prog: IterationProgram, host: np.ndarray,
                block: torch.Tensor, k: int, start_iter: int,
                init0: float) -> dict:
        """Host ``Tree`` and ``_DeviceTree`` of each fetched row, up to and
        including the first stump or stop row (the JAX package's
        ``_se_ingest``)."""
        lr = self.learning_rate
        L = self.config.num_leaves
        fusable = self._fusable_config()
        stopped, stop_row = False, None
        for j in range(k):
            fields = prog.row_fields(host, j)
            tj = host_tree(host[j][:prog.W], L, self.max_bin)
            nl = tj.num_leaves
            self.step_counts.append(tj.n_steps)
            if fusable:
                lvj = fields["lv"].astype(np.float64)
            else:
                lvj = np.asarray(tj.leaf_value, np.float64) * lr
            if nl <= 1:
                stopped = True
                lvj = np.zeros_like(lvj)  # a stump contributes nothing
            ht = Tree.from_arrays(tj, self.train_set.used_features,
                                  self.train_set.bin_mappers)
            ht.internal_value = ht.internal_value * lr
            ht.shrinkage = lr
            bias = init0 if (start_iter == 0 and j == 0) else 0.0
            ht.leaf_value = lvj[:max(nl, 1)] + bias   # Tree::AddBias
            self.models.append(ht)
            dfields = prog.row_fields(block, j)
            dev_lv = dfields["lv"] if nl > 1 else \
                torch.zeros_like(dfields["lv"])
            steps = round_up_pow2(max(ht.max_depth(), 1))
            self.device_trees.append(_DeviceTree(dfields, dev_lv, steps))
            self.tree_weights.append(1.0)
            self.iter_ += 1
            stop = bool(fields["stop"])
            if stopped or stop:
                if stop:
                    stop_row = j
                break
        done = self.iter_ - start_iter
        evals = np.stack([prog.row_fields(host, j)["ev"]
                          for j in range(done)]) if done else \
            np.zeros((0, prog.E), np.float32)
        return {"evals": evals.reshape(done, prog.E), "done": done,
                "stump": stopped, "stop_row": stop_row}

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
        trees go, and each one's contribution is subtracted from every
        score by a tree walk with weight -1 (add-then-subtract is not bit
        exact, but nothing trains on the healed score)."""
        n = int(n)
        if n <= 0:
            return
        for dt in self.device_trees[-n:]:
            _apply_tree(self.score, self.binned_dev, dt, self.na_bin_dev,
                        -1.0)
            for _, vb, vs in self.valid_sets:
                _apply_tree(vs, vb, dt, self.na_bin_dev, -1.0)
        del self.models[-n:]
        del self.device_trees[-n:]
        del self.tree_weights[-n:]
        del self.step_counts[-n:]
        self.iter_ -= n

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
