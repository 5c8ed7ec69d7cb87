"""GBDT boosting loop.

Counterpart of the JAX package's ``models/gbdt.py`` ``GBDTModel`` for the
slice this port runs: the masked (one tree per iteration, strict
leaf-wise) learner on one device.  One iteration (gbdt.cpp:371
``TrainOneIter``) is: BoostFromAverage on the first iteration ->
gradients (B5) -> one tree from the grower (B1-B3) -> f32 shrinkage ->
train score += leaf value gathered through the grower's row -> leaf
vector -> every valid score += tree walk (B4).  Trees are kept on the
host (``Tree``) for the model text and a device copy of each
(``_DeviceTree``) for the valid-set walk.

Parameter values that need modules the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item (``_refuse_unported``).
``fused_chunk`` and ``superepoch`` are accepted and run the per-iteration
loop, which the JAX package's own contract makes byte-identical to them;
the fused CUDA-graph loop is ROADMAP A13.
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
from ..grower import GrowStats, TreeArrays, grow_tree
from ..objectives import ObjectiveFunction
from ..ops.split import SplitParams
from ..predict_device import add_tree_score
from ..tree_model import Tree
from ..utils.shapes import round_up_pow2


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


def _refuse_unported(config: Config, ds: Dataset) -> None:
    """NotImplementedError for every parameter value whose module the port
    does not have yet, naming the ROADMAP item that ports it."""
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
    for hit, what, item in checks:
        if hit:
            raise NotImplementedError(
                f"{what} is not ported to lightgbm_torch yet (ROADMAP {item})")


class PhaseTimer:
    """Per-phase time of the iteration loop.  On the card it records CUDA
    events on the stream (no synchronisation while training) and sums the
    spans between consecutive marks when read; on the CPU it reads the host
    clock.  Off unless a caller sets ``GBDTModel.phase_timer``."""

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
    """A tree's node tables and leaf values on the device, for B4."""

    __slots__ = ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "leaf_value", "steps")

    def __init__(self, arrays: TreeArrays, leaf_value: np.ndarray,
                 steps: int, device: torch.device):
        nodes = np.stack([arrays.split_feature, arrays.threshold_bin,
                          arrays.left_child, arrays.right_child]
                         ).astype(np.int32)
        nodes_dev = torch.as_tensor(nodes).to(device)
        self.split_feature, self.threshold_bin, self.left_child, \
            self.right_child = nodes_dev.unbind(0)
        self.default_left = torch.as_tensor(
            np.asarray(arrays.default_left, bool)).to(device)
        self.leaf_value = torch.as_tensor(
            np.asarray(leaf_value, np.float32)).to(device)
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
        self.na_bin_host = np.asarray([ds.bin_mappers[f].na_bin
                                       for f in ds.used_features], np.int32)
        self.max_bin = int(num_bin.max())
        dev = self.device
        self.num_bin_dev = torch.as_tensor(num_bin).to(dev)
        self.na_bin_dev = torch.as_tensor(self.na_bin_host).to(dev)
        self.feature_mask = torch.ones(self.num_features, dtype=torch.bool,
                                       device=dev)
        self.binned_dev = torch.as_tensor(
            np.ascontiguousarray(ds.binned)).to(dev)

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
        self.models: List[Tree] = []
        self.device_trees: List[_DeviceTree] = []
        self.tree_weights: List[float] = []
        self.step_counts: List[int] = []
        self.grow_stats = GrowStats()
        self.phase_timer: Optional[PhaseTimer] = None

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

    def _mark(self, phase: str) -> None:
        if self.phase_timer is not None:
            self.phase_timer.mark(phase)

    # -- training ----------------------------------------------------------
    def train_one_iter(self, grad: Optional[np.ndarray] = None,
                       hess: Optional[np.ndarray] = None) -> bool:
        """One boosting iteration (gbdt.cpp:371 TrainOneIter).
        Returns True if training should stop (no split was possible)."""
        cfg = self.config
        dev = self.device
        if self.iter_ == 0 and self.objective is not None \
                and cfg.boost_from_average and not self._init_applied:
            # BoostFromAverage (gbdt.cpp:346): add the init score to the
            # train and valid scorers before the first gradients; the saved
            # tree gets it as a bias (AddBias, gbdt.cpp:416-418)
            init = self.objective.boost_from_score(0)
            self._init_scores = [init]
            if init != 0.0:
                bias = torch.tensor(init, dtype=torch.float32, device=dev)
                self.score += bias
                for _, _, vscore in self.valid_sets:
                    vscore += bias
        init_score = self._init_scores[0] if self.iter_ == 0 else 0.0

        self._mark("gradients")
        if grad is None:
            g, h = self.objective.get_gradients(self.score)
        else:
            g = torch.as_tensor(np.asarray(grad, np.float32).reshape(-1)
                                ).to(dev)
            h = torch.as_tensor(np.asarray(hess, np.float32).reshape(-1)
                                ).to(dev)
        # (grad*w, hess*w, w) with w = 1: no bagging/GOSS in this slice
        vals = torch.stack([g, h, torch.ones_like(g)], dim=1)

        self._mark("grow")
        arrays = grow_tree(self.binned_dev, vals, self.feature_mask,
                           self.num_bin_dev, self.na_bin_dev,
                           num_leaves=cfg.num_leaves, num_bins=self.max_bin,
                           params=self.split_params,
                           max_depth=cfg.max_depth,
                           na_bin_host=self.na_bin_host,
                           stats=self.grow_stats)
        self._mark("score")
        nl = arrays.num_leaves
        self.step_counts.append(arrays.n_steps)
        leaf_values = np.asarray(arrays.leaf_value, np.float64).copy()
        stopped = nl <= 1
        if stopped:
            leaf_values[:] = 0.0  # a stump contributes nothing (gbdt.cpp)
        shrinkage = self.learning_rate
        if self.objective is not None:
            # f32 shrinkage, as the JAX package applies it on every
            # configuration its fused path accepts (an exact f64 product of
            # f32 operands rounded to f32 is the device's f32 multiply)
            leaf_values = (leaf_values * np.float64(np.float32(shrinkage))
                           ).astype(np.float32).astype(np.float64)
        else:
            leaf_values *= shrinkage
        ht = Tree.from_arrays(arrays, self.train_set.used_features,
                              self.train_set.bin_mappers)
        ht.internal_value = ht.internal_value * shrinkage
        ht.shrinkage = shrinkage
        # the scorers already carry the bias; the saved tree gets it
        ht.leaf_value = (leaf_values + init_score)[:max(nl, 1)].copy()

        lv_dev = torch.as_tensor(leaf_values.astype(np.float32)).to(dev)
        self.score += lv_dev.index_select(0, arrays.leaf_of_row)

        steps = round_up_pow2(max(ht.max_depth(), 1))
        dt = _DeviceTree(arrays, leaf_values, steps, dev)
        self._mark("valid")
        for _, vbinned, vscore in self.valid_sets:
            _apply_tree(vscore, vbinned, dt, self.na_bin_dev, 1.0)
        self._mark("")

        self.models.append(ht)
        self.device_trees.append(dt)
        self.tree_weights.append(1.0)
        self.iter_ += 1
        return stopped

    # -- scores ------------------------------------------------------------
    @property
    def num_iterations_trained(self) -> int:
        return self.iter_

    def train_score(self) -> np.ndarray:
        return self.score.cpu().numpy()

    def valid_score(self, i: int) -> np.ndarray:
        return self.valid_sets[i][2].cpu().numpy()


def create_boosting(config: Config, train_set: Dataset,
                    objective) -> GBDTModel:
    """Boosting factory (boosting.cpp:35-68 CreateBoosting analog)."""
    if config.boosting in ("gbdt", "gbrt"):
        return GBDTModel(config, train_set, objective)
    raise NotImplementedError(
        f"boosting={config.boosting} is not ported to lightgbm_torch yet "
        "(ROADMAP A9)")
