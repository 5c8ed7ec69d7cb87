"""Booster: the user-facing model handle.

Counterpart of the JAX package's ``booster.py`` for this slice: training
(``update`` per iteration, ``update_chunk`` and ``update_superepoch``
fused), evaluation (host metrics, or the traced ones with
``eval_valid_traced``), prediction by the host tree walk, and the
reference model text (``GBDT::SaveModelToString`` / ``LoadModelFromString``,
gbdt_model_text.cpp:311, 421), byte for byte the JAX package's format, so
models move between the two packages.  The bucketed device predictor
(B10, ``serve/engine.py``) is ROADMAP A14: ``predict_bucketed`` is false
here, and SHAP contributions (``pred_contrib``) come with it.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .basic import LightGBMError
from .config import Config
from .dataset import Dataset
from .metrics import Metric, create_metric
from .models.gbdt import create_boosting
from .objectives import create_objective
from .tree_model import Tree


def _objective_to_string(cfg: Config) -> str:
    o = cfg.objective
    if o == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if o in ("multiclass", "multiclassova"):
        return f"{o} num_class:{cfg.num_class}"
    if o == "lambdarank":
        return "lambdarank"
    if o == "quantile":
        return f"quantile alpha:{cfg.alpha:g}"
    if o == "huber":
        return f"huber alpha:{cfg.alpha:g}"
    if o == "fair":
        return f"fair fair_c:{cfg.fair_c:g}"
    if o == "tweedie":
        return f"tweedie tweedie_variance_power:{cfg.tweedie_variance_power:g}"
    return o


def _objective_from_string(s: str) -> Dict[str, Any]:
    toks = s.split()
    out: Dict[str, Any] = {"objective": toks[0]} if toks else {}
    for t in toks[1:]:
        if ":" in t:
            k, v = t.split(":", 1)
            out[k] = v
    return out


def _finalize_score(score: np.ndarray, k: int, objective, average_output,
                    t0: int, t1: int, raw_score: bool) -> np.ndarray:
    """RF averaging over the predicted range, then the objective's output
    conversion, which runs in f32 as the JAX package's does."""
    if average_output and t1 > t0:
        score /= (t1 - t0) // k
    if not raw_score and objective is not None:
        conv = objective.convert_output(torch.as_tensor(
            score if k > 1 else score[:, 0], dtype=torch.float32))
        return conv.numpy()
    return score if k > 1 else score[:, 0]


class _IntAndCall(int):
    """int that also answers the reference's METHOD spelling
    (``bst.current_iteration()``)."""

    def __call__(self) -> int:
        return int(self)


def _atomic_write(path: str, text: str) -> None:
    """Write ``text`` to ``path`` through a temporary file and
    ``os.replace``, so a crash never leaves a truncated model."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class Booster:
    """Training/prediction handle (basic.py:2548 / boosting.h:27 analog)."""

    def __init__(self, params: Optional[Dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._valid_names: List[str] = []
        self._train_metrics: List[Metric] = []
        self._valid_metrics: List[List[Metric]] = []
        self.trees: List[Tree] = []
        self.tree_weights: List[float] = []
        self.feature_names: List[str] = []
        self._model = None
        self.train_set = None
        self._num_class = 1
        self._num_tree_per_iteration = 1
        self._average_output = False
        self._max_feature_idx = 0
        self._unported_objective = None

        if model_file is not None:
            with open(model_file, encoding="utf-8") as f:
                self._load_model_string(f.read())
            return
        if model_str is not None:
            self._load_model_string(model_str)
            return
        if train_set is None:
            raise ValueError("Booster needs train_set, model_file or model_str")

        self.config = Config(params or {})
        if self.config.predict_bucketed == "true":
            raise NotImplementedError(
                "predict_bucketed=true needs the serving engine, which is "
                "not ported to lightgbm_torch yet (ROADMAP A14)")
        # a not-yet-constructed dataset bins with its OWN params as the
        # base and the booster's params overriding (reference
        # _update_params semantics)
        construct_cfg = self.config
        if not train_set._constructed and train_set.params:
            from .config import canonical_params
            construct_cfg = Config({**canonical_params(train_set.params),
                                    **canonical_params(params or {})})
        self.train_set = train_set.construct(construct_cfg)
        self.objective = create_objective(self.config)
        self._model = create_boosting(self.config, self.train_set,
                                      self.objective)
        self._num_class = self.config.num_class
        self._num_tree_per_iteration = self.config.num_model_per_iteration
        self.feature_names = list(self.train_set.feature_names)
        self._max_feature_idx = self.train_set.num_total_features - 1
        self._train_metrics = self._make_metrics(self.train_set.metadata,
                                                 self.train_set.num_data)

    # ------------------------------------------------------------------
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        if self._model is None:
            raise ValueError("cannot add validation data to a loaded model")
        data.reference = self.train_set
        data.construct(self.config)
        self._model.add_valid_set(data)
        self._valid_names.append(name)
        self._valid_metrics.append(self._make_metrics(data.metadata,
                                                      data.num_data))
        return self

    def _make_metrics(self, metadata, num_data) -> List:
        """Configured metric objects bound to one dataset's metadata."""
        ms = []
        for mname in self.config.default_metric():
            m = create_metric(mname, self.config)
            if m is not None:
                m.init(metadata, num_data)
                ms.append(m)
        return ms

    def update(self, train_set=None, fobj=None) -> bool:
        """One boosting iteration; returns True if no further splits
        (LGBM_BoosterUpdateOneIter analog, c_api.cpp:1686)."""
        if fobj is not None:
            preds = self._model.train_score()
            grad, hess = fobj(preds, self.train_set)
            grad, hess = np.asarray(grad), np.asarray(hess)
            n = self.train_set.num_data
            if grad.size != hess.size:
                raise ValueError(
                    f"Lengths of gradient ({grad.size}) and Hessian "
                    f"({hess.size}) don't match")
            if grad.size != n:
                raise ValueError(
                    f"Lengths of gradient ({grad.size}) and Hessian "
                    f"({hess.size}) don't match training data length "
                    f"({n}) * number of models per one iteration (1)")
            stopped = self._model.train_one_iter(grad, hess)
        else:
            stopped = self._model.train_one_iter()
        self._sync_trees()
        return stopped

    def update_chunk(self, k: int) -> bool:
        """Run ``k`` iterations fused, one host fetch per chunk
        (GBDTModel.train_chunk).  The caller checks ``supports_fused()``;
        returns True if training hit a no-split iteration."""
        stopped = self._model.train_chunk(k)
        self._sync_trees()
        return stopped

    def update_superepoch(self, k: int, es_it0: int, eval_spec=(),
                          es_spec=None) -> dict:
        """Run ``k`` full iterations (growth, scores, valid walks, traced
        metrics, early-stop vote) fused, with one host fetch
        (GBDTModel.train_superepoch).  Returns the fetched block that
        engine.train replays through the callbacks."""
        out = self._model.train_superepoch(k, es_it0, eval_spec, es_spec)
        self._sync_trees()
        return out

    def supports_fused(self) -> bool:
        return (self._model is not None and self._model.supports_fused()
                and not self._model.valid_sets)

    def fused_reasons(self) -> List[str]:
        """Why ``supports_fused()`` is False: specific blockers, empty when
        fusion is eligible (GBDTModel.fused_reasons)."""
        if self._model is None:
            return ["no active training model"]
        return self._model.fused_reasons()

    def _sync_trees(self) -> None:
        self.trees = self._model.models
        self.tree_weights = self._model.tree_weights

    @property
    def current_iteration(self) -> "_IntAndCall":
        if self._model is not None:
            return _IntAndCall(self._model.num_iterations_trained)
        return _IntAndCall(len(self.trees) // self._num_tree_per_iteration)

    def num_trees(self) -> int:
        return len(self.trees)

    # ------------------------------------------------------------------
    def eval_train(self, feval=None) -> List[Tuple]:
        score = self._model.train_score()
        return self._eval_set(getattr(self, "_train_data_name", "training"),
                              score, self._train_metrics,
                              self.train_set, feval)

    def eval_valid(self, feval=None) -> List[Tuple]:
        out = []
        for i, name in enumerate(self._valid_names):
            score = self._model.valid_score(i)
            ds = self._model.valid_sets[i][0]
            out.extend(self._eval_set(name, score, self._valid_metrics[i],
                                      ds, feval))
        return out

    def _traced_spec(self) -> Tuple:
        return tuple((vi, name, mt.name, mt.is_higher_better)
                     for vi, name in enumerate(self._valid_names)
                     for mt in self._valid_metrics[vi])

    def eval_valid_traced(self) -> List[Tuple]:
        """Every valid-set metric by the traced metric kernels (B12) with
        one host fetch: the kernels the fused epochs report through, so a
        ``fused_eval=true`` per-iteration run reports the same bits as a
        super-epoch run.  ``fused_eval=false`` keeps the host f64
        ``eval_valid``."""
        spec = self._traced_spec()
        vals = self._model.eval_traced(spec)
        return [(name, mn, float(vals[e]), hib)
                for e, (_vi, name, mn, hib) in enumerate(spec)]

    def _eval_set(self, name, score, metrics, dataset, feval) -> List[Tuple]:
        results = []
        for m in metrics:
            for mname, val, hib in m.eval(score):
                results.append((name, mname, val, hib))
        if feval is not None:
            for fe in (feval if isinstance(feval, (list, tuple)) else [feval]):
                r = fe(score, dataset)
                rs = r if isinstance(r, list) else [r]
                for (mname, val, hib) in rs:
                    results.append((name, mname, val, hib))
        return results

    # ------------------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                **kw) -> np.ndarray:
        """Prediction on raw features by the host tree walk
        (gbdt_prediction.cpp:97 inner loop, Predictor analog)."""
        from .dataset import _to_numpy_2d
        for opt in ("pred_leaf", "pred_contrib", "pred_early_stop"):
            if kw.get(opt):
                raise NotImplementedError(
                    f"{opt} is not ported to lightgbm_torch yet "
                    "(ROADMAP A14)")
        if not raw_score and self._unported_objective is not None:
            raise NotImplementedError(
                f"the output transform of objective="
                f"{self._unported_objective} is not ported to lightgbm_torch "
                "yet (ROADMAP A9); pass raw_score=True")
        x, _, _ = _to_numpy_2d(data)
        disable_shape_check = bool(kw.get(
            "predict_disable_shape_check",
            self.config.predict_disable_shape_check))
        nf_model = self._max_feature_idx + 1
        if x.shape[1] != nf_model:
            if not disable_shape_check:
                raise LightGBMError(
                    f"The number of features in data ({x.shape[1]}) is not "
                    f"the same as it was in training data ({nf_model}).\n"
                    "You can set ``predict_disable_shape_check=true`` to "
                    "discard this error, but please be aware what you are "
                    "doing.")
            # the reference Predictor zero-fills a missing feature tail
            if x.shape[1] < nf_model:
                x = np.concatenate(
                    [x, np.zeros((len(x), nf_model - x.shape[1]),
                                 dtype=x.dtype)], axis=1)
            else:
                x = x[:, :nf_model]
        n = len(x)
        k = self._num_tree_per_iteration
        start_iteration = max(0, start_iteration)
        if num_iteration is None:
            # only an OMITTED num_iteration defaults to the best iteration
            num_iteration = (self.best_iteration
                             if self.best_iteration > 0
                             and start_iteration <= 0 else
                             len(self.trees) // k)
        elif num_iteration <= 0:
            num_iteration = len(self.trees) // k
        t0 = start_iteration * k
        t1 = min((start_iteration + num_iteration) * k, len(self.trees))
        score = np.zeros((n, k))
        for ti in range(t0, t1):
            score[:, ti % k] += (self.tree_weights[ti]
                                 * self.trees[ti].predict(x))
        return _finalize_score(score, k, self.objective,
                               self._average_output, t0, t1, raw_score)

    # ------------------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        """SaveModelToString (gbdt_model_text.cpp:311)."""
        cfg = getattr(self, "config", None)
        buf = io.StringIO()
        buf.write("tree\n")
        buf.write("version=v3\n")
        buf.write(f"num_class={self._num_class}\n")
        buf.write(f"num_tree_per_iteration={self._num_tree_per_iteration}\n")
        buf.write("label_index=0\n")
        buf.write(f"max_feature_idx={self._max_feature_idx}\n")
        obj_str = _objective_to_string(cfg) if cfg else getattr(
            self, "_objective_str", "regression")
        buf.write(f"objective={obj_str}\n")
        if self._average_output:
            buf.write("average_output\n")
        names = self.feature_names or [f"Column_{i}"
                                       for i in range(self._max_feature_idx + 1)]
        buf.write("feature_names=" + " ".join(names) + "\n")
        buf.write("feature_infos=" + " ".join(self._feature_infos()) + "\n")

        k = self._num_tree_per_iteration
        t0 = start_iteration * k
        t1 = len(self.trees) if num_iteration is None else \
            min(t0 + num_iteration * k, len(self.trees))
        blocks = []
        for i, ti in enumerate(range(t0, t1)):
            t = self.trees[ti]
            w = self.tree_weights[ti] if ti < len(self.tree_weights) else 1.0
            if w != 1.0:
                import copy
                t = copy.deepcopy(t)
                t.leaf_value *= w
                t.internal_value *= w
            blocks.append(t.to_string(i) + "\n")
        sizes = [len(b.encode()) for b in blocks]
        buf.write("tree_sizes=" + " ".join(str(s) for s in sizes) + "\n\n")
        for b in blocks:
            buf.write(b)
        buf.write("end of trees\n\n")
        buf.write("feature_importances:\n")
        # gains of the trees written above, rounded through the %g the tree
        # blocks print, so save -> load -> save is byte-stable
        imp = np.zeros(self._max_feature_idx + 1)
        for t in self.trees[t0:t1]:
            for i in range(t.num_nodes()):
                imp[t.split_feature[i]] += float(f"{t.split_gain[i]:g}")
        order = np.argsort(-imp)
        for fi in order:
            if imp[fi] > 0:
                buf.write(f"{names[fi]}={imp[fi]:g}\n")
        buf.write("\nparameters:\n")
        if cfg is not None:
            for key, val in sorted(cfg.raw_params.items()):
                buf.write(f"[{key}: {val}]\n")
        buf.write("end of parameters\n\n")
        buf.write("pandas_categorical:null\n")
        return buf.getvalue()

    def _feature_infos(self) -> List[str]:
        infos = []
        ds = self.train_set
        if ds is None or ds.bin_mappers is None:
            return ["none"] * (self._max_feature_idx + 1)
        for f in range(ds.num_total_features):
            m = ds.bin_mappers[f]
            if m.is_trivial:
                infos.append("none")
            elif m.bin_type.name == "CATEGORICAL":
                infos.append(":".join(str(int(c)) for c in m.categories))
            else:
                ub = m.bin_upper_bound
                finite = ub[np.isfinite(ub)]
                lo = float(finite[0]) if len(finite) else 0.0
                hi = float(finite[-1]) if len(finite) else 0.0
                infos.append(f"[{lo:g}:{hi:g}]")
        return infos

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text atomically."""
        _atomic_write(filename,
                      self.model_to_string(num_iteration, start_iteration))
        return self

    # ------------------------------------------------------------------
    def _load_model_string(self, s: str) -> None:
        """LoadModelFromString (gbdt_model_text.cpp:421)."""
        if "num_class=" not in s:
            raise ValueError("input is not a LightGBM model "
                             "(missing header)")
        header, _, rest = s.partition("\nTree=")
        kv: Dict[str, str] = {}
        for line in header.splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
            elif line.strip() == "average_output":
                self._average_output = True
        self._num_class = int(kv.get("num_class", "1"))
        self._num_tree_per_iteration = int(kv.get("num_tree_per_iteration", "1"))
        self._max_feature_idx = int(kv.get("max_feature_idx", "0"))
        self._objective_str = kv.get("objective", "regression")
        self.feature_names = kv.get("feature_names", "").split(" ") \
            if kv.get("feature_names") else []
        obj_kv = _objective_from_string(self._objective_str)
        params = {"objective": obj_kv.pop("objective", "regression")}
        params.update(obj_kv)
        self.config = Config(params)
        try:
            self.objective = create_objective(self.config)
        except NotImplementedError:
            # the trees still load, save and predict raw scores
            self.objective = None
            self._unported_objective = self.config.objective

        body = "Tree=" + rest
        tree_blocks = body.split("\nend of trees")[0]
        self.trees = []
        for block in tree_blocks.split("Tree="):
            block = block.strip()
            if not block:
                continue
            self.trees.append(Tree.from_string("Tree=" + block))
        self.tree_weights = [1.0] * len(self.trees)
        self.best_iteration = -1
