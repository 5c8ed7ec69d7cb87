"""Training entry point: ``train``.

Counterpart of the JAX package's ``engine.py`` ``train`` for this slice:
parameter normalisation, valid-set wiring, the per-iteration loop with
callbacks, and early stopping via ``EarlyStopException`` (reference
python-package engine.py:25).  The JAX package's fused-chunk and
super-epoch paths are byte-identical to its per-iteration loop by its own
contract, so ``fused_chunk`` and ``superepoch`` are accepted and run the
per-iteration loop here (the fused CUDA-graph loop is ROADMAP A13).
Snapshots, resume and continued training (``init_model``) are ROADMAP
A12; ``cv`` comes with A6's breadth.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from . import callback as callback_mod
from .booster import Booster
from .callback import CallbackEnv, EarlyStopException
from .config import Config
from .dataset import Dataset


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model: Optional[Union[str, Booster]] = None,
          feature_name="auto", categorical_feature="auto",
          keep_training_booster: bool = False,
          callbacks: Optional[List[Callable]] = None) -> Booster:
    """Train a gradient-boosted model (engine.py:25 analog)."""
    params = dict(params or {})
    cfg = Config(params)
    if cfg.resume or cfg.snapshot_freq > 0:
        raise NotImplementedError(
            "snapshots and resume are not ported to lightgbm_torch yet "
            "(ROADMAP A12)")
    from .config import canonical_params
    if "num_iterations" in canonical_params(params):
        # any num_iterations alias in params overrides the keyword
        num_boost_round = cfg.num_iterations
    # the saved model's parameters section records the round count
    params["num_iterations"] = num_boost_round
    if valid_sets is not None and not isinstance(valid_sets, (list, tuple)):
        valid_sets = [valid_sets]
    if isinstance(valid_names, str):
        valid_names = [valid_names]
    if feature_name != "auto" and not train_set._constructed:
        train_set.set_feature_name(feature_name)
    if categorical_feature != "auto" and not train_set._constructed:
        train_set.set_categorical_feature(categorical_feature)

    if init_model is not None:
        raise NotImplementedError(
            "continued training (init_model) is not ported to lightgbm_torch "
            "yet (ROADMAP A12)")

    booster = Booster(params=params, train_set=train_set)
    train_eval_name = None
    if valid_sets:
        names = valid_names or [
            "training" if vs is train_set else f"valid_{i}"
            for i, vs in enumerate(valid_sets)]
        for vs, name in zip(valid_sets, names):
            if vs is train_set:
                # the training set in valid_sets reports training metrics
                train_eval_name = name
                booster._train_data_name = name
                continue
            booster.add_valid(vs, name)

    cbs = list(callbacks or [])
    if cfg.early_stopping_round and cfg.early_stopping_round > 0:
        cbs.append(callback_mod.early_stopping(
            cfg.early_stopping_round, cfg.first_metric_only,
            cfg.verbosity > 0))
    cbs_before = sorted((c for c in cbs
                         if getattr(c, "before_iteration", False)),
                        key=lambda c: getattr(c, "order", 0))
    cbs_after = sorted((c for c in cbs
                        if not getattr(c, "before_iteration", False)),
                       key=lambda c: getattr(c, "order", 0))

    for i in range(num_boost_round):
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=None)
        for cb in cbs_before:
            cb(env)
        stopped = booster.update(fobj=fobj)
        evals = []
        if cfg.is_provide_training_metric or train_eval_name is not None:
            evals.extend(booster.eval_train(feval))
        if booster._valid_names:
            evals.extend(booster.eval_valid(feval))
        env = CallbackEnv(model=booster, params=params, iteration=i,
                          begin_iteration=0, end_iteration=num_boost_round,
                          evaluation_result_list=evals)
        try:
            for cb in cbs_after:
                cb(env)
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for (name, metric, value, _) in e.best_score:
                booster.best_score.setdefault(name, {})[metric] = value
            break
        if stopped:
            break
    return booster

