"""Training entry point: ``train``.

Counterpart of the JAX package's ``engine.py`` ``train`` for this slice:
parameter normalisation, valid-set wiring, callbacks and early stopping
via ``EarlyStopException`` (reference python-package engine.py:25), and
the JAX package's three training paths, chosen the same way:

- fused chunks (``fused_chunk`` > 1, default 25) when no per-iteration
  host work is needed (no valid set, callback, custom objective or
  training metric): ``fused_chunk`` iterations per fetch;
- super-epochs (``superepoch`` 0 = auto, or k > 1) when every valid
  metric has a traced form and every callback is replay-safe: k full
  iterations per fetch (k = ``max(2, min(fused_chunk,
  early_stopping_round))`` on auto), then the fetched eval block is
  replayed through the real callbacks, so ``record_evals``,
  ``best_iteration`` and ``best_score`` come out as a per-iteration run
  that evaluates through the traced metrics would give them;
- the per-iteration loop otherwise, or with ``superepoch=-1``.

The fused paths give the same trees as the per-iteration loop but report
the traced f32 metric values, where the per-iteration loop reports the
host f64 ones unless ``fused_eval=true``.  Snapshots, resume and
continued training (``init_model``) are ROADMAP A12; ``cv`` comes with
A6's breadth.
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

    # fused chunks: no per-iteration host work, so ``fused_chunk``
    # iterations run as graph replays with one host fetch per chunk; a
    # remainder falls through to the paths below
    start_round = 0
    chunk_stopped = False
    chunk = cfg.fused_chunk
    if (chunk > 1 and fobj is None and not cbs
            and not booster._valid_names
            and not cfg.is_provide_training_metric
            and train_eval_name is None and cfg.verbosity <= 1
            and booster.supports_fused()):
        while num_boost_round - start_round >= chunk and not chunk_stopped:
            chunk_stopped = booster.update_chunk(chunk)
            start_round = booster.current_iteration

    # super-epochs: k full iterations (growth, scores, valid walks, traced
    # eval, early-stop vote) per fetch, then the fetched eval block
    # replayed through the real callbacks
    se_plan = None if chunk_stopped else _superepoch_plan(
        cfg, booster, fobj, feval, cbs_before, cbs_after, train_eval_name)
    if se_plan is not None:
        base_k, eval_spec, es_spec = se_plan
        from .utils.log import Log
        while not chunk_stopped:
            k_eff = min(base_k, num_boost_round - start_round)
            if k_eff < 2:
                break
            out = booster.update_superepoch(k_eff, start_round, eval_spec,
                                            es_spec)
            done = out["done"]
            es_raised = False
            for j in range(done):
                ev_row = [(nm, mn, float(out["evals"][j][e]), hib)
                          for e, (_vi, nm, mn, hib) in enumerate(eval_spec)]
                env = CallbackEnv(model=booster, params=params,
                                  iteration=start_round + j,
                                  begin_iteration=0,
                                  end_iteration=num_boost_round,
                                  evaluation_result_list=ev_row)
                try:
                    for cb in cbs_after:
                        cb(env)
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    for (name, metric, value, _) in e.best_score:
                        booster.best_score.setdefault(name, {})[metric] = \
                            value
                    es_raised = True
                    extra = done - (j + 1)
                    if extra > 0:
                        # the vote and this replay read the same fetched
                        # values, so they agree on the stop row; should
                        # they not, the surplus trees go
                        Log.warning(
                            "super-epoch vote overshot the host early "
                            f"stop by {extra} iteration(s); dropping "
                            "surplus trees")
                        booster._model.drop_iterations(extra)
                        booster._sync_trees()
                    break
            if es_raised or out["stump"]:
                chunk_stopped = True
            elif out["stop_row"] is not None:
                # the vote tripped but the replay did not raise: trust the
                # host, clear the latch, keep training
                Log.warning("super-epoch early-stop vote tripped but the "
                            "host callbacks did not; resuming")
                booster._model.clear_es_stop()
            start_round = booster.current_iteration
        if not chunk_stopped and start_round < num_boost_round \
                and eval_spec:
            # remainder rounds run per iteration but keep the traced
            # values, so the run's record_evals stay those of the traced
            # metrics
            booster._traced_eval = True
    elif str(cfg.fused_eval).lower() == "true" and feval is None \
            and booster._valid_names:
        # fused_eval=true: per-iteration runs report the traced metrics
        # (one fetch per iteration for all of them)
        from .metrics import traced_metric_fn
        if all(traced_metric_fn(mt.name, cfg) is not None
               for ms in booster._valid_metrics for mt in ms):
            booster._traced_eval = True

    for i in range(start_round, num_boost_round if not chunk_stopped else 0):
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
            if getattr(booster, "_traced_eval", False) and feval is None:
                evals.extend(booster.eval_valid_traced())
            else:
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



def _superepoch_plan(cfg, booster, fobj, feval, cbs_before, cbs_after,
                     train_eval_name):
    """Whether super-epochs (GBDTModel.train_superepoch) can drive this
    run, and with what epoch size (the JAX package's ``_superepoch_plan``).
    Returns ``(base_k, eval_spec, es_spec)`` or None for the
    per-iteration path.  Requirements: a fusable configuration, no custom
    fobj/feval, no training-set eval, only replay-safe callbacks, valid
    metrics that all have traced kernels, and at most one early-stopping
    callback in its scalar ``min_delta == 0`` form."""
    if cfg.superepoch == -1:
        return None
    if not (cfg.superepoch > 0 or cfg.fused_chunk > 1):
        return None
    if fobj is not None or feval is not None:
        return None
    if cfg.is_provide_training_metric or train_eval_name is not None:
        return None
    if cfg.verbosity > 1:
        return None
    if cbs_before:
        return None
    if any(not getattr(cb, "_replayable", False) for cb in cbs_after):
        return None
    model = booster._model
    if not model._fusable_config():
        return None
    if str(cfg.fused_eval).lower() == "false" and model.valid_sets:
        return None
    from .metrics import traced_metric_fn
    eval_spec = []
    for vi, name in enumerate(booster._valid_names):
        for mt in booster._valid_metrics[vi]:
            if traced_metric_fn(mt.name, cfg) is None:
                return None
            eval_spec.append((vi, name, mt.name, bool(mt.is_higher_better)))
    eval_spec = tuple(eval_spec)
    es_cbs = [cb for cb in cbs_after
              if getattr(cb, "_es_spec", None) is not None]
    if len(es_cbs) > 1:
        return None
    es_spec = None
    if es_cbs:
        spec = es_cbs[0]._es_spec
        md = spec["min_delta"]
        if isinstance(md, (list, tuple)) or float(md) != 0.0:
            return None
        # the entries whose trip the host closure really checks:
        # 'training'-named sets and first_metric_only mismatches update
        # their best but never raise (callback.early_stopping)
        first_metric = eval_spec[0][2].split("@")[0] if eval_spec else ""
        eligible = tuple(
            (nm != "training")
            and (not spec["first_metric_only"]
                 or mn.split("@")[0] == first_metric)
            for (_vi, nm, mn, _h) in eval_spec)
        es_spec = {"stopping_rounds": int(spec["stopping_rounds"]),
                   "first_metric_only": bool(spec["first_metric_only"]),
                   "eligible": eligible}
    # epoch size: an explicit superepoch wins; auto takes the fused chunk,
    # bounded by the early-stop horizon so a stop wastes at most about one
    # epoch of blocked iterations
    if cfg.superepoch > 0:
        base_k = cfg.superepoch
    elif es_spec is not None:
        base_k = max(2, min(cfg.fused_chunk, es_spec["stopping_rounds"]))
    else:
        base_k = cfg.fused_chunk
    return max(int(base_k), 2), eval_spec, es_spec
