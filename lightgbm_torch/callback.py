"""Training callbacks (reference: python-package/lightgbm/callback.py:15-356).

Same surface: ``log_evaluation``, ``record_evaluation``, ``reset_parameter``,
``early_stopping``; early stopping signals via ``EarlyStopException`` caught
by the train loop (engine.py:252 pattern).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _fmt_eval(res, show_stdv: bool = True) -> str:
    if len(res) == 4:
        name, metric, value, _ = res
        return f"{name}'s {metric}: {value:g}"
    # cv 5-tuple (callback.py _format_eval_result cv branch)
    _, key, mean, _hib, stdv = res
    if show_stdv:
        return f"cv_agg's {key}: {mean:g} + {stdv:g}"
    return f"cv_agg's {key}: {mean:g}"


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            msg = "\t".join(_fmt_eval(r, show_stdv)
                            for r in env.evaluation_result_list)
            print(f"[{env.iteration + 1}]\t{msg}")
    _callback.order = 10
    # pure function of the CallbackEnv — the super-epoch replay
    # (engine.py) can feed it fetched eval rows after the fact and the
    # output is identical to the per-iteration path
    _callback._replayable = True
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result must be a dict")

    def _callback(env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            if len(item) == 4:
                name, metric, value = item[0], item[1], item[2]
                eval_result.setdefault(name, collections.OrderedDict())
                eval_result[name].setdefault(metric, []).append(value)
            else:
                # cv 5-tuple ('cv_agg', '<set> <metric>', mean, hib,
                # stdv) — recorded as {set: {metric-mean: [...],
                # metric-stdv: [...]}} (reference callback.py:111-136)
                dsname, metric = item[1].split(" ", 1)
                eval_result.setdefault(dsname, collections.OrderedDict())
                eval_result[dsname].setdefault(f"{metric}-mean",
                                               []).append(item[2])
                eval_result[dsname].setdefault(f"{metric}-stdv",
                                               []).append(item[4])
    _callback.order = 20
    # env-pure: replayable from a super-epoch's fetched eval block
    _callback._replayable = True
    return _callback


def log_telemetry(period: int = 10, collect: Dict = None) -> Callable:
    """Log (and optionally collect) obs metrics snapshots during
    training (docs/Observability.md).  Every ``period`` iterations the
    booster's aggregated snapshot is summarized via ``Log.info`` —
    iteration count, mean per-phase milliseconds, cumulative comm wire
    bytes — and, when ``collect`` is given, stored whole under the
    1-based iteration number.  A no-op unless ``telemetry=true``."""

    def _summary(snap: Dict) -> str:
        parts = []
        it = snap.get("train.iterations")
        if it:
            parts.append(f"iters={it['value']:g}")
        for key, rec in snap.items():
            if key.startswith("train.phase_seconds{") \
                    and rec.get("count"):
                phase = key.split("phase=", 1)[1].rstrip("}")
                parts.append(
                    f"{phase}={rec['sum'] / rec['count'] * 1e3:.1f}ms")
        wire = sum(rec["value"] for key, rec in snap.items()
                   if key.startswith("comm.wire_bytes{"))
        if wire:
            parts.append(f"comm={wire / 1e6:.2f}MB")
        return " ".join(parts) or "(no telemetry data)"

    def _callback(env: CallbackEnv) -> None:
        if period <= 0 or (env.iteration + 1) % period != 0:
            return
        boosters = getattr(env.model, "boosters", None) or [env.model]
        many = len(boosters) > 1          # cv: one snapshot per fold
        for bi, bst in enumerate(boosters):
            snap_fn = getattr(bst, "telemetry_snapshot", None)
            snap = snap_fn() if snap_fn is not None else {}
            if not snap or all(k.startswith("compile.") for k in snap):
                # telemetry=false: the snapshot still carries the
                # process-wide compile accounting (docs/Compile-Cache.md)
                # but there is nothing iteration-scoped to log
                continue
            if collect is not None:
                if many:
                    collect.setdefault(env.iteration + 1, []).append(snap)
                else:
                    collect[env.iteration + 1] = snap
            from .utils.log import Log
            tag = f" fold {bi}" if many else ""
            Log.info(f"[telemetry] [{env.iteration + 1}]{tag} "
                     f"{_summary(snap)}")
    _callback.order = 40
    return _callback


def reset_parameter(**kwargs) -> Callable:
    """Per-iteration parameter schedule; supports ``learning_rate`` as a
    list or ``f(iteration) -> value`` (callback.py reset_parameter)."""

    def _callback(env: CallbackEnv) -> None:
        it = env.iteration - env.begin_iteration
        # cv passes the CVBooster container — the schedule applies to
        # every fold (the reference's _reset_parameter_callback does the
        # same CVBooster fan-out)
        boosters = getattr(env.model, "boosters", None) or [env.model]
        for key, value in kwargs.items():
            new_val = value[it] if isinstance(value, list) else value(it)
            for bst in boosters:
                if key == "learning_rate":
                    bst._model.learning_rate = new_val
                else:
                    setattr(bst._model.config, key, new_val)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    best_score: List[float] = []
    best_iter: List[int] = []
    best_score_list: List[list] = []
    cmp_op: List[Callable] = []
    enabled = [True]
    first_metric = [""]
    warned_nonfinite = [False]

    def _metric_of(item) -> str:
        # cv 5-tuples carry '<set> <metric>' as the key
        m = item[1]
        return m.split(" ", 1)[1] if item[0] == "cv_agg" and " " in m else m

    def _init(env: CallbackEnv) -> None:
        enabled[0] = bool(env.evaluation_result_list)
        if not enabled[0]:
            return
        best_score.clear(), best_iter.clear()
        best_score_list.clear(), cmp_op.clear()
        first_metric[0] = _metric_of(
            env.evaluation_result_list[0]).split("@")[0]
        # per-metric deltas (callback.py _EarlyStoppingCallback): a list
        # gives one delta per UNIQUE metric (broadcast over datasets),
        # a scalar applies everywhere; negatives are rejected
        uniq = []
        for item in env.evaluation_result_list:
            m = _metric_of(item)
            if m not in uniq:
                uniq.append(m)
        if isinstance(min_delta, (list, tuple)):
            deltas = [float(d) for d in min_delta]
            if any(d < 0 for d in deltas):
                raise ValueError("Values for early stopping min_delta "
                                 "must be non-negative.")
            if len(deltas) != len(uniq):
                raise ValueError("Must provide a single value for "
                                 "min_delta or as many as metrics.")
            delta_of = dict(zip(uniq, deltas))
        else:
            if float(min_delta) < 0:
                raise ValueError("Early stopping min_delta must be "
                                 "non-negative.")
            delta_of = {m: float(min_delta) for m in uniq}
        for item in env.evaluation_result_list:
            higher_better = item[3]
            d = delta_of[_metric_of(item)]
            best_iter.append(0)
            best_score_list.append(None)
            if higher_better:
                best_score.append(float("-inf"))
                cmp_op.append(
                    lambda new, best, _d=d: new > best + _d)
            else:
                best_score.append(float("inf"))
                cmp_op.append(
                    lambda new, best, _d=d: new < best - _d)

    def _callback(env: CallbackEnv) -> None:
        if not best_score:
            _init(env)
        if not enabled[0]:
            return
        import math
        for i, item in enumerate(env.evaluation_result_list):
            name, val = item[0], item[2]
            metric = _metric_of(item)
            # a non-finite metric is NEVER an improvement: the reference
            # (and this loop, before the fix) recorded the FIRST value
            # unconditionally, so an early NaN/Inf became an unbeatable
            # best score and poisoned the whole early-stopping run
            finite = val is not None and math.isfinite(val)
            if not finite and not warned_nonfinite[0]:
                warned_nonfinite[0] = True
                from .utils.log import Log
                Log.warning(
                    f"early stopping: non-finite value for {metric} "
                    f"({val}); treated as no improvement")
            if finite and (best_score_list[i] is None
                           or cmp_op[i](val, best_score[i])):
                best_score[i] = val
                best_iter[i] = env.iteration
                best_score_list[i] = list(env.evaluation_result_list)
            if first_metric_only and metric.split("@")[0] != first_metric[0]:
                continue
            if name == "training" \
                    or (name == "cv_agg" and item[1].startswith("train ")):
                continue
            # best_score_list[i] stays None while every value so far was
            # non-finite — report the current results in that case
            bsl = best_score_list[i] if best_score_list[i] is not None \
                else list(env.evaluation_result_list)
            if env.iteration - best_iter[i] >= stopping_rounds:
                if verbose:
                    print(f"Early stopping, best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t" +
                          "\t".join(_fmt_eval(r) for r in bsl))
                raise EarlyStopException(best_iter[i], bsl)
            if env.iteration == env.end_iteration - 1:
                if verbose:
                    print(f"Did not meet early stopping. Best iteration is:\n"
                          f"[{best_iter[i] + 1}]\t" +
                          "\t".join(_fmt_eval(r) for r in bsl))
                raise EarlyStopException(best_iter[i], bsl)
    _callback.order = 30
    # env-pure state machine: the super-epoch replay (engine.py) feeds
    # it the SAME (iteration, evaluation_result_list) stream the
    # per-iteration path would, so best_iteration/best_score come out
    # byte-identical.  _es_spec lets the engine mirror the closure as a
    # traced in-scan vote (models/gbdt.py) that predicts the stop row —
    # only the scalar min_delta == 0 form is traced (engine gates)
    _callback._replayable = True
    _callback._es_spec = {"stopping_rounds": stopping_rounds,
                          "first_metric_only": first_metric_only,
                          "min_delta": min_delta}
    return _callback
