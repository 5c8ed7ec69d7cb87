"""Classified training failures and suspect-device quarantine: the part of
the JAX package's ``parallel/elastic.py`` that the computation-integrity
layer (``integrity.py``) needs.

- :class:`ElasticFailure`, :data:`FAILURE_KINDS` and :func:`failure_kind`
  classify a failure (``integrity.IntegrityFailure`` is kind ``"sdc"``);
- :func:`_on_failure` records a classified failure: an event in
  :func:`events` and the ``elastic.failures{kind=...}`` counter of the
  process-level registry (:func:`metrics_snapshot`);
- :func:`mark_suspect`, :func:`suspected_devices`, :func:`clear_suspects`
  and :func:`sdc_shrunk` keep the devices a sticky SDC failure named
  (``integrity_policy=quarantine``) and the mesh size the recovery
  ladder's next rung would take without them.

The rest waits for ROADMAP A16b: the heartbeat liveness monitor, the
collective deadline (``guarded_get``), ``elastic_train``'s shrink-to-
survive ladder and its JSONL event file; the flight-recorder dump at a
classified failure waits for A15 (the blackbox).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..obs.metrics import MetricsRegistry

FAILURE_KINDS = ("collective_timeout", "host_loss", "claim_wedge",
                 "bringup", "ingest", "sdc")

# process-level elastic metrics: host-side counter bumps per failure,
# nothing per iteration
_REGISTRY = MetricsRegistry()
_REGISTRY_LOCK = threading.Lock()
# the classified failures of this process, oldest first (the JAX
# package appends them to ``<output_model>.elastic.jsonl``, A16b)
_EVENTS: List[Dict[str, object]] = []


def metrics_snapshot() -> dict:
    """Deterministic dict snapshot of the ``elastic.*`` metrics."""
    return _REGISTRY.snapshot()


def reset_metrics() -> None:
    """Drop all ``elastic.*`` metric state and the event record."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        _REGISTRY = MetricsRegistry()
        _EVENTS.clear()


def _metrics() -> MetricsRegistry:
    with _REGISTRY_LOCK:
        return _REGISTRY


def events() -> List[Dict[str, object]]:
    """A copy of the classified-failure events recorded so far."""
    with _REGISTRY_LOCK:
        return [dict(e) for e in _EVENTS]


class ElasticFailure(RuntimeError):
    """A classified mid-run training failure; ``kind`` is one of
    :data:`FAILURE_KINDS`.  The message carries the resilience
    classifier's retryable patterns (``unavailable``, ``deadline``,
    ``heartbeat``)."""

    def __init__(self, kind: str, detail: str = ""):
        assert kind in FAILURE_KINDS, kind
        self.kind = kind
        self.detail = detail
        super().__init__(
            f"elastic failure [{kind}]: "
            f"{detail or 'classified distributed-training failure'} "
            "(UNAVAILABLE: deadline/heartbeat)")


def failure_kind(exc: BaseException) -> Optional[str]:
    """Classify an exception into a :data:`FAILURE_KINDS` entry, or None
    for errors a recovery ladder must not swallow."""
    from ..utils.resilience import (WatchdogTimeout,
                                    is_retryable_device_error)
    if isinstance(exc, ElasticFailure):
        return exc.kind
    if isinstance(exc, WatchdogTimeout):
        return "collective_timeout"
    if is_retryable_device_error(exc):
        return "bringup"
    return None


def _on_failure(exc: ElasticFailure, site: str = "") -> None:
    """Classified-failure bookkeeping: the ``elastic.failures`` counter
    and one event.  Each failure passes here once, where it is first
    classified."""
    reg = _metrics()
    reg.counter("elastic.failures", kind=exc.kind).inc()
    with _REGISTRY_LOCK:
        _EVENTS.append({"event": exc.kind, "t": round(time.time(), 3),
                        "site": site, "detail": exc.detail})


# Device ids attributed to a sticky silent-data-corruption failure.
# Guarded by _suspect_lock; reads return an immutable copy.
_suspect_lock = threading.Lock()
_suspects: set = set()


def mark_suspect(device_ids) -> None:
    """Record devices attributed to a sticky SDC failure (quarantine)."""
    with _suspect_lock:
        for d in device_ids:
            _suspects.add(int(d))
        n = len(_suspects)
    _metrics().gauge("elastic.suspect_devices").set(n)


def suspected_devices() -> frozenset:
    """Immutable snapshot of the quarantined device ids."""
    with _suspect_lock:
        return frozenset(_suspects)


def clear_suspects() -> None:
    """Drop all quarantine state."""
    with _suspect_lock:
        _suspects.clear()
    _metrics().gauge("elastic.suspect_devices").set(0)


def sdc_shrunk(n: int) -> int:
    """Next data-parallel rung after a sticky-SDC failure: drop exactly
    the quarantined suspects, or halve when attribution named none."""
    sus = len(suspected_devices())
    if sus:
        return max(1, int(n) - sus)
    return max(1, int(n) // 2)
