"""Serving circuit breaker: admission-time rejection while the device
side is failing (the JAX package's ``serve/breaker.py``, copied).

Retry (``serve_retries``) protects ONE batch from a transient blip; the
breaker protects the SERVICE from a dependency that is actually down
(device wedged, backend gone).  Without it,
every incoming request queues, waits out the full retry schedule, and
fails — the bounded queue stays pinned at capacity doing work that
cannot succeed.  With it, ``serve_breaker_failures`` consecutive batch
failures open the circuit and submissions are rejected UP FRONT with
:class:`CircuitOpen` carrying a ``retry_after_ms`` hint (HTTP maps it
to 503 + ``Retry-After``); after ``serve_breaker_cooldown_ms`` the
circuit half-opens and admits probe traffic — one batch outcome decides
whether it closes or re-opens with a doubled cooldown (capped).

Only infrastructure-shaped failures count: a request's own bad input
(``ValueError`` family, ``LightGBMError`` shape checks, ``TypeError``)
fails that request alone and must never open the circuit for everyone
else.  The state machine itself is the generic
``utils/resilience.CircuitBreaker``; this module adds the serve
semantics — failure classification, metrics (``serve.breaker_state``
gauge: 0 closed / 1 half-open / 2 open, ``serve.breaker_opens`` /
``serve.breaker_rejected`` counters) and the typed admission error.
"""

from __future__ import annotations

from typing import Optional

from ..utils.resilience import CircuitBreaker

# failures that belong to one request, not to the serving substrate —
# they never move the breaker (LightGBMError subclasses ValueError)
_REQUEST_SCOPED = (ValueError, TypeError, KeyError, IndexError,
                   AttributeError, AssertionError, NotImplementedError)

_STATE_GAUGE = {CircuitBreaker.CLOSED: 0, CircuitBreaker.HALF_OPEN: 1,
                CircuitBreaker.OPEN: 2}


class CircuitOpen(RuntimeError):
    """Serving circuit is open; retry after ``retry_after_ms``."""

    def __init__(self, retry_after_ms: float, opens: int):
        super().__init__(
            f"serving circuit open (opened {opens}x); "
            f"retry in ~{retry_after_ms:.0f} ms")
        self.retry_after_ms = float(retry_after_ms)
        self.opens = int(opens)


class ServeBreaker:
    """The batcher-facing adapter around ``resilience.CircuitBreaker``.

    Holds no lock of its own: every method is a pass-through to the
    breaker's internally-locked state machine (leaf-level — it never
    calls back into the batcher), plus ``_last_opens``, which only the
    worker thread's ``on_failure`` touches."""

    def __init__(self, failures: int = 5, cooldown_ms: float = 1000.0,
                 cooldown_max_ms: Optional[float] = None, metrics=None,
                 clock=None):
        if cooldown_max_ms is None:
            cooldown_max_ms = cooldown_ms * 16.0
        kw = {"clock": clock} if clock is not None else {}
        self._cb = CircuitBreaker(
            failure_threshold=failures,
            cooldown_s=cooldown_ms / 1e3,
            cooldown_max_s=cooldown_max_ms / 1e3, **kw)
        self.metrics = metrics
        self._last_opens = 0

    @property
    def enabled(self) -> bool:
        return self._cb.enabled

    def state(self) -> str:
        return self._cb.state()

    def check_admission(self) -> bool:
        """Raise :class:`CircuitOpen` while the circuit is open;
        otherwise admit, returning True when THIS request claimed the
        half-open probe slot (the batcher records it, and a probe that
        leaves the system without a batch outcome — deadline-shed,
        dropped at close — is handed back via :meth:`on_dropped` so the
        slot cannot wedge shut).  Called by ``MicroBatcher.submit`` as
        the LAST admission check before enqueue: still ahead of the
        queue (so rejected work never consumes capacity), but after
        every other rejection — a subsequent ``BacklogFull`` /
        ``DeadlineExceeded`` would leak the claimed probe.  The state
        gauge is updated only on rejections and batch outcomes (where
        transitions happen), keeping the common admitted path to one
        breaker lock acquisition."""
        admitted, probe = self._cb.try_acquire()
        if admitted:
            return probe
        if self.metrics is not None:
            self.metrics.counter("serve.breaker_rejected").inc()
        self._gauge()
        raise CircuitOpen(self._cb.retry_after_s() * 1e3, self._cb.opens)

    @staticmethod
    def counts(exc: BaseException) -> bool:
        """Whether a batch failure moves the breaker: infrastructure
        failures do, request-scoped input errors do not."""
        return not isinstance(exc, _REQUEST_SCOPED)

    def on_success(self) -> None:
        self._cb.record_success()
        self._gauge()

    def on_dropped(self) -> None:
        """An admitted probe request left the system without a batch
        outcome (deadline-shed before dispatch, dropped at close):
        release the slot so the next request probes immediately instead
        of a healthy device serving 503s for the whole abandoned-probe
        expiry."""
        self._cb.release_probe()
        self._gauge()

    def on_failure(self, exc: BaseException, probe: bool = False) -> None:
        if not self.counts(exc):
            # a request-scoped failure says nothing about the
            # infrastructure: a probe batch that dies of one must give
            # the slot back, not leave the circuit shut until expiry
            if probe:
                self.on_dropped()
            return
        self._cb.record_failure()
        if self.metrics is not None and self._cb.opens > self._last_opens:
            self.metrics.counter("serve.breaker_opens").inc(
                self._cb.opens - self._last_opens)
        self._last_opens = self._cb.opens
        self._gauge()

    def _gauge(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("serve.breaker_state").set(
                _STATE_GAUGE[self._cb.state()])

    def refresh_gauge(self) -> None:
        """Re-read the state into the gauge.  OPEN -> HALF_OPEN is a
        lazy clock transition with no event attached; a replica the LB
        stopped routing to would otherwise export ``open`` forever
        while /healthz (live describe) already says ``half_open`` —
        the metrics exporter calls this so dashboards and health can
        never disagree."""
        self._gauge()

    def describe(self) -> dict:
        return self._cb.describe()
