"""Micro-batching request queue with bounded backpressure (the JAX
package's ``serve/batcher.py``, copied).

One worker thread coalesces concurrent prediction requests into device
batches: the first queued request opens a window of ``max_wait_ms``;
everything that arrives before the window closes (or before the batch
reaches ``max_batch`` rows) rides the same traversal.  The queue is
BOUNDED in rows — when ``queue_rows`` of work is already pending,
``submit`` rejects immediately with :class:`BacklogFull` carrying a
``retry_after_ms`` estimate instead of growing without bound (the
explicit reject-with-retry-after discipline; HTTP maps it to 429 +
``Retry-After``).  Transient device errors retry through
``utils/resilience.RetryPolicy``; non-transient errors fail only the
requests of the batch that hit them.

Hardening (docs/Serving.md "Hardening"): per-request DEADLINES
(``deadline_ms`` / ``default_deadline_ms``) are enforced before any
device work — fail-fast at admission when the queue's estimated wait
already blows the deadline, and load-shedding at dispatch for requests
whose deadline lapsed while queued (:class:`DeadlineExceeded`).  An
optional CIRCUIT BREAKER (serve/breaker.py) rejects at admission while
the device side is failing; batch outcomes feed it from ``_dispatch``.
``begin_drain`` / ``wait_idle`` give graceful shutdown: queued work
finishes, new work is refused with :class:`BatcherDraining`.

Metrics (when a registry is attached): ``serve.queue_depth`` gauge
(rows), ``serve.batch_rows`` / ``serve.batch_occupancy`` /
``serve.latency`` histograms, ``serve.requests`` / ``serve.rows`` /
``serve.rejected`` / ``serve.errors`` / ``serve.deadline_rejected`` /
``serve.deadline_shed`` counters (breaker: ``serve.breaker_*``), plus
a ``serve.batch`` span per dispatched batch on the tracer, when one is
given (the port's ``Server`` gives none: tracing is ROADMAP A15).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional

import numpy as np

from ..utils.resilience import (RetryPolicy, is_retryable_device_error,
                                retry_call)


class BacklogFull(RuntimeError):
    """Queue is at capacity; retry after ``retry_after_ms``."""

    def __init__(self, retry_after_ms: float, depth_rows: int):
        super().__init__(
            f"serve queue full ({depth_rows} rows pending); "
            f"retry in ~{retry_after_ms:.0f} ms")
        self.retry_after_ms = float(retry_after_ms)
        self.depth_rows = int(depth_rows)


class BatcherClosed(RuntimeError):
    """The batcher was shut down before this request completed."""


class BatcherDraining(BatcherClosed):
    """The batcher is draining (graceful shutdown): queued work will
    finish, new work is refused."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before it could be served.

    Raised in two places, both BEFORE any device work is spent on the
    doomed request: at admission, when the queue's estimated wait
    already exceeds the deadline (fail fast instead of queuing work the
    client will have abandoned), and at dispatch, when a queued
    request's deadline lapsed while it waited (load shedding — the
    batch traverses only rows someone is still waiting for)."""

    def __init__(self, deadline_ms: float, waited_ms: float,
                 where: str = "queue"):
        super().__init__(
            f"deadline of {deadline_ms:.0f} ms exceeded in {where} "
            f"(waited {waited_ms:.0f} ms)")
        self.deadline_ms = float(deadline_ms)
        self.waited_ms = float(waited_ms)
        self.where = where


class PredictionFuture:
    """Handle for one submitted request; ``result()`` blocks."""

    __slots__ = ("_event", "_value", "_exc", "info", "t_submit",
                 "deadline")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None
        self.info: dict = {}
        self.t_submit = time.perf_counter()
        self.deadline: Optional[float] = None   # absolute perf_counter

    def _set(self, value, info: Optional[dict] = None) -> None:
        self._value = value
        if info:
            self.info = info
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("prediction did not complete in time")
        if self._exc is not None:
            raise self._exc
        return self._value


class _Item:
    __slots__ = ("rows", "future", "probe", "key")

    def __init__(self, rows: np.ndarray, future: PredictionFuture,
                 probe: bool = False, key=None):
        self.rows = rows
        self.future = future
        # this request claimed the breaker's half-open probe slot: if it
        # leaves without a batch outcome the slot must be released
        self.probe = probe
        # routing key (e.g. a fleet segment): requests with different
        # keys never share a batch — each key may resolve to a
        # different model
        self.key = key


class MicroBatcher:
    """Coalesce concurrent requests into bounded device batches.

    ``predict_fn(rows) -> (outputs, info)``: outputs is an array whose
    leading axis matches ``rows`` (sliced back per request), ``info`` a
    small dict attached to every future of the batch (model version
    etc.); a plain-array return is also accepted.

    Lock contract: ``_lock`` guards ``_queue``, ``_depth_rows``,
    ``_closed``, ``_draining``, ``_inflight`` and ``_ewma_batch_s``.

    ``_wake`` is a Condition over ``_lock`` (one mutex).  The breaker
    is called both under ``_lock`` (admission, shed) and outside it
    (batch outcomes) — legal because the breaker's own lock is
    leaf-level and never calls back into the batcher.
    ``batches_dispatched`` is written by the worker thread only.
    """

    # how far before the earliest queued deadline the coalescing window
    # closes: absorbs condition-wakeup + collect latency so the request
    # dispatches while still inside its deadline rather than being shed
    # microseconds past it
    _DISPATCH_MARGIN_S = 0.005

    def __init__(self, predict_fn: Callable, *, max_batch: int = 1024,
                 max_wait_ms: float = 2.0, queue_rows: int = 8192,
                 retry_policy: Optional[RetryPolicy] = None,
                 default_deadline_ms: float = 0.0, breaker=None,
                 metrics=None, tracer=None):
        self.predict_fn = predict_fn
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1e3
        self.queue_rows = max(self.max_batch, int(queue_rows))
        self.retry_policy = retry_policy
        self.default_deadline_ms = max(0.0, float(default_deadline_ms))
        self.breaker = breaker
        self.metrics = metrics
        self.tracer = tracer
        self._queue: List[_Item] = []
        self._depth_rows = 0
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        self._draining = False
        self._inflight = False
        self.batches_dispatched = 0
        # EWMA of observed per-batch service time (seconds), written by
        # the worker after each batch and read by submit — both under
        # _lock; 0 until the first batch completes
        self._ewma_batch_s = 0.0
        self._worker = threading.Thread(target=self._run,
                                        name="lgbtorch-serve-batcher",
                                        daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------
    def submit(self, rows: np.ndarray,
               deadline_ms: Optional[float] = None,
               key=None) -> PredictionFuture:
        """Enqueue one request; raises :class:`BacklogFull` when the
        bounded queue cannot take it, :class:`CircuitOpen` while the
        serving circuit is open, and :class:`DeadlineExceeded` when the
        queue's estimated wait already exceeds ``deadline_ms`` (which
        defaults to ``default_deadline_ms``; <= 0 means no deadline).
        A 1-D vector is one row; anything not coercible to a 2-D array
        is rejected HERE, where the error reaches only the offending
        caller — malformed rows must never travel into a shared batch
        where they would poison the other requests riding it."""
        rows = np.asarray(rows)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        if rows.ndim != 2:
            raise ValueError(f"rows must be 2-D, got {rows.ndim}-D")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline_ms = float(deadline_ms)
        n = len(rows)
        fut = PredictionFuture()
        if deadline_ms > 0:
            fut.deadline = fut.t_submit + deadline_ms / 1e3
        with self._lock:
            if self._closed:
                raise BatcherClosed("batcher is closed")
            if self._draining:
                raise BatcherDraining("batcher is draining")
            pending_batches = -(-self._depth_rows // self.max_batch)
            window_ms = pending_batches * max(
                self.max_wait_ms_effective(), 1.0)
            # the wait estimate: measured per-batch service time once
            # any batch has completed (full batches dispatch on FILL,
            # so the coalescing window is not a wait floor for them —
            # a drained-in-1ms queue must not 504 a 5ms deadline), the
            # window heuristic until then (cold start: reject on the
            # only signal there is)
            ewma_ms = self._ewma_batch_s * 1e3
            est_wait_ms = pending_batches * ewma_ms if ewma_ms > 0 \
                else window_ms
            if self._depth_rows + n > self.queue_rows and self._queue:
                if self.metrics is not None:
                    self.metrics.counter("serve.rejected").inc()
                raise BacklogFull(max(est_wait_ms, window_ms),
                                  self._depth_rows)
            if fut.deadline is not None and self._queue \
                    and est_wait_ms > deadline_ms:
                # the estimated wait already blows the deadline: fail
                # fast instead of queuing work the client will have
                # abandoned
                if self.metrics is not None:
                    self.metrics.counter("serve.deadline_rejected").inc()
                raise DeadlineExceeded(deadline_ms, 0.0,
                                       where="admission")
            probe = False
            if self.breaker is not None:
                # LAST admission check, after every other rejection:
                # check_admission in HALF_OPEN claims the single probe
                # slot, and a later BacklogFull/DeadlineExceeded would
                # leak it — rejecting ALL traffic for a full (possibly
                # doubled) cooldown on an already-healthy device.  Still
                # before enqueue: breaker-rejected work never consumes
                # queue capacity or waits out a doomed retry cycle
                probe = self.breaker.check_admission()
            self._queue.append(_Item(rows, fut, probe=probe, key=key))
            self._depth_rows += n
            if self.metrics is not None:
                self.metrics.gauge("serve.queue_depth").set(
                    self._depth_rows)
            self._wake.notify()
        return fut

    def max_wait_ms_effective(self) -> float:
        return self.max_wait_s * 1e3

    @property
    def depth_rows(self) -> int:
        with self._lock:
            return self._depth_rows

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining and not self._closed

    def begin_drain(self) -> None:
        """Stop accepting work (``submit`` raises
        :class:`BatcherDraining`) while the worker keeps draining what
        is already queued.  Reversible shutdown prologue: the batcher
        itself stays alive until :meth:`close`."""
        with self._lock:
            self._draining = True
            self._wake.notify_all()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until the queue is empty AND no batch is in flight;
        False if ``timeout`` elapsed first.  With :meth:`begin_drain`
        active this is "drained": every accepted request has been
        answered."""
        end = None if timeout is None else time.perf_counter() + timeout
        with self._lock:
            while self._queue or self._inflight:
                left = None if end is None \
                    else end - time.perf_counter()
                if left is not None and left <= 0:
                    return False
                self._wake.wait(left)
            return True

    def close(self, timeout: float = 5.0) -> None:
        """Graceful shutdown: new submissions are rejected immediately,
        already-queued work drains, and only requests the worker could
        not drain within ``timeout`` fail with :class:`BatcherClosed`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._draining = True
            self._wake.notify_all()
        self._worker.join(timeout)
        with self._lock:
            leftovers, self._queue = self._queue, []
            self._depth_rows = 0
        for item in leftovers:
            if item.probe and self.breaker is not None:
                self.breaker.on_dropped()
            item.future._set_exception(BatcherClosed("batcher closed"))

    # -- worker side -------------------------------------------------------
    def _collect(self) -> List[_Item]:
        """Block for the next batch: wait for a first request, then hold
        the window open until ``max_wait_s`` passes or ``max_batch``
        rows are in hand.  An oversized single request becomes its own
        batch (the engine chunks internally).  Requests whose deadline
        lapsed while queued are shed here — failed with
        :class:`DeadlineExceeded` instead of riding the batch, so
        device time goes only to rows someone is still waiting for."""
        expired: List[_Item] = []
        with self._lock:
            while not self._queue and not self._closed:
                self._wake.wait()
            if not self._queue:
                return []
            # the window never holds past a queued request's deadline:
            # close it early (margin covers wakeup + collect latency)
            # and dispatch, instead of sleeping the full coalescing
            # window and then shedding work the window itself doomed.
            # Each arrival notifies and may carry a tighter deadline —
            # but the worker is the ONLY popper and it is here, so the
            # queue is append-only for the duration of the window and
            # each pass need only fold in the arrivals since the last
            # (O(1) amortized per request, not O(queue) per wakeup)
            end = self._queue[0].future.t_submit + self.max_wait_s
            have = 0
            scanned = 0
            while not self._closed:
                for item in self._queue[scanned:]:
                    have += len(item.rows)
                    d = item.future.deadline
                    if d is not None:
                        end = min(end, d - self._DISPATCH_MARGIN_S)
                scanned = len(self._queue)
                if have >= self.max_batch:
                    break
                left = end - time.perf_counter()
                if left <= 0:
                    break
                self._wake.wait(left)
            batch: List[_Item] = []
            rows = 0
            now = time.perf_counter()
            while self._queue:
                head = self._queue[0]
                if head.future.deadline is not None \
                        and now > head.future.deadline:
                    self._queue.pop(0)
                    self._depth_rows -= len(head.rows)
                    expired.append(head)
                    continue
                nxt = len(head.rows)
                if batch and (rows + nxt > self.max_batch
                              or head.rows.shape[1]
                              != batch[0].rows.shape[1]
                              or head.key != batch[0].key):
                    # width mismatch (a request sized for a different
                    # model width) or a different routing key (a
                    # request bound for a different model): never
                    # concatenated into this batch — it opens the NEXT
                    # batch and fails alone if invalid
                    break
                item = self._queue.pop(0)
                batch.append(item)
                rows += nxt
            self._depth_rows -= rows
            if expired:
                # shed futures are failed BEFORE the all-shed wakeup
                # below: wait_idle returning True means every accepted
                # request has been ANSWERED, not merely dequeued — a
                # drain caller must never observe "drained" while shed
                # clients still block in result().  (Holding the lock
                # here is fine: _set_exception only sets an Event, and
                # breaker calls under the batcher lock are the
                # established submit-side ordering.)
                if self.metrics is not None:
                    self.metrics.counter("serve.deadline_shed").inc(
                        len(expired))
                for item in expired:
                    if item.probe and self.breaker is not None:
                        # a shed probe never reaches _dispatch: release
                        # the slot or the breaker stays shut until
                        # expiry
                        self.breaker.on_dropped()
                    f = item.future
                    f._set_exception(DeadlineExceeded(
                        (f.deadline - f.t_submit) * 1e3,
                        (now - f.t_submit) * 1e3, where="queue"))
            if batch:
                self._inflight = True
            elif expired:
                # everything collected this round was shed: no dispatch
                # will follow, so wake wait_idle() here — otherwise a
                # drain whose last round is all-expired sleeps out its
                # full budget
                self._wake.notify_all()
            if self.metrics is not None:
                self.metrics.gauge("serve.queue_depth").set(
                    self._depth_rows)
        return batch

    def _record_service_time(self, t0: float) -> None:
        # failed batches count too: their (retry-inflated) duration is
        # exactly what the next queued request will wait through
        dur = time.perf_counter() - t0
        with self._lock:        # submit reads the EWMA under the lock
            prev = self._ewma_batch_s
            self._ewma_batch_s = dur if prev == 0.0 \
                else 0.25 * dur + 0.75 * prev

    def _dispatch(self, batch: List[_Item]) -> None:
        n = sum(len(i.rows) for i in batch)
        t0 = time.perf_counter()
        span = (self.tracer.span("serve.batch", rows=n,
                                 requests=len(batch))
                if self.tracer is not None else None)
        try:
            # concatenation INSIDE the guarded region: any surviving
            # shape surprise fails this batch's futures, never the
            # worker thread
            rows = (batch[0].rows if len(batch) == 1
                    else np.concatenate([i.rows for i in batch], axis=0))
            if batch[0].key is not None:
                # keyed batch: the whole batch shares one routing key
                # (collect never mixes keys), delivered to predict_fn
                # so it can resolve the routed model
                out = retry_call(self.predict_fn, rows, batch[0].key,
                                 policy=self.retry_policy,
                                 classify=is_retryable_device_error,
                                 label="serve.predict")
            else:
                out = retry_call(self.predict_fn, rows,
                                 policy=self.retry_policy,
                                 classify=is_retryable_device_error,
                                 label="serve.predict")
            outputs, info = out if isinstance(out, tuple) else (out, {})
            outputs = np.asarray(outputs)
        except BaseException as e:
            self._record_service_time(t0)
            if span is not None:
                span.end()
            if self.metrics is not None:
                self.metrics.counter("serve.errors").inc(len(batch))
            if self.breaker is not None:
                self.breaker.on_failure(
                    e, probe=any(i.probe for i in batch))
            for item in batch:
                item.future._set_exception(e)
            return
        self._record_service_time(t0)
        if span is not None:
            span.end()
        if self.breaker is not None:
            self.breaker.on_success()
        self.batches_dispatched += 1
        now = time.perf_counter()
        if self.metrics is not None:
            self.metrics.counter("serve.requests").inc(len(batch))
            self.metrics.counter("serve.rows").inc(n)
            self.metrics.histogram("serve.batch_rows").observe(n)
            self.metrics.histogram("serve.batch_occupancy").observe(
                min(1.0, n / self.max_batch))
            for item in batch:
                self.metrics.histogram("serve.latency").observe(
                    now - item.future.t_submit)
        lo = 0
        for item in batch:
            hi = lo + len(item.rows)
            item.future._set(outputs[lo:hi], dict(info))
            lo = hi

    def _run(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                with self._lock:
                    if self._closed:
                        return
                continue
            try:
                self._dispatch(batch)
            except BaseException as e:       # noqa: BLE001 — the worker
                # must outlive ANY single batch; _dispatch already fails
                # the batch's own futures, this is the last-ditch belt
                for item in batch:
                    if not item.future.done():
                        item.future._set_exception(e)
            finally:
                with self._lock:
                    self._inflight = False
                    self._wake.notify_all()     # wake wait_idle()
