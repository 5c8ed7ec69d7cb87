"""Fault-tolerance primitives: retry/backoff, circuit breaker, watchdog,
atomic writes.

The JAX package's ``utils/resilience.py``, copied (it imports no JAX):

- :class:`RetryPolicy` / :func:`retry_call` / :func:`retry` — jittered
  exponential backoff with a hard deadline and an exception classifier
  (:func:`is_retryable_device_error`, the same message patterns):
  transient device-claim / backend-bring-up errors are retried,
  programming errors are not.  A CUDA launch fault (an illegal address,
  a refused launch, ``_kernels.KernelError``) matches none of the
  patterns, so a broken kernel fails loudly instead of being retried
  into silence.
- :class:`CircuitBreaker` — CLOSED/OPEN/HALF_OPEN state machine with
  exponentially backed-off half-open probes (serve/breaker.py maps it
  to admission-time rejects).
- :class:`Watchdog` — arms ``faulthandler`` stack dumps while a blocking
  device call (a CUDA synchronise, a kernel build) is in flight, or runs
  the call in a worker thread and raises at the deadline.
- :func:`atomic_write` — temp file in the target directory +
  ``os.replace``.

Not ported with it: the flight-recorder dumps the JAX package's
watchdog triggers (``obs/blackbox.py``, ROADMAP A15) and the
``snapshot_write`` / ``snapshot_kill`` fault-injection sites of
``atomic_write`` (``utils/faultinject.py``, ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
import faulthandler
import functools
import os
import random
import sys
import tempfile
import threading
import time
from typing import Callable, Optional


# ---------------------------------------------------------------------------
# Exception classification
# ---------------------------------------------------------------------------

# Message fragments of transient device-claim / backend-init / network
# failures (claim hangs, distributed heartbeats, gRPC status strings); the
# JAX package's list, unchanged.  Matched case-insensitively against
# str(exc).
_RETRYABLE_PATTERNS = (
    "unavailable",
    "deadline exceeded",
    "deadline_exceeded",
    "timed out",
    "timeout",
    "connection refused",
    "connection reset",
    "connection closed",
    "failed to connect",
    "socket closed",
    "stream removed",
    "resource exhausted",
    "aborted",
    "claim",
    "heartbeat",
    "coordination service",
    "barrier",
    "backend setup",
    "initialization failed",
)

# Never retried regardless of message: programming / environment errors a
# second attempt cannot fix, and control-flow exceptions.
_FATAL_TYPES = (KeyboardInterrupt, SystemExit, GeneratorExit, MemoryError,
                NotImplementedError, AssertionError, TypeError,
                AttributeError, KeyError, IndexError, ImportError,
                SyntaxError)


def is_retryable_device_error(exc: BaseException) -> bool:
    """Default classifier: True for transient device-claim / backend-init
    shaped failures, False for programming errors.  ValueError is fatal
    (bad arguments don't become good by waiting) EXCEPT LightGBMError
    subclasses are still checked by message — they wrap device errors."""
    if isinstance(exc, _FATAL_TYPES):
        return False
    if type(exc) is ValueError:
        return False
    msg = str(exc).lower()
    return any(p in msg for p in _RETRYABLE_PATTERNS)


# ---------------------------------------------------------------------------
# Retry with jittered exponential backoff + hard deadline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RetryPolicy:
    """Backoff schedule for :func:`retry_call`.

    max_attempts: total tries (1 = no retry).
    base_delay_s: backoff before the 2nd attempt; doubles per attempt.
    max_delay_s:  backoff cap.
    deadline_s:   hard wall-clock budget across ALL attempts (0 = none);
                  a retry that could not even START before the deadline
                  re-raises instead of sleeping.
    jitter:       fraction of each delay randomized (0..1): the slept
                  delay is uniform in [d*(1-jitter/2), d*(1+jitter/2)],
                  de-synchronizing a fleet of workers hammering one relay.
    """
    max_attempts: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 30.0
    deadline_s: float = 0.0
    jitter: float = 0.5


def retry_call(fn: Callable, *args, policy: Optional[RetryPolicy] = None,
               classify: Optional[Callable[[BaseException], bool]] = None,
               on_retry: Optional[Callable[[int, float, BaseException],
                                           None]] = None,
               label: str = "", **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying classified-transient
    failures under ``policy``.  ``on_retry(attempt, delay_s, exc)`` is
    invoked before each backoff sleep.
    The final failure is re-raised unmodified."""
    policy = policy or RetryPolicy()
    classify = classify or is_retryable_device_error
    name = label or getattr(fn, "__name__", "call")
    t0 = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except BaseException as e:
            if attempt >= max(1, policy.max_attempts) or not classify(e):
                raise
            delay = min(policy.max_delay_s,
                        policy.base_delay_s * (2.0 ** (attempt - 1)))
            if policy.jitter > 0:
                delay *= 1.0 + policy.jitter * (random.random() - 0.5)
            if policy.deadline_s > 0 and \
                    time.monotonic() - t0 + delay > policy.deadline_s:
                from .log import Log
                Log.warning(
                    f"{name}: retry deadline ({policy.deadline_s:g}s) "
                    f"exhausted after attempt {attempt}; giving up")
                raise
            from .log import Log
            Log.warning(
                f"{name}: attempt {attempt}/{policy.max_attempts} failed "
                f"({e}); retrying in {delay:.1f}s")
            if on_retry is not None:
                on_retry(attempt, delay, e)
            time.sleep(delay)


def retry(policy: Optional[RetryPolicy] = None, **retry_kwargs):
    """Decorator form of :func:`retry_call`::

        @retry(RetryPolicy(max_attempts=4))
        def claim(): ...
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            return retry_call(fn, *args, policy=policy, **retry_kwargs,
                              **kwargs)
        return wrapper
    return deco


# ---------------------------------------------------------------------------
# Circuit breaker: stop hammering a failing dependency
# ---------------------------------------------------------------------------

class CircuitBreaker:
    """Thread-safe CLOSED -> OPEN -> HALF_OPEN breaker.

    Retry/backoff (above) protects one CALL; the breaker protects the
    CALLER POPULATION: once ``failure_threshold`` consecutive failures
    are recorded the circuit opens and :meth:`allow` answers False —
    work is rejected up front instead of queuing onto a dependency that
    is down (the serve batcher maps this to an immediate 503, keeping
    the bounded queue free for traffic that can succeed).  After
    ``cooldown_s`` the circuit half-opens: :meth:`allow` admits ONE
    probe (further callers stay rejected — a burst arriving right at
    the cooldown boundary must not pile onto the still-unproven
    dependency; an abandoned probe expires after the current cooldown
    so a lost outcome cannot wedge the breaker); the probe's recorded
    outcome decides — success closes the circuit, failure re-opens it
    with the cooldown DOUBLED (capped at ``cooldown_max_s``), so a
    dependency that stays down is probed at a decaying rate rather
    than every cooldown.

    ``failure_threshold <= 0`` disables the breaker entirely (always
    allows, records nothing).  ``clock`` is injectable for tests.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 1.0,
                 cooldown_max_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = int(failure_threshold)
        # floored above zero: with cooldown 0 a tripped circuit is
        # instantly HALF_OPEN and the probe-expiry test always passes,
        # so EVERY caller becomes the probe and nothing is ever
        # rejected — the breaker would silently not exist
        self.cooldown_s = max(1e-3, float(cooldown_s))
        self.cooldown_max_s = max(self.cooldown_s, float(cooldown_max_s))
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0            # consecutive, while CLOSED
        self._open_until = 0.0
        self._cur_cooldown = self.cooldown_s
        self._probe_t: Optional[float] = None   # outstanding probe start
        self.opens = 0                # lifetime open transitions

    @property
    def enabled(self) -> bool:
        return self.failure_threshold > 0

    def state(self) -> str:
        """Current state, with the OPEN -> HALF_OPEN clock transition
        applied (reading the state can move it, like :meth:`allow`)."""
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if self._state == self.OPEN \
                and self._clock() >= self._open_until:
            self._state = self.HALF_OPEN
            self._probe_t = None
        return self._state

    def allow(self) -> bool:
        """Whether new work may proceed right now.  False while OPEN
        with the cooldown running, and in HALF_OPEN for everyone but
        the single probe (the first caller after the cooldown; a probe
        whose outcome never lands expires after the current cooldown)."""
        return self.try_acquire()[0]

    def try_acquire(self) -> "tuple[bool, bool]":
        """``(admitted, claimed_probe)`` — :meth:`allow`, additionally
        reporting whether THIS call claimed the half-open probe slot.
        A caller whose admitted work can leave the system without a
        recorded outcome (dropped, shed) must :meth:`release_probe`
        when that happens, or the breaker stays shut for the full
        abandoned-probe expiry on a possibly healthy dependency."""
        if not self.enabled:
            return True, False
        with self._lock:
            st = self._state_locked()
            if st == self.OPEN:
                return False, False
            if st == self.HALF_OPEN:
                now = self._clock()
                if self._probe_t is not None \
                        and now - self._probe_t < self._cur_cooldown:
                    return False, False
                self._probe_t = now
                return True, True
            return True, False

    def release_probe(self) -> None:
        """Give back a probe slot claimed by :meth:`try_acquire` whose
        work will never record an outcome (deadline-shed before
        dispatch, request-scoped failure): the next caller probes
        immediately instead of every caller waiting out the
        abandoned-probe expiry."""
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._probe_t = None

    def retry_after_s(self) -> float:
        """The Retry-After hint for rejected work: the remaining
        cooldown while OPEN, the remaining probe window while HALF_OPEN
        with a probe outstanding (callers rejected then must NOT retry
        immediately — that is exactly when traffic is being held back),
        0 otherwise."""
        with self._lock:
            return self._retry_after_locked()

    def _retry_after_locked(self) -> float:
        # the ONE computation of the hint: describe() must report the
        # same number CircuitOpen carries, or /healthz and the 503
        # body disagree about when to come back
        st = self._state_locked()
        now = self._clock()
        if st == self.OPEN:
            return max(0.0, self._open_until - now)
        if st == self.HALF_OPEN and self._probe_t is not None:
            return max(0.0, self._probe_t + self._cur_cooldown - now)
        return 0.0

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._state_locked()
            if st == self.HALF_OPEN:
                # probe succeeded: full reset, cooldown back to base
                self._state = self.CLOSED
                self._cur_cooldown = self.cooldown_s
                self._probe_t = None
            self._failures = 0

    def record_failure(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            st = self._state_locked()
            if st == self.HALF_OPEN:
                # failed probe: re-open with a doubled cooldown
                self._cur_cooldown = min(self.cooldown_max_s,
                                         self._cur_cooldown * 2.0)
                self._trip_locked()
            elif st == self.CLOSED:
                self._failures += 1
                if self._failures >= self.failure_threshold:
                    self._trip_locked()
            # already OPEN: late failures from in-flight work don't
            # extend the cooldown (they predate the trip)

    def _trip_locked(self) -> None:
        self._state = self.OPEN
        self._failures = 0
        self._open_until = self._clock() + self._cur_cooldown
        self._probe_t = None
        self.opens += 1

    def describe(self) -> dict:
        with self._lock:
            retry_after = self._retry_after_locked()
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "opens": self.opens,
                    "cooldown_s": self._cur_cooldown,
                    "retry_after_s": retry_after}


# ---------------------------------------------------------------------------
# Watchdog: faulthandler stack dumps for wedged blocking calls
# ---------------------------------------------------------------------------

class WatchdogTimeout(RuntimeError):
    """A blocking call guarded by :meth:`Watchdog.run` exceeded its
    deadline.  The message deliberately matches the resilience
    classifier's retryable patterns (``deadline exceeded``) so a hung
    collective/claim is retried — or handed to the elastic recovery
    ladder — like any other transient device failure."""

    def __init__(self, label: str, timeout_s: float):
        self.label = label
        self.timeout_s = timeout_s
        super().__init__(
            f"deadline exceeded: {label or 'blocking call'} still "
            f"running after {timeout_s:g}s (abandoned by watchdog)")


class Watchdog:
    """Context manager arming periodic ``faulthandler`` stack dumps while
    a blocking device call is in flight::

        with Watchdog(cfg.dist_init_timeout_s, label="device sync"):
            torch.cuda.synchronize()

    If the call exceeds ``timeout_s`` the interpreter dumps every
    thread's stack to stderr (repeating each ``timeout_s``), which
    makes a hang loud and attributable.  ``timeout_s <= 0`` disables.

    **Cancel-and-raise mode** (``on_timeout="raise"``): :meth:`run`
    executes the guarded call in a daemon worker thread and, at the
    deadline, raises :class:`WatchdogTimeout` in the WAITING thread —
    the hung C call itself cannot be interrupted (a wedged collective
    blocks in the runtime), so the worker is abandoned and the caller
    gets a classified, retryable exception instead of a silent hang.
    The all-thread stack dump fires synchronously at the deadline, so
    the post-mortem survives the abandonment.  The default
    (``on_timeout="dump"``) keeps the dump-only behavior: :meth:`run`
    calls the function inline under the context manager and never
    raises on its own.

    ``faulthandler``'s later-dump timer is process-global: nesting
    dump-mode Watchdogs (or combining with pytest's per-test dump)
    leaves the innermost exit having cancelled the outer timer.
    Acceptable for the bring-up call sites the CONTEXT MANAGER guards —
    they do not nest.  Raise-mode :meth:`run` deliberately never
    touches that timer (it dumps synchronously at the deadline
    instead): a caller that runs once per iteration would otherwise
    cancel any ambient hang dump (e.g. a test runner's per-test
    watchdog) on every single call.
    """

    def __init__(self, timeout_s: float, label: str = "",
                 file=None, on_timeout: str = "dump") -> None:
        if on_timeout not in ("dump", "raise"):
            raise ValueError(
                f"on_timeout must be 'dump' or 'raise', got {on_timeout!r}")
        self.timeout_s = float(timeout_s)
        self.label = label
        self.file = file
        self.on_timeout = on_timeout

    def __enter__(self) -> "Watchdog":
        if self.timeout_s > 0:
            faulthandler.dump_traceback_later(
                self.timeout_s, repeat=True,
                file=self.file if self.file is not None else sys.stderr)
            from .log import Log
            Log.debug(f"watchdog armed ({self.timeout_s:g}s) around "
                      f"{self.label or 'blocking call'}")
        return self

    def __exit__(self, *exc) -> None:
        if self.timeout_s > 0:
            faulthandler.cancel_dump_traceback_later()

    def run(self, fn: Callable, *args, **kwargs):
        """Call ``fn(*args, **kwargs)`` under this watchdog.

        ``on_timeout="dump"`` (default): inline call inside the context
        manager — stack dumps at the deadline, no exception, identical
        to ``with Watchdog(...): fn()``.

        ``on_timeout="raise"``: the call runs in a daemon worker
        thread; if it has not finished after ``timeout_s`` the waiting
        thread dumps every thread's stack + the live flight recorders
        synchronously, raises :class:`WatchdogTimeout`, and the worker
        is abandoned — it keeps whatever it was wedged on, like a real
        hung collective, and its eventual result (or exception) is
        discarded.  ``timeout_s <= 0`` always runs inline (no
        deadline)."""
        if self.timeout_s <= 0 or self.on_timeout == "dump":
            with self:
                return fn(*args, **kwargs)
        box: dict = {}
        done = threading.Event()

        def _worker():
            try:
                box["value"] = fn(*args, **kwargs)
            except BaseException as e:      # noqa: BLE001 — relayed below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(target=_worker, daemon=True,
                             name=f"watchdog:{self.label or 'call'}")
        t.start()
        if not done.wait(self.timeout_s):
            # deadline: post-mortem NOW (all-thread stacks),
            # synchronously in this thread — NOT via the
            # process-global dump_traceback_later timer, which per-call
            # arm/cancel would silently disable any ambient hang dump
            # (conftest's per-test watchdog) for raise-mode callers that
            # run once per training iteration
            faulthandler.dump_traceback(
                file=self.file if self.file is not None else sys.stderr,
                all_threads=True)
            from .log import Log
            Log.warning(f"watchdog: {self.label or 'blocking call'} "
                        f"abandoned after {self.timeout_s:g}s deadline")
            raise WatchdogTimeout(self.label, self.timeout_s)
        if "error" in box:
            raise box["error"]
        return box["value"]


# ---------------------------------------------------------------------------
# Atomic file writes (temp + os.replace)
# ---------------------------------------------------------------------------

def atomic_write(path, data, binary: bool = False) -> None:
    """Write ``data`` to ``path`` atomically: temp file in the TARGET
    directory (``os.replace`` requires same-filesystem), fsync, rename.
    A crash at any point leaves either the old file or the new file —
    never a truncated hybrid.  Creates missing parent directories."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d,
                               prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        # text mode pins utf-8: readers (Booster model load, manifest
        # json) decode utf-8, and a locale-dependent write encoding
        # would break the byte checksums recorded over these files
        with os.fdopen(fd, "wb" if binary else "w",
                       encoding=None if binary else "utf-8") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, path)
