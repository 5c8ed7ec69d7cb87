"""Serving frontends: in-process ``Server`` API + stdlib HTTP endpoint
(the JAX package's ``serve/server.py``).

``Server`` wires the subsystem together: a :class:`~.registry.ModelRegistry`
(initial model from a ``Booster``, a model file or a model string), a
:class:`~.batcher.MicroBatcher` sized by the ``serve_*`` config params,
and a :class:`~..obs.metrics.MetricsRegistry` for the ``serve.*``
metrics (host-side counters, no device syncs).

Predictions go through ``Booster.predict`` of the batch's resolved model
version — which itself routes through the bucketed
:class:`~.engine.PredictorEngine` (the walk on the card by kernel B10a) —
so serve results are byte-identical to a direct ``Booster.predict`` call
on the same rows, micro-batch coalescing included.  With
``serve_device_binning`` the batch instead rides the engine's fused
device-resident kernel (``fused_predict``, B10c: one launch, one fetch);
models the fused path cannot serve (or that failed the self-check gate)
demote to the host walk, counted in ``serve.host_fallback_batches``.
The engine and the loaded boosters run on the server's ``device_type``
(the card unless ``device_type=cpu``).

``start_http`` exposes the same Server over a stdlib-only
``ThreadingHTTPServer``:

- ``POST /predict``  ``{"rows": [[...], ...], "deadline_ms": ...}`` ->
  ``{"predictions": ..., "model_version": ..., "num_rows": ...}``;
  429 + ``Retry-After`` on backpressure, 503 + ``Retry-After`` while
  the circuit breaker is open, 504 past the deadline, 503 while
  draining, 400 on malformed input.
- ``POST /reload``   ``{"model_file": ...}`` (or ``"model_str"``,
  optional ``"sha256"`` to pin the artifact) -> hot swap, in-flight
  requests finish on the old version; 409 on checksum mismatch (the
  current version keeps serving).
- ``POST /drain``    graceful shutdown prologue: refuse new work,
  finish queued work within ``serve_drain_s``; ``/healthz`` flips to
  503 so load balancers stop routing here.
- ``GET /healthz``   readiness + current model version + queue depth +
  breaker state: 200 while ``ok``/``degraded``, 503 when draining or
  model-less.
- ``GET /metrics``   deterministic JSON metrics snapshot
  (``serve.latency`` quantiles included) + the engine's bucket and
  launch stats; ``?format=prom`` for the Prometheus text exposition.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP item
when asked for: telemetry sessions and the flight recorder
(``telemetry``, ``telemetry_blackbox``: ``obs``, A15), serving from
training snapshots (``resume``, ``POST /reload`` with ``"snapshot"``:
``snapshot.py``, A12), gated promotion and the freshness report
(``promote``, ``POST /promote``, ``GET /freshness``:
``pipeline/continual.py``, A17) and the chaos sites
(``utils/faultinject.py``, A12).  The JAX package's persistent XLA
compile cache (``utils/compile_cache.py``) has no counterpart: CUDA
kernels are built once per checkout (``_kernels.py``), so ``Server``
makes no such call, and ``/metrics`` carries no compile counters and no
``perf.forest.*`` roofline join (``obs/flops.py``, A15).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..basic import LightGBMError
from ..config import Config
from ..fleet.router import SegmentRouter
from ..obs.metrics import Histogram, MetricsRegistry, prometheus_text
from ..utils.log import Log
from ..utils.resilience import RetryPolicy, Watchdog, WatchdogTimeout
from .batcher import (BacklogFull, BatcherClosed, DeadlineExceeded,
                      MicroBatcher)
from .breaker import CircuitOpen, ServeBreaker
from .registry import ArtifactVerificationError, ModelRegistry, NoModelError


class Server:
    """Long-lived in-process prediction service.

    Thread topology: HTTP handler threads (ThreadingHTTPServer) call
    ``submit``/``reload``/``health``/``metrics_snapshot`` concurrently;
    the batcher worker thread calls ``_predict_batch``.  Kernels launch
    from the worker thread, on its current stream.

    Lock contract: ``_lock`` guards ``_closed`` and ``_seg_labels``."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 booster=None, model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.config = params if isinstance(params, Config) \
            else Config(params or {})
        cfg = self.config
        if cfg.telemetry or cfg.telemetry_blackbox:
            raise NotImplementedError(
                "serving telemetry sessions and the flight recorder need "
                "obs/, which is not ported to lightgbm_torch yet "
                "(ROADMAP A15)")
        self.metrics = MetricsRegistry()
        self.registry = ModelRegistry(
            max_batch=cfg.serve_max_batch,
            min_bucket=cfg.serve_min_bucket,
            verify_artifacts=cfg.serve_verify_artifacts,
            device_binning=cfg.serve_device_binning,
            packed=cfg.serve_packed_tables,
            max_resident=cfg.serve_max_resident,
            device_type=cfg.device_type)
        self._lock = threading.Lock()
        # segment -> version routing over the co-resident registry:
        # per-request ``segment`` keys resolve here; unknown keys fall
        # back to the default segment
        self.router = SegmentRouter(cfg.serve_default_segment)
        # distinct segment labels already granted their own metric
        # series (bounded by serve_metrics_max_versions; _seg_label)
        self._seg_labels: set = set()
        model_file = model_file or (cfg.input_model or None)
        if booster is not None or model_file or model_str:
            self.registry.load(model_file=model_file,
                               model_str=model_str, booster=booster)
        elif cfg.resume and cfg.output_model:
            self.registry.load_snapshot(cfg.output_model)
        self.breaker = ServeBreaker(
            failures=cfg.serve_breaker_failures,
            cooldown_ms=cfg.serve_breaker_cooldown_ms,
            metrics=self.metrics) \
            if cfg.serve_breaker_failures > 0 else None
        self.batcher = MicroBatcher(
            self._predict_batch,
            max_batch=cfg.serve_max_batch,
            max_wait_ms=cfg.serve_max_wait_ms,
            queue_rows=cfg.serve_queue_rows,
            # serve-scaled backoff: the bring-up defaults (1 s base)
            # would stall the single worker for seconds on a path whose
            # latency budget is serve_max_wait_ms
            retry_policy=RetryPolicy(
                max_attempts=max(1, cfg.serve_retries + 1),
                base_delay_s=0.02, max_delay_s=0.25),
            default_deadline_ms=cfg.serve_deadline_ms,
            breaker=self.breaker,
            metrics=self.metrics)
        self._t0 = time.time()
        self._closed = False

    # -- batch execution (worker thread) -----------------------------------
    def _resolve_served(self, segment):
        """The ServedModel for a batch's routing key: the router maps
        ``segment`` to a registry version (default-segment fallback for
        unknown keys); an unrouted/evicted resolution serves the
        registry's current model.  ``segment=None`` (unkeyed request)
        is exactly the pre-fleet path."""
        if segment is None:
            return self.registry.current()
        ver, fell_back = self.router.resolve(segment)
        if fell_back:
            self.metrics.counter("serve.segment_fallbacks").inc()
        if ver is None:
            return self.registry.current()
        try:
            return self.registry.get(ver)
        except KeyError:
            # the routed version was unloaded/evicted underneath the
            # assignment: drop the stale routes and serve current —
            # a routing gap degrades to the default model, never a 500
            for seg in self.router.drop_version(ver):
                Log.warning(f"serve: segment {seg!r} pointed at "
                            f"unloaded model {ver}; rerouting to "
                            "default")
            self.metrics.counter("serve.segment_fallbacks").inc()
            return self.registry.current()

    def _seg_label(self, segment) -> str:
        """Bounded-cardinality metric label for a segment: the first
        ``serve_metrics_max_versions`` distinct segments keep their own
        label; the rest aggregate under ``__other__`` so an unbounded
        key space cannot bloat the exposition."""
        cap = self.config.serve_metrics_max_versions
        if cap <= 0:
            return "__other__"
        s = str(segment)
        with self._lock:
            if s in self._seg_labels:
                return s
            if len(self._seg_labels) < cap:
                self._seg_labels.add(s)
                return s
        return "__other__"

    def _predict_batch(self, rows: np.ndarray,
                       segment=None) -> Tuple[np.ndarray, dict]:
        served = self._resolve_served(segment)  # resolved per batch:
        # requests already in this batch finish on it even if a reload or
        # segment reassignment lands now
        served.begin_request()             # residency-cap eviction
        # skips versions with requests in flight (registry.py)
        try:
            if self.config.serve_device_binning:
                eng = served.engine
                if eng is not None and eng.fused_reason is None:
                    # device-resident fast path: ONE kernel (bin -> walk
                    # -> accumulate), the transform on the device, one
                    # fetch (the final scores)
                    out = eng.fused_predict(rows)
                    self.metrics.counter("serve.fused_batches").inc()
                else:
                    # demoted (a failed self-check discarded the engine)
                    # or fused-incapable (linear trees, f32-inexact
                    # categories): the always-correct host walk serves
                    self.metrics.counter(
                        "serve.host_fallback_batches").inc()
                    out = served.booster.predict(rows)
            else:
                out = served.booster.predict(rows)
        finally:
            served.end_request()
        info = {"model_version": served.version}
        if segment is not None:
            info["segment"] = str(segment)
            self.metrics.counter(
                "serve.segment_rows",
                segment=self._seg_label(segment)).inc(len(rows))
        return np.asarray(out), info

    # -- client surface ----------------------------------------------------
    def predict(self, rows, timeout: Optional[float] = None,
                deadline_ms: Optional[float] = None,
                segment: Optional[str] = None) -> np.ndarray:
        """Predict through the micro-batching queue; blocks for the
        result.  Raises :class:`~.batcher.BacklogFull` under
        backpressure, :class:`~.breaker.CircuitOpen` while the breaker
        is open, :class:`~.batcher.DeadlineExceeded` past the
        deadline.  ``segment`` routes to that segment's promoted model
        version (fleet serving; unknown keys fall back to the default
        segment)."""
        return self.submit(rows, deadline_ms=deadline_ms,
                           segment=segment).result(timeout)

    def submit(self, rows, deadline_ms: Optional[float] = None,
               segment: Optional[str] = None):
        """Enqueue and return the :class:`PredictionFuture` (the
        non-blocking form of :meth:`predict`).  ``deadline_ms``
        overrides the ``serve_deadline_ms`` default for this request;
        ``segment`` is the fleet routing key — requests with different
        segments never share a device batch (they may resolve to
        different models)."""
        return self.batcher.submit(
            np.asarray(rows, np.float64), deadline_ms=deadline_ms,
            key=None if segment is None else str(segment))

    def reload(self, model_file: Optional[str] = None,
               model_str: Optional[str] = None, booster=None,
               snapshot: Optional[str] = None,
               expected_sha256: Optional[str] = None,
               version: Optional[str] = None) -> str:
        """Load a new model version and atomically swap it in; returns
        the new version id (auto-assigned unless ``version`` names
        one).  A failed load (unreadable file, checksum mismatch,
        injected fault) leaves the current version serving and counts
        ``serve.reload_failures``."""
        try:
            if snapshot is not None:
                version = self.registry.load_snapshot(
                    snapshot, version=version,
                    expected_sha256=expected_sha256)
            else:
                version = self.registry.load(
                    model_file=model_file, model_str=model_str,
                    booster=booster, expected_sha256=expected_sha256,
                    version=version)
        except BaseException:
            self.metrics.counter("serve.reload_failures").inc()
            raise
        Log.info(f"serve: activated model {version}")
        return version

    # -- continual surface (ROADMAP A17) -----------------------------------
    def promote(self, *args, **kwargs):
        """Gated promotion: needs ``pipeline/continual.py``, not ported
        yet."""
        raise NotImplementedError(
            "gated promotion needs pipeline/continual.py, which is not "
            "ported to lightgbm_torch yet (ROADMAP A17)")

    def shadow_batches(self):
        """The live-batch ring of the shadow-parity promotion gate: needs
        ``pipeline/continual.py``, not ported yet."""
        raise NotImplementedError(
            "shadow gating needs pipeline/continual.py, which is not "
            "ported to lightgbm_torch yet (ROADMAP A17)")

    def freshness(self) -> dict:
        """The staleness report of continual training: needs
        ``pipeline/continual.py``, not ported yet."""
        raise NotImplementedError(
            "the freshness report needs pipeline/continual.py, which is "
            "not ported to lightgbm_torch yet (ROADMAP A17)")

    # -- lifecycle ---------------------------------------------------------
    @property
    def draining(self) -> bool:
        return self.batcher.draining

    def drain(self, timeout_s: Optional[float] = None) -> dict:
        """Graceful shutdown prologue: refuse new work, finish what is
        queued (bounded by ``timeout_s``, default ``serve_drain_s``),
        report the outcome.  The server stays alive (health answers,
        metrics export) until :meth:`close` — the LB-friendly sequence
        is drain, observe ``/healthz`` flip to 503, then close."""
        try:
            timeout_s = self.config.serve_drain_s if timeout_s is None \
                else float(timeout_s)
        except (TypeError, ValueError):
            timeout_s = self.config.serve_drain_s
        self.batcher.begin_drain()
        if timeout_s > 0:
            # the drain budget is enforced by the resilience watchdog's
            # cancel-and-raise mode (the same deadline machinery the
            # elastic collective timeout uses): a drain that wedges —
            # e.g. an in-flight batch stuck in a hung device call, so
            # the idle condition can never fire — dumps all-thread
            # stacks and raises in THIS thread instead of hanging
            # shutdown; the abandoned waiter is harmless (daemon,
            # wakes into a discarded result)
            try:
                drained = Watchdog(
                    timeout_s, label="serve drain",
                    on_timeout="raise").run(self.batcher.wait_idle)
            except WatchdogTimeout:
                drained = False
        else:
            drained = self.batcher.wait_idle(timeout_s)
        leftover = self.batcher.depth_rows
        if drained:
            Log.info("serve: drained (all accepted requests answered)")
        else:
            Log.warning(f"serve: drain timed out after {timeout_s:g}s "
                        f"({leftover} rows still queued)")
        return {"drained": drained, "leftover_rows": leftover,
                "timeout_s": timeout_s}

    def health(self) -> dict:
        try:
            model = self.registry.current().describe()
            status = "ok"
        except NoModelError:
            model, status = None, "no_model"
        if self.batcher.draining or self._closed:
            status = "draining" if not self._closed else "stopped"
        elif status == "ok" and self.breaker is not None \
                and self.breaker.state() != "closed":
            # the device side is failing (or on probation): alive, but
            # a load balancer should prefer healthier replicas
            status = "degraded"
        out = {"status": status,
               # readiness: may an LB route NEW traffic here?  Degraded
               # stays ready — the breaker's half-open probe IS a
               # client request, so draining a degraded replica would
               # starve it of the traffic that closes the circuit
               "ready": status in ("ok", "degraded"),
               "model": model,
               "queue_depth_rows": self.batcher.depth_rows,
               "uptime_s": round(time.time() - self._t0, 3),
               "versions": self.registry.versions()}
        if self.breaker is not None:
            out["breaker"] = self.breaker.describe()
        return out

    def metrics_snapshot(self) -> dict:
        if self.breaker is not None:
            # the OPEN->HALF_OPEN transition is lazy (clock-driven, no
            # event): refresh so an idle replica's exported state can't
            # go stale against /healthz
            self.breaker.refresh_gauge()
        snap = dict(self.metrics.snapshot())
        lat = snap.get("serve.latency")
        if lat and lat.get("count"):
            h = Histogram(tuple(lat["buckets"]))
            h.counts, h.count = list(lat["counts"]), lat["count"]
            h.sum, h.min, h.max = lat["sum"], lat["min"], lat["max"]
            snap["serve.latency_quantiles"] = {
                "p50_s": h.quantile(0.5), "p99_s": h.quantile(0.99)}
        try:
            engine = self.registry.current().engine
            if engine is not None:
                snap["serve.engine"] = engine.compile_stats()
        except NoModelError:
            pass
        # segment routing table — bounded by the same label cap as the
        # per-segment counters so a hostile key stream can't bloat the
        # export (overflow collapses into a count, not a key list)
        segs = self.router.snapshot()
        if segs:
            cap = max(0, int(self.config.serve_metrics_max_versions))
            items = sorted(segs.items())
            snap["serve.segments"] = dict(items[:cap])
            if len(items) > cap:
                snap["serve.segments_overflow"] = len(items) - cap
            snap["serve.segments_total"] = len(items)
        return snap

    def close(self) -> None:
        with self._lock:        # close-once latch: two racing closers
            if self._closed:    # must not double-close the sinks
                return
            self._closed = True
        self.batcher.close()


# ---------------------------------------------------------------------------
# HTTP frontend (stdlib only)
# ---------------------------------------------------------------------------

class HttpFrontend:
    """Handle for a running HTTP frontend (``.port``, ``.close()``)."""

    def __init__(self, httpd, thread: Optional[threading.Thread]):
        self._httpd = httpd
        self._thread = thread
        self.host, self.port = httpd.server_address[:2]

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def start_http(server: Server, host: str = "127.0.0.1", port: int = 0,
               background: bool = True) -> HttpFrontend:
    """Expose ``server`` over HTTP; ``port=0`` picks a free port (read
    it back from the returned handle)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):       # route through Log
            Log.debug("serve-http: " + fmt % args)

        def _send(self, code: int, payload: dict,
                  headers: Optional[dict] = None) -> None:
            self._send_text(code, json.dumps(payload),
                            "application/json", headers)

        def _send_text(self, code: int, text: str, content_type: str,
                       headers: Optional[dict] = None) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            from urllib.parse import parse_qs, urlparse
            u = urlparse(self.path)
            if u.path == "/healthz":
                h = server.health()
                # readiness semantics for load balancers: 200 only
                # while NEW traffic should be routed here; a draining
                # or model-less replica answers (liveness) with 503.
                # health() computes "ready" — route on it so code and
                # body can never disagree
                self._send(200 if h["ready"] else 503, h)
            elif u.path == "/freshness":
                self._send(501, {"error": "GET /freshness needs "
                                          "pipeline/continual.py "
                                          "(ROADMAP A17)"})
            elif u.path == "/metrics":
                snap = server.metrics_snapshot()
                if parse_qs(u.query).get("format", [""])[0] == "prom":
                    # Prometheus text exposition (obs/metrics.py)
                    self._send_text(
                        200, prometheus_text(snap),
                        "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self._send(200, snap)
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, TypeError) as e:
                self._send(400, {"error": f"bad JSON: {e}"})
                return
            if self.path == "/predict":
                self._predict(req)
            elif self.path == "/reload":
                self._reload(req)
            elif self.path == "/promote":
                self._send(501, {"error": "POST /promote needs "
                                          "pipeline/continual.py "
                                          "(ROADMAP A17)"})
            elif self.path == "/drain":
                self._send(200, server.drain(req.get("timeout_s")))
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def _current_version(self):
            try:
                return server.registry.current().version
            except NoModelError:
                return None

        def _predict(self, req: dict) -> None:
            rows = req.get("rows")
            if rows is None:
                self._send(400, {"error": "missing 'rows'"})
                return
            try:
                arr = np.asarray(rows, np.float64)
                if arr.ndim == 1:
                    arr = arr.reshape(1, -1)
                if arr.ndim != 2:
                    raise ValueError(f"rows must be 2-D, got "
                                     f"{arr.ndim}-D")
            except (ValueError, TypeError) as e:
                self._send(400, {"error": f"bad rows: {e}"})
                return
            deadline_ms = req.get("deadline_ms")
            timeout_s = req.get("timeout_s", 30.0)
            try:
                if deadline_ms is not None:
                    deadline_ms = float(deadline_ms)
                timeout_s = float(timeout_s)
            except (ValueError, TypeError) as e:
                # malformed knobs are the client's fault — 400, like
                # bad rows, not the catch-all 500 below
                self._send(400, {"error": f"bad deadline_ms or "
                                          f"timeout_s: {e}"})
                return
            segment = req.get("segment")
            if segment is not None:
                segment = str(segment)
            try:
                fut = server.submit(arr, deadline_ms=deadline_ms,
                                    segment=segment)
                pred = fut.result(timeout=timeout_s)
            except BacklogFull as e:
                self._send(429, {"error": str(e),
                                 "retry_after_ms": e.retry_after_ms},
                           headers={"Retry-After": str(max(
                               1, int(e.retry_after_ms / 1000 + 0.5)))})
                return
            except CircuitOpen as e:
                # the device side is failing: reject up front with the
                # breaker's cooldown as the back-off hint
                self._send(503, {"error": str(e),
                                 "retry_after_ms": e.retry_after_ms},
                           headers={"Retry-After": str(max(
                               1, int(e.retry_after_ms / 1000 + 0.5)))})
                return
            except DeadlineExceeded as e:
                self._send(504, {"error": str(e),
                                 "deadline_ms": e.deadline_ms,
                                 "where": e.where})
                return
            except BatcherClosed as e:       # draining or shut down
                self._send(503, {"error": str(e),
                                 "draining": server.draining})
                return
            except NoModelError as e:
                self._send(503, {"error": str(e)})
                return
            except Exception as e:          # noqa: BLE001 — request-scoped
                # a malformed REQUEST (wrong feature count, bad shape)
                # is the client's fault — 400, not 500; per-width batch
                # coalescing guarantees it failed alone
                code = 400 if isinstance(e, (ValueError, LightGBMError)) \
                    else 500
                self._send(code,
                           {"error": f"{type(e).__name__}: {e}"})
                return
            body = {
                "predictions": np.asarray(pred).tolist(),
                "num_rows": int(len(arr)),
                "model_version": fut.info.get("model_version")}
            if segment is not None:
                body["segment"] = fut.info.get("segment", segment)
            self._send(200, body)

        def _reload(self, req: dict) -> None:
            try:
                version = server.reload(
                    model_file=req.get("model_file"),
                    model_str=req.get("model_str"),
                    snapshot=req.get("snapshot"),
                    expected_sha256=req.get("sha256"))
            except ArtifactVerificationError as e:
                # the artifact is not what the caller said it was —
                # conflict, not client-syntax error; current version
                # keeps serving.  The BODY carries the verification
                # failure reason (which file, which checksums) plus the
                # version still serving — a deploy script retrying on a
                # bare 409 has nothing to page the operator with
                self._send(409, {"error": str(e),
                                 "reason": str(e),
                                 "verification": "failed",
                                 "current_version":
                                     self._current_version()})
                return
            except Exception as e:          # noqa: BLE001 — operator call
                self._send(400,
                           {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"model_version": version})

    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.daemon_threads = True
    thread = None
    if background:
        thread = threading.Thread(target=httpd.serve_forever,
                                  name="lgbtorch-serve-http", daemon=True)
        thread.start()
    Log.info(f"serve: HTTP frontend on "
             f"http://{httpd.server_address[0]}:"
             f"{httpd.server_address[1]}")
    return HttpFrontend(httpd, thread)
