"""The port's serving stack (``lightgbm_torch.serve``): the Server over the
predictor engine, the micro-batcher, the registry, the circuit breaker,
deadlines, drain and the HTTP frontend — the cases of the JAX package's
``test_serve.py``, ``test_serve_fused.py`` and ``test_serve_hardening.py``
that need no unported module, on the CPU (``device_type="cpu"``, every
kernel as its plain version).

Served answers are held byte-identical to the port's ``Booster.predict``
on the same rows (host-binned path) or to the engine's
``_fused_reference`` (fused path, on rows where f32 and f64 binning
agree), and against the JAX package's ``Booster.predict`` on the same
model text: raw scores exactly, converted scores to 1e-6 relative (the
two packages take ``exp`` from different CPU libraries)."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import _kernels
from lightgbm_torch.obs.metrics import Histogram, MetricsRegistry
from lightgbm_torch.serve import (ArtifactVerificationError, BacklogFull,
                                  BatcherClosed, BatcherDraining, CircuitOpen,
                                  DeadlineExceeded, EngineUnsupported,
                                  MicroBatcher, ModelRegistry, NoModelError,
                                  PredictorEngine, Server, start_http)
from lightgbm_torch.serve.registry import _sha256_hex
from lightgbm_torch.utils.resilience import CircuitBreaker, RetryPolicy

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, jax_serve_models, pin_torch_threads, pin_torch_threads_module,
    serve_rows)

CPU = {"device_type": "cpu", "verbosity": -1}
TRANSFORM_RTOL = 1e-6


def _train(rounds=8, seed=0, n=300, f=5, objective="regression", **extra):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    y = x[:, 0] + 0.5 * x[:, 1]
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    return lgt.train({"objective": objective, "num_leaves": 8, **CPU,
                      **extra}, lgt.Dataset(x, y), rounds)


@pytest.fixture(scope="module")
def booster():
    return _train()


@pytest.fixture(scope="module")
def models():
    return jax_serve_models()


def _post(base, path, payload, timeout=10):
    req = urllib.request.Request(
        base + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


# ---------------------------------------------------------------------------
# serve-path parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["regression", "binary", "categorical",
                                 "multiclass", "binary_stump"])
def test_server_matches_booster_and_jax(models, tag):
    """In-process serve == Booster.predict == host walk, byte for byte,
    with requests split across micro-batches; and the JAX package's
    Booster.predict on the same model text."""
    text, xt = models[tag]
    port = lgt.Booster(params=CPU, model_str=text)
    ref = host_walk(port, xt)
    srv = Server({**CPU, "serve_max_batch": 32, "serve_max_wait_ms": 20.0},
                 model_str=text)
    try:
        # uneven request sizes force coalescing AND splitting across
        # several micro-batches (32-row cap, 150 rows)
        futs = [srv.submit(xt[i:i + 13]) for i in range(0, len(xt), 13)]
        got = np.concatenate([f.result(30) for f in futs])
        assert srv.registry.current().engine is not None
    finally:
        srv.close()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert futs[0].info["model_version"] == "v1"
    want = np.asarray(lgb.Booster(model_str=text).predict(xt))
    if port.objective is None or tag == "regression":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=TRANSFORM_RTOL)


@pytest.mark.parametrize("tag", ["regression", "binary", "categorical"])
def test_fused_server_matches_reference(models, tag):
    text, xt = models[tag]
    srv = Server({**CPU, "serve_device_binning": True,
                  "serve_max_batch": 64, "serve_max_wait_ms": 5.0},
                 model_str=text)
    try:
        eng = srv.registry.current().engine
        assert eng is not None and eng.fused_ok
        mask = eng._f32_consensus_mask(xt)
        rows = xt[mask]
        futs = [srv.submit(rows[i:i + 17]) for i in range(0, len(rows), 17)]
        got = np.concatenate([f.result(30) for f in futs])
        snap = srv.metrics_snapshot()
    finally:
        srv.close()
    np.testing.assert_array_equal(got, eng._fused_reference(rows))
    assert got.dtype == np.float32
    assert snap["serve.fused_batches"]["value"] >= 1
    assert "serve.host_fallback_batches" not in snap
    # against the JAX package's exact host path, to the f32 accumulation
    want = np.asarray(lgb.Booster(model_str=text).predict(rows))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_http_predict_healthz_metrics(models):
    text, xt = models["binary"]
    bst = lgt.Booster(params=CPU, model_str=text)
    srv = Server({**CPU, "serve_max_batch": 16, "serve_max_wait_ms": 1.0},
                 model_str=text)
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    try:
        resp = _post(base, "/predict", {"rows": xt[:41].tolist()})
        h = json.loads(urllib.request.urlopen(base + "/healthz").read())
        m = json.loads(urllib.request.urlopen(base + "/metrics").read())
        prom = urllib.request.urlopen(
            base + "/metrics?format=prom").read().decode()
    finally:
        fe.close()
        srv.close()
    ref = bst.predict(xt[:41])
    # JSON floats round-trip f32/f64 exactly (repr round trip)
    np.testing.assert_array_equal(np.asarray(resp["predictions"], ref.dtype),
                                  ref)
    assert resp["model_version"] == "v1" and resp["num_rows"] == 41
    assert h["status"] == "ok" and h["ready"] is True
    assert h["model"]["num_trees"] == len(bst.trees)
    assert h["versions"][0]["current"] is True
    assert m["serve.requests"]["value"] >= 1
    assert m["serve.latency_quantiles"]["p99_s"] > 0
    assert m["serve.engine"]["buckets"]
    assert "# TYPE serve_requests counter" in prom


def test_http_bad_requests_and_unported_endpoints(booster):
    srv = Server({**CPU, "serve_max_wait_ms": 1.0}, booster=booster)
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    try:
        for payload, frag in [({}, "missing 'rows'"),
                              ({"rows": [[[1]]]}, "bad rows")]:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/predict", payload)
            assert ei.value.code == 400
            assert frag in json.loads(ei.value.read())["error"]
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope")
        assert ei.value.code == 404
        # wrong feature count: this request fails alone, as a 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/predict", {"rows": [[1.0, 2.0]]})
        assert ei.value.code == 400
        assert "predict_disable_shape_check" in \
            json.loads(ei.value.read())["error"]
        for path, item in (("/promote", "A17"), ("/freshness", "A17")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                if path == "/promote":
                    _post(base, path, {})
                else:
                    urllib.request.urlopen(base + path)
            assert ei.value.code == 501
            assert item in json.loads(ei.value.read())["error"]
        ok = _post(base, "/predict", {"rows": np.zeros((2, 5)).tolist()})
        assert ok["num_rows"] == 2
    finally:
        fe.close()
        srv.close()


def test_zero_rows_through_server(booster):
    srv = Server(CPU, booster=booster)
    try:
        assert srv.predict(np.empty((0, 5))).shape == (0,)
    finally:
        srv.close()


@pytest.mark.parametrize("params,item", [
    ({"telemetry": True}, "A15"), ({"telemetry_blackbox": True}, "A15"),
    ({"resume": True}, "A12")])
def test_unported_server_options_raise(booster, params, item):
    with pytest.raises(NotImplementedError, match=item):
        Server({**CPU, **params})


def test_unported_server_methods_raise(booster):
    srv = Server(CPU, booster=booster)
    try:
        with pytest.raises(NotImplementedError, match="A17"):
            srv.promote(model_file="m.txt")
        with pytest.raises(NotImplementedError, match="A17"):
            srv.freshness()
        with pytest.raises(NotImplementedError, match="A17"):
            srv.shadow_batches()
        with pytest.raises(NotImplementedError, match="A12"):
            srv.reload(snapshot="out")
        with pytest.raises(NotImplementedError, match="A12"):
            srv.registry.load_snapshot("out")
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

def test_batcher_coalesces_concurrent_requests():
    seen = []

    def predict_fn(rows):
        seen.append(len(rows))
        return rows[:, 0] * 2.0

    gate = MicroBatcher(predict_fn, max_batch=64, max_wait_ms=150.0,
                        queue_rows=1024)
    try:
        futs = [gate.submit(np.full((5, 2), i, float)) for i in range(6)]
        outs = [f.result(10) for f in futs]
    finally:
        gate.close()
    for i, o in enumerate(outs):
        np.testing.assert_array_equal(o, np.full(5, 2.0 * i))
    assert max(seen) == 30


def test_batcher_backpressure_rejects_with_retry_after():
    release = threading.Event()
    gate = MicroBatcher(lambda rows: (release.wait(10), rows[:, 0])[1],
                        max_batch=4, max_wait_ms=0.0, queue_rows=8)
    try:
        futs = [gate.submit(np.zeros((4, 1)))]
        time.sleep(0.05)            # worker picks up batch 1, blocks
        futs += [gate.submit(np.zeros((4, 1))),
                 gate.submit(np.zeros((4, 1)))]
        with pytest.raises(BacklogFull) as ei:
            gate.submit(np.zeros((4, 1)))
        assert ei.value.retry_after_ms > 0 and ei.value.depth_rows == 8
        release.set()
        for f in futs:
            f.result(10)
    finally:
        release.set()
        gate.close()


def test_batcher_transient_errors_retry_fatal_do_not():
    calls = {"n": 0}

    def flaky(rows):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("collective timed out")  # transient
        return rows[:, 0]

    gate = MicroBatcher(flaky, max_batch=8, max_wait_ms=0.0,
                        retry_policy=RetryPolicy(max_attempts=2,
                                                 base_delay_s=0.01))
    try:
        assert gate.submit(np.ones((2, 1))).result(10) is not None
        assert calls["n"] == 2

        def fatal(rows):
            raise TypeError("broken request")

        gate.predict_fn = fatal
        with pytest.raises(TypeError):
            gate.submit(np.ones((2, 1))).result(10)
    finally:
        gate.close()


def test_batcher_close_drains_then_rejects_and_survives_bad_requests():
    hold = threading.Event()
    gate = MicroBatcher(lambda r: (hold.wait(5), r[:, 0])[1], max_batch=64,
                        max_wait_ms=0.0)
    f1 = gate.submit(np.zeros((2, 1)))
    time.sleep(0.05)
    f2 = gate.submit(np.zeros((2, 5)))   # width change: its own batch
    hold.set()
    np.testing.assert_array_equal(f2.result(5), np.zeros(2))
    with pytest.raises(ValueError, match="2-D"):
        gate.submit(np.zeros((1, 2, 2)))

    def boom(rows):
        raise RuntimeError("boom")
    gate.predict_fn = boom
    with pytest.raises(RuntimeError):
        gate.submit(np.zeros((1, 2))).result(10)
    assert gate._worker.is_alive()
    gate.close()
    f1.result(5)
    with pytest.raises(BatcherClosed):
        gate.submit(np.zeros((1, 1)))
    assert not gate._worker.is_alive()


def test_batcher_metrics_recorded():
    m = MetricsRegistry()
    gate = MicroBatcher(lambda r: r[:, 0], max_batch=8, max_wait_ms=0.0,
                        metrics=m)
    try:
        gate.submit(np.zeros((3, 1))).result(10)
    finally:
        gate.close()
    snap = m.snapshot()
    assert snap["serve.requests"]["value"] == 1
    assert snap["serve.rows"]["value"] == 3
    assert snap["serve.batch_rows"]["count"] == 1
    assert snap["serve.latency"]["count"] == 1
    assert 0 < snap["serve.batch_occupancy"]["max"] <= 1.0


# ---------------------------------------------------------------------------
# deadlines and drain
# ---------------------------------------------------------------------------

def test_lapsed_deadline_shed_before_dispatch():
    m = MetricsRegistry()
    hold = threading.Event()
    seen = []

    def fn(rows):
        seen.append(len(rows))
        hold.wait(10)
        return rows[:, 0]

    gate = MicroBatcher(fn, max_batch=4, max_wait_ms=0.0, metrics=m)
    try:
        f1 = gate.submit(np.zeros((1, 2)))
        time.sleep(0.05)
        f2 = gate.submit(np.zeros((2, 2)), deadline_ms=60.0)
        time.sleep(0.15)
        hold.set()
        with pytest.raises(DeadlineExceeded) as ei:
            f2.result(5)
        assert ei.value.where == "queue" and ei.value.waited_ms >= 60.0
        f1.result(5)
    finally:
        hold.set()
        gate.close()
    assert seen == [1]
    assert m.snapshot()["serve.deadline_shed"]["value"] == 1


def test_hopeless_deadline_rejected_at_admission():
    hold = threading.Event()
    gate = MicroBatcher(lambda r: (hold.wait(10), r[:, 0])[1], max_batch=2,
                        max_wait_ms=100.0)
    try:
        f1 = gate.submit(np.zeros((2, 1)))
        time.sleep(0.05)
        f2 = gate.submit(np.zeros((2, 1)))
        with pytest.raises(DeadlineExceeded) as ei:
            gate.submit(np.zeros((1, 1)), deadline_ms=50.0)
        assert ei.value.where == "admission"
        f3 = gate.submit(np.zeros((1, 1)), deadline_ms=5000.0)
        hold.set()
        for f in (f1, f2, f3):
            f.result(5)
    finally:
        hold.set()
        gate.close()


def test_http_504_on_deadline(booster):
    srv = Server({**CPU, "serve_max_wait_ms": 0.0}, booster=booster)
    hold = threading.Event()
    real = srv.batcher.predict_fn
    srv.batcher.predict_fn = lambda rows: (hold.wait(10), real(rows))[1]
    fe = start_http(srv, port=0)
    try:
        f1 = srv.submit(np.zeros((1, 5)))
        time.sleep(0.1)
        threading.Timer(0.3, hold.set).start()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(f"http://127.0.0.1:{fe.port}", "/predict",
                  {"rows": [[0.0] * 5], "deadline_ms": 80.0})
        assert ei.value.code == 504
        assert json.loads(ei.value.read())["deadline_ms"] == \
            pytest.approx(80.0)
        f1.result(5)
    finally:
        hold.set()
        fe.close()
        srv.close()


def test_drain_answers_queued_then_refuses_new(booster):
    srv = Server({**CPU, "serve_max_batch": 2, "serve_max_wait_ms": 0.0},
                 booster=booster)
    hold = threading.Event()
    real = srv.batcher.predict_fn
    srv.batcher.predict_fn = lambda rows: (hold.wait(10), real(rows))[1]
    x = np.zeros((2, 5))
    f1 = srv.submit(x)
    time.sleep(0.05)
    f2 = srv.submit(x)
    result = {}
    t = threading.Thread(target=lambda: result.update(srv.drain(10.0)),
                         daemon=True)
    t.start()
    time.sleep(0.05)
    with pytest.raises(BatcherDraining):
        srv.submit(x)
    h = srv.health()
    assert h["status"] == "draining" and h["ready"] is False
    hold.set()
    t.join(10)
    assert not t.is_alive()
    assert result["drained"] is True and result["leftover_rows"] == 0
    f1.result(5), f2.result(5)
    srv.close()


def test_http_drain_and_healthz_503(booster):
    srv = Server(CPU, booster=booster)
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    try:
        resp = _post(base, "/drain", {})
        assert resp["drained"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/healthz")
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/predict", {"rows": [[0.0] * 5]})
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["draining"] is True
    finally:
        fe.close()
        srv.close()


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _clocked(**kw):
    clock = {"t": 0.0}
    return CircuitBreaker(clock=lambda: clock["t"], **kw), clock


def test_breaker_trips_probes_and_backs_off():
    cb, clock = _clocked(failure_threshold=3, cooldown_s=1.0,
                         cooldown_max_s=4.0)
    for _ in range(2):
        cb.record_failure()
    cb.record_success()              # resets the consecutive count
    for _ in range(2):
        cb.record_failure()
    assert cb.state() == "closed" and cb.allow()
    cb.record_failure()
    assert cb.state() == "open" and not cb.allow() and cb.opens == 1
    clock["t"] = 1.5
    assert cb.allow()                # THE probe
    assert not cb.allow()            # the burst behind it
    cb.record_failure()              # probe fails: cooldown doubles
    assert cb.describe()["cooldown_s"] == 2.0
    clock["t"] = 10.0
    assert cb.allow()
    cb.record_success()
    assert cb.state() == "closed" and cb.describe()["cooldown_s"] == 1.0
    off, _ = _clocked(failure_threshold=0)
    for _ in range(5):
        off.record_failure()
    assert off.allow() and off.state() == "closed"


def test_server_breaker_opens_rejects_and_recovers(booster):
    srv = Server({**CPU, "serve_retries": 0, "serve_breaker_failures": 2,
                  "serve_breaker_cooldown_ms": 150.0,
                  "serve_max_wait_ms": 0.0}, booster=booster)
    real = srv.batcher.predict_fn

    def boom(rows):
        raise RuntimeError("device UNAVAILABLE (simulated wedge)")

    srv.batcher.predict_fn = boom
    x = np.zeros((1, 5))
    try:
        # wrong feature count: request-scoped, never moves the breaker
        srv.batcher.predict_fn = real
        for _ in range(3):
            with pytest.raises(Exception):
                srv.predict(np.zeros((1, 2)), timeout=5)
        assert srv.breaker.describe()["state"] == "closed"
        srv.batcher.predict_fn = boom
        for _ in range(2):
            with pytest.raises(RuntimeError):
                srv.predict(x, timeout=5)
        with pytest.raises(CircuitOpen) as ei:
            srv.submit(x)
        assert ei.value.retry_after_ms > 0
        h = srv.health()
        assert h["status"] == "degraded" and h["ready"] is True
        snap = srv.metrics_snapshot()
        assert snap["serve.breaker_opens"]["value"] == 1
        assert snap["serve.breaker_state"]["value"] == 2
        srv.batcher.predict_fn = real
        deadline = time.time() + 10
        while True:
            try:
                srv.predict(x, timeout=5)
                break
            except CircuitOpen:
                assert time.time() < deadline, "breaker never half-opened"
                time.sleep(0.03)
        assert srv.breaker.describe()["state"] == "closed"
        assert srv.health()["status"] == "ok"
    finally:
        srv.close()


def test_kernel_faults_are_not_retried():
    from lightgbm_torch.utils.resilience import is_retryable_device_error
    assert not is_retryable_device_error(_kernels.KernelError(
        "CUDA kernel forest_walk failed to launch: cudaError 700"))
    assert not is_retryable_device_error(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert is_retryable_device_error(RuntimeError("device UNAVAILABLE"))


# ---------------------------------------------------------------------------
# registry, hot swap, verification
# ---------------------------------------------------------------------------

def test_registry_swap_unload_and_eviction():
    b1, b2 = _train(rounds=5), _train(rounds=9, seed=1)
    reg = ModelRegistry(device_type="cpu")
    with pytest.raises(NoModelError):
        reg.current()
    v1 = reg.load(booster=b1)
    old = reg.current()
    v2 = reg.load(model_str=b2.model_to_string())
    assert (v1, v2) == ("v1", "v2") and reg.current().version == "v2"
    xt = serve_rows(20, f=5, seed=31)
    np.testing.assert_array_equal(old.booster.predict(xt), b1.predict(xt))
    assert reg.current().engine.device.type == "cpu"
    with pytest.raises(ValueError, match="current"):
        reg.unload("v2")
    reg.activate("v1")
    reg.unload("v2")
    assert [v["version"] for v in reg.versions()] == ["v1"]
    with pytest.raises(KeyError):
        reg.get("v2")
    # past the residency cap the oldest non-current version goes
    capped = ModelRegistry(device_type="cpu", max_resident=2)
    for b in (_train(rounds=3), b1, b2):
        capped.load(booster=b)
    assert [v["version"] for v in capped.versions()] == ["v2", "v3"]


def test_server_reload_switches_new_requests(booster):
    b2 = _train(rounds=9, seed=1)
    srv = Server({**CPU, "serve_max_wait_ms": 0.0}, booster=booster)
    try:
        xt = serve_rows(15, f=5, seed=34)
        f1 = srv.submit(xt)
        np.testing.assert_array_equal(f1.result(10), booster.predict(xt))
        v2 = srv.reload(booster=b2)
        f2 = srv.submit(xt)
        np.testing.assert_array_equal(f2.result(10), b2.predict(xt))
        assert f2.info["model_version"] == v2 == "v2"
    finally:
        srv.close()


def test_registry_verifies_artifacts(tmp_path, booster):
    path = str(tmp_path / "m.txt")
    booster.save_model(path)
    reg = ModelRegistry(device_type="cpu")
    with pytest.raises(ArtifactVerificationError):
        reg.load(model_file=path, expected_sha256="0" * 64)
    with pytest.raises(ValueError, match="non-empty"):
        reg.load(model_file=path, expected_sha256="")
    assert reg.versions() == []
    with open(path, "rb") as f:
        v = reg.load(model_file=path, expected_sha256=_sha256_hex(f.read()))
    assert reg.get(v).version == v
    s = booster.model_to_string()
    reg.load(model_str=s, expected_sha256=_sha256_hex(s))
    with pytest.raises(ValueError, match="expected_sha256"):
        reg.load(booster=booster, expected_sha256=_sha256_hex(s))


def test_http_reload_and_409_on_bad_sha(tmp_path, booster):
    b2 = _train(rounds=6, seed=3)
    path = str(tmp_path / "m2.txt")
    b2.save_model(path)
    srv = Server(CPU, booster=booster)
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/reload", {"model_file": path, "sha256": "f" * 64})
        assert ei.value.code == 409
        assert srv.health()["model"]["version"] == "v1"
        assert srv.metrics_snapshot()["serve.reload_failures"]["value"] == 1
        assert _post(base, "/reload", {"model_file": path}
                     )["model_version"] == "v2"
        xt = serve_rows(9, f=5, seed=45)
        got = _post(base, "/predict", {"rows": xt.tolist()})
        assert got["model_version"] == "v2"
        np.testing.assert_array_equal(np.asarray(got["predictions"]),
                                      b2.predict(xt))
    finally:
        fe.close()
        srv.close()


def test_failed_self_check_demotes_tohost_walk(booster, monkeypatch):
    monkeypatch.setattr(PredictorEngine, "self_check",
                        lambda self, **kw: False)
    srv = Server({**CPU, "serve_device_binning": True,
                  "serve_max_wait_ms": 0.0}, booster=_train(seed=5))
    try:
        served = srv.registry.current()
        assert served.engine is None and served.self_check_failed
        xt = serve_rows(7, f=5, seed=5)
        np.testing.assert_array_equal(srv.predict(xt, timeout=10),
                                      host_walk(served.booster, xt))
        snap = srv.metrics_snapshot()
        assert snap["serve.host_fallback_batches"]["value"] == 1
        assert "serve.fused_batches" not in snap
    finally:
        srv.close()


@pytest.mark.parametrize("fault", [
    _kernels.KernelError("CUDA kernel forest_walk failed to launch: "
                         "cudaError 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered")])
def test_kernel_fault_in_self_check_raises(fault, monkeypatch):
    def broken(self, **kw):
        raise fault
    monkeypatch.setattr(PredictorEngine, "self_check", broken)
    reg = ModelRegistry(device_type="cpu")
    with pytest.raises(type(fault)):
        reg.load(booster=_train(seed=6))
    assert reg.versions() == []


def test_kernel_fault_in_a_batch_fails_it(booster, monkeypatch):
    srv = Server({**CPU, "serve_device_binning": True,
                  "serve_max_wait_ms": 0.0}, booster=_train(seed=7))

    def broken(self, x, raw_score=False):
        raise _kernels.KernelError("CUDA kernel fused_predict failed to "
                                   "launch: cudaError 1")
    monkeypatch.setattr(PredictorEngine, "fused_predict", broken)
    try:
        with pytest.raises(_kernels.KernelError):
            srv.predict(np.zeros((2, 5)), timeout=10)
        snap = srv.metrics_snapshot()
        assert "serve.host_fallback_batches" not in snap
        assert snap["serve.errors"]["value"] == 1
    finally:
        srv.close()


def test_linear_trees_fall_back_counted():
    x = serve_rows(400, seed=23, nan_frac=0.0)
    jb = lgb.train({"objective": "regression", "linear_tree": True,
                    "verbosity": -1, "num_leaves": 8},
                   lgb.Dataset(x, label=x[:, 0]), num_boost_round=4)
    text = jb.model_to_string()
    srv = Server({**CPU, "serve_device_binning": True,
                  "serve_max_wait_ms": 0.0}, model_str=text)
    try:
        eng = srv.registry.current().engine
        assert not eng.fused_ok and "linear" in eng.fused_reason
        with pytest.raises(EngineUnsupported):
            eng.fused_predict(x[:2])
        xt = serve_rows(10, seed=24, nan_frac=0.0)
        out = srv.predict(xt)
        np.testing.assert_array_equal(out, np.asarray(jb.predict(xt)))
        snap = srv.metrics_snapshot()
        assert snap["serve.host_fallback_batches"]["value"] >= 1
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# segments, metrics, launch counter
# ---------------------------------------------------------------------------

def test_segments_route_to_their_version(booster):
    b2 = _train(rounds=9, seed=1)
    srv = Server({**CPU, "serve_max_wait_ms": 0.0}, booster=booster)
    try:
        v2 = srv.registry.load(booster=b2, activate=False)
        srv.router.assign("eu", v2)
        xt = serve_rows(6, f=5, seed=8)
        np.testing.assert_array_equal(srv.predict(xt, segment="eu"),
                                      b2.predict(xt))
        np.testing.assert_array_equal(srv.predict(xt, segment="us"),
                                      booster.predict(xt))
        np.testing.assert_array_equal(srv.predict(xt), booster.predict(xt))
        snap = srv.metrics_snapshot()
        assert snap["serve.segment_fallbacks"]["value"] == 1
        assert snap["serve.segments"] == {"eu": "v2"}
        srv.registry.unload(v2)
        np.testing.assert_array_equal(srv.predict(xt, segment="eu"),
                                      booster.predict(xt))
        assert srv.router.snapshot() == {}
    finally:
        srv.close()


def test_histogram_quantile_and_router_match_jax():
    from lightgbm_tpu.fleet.router import SegmentRouter as JRouter
    from lightgbm_tpu.obs.metrics import Histogram as JHistogram
    from lightgbm_tpu.obs.metrics import prometheus_text as jprom
    from lightgbm_torch.fleet.router import SegmentRouter
    from lightgbm_torch.obs.metrics import prometheus_text
    ht, hj = Histogram(buckets=(1.0, 2.0, 4.0)), JHistogram((1.0, 2.0, 4.0))
    assert ht.quantile(0.5) is None
    for v in (0.5, 1.5, 1.5, 3.0, 8.0):
        ht.observe(v)
        hj.observe(v)
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    mt = MetricsRegistry()
    from lightgbm_tpu.obs import MetricsRegistry as JMetrics
    mj = JMetrics()
    for m in (mt, mj):
        m.counter("serve.rows", segment="eu").inc(3)
        m.gauge("serve.queue_depth").set(7)
        m.histogram("serve.latency").observe(0.002)
    assert mt.snapshot() == mj.snapshot()
    assert prometheus_text(mt.snapshot()) == jprom(mj.snapshot())
    rt, rj = SegmentRouter("main"), JRouter("main")
    for r in (rt, rj):
        r.assign("eu", "v2")
        r.assign("us", "v3")
    for seg in (None, "eu", "us", "apac"):
        assert rt.resolve(seg) == rj.resolve(seg)
    assert rt.drop_version("v2") == rj.drop_version("v2")
    assert rt.snapshot() == rj.snapshot()
    assert rt.fallbacks() == rj.fallbacks()


def test_launch_counter_is_thread_safe():
    """Many threads counting launches at once, with a short switch
    interval: a lost read-modify-write would show in the total."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, per = 16, 2000
    try:
        _kernels.reset_launch_counts()

        def work():
            for _ in range(per):
                _kernels.launched("forest_walk", 0)

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _kernels.launch_counts()["forest_walk"] == n_threads * per
    _kernels.reset_launch_counts()
    with pytest.raises(_kernels.KernelError, match="cudaError 700"):
        _kernels.launched("forest_walk", 700)
    assert _kernels.launch_counts()["forest_walk"] == 0


# ---------------------------------------------------------------------------
# more of the JAX package's serving cases
# ---------------------------------------------------------------------------

def test_fused_batch_fetches_once(models, monkeypatch):
    """A fused batch copies one tensor to the host: the final scores."""
    text, xt = models["binary"]
    eng = PredictorEngine.from_booster(
        lgt.Booster(params=CPU, model_str=text))
    eng.fused_predict(xt[:4])                 # tables built
    fetched = []
    real = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu",
                        lambda self, *a, **k: (fetched.append(
                            tuple(self.shape)), real(self, *a, **k))[1])
    eng.fused_predict(xt[:40])
    assert fetched == [(40,)]      # the 40 rows of the 64-row bucket
    fetched.clear()
    eng.leaf_ids(xt[:40])                     # the host path: leaf ids
    assert fetched == [(40, len(eng.trees))]


def test_min_bucket_floors_tiny_batches(booster):
    eng = PredictorEngine.from_booster(booster, min_bucket=16)
    for n in (1, 2, 3, 7, 15, 16):
        eng.leaf_ids(serve_rows(n, f=5, seed=n))
    assert list(eng.compile_stats()["buckets"]) == [16]


def test_device_binning_agrees_on_separated_values():
    """Device (f32) binning is approximate only on threshold ties:
    values clear of every threshold bin exactly as the host (f64) does."""
    rs = np.random.RandomState(60)
    x = rs.randint(0, 20, (400, 4)).astype(np.float64)
    bst = lgt.train({"objective": "binary", "num_leaves": 8, **CPU},
                    lgt.Dataset(x, (x[:, 0] > 10).astype(np.float64)), 8)
    eng = PredictorEngine.from_booster(bst)
    xt = rs.randint(0, 20, (50, 4)).astype(np.float64) + 0.25
    np.testing.assert_array_equal(eng.predict(xt),
                                  eng.predict(xt, device_binning=True))


def test_categories_beyond_f32_serve_byhost_walk():
    """Categories at or above 2^24 cannot be device-binned exactly: the
    engine has a fused_reason, its device-binning self-check raises
    EngineUnsupported, and a device-binning server demotes the model to
    the host walk instead of serving wrong answers."""
    rs = np.random.RandomState(11)
    big = np.column_stack([np.repeat([1.0, float(1 << 24) + 2.0], 100),
                           rs.randn(200)])
    jb = lgb.train({"objective": "regression", "verbosity": -1,
                    "num_leaves": 4, "min_data_per_group": 1,
                    "min_data_in_leaf": 5},
                   lgb.Dataset(big, label=big[:, 1] + (big[:, 0] > 2),
                               categorical_feature=[0]),
                   num_boost_round=4)
    text = jb.model_to_string()
    eng = PredictorEngine.from_booster(
        lgt.Booster(params=CPU, model_str=text))
    if eng._device_bin_err is None:
        pytest.skip("model grew no categorical split at 2^24 or above")
    assert not eng.fused_ok and "2^24" in eng.fused_reason
    with pytest.raises(EngineUnsupported):
        eng.self_check(device_binning=True)
    srv = Server({**CPU, "serve_device_binning": True,
                  "serve_max_wait_ms": 0.0}, model_str=text)
    try:
        assert srv.registry.current().self_check_failed
        np.testing.assert_array_equal(srv.predict(big[:20]),
                                      np.asarray(jb.predict(big[:20])))
        assert srv.metrics_snapshot()[
            "serve.host_fallback_batches"]["value"] == 1
    finally:
        srv.close()


def test_server_default_deadline_and_disabled_breaker(booster):
    srv = Server({**CPU, "serve_deadline_ms": 60.0,
                  "serve_max_wait_ms": 0.0, "serve_breaker_failures": 0},
                 booster=booster)
    assert srv.breaker is None and "breaker" not in srv.health()
    hold = threading.Event()
    real = srv.batcher.predict_fn
    srv.batcher.predict_fn = lambda rows: (hold.wait(10), real(rows))[1]
    try:
        f1 = srv.submit(np.zeros((1, 5)))
        time.sleep(0.15)
        f2 = srv.submit(np.zeros((1, 5)))   # inherits the default
        time.sleep(0.15)
        hold.set()
        f1.result(5)
        with pytest.raises(DeadlineExceeded):
            f2.result(5)
        # an explicit per-request deadline overrides the default
        assert srv.predict(np.zeros((1, 5)), timeout=5,
                           deadline_ms=30000.0) is not None
    finally:
        hold.set()
        srv.close()


def test_http_503_with_retry_after_while_open(booster):
    srv = Server({**CPU, "serve_retries": 0, "serve_breaker_failures": 2,
                  "serve_breaker_cooldown_ms": 150.0,
                  "serve_max_wait_ms": 0.0}, booster=booster)
    srv.batcher.predict_fn = \
        lambda rows: (_ for _ in ()).throw(RuntimeError("UNAVAILABLE"))
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    try:
        for _ in range(2):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base, "/predict", {"rows": [[0.0] * 5]})
            assert ei.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/predict", {"rows": [[0.0] * 5]})
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["retry_after_ms"] > 0
        h = json.loads(urllib.request.urlopen(base + "/healthz").read())
        assert h["status"] == "degraded"
    finally:
        fe.close()
        srv.close()


def test_http_429_backpressure(booster):
    srv = Server({**CPU, "serve_max_batch": 4, "serve_max_wait_ms": 0.0,
                  "serve_queue_rows": 8}, booster=booster)
    hold = threading.Event()
    real = srv._predict_batch
    srv.batcher.predict_fn = lambda rows: (hold.wait(10), real(rows))[1]
    fe = start_http(srv, port=0)
    base = f"http://127.0.0.1:{fe.port}"
    futs = []
    try:
        rows = serve_rows(4, f=5, seed=43)
        futs.append(srv.submit(rows))
        time.sleep(0.1)                # the worker takes batch 1, waits
        futs += [srv.submit(rows) for _ in range(2)]
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, "/predict", {"rows": rows.tolist()})
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"]
        assert json.loads(ei.value.read())["retry_after_ms"] > 0
    finally:
        hold.set()
        for f in futs:
            f.result(10)
        fe.close()
        srv.close()


def test_admission_uses_measured_service_time_and_drain_wakes_on_shed():
    hold = threading.Event()
    seen = []

    def fn(rows):
        seen.append(len(rows))
        if len(seen) == 2:
            hold.wait(10)
        return rows[:, 0]

    b = MicroBatcher(fn, max_batch=2, max_wait_ms=100.0)
    try:
        b.submit(np.zeros((2, 1))).result(5)   # measures a batch
        f1 = b.submit(np.zeros((2, 1)))        # dispatches and waits
        time.sleep(0.05)
        f2 = b.submit(np.zeros((2, 1)))        # one batch pending
        # the 100 ms window would refuse a 90 ms deadline; the measured
        # sub-millisecond service time admits it
        f3 = b.submit(np.zeros((1, 1)), deadline_ms=90.0)
        hold.set()
        for f in (f3, f1, f2):
            f.result(5)
    finally:
        hold.set()
        b.close()
    # a drain whose last round sheds everything wakes at once
    hold2 = threading.Event()
    gate = MicroBatcher(lambda r: (hold2.wait(5), r[:, 0])[1], max_batch=8,
                        max_wait_ms=10.0)
    g1 = gate.submit(np.zeros((2, 1)))
    time.sleep(0.05)
    g2 = gate.submit(np.zeros((2, 1)), deadline_ms=60.0)
    time.sleep(0.1)
    gate.begin_drain()
    hold2.set()
    t0 = time.perf_counter()
    assert gate.wait_idle(5.0) is True
    assert time.perf_counter() - t0 < 2.0
    np.testing.assert_array_equal(g1.result(1), np.zeros(2))
    with pytest.raises(DeadlineExceeded):
        g2.result(1)
    gate.close()
