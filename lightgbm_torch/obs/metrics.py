"""Metrics registry: labeled counters/gauges/histograms, dict export and
the Prometheus text exposition.

The part of the JAX package's ``obs/metrics.py`` that the server reads,
copied (it imports no JAX).  Instruments are created lazily by (name,
sorted label items) and are plain Python objects — incrementing a
counter is one dict lookup + float add, and nothing here touches the
device.  ``snapshot()`` is deterministic: keys are the canonical
``name{k=v,...}`` strings with labels sorted, values plain
JSON-serializable dicts.  The multi-process aggregation
(``aggregate_snapshots``, ``gather_snapshots``) waits for ROADMAP
A15/A16.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Optional, Tuple

# default histogram buckets: log-ish spacing covering µs..minutes for
# time-valued series and 1..1e9 for count-valued ones
_DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.25, 1.0, 2.5, 10.0,
                    60.0, 600.0)


def _key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def export(self) -> Dict[str, Any]:
        return {"type": "counter", "value": self.value}


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def export(self) -> Dict[str, Any]:
        return {"type": "gauge", "value": self.value}


class Histogram:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def export(self) -> Dict[str, Any]:
        return {"type": "histogram", "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": list(self.buckets), "counts": list(self.counts)}

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (0..1) by linear interpolation inside
        the containing bucket, clamped to the observed [min, max] (the
        Prometheus ``histogram_quantile`` estimator).  None when empty.
        Serving latency p50/p99 (serve/server.py /metrics) read this."""
        if self.count <= 0:
            return None
        target = max(0.0, min(1.0, q)) * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target and c > 0:
                lo = self.buckets[i - 1] if i > 0 else self.min
                hi = self.buckets[i] if i < len(self.buckets) else self.max
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if hi <= lo:
                    return float(hi)
                frac = (target - (cum - c)) / c
                return float(lo + (hi - lo) * frac)
        return float(self.max)


class MetricsRegistry:
    """Lazy instrument registry; thread-safe creation, lock-free use."""

    def __init__(self):
        self._instruments: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw):
        key = _key(name, labels)
        inst = self._instruments.get(key)
        if inst is None:
            with self._lock:
                inst = self._instruments.setdefault(key, cls(**kw))
        if not isinstance(inst, cls):
            raise TypeError(f"metric {key!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None,
                  **labels: Any) -> Histogram:
        kw = {"buckets": tuple(buckets)} if buckets else {}
        return self._get(Histogram, name, labels, **kw)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Deterministic plain-dict export (sorted keys)."""
        with self._lock:
            items = sorted(self._instruments.items())
        return {k: inst.export() for k, inst in items}

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


_PROM_NAME_RE = None


def _prom_name(name: str) -> str:
    global _PROM_NAME_RE
    if _PROM_NAME_RE is None:
        import re
        _PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
    out = _PROM_NAME_RE.sub("_", name)
    return "_" + out if out and out[0].isdigit() else out


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    esc = {k: str(v).replace("\\", "\\\\").replace('"', '\\"')
           for k, v in labels.items()}
    return "{" + ",".join(f'{_prom_name(k)}="{esc[k]}"'
                          for k in sorted(esc)) + "}"


def _parse_key(key: str):
    """``name{a=b,c=d}`` snapshot key -> (name, labels dict)."""
    base, brace, rest = key.partition("{")
    labels: Dict[str, str] = {}
    if brace:
        for part in rest[:-1].split(","):
            k, _, v = part.partition("=")
            if k:
                labels[k] = v
    return base, labels


def prometheus_text(snap: Dict[str, Any]) -> str:
    """Render a metrics snapshot in the Prometheus text exposition
    format (v0.0.4) — the ``?format=prom`` answer of the serve
    ``/metrics`` endpoint.

    Typed instruments map directly (histograms emit cumulative
    ``_bucket``/``_sum``/``_count`` series with ``le`` labels); plain
    numeric entries (``compile.*``, ``perf.*``) become gauges; string
    entries (the roofline ``bound`` verdicts) become info-style
    ``name{value="..."} 1`` gauges; nested plain dicts
    (``serve.engine``, ``serve.latency_quantiles``,
    ``compile.traces`` by-name) flatten one level, numeric leaves
    only.  Deterministic: keys sorted, one ``# TYPE`` line per
    metric family."""
    lines: List[str] = []
    typed: Dict[str, str] = {}

    def emit(name: str, typ: str, labels: Dict[str, str],
             value: float) -> None:
        pname = _prom_name(name)
        if pname not in typed:
            typed[pname] = typ
            lines.append(f"# TYPE {pname} {typ}")
        lines.append(f"{pname}{_prom_labels(labels)} {value!r}")

    for key in sorted(snap):
        rec = snap[key]
        name, labels = _parse_key(key)
        if isinstance(rec, bool):
            emit(name, "gauge", labels, float(rec))
        elif isinstance(rec, (int, float)):
            emit(name, "gauge", labels, float(rec))
        elif isinstance(rec, str):
            emit(name, "gauge", dict(labels, value=rec), 1.0)
        elif isinstance(rec, dict) and rec.get("type") == "counter":
            emit(name, "counter", labels, float(rec.get("value", 0.0)))
        elif isinstance(rec, dict) and rec.get("type") == "gauge":
            emit(name, "gauge", labels, float(rec.get("value", 0.0)))
        elif isinstance(rec, dict) and rec.get("type") == "histogram":
            pname = _prom_name(name)
            if pname not in typed:
                typed[pname] = "histogram"
                lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for b, c in zip(list(rec.get("buckets", [])) + ["+Inf"],
                            rec.get("counts", [])):
                cum += c
                lines.append(f"{pname}_bucket"
                             f"{_prom_labels(dict(labels, le=str(b)))}"
                             f" {cum}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} "
                         f"{float(rec.get('sum', 0.0))!r}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{int(rec.get('count', 0))}")
        elif isinstance(rec, dict):
            for sub in sorted(rec):
                v = rec[sub]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                emit(f"{name}.{sub}", "gauge", labels, float(v))
    return "\n".join(lines) + "\n"
