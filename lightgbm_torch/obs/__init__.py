"""Observability: the metrics registry the server reads (``metrics``)
and the distributed learners' collective ledger (``comm``).  Tracing,
telemetry, the flight recorder and the roofline join are ROADMAP A15."""

from .metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
