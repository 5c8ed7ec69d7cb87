"""Observability: the metrics registry the server reads (``metrics``).
Tracing, telemetry sessions, the flight recorder and the roofline join
are ROADMAP A15."""

from .metrics import MetricsRegistry

__all__ = ["MetricsRegistry"]
