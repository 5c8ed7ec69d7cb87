"""Batched low-latency inference serving (the JAX package's ``serve/``).

- ``engine``    predictor engine: the ensemble flattened ONCE into packed
                structure-of-arrays device tables, rows binned into
                model-derived bin space, the whole-forest walk on the card
                (kernel B10a) in power-of-two row buckets; under
                ``serve_device_binning`` the whole batch — bin, walk,
                accumulate — is ONE kernel (B10c) with one score fetch.
- ``batcher``   micro-batching queue: a worker thread coalesces
                concurrent requests under ``serve_max_batch`` /
                ``serve_max_wait_ms`` with a bounded queue and explicit
                reject-with-retry-after backpressure.
- ``registry``  versioned model registry with atomic hot swap.
- ``breaker``   serving circuit breaker (``utils/resilience``).
- ``server``    in-process ``Server`` API + stdlib-only HTTP frontend
                (``/predict``, ``/healthz``, ``/metrics``, ``/drain``,
                ``/reload``).
"""

from __future__ import annotations

from .batcher import (BacklogFull, BatcherClosed, BatcherDraining,
                      DeadlineExceeded, MicroBatcher)
from .breaker import CircuitOpen, ServeBreaker
from .engine import EngineUnsupported, PredictorEngine
from .registry import (ArtifactVerificationError, ModelRegistry,
                       NoModelError, ServedModel)
from .server import Server, start_http

__all__ = [
    "ArtifactVerificationError", "BacklogFull", "BatcherClosed",
    "BatcherDraining", "CircuitOpen", "DeadlineExceeded",
    "EngineUnsupported", "MicroBatcher", "ModelRegistry", "NoModelError",
    "PredictorEngine", "ServeBreaker", "ServedModel", "Server",
    "start_http",
]
