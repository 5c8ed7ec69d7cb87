"""Segment routing for serving (the JAX package's ``fleet/router.py``,
copied; it imports no JAX).

The :class:`SegmentRouter` is the thread-safe map from a request's
``segment`` key to the registry version that should serve it:

- ``assign(segment, version)`` — point one segment at a version; the
  other segments keep what they serve.
- ``resolve(segment)`` — the version for a key, falling back to the
  DEFAULT segment's version for unknown keys, and to None (the
  registry's current model) when the default is unassigned too.

The router stores version STRINGS, not ServedModel handles: resolution
re-enters the registry under its own lock, so an evicted/unloaded
version fails lookup there (and the server falls back to current)
instead of pinning a stale model alive here.  The rest of the JAX
package's ``fleet/`` (fleet training, per-segment continual promotion)
is ROADMAP A17.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple


class SegmentRouter:
    """Thread-safe segment -> model-version map with default fallback.

    Lock contract: ``_lock`` guards ``_segments`` and ``_fallbacks``.

    ``_lock`` is leaf-level: no callback, registry, or batcher call is
    ever made while holding it."""

    def __init__(self, default_segment: str = "default"):
        self._default = str(default_segment)
        self._segments: Dict[str, str] = {}
        self._fallbacks = 0
        self._lock = threading.Lock()

    @property
    def default_segment(self) -> str:
        return self._default

    def assign(self, segment: str, version: str) -> None:
        """Point ``segment`` at registry ``version`` (per-segment
        promote).  Existing in-flight requests keep the version they
        resolved; only new resolutions see the assignment."""
        with self._lock:
            self._segments[str(segment)] = str(version)

    def unassign(self, segment: str) -> Optional[str]:
        """Drop a segment's assignment (rollback to default routing).
        Returns the version it pointed at, or None."""
        with self._lock:
            return self._segments.pop(str(segment), None)

    def resolve(self, segment: Optional[str]) -> Tuple[Optional[str], bool]:
        """``(version, fell_back)`` for a request's segment key.

        ``segment=None`` (no key on the request) routes to the default
        segment's version with ``fell_back=False`` — an unsegmented
        request is not a routing miss.  An UNKNOWN key falls back the
        same way but counts (``fell_back=True``, the
        ``serve.segment_fallbacks`` metric).  Returns version None when
        neither the key nor the default segment is assigned — the
        caller serves the registry's current model."""
        with self._lock:
            if segment is None:
                return self._segments.get(self._default), False
            v = self._segments.get(str(segment))
            if v is not None:
                return v, False
            self._fallbacks += 1
            return self._segments.get(self._default), True

    def drop_version(self, version: str) -> List[str]:
        """Remove every assignment pointing at ``version`` (called when
        the registry unloads/evicts it).  Returns the segments
        dropped."""
        with self._lock:
            gone = [s for s, v in self._segments.items() if v == version]
            for s in gone:
                self._segments.pop(s)
            return gone

    def fallbacks(self) -> int:
        """Unknown-segment resolutions served by the default so far."""
        with self._lock:
            return self._fallbacks

    def snapshot(self) -> Dict[str, str]:
        """Copy of the segment -> version map (metrics / admin)."""
        with self._lock:
            return dict(self._segments)
