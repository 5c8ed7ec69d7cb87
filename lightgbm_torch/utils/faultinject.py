"""Deterministic fault injection (the JAX package's ``utils/faultinject.py``).

Named injection sites are one dict-empty check when nothing is armed and
fire according to a spec from the ``LGBM_TPU_FAULTS`` environment
variable or :func:`configure`::

    LGBM_TPU_FAULTS="hist_sdc:3,score_sdc:5"

Spec grammar — comma-separated ``site:hits[:action]`` entries:

- ``hits``: which occurrences of the site fire, counted from 1 — ``3``
  (exactly the 3rd hit), ``1-2`` (hits 1 and 2), ``4-`` (hit 4 onward).
- ``action`` (optional): ``raise`` (default — :class:`InjectedFault`),
  ``kill`` (:class:`InjectedKill`, a BaseException that ``except
  Exception`` cannot swallow), ``exit`` (``os._exit(23)``), ``hang``
  (the site blocks for ``LGBM_TPU_FAULT_HANG_S`` seconds, default 30) or
  ``bitflip`` (one deterministic bit of the named tensor flips, at the
  sites wired through :func:`maybe_bitflip`).  ``snapshot_kill``
  defaults to ``kill``; ``collective_hang``, ``claim_wedge`` and
  ``ingest_hang`` to ``hang``; ``hist_sdc`` and ``score_sdc`` to
  ``bitflip``.

The grammar knows every site of the JAX package (``KNOWN_SITES``), so a
spec written for it parses here.  The port wires four of them: the
computation-integrity layer's substrate (``integrity.py``) and the
distributed learners' (``parallel/``):

================  ========================================================
``hist_sdc``      the grower's output (``models/fused.py``, the checked
                  iteration): one bit of the new tree's ``leaf_count[0]``
                  word flips in the tree buffer
``score_sdc``     the score-update delta of the checked iteration
                  (``models/fused.py``)
``collective``    each tree's dispatch to a distributed learner
                  (``parallel/data_parallel._CollectiveGate``)
``device_claim``  the process group's bring-up
                  (``parallel/mesh.init_distributed``)
================  ========================================================

The other sites are wired with the modules that hold them (snapshots,
ROADMAP A12; elastic training and ingest, A16b; the rest of A17).
"""

from __future__ import annotations

import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

ENV_VAR = "LGBM_TPU_FAULTS"

KNOWN_SITES = ("device_claim", "collective", "snapshot_write",
               "snapshot_kill", "nan_grads", "serve_batch",
               "serve_reload", "serve_self_check", "continual_append",
               "continual_boost", "continual_publish",
               "continual_promote", "shadow_probe", "collective_hang",
               "host_loss", "claim_wedge", "ingest_read",
               "ingest_checksum", "ingest_hang", "hist_sdc",
               "score_sdc")

# sites whose realistic failure mode is a wedge, not an error
_HANG_DEFAULT_SITES = ("collective_hang", "claim_wedge", "ingest_hang")

# sites whose realistic failure mode is silent data corruption: the
# device keeps running and hands back a wrong number (maybe_bitflip)
_BITFLIP_DEFAULT_SITES = ("hist_sdc", "score_sdc")

# how long a firing ``hang`` action blocks
HANG_ENV_VAR = "LGBM_TPU_FAULT_HANG_S"


def _hang_seconds() -> float:
    try:
        return float(os.environ.get(HANG_ENV_VAR, "") or 30.0)
    except ValueError:
        return 30.0


class InjectedFault(RuntimeError):
    """Raised by a firing site; the message carries the retryable
    patterns of ``utils/resilience.is_retryable_device_error``."""

    def __init__(self, site: str, hit: int):
        self.site = site
        self.hit = hit
        super().__init__(
            f"injected fault at site '{site}' (hit {hit}): UNAVAILABLE: "
            "simulated device claim/backend failure")


class InjectedKill(BaseException):
    """Simulated process death at a site (a BaseException, so ``except
    Exception`` recovery paths cannot swallow it)."""

    def __init__(self, site: str, hit: int):
        self.site = site
        self.hit = hit
        super().__init__(f"injected kill at site '{site}' (hit {hit})")


# site -> (first_hit, last_hit_or_None_for_open_end, action)
_spec: Dict[str, Tuple[int, Optional[int], str]] = {}
_hits: Dict[str, int] = {}


def configure(spec: Optional[str]) -> None:
    """Install a fault spec (replacing any active one) and reset all hit
    counters.  ``None``/empty disables injection entirely."""
    _spec.clear()
    _hits.clear()
    if not spec:
        return
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (2, 3):
            raise ValueError(f"bad fault spec entry {entry!r} "
                             "(want site:hits[:action])")
        site, hits_s = parts[0].strip(), parts[1].strip()
        if len(parts) == 3:
            action = parts[2].strip()
        elif site == "snapshot_kill":
            action = "kill"
        elif site in _HANG_DEFAULT_SITES:
            action = "hang"
        elif site in _BITFLIP_DEFAULT_SITES:
            action = "bitflip"
        else:
            action = "raise"
        if site not in KNOWN_SITES:
            raise ValueError(f"unknown fault site {site!r} "
                             f"(known: {', '.join(KNOWN_SITES)})")
        if action not in ("raise", "kill", "exit", "hang", "bitflip"):
            raise ValueError(f"unknown fault action {action!r}")
        if "-" in hits_s:
            lo_s, hi_s = hits_s.split("-", 1)
            lo = int(lo_s)
            hi = int(hi_s) if hi_s else None
        else:
            lo = hi = int(hits_s)
        if lo < 1 or (hi is not None and hi < lo):
            raise ValueError(f"bad hit range in {entry!r}")
        _spec[site] = (lo, hi, action)


def clear() -> None:
    """Disable injection and reset counters."""
    configure(None)


def enabled() -> bool:
    """Whether any site is armed (the fused paths refuse then: no
    injection site fires inside a captured graph)."""
    return bool(_spec)


def hits(site: str) -> int:
    """How many times ``site`` was reached since configure()."""
    return _hits.get(site, 0)


def _advance(site: str) -> Tuple[bool, int, str]:
    """Count a hit; return (fires, hit_index, action)."""
    if site not in _spec:
        return False, 0, "raise"
    n = _hits.get(site, 0) + 1
    _hits[site] = n
    lo, hi, action = _spec[site]
    return (n >= lo and (hi is None or n <= hi)), n, action


def _act(site: str, n: int, action: str) -> None:
    """The non-bitflip actions of a firing site."""
    if action == "exit":
        os._exit(23)
    if action == "kill":
        raise InjectedKill(site, n)
    if action == "hang":
        import time
        time.sleep(_hang_seconds())
        return
    raise InjectedFault(site, n)


def check(site: str) -> None:
    """Raise, exit or hang if ``site`` fires on this hit (its action);
    nothing otherwise."""
    if not _spec:
        return
    fire, n, action = _advance(site)
    if fire:
        _act(site, n, action)


def bitflip_choice(site: str, hit: int, size: int, floating: bool,
                   index: Optional[int] = None) -> Tuple[int, int]:
    """(element, bit) that hit ``hit`` of ``site`` flips in a flat tensor
    of ``size`` elements, from ``crc32(site:hit)`` as the JAX package
    draws them: the element ``seed % size`` (or ``index % size``), the bit
    ``(seed >> 8) % 31`` for an integer tensor and ``8 + (seed >> 8) %
    23`` for f32 (at least 256 ulps, never hidden inside
    ``integrity_ulp_tol``); the sign bit is never flipped."""
    seed = zlib.crc32(f"{site}:{hit}".encode())
    size = max(int(size), 1)
    idx = (seed if index is None else int(index)) % size
    bit = 8 + (seed >> 8) % 23 if floating else (seed >> 8) % 31
    return idx, bit


def maybe_bitflip(site: str, t: torch.Tensor,
                  index: Optional[int] = None) -> torch.Tensor:
    """SDC injection: count a hit at ``site``; when it fires with action
    ``bitflip``, flip exactly one bit of ``t`` in place (the element and
    bit of ``bitflip_choice``, the JAX package's for the same
    ``site:hit``) and return it.  In place, where the JAX function
    returns a new array: the port's sites corrupt the buffer the
    iteration goes on to read (the tree buffer, the delta).  Returns
    ``t`` untouched when the site is unarmed or this hit does not fire.
    A non-``bitflip`` action on an armed site still applies.  ``t`` is
    f32 or an integer tensor, contiguous."""
    if site not in _spec:
        return t
    fire, n, action = _advance(site)
    if not fire:
        return t
    if action != "bitflip":
        _act(site, n, action)
        return t
    floating = t.is_floating_point()
    if floating and t.dtype != torch.float32:
        raise TypeError(f"maybe_bitflip: unsupported dtype {t.dtype} at "
                        f"site '{site}'")
    if t.dtype == torch.bool or t.is_complex() or not t.is_contiguous():
        raise TypeError(f"maybe_bitflip: unsupported tensor ({t.dtype}) "
                        f"at site '{site}'")
    flat = t.view(-1)
    idx, bit = bitflip_choice(site, n, flat.numel(), floating, index)
    if floating:
        words = flat.view(torch.int32)
        words[idx] ^= 1 << bit
    else:
        # the int32 mask cast to the tensor's type (numpy's wrap-around,
        # as ``mask.astype(dtype)`` in the JAX package)
        np_dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        mask = int(np.array(1 << bit, np.int64).astype(np.int32)
                   .astype(np_dtype))
        flat[idx] ^= mask
    return t


# arm from the environment at import
configure(os.environ.get(ENV_VAR))
