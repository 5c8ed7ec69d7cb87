"""Bytes-on-the-wire accounting for the collective call sites of the
distributed learners.

Counterpart of the JAX package's ``obs/comm.py`` ``CommLedger``: a
learner routes each collective through its ledger (by way of the
``parallel.mesh.ProcessMesh`` that runs it), which records the site's
static row, (site, collective, payload bytes, wire-byte estimate,
cadence), the ``grow.comm`` table the JAX growers expose.  The JAX
package records the row once at trace time; here every call re-records
it (the same row for the same shapes) and also counts the site's calls,
its payload bytes, and, when the mesh times its collectives, its
milliseconds.

Wire-byte model (ring algorithms, as the JAX package's):

- all-reduce (``psum``, ``pmax``): ``2 * (n-1)/n * payload`` per rank
- reduce-scatter (``psum_scatter``): ``(n-1)/n * input payload``
- all-gather: ``(n-1)/n * output payload``

Cadence says how often a site runs: ``"step"`` once per grower step
(histogram reduce, best-split select), ``"tree"`` once per tree (root
totals, quantization scales).  The port's grower runs its fixed step
sequence, dead steps included, so a tree of L leaves calls each step
site L - 1 times (strict) whatever ``n_steps`` it grew;
``bytes_per_iteration`` keeps the JAX package's formula over the steps a
caller passes.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple


class CommSite(NamedTuple):
    site: str             # stable call-site name, e.g. "dp.hist_reduce"
    collective: str       # psum | pmax | psum_scatter | all_gather
    payload_bytes: int    # tensor bytes entering the collective
    wire_bytes: int       # estimated bytes crossing the wire per rank
    axis_size: int
    cadence: str          # "step" | "tree"


def wire_bytes(collective: str, payload: int, n: int) -> int:
    """Per-rank wire bytes under the ring model (module docstring)."""
    if n <= 1:
        return 0
    frac = (n - 1) / n
    if collective in ("psum", "pmax"):
        return int(2 * frac * payload)
    return int(frac * payload)


def nbytes(shape, itemsize: int) -> int:
    return int(math.prod(shape)) * int(itemsize)


class CommLedger:
    """One learner's collective ledger (module docstring)."""

    def __init__(self, axis_size: int):
        self.axis_size = int(axis_size)
        self._sites: Dict[str, CommSite] = {}
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.ms: Dict[str, float] = {}

    def record(self, site: str, collective: str, payload: int,
               cadence: str = "step", wire_payload: int = None) -> None:
        """The site's static row and one call of ``payload`` bytes
        (``wire_payload``: the all-gather's output bytes)."""
        self._sites[site] = CommSite(
            site=site, collective=collective, payload_bytes=int(payload),
            wire_bytes=wire_bytes(collective,
                                  payload if wire_payload is None
                                  else wire_payload, self.axis_size),
            axis_size=self.axis_size, cadence=cadence)
        self.calls[site] = self.calls.get(site, 0) + 1
        self.bytes[site] = self.bytes.get(site, 0) + int(payload)

    def add_ms(self, site: str, ms: float) -> None:
        self.ms[site] = self.ms.get(site, 0.0) + float(ms)

    def sites(self) -> Tuple[CommSite, ...]:
        return tuple(self._sites[k] for k in sorted(self._sites))

    def bytes_per_iteration(self, n_steps: int) -> int:
        """Estimated wire bytes of one boosting iteration whose grower ran
        ``n_steps`` step-cadence calls of each step site."""
        return sum(s.wire_bytes * (n_steps if s.cadence == "step" else 1)
                   for s in self.sites())
