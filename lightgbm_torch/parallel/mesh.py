"""The process group of distributed training, and its collectives.

Counterpart of the JAX package's ``parallel/mesh.py``.  The JAX package
shards one program over a device mesh and lets XLA lower ``lax.psum``,
``psum_scatter``, ``pmax`` and ``all_gather`` to the interconnect's
collectives.  The port runs one process per rank (SPMD, the JAX
package's one-controller-per-host mode): each rank holds its own rows and
runs the port's kernels on its own card, or on the CPU when asked, and
the collectives are ``torch.distributed`` calls on one ``ProcessMesh``:

- ``all_reduce`` (SUM for ``psum``, MAX for ``pmax``), in place;
- ``reduce_scatter`` (``psum_scatter`` over the leading axis, tiled);
- ``all_gather`` (a new leading rank axis).

The backend is NCCL when every rank has a card of its own, gloo on the
CPU.  Gloo moves host tensors: with the gloo backend and a tensor on the
card (ranks that share one card, where NCCL refuses two ranks on one
device) the mesh stages every operation through pinned host buffers, by
that rule and no other; ``staged`` names the operations it staged.  Each
call goes through the learner's ``obs.comm.CommLedger`` under its site
name; with ``timed`` set, each call is bracketed by device
synchronisations and its milliseconds go to the ledger too.

``owner_shard_plan`` (numpy, the JAX package's :49-93) chunks the
histogram's feature axis for the data-parallel reduce-scatter.
"""

from __future__ import annotations

import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.comm import CommLedger, nbytes


class OwnerShardPlan(NamedTuple):
    """Owner-shard chunking of the histogram (feature) axis for the
    data-parallel reduce-scatter (data_parallel_tree_learner.cpp:174-186:
    after ``Network::ReduceScatter`` each rank holds only its features'
    global histograms).

    chunk:      histogram rows owned per rank, ``ceil(G / n_shards)``
    fmax:       split-scan width per rank, the most features a rank owns
    shard_feat: [n_shards, fmax] int32, the global feature id behind each
                rank's local scan slot; -1 = padding (scan-masked)
    """
    chunk: int
    fmax: int
    shard_feat: np.ndarray

    @property
    def n_shards(self) -> int:
        return self.shard_feat.shape[0]

    def hist_bytes(self, num_leaves: int, padded_bins: int,
                   scratch: int = 0) -> int:
        """Per-rank histogram-state bytes at a leaf budget (f32 g/h/c)."""
        return (num_leaves + scratch) * self.chunk * padded_bins * 3 * 4


def owner_shard_plan(group_of: np.ndarray, n_shards: int) -> OwnerShardPlan:
    """Partition the histogram axis (EFB groups; features when unbundled,
    ``group_of`` the identity) into ``n_shards`` equal chunks and map every
    owned group back to its global feature ids."""
    group_of = np.asarray(group_of, np.int64)
    g = int(group_of.max()) + 1 if group_of.size else 1
    chunk = -(-g // n_shards)
    owned = [np.nonzero((group_of >= s * chunk)
                        & (group_of < (s + 1) * chunk))[0]
             for s in range(n_shards)]
    fmax = max(1, max(len(o) for o in owned))
    shard_feat = np.full((n_shards, fmax), -1, np.int32)
    for s, o in enumerate(owned):
        shard_feat[s, :len(o)] = o
    return OwnerShardPlan(chunk=chunk, fmax=fmax, shard_feat=shard_feat)


class ProcessMesh:
    """One rank's view of a one-axis process group (module docstring):
    ``world_size``, ``rank``, ``axis`` name, ``group`` (None: the default
    group), ``backend`` and ``device``, with the collectives."""

    def __init__(self, group=None, axis: str = "data",
                 device: Optional[torch.device] = None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group
        self.world_size = int(dist.get_world_size(group))
        self.rank = int(dist.get_rank(group))
        self.axis = axis
        self.backend = str(dist.get_backend(group))
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.timed = False
        self.staged: Dict[str, int] = {}
        self._pinned: Dict[Tuple, torch.Tensor] = {}

    def _stages(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def _host(self, t: torch.Tensor, key: str) -> torch.Tensor:
        """A pinned host buffer of ``t``'s shape and dtype (one per key,
        shape and dtype, kept across calls)."""
        k = (key, tuple(t.shape), t.dtype)
        buf = self._pinned.get(k)
        if buf is None:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf

    def _call(self, ledger: Optional[CommLedger], site: str, fn):
        if not self.timed:
            return fn()
        sync = self.device.type == "cuda"
        if sync:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize(self.device)
        if ledger is not None:
            ledger.add_ms(site, (time.perf_counter() - t0) * 1e3)
        return out

    def _note_stage(self, op: str) -> None:
        self.staged[op] = self.staged.get(op, 0) + 1

    def all_reduce(self, t: torch.Tensor, op: str = "sum", *,
                   ledger: Optional[CommLedger] = None, site: str = "",
                   cadence: str = "step") -> torch.Tensor:
        """``t`` summed (``op="sum"``, ``psum``) or maxed (``"max"``,
        ``pmax``) over the ranks, in place; returns ``t``."""
        d = self._dist
        red = d.ReduceOp.SUM if op == "sum" else d.ReduceOp.MAX
        if ledger is not None:
            ledger.record(site, "psum" if op == "sum" else "pmax",
                          nbytes(t.shape, t.element_size()), cadence)

        def run():
            if self._stages(t):
                self._note_stage(f"all_reduce_{op}")
                h = self._host(t, "ar")
                h.copy_(t)
                d.all_reduce(h, op=red, group=self.group)
                t.copy_(h)
            else:
                d.all_reduce(t, op=red, group=self.group)
            return t
        return self._call(ledger, site, run)

    def reduce_scatter(self, t: torch.Tensor, *,
                       ledger: Optional[CommLedger] = None, site: str = "",
                       out: Optional[torch.Tensor] = None,
                       cadence: str = "step") -> torch.Tensor:
        """``t`` [S * chunk, ...] summed over the ranks, this rank's
        chunk [chunk, ...] (``psum_scatter``, ``tiled=True``, dimension
        0) into ``out`` (a new tensor when None)."""
        d = self._dist
        scatter = getattr(d, "reduce_scatter_single", None) \
            or d.reduce_scatter_tensor
        S = self.world_size
        if t.shape[0] % S or not t.is_contiguous():
            raise ValueError("reduce_scatter needs a contiguous tensor "
                             "whose leading axis divides over the ranks")
        shape = (t.shape[0] // S,) + tuple(t.shape[1:])
        if out is None:
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
        if ledger is not None:
            ledger.record(site, "psum_scatter",
                          nbytes(t.shape, t.element_size()), cadence)

        def run():
            if self._stages(t):
                self._note_stage("reduce_scatter")
                hi, ho = self._host(t, "rs_in"), self._host(out, "rs_out")
                hi.copy_(t)
                scatter(ho, hi, group=self.group)
                out.copy_(ho)
            else:
                scatter(out, t, group=self.group)
            return out
        return self._call(ledger, site, run)

    def all_gather(self, t: torch.Tensor, *,
                   ledger: Optional[CommLedger] = None, site: str = "",
                   cadence: str = "step") -> torch.Tensor:
        """[S, *t.shape]: every rank's ``t``, in rank order."""
        d = self._dist
        gather = getattr(d, "all_gather_single", None) \
            or d.all_gather_into_tensor
        t = t.contiguous()
        # the ranks' tensors laid end to end on the leading axis (the form
        # every backend takes), viewed [S, *t.shape] on return
        out = torch.empty((self.world_size * t.shape[0],)
                          + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        if ledger is not None:
            payload = nbytes(t.shape, t.element_size())
            ledger.record(site, "all_gather", payload, cadence,
                          wire_payload=payload * self.world_size)

        def run():
            if self._stages(t):
                self._note_stage("all_gather")
                hi, ho = self._host(t, "ag_in"), self._host(out, "ag_out")
                hi.copy_(t)
                gather(ho, hi, group=self.group)
                out.copy_(ho)
            else:
                gather(out, t, group=self.group)
            return out.view((self.world_size,) + tuple(t.shape))
        return self._call(ledger, site, run)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order (host set-up
        only)."""
        out = [None] * self.world_size
        self._dist.all_gather_object(out, obj, group=self.group)
        return out


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), group=None,
              device=None) -> ProcessMesh:
    """The mesh of the initialised process group (``init_distributed``):
    one axis over its ranks.  ``shape`` = None uses every rank; a shape
    must name one axis of the group's size."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no torch.distributed process group: call "
                           "parallel.init_distributed (or launch.init) "
                           "first")
    n = dist.get_world_size(group)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        if len(shape) != 1 or shape[0] != n:
            raise ValueError(f"mesh shape {list(shape)} does not match the "
                             f"process group of {n} ranks (one axis)")
    return ProcessMesh(group, axis_names[0], device)


def default_mesh(num: Optional[int] = None) -> ProcessMesh:
    return make_mesh(None if num is None else (num,))


def default_backend(device_type: str) -> str:
    """NCCL when the ranks train on cards, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     retries: int = 2,
                     timeout_s: float = 300.0) -> None:
    """``torch.distributed.init_process_group`` (the ``LGBM_NetworkInit``
    analog) under the resilience layer: ``retries`` jittered-backoff
    re-attempts of classified-transient failures within ``timeout_s``,
    with a watchdog that dumps every thread's stack if the bring-up
    wedges.  With no ``init_method`` the group reads the usual
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  ``backend`` None: NCCL when a card is visible, else
    gloo.  A no-op when a group exists."""
    import torch.distributed as dist

    from ..utils import faultinject
    from ..utils.resilience import RetryPolicy, Watchdog, retry_call

    if dist.is_initialized():
        return
    if backend is None:
        backend = default_backend(
            "cuda" if torch.cuda.is_available() else "cpu")
    kw = {"backend": backend}
    if init_method is not None:
        kw.update(init_method=init_method, world_size=int(world_size),
                  rank=int(rank))

    def _bring_up():
        faultinject.check("device_claim")
        dist.init_process_group(**kw)

    policy = RetryPolicy(max_attempts=max(1, int(retries) + 1),
                         deadline_s=float(timeout_s))
    with Watchdog(timeout_s, label="torch.distributed bring-up"):
        retry_call(_bring_up, policy=policy,
                   label="torch.distributed bring-up")
