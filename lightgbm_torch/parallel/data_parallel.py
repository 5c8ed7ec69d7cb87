"""Data-parallel tree learner: rows split over the ranks.

Counterpart of the JAX package's ``parallel/data_parallel.py`` (the
reference's DataParallelTreeLearner,
data_parallel_tree_learner.cpp:13-283), on one process per rank:

- each rank holds its own contiguous rows and builds LOCAL histograms of
  every feature with the port's kernels (B1, B1-K, their integer forms);
- the owner-shard learner (the default) pads the feature axis to ``S *
  chunk`` (B1 writes straight into a zeroed padded buffer) and
  reduce-scatters it (``torch.distributed.reduce_scatter_tensor``, the
  JAX package's ``lax.psum_scatter``), so each rank keeps only its chunk
  of the GLOBAL histograms: the grower's per-leaf carry is [L, chunk, B,
  3] and the subtraction runs post-scatter on owned features.  A batched
  super-step's [K, F, B, 3] pass is laid out rank-major ([S, K, chunk, B,
  3], one strided copy of each rank's feature slice) before its scatter;
- B2 scans the owned features (the scan-space metadata of ``_localize``,
  :292-301), and the records are all-gathered and resolved to the global
  winner by B16a (``ops/split.gather_best``, the JAX package's
  ``select_best``, :274-276);
- the root's sums are one [3] all-reduce; under quantized training the
  scales are a MAX all-reduce and the rounding stream is keyed by global
  row ids (the rank's row offset: the exclusive prefix sum of the ranks'
  row counts), so the int32 histograms and every tree equal the serial
  run's bit for bit (``RowShardHooks``);
- ``owner_shard=False`` (``dp_owner_shard=false``) is the legacy learner:
  one full [F, B, 3] SUM all-reduce a pass, every rank scanning every
  feature with no select.

Every rank runs the grower's fixed step sequence, dead steps included, so
the ranks run the same collectives in the same order.  The
``collective`` fault-injection site fires at each tree's dispatch
(``_CollectiveGate``).  EFB bundles and k-hot storage under this learner
are ROADMAP A16b.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..grower import DistHooks, grow_tree, grow_tree_batched
from ..obs.comm import CommLedger
from ..ops.split import RECORD, gather_best
from .mesh import OwnerShardPlan, ProcessMesh, owner_shard_plan


class DistGrower:
    """A distributed learner's ``grow``: ``grow_tree`` (K = 1) or
    ``grow_tree_batched`` over the learner's hooks, with the JAX growers'
    ``comm`` ledger (and ``plan``, owner-shard) as attributes."""

    def __init__(self, hooks: DistHooks, split_batch: int = 1):
        self.hooks = hooks
        self.split_batch = int(split_batch)
        self.comm: CommLedger = hooks.ledger

    def __call__(self, binned, vals, feature_mask, num_bin, na_bin, **kw):
        if self.split_batch > 1:
            return grow_tree_batched(binned, vals, feature_mask, num_bin,
                                     na_bin, split_batch=self.split_batch,
                                     dist=self.hooks, **kw)
        return grow_tree(binned, vals, feature_mask, num_bin, na_bin,
                         dist=self.hooks, **kw)

    def __getattr__(self, name):
        return getattr(self.hooks, name)


class _CollectiveGate:
    """Callable pass-through hosting the ``collective`` fault-injection
    site (utils/faultinject.py) at the dispatch of each tree's
    cross-rank program; attributes delegate to the wrapped grower."""

    def __init__(self, inner):
        self._inner = inner

    def __call__(self, *args, **kwargs):
        from ..utils import faultinject
        faultinject.check("collective")
        return self._inner(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class RowShardHooks(DistHooks):
    """What the row-sharded learners share, under the learner's site
    prefix: the root sums' all-reduce, and the JAX package's
    ``_quant_hooks`` (:196-212): the tree's [3] quantization scales MAX
    all-reduced so every rank quantizes with the global scale, and the
    row offset that keys the rounding by global row ids; together they
    make the int32 histogram reduce bitwise the serial one."""

    def __init__(self, mesh: ProcessMesh, ledger: CommLedger,
                 hist_cols: int, scan_features: int, row_offset: int,
                 prefix: str):
        super().__init__(hist_cols, scan_features)
        self.mesh, self.ledger = mesh, ledger
        self.row_offset = int(row_offset)
        self.prefix = prefix

    def sum_reduce(self, t):
        return self.mesh.all_reduce(t, "sum", ledger=self.ledger,
                                    site=f"{self.prefix}.root_sum",
                                    cadence="tree")

    def scale_reduce(self, s):
        return self.mesh.all_reduce(s, "max", ledger=self.ledger,
                                    site=f"{self.prefix}.quant_scale",
                                    cadence="tree")


class OwnerShardHooks(RowShardHooks):
    """The owner-shard data-parallel learner's hooks (module
    docstring)."""

    def __init__(self, mesh: ProcessMesh, plan: OwnerShardPlan,
                 num_features: int, num_bins: int, row_offset: int,
                 device: torch.device):
        ledger = CommLedger(mesh.world_size)
        super().__init__(mesh, ledger, plan.chunk, plan.fmax, row_offset,
                         "dp")
        self.plan = plan
        self.num_features = int(num_features)
        self.num_bins = int(num_bins)
        self.device = torch.device(device)
        self.shard_feat = torch.as_tensor(plan.shard_feat).to(self.device)
        gfid = self.shard_feat[mesh.rank]
        self._ok = gfid >= 0
        self._safe = torch.clamp_min(gfid, 0).to(torch.int64)
        self._pad: Dict[torch.dtype, torch.Tensor] = {}
        self._major: Dict[tuple, torch.Tensor] = {}
        self._mono: Optional[tuple] = None

    def _padded(self, dtype: torch.dtype) -> torch.Tensor:
        buf = self._pad.get(dtype)
        if buf is None:
            buf = torch.zeros((self.mesh.world_size * self.plan.chunk,
                               self.num_bins, 3), dtype=dtype,
                              device=self.device)
            self._pad[dtype] = buf
        return buf

    def hist_out(self, dtype):
        return self._padded(dtype)[:self.num_features]

    def reduce(self, h, scales=None):
        S, chunk, F = self.mesh.world_size, self.plan.chunk, \
            self.num_features
        if h.dim() == 3:
            buf = self._padded(h.dtype)
            if h.data_ptr() != buf.data_ptr():
                buf[:F].copy_(h)
        else:
            # [K, F, B, 3] -> rank-major [S, K, chunk, B, 3]: each rank's
            # chunk of every slot contiguous for the scatter
            K = h.shape[0]
            key = (h.dtype, K)
            buf = self._major.get(key)
            if buf is None:
                buf = torch.zeros((S, K, chunk) + tuple(h.shape[2:]),
                                  dtype=h.dtype, device=h.device)
                self._major[key] = buf
            for s in range(S):
                f0, f1 = s * chunk, min(F, (s + 1) * chunk)
                if f1 > f0:
                    buf[s, :, :f1 - f0].copy_(h[:, f0:f1])
            buf = buf.view((S * K * chunk,) + tuple(h.shape[2:]))
        out = self.mesh.reduce_scatter(buf, ledger=self.ledger,
                                       site="dp.hist_reduce")
        return out if h.dim() == 3 else out.view(
            (h.shape[0], chunk) + tuple(h.shape[2:]))

    def scan_meta(self, feature_mask, num_bin, na_bin, is_cat):
        """The owned slots' metadata (the JAX package's ``_localize``):
        pad slots masked, two bins, no NA bin, numerical."""
        ok, safe = self._ok, self._safe
        two = torch.full((), 2, dtype=num_bin.dtype, device=num_bin.device)
        none = torch.full((), -1, dtype=na_bin.dtype, device=na_bin.device)
        return (feature_mask[safe] & ok,
                torch.where(ok, num_bin[safe], two).contiguous(),
                torch.where(ok, na_bin[safe], none).contiguous(),
                None if is_cat is None else (is_cat[safe] & ok))

    def scan_mono(self, mono):
        if self._mono is None or self._mono[0] is not mono:
            zero = torch.zeros((), dtype=mono.dtype, device=mono.device)
            self._mono = (mono, torch.where(self._ok, mono[self._safe],
                                            zero).contiguous())
        return self._mono[1]

    def select(self, res, active=None):
        return select_best(self.mesh, self.ledger, "dp.best_split", res,
                           active, shard_feat=self.shard_feat)


def select_best(mesh: ProcessMesh, ledger: CommLedger, site: str, res,
                active=None, *, shard_feat=None, f_local=None):
    """``SyncUpGlobalBestSplit`` (parallel_tree_learner.h:191): one
    all-gather of this rank's records (with a categorical scan, the
    records, flags and rank rows packed in one int32 tensor), then B16a
    resolves each child's winner with its global feature."""
    cat = isinstance(res, tuple)
    if cat:
        rec, flag, rank = res
        packed = torch.cat([rec.view(torch.int32), flag[:, None], rank],
                           dim=1)
    else:
        packed = res
    g = mesh.all_gather(packed, ledger=ledger, site=site)
    if cat:
        recs = g[..., :RECORD].contiguous().view(torch.float32)
        return gather_best(recs, g[..., RECORD].contiguous(),
                           g[..., RECORD + 1:].contiguous(),
                           shard_feat=shard_feat, f_local=f_local,
                           active=active)
    return gather_best(g, shard_feat=shard_feat, f_local=f_local,
                       active=active)


class FullReduceHooks(RowShardHooks):
    """The legacy data-parallel learner (``dp_owner_shard=false``): one
    full SUM all-reduce of every pass's histograms; every rank scans
    every feature and takes the same decision, so nothing is
    selected."""

    def __init__(self, mesh: ProcessMesh, num_features: int,
                 row_offset: int):
        super().__init__(mesh, CommLedger(mesh.world_size), num_features,
                         num_features, row_offset, "dp")

    def reduce(self, h, scales=None):
        return self.mesh.all_reduce(h.contiguous(), "sum",
                                    ledger=self.ledger, site="dp.hist_psum")


def make_dp_grower(mesh: ProcessMesh, *, num_features: int, num_bins: int,
                   split_batch: int = 1, owner_shard: bool = True,
                   row_offset: int = 0) -> _CollectiveGate:
    """The data-parallel ``grow`` over ``mesh`` (``DistGrower`` behind the
    ``collective`` gate; its histograms on ``mesh.device``): the
    owner-shard learner, or the full-reduce one with
    ``owner_shard=False``.  ``row_offset``: this rank's first global
    row."""
    if owner_shard:
        plan = owner_shard_plan(np.arange(int(num_features)),
                                mesh.world_size)
        hooks = OwnerShardHooks(mesh, plan, num_features, num_bins,
                                row_offset, mesh.device)
    else:
        hooks = FullReduceHooks(mesh, num_features, row_offset)
    grow = DistGrower(hooks, split_batch)
    grow.owner_shard = bool(owner_shard)
    return _CollectiveGate(grow)
