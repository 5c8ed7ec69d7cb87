"""Distributed dataset construction: sketch-merged bin-mapper fitting.

Counterpart of the JAX package's ``parallel/dist_data.py`` (the
reference's distributed binning, dataset_loader.cpp:1104-1186): every
rank folds its own rows into mergeable per-feature quantile sketches
(``binning.QuantileSketch``), the serialized sketches are all-gathered,
and every rank merges them in rank order and fits FindBin over the
merged summaries, so every rank gets byte-identical bin mappers that saw
every shard's rows.  ``method="shard"`` is the legacy feature-sharded
FindBin (each feature's bounds from one rank's rows).

Wire format: every all-gathered payload is framed, ``LGTF | version u16 |
length u64 | sha256[32] | body``, and unframing verifies before
unpickling (``frame_payload`` / ``unframe_payload``); a corrupt or
truncated peer payload raises ``PayloadIntegrityError``, whose message
carries the resilience classifier's retryable pattern.

The collective is ``torch.distributed.all_gather_object`` over the
default process group; the ``allgather`` hook (bytes -> every rank's
bytes) keeps it testable in one process.
"""

from __future__ import annotations

import hashlib
import pickle
from typing import Callable, List, Optional

import numpy as np

from ..binning import (BinMapper, BinType, QuantileSketch,
                       fit_mappers_from_sketches, sketch_features)
from ..config import Config

_FRAME_MAGIC = b"LGTF"
_FRAME_VERSION = 1
_HEADER_LEN = len(_FRAME_MAGIC) + 2 + 8 + 32


class PayloadIntegrityError(RuntimeError):
    """An all-gathered peer payload failed framing verification.  The
    message matches the resilience classifier's retryable patterns
    (UNAVAILABLE): a torn payload is a transport failure."""

    def __init__(self, detail: str):
        super().__init__(
            f"UNAVAILABLE: corrupt allgathered payload ({detail})")


def frame_payload(body: bytes) -> bytes:
    """``LGTF | version | length | sha256 | body``, self-verifying."""
    return (_FRAME_MAGIC
            + _FRAME_VERSION.to_bytes(2, "little")
            + len(body).to_bytes(8, "little")
            + hashlib.sha256(body).digest()
            + body)


def unframe_payload(blob: bytes) -> bytes:
    """Verify and strip a ``frame_payload`` frame; raises
    ``PayloadIntegrityError`` on a magic, version, length or sha256
    mismatch, before any byte of the body reaches ``pickle.loads``."""
    if len(blob) < _HEADER_LEN:
        raise PayloadIntegrityError(
            f"truncated header: {len(blob)} bytes < {_HEADER_LEN}")
    if blob[:4] != _FRAME_MAGIC:
        raise PayloadIntegrityError(f"bad magic {blob[:4]!r}")
    version = int.from_bytes(blob[4:6], "little")
    if version != _FRAME_VERSION:
        raise PayloadIntegrityError(
            f"unsupported frame version {version}")
    n = int.from_bytes(blob[6:14], "little")
    body = blob[_HEADER_LEN:_HEADER_LEN + n]
    if len(body) != n:
        raise PayloadIntegrityError(
            f"truncated body: header says {n} bytes, got {len(body)}")
    if hashlib.sha256(body).digest() != blob[14:46]:
        raise PayloadIntegrityError("sha256 mismatch")
    return body


def shard_features(num_features: int, num_machines: int):
    """Contiguous balanced feature slices (dataset_loader.cpp:1106-1117)."""
    step = max((num_features + num_machines - 1) // num_machines, 1)
    start, length = [0] * num_machines, [0] * num_machines
    for i in range(num_machines - 1):
        length[i] = min(step, num_features - start[i])
        start[i + 1] = start[i] + length[i]
    length[num_machines - 1] = num_features - start[num_machines - 1]
    return start, length


def torch_allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's ``payload``, in rank order, over the default
    ``torch.distributed`` group."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, payload)
    return out


def _exchange(obj, allgather: Callable[[bytes], List[bytes]]) -> List:
    """pickle -> frame -> all-gather -> verify each peer -> unpickle."""
    payload = frame_payload(pickle.dumps(obj, protocol=4))
    out = []
    for rank, blob in enumerate(allgather(payload)):
        try:
            body = unframe_payload(blob)
        except PayloadIntegrityError as e:
            raise PayloadIntegrityError(f"rank {rank}: {e}") from None
        out.append(pickle.loads(body))
    return out


def distributed_bin_mappers(
        local_sample: np.ndarray, config: Config,
        cat_idx: Optional[set] = None,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        allgather: Optional[Callable[[bytes], List[bytes]]] = None,
        method: str = "sketch") -> List[BinMapper]:
    """Globally consistent bin mappers from per-rank row samples
    ``local_sample`` [n, F] (the JAX package's function of the same name):
    the full list of F mappers, identical on every rank (module
    docstring)."""
    cat_idx = cat_idx or set()
    if process_index is None or process_count is None:
        import torch.distributed as dist
        process_index = dist.get_rank()
        process_count = dist.get_world_size()
    if allgather is None:
        allgather = torch_allgather_bytes
    if method == "sketch":
        return _sketch_bin_mappers(local_sample, config, cat_idx,
                                   allgather)
    if method != "shard":
        raise ValueError(f"unknown distributed binning method "
                         f"{method!r} (want sketch or shard)")
    f_total = local_sample.shape[1]
    start, length = shard_features(f_total, process_count)
    lo = start[process_index]
    hi = lo + length[process_index]
    own: List[dict] = []
    n = len(local_sample)
    mbf = config.max_bin_by_feature
    for f in range(lo, hi):
        m = BinMapper()
        mb = int(mbf[f]) if mbf else config.max_bin
        bt = BinType.CATEGORICAL if f in cat_idx else BinType.NUMERICAL
        m.find_bin(local_sample[:, f], n, mb, config.min_data_in_bin,
                   min_split_data=config.min_data_in_leaf,
                   pre_filter=config.feature_pre_filter, bin_type=bt,
                   use_missing=config.use_missing,
                   zero_as_missing=config.zero_as_missing)
        own.append(m.to_state())
    shards = _exchange(own, allgather)
    mappers = [BinMapper.from_state(st) for states in shards
               for st in states]
    if len(mappers) != f_total:
        raise RuntimeError(
            f"distributed binning produced {len(mappers)} mappers for "
            f"{f_total} features — rank slices out of sync")
    return mappers


def _sketch_bin_mappers(local_sample: np.ndarray, config: Config,
                        cat_idx: set,
                        allgather: Callable[[bytes], List[bytes]]
                        ) -> List[BinMapper]:
    f_total = local_sample.shape[1]
    cap = int(getattr(config, "ingest_sketch_size", 2048))
    own = [QuantileSketch(cap, categorical=(f in cat_idx))
           for f in range(f_total)]
    sketch_features(np.asarray(local_sample, np.float64), own)
    shards = _exchange([s.to_state() for s in own], allgather)
    merged: Optional[List[QuantileSketch]] = None
    for rank, states in enumerate(shards):
        if len(states) != f_total:
            raise PayloadIntegrityError(
                f"rank {rank} sent {len(states)} sketches for "
                f"{f_total} features")
        sks = [QuantileSketch.from_state(st) for st in states]
        if merged is None:
            merged = sks
        else:
            # rank-order merge: identical on every rank
            for m, s in zip(merged, sks):
                m.merge(s)
    return fit_mappers_from_sketches(merged, config, cat_idx)
