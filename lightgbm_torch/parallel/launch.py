"""Multi-process training bring-up: the Dask-layer analog.

Counterpart of the JAX package's ``parallel/launch.py``: initialise the
process group, then run the SAME training call on every rank with its
own rows (SPMD).  Typical use, the same script on every rank::

    import lightgbm_torch as lgt
    from lightgbm_torch.parallel import launch

    launch.init(machines="10.0.0.1:12400,10.0.0.2:12400")
    shard = launch.row_shard(x, y)           # this rank's rows
    mappers = launch.global_bin_mappers(shard.sample(200_000), config)
    ds = lgt.Dataset(shard.x, label=shard.y, bin_mappers=mappers)
    bst = lgt.train({"tree_learner": "data", ...}, ds)
"""

from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Optional

import numpy as np

from ..config import Config


class RowShard(NamedTuple):
    """This rank's rows.  ``weight`` and the global row range
    ``[row_start, row_stop)`` are filled by ``row_shard`` (``row_stop``
    0 where the placement is unknown)."""
    x: np.ndarray
    y: Optional[np.ndarray]
    process_index: int
    process_count: int
    weight: Optional[np.ndarray] = None
    row_start: int = 0
    row_stop: int = 0

    def sample(self, cnt: int, seed: int = 3) -> np.ndarray:
        from ..dataset import _sample_rows
        rng = np.random.RandomState(seed + self.process_index)
        n = len(self.x)
        if cnt >= n:
            return self.x
        return self.x[_sample_rows(rng, n, cnt)]


def _rank_in(machines: str) -> int:
    import socket
    entries = [m.strip() for m in machines.split(",") if m.strip()]
    names = {socket.gethostname(), "127.0.0.1", "localhost"}
    try:
        names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    for i, e in enumerate(entries):
        if e.rsplit(":", 1)[0] in names:
            return i
    raise ValueError(f"local host not found in machines={machines!r}")


def init(init_method: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         machines: Optional[str] = None,
         local_listen_port: int = 12400,
         backend: Optional[str] = None,
         retries: int = 2,
         timeout_s: float = 300.0) -> None:
    """Bring up ``torch.distributed`` (``LGBM_NetworkInit``).
    ``machines`` takes the reference's ``ip1:port1,ip2:port2`` form: the
    first entry is the rendezvous (``tcp://ip1:port1``), the rank count is
    the entry count, and the rank is the local host's entry unless
    ``process_id`` names it.  With neither ``init_method`` nor
    ``machines``, the usual environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) is read when it is set; otherwise this is
    a single process and nothing is brought up.  ``backend`` None: NCCL
    with a card, gloo without (``mesh.init_distributed``)."""
    import torch.distributed as dist

    from .mesh import init_distributed
    if dist.is_available() and dist.is_initialized():
        return
    if machines:
        entries = [m.strip() for m in machines.split(",") if m.strip()]
        if init_method is None:
            host, port = entries[0].rsplit(":", 1)
            init_method = f"tcp://{host}:{port or local_listen_port}"
        if num_processes is None:
            num_processes = len(entries)
        if process_id is None:
            process_id = _rank_in(machines)
    if init_method is None and not all(
            k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT",
                                      "WORLD_SIZE", "RANK")):
        return
    init_distributed(init_method, num_processes, process_id, backend,
                     retries=retries, timeout_s=timeout_s)


def row_shard(x: np.ndarray, y: Optional[np.ndarray] = None,
              process_index: Optional[int] = None,
              process_count: Optional[int] = None,
              weight: Optional[np.ndarray] = None) -> RowShard:
    """This rank's contiguous rows of a globally loaded array
    (``np.array_split`` order, dataset_loader.cpp:203-298)."""
    if process_index is None or process_count is None:
        import torch.distributed as dist
        on = dist.is_available() and dist.is_initialized()
        process_index = dist.get_rank() if on else 0
        process_count = dist.get_world_size() if on else 1
    idx = np.array_split(np.arange(len(x)), process_count)[process_index]
    return RowShard(x=x[idx], y=None if y is None else y[idx],
                    process_index=process_index,
                    process_count=process_count,
                    weight=None if weight is None
                    else np.asarray(weight)[idx],
                    row_start=int(idx[0]) if len(idx) else 0,
                    row_stop=int(idx[-1]) + 1 if len(idx) else 0)


def global_bin_mappers(local_sample: np.ndarray, config: Config,
                       cat_idx: Optional[set] = None,
                       allgather: Optional[Callable] = None) -> List:
    """Globally consistent bin mappers from per-rank samples
    (``dist_data.distributed_bin_mappers``)."""
    from .dist_data import distributed_bin_mappers
    return distributed_bin_mappers(local_sample, config, cat_idx=cat_idx,
                                   allgather=allgather)
