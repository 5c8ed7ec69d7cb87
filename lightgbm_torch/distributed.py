"""Cluster orchestration: the reference's Dask-layer analog, one process per
rank.

Counterpart of the JAX package's ``distributed.py`` (the reference's
dask.py ``_train``: allocate one port per worker, build the
``machines=ip1:port1,ip2:port2`` parameter, run one trainer per worker).
Two halves:

- ``run``, the launcher: spawns N coordinated worker processes on this
  machine (``python -m lightgbm_torch.distributed``), each of which brings
  up the process group (``parallel.launch.init``) over a free localhost
  port and calls the entry; the results come back rank-ordered.  With a
  ``nccl`` group each worker takes card ``rank % device_count``.  The
  kernels are built before the spawn (``_kernels.build_all``) when a card
  is visible, and the workers only load them: a worker never builds.
- ``train``, the per-worker trainer: every rank calls it identically; it
  keeps the rank's contiguous rows (every row under
  ``tree_learner=feature``), fits globally consistent bin mappers
  (``parallel/dist_data.py``) and trains with ``tree_learner=data`` (the
  default) over the process group.  Each rank evaluates the full valid set
  it is given.

Worker functions are addressed as ``"module:function"``, receive a
``WorkerContext`` and may return any picklable result.  The ``Distributed*``
sklearn estimators wait for the port's ``sklearn.py`` (ROADMAP A17).
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List, NamedTuple, Optional

import numpy as np


class WorkerContext(NamedTuple):
    """What every spawned worker receives: its rank, the worker count,
    the ``machines`` string and its own port."""
    rank: int
    num_workers: int
    machines: str            # "host1:port1,host2:port2" (config.h machines)
    local_listen_port: int


def _free_ports(n: int) -> List[int]:
    """n distinct free localhost ports."""
    socks, ports = [], []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
    finally:
        for s in socks:
            s.close()
    return ports


def build_machines(hosts: List[str], ports: List[int]) -> str:
    """The reference ``machines`` parameter (config.h; dask.py:700)."""
    return ",".join(f"{h}:{p}" for h, p in zip(hosts, ports))


def run(entry: str, num_workers: int = 2, *,
        backend: str = "gloo",
        args: Any = None,
        timeout: int = 600,
        extra_pythonpath: Optional[List[str]] = None) -> List[Any]:
    """Spawn ``num_workers`` coordinated processes on this machine and
    return their results rank-ordered.

    entry: ``"module:function"``, called as ``function(ctx)``, or
      ``function(ctx, args)`` when ``args`` is given.
    backend: the process group's, ``gloo`` (CPU ranks, or ranks that
      share a card) or ``nccl`` (a card per rank).
    extra_pythonpath: directories the workers import from besides the
      package's own root.
    """
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, not {backend!r}")
    import torch
    if torch.cuda.is_available():
        # the workers load what is built here and never build
        from . import _kernels
        _kernels.build_all()
    ports = _free_ports(num_workers)
    machines = build_machines(["127.0.0.1"] * num_workers, ports)
    tmp = tempfile.mkdtemp(prefix="lgbt_dist_")
    from ._kernels import NO_BUILD_ENV
    env = dict(os.environ)
    env[NO_BUILD_ENV] = "1"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        list(extra_pythonpath or []) + [root]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    args_path = ""
    if args is not None:
        args_path = os.path.join(tmp, "args.pkl")
        with open(args_path, "wb") as f:
            pickle.dump(args, f)
    # worker output goes to files, not pipes: a worker blocked on a full
    # pipe would stall its collectives and with them every other worker
    procs, logs = [], []
    for rank in range(num_workers):
        cmd = [sys.executable, "-m", "lightgbm_torch.distributed",
               "--entry", entry, "--rank", str(rank),
               "--num-workers", str(num_workers), "--machines", machines,
               "--result", os.path.join(tmp, f"r{rank}.pkl"),
               "--backend", backend]
        if args_path:
            cmd += ["--args", args_path]
        log = open(os.path.join(tmp, f"r{rank}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(cmd, env=env, stdout=log,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        for q in procs:
            q.wait()
        raise
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    outs = []
    for log in logs:
        log.flush()
        log.seek(0)
        outs.append(log.read())
        log.close()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {rank} failed (rc={p.returncode}):\n{out[-3000:]}")
    results = []
    for rank in range(num_workers):
        with open(os.path.join(tmp, f"r{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    shutil.rmtree(tmp, ignore_errors=True)
    return results


def train(params: dict, x: np.ndarray, y: Optional[np.ndarray] = None, *,
          weight: Optional[np.ndarray] = None,
          num_boost_round: int = 100,
          shard_rows: bool = True,
          sample_count: int = 200_000,
          valid: Optional[tuple] = None):
    """The per-worker SPMD trainer: every rank calls it identically and
    gets the (replicated) Booster.  ``params`` may carry ``machines`` and
    ``local_listen_port``: the process group is then brought up here.
    ``shard_rows``: ``x``/``y`` are the global arrays and each rank keeps
    its contiguous rows (every row under ``tree_learner=feature``); False
    when each rank loaded its own rows.  ``valid`` = (x, y): the valid set
    every rank evaluates in full."""
    import torch.distributed as dist

    from . import Dataset, train as _engine_train
    from .config import Config
    from .parallel import launch

    p = dict(params)
    machines = str(p.pop("machines", "") or "")
    port = int(p.pop("local_listen_port", 12400) or 12400)
    if machines:
        launch.init(machines=machines, local_listen_port=port,
                    retries=int(p.get("dist_init_retries", 2)),
                    timeout_s=float(p.get("dist_init_timeout_s", 300.0)))
    world = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    if world > 1:
        rank = dist.get_rank()
        p.setdefault("num_machines", world)
        p.setdefault("tree_learner", "data")
        if shard_rows and p["tree_learner"] != "feature":
            sh = launch.row_shard(x, y, rank, world, weight=weight)
            weight = sh.weight
        else:
            sh = launch.RowShard(x=x, y=y, process_index=rank,
                                 process_count=world)
        cfg = Config(dict(p, num_iterations=num_boost_round))
        cat_spec = str(getattr(cfg, "categorical_feature", "") or "")
        cat = {int(t) for t in cat_spec.split(",") if t.strip().isdigit()} \
            or None
        mappers = launch.global_bin_mappers(sh.sample(sample_count), cfg,
                                            cat_idx=cat)
        ds = Dataset(sh.x, label=sh.y, weight=weight, params=p,
                     bin_mappers=mappers)
    else:
        ds = Dataset(x, label=y, weight=weight, params=p)
    kw = {}
    if valid is not None:
        vx, vy = valid
        kw["valid_sets"] = [Dataset(vx, label=vy, params=p, reference=ds)]
    return _engine_train(p, ds, num_boost_round=num_boost_round, **kw)


def _main(argv: List[str]) -> None:
    """The worker bootstrap ``run`` spawns: bring up the process group,
    then call the entry."""
    import argparse
    ap = argparse.ArgumentParser(prog="python -m lightgbm_torch.distributed")
    ap.add_argument("--entry", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--num-workers", type=int, required=True)
    ap.add_argument("--machines", required=True)
    ap.add_argument("--result", default="")
    ap.add_argument("--args", default="")
    ap.add_argument("--backend", default="gloo")
    ns = ap.parse_args(argv)

    import torch
    if ns.backend == "nccl":
        torch.cuda.set_device(ns.rank % torch.cuda.device_count())
    from .parallel import launch
    entries = [m for m in ns.machines.split(",") if m]
    host, port = entries[0].rsplit(":", 1)
    launch.init(init_method=f"tcp://{host}:{port}",
                num_processes=ns.num_workers, process_id=ns.rank,
                backend=ns.backend)

    mod_name, fn_name = ns.entry.split(":")
    import importlib
    fn = getattr(importlib.import_module(mod_name), fn_name)
    ctx = WorkerContext(rank=ns.rank, num_workers=ns.num_workers,
                        machines=ns.machines,
                        local_listen_port=int(
                            entries[ns.rank].rsplit(":", 1)[1]))
    try:
        if ns.args:
            with open(ns.args, "rb") as f:
                result = fn(ctx, pickle.load(f))
        else:
            result = fn(ctx)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    if ns.result:
        with open(ns.result, "wb") as f:
            pickle.dump(result, f)


if __name__ == "__main__":
    _main(sys.argv[1:])
