"""The distributed learners' host side, in one process (no spawn):

- ``owner_shard_plan`` equal to the JAX package's;
- the framed payloads (``frame_payload``/``unframe_payload``): round
  trip, and the refusal of a corrupt, truncated or foreign payload;
- ``distributed_bin_mappers`` through the injected ``allgather`` hook
  equal to the JAX package's on the same shards (sketch and shard
  methods);
- the ``CommLedger`` of the data-parallel (full-reduce and owner-shard)
  and voting learners against the JAX growers' ``grow.comm`` for the
  same configuration: the sites, collectives, payload and wire bytes,
  cadences and bytes per tree.  The port's ledger is filled by a tree
  grown over ``LoopbackMesh``, a ``ProcessMesh`` whose collectives act as
  S ranks holding this rank's data; the owner-shard best-split payload is the port's
  record layout (12 f32 words a child and, with a categorical feature,
  the flag and the rank row), not the JAX package's pytree;
- a lone rank: the JAX package's warning and a serial model;
- the JAX package's ``ValueError``s for the controls a distributed
  learner refuses (the same messages), and ``NotImplementedError``
  naming ROADMAP A16b for what the port refuses yet.
"""

import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.models import gbdt as tgbdt
from lightgbm_torch.parallel import dist_data as tdd
from lightgbm_torch.parallel.mesh import ProcessMesh
from lightgbm_torch.parallel.mesh import owner_shard_plan as t_plan
from lightgbm_torch.utils.log import register_log_callback
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.parallel import dist_data as jdd
from lightgbm_tpu.parallel.mesh import owner_shard_plan as j_plan

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.1, "max_bin": 63, "verbosity": -1}
PORT = {"device_type": "cpu"}


class _Loopback:
    """``torch.distributed`` as S ranks that all hold this rank's
    tensors."""

    class ReduceOp:
        SUM, MAX = "sum", "max"

    def __init__(self, S):
        self.S = S

    def all_reduce(self, t, op, group=None):
        if op == "sum":
            t.mul_(self.S)

    def reduce_scatter_single(self, out, t, group=None):
        out.copy_(t.view((self.S,) + tuple(out.shape))[0] * self.S)

    def all_gather_single(self, out, t, group=None):
        out.copy_(torch.cat([t] * self.S))


class LoopbackMesh(ProcessMesh):
    def __init__(self, S, axis="data"):
        self._dist = _Loopback(S)
        self.group, self.world_size, self.rank = None, S, 0
        self.axis, self.backend = axis, "loopback"
        self.device = torch.device("cpu")
        self.timed, self.staged, self._pinned = False, {}, {}

    def all_gather_object(self, obj):
        return [obj] * self.world_size


@pytest.fixture
def loopback(monkeypatch):
    """Distributed learners over ``LoopbackMesh`` (S = 2)."""
    def resolve(config, device):
        kind = config.tree_learner if config.tree_learner in \
            tgbdt.DIST_LEARNERS else None
        if kind is None:
            return None, None
        return kind, LoopbackMesh(2, "feature" if kind == "feature"
                                  else "data")
    monkeypatch.setattr(tgbdt, "resolve_distribution", resolve)


def _data(n=1200, f=7, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] * x[:, 2] + 0.3 * rs.randn(n)
         > 0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("group_of,S", [
    (np.arange(28), 2), (np.arange(28), 8), (np.arange(5), 8),
    (np.asarray([0, 0, 1, 2, 2, 2, 3, 4, 4]), 3)])
def test_owner_shard_plan_equals_jax(group_of, S):
    t, j = t_plan(group_of, S), j_plan(group_of, S)
    assert (t.chunk, t.fmax) == (j.chunk, j.fmax)
    np.testing.assert_array_equal(t.shard_feat, j.shard_feat)
    assert t.hist_bytes(31, 64, 2) == j.hist_bytes(31, 64, 2)


def test_frame_round_trip_and_corrupt_refusal():
    body = pickle.dumps({"a": np.arange(5)})
    blob = tdd.frame_payload(body)
    assert blob == jdd.frame_payload(body)
    assert tdd.unframe_payload(blob) == body
    bad = bytearray(blob)
    bad[-1] ^= 0x40
    for broken, what in ((bytes(bad), "sha256"), (blob[:20], "truncated"),
                         (b"XXXX" + blob[4:], "magic"),
                         (blob[:-3], "truncated body")):
        with pytest.raises(tdd.PayloadIntegrityError, match="UNAVAILABLE"):
            tdd.unframe_payload(broken)
    with pytest.raises(tdd.PayloadIntegrityError, match="rank 1"):
        tdd._exchange([1], lambda p: [p, bytes(bad)])


def _mappers(mod, shards, cfg, method, cat):
    """Every rank's mappers through the injected all-gather: each rank's
    payload is taken first, then every rank merges all of them."""
    payloads = []

    class _Taken(Exception):
        pass

    def take(p):
        payloads.append(p)
        raise _Taken

    for r, s in enumerate(shards):
        with pytest.raises(_Taken):
            mod.distributed_bin_mappers(s, cfg, cat_idx=cat,
                                        process_index=r,
                                        process_count=len(shards),
                                        allgather=take, method=method)
    return [mod.distributed_bin_mappers(
        s, cfg, cat_idx=cat, process_index=r, process_count=len(shards),
        allgather=lambda p: list(payloads), method=method)
        for r, s in enumerate(shards)]


def _state(m):
    return {k: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else v)
            for k, v in m.to_state().items()}


@pytest.mark.parametrize("method", ["sketch", "shard"])
def test_distributed_bin_mappers_equal_jax(method):
    rs = np.random.RandomState(3)
    x = rs.randn(900, 5)
    x[:, 4] = rs.randint(0, 6, 900)
    x[rs.rand(900) < 0.05, 1] = np.nan
    shards = np.array_split(x, 3)
    params = {"max_bin": 31, "ingest_sketch_size": 64}
    t = _mappers(tdd, shards, TConfig(params), method, {4})
    j = _mappers(jdd, shards, JConfig(params), method, {4})
    for tr, jr in zip(t, j):
        assert [_state(m) for m in tr] == [_state(m) for m in jr]
    assert all([_state(m) for m in tr] == [_state(m) for m in t[0]]
               for tr in t)


def _sites(ledger):
    return [(s.site, s.collective, s.payload_bytes, s.wire_bytes,
             s.axis_size, s.cadence) for s in ledger.sites()]


def _jax_comm(params, x, y):
    bst = lgb.train(dict(BASE, tpu_learner="masked", mesh_shape=[2],
                         **params), lgb.Dataset(x, label=y),
                    num_boost_round=1)
    return bst._model.grower.comm


def _port_comm(params, x, y):
    bst = lgt.train(dict(BASE, **PORT, **params),
                    lgt.Dataset(x, label=y), num_boost_round=1)
    return bst._model.dist_grower.comm


@pytest.mark.parametrize("params", [
    {"tree_learner": "data", "dp_owner_shard": False},
    {"tree_learner": "voting", "top_k": 3},
    {"tree_learner": "data", "dp_owner_shard": False, "quant_train": True},
])
def test_comm_ledger_equals_jax(loopback, params):
    x, y = _data()
    t, j = _port_comm(params, x, y), _jax_comm(params, x, y)
    assert _sites(t) == _sites(j)
    for steps in (1, 14):
        assert t.bytes_per_iteration(steps) == j.bytes_per_iteration(steps)
    # every step site is called once a step of the fixed sequence (both
    # children's passes under voting), the tree sites once
    L = BASE["num_leaves"]
    for s in t.sites():
        per_tree = (2 * (L - 1) + 1 if params["tree_learner"] == "voting"
                    else L) if s.cadence == "step" else 1
        assert t.calls[s.site] == per_tree, s.site


def test_comm_ledger_owner_shard_sites(loopback):
    x, y = _data()
    t = _port_comm({"tree_learner": "data"}, x, y)
    j = _jax_comm({"tree_learner": "data"}, x, y)
    ts, js = {s[0]: s for s in _sites(t)}, {s[0]: s for s in _sites(j)}
    assert set(ts) == set(js) == {"dp.hist_reduce", "dp.root_sum",
                                  "dp.best_split"}
    assert ts["dp.hist_reduce"] == js["dp.hist_reduce"]
    assert ts["dp.root_sum"] == js["dp.root_sum"]
    # one all-gather of the pair's two 12-word records a step
    assert ts["dp.best_split"][1:3] == ("all_gather", 2 * 12 * 4)
    assert ts["dp.best_split"][3] == 2 * 12 * 4
    plan = t_plan(np.arange(x.shape[1]), 2)
    assert ts["dp.hist_reduce"][2] == 2 * plan.chunk * 63 * 3 * 4


def _tree_text(text):
    return text.split("end of trees")[0].split("Tree=", 1)[1]


def test_lone_rank_warns_and_trains_serially():
    import torch.distributed as dist
    assert not (dist.is_available() and dist.is_initialized())
    x, y = _data(n=500)
    lines = []
    register_log_callback(lines.append)
    try:
        bst = lgt.train(dict(BASE, **PORT, verbosity=0,
                             tree_learner="voting"),
                        lgt.Dataset(x, label=y), num_boost_round=3)
    finally:
        register_log_callback(None)
    assert any("tree_learner=voting requested but only one device is "
               "visible; training serially" in ln for ln in lines)
    assert bst._model.dist is None
    ser = lgt.train(dict(BASE, **PORT), lgt.Dataset(x, label=y),
                    num_boost_round=3)
    assert _tree_text(bst.model_to_string()) == \
        _tree_text(ser.model_to_string())
    with pytest.raises(ValueError, match="needs 2 ranks"):
        lgt.train(dict(BASE, **PORT, num_machines=2),
                  lgt.Dataset(x, label=y), num_boost_round=1)


@pytest.mark.parametrize("learner,extra", [
    ("data", {"interaction_constraints": [[0, 1], [2, 3]]}),
    ("data", {"feature_fraction_bynode": 0.5}),
    ("data", {"cegb_penalty_split": 0.1}),
    ("data", {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0],
              "monotone_constraints_method": "intermediate"}),
    ("feature", {"extra_trees": True}),
    ("data", {"feature_contri": [1.0, 0.5, 1, 1, 1, 1, 1]}),
    ("voting", {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0]}),
    ("feature", {"monotone_constraints": [1, 0, 0, 0, 0, 0, 0]}),
])
def test_jax_value_errors(loopback, learner, extra):
    x, y = _data(n=400)
    with pytest.raises(ValueError) as ej:
        lgb.train(dict(BASE, tree_learner=learner, mesh_shape=[2], **extra),
                  lgb.Dataset(x, label=y), num_boost_round=1)
    with pytest.raises(ValueError) as et:
        lgt.train(dict(BASE, **PORT, tree_learner=learner, **extra),
                  lgt.Dataset(x, label=y), num_boost_round=1)
    assert str(et.value) == str(ej.value)


def _onehot(n=600, seed=1):
    rs = np.random.RandomState(seed)
    k = rs.randint(0, 6, n)
    x = np.zeros((n, 8), np.float32)
    x[np.arange(n), k] = 1.0
    x[:, 6:] = rs.randn(n, 2)
    return x, (k % 2 == 0).astype(np.float32)


@pytest.mark.parametrize("case", ["efb", "sparse", "goss", "multiclass",
                                  "ranking", "integrity", "elastic"])
def test_a16b_refusals(loopback, case):
    x, y = _data(n=400)
    params = dict(BASE, **PORT, tree_learner="data")
    kw = {}
    if case == "efb":
        x, y = _onehot()
        ds = lgt.Dataset(x, label=y)
        assert ds.construct(TConfig(params)).efb is not None
    elif case == "sparse":
        rs = np.random.RandomState(2)
        xs = sps.random(400, 60, density=0.04, format="csr",
                        random_state=rs, dtype=np.float32)
        params["enable_bundle"] = False
        ds = lgt.Dataset(xs, label=y)
        assert ds.construct(TConfig(params)).binned_sparse is not None
    else:
        ds = lgt.Dataset(x, label=y)
    if case == "goss":
        params["data_sample_strategy"] = "goss"
    elif case == "multiclass":
        params.update(objective="multiclass", num_class=3)
        ds = lgt.Dataset(x, label=(np.arange(len(x)) % 3).astype(float))
    elif case == "ranking":
        params["objective"] = "lambdarank"
        ds = lgt.Dataset(x, label=(np.arange(len(x)) % 3).astype(float),
                         group=[100] * 4)
    elif case == "integrity":
        params["integrity_check_freq"] = 1
    elif case == "elastic":
        params["elastic_enable"] = True
    with pytest.raises(NotImplementedError, match="A16b"):
        lgt.train(params, ds, num_boost_round=1, **kw)
