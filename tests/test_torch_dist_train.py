"""Distributed training end to end: ``tree_learner=data|feature|voting``
over ``torch.distributed`` (gloo, CPU ranks), each configuration trained
by R = 2 or 4 spawned ranks through ``lightgbm_torch.distributed.run``
(one spawn per R runs every configuration, so start-up is paid once;
``tests/torch_dist_worker.py``), against:

- the JAX package's ``lgb.train(..., tree_learner=..., mesh_shape=[R])``
  on the conftest's virtual CPU devices, with its own tolerance
  (``tests/test_tree_learner_dist.py``: split features and children
  equal, leaf values within rtol 1e-4, atol 1e-5): data (owner-shard
  with a categorical feature, monotone ``basic``, a valid set and early
  stopping; full-reduce), feature, voting with a small ``top_k``, batched
  growth at K = 8, quantized training; 1,999 rows, which divide over
  neither R;
- the port's serial run on the same rows and bin mappers, the same
  tolerance (voting with ``2 top_k < F`` is not exact and is held to the
  JAX voting run only);
- under ``quant_train``: the serial port run's trees bit for bit;
- bagging: each rank's mask equal to ``jax.random``'s with the JAX
  package's ``fold_in`` of the rank;
- every rank's model text equal, a rerun's byte-identical, and
  ``distributed.train`` with two workers.
"""

import os

import jax
import numpy as np
import pytest

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import distributed

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

N, F = 1999, 7
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 5,
        "learning_rate": 0.1, "max_bin": 63, "verbosity": -1}
CAT = {"categorical_feature": "0"}
MONO = {"monotone_constraints": [0, 1, 0, 0, 0, 0, 0]}
QUANT = {"quant_train": True, "quant_bits": 8,
         "quant_round": "stochastic"}
BAG = {"bagging_fraction": 0.7, "bagging_freq": 1, "bagging_seed": 9,
       "feature_fraction": 0.8}
ES = {"metric": "auc", "early_stopping_round": 3}
RTOL, ATOL = 1e-4, 1e-5

CONFIGS = {
    2: [
        ("owner", dict(BASE, tree_learner="data", **CAT, **MONO, **ES),
         {"valid": True, "rerun": True}),
        ("full", dict(BASE, tree_learner="data", dp_owner_shard=False), {}),
        ("feature", dict(BASE, tree_learner="feature", **CAT), {}),
        ("voting", dict(BASE, tree_learner="voting", top_k=2), {}),
        ("batched", dict(BASE, tree_learner="data", num_leaves=40,
                         min_data_in_leaf=30, lambda_l2=1.0, split_batch=8),
         {}),
        ("quant", dict(BASE, tree_learner="data", **QUANT),
         {"rerun": True}),
        ("bag", dict(BASE, tree_learner="data", **BAG), {"bag": True}),
        ("api", dict(BASE, tree_learner="data"), {"api": True}),
    ],
    4: [
        ("owner", dict(BASE, tree_learner="data"), {}),
        ("feature", dict(BASE, tree_learner="feature"), {}),
        ("voting", dict(BASE, tree_learner="voting", top_k=2), {}),
        ("quant", dict(BASE, tree_learner="data", **QUANT), {}),
    ],
}
# the configurations held to the port's serial run
SERIAL = {"owner", "full", "feature", "batched", "quant"}


def _data(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, F).astype(np.float32)
    x[:, 0] = rs.randint(0, 6, n)
    logit = (x[:, 1] + 0.6 * (x[:, 0] % 3 == 1) - 0.5 * x[:, 2] * x[:, 3]
             + 0.4 * np.abs(x[:, 4]) + 0.3 * rs.randn(n))
    return x, (logit > 0).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    x, y = _data(N, 0)
    xv, yv = _data(600, 1)
    return x, y, xv, yv


@pytest.fixture(scope="module")
def spawns(data):
    """R -> every rank's results of the R-rank spawn, made on first
    use."""
    runs = {}

    def get(R):
        if R not in runs:
            x, y, xv, yv = data
            runs[R] = distributed.run(
                "torch_dist_worker:run_cells", R, backend="gloo",
                args={"x": x, "y": y, "xv": xv, "yv": yv,
                      "configs": CONFIGS[R]},
                timeout=600, extra_pythonpath=[os.path.dirname(__file__)])
        return runs[R]
    return get


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _field(tree, name):
    for ln in tree.splitlines():
        if ln.startswith(name + "="):
            return ln.split("=", 1)[1].split()
    return []


def _assert_same_model(a, b, rtol=RTOL, atol=ATOL, trees=None):
    ta, tb = _trees(a), _trees(b)
    assert len(ta) == len(tb)
    for i, (x, y) in enumerate(zip(ta[:trees], tb[:trees])):
        for f in ("split_feature", "left_child", "right_child"):
            assert _field(x, f) == _field(y, f), (i, f)
        np.testing.assert_allclose(
            np.asarray(_field(x, "leaf_value"), float),
            np.asarray(_field(y, "leaf_value"), float), rtol=rtol,
            atol=atol, err_msg=f"tree {i}")


def _jax_text(params, R, x, y, xv, yv, valid):
    p = dict(params, tree_learner=params["tree_learner"], mesh_shape=[R],
             tpu_learner="masked")
    ds = lgb.Dataset(x, label=y)
    kw = {"valid_sets": [lgb.Dataset(xv, label=yv, reference=ds)]} \
        if valid else {}
    return lgb.train(p, ds, num_boost_round=5, **kw).model_to_string()


def _serial_text(params, x, y, xv, yv, valid):
    p = {k: v for k, v in params.items()
         if k not in ("tree_learner", "dp_owner_shard")}
    p["device_type"] = "cpu"
    ds = lgt.Dataset(x, label=y, params=p)
    kw = {"valid_sets": [lgt.Dataset(xv, label=yv, params=p,
                                     reference=ds)]} if valid else {}
    return lgt.train(p, ds, num_boost_round=5, **kw).model_to_string()


def _config(R, name):
    return next(c for c in CONFIGS[R] if c[0] == name)


def _cases(names):
    return [(R, c[0]) for R in CONFIGS for c in CONFIGS[R]
            if c[0] in names]


@pytest.mark.parametrize("R", sorted(CONFIGS))
def test_every_rank_writes_one_model(spawns, R):
    out = spawns(R)
    assert len(out) == R
    for name, _, opts in CONFIGS[R]:
        texts = {o[name]["text"] for o in out}
        assert len(texts) == 1, name
        if opts.get("rerun"):
            assert out[0][name]["rerun"] == out[0][name]["text"], name
        if name != "feature":
            rows = [o[name]["rows"] for o in out]
            assert sum(rows) == N and len(set(rows)) == 2
            assert [o[name]["row_offset"] for o in out] == \
                list(np.cumsum([0] + rows[:-1]))
        assert {o[name]["dist"] for o in out} == {
            _config(R, name)[1]["tree_learner"]}


@pytest.mark.parametrize("R,name", _cases(
    {"owner", "full", "feature", "voting", "batched", "quant"}))
def test_trees_equal_jax_distributed(spawns, data, R, name):
    out = spawns(R)
    _, params, opts = _config(R, name)
    jt = _jax_text(params, R, *data, opts.get("valid", False))
    _assert_same_model(out[0][name]["text"], jt)


@pytest.mark.parametrize("R,name", _cases(SERIAL))
def test_trees_equal_serial_port(spawns, data, R, name):
    out = spawns(R)
    _, params, opts = _config(R, name)
    st = _serial_text(params, *data, opts.get("valid", False))
    dt = out[0][name]["text"]
    _assert_same_model(dt, st)
    if name == "quant":
        # exact int32 histograms: every tree bit for bit
        assert _trees(dt) == _trees(st)


def test_bagging_masks_fold_in_rank(spawns):
    out = spawns(2)
    cfg = _config(2, "bag")[1]
    for rank, o in enumerate(out):
        n = o["bag"]["rows"]
        for it, mask in enumerate(o["bag"]["masks"]):
            epoch = (it // cfg["bagging_freq"]) * cfg["bagging_freq"]
            key = jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(cfg["bagging_seed"]), epoch), rank)
            want = np.asarray(jax.random.uniform(key, (n,))
                              < cfg["bagging_fraction"], np.float32)
            np.testing.assert_array_equal(mask, want)
    assert not np.array_equal(out[0]["bag"]["masks"][0][:50],
                              out[1]["bag"]["masks"][0][:50])


@pytest.mark.parametrize("R,name", [(2, "full"), (4, "owner")])
def test_step_sites_called_on_every_step(spawns, R, name):
    out = spawns(R)
    L = BASE["num_leaves"]
    calls = out[0][name]["calls"]
    site = "dp.hist_psum" if name == "full" else "dp.hist_reduce"
    # the fixed step sequence: the root and L - 1 steps a tree, dead
    # steps included, on every rank
    assert calls[site] == calls["dp.root_sum"] * L
    assert all(o[name]["calls"] == calls for o in out)
