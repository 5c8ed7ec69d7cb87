"""The wide super-step widths K = 32 and 64 on the port (the JAX package's
``tests/test_hist_width.py`` on ``lightgbm_torch``, ``device_type=cpu``,
every kernel as its plain version):

- the K-slot histogram (B1-K) at K = 32 and 64 equals the per-slot
  masked histogram and the JAX package's [F, B, 3K] layout, and the int8
  form (B1-K-int) at K = 64 is exact;
- whole batched trees at K = 32 and 64 (255 leaves, exact sums) equal
  ``make_grower(split_batch=K)``'s: B3s-K, B3-K, B2 on 2K = 64 and 128
  children, and the subtraction at those widths;
- on the separated-gains fixture of ``tests/test_torch_train_wide.py``,
  ``split_batch=32`` (40 leaves) grows the JAX package's first tree
  (structure, counts; values within the f32 sums' order) on every path,
  and ``split_batch=64`` (70 leaves) trains and matches it too;
- K = 32 with a categorical feature (B2-cat on 64 children) trains and
  keeps the strict grower's quality, as the JAX package's
  ``test_k32_categorical``;
- an over-budget width fits down byte-identically (31 leaves at K = 32
  run K = 16), and the fused chunk carries K = 32 byte-identically."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.grower import (GrowWorkspace, fetch_tree,
                                   grow_tree_batched)
from lightgbm_torch.ops import histogram as th
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.histogram import compute_histogram as jax_histogram
from lightgbm_tpu.ops.split import SplitParams as JParams

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module,
    raw_problem)

# the JAX package's tolerance of its per-slot check (test_hist_width.py)
SLOT_RTOL, SLOT_ATOL = 2e-5, 2e-4
# leaf values and gains of the first tree against the JAX package's: the
# same rows summed in another order, the larger child by subtraction
VALUE_RTOL = 2e-3
AUC_GAP = 0.03
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {}, "superepoch": {}}
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")


def _strip_params(text: str) -> str:
    return text.split("parameters:")[0]


def _tree(text, i):
    return text.split("Tree=")[i + 1].split("\n\n")[0]


def _field(tree_text, name):
    for ln in tree_text.splitlines():
        if ln.startswith(name + "="):
            return ln.split("=", 1)[1]
    raise KeyError(name)


def _auc(y, s):
    order = np.argsort(s)
    r = np.empty(len(s))
    r[order] = np.arange(1, len(s) + 1)
    pos = y > 0
    n1, n0 = pos.sum(), (~pos).sum()
    return (r[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


# --- B1-K and B1-K-int at the wide widths ----------------------------------

@pytest.mark.parametrize("k", [32, 64])
def test_slotted_matches_masked_per_slot(k):
    rs = np.random.RandomState(0)
    n, f, B = 3000, 5, 31
    binned = rs.randint(0, B, size=(n, f), dtype=np.uint8)
    vals = rs.randn(n, 3).astype(np.float32)
    slot = rs.randint(-1, k, size=n, dtype=np.int32)
    bt, vt, st = (torch.as_tensor(a) for a in (binned, vals, slot))
    h = th.compute_histogram(bt, vt, num_bins=B, slot=st, num_slots=k,
                             slots_used=torch.tensor([k], dtype=torch.int32))
    assert h.shape == (k, f, B, 3)
    hj = np.asarray(jax_histogram(jnp.asarray(binned), jnp.asarray(vals),
                                  num_bins=B, slot=jnp.asarray(slot),
                                  num_slots=k))
    # the JAX layout: channel c of slot s at c*K + s
    hj = hj.reshape(f, B, 3, k).transpose(3, 0, 1, 2)
    np.testing.assert_allclose(h.numpy(), hj, rtol=SLOT_RTOL,
                               atol=SLOT_ATOL)
    for s in (0, k // 2, k - 1):
        m = torch.as_tensor((slot == s).astype(np.float32))[:, None]
        ref = th.compute_histogram(bt, vt * m, num_bins=B)
        np.testing.assert_allclose(h[s].numpy(), ref.numpy(),
                                   rtol=SLOT_RTOL, atol=SLOT_ATOL)


def test_int8_k64_exact():
    rs = np.random.RandomState(1)
    n, f, B, k = 2500, 4, 31, 64
    binned = rs.randint(0, B, size=(n, f), dtype=np.uint8)
    vi = rs.randint(-50, 50, size=(n, 3), dtype=np.int8)
    slot = rs.randint(0, k, size=n, dtype=np.int32)
    h = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vi),
                             num_bins=B, slot=torch.as_tensor(slot),
                             num_slots=k,
                             slots_used=torch.tensor([k], dtype=torch.int32))
    assert h.dtype == torch.int32 and h.shape == (k, f, B, 3)
    ref = np.zeros((k, f, B, 3), np.int64)
    for ff in range(f):
        np.add.at(ref, (slot, ff, binned[:, ff]), vi.astype(np.int64))
    np.testing.assert_array_equal(h.numpy(), ref)
    hj = np.asarray(jax_histogram(jnp.asarray(binned), jnp.asarray(vi),
                                  num_bins=B, slot=jnp.asarray(slot),
                                  num_slots=k))
    np.testing.assert_array_equal(
        h.numpy(), hj.reshape(f, B, 3, k).transpose(3, 0, 1, 2))


# --- whole batched trees at K = 32 and 64 ----------------------------------

@pytest.mark.parametrize("k", [32, 64])
def test_batched_tree_matches_jax(k):
    binned, vals, num_bin, na_bin = binned_problem(21, n=6000, f=8, bins=31)
    # g a multiple of 1/8, h = w = 1: every sum is exact in f32
    ex = np.ones_like(vals)
    ex[:, 0] = np.round(8.0 * vals[:, 0]) / 8.0
    n, f = binned.shape
    L, B = 255, int(num_bin.max())
    params = {"min_data_in_leaf": 8}
    mask = np.ones(f, bool)
    grow = make_grower(num_leaves=L, num_bins=B, params=JParams(**params),
                       split_batch=k)
    tj = grow(*(jnp.asarray(a) for a in (binned, ex, mask, num_bin,
                                         na_bin)))
    ws = GrowWorkspace(n, f, B, L, torch.device("cpu"), split_batch=k)
    grow_tree_batched(*(torch.as_tensor(a) for a in (binned, ex, mask,
                                                     num_bin, na_bin)),
                      num_leaves=L, num_bins=B, params=TParams(**params),
                      split_batch=k, workspace=ws)
    tt = fetch_tree(ws)
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl == L
    nn = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      np.asarray(getattr(tj, name))[:nn],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    for name, cnt in (("leaf_value", nl), ("leaf_count", nl),
                      ("split_gain", nn)):
        b = np.asarray(getattr(tj, name), np.float64)[:cnt]
        np.testing.assert_allclose(getattr(tt, name)[:cnt], b, rtol=1e-6,
                                   atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    # the live super-steps (the JAX loop also counts the one that found
    # nothing), at least the budget's share of K-wide steps
    assert tt.n_steps in (int(tj.n_steps), int(tj.n_steps) - 1)
    assert tt.n_steps >= -(-(L - 1) // k)


# --- training against the JAX package --------------------------------------

def _noisy_binary():
    x, y = raw_problem(61, n=6000, f=10, task="binary", nan_frac=0.0)
    xv, yv = raw_problem(62, n=1500, f=10, task="binary", nan_frac=0.0)
    rs = np.random.RandomState(63)
    y = np.where(rs.rand(len(y)) < 0.2, 1 - y, y).astype(np.float32)
    return x, y, xv, yv


def _train(mod, params, data, rounds, path):
    x, y, xv, yv = data
    p = {"verbosity": -1, "max_bin": 31, "objective": "binary",
         "learning_rate": 0.3, "min_data_in_leaf": 20,
         "bagging_fraction": 0.8, "bagging_freq": 3,
         "feature_fraction": 0.8, "fused_chunk": 4, **params, **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y)
    vs = None if path == "fused_chunk" else \
        [mod.Dataset(xv, yv, reference=tr)]
    return mod.train(p, tr, rounds, valid_sets=vs)


def _assert_first_tree_matches(bt, bj):
    t0, j0 = _tree(bt.model_to_string(), 0), _tree(bj.model_to_string(), 0)
    for name in STRUCTURAL:
        assert _field(t0, name) == _field(j0, name), name
    for name in ("leaf_value", "split_gain", "internal_value"):
        a = np.asarray(_field(t0, name).split(), np.float64)
        b = np.asarray(_field(j0, name).split(), np.float64)
        np.testing.assert_allclose(a, b, rtol=VALUE_RTOL,
                                   atol=VALUE_RTOL * np.abs(b).max(),
                                   err_msg=name)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_k32_first_tree_equals_jax(path):
    data = _noisy_binary()
    params = {"num_leaves": 40, "split_batch": 32}
    bt = _train(lgt, params, data, 2, path)
    bj = _train(lgb, params, data, 2, path)
    assert bt._model.split_batch == 32
    assert "num_leaves=40" in _tree(bt.model_to_string(), 0)
    _assert_first_tree_matches(bt, bj)


def test_k64_trains_and_matches():
    data = _noisy_binary()
    x, y = data[:2]
    params = {"num_leaves": 70, "split_batch": 64}
    bt = _train(lgt, params, data, 3, "per_iteration")
    bj = _train(lgb, params, data, 3, "per_iteration")
    assert bt._model.split_batch == 64
    _assert_first_tree_matches(bt, bj)
    strict = _train(lgt, {"num_leaves": 70, "split_batch": 1}, data, 3,
                    "per_iteration")
    assert _auc(y, bt.predict(x)) > _auc(y, strict.predict(x)) - AUC_GAP


def test_k32_categorical():
    x, _ = raw_problem(11, n=900, f=10, task="binary", nan_frac=0.0)
    rs = np.random.RandomState(5)
    cat = rs.randint(0, 8, x.shape[0]).astype(float)
    y = ((cat >= 4) & (x[:, 0] > -0.5)).astype(np.float32)
    x[:, 5] = cat
    aucs = {}
    for sb in (1, 32):
        p = {"objective": "binary", "verbosity": -1, "num_leaves": 33,
             "min_data_in_leaf": 5, "min_data_per_group": 5,
             "max_bin": 31, "split_batch": sb, "device_type": "cpu"}
        bst = lgt.train(p, lgt.Dataset(x, y, categorical_feature=[5]), 6)
        assert bst._model.split_batch == sb
        assert bst._model.is_cat_dev is not None
        aucs[sb] = _auc(y, bst.predict(x))
        if sb == 32:
            assert "decision_type=" in bst.model_to_string()
            assert any(int(d) & 1 for d in _field(
                _tree(bst.model_to_string(), 0), "decision_type").split())
    assert aucs[32] > 0.9
    assert aucs[32] > aucs[1] - AUC_GAP


def _small(**over):
    x, y = raw_problem(11, n=900, f=10, task="binary")
    p = {"objective": "binary", "verbosity": -1, "min_data_in_leaf": 5,
         "max_bin": 31, "num_leaves": 33, "device_type": "cpu", **over}
    return lgt.train(p, lgt.Dataset(x, y), 3)


def test_over_budget_width_fits_down_byte_identical():
    """num_leaves=31 at K = 32 runs the K = 16 program: the bytes an
    explicit split_batch=16 trains."""
    a = _small(num_leaves=31, split_batch=32)
    b = _small(num_leaves=31, split_batch=16)
    assert a._model.split_batch == 16
    assert _strip_params(a.model_to_string()) == \
        _strip_params(b.model_to_string())


def test_fused_chunk_carries_k32():
    """The fused chunks (CUDA-graph replays on the card) carry K = 32:
    fused == per-iteration byte-identically."""
    a = _small(split_batch=32, fused_chunk=1, superepoch=-1)
    b = _small(split_batch=32, fused_chunk=3)
    assert a._model.split_batch == b._model.split_batch == 32
    assert b._model._programs
    assert _strip_params(a.model_to_string()) == \
        _strip_params(b.model_to_string())
