"""Quantized training (``quant_train=true``) end to end on the CPU, every
kernel as its plain version, against the JAX package's quantized growers
and training (``quant_train=True``, ``tpu_learner="masked"``):

- whole trees of the strict grower (31 leaves) and the batched one (255
  leaves, K = 16) against ``make_grower(..., quant=QuantSpec(...))`` with
  the same ``rng_iter``: the integer histograms are exact in both, so
  every integer array and the row -> leaf vector are equal; where the
  scales are powers of two (every dequantized sum then exact in f32)
  every f32 field is equal too, and elsewhere the f32 fields agree to
  ``RTOL`` (B2's f32 prefix sums of the dequantized histograms are taken
  in another order than XLA's cumsum);
- training on a binary problem whose gains stay well separated: every
  tree's integer arrays (the structural lines of the model text) equal
  the JAX package's over 5 rounds on each of the three paths, with int8
  and int16 lanes and both roundings; the predictions agree to
  ``PRED_RTOL``; at 255 leaves the first tree is equal, every later
  tree's integer arrays too, and the valid metric within
  ``METRIC_RTOL``;
- the four-family harness of the JAX package's tests/test_quant.py: the
  port's quantized training against its own f32 training within the JAX
  package's epsilons, at int8 and int16;
- the three paths write the same model text;
- multiclass on the per-iteration loop, EFB bundles, categorical
  features, GOSS, and feature_fraction_bynode with extra_trees, each
  against the JAX package's trees;
- the int32-overflow refusal, with the JAX package's text."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.grower import (GrowWorkspace, fetch_tree, grow_tree,
                                   grow_tree_batched)
from lightgbm_torch.ops.quantize import QuantSpec as TQuant
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.quantize import QuantSpec as JQuant
from lightgbm_tpu.ops.split import SplitParams as JParams

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, multiclass_problem, pin_torch_threads,
    pin_torch_threads_module, raw_problem)

RTOL = 1e-5
PRED_RTOL = 1e-5
METRIC_RTOL = 0.02
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 3}, "superepoch": {"fused_chunk": 3}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
INT_FIELDS = ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child")
F32_FIELDS = ("split_gain", "internal_value", "internal_weight",
              "internal_count", "leaf_value", "leaf_weight", "leaf_count")


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(tree_text):
    return [ln for ln in tree_text.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _pow2_vals(vals, bits):
    """``vals`` with g and h rescaled so that each channel's largest
    magnitude is ``qmax * 2^-k``: the scales are powers of two, so every
    dequantized value is exact in f32, and so is every sum of them while
    its integer stays under 2^24 (int8 sums of a few thousand rows do;
    for int16 the largest row of each channel is made 64 times the
    others', so that the rest quantize to at most 512)."""
    qmax = (1 << (bits - 1)) - 1
    out = vals.copy()
    for c, k in ((0, bits - 4), (1, bits - 1)):
        top = np.float32(qmax * 2.0 ** -k)
        i = int(np.abs(out[:, c]).argmax())
        if bits == 16:
            out[i, c] *= 64
        out[:, c] = (out[:, c] / np.abs(out[i, c]) * top).astype(np.float32)
        out[i, c] = np.copysign(top, out[i, c])
    return out


def _grow_pair(leaves, K, bits, stochastic, exact, it=3, seed=5,
               depth=-1, params=None):
    binned, vals, num_bin, na_bin = binned_problem(21, n=4000, f=8, bins=31)
    if exact:
        vals = _pow2_vals(vals, bits)
    p = params or {"min_data_in_leaf": 20}
    f = binned.shape[1]
    mask = np.ones(f, bool)
    grow = make_grower(num_leaves=leaves, num_bins=31, params=JParams(**p),
                       max_depth=depth, split_batch=K, hist_overlap=True,
                       quant=JQuant(bits=bits, stochastic=stochastic,
                                    seed=seed))
    tj = grow(*(jnp.asarray(a) for a in (binned, vals, mask, num_bin,
                                         na_bin)), rng_iter=jnp.int32(it))
    spec = TQuant(bits=bits, stochastic=stochastic, seed=seed)
    ws = GrowWorkspace(len(binned), f, 31, leaves, torch.device("cpu"),
                       split_batch=K, quant=spec)
    args = [torch.as_tensor(a) for a in (binned, vals, mask, num_bin,
                                         na_bin)]
    kw = dict(num_leaves=leaves, num_bins=31, params=TParams(**p),
              max_depth=depth, workspace=ws, quant=spec,
              rng_iter=torch.tensor([it], dtype=torch.int32))
    if K == 1:
        grow_tree(*args, **kw)
    else:
        grow_tree_batched(*args, split_batch=K, **kw)
    return fetch_tree(ws), tj, ws


def _assert_trees_equal(tt, tj, exact):
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl and nl > 2
    n = nl - 1
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(tt, name)[:n],
                                      np.asarray(getattr(tj, name))[:n],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_depth[:nl],
                                  np.asarray(tj.leaf_depth)[:nl])
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    for name in F32_FIELDS:
        k = n if name.startswith(("internal", "split")) else nl
        b = np.asarray(getattr(tj, name))[:k]
        if exact:
            np.testing.assert_array_equal(getattr(tt, name)[:k], b,
                                          err_msg=name)
        else:
            b = b.astype(np.float64)
            np.testing.assert_allclose(getattr(tt, name)[:k], b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max(),
                                       err_msg=name)


@pytest.mark.parametrize("bits,stochastic,exact", [
    (8, True, True), (8, False, True), (16, True, True), (8, True, False),
    (16, True, False), (16, False, False)])
def test_strict_tree_equals_jax(bits, stochastic, exact):
    tt, tj, ws = _grow_pair(31, 1, bits, stochastic, exact)
    _assert_trees_equal(tt, tj, exact)
    # the per-leaf histograms are exact integers
    assert ws.hist.dtype == torch.int32
    assert ws.qvals.dtype == (torch.int8 if bits == 8 else torch.int16)


def test_strict_tree_with_depth_and_l2_equals_jax():
    tt, tj, _ = _grow_pair(20, 1, 8, True, True, it=11, depth=4,
                           params={"min_data_in_leaf": 40,
                                   "lambda_l2": 1.0})
    _assert_trees_equal(tt, tj, True)
    assert tt.leaf_depth[:tt.num_leaves].max() <= 4


@pytest.mark.parametrize("bits,exact", [(8, True), (16, True)])
def test_batched_tree_equals_jax(bits, exact):
    tt, tj, _ = _grow_pair(255, 16, bits, True, exact,
                           params={"min_data_in_leaf": 8})
    _assert_trees_equal(tt, tj, exact)
    assert tt.num_leaves > 100


def test_rounding_key_changes_the_tree():
    a, _, _ = _grow_pair(31, 1, 8, True, False, it=3)
    b, _, _ = _grow_pair(31, 1, 8, True, False, it=4)
    assert not np.array_equal(a.leaf_value, b.leaf_value)


# --- training ---------------------------------------------------------------

def _train(mod, params, data, rounds, path, valid=True):
    x, y, xv, yv = data
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 31,
         "min_data_in_leaf": 30, "learning_rate": 0.5, "verbosity": -1,
         "quant_train": True, **params, **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y)
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid \
        and path != "fused_chunk" else None
    ev = {}
    bst = mod.train(p, tr, rounds, valid_sets=vs,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


@pytest.fixture(scope="module")
def bin_data():
    x, y = raw_problem(41, n=4000, f=10, task="binary", nan_frac=0.0)
    xv, yv = raw_problem(42, n=1500, f=10, task="binary", nan_frac=0.0)
    return x, y, xv, yv


LANES = {"int8": {}, "int16": {"quant_bits": 16},
         "nearest": {"quant_round": "nearest"}}


@pytest.fixture(scope="module", params=sorted(LANES))
def lane_runs(request, bin_data):
    extra = LANES[request.param]
    jax_run = _train(lgb, extra, bin_data, 5, "per_iteration")[0]
    ours = {path: _train(lgt, extra, bin_data, 5, path)[0]
            for path in PATHS}
    return jax_run, ours


def test_trees_equal_jax_on_every_path(lane_runs, bin_data):
    bj, ours = lane_runs
    tj = _trees(bj.model_to_string())
    assert len(tj) == 5
    for path, bt in ours.items():
        tt = _trees(bt.model_to_string())
        assert [_structure(t) for t in tt] == [_structure(t) for t in tj], \
            path
    xv = bin_data[2]
    pj = np.asarray(bj.predict(xv, raw_score=True))
    np.testing.assert_allclose(ours["superepoch"].predict(xv, raw_score=True),
                               pj, rtol=PRED_RTOL,
                               atol=PRED_RTOL * np.abs(pj).max())


def test_paths_write_the_same_model(lane_runs):
    _, ours = lane_runs
    texts = {path: _norm(bt.model_to_string()) for path, bt in ours.items()}
    assert texts["per_iteration"] == texts["superepoch"] \
        == texts["fused_chunk"]


def test_quant_trees_differ_from_f32(lane_runs, bin_data):
    _, ours = lane_runs
    f32 = _train(lgt, {"quant_train": False}, bin_data, 5,
                 "per_iteration")[0]
    assert _trees(f32.model_to_string()) \
        != _trees(ours["per_iteration"].model_to_string())


def _grid_labels(seed, n):
    """Raw rows and L2 labels on a 1/16 grid, the largest of magnitude
    127/16: without BoostFromAverage the first iteration's gradients are
    -y, the int8 scale is 1/16 and the hessians' 1/127 dequantizes 127
    back to 1, so the first tree's quantization and every sum of its
    histograms are exact."""
    x, _ = raw_problem(seed, n=n, f=8, task="regression", nan_frac=0.0)
    y = np.clip(np.round(16 * (2 * x[:, 0] - x[:, 1] + x[:, 2] * x[:, 3]))
                / 16, -127 / 16, 127 / 16).astype(np.float32)
    y[0] = 127 / 16
    return x, y


@pytest.fixture(scope="module")
def grid_data():
    return (*_grid_labels(51, 4000), *_grid_labels(52, 1000))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_wide_first_tree_equals_jax_and_metric_close(grid_data, path):
    """At 255 leaves the first tree's model text equals the JAX
    package's, and every later tree's integer arrays do too (ROADMAP C):
    the int32 histograms are exact, and what is left of the f32 paths'
    divergence, B2's f32 prefix sums of the dequantized histograms in
    another order than XLA's cumsum, moves leaf values in their last
    bits but flips no split here (the f32 path holds the first tree
    only)."""
    params = {"objective": "regression", "num_leaves": 255,
              "min_data_in_leaf": 5, "learning_rate": 0.2,
              "boost_from_average": False, "metric": "l2"}
    bj, evj = _train(lgb, params, grid_data, 4, "per_iteration")
    bt, evt = _train(lgt, params, grid_data, 4, path)
    tj, tt = _trees(bj.model_to_string()), _trees(bt.model_to_string())
    assert tt[0] == tj[0]
    assert [_structure(t) for t in tt] == [_structure(t) for t in tj]
    assert len(_structure(tt[0])[1].split()) > 200      # 255-leaf trees
    if path != "fused_chunk":
        lj, lt = evj["valid_0"]["l2"], evt["valid_0"]["l2"]
        np.testing.assert_allclose(min(lt), min(lj), rtol=METRIC_RTOL)


# --- the JAX package's four-family harness (tests/test_quant.py:168-227) ----

_rs = np.random.RandomState(11)
HX = _rs.randn(600, 6)
HY_REG = (2.0 * HX[:, 0] - HX[:, 1] + 0.1 * _rs.randn(600)).astype(
    np.float32)
HY_BIN = (HX[:, 0] - HX[:, 1] + 0.2 * _rs.randn(600) > 0).astype(np.float32)
HY_RANK = np.clip(np.round(HX[:, 0] - HX[:, 1] + 0.3 * _rs.randn(600)), 0,
                  3).astype(np.float32)
HY_MC = np.digitize(HX[:, 0] + 0.3 * HX[:, 1], [-0.5, 0.5]).astype(
    np.float32)
HBASE = {"num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 5,
         "verbosity": -1, "device_type": "cpu"}
FAMILIES = {
    "regression": ({"objective": "regression"}, HY_REG, "l2", 0.12),
    "binary": ({"objective": "binary"}, HY_BIN, "auc", 0.02),
    "multiclass": ({"objective": "multiclass", "num_class": 3}, HY_MC,
                   "mlogloss", 0.10),
    "lambdarank": ({"objective": "lambdarank"}, HY_RANK, "ndcg", 0.05),
}


def _auc(y, s):
    r = np.argsort(np.argsort(s)) + 1
    npos = int((y > 0).sum())
    nneg = len(y) - npos
    return float((r[y > 0].sum() - npos * (npos + 1) / 2) / (npos * nneg))


def _ndcg(y, s, groups, k=10):
    out, start = [], 0
    for g in groups:
        yy, ss = y[start:start + g], s[start:start + g]
        start += g
        order = np.argsort(-ss, kind="stable")[:k]
        disc = 1.0 / np.log2(np.arange(2, len(order) + 2))
        dcg = float(((2.0 ** yy[order] - 1) * disc).sum())
        ideal = np.sort(yy)[::-1][:k]
        idcg = float(((2.0 ** ideal - 1) * disc[:len(ideal)]).sum())
        out.append(dcg / idcg if idcg > 0 else 1.0)
    return float(np.mean(out))


def _family_metric(kind, bst, y, groups):
    pred = bst.predict(HX)
    if kind == "l2":
        return float(np.mean((pred - y) ** 2))
    if kind == "auc":
        return _auc(y, pred)
    if kind == "mlogloss":
        p = np.clip(pred[np.arange(len(y)), y.astype(int)], 1e-9, 1.0)
        return float(-np.mean(np.log(p)))
    return _ndcg(y, pred, groups)


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("bits", [8, 16])
def test_quant_within_epsilon_of_f32(family, bits):
    over, y, kind, eps = FAMILIES[family]
    groups = [20] * 30 if family == "lambdarank" else None
    p = {**HBASE, **over}

    def run(extra):
        ds = lgt.Dataset(HX, y, group=groups)
        return lgt.train({**p, **extra}, ds, 5)

    v_f32 = _family_metric(kind, run({}), y, groups)
    v_q = _family_metric(kind, run({"quant_train": True,
                                    "quant_bits": bits}), y, groups)
    if kind == "l2":
        assert abs(v_q - v_f32) <= eps * max(v_f32, 1e-9), (v_f32, v_q)
    else:
        assert abs(v_q - v_f32) <= eps, (v_f32, v_q)


# --- composition with the other modules ---------------------------------------

def _both(params, x, y, rounds=5, **dskw):
    """The port's and the JAX package's per-iteration quantized runs
    (objective ``none``: the ``_grid_l2`` gradients)."""
    p = {"num_leaves": 15, "max_bin": 31, "min_data_in_leaf": 30,
         "verbosity": -1, "quant_train": True, **params,
         **PATHS["per_iteration"]}
    fobj = _grid_l2 if p.get("objective") == "none" else None
    bt = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x, y, **dskw),
                   rounds, fobj=fobj)
    bj = lgb.train({**p, "tpu_learner": "masked"},
                   lgb.Dataset(x, label=y, **dskw), rounds, fobj=fobj)
    return _trees(bt.model_to_string()), _trees(bj.model_to_string())


def test_multiclass_equals_jax():
    x, y = multiclass_problem(31, n=3000, f=6, k=3)
    tt, tj = _both({"objective": "multiclass", "num_class": 3,
                    "learning_rate": 0.3}, x, y, rounds=3)
    assert len(tt) == len(tj) == 9
    assert [_structure(t) for t in tt] == [_structure(t) for t in tj]


def _onehot(n=3000, seed=3):
    rs = np.random.RandomState(seed)
    dense = rs.randn(n, 3)
    cat = rs.randint(0, 12, size=n)
    oh = np.zeros((n, 12))
    oh[np.arange(n), cat] = 1.0
    y = (dense[:, 0] + (cat % 3 == 0) - 0.5 * dense[:, 1]
         + 0.2 * rs.randn(n) > 0.5).astype(np.float32)
    return np.column_stack([dense, oh]), y


def _categorical(n=3000, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4)
    x[:, 1] = rs.randint(0, 9, size=n)
    y = np.round(16 * (x[:, 0] + 1.2 * (x[:, 1] % 4 == 1))) / 16
    return x, y.astype(np.float32)


def _grid_l2(preds, ds):
    """L2 gradients on the 1/16 grid with one row at 127/16 (see
    ``_grid_labels``): every iteration's int8 quantization is exact, so
    every histogram sum is, and categorical ratio orders cannot tie
    differently in the two packages."""
    label = np.asarray(ds.get_label(), np.float64)
    g = np.clip(np.round(16 * (np.asarray(preds, np.float64) - label)) / 16,
                -127 / 16, 127 / 16)
    g[0] = 127 / 16
    return g.astype(np.float32), np.ones(len(g), np.float32)


MODES = {
    "efb": ({"objective": "binary", "learning_rate": 0.5}, _onehot, {}),
    "categorical": ({"objective": "none", "learning_rate": 0.5,
                     "min_data_per_group": 20, "cat_smooth": 5.0},
                    _categorical, {"categorical_feature": [1]}),
    "goss": ({"objective": "binary", "learning_rate": 0.5,
              "data_sample_strategy": "goss"},
             lambda: raw_problem(41, n=4000, f=10, nan_frac=0.0), {}),
    "bynode_extra": ({"objective": "binary", "learning_rate": 0.5,
                      "feature_fraction_bynode": 0.7, "extra_trees": True,
                      "quant_round": "nearest"},
                     lambda: raw_problem(41, n=4000, f=10, nan_frac=0.0),
                     {}),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modules_compose_with_quant_as_jax(mode):
    params, data, dskw = MODES[mode]
    x, y = data()
    tt, tj = _both(params, x, y, **dskw)
    assert len(tt) == len(tj) == 5
    assert [_structure(t) for t in tt] == [_structure(t) for t in tj]
    if mode == "efb":
        ds = lgt.Dataset(x, y).construct()
        assert ds.binned.shape[1] < x.shape[1]        # the one-hots bundle
    if mode == "categorical":
        # exact sums: the whole trees are equal, and they split the
        # categorical feature
        assert tt == tj
        assert any(ln.startswith("num_cat=") and ln != "num_cat=0"
                   for t in tt for ln in t.splitlines())


# --- the int32-overflow refusal ---------------------------------------------

def test_int16_refuses_rows_that_could_overflow():
    n = (2 ** 31 - 1) // 32767 + 1             # 65,539 rows
    rs = np.random.RandomState(0)
    x = rs.randn(n, 2)
    y = (x[:, 0] > 0).astype(np.float32)
    params = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
              "quant_train": True, "quant_bits": 16}
    with pytest.raises(ValueError, match="int32 histogram"):
        lgt.train(params, lgt.Dataset(x, y), 1)
    with pytest.raises(ValueError, match="int32 histogram"):
        lgb.train({**params, "device_type": "cpu"}, lgb.Dataset(x, label=y),
                  1)
    # one row fewer fits; int8 takes the same rows
    lgt.train(params, lgt.Dataset(x[1:], y[1:]), 1)
    lgt.train({**params, "quant_bits": 8}, lgt.Dataset(x, y), 1)
