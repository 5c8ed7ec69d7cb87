"""Sparse binned storage (the padded k-hot layout, kernel B8) in the port
against the JAX package.

The same numpy-seeded scipy CSR input goes to both packages; every
kernel runs as its plain version (CPU tensors) and the JAX package runs
its masked learner (``tpu_learner="masked"``), which keeps the k-hot rows
as the port does:

- layout: ``collect_entries_csc``, ``build_khot`` and the Dataset's
  ``binned_sparse`` equal the JAX package's; the layout decision is its
  own (wide sparse input goes sparse, narrow CSR stays dense and trains
  under default parameters, ``enable_sparse=false`` is kept);
- functions: ``column``, ``column_per_row`` and the tree walk (B4 on
  k-hot rows) equal ``lightgbm_tpu.sparse_data``'s; ``histogram_plain``
  in its three forms (every row, the strict grower's slot, K slots)
  within ``HIST_RTOL`` of the JAX ``histogram``, and equal to the dense
  histogram of the densified rows; the partitions B3/B3-K on k-hot rows
  equal their dense results;
- whole trees against ``make_grower`` on the JAX side, strict and
  ``split_batch=4``, on exact (1/8-rounded) gradients: every field equal;
- training against the JAX package: exact-gradient model texts (strict,
  batched, bagging, GOSS, feature_fraction, a categorical column);
  binary (alone, and with feature_fraction_bynode and extra_trees),
  multiclass, regression_l1 (renewed leaves) and lambdarank within the
  JAX test's prediction bound (2e-4, tests/test_sparse_bin.py:183);
- inside the port: sparse against dense storage, the three train paths'
  model text, a sparse valid set with early stopping (its recorded metric
  recomputed), ``Booster.predict`` on CSR in chunks;
- ``subset``, ``load_binary`` of a JAX-written sparse cache and
  ``convert.sparse_from_numpy``;
- the refusals: ``quant_train`` (the JAX ``ValueError``), a stride past
  256 bins (ROADMAP A9.5), and the ``partitioned`` override warning."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import booster as tbooster
from lightgbm_torch import convert
from lightgbm_torch import sparse_data as tspd
from lightgbm_torch.grower import (STEP_RECORD, BatchedStep, GrowWorkspace,
                                   fetch_tree, grow_tree, grow_tree_batched,
                                   partition_plain, partition_slots_plain)
from lightgbm_torch.models import gbdt as tgbdt
from lightgbm_torch.ops.histogram import histogram_plain as dense_hist
from lightgbm_torch.ops.histogram import histogram_slots_plain
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_torch.predict_device import (add_tree_score,
                                           traverse_tree_plain)
from lightgbm_tpu import sparse_data as jspd
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams as JParams

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    assert_first_tree_equal, pin_torch_threads, pin_torch_threads_module)

# the port's plain histogram sums in f64, the JAX one in f32 blocks: held
# relative to the largest magnitude of the histogram
HIST_RTOL = 1e-5
# tests/test_sparse_bin.py:183, predictions of two storages or packages
PRED_TOL = 2e-4
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 3}, "superepoch": {"fused_chunk": 3}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")


def sparse_rows(n, f, nnz, seed, levels=3, cat_col=None):
    """CSR [n, f]: ``nnz`` distinct random columns a row, values on
    ``levels`` positive levels; ``cat_col`` (optional) holds integer
    categories 1..8 in a third of the rows."""
    rs = np.random.RandomState(seed)
    cols = np.argsort(rs.rand(n, f), axis=1)[:, :nnz]
    cols.sort(axis=1)
    vals = rs.randint(1, levels + 1, size=(n, nnz)).astype(np.float64)
    x = sps.csr_matrix((vals.ravel(), cols.ravel(),
                        np.arange(0, n * nnz + 1, nnz)), shape=(n, f))
    if cat_col is not None:
        x = x.tolil()
        x[:, cat_col] = 0
        rows = np.nonzero(rs.rand(n) < 0.33)[0]
        x[rows, cat_col] = rs.randint(1, 9, size=len(rows))
        x = x.tocsr()
    return x


def _signal(x, seed):
    w = np.random.RandomState(seed + 1000).randn(x.shape[1])
    w[np.random.RandomState(seed + 2000).rand(x.shape[1]) < 0.8] = 0.0
    return np.asarray(x @ w).ravel()


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(text):
    return [ln for ln in text.split("end of trees")[0].splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _both(x, y, params=None, **kw):
    """The port's and the JAX package's constructed Datasets."""
    p = {"verbosity": -1, **(params or {})}
    return (lgt.Dataset(x, y, params=p, **kw).construct(),
            lgb.Dataset(x, label=y, params=p, **kw).construct())


def _bin_meta(ds):
    used = ds.used_features
    num_bin = np.asarray([ds.bin_mappers[f].num_bin for f in used], np.int32)
    na_bin = np.asarray([ds.bin_mappers[f].na_bin for f in used], np.int32)
    return num_bin, na_bin


def _host_sets(seed=3, n=600, f=300, nnz=30, levels=3):
    x = sparse_rows(n, f, nnz, seed, levels)
    return x, _both(x, np.zeros(n, np.float32), {"enable_bundle": False})


# --- layout ------------------------------------------------------------------

def test_collect_entries_and_build_khot_equal_jax():
    x, (dt, dj) = _host_sets()
    csc = x.tocsc()
    stride = dt.max_bin
    rt, ft, dbt = tspd.collect_entries_csc(csc, dt.bin_mappers,
                                           dt.used_features, stride)
    rj, fj, dbj = jspd.collect_entries_csc(csc, dj.bin_mappers,
                                           dj.used_features, stride)
    for a, b in ((rt, rj), (ft, fj), (dbt, dbj)):
        np.testing.assert_array_equal(a, b)
    kt = tspd.build_khot(rt, ft, dbt, x.shape[0], stride, len(dbt))
    kj = jspd.build_khot(rj, fj, dbj, x.shape[0], stride, len(dbj))
    np.testing.assert_array_equal(kt.flat, kj.flat)
    np.testing.assert_array_equal(kt.densify(), kj.densify())
    # the densified rows are the dense Dataset's
    dense = lgt.Dataset(x.toarray(), np.zeros(x.shape[0]),
                        params={"verbosity": -1,
                                "enable_bundle": False}).construct()
    np.testing.assert_array_equal(kt.densify(), dense.binned)


@pytest.mark.parametrize("shape,params,sparse", [
    ((2000, 600, 30), {}, True),                  # the JAX test's shape
    ((800, 300, 30), {"enable_bundle": False}, True),
    ((400, 600, 40), {"enable_sparse": False}, False),
    ((300, 8, 0), {}, False),                     # narrow CSR: dense
])
def test_layout_decision_equals_jax(shape, params, sparse):
    n, f, nnz = shape
    if nnz:
        x = sparse_rows(n, f, nnz, seed=n + f)
    else:
        x = sps.csr_matrix(np.random.RandomState(6).randn(n, f))
    dt, dj = _both(x, np.zeros(n, np.float32), params)
    assert (dt.binned_sparse is not None) is sparse
    assert (dj.binned_sparse is not None) is sparse
    if sparse:
        assert dt.binned is None and dt.efb is None
        np.testing.assert_array_equal(dt.binned_sparse.flat,
                                      dj.binned_sparse.flat)
        np.testing.assert_array_equal(dt.binned_sparse.default_bin,
                                      dj.binned_sparse.default_bin)
        assert dt.binned_sparse.stride == dj.binned_sparse.stride
        assert dt.binned_sparse.nbytes() < n * dt.num_features
    else:
        np.testing.assert_array_equal(dt.binned, dj.binned)


def test_narrow_csr_trains_under_default_parameters():
    """The repaired fault: a narrow CSR input, which both packages bin
    densely, trains with the default ``enable_sparse``."""
    rs = np.random.RandomState(6)
    xd = rs.randn(300, 8)
    y = (xd[:, 0] + 0.3 * rs.randn(300) > 0).astype(np.float32)
    x = sps.csr_matrix(xd)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    bt = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x, y), 3)
    bd = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(xd, y), 3)
    assert bt.train_set.binned_sparse is None
    assert _norm(bt.model_to_string()) == _norm(bd.model_to_string())


# --- functions -----------------------------------------------------------------

def _sp_pair(seed=7, n=257, f=11, b=8):
    """A dense bin matrix with random default bins as k-hot rows of both
    packages (the JAX test's ``_to_sparse_binned``)."""
    rs = np.random.RandomState(seed)
    dense = rs.randint(0, b, size=(n, f)).astype(np.int32)
    db = rs.randint(0, b, size=f).astype(np.int32)
    rows, cols = np.nonzero(dense != db[None, :])
    flat = (cols * b + dense[rows, cols]).astype(np.int32)
    host = jspd.build_khot(rows.astype(np.int64), flat, db, n, b, f)
    return dense, host, host.to_device(), convert.sparse_from_numpy(
        host.flat, host.default_bin, host.stride, host.num_features)


def test_columns_equal_jax_and_dense():
    dense, _, jsp, tsp = _sp_pair()
    for feat in (0, 3, dense.shape[1] - 1):
        got = tspd.column(tsp, feat).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jspd.column(jsp, jnp.int32(feat))))
        np.testing.assert_array_equal(got, dense[:, feat])
    feat_r = np.random.RandomState(3).randint(0, dense.shape[1],
                                              size=len(dense))
    got = tspd.column_per_row(tsp, torch.as_tensor(feat_r)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jspd.column_per_row(jsp, jnp.asarray(
            feat_r.astype(np.int32)))))
    np.testing.assert_array_equal(got, dense[np.arange(len(dense)), feat_r])


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("form", ["all", "strict", "k4", "k4_unused"])
def test_histogram_forms_equal_jax_and_dense(form):
    dense, _, jsp, tsp = _sp_pair(seed=11)
    n, f = dense.shape
    b = 8
    rs = np.random.RandomState(13)
    vals = rs.randn(n, 3).astype(np.float32)
    tv = torch.as_tensor(vals)
    binned = torch.as_tensor(dense.astype(np.uint8))
    if form == "all":
        got = tspd.histogram(tsp, tv, num_bins=b)
        want = jspd.histogram(jsp, jnp.asarray(vals), num_bins=b)
        ref = dense_hist(binned, tv, num_bins=b)
    elif form == "strict":
        slot = np.where(rs.rand(n) < 0.4, 0, -1).astype(np.int32)
        got = tspd.histogram(tsp, tv, num_bins=b,
                             slot=torch.as_tensor(slot),
                             active=torch.ones(1, dtype=torch.int32))
        want = jspd.histogram(jsp, jnp.asarray(vals), num_bins=b,
                              slot=jnp.asarray(slot), num_slots=1)
        ref = dense_hist(binned, tv, num_bins=b, slot=torch.as_tensor(slot))
    else:
        # k4_unused: slots 2 and 3 hold no row (and a slot past K is
        # dropped, as the dense B1-K drops it)
        hi = 4 if form == "k4" else 2
        slot = rs.randint(-1, hi, size=n).astype(np.int32)
        if form == "k4_unused":
            slot[::17] = 9
        ts = torch.as_tensor(slot)
        got = tspd.histogram(tsp, tv, num_bins=b, slot=ts, num_slots=4,
                             slots_used=torch.tensor([4], dtype=torch.int32))
        want = np.asarray(jspd.histogram(
            jsp, jnp.asarray(vals), num_bins=b,
            slot=jnp.asarray(np.where(slot < 4, slot, -1)),
            num_slots=4)).reshape(f, b, 3, 4).transpose(3, 0, 1, 2)
        ref = histogram_slots_plain(binned, tv, ts, num_slots=4, num_bins=b)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _rel_err(got, want) <= HIST_RTOL
    assert _rel_err(got, ref) <= HIST_RTOL
    if form == "k4_unused":
        assert float(got[2:].abs().max()) == 0.0


def test_histogram_inactive_and_empty_slots():
    _, _, _, tsp = _sp_pair(seed=12)
    n = tsp.shape[0]
    vals = torch.randn(n, 3, generator=torch.Generator().manual_seed(1))
    off = torch.zeros(1, dtype=torch.int32)
    h = tspd.histogram(tsp, vals, num_bins=8,
                       slot=torch.zeros(n, dtype=torch.int32), active=off)
    assert float(h.abs().max()) == 0.0
    h = tspd.histogram(tsp, vals, num_bins=8,
                       slot=torch.full((n,), -1, dtype=torch.int32),
                       active=torch.ones(1, dtype=torch.int32))
    assert float(h.abs().max()) == 0.0
    with pytest.raises(TypeError, match="float32 vals"):
        tspd.histogram(tsp, vals.to(torch.int8), num_bins=8)


def _rec(leaf, new_leaf, feature, threshold, default_left, na_bin, smaller,
         active=1):
    return torch.tensor([leaf, new_leaf, feature, threshold, default_left,
                         na_bin, smaller, active], dtype=torch.int32)


def test_partitions_on_khot_rows_equal_dense():
    dense, _, _, tsp = _sp_pair(seed=21, n=500, f=9)
    binned = torch.as_tensor(dense.astype(np.uint8))
    lor0 = torch.as_tensor(np.random.RandomState(2).randint(
        0, 5, len(dense)).astype(np.int32))
    rank = torch.arange(8, dtype=torch.int32)
    for feat, thr, na in ((0, 3, -1), (4, 2, 7), (8, 5, -1)):
        rec = _rec(2, 6, feat, thr, 1, na, 6)
        a, b = lor0.clone(), lor0.clone()
        sa = partition_plain(tsp, a, rec, rank)
        sb = partition_plain(binned, b, rec, rank)
        assert torch.equal(a, b) and torch.equal(sa, sb)
        assert int((a == 6).sum()) > 0
    K = 3
    recs = torch.stack([_rec(k, 5 + k, 2 * k + 1, 3, k % 2, -1, k)
                        for k in range(K)])
    slot_of_leaf = torch.full((8,), -1, dtype=torch.int32)
    slot_of_leaf[:K] = torch.arange(K, dtype=torch.int32)
    z = torch.zeros
    step = BatchedStep(recs=recs, slot_of_leaf=slot_of_leaf,
                       idx2=z(2 * K, dtype=torch.int64), tot2=z((2 * K, 3)),
                       po2=z(2 * K), small_left=z(K, dtype=torch.bool),
                       keep2=z(2 * K, dtype=torch.bool),
                       status=torch.tensor([1, K], dtype=torch.int32))
    a, b = lor0.clone(), lor0.clone()
    ta = partition_slots_plain(tsp, a, step, rank)
    tb = partition_slots_plain(binned, b, step, rank)
    assert torch.equal(a, b) and torch.equal(ta, tb)
    assert recs.shape[1] == STEP_RECORD


# --- whole trees ---------------------------------------------------------------

def _exact_vals(x, seed):
    """(g, h, 1) with g and h multiples of 1/8 driven by the rows (every
    histogram sum, and every fill, exact in f32)."""
    rs = np.random.RandomState(seed)
    sig = _signal(x, seed) + 0.3 * rs.randn(x.shape[0])
    g = (np.round(8 * sig) / 8).astype(np.float32)
    h = (np.round(8 * (0.5 + rs.rand(x.shape[0]))) / 8).astype(np.float32)
    return np.stack([g, h, np.ones(x.shape[0], np.float32)], 1)


@pytest.mark.parametrize("L,K", [(31, 1), (40, 4)])
def test_whole_tree_on_khot_rows_equals_jax(L, K):
    x = sparse_rows(1500, 200, 25, seed=30 + K)
    dt, dj = _both(x, np.zeros(x.shape[0], np.float32),
                   {"enable_bundle": False})
    assert dt.binned_sparse is not None and dj.binned_sparse is not None
    nb, na = _bin_meta(dj)
    B, F = int(nb.max()), len(nb)
    vals = _exact_vals(x, 31)
    mask = np.ones(F, bool)
    p = {"min_data_in_leaf": 10}
    grow = make_grower(num_leaves=L, num_bins=B, params=JParams(**p),
                       split_batch=K)
    tj = grow(dj.binned_sparse.to_device(),
              *(jnp.asarray(a) for a in (vals, mask, nb, na)))
    ws = GrowWorkspace(x.shape[0], F, B, L, torch.device("cpu"),
                       split_batch=K)
    args = [torch.as_tensor(a) for a in (vals, mask, nb, na)]
    kw = dict(num_leaves=L, num_bins=B, params=TParams(**p), workspace=ws)
    sp = dt.binned_sparse.to_device("cpu")
    if K == 1:
        grow_tree(sp, *args, **kw)
    else:
        grow_tree_batched(sp, *args, split_batch=K, **kw)
    tt = fetch_tree(ws)
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl and nl > L // 2
    n = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:n],
                                      np.asarray(getattr(tj, name))[:n],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    for name, k in (("split_gain", n), ("internal_value", n),
                    ("leaf_value", nl), ("leaf_weight", nl),
                    ("leaf_count", nl)):
        np.testing.assert_array_equal(getattr(tt, name)[:k],
                                      np.asarray(getattr(tj, name))[:k],
                                      err_msg=name)
    # B4 on the k-hot rows walks the tree to the grower's leaves, as the
    # JAX package's traverse_tree_sparse does
    fields = {k: np.asarray(v) for k, v in tj._asdict().items()}
    tree = convert.tree_arrays_from_numpy(fields)
    node = [torch.as_tensor(getattr(tree, k)) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    lt = traverse_tree_plain(sp, *node, torch.as_tensor(na), steps=64)
    lj = jspd.traverse_tree_sparse(
        dj.binned_sparse.to_device(), tj.split_feature, tj.threshold_bin,
        tj.default_left, tj.left_child, tj.right_child, jnp.asarray(na),
        tj.is_cat_node, tj.cat_rank, steps=64)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(lt.numpy(), tt.leaf_of_row.numpy())
    score = torch.zeros(x.shape[0])
    lv = torch.tensor(np.asarray(tj.leaf_value, np.float32))
    add_tree_score(score, sp, *node, torch.as_tensor(na), lv, 0.5, steps=64)
    np.testing.assert_array_equal(score.numpy(),
                                  (lv[lt.long()] * 0.5).numpy())


# --- training ------------------------------------------------------------------

def _exact_l2(preds, ds):
    g = np.round(8.0 * (np.asarray(preds, np.float64) - ds.get_label())) / 8
    return g.astype(np.float32), np.ones(len(g), np.float32)


def _reg_data(seed=41, n=1200, nv=400, cat_col=None):
    x = sparse_rows(n + nv, 300, 30, seed, cat_col=cat_col)
    y = np.round(_signal(x, seed)).astype(np.float32)
    if cat_col is not None:
        c = x[:, cat_col].toarray().ravel()
        y += (8.0 * (c % 4 == 1) - 6.0 * (c == 6)).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _train(mod, params, data, rounds, path="per_iteration", fobj=None,
           valid=True, **ds_kw):
    x, y, xv, yv = data
    p = {"verbosity": -1, "min_data_in_leaf": 10, "enable_bundle": False,
         **params, **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y, **ds_kw)
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid else None
    ev = {}
    bst = mod.train(p, tr, rounds, valid_sets=vs, fobj=fobj,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


EXACT = {"strict": {"num_leaves": 15},
         "batched_k4": {"num_leaves": 24, "split_batch": 4},
         "bagging": {"num_leaves": 15, "bagging_fraction": 0.7,
                     "bagging_freq": 1},
         "goss": {"num_leaves": 15, "data_sample_strategy": "goss"},
         "feature_fraction": {"num_leaves": 15, "feature_fraction": 0.7},
         "categorical": {"num_leaves": 15, "min_data_per_group": 20}}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_gradients_give_the_jax_model_text(case):
    cat = case == "categorical"
    data = _reg_data(cat_col=7 if cat else None)
    kw = {"categorical_feature": [7]} if cat else {}
    params = {"objective": "none", "learning_rate": 0.5, "metric": "l2",
              **EXACT[case]}
    bt, evt = _train(lgt, params, data, 3, fobj=_exact_l2, **kw)
    bj, evj = _train(lgb, params, data, 3, fobj=_exact_l2, **kw)
    m = bt._model
    assert isinstance(m.binned_dev, tspd.SparseBinned)
    assert isinstance(m.valid_sets[0][1], tspd.SparseBinned)
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 3
    for i, (a, b) in enumerate(zip(tt, tj)):
        assert a == b, f"tree {i}"
    assert evt["valid_0"]["l2"] == evj["valid_0"]["l2"]
    if cat:
        assert m.models[0].num_cat > 0


def _bin_data(seed=51, n=1200, nv=400):
    x = sparse_rows(n + nv, 300, 30, seed)
    rs = np.random.RandomState(seed)
    y = (_signal(x, seed) + 0.5 * rs.randn(n + nv) > 0).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _mc_data(seed=61, n=1200, nv=400):
    x = sparse_rows(n + nv, 300, 30, seed)
    s = np.stack([_signal(x, seed + c) for c in range(3)], 1)
    y = np.argmax(s, 1).astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


def _l1_data(seed=65, n=1200, nv=400):
    x = sparse_rows(n + nv, 300, 30, seed)
    rs = np.random.RandomState(seed)
    y = (_signal(x, seed) + 0.3 * rs.standard_cauchy(n + nv)) \
        .astype(np.float32)
    return x[:n], y[:n], x[n:], y[n:]


BINARY = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "metric": "binary_logloss"}
TRAIN_CASES = {
    "binary": (BINARY, _bin_data, 4),
    "bynode_extra_trees": ({**BINARY, "feature_fraction_bynode": 0.8,
                            "extra_trees": True}, _bin_data, 4),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "num_leaves": 7, "learning_rate": 0.3,
                    "metric": "multi_logloss"}, _mc_data, 3),
    # a renewing objective: leaf values renewed on the host (per-iteration)
    "regression_l1": ({"objective": "regression_l1", "num_leaves": 15,
                       "learning_rate": 0.3, "metric": "l1"}, _l1_data, 4),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_training_predicts_as_jax(case):
    params, make, rounds = TRAIN_CASES[case]
    data = make()
    bt, evt = _train(lgt, params, data, rounds)
    bj, evj = _train(lgb, params, data, rounds)
    assert isinstance(bt._model.binned_dev, tspd.SparseBinned)
    assert bt.num_trees() == bj.num_trees()
    xv = data[2]
    np.testing.assert_allclose(bt.predict(xv), np.asarray(bj.predict(xv)),
                               rtol=PRED_TOL, atol=PRED_TOL)
    name = params["metric"]
    np.testing.assert_allclose(evt["valid_0"][name], evj["valid_0"][name],
                               rtol=1e-4)


def test_lambdarank_predicts_as_jax():
    x = sparse_rows(1000, 300, 30, seed=71)
    rs = np.random.RandomState(71)
    rel = np.clip(np.round(_signal(x, 71) + 1 + 0.5 * rs.randn(1000)),
                  0, 4).astype(np.float32)
    group = np.full(50, 20)
    p = {"objective": "lambdarank", "num_leaves": 7, "learning_rate": 0.3,
         "min_data_in_leaf": 10, "verbosity": -1, "enable_bundle": False}
    bt = lgt.train({**p, "device_type": "cpu"},
                   lgt.Dataset(x, rel, group=group), 3)
    bj = lgb.train({**p, "tpu_learner": "masked"},
                   lgb.Dataset(x, label=rel, group=group), 3)
    assert isinstance(bt._model.binned_dev, tspd.SparseBinned)
    np.testing.assert_allclose(bt.predict(x), np.asarray(bj.predict(x)),
                               rtol=PRED_TOL, atol=PRED_TOL)


def test_sparse_storage_predicts_as_dense():
    x, y, xv, _ = _bin_data(seed=81)
    p = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
         "min_data_in_leaf": 10, "enable_bundle": False,
         "device_type": "cpu"}
    ds, dd = lgt.Dataset(x, y), lgt.Dataset(x.toarray(), y)
    bs, bd = lgt.train(p, ds, 6), lgt.train(p, dd, 6)
    assert ds.binned_sparse is not None and dd.binned_sparse is None
    assert _structure(bs.model_to_string()) \
        == _structure(bd.model_to_string())
    np.testing.assert_allclose(bs.predict(xv), bd.predict(xv),
                               rtol=PRED_TOL, atol=PRED_TOL)


def test_paths_write_the_same_model():
    data = _bin_data(seed=91)
    params = {"objective": "binary", "num_leaves": 15,
              "learning_rate": 0.3}
    texts = {}
    for path in PATHS:
        bst, _ = _train(lgt, params, data, 6, path, valid=False)
        texts[path] = _norm(bst.model_to_string())
        if path != "per_iteration":
            assert bst._model.fetch_counts.get("epoch", 0) >= 1
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]


def test_sparse_valid_set_early_stopping():
    x, y, xv, yv = _reg_data(seed=23)
    params = {"objective": "regression", "num_leaves": 15, "metric": "l2",
              "learning_rate": 0.5, "early_stopping_round": 2}
    bst, ev = _train(lgt, params, (x, y, xv, yv), 30)
    m = bst._model
    # a sparse valid set takes the per-iteration path (JAX engine.py:459)
    assert isinstance(m.valid_sets[0][1], tspd.SparseBinned)
    assert m.fetch_counts.get("epoch", 0) == 0
    rec = ev["valid_0"]["l2"]
    assert 2 <= bst.best_iteration < len(rec) <= 30
    for it in (1, len(rec)):
        pred = bst.predict(xv, num_iteration=it)
        l2 = float(np.mean((pred - yv) ** 2))
        assert abs(l2 - rec[it - 1]) <= 1e-4 * max(1.0, l2)


def test_predict_csr_in_chunks(monkeypatch):
    x, y, xv, _ = _bin_data(seed=95)
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1, "device_type": "cpu",
                     "enable_bundle": False}, lgt.Dataset(x, y), 3)
    whole = bst.predict(xv)
    monkeypatch.setattr(tbooster, "SPARSE_PREDICT_ROWS", 37)
    np.testing.assert_array_equal(bst.predict(xv), whole)
    np.testing.assert_array_equal(bst.predict(xv.toarray()), whole)
    leaves = bst.predict(xv, pred_leaf=True)
    assert leaves.shape == (xv.shape[0], 3)


# --- carry-over ------------------------------------------------------------------

def test_subset_load_binary_and_convert(tmp_path):
    x = sparse_rows(2000, 600, 30, seed=8)
    y = np.random.RandomState(8).randn(2000).astype(np.float32)
    dt, dj = _both(x, y)
    assert dt.binned_sparse is not None
    sub = dt.subset(np.arange(100, 200))
    np.testing.assert_array_equal(sub.binned_sparse.flat,
                                  dt.binned_sparse.flat[100:200])
    p = str(tmp_path / "sparse.bin")
    dj.save_binary(p)
    ds2 = lgt.Dataset.load_binary(p)
    assert ds2.binned is None and ds2.num_data == 2000
    for name in ("flat", "default_bin", "stride"):
        np.testing.assert_array_equal(getattr(ds2.binned_sparse, name),
                                      getattr(dt.binned_sparse, name))
    b = lgt.train({"objective": "regression", "num_leaves": 7,
                   "verbosity": -1, "device_type": "cpu"}, ds2, 2)
    assert isinstance(b._model.binned_dev, tspd.SparseBinned)
    sp = convert.sparse_from_numpy(dj.binned_sparse.flat,
                                   dj.binned_sparse.default_bin,
                                   dj.binned_sparse.stride,
                                   dj.binned_sparse.num_features)
    vals = torch.as_tensor(np.random.RandomState(9).randn(2000, 3)
                           .astype(np.float32))
    own = dt.binned_sparse.to_device()
    assert torch.equal(tspd.histogram(sp, vals, num_bins=dt.max_bin),
                       tspd.histogram(own, vals, num_bins=dt.max_bin))


# --- refusals ------------------------------------------------------------------

def test_quant_train_on_sparse_storage_raises_the_jax_error():
    x, y, _, _ = _bin_data()
    with pytest.raises(ValueError, match="quant_train requires dense "
                                         "binned storage"):
        lgt.train({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu", "quant_train": True,
                   "enable_bundle": False}, lgt.Dataset(x, y), 2)


def test_stride_past_256_bins_is_refused():
    rs = np.random.RandomState(4)
    n, f, nnz = 5000, 40, 12
    cols = np.argsort(rs.rand(n, f), axis=1)[:, :nnz]
    cols.sort(axis=1)
    x = sps.csr_matrix((rs.rand(n * nnz) + 0.5, cols.ravel(),
                        np.arange(0, n * nnz + 1, nnz)), shape=(n, f))
    ds = lgt.Dataset(x, rs.randn(n), params={"max_bin": 400,
                                             "verbosity": -1})
    ds.construct()
    assert ds.binned_sparse is not None and ds.binned_sparse.stride > 256
    with pytest.raises(NotImplementedError, match="A9.5"):
        lgt.train({"objective": "regression", "verbosity": -1,
                   "device_type": "cpu", "max_bin": 400}, ds, 1)


def test_partitioned_learner_is_overridden_with_the_jax_warning(
        monkeypatch):
    x, y, _, _ = _bin_data()
    said = []
    monkeypatch.setattr(tgbdt.Log, "warning", staticmethod(said.append))
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "verbosity": -1, "device_type": "cpu",
                     "enable_bundle": False,
                     "tpu_learner": "partitioned"}, lgt.Dataset(x, y), 2)
    assert isinstance(bst._model.binned_dev, tspd.SparseBinned)
    assert any("tpu_learner=partitioned overridden to masked" in s
               for s in said)
    # dense storage keeps the partitioned learner, whose first tree is
    # the JAX package's
    p = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
         "tpu_learner": "partitioned"}
    bd = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x.toarray(), y),
                   1)
    assert bd._model.learner == "partitioned"
    assert_first_tree_equal(bd, lgb.train(p, lgb.Dataset(x.toarray(),
                                                         label=y), 1))
