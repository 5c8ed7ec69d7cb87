"""EFB (exclusive feature bundling) in the port against the JAX package.

Every kernel runs as its plain version (CPU tensors); the JAX package runs
the masked learner (``tpu_learner="masked"``), which keeps the matrix
bundled on its device as the port does:

- bundling: ``EFBInfo`` and the grouped matrix equal the JAX package's
  (one-hot blocks with NaN in a dense column, a conflict budget, a valid
  set built with ``reference=``, the pigeonhole skip);
- B9: ``expand_group_hist_plain`` against the JAX ``expand_group_hist`` at
  1, 2 and 2K children, bit for bit on dyadic histograms; on random f32
  ones every bin but bin 0 is equal and bin 0 (the FixHistogram
  subtraction, whose sum of the other bins both take in another order)
  within ``FIX0_ULPS`` ulps of the child's total; the wrapper leaves its
  output untouched on an inactive step;
- B3/B3-K and B4 with the decode maps: the bins they test are the
  unbundled matrix's, and B4 walks a JAX-grown tree to the JAX package's
  leaves and scores (``add_tree_score(..., efb_maps)``), bit for bit;
- whole trees on the bundled matrix against ``make_grower(efb=...)`` on
  exact (1/8-rounded) gradients: the strict grower at 31 leaves, the
  batched one at 255 (K = 16, one tree);
- ``train`` at the default ``enable_bundle``: the JAX package's model text
  on exact gradients, its tree structure on a gain-separated binary
  problem on each path, the same text on the three paths, multiclass,
  categorical features beside bundles, GOSS and bagging composed, and the
  bundled trees equal to the unbundled ones on exact gradients;
- a bundle of more than 256 bins is refused, naming ROADMAP A9.5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import convert
from lightgbm_torch import efb as tefb
from lightgbm_torch.grower import (STEP_RECORD, BatchedStep, GrowWorkspace,
                                   fetch_tree, grow_tree, grow_tree_batched,
                                   partition_plain, partition_slots_plain)
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_torch.predict_device import (add_tree_score,
                                           traverse_tree_plain)
from lightgbm_tpu import efb as jefb
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.predict_device import add_tree_score as j_add_tree_score
from lightgbm_tpu.predict_device import traverse_tree_binned

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

# bin 0 of a bundled feature is total - (bin 1 + ... + bin B-1); the port
# sums the other bins in bin order, XLA in an order of its choosing, so on
# inexact f32 values the two may part by roundings of the running sum,
# each at most an ulp of the child's total (the histograms below are real
# ones: every partial sum is at most the total in size)
FIX0_ULPS = 2
# tests/test_efb.py's bound on bundled against unbundled predictions; the
# port's bundled predictions are held to the JAX package's and to the
# port's own unbundled ones at it (B1 sums in f64, so a one-hot feature's
# bin 0, nearly every row, rounds once)
PRED_RTOL, PRED_ATOL = 1e-5, 1e-6
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 3}, "superepoch": {"fused_chunk": 3}}
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")


def onehot_data(n=3000, n_dense=3, cards=(12, 6), seed=0, nan_col=0,
                two_hot=0.0, cat_col=False):
    """Dense features (NaN every 17th row of ``nan_col``), then one-hot
    blocks of ``cards`` categories (a share ``two_hot`` of rows with a
    second category set: conflicts), then optionally an integer
    categorical column; a binary label driven by both."""
    rs = np.random.RandomState(seed)
    dense = rs.randn(n, n_dense)
    cols, cats = [dense], []
    for c in cards:
        cat = rs.randint(0, c, size=n)
        oh = np.zeros((n, c))
        oh[np.arange(n), cat] = 1.0
        if two_hot:
            rows = rs.rand(n) < two_hot
            oh[rows, (cat[rows] + 1) % c] = 1.0
        cols.append(oh)
        cats.append(cat)
    logit = dense[:, 0] + (cats[0] % 3 == 0) + 0.2 * rs.randn(n)
    if len(cats) > 1:
        logit -= 0.7 * (cats[1] == 2)
    if cat_col:
        cc = rs.randint(0, 9, size=n)
        cols.append(cc[:, None].astype(np.float64))
        logit += 0.9 * (cc % 4 == 1)
    x = np.column_stack(cols)
    if nan_col is not None:
        x[::17, nan_col] = np.nan
    return x, (logit > 0.5).astype(np.float32)


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


def _assert_same_bundles(dt, dj):
    assert dt.efb is not None and dj.efb is not None
    assert dt.efb.groups == dj.efb.groups
    for name in ("group_of_feat", "off_of_feat", "group_num_bin"):
        np.testing.assert_array_equal(getattr(dt.efb, name),
                                      getattr(dj.efb, name), err_msg=name)
    assert dt.binned.dtype == dj.binned.dtype
    np.testing.assert_array_equal(dt.binned, dj.binned)


# --- bundling ---------------------------------------------------------------

BUNDLE_CASES = {
    "onehot_nan": ({}, {}),
    "three_blocks": ({"cards": (12, 6, 20), "seed": 3}, {"max_bin": 31}),
    "conflict_rate": ({"two_hot": 0.01, "seed": 4},
                      {"max_conflict_rate": 0.05}),
    "categorical_beside": ({"cat_col": True, "seed": 5}, {}),
}


@pytest.mark.parametrize("case", sorted(BUNDLE_CASES))
def test_bundles_equal_jax(case):
    data_kw, params = BUNDLE_CASES[case]
    x, y = onehot_data(**data_kw)
    kw = {}
    if data_kw.get("cat_col"):
        kw["categorical_feature"] = [x.shape[1] - 1]
    dt, dj = _both(x, y, params, **kw)
    _assert_same_bundles(dt, dj)
    assert dt.binned.shape[1] < dt.num_features
    if case == "conflict_rate":
        # the budget admits the conflicting rows; at rate 0 the blocks
        # split into more groups
        d0, _ = _both(x, y)
        assert d0.efb.num_groups > dt.efb.num_groups
    if data_kw.get("cat_col"):
        j = dt.num_features - 1
        assert dt.efb.off_of_feat[j] == -1      # categorical: a singleton


def test_valid_set_built_with_reference_shares_the_bundles():
    x, y = onehot_data(seed=6)
    xv, yv = onehot_data(n=800, seed=7)
    dt, dj = _both(x, y)
    vt = lgt.Dataset(xv, yv, reference=dt).construct()
    vj = lgb.Dataset(xv, label=yv, reference=dj).construct()
    assert vt.efb is dt.efb
    _assert_same_bundles(vt, vj)
    nb, _ = _bin_meta(dt)
    np.testing.assert_array_equal(
        tefb.unbundle(vt.binned, vt.efb, nb), vt.feature_binned())


def test_find_bundles_bin_grouped_unbundle_equal_jax():
    rs = np.random.RandomState(8)
    n, k = 600, 9
    cat = rs.randint(0, k, size=n)
    bins = np.zeros((n, k + 2), np.int64)
    bins[np.arange(n), cat] = 1 + rs.randint(0, 3, size=n)
    bins[:, k] = rs.randint(0, 7, size=n)              # dense
    bins[:, k + 1] = rs.randint(0, 5, size=n)          # categorical
    nb = np.asarray([4] * k + [7, 5])
    is_cat = np.zeros(k + 2, bool)
    is_cat[k + 1] = True
    mfb = np.zeros(k + 2, np.int64)
    args = (bins, nb, is_cat, mfb)
    et, ej = tefb.find_bundles(*args), jefb.find_bundles(*args)
    assert et.groups == ej.groups and et.any_bundled
    np.testing.assert_array_equal(et.off_of_feat, ej.off_of_feat)
    gt = tefb.bin_grouped(lambda j: bins[:, j], et, n)
    np.testing.assert_array_equal(gt, jefb.bin_grouped(lambda j: bins[:, j],
                                                       ej, n))
    np.testing.assert_array_equal(tefb.unbundle(gt, et, nb), bins)
    for a, b in zip(tefb.expansion_maps(et, nb, 7),
                    jefb.expansion_maps(ej, nb, 7)):
        np.testing.assert_array_equal(a, b)


def test_pigeonhole_skip_uses_bin0_occupancy():
    # tests/test_efb.py's case: a bin 0 that merged several values must
    # not hide a mutually exclusive pair
    rng = np.random.RandomState(5)
    n = 6000
    a, b = np.zeros(n), np.zeros(n)
    half = n // 2
    a[:half] = rng.rand(half) + 0.5
    a[half:half + 600] = rng.choice([1e-35, 0.0], 600)
    b[half:] = rng.rand(half) + 0.5
    x = np.column_stack([a, b, rng.randn(n)])
    y = (a + b > 1.0).astype(np.float32)
    dt, dj = _both(x, y, {"max_bin": 15})
    _assert_same_bundles(dt, dj)
    assert any(len(g) == 2 for g in dt.efb.groups)


def test_pigeonhole_skip_fires_on_dense(monkeypatch):
    import lightgbm_torch.dataset as ds_mod
    called = []
    orig = ds_mod.find_bundles
    monkeypatch.setattr(ds_mod, "find_bundles",
                        lambda *a, **k: called.append(1) or orig(*a, **k))
    rng = np.random.RandomState(6)
    x = rng.standard_normal((3000, 20))
    dt, dj = _both(x, (x[:, 0] > 0).astype(np.float32), {"max_bin": 31})
    assert dt.efb is None and dj.efb is None and not called


# --- B9 ---------------------------------------------------------------------

def _efb_state(seed=0, cards=(12, 6), max_bin=31):
    x, y = onehot_data(cards=cards, seed=seed)
    ds = lgt.Dataset(x, y, params={"verbosity": -1,
                                   "max_bin": max_bin}).construct()
    nb, _ = _bin_meta(ds)
    return ds, nb, int(nb.max())


def _group_hists(ds, C, seed, dyadic):
    """C children's real group histograms: random (g, h, 1) of random row
    subsets, summed per group bin in f64 and rounded to f32 (dyadic
    values: exact), with their totals."""
    rs = np.random.RandomState(seed)
    n, g = ds.binned.shape
    bg = ds.efb.max_group_bin
    hist = np.zeros((C, g, bg, 3), np.float32)
    tot = np.zeros((C, 3), np.float32)
    for c in range(C):
        rows = rs.rand(n) < 0.3 + 0.5 * rs.rand()
        gr = rs.randn(n)
        hs = 0.1 + rs.rand(n)
        if dyadic:
            gr, hs = np.round(8 * gr) / 8, np.round(8 * hs) / 8
        vals = np.stack([gr, hs, np.ones(n)], 1)[rows].astype(np.float32)
        for j in range(g):
            np.add.at(hist[c, j], ds.binned[rows, j].astype(np.int64),
                      vals.astype(np.float64))
        tot[c] = vals.astype(np.float64).sum(0)
    return hist, tot


def _jax_expand(ds, nb, B, hist, tot):
    d = jefb.make_device_efb(ds.efb, nb, B)
    return np.stack([np.asarray(jefb.expand_group_hist(
        jnp.asarray(hist[c]), jnp.asarray(tot[c]), d.group_of_feat,
        d.col_idx, d.fix0)) for c in range(len(hist))])


@pytest.mark.parametrize("C", [1, 2, 32])
@pytest.mark.parametrize("dyadic", [True, False])
def test_expand_group_hist_matches_jax(C, dyadic):
    ds, nb, B = _efb_state(seed=C)
    hist, tot = _group_hists(ds, C, seed=10 + C, dyadic=dyadic)
    dev = tefb.make_device_efb(ds.efb, nb, B, "cpu")
    out = tefb.expand_group_hist(torch.as_tensor(hist), torch.as_tensor(tot),
                                 dev).numpy()
    ref = _jax_expand(ds, nb, B, hist, tot)
    assert out.shape == ref.shape == (C, len(nb), B, 3)
    if dyadic:
        np.testing.assert_array_equal(out, ref)
        return
    np.testing.assert_array_equal(out[:, :, 1:], ref[:, :, 1:])
    fix = np.asarray(ds.efb.off_of_feat) >= 0
    np.testing.assert_array_equal(out[:, ~fix, 0], ref[:, ~fix, 0])
    ulp = np.spacing(np.abs(tot))[:, None, :]
    assert (np.abs(out[:, fix, 0] - ref[:, fix, 0])
            <= FIX0_ULPS * ulp).all()


def test_expand_group_hist_inactive_step_writes_nothing():
    ds, nb, B = _efb_state(seed=2)
    hist, tot = _group_hists(ds, 2, seed=3, dyadic=True)
    dev = tefb.make_device_efb(ds.efb, nb, B, "cpu")
    out = torch.full((2, len(nb), B, 3), 7.0)
    for flag, want in ((0, out.clone()),
                       (1, torch.as_tensor(_jax_expand(ds, nb, B, hist,
                                                       tot)))):
        got = tefb.expand_group_hist(
            torch.as_tensor(hist), torch.as_tensor(tot), dev,
            active=torch.tensor([flag], dtype=torch.int32), out=out)
        assert got is out
        assert torch.equal(out, want)


def test_expand_group_hist_singletons_only():
    # every feature its own group: the expansion is the histogram itself
    # cut to each feature's bins (bin 0 kept, no fix)
    rs = np.random.RandomState(9)
    nb = np.asarray([5, 3, 7], np.int32)
    info = tefb.EFBInfo(groups=[[0], [1], [2]],
                        group_of_feat=np.arange(3, dtype=np.int32),
                        off_of_feat=np.full(3, -1, np.int32),
                        group_num_bin=nb.copy())
    dev = tefb.make_device_efb(info, nb, 7, "cpu")
    hist = rs.randn(2, 3, 7, 3).astype(np.float32)
    for j, b in enumerate(nb):
        hist[:, j, b:] = 0.0
    out = tefb.expand_group_hist(torch.as_tensor(hist),
                                 torch.zeros((2, 3)), dev)
    np.testing.assert_array_equal(out.numpy(), hist)


# --- B3/B3-K and B4 decode ---------------------------------------------------

def _rec(leaf, new_leaf, feature, threshold, default_left, na_bin, smaller,
         active=1):
    return torch.tensor([leaf, new_leaf, feature, threshold, default_left,
                         na_bin, smaller, active], dtype=torch.int32)


def test_partition_decodes_bundles_as_the_unbundled_matrix():
    x, y = onehot_data(n=2000, cards=(12, 6), seed=11, cat_col=True)
    ds = lgt.Dataset(x, y, params={"verbosity": -1},
                     categorical_feature=[x.shape[1] - 1]).construct()
    nb, na = _bin_meta(ds)
    dev = tefb.make_device_efb(ds.efb, nb, int(nb.max()), "cpu")
    grouped = torch.as_tensor(ds.binned)
    flat = torch.as_tensor(ds.feature_binned())
    rs = np.random.RandomState(12)
    B = int(nb.max())
    # a categorical split's rank row beside the identity
    rank = torch.stack([torch.arange(B, dtype=torch.int32),
                        torch.as_tensor(rs.permutation(B).astype(np.int32))])
    lor0 = torch.as_tensor(rs.randint(0, 2, len(x)).astype(np.int32))
    for f in range(len(nb)):
        thr = int(rs.randint(0, nb[f]))
        rec = _rec(1, 2, f, thr, f % 2, int(na[f]), 2)
        a, b = lor0.clone(), lor0.clone()
        sa = partition_plain(grouped, a, rec, rank, dev)
        sb = partition_plain(flat, b, rec, rank)
        assert torch.equal(a, b) and torch.equal(sa, sb), f
    # B3-K: two slots at once, each record its own feature
    K, L = 2, 4
    feats = rs.choice(len(nb), size=K, replace=False)
    recs = torch.stack([_rec(k, L - K + k, int(feats[k]),
                             int(rs.randint(0, nb[feats[k]])), 1,
                             int(na[feats[k]]), k) for k in range(K)])
    step = BatchedStep(recs=recs,
                       slot_of_leaf=torch.tensor([0, 1, -1, -1],
                                                 dtype=torch.int32),
                       idx2=torch.zeros(2 * K, dtype=torch.int64),
                       tot2=torch.zeros((2 * K, 3)),
                       po2=torch.zeros(2 * K),
                       small_left=torch.zeros(K, dtype=torch.bool),
                       keep2=torch.zeros(2 * K, dtype=torch.bool),
                       status=torch.tensor([1, K], dtype=torch.int32))
    a, b = lor0.clone(), lor0.clone()
    ta = partition_slots_plain(grouped, a, step, rank, dev)
    tb = partition_slots_plain(flat, b, step, rank)
    assert torch.equal(a, b) and torch.equal(ta, tb)
    assert recs.shape[1] == STEP_RECORD


def _exact_vals(x, seed):
    """Per-row (g, h, 1) with g a multiple of 1/8 driven by the raw
    features (every histogram sum exact in f32)."""
    rs = np.random.RandomState(seed)
    d = np.nan_to_num(x[:, 0], nan=-1.0)
    sig = 1.5 * d - 1.0 * x[:, 4] + 0.8 * x[:, 8] + 0.6 * x[:, 2] \
        + 0.7 * (x[:, 1] > 0.3) + 0.3 * rs.randn(len(x))
    g = (np.round(8 * sig) / 8).astype(np.float32)
    h = (np.round(8 * (0.5 + rs.rand(len(x)))) / 8).astype(np.float32)
    return np.stack([g, h, np.ones(len(x), np.float32)], 1)


def _grow_both(L, K, seed, cards=(12, 6, 20), params=None):
    x, y = onehot_data(n=4000, cards=cards, seed=seed)
    dt, dj = _both(x, y, {"max_bin": 31})
    _assert_same_bundles(dt, dj)
    nb, na = _bin_meta(dj)
    B, F = int(nb.max()), len(nb)
    vals = _exact_vals(x, seed)
    mask = np.ones(F, bool)
    p = params or {"min_data_in_leaf": 20}
    grow = make_grower(num_leaves=L, num_bins=B, params=JParams(**p),
                       split_batch=K,
                       efb=jefb.make_device_efb(dj.efb, nb, B))
    tj = grow(*(jnp.asarray(a) for a in (dj.binned, vals, mask, nb, na)))
    dev = tefb.make_device_efb(dt.efb, nb, B, "cpu")
    ws = GrowWorkspace(len(x), F, B, L, torch.device("cpu"), split_batch=K,
                       efb=dev)
    args = [torch.as_tensor(a) for a in (dt.binned, vals, mask, nb, na)]
    kw = dict(num_leaves=L, num_bins=B, params=TParams(**p), workspace=ws,
              efb=dev)
    if K == 1:
        grow_tree(*args, **kw)
    else:
        grow_tree_batched(*args, split_batch=K, **kw)
    return fetch_tree(ws), tj, dt, dj, dev, x


@pytest.mark.parametrize("L,K,seed", [(31, 1, 13), (255, 16, 14)])
def test_whole_tree_on_bundles_equals_jax(L, K, seed):
    p = {"min_data_in_leaf": 20} if K == 1 else {"min_data_in_leaf": 5}
    tt, tj, _, _, _, _ = _grow_both(L, K, seed, params=p)
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
                    ("internal_count", n), ("leaf_value", nl),
                    ("leaf_weight", nl), ("leaf_count", nl)):
        np.testing.assert_array_equal(getattr(tt, name)[:k],
                                      np.asarray(getattr(tj, name))[:k],
                                      err_msg=name)
    # the tree splits bundled one-hot features, not only the dense ones
    assert (tt.split_feature[:n] >= 3).any()


def test_b4_walks_bundled_rows_as_jax():
    tt, tj, dt, dj, dev, _ = _grow_both(31, 1, 15)
    xv, yv = onehot_data(n=1500, cards=(12, 6, 20), seed=16)
    vt = lgt.Dataset(xv, yv, reference=dt).construct()
    vj = lgb.Dataset(xv, label=yv, reference=dj).construct()
    np.testing.assert_array_equal(vt.binned, vj.binned)
    nb, na = _bin_meta(dj)
    fields = {k: np.asarray(v) for k, v in tj._asdict().items()}
    tree = convert.tree_arrays_from_numpy(fields)
    node = [torch.as_tensor(getattr(tree, k)) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    steps = 32
    jmaps = (jnp.asarray(dj.efb.group_of_feat),
             jnp.asarray(dj.efb.off_of_feat), jnp.asarray(nb - 1))
    lj = traverse_tree_binned(jnp.asarray(vj.binned), tj.split_feature,
                              tj.threshold_bin, tj.default_left,
                              tj.left_child, tj.right_child,
                              jnp.asarray(na), tj.is_cat_node, tj.cat_rank,
                              jmaps, steps=steps)
    lt = traverse_tree_plain(torch.as_tensor(vt.binned), *node,
                             torch.as_tensor(na), steps=steps,
                             efb_maps=dev.maps)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert len(np.unique(np.asarray(lj))) > 8
    score0 = np.random.RandomState(17).randn(len(xv)).astype(np.float32)
    st = add_tree_score(torch.as_tensor(score0.copy()),
                        torch.as_tensor(vt.binned), *node,
                        torch.as_tensor(na), torch.as_tensor(tree.leaf_value),
                        1.0, steps=steps, efb_maps=dev.maps)
    sj = j_add_tree_score(jnp.asarray(score0), jnp.asarray(vj.binned),
                          tj.split_feature, tj.threshold_bin,
                          tj.default_left, tj.left_child, tj.right_child,
                          jnp.asarray(na), tj.is_cat_node, tj.cat_rank,
                          tj.leaf_value, jnp.float32(1.0), jmaps,
                          steps=steps)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    # the column form of an [N, 3] score
    s3 = torch.zeros((len(xv), 3))
    add_tree_score(s3, torch.as_tensor(vt.binned), *node,
                   torch.as_tensor(na), torch.as_tensor(tree.leaf_value),
                   1.0, steps=steps, efb_maps=dev.maps, column=2)
    np.testing.assert_array_equal(s3[:, 2].numpy(),
                                  np.asarray(tree.leaf_value)[lt.numpy()])
    assert not s3[:, :2].any()


# --- training -----------------------------------------------------------------

def _exact_l2(preds, ds):
    g = np.round(8.0 * (np.asarray(preds, np.float64) - ds.get_label())) / 8
    return g.astype(np.float32), np.ones(len(g), np.float32)


def _train(mod, params, data, rounds, path="superepoch", fobj=None,
           valid=True, **ds_kw):
    x, y, xv, yv = data
    p = {"verbosity": -1, "max_bin": 31, "min_data_in_leaf": 20, **params,
         **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y, **ds_kw)
    vs = [mod.Dataset(xv, yv, reference=tr)] if valid else None
    ev = {}
    bst = mod.train(p, tr, rounds, valid_sets=vs, fobj=fobj,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


def _reg_data(seed=21, cat_col=False):
    x, _ = onehot_data(n=3000, cards=(12, 6, 20), seed=seed,
                       cat_col=cat_col)
    xv, _ = onehot_data(n=800, cards=(12, 6, 20), seed=seed + 1,
                        cat_col=cat_col)

    def label(a):
        y = 2 * np.nan_to_num(a[:, 0]) - 1.5 * a[:, 4] + a[:, 9] \
            + 0.5 * a[:, 1]
        if cat_col:
            y += 2.0 * (a[:, -1] % 4 == 1) - 1.0 * (a[:, -1] == 6)
        return np.round(y).astype(np.float32)
    return x, label(x), xv, label(xv)


EXACT = {"strict": {"num_leaves": 15},
         "batched_k8": {"num_leaves": 64, "min_data_in_leaf": 10},
         "categorical": {"num_leaves": 15, "min_data_per_group": 20}}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_exact_gradients_give_the_jax_model_text(case):
    cat = case == "categorical"
    data = _reg_data(cat_col=cat)
    kw = {"categorical_feature": [data[0].shape[1] - 1]} if cat else {}
    params = {"objective": "none", "learning_rate": 0.5, "metric": "l2",
              **EXACT[case]}
    bt, evt = _train(lgt, params, data, 4, "per_iteration", _exact_l2, **kw)
    bj, evj = _train(lgb, params, data, 4, "per_iteration", _exact_l2, **kw)
    assert bt._model.efb_dev is not None and bj._model._use_efb
    assert bt._model.binned_dev.shape[1] < bt._model.num_features
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 4
    for i, (a, b) in enumerate(zip(tt, tj)):
        assert a == b, f"tree {i}"
    assert evt["valid_0"]["l2"] == evj["valid_0"]["l2"]
    if cat:
        assert min(t.num_cat for t in bt._model.models) > 0
    # bundling is lossless: the unbundled run writes the same trees
    bu, _ = _train(lgt, {**params, "enable_bundle": False}, data, 4,
                   "per_iteration", _exact_l2, **kw)
    assert bu._model.efb_dev is None
    assert _trees(bu.model_to_string()) == tt


BINARY = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.3,
          "metric": ["binary_logloss", "auc"]}


def _bin_data():
    # no NaN: an NA bin makes near-tied NA directions (ROADMAP C)
    x, y = onehot_data(n=4000, cards=(12, 6), seed=31, nan_col=None)
    xv, yv = onehot_data(n=1000, cards=(12, 6), seed=32, nan_col=None)
    return x, y, xv, yv


@pytest.fixture(scope="module")
def binary_runs():
    data = _bin_data()
    return {(path, mod.__name__): _train(
        mod, BINARY, data, 5, path, valid=path != "fused_chunk")
        for path in PATHS for mod in (lgt, lgb)}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_binary_structure_equals_jax(binary_runs, path):
    (bt, evt), (bj, evj) = binary_runs[(path, "lightgbm_torch")], \
        binary_runs[(path, "lightgbm_tpu")]
    assert bt._model.efb_dev is not None
    st, sj = _structure(bt.model_to_string()), \
        _structure(bj.model_to_string())
    assert len(st) == 8 * 5 and st == sj
    if path != "fused_chunk":
        np.testing.assert_allclose(evt["valid_0"]["binary_logloss"],
                                   evj["valid_0"]["binary_logloss"],
                                   rtol=1e-5)
    xv = _bin_data()[2]
    np.testing.assert_allclose(bt.predict(xv), np.asarray(bj.predict(xv)),
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_paths_write_the_same_model(binary_runs):
    texts = {p: _norm(binary_runs[(p, "lightgbm_torch")][0]
                      .model_to_string()) for p in PATHS}
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]
    m = binary_runs[("superepoch", "lightgbm_torch")][0]._model
    assert m.fetch_counts.get("epoch", 0) >= 1


def test_bundled_predicts_as_unbundled():
    # tests/test_efb.py's fixture and settings
    x, y = onehot_data(n=3000, cards=(12,), seed=0, nan_col=None)
    params = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 20, "device_type": "cpu"}
    b1 = lgt.train({**params, "enable_bundle": True}, lgt.Dataset(x, y), 10)
    b2 = lgt.train({**params, "enable_bundle": False}, lgt.Dataset(x, y), 10)
    bj = lgb.train({**params, "device_type": "cpu", "tpu_learner": "masked",
                    "enable_bundle": True}, lgb.Dataset(x, label=y), 10)
    assert b1._model.efb_dev is not None and b2._model.efb_dev is None
    assert b1._model.binned_dev.shape[1] < x.shape[1]
    assert _structure(b1.model_to_string()) \
        == _structure(b2.model_to_string())
    np.testing.assert_allclose(b1.predict(x), np.asarray(bj.predict(x)),
                               rtol=PRED_RTOL, atol=PRED_ATOL)
    np.testing.assert_allclose(b1.predict(x), b2.predict(x),
                               rtol=PRED_RTOL, atol=PRED_ATOL)


def test_multiclass_on_bundles_equals_jax():
    x, _ = onehot_data(n=3000, cards=(12, 6), seed=41)
    xv, _ = onehot_data(n=800, cards=(12, 6), seed=42)

    def label(a):
        c = np.argmax(np.stack([2 * np.nan_to_num(a[:, 0]),
                                1.6 * a[:, 4] + a[:, 3],
                                a[:, 1] + 1.2 * a[:, 15]], 1), 1)
        return c.astype(np.float32)
    data = (x, label(x), xv, label(xv))
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 7,
              "learning_rate": 0.3, "metric": "multi_logloss"}
    bt, evt = _train(lgt, params, data, 3, "per_iteration")
    bj, evj = _train(lgb, params, data, 3, "per_iteration")
    assert bt._model.efb_dev is not None
    assert bt.num_trees() == bj.num_trees() == 9
    assert _structure(bt.model_to_string()) \
        == _structure(bj.model_to_string())
    np.testing.assert_allclose(evt["valid_0"]["multi_logloss"],
                               evj["valid_0"]["multi_logloss"], rtol=1e-5)


SAMPLED = {"goss": {"data_sample_strategy": "goss"},
           "bagging": {"bagging_fraction": 0.7, "bagging_freq": 1,
                       "feature_fraction": 0.8},
           "bynode_extra": {"feature_fraction_bynode": 0.7,
                            "extra_trees": True}}


@pytest.mark.parametrize("mode", sorted(SAMPLED))
def test_sampling_on_bundles_equals_jax(mode):
    data = _bin_data()
    params = {**BINARY, **SAMPLED[mode]}
    bt, _ = _train(lgt, params, data, 4, "superepoch")
    bj, _ = _train(lgb, params, data, 4, "superepoch")
    bp, _ = _train(lgt, params, data, 4, "per_iteration")
    assert bt._model.efb_dev is not None
    assert _structure(bt.model_to_string()) \
        == _structure(bj.model_to_string())
    assert _norm(bt.model_to_string()) == _norm(bp.model_to_string())


def test_wide_bundles_train_on_the_batched_grower():
    data = _reg_data(seed=51)
    params = {"objective": "none", "num_leaves": 255, "learning_rate": 0.5,
              "min_data_in_leaf": 5, "metric": "l2"}
    bt, _ = _train(lgt, params, data, 2, "per_iteration", _exact_l2)
    bj, _ = _train(lgb, params, data, 2, "per_iteration", _exact_l2)
    assert bt._model.split_batch == 16 and bt._model.efb_dev is not None
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert tt[0] == tj[0]
    assert int(tt[0].split("num_leaves=")[1].split()[0]) > 200


@pytest.mark.parametrize("valid_params", [{}, {"enable_bundle": False}])
def test_valid_set_without_reference_takes_the_train_bundles(valid_params):
    # a valid set constructed on its own before training (the train rows
    # again, so the same bin mappers): its own bundles, or none, are
    # regrouped into the train set's, and its walk (B4) lands every row
    # where the grower put it
    x, y = onehot_data(n=2000, seed=71, nan_col=None)
    tr = lgt.Dataset(x, y)
    va = lgt.Dataset(x, y, params={"verbosity": -1, **valid_params})
    va.construct()
    bst = lgt.train({"objective": "binary", "num_leaves": 15,
                     "verbosity": -1, "device_type": "cpu",
                     "superepoch": -1, "fused_chunk": 1}, tr, 4,
                    valid_sets=[va])
    m = bst._model
    assert m.efb_dev is not None and va.efb is not tr.efb
    assert (va.efb is None) == ("enable_bundle" in valid_params)
    np.testing.assert_array_equal(m.valid_sets[0][1].numpy(), tr.binned)
    np.testing.assert_array_equal(m.valid_score(0), m.train_score())


def test_bundle_over_256_bins_is_refused():
    # three mutually exclusive features of about 100 bins each: their
    # bundle has about 300 bins, so the grouped matrix is uint16
    rs = np.random.RandomState(61)
    n = 6000
    x = np.zeros((n, 4))
    which = rs.randint(0, 3, n)
    x[np.arange(n), which] = rs.rand(n) + 0.5
    x[:, 3] = rs.randn(n)
    y = (x[:, 0] > 1.0).astype(np.float32)
    ds = lgt.Dataset(x, y, params={"verbosity": -1, "max_bin": 100})
    ds.construct()
    assert ds.efb is not None and ds.binned.dtype == np.uint16
    with pytest.raises(NotImplementedError,
                       match="per EFB bundle.*ROADMAP A9.5"):
        lgt.train({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu"}, ds, 1)
