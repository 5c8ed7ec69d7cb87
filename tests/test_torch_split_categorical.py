"""B2 with categorical features (B2-cat's plain version), B3/B3-K with
per-leaf rank tables, B3s/B3s-K writing categorical nodes and B4 walking
them, against the JAX package on the CPU (every kernel as its plain
version):

- ``find_best_split`` with ``is_cat`` against the JAX ``find_best_split``
  leaf by leaf: one-vs-rest, ascending and descending subsets, exact ratio
  ties, unused and padding bins, ``max_cat_threshold``, ``cat_l2``,
  ``cat_smooth``, path smoothing, [K, F] masks and both outcomes of the
  numerical/categorical merge.  Feature, threshold, is-categorical flag
  and rank row are equal; gains, sums and outputs within ``RTOL`` (the
  prefix sums run in another order: the port's in bin order, the JAX
  package's as an associative scan);
- the partition rule with rank tables (``partition_plain``,
  ``partition_slots_plain``) against the JAX ``do_split`` rule;
- whole categorical trees of the strict (31 leaves) and batched (64
  leaves, K = 8; 255 leaves, K = 16) growers against ``make_grower`` with
  ``is_cat``: every integer array, ``is_cat_node``, ``cat_rank`` and the
  row -> leaf vector equal;
- ``add_tree_score_plain`` on a JAX-grown categorical tree, carried across
  by ``convert.tree_arrays_from_numpy``, against the JAX
  ``add_tree_score``, with NaN bins in numerical columns.

The fixtures' gradients are multiples of 1/8 and their hessians multiples
of 1/4, so every histogram and prefix sum is exact in both packages:
mirrored subsets (an ascending prefix and the descending prefix of the
other used bins) then tie exactly, and both packages take the ascending
one, the first in the flattened order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch import convert
from lightgbm_torch.grower import (DEFAULT_LEFT, FEATURE, NEW_LEAF,
                                   STEP_RECORD, THRESHOLD, BatchedStep,
                                   GrowWorkspace, fetch_tree, grow_tree,
                                   grow_tree_batched, partition_plain,
                                   partition_slots_plain)
from lightgbm_torch.ops import split as ts
from lightgbm_torch.predict_device import add_tree_score, traverse_tree_plain
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import compute_histogram
from lightgbm_tpu.predict_device import add_tree_score as j_add_tree_score

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

RTOL = 1e-5
BINS = 40


def cat_problem(seed, n=5000, cards=(3, 12, 30, 38), num_feats=2,
                na_num=True, bins=BINS):
    """Binned rows: categorical columns of the given cardinalities
    (Zipf-skewed, so the rarest categories fall below min_data_per_group),
    then ``num_feats`` numerical columns (the first with an NA bin);
    exact (g, h, 1) vals with per-category effects."""
    rs = np.random.RandomState(seed)
    cols, num_bin, na_bin, effects = [], [], [], np.zeros(n)
    for c in cards:
        p = 1.0 / np.arange(1, c + 1) ** 0.8
        col = rs.choice(c, size=n, p=p / p.sum())
        cols.append(col)
        num_bin.append(c)
        na_bin.append(-1)
        effects += rs.randn(c)[col]
    for j in range(num_feats):
        col = rs.randint(0, bins - 1, n)
        nb, na = bins - 1, -1
        if na_num and j == 0:
            col[rs.rand(n) < 0.15] = bins - 1
            nb, na = bins, bins - 1
        cols.append(col)
        num_bin.append(nb)
        na_bin.append(na)
        effects += 1.2 * (col >= bins // 2)
    binned = np.stack(cols, 1).astype(np.uint8)
    g = np.round(8 * (0.3 - effects + 0.4 * rs.randn(n))) / 8
    h = np.round(4 * (0.5 + rs.rand(n))) / 4
    vals = np.stack([g, h, np.ones(n)], 1).astype(np.float32)
    is_cat = np.array([True] * len(cards) + [False] * num_feats)
    return (binned, vals, np.asarray(num_bin, np.int32),
            np.asarray(na_bin, np.int32), is_cat)


def _leaves(K, seed, bins=BINS, **kw):
    binned, vals, num_bin, na_bin, is_cat = cat_problem(seed, bins=bins,
                                                        **kw)
    rs = np.random.RandomState(seed + 1)
    hists, totals = [], []
    for k in range(K):
        rows = rs.rand(len(binned)) < (1.0 if k == 0 else
                                       rs.uniform(0.2, 0.9))
        hists.append(np.asarray(compute_histogram(
            jnp.asarray(binned[rows]), jnp.asarray(vals[rows]),
            num_bins=bins)))
        totals.append(vals[rows].sum(axis=0))
    return (np.stack(hists), np.stack(totals).astype(np.float32), num_bin,
            na_bin, is_cat)


def _port(hist, total, parent, num_bin, na_bin, mask, is_cat, params):
    rec, cat, rank = ts.find_best_split(
        *(torch.as_tensor(a) for a in (hist, total, parent, num_bin, na_bin,
                                       mask)),
        ts.SplitParams(**params), is_cat=torch.as_tensor(is_cat))
    return ts.unpack(rec), cat, rank


def _check_leaves(hist, total, num_bin, na_bin, is_cat, params, mask=None,
                  parent=None):
    """The port's records against the JAX package's, leaf by leaf;
    returns the JAX results."""
    K, f = hist.shape[:2]
    mask = np.ones(f, bool) if mask is None else mask
    parent = np.zeros(K, np.float32) if parent is None else parent
    rt, cat, rank = _port(hist, total, parent, num_bin, na_bin, mask,
                          is_cat, params)
    pj = js.SplitParams(**params)
    out = []
    for k in range(K):
        mk = mask if mask.ndim == 1 else mask[k]
        rj = js.find_best_split(
            jnp.asarray(hist[k]), jnp.asarray(total[k]), jnp.asarray(num_bin),
            jnp.asarray(na_bin), jnp.asarray(mk), pj,
            jnp.float32(parent[k]), is_cat=jnp.asarray(is_cat))
        assert int(rt.feature[k]) == int(rj.feature), k
        assert int(rt.threshold[k]) == int(rj.threshold), k
        assert bool(rt.default_left[k]) == bool(rj.default_left), k
        assert bool(cat[k]) == bool(rj.is_cat), k
        np.testing.assert_array_equal(rank[k].numpy(),
                                      np.asarray(rj.bin_rank))
        for a, b in ((rt.gain[k], rj.gain), (rt.left_sum[k], rj.left_sum),
                     (rt.right_sum[k], rj.right_sum),
                     (rt.left_output[k], rj.left_output),
                     (rt.right_output[k], rj.right_output)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if np.isinf(b).any():
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=RTOL,
                                           atol=RTOL * np.abs(b).max())
        out.append(rj)
    return out


CASES = {
    # 3-4 used categories: one-vs-rest
    "one_vs_rest": ({"cards": (3, 4, 4)}, {"min_data_per_group": 20}),
    "subsets": ({}, {"min_data_per_group": 20}),
    "subsets_l1_l2": ({}, {"lambda_l1": 1.0, "lambda_l2": 2.0,
                           "min_data_per_group": 20}),
    "default_params": ({}, {}),
    "unused_bins": ({}, {"min_data_per_group": 150}),
    "max_cat_threshold": ({}, {"max_cat_threshold": 2,
                               "min_data_per_group": 20}),
    "cat_l2_off": ({}, {"cat_l2": 0.0}),
    "cat_l2_high": ({}, {"cat_l2": 40.0}),
    "cat_smooth_low": ({}, {"cat_smooth": 1.0}),
    "cat_smooth_high": ({}, {"cat_smooth": 80.0}),
    "path_smooth": ({}, {"path_smooth": 5.0, "max_delta_step": 0.8,
                         "min_data_in_leaf": 40}),
    "onehot_threshold": ({"cards": (6, 12)}, {"max_cat_to_onehot": 12,
                                              "min_data_per_group": 10}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_categorical_split_matches_jax(case):
    kw, params = CASES[case]
    hist, total, num_bin, na_bin, is_cat = _leaves(6, seed=len(case), **kw)
    found = _check_leaves(hist, total, num_bin, na_bin, is_cat, params)
    cats = [np.asarray(r.bin_rank) for r in found if bool(r.is_cat)]
    assert cats
    if case.startswith("subsets"):
        # some leaf takes a ratio-ordered subset (ranks 0..B-1, a
        # permutation), not one-vs-rest
        assert any(sorted(r) == list(range(BINS)) for r in cats)
    if case == "one_vs_rest":
        # one bin left (rank 0), every other bin at rank B
        for r in found:
            if bool(r.is_cat):
                rank = np.asarray(r.bin_rank)
                assert (rank == 0).sum() == 1 and int(r.threshold) == 0
                assert set(np.unique(rank)) == {0, BINS}
    if case == "max_cat_threshold":
        assert all(int(r.threshold) < 2 for r in found if bool(r.is_cat))


def test_padding_bins_rank_past_every_threshold():
    """Bins at or past a feature's own count (B = 64 > every num_bin) and
    unused bins sort last: their ranks exceed the threshold."""
    hist, total, num_bin, na_bin, is_cat = _leaves(4, seed=11, bins=64)
    found = _check_leaves(hist, total, num_bin, na_bin, is_cat,
                          {"min_data_per_group": 60})
    for k, r in enumerate(found):
        if not bool(r.is_cat):
            continue
        f = int(r.feature)
        rank = np.asarray(r.bin_rank)
        assert (rank[num_bin[f]:] > int(r.threshold)).all()
        unused = hist[k, f, :, 2] < 59.5
        assert (rank[unused] > int(r.threshold)).all()


@pytest.mark.parametrize("direction", ["ascending", "descending"])
def test_exact_ratio_ties_keep_bin_order(direction):
    """Two categories with identical (g, h, count) in every leaf: both
    orders keep them in bin order (the descending order is the stable
    ascending order of -ratio, not the ascending order reversed)."""
    hist, total, num_bin, na_bin, is_cat = _leaves(6, seed=5)
    f, a, b = 2, 3, 17                      # feature with 30 categories
    hist[:, f, b] = hist[:, f, a]
    # a strong positive or negative pair, so the pair sits at the start of
    # the ascending or the descending order
    sign = -1.0 if direction == "ascending" else 1.0
    hist[:, f, a, 0] = hist[:, f, b, 0] = sign * 4.0 * hist[:, f, a, 1]
    is_only = np.zeros_like(is_cat)
    is_only[f] = True
    mask = is_only.copy()
    found = _check_leaves(hist, total, num_bin, na_bin, is_cat,
                          {"min_data_per_group": 10}, mask=mask)
    for r in found:
        assert bool(r.is_cat) and int(r.feature) == f
        assert int(r.threshold) >= 1           # a subset, not one-vs-rest
        rank = np.asarray(r.bin_rank)
        assert rank[b] == rank[a] + 1


def test_per_child_masks_match_jax():
    K = 8
    hist, total, num_bin, na_bin, is_cat = _leaves(K, seed=7)
    rs = np.random.RandomState(3)
    mask = rs.rand(K, hist.shape[1]) < 0.6
    mask[0] = is_cat                        # categorical only
    mask[1] = ~is_cat                       # numerical only
    found = _check_leaves(hist, total, num_bin, na_bin, is_cat, {},
                          mask=mask)
    assert not bool(found[1].is_cat)
    for k, r in enumerate(found):
        if np.isfinite(float(r.gain)):
            assert mask[k, int(r.feature)]


@pytest.mark.parametrize("winner", ["numerical", "categorical"])
def test_merge_takes_numerical_on_ties_and_better_gains(winner):
    """The numerical record wins on >=: an exact tie (the same histogram
    as a numerical and a 3-category feature, one category a bin) goes to
    the numerical one; a 38-category feature beats the numerical one."""
    hist, total, num_bin, na_bin, is_cat = _leaves(4, seed=9)
    f_cat = 0 if winner == "numerical" else 3
    f_num = 4
    if winner == "numerical":
        # the numerical feature takes the categorical feature's 3 bins:
        # its best threshold equals a one-vs-rest or prefix split
        hist[:, f_num] = 0
        hist[:, f_num, :3] = hist[:, f_cat, :3]
        num_bin = num_bin.copy()
        num_bin[f_num] = 3
        na_bin = na_bin.copy()
        na_bin[f_num] = -1
    mask = np.zeros(len(is_cat), bool)
    mask[[f_cat, f_num]] = True
    found = _check_leaves(hist, total, num_bin, na_bin, is_cat,
                          {"min_data_per_group": 20, "cat_l2": 0.0,
                           "cat_smooth": 0.0}, mask=mask)
    cats = [bool(r.is_cat) for r in found]
    if winner == "numerical":
        assert not any(cats)
    else:
        assert any(cats)


def test_inactive_step_returns_zeros():
    hist, total, num_bin, na_bin, is_cat = _leaves(2, seed=3)
    rec, cat, rank = ts.find_best_split(
        *(torch.as_tensor(a) for a in (hist, total, np.zeros(2, np.float32),
                                       num_bin, na_bin,
                                       np.ones(len(is_cat), bool))),
        ts.SplitParams(), active=torch.zeros(1, dtype=torch.int32),
        is_cat=torch.as_tensor(is_cat))
    assert not rec.any() and not cat.any() and not rank.any()


def test_without_is_cat_the_records_are_unchanged():
    """is_cat all False gives B2's records, identity rank rows and no
    categorical winner."""
    hist, total, num_bin, na_bin, is_cat = _leaves(4, seed=13)
    args = [torch.as_tensor(a) for a in (hist, total, np.zeros(4, np.float32),
                                         num_bin, na_bin,
                                         np.ones(len(is_cat), bool))]
    plain = ts.find_best_split(*args, ts.SplitParams())
    rec, cat, rank = ts.find_best_split(
        *args, ts.SplitParams(),
        is_cat=torch.zeros(len(is_cat), dtype=torch.bool))
    assert torch.equal(plain, rec) and not cat.any()
    assert torch.equal(rank, torch.arange(BINS, dtype=torch.int32).expand(
        4, BINS))


# --- the partition rule ------------------------------------------------------

def _jax_rule(fcol, nb, icat, dleft, rank_row, thr):
    """The JAX package's do_split predicate (grower.py:788-789)."""
    is_na = (nb >= 0) & (fcol == nb) & (~icat)
    return jnp.where(is_na, dleft, rank_row[fcol] <= thr)


def _rank_table(rs, rows, bins):
    table = np.stack([rs.permutation(bins) for _ in range(rows)])
    table[::3] = np.arange(bins)           # numerical rows: identity
    return table.astype(np.int32)


@pytest.mark.parametrize("icat", [True, False])
def test_partition_plain_with_rank_table_matches_jax_rule(icat):
    rs = np.random.RandomState(int(icat))
    n, f, R = 3000, 5, 9
    binned = rs.randint(0, BINS, (n, f)).astype(np.uint8)
    lor = rs.randint(0, 6, n).astype(np.int32)
    table = _rank_table(rs, R, BINS)
    leaf, feat, thr = 4, 2, 17
    # a categorical split's record carries na_bin -1; a numerical one the
    # feature's NA bin
    nb = -1 if icat else BINS - 1
    rec = np.array([leaf, 7, feat, thr, 1, nb, leaf, 1], np.int32)
    lor_t = torch.as_tensor(lor.copy())
    partition_plain(torch.as_tensor(binned), lor_t, torch.as_tensor(rec),
                    torch.as_tensor(table))
    go_left = np.asarray(_jax_rule(
        jnp.asarray(binned[:, feat], jnp.int32), jnp.int32(BINS - 1),
        jnp.bool_(icat), jnp.bool_(True), jnp.asarray(table[leaf]), thr))
    want = np.where((lor == leaf) & ~go_left, 7, lor)
    np.testing.assert_array_equal(lor_t.numpy(), want)


def test_partition_slots_plain_with_rank_table_matches_jax_rule():
    rs = np.random.RandomState(4)
    n, f, K, L = 4000, 5, 4, 12
    binned = rs.randint(0, BINS, (n, f)).astype(np.uint8)
    lor = rs.randint(0, 6, n).astype(np.int32)
    table = _rank_table(rs, L + 2 * K, BINS)
    leaves = np.array([1, 3, 4, L + 3])            # slot 3 invalid
    icat = np.array([True, False, True, False])
    recs = np.zeros((K, STEP_RECORD), np.int32)
    for k in range(K):
        recs[k] = [leaves[k], 6 + k, k % f, 9 + k, k % 2,
                   -1 if icat[k] else BINS - 1, leaves[k], int(k < 3)]
    slot_of_leaf = np.full(L, -1, np.int32)
    slot_of_leaf[leaves[:3]] = np.arange(3)
    step = BatchedStep(
        recs=torch.as_tensor(recs),
        slot_of_leaf=torch.as_tensor(slot_of_leaf),
        idx2=torch.zeros(2 * K, dtype=torch.int64),
        tot2=torch.zeros((2 * K, 3)), po2=torch.zeros(2 * K),
        small_left=torch.zeros(K, dtype=torch.bool),
        keep2=torch.zeros(2 * K, dtype=torch.bool),
        status=torch.tensor([1, 3], dtype=torch.int32))
    lor_t = torch.as_tensor(lor.copy())
    partition_slots_plain(torch.as_tensor(binned), lor_t, step,
                          torch.as_tensor(table))
    want = lor.copy()
    for k in range(3):
        rows = lor == leaves[k]
        fcol = jnp.asarray(binned[:, recs[k, FEATURE]], jnp.int32)
        gl = np.asarray(_jax_rule(fcol, jnp.int32(BINS - 1),
                                  jnp.bool_(icat[k]),
                                  jnp.bool_(bool(recs[k, DEFAULT_LEFT])),
                                  jnp.asarray(table[leaves[k]]),
                                  int(recs[k, THRESHOLD])))
        want[rows & ~gl] = recs[k, NEW_LEAF]
    np.testing.assert_array_equal(lor_t.numpy(), want)


# --- whole categorical trees -------------------------------------------------

@pytest.mark.parametrize("L,K", [(31, 1), (64, 8), (255, 16)])
def test_categorical_trees_match_jax(L, K):
    binned, vals, num_bin, na_bin, is_cat = cat_problem(21, n=6000)
    n, f = binned.shape
    params = {"min_data_in_leaf": 8, "min_data_per_group": 20}
    grow = make_grower(num_leaves=L, num_bins=BINS,
                       params=js.SplitParams(**params), split_batch=K)
    tj = grow(*(jnp.asarray(a) for a in (binned, vals, np.ones(f, bool),
                                         num_bin, na_bin)),
              is_cat=jnp.asarray(is_cat))
    ws = GrowWorkspace(n, f, BINS, L, torch.device("cpu"), split_batch=K,
                       categorical=True)
    port = grow_tree if K == 1 else grow_tree_batched
    kw = {} if K == 1 else {"split_batch": K}
    port(*(torch.as_tensor(a) for a in (binned, vals, np.ones(f, bool),
                                        num_bin, na_bin)),
         num_leaves=L, num_bins=BINS, params=ts.SplitParams(**params),
         workspace=ws, is_cat=torch.as_tensor(is_cat), **kw)
    tt = fetch_tree(ws)
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl and nl > min(L, 60) // 2
    nn = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "is_cat_node"):
        np.testing.assert_array_equal(
            getattr(tt, name)[:nn], np.asarray(getattr(tj, name))[:nn],
            err_msg=name)
    np.testing.assert_array_equal(tt.cat_rank[:nn],
                                  np.asarray(tj.cat_rank)[:nn])
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    assert tt.is_cat_node[:nn].sum() >= 3
    # categorical nodes never send NA right by default: default_left 0
    assert not tt.default_left[:nn][tt.is_cat_node[:nn]].any()


def _jax_cat_tree(seed, leaves):
    binned, vals, num_bin, na_bin, is_cat = cat_problem(seed, n=4000)
    grow = make_grower(num_leaves=leaves, num_bins=BINS,
                       params=js.SplitParams(min_data_in_leaf=20,
                                             min_data_per_group=20))
    tj = grow(*(jnp.asarray(a) for a in (binned, vals,
                                         np.ones(len(is_cat), bool), num_bin,
                                         na_bin)),
              is_cat=jnp.asarray(is_cat))
    return tj, {k: np.asarray(v) for k, v in tj._asdict().items()}, \
        num_bin, na_bin


@pytest.mark.parametrize("seed,leaves,weight", [(41, 15, 1.0), (42, 31, 1.0),
                                                (43, 7, 0.5)])
def test_add_tree_score_on_categorical_tree_matches_jax(seed, leaves,
                                                         weight):
    tj, fields, num_bin, na_bin = _jax_cat_tree(seed, leaves)
    tree = convert.tree_arrays_from_numpy(fields)
    nl = tree.num_leaves
    assert tree.is_cat_node[:nl - 1].any()
    steps = 16
    # rows the tree never saw, NaN bins in the numerical column
    vb = cat_problem(seed + 100, n=2000)[0]
    score0 = np.random.RandomState(seed).randn(2000).astype(np.float32)
    node = [torch.as_tensor(getattr(tree, k)) for k in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    cat = {"is_cat_node": torch.as_tensor(tree.is_cat_node),
           "cat_rank": torch.as_tensor(tree.cat_rank)}
    lt = traverse_tree_plain(torch.as_tensor(vb), *node,
                             torch.as_tensor(na_bin), steps=steps, **cat)
    st = add_tree_score(torch.as_tensor(score0.copy()), torch.as_tensor(vb),
                        *node, torch.as_tensor(na_bin),
                        torch.as_tensor(tree.leaf_value), weight,
                        steps=steps, **cat)
    sj = np.asarray(j_add_tree_score(
        jnp.asarray(score0), jnp.asarray(vb), tj.split_feature,
        tj.threshold_bin, tj.default_left, tj.left_child, tj.right_child,
        jnp.asarray(na_bin), tj.is_cat_node, tj.cat_rank, tj.leaf_value,
        jnp.float32(weight), steps=steps))
    if weight == 1.0:
        np.testing.assert_array_equal(st.numpy(), sj)
    else:
        tol = 4 * np.finfo(np.float32).eps * np.abs(sj).max()
        np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=tol)
    # the walk reaches several leaves
    assert len(np.unique(lt.numpy())) > leaves // 2
