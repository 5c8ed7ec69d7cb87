"""The partitioned learner (``lightgbm_torch/grower_partitioned.py``) and
its kernels' plain versions, held against the JAX package's
``grower_partitioned.py`` on the CPU on the same numpy-seeded inputs:

- B11a, B11b and B11c's plain versions (``ops/segment.py``) against
  ``_hist_segment``, ``_partition_segment`` and ``_leaf_of_row`` on empty,
  one-row, mid and full segments, with NA bins, categorical ranks and an
  EFB group column: B11b's order and left count and B11c's rows equal;
  B11a's integer form equal, its f32 form equal on dyadic vals and within
  ``HIST_RTOL`` of the largest bin on f32 noise (the JAX program sums by
  a one-hot matmul, the plain version in row-order runs);
- B2's ``mono_bounds`` and ``penalty`` forms (plain) against
  ``find_best_split(..., mono_bounds=..., gain_penalty=...)`` child by
  child, numerical and categorical, under the default parameters,
  ``path_smooth`` and ``max_delta_step``: integer fields equal, f32
  fields within ``RTOL`` (one f32 operation at a time against XLA's
  fused kernels);
- the copied numpy helpers ``_leaf_boxes``, ``_advanced_bounds``,
  ``_mono_intervals``, ``_forced_record`` and ``CEGBState.penalty_vector``
  equal to the JAX package's on random trees;
- ``PartitionedGrower`` against the JAX one on tests/test_partitioned.py's
  ``_data`` (bagging x NA bin, and ``max_depth``): structure and row ->
  leaf vector equal, leaf values within ``LEAF_RTOL``; and against the
  port's own masked strict grower, as the JAX test holds its two learners;
- ``lgt.train`` against ``lgb.train``, both with ``tpu_learner=
  "partitioned"``, on exact gradients (a custom L2 objective whose
  gradients are multiples of 1/8, so every histogram sum is exact in f32
  and both packages write the same bits): the model text equal for the
  plain learner, bagging, GOSS (its amplification (1 - 0.2) / 0.1 is 8
  in f32), bynode and extra_trees (the host RNG streams),
  feature_fraction, interaction constraints, contri, CEGB, categorical
  features, EFB, forced splits, multiclass (a softmax custom objective
  rounded the same way) and CEGB with forced splits (the fold the masked
  path does must not run here); the monotone penalty and the methods
  ``intermediate`` and ``advanced`` (whose clamped gains XLA rounds
  otherwise) to equal structure with values within ``RTOL``;
  ``quant_train`` (its dequantized sums are inexact in f32) to equal
  integer tree arrays in every tree; a tiny ``histogram_pool_size`` by
  AUC (within ``POOL_AUC_GAP``), as the JAX test holds it;
- the learner selection and ``fused_reasons`` rules of the JAX package.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import constraints as tc
from lightgbm_torch import grower as tgr
from lightgbm_torch import grower_partitioned as tgp
from lightgbm_torch.ops import segment as tseg
from lightgbm_torch.ops import split as ts
from lightgbm_tpu import grower_partitioned as jgp
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import compute_histogram

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module,
    raw_problem)

# f32 fields of split records and models: one operation at a time
# against XLA's fused kernels
RTOL = 1e-5
# B11a's f32 form on noise: the JAX program's matmul and the plain
# version's row-order runs sum the same values in other orders
HIST_RTOL = 1e-5
# the grower on tests/test_partitioned.py's data, whose vals are f32
# noise: that test's own tolerance between the JAX package's learners
LEAF_RTOL = 2e-3
# a tiny histogram pool rebuilds evicted histograms (other f32 sums than
# the subtraction): the JAX test's AUC tolerance
POOL_AUC_GAP = 0.01
INT_FIELDS = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count",
              "cat_boundaries", "cat_threshold")
FLOAT_FIELDS = ("split_gain", "leaf_value", "internal_value",
                "leaf_weight", "internal_weight")


def _trees(text):
    return [t.split("\n\n")[0] for t in
            text.split("end of trees")[0].split("Tree=")[1:]]


def _field(tree, name):
    for ln in tree.splitlines():
        if ln.startswith(name + "="):
            return ln.split("=", 1)[1]
    return ""


def _same_structure(a, b, values=True):
    for name in INT_FIELDS:
        assert _field(a, name) == _field(b, name), name
    if not values:
        return
    for name in FLOAT_FIELDS:
        x = np.asarray(_field(a, name).split(), np.float64)
        y = np.asarray(_field(b, name).split(), np.float64)
        np.testing.assert_allclose(x, y, rtol=RTOL,
                                   atol=RTOL * max(np.abs(y).max(), 1.0),
                                   err_msg=name)


# --- (a) B11a, B11b, B11c ------------------------------------------------------

SEGMENTS = {"empty": (100, 0), "one_row": (37, 1), "mid": (500, 1700),
            "full": (0, 3000)}


def _perm(n, seed):
    return np.random.RandomState(seed).permutation(n).astype(np.int32)


def _pow2(x):
    return jgp._pow2(max(int(x), 1))


@pytest.mark.parametrize("kind", ["dyadic", "noise", "int8", "int16",
                                  "efb"])
@pytest.mark.parametrize("seg", sorted(SEGMENTS))
def test_segment_histogram_equals_jax(seg, kind):
    begin, count = SEGMENTS[seg]
    n, bins = 3000, 31
    binned, vals, _, _ = binned_problem(3, n=n, f=6, bins=bins)
    if kind == "efb":
        # an EFB group matrix: columns of up to 2 * bins group bins
        rs = np.random.RandomState(4)
        binned = rs.randint(0, 2 * bins, size=(n, 3)).astype(np.uint8)
        bins = 2 * bins
    rs = np.random.RandomState(5)
    if kind in ("dyadic", "efb"):
        vals = np.round(vals * 8) / 8
    elif kind in ("int8", "int16"):
        hi = 127 if kind == "int8" else 32767
        vals = rs.randint(-hi, hi + 1, size=vals.shape).astype(
            np.int8 if kind == "int8" else np.int16)
    vals = vals.astype(vals.dtype if kind.startswith("int") else np.float32)
    order = _perm(n, 6)
    got = tseg.segment_histogram(
        torch.as_tensor(binned), torch.as_tensor(vals),
        torch.as_tensor(order), begin, count, num_bins=bins).numpy()
    want = np.asarray(jgp._hist_segment(
        jnp.asarray(order), jnp.asarray(binned), jnp.asarray(vals),
        jnp.int32(begin), jnp.int32(count), p=_pow2(count), num_bins=bins))
    assert got.shape == want.shape
    if kind == "noise":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=HIST_RTOL * np.abs(want).max())
    else:
        assert got.dtype == (np.int32 if kind.startswith("int")
                             else np.float32)
        np.testing.assert_array_equal(got, want)
    if count == 0:
        assert not got.any()


def _partition_args(case, n=3000, bins=31):
    """(binned, split kwargs of the port, JAX operands) of a case."""
    binned, _, num_bin, na_bin = binned_problem(7, n=n, f=6, bins=bins)
    rs = np.random.RandomState(8)
    rank = np.arange(bins, dtype=np.int32)
    icat, col, goff, nbm1 = False, 2, -1, int(num_bin[2]) - 1
    na, thr, dleft = int(na_bin[2]), 14, True
    if case == "no_na":
        col, na, thr, dleft, nbm1 = 1, -1, 9, False, int(num_bin[1]) - 1
    elif case == "categorical":
        rank = rs.permutation(bins).astype(np.int32)
        icat, col, thr = True, 0, 11
        nbm1 = int(num_bin[0]) - 1
        na = int(na_bin[0])
    elif case == "efb":
        # feature bins 1..12 at group bins 20..31 of column 4; the rest
        # of the column is other features' (bin 0 for this one)
        binned[:, 4] = rs.randint(0, 40, size=n)
        col, goff, nbm1, na, thr, dleft = 4, 20, 12, 12, 5, True
    port = dict(col=col, na_bin=-1 if icat else na, goff=goff, nbm1=nbm1,
                threshold=thr, default_left=dleft,
                rank=torch.as_tensor(rank))
    jax_ops = (jnp.int32(col), jnp.int32(na), jnp.int32(goff),
               jnp.int32(nbm1), jnp.int32(thr), jnp.bool_(dleft),
               jnp.bool_(icat), jnp.asarray(rank))
    return binned, port, jax_ops


@pytest.mark.parametrize("case", ["na", "no_na", "categorical", "efb"])
@pytest.mark.parametrize("seg", sorted(SEGMENTS))
def test_partition_segment_equals_jax(seg, case):
    begin, count = SEGMENTS[seg]
    binned, port, jax_ops = _partition_args(case)
    order = _perm(binned.shape[0], 9)
    ot = torch.as_tensor(order.copy())
    left = tseg.partition_segment(torch.as_tensor(binned), ot, begin, count,
                                  **port)
    oj, lj = jgp._partition_segment(
        jnp.asarray(order), jnp.asarray(binned), *jax_ops,
        jnp.int32(begin), jnp.int32(count), p=_pow2(count))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    assert left.dtype == torch.int32 and left.shape == (1,)
    assert int(left[0]) == int(lj)
    # the rest of the permutation is untouched, the segment permuted
    outside = np.ones(len(order), bool)
    outside[begin:begin + count] = False
    np.testing.assert_array_equal(ot.numpy()[outside], order[outside])
    if count > 1 and seg != "one_row":
        assert 0 < int(left[0]) < count


@pytest.mark.parametrize("segments", [1, 2, 9, 31])
def test_leaf_of_row_equals_jax(segments):
    n = 3000
    rs = np.random.RandomState(segments)
    order = _perm(n, 10 + segments)
    begins = np.sort(np.concatenate(
        [[0], rs.choice(np.arange(1, n), segments - 1, replace=False)]))
    leafs = rs.permutation(segments).astype(np.int32)
    got = tseg.leaf_of_row(torch.as_tensor(order),
                           torch.as_tensor(begins.astype(np.int32)),
                           torch.as_tensor(leafs))
    want = jgp._leaf_of_row(jnp.asarray(order),
                            jnp.asarray(begins, jnp.int32),
                            jnp.asarray(leafs), num_leaves=31)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- (b) B2's mono_bounds and penalty forms ----------------------------------

def _children(seed, f=8, bins=31, c=4):
    binned, vals, num_bin, na_bin = binned_problem(seed, f=f, bins=bins)
    rs = np.random.RandomState(seed)
    n = len(binned)
    hists, tots = [], []
    for k in range(c):
        keep = (rs.rand(n) < (0.3 + 0.15 * k)).astype(np.float32)
        v = vals * keep[:, None]
        hists.append(np.asarray(compute_histogram(
            jnp.asarray(binned), jnp.asarray(v), num_bins=bins)))
        tots.append(v.sum(axis=0))
    return (np.stack(hists), np.stack(tots).astype(np.float32), num_bin,
            na_bin)


def _bounds(rs, c, f, b, scale):
    """Random mono_bounds [C, F, B] x 4 with infinite entries, as the
    advanced method gives them (lower bounds of -inf where no neighbour
    binds, some contradictory pairs)."""
    lo_l = np.where(rs.rand(c, f, b) < 0.5, -np.inf,
                    -scale * rs.rand(c, f, b))
    hi_l = np.where(rs.rand(c, f, b) < 0.5, np.inf, scale * rs.rand(c, f, b))
    lo_r = np.where(rs.rand(c, f, b) < 0.5, -np.inf,
                    -scale * rs.rand(c, f, b))
    hi_r = np.where(rs.rand(c, f, b) < 0.5, np.inf,
                    scale * rs.rand(c, f, b) - 0.2 * scale)
    return [a.astype(np.float32) for a in (lo_l, hi_l, lo_r, hi_r)]


PARAMS_B2 = {"default": {}, "path_smooth": {"path_smooth": 2.0},
             "max_delta": {"max_delta_step": 0.5}}


@pytest.mark.parametrize("pcase", sorted(PARAMS_B2))
@pytest.mark.parametrize("form", ["bounds", "penalty", "both"])
@pytest.mark.parametrize("categorical", [False, True])
def test_split_bounds_and_penalty_equal_jax(form, pcase, categorical):
    hist, tot, num_bin, na_bin = _children(11)
    C, f, B, _ = hist.shape
    params = PARAMS_B2[pcase]
    pj, pt = js.SplitParams(**params), ts.SplitParams(**params)
    rs = np.random.RandomState(12)
    mono = np.array([1, -1, 0, 1, 0, -1, 1, 0], np.int32)
    fmax = np.float32(np.finfo(np.float32).max)
    parent = np.array([0.0, 0.1, -0.05, 0.02], np.float32)
    bounds = _bounds(rs, C, f, B, 0.3)
    pen = (rs.rand(C, f) * 20).astype(np.float32)
    is_cat = np.zeros(f, bool)
    if categorical:
        is_cat[[6, 7]] = True
    cons = {}
    if form in ("bounds", "both"):
        cons.update(mono=torch.as_tensor(mono.astype(np.int8)),
                    out_lo=torch.full((C,), -fmax),
                    out_hi=torch.full((C,), fmax),
                    **{k: torch.as_tensor(a) for k, a in zip(
                        ("lo_l", "hi_l", "lo_r", "hi_r"), bounds)})
    if form in ("penalty", "both"):
        cons["penalty"] = torch.as_tensor(pen)
    res = ts.find_best_split(
        torch.as_tensor(hist), torch.as_tensor(tot),
        torch.as_tensor(parent), torch.as_tensor(num_bin),
        torch.as_tensor(na_bin), torch.ones(f, dtype=torch.bool), pt,
        is_cat=torch.as_tensor(is_cat) if categorical else None,
        cons=ts.SplitConstraints(**cons))
    rec, cat, rank = res if categorical else (res, None, None)
    seen = 0
    for c in range(C):
        kw = {}
        if "lo_l" in cons:
            kw.update(mono=jnp.asarray(mono), out_lo=jnp.float32(-fmax),
                      out_hi=jnp.float32(fmax),
                      mono_bounds=tuple(jnp.asarray(a[c]) for a in bounds))
        if "penalty" in cons:
            kw["gain_penalty"] = jnp.asarray(pen[c])
        rj = js.find_best_split(
            jnp.asarray(hist[c]), jnp.asarray(tot[c]), jnp.asarray(num_bin),
            jnp.asarray(na_bin), jnp.ones(f, bool), pj,
            jnp.float32(parent[c]),
            jnp.asarray(is_cat) if categorical else None, **kw)
        rt = ts.unpack(rec[c])
        if np.isneginf(float(rj.gain)):
            assert np.isneginf(float(rt.gain)), c
            continue
        assert int(rt.feature) == int(rj.feature), c
        assert int(rt.threshold) == int(rj.threshold), c
        assert bool(rt.default_left) == bool(rj.default_left), c
        if categorical:
            assert bool(cat[c]) == bool(rj.is_cat), c
            np.testing.assert_array_equal(rank[c].numpy(),
                                          np.asarray(rj.bin_rank))
        for a, b in ((rt.gain, rj.gain), (rt.left_sum, rj.left_sum),
                     (rt.right_sum, rj.right_sum),
                     (rt.left_output, rj.left_output),
                     (rt.right_output, rj.right_output)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            np.testing.assert_allclose(a, b, rtol=RTOL,
                                       atol=RTOL * np.abs(b).max())
        seen += 1
    assert seen >= 2


def test_split_bounds_change_the_pick():
    """The bounds and the penalty each move a pick or a gain on these
    children (so the comparisons above are not of free scans)."""
    hist, tot, num_bin, na_bin = _children(11)
    C, f, B, _ = hist.shape
    args = (torch.as_tensor(hist), torch.as_tensor(tot), torch.zeros(C),
            torch.as_tensor(num_bin), torch.as_tensor(na_bin),
            torch.ones(f, dtype=torch.bool), ts.SplitParams())
    mono = torch.tensor([1, -1, 0, 1, 0, -1, 1, 0], dtype=torch.int8)
    wide = ts.SplitConstraints(mono=mono, out_lo=torch.full((C,), -1e30),
                               out_hi=torch.full((C,), 1e30))
    base = ts.find_best_split(*args, cons=wide)
    b = [torch.as_tensor(a) for a in
         _bounds(np.random.RandomState(12), C, f, B, 0.05)]
    tight = wide._replace(lo_l=b[0], hi_l=b[1], lo_r=b[2], hi_r=b[3])
    assert not torch.equal(ts.find_best_split(*args, cons=tight), base)
    pen = ts.SplitConstraints(penalty=torch.full((C, f), 50.0))
    assert not torch.equal(ts.find_best_split(*args, cons=pen),
                           ts.find_best_split(*args))
    with pytest.raises(ValueError, match="penalty replaces"):
        ts.find_best_split(*args, cons=ts.SplitConstraints(
            penalty=torch.zeros((C, f)), cegb_slope=torch.zeros(f)))


# --- (c) the copied host helpers -------------------------------------------

def _jax_tree(seed, L=16, B=16, mono=None):
    """A tree of the JAX partitioned grower on test_partitioned's data,
    with an NA bin on feature 0, and its host arrays."""
    binned, vals = _data(seed=seed, bag=True)
    f = binned.shape[1]
    na_bin = np.full(f, -1, np.int32)
    na_bin[0] = B - 1
    g = jgp.PartitionedGrower(num_leaves=L, num_bins=B,
                              params=js.SplitParams(min_data_in_leaf=5),
                              mono=mono)
    t = g(jnp.asarray(binned), jnp.asarray(vals), jnp.ones(f, bool),
          jnp.full(f, B, jnp.int32), jnp.asarray(na_bin))
    host = {k: np.asarray(getattr(t, k)) for k in t._fields}
    return host, np.full(f, B, np.int32), na_bin


def _port_grower(L, B, f, mono=None, **kw):
    return tgp.PartitionedGrower(
        num_leaves=L, num_bins=B, params=ts.SplitParams(min_data_in_leaf=5),
        num_bin=np.full(f, B, np.int32), na_bin=np.full(f, -1, np.int32),
        device="cpu", mono=mono, **kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_helpers_equal_jax(seed):
    L, B = 16, 16
    mono = np.array([1, -1, 0, 0, 1, 0], np.int32)
    t, nb, na = _jax_tree(seed, L, B)
    nl = int(t["num_leaves"])
    rs = np.random.RandomState(seed)
    is_cat = rs.rand(L - 1) < 0.2
    args = (nl, t["split_feature"], t["threshold_bin"], t["left_child"],
            t["right_child"], is_cat, nb)
    kw = dict(default_left=t["default_left"], na_host=na)
    bi_t, bw_t = tgp.PartitionedGrower._leaf_boxes(*args, **kw)
    bi_j, bw_j = jgp.PartitionedGrower._leaf_boxes(*args, **kw)
    np.testing.assert_array_equal(bi_t, bi_j)
    np.testing.assert_array_equal(bw_t, bw_j)
    gt = _port_grower(L, B, 6, mono=mono)
    gj = jgp.PartitionedGrower(num_leaves=L, num_bins=B,
                               params=js.SplitParams(min_data_in_leaf=5),
                               mono=mono)
    lv = t["leaf_value"]
    for y in range(nl):
        for a, b in zip(gt._advanced_bounds(bi_t, bw_t, lv, y, B, na_host=na),
                        gj._advanced_bounds(bi_j, bw_j, lv, y, B,
                                            na_host=na)):
            np.testing.assert_array_equal(a, b)
    assert gt._mono_intervals(nl, t["split_feature"], t["left_child"],
                              t["right_child"], lv, is_cat) == \
        gj._mono_intervals(nl, t["split_feature"], t["left_child"],
                           t["right_child"], lv, is_cat)
    hist = rs.randn(6, B, 3).astype(np.float32)
    hist[..., 2] = rs.randint(0, 40, size=(6, B))
    total = hist[0].sum(axis=0)
    for feat, thr in ((1, 3), (4, 9), (2, 0), (3, B - 1)):
        spec = {"feature": feat, "threshold_bin": thr}
        a = gt._forced_record(spec, hist, total, 0.1, B)
        b = gj._forced_record(spec, hist, total, 0.1, B)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    used = rs.rand(6) < 0.5
    ct = tc.CEGBState(0.7, 0.01, rs.rand(6).astype(np.float32),
                      rs.rand(6).astype(np.float32), used.copy())
    cj = jgp.CEGBState(*ct[:4], used.copy())
    for count in (1.0, 37.0, 1234.0):
        np.testing.assert_array_equal(ct.penalty_vector(count),
                                      cj.penalty_vector(count))


# --- (d) the grower ----------------------------------------------------------

def _data(n=3000, f=6, b=16, seed=0, bag=False):
    """tests/test_partitioned.py's ``_data``, copied."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, size=(n, f)).astype(np.uint8)
    y = (binned[:, 2] >= b // 2).astype(np.float32) \
        + 0.3 * rng.randn(n).astype(np.float32)
    g = (0.5 - y).astype(np.float32)
    w = (rng.rand(n) < 0.7).astype(np.float32) if bag \
        else np.ones(n, np.float32)
    vals = np.stack([g * w, w, w], axis=1)
    return binned, vals


def _grow_both(binned, vals, na_bin, L, B, max_depth=-1):
    f = binned.shape[1]
    p = js.SplitParams(min_data_in_leaf=5)
    tj = jgp.PartitionedGrower(num_leaves=L, num_bins=B, params=p,
                               max_depth=max_depth)(
        jnp.asarray(binned), jnp.asarray(vals), jnp.ones(f, bool),
        jnp.full(f, B, jnp.int32), jnp.asarray(na_bin))
    gt = tgp.PartitionedGrower(
        num_leaves=L, num_bins=B, params=ts.SplitParams(min_data_in_leaf=5),
        num_bin=np.full(f, B, np.int32), na_bin=na_bin, device="cpu",
        max_depth=max_depth)
    ws = tgr.GrowWorkspace(len(binned), f, B, L, torch.device("cpu"))
    gt.grow(torch.as_tensor(binned), torch.as_tensor(vals), np.ones(f, bool),
            workspace=ws)
    return tj, tgr.fetch_tree(ws)


@pytest.mark.parametrize("bag", [False, True])
@pytest.mark.parametrize("na", [False, True])
def test_grower_equals_jax(bag, na):
    binned, vals = _data(bag=bag)
    f, B, L = binned.shape[1], 16, 8
    na_bin = np.full(f, -1, np.int32)
    if na:
        na_bin[0] = B - 1
    tj, ht = _grow_both(binned, vals, na_bin, L, B)
    lor = ht.leaf_of_row.numpy()
    nl = int(tj.num_leaves)
    assert ht.num_leaves == nl > 2
    for k in ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(ht, k))[:nl - 1],
                                      np.asarray(getattr(tj, k))[:nl - 1],
                                      err_msg=k)
    np.testing.assert_allclose(ht.leaf_value[:nl],
                               np.asarray(tj.leaf_value)[:nl],
                               rtol=LEAF_RTOL, atol=LEAF_RTOL / 10)
    np.testing.assert_allclose(ht.leaf_count[:nl],
                               np.asarray(tj.leaf_count)[:nl], atol=0.5)
    np.testing.assert_array_equal(lor, np.asarray(tj.leaf_of_row))
    assert ht.n_steps == nl - 1


def test_grower_respects_max_depth():
    binned, vals = _data()
    f, B = binned.shape[1], 16
    tj, ht = _grow_both(binned, vals, np.full(f, -1, np.int32), 16, B,
                        max_depth=2)
    assert ht.num_leaves == int(tj.num_leaves) <= 4
    np.testing.assert_array_equal(ht.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))


@pytest.mark.parametrize("bag", [False, True])
def test_grower_equals_the_masked_strict_grower(bag):
    binned, vals = _data(seed=3, bag=bag)
    f, B, L = binned.shape[1], 16, 12
    na_bin = np.full(f, -1, np.int32)
    na_bin[1] = B - 1
    gt = tgp.PartitionedGrower(
        num_leaves=L, num_bins=B, params=ts.SplitParams(min_data_in_leaf=5),
        num_bin=np.full(f, B, np.int32), na_bin=na_bin, device="cpu")
    ws = tgr.GrowWorkspace(len(binned), f, B, L, torch.device("cpu"))
    gt.grow(torch.as_tensor(binned), torch.as_tensor(vals), np.ones(f, bool),
            workspace=ws)
    hp = tgr.fetch_tree(ws)
    wm = tgr.GrowWorkspace(len(binned), f, B, L, torch.device("cpu"))
    tgr.grow_tree(torch.as_tensor(binned), torch.as_tensor(vals),
                  torch.ones(f, dtype=torch.bool),
                  torch.full((f,), B, dtype=torch.int32),
                  torch.as_tensor(na_bin), num_leaves=L, num_bins=B,
                  params=ts.SplitParams(min_data_in_leaf=5), workspace=wm)
    hm = tgr.fetch_tree(wm)
    nl = hp.num_leaves
    assert nl == hm.num_leaves > 4
    for k in ("split_feature", "threshold_bin", "default_left",
              "left_child", "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(hp, k))[:nl - 1],
                                      np.asarray(getattr(hm, k))[:nl - 1],
                                      err_msg=k)
    np.testing.assert_array_equal(hp.leaf_depth[:nl], hm.leaf_depth[:nl])
    np.testing.assert_allclose(hp.leaf_value[:nl], hm.leaf_value[:nl],
                               rtol=LEAF_RTOL, atol=LEAF_RTOL / 10)
    np.testing.assert_array_equal(hp.leaf_of_row.numpy(),
                                  hm.leaf_of_row.numpy())


# --- (e) training against the JAX package ----------------------------------

def _exact_l2(preds, ds):
    """L2 gradients rounded to multiples of 1/8 (every histogram sum
    exact in f32), unit hessians."""
    g = np.round(8.0 * (np.asarray(preds, np.float64) - ds.get_label())) / 8
    return g.astype(np.float32), np.ones(len(g), np.float32)


def _exact_data(cat=False, onehot=False):
    x, _ = raw_problem(51, n=3000, f=8, task="regression", nan_frac=0.03)
    y = 2 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1]) \
        + np.nan_to_num(x[:, 2] * x[:, 3])
    rs = np.random.RandomState(52)
    if cat:
        c = rs.randint(0, 9, len(x))
        x = np.column_stack([x, c.astype(np.float64)])
        y = y + 1.5 * (c % 4 == 1) - (c == 6)
    if onehot:
        c = rs.randint(0, 10, len(x))
        x = np.column_stack([x, np.eye(10)[c]])
        y = y + 1.2 * (c % 3 == 0)
    return x, np.round(y).astype(np.float32)


BASE = {"objective": "none", "learning_rate": 0.5, "max_bin": 31,
        "num_leaves": 15, "min_data_in_leaf": 5, "verbosity": -1,
        "tpu_learner": "partitioned"}
MONO = {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0]}
FORCED = {"feature": 2, "threshold": 0.1,
          "left": {"feature": 3, "threshold": -0.2},
          "right": {"feature": 0, "threshold": 0.5}}
# (params, model text "exact" | "structure" | "integer" arrays)
CASES = {
    "plain": ({}, "exact"),
    "bagging": ({"bagging_fraction": 0.7, "bagging_freq": 1}, "exact"),
    "goss": ({"data_sample_strategy": "goss"}, "exact"),
    "bynode": ({"feature_fraction_bynode": 0.6}, "exact"),
    "extra_trees": ({"extra_trees": True, "extra_seed": 3}, "exact"),
    "feature_fraction": ({"feature_fraction": 0.7}, "exact"),
    "interaction": ({"interaction_constraints": "[0,1,2],[2,3,4],[5,6,7]"},
                    "exact"),
    "contri": ({"feature_contri": [1.0, 0.5, 1.0, 0.2, 1.0, 1.0, 1.0, 1.0]},
               "exact"),
    "cegb": ({"cegb_penalty_split": 0.002,
              "cegb_penalty_feature_coupled": [1.0] * 8,
              "cegb_penalty_feature_lazy": [0.0, 0.0005] * 4}, "exact"),
    "categorical": ({"min_data_per_group": 20}, "exact"),
    "efb": ({}, "exact"),
    "forced": ({"forcedsplits_filename": FORCED}, "exact"),
    "mono_basic": ({**MONO, "monotone_penalty": 0.5}, "structure"),
    "mono_intermediate": ({**MONO, "monotone_constraints_method":
                           "intermediate"}, "structure"),
    "mono_advanced": ({**MONO, "monotone_constraints_method": "advanced"},
                      "structure"),
    "quant": ({"quant_train": True, "quant_bits": 8}, "integer"),
}


def _params(case, tmp):
    params, _ = CASES[case]
    p = {**BASE, **params}
    if isinstance(p.get("forcedsplits_filename"), dict):
        path = tmp / f"{case}.json"
        path.write_text(json.dumps(p["forcedsplits_filename"]))
        p["forcedsplits_filename"] = str(path)
    return p


def _train_both(p, x, y, rounds=4, fobj=_exact_l2, **ds_kw):
    bt = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x, y, **ds_kw),
                   rounds, fobj=fobj)
    bj = lgb.train(p, lgb.Dataset(x, label=y, **ds_kw), rounds, fobj=fobj)
    return bt, bj


@pytest.fixture(scope="module")
def case_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("forced")
    out = {}
    for case in CASES:
        x, y = _exact_data(cat=case == "categorical",
                           onehot=case == "efb")
        kw = {"categorical_feature": [8]} if case == "categorical" else {}
        out[case] = _train_both(_params(case, tmp), x, y, **kw)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_equals_jax(case_runs, case):
    bt, bj = case_runs[case]
    m = bt._model
    assert m.learner == "partitioned" and m.partitioned is not None
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 4
    kind = CASES[case][1]
    for i, (a, b) in enumerate(zip(tt, tj)):
        if kind == "exact":
            assert a == b, f"tree {i}"
        else:
            _same_structure(a, b, values=kind == "structure")
    assert int(_field(tt[0], "num_leaves")) == 15
    if case == "efb":
        assert m.efb_dev is not None
        assert m.binned_dev.shape[1] < m.num_features
    if case == "categorical":
        assert min(t.num_cat for t in m.models) > 0
    if case == "forced":
        for t in tt:
            assert _field(t, "split_feature").split()[:3] == ["2", "3", "0"]
    # one fetch a tree, then the grower's: the root, and per split its
    # left count and the children's records
    splits = sum(t.num_leaves - 1 for t in m.models)
    assert m.fetch_counts["tree"] == m.fetch_counts["root"] == 4
    assert m.fetch_counts["split_count"] == splits


def test_host_rng_streams_live_across_trees(case_runs):
    """bynode and extra_trees draw from the grower's host streams
    (RandomState(feature_fraction_seed + 1), RandomState(extra_seed)),
    which run on from tree to tree: the later trees differ from a grower
    restarted every tree, and equal the JAX package's (above)."""
    for case in ("bynode", "extra_trees"):
        bt, _ = case_runs[case]
        g = bt._model.partitioned
        fresh = np.random.RandomState(0)
        state = (g._bynode_rng if case == "bynode"
                 else g._extra_rng).get_state()[1]
        assert not np.array_equal(state, fresh.get_state()[1])
        tt = _trees(bt.model_to_string())
        assert len({_field(t, "split_feature") for t in tt}) > 1


def test_cegb_with_forced_splits_leaves_the_forced_feature_unmarked(
        tmp_path):
    """The JAX trainer folds the fetched split features into CEGB's used
    set only on the masked learner; the partitioned learner marks its
    best-first splits itself and never a forced one.  With the forced
    root on feature 0 and a coupled penalty on feature 0 alone, feature 0
    stays penalised in every later tree, as in the JAX package."""
    x, y = _exact_data()
    spec = tmp_path / "root.json"
    spec.write_text(json.dumps({"feature": 0, "threshold": 0.0}))
    p = {**BASE, "forcedsplits_filename": str(spec),
         "cegb_penalty_feature_coupled": [1e6] + [0.0] * 7}
    bt, bj = _train_both(p, x, y, rounds=3)
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert tt == tj
    m = bt._model
    assert not m.cegb.used[0] and m.cegb.used[1:].any()
    for t in m.models:
        feats = t.split_feature[:t.num_leaves - 1]
        assert feats[0] == 0 and 0 not in feats[1:]
    # without the penalty the best-first splits take feature 0 again
    q = {k: v for k, v in p.items() if k != "cegb_penalty_feature_coupled"}
    b0 = lgt.train({**q, "device_type": "cpu"}, lgt.Dataset(x, y), 1,
                   fobj=_exact_l2)
    t0 = b0._model.models[0]
    assert 0 in t0.split_feature[1:t0.num_leaves - 1]


def _exact_softmax(preds, ds):
    """Softmax gradients of 3 classes rounded to multiples of 1/8, unit
    hessians: [N * 3] row-major."""
    s = np.asarray(preds, np.float64).reshape(len(ds.get_label()), 3)
    e = np.exp(s - s.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    g = np.round(8.0 * (p - np.eye(3)[ds.get_label().astype(int)])) / 8
    return g.astype(np.float32).reshape(-1), np.ones(g.size, np.float32)


def test_multiclass_equals_jax():
    from torch_port_fixtures import multiclass_problem
    x, y = multiclass_problem(5, n=2000, f=6, k=3)
    p = {"objective": "none", "num_class": 3, "num_leaves": 7,
         "max_bin": 31, "learning_rate": 0.5, "verbosity": -1,
         "tpu_learner": "partitioned", "feature_fraction_bynode": 0.7}
    bt, bj = _train_both(p, x, y, rounds=3, fobj=_exact_softmax)
    tt, tj = _trees(bt.model_to_string()), _trees(bj.model_to_string())
    assert len(tt) == len(tj) == 9
    assert tt == tj
    assert bt._model.num_class == 3 and bt._model.partitioned is not None


def test_tiny_histogram_pool_by_auc():
    """A pool of two leaf histograms rebuilds the evicted ones from their
    segments and builds the larger child directly: other f32 sums than
    the subtraction, held by AUC as the JAX test holds it."""
    from lightgbm_tpu.metrics import _auc
    x, y = raw_problem(61, n=3000, f=8)
    p = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
         "min_data_in_leaf": 5, "verbosity": -1, "enable_bundle": False,
         "tpu_learner": "partitioned"}
    tiny = {**p, "histogram_pool_size": 0.0001}
    bt, bj = _train_both(tiny, x, y, rounds=5, fobj=None)
    assert bt._model.partitioned.pool_entries == 2
    b1 = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x, y), 5)
    assert len(bt._model.models) == len(bj.trees) == len(b1._model.models)
    a_t = _auc(y, bt.predict(x, raw_score=True), None)
    a_j = _auc(y, np.asarray(bj.predict(x, raw_score=True)), None)
    a_1 = _auc(y, b1.predict(x, raw_score=True), None)
    assert abs(a_t - a_j) < POOL_AUC_GAP and abs(a_t - a_1) < POOL_AUC_GAP


# --- (f) learner selection ----------------------------------------------------

def _model(params, x=None, y=None, **ds_kw):
    if x is None:
        x, y = raw_problem(4, n=400, f=4)
    ds = lgt.Dataset(x, np.minimum(y, 1), **ds_kw)
    return lgt.train({"objective": "binary", "verbosity": -1,
                      "device_type": "cpu", **params}, ds, 1)._model


@pytest.mark.parametrize("params,learner", [
    ({}, "masked"),
    ({"tpu_learner": "masked"}, "masked"),
    ({"tpu_learner": "partitioned"}, "partitioned"),
    ({"monotone_constraints": [1, 0, 0, 0]}, "masked"),
    ({"monotone_constraints": [1, 0, 0, 0],
      "monotone_constraints_method": "intermediate"}, "partitioned"),
    ({"monotone_constraints": [1, 0, 0, 0],
      "monotone_constraints_method": "advanced"}, "partitioned"),
    ({"monotone_constraints": [0, 0, 0, 0],
      "monotone_constraints_method": "advanced"}, "masked"),
    ({"forcedsplits_filename": FORCED}, "partitioned"),
])
def test_learner_selection(tmp_path, params, learner):
    p = dict(params)
    if isinstance(p.get("forcedsplits_filename"), dict):
        path = tmp_path / "f.json"
        path.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
        p["forcedsplits_filename"] = str(path)
    m = _model(p)
    assert m.learner == learner
    assert (m.partitioned is not None) == (learner == "partitioned")
    reasons = m.fused_reasons()
    assert (learner == "partitioned") == any(
        "tpu_learner=partitioned: only the one-program masked grower runs "
        "inside a fused scan" in r for r in reasons)
    assert ("forcedsplits_filename" in p) == any(
        "forced_splits need host node bookkeeping" in r for r in reasons)
    if learner == "partitioned":
        assert not m.supports_fused()
        assert m.split_batch == 1 and m.node_sampling is None
        with pytest.raises(ValueError, match="config not fusable"):
            m.train_chunk(2)


def test_explicit_masked_and_sparse_storage_raise_the_jax_errors(tmp_path):
    import scipy.sparse as sps
    x, y = raw_problem(4, n=400, f=4)
    path = tmp_path / "f.json"
    path.write_text(json.dumps({"feature": 1, "threshold": 0.0}))
    for controls in ({"forcedsplits_filename": str(path)},
                     {"monotone_constraints": [1, 0, 0, 0],
                      "monotone_constraints_method": "intermediate"}):
        p = {"objective": "binary", "verbosity": -1,
             "tpu_learner": "masked", **controls}
        for mod, ds in ((lgt, lgt.Dataset(x, y)),
                        (lgb, lgb.Dataset(x, label=y))):
            with pytest.raises(ValueError, match="require the partitioned"):
                mod.train({**p, "device_type": "cpu"} if mod is lgt else p,
                          ds, 1)
    # k-hot rows (tests/test_torch_sparse.py's sparse_rows): 30 stored
    # values of 3 levels a row over 300 columns
    rs = np.random.RandomState(0)
    n, f, nnz = 600, 300, 30
    cols = np.sort(np.argsort(rs.rand(n, f), axis=1)[:, :nnz], axis=1)
    xs = sps.csr_matrix((rs.randint(1, 4, size=n * nnz).astype(np.float64),
                         cols.ravel(), np.arange(0, n * nnz + 1, nnz)),
                        shape=(n, f))
    ys = (rs.rand(n) < 0.5).astype(np.float32)
    p = {"objective": "binary", "verbosity": -1, "enable_bundle": False,
         "forcedsplits_filename": str(path)}
    for mod, ds in ((lgt, lgt.Dataset(xs, ys)),
                    (lgb, lgb.Dataset(xs, label=ys))):
        with pytest.raises(ValueError, match="dense binned storage"):
            mod.train({**p, "device_type": "cpu"} if mod is lgt else p,
                      ds, 1)


def test_fused_chunk_runs_the_per_iteration_loop():
    """fused_chunk > 1 with the partitioned learner trains on the
    per-iteration loop (one tree fetch an iteration), as the JAX
    package's blockers send it there."""
    x, y = raw_problem(4, n=600, f=4)
    b = lgt.train({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu", "tpu_learner": "partitioned",
                   "fused_chunk": 3, "num_leaves": 7},
                  lgt.Dataset(x, y), 4)
    fc = b._model.fetch_counts
    assert fc["tree"] == 4 and "epoch" not in fc
