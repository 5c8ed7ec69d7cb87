"""The batched grower (split_batch K > 1) against the JAX package on the
CPU, with every kernel as its plain version:

- B1-K: ``compute_histogram(slot=, num_slots=K)`` [K, F, B, 3] against the
  JAX function's [F, B, 3K] (channel c of slot k at c*K + k), bitwise on
  sums that f32 holds exactly, within ``RTOL`` otherwise;
- B3-K and B3s-K: ``partition_slots`` and ``grow_step_batched`` against
  the JAX super-step's own lines (grower.py:1002-1034 and :1158-1210,
  replayed here with ``jax.numpy`` on the same state), exactly, on tied
  gains and a budget-cut super-step;
- ``grow_tree_batched`` against ``make_grower(split_batch=K)`` on four
  fixtures (balanced, chain-shaped, tied with a duplicated column,
  ``max_depth``): integer tree arrays and the row -> leaf vector equal,
  f32 fields within ``RTOL``.  The fixtures' gradients are multiples of
  1/8 and their hessians 1, so both packages' histograms are exact and
  equal whatever the summation order, and every tie is a true tie;
- the width rules (``SPLIT_BATCH_SET``, ``snap_split_batch``,
  ``fit_split_batch``, ``bucket_leaves``, the port's K resolution)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.grower import (STEP_RECORD, BatchedStep, GrowWorkspace,
                                   fetch_tree, grow_step_batched,
                                   grow_tree_batched, partition_slots,
                                   tree_fields, tree_words)
from lightgbm_torch.models.gbdt import resolve_split_batch
from lightgbm_torch.ops import histogram as th
from lightgbm_torch.ops.split import SplitParams as TParams
from lightgbm_torch.utils import shapes as tshapes
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.histogram import compute_histogram
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.utils import shapes as jshapes

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

RTOL = 1e-6


def _exact_vals(vals):
    """(g, h, w) with g a multiple of 1/8 and h = w = 1: every sum of a
    few thousand rows is exact in f32."""
    out = np.ones_like(vals)
    out[:, 0] = np.round(8.0 * vals[:, 0]) / 8.0
    return out


@pytest.mark.parametrize("K", [8, 16])
@pytest.mark.parametrize("exact", [True, False])
def test_histogram_slots_matches_jax_layout(K, exact):
    binned, vals, _, _ = binned_problem(5, n=3000, f=6, bins=15)
    if exact:
        vals = _exact_vals(vals)
    rs = np.random.RandomState(K)
    slot = rs.randint(-3, K, size=len(binned)).astype(np.int32)
    ht = th.compute_histogram(torch.as_tensor(binned), torch.as_tensor(vals),
                              num_bins=15, slot=torch.as_tensor(slot),
                              num_slots=K,
                              slots_used=torch.tensor([K], dtype=torch.int32)
                              ).numpy()
    hj = np.asarray(compute_histogram(jnp.asarray(binned), jnp.asarray(vals),
                                      num_bins=15, slot=jnp.asarray(slot),
                                      num_slots=K))
    assert ht.shape == (K, 6, 15, 3) and hj.shape == (6, 15, 3 * K)
    # JAX: channel c of slot k at c*K + k
    hj_k = hj.reshape(6, 15, 3, K).transpose(3, 0, 1, 2)
    if exact:
        np.testing.assert_array_equal(ht, hj_k)
    else:
        assert np.abs(ht - hj_k).max() <= 2e-6 * max(1.0, np.abs(hj).max())
        np.testing.assert_array_equal(ht[..., 2], hj_k[..., 2])


# --- one super-step against the JAX super-step's lines ----------------------

def _state(L, K, gains, num_leaves, seed=0, done=False):
    """A mid-tree state: a table whose gains are ``gains`` (other fields
    random but sane), a tree buffer of ``num_leaves`` leaves in a chain,
    and the step outputs."""
    rs = np.random.RandomState(seed)
    table = np.zeros((L + 2 * K, 12), np.float32)
    table[:, 0] = -np.inf
    table[:len(gains), 0] = gains
    table[:, 1] = rs.randint(0, 5, len(table))
    table[:, 2] = rs.randint(0, 9, len(table))
    table[:, 3] = rs.randint(0, 2, len(table))
    table[:, 4:10] = rs.randint(1, 50, (len(table), 6))
    table[:, 10:12] = rs.randn(len(table), 2)
    words = np.zeros(tree_words(L), np.int32)
    v = tree_fields(words, L)
    v["leaf_parent"][:] = -1
    v["num_leaves"][0], v["done"][0] = num_leaves, int(done)
    for i in range(num_leaves - 1):       # node i splits leaf i
        v["left_child"][i], v["right_child"][i] = ~i, ~(i + 1)
        if i > 0:
            v["right_child"][i - 1] = i
        v["leaf_parent"][i] = v["leaf_parent"][i + 1] = i
        v["leaf_depth"][:i + 2] += 1
    v["leaf_value"][:num_leaves] = rs.randn(num_leaves)
    v["leaf_count"][:num_leaves] = rs.randint(1, 99, num_leaves)
    step = BatchedStep(
        recs=torch.zeros((K, STEP_RECORD), dtype=torch.int32),
        slot_of_leaf=torch.full((L,), -1, dtype=torch.int32),
        idx2=torch.zeros(2 * K, dtype=torch.int64),
        tot2=torch.zeros((2 * K, 3)), po2=torch.zeros(2 * K),
        small_left=torch.zeros(K, dtype=torch.bool),
        keep2=torch.zeros(2 * K, dtype=torch.bool),
        status=torch.zeros(2, dtype=torch.int32))
    return table, words, step


def _jax_books(table, words, L, K, max_depth):
    """The JAX super-step's selection and Tree::Split bookkeeping
    (grower.py:1002-1034, :1087-1097, :1158-1210) on the same state."""
    v = {k: jnp.asarray(a) for k, a in tree_fields(words, L).items()}
    nl = v["num_leaves"][0]
    gains, leaves = jax.lax.top_k(jnp.asarray(table[:L, 0]), K)
    kidx = jnp.arange(K, dtype=jnp.int32)
    valid = (gains > 0.0) & (kidx < (L - 1) - (nl - 1)) & (v["done"][0] == 0)
    if not bool(valid[0]):
        return None
    # the tree arrays get K scratch slots past L, as in the JAX grower
    def pad(a, n):
        return jnp.concatenate([a, jnp.zeros(n, a.dtype)])

    leaf_sel = jnp.where(valid, leaves, L + kidx)
    node_sel = jnp.where(valid, nl - 1 + kidx, L - 1 + kidx)
    new_leaf_sel = jnp.where(valid, nl + kidx, L + kidx)
    t = jnp.asarray(table)
    feat_k = t[leaf_sel, 1].astype(jnp.int32)
    thr_k = t[leaf_sel, 2].astype(jnp.int32)
    dleft_k = (t[leaf_sel, 3] != 0).astype(jnp.int32)
    lp = pad(v["leaf_parent"], K).at[L:].set(-1)
    parent_k = lp[leaf_sel]
    lc, rc = pad(v["left_child"], K), pad(v["right_child"], K)
    node_ids = jnp.arange(L - 1 + K, dtype=jnp.int32)
    for j in range(K):
        fix_l = (node_ids == parent_k[j]) & (lc == ~leaf_sel[j])
        fix_r = (node_ids == parent_k[j]) & (rc == ~leaf_sel[j])
        lc = jnp.where(fix_l, node_sel[j], lc)
        rc = jnp.where(fix_r, node_sel[j], rc)
    lc = lc.at[node_sel].set(~leaf_sel)
    rc = rc.at[node_sel].set(~new_leaf_sel)
    ld = pad(v["leaf_depth"], K)
    d_k = ld[leaf_sel] + 1
    lv = pad(v["leaf_value"], K)
    out = {
        "num_leaves": nl + valid.sum(),
        "split_feature": pad(v["split_feature"], K).at[node_sel].set(feat_k),
        "threshold_bin": pad(v["threshold_bin"], K).at[node_sel].set(thr_k),
        "default_left": pad(v["default_left"], K).at[node_sel].set(dleft_k),
        "left_child": lc, "right_child": rc,
        "split_gain": pad(v["split_gain"], K).at[node_sel].set(
            jnp.where(valid, gains, 0.0)),
        "internal_value": pad(v["internal_value"], K).at[node_sel].set(
            lv[leaf_sel]),
        "leaf_value": lv.at[leaf_sel].set(t[leaf_sel, 10])
                        .at[new_leaf_sel].set(t[leaf_sel, 11]),
        "leaf_count": pad(v["leaf_count"], K).at[leaf_sel].set(
            t[leaf_sel, 6]).at[new_leaf_sel].set(t[leaf_sel, 9]),
        "leaf_depth": ld.at[leaf_sel].set(d_k).at[new_leaf_sel].set(d_k),
        "leaf_parent": lp.at[leaf_sel].set(node_sel)
                         .at[new_leaf_sel].set(node_sel),
    }
    smaller_left = t[leaf_sel, 6] <= t[leaf_sel, 9]
    depth_ok = (max_depth <= 0) | (d_k < max_depth)
    return out, dict(valid=np.asarray(valid), leaf_sel=np.asarray(leaf_sel),
                     new_leaf_sel=np.asarray(new_leaf_sel),
                     small_id=np.asarray(jnp.where(smaller_left, leaf_sel,
                                                   new_leaf_sel)),
                     keep=np.asarray(depth_ok & valid))


CASES = {
    # distinct gains, a full batch of K valid splits
    "plain": (12, 4, [0.5, 3.0, 0.2, 1.5, 2.5, 0.1, 4.0], 7, -1),
    # tied gains: lax.top_k takes the lower leaf index first
    "ties": (12, 4, [1.0, 2.0, 2.0, 0.0, 2.0, 1.0, 1.0], 7, 5),
    # budget cut: L - num_leaves = 2 leaves left for 4 slots
    "budget": (9, 4, [0.5, 3.0, 0.2, 1.5, 2.5, 0.1, 4.0], 7, -1),
    # non-positive gains end the valid prefix
    "prefix": (12, 4, [0.0, 3.0, -1.0, 0.0, 2.5, -0.0, -np.inf], 7, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_grow_step_batched_matches_jax_super_step(case):
    L, K, gains, nl, depth = CASES[case]
    table, words, step = _state(L, K, np.asarray(gains, np.float32), nl)
    tree = torch.as_tensor(words.copy())
    grow_step_batched(torch.as_tensor(table), tree,
                      torch.full((5,), 7, dtype=torch.int32), num_leaves=L,
                      split_batch=K, max_depth=depth, step=step)
    want, sel = _jax_books(table, words, L, K, depth)
    got = tree_fields(tree.numpy(), L)
    nv = int(sel["valid"].sum())
    assert step.status.tolist() == [1, nv] and nv >= 1
    assert int(got["num_leaves"][0]) == int(want["num_leaves"])
    assert int(got["n_steps"][0]) == 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child", "split_gain",
                 "internal_value"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name])[:L - 1],
                                      err_msg=name)
    for name in ("leaf_value", "leaf_count", "leaf_depth", "leaf_parent"):
        np.testing.assert_array_equal(got[name], np.asarray(want[name])[:L],
                                      err_msg=name)
    recs = step.recs.numpy()
    valid = sel["valid"]
    np.testing.assert_array_equal(recs[:, 7], valid.astype(np.int32))
    np.testing.assert_array_equal(recs[valid, 0], sel["leaf_sel"][valid])
    np.testing.assert_array_equal(recs[valid, 1], sel["new_leaf_sel"][valid])
    np.testing.assert_array_equal(recs[valid, 6], sel["small_id"][valid])
    np.testing.assert_array_equal(step.keep2.numpy(),
                                  np.concatenate([sel["keep"], sel["keep"]]))
    # invalid slots go to scratch rows past L, each of the 2K distinct
    idx2 = step.idx2.numpy()
    assert len(set(idx2.tolist())) == 2 * K
    assert (idx2[:K][~valid] >= L).all() and (idx2[K:][~valid] >= L).all()
    slot_of_leaf = step.slot_of_leaf.numpy()
    assert (slot_of_leaf >= 0).sum() == nv
    for k in np.nonzero(valid)[0]:
        assert slot_of_leaf[sel["leaf_sel"][k]] == k


def test_grow_step_batched_dead_step_sets_done():
    table, words, step = _state(12, 4, np.full(7, -1.0, np.float32), 7)
    tree = torch.as_tensor(words.copy())
    grow_step_batched(torch.as_tensor(table), tree,
                      torch.zeros(5, dtype=torch.int32), num_leaves=12,
                      split_batch=4, max_depth=-1, step=step)
    got = tree_fields(tree.numpy(), 12)
    assert step.status.tolist() == [0, 0]
    assert int(got["done"][0]) == 1 and int(got["num_leaves"][0]) == 7
    np.testing.assert_array_equal(tree.numpy()[2:], words[2:])
    # a done tree stays done, with no split even at positive gains, and
    # the step outputs stay those of the super-step that found it done
    table[:7, 0] = 5.0
    table[12:, :] = 7.0
    before = [t.clone() for t in step]
    words_done = tree.clone()
    grow_step_batched(torch.as_tensor(table), tree,
                      torch.zeros(5, dtype=torch.int32), num_leaves=12,
                      split_batch=4, max_depth=-1, step=step)
    assert step.status.tolist() == [0, 0]
    assert torch.equal(tree, words_done)
    assert all(torch.equal(a, b) for a, b in zip(step, before))


def test_partition_slots_matches_jax_partition():
    binned, _, num_bin, na_bin = binned_problem(8, n=2000, f=6, bins=15)
    L, K = 20, 4
    rs = np.random.RandomState(3)
    lor = rs.randint(0, 9, len(binned)).astype(np.int32)
    # slots 0..2 valid on leaves 1, 4, 7 (new leaves 9..11), slot 3 not
    recs = np.zeros((K, STEP_RECORD), np.int32)
    for k, (leaf, feat, thr, dleft) in enumerate(
            [(1, 2, 6, 1), (4, 0, 3, 0), (7, 5, 10, 1)]):
        recs[k] = (leaf, 9 + k, feat, thr, dleft, na_bin[feat],
                   leaf if k % 2 else 9 + k, 1)
    recs[3] = (L + 3, L + K + 3, 0, 0, 0, -1, L + 3, 0)
    slot_of_leaf = np.full(L, -1, np.int32)
    slot_of_leaf[[1, 4, 7]] = [0, 1, 2]
    step = BatchedStep(
        recs=torch.as_tensor(recs),
        slot_of_leaf=torch.as_tensor(slot_of_leaf),
        idx2=None, tot2=None, po2=None, small_left=None, keep2=None,
        status=torch.tensor([1, 3], dtype=torch.int32))
    lor_t = torch.as_tensor(lor.copy())
    tslot = partition_slots(torch.as_tensor(binned), lor_t, step,
                            torch.arange(15, dtype=torch.int32)).numpy()
    # the JAX super-step's partition (grower.py:1029-1067)
    slot = jnp.asarray(slot_of_leaf)[jnp.asarray(lor)]
    active = slot >= 0
    sl = jnp.maximum(slot, 0)
    r = jnp.asarray(recs)
    feat_r = r[sl, 2]
    fcol = jnp.take_along_axis(jnp.asarray(binned), feat_r[:, None],
                               axis=1)[:, 0].astype(jnp.int32)
    nb_r = jnp.asarray(na_bin)[feat_r]
    is_na = (nb_r >= 0) & (fcol == nb_r)
    go_left = jnp.where(is_na, r[sl, 4] != 0, fcol <= r[sl, 3])
    new_lor = jnp.where(active & ~go_left, r[sl, 1], jnp.asarray(lor))
    tslot_of_leaf = jnp.full(L + 2 * K, -1, jnp.int32).at[r[:, 6]].set(
        jnp.where(r[:, 7] != 0, jnp.arange(K), -1))
    np.testing.assert_array_equal(lor_t.numpy(), np.asarray(new_lor))
    np.testing.assert_array_equal(tslot, np.asarray(tslot_of_leaf[new_lor]))
    assert (tslot >= 0).any() and (lor_t.numpy() >= 9).any()
    # a dead super-step moves no row
    dead = step._replace(status=torch.tensor([0, 0], dtype=torch.int32))
    before = lor_t.clone()
    partition_slots(torch.as_tensor(binned), lor_t, dead,
                    torch.arange(15, dtype=torch.int32))
    assert torch.equal(lor_t, before)


# --- whole trees ---------------------------------------------------------------

def _fixture(kind):
    """(binned, vals, num_bin, na_bin, leaves, K, max_depth, params)."""
    if kind == "chain":
        # one feature whose bins carry gradients -3^b: the best split of a
        # leaf of bins 0..m isolates bin m, and only the other child can
        # split again, so each super-step has one valid slot
        bins = 12
        b0 = np.repeat(np.arange(bins), 2).astype(np.uint8)
        binned = np.stack([b0, np.zeros_like(b0)], axis=1)
        g = -np.power(3.0, b0).astype(np.float32)
        vals = np.stack([g, np.ones_like(g), np.ones_like(g)], 1)
        return (binned, vals, np.array([bins, 1], np.int32),
                np.array([-1, -1], np.int32), bins, 8, -1,
                {"min_data_in_leaf": 1, "min_sum_hessian_in_leaf": 0.0})
    binned, vals, num_bin, na_bin = binned_problem(21, n=6000, f=8, bins=31)
    vals = _exact_vals(vals)
    if kind == "balanced":
        return binned, vals, num_bin, na_bin, 255, 16, -1, \
            {"min_data_in_leaf": 8}
    if kind == "max_depth":
        return binned, vals, num_bin, na_bin, 100, 8, 4, \
            {"min_data_in_leaf": 5, "lambda_l2": 1.0}
    # ties: the rows twice, the second copy's gradients negated (every
    # split of one half has the gain of the same split of the other), a
    # column that tells the halves apart, and feature 0 duplicated
    n = len(binned)
    half = np.concatenate([np.zeros(n, np.uint8), np.ones(n, np.uint8)])
    b2 = np.concatenate([binned, binned])
    b2 = np.concatenate([half[:, None], b2, b2[:, :1]], axis=1)
    v2 = np.concatenate([vals, vals])
    v2[n:, 0] *= -1
    v2[:n, 0] += 0.5               # the root splits the halves apart
    num_bin = np.concatenate([[2], num_bin, num_bin[:1]]).astype(np.int32)
    na_bin = np.concatenate([[-1], na_bin, na_bin[:1]]).astype(np.int32)
    return b2, v2, num_bin, na_bin, 63, 8, -1, {"min_data_in_leaf": 20}


@pytest.mark.parametrize("kind", ["balanced", "chain", "ties", "max_depth"])
def test_grow_tree_batched_matches_jax(kind):
    binned, vals, num_bin, na_bin, L, K, depth, params = _fixture(kind)
    n, f = binned.shape
    mask = np.ones(f, bool)
    B = int(num_bin.max())
    grow = make_grower(num_leaves=L, num_bins=B, params=JParams(**params),
                       max_depth=depth, split_batch=K)
    tj = grow(*(jnp.asarray(a) for a in (binned, vals, mask, num_bin,
                                         na_bin)))
    ws = GrowWorkspace(n, f, B, L, torch.device("cpu"), split_batch=K)
    grow_tree_batched(*(torch.as_tensor(a) for a in (binned, vals, mask,
                                                     num_bin, na_bin)),
                      num_leaves=L, num_bins=B, params=TParams(**params),
                      max_depth=depth, split_batch=K, workspace=ws)
    tt = fetch_tree(ws)
    nl = int(tj.num_leaves)
    assert tt.num_leaves == nl
    nn = nl - 1
    for name in ("split_feature", "threshold_bin", "default_left",
                 "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(tt, name)[:nn],
                                      np.asarray(getattr(tj, name))[:nn],
                                      err_msg=name)
    np.testing.assert_array_equal(tt.leaf_depth[:nl],
                                  np.asarray(tj.leaf_depth)[:nl])
    np.testing.assert_array_equal(tt.leaf_of_row.numpy(),
                                  np.asarray(tj.leaf_of_row))
    for name, k in (("split_gain", nn), ("internal_value", nn),
                    ("internal_count", nn), ("leaf_value", nl),
                    ("leaf_weight", nl), ("leaf_count", nl)):
        b = np.asarray(getattr(tj, name), np.float64)[:k]
        np.testing.assert_allclose(getattr(tt, name)[:k], b, rtol=RTOL,
                                   atol=RTOL * np.abs(b).max(), err_msg=name)
    # live super-steps: the JAX loop also counts the one that found
    # nothing to split when the tree ends short of its budget
    js = int(tj.n_steps)
    assert tt.n_steps in (js, js - 1) and tt.n_steps >= -(-(nl - 1) // K)
    if kind == "chain":
        assert nl == L and tt.n_steps == L - 1      # one split a step
    elif kind == "balanced":
        assert nl == L and tt.n_steps < 30
    elif kind == "max_depth":
        assert tt.leaf_depth[:nl].max() <= depth and nl <= 2 ** depth
    else:
        assert nl == L
        # the duplicated column never wins over its lower-index twin
        assert (tt.split_feature[:nn] != f - 1).all()


# --- width rules ----------------------------------------------------------------

def test_width_rules_equal_jax():
    assert tshapes.SPLIT_BATCH_SET == jshapes.SPLIT_BATCH_SET
    for k in range(0, 80):
        assert tshapes.snap_split_batch(k) == jshapes.snap_split_batch(k)
        for leaves in (2, 8, 9, 17, 31, 33, 64, 65, 100, 255):
            assert tshapes.fit_split_batch(k, leaves) \
                == jshapes.fit_split_batch(k, leaves)
    for leaves in (2, 31, 40, 63, 64, 127, 128, 255, 256, 1000):
        assert tshapes.bucket_leaves(leaves) == jshapes.bucket_leaves(leaves)


@pytest.mark.parametrize("params,want", [
    ({"num_leaves": 31}, 1), ({"num_leaves": 63}, 1),
    ({"num_leaves": 64}, 8), ({"num_leaves": 100}, 8),
    ({"num_leaves": 128}, 16), ({"num_leaves": 255}, 16),
    ({"num_leaves": 255, "split_batch": 1}, 1),
    ({"num_leaves": 31, "split_batch": 5}, 8),
    ({"num_leaves": 31, "split_batch": 32}, 16),
    ({"num_leaves": 6, "split_batch": 8}, 5),
    ({"num_leaves": 31, "split_batch": 5, "trace_buckets": False}, 5),
])
def test_resolved_split_batch(params, want):
    assert resolve_split_batch(TConfig(params)) == want
