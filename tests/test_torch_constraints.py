"""The split controls on the masked growers: monotone constraints
(``basic``, with ``monotone_penalty``), interaction constraints,
``feature_contri`` and CEGB, held against the JAX package on the CPU
(every kernel as its plain version; the JAX package with
``tpu_learner="masked"``) on the same numpy-seeded inputs:

- the host vectors of ``lightgbm_torch.constraints`` equal the JAX
  package's (monotone vector, interaction groups, ``feature_contri``,
  ``_make_cegb``, the CEGB slope and coupled penalty) and
  ``monotone_penalty_factor`` at depths 0-8: bit for bit for integer
  penalties, within ``FACTOR_ULP`` ulp otherwise (numpy's f32 power
  against XLA's where the exponent is not an integer);
- ``find_best_split_plain`` against the JAX ``find_best_split`` child by
  child, numerical and categorical, with each control alone and all
  together, with ``path_smooth`` and ``max_delta_step``: integer fields
  equal, f32 fields within ``RTOL``;
- B3s/B3s-K's plain versions at every step of whole trees: each
  child's output range, branch set, allowed mask and the used features
  against the JAX grower's ``_child_ranges``, ``_inter_allowed`` and
  marks;
- whole 31-leaf strict models on an exact-label L2 fixture, for each
  control alone and all together, on the three paths of ``train``: the
  trees' structure equals the JAX package's, leaf values and gains within
  ``RTOL``, the first tree's text equal (but for the monotone runs, whose
  clamped-gain recompute XLA's fused kernel rounds otherwise than one
  operation at a time: their split gains differ in the last bits), and
  the port's three paths write
  the same text; a 255-leaf K = 16 model's first tree likewise, its best
  valid l2 within ``METRIC_RTOL``;
- compositions (monotone with categorical features, EFB, sparse k-hot
  storage, ``quant_train`` and lambdarank; interaction constraints with
  ``feature_fraction_bynode`` and multiclass): predictions within
  ``PRED_ATOL`` of the JAX package's;
- no monotone violation on swept rows and no root-to-leaf path outside
  one interaction group (the helpers of tests/test_constraints.py,
  copied)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import constraints as tc
from lightgbm_torch import grower as tgr
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.ops import split as ts
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.grower_partitioned import CEGBState as JCEGBState
from lightgbm_tpu.models.gbdt import GBDTModel as JGBDT
from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.histogram import compute_histogram

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    assert_first_tree_equal, binned_problem, pin_torch_threads,
    pin_torch_threads_module, raw_problem)

RTOL = 1e-5
FACTOR_ULP = 1
METRIC_RTOL = 0.02
PRED_ATOL = 2e-4
_PATH_PARAMS = ("[superepoch:", "[fused_eval:", "[fused_chunk:")
PATHS = {"per_iteration": {"superepoch": -1, "fused_chunk": 1},
         "fused_chunk": {"fused_chunk": 3}, "superepoch": {"fused_chunk": 3}}
INT_FIELDS = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
FLOAT_FIELDS = ("split_gain", "leaf_value", "internal_value")
# the controls over the 8 features of the exact fixture
CONTROLS = {
    "mono": {"monotone_constraints": [1, -1, 0, 0, 1, 0, 0, 0],
             "monotone_penalty": 0.5},
    "inter": {"interaction_constraints": "[0,1,2],[2,3,4],[5,6,7]"},
    "contri": {"feature_contri": [1.0, 0.5, 1.0, 0.2, 1.0, 1.0, 1.0, 1.0]},
    "cegb": {"cegb_penalty_split": 0.002,
             "cegb_penalty_feature_coupled": [1.0] * 8,
             "cegb_penalty_feature_lazy": [0.0, 0.0005] * 4},
}
CONTROLS["all"] = {k: v for c in CONTROLS.values() for k, v in c.items()}


def _norm(text):
    return "\n".join(ln for ln in text.splitlines()
                     if not ln.startswith(_PATH_PARAMS))


def _trees(text):
    return [t.split("\n\n")[0] for t in
            text.split("end of trees")[0].split("Tree=")[1:]]


def _field(tree, name):
    for ln in tree.splitlines():
        if ln.startswith(name + "="):
            return ln.split("=", 1)[1]
    return ""


def _same_tree(a, b, exact):
    """Structure equal, gains and values within RTOL; text equal when
    ``exact``."""
    for name in INT_FIELDS:
        assert _field(a, name) == _field(b, name), name
    for name in FLOAT_FIELDS:
        x = np.asarray(_field(a, name).split(), np.float64)
        y = np.asarray(_field(b, name).split(), np.float64)
        np.testing.assert_allclose(x, y, rtol=RTOL,
                                   atol=RTOL * np.abs(y).max(), err_msg=name)
    if exact:
        assert a == b


# --- (a) the host vectors ----------------------------------------------------

def _datasets(params, f=8, n=600):
    x, y = raw_problem(3, n=n, f=f, task="regression", nan_frac=0.0)
    x[:, 5] = 0.0               # an unused feature: slots skip it
    p = {"verbosity": -1, **params}
    dt = lgt.Dataset(x, y, params=p).construct(TConfig(p))
    dj = lgb.Dataset(x, label=y, params=p).construct(JConfig(p))
    assert list(dt.used_features) == list(dj.used_features)
    assert 5 not in dt.used_features
    return TConfig(p), dt, JConfig(p), dj


def test_host_vectors_equal_jax():
    params = {**CONTROLS["all"],
              "interaction_constraints": "[0,1,2],[2,3,4,5],[5,6,7],[9]",
              "cegb_tradeoff": 0.7}
    ct, dt, cj, dj = _datasets(params)
    np.testing.assert_array_equal(tc.interaction_allow(ct, dt),
                                  JGBDT._interaction_allow(cj, dj))
    jc = JGBDT._make_cegb(cj, dj)
    pc = tc.make_cegb(ct, dt)
    assert (pc.tradeoff, pc.penalty_split) == (jc.tradeoff,
                                               jc.penalty_split)
    for a, b in ((pc.coupled, jc.coupled), (pc.lazy, jc.lazy),
                 (pc.used, jc.used)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the JAX grower's device constants (grower.py:481-484)
    j_slope = jnp.asarray(jc.tradeoff * (jc.penalty_split + jc.lazy),
                          jnp.float32)
    np.testing.assert_array_equal(tc.cegb_slope(pc), np.asarray(j_slope))
    np.testing.assert_array_equal(
        tc.cegb_coupled(pc),
        np.asarray(jnp.asarray(jc.tradeoff * jc.coupled, jnp.float32)))
    # without lazy penalties the slope rounds once from f64
    no_lazy = jc._replace(lazy=None)
    j_slope0 = jnp.asarray(no_lazy.tradeoff * (no_lazy.penalty_split
                                               + np.zeros(len(jc.used))),
                           jnp.float32)
    np.testing.assert_array_equal(tc.cegb_slope(pc._replace(lazy=None)),
                                  np.asarray(j_slope0))
    # the monotone and contri vectors over used slots (the JAX package's
    # models/gbdt.py:176-195, read from a model)
    x, y = raw_problem(3, n=600, f=8, task="regression", nan_frac=0.0)
    x[:, 5] = 0.0
    bj = lgb.train({**params, "verbosity": -1, "tpu_learner": "masked",
                    "objective": "regression"}, lgb.Dataset(x, label=y), 1)
    np.testing.assert_array_equal(tc.monotone_vector(ct, dt),
                                  bj._model._mono)
    np.testing.assert_array_equal(tc.contri_vector(ct, dt),
                                  bj._model._feature_contri)
    assert tc.make_cegb(TConfig({}), dt) is None
    assert tc.monotone_vector(TConfig({"monotone_constraints": [0, 0]}),
                              dt) is None


@pytest.mark.parametrize("penalty", [0.0, 0.5, 1.0, 2.5, 8.0])
def test_monotone_penalty_factor_equals_jax(penalty):
    d = np.arange(9)
    got = tc.monotone_penalty_factor(penalty, d)
    want = np.asarray(js.monotone_penalty_factor(penalty, jnp.asarray(d)))
    assert got.dtype == np.float32
    if float(penalty).is_integer():
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=FACTOR_ULP)


# --- (b) B2 and B2-cat with the split controls -------------------------------

CASES_B2 = {
    "mono": {"mono": True},
    "penalty": {"mono": True, "penalty": 2.0},
    "penalty_half": {"mono": True, "penalty": 0.5},
    "contri": {"contri": True},
    "cegb_split": {"cegb": (0.02, False)},
    "cegb_coupled": {"cegb": (0.0, True)},
    "all": {"mono": True, "penalty": 2.0, "contri": True,
            "cegb": (0.01, True)},
}
PARAMS_B2 = {"default": {}, "path_smooth": {"path_smooth": 20.0},
             "max_delta": {"max_delta_step": 0.05},
             "both": {"path_smooth": 3.0, "max_delta_step": 0.3,
                      "lambda_l1": 1.0, "lambda_l2": 2.0}}


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


@pytest.mark.parametrize("pcase", sorted(PARAMS_B2))
@pytest.mark.parametrize("case", sorted(CASES_B2))
@pytest.mark.parametrize("categorical", [False, True])
def test_split_with_controls_equals_jax(case, pcase, categorical):
    hist, tot, num_bin, na_bin = _children(11)
    C, f, B, _ = hist.shape
    spec = CASES_B2[case]
    params = PARAMS_B2[pcase]
    pj, pt = js.SplitParams(**params), ts.SplitParams(**params)
    rs = np.random.RandomState(5)
    mono = np.array([1, -1, 0, 1, 0, -1, 1, 0], np.int32)
    lo = np.array([-np.inf, -0.2, 0.0, -0.05], np.float32)
    hi = np.array([np.inf, 0.3, np.inf, 0.05], np.float32)
    depth = np.array([0, 1, 3, 6], np.int32)
    contri = np.array([1.0, 0.5, 0.0, 2.0, 1.0, 0.25, 1.0, 0.8], np.float32)
    cuse = rs.rand(f) < 0.4
    parent = np.array([0.0, 0.1, -0.05, 0.02], np.float32)
    is_cat = np.zeros(f, bool)
    if categorical:
        is_cat[[6, 7]] = True
    kw_t = {}
    cons = {}
    pen = spec.get("penalty", 0.0)
    if spec.get("mono"):
        cons.update(mono=torch.as_tensor(mono.astype(np.int8)),
                    out_lo=torch.as_tensor(lo), out_hi=torch.as_tensor(hi))
        if pen > 0:
            cons.update(depth=torch.as_tensor(depth),
                        factor=torch.as_tensor(tc.monotone_penalty_factor(
                            pen, np.arange(9))))
    if spec.get("contri"):
        cons["contri"] = torch.as_tensor(contri)
    cegb = None
    if "cegb" in spec:
        split_pen, coupled = spec["cegb"]
        cegb = JCEGBState(tradeoff=1.0, penalty_split=split_pen,
                          coupled=np.full(f, 30.0, np.float32)
                          if coupled else None, lazy=None,
                          used=np.zeros(f, bool))
        pc = tc.CEGBState(*cegb)
        cons["cegb_slope"] = torch.as_tensor(tc.cegb_slope(pc))
        if coupled:
            cons.update(cegb_coupled=torch.as_tensor(tc.cegb_coupled(pc)),
                        cuse=torch.as_tensor(cuse))
    if cons:
        kw_t["cons"] = ts.SplitConstraints(**cons)
    mask = np.ones(f, bool)
    res = ts.find_best_split(
        torch.as_tensor(hist), torch.as_tensor(tot),
        torch.as_tensor(parent), torch.as_tensor(num_bin),
        torch.as_tensor(na_bin), torch.as_tensor(mask), pt,
        is_cat=torch.as_tensor(is_cat) if categorical else None, **kw_t)
    rec, cat, rank = res if categorical else (res, None, None)
    moved = 0
    for c in range(C):
        kw = {}
        if spec.get("mono"):
            kw.update(mono=jnp.asarray(mono), out_lo=jnp.float32(lo[c]),
                      out_hi=jnp.float32(hi[c]))
        gs = None
        if pen > 0:
            gs = jnp.where(jnp.asarray(mono) != 0,
                           js.monotone_penalty_factor(pen, depth[c]),
                           1.0).astype(jnp.float32)
        if spec.get("contri"):
            gs = jnp.asarray(contri) if gs is None \
                else gs * jnp.asarray(contri)
        if gs is not None:
            kw["gain_scale"] = gs
        if cegb is not None:
            slope = jnp.asarray(cegb.tradeoff * (cegb.penalty_split
                                                 + np.zeros(f)),
                                jnp.float32)
            p_ = slope * jnp.float32(tot[c, 2])
            if cegb.coupled is not None:
                p_ = p_ + jnp.asarray(cegb.tradeoff * cegb.coupled,
                                      jnp.float32) * (~jnp.asarray(cuse))
            kw["gain_penalty"] = p_
        rj = js.find_best_split(
            jnp.asarray(hist[c]), jnp.asarray(tot[c]), jnp.asarray(num_bin),
            jnp.asarray(na_bin), jnp.asarray(mask), pj,
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
        if spec.get("mono"):
            lo_c, hi_c = float(rt.left_output), float(rt.right_output)
            assert lo[c] <= lo_c <= hi[c] and lo[c] <= hi_c <= hi[c]
        moved += 1
    assert moved >= 2


def test_split_controls_change_the_pick():
    """Each control moves some child's pick or gain on these children (so
    the comparisons above are not of unconstrained scans)."""
    hist, tot, num_bin, na_bin = _children(11)
    args = (torch.as_tensor(hist), torch.as_tensor(tot),
            torch.zeros(4), torch.as_tensor(num_bin),
            torch.as_tensor(na_bin), torch.ones(8, dtype=torch.bool),
            ts.SplitParams())
    base = ts.find_best_split(*args)
    f = 8
    variants = {
        "mono": ts.SplitConstraints(
            mono=torch.tensor([1, -1, 0, 1, 0, -1, 1, 0], dtype=torch.int8),
            out_lo=torch.full((4,), -0.05), out_hi=torch.full((4,), 0.05)),
        "contri": ts.SplitConstraints(contri=torch.full((f,), 0.5)),
        "cegb": ts.SplitConstraints(cegb_slope=torch.full((f,), 0.02)),
    }
    for name, cons in variants.items():
        got = ts.find_best_split(*args, cons=cons)
        assert not torch.equal(got, base), name


# --- (c) B3s/B3s-K's state updates against the JAX grower's ------------------

def _jax_closures(mono, groups, num_leaves, bins):
    fn = make_grower(num_leaves=num_leaves, num_bins=bins,
                     params=js.SplitParams(), mono=mono,
                     interaction_groups=groups, jit=False)
    names = ("_child_ranges", "_inter_allowed")
    return {k: c.cell_contents for k, c in zip(fn.__code__.co_freevars,
                                                fn.__closure__)
            if k in names}


@pytest.mark.parametrize("num_leaves,K", [(31, 1), (64, 8)])
def test_step_state_equals_jax(num_leaves, K):
    binned, vals, num_bin, na_bin = binned_problem(17, n=3000)
    f, bins = binned.shape[1], 31
    mono = np.array([1, -1, 0, 1, 0, -1, 1, 0], np.int32)
    groups = np.array([[1, 1, 1, 1, 0, 0, 0, 0], [0, 0, 1, 1, 1, 1, 0, 0],
                       [0, 0, 0, 0, 0, 1, 1, 1]], bool)
    fmask = np.ones(f, bool)
    fmask[7] = False
    jf = _jax_closures(mono, groups, num_leaves, bins)
    cons = tc.device_constraints(num_leaves, "cpu", mono=mono,
                                 mono_penalty=1.0, groups=groups,
                                 cegb=tc.CEGBState(1.0, 0.001, None, None,
                                                   np.zeros(f, bool)))
    ws = tgr.GrowWorkspace(len(binned), f, bins, num_leaves,
                           torch.device("cpu"), split_batch=K,
                           constraints=cons)
    seen = {"live": 0}
    real = tgr.grow_step if K == 1 else tgr.grow_step_batched

    def check_slot(st, pre, leaf, new, feat, k, n, first):
        row = pre["table"][leaf]
        lo_p = -np.inf if first else pre["olo"][leaf]
        hi_p = np.inf if first else pre["ohi"][leaf]
        mid = 0.5 * (jnp.float32(row[10]) + jnp.float32(row[11]))
        want = jf["_child_ranges"](jnp.float32(lo_p), jnp.float32(hi_p),
                                   jnp.int32(mono[feat]), jnp.bool_(False),
                                   mid)
        got = (st.olo[leaf], st.ohi[leaf], st.olo[new], st.ohi[new])
        for a, b in zip(got, want):
            assert float(a) == float(b)
        assert (float(st.clo[k]), float(st.chi[k]), float(st.clo[n + k]),
                float(st.chi[n + k])) == tuple(float(w) for w in want)
        branch = (np.zeros(f, bool) if first else pre["fallow"][leaf]) \
            | (np.arange(f) == feat)
        allowed = np.asarray(jf["_inter_allowed"](jnp.asarray(branch))) \
            & fmask
        np.testing.assert_array_equal(st.fallow[leaf].numpy(), branch)
        np.testing.assert_array_equal(st.fallow[new].numpy(), branch)
        np.testing.assert_array_equal(st.cmask[k].numpy(), allowed)
        np.testing.assert_array_equal(st.cmask[n + k].numpy(), allowed)
        assert bool(st.cuse[feat])
        seen["live"] += 1

    def wrapped(table, tree, na, **kw):
        st = kw["cons"]
        pre = {"table": table.numpy().copy(), "olo": st.olo.numpy().copy(),
               "ohi": st.ohi.numpy().copy(),
               "fallow": st.fallow.numpy().copy(),
               "cuse": st.cuse.numpy().copy()}
        first = int(tgr.tree_fields(tree, num_leaves,
                                    0)["num_leaves"][0]) == 1
        real(table, tree, na, **kw)
        marks = np.zeros(f, bool)
        if K == 1:
            rec = kw["rec"]
            if int(rec[tgr.ACTIVE]):
                leaf, new, feat = (int(rec[c]) for c in
                                   (tgr.LEAF, tgr.NEW_LEAF, tgr.FEATURE))
                check_slot(st, pre, leaf, new, feat, 0, 1, first)
                marks[feat] = True
        else:
            recs = kw["step"].recs
            for k in range(K):
                if int(recs[k, tgr.ACTIVE]):
                    leaf, new, feat = (int(recs[k, c]) for c in
                                       (tgr.LEAF, tgr.NEW_LEAF, tgr.FEATURE))
                    check_slot(st, pre, leaf, new, feat, k, K, first)
                    marks[feat] = True
        np.testing.assert_array_equal(st.cuse.numpy(), pre["cuse"] | marks)

    name = "grow_step" if K == 1 else "grow_step_batched"
    setattr(tgr, name, wrapped)
    try:
        grow = tgr.grow_tree if K == 1 else tgr.grow_tree_batched
        kw = {} if K == 1 else {"split_batch": K}
        ws.cuse.zero_()
        grow(torch.as_tensor(binned), torch.as_tensor(vals),
             torch.as_tensor(fmask), torch.as_tensor(num_bin),
             torch.as_tensor(na_bin), num_leaves=num_leaves, num_bins=bins,
             params=ts.SplitParams(min_data_in_leaf=5), workspace=ws,
             constraints=cons, **kw)
    finally:
        setattr(tgr, name, real)
    assert seen["live"] >= num_leaves // 2
    # no split on a feature outside every group or the feature mask
    t = tgr.fetch_tree(ws)
    used = t.split_feature[:t.num_leaves - 1]
    assert not np.isin(used, [7]).any()


# --- (d, e) whole models -----------------------------------------------------

def _exact():
    x, _ = raw_problem(51, n=4000, f=8, task="regression", nan_frac=0.0)
    xv, _ = raw_problem(52, n=1000, f=8, task="regression", nan_frac=0.0)
    y = np.round(2 * x[:, 0] - x[:, 1] + x[:, 2] * x[:, 3]).astype(
        np.float32)
    yv = np.round(2 * xv[:, 0] - xv[:, 1]).astype(np.float32)
    return x, y, xv, yv


BASE = {"objective": "regression", "learning_rate": 0.5, "max_bin": 31,
        "boost_from_average": False, "min_data_in_leaf": 5, "metric": "l2",
        "verbosity": -1}


def _train(mod, params, data, rounds, path):
    x, y, xv, yv = data
    p = {**BASE, **params, **PATHS[path]}
    p.update({"device_type": "cpu"} if mod is lgt
             else {"tpu_learner": "masked"})
    tr = mod.Dataset(x, y)
    vs = None if path == "fused_chunk" else [mod.Dataset(xv, yv,
                                                         reference=tr)]
    ev = {}
    bst = mod.train(p, tr, rounds, valid_sets=vs,
                    callbacks=[mod.record_evaluation(ev)])
    return bst, ev


@pytest.fixture(scope="module")
def strict_runs():
    data = _exact()
    return {(case, path, mod.__name__): _train(
        mod, {"num_leaves": 31, **CONTROLS[case]}, data, 4, path)
        for case in CONTROLS for path in PATHS for mod in (lgt, lgb)}


@pytest.mark.parametrize("path", sorted(PATHS))
@pytest.mark.parametrize("case", sorted(CONTROLS))
def test_strict_models_equal_jax(strict_runs, case, path):
    (bt, evt), (bj, evj) = strict_runs[(case, path, "lightgbm_torch")], \
        strict_runs[(case, path, "lightgbm_tpu")]
    tt, tj = _trees(_norm(bt.model_to_string())), \
        _trees(_norm(bj.model_to_string()))
    assert len(tt) == len(tj) >= 3
    mono = "monotone_constraints" in CONTROLS[case]
    for i, (a, b) in enumerate(zip(tt, tj)):
        _same_tree(a, b, exact=i == 0 and not mono)
    assert bt._model.split_batch == 1
    if path != "fused_chunk":
        np.testing.assert_allclose(evt["valid_0"]["l2"], evj["valid_0"]["l2"],
                                   rtol=RTOL)


@pytest.mark.parametrize("case", sorted(CONTROLS))
def test_strict_paths_write_the_same_model(strict_runs, case):
    texts = {p: _norm(strict_runs[(case, p, "lightgbm_torch")][0]
                      .model_to_string()) for p in PATHS}
    assert texts["per_iteration"] == texts["fused_chunk"] \
        == texts["superepoch"]
    plain = _norm(lgt.train({**BASE, "num_leaves": 31, "device_type": "cpu",
                             **PATHS["per_iteration"]},
                            lgt.Dataset(*_exact()[:2]), 4)
                  .model_to_string())
    assert _trees(texts["per_iteration"]) != _trees(plain)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_wide_first_tree_equals_jax(path):
    data = _exact()
    params = {"num_leaves": 255, **CONTROLS["all"],
              "feature_fraction_bynode": 0.6}
    bt, evt = _train(lgt, params, data, 3, path)
    bj, evj = _train(lgb, params, data, 3, path)
    assert bt._model.split_batch == 16
    tt, tj = _trees(_norm(bt.model_to_string())), \
        _trees(_norm(bj.model_to_string()))
    _same_tree(tt[0], tj[0], exact=False)
    assert "num_leaves=" in tt[0]
    if path != "fused_chunk":
        a, b = min(evt["valid_0"]["l2"]), min(evj["valid_0"]["l2"])
        assert abs(a - b) <= METRIC_RTOL * b, (a, b)


def test_intermediate_and_advanced_name_the_partitioned_learner():
    """The monotone methods intermediate and advanced select the
    partitioned learner (``auto``), whose first tree is the JAX
    package's; with an explicit masked learner both packages raise the
    JAX package's ValueError naming the partitioned learner."""
    x, y = raw_problem(4, n=400, f=4)
    y = np.minimum(y, 1)
    for method in ("intermediate", "advanced"):
        # 7 leaves: past them this 400-row set's best gains fall to f32
        # rounding noise (about 1e-6), where summation orders decide
        p = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
             "monotone_constraints": [1, 0, 0, 0],
             "monotone_constraints_method": method}
        bt = lgt.train({**p, "device_type": "cpu"}, lgt.Dataset(x, y), 2)
        assert bt._model.learner == "partitioned"
        bj = lgb.train(p, lgb.Dataset(x, label=y), 2)
        assert_first_tree_equal(bt, bj)
        for mod, ds in ((lgt, lgt.Dataset(x, y)),
                        (lgb, lgb.Dataset(x, label=y))):
            with pytest.raises(ValueError,
                               match="require the partitioned learner"):
                mod.train({**p, "tpu_learner": "masked", **(
                    {"device_type": "cpu"} if mod is lgt else {})}, ds, 2)


def test_cegb_used_state_carries_across_trees_and_paths():
    """The host ``used`` set after training holds every split feature of
    the model, and an epoch's start uploads it (a per-iteration run
    after a fused one continues from it)."""
    x, y, _, _ = _exact()
    params = {**BASE, "num_leaves": 15, "device_type": "cpu",
              **CONTROLS["cegb"]}
    b1 = lgt.train({**params, "fused_chunk": 3}, lgt.Dataset(x, y), 6)
    m = b1._model
    feats = set()
    for t in m.models:
        feats |= set(int(v) for v in t.split_feature[:t.num_leaves - 1])
    assert set(np.nonzero(m.cegb.used)[0]) == feats
    assert bool(torch.equal(m.grow_ws.cuse, torch.as_tensor(m.cegb.used)))
    b2 = lgt.train({**params, **PATHS["per_iteration"]},
                   lgt.Dataset(x, y), 6)
    assert _norm(b1.model_to_string()) == _norm(b2.model_to_string())


# --- (f) compositions --------------------------------------------------------

def _pred_close(bt, bj, x):
    np.testing.assert_allclose(bt.predict(x, raw_score=True),
                               np.asarray(bj.predict(x, raw_score=True)),
                               rtol=0, atol=PRED_ATOL)


def _both(params, x, y, rounds=4, ds_kw=None, valid=None):
    ds_kw = ds_kw or {}
    bt = lgt.train({**params, "device_type": "cpu"},
                   lgt.Dataset(x, y, **ds_kw), rounds)
    bj = lgb.train({**params, "tpu_learner": "masked"},
                   lgb.Dataset(x, label=y, **ds_kw), rounds)
    return bt, bj


MONO3 = {"monotone_constraints": [1, -1, 0, 1, 0, 0, 0, 0]}


def test_monotone_with_categorical_features():
    rs = np.random.RandomState(7)
    x, _ = raw_problem(71, n=3000, f=8, task="regression", nan_frac=0.0)
    x[:, 6] = rs.randint(0, 9, len(x))
    y = np.round(2 * x[:, 0] - x[:, 1] + (x[:, 6] % 3)).astype(np.float32)
    bt, bj = _both({**BASE, "num_leaves": 15, "min_data_per_group": 20,
                    **MONO3}, x, y, ds_kw={"categorical_feature": [6]})
    assert sum(t.num_cat for t in bt._model.models) > 0
    _pred_close(bt, bj, x)


def test_monotone_with_efb():
    rs = np.random.RandomState(8)
    x, _ = raw_problem(72, n=3000, f=8, task="regression", nan_frac=0.0)
    hot = rs.randint(0, 6, len(x))
    onehot = np.eye(6)[hot]
    xx = np.concatenate([x, onehot], axis=1)
    y = np.round(2 * x[:, 0] - x[:, 1] + hot % 3).astype(np.float32)
    params = {**BASE, "num_leaves": 15,
              "monotone_constraints": [1, -1] + [0] * 12}
    bt, bj = _both(params, xx, y)
    assert bt._model.efb_dev is not None
    _pred_close(bt, bj, xx)


def test_monotone_with_sparse_storage():
    rs = np.random.RandomState(9)
    n, f, nnz = 1200, 200, 20
    cols = np.stack([rs.choice(f, nnz, replace=False) for _ in range(n)])
    cols.sort(axis=1)
    vals = rs.randint(1, 4, size=(n, nnz)).astype(np.float64)
    x = sps.csr_matrix((vals.ravel(), cols.ravel(),
                        np.arange(0, n * nnz + 1, nnz)), shape=(n, f))
    w = rs.randn(f)
    y = np.round(np.asarray(x @ w).ravel()).astype(np.float32)
    mc = [0] * f
    mc[int(np.argmax(np.abs(w)))] = int(np.sign(w[np.argmax(np.abs(w))]))
    params = {**BASE, "num_leaves": 15, "min_data_in_leaf": 10,
              "enable_bundle": False, "monotone_constraints": mc}
    bt, bj = _both(params, x, y)
    from lightgbm_torch.sparse_data import SparseBinned
    assert isinstance(bt._model.binned_dev, SparseBinned)
    _pred_close(bt, bj, x)


def test_monotone_with_quant_train():
    x, y, _, _ = _exact()
    params = {**BASE, "num_leaves": 15, "quant_train": True,
              "quant_bits": 8, **MONO3}
    bt, bj = _both(params, x, y)
    _pred_close(bt, bj, x)


def test_monotone_with_lambdarank():
    rs = np.random.RandomState(0)
    sizes = rs.randint(5, 36, 150)
    n = int(sizes.sum())
    x = rs.randn(n, 8).astype(np.float32)
    rel = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] ** 2 + 0.3 * rs.randn(n)
    y = np.digitize(rel, [0.0, 0.8, 1.5, 2.2]).astype(np.float32)
    params = {"objective": "lambdarank", "num_leaves": 15, "verbosity": -1,
              "min_data_in_leaf": 5, **MONO3}
    bt, bj = _both(params, x, y, ds_kw={"group": sizes})
    _pred_close(bt, bj, x)


def test_interaction_with_bynode():
    x, y, _, _ = _exact()
    params = {**BASE, "num_leaves": 31, "feature_fraction_bynode": 0.5,
              **CONTROLS["inter"]}
    bt, bj = _both(params, x, y)
    _pred_close(bt, bj, x)
    _no_interaction_violation(bt, [[0, 1, 2], [2, 3, 4], [5, 6, 7]])


def test_interaction_with_multiclass():
    x, _ = raw_problem(73, n=3000, f=8, task="regression", nan_frac=0.0)
    y = np.digitize(x[:, 0] + x[:, 5], [-0.5, 0.5]).astype(np.float32)
    params = {"objective": "multiclass", "num_class": 3, "num_leaves": 15,
              "verbosity": -1, "max_bin": 31, **CONTROLS["inter"]}
    bt, bj = _both(params, x, y, rounds=3)
    _pred_close(bt, bj, x)
    _no_interaction_violation(bt, [[0, 1, 2], [2, 3, 4], [5, 6, 7]])


# --- (g) violations ----------------------------------------------------------
# tests/test_constraints.py's helpers, copied

def _mono_data(n=4000, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(n, 3)
    # y increasing in x0, decreasing in x1, free in x2
    y = (3.0 * x[:, 0] - 2.0 * x[:, 1] + np.sin(6.28 * x[:, 2])
         + 0.2 * rs.randn(n)).astype(np.float32)
    return x, y


def _check_monotone(bst, feature, sign, n_checks=50, seed=1):
    """Sweep the constrained feature on fixed rows; predictions must be
    monotone in the swept direction."""
    rs = np.random.RandomState(seed)
    base = rs.rand(n_checks, 3)
    grid = np.linspace(0.0, 1.0, 30)
    ok = True
    for i in range(n_checks):
        rows = np.repeat(base[i][None, :], len(grid), axis=0)
        rows[:, feature] = grid
        pred = bst.predict(rows)
        diffs = np.diff(pred)
        if sign > 0:
            ok &= bool((diffs >= -1e-9).all())
        else:
            ok &= bool((diffs <= 1e-9).all())
    return ok


def _no_interaction_violation(bst, groups):
    """Every root-to-leaf path's features lie in one group."""
    for t in bst._model.models:
        if t.num_leaves <= 1:
            continue

        def walk(node, feats):
            if node < 0:
                assert any(feats <= set(g) for g in groups), feats
                return
            f = feats | {int(t.split_feature[node])}
            walk(int(t.left_child[node]), f)
            walk(int(t.right_child[node]), f)
        walk(0, set())


@pytest.mark.parametrize("grower", ["strict", "batched"])
@pytest.mark.parametrize("penalty", [0.0, 1.5])
def test_no_monotone_violations(grower, penalty):
    x, y = _mono_data()
    p = {"objective": "regression", "num_leaves": 31 if grower == "strict"
         else 64, "max_bin": 63, "min_data_in_leaf": 10,
         "monotone_constraints": [1, -1, 0], "monotone_penalty": penalty,
         "device_type": "cpu", "verbosity": -1}
    bst = lgt.train(p, lgt.Dataset(x, y), 20)
    assert bst._model.split_batch == (1 if grower == "strict" else 8)
    assert _check_monotone(bst, 0, +1), "predictions not increasing in x0"
    assert _check_monotone(bst, 1, -1), "predictions not decreasing in x1"
    used = set()
    for t in bst._model.models:
        used |= set(int(v) for v in t.split_feature[:t.num_leaves - 1])
    assert {0, 1} <= used


def test_no_interaction_violations_wide():
    x, y, _, _ = _exact()
    groups = [[0, 1, 2], [2, 3, 4], [5, 6, 7]]
    bst = lgt.train({**BASE, "num_leaves": 64, "device_type": "cpu",
                     **CONTROLS["inter"]}, lgt.Dataset(x, y), 5)
    assert bst._model.split_batch == 8
    _no_interaction_violation(bst, groups)
