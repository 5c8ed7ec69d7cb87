"""The computation-integrity layer in the port (``lightgbm_torch.integrity``,
``utils/faultinject``, ``parallel/elastic``) on the CPU.

Held against the JAX package's ``lightgbm_tpu.integrity`` and
``utils.faultinject`` on the same seeded numpy inputs:

- ``ulp_delta`` and ``compare_tree_arrays`` equal the JAX functions';
- the plain B17a (``invariant_flags_plain``, on the grower's tree buffer)
  gives the JAX ``invariant_flags``'s flag on healthy trees, on trees
  with broken counts or gains, and on real trees of a port training with
  one bit of a count flipped;
- the plain B17c (``feature_totals_residual``) equals the JAX function
  within 1e-5 relative on f32 histograms and exactly on int32 ones;
- ``maybe_bitflip`` flips the JAX function's element and bit for each
  ``site:hit``, and the spec grammar accepts and refuses as the JAX one;
- the plain B17b (``score_mismatch``) flags a changed row;

and, mirroring ``tests/test_integrity.py``'s training cases on the port's
CPU path (masked learner, ``device_type=cpu``; the shadow is the plain
grower run again):

- checked training (``integrity_check_freq`` 1 and 3) writes the model
  text of unchecked training, and its first tree is the JAX package's
  checked run's;
- at ``integrity_check_freq=0`` the fetches by site, the launches and the
  grower calls are those of a configuration that never names integrity;
- ``hist_sdc:3`` and ``score_sdc:3`` are absorbed byte-identically;
  ``hist_sdc:3-4`` raises ``IntegrityFailure`` (kind ``sdc``, iteration
  3, a ``leaf_count`` divergence); ``quarantine`` marks the attributed
  device; ``sdc_shrunk``'s arithmetic;
- multiclass, ``quant_train``, the 255-leaf batched grower and the split
  controls with CEGB train checked byte-identically;
- ``tpu_learner=partitioned`` raises the JAX package's ``ValueError``,
  ``rewind`` names ROADMAP A12, and the fused paths and the fleet refuse
  the layer and armed injection, as the JAX package's do;
- the shadow grower leaves the primary's workspace untouched;
  ``boundary_check`` and ``manifest`` (no caller until A12).
"""

import types

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import integrity
from lightgbm_torch.grower import (GrowWorkspace, grow_tree,
                                   make_shadow_grower, tree_layout,
                                   tree_words)
from lightgbm_torch.ops.histogram import (feature_totals_residual,
                                          feature_totals_residual_plain)
from lightgbm_torch.ops.split import SplitParams
from lightgbm_torch.parallel import elastic
from lightgbm_torch.utils import faultinject
from lightgbm_tpu import integrity as jax_integrity
from lightgbm_tpu.parallel import elastic as jax_elastic
from lightgbm_tpu.utils import faultinject as jax_faultinject

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

# the JAX package's integrity test configuration (tests/test_integrity.py)
BASE = {"objective": "binary", "num_leaves": 7, "verbosity": -1,
        "deterministic": True, "seed": 3, "tpu_learner": "masked"}
CPU = {"device_type": "cpu"}
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
# B17c: the JAX function sums an f32 histogram in f32, the port in f64
RESIDUAL_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clean_state():
    for fi in (faultinject, jax_faultinject):
        fi.clear()
    for el in (elastic, jax_elastic):
        el.clear_suspects()
    for mod in (integrity, jax_integrity):
        mod.reset_metrics()
    elastic.reset_metrics()
    yield
    for fi in (faultinject, jax_faultinject):
        fi.clear()
    for el in (elastic, jax_elastic):
        el.clear_suspects()
    for mod in (integrity, jax_integrity):
        mod.reset_metrics()
    elastic.reset_metrics()


def _data(n=400, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 8).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    return x, y


def _train(extra=None, rounds=8, faults=None, n=400, x=None, y=None):
    if x is None:
        x, y = _data(n)
    faultinject.configure(faults)
    try:
        return lgt.train(dict(BASE, **CPU, **(extra or {})),
                         lgt.Dataset(x, y), num_boost_round=rounds)
    finally:
        faultinject.configure(None)


def _trees(bst):
    return bst.model_to_string().split("parameters:")[0] \
        .split("feature_infos")[1]


def _structure(tree_text):
    return [ln for ln in tree_text.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _first_tree(text):
    return text.split("end of trees")[0].split("Tree=")[1]


def _mvals():
    return {k: v["value"] for k, v in integrity.metrics_snapshot().items()}


# --- comparison primitives ------------------------------------------------

def test_ulp_delta_equals_jax():
    rs = np.random.RandomState(0)
    a = rs.randn(64).astype(np.float32)
    b = a.copy()
    b[::3] = np.nextafter(b[::3], np.float32(9.0), dtype=np.float32)
    b[1::5] = -b[1::5]
    a[2], b[2] = np.nan, np.nan
    a[7], b[7] = -0.0, 0.0
    a[11], b[11] = np.inf, np.float32(3e38)
    assert np.array_equal(integrity.ulp_delta(a, b),
                          jax_integrity.ulp_delta(a, b))


def _tiny(**over):
    """The JAX test's 3-leaf tree (node 0 -> node 1 and leaf 0, node 1 ->
    leaves 1 and 2) in a 4-leaf budget, as a dict of its fields."""
    t = {"num_leaves": 3, "left_child": np.array([1, ~1, 0], np.int32),
         "right_child": np.array([~0, ~2, 0], np.int32),
         "leaf_count": np.array([100., 60., 40., 0.], np.float32),
         "internal_count": np.array([200., 100., 0.], np.float32),
         "split_gain": np.array([1.5, 0.25, 0.0], np.float32)}
    t.update(over)
    return t


def _words(fields, L=4):
    """The grower's tree buffer of ``fields`` for an L-leaf budget."""
    w = torch.zeros(tree_words(L), dtype=torch.int32)
    for name, (off, n, kind) in tree_layout(L).items():
        if name not in fields:
            continue
        v = torch.as_tensor(np.asarray(fields[name]).reshape(-1)[:n].copy())
        w[off:off + v.numel()] = v.view(torch.int32) if kind == "f" \
            else v.to(torch.int32)
    return w


def _jax_tree(fields):
    import collections
    T = collections.namedtuple("T", list(fields) + ["leaf_of_row"])
    return T(**{k: (np.int32(v) if k == "num_leaves" else v)
                for k, v in fields.items()}, leaf_of_row=np.int32(0))


def _port_tree(fields):
    import collections
    T = collections.namedtuple("T", list(fields) + ["leaf_of_row"])
    return T(**fields, leaf_of_row=None)


@pytest.mark.parametrize("case", ["same", "int", "float1", "float3", "shape"])
@pytest.mark.parametrize("tol", [0, 2])
def test_compare_tree_arrays_equals_jax(case, tol):
    a = _tiny()
    lc = a["leaf_count"].copy()
    b = {"same": {}, "int": {"left_child": np.array([1, ~2, 0], np.int32)},
         "float1": {"leaf_count": np.nextafter(
             lc, np.float32(1e9), dtype=np.float32)},
         "float3": {"split_gain": a["split_gain"] * np.float32(1.0000005)},
         "shape": {"leaf_count": lc[:3]}}[case]
    b = _tiny(**b)
    got = integrity.compare_tree_arrays(_port_tree(a), _port_tree(b), tol)
    want = jax_integrity.compare_tree_arrays(_jax_tree(a), _jax_tree(b), tol)
    assert got == want


# --- B17a --------------------------------------------------------------

def _flag_both(fields, L=4):
    port = int(integrity.invariant_flags(_words(fields, L), L)[0])
    jt = dict(fields)
    jt["num_leaves"] = np.int32(jt["num_leaves"])
    want = bool(jax_integrity.invariant_flags(
        types.SimpleNamespace(**jt)))
    return port, want


@pytest.mark.parametrize("case", ["healthy", "conserve", "gain_inf",
                                  "gain_nan", "stump", "root",
                                  "nan_count", "dead_node_ignored"])
def test_invariant_flags_plain_equals_jax(case):
    t = _tiny()
    lc, sg, ic = (t["leaf_count"].copy(), t["split_gain"].copy(),
                  t["internal_count"].copy())
    if case == "conserve":
        lc[1] += 8.0
    elif case == "gain_inf":
        sg[0] = np.inf
    elif case == "gain_nan":
        sg[1] = np.nan
    elif case == "stump":
        t["num_leaves"] = 1
        lc[:] = [200., 0., 0., 0.]
    elif case == "root":
        ic[0] = 260.0
    elif case == "nan_count":
        lc[2] = np.nan
    elif case == "dead_node_ignored":
        sg[2] = np.inf   # past num_leaves - 1
    t.update(leaf_count=lc, split_gain=sg, internal_count=ic)
    port, want = _flag_both(t)
    assert port == int(want)
    assert port == int(case in ("healthy", "stump", "dead_node_ignored"))


def test_invariant_flags_on_grown_trees_equal_jax():
    """31-leaf trees of the port's grower, healthy and with each third
    bit of [8, 31) of two counts flipped: the plain B17a's flag is the
    JAX function's on the same fields."""
    from lightgbm_torch.grower import tree_fields
    L = 31
    seen = {0: 0, 1: 0}
    for seed in (0, 1, 2):
        binned, vals, num_bin, na_bin = binned_problem(seed, n=3000, f=6,
                                                       bins=31)
        ws = GrowWorkspace(3000, 6, 31, L, torch.device("cpu"))
        grow_tree(torch.as_tensor(binned), torch.as_tensor(vals),
                  torch.ones(6, dtype=torch.bool), torch.as_tensor(num_bin),
                  torch.as_tensor(na_bin), num_leaves=L, num_bins=31,
                  params=SplitParams(min_data_in_leaf=5), workspace=ws)
        f = tree_fields(ws.tree.numpy(), L)
        base = {k: np.array(f[k]) for k in
                ("left_child", "right_child", "leaf_count",
                 "internal_count", "split_gain")}
        base["num_leaves"] = int(f["num_leaves"][0])
        assert base["num_leaves"] > 8
        for which, idx, bit in [(None, 0, 0)] + [
                (fld, i, b) for fld in ("leaf_count", "internal_count")
                for i in (0, 3) for b in range(8, 31, 3)]:
            t = {k: (v.copy() if isinstance(v, np.ndarray) else v)
                 for k, v in base.items()}
            if which is not None:
                t[which].view(np.int32)[idx] ^= np.int32(1 << bit)
            port, want = _flag_both(t, L)
            assert port == int(want), (seed, which, idx, bit)
            seen[port] += 1
    assert seen[0] > 0 and seen[1] > 0


# --- B17c --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["f32", "int8", "int16"])
def test_feature_totals_residual_equals_jax(kind):
    import jax.numpy as jnp
    from lightgbm_tpu.ops.histogram import (compute_histogram,
                                            feature_totals_residual as jres)
    rs = np.random.RandomState(1)
    binned = rs.randint(0, 15, (500, 4)).astype(np.uint8)
    if kind == "f32":
        vals = rs.randn(500, 3).astype(np.float32)
    else:
        dt = np.int8 if kind == "int8" else np.int16
        hi = 127 if kind == "int8" else 32767
        vals = rs.randint(-hi, hi + 1, (500, 3)).astype(dt)
    hist = np.array(compute_histogram(jnp.asarray(binned),
                                      jnp.asarray(vals), num_bins=16))
    bad = hist.copy()
    bad[2, 3, 1] += 64
    for h in (hist, bad):
        want = float(jres(jnp.asarray(h), jnp.asarray(vals)))
        got = feature_totals_residual(torch.as_tensor(h),
                                      torch.as_tensor(vals))
        assert got.dtype == torch.float64 and got.shape == ()
        if kind == "f32":
            assert abs(float(got) - want) <= RESIDUAL_RTOL * max(
                abs(want), 1.0), (float(got), want)
        else:
            assert float(got) == want
    if kind != "f32":
        assert float(feature_totals_residual_plain(
            torch.as_tensor(hist), torch.as_tensor(vals))) == 0.0
    with pytest.raises(TypeError):
        feature_totals_residual(torch.as_tensor(hist).float()
                                if kind != "f32" else
                                torch.as_tensor(hist).int(),
                                torch.as_tensor(vals))


# --- injection ---------------------------------------------------------

@pytest.mark.parametrize("site", ["hist_sdc", "score_sdc"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("index", [None, 0, 5])
def test_maybe_bitflip_equals_jax(site, dtype, index):
    base = (np.linspace(1.0, 2.0, 37) * 100).astype(dtype)
    spec = f"{site}:2-6"
    faultinject.configure(spec)
    jax_faultinject.configure(spec)
    for hit in range(1, 8):
        t = torch.as_tensor(base.copy())
        got = faultinject.maybe_bitflip(site, t, index=index)
        want = np.asarray(jax_faultinject.maybe_bitflip(site, base,
                                                        index=index))
        assert got is t
        assert got.numpy().tobytes() == want.tobytes(), hit
        assert (got.numpy() != base).sum() == (1 if 2 <= hit <= 6 else 0)
    assert faultinject.hits(site) == jax_faultinject.hits(site) == 7


@pytest.mark.parametrize("spec", [
    "hist_sdc:3", "hist_sdc:3-4,score_sdc:5", "score_sdc:2-", "nan_grads:1",
    "snapshot_kill:1", "collective_hang:2:raise", "hist_sdc:1:kill", "",
    "hist_sdc", "bogus:1", "hist_sdc:0", "hist_sdc:4-2",
    "hist_sdc:1:explode"])
def test_spec_grammar_equals_jax(spec):
    def outcome(mod):
        try:
            mod.configure(spec)
        except ValueError:
            return "ValueError"
        return dict(mod._spec)
    assert outcome(faultinject) == outcome(jax_faultinject)
    assert faultinject.enabled() == jax_faultinject.enabled()


def test_unarmed_site_returns_the_same_tensor():
    t = torch.ones(4)
    faultinject.configure("claim_wedge:1")
    assert faultinject.maybe_bitflip("hist_sdc", t) is t
    assert faultinject.hits("hist_sdc") == 0


# --- B17b --------------------------------------------------------------

def test_score_mismatch_plain():
    rs = np.random.RandomState(2)
    lv = torch.as_tensor(rs.randn(7).astype(np.float32))
    lor = torch.as_tensor(rs.randint(0, 7, 300).astype(np.int32))
    delta = lv.index_select(0, lor)
    assert int(integrity.score_mismatch(lv, lor, delta)[0]) == 0
    faultinject.configure("score_sdc:1")
    bad = faultinject.maybe_bitflip("score_sdc", delta.clone())
    assert int(integrity.score_mismatch(lv, lor, bad)[0]) == 1
    lor2 = lor.clone()
    lor2[5] = 7
    assert int(integrity.score_mismatch(lv, lor2, delta)[0]) == 1


# --- checked training --------------------------------------------------

def test_checked_training_is_byte_identical():
    ref = _trees(_train())
    for freq in (1, 3):
        bst = _train({"integrity_check_freq": freq})
        assert _trees(bst) == ref
        m = bst._model
        n_check = 8 if freq == 1 else 2
        assert m.fetch_counts == {"integrity": 8, "tree": 8,
                                  "integrity_score": n_check}
    mv = _mvals()
    assert mv["integrity.checks{path=grow}"] == 8 + 2
    assert mv["integrity.checks{path=score}"] == 8 + 2
    assert "integrity.mismatches{path=grow}" not in mv


def test_checked_first_tree_equals_jax_checked_run():
    x, y = _data()
    p = dict(BASE, integrity_check_freq=1)
    jb = lgb.train(dict(p), lgb.Dataset(x, label=y), num_boost_round=3)
    pb = _train({"integrity_check_freq": 1}, rounds=3)
    assert _structure(_first_tree(pb.model_to_string())) \
        == _structure(_first_tree(jb.model_to_string()))


def test_freq_zero_adds_nothing(monkeypatch):
    """integrity_check_freq=0 is the loop of a configuration that never
    names integrity: the same fetches by site, launches, grower calls and
    no B17a/B17b call."""
    from lightgbm_torch import _kernels
    from lightgbm_torch.models import fused
    calls = {"grow": 0, "inv": 0, "score": 0}

    def count(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(fused, "grow_tree", count("grow", fused.grow_tree))
    monkeypatch.setattr(fused, "invariant_flags",
                        count("inv", fused.invariant_flags))
    monkeypatch.setattr(integrity, "score_mismatch",
                        count("score", integrity.score_mismatch))
    seen = []
    for extra in ({}, {"integrity_check_freq": 0}):
        _kernels.reset_launch_counts()
        for k in calls:
            calls[k] = 0
        bst = _train(extra, rounds=6)
        m = bst._model
        assert m._integrity is None and len(bst.trees) == 6
        seen.append((dict(m.fetch_counts), _kernels.launch_counts(),
                     dict(calls), _trees(bst)))
    assert seen[0] == seen[1]
    assert seen[0][2] == {"grow": 6, "inv": 0, "score": 0}
    assert _mvals() == {}


def test_grow_transient_absorbed_byte_identical():
    p = {"integrity_check_freq": 1}
    ref = _trees(_train(p))
    integrity.reset_metrics()
    bst = _train(p, faults="hist_sdc:3")
    assert _trees(bst) == ref
    mv = _mvals()
    assert mv["integrity.mismatches{path=grow}"] == 1
    assert mv["integrity.transient_absorbed"] == 1
    assert "integrity.sticky" not in mv
    assert bst._model.fetch_counts["integrity_recheck"] == 1


def test_score_transient_absorbed_byte_identical():
    p = {"integrity_check_freq": 1}
    ref = _trees(_train(p))
    integrity.reset_metrics()
    assert _trees(_train(p, faults="score_sdc:3")) == ref
    mv = _mvals()
    assert mv["integrity.mismatches{path=score}"] == 1
    assert mv["integrity.transient_absorbed"] == 1


def test_transient_off_check_iteration_caught_by_invariants():
    """freq 3: iteration 2 is no check iteration; hit 2 of hist_sdc
    flips exponent bit 25 of leaf 0's count, which B17a alone catches,
    and the re-run absorbs."""
    assert faultinject.bitflip_choice("hist_sdc", 2, 7, True, index=0) \
        == (0, 25)
    p = {"integrity_check_freq": 3}
    ref = _trees(_train(p))
    integrity.reset_metrics()
    bst = _train(p, faults="hist_sdc:2")
    mv = _mvals()
    assert mv["integrity.mismatches{path=grow}"] == 1
    assert mv["integrity.transient_absorbed"] == 1
    assert mv["integrity.checks{path=grow}"] == 2    # iterations 3, 6
    assert _trees(bst) == ref


def test_sticky_raises_classified_sdc():
    with pytest.raises(integrity.IntegrityFailure) as ei:
        _train({"integrity_check_freq": 1}, faults="hist_sdc:3-4")
    e = ei.value
    assert elastic.failure_kind(e) == "sdc"
    assert e.iteration == 3
    assert e.devices == ()      # the CPU names no device
    assert any(d["field"] == "leaf_count" for d in e.divergences)
    mv = _mvals()
    assert mv["integrity.sticky"] == 1
    assert "integrity.quarantined" not in mv
    em = {k: v["value"] for k, v in elastic.metrics_snapshot().items()}
    assert em["elastic.failures{kind=sdc}"] == 1
    assert [ev["event"] for ev in elastic.events()] == ["sdc"]


def test_quarantine_policy_marks_suspects():
    # on the CPU the sticky failure names no device, so nothing is marked
    with pytest.raises(integrity.IntegrityFailure) as ei:
        _train({"integrity_check_freq": 1,
                "integrity_policy": "quarantine"}, faults="hist_sdc:3-4")
    assert ei.value.devices == ()
    assert elastic.suspected_devices() == frozenset()
    # a divergence placed on card 3 marks it, as on the card
    cfg = lgt.Config({"integrity_check_freq": 1,
                      "integrity_policy": "quarantine"})
    chk = integrity.IntegrityChecker(cfg, None, True, (7, 16, 0))
    placed = types.SimpleNamespace(device=torch.device("cuda", 3))
    with pytest.raises(integrity.IntegrityFailure) as ei:
        chk._sticky(4, [{"field": "leaf_count"}], placed)
    assert ei.value.devices == (3,) and ei.value.iteration == 5
    assert elastic.suspected_devices() == frozenset({3})
    assert _mvals()["integrity.quarantined"] == 1


def test_sdc_shrunk_drops_exactly_the_suspects():
    for el in (elastic, jax_elastic):
        assert el.sdc_shrunk(8) == 4
        el.mark_suspect([5])
        assert el.sdc_shrunk(8) == 7
        el.mark_suspect([2, 6])
        assert el.sdc_shrunk(8) == 5
        assert el.sdc_shrunk(2) == 1
    assert elastic.suspected_devices() == jax_elastic.suspected_devices()


@pytest.mark.parametrize("name,extra", [
    ("multiclass", {"objective": "multiclass", "num_class": 3}),
    ("quant", {"quant_train": True, "quant_bits": 8}),
    ("batched_255", {"num_leaves": 255, "min_data_in_leaf": 5}),
    ("controls", {"monotone_constraints": [1, 1, 0, 0, 0, 0, 0, 0],
                  "interaction_constraints": [[0, 1, 2, 3],
                                              [2, 3, 4, 5, 6, 7]],
                  "cegb_penalty_split": 0.01,
                  "cegb_penalty_feature_coupled": [0.05] * 8,
                  "bagging_fraction": 0.8, "bagging_freq": 1})])
def test_checked_forms_byte_identical(name, extra):
    x, y = _data(1200, seed=5)
    if name == "multiclass":
        y = (np.digitize(x[:, 0] + 0.3 * x[:, 2], [-0.5, 0.5])
             ).astype(np.float32)
    ref = _trees(_train(extra, rounds=5, x=x, y=y))
    integrity.reset_metrics()
    got = _train(dict(extra, integrity_check_freq=2), rounds=5, x=x, y=y,
                 faults="hist_sdc:2,score_sdc:4")
    assert _trees(got) == ref
    assert len(got.trees) == 5 * (3 if name == "multiclass" else 1)
    mv = _mvals()
    assert mv["integrity.transient_absorbed"] == 2
    assert "integrity.sticky" not in mv


def test_partitioned_learner_raises_jax_text():
    x, y = _data()
    p = dict(BASE, integrity_check_freq=1, tpu_learner="partitioned")
    with pytest.raises(ValueError) as want:
        lgb.train(dict(p), lgb.Dataset(x, label=y), num_boost_round=2)
    with pytest.raises(ValueError) as got:
        _train({"integrity_check_freq": 1, "tpu_learner": "partitioned"},
               rounds=2)
    assert str(got.value) == str(want.value)


def test_rewind_names_a12():
    with pytest.raises(NotImplementedError, match="A12"):
        _train({"integrity_check_freq": 1, "integrity_policy": "rewind"})


def test_fused_paths_refuse_the_layer_and_armed_sites():
    x, y = _data()
    xv, yv = _data(200, seed=1)
    for extra, faults in (({"integrity_check_freq": 2}, None),
                          ({}, "score_sdc:99")):
        faultinject.configure(faults)
        try:
            tr = lgt.Dataset(x, y)
            bst = lgt.train(dict(BASE, **CPU, **extra,
                                 metric="binary_logloss"), tr,
                            num_boost_round=4,
                            valid_sets=[lgt.Dataset(xv, yv, reference=tr)])
            m = bst._model
            # the super-epoch plan refused: one tree fetch an iteration
            assert m.fetch_counts.get("epoch", 0) == 0
            assert m.fetch_counts["tree"] == 4
            assert not m.supports_fused()
            want = ("integrity_check_freq > 0" if extra
                    else "fault injection active")
            assert any(r.startswith(want) for r in m.fused_reasons())
            m.valid_sets.clear()
            with pytest.raises(ValueError, match="config not fusable"):
                m.train_chunk(2)
        finally:
            faultinject.clear()


def test_fleet_refuses_as_jax():
    from lightgbm_torch.fleet import fleet_train
    from lightgbm_tpu.fleet import fleet_train as jax_fleet_train
    x, y = _data(600)
    xv, yv = _data(200, seed=1)
    p = dict(BASE, integrity_check_freq=1, fleet_members=2,
             metric="binary_logloss")
    out = []
    for mod, ft, extra in ((lgb, jax_fleet_train, {}),
                           (lgt, fleet_train, CPU)):
        tr = mod.Dataset(x, label=y)
        with pytest.raises(ValueError) as ei:
            ft(dict(p, **extra), tr, 4,
               valid_sets=[mod.Dataset(xv, label=yv, reference=tr)])
        out.append(str(ei.value))
    assert "does not qualify for the super-epoch trainer" in out[1]
    assert out[0] == out[1]


# --- the shadow grower, the boundary check and the manifest ------------

def test_shadow_grower_leaves_the_primary_untouched():
    binned, vals, num_bin, na_bin = binned_problem(5, n=2000, f=6, bins=15)
    b, v = torch.as_tensor(binned), torch.as_tensor(vals)
    nb, na = torch.as_tensor(num_bin), torch.as_tensor(na_bin)
    fmask = torch.ones(6, dtype=torch.bool)
    kw = dict(num_leaves=15, num_bins=15, params=SplitParams(
        min_data_in_leaf=5))
    ws = GrowWorkspace(2000, 6, 15, 15, torch.device("cpu"))
    grow_tree(b, v, fmask, nb, na, workspace=ws, **kw)
    before = [t.clone() for t in (ws.tree, ws.leaf_of_row, ws.table,
                                  ws.hist)]
    shadow = make_shadow_grower(ws)
    assert shadow.ws is not ws and not shadow.independent
    out = shadow.grow(grow_tree, b, v, fmask, nb, na, **kw)
    assert out is shadow.ws.tree
    assert torch.equal(out, ws.tree)
    for t0, t1 in zip(before, (ws.tree, ws.leaf_of_row, ws.table,
                               ws.hist)):
        assert torch.equal(t0, t1)


def test_boundary_check_and_manifest():
    assert _train(rounds=2)._model.integrity_manifest(2) is None
    bst = _train({"integrity_check_freq": 3}, rounds=4)
    m = bst._model
    man = m.integrity_manifest(4)
    assert man == {"verified": False, "checked_iteration": 3, "checks": 2,
                   "transients": 0, "check_freq": 3,
                   "independent_trace": False}
    m.integrity_boundary_check()
    assert _mvals()["integrity.checks{path=boundary}"] == 1
    assert m.integrity_manifest(4)["verified"] is True
    assert m.fetch_counts["integrity_boundary"] == 1
    m.integrity_boundary_check()            # already verified: free
    assert m.fetch_counts["integrity_boundary"] == 1
    # a retained tree that the shadow does not reproduce is sticky
    chk = m._integrity
    it_g, host, run_shadow = chk._pending
    lc = host.leaf_count.copy()
    lc[0] += 1.0
    chk._pending = (it_g, host._replace(leaf_count=lc), run_shadow)
    chk.verified_iteration = 0
    with pytest.raises(integrity.IntegrityFailure) as ei:
        m.integrity_boundary_check()
    assert ei.value.iteration == 4
    assert m.fetch_counts["integrity_boundary"] == 3
