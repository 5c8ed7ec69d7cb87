"""Fleet training in the port (``lightgbm_torch.fleet``) on the CPU.

The port's fleet is held to its own contract: every member's model is
byte-identical to a solo ``lightgbm_torch.train`` with that member's
params.  The JAX package's ``fleet_train`` is not the oracle for f32
members: its members diverge from their solo runs at Tree 0 for
``bagging_replicas``, ``lr_leaves_sweep_es`` and ``goss_grid`` and in its
ragged early stop (``tests/test_fleet.py``, ROADMAP C).  So:

- ``parse_sweep`` and ``expand_members`` equal the JAX package's on a
  table of specs, with the same exception type on bad entries;
- the port accepts and refuses the same rosters as the JAX
  ``fleet_train``, and refuses snapshots and resume (ROADMAP A12);
- for each roster of the JAX ``MATRIX`` and the ragged early stop, every
  member's ``model_to_string()`` and ``best_iteration`` equal a solo port
  ``train`` with ``fr.member_params[j]``;
- the ``quant_int8`` members equal the JAX ``fleet_train``'s (the roster
  on which the JAX fleet matches its solo runs): every tree's structure
  equal, raw predictions within ``PRED_RTOL`` (exact int32 histograms in
  both packages; the split scan's f32 prefix sums round otherwise);
- each f32 member's first tree is held to the JAX solo ``lgb.train``
  (``tpu_learner="masked"``) on a fixture with well-separated gains, as
  the sampling tests hold solo runs: its structure at 31 leaves (the
  first 30 splits of a 63-leaf tree, whose deep splits tie);
- one ``"fleet_fetch"`` an epoch and no solo ``"epoch"`` fetch;
- the plain member forms (B1-M, B1-K-M, B1-int-M, B3-M, B3-K-M, B4-M)
  equal N solo plain calls bit for bit, with one member on a dead step;
- a fresh interpreter that imports every module of ``lightgbm_torch``,
  ``chip_smoke.py`` and the port's tools loads none of ``jax``,
  ``jaxlib`` or ``lightgbm_tpu`` (their sources are checked by
  ``tests/test_torch_substrate.py``).
"""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.fleet import (FleetResult, expand_members, fleet_train,
                                  parse_sweep)
from lightgbm_tpu.fleet import expand_members as jax_expand_members
from lightgbm_tpu.fleet import fleet_train as jax_fleet_train
from lightgbm_tpu.fleet import parse_sweep as jax_parse_sweep

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module, raw_problem)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package's fleet test configuration (tests/test_fleet.py:38-42)
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
        "max_bin": 31, "min_data_in_leaf": 5, "verbosity": -1,
        "deterministic": True, "superepoch": 8, "fused_eval": True,
        "fused_chunk": 8, "metric": ["binary_logloss"],
        "padded_leaves": True, "split_batch": 1, "tpu_learner": "masked"}
CPU = {"device_type": "cpu"}
# the JAX package's roster matrix (tests/test_fleet.py:124-138)
MATRIX = {
    "bagging_replicas": (
        {"bagging_fraction": 0.7, "bagging_freq": 1, "fleet_members": 2},
        None),
    "lr_leaves_sweep_es": (
        {"fleet_sweep": "learning_rate=0.05|0.1;num_leaves=31|63",
         "early_stopping_round": 5},
        None),
    "goss_grid": (
        {"data_sample_strategy": "goss"},
        [{"bagging_seed": 3}, {"bagging_seed": 11}]),
    "quant_int8": (
        {"quant_train": True, "quant_bits": 8, "fleet_members": 2},
        None),
}
STRUCTURAL = ("num_leaves", "split_feature", "threshold", "decision_type",
              "left_child", "right_child", "leaf_count", "internal_count")
# raw predictions of the quantized members against the JAX fleet's: the
# same int32 histograms, dequantized and scanned in f32 in another order
# (tests/test_torch_quant_train.py's PRED_RTOL)
PRED_RTOL = 1e-5


def _data(n=1200, f=10, seed=7):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, f).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + 0.4 * x[:, 2] * x[:, 3]
         + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return x, y


def _sets(mod, x, y, params, n_train=1000):
    ds = mod.Dataset(x[:n_train], label=y[:n_train], params=params)
    va = mod.Dataset(x[n_train:], label=y[n_train:], params=params,
                     reference=ds)
    return ds, va


def _trees(text):
    return text.split("end of trees")[0].split("Tree=")[1:]


def _structure(tree_text):
    return [ln for ln in tree_text.splitlines()
            if ln.split("=")[0] in STRUCTURAL]


def _field(tree_text, name):
    return dict(ln.split("=", 1) for ln in tree_text.splitlines()
                if "=" in ln)[name].split()


def _port_fleet(params, members=None, rounds=16):
    x, y = _data()
    p = dict(params, **CPU)
    ds, va = _sets(lgt, x, y, p)
    return fleet_train(dict(p), ds, num_boost_round=rounds,
                       valid_sets=[va], members=members)


def _assert_members_match_solo(fr, rounds):
    x, y = _data()
    assert isinstance(fr, FleetResult) and len(fr) >= 2
    assert fr.epochs >= 1, "the fleet epoch path must engage"
    for j in range(len(fr)):
        ds, va = _sets(lgt, x, y, fr.member_params[j])
        sb = lgt.train(dict(fr.member_params[j]), ds, num_boost_round=rounds,
                       valid_sets=[va])
        assert fr[j].model_to_string() == sb.model_to_string(), \
            f"member {j} diverged from its solo run"
        assert fr[j].best_iteration == sb.best_iteration


# --- roster expansion -----------------------------------------------------

SWEEPS = ["learning_rate=0.05|0.1;num_leaves=31|63", "eta=0.2", "", " ; ",
          "seed=1|2|3", "bagging_seed=3|11;feature_fraction_seed=1",
          "shrinkage_rate=0.3|0.4;num_leaf=15", "output_model=a.txt|b.txt",
          "max_bin=31|63", "not_a_param=1|2", "learning_rate",
          "num_leaves=abc"]


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:      # noqa: BLE001 - the type is the result
        return ("raises", type(e))


@pytest.mark.parametrize("spec", SWEEPS)
def test_parse_sweep_equals_jax(spec):
    assert _outcome(parse_sweep, spec) == _outcome(jax_parse_sweep, spec)


EXPANSIONS = {
    "members_win": ({"fleet_members": 3,
                     "fleet_sweep": "learning_rate=0.05|0.1"},
                    [{"seed": 1}, {"seed": 2}]),
    "sweep_wins": ({"fleet_members": 3,
                    "fleet_sweep": "learning_rate=0.05|0.1"}, None),
    "replicas": ({"fleet_members": 3, "seed": 4, "bagging_seed": 9}, None),
    "aliases": ({"fleet_members": 2}, [{"eta": 0.3, "num_leaf": 31},
                                       {"random_seed": 5}]),
    "explicit_output": ({}, [{"output_model": "x.txt"}, {"seed": 1}]),
    "none": ({}, None),
    "bad_member": ({"fleet_members": 2}, [{"max_depth": 3}]),
}


@pytest.mark.parametrize("case", sorted(EXPANSIONS))
def test_expand_members_equals_jax(case):
    params, members = EXPANSIONS[case]
    p = dict(BASE, **{"output_model": "m.txt", **params})
    assert _outcome(expand_members, p, members) == \
        _outcome(jax_expand_members, p, members)


# --- the rosters accepted and refused --------------------------------------

def _cegb():
    return dict(BASE, fleet_members=2, cegb_penalty_split=1e-3)


ROSTERS = {
    # 31 and 63 leaves pad to one leaf budget (64): one epoch shape
    "leaves_31_63": (lambda: BASE, [{"num_leaves": 31},
                                    {"num_leaves": 63}], {}),
    # 15 is not padded (64 > 4 x 15), 31 is: two epoch shapes
    "leaves_15_31": (lambda: BASE, [{"num_leaves": 15},
                                    {"num_leaves": 31}], {}),
    "one_member": (lambda: BASE, [{"seed": 1}], {}),
    "not_member_axis": (lambda: BASE, [{"seed": 1}, {"max_depth": 3}], {}),
    "non_uniform": (lambda: dict(BASE, fleet_members=2), None,
                    {"members_differ": True}),
    "cegb": (_cegb, None, {}),
    "train_in_valid": (lambda: dict(BASE, fleet_members=2), None,
                       {"train_valid": True}),
    "callbacks_list": (lambda: dict(BASE, fleet_members=2), None,
                       {"callbacks": "list"}),
    "plan_mismatch": (lambda: dict(BASE, fleet_members=2), None,
                      {"callbacks": "mismatch"}),
}


def _roster_outcome(mod, ft, name):
    params_fn, members, opts = ROSTERS[name]
    x, y = _data(n=400)
    p = dict(params_fn())
    if mod is lgt:
        p.update(CPU)
    ds, va = _sets(mod, x, y, p, n_train=300)
    valid = [ds] if opts.get("train_valid") else [va]
    cbs = None
    if opts.get("callbacks") == "list":
        cbs = [mod.record_evaluation({})]
    elif opts.get("callbacks") == "mismatch":
        def cbs(j):
            return [mod.early_stopping(3)] if j else []
    if opts.get("members_differ"):
        members = [{"seed": 1}, {"seed": 2, "lambda_l2": 1.0}]
    try:
        fr = ft(p, ds, num_boost_round=4, valid_sets=valid,
                callbacks=cbs, members=members)
    except (ValueError, NotImplementedError) as e:
        return "refused", type(e)
    return "accepted", len(fr)


@pytest.mark.parametrize("name", sorted(ROSTERS))
def test_rosters_accepted_and_refused_as_jax(name):
    ours = _roster_outcome(lgt, fleet_train, name)
    theirs = _roster_outcome(lgb, jax_fleet_train, name)
    assert ours == theirs


@pytest.mark.parametrize("extra", [{"snapshot_freq": 8}, {"resume": True},
                                   {"auto_resume": True}])
def test_snapshots_and_resume_refused_naming_a12(extra):
    x, y = _data(n=400)
    p = dict(BASE, fleet_members=2, output_model="m.txt", **CPU, **extra)
    ds, va = _sets(lgt, x, y, p, n_train=300)
    with pytest.raises(NotImplementedError, match="A12"):
        fleet_train(p, ds, num_boost_round=4, valid_sets=[va])


# --- byte identity with solo port runs ---------------------------------------

@pytest.mark.parametrize("name", list(MATRIX))
def test_fleet_members_equal_solo_port(name):
    extra, members = MATRIX[name]
    fr = _port_fleet(dict(BASE, **extra), members=members)
    _assert_members_match_solo(fr, 16)


def test_early_stop_members_equal_solo_port():
    # the JAX package's early-stop roster (tests/test_fleet.py:146-157):
    # aggressive lr + tight patience
    p = dict(BASE, fleet_members=2, early_stopping_round=3,
             learning_rate=0.5, num_leaves=31)
    fr = _port_fleet(p, rounds=40)
    _assert_members_match_solo(fr, 40)
    assert any(fr.stopped)


def test_ragged_early_stop_members_equal_solo_port():
    # three learning rates stop at three rounds: member 2 leaves the fleet
    # in its first epoch and rides its lane dead while 0 and 1 train on,
    # member 1 leaves in the second, and member 0 finishes solo
    p = dict(BASE, fleet_sweep="learning_rate=0.2|0.5|0.8",
             early_stopping_round=3)
    fr = _port_fleet(p, rounds=24)
    _assert_members_match_solo(fr, 24)
    assert fr.epochs == 2 and all(fr.stopped)
    assert [b.current_iteration for b in fr.boosters] == [24, 10, 6]
    assert fr[0]._model.fetch_counts == {"fleet_fetch": 2, "epoch": 1}


def test_quant_members_equal_jax_fleet():
    extra, members = MATRIX["quant_int8"]
    x, y = _data()
    p = dict(BASE, **extra)
    ds, va = _sets(lgb, x, y, p)
    fj = jax_fleet_train(dict(p), ds, num_boost_round=16, valid_sets=[va],
                         members=members)
    ft = _port_fleet(p, members=members)
    assert len(fj) == len(ft) == 2
    for j in range(2):
        tj, tt = _trees(fj[j].model_to_string()), \
            _trees(ft[j].model_to_string())
        assert len(tj) == len(tt) == 16
        assert [_structure(t) for t in tt] == [_structure(t) for t in tj]
        pj = np.asarray(fj[j].predict(x, raw_score=True))
        np.testing.assert_allclose(ft[j].predict(x, raw_score=True), pj,
                                   rtol=PRED_RTOL,
                                   atol=PRED_RTOL * np.abs(pj).max())


# each f32 roster's members against the JAX solo run's first tree, on a
# fixture whose gains are well separated (tests/test_torch_train_sampling.py)
F32_ROSTERS = {"bagging_replicas": {"bagging_fraction": 0.7,
                                    "bagging_freq": 1, "fleet_members": 2},
               "lr_leaves_sweep": {"fleet_sweep":
                                   "learning_rate=0.05|0.1;"
                                   "num_leaves=31|63"},
               "goss": {"data_sample_strategy": "goss",
                        "fleet_members": 2}}
SEPARATED = {"objective": "binary", "num_leaves": 31, "learning_rate": 0.3,
             "min_data_in_leaf": 20, "metric": ["binary_logloss"],
             "verbosity": -1, "max_bin": 31, "tpu_learner": "masked",
             "superepoch": 4, "fused_chunk": 4, "fused_eval": True}


@pytest.mark.parametrize("name", sorted(F32_ROSTERS))
def test_f32_members_first_tree_equals_jax_solo(name):
    x, y = raw_problem(61, n=6000, f=6, task="binary", nan_frac=0.0)
    xv, yv = raw_problem(62, n=1500, f=6, task="binary", nan_frac=0.0)
    p = dict(SEPARATED, **F32_ROSTERS[name], **CPU)
    tr = lgt.Dataset(x, y, params=p)
    fr = fleet_train(dict(p), tr, 4,
                     valid_sets=[lgt.Dataset(xv, yv, reference=tr,
                                             params=p)])
    for j in range(len(fr)):
        mp = {k: v for k, v in fr.member_params[j].items()
              if k != "device_type"}
        trj = lgb.Dataset(x, y, params=mp)
        bj = lgb.train(mp, trj, 1, valid_sets=[
            lgb.Dataset(xv, yv, reference=trj, params=mp)])
        a = _trees(bj.model_to_string())[0]
        b = _trees(fr[j].model_to_string())[0]
        if mp["num_leaves"] == 31:
            assert _structure(a) == _structure(b), f"member {j}"
        else:
            for fld in ("split_feature", "threshold"):
                assert _field(a, fld)[:30] == _field(b, fld)[:30], \
                    f"member {j}"


def test_one_fleet_fetch_an_epoch():
    fr = _port_fleet(dict(BASE, fleet_members=2))
    # 16 rounds at k = 8: two fleet epochs, two fetches on member 0 that
    # carry every member's rows; no member fetched a solo epoch
    assert fr.epochs == 2
    assert fr[0]._model.fetch_counts == {"fleet_fetch": 2}
    assert fr[1]._model.fetch_counts == {}
    assert fr.epoch_ms == []        # CUDA events only on the card


def test_members_share_one_copy_of_the_shared_operands():
    fr = _port_fleet(dict(BASE, fleet_members=3), rounds=8)
    m0 = fr[0]._model
    for b in fr.boosters[1:]:
        m = b._model
        assert m.binned_dev is m0.binned_dev
        assert m.num_bin_dev is m0.num_bin_dev
        assert m.na_bin_dev is m0.na_bin_dev
        assert m.valid_sets[0][1] is m0.valid_sets[0][1]
        assert m.valid_ops(0)[0] is m0.valid_ops(0)[0]
        assert m.objective.label is m0.objective.label
        assert m.score is not m0.score
        assert m.valid_sets[0][2] is not m0.valid_sets[0][2]


# --- the plain member forms against N solo plain calls ------------------------

def _member_inputs(seed=3, n=900, f=7, B=15, M=3):
    rs = np.random.RandomState(seed)
    binned = torch.as_tensor(rs.randint(0, B, (n, f)).astype(np.uint8))
    vals = [torch.as_tensor(rs.randn(n, 3).astype(np.float32))
            for _ in range(M)]
    qvals = [torch.as_tensor(rs.randint(-127, 128, (n, 3)).astype(np.int8))
             for _ in range(M)]
    slots = [torch.as_tensor(np.where(rs.rand(n) < 0.4, 0, -1)
                             .astype(np.int32)) for _ in range(M)]
    kslots = [torch.as_tensor(rs.randint(-1, 4, n).astype(np.int32))
              for _ in range(M)]
    # member 1 is on a dead step
    actives = [torch.tensor([int(j != 1)], dtype=torch.int32)
               for j in range(M)]
    return binned, vals, qvals, slots, kslots, actives


@pytest.mark.parametrize("form", ["B1-M", "B1-K-M", "B1-int-M",
                                  "B1-K-int-M"])
def test_plain_histogram_members_equal_solo_plain(form):
    from lightgbm_torch.ops.histogram import (compute_histogram,
                                              compute_histogram_members)
    binned, vals, qvals, slots, kslots, actives = _member_inputs()
    vs = qvals if "int" in form else vals
    kw = {"num_bins": 15}
    ss = slots
    used = None
    if "-K-" in form:
        ss, kw["num_slots"] = kslots, 4
        used = [torch.tensor([4], dtype=torch.int32)] * len(vs)
    out = compute_histogram_members(binned, vs, slots=ss, actives=actives,
                                    slots_used=used, **kw)
    assert out.shape[0] == len(vs)
    for j in range(len(vs)):
        solo = compute_histogram(binned, vs[j], slot=ss[j],
                                 active=actives[j],
                                 slots_used=None if used is None
                                 else used[j], **kw)
        assert torch.equal(out[j], solo), j
    # the dead member's pass is the solo plain version's empty one
    assert not bool(out[1].any())


def test_plain_partition_members_equal_solo_plain():
    from lightgbm_torch.grower import (STEP_RECORD, BatchedStep, partition,
                                       partition_members, partition_slots,
                                       partition_slots_members)
    binned, *_ = _member_inputs()
    n, M, K, L = binned.shape[0], 3, 4, 15
    rs = np.random.RandomState(9)
    rank = torch.arange(15, dtype=torch.int32)
    lor0 = [torch.as_tensor(rs.randint(0, 8, n).astype(np.int32))
            for _ in range(M)]
    recs = [torch.tensor([j, 8 + j, j + 1, 5 + j, j % 2, -1, j,
                          int(j != 1)], dtype=torch.int32)
            for j in range(M)]
    lm = [t.clone() for t in lor0]
    slot = partition_members(binned, lm, recs, [rank] * M)
    for j in range(M):
        ls = lor0[j].clone()
        solo = partition(binned, ls, recs[j], rank)
        assert torch.equal(lm[j], ls)
        if j != 1:
            assert torch.equal(slot[j], solo)
    assert torch.equal(lm[1], lor0[1])
    steps = []
    for j in range(M):
        sol = torch.full((L,), -1, dtype=torch.int32)
        rk = torch.zeros((K, STEP_RECORD), dtype=torch.int32)
        for k in range(K):
            leaf = (2 * k + j) % 8
            sol[leaf] = k
            rk[k] = torch.tensor([leaf, 8 + k, (k + j) % 7, 3 + k, k % 2,
                                  -1, leaf, 1])
        steps.append(BatchedStep(
            recs=rk, slot_of_leaf=sol,
            idx2=torch.zeros(2 * K, dtype=torch.int64),
            tot2=torch.zeros((2 * K, 3)), po2=torch.zeros(2 * K),
            small_left=torch.zeros(K, dtype=torch.bool),
            keep2=torch.zeros(2 * K, dtype=torch.bool),
            status=torch.tensor([int(j != 1), K * int(j != 1)],
                                dtype=torch.int32)))
    lm = [t.clone() for t in lor0]
    tslot = partition_slots_members(binned, lm, steps, [rank] * M)
    for j in range(M):
        ls = lor0[j].clone()
        solo = partition_slots(binned, ls, steps[j], rank)
        assert torch.equal(lm[j], ls) and torch.equal(tslot[j], solo)
    assert torch.equal(lm[1], lor0[1])


def test_plain_tree_score_members_equal_solo_plain():
    from lightgbm_torch.grower import GrowWorkspace, grow_tree
    from lightgbm_torch.ops.split import SplitParams
    from lightgbm_torch.predict_device import (add_tree_score,
                                               add_tree_score_members)
    binned, vals, *_ = _member_inputs()
    n, f = binned.shape
    nb = torch.full((f,), 15, dtype=torch.int32)
    na = torch.full((f,), -1, dtype=torch.int32)
    trees, lvs = [], []
    for j, leaves in enumerate((7, 15, 4)):
        ws = GrowWorkspace(n, f, 15, leaves, torch.device("cpu"))
        grow_tree(binned, vals[j], torch.ones(f, dtype=torch.bool), nb, na,
                  num_leaves=leaves, num_bins=15,
                  params=SplitParams(min_data_in_leaf=10), workspace=ws)
        trees.append(ws.fields)
        lvs.append(ws.fields["leaf_value"] * 0.1)
    rs = np.random.RandomState(4)
    score0 = [torch.as_tensor(rs.randn(n).astype(np.float32))
              for _ in range(3)]
    steps = [8, 16, 4]
    sm = [s.clone() for s in score0]
    add_tree_score_members(sm, binned, trees, na, lvs, 1.0, steps=steps)
    for j in range(3):
        ss = score0[j].clone()
        t = trees[j]
        add_tree_score(ss, binned, t["split_feature"], t["threshold_bin"],
                       t["default_left"], t["left_child"], t["right_child"],
                       na, lvs[j], 1.0, steps=steps[j])
        assert torch.equal(sm[j], ss), j


def test_lockstep_mixed_budgets_equal_solo_growers():
    """The lockstep grower with leaf budgets 7, 15 and 4: the largest
    budget's steps run, the smaller members' extra steps are dead, and
    every member's tree and rows equal its solo grower's."""
    from lightgbm_torch.grower import (GrowMember, GrowWorkspace, grow_tree,
                                       grow_trees_lockstep)
    from lightgbm_torch.ops.split import SplitParams
    binned, vals, *_ = _member_inputs()
    n, f = binned.shape
    nb = torch.full((f,), 15, dtype=torch.int32)
    na = torch.full((f,), -1, dtype=torch.int32)
    fm = torch.ones(f, dtype=torch.bool)
    prm = SplitParams(min_data_in_leaf=10)
    cpu = torch.device("cpu")
    budgets = (7, 15, 4)
    wss = [GrowWorkspace(n, f, 15, L, cpu) for L in budgets]
    arrays = grow_trees_lockstep(
        binned, [GrowMember(ws, v, fm, prm) for ws, v in zip(wss, vals)],
        nb, na)
    for j, L in enumerate(budgets):
        ws = GrowWorkspace(n, f, 15, L, cpu)
        grow_tree(binned, vals[j], fm, nb, na, num_leaves=L, num_bins=15,
                  params=prm, workspace=ws)
        assert torch.equal(wss[j].tree, ws.tree), j
        assert torch.equal(arrays[j].leaf_of_row, ws.leaf_of_row), j


# --- no JAX in the port -------------------------------------------------------
# (each module's source: tests/test_torch_substrate.py
# test_port_imports_no_jax)

def test_importing_the_whole_port_loads_no_jax():
    """A fresh interpreter imports every module of ``lightgbm_torch``,
    ``chip_smoke`` and the port's tools; none of ``jax``, ``jaxlib`` or
    ``lightgbm_tpu`` may be loaded."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (ROOT / "lightgbm_torch").rglob("*.py")
        if "_build" not in p.relative_to(ROOT).parts)
    mods += ["chip_smoke"] + sorted(
        f"tools.{p.stem}" for p in (ROOT / "tools").glob("torch_*.py"))
    forbidden = ("jax", "jaxlib", "lightgbm_tpu")
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{forbidden!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
