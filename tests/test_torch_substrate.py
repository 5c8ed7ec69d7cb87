"""lightgbm_torch host substrate against the JAX package: binning and
Dataset fields, the config table, the model text of the reference
fixtures, the package's import rule and its device rule."""

import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import config as tconfig
from lightgbm_tpu import config as jconfig

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    assert_first_tree_equal, pin_torch_threads, pin_torch_threads_module,
    raw_problem)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "reference"


@pytest.mark.parametrize("max_bin", [15, 31])
def test_dataset_fields_equal(max_bin):
    x, y = raw_problem(0, n=3000, f=10)
    xv, yv = raw_problem(1, n=800, f=10)
    params = {"max_bin": max_bin, "verbosity": -1}
    dt = lgt.Dataset(x, y, params=params).construct()
    dj = lgb.Dataset(x, y, params=params).construct()
    np.testing.assert_array_equal(dt.binned, dj.binned)
    assert dt.used_features == dj.used_features
    for mt, mj in zip(dt.bin_mappers, dj.bin_mappers):
        assert mt.num_bin == mj.num_bin
        assert mt.na_bin == mj.na_bin
        np.testing.assert_array_equal(mt.bin_upper_bound, mj.bin_upper_bound)
    vt = lgt.Dataset(xv, yv, reference=dt).construct()
    vj = lgb.Dataset(xv, yv, reference=dj).construct()
    np.testing.assert_array_equal(vt.binned, vj.binned)


def test_config_table_equal():
    assert tconfig._ALIASES == jconfig._ALIASES
    assert tconfig._OBJECTIVE_ALIASES == jconfig._OBJECTIVE_ALIASES
    assert tconfig._METRIC_ALIASES == jconfig._METRIC_ALIASES
    assert set(tconfig._PARAMS) == set(jconfig._PARAMS)
    differ = {k for k in tconfig._PARAMS
              if tconfig._PARAMS[k] != jconfig._PARAMS[k]}
    assert differ == {"device_type"}
    assert tconfig.Config().device_type == "cuda"
    assert tconfig.Config({"device": "gpu"}).device_type == "cuda"
    assert tconfig.Config({"device_type": "cpu"}).device_type == "cpu"
    with pytest.raises(ValueError):
        tconfig.Config({"device_type": "tpu"})


@pytest.mark.parametrize("params", [
    {"objective": "binary", "num_leaves": 31, "eta": 0.3,
     "min_child_samples": 7, "reg_lambda": 1.5},
    {"objective": "mse", "max_leaves": 15, "subsample_for_bin": 1000},
])
def test_config_aliases_resolve_equal(params):
    ct, cj = tconfig.Config(params), jconfig.Config(params)
    for name in tconfig._PARAMS:
        if name != "device_type":
            assert getattr(ct, name) == getattr(cj, name), name


@pytest.mark.parametrize("stem", ["binary", "regression", "multiclass",
                                  "lambdarank", "xendcg"])
def test_reference_fixture_reserialises(stem):
    path = str(FIXTURES / f"{stem}_model.txt")
    text_t = lgt.Booster(model_file=path).model_to_string()
    text_j = lgb.Booster(model_file=path).model_to_string()
    assert text_t == text_j
    assert lgt.Booster(model_str=text_t).model_to_string() == text_t


def test_fixture_predicts_like_jax():
    path = str(FIXTURES / "binary_model.txt")
    rs = np.random.RandomState(3)
    x = rs.rand(300, 28) * 3.0
    pt = lgt.Booster(model_file=path).predict(x)
    pj = np.asarray(lgb.Booster(model_file=path).predict(x))
    np.testing.assert_allclose(pt, pj, rtol=1e-6)
    np.testing.assert_array_equal(
        lgt.Booster(model_file=path).predict(x, raw_score=True),
        np.asarray(lgb.Booster(model_file=path).predict(x, raw_score=True)))


def _imported_modules(path: pathlib.Path):
    """Every module a source names in an import statement, or in a call
    of ``importlib.import_module``/``__import__`` with a literal name."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_port_imports_no_jax():
    # the package's sources (its gitignored _build directory holds only
    # compiled kernels and is no part of it)
    files = sorted(p for p in (ROOT / "lightgbm_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts) \
        + [ROOT / "chip_smoke.py"] \
        + sorted((ROOT / "tools").glob("torch_*.py"))
    assert len(files) > 15
    # the threefry stream (bagging, GOSS and the node draws) and the
    # growers that key on it are the port's own, not jax.random's
    for mod in ("ops/random.py", "grower.py", "models/fused.py",
                "ops/split.py"):
        assert ROOT / "lightgbm_torch" / mod in files
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
    assert bad == []


def test_exp_tripwire_warns_and_never_fails(monkeypatch):
    """The tripwire that every port test runs after itself
    (``torch_port_fixtures.exp_tripwire``): silent while ``torch.exp``
    gives the session start's bits, a ``PytestWarning`` naming the test
    and the last clean one when it does not."""
    import warnings
    import torch_port_fixtures as tpf
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tpf.exp_tripwire("tests/x.py::clean")
    monkeypatch.setattr(tpf, "_EXP_BITS", [b ^ 1 for b in tpf._EXP_BITS])
    with pytest.warns(pytest.PytestWarning,
                      match="after tests/x.py::dirty, .* last right after "
                            "tests/x.py::clean"):
        tpf.exp_tripwire("tests/x.py::dirty")


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = raw_problem(2, n=500, f=4)
    with pytest.raises(lgt.LightGBMError, match="no CUDA card"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(x, y), 2)


# parameters that select the partitioned learner (ported: they train)
_PARTITIONED = ("monotone_constraints_method", "forcedsplits_filename",
                "tpu_learner")


@pytest.mark.parametrize("params,item", [
    ({"cegb_penalty_split": 1.0, "boosting": "dart"}, "A9"),
    ({"monotone_constraints": [1, 0, 0, 0],
      "monotone_constraints_method": "intermediate"}, "A11"),
    ({"monotone_constraints": [1, 0, 0, 0],
      "monotone_constraints_method": "advanced"}, "A11"),
    ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5}, "A9"),
    ({"forcedsplits_filename": "splits.json"}, "A11"),
    ({"linear_tree": True}, "A9"),
    ({"boosting": "dart"}, "A9"),
    ({"tpu_learner": "partitioned"}, "A11"),
    ({"tree_learner": "data"}, "A16"),
    ({"forcedsplits_filename": "splits.json",
      "monotone_constraints": [1, 0, 0, 0]}, "A11"),
    ({"finite_check_freq": 2}, "A12"),
    ({"telemetry": True}, "A15"),
    ({"integrity_check_freq": 2, "integrity_policy": "rewind"}, "A12"),
    ({"snapshot_freq": 5}, "A12"),
])
def test_unported_parameters_raise(params, item, tmp_path):
    """Each parameter value whose module the port lacks raises, naming its
    ROADMAP item.  The partitioned learner and the controls it serves
    (forced splits, monotone intermediate/advanced; ROADMAP A11, ported)
    train instead, and their first tree is the JAX package's.  A
    distributed learner (ROADMAP A16, ported) on a lone rank, with no
    process group, trains serially: the serial run's trees."""
    x, y = raw_problem(4, n=400, f=4)
    y = np.minimum(y, 1)
    full = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
            **params}
    if item == "A16":
        bt = lgt.train(full, lgt.Dataset(x, y), 2)
        assert bt._model.dist is None
        bs = lgt.train({k: v for k, v in full.items()
                        if k != "tree_learner"}, lgt.Dataset(x, y), 2)
        assert bt.model_to_string().split("end of trees")[0] \
            == bs.model_to_string().split("end of trees")[0]
        return
    if any(k in params for k in _PARTITIONED):
        # 7 leaves: past them this 400-row set's best gains fall to f32
        # rounding noise (about 1e-6 against a root gain of 110), where
        # the two packages' summation orders decide
        full["num_leaves"] = 7
        if "forcedsplits_filename" in full:
            path = tmp_path / full["forcedsplits_filename"]
            path.write_text(json.dumps(
                {"feature": 1, "threshold": 0.0,
                 "left": {"feature": 0, "threshold": 0.3}}))
            full["forcedsplits_filename"] = str(path)
        bt = lgt.train(full, lgt.Dataset(x, y), 2)
        assert bt._model.learner == "partitioned"
        bj = lgb.train({k: v for k, v in full.items() if k != "device_type"},
                       lgb.Dataset(x, label=y), 2)
        assert_first_tree_equal(bt, bj)
        return
    with pytest.raises(NotImplementedError, match=item):
        lgt.train(full, lgt.Dataset(x, y), 2)


def test_categorical_feature_raises():
    """Categorical features no longer raise: training splits on the
    categorical column, writes category bitsets and predicts as the JAX
    package does on the same model text."""
    rs = np.random.RandomState(5)
    x = rs.randint(0, 5, size=(400, 3)).astype(np.float64)
    y = np.isin(x[:, 0], (1, 3)).astype(np.float32)
    bst = lgt.train({"objective": "binary", "verbosity": -1,
                     "device_type": "cpu", "min_data_per_group": 5,
                     "min_data_in_leaf": 5},
                    lgt.Dataset(x, y, categorical_feature=[0]), 2)
    text = bst.model_to_string()
    assert "num_cat=1" in text and "cat_threshold=" in text
    t = bst._model.models[0]
    assert t.split_feature[0] == 0 and int(t.decision_type[0]) & 1
    np.testing.assert_allclose(
        bst.predict(x), np.asarray(lgb.Booster(model_str=text).predict(x)),
        rtol=1e-6)


@pytest.mark.parametrize("sub", ["serve", "fleet", "obs",
                                 "utils/resilience.py", "utils/shapes.py",
                                 "parallel", "integrity.py",
                                 "utils/faultinject.py"])
def test_serving_modules_import_no_jax(sub):
    path = ROOT / "lightgbm_torch" / sub
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files and all(p.is_file() for p in files)
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
    assert bad == []


def test_serving_shapes_equal_jax():
    from lightgbm_torch.utils import shapes as ts
    from lightgbm_tpu.utils import shapes as js
    for n in list(range(0, 70)) + [127, 128, 129, 1000, 65537]:
        assert ts._pow2_floor(n, 16) == js._pow2_floor(n, 16)
        for fn in ("bucket_nodes", "bucket_leaf_slots", "bucket_bins",
                   "bucket_steps", "round_up_pow2"):
            assert getattr(ts, fn)(n) == getattr(js, fn)(n), (fn, n)
        for kw in ({}, {"min_bucket": 1}, {"cap": 64}, {"cap": 100}):
            assert ts.bucket_rows(n, **kw) == js.bucket_rows(n, **kw)


def test_resilience_equal_jax():
    from lightgbm_torch.utils import resilience as tr
    from lightgbm_tpu.utils import resilience as jr
    assert tr._RETRYABLE_PATTERNS == jr._RETRYABLE_PATTERNS
    errors = [RuntimeError("claim hung"), RuntimeError("DEADLINE_EXCEEDED"),
              ValueError("bad"), TypeError("x"), RuntimeError("boom"),
              RuntimeError("CUDA error: an illegal memory access"),
              tr.WatchdogTimeout("sync", 1.0), KeyboardInterrupt()]
    for e in errors:
        assert tr.is_retryable_device_error(e) \
            == jr.is_retryable_device_error(e), e
    for mod in (tr, jr):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("connection reset")
            return "ok"
        assert mod.retry_call(flaky, policy=mod.RetryPolicy(
            max_attempts=3, base_delay_s=0.001, jitter=0.0)) == "ok"
        assert len(calls) == 3
    # the two breakers walk the same states on the same event sequence
    clocks = {"t": 0.0}
    bt = tr.CircuitBreaker(2, 1.0, 4.0, clock=lambda: clocks["t"])
    bj = jr.CircuitBreaker(2, 1.0, 4.0, clock=lambda: clocks["t"])
    for step, ev in enumerate("ffaxfsafxaf"):
        clocks["t"] = 0.7 * step
        for b in (bt, bj):
            {"f": b.record_failure, "s": b.record_success,
             "a": b.allow, "x": b.release_probe}[ev]()
        assert bt.describe() == bj.describe()
    assert tr.Watchdog(5.0, on_timeout="raise").run(lambda: 3) == 3
    with pytest.raises(tr.WatchdogTimeout):
        import time
        tr.Watchdog(0.05, on_timeout="raise").run(time.sleep, 2.0)


def test_atomic_write(tmp_path):
    from lightgbm_torch.utils.resilience import atomic_write
    path = tmp_path / "sub" / "m.txt"
    atomic_write(path, "abc")
    atomic_write(path, "defg")
    assert path.read_text() == "defg"
    assert [p.name for p in path.parent.iterdir()] == ["m.txt"]
