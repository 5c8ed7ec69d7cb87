"""lightgbm_torch host substrate against the JAX package: binning and
Dataset fields, the config table, the model text of the reference
fixtures, the package's import rule and its device rule."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch import config as tconfig
from lightgbm_tpu import config as jconfig

from torch_port_fixtures import raw_problem

torch.set_num_threads(2)

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
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    # the package's sources (its gitignored _build directory holds only
    # compiled kernels and is no part of it)
    files = sorted(p for p in (ROOT / "lightgbm_torch").rglob("*.py")
                   if "_build" not in p.relative_to(ROOT).parts) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]
    assert bad == []


def test_default_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y = raw_problem(2, n=500, f=4)
    with pytest.raises(lgt.LightGBMError, match="no CUDA card"):
        lgt.train({"objective": "binary", "verbosity": -1},
                  lgt.Dataset(x, y), 2)


@pytest.mark.parametrize("params,item", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, "A9"),
    ({"data_sample_strategy": "goss"}, "A9"),
    ({"feature_fraction": 0.5}, "A9"),
    ({"extra_trees": True}, "A9"),
    ({"num_leaves": 64}, "A8"),
    ({"linear_tree": True}, "A9"),
    ({"boosting": "dart"}, "A9"),
    ({"quant_train": True}, "A10"),
    ({"tree_learner": "data"}, "A16"),
    ({"monotone_constraints": [1, 0, 0, 0]}, "A9"),
    ({"objective": "multiclass", "num_class": 3}, "A9"),
    ({"objective": "lambdarank"}, "A9"),
    ({"integrity_check_freq": 2}, "A17"),
    ({"snapshot_freq": 5}, "A12"),
])
def test_unported_parameters_raise(params, item):
    x, y = raw_problem(4, n=400, f=4)
    full = {"objective": "binary", "verbosity": -1, "device_type": "cpu",
            **params}
    with pytest.raises(NotImplementedError, match=item):
        lgt.train(full, lgt.Dataset(x, np.minimum(y, 1)), 2)


def test_categorical_feature_raises():
    rs = np.random.RandomState(5)
    x = rs.randint(0, 5, size=(400, 3)).astype(np.float64)
    y = (x[:, 0] > 2).astype(np.float32)
    with pytest.raises(NotImplementedError, match="categorical"):
        lgt.train({"objective": "binary", "verbosity": -1,
                   "device_type": "cpu"},
                  lgt.Dataset(x, y, categorical_feature=[0]), 2)
