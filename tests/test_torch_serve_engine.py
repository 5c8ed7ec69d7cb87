"""The port's ``serve.engine.PredictorEngine`` against the JAX package's, both
built from the same model text (the serving matrix of
``torch_port_fixtures.jax_serve_models``), the port's on the CPU where its
kernels run as their plain versions.

Held equal exactly: the feature tables, the packed node tables with their
dtypes, ``table_bytes``, the device binning tables, the host f64 binning,
the leaf ids (host-binned and device-binned), the raw scores and the raw
fused scores.  Transformed scores (the binary sigmoid) agree to 1e-6
relative: the two packages take ``exp`` from different CPU libraries
(XLA's and ATen's), which may round the last bit apart; within the port
the transform is the same torch op on both sides of every comparison, and
those comparisons are exact."""

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.serve import engine as tengine
from lightgbm_tpu.serve import engine as jengine

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, jax_serve_models, pin_torch_threads, pin_torch_threads_module,
    serve_rows)

TAGS = ["regression", "binary", "binary_stump", "multiclass", "categorical",
        "stumps"]
TRANSFORM_RTOL = 1e-6


@pytest.fixture(scope="module")
def models():
    return jax_serve_models()


def _pair(models, tag, packed=True):
    text, x = models[tag]
    jb = lgb.Booster(model_str=text)
    tb = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    return (jengine.PredictorEngine.from_booster(jb, packed=packed),
            tengine.PredictorEngine.from_booster(tb, packed=packed), jb, tb,
            x)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tag", TAGS)
def test_tables_equal(models, tag, packed):
    je, te, _, _, x = _pair(models, tag, packed)
    assert len(je.tables) == len(te.tables)
    for a, b in zip(je.tables, te.tables):
        assert (a.kind, a.miss_nan, a.na_bin, a.num_bins) \
            == (b.kind, b.miss_nan, b.na_bin, b.num_bins)
        np.testing.assert_array_equal(a.thresholds, b.thresholds)
        np.testing.assert_array_equal(a.cats, b.cats)
    ja, ta = je._packed_host_arrays(), te._packed_host_arrays()
    assert set(ja) == set(ta)
    for name in ja:
        assert ja[name].dtype == ta[name].dtype, name
        np.testing.assert_array_equal(ja[name], ta[name])
    for name in ("_default_left", "_is_cat_node", "_na_bin", "_leaf_f32",
                 "_w32", "leaf_values"):
        np.testing.assert_array_equal(getattr(je, name), getattr(te, name))
    assert te.table_bytes == je.table_bytes
    assert (te._steps, te._bin_dtype, te._avg_denom, te.fingerprint) \
        == (je._steps, je._bin_dtype, je._avg_denom, je.fingerprint)
    assert te.fused_reason == je.fused_reason
    for a, b in zip(je._device_bin_tables(), te._device_bin_tables()):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the device binning searches these rows, so each must be
    # non-decreasing (+inf padding included)
    thr, _, cat_vals, _ = (t.numpy() for t in te._device_bin_tables())
    for table in (thr, cat_vals):
        assert (table[:, 1:] >= table[:, :-1]).all()
    np.testing.assert_array_equal(te.bin_rows(x), je.bin_rows(x))


@pytest.mark.parametrize("tag", TAGS)
def test_leaf_ids_and_scores_equal(models, tag):
    je, te, jb, tb, x = _pair(models, tag)
    for dbin in (False, True):
        np.testing.assert_array_equal(te.leaf_ids(x, device_binning=dbin),
                                      je.leaf_ids(x, device_binning=dbin))
    raw_t, raw_j = te.raw_scores(x), je.raw_scores(x)
    assert raw_t.dtype == raw_j.dtype == np.float64
    np.testing.assert_array_equal(raw_t, raw_j)
    np.testing.assert_array_equal(te.predict(x, raw_score=True),
                                  je.predict(x, raw_score=True))
    # the port's engine equals the port's host walk exactly
    np.testing.assert_array_equal(te.predict(x, raw_score=True),
                                  host_walk(tb, x, raw_score=True))
    pt, pj = te.predict(x), np.asarray(je.predict(x))
    assert pt.dtype == pj.dtype
    np.testing.assert_allclose(pt, pj, rtol=TRANSFORM_RTOL)


@pytest.mark.parametrize("tag", TAGS)
def test_fused_predict_against_jax_and_reference(models, tag):
    je, te, _, _, x = _pair(models, tag)
    mask = te._f32_consensus_mask(x)
    np.testing.assert_array_equal(mask, je._f32_consensus_mask(x))
    assert mask.any()
    raw_t = te.fused_predict(x, raw_score=True)
    np.testing.assert_array_equal(raw_t, je.fused_predict(x, raw_score=True))
    np.testing.assert_array_equal(raw_t[mask],
                                  te._fused_reference(x[mask],
                                                      raw_score=True))
    got = te.fused_predict(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[mask], te._fused_reference(x[mask]))
    np.testing.assert_allclose(got, np.asarray(je.fused_predict(x)),
                               rtol=TRANSFORM_RTOL)


@pytest.mark.parametrize("tag", TAGS)
def test_self_check_passes(models, tag):
    _, te, _, _, _ = _pair(models, tag)
    assert te.self_check() is True
    assert te.self_check(device_binning=True) is True


def test_self_check_catches_corrupt_tables(models):
    _, te, _, _, _ = _pair(models, "binary")
    te._dev["threshold_bin"] = te._dev["threshold_bin"] + 1
    assert te.self_check() is False


def test_linear_tree_model_has_its_fused_reason():
    x = serve_rows(400, seed=23, nan_frac=0.0)
    jb = lgb.train({"objective": "regression", "linear_tree": True,
                    "verbosity": -1, "num_leaves": 8},
                   lgb.Dataset(x, label=x[:, 0]), num_boost_round=4)
    text = jb.model_to_string()
    te = tengine.PredictorEngine.from_booster(
        lgt.Booster(params={"device_type": "cpu"}, model_str=text))
    je = jengine.PredictorEngine.from_booster(lgb.Booster(model_str=text))
    assert not te.fused_ok and "linear" in te.fused_reason
    assert te.fused_reason == je.fused_reason
    with pytest.raises(tengine.EngineUnsupported):
        te.fused_predict(x[:4])
    # the host-binned route still serves linear leaves exactly
    xt = serve_rows(30, seed=24, nan_frac=0.0)
    np.testing.assert_array_equal(te.predict(xt), np.asarray(je.predict(xt)))


def test_zero_rows_cost_no_launch(models, monkeypatch):
    _, te, _, tb, x = _pair(models, "binary")
    calls = []
    for name in ("traverse_forest_binned", "fused_forest_predict",
                 "bin_rows_device_full"):
        real = getattr(tengine, name)
        monkeypatch.setattr(tengine, name,
                            lambda *a, _r=real, _n=name, **k:
                            (calls.append(_n), _r(*a, **k))[1])
    empty = np.empty((0, x.shape[1]))
    assert te.leaf_ids(empty).shape == (0, len(te.trees))
    assert te.leaf_ids(empty, device_binning=True).shape == (0,
                                                             len(te.trees))
    assert te.fused_predict(empty).shape == (0,)
    assert te.predict(empty).shape == (0,)
    assert tb.predict(empty, pred_leaf=True).shape == (0, len(tb.trees))
    assert calls == []
    te.leaf_ids(x[:3])
    assert calls == ["traverse_forest_binned"]


def test_buckets_are_bounded_powers_of_two(models):
    _, te, _, _, _ = _pair(models, "regression")
    eng = tengine.PredictorEngine(te.trees, te.tree_weights, 1,
                                  te.num_features, max_batch=64,
                                  device_type="cpu")
    rs = np.random.RandomState(0)
    for n in rs.randint(1, 200, 30):
        eng.leaf_ids(serve_rows(int(n), seed=int(n)))
    stats = eng.compile_stats()
    assert stats["max_shapes_bound"] == 7
    assert len(stats["buckets"]) <= stats["max_shapes_bound"]
    assert all(b & (b - 1) == 0 and 16 <= b <= 64 for b in stats["buckets"])
    assert set(stats["launches_process"]) == {"forest_walk", "bin_rows",
                                              "fused_predict"}


def test_packed_vs_int32_equivalence(models):
    _, packed, _, _, x = _pair(models, "categorical", packed=True)
    _, plain, _, _, _ = _pair(models, "categorical", packed=False)
    assert plain.compile_stats()["threshold_dtype"] == "int32"
    assert packed.compile_stats()["threshold_dtype"] == "uint8"
    np.testing.assert_array_equal(packed.leaf_ids(x), plain.leaf_ids(x))
    np.testing.assert_array_equal(packed.fused_predict(x),
                                  plain.fused_predict(x))
    np.testing.assert_array_equal(packed.predict(x), plain.predict(x))
    assert packed.table_bytes < plain.table_bytes


def test_uint16_tables_match_jax():
    rs = np.random.RandomState(34)
    x = rs.randn(1500, 2)
    y = x[:, 0] + np.sin(3 * x[:, 0]) + 0.1 * x[:, 1]
    jb = lgb.train({"objective": "regression", "num_leaves": 31,
                    "max_bin": 1023, "min_data_in_leaf": 5,
                    "verbosity": -1},
                   lgb.Dataset(x, label=y), num_boost_round=60)
    text = jb.model_to_string()
    te = tengine.PredictorEngine.from_booster(
        lgt.Booster(params={"device_type": "cpu"}, model_str=text))
    je = jengine.PredictorEngine.from_booster(lgb.Booster(model_str=text))
    assert max(t.num_bins for t in te.tables) > 255
    assert te.compile_stats()["threshold_dtype"] == "uint16"
    assert te._dev["threshold_bin"].dtype == torch.int16
    xt = np.concatenate([rs.randn(60, 2), x[:20]])
    np.testing.assert_array_equal(te.leaf_ids(xt), je.leaf_ids(xt))
    np.testing.assert_array_equal(te.fused_predict(xt, raw_score=True),
                                  je.fused_predict(xt, raw_score=True))


def test_device_follows_device_type(models, monkeypatch):
    text, _ = models["binary"]
    tb = lgt.Booster(params={"device_type": "cpu"}, model_str=text)
    assert tengine.PredictorEngine.from_booster(tb).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(lgt.LightGBMError, match="no CUDA card"):
        tengine.PredictorEngine.from_booster(tb, device_type="cuda")
    with pytest.raises(lgt.LightGBMError, match="no CUDA card"):
        tengine.PredictorEngine.from_booster(lgt.Booster(model_str=text))


def test_per_row_flops_bytes_names_its_item(models):
    _, te, _, _, _ = _pair(models, "binary")
    with pytest.raises(NotImplementedError, match="A15"):
        te.per_row_flops_bytes()
