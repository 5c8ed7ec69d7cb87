"""``lightgbm_torch.Booster.predict`` through the predictor engine: the auto
route, the three ``predict_bucketed`` modes, the engine cache's
invalidation at every model mutation, ``pred_leaf`` on both routes and
``pred_early_stop`` on the host walk, against the port's own host walk
and the JAX package's ``Booster.predict`` on the same model text.

Raw scores and leaf ids are held equal exactly.  Converted scores (the
binary sigmoid) are held exactly against the port's host walk (the same
torch op) and to 1e-6 relative against the JAX package, whose ``exp``
comes from another CPU library."""

import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.serve import PredictorEngine

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    host_walk, jax_serve_models, pin_torch_threads, pin_torch_threads_module,
    raw_problem, serve_rows)

CPU = {"device_type": "cpu", "verbosity": -1}
TRANSFORM_RTOL = 1e-6


@pytest.fixture(scope="module")
def trained():
    x, y = raw_problem(51, n=2000, f=6)
    bst = lgt.train({"objective": "binary", "num_leaves": 15, **CPU},
                    lgt.Dataset(x, y), 40)
    return bst, serve_rows(2000, seed=52)


def test_auto_route_engages_at_the_threshold(trained):
    bst, xt = trained
    bst._drop_predict_cache()
    assert bst.config.predict_bucketed == "auto"
    assert bst._ENGINE_AUTO_WORK == 1 << 16
    small = xt[:1000]                       # 1000 x 40 trees < 65,536
    ref_small = host_walk(bst, small)
    np.testing.assert_array_equal(bst.predict(small), ref_small)
    assert bst._engine_cache is None
    got = bst.predict(xt)                   # 2000 x 40 trees >= 65,536
    assert isinstance(bst._engine_cache, PredictorEngine)
    np.testing.assert_array_equal(got, host_walk(bst, xt))
    # once built, the engine serves every size
    assert bst.predict_engine(1) is bst._engine_cache
    np.testing.assert_array_equal(bst.predict(small), ref_small)
    np.testing.assert_array_equal(bst.predict(xt, raw_score=True),
                                  host_walk(bst, xt, raw_score=True))


def test_engine_route_matches_jax(trained):
    bst, xt = trained
    text = bst.model_to_string()
    jb = lgb.Booster(model_str=text)
    port = lgt.Booster(params=CPU, model_str=text)
    got = port.predict(xt, raw_score=True)
    assert isinstance(port._engine_cache, PredictorEngine)
    np.testing.assert_array_equal(
        got, np.asarray(jb.predict(xt, raw_score=True)))
    np.testing.assert_allclose(port.predict(xt), np.asarray(jb.predict(xt)),
                               rtol=TRANSFORM_RTOL)


@pytest.mark.parametrize("mode,engine", [("true", True), ("false", False),
                                         ("auto", False)])
def test_predict_bucketed_modes(trained, mode, engine):
    bst, xt = trained
    text = bst.model_to_string()
    b = lgt.Booster(params={**CPU, "predict_bucketed": mode}, model_str=text)
    assert b.config.predict_bucketed == mode
    out = b.predict(xt[:10])               # 10 x 40 trees: below auto
    assert isinstance(b._engine_cache, PredictorEngine) is engine
    np.testing.assert_array_equal(out, host_walk(b, xt[:10]))


def test_predict_bucketed_true_trains():
    x, y = raw_problem(53, n=600, f=4)
    bst = lgt.train({"objective": "binary", "predict_bucketed": True, **CPU},
                    lgt.Dataset(x, y), 3)
    assert bst.predict_engine() is not None


@pytest.mark.parametrize("kw", [{"start_iteration": 3},
                                {"num_iteration": 5},
                                {"start_iteration": 2, "num_iteration": 4},
                                {"raw_score": True, "num_iteration": 0}])
def test_iteration_slicing_on_the_engine_route(trained, kw):
    bst, xt = trained
    bst.config.predict_bucketed = "true"
    try:
        np.testing.assert_array_equal(bst.predict(xt[:50], **kw),
                                      host_walk(bst, xt[:50], **kw))
    finally:
        bst.config.predict_bucketed = "auto"


def test_cache_dropped_after_update_and_chunk():
    x, y = raw_problem(54, n=800, f=5)
    b = lgt.Booster(params={"objective": "binary", "predict_bucketed": True,
                            **CPU}, train_set=lgt.Dataset(x, y))
    b.update()
    e1 = b.predict_engine()
    assert e1 is not None and len(e1.trees) == 1
    b.update()
    assert b._engine_cache is None
    e2 = b.predict_engine()
    assert e2 is not e1 and len(e2.trees) == 2
    b.update_chunk(3)
    assert b._engine_cache is None
    assert len(b.predict_engine().trees) == 5
    np.testing.assert_array_equal(b.predict(x), host_walk(b, x))


def test_cache_dropped_after_superepoch_and_drop_iterations():
    x, y = raw_problem(55, n=1200, f=5)
    xv, yv = raw_problem(56, n=400, f=5)
    b = lgt.Booster(params={"objective": "binary", "predict_bucketed": True,
                            "metric": "auc", **CPU},
                    train_set=lgt.Dataset(x, y))
    b.add_valid(lgt.Dataset(xv, yv), "valid_0")
    b.update_superepoch(4, 0, b._traced_spec())
    assert b._engine_cache is None
    e = b.predict_engine()
    assert len(e.trees) == 4
    b._model.drop_iterations(2)            # the super-epoch replay's heal
    assert b._engine_cache is None
    assert len(b.predict_engine().trees) == 2
    np.testing.assert_array_equal(b.predict(xv), host_walk(b, xv))


@pytest.mark.parametrize("tag", ["binary", "categorical", "multiclass",
                                 "binary_stump"])
def test_pred_leaf_matches_jax_on_both_routes(tag):
    text, xt = jax_serve_models()[tag]
    jb = lgb.Booster(model_str=text)
    for mode in ("true", "false"):
        b = lgt.Booster(params={**CPU, "predict_bucketed": mode},
                        model_str=text)
        for kw in ({}, {"start_iteration": 2, "num_iteration": 3}):
            got = b.predict(xt, pred_leaf=True, **kw)
            want = np.asarray(jb.predict(xt, pred_leaf=True, **kw))
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tag,margin", [("binary", 0.5),
                                        ("multiclass", 0.02)])
def test_pred_early_stop_matches_jax(tag, margin):
    text, xt = jax_serve_models()[tag]
    jb = lgb.Booster(model_str=text)
    b = lgt.Booster(params={**CPU, "predict_bucketed": "true"},
                    model_str=text)
    kw = {"pred_early_stop": True, "pred_early_stop_freq": 2,
          "pred_early_stop_margin": margin, "raw_score": True}
    got = b.predict(xt, **kw)
    assert b._engine_cache is None         # the host walk served it
    np.testing.assert_array_equal(got, np.asarray(jb.predict(xt, **kw)))
    # early stopping really cut some rows short
    assert not np.array_equal(got, b.predict(xt, raw_score=True))


def test_zero_rows_and_unported_options(trained):
    bst, xt = trained
    f = bst.num_feature()
    assert bst.predict(np.empty((0, f))).shape == (0,)
    assert bst.predict(np.empty((0, f))).dtype == np.float32
    assert bst.predict(np.empty((0, f)), raw_score=True).dtype == np.float64
    leaf = bst.predict(np.empty((0, f)), pred_leaf=True)
    assert leaf.shape == (0, bst.num_trees()) and leaf.dtype == np.int32
    with pytest.raises(lgt.LightGBMError, match="shape_check"):
        bst.predict(np.empty((0, 3)))
    with pytest.raises(NotImplementedError, match="A14"):
        bst.predict(xt[:5], pred_contrib=True)
