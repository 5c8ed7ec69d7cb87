"""B10 serving forest functions: the port's plain versions against the JAX
package's ``traverse_forest_binned`` (B10a), ``bin_rows_device_full``
(B10b) and the raw part of ``fused_forest_predict`` (B10c,
``transform=None``), on the same tables and rows.

The tables come from the JAX package's ``PredictorEngine`` over JAX-trained
models (regression with NaNs, binary, binary with a stump, 3-class, a
categorical feature, stumps only), packed and int32; the rows carry NaNs,
exact threshold ties, out-of-range values, and unseen, negative and NaN
categories.  Leaf ids and bins are integer work and must be equal.  Raw
fused scores must be bitwise equal: both sides multiply each f32 leaf
value by its f32 tree weight and then add the products per class in tree
order, two IEEE roundings each (the JAX program keeps them apart with an
optimization barrier), then divide by ``avg_denom``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_torch import predict_device as pd
from lightgbm_tpu.predict_device import bin_rows_device, bin_rows_device_full
from lightgbm_tpu.serve import engine as jengine

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    jax_serve_models, pin_torch_threads, pin_torch_threads_module)

TAGS = ["regression", "binary", "binary_stump", "multiclass", "categorical",
        "stumps"]


@pytest.fixture(scope="module")
def models():
    return jax_serve_models()


def _engine(models, tag, packed=True):
    text, x = models[tag]
    bst = lgb.Booster(model_str=text)
    eng = jengine.PredictorEngine.from_booster(bst, packed=packed)
    return eng, bst, x


def _t(a):
    """A numpy table as the port's tensor (uint16 as int16 bits)."""
    a = np.array(a)             # a writable copy
    if a.dtype == np.uint16:
        a = a.view(np.int16)
    return torch.from_numpy(a)


def _node_tables(eng):
    """(JAX arrays, port tensors) of the node tables, in the argument
    order of traverse_forest_binned after ``binned``."""
    arrs = eng._packed_host_arrays()
    order = [arrs["split_feature"], arrs["threshold_bin"], eng._default_left,
             arrs["left_child"], arrs["right_child"], eng._na_bin,
             eng._is_cat_node, arrs["cat_index"], arrs["cat_table"]]
    return [jnp.asarray(a) for a in order], [_t(a) for a in order]


def test_models_cover_the_cases(models):
    cat = _engine(models, "categorical")[0]
    assert any(t.kind == "cat" for t in cat.tables)
    assert cat._is_cat_node.any()
    stump = _engine(models, "binary_stump")[0]
    assert (stump._threshold_bin[:, 0] == jengine._ALWAYS_LEFT).sum() == 1
    assert _engine(models, "multiclass")[0].num_class == 3
    assert any(t.miss_nan for t in _engine(models, "regression")[0].tables)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tag", TAGS)
def test_forest_walk_matches_jax(models, tag, packed):
    eng, _, x = _engine(models, tag, packed)
    binned = eng.bin_rows(x).astype(eng._bin_dtype)
    jt, tt = _node_tables(eng)
    want = np.asarray(jengine._traverse_jit()(jnp.asarray(binned), *jt,
                                              steps=eng._steps))
    got = pd.traverse_forest_binned(_t(binned), *tt, steps=eng._steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the leaves of the host tree walk
    host = np.stack([t.predict_leaf(x) for t in eng.trees], axis=1)
    np.testing.assert_array_equal(got.numpy(), host)


@pytest.mark.parametrize("tag", TAGS)
def test_bin_rows_matches_jax(models, tag):
    eng, _, x = _engine(models, tag)
    thr, zero_bin, cat_vals, cat_len = (np.asarray(a) for a in
                                        eng._device_bin_tables())
    na_bin = eng._na_bin
    xf = x.astype(np.float32)
    want = np.asarray(bin_rows_device_full(
        jnp.asarray(xf), jnp.asarray(thr), jnp.asarray(na_bin),
        jnp.asarray(zero_bin), jnp.asarray(cat_vals), jnp.asarray(cat_len)))
    got = pd.bin_rows_device_full(_t(xf), _t(thr), _t(na_bin), _t(zero_bin),
                                  _t(cat_vals), _t(cat_len))
    np.testing.assert_array_equal(got.numpy(), want)
    if not (cat_len > 0).any():
        num = pd.bin_rows_device(_t(xf), _t(thr), _t(na_bin), _t(zero_bin))
        np.testing.assert_array_equal(num.numpy(), np.asarray(
            bin_rows_device(jnp.asarray(xf), jnp.asarray(thr),
                            jnp.asarray(na_bin), jnp.asarray(zero_bin))))


@pytest.mark.parametrize("weights,avg_denom", [("ones", 1.0),
                                               ("random", 3.0)])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("tag", TAGS)
def test_fused_raw_matches_jax_bitwise(models, tag, packed, weights,
                                       avg_denom):
    eng, _, x = _engine(models, tag, packed)
    T = len(eng.trees)
    w = np.ones(T, np.float32) if weights == "ones" else \
        np.random.RandomState(T).uniform(0.3, 1.7, T).astype(np.float32)
    bins = [np.asarray(a) for a in eng._device_bin_tables()]
    jt, tt = _node_tables(eng)
    # fused argument order: x, thr, na_bin, zero_bin, cat_vals, cat_len,
    # then the node tables without na_bin, is_cat_node before cat_index
    order = [0, 1, 2, 3, 4, 6, 7, 8]
    xf = x.astype(np.float32)
    want = np.asarray(jengine._fused_jit()(
        jnp.asarray(xf), jnp.asarray(bins[0]), jnp.asarray(eng._na_bin),
        jnp.asarray(bins[1]), jnp.asarray(bins[2]), jnp.asarray(bins[3]),
        *[jt[i] for i in order], jnp.asarray(eng._leaf_f32), jnp.asarray(w),
        jnp.asarray(np.float32(avg_denom)), steps=eng._steps,
        num_class=eng.num_class, transform=None))
    got = pd.fused_forest_predict(
        _t(xf), _t(bins[0]), _t(eng._na_bin), _t(bins[1]), _t(bins[2]),
        _t(bins[3]), *[tt[i] for i in order], _t(eng._leaf_f32), _t(w),
        avg_denom, steps=eng._steps, num_class=eng.num_class)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_uint16_tables_read_as_unsigned():
    """A threshold table above 255 bins packs to uint16 and travels as
    int16 bits; the port must read values >= 32768 as unsigned."""
    t = torch.tensor([[40000, 1, 65535]], dtype=torch.int32)
    packed = _t(t.numpy().astype(np.uint16))
    assert packed.dtype == torch.int16
    np.testing.assert_array_equal(pd.widen_unsigned(packed).numpy(),
                                  t.numpy())


def test_wrappers_refuse_bad_tables(models):
    eng, _, x = _engine(models, "binary")
    _, tt = _node_tables(eng)
    binned = _t(eng.bin_rows(x).astype(np.uint8))
    with pytest.raises(TypeError, match="share a dtype"):
        pd.traverse_forest_binned(binned, *tt[:3], tt[3].to(torch.int32),
                                  *tt[4:], steps=eng._steps)
    with pytest.raises(TypeError, match="binned"):
        pd.traverse_forest_binned(binned.to(torch.float32), *tt,
                                  steps=eng._steps)
