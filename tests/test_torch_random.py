"""The port's threefry stream and row/feature sampling against the JAX
package, bit for bit: ``prng_key``, ``fold_in`` and ``uniform`` equal to
``jax.random`` (seeds past 2^31 and negative ones included), the B6 plain
version's bagging masks equal to the JAX model's ``_bagging_w`` (plain and
pos/neg fractions), and the feature_fraction mask stream equal to the JAX
model's ``_feature_mask`` sequence."""

import jax
import numpy as np
import pytest
import torch

import lightgbm_torch as lgt
import lightgbm_tpu as lgb
from lightgbm_torch.ops import random as trandom

from torch_port_fixtures import raw_problem

torch.set_num_threads(2)

SEEDS = [0, 3, 42, -1, -7, 2**31 + 5, 2**32 + 9, 2**40 + 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_equal_jax(seed):
    kj = jax.random.PRNGKey(seed)
    assert trandom.prng_key(seed) == tuple(np.asarray(kj).tolist())
    for data in (0, 1, 5, 12345, 2**31 + 3):
        assert trandom.fold_in(trandom.prng_key(seed), data) \
            == tuple(np.asarray(jax.random.fold_in(kj, data)).tolist())


@pytest.mark.parametrize("n", [1, 1000, 65537])
@pytest.mark.parametrize("seed,epoch", [(3, 0), (3, 5), (-1, 10),
                                        (2**32 + 9, 2**31 + 1)])
def test_uniform_bitwise_equal_jax(seed, epoch, n):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), epoch)
    uj = np.asarray(jax.random.uniform(kj, (n,)))
    ut = trandom.uniform(trandom.bagging_key(seed, epoch), n).numpy()
    assert ut.dtype == np.float32 and uj.tobytes() == ut.tobytes()
    assert (ut >= 0).all() and (ut < 1).all()


def _models(params, n=3000):
    x, y = raw_problem(11, n=n, f=9, task="binary")
    base = {"objective": "binary", "verbosity": -1, "num_leaves": 7, **params}
    mt = lgt.Booster(base | {"device_type": "cpu"}, lgt.Dataset(x, y))._model
    mj = lgb.Booster(base | {"tpu_learner": "masked"},
                     lgb.Dataset(x, y))._model
    return mt, mj


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.8, "bagging_freq": 5},
    {"bagging_fraction": 0.5, "bagging_freq": 5, "bagging_seed": 2**31 + 1},
    {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.9,
     "bagging_freq": 5},
])
def test_bagging_masks_equal_jax(params):
    mt, mj = _models(params)
    assert mt._bagging_active and mj._bagging_active
    masks = []
    for it in range(12):
        wt = mt._bagging_w(it).numpy()
        wj = np.asarray(mj._bagging_w(jax.numpy.int32(it)))
        assert wt.dtype == np.float32 and wt.tobytes() == wj.tobytes(), it
        masks.append(wt)
    # the mask holds for bagging_freq iterations and then changes
    assert all(np.array_equal(masks[0], masks[i]) for i in range(5))
    assert not np.array_equal(masks[4], masks[5])
    assert 0.4 < masks[0].mean() < 0.95


def test_bag_vals_stack_equals_mask_times_gradients():
    mt, _ = _models({"pos_bagging_fraction": 0.5, "bagging_freq": 2})
    rs = np.random.RandomState(2)
    g = torch.as_tensor(rs.randn(mt.num_data).astype(np.float32))
    h = torch.as_tensor(rs.rand(mt.num_data).astype(np.float32))
    for it in (0, 3):
        vals = trandom.bag_vals(g, h, torch.tensor([it], dtype=torch.int32),
                                **mt.bagging_args())
        w = mt._bagging_w(it)
        want = torch.stack([g * w, h * w, w], dim=1)
        assert torch.equal(vals.view(torch.int32), want.view(torch.int32))


def test_feature_masks_equal_jax():
    mt, mj = _models({"feature_fraction": 0.6, "feature_fraction_seed": 9})
    for _ in range(20):
        a, b = mt._feature_mask(), mj._feature_mask()
        assert a.dtype == bool and np.array_equal(a, b)
        assert a.sum() == max(1, int(round(mt.num_features * 0.6)))
    # an epoch's masks are drawn up front, k at a time, from the same stream
    np.testing.assert_array_equal(mt._feature_masks(4),
                                  np.stack([mj._feature_mask()
                                            for _ in range(4)]))
