"""Shared inputs for the lightgbm_torch parity tests (tests/test_torch_*).

Every input is made with numpy from a seed and handed to both packages:
the JAX package (the reference, run on the CPU) and its PyTorch port
(``device_type="cpu"``, where every kernel runs as its plain version).
"""

import warnings

import numpy as np
import pytest
import torch

# the intra-op thread count of every port test (``pin_torch_threads``)
TORCH_THREADS = 2

# ``exp_tripwire``'s probe: f32 arguments across exp's range (a long
# vector, for the vectorised path, and a short one) and the bits of their
# exp taken when this module is imported, at the start of a session
_EXP_PROBES = (torch.linspace(-80.0, 80.0, 4099, dtype=torch.float32),
               torch.tensor([-1.5, -1e-3, 0.0, 0.25, 1.0, 7.5, 30.0]))


def _exp_bits():
    return [torch.exp(p).view(torch.int32).clone() for p in _EXP_PROBES]


_EXP_BITS = _exp_bits()
# the last port test after which torch.exp still gave the start's bits
_exp_clean = {"after": "(session start)"}


def binned_problem(seed: int, n: int = 4000, f: int = 8, bins: int = 31,
                   na_features=(2, 5)):
    """A binned matrix with well separated signal, per-row (g, h, 1) vals
    and bin metadata.  Features in ``na_features`` carry an NA bin (the
    last bin, as BinMapper gives NaN values)."""
    rs = np.random.RandomState(seed)
    binned = rs.randint(0, bins - 1, size=(n, f)).astype(np.uint8)
    num_bin = np.full(f, bins - 1, np.int32)
    na_bin = np.full(f, -1, np.int32)
    for j in (j for j in na_features if j < f):
        num_bin[j] = bins
        na_bin[j] = bins - 1
        nan_rows = rs.rand(n) < 0.15
        binned[nan_rows, j] = bins - 1
    # steps of decreasing size on several features: every split of a
    # small tree follows real structure, so gains are well separated
    steps = [(0, bins // 2, 3.0), (1, bins // 3, -2.0), (3, 2 * bins // 3, 1.3),
             (4, bins // 4, -0.9), (1, 2 * bins // 3, 0.6)]
    signal = 0.05 * rs.randn(n).astype(np.float32)
    for j, cut, size in steps:
        if j < f:
            signal += size * (binned[:, j] >= cut).astype(np.float32)
    if f > 2:
        signal += 1.6 * (binned[:, 2] == bins - 1)
    g = (0.4 - signal).astype(np.float32)
    h = (0.5 + 0.5 * rs.rand(n)).astype(np.float32)
    vals = np.stack([g, h, np.ones(n, np.float32)], axis=1)
    return binned, vals, num_bin, na_bin


def raw_problem(seed: int, n: int = 3000, f: int = 8, task: str = "binary",
                nan_frac: float = 0.05):
    """Raw features with NaNs and a binary or regression target with a
    clear signal, so split gains are well separated."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    logit = 1.5 * x[:, 0] - x[:, 1] + 0.8 * x[:, 2] * x[:, 3] \
        + 0.5 * rs.randn(n)
    x[rs.rand(n, f) < nan_frac] = np.nan
    if task == "binary":
        y = (logit > 0).astype(np.float32)
    else:
        y = (2.0 * logit + 0.3 * rs.randn(n)).astype(np.float32)
    return x, y


def serve_rows(n, f=6, seed=0, nan_frac=0.08, cat_col=None):
    """Raw rows for the serving tests: NaNs, and integer categories in
    ``cat_col`` (unseen, negative and NaN ones included)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    if cat_col is not None:
        x[:, cat_col] = rs.randint(-2, 15, n)
    x[rs.rand(n, f) < nan_frac] = np.nan
    return x


def hard_rows(x, trees, seed=0):
    """``x`` with the values a binning can get wrong: every numerical
    split threshold of ``trees`` copied into some row (exact ties), and
    out-of-range values (+-1e30, +-inf, -0.0) in others."""
    rs = np.random.RandomState(seed)
    x = np.array(x, np.float64)
    for t in trees:
        for i in range(t.num_nodes()):
            if not int(t.decision_type[i]) & 1:
                x[rs.randint(0, len(x)), int(t.split_feature[i])] = \
                    t.threshold[i]
    for v in (1e30, -1e30, np.inf, -np.inf, -0.0):
        x[rs.randint(0, len(x), 3), rs.randint(0, x.shape[1])] = v
    return x


def jax_serve_models():
    """JAX-trained models across the serving matrix, as
    {tag: (model text, test rows)}: regression with NaNs, binary, binary
    with a stump tree in the middle, 3-class, a categorical feature, and
    a forest of stumps only."""
    import lightgbm_tpu as lgb
    from lightgbm_tpu.tree_model import Tree

    def train(params, x, y, rounds=8, **kw):
        return lgb.train({"verbosity": -1, "num_leaves": 8, **params},
                         lgb.Dataset(x, label=y, **kw),
                         num_boost_round=rounds)

    rs = np.random.RandomState(7)
    out = {}
    x = serve_rows(500, seed=1)
    y = np.where(np.isnan(x[:, 0]), 0.3, x[:, 0] + 0.5 * x[:, 1])
    bst = train({"objective": "regression"}, x, y)
    out["regression"] = (bst, serve_rows(150, seed=11))
    x = serve_rows(500, seed=2)
    y = (np.nan_to_num(x[:, 0]) > 0).astype(np.float64)
    bst = train({"objective": "binary"}, x, y)
    out["binary"] = (bst, serve_rows(150, seed=12))
    stumped = lgb.Booster(model_str=bst.model_to_string())
    stump = Tree(1)
    stump.leaf_value[0] = 0.125
    stumped.trees.insert(3, stump)
    stumped.tree_weights.insert(3, 1.0)
    out["binary_stump"] = (stumped, serve_rows(150, seed=12))
    x = serve_rows(500, seed=3)
    y = rs.randint(0, 3, len(x)).astype(np.float64)
    bst = train({"objective": "multiclass", "num_class": 3}, x, y, rounds=5)
    out["multiclass"] = (bst, serve_rows(150, seed=13))
    x = serve_rows(500, seed=4)
    x[:, 2] = rs.randint(0, 12, len(x))
    x[rs.rand(len(x)) < 0.05, 2] = np.nan
    y = (np.nan_to_num(x[:, 2]) % 3 == 0).astype(np.float64)
    bst = train({"objective": "binary", "min_data_per_group": 5,
                 "cat_smooth": 1.0}, x, y, categorical_feature=[2])
    out["categorical"] = (bst, serve_rows(150, seed=14, cat_col=2))
    x = serve_rows(300, seed=5)
    bst = train({"objective": "regression", "min_data_in_leaf": 1000},
                x, np.nan_to_num(x[:, 0]), rounds=4)
    out["stumps"] = (bst, serve_rows(150, seed=15))
    return {tag: (b.model_to_string(), hard_rows(xt, b.trees, seed=len(tag)))
            for tag, (b, xt) in out.items()}


def host_walk(bst, x, **kw):
    """``bst.predict`` by the host tree walk (``predict_bucketed=false``),
    leaving the booster's mode and engine cache as they were."""
    old, cache = bst.config.predict_bucketed, bst._engine_cache
    bst.config.predict_bucketed = "false"
    try:
        return bst.predict(x, **kw)
    finally:
        bst.config.predict_bucketed = old
        bst._engine_cache = cache


@pytest.fixture(autouse=True, scope="module")
def pin_torch_threads_module():
    """``pin_torch_threads`` for a module's own module-scoped fixtures,
    which pytest sets up before any function-scoped one."""
    torch.set_num_threads(TORCH_THREADS)
    yield


def exp_tripwire(nodeid: str) -> None:
    """``torch.exp`` on fixed f32 vectors against the bits taken at the
    start of the session, run by ``pin_torch_threads`` after every port
    test: a mismatch (a worker in the state in which a first training's
    gradients come out a last bit off, ROADMAP C) issues a
    ``PytestWarning`` naming the test ``nodeid`` and the last port test
    after which exp was still right.  It never fails the test."""
    now = _exp_bits()
    bad = sum(int((a != b).sum()) for a, b in zip(now, _EXP_BITS))
    if bad:
        warnings.warn(pytest.PytestWarning(
            f"torch.exp tripwire: after {nodeid}, {bad} of "
            f"{sum(p.numel() for p in _EXP_PROBES)} probe values differ "
            "from the session start's bits; exp was last right after "
            f"{_exp_clean['after']}"))
    else:
        _exp_clean["after"] = nodeid


@pytest.fixture(autouse=True)
def pin_torch_threads(request, pin_torch_threads_module):
    """Run every port test on ``TORCH_THREADS`` intra-op threads, set just
    before the test whatever an earlier test or module changed: a float
    reduction of the plain versions splits its work by the thread count,
    so a count that moved between two trainings of one test could round
    their sums differently.  Imported into each ``tests/test_torch_*.py``
    (an imported fixture is the module's own).  After the test it runs
    ``exp_tripwire``."""
    torch.set_num_threads(TORCH_THREADS)
    yield
    exp_tripwire(request.node.nodeid)


def multiclass_problem(seed: int, n: int = 3000, f: int = 6, k: int = 3,
                       nan_frac: float = 0.0):
    """Raw features and a k-class label from well separated per-class
    logits (class c driven mostly by feature c)."""
    rs = np.random.RandomState(seed)
    x = rs.randn(n, f)
    logits = np.stack([2.0 * x[:, c % f] - 0.5 * x[:, (c + 1) % f]
                       for c in range(k)], axis=1)
    y = np.argmax(logits + 0.4 * rs.randn(n, k), axis=1).astype(np.float32)
    x[rs.rand(n, f) < nan_frac] = np.nan
    return x, y


# the first tree's integer fields, and its f32 fields within FIRST_TREE_RTOL
# (f32 sums in other orders than the JAX package's XLA programs)
FIRST_TREE_INT = ("num_leaves", "split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "leaf_count", "internal_count")
FIRST_TREE_FLOAT = ("split_gain", "leaf_value", "internal_value")
FIRST_TREE_RTOL = 1e-4


def assert_first_tree_equal(bt, bj):
    """The first tree of the port's booster ``bt`` has the structure of
    the JAX package's ``bj`` and its values within FIRST_TREE_RTOL."""
    def first(b):
        text = b.model_to_string().split("end of trees")[0]
        return text.split("Tree=")[1].split("\n\n")[0]

    def field(tree, name):
        for ln in tree.splitlines():
            if ln.startswith(name + "="):
                return ln.split("=", 1)[1]
        return ""
    a, b = first(bt), first(bj)
    for name in FIRST_TREE_INT:
        assert field(a, name) == field(b, name), name
    for name in FIRST_TREE_FLOAT:
        x = np.asarray(field(a, name).split(), np.float64)
        y = np.asarray(field(b, name).split(), np.float64)
        np.testing.assert_allclose(
            x, y, rtol=FIRST_TREE_RTOL,
            atol=FIRST_TREE_RTOL * max(np.abs(y).max(), 1.0), err_msg=name)
