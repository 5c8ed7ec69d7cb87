"""Multiclass pieces of lightgbm_torch against the JAX package, on the
same numpy inputs made from a seed (the port on the CPU, where every
kernel runs as its plain version):

- the objectives ``multiclass`` (softmax) and ``multiclassova``: [N, K]
  gradients and hessians with and without weights within ``GRAD_RTOL``
  (both packages take the exponentials in f32, with their own ``exp``),
  ``boost_from_score(k)`` for every class exactly (the same numpy f32
  ops), ``convert_output`` within ``GRAD_RTOL``, and the label checks;
- the host metrics multi_logloss, multi_error (top_k 1 and 2, named
  ``multi_error@2``) and auc_mu against the JAX classes on the same
  scores, within ``HOST_RTOL``;
- the traced multi_logloss (B12c's plain version) against the JAX
  ``_t_multi_logloss`` within ``TRACED_RTOL``: saturated scores that hit
  the 1e-7 clip, zero-weight rows, every class present and one absent,
  and NaN for a label outside [0, K);
- B4's column form: tree t of a multiclass model adds into column t % K
  of an [N, K] score, equal bit for bit to the JAX ``add_tree_score`` on
  ``vscore[:, k]`` (the JAX trainer's walk into zeros then add, at weight
  1) for numerical and categorical trees; column 0 of a [N] score is the
  one-column call."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_torch import convert
from lightgbm_torch import metrics as tm
from lightgbm_torch.config import Config as TConfig
from lightgbm_torch.dataset import Metadata as TMeta
from lightgbm_torch.objectives import (MulticlassOVA, MulticlassSoftmax,
                                       create_objective)
from lightgbm_torch.predict_device import add_tree_score
from lightgbm_torch.utils.shapes import round_up_pow2
from lightgbm_tpu import metrics as jm
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMeta
from lightgbm_tpu.grower import make_grower
from lightgbm_tpu.ops.split import SplitParams
from lightgbm_tpu.predict_device import add_tree_score as j_add_tree_score

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    binned_problem, pin_torch_threads, pin_torch_threads_module)

# the exponentials of torch and XLA differ by an ulp or two
GRAD_RTOL, GRAD_ATOL = 2e-6, 1e-7
# the same numpy formula on scores equal to the last bit
HOST_RTOL = 1e-12
# f32 sums of N terms in another order
TRACED_RTOL = 1e-5
K = 4
OBJECTIVES = {"multiclass": (MulticlassSoftmax, jobj.MulticlassSoftmax),
              "multiclassova": (MulticlassOVA, jobj.MulticlassOVA)}


def _labels(rs, n, k, absent=None):
    lbl = rs.randint(0, k, n)
    if absent is not None:
        lbl[lbl == absent] = (absent + 1) % k
    return lbl.astype(np.float32)


def _objectives(name, label, weight, k=K):
    ct, cj = OBJECTIVES[name]
    params = {"objective": name, "num_class": k}
    ot, oj = ct(TConfig(params)), cj(JConfig(params))
    n = len(label)
    for meta_cls, obj in ((TMeta, ot), (JMeta, oj)):
        md = meta_cls(n)
        md.set_label(label)
        if weight is not None:
            md.set_weight(weight)
        obj.init(md, n)
    return ot, oj


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_gradients_match_jax(name, weighted):
    rs = np.random.RandomState(11)
    n = 1500
    label = _labels(rs, n, K)
    weight = (0.5 + rs.rand(n)).astype(np.float32) if weighted else None
    score = (2.0 * rs.randn(n, K)).astype(np.float32)
    ot, oj = _objectives(name, label, weight)
    gt, ht = ot.get_gradients(torch.as_tensor(score))
    gj, hj = oj.get_gradients(jnp.asarray(score))
    assert gt.shape == ht.shape == (n, K)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    if name == "multiclass":
        # the factor-2 hessian of the reference
        p = torch.softmax(torch.as_tensor(score), dim=1)
        w = 1.0 if weight is None else torch.as_tensor(weight)[:, None]
        np.testing.assert_allclose(ht.numpy(), (2 * p * (1 - p) * w).numpy(),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_boost_from_score_and_transform_match_jax(name, weighted):
    rs = np.random.RandomState(12)
    n = 900
    label = _labels(rs, n, K, absent=None)
    weight = (0.2 + rs.rand(n)).astype(np.float32) if weighted else None
    ot, oj = _objectives(name, label, weight)
    for k in range(K):
        assert ot.boost_from_score(k) == oj.boost_from_score(k)
    raw = (3.0 * rs.randn(50, K)).astype(np.float32)
    np.testing.assert_allclose(
        ot.convert_output(torch.as_tensor(raw)).numpy(),
        np.asarray(oj.convert_output(jnp.asarray(raw))), rtol=GRAD_RTOL,
        atol=GRAD_ATOL)


def test_boost_from_score_of_an_absent_class():
    rs = np.random.RandomState(13)
    label = _labels(rs, 600, K, absent=2)
    for name in OBJECTIVES:
        ot, oj = _objectives(name, label, None)
        assert ot.boost_from_score(2) == oj.boost_from_score(2)
    assert ot.boost_from_score(2) == 0.0      # OVA: p = 0


def test_label_checks():
    md = TMeta(4)
    md.set_label(np.array([0, 1, 3, 2], np.float32))
    cfg = TConfig({"objective": "multiclass", "num_class": 3})
    with pytest.raises(ValueError, match="num_class"):
        create_objective(cfg).init(md, 4)
    md.set_label(np.array([0, -1, 1, 2], np.float32))
    with pytest.raises(ValueError, match="num_class"):
        create_objective(cfg).init(md, 4)
    # one-vs-all takes no range check, as the JAX package: a label past
    # K fails the one-hot lookup
    md.set_label(np.array([0, 1, 3, 2], np.float32))
    ova = create_objective(TConfig({"objective": "multiclassova",
                                    "num_class": 3}))
    with pytest.raises(IndexError):
        ova.init(md, 4)
    with pytest.raises(ValueError, match="num_class"):
        TConfig({"objective": "multiclass", "num_class": 1})
    with pytest.raises(ValueError, match="labels"):
        tm.check_class_labels(np.array([0.0, 3.0]), 3)
    tm.check_class_labels(np.array([0.0, 2.0, 1.0]), 3)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric,params", [
    ("multi_logloss", {}), ("multi_error", {}),
    ("multi_error", {"multi_error_top_k": 2}), ("auc_mu", {})])
def test_host_metrics_match_jax(metric, params, weighted):
    rs = np.random.RandomState(14)
    n = 1200
    label = _labels(rs, n, K)
    weight = (0.3 + rs.rand(n)).astype(np.float32) if weighted else None
    score = (1.5 * rs.randn(n, K)).astype(np.float32)
    score[:40] = 40.0 * np.sign(score[:40])   # saturated rows
    score[40:80, 1] = score[40:80, 2]         # ties for multi_error
    out = []
    for meta_cls, mod, cfg_cls in ((TMeta, tm, TConfig),
                                   (JMeta, jm, JConfig)):
        md = meta_cls(n)
        md.set_label(label)
        if weight is not None:
            md.set_weight(weight)
        m = mod.create_metric(metric, cfg_cls({"objective": "multiclass",
                                               "num_class": K, **params}))
        m.init(md, n)
        out.append(m.eval(score))
    (nt, vt, ht), = out[0]
    (nj, vj, hj), = out[1]
    assert (nt, ht) == (nj, hj)
    if params:
        assert nt == "multi_error@2"
    np.testing.assert_allclose(vt, vj, rtol=HOST_RTOL)


def _traced_case(case, rs, n=3000):
    score = (2.0 * rs.randn(n, K)).astype(np.float32)
    label = _labels(rs, n, K, absent=3 if case == "class_absent" else None)
    weight = (0.5 + rs.rand(n)).astype(np.float32)
    if case == "saturated":
        # the label's probability underflows below the 1e-7 clip
        score[::3] = 0.0
        score[::3, 0] = 80.0
        label[::3] = 1.0
    if case == "zero_weights":
        weight[::5] = 0.0
        score[::5] = 1e4 * rs.randn(len(score[::5]), K)
    return score, label, weight


@pytest.mark.parametrize("case", ["random", "saturated", "zero_weights",
                                  "class_absent"])
def test_traced_multi_logloss_matches_jax(case):
    rs = np.random.RandomState(15)
    score, label, weight = _traced_case(case, rs)
    t = float(tm.traced_multi_logloss(*(torch.as_tensor(a) for a in
                                        (score, label, weight))))
    j = float(jm._t_multi_logloss(JConfig({}))(
        *(jnp.asarray(a) for a in (score, label, weight))))
    assert np.isfinite(t)
    assert abs(t - j) <= TRACED_RTOL * abs(j), (t, j)
    if case == "saturated":
        assert t > -np.log(1e-7) / 3 * 0.9      # the clip was reached


def test_traced_multi_logloss_refuses_labels_outside_classes():
    rs = np.random.RandomState(16)
    score, label, weight = _traced_case("random", rs, n=100)
    label[7] = K
    t = tm.traced_multi_logloss(*(torch.as_tensor(a) for a in
                                  (score, label, weight)))
    assert torch.isnan(t)
    label[7] = -1
    assert torch.isnan(tm.traced_multi_logloss_plain(
        *(torch.as_tensor(a) for a in (score, label, weight))))
    with pytest.raises(TypeError):
        tm.traced_multi_logloss(torch.zeros(4), torch.zeros(4),
                                torch.ones(4))
    with pytest.raises(ValueError):
        tm.traced_multi_logloss(torch.zeros(4, 3), torch.zeros(5),
                                torch.ones(5))


def _trees(seed, cat=False):
    """K reference trees grown by the JAX grower on per-class targets
    (the last feature categorical with ``cat``), and the binned rows."""
    binned, vals, num_bin, na_bin = binned_problem(seed, n=3000, f=6,
                                                   bins=31)
    kw = {}
    if cat:
        na_bin = na_bin.copy()
        na_bin[5] = -1
        kw["is_cat"] = jnp.asarray(np.arange(6) == 5)
    grow = make_grower(num_leaves=15, num_bins=31,
                       params=SplitParams(min_data_in_leaf=20,
                                          min_data_per_group=20))
    rs = np.random.RandomState(seed)
    out = []
    for k in range(K):
        v = vals.copy()
        # class k also prefers the categories c % 4 == k of the last
        # feature, which no threshold on the bin order separates
        v[:, 0] = v[:, 0] * (1.0 + k) \
            - 3.0 * ((binned[:, 5] % 4) == k).astype(np.float32)
        v[:, 0] += 0.01 * rs.randn(len(v)).astype(np.float32)
        tj = grow(jnp.asarray(binned), jnp.asarray(v), jnp.ones(6, bool),
                  jnp.asarray(num_bin), jnp.asarray(na_bin), **kw)
        out.append(tj)
    vb, _, _, _ = binned_problem(seed + 100, n=2000, f=6, bins=31)
    return out, vb, num_bin, na_bin


@pytest.mark.parametrize("cat", [False, True])
def test_column_form_matches_jax_class_columns(cat):
    trees, vb, num_bin, na_bin = _trees(41, cat)
    if cat:
        assert any(bool(np.asarray(t.is_cat_node).any()) for t in trees)
    data = convert.dataset_from_numpy(vb, num_bin, na_bin,
                                      [np.arange(31.0)] * 6)
    rs = np.random.RandomState(42)
    s0 = rs.randn(len(vb), K).astype(np.float32)
    st = torch.as_tensor(s0.copy())
    sj = jnp.asarray(s0)
    # two iterations of K trees: tree t into column t % K
    for t, tj in enumerate(trees + trees[::-1]):
        k = t % K
        fields = {f: np.asarray(v) for f, v in tj._asdict().items()}
        tree = convert.tree_arrays_from_numpy(fields)
        steps = round_up_pow2(max(int(tree.leaf_depth[:tree.num_leaves]
                                      .max()), 1))
        node = [torch.as_tensor(getattr(tree, f)) for f in (
            "split_feature", "threshold_bin", "default_left", "left_child",
            "right_child")]
        catkw = {}
        if cat:
            catkw = {"is_cat_node": torch.as_tensor(tree.is_cat_node),
                     "cat_rank": torch.as_tensor(
                         np.asarray(tree.cat_rank, np.int32))}
        add_tree_score(st, data.binned, *node, data.na_bin,
                       torch.as_tensor(tree.leaf_value), 1.0, steps=steps,
                       column=k, **catkw)
        # the JAX trainer's valid update: the walk into zeros, then add
        vd = j_add_tree_score(
            jnp.zeros(len(vb), jnp.float32), jnp.asarray(vb),
            tj.split_feature, tj.threshold_bin, tj.default_left,
            tj.left_child, tj.right_child, jnp.asarray(na_bin),
            tj.is_cat_node, tj.cat_rank, tj.leaf_value, jnp.float32(1.0),
            steps=steps)
        sj = sj.at[:, k].add(vd)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert not np.array_equal(st.numpy(), s0)


def test_column_zero_of_one_column_is_the_plain_call():
    trees, vb, num_bin, na_bin = _trees(43)
    data = convert.dataset_from_numpy(vb, num_bin, na_bin,
                                      [np.arange(31.0)] * 6)
    fields = {f: np.asarray(v) for f, v in trees[0]._asdict().items()}
    tree = convert.tree_arrays_from_numpy(fields)
    node = [torch.as_tensor(getattr(tree, f)) for f in (
        "split_feature", "threshold_bin", "default_left", "left_child",
        "right_child")]
    lv = torch.as_tensor(tree.leaf_value)
    s0 = np.random.RandomState(44).randn(len(vb)).astype(np.float32)
    a, b = torch.as_tensor(s0.copy()), torch.as_tensor(s0.copy())
    add_tree_score(a, data.binned, *node, data.na_bin, lv, 0.3, steps=8)
    add_tree_score(b, data.binned, *node, data.na_bin, lv, 0.3, steps=8,
                   column=0)
    assert torch.equal(a, b)
    # a [N, 1] score takes the same bits in its one column
    c = torch.as_tensor(s0.copy())[:, None].contiguous()
    add_tree_score(c, data.binned, *node, data.na_bin, lv, 0.3, steps=8,
                   column=0)
    assert torch.equal(c[:, 0], a)
    with pytest.raises(ValueError, match="column"):
        add_tree_score(a, data.binned, *node, data.na_bin, lv, 0.3, steps=8,
                       column=1)
    with pytest.raises(ValueError, match="column"):
        add_tree_score(torch.zeros(len(vb), 3), data.binned, *node,
                       data.na_bin, lv, 1.0, steps=8, column=3)
