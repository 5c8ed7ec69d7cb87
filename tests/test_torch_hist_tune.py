"""The histogram autotuner (``lightgbm_torch/ops/hist_tune.py``, B15) and
``rows_per_block``, on the CPU, against the JAX package's
``ops/hist_tune.py`` and the port's own untuned runs:

- ``candidate_widths``, ``shape_key`` at the CPU platform and
  ``padded_bins`` equal the JAX functions';
- one sweep, then memory and disk hits, the table keyed with ``kmax``
  (the JAX package's ``TestAutotuner.test_sweep_and_persistence``), and a
  second process against a warm directory runs no sweep and predicts the
  same (``tests/test_zretrace.py``'s script on the port, without the
  compile counters), after a ``hist_tune=off`` run that never imported
  the module;
- ``hist_tune=on`` trains at the record's K, and its model text equals an
  untuned run at ``split_batch=rec["k"]`` and
  ``rows_per_block=rec["block_rows"]``; ``off`` is byte-identical to the
  parameter unset; an explicit ``split_batch`` and a budget of 8 leaves
  or fewer skip the sweep; a bad value is refused; a ``KernelError``
  inside the sweep propagates out of ``lgt.train``, other failures keep
  the untuned shapes;
- ``rows_per_block``: at 0 every launch shape is the automatic one (the
  shapes pinned here), a positive value is rounded up to each kernel's
  granularity and refused past the partial buffer's cap (the forms that
  keep one), and it reaches
  the workspace, every histogram pass of both growers (the shadow
  grower's too), the fused captures, the super-epochs, the fleet's
  member passes and the partitioned learner's segment histograms; fleet members with different values are refused
  with the JAX package's text.

The CPU sweeps sample 1,024 rows, as the JAX package's tests do."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import lightgbm_torch as lgt
from lightgbm_torch import _kernels
from lightgbm_torch import grower as tgr
from lightgbm_torch import grower_partitioned as tgp
from lightgbm_torch.fleet import fleet_train
from lightgbm_torch.fleet.trainer import _check_models
from lightgbm_torch.ops import hist_tune
from lightgbm_torch.ops import histogram as th
from lightgbm_torch.utils import shapes as tshapes
from lightgbm_tpu.fleet import fleet_train as jax_fleet_train
from lightgbm_tpu.obs import flops as jflops
from lightgbm_tpu.ops import hist_tune as jax_hist_tune

from torch_port_fixtures import (  # noqa: F401 (autouse fixtures)
    pin_torch_threads, pin_torch_threads_module)

REPO = Path(__file__).resolve().parent.parent


def _strip_params(text: str) -> str:
    """Model text without the dumped parameter block."""
    return text.split("parameters:")[0]


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(11)
    n, f = 900, 10
    x = rs.randn(n, f)
    x[rs.rand(n, f) < 0.03] = np.nan
    logit = (np.nan_to_num(x[:, 0]) * 1.5 - np.nan_to_num(x[:, 1])
             + 0.4 * np.nan_to_num(x[:, 2]) + 0.3 * rs.randn(n))
    return x, (logit > 0).astype(np.float32)


def _train(x, y, rounds=3, **over):
    p = {"objective": "binary", "verbosity": -1, "min_data_in_leaf": 5,
         "max_bin": 31, "num_leaves": 33, "device_type": "cpu"}
    p.update(over)
    return lgt.train(p, lgt.Dataset(x, y), rounds)


def _clear_mem():
    with hist_tune._LOCK:
        hist_tune._MEM.clear()


# --- the tuner's rules against the JAX package's ---------------------------

@pytest.mark.parametrize("kmax", [0, 1, 8, 16, 31, 32, 63, 64, 100])
def test_candidate_widths_equal_jax(kmax):
    assert hist_tune.candidate_widths(kmax) == \
        jax_hist_tune.candidate_widths(kmax)


@pytest.mark.parametrize("shape", [
    (2000, 4, 15, 4, 32), (900, 10, 31, 4, 32), (1_000_000, 28, 63, 4, 64),
    (1_000_000, 28, 63, 1, 64), (70_000, 136, 255, 2, 16), (1, 1, 2, 4, 8),
    (2_270_296, 8, 64, 4, 64), (5, 3, 65, 1, 32)])
def test_shape_key_and_padded_bins_equal_jax(shape):
    n, c, b, i, k = shape
    assert hist_tune.shape_key("cpu", n, c, b, i, k) == \
        jax_hist_tune.shape_key("cpu", n, c, b, i, k)
    assert tshapes.padded_bins(b) == jflops.padded_bins(b)
    assert hist_tune.platform_name("cpu") == "cpu"


def test_sweep_and_persistence(tmp_path):
    rec = hist_tune.tune(2000, 4, 15, kmax=32, reps=2, sample_rows=1024,
                         device="cpu")
    assert rec["k"] in (8, 16, 32)
    assert rec["block_rows"] >= 8
    assert rec["ms_per_leaf"] <= rec["ms_per_pass"]
    assert set(rec) == {"k", "block_rows", "ms_per_pass", "ms_per_leaf",
                        "platform", "sample_rows", "n_cols", "num_bins",
                        "itemsize", "kmax", "reps"}
    assert rec["platform"] == "cpu" and rec["sample_rows"] == 1024
    # every width x its three row blocks, the row blocks the K-slot
    # form's automatic one, half and double it, at the training's rows
    sweep = hist_tune.last_sweep()
    assert [c["k"] for c in sweep] == [8] * 3 + [16] * 3 + [32] * 3
    b0 = th.slots_launch_shape(2000, 4, 15, 8)[0]
    assert [c["block_rows"] for c in sweep[:3]] == \
        sorted({th.slots_launch_shape(2000, 4, 15, 8, b)[0]
                for b in (b0 // 2, b0, 2 * b0)})
    # ensure(): sweep once, then table hits (memory and disk)
    d = str(tmp_path / "tune")
    c0 = hist_tune.tune_counts()
    r1 = hist_tune.ensure(2000, 4, 15, kmax=32, dir_path=d, device="cpu")
    c1 = hist_tune.tune_counts()
    assert c1["sweeps"] == c0["sweeps"] + 1
    path = os.path.join(d, hist_tune.TUNE_FILE)
    assert os.path.exists(path)
    r2 = hist_tune.ensure(2000, 4, 15, kmax=32, dir_path=d, device="cpu")
    c2 = hist_tune.tune_counts()
    assert c2["sweeps"] == c1["sweeps"] and r2 == r1
    assert c2["hits"] == c1["hits"] + 1
    # a fresh process view still resolves from DISK, no sweep
    _clear_mem()
    r3 = hist_tune.ensure(2000, 4, 15, kmax=32, dir_path=d, device="cpu")
    assert r3 == r1
    assert hist_tune.tune_counts()["sweeps"] == c2["sweeps"]
    table = json.load(open(path))
    key = next(iter(table))
    assert "kmax32" in key and key.startswith("cpu|")
    assert table[key]["k"] == r1["k"]


def test_integer_sweep_uses_the_integer_form():
    rec = hist_tune.tune(3000, 5, 31, itemsize=1, kmax=16, reps=1,
                         sample_rows=1024, device="cpu")
    assert rec["itemsize"] == 1 and rec["k"] in (8, 16)
    for c in hist_tune.last_sweep():
        # whole warps: the integer forms' granularity
        assert c["block_rows"] % 32 == 0
    b0 = th.int_launch_shape(3000, 5, 31, 8)[0]
    assert -(-b0 // 32) * 32 in [c["block_rows"]
                                 for c in hist_tune.last_sweep()[:3]]


def test_block_candidates_drop_those_past_the_cap(monkeypatch):
    # B1-K keeps no partial: at 1M x 28 x 255 bins and K = 64 all three
    # candidates stay, each a whole warp's rows
    b0 = th.slots_launch_shape(1_000_000, 28, 255, 64)[0]
    assert hist_tune._block_candidates(1_000_000, 28, 255, 4, 64) == \
        [-(-(b0 // 2) // 32) * 32, b0, 2 * b0]
    assert hist_tune._block_candidates(1_000_000, 28, 63, 4, 64) == \
        [50016, 100000, 200000]
    # B1-K-int: its automatic row block's partial buffer is 49 MB, half of
    # it 99 MB; under a 60 MB cap half the row block is dropped
    monkeypatch.setattr(th, "PARTIAL_CAP_BYTES", 60_000_000)
    i0 = th.int_launch_shape(1_000_000, 28, 255, 64)[0]
    cands = hist_tune._block_candidates(1_000_000, 28, 255, 1, 64)
    assert cands == [th.int_launch_shape(1_000_000, 28, 255, 64, b)[0]
                     for b in (i0, 2 * i0)]


# --- hist_tune=on in training ----------------------------------------------

def test_hist_tune_on_trains_the_record(data, tmp_path):
    x, y = data
    d = str(tmp_path / "cache")
    _clear_mem()
    c0 = hist_tune.tune_counts()["sweeps"]
    bst = _train(x, y, hist_tune="on", compile_cache_dir=d)
    assert hist_tune.tune_counts()["sweeps"] == c0 + 1
    assert os.path.exists(os.path.join(d, hist_tune.TUNE_FILE))
    rec = bst._model.hist_tuned
    assert rec is not None and rec["kmax"] == 32
    assert bst._model.split_batch == rec["k"]
    assert bst._model.rows_per_block == rec["block_rows"]
    twin = _train(x, y, split_batch=rec["k"],
                  rows_per_block=rec["block_rows"])
    assert _strip_params(bst.model_to_string()) == \
        _strip_params(twin.model_to_string())
    # a second booster on the same shape bucket: zero re-tune
    again = _train(x, y, hist_tune="on", compile_cache_dir=d)
    assert hist_tune.tune_counts()["sweeps"] == c0 + 1
    assert again.model_to_string() == bst.model_to_string()


def test_hist_tune_off_is_default_and_exact(data):
    x, y = data
    c0 = hist_tune.tune_counts()["sweeps"]
    a = _train(x, y, num_leaves=15)
    b = _train(x, y, num_leaves=15, hist_tune="off")
    assert hist_tune.tune_counts()["sweeps"] == c0
    assert b._model.hist_tuned is None and b._model.rows_per_block == 0
    assert _strip_params(a.model_to_string()) == \
        _strip_params(b.model_to_string())


def test_explicit_split_batch_wins_over_tuner(data, tmp_path):
    x, y = data
    c0 = hist_tune.tune_counts()["sweeps"]
    bst = _train(x, y, hist_tune="on", split_batch=16,
                 compile_cache_dir=str(tmp_path))
    assert hist_tune.tune_counts()["sweeps"] == c0
    assert bst._model.hist_tuned is None
    assert bst._model.split_batch == 16 and bst._model.rows_per_block == 0
    assert not os.path.exists(os.path.join(str(tmp_path),
                                           hist_tune.TUNE_FILE))


@pytest.mark.parametrize("leaves", [2, 8])
def test_small_budget_skips_the_sweep(data, tmp_path, leaves):
    x, y = data
    c0 = hist_tune.tune_counts()["sweeps"]
    bst = _train(x, y, rounds=2, num_leaves=leaves, hist_tune="on",
                 compile_cache_dir=str(tmp_path))
    assert hist_tune.tune_counts()["sweeps"] == c0
    assert bst._model.hist_tuned is None and bst._model.split_batch == 1
    plain = _train(x, y, rounds=2, num_leaves=leaves)
    assert _strip_params(bst.model_to_string()) == \
        _strip_params(plain.model_to_string())


def test_bad_hist_tune_value_rejected(data):
    x, y = data
    with pytest.raises(ValueError, match="hist_tune"):
        _train(x, y, rounds=1, hist_tune="sometimes")


def test_partitioned_learner_does_not_tune(data, tmp_path):
    x, y = data
    c0 = hist_tune.tune_counts()["sweeps"]
    bst = _train(x, y, rounds=2, hist_tune="on", tpu_learner="partitioned",
                 compile_cache_dir=str(tmp_path))
    assert bst._model.learner == "partitioned"
    assert hist_tune.tune_counts()["sweeps"] == c0
    assert bst._model.hist_tuned is None


def test_kernel_error_in_sweep_propagates(data, tmp_path, monkeypatch):
    x, y = data

    def broken(*a, **kw):
        raise _kernels.KernelError("CUDA kernel histogram_slots failed to "
                                   "launch: cudaError 98")

    monkeypatch.setattr(th, "compute_histogram", broken)
    _clear_mem()
    with pytest.raises(_kernels.KernelError, match="histogram_slots"):
        _train(x, y, hist_tune="on", compile_cache_dir=str(tmp_path))


def test_other_failures_keep_untuned_shapes(data, tmp_path):
    """An unwritable table directory (a file where the directory should
    be) logs a warning and trains at the untuned shapes."""
    x, y = data
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")
    _clear_mem()
    bst = _train(x, y, hist_tune="on", num_leaves=70,
                 compile_cache_dir=str(blocker / "sub"))
    assert bst._model.hist_tuned is None
    assert bst._model.split_batch == 8 and bst._model.rows_per_block == 0
    plain = _train(x, y, num_leaves=70)
    assert _strip_params(bst.model_to_string()) == \
        _strip_params(plain.model_to_string())


_TUNE_SCRIPT = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[2])
import lightgbm_torch as lgt
cache_dir = sys.argv[1]
rs = np.random.RandomState(0)
x = rs.randn(400, 6)
y = (x[:, 0] - x[:, 1] + 0.2 * rs.randn(400) > 0).astype(np.float32)
p = {"objective": "binary", "num_leaves": 33, "verbosity": 0,
     "min_data_in_leaf": 5, "max_bin": 15, "device_type": "cpu",
     "fused_chunk": 0, "split_batch": 0, "compile_cache_dir": cache_dir}
lgt.train(dict(p, hist_tune="off"), lgt.Dataset(x, y), 1)
off_imported = "lightgbm_torch.ops.hist_tune" in sys.modules
bst = lgt.train(dict(p, hist_tune="on"), lgt.Dataset(x, y), 2)
from lightgbm_torch.ops import hist_tune
rec = {"sweeps": hist_tune.tune_counts()["sweeps"],
       "off_imported": off_imported, "k": bst._model.split_batch,
       "pred": np.asarray(bst.predict(x[:4])).round(8).tolist()}
print("TUNE " + json.dumps(rec))
"""


def test_second_process_reuses_choice(tmp_path):
    cache = str(tmp_path / "cache")

    def run():
        out = subprocess.run(
            [sys.executable, "-c", _TUNE_SCRIPT, cache, str(REPO)],
            capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
        assert out.returncode == 0, out.stderr[-3000:]
        for line in out.stdout.splitlines():
            if line.startswith("TUNE "):
                return json.loads(line[5:])
        raise AssertionError(out.stdout)

    cold = run()
    warm = run()
    assert cold["sweeps"] == 1 and not cold["off_imported"]
    assert os.path.exists(os.path.join(cache, "hist_tune.json"))
    assert warm["sweeps"] == 0, warm
    assert warm["k"] == cold["k"] and warm["pred"] == cold["pred"]


# --- rows_per_block --------------------------------------------------------

# the automatic launch shapes (rows_per_block 0): B1, B1-K, B1-int and
# B1-K-int at (rows, columns, bins, K), as the kernels launch them (B1-K:
# rows of a row range, tile slots, tile features)
AUTO_SHAPES = {
    (2000, 4, 15, 8): ((1024, 4, 8), (1024, 8, 4), (1000, 4, 1),
                       (1000, 4, 8)),
    (900, 10, 31, 32): ((1024, 10, 8), (1024, 16, 10), (900, 10, 1),
                        (900, 10, 32)),
    (1_000_000, 28, 63, 16): ((7580, 28, 5), (30304, 4, 28),
                              (3788, 28, 1), (7576, 28, 8)),
    (1_000_000, 28, 63, 64): ((7580, 28, 5), (100000, 5, 28),
                              (3788, 28, 1), (26316, 28, 10)),
    (1_000_000, 28, 255, 32): ((7576, 28, 1), (250016, 1, 28),
                               (3788, 28, 1), (58824, 28, 2)),
    (2_270_296, 136, 255, 16): ((17200, 37, 1), (1135168, 1, 34),
                                (17200, 68, 1), (252256, 68, 1)),
    (50_001, 13, 255, 8): ((1024, 13, 2), (1536, 2, 13), (1021, 13, 1),
                           (1021, 13, 4)),
    (581_012, 8, 255, 64): ((4404, 8, 4), (72640, 4, 8), (2201, 8, 1),
                            (17607, 8, 8)),
}


@pytest.mark.parametrize("shape", sorted(AUTO_SHAPES))
def test_launch_shapes_unchanged_at_zero(shape):
    n, f, b, k = shape
    want = AUTO_SHAPES[shape]
    for rpb in ((), (0,)):
        got = (th.launch_shape(n, f, b, *rpb),
               th.slots_launch_shape(n, f, b, k, *rpb),
               th.int_launch_shape(n, f, b, None, *rpb),
               th.int_launch_shape(n, f, b, k, *rpb))
        assert got == want
    assert th.form_launch_shape(n, f, b, k, False) == want[1]
    assert th.form_launch_shape(n, f, b, None, True) == want[2]
    # B1-K's tile of 64-bit counters fits a block's shared memory
    rows, tk, tf = want[1]
    assert 16 + tk * tf * b * 3 * 8 <= 227 * 1024
    assert 1 <= tk <= k and 1 <= tf <= f and rows % 32 == 0


@pytest.mark.parametrize("rpb", [1, 33, 1000, 4097, 20_000])
def test_explicit_rows_rounded_to_granularity(rpb):
    n, f, b = 20_000, 28, 63
    rows, _, sub = th.launch_shape(n, f, b, rpb)
    assert rows % sub == 0 and rpb <= rows < rpb + sub
    # B1-K's row range and the integer forms' row block: a whole warp's
    # 32 rows
    rows = th.slots_launch_shape(n, f, b, 16, rpb)[0]
    assert rows % 32 == 0 and rpb <= rows < rpb + 32
    for k in (None, 32):
        rows = th.int_launch_shape(n, f, b, k, rpb)[0]
        assert rows % 32 == 0 and rpb <= rows < rpb + 32
    # the tiles are the automatic shape's
    assert th.launch_shape(n, f, b, rpb)[1:] == th.launch_shape(n, f, b)[1:]
    assert th.slots_launch_shape(n, f, b, 16, rpb)[1:] == \
        th.slots_launch_shape(n, f, b, 16)[1:]


def test_rows_per_block_past_the_cap_refused():
    # B1 at 1M x 28 x 63: 10-row blocks give 100,000 partials of 5,292
    # cells, 2.1 GB
    with pytest.raises(ValueError, match="partial histograms"):
        th.launch_shape(1_000_000, 28, 63, 8)
    with pytest.raises(ValueError, match="rows_per_block=64"):
        th.int_launch_shape(1_000_000, 28, 63, 64, 64)
    # the automatic shapes and a value under the cap pass; B1-K keeps no
    # partial, so any row range passes
    th.launch_shape(1_000_000, 28, 63)
    th.launch_shape(1_000_000, 28, 63, 4096)
    th.slots_launch_shape(1_000_000, 28, 63, 64)
    th.slots_launch_shape(1_000_000, 28, 63, 64, 512)
    th.slots_launch_shape(1_000_000, 28, 63, 64, 32)


def test_rows_per_block_past_the_cap_refused_by_train(data, monkeypatch):
    x, y = data
    # a cap that 64-row blocks of the 900-row set (15 partials of about
    # 10 x 31 bins) pass and 512-row blocks (2 partials) do not
    monkeypatch.setattr(th, "PARTIAL_CAP_BYTES", 10 * 31 * 12 * 8)
    with pytest.raises(ValueError, match="past the"):
        _train(x, y, rounds=1, rows_per_block=64)
    with pytest.raises(ValueError, match="past the"):
        th.compute_histogram(
            *_hist_operands(900, 10, 31), num_bins=31, rows_per_block=64)
    _train(x, y, rounds=1, rows_per_block=512)


def _hist_operands(n, f, b, seed=0):
    import torch
    rs = np.random.RandomState(seed)
    binned = torch.as_tensor(rs.randint(0, b, size=(n, f), dtype=np.uint8))
    vals = torch.as_tensor(rs.randn(n, 3).astype(np.float32))
    return binned, vals


def test_plain_versions_ignore_rows_per_block():
    import torch
    binned, vals = _hist_operands(3000, 6, 31)
    slot = torch.as_tensor(np.random.RandomState(1).randint(
        -1, 8, size=3000).astype(np.int32))
    used = torch.tensor([8], dtype=torch.int32)
    for kw in ({}, {"slot": slot}, {"slot": slot, "num_slots": 8,
                                    "slots_used": used}):
        a = th.compute_histogram(binned, vals, num_bins=31, **kw)
        b = th.compute_histogram(binned, vals, num_bins=31,
                                 rows_per_block=100, **kw)
        assert torch.equal(a, b)
    m = th.compute_histogram_members(binned, [vals, vals * 2], num_bins=31,
                                     rows_per_block=100)
    assert torch.equal(m[0], th.compute_histogram(binned, vals,
                                                  num_bins=31))


def _recording(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def rec(*a, **kw):
        seen.append(kw.get("rows_per_block"))
        return real(*a, **kw)

    monkeypatch.setattr(module, name, rec)
    return seen


@pytest.mark.parametrize("leaves", [15, 70])
def test_rows_per_block_reaches_every_pass(data, monkeypatch, leaves):
    """The value reaches the workspace, the shadow grower's workspace,
    every histogram pass of the trainer's grower and of the shadow's, and
    the fused capture key."""
    x, y = data
    seen = _recording(monkeypatch, tgr, "compute_histogram")
    bst = _train(x, y, rounds=2, num_leaves=leaves, rows_per_block=3000,
                 integrity_check_freq=1, superepoch=-1, fused_chunk=1)
    m = bst._model
    assert m.rows_per_block == 3000 and m.grow_ws.rows_per_block == 3000
    assert m._integrity.shadow_fn.ws.rows_per_block == 3000
    # each tree's root pass and every step's, primary and shadow
    steps = leaves - 1
    assert seen == [3000] * (2 * 2 * (1 + steps))
    plain = _train(x, y, rounds=2, num_leaves=leaves,
                   integrity_check_freq=1, superepoch=-1, fused_chunk=1)
    assert _strip_params(bst.model_to_string()) == \
        _strip_params(plain.model_to_string())
    # the fused paths capture at the row block, and another row block is
    # another capture
    seen.clear()
    fused = _train(x, y, rounds=4, num_leaves=leaves, rows_per_block=3000,
                   fused_chunk=2)
    fm = fused._model
    progs = list(fm._programs.values())
    assert progs and all(p.rows_per_block == 3000 for p in progs)
    assert seen and set(seen) == {3000}
    spec = (progs[0].eval_spec, progs[0].es_spec)
    assert fm._program(*spec) is progs[0]
    fm.grow_ws.rows_per_block = 4096
    again = fm._program(*spec)
    assert again is not progs[0] and again.rows_per_block == 4096


def test_rows_per_block_reaches_super_epochs_and_the_fleet(data,
                                                          monkeypatch):
    """The super-epoch path's passes and the fleet's member passes (B1-M,
    B1-K-M) take the row block."""
    x, y = data
    seen = _recording(monkeypatch, tgr, "compute_histogram")
    tr = lgt.Dataset(x[:700], y[:700])
    va = lgt.Dataset(x[700:], y[700:], reference=tr)
    p = {"objective": "binary", "verbosity": -1, "min_data_in_leaf": 5,
         "max_bin": 31, "num_leaves": 70, "device_type": "cpu",
         "rows_per_block": 2048, "early_stopping_round": 3}
    bst = lgt.train(p, tr, 4, valid_sets=[va])
    assert bst._model.fetch_counts.get("epoch", 0) >= 1
    assert seen and set(seen) == {2048}
    seen_m = _recording(monkeypatch, tgr, "compute_histogram_members")
    fr = fleet_train({**p, "num_leaves": 15, "fleet_members": 2}, tr,
                     num_boost_round=4, valid_sets=[va])
    assert fr.epochs >= 1
    assert seen_m and set(seen_m) == {2048}
    assert all(b._model.grow_ws.rows_per_block == 2048 for b in fr)


def test_rows_per_block_reaches_the_partitioned_learner(data, monkeypatch):
    x, y = data
    seen = _recording(monkeypatch, tgp, "segment_histogram")
    bst = _train(x, y, rounds=2, num_leaves=7, rows_per_block=2048,
                 tpu_learner="partitioned")
    assert bst._model.partitioned.rows_per_block == 2048
    assert seen and set(seen) == {2048}


def test_fleet_members_differing_in_rows_per_block_refused(data):
    import lightgbm_tpu as lgb
    x, y = data
    msgs = []
    for mod, ft, extra in ((lgt, fleet_train, {"device_type": "cpu"}),
                           (lgb, jax_fleet_train, {})):
        p = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
             **extra}
        ds = mod.Dataset(x[:700], y[:700])
        va = mod.Dataset(x[700:], y[700:], reference=ds)
        with pytest.raises(ValueError) as e:
            ft(p, ds, num_boost_round=2, valid_sets=[va],
               members=[{"rows_per_block": 0}, {"rows_per_block": 2048}])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the shared-trace signature carries the row block as the JAX
    # package's does
    a = _train(x, y, rounds=1, num_leaves=7)
    b = _train(x, y, rounds=1, num_leaves=7, rows_per_block=2048)
    with pytest.raises(ValueError, match="compiles a different program "
                                         "shape than member 0"):
        _check_models([a, b])
    _check_models([a, _train(x, y, rounds=1, num_leaves=7)])
