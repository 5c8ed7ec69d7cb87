"""Predictor engine: the ensemble as structure-of-arrays device tables,
the whole-forest walk on the card, bucketed batches.

Counterpart of the JAX package's ``serve/engine.py``.  The ensemble is
flattened ONCE into stacked [T, M] node tables (the SoA layout
arXiv:2011.02022 and arXiv:1706.08359 identify as where GBDT inference
throughput lives) and every row walks every tree on the device with the
B10a kernel (``predict_device.traverse_forest_binned``, ``csrc/forest.cu``):

- **Model-derived binning.**  Each feature's bin table is the sorted set
  of split thresholds the ENSEMBLE uses (a loaded model file has no
  ``BinMapper``).  With ``bin(x) = searchsorted(T_f, x, side="left")`` the
  reference decision ``x <= threshold`` is EXACTLY ``bin(x) <=
  index(threshold)``, so the walk over bins reproduces
  ``tree_model.Tree.predict_leaf`` bit for bit.  Binning runs on the
  host in float64 (``bin_rows``); the ``serve_device_binning`` mode bins
  on the device in f32 (B10b) at the cost of exactness on threshold ties.
- **Bucketed batches.**  Row counts round up to power-of-two buckets
  (floored at ``min_bucket``, capped at ``max_batch``).  A CUDA kernel
  does not recompile per shape, so here the buckets bound the number of
  distinct launch shapes and allocations; ``compile_stats()`` reports
  the buckets seen and the kernel launches (the JAX package reports XLA
  traces there).
- **Exact scores.**  The device returns leaf ids ([rows, trees] int32,
  the host path's one fetch); leaf values are accumulated on the HOST in
  float64 in tree order — the same float ops, in the same order, as
  ``Booster.predict``'s host walk, so engine scores are byte-identical
  to it.
- **Fused device-resident path** (``fused_predict``, the
  ``serve_device_binning`` serving mode): binning, the walk and the
  tree-order f32 leaf-value accumulation run as ONE kernel (B10c), and
  the objective's output transform as torch ops on the card; the only
  fetch is the final [rows, out] scores.  Its parity contract is
  :meth:`_fused_reference`, a host replay of exactly those f32 ops whose
  transform runs on the engine's device (a CPU ``exp`` and a CUDA
  ``expf`` differ in the last bit), enforced byte for byte by
  :meth:`self_check` on probe rows where f32 and f64 binning provably
  agree.  Models the fused kernel cannot represent (linear leaves,
  categories beyond f32's exact integer range) serve via the host paths.
- **Packed tables** (``serve_packed_tables``): thresholds uint8/uint16 by
  bin count, children int8/int16 by node count, features and categorical
  indices uint8/uint16; ``packed=False`` keeps everything int32.  A
  uint16 table is uploaded as an int16 tensor of the same bits and read
  as uint16 by the kernels.

The engine runs on ``device_type``'s device (the card unless
``device_type="cpu"``, where every kernel runs as its plain version).
Tables go to the device once: the node tables at construction, the
binning tables and the fused path's leaf values at first use, under the
lock.  A kernel that does not build or launch raises
``_kernels.KernelError``; it is never turned into
:class:`EngineUnsupported`.  Not ported: ``per_row_flops_bytes`` (it
needs ``obs/flops.py``, ROADMAP A15) and the ``serve_self_check``
fault-injection site (``utils/faultinject.py``, ROADMAP A12).
"""

from __future__ import annotations

import functools
import hashlib
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import _kernels
from ..predict_device import (bin_rows_device_full, fused_forest_predict,
                              traverse_forest_binned)
from ..utils.shapes import (bucket_bins, bucket_leaf_slots, bucket_nodes,
                            bucket_rows, bucket_steps)

_CAT_BIT = 1
_DEFAULT_LEFT_BIT = 2
_MISSING_SHIFT = 2
_ALWAYS_LEFT = np.int32(1 << 30)   # stump sentinel threshold: rank <= this
_F32_EXACT_INT = float(1 << 24)    # |ints| below this are f32-exact


class EngineUnsupported(ValueError):
    """Model shape the SoA engine cannot represent (callers fall back to
    the host-tree path).  Never raised for a kernel that fails to build
    or launch: that is ``_kernels.KernelError`` and propagates."""


class _FeatureTable:
    """Per-feature model-derived bin table."""

    __slots__ = ("kind", "thresholds", "cats", "miss_nan", "na_bin",
                 "num_bins")

    def __init__(self, kind: str):
        self.kind = kind                    # "num" | "cat" | "unused"
        self.thresholds = np.empty(0, np.float64)
        self.cats = np.empty(0, np.int64)
        self.miss_nan = False               # any node routes NaN by flag
        self.na_bin = -1
        self.num_bins = 1


def _feature_tables(trees, num_features: int) -> List[_FeatureTable]:
    tables = [_FeatureTable("unused") for _ in range(num_features)]
    thr_acc: Dict[int, List[np.ndarray]] = {}
    cat_acc: Dict[int, set] = {}
    miss_acc: Dict[int, set] = {}
    for t in trees:
        n = t.num_nodes()
        if n == 0:
            continue
        sf = t.split_feature[:n]
        dt = t.decision_type[:n]
        is_cat = (dt & _CAT_BIT) != 0
        miss = (dt >> _MISSING_SHIFT) & 3
        for f in np.unique(sf[~is_cat]):
            m = (sf == f) & ~is_cat
            thr_acc.setdefault(int(f), []).append(t.threshold[:n][m])
            # miss kind 2 (NaN) routes NaN by the node's default_left
            # flag; kinds 0/1 convert NaN to 0.0 first
            # (tree_model._decide) — record which behaviors appear
            miss_acc.setdefault(int(f), set()).update(
                {2} if (miss[m] == 2).any() else set())
            miss_acc[int(f)].update(
                {0} if (miss[m] != 2).any() else set())
        for i in np.nonzero(is_cat)[0]:
            f = int(sf[i])
            ci = int(t.threshold[i])
            lo, hi = t.cat_boundaries[ci], t.cat_boundaries[ci + 1]
            words = t.cat_threshold[lo:hi]
            cset = cat_acc.setdefault(f, set())
            for wi, w in enumerate(words):
                w = int(w)
                while w:
                    b = w & -w
                    cset.add(32 * wi + b.bit_length() - 1)
                    w ^= b
    for f, chunks in thr_acc.items():
        if f in cat_acc:
            raise EngineUnsupported(
                f"feature {f} has both numerical and categorical splits")
        if len(miss_acc[f]) > 1:
            # a trained model never mixes NaN-routing and NaN-converting
            # nodes on one feature (they come from one BinMapper); a
            # hand-merged model could — refuse rather than mispredict
            raise EngineUnsupported(
                f"feature {f} mixes NaN-routing and NaN-converting "
                "split nodes")
        tab = tables[f]
        tab.kind = "num"
        tab.miss_nan = miss_acc[f] == {2}
        tab.thresholds = np.unique(np.concatenate(chunks))
        # bins 0..len(T) from searchsorted, +1 reserved NaN bin when the
        # feature routes NaN by flag
        tab.na_bin = len(tab.thresholds) + 1 if tab.miss_nan else -1
        tab.num_bins = len(tab.thresholds) + (2 if tab.miss_nan else 1)
    for f, cset in cat_acc.items():
        tab = tables[f]
        tab.kind = "cat"
        tab.cats = np.asarray(sorted(cset), np.int64)
        tab.num_bins = len(tab.cats) + 1        # + unseen/NaN sentinel
    return tables


# objective output transforms, canonicalized by (class, output-relevant
# params): two boosters of one family carry two distinct-but-equal
# objective instances and get the SAME callable.  The cached callable
# binds the class's ``convert_output`` to a minimal shim carrying only
# the params the conversions read (``self.sigmoid``, objectives.py) —
# never the objective instance itself, whose training-side label/weight
# tensors must not be pinned process-wide by a serve-path cache.
_TRANSFORM_CACHE: Dict[tuple, object] = {}
_TRANSFORM_LOCK = threading.Lock()


class _TransformSelf:
    """Stand-in ``self`` for a cached output transform."""

    __slots__ = ("sigmoid",)

    def __init__(self, sigmoid: float):
        self.sigmoid = sigmoid


def _transform_for(objective):
    if objective is None:
        return None
    sigmoid = float(getattr(objective, "sigmoid", 0.0) or 0.0)
    key = (type(objective).__module__, type(objective).__qualname__,
           sigmoid)
    with _TRANSFORM_LOCK:
        fn = _TRANSFORM_CACHE.get(key)
        if fn is None:
            fn = functools.partial(type(objective).convert_output,
                                   _TransformSelf(sigmoid))
            _TRANSFORM_CACHE[key] = fn
    return fn


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host table on ``device`` as it is; uint16 as int16 bits."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        arr = arr.view(np.int16)
    return torch.from_numpy(arr).to(device)


class PredictorEngine:
    """One trained ensemble, flattened for batched device traversal.

    Thread-safe: ``leaf_ids``/``raw_scores``/``predict``/
    ``fused_predict`` may be called concurrently (the kernels launch on
    each thread's current stream; the bucket ledger and the lazy
    device-table uploads are lock-guarded).

    Lock contract: ``_lock`` guards ``_buckets_seen``, ``_fused_buckets``,
    ``_bin_dev`` and ``_fused_dev``.  All other attributes are frozen at
    construction.
    """

    def __init__(self, trees, tree_weights, num_class: int,
                 num_features: int, objective=None,
                 average_output: bool = False, *,
                 max_batch: Optional[int] = None, min_bucket: int = 16,
                 fingerprint: Optional[str] = None, packed: bool = True,
                 device_type: str = "cuda"):
        from ..models.gbdt import device_for

        self.trees = list(trees)
        self.tree_weights = list(tree_weights)
        self.num_class = max(1, int(num_class))
        self.num_features = int(num_features)
        self.objective = objective
        self.average_output = bool(average_output)
        self.max_batch = int(max_batch) if max_batch else None
        self.min_bucket = max(1, int(min_bucket))
        self.packed = bool(packed)
        if self.max_batch is not None:
            self.min_bucket = min(self.min_bucket, self.max_batch)
        if self.num_features < 1:
            raise EngineUnsupported("model has no features")
        self.device = device_for(device_type)

        self.tables = _feature_tables(self.trees, self.num_features)
        self._build_soa()
        self.fingerprint = fingerprint or self._fingerprint()
        self._lock = threading.Lock()
        self._buckets_seen: Dict[int, int] = {}
        self._fused_buckets: Dict[int, int] = {}

        d = self._dev = {}
        packed_arrays = self._packed_host_arrays()
        for name, arr in packed_arrays.items():
            d[name] = _upload(arr, self.device)
        d["default_left"] = _upload(self._default_left, self.device)
        d["is_cat_node"] = _upload(self._is_cat_node, self.device)
        d["na_bin"] = _upload(self._na_bin, self.device)
        self._host_dtypes = {name: arr.dtype
                             for name, arr in packed_arrays.items()}
        self._bin_dev = None               # lazy device-binning tables

        # fused-path availability + parity contract pieces: the f32
        # leaf table and weights the device will gather (and the host
        # reference oracle replays), the RF averaging denominator, the
        # canonicalized objective transform
        self._leaf_f32 = np.zeros(
            (len(self.trees), self._leaf_slots), np.float32)
        if len(self.trees):
            self._leaf_f32[:, :self.leaf_values.shape[1]] = \
                self.leaf_values.astype(np.float32)
        # the ONE f32 weight vector both the kernel and its host parity
        # oracle read
        self._w32 = np.asarray(
            [self.tree_weights[t] if t < len(self.tree_weights) else 1.0
             for t in range(len(self.trees))], np.float32)
        t1, k = len(self.trees), self.num_class
        self._avg_denom = float(max(t1 // k, 1)) \
            if (self.average_output and t1 > 0) else 1.0
        self._transform = _transform_for(objective)
        self.fused_reason: Optional[str] = None
        if not self.trees:
            self.fused_reason = "model has no trees"
        elif any(t.is_linear for t in self.trees):
            self.fused_reason = ("linear-leaf outputs need raw-feature "
                                 "host math")
        elif self._device_bin_err:
            self.fused_reason = self._device_bin_err
        self._fused_dev = None             # lazy leaf/weight upload

        # per-model device-resident footprint: packed node tables, leaf
        # values, tree weights, and the fused path's binning tables (f32
        # [F, padded-B] thresholds + [F, padded-C] categories + two [F]
        # int32 vectors)
        F = self.num_features
        bin_table_bytes = 0
        if self._device_bin_err is None:
            pb, pc = self._bin_table_widths()
            bin_table_bytes = F * pb * 4 + F * pc * 4 + 2 * F * 4
        self.table_bytes = int(
            sum(a.nbytes for a in packed_arrays.values())
            + self._default_left.nbytes + self._is_cat_node.nbytes
            + self._na_bin.nbytes + self._leaf_f32.nbytes
            + 4 * len(self.trees) + bin_table_bytes)

    @property
    def fused_ok(self) -> bool:
        """Whether :meth:`fused_predict` can serve this model."""
        return self.fused_reason is None

    def _traverse(self, binned: torch.Tensor) -> torch.Tensor:
        d = self._dev
        return traverse_forest_binned(
            binned, d["split_feature"], d["threshold_bin"],
            d["default_left"], d["left_child"], d["right_child"],
            d["na_bin"], d["is_cat_node"], d["cat_index"],
            d["cat_table"], steps=self._steps)

    # -- construction ------------------------------------------------------
    @staticmethod
    def _uint_dtype(max_val: int):
        """Narrowest unsigned dtype holding [0, max_val]."""
        if max_val <= np.iinfo(np.uint8).max:
            return np.uint8
        if max_val <= np.iinfo(np.uint16).max:
            return np.uint16
        return np.int32

    @staticmethod
    def _int_dtype(min_val: int, max_val: int):
        """Narrowest signed dtype holding [min_val, max_val]."""
        for dt in (np.int8, np.int16):
            ii = np.iinfo(dt)
            if ii.min <= min_val and max_val <= ii.max:
                return dt
        return np.int32

    def _packed_host_arrays(self) -> Dict[str, np.ndarray]:
        """The node tables at their device dtypes (serve_packed_tables:
        narrowest dtype the model's bin/node/feature counts allow;
        ``packed=False`` keeps everything int32).  The stump sentinel
        threshold re-encodes as the packed dtype's max — every real
        rank is strictly below it, so ``rank <= sentinel`` stays
        always-true.  The forest kernels widen every gathered value
        back to int32 (predict_device, csrc/forest.cu), so packing
        changes bytes moved, never decisions."""
        out: Dict[str, np.ndarray] = {}
        if not self.packed:
            out["split_feature"] = self._split_feature
            out["threshold_bin"] = self._threshold_bin
            out["left_child"] = self._left_child
            out["right_child"] = self._right_child
            out["cat_index"] = self._cat_index
            out["cat_table"] = self._cat_table
            return out
        M = self._split_feature.shape[1] if self._split_feature.size \
            else 1
        L = self._leaf_slots
        max_rank = max([t.num_bins - 1 for t in self.tables] + [1])
        thr_dt = self._uint_dtype(max_rank + 1)   # +1: sentinel slot
        sentinel = np.iinfo(thr_dt).max
        out["threshold_bin"] = np.where(
            self._threshold_bin == _ALWAYS_LEFT, sentinel,
            self._threshold_bin).astype(thr_dt)
        child_dt = self._int_dtype(-L, M - 1)
        out["left_child"] = self._left_child.astype(child_dt)
        out["right_child"] = self._right_child.astype(child_dt)
        out["split_feature"] = self._split_feature.astype(
            self._uint_dtype(max(self.num_features - 1, 0)))
        out["cat_index"] = self._cat_index.astype(
            self._uint_dtype(max(len(self._cat_table) - 1, 0)))
        out["cat_table"] = self._cat_table.astype(np.uint8)
        return out

    def _build_soa(self) -> None:
        trees = self.trees
        T = len(trees)
        # node/leaf slots pad to the shared pow2 policy so co-hosted
        # versions of one model family (hot-swap / shadow) land on
        # identical SoA shapes and launch shapes; padded slots cost table
        # memory only
        M = bucket_nodes(max([t.num_nodes() for t in trees] + [1]))
        L = bucket_leaf_slots(max([t.num_leaves for t in trees] + [1]))
        self._leaf_slots = L
        self._split_feature = np.zeros((T, M), np.int32)
        self._threshold_bin = np.zeros((T, M), np.int32)
        self._default_left = np.zeros((T, M), bool)
        self._left_child = np.full((T, M), -1, np.int32)
        self._right_child = np.full((T, M), -1, np.int32)
        self._is_cat_node = np.zeros((T, M), bool)
        self._cat_index = np.zeros((T, M), np.int32)
        self.leaf_values = np.zeros((T, L), np.float64)
        self._na_bin = np.asarray([tab.na_bin for tab in self.tables],
                                  np.int32)
        cat_rows: List[np.ndarray] = []
        max_cat_bins = max([tab.num_bins for tab in self.tables
                            if tab.kind == "cat"] + [1])
        depth = 1
        for ti, t in enumerate(trees):
            n = t.num_nodes()
            self.leaf_values[ti, :t.num_leaves] = t.leaf_value[:t.num_leaves]
            if t.num_leaves <= 1:
                # stump: the padded root routes every row (NaN included)
                # to leaf 0
                self._threshold_bin[ti, 0] = _ALWAYS_LEFT
                self._default_left[ti, 0] = True
                continue
            depth = max(depth, t.max_depth())
            sf = t.split_feature[:n]
            dt = t.decision_type[:n]
            is_cat = (dt & _CAT_BIT) != 0
            self._split_feature[ti, :n] = sf
            self._default_left[ti, :n] = (dt & _DEFAULT_LEFT_BIT) != 0
            self._left_child[ti, :n] = t.left_child[:n]
            self._right_child[ti, :n] = t.right_child[:n]
            self._is_cat_node[ti, :n] = is_cat
            for f in np.unique(sf[~is_cat]):
                tab = self.tables[int(f)]
                m = (sf == f) & ~is_cat
                self._threshold_bin[ti, :n][m] = np.searchsorted(
                    tab.thresholds, t.threshold[:n][m], side="left")
            for i in np.nonzero(is_cat)[0]:
                tab = self.tables[int(sf[i])]
                # rank row over the feature's model-wide category table:
                # 0 = in this node's left set, 1 = not (sentinel bin —
                # unseen / negative / NaN — is always 1 -> right, the
                # _cat_contains fall-through)
                row = np.ones(max_cat_bins, np.int32)
                if len(tab.cats):
                    contained = t._cat_contains(
                        int(t.threshold[i]), tab.cats.astype(np.float64))
                    row[:len(tab.cats)] = np.where(contained, 0, 1)
                self._cat_index[ti, i] = len(cat_rows)
                cat_rows.append(row)
                # threshold_bin stays 0: go left iff rank <= 0
        self._cat_table = (np.stack(cat_rows) if cat_rows
                           else np.zeros((1, 1), np.int32))
        self._steps = bucket_steps(depth)
        # host->device transfer dtype for host-binned batches: bins are
        # bounded by the model's own table sizes, so the [N, F] binned
        # matrix usually crosses the wire as uint8
        max_bin = max([tab.num_bins - 1 for tab in self.tables] + [1])
        self._bin_dtype = self._uint_dtype(max_bin) if self.packed \
            else np.int32
        # device binning needs every categorical value f32-exact (the
        # fused path compares trunc(f32 x) against an f32 category
        # table); a model using categories at/above 2^24 serves via the
        # host paths instead
        self._device_bin_err: Optional[str] = None
        for f, tab in enumerate(self.tables):
            if tab.kind == "cat" and len(tab.cats) \
                    and float(np.abs(tab.cats).max()) >= _F32_EXACT_INT:
                self._device_bin_err = (
                    f"feature {f} uses categories beyond f32's exact "
                    f"integer range (>= 2^24); device binning would "
                    "misroute them")
                break

    def _fingerprint(self) -> str:
        h = hashlib.sha256()
        h.update(f"{len(self.trees)}:{self.num_class}:"
                 f"{self.num_features}".encode())
        for arr in (self._split_feature, self._threshold_bin,
                    self._left_child, self.leaf_values,
                    np.asarray(self.tree_weights, np.float64)):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()[:16]

    # -- binning -----------------------------------------------------------
    def bin_rows(self, x: np.ndarray) -> np.ndarray:
        """Exact host-side (f64) model-derived binning: [n, F] float ->
        [n, F] int32 in each feature's own bin space."""
        x = np.asarray(x, np.float64)
        out = np.zeros(x.shape, np.int32)
        for f, tab in enumerate(self.tables):
            if tab.kind == "num":
                v = x[:, f]
                isnan = np.isnan(v)
                if tab.miss_nan:
                    out[:, f] = np.where(
                        isnan, tab.na_bin,
                        np.searchsorted(tab.thresholds,
                                        np.where(isnan, 0.0, v), "left"))
                else:
                    out[:, f] = np.searchsorted(
                        tab.thresholds, np.where(isnan, 0.0, v), "left")
            elif tab.kind == "cat" and len(tab.cats):
                v = x[:, f]
                # trunc-toward-zero + NaN/inf -> -1, exactly
                # tree_model._decide's CategoricalDecision input mapping
                iv = np.where(np.isfinite(v), v, -1.0).astype(np.int64)
                pos = np.searchsorted(tab.cats, iv)
                pos = np.clip(pos, 0, len(tab.cats) - 1)
                out[:, f] = np.where(tab.cats[pos] == iv, pos,
                                     len(tab.cats))
        return out

    def _bucket(self, n: int) -> int:
        # the shared bucketing policy (utils/shapes.py)
        return bucket_rows(n, min_bucket=self.min_bucket,
                           cap=self.max_batch)

    def _bin_table_widths(self) -> Tuple[int, int]:
        """Padded (threshold, category) table widths: pow2 via the
        shared policy, so a co-hosted version with a few more distinct
        thresholds keeps the same table shapes."""
        b = bucket_bins(
            max([len(t.thresholds) for t in self.tables] + [1]))
        c = max([len(t.cats) for t in self.tables] + [0])
        return b, (bucket_bins(c, floor=4) if c else 0)

    def _device_bin_tables(self):
        if self._device_bin_err:
            raise EngineUnsupported(self._device_bin_err)
        dev = self._bin_dev
        if dev is not None:
            # lock-free fast path: the tuple is published whole under the
            # lock below, so a non-None read is a complete table set
            return dev
        # build-once under the lock: two first-batch threads must not
        # upload the tables twice
        with self._lock:
            if self._bin_dev is None:
                F = self.num_features
                B, C = self._bin_table_widths()
                thr = np.full((F, B), np.inf, np.float32)
                zero_bin = np.zeros(F, np.int32)
                cat_vals = np.full((F, C), np.inf, np.float32)
                cat_len = np.zeros(F, np.int32)
                for f, tab in enumerate(self.tables):
                    if tab.kind == "num":
                        thr[f, :len(tab.thresholds)] = tab.thresholds
                        zero_bin[f] = np.searchsorted(tab.thresholds,
                                                      0.0, "left")
                    elif tab.kind == "cat" and len(tab.cats):
                        cat_vals[f, :len(tab.cats)] = tab.cats
                        cat_len[f] = len(tab.cats)
                self._bin_dev = tuple(_upload(a, self.device) for a in
                                      (thr, zero_bin, cat_vals, cat_len))
            return self._bin_dev

    def _rows_f32(self, sub: np.ndarray, bucket: int) -> torch.Tensor:
        xpad = np.zeros((bucket, self.num_features), np.float32)
        xpad[:len(sub)] = sub
        return torch.from_numpy(xpad).to(self.device)

    # -- traversal ---------------------------------------------------------
    def leaf_ids(self, x: np.ndarray,
                 device_binning: bool = False) -> np.ndarray:
        """Leaf index per (row, tree): [n, F] raw floats -> [n, T] int32.
        Batches above the bucket cap are processed in max-bucket chunks;
        zero rows never touch the device."""
        x = np.asarray(x, np.float64)
        n = len(x)
        T = len(self.trees)
        if n == 0 or T == 0:
            return np.zeros((n, T), np.int32)
        cap = self._bucket(n)
        chunks = []
        for lo in range(0, n, cap):
            sub = x[lo:lo + cap]
            bucket = self._bucket(len(sub))
            with self._lock:
                self._buckets_seen[bucket] = \
                    self._buckets_seen.get(bucket, 0) + 1
            if device_binning:
                thr, zero_bin, cat_vals, cat_len = \
                    self._device_bin_tables()
                binned = bin_rows_device_full(
                    self._rows_f32(sub, bucket), thr, self._dev["na_bin"],
                    zero_bin, cat_vals, cat_len)
            else:
                pad = np.zeros((bucket, self.num_features),
                               self._bin_dtype)
                pad[:len(sub)] = self.bin_rows(sub)
                binned = _upload(pad, self.device)
            # the host path's ONE device fetch: leaf ids are the data the
            # host accumulation needs
            out = self._traverse(binned)[:len(sub)].cpu().numpy()
            chunks.append(np.asarray(out, np.int32))
        return np.concatenate(chunks, axis=0)

    # -- fused device-resident path ----------------------------------------
    def _fused_dev_arrays(self):
        dev = self._fused_dev
        if dev is not None:
            return dev          # lock-free fast path, published whole
        with self._lock:        # build-once (see _device_bin_tables)
            if self._fused_dev is None:
                self._fused_dev = (_upload(self._leaf_f32, self.device),
                                   _upload(self._w32, self.device))
            return self._fused_dev

    def _fused_call(self, xdev: torch.Tensor) -> torch.Tensor:
        d = self._dev
        thr, zero_bin, cat_vals, cat_len = self._device_bin_tables()
        leaf_value, tree_weight = self._fused_dev_arrays()
        return fused_forest_predict(
            xdev, thr, d["na_bin"], zero_bin, cat_vals, cat_len,
            d["split_feature"], d["threshold_bin"], d["default_left"],
            d["left_child"], d["right_child"], d["is_cat_node"],
            d["cat_index"], d["cat_table"], leaf_value, tree_weight,
            self._avg_denom, steps=self._steps, num_class=self.num_class)

    def fused_predict(self, x: np.ndarray,
                      raw_score: bool = False) -> np.ndarray:
        """Full prediction through the ONE device-resident kernel (B10c:
        bin -> walk -> accumulate) and the objective's transform as torch
        ops on the device: [n, F] raw floats -> final f32 scores, with a
        SINGLE device-to-host copy per bucket chunk, the final scores.
        Raises :class:`EngineUnsupported` when :attr:`fused_reason` is set
        (linear trees, f32-inexact categories); callers fall back to the
        host paths (serve/server.py counts ``serve.host_fallback_batches``).
        Accumulation is f32 in tree order — the contract
        :meth:`_fused_reference` replays and :meth:`self_check` enforces;
        against the exact host path the difference is the f64 -> f32
        accumulation rounding, ``serve_device_binning``'s accepted cost."""
        if self.fused_reason is not None:
            raise EngineUnsupported(self.fused_reason)
        x = np.asarray(x, np.float64)
        n = len(x)
        k = self.num_class
        if n == 0:
            return np.zeros((0, k) if k > 1 else (0,), np.float32)
        transform = None if raw_score else self._transform
        cap = self._bucket(n)
        chunks = []
        for lo in range(0, n, cap):
            sub = x[lo:lo + cap]
            bucket = self._bucket(len(sub))
            with self._lock:
                self._fused_buckets[bucket] = \
                    self._fused_buckets.get(bucket, 0) + 1
            scores = self._fused_call(self._rows_f32(sub, bucket))
            if transform is not None:
                scores = transform(scores)
            # the fused path's ONE device fetch: the final scores
            chunks.append(scores[:len(sub)].cpu().numpy())
        return np.concatenate(chunks, axis=0)

    def _fused_reference(self, x: np.ndarray,
                         raw_score: bool = False) -> np.ndarray:
        """Host oracle for the fused path's parity contract: the SAME f32
        float ops, in the same order, over leaves from the host tree walk
        — f32 leaf-value gather, f32 weight multiply, f32 tree-order
        accumulation, f32 RF averaging — then the objective's transform
        as torch ops on the ENGINE's device, as the fused path applies it
        (a host transform would differ from the card's in the last bit).
        ``self_check`` compares :meth:`fused_predict` against this byte
        for byte on rows where f32 and f64 binning provably agree."""
        x = np.asarray(x, np.float64)
        n = len(x)
        k = self.num_class
        T = len(self.trees)
        if n == 0 or T == 0:
            return np.zeros((0, k) if k > 1 else (0,), np.float32)
        leaves = np.stack([t.predict_leaf(x) for t in self.trees],
                          axis=1).astype(np.int32)
        vals = self._leaf_f32[np.arange(T)[None, :], leaves]
        prods = vals * self._w32[None, :]
        score = np.zeros((n, k), np.float32)
        for ti in range(T):
            score[:, ti % k] += prods[:, ti]
        score = score / np.float32(self._avg_denom)
        out = score if k > 1 else score[:, 0]
        if not raw_score and self._transform is not None:
            out = self._transform(
                torch.from_numpy(np.ascontiguousarray(out)).to(
                    self.device)).cpu().numpy()
        return out

    # -- scoring -----------------------------------------------------------
    def raw_scores(self, x: np.ndarray, t0: int = 0,
                   t1: Optional[int] = None,
                   leaves: Optional[np.ndarray] = None,
                   device_binning: bool = False) -> np.ndarray:
        """[n, num_class] float64 raw scores over trees [t0, t1) —
        float-op-for-float-op identical to ``Booster.predict``'s host
        accumulation (tree order, f64, tree_weights applied)."""
        x = np.asarray(x, np.float64)
        t1 = len(self.trees) if t1 is None else t1
        k = self.num_class
        if leaves is None:
            leaves = self.leaf_ids(x, device_binning=device_binning)
        score = np.zeros((len(x), k))
        for ti in range(t0, t1):
            t = self.trees[ti]
            w = self.tree_weights[ti] if ti < len(self.tree_weights) else 1.0
            lv = leaves[:, ti]
            vals = t.linear_leaf_outputs(lv, x) if t.is_linear \
                else t.leaf_value[lv]
            score[:, ti % k] += w * vals
        return score

    def predict(self, x, raw_score: bool = False,
                device_binning: bool = False) -> np.ndarray:
        """Full-model prediction with the ``Booster.predict`` output
        contract (averaging for RF, objective output conversion — the
        shared ``booster._finalize_score`` tail)."""
        from ..booster import _finalize_score
        x = np.asarray(x, np.float64)
        k = self.num_class
        n, t1 = len(x), len(self.trees)
        if n == 0:
            out_f32 = not raw_score and self.objective is not None
            shape = (0, k) if k > 1 else (0,)
            return np.zeros(shape, np.float32 if out_f32 else np.float64)
        score = self.raw_scores(x, device_binning=device_binning)
        return _finalize_score(score, k, self.objective,
                               self.average_output, 0, t1, raw_score)

    # -- verification ------------------------------------------------------
    def _probe_candidates(self) -> List[np.ndarray]:
        """Per-feature probe values aimed at the engine's risk surface:
        the model's own split thresholds (exact tie inputs — the values
        f32 rounding would misroute), midpoints between consecutive
        thresholds, out-of-range values, NaN, and every categorical's
        in/out-of-set and unseen values."""
        cands: List[np.ndarray] = []
        for tab in self.tables:
            if tab.kind == "num" and len(tab.thresholds):
                t = tab.thresholds
                mids = (t[:-1] + t[1:]) / 2.0 if len(t) > 1 \
                    else np.empty(0)
                c = np.concatenate([t, mids, [t[0] - 1.0, t[-1] + 1.0,
                                              0.0, np.nan]])
            elif tab.kind == "cat" and len(tab.cats):
                c = np.concatenate([tab.cats.astype(np.float64),
                                    [tab.cats[-1] + 1.0, -1.0, np.nan]])
            else:
                c = np.zeros(1)
            cands.append(c)
        return cands

    def _f32_consensus_mask(self, x: np.ndarray) -> np.ndarray:
        """Rows whose f32 on-device binning provably agrees with the
        exact f64 binning — only those can be byte-compared against the
        host walk (``serve_device_binning`` documents tie inexactness
        as the mode's accepted cost, so tie rows prove nothing)."""
        exact = self.bin_rows(x)
        ok = np.ones(len(x), bool)
        for f, tab in enumerate(self.tables):
            if tab.kind == "cat" and len(tab.cats):
                # integer-exact on device IF trunc(f32 x) == trunc(f64
                # x): only f32 rounding of the raw value can diverge
                v = x[:, f]
                iv64 = np.where(np.isfinite(v), v, -1.0).astype(np.int64)
                vf = v.astype(np.float32)
                iv32 = np.where(np.isfinite(vf), np.trunc(vf), -1.0)
                ok &= iv32 == iv64
                continue
            if tab.kind != "num" or not len(tab.thresholds):
                continue
            v = x[:, f]
            isnan = np.isnan(v)
            # mirror bin_rows_device: f32 value vs f32 threshold table;
            # NaN takes the f64-derived na/zero fallback, never f32 ops
            b32 = np.searchsorted(
                tab.thresholds.astype(np.float32),
                np.where(isnan, 0.0, v).astype(np.float32),
                side="left").astype(np.int64)
            nan_bin = tab.na_bin if tab.miss_nan else np.searchsorted(
                tab.thresholds, 0.0, side="left")
            b32 = np.where(isnan, nan_bin, b32)
            ok &= b32 == exact[:, f]
        return ok

    def self_check(self, max_rows: int = 64,
                   max_total_rows: int = 4096,
                   device_binning: bool = False) -> bool:
        """Post-build parity canary: walk deterministic probe batches on
        the device and require the scores to be byte-identical to the
        host tree walk (``Tree.predict_leaf`` leaves fed through the SAME
        :meth:`raw_scores` accumulation, so the comparison isolates the
        device walk + binning).  Probes run in ``max_rows`` chunks until
        EVERY feature's candidate list has cycled through (capped at
        ``max_total_rows``).  ``device_binning`` additionally verifies the
        f32 on-device binning path (B10b) on probe rows where f32 and f64
        binning provably agree and, for a fused-capable model, the fused
        kernel (B10c) against :meth:`_fused_reference` on those rows (the
        transformed scores, or the raw ones when the objective's
        transform is not ported).  True = verified; False = the device
        tables or kernels disagree with the model they were built from;
        callers then serve by the host walk (serve/registry.py).  A
        kernel that does not build or launch raises."""
        cands = self._probe_candidates()
        if not cands or not self.trees:
            return True
        total = min(max(len(c) for c in cands), max_total_rows)
        for off in range(0, total, max_rows):
            rows = min(max_rows, total - off)
            probe = np.zeros((rows, self.num_features), np.float64)
            idx = off + np.arange(rows)
            for f, c in enumerate(cands):
                probe[:, f] = c[idx % len(c)]
            host_leaves = np.stack(
                [t.predict_leaf(probe) for t in self.trees],
                axis=1).astype(np.int32)
            host = self.raw_scores(probe, leaves=host_leaves)
            if not np.array_equal(self.raw_scores(probe), host):
                return False
            if device_binning:
                mask = self._f32_consensus_mask(probe)
                if mask.any():
                    if not np.array_equal(
                            self.raw_scores(probe[mask],
                                            device_binning=True),
                            host[mask]):
                        return False
                    if self.fused_reason is None and not np.array_equal(
                            self.fused_predict(probe[mask]),
                            self._fused_reference(probe[mask])):
                        return False
        return True

    # -- introspection -----------------------------------------------------
    def per_row_flops_bytes(self, fused: bool = False) -> Tuple[int, int]:
        """Static (flops, bytes) per served row: needs the JAX package's
        ``obs/flops.py`` formulas, not ported yet."""
        raise NotImplementedError(
            "per_row_flops_bytes needs obs/flops.py, which is not ported "
            "to lightgbm_torch yet (ROADMAP A15)")

    def compile_stats(self) -> dict:
        """Bucket ledger: the buckets used (with hit counts, host-binned
        and fused paths separately), the bound on distinct launch shapes,
        the process-wide launches of the forest kernels
        (``_kernels.LAUNCHES``), fused availability and the packed table
        footprint.  A CUDA kernel does not recompile per shape, so there
        are no traces to count."""
        with self._lock:
            buckets = dict(sorted(self._buckets_seen.items()))
            fused_buckets = dict(sorted(self._fused_buckets.items()))
        cap = self.max_batch or max(list(buckets) + list(fused_buckets)
                                    + [self.min_bucket])
        bound = int(math.ceil(math.log2(max(cap, 2)))) + 1
        counts = _kernels.launch_counts()
        return {"fingerprint": self.fingerprint, "buckets": buckets,
                "fused_buckets": fused_buckets,
                "max_shapes_bound": bound,
                "launches_process": {k: counts[k] for k in
                                     ("forest_walk", "bin_rows",
                                      "fused_predict")},
                "device": str(self.device),
                "fused": self.fused_reason is None,
                "fused_reason": self.fused_reason,
                "packed": self.packed,
                "table_bytes": self.table_bytes,
                "threshold_dtype":
                    str(np.dtype(self._host_dtypes["threshold_bin"])),
                "child_dtype": str(np.dtype(self._host_dtypes["left_child"])),
                "steps": self._steps, "num_trees": len(self.trees)}

    @classmethod
    def from_booster(cls, booster, *, max_batch: Optional[int] = None,
                     min_bucket: int = 16, packed: bool = True,
                     device_type: Optional[str] = None) -> "PredictorEngine":
        """Flatten a ``Booster`` (live or loaded from a model file), on
        ``device_type``'s device (default: the booster's)."""
        return cls(booster.trees, booster.tree_weights,
                   booster._num_tree_per_iteration,
                   booster.num_feature(),
                   objective=getattr(booster, "objective", None),
                   average_output=booster._average_output,
                   max_batch=max_batch, min_bucket=min_bucket,
                   packed=packed,
                   device_type=device_type or booster.config.device_type)
