"""Host-side tree model: serialization + raw-feature prediction.

Analog of the reference ``Tree`` (include/LightGBM/tree.h:25-729,
src/io/tree.cpp): array-encoded binary tree with leaves addressed as
``~leaf_index`` in child pointers.  Text serialization follows the reference
model format (``Tree::ToString`` tree.cpp / gbdt_model_text.cpp:311) so
models round-trip and stay ecosystem-compatible: per-node
``decision_type`` bit-field (bit0 categorical, bit1 default-left,
bits2-3 missing type), real-valued thresholds (bin upper bounds), and
categorical splits stored as bitsets over raw category values.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from .binning import BinMapper, BinType, MissingType

_CAT_BIT = 1          # decision_type bit 0: categorical split
_DEFAULT_LEFT_BIT = 2  # bit 1
_MISSING_SHIFT = 2     # bits 2-3: 0 none / 1 zero / 2 nan


class Tree:
    """A single decision tree in host (NumPy) form."""

    def __init__(self, num_leaves: int):
        self.num_leaves = num_leaves
        n = max(num_leaves - 1, 1)
        self.split_feature = np.zeros(n, np.int32)     # original feature idx
        self.threshold = np.zeros(n, np.float64)       # real-valued threshold
        self.threshold_bin = np.zeros(n, np.int32)
        self.decision_type = np.zeros(n, np.int32)
        self.left_child = np.full(n, -1, np.int32)
        self.right_child = np.full(n, -2, np.int32)
        self.split_gain = np.zeros(n, np.float64)
        self.leaf_value = np.zeros(num_leaves, np.float64)
        self.leaf_weight = np.zeros(num_leaves, np.float64)
        self.leaf_count = np.zeros(num_leaves, np.int64)
        self.internal_value = np.zeros(n, np.float64)
        self.internal_weight = np.zeros(n, np.float64)
        self.internal_count = np.zeros(n, np.int64)
        # categorical storage (tree.h cat_boundaries_/cat_threshold_)
        self.num_cat = 0
        self.cat_boundaries = [0]
        self.cat_threshold: List[int] = []             # packed uint32 bitset words
        self.shrinkage = 1.0
        # linear trees (LinearTreeLearner, linear_tree_learner.cpp): per-leaf
        # linear model out = leaf_const + sum(leaf_coeff * x[leaf_features])
        self.is_linear = False
        self.leaf_const = np.zeros(num_leaves, np.float64)
        self.leaf_features: List[List[int]] = [[] for _ in range(num_leaves)]
        self.leaf_coeff: List[List[float]] = [[] for _ in range(num_leaves)]

    # ------------------------------------------------------------------
    @classmethod
    def from_arrays(cls, arrays, feature_map: Sequence[int],
                    mappers: Sequence[BinMapper]) -> "Tree":
        """Build from the grower's device ``TreeArrays``.

        feature_map: used-feature slot -> original feature index.
        mappers: per original feature (for bin -> real threshold).
        """
        nl = int(arrays.num_leaves)
        t = cls(nl)
        n = max(nl - 1, 0)
        slot_feat = np.asarray(arrays.split_feature)[:n]
        t.split_feature = np.asarray([feature_map[s] for s in slot_feat], np.int32)
        t.threshold_bin = np.asarray(arrays.threshold_bin)[:n].astype(np.int32)
        dl = np.asarray(arrays.default_left)[:n]
        t.left_child = np.asarray(arrays.left_child)[:n].astype(np.int32)
        t.right_child = np.asarray(arrays.right_child)[:n].astype(np.int32)
        t.split_gain = np.asarray(arrays.split_gain)[:n].astype(np.float64)
        t.leaf_value = np.asarray(arrays.leaf_value)[:nl].astype(np.float64)
        t.leaf_weight = np.asarray(arrays.leaf_weight)[:nl].astype(np.float64)
        t.leaf_count = np.rint(np.asarray(arrays.leaf_count)[:nl]).astype(np.int64)
        t.internal_value = np.asarray(arrays.internal_value)[:n].astype(np.float64)
        t.internal_weight = np.asarray(arrays.internal_weight)[:n].astype(np.float64)
        t.internal_count = np.rint(np.asarray(arrays.internal_count)[:n]).astype(np.int64)

        t.threshold = np.zeros(n, np.float64)
        t.decision_type = np.zeros(n, np.int32)
        is_cat_node = np.asarray(arrays.is_cat_node)[:n]
        cat_rank = np.asarray(arrays.cat_rank)[:n]
        for i in range(n):
            f = t.split_feature[i]
            m = mappers[f]
            dt = 0
            if m.missing_type == MissingType.ZERO:
                dt |= 1 << _MISSING_SHIFT
            elif m.missing_type == MissingType.NAN:
                dt |= 2 << _MISSING_SHIFT
            if is_cat_node[i]:
                # left set = bins whose decision rank <= threshold
                # (gradient-ratio subset, ops/split.py categorical scan)
                dt |= _CAT_BIT
                rank = cat_rank[i]
                ncat = len(m.categories)
                sel = [b for b in range(min(ncat, len(rank)))
                       if rank[b] <= t.threshold_bin[i]]
                cats = m.categories[sel]
                t.threshold[i] = t._add_cat_bitset(cats)
            else:
                if dl[i]:
                    dt |= _DEFAULT_LEFT_BIT
                t.threshold[i] = m.bin_to_value(int(t.threshold_bin[i]))
            t.decision_type[i] = dt
        return t

    def _add_cat_bitset(self, cats: np.ndarray) -> int:
        """Append a category bitset; returns the cat-split index stored in
        ``threshold`` (tree.h cat_threshold_ layout)."""
        if len(cats) == 0:
            words = [0]
        else:
            nwords = int(np.max(cats)) // 32 + 1
            arr = np.zeros(nwords, np.uint32)
            for c in cats:
                arr[int(c) // 32] |= np.uint32(1 << (int(c) % 32))
            words = arr.tolist()
        idx = self.num_cat
        self.cat_threshold.extend(int(w) for w in words)
        self.cat_boundaries.append(len(self.cat_threshold))
        self.num_cat += 1
        return float(idx)

    def _cat_contains(self, cat_idx: int, value: float) -> np.ndarray:
        lo, hi = self.cat_boundaries[cat_idx], self.cat_boundaries[cat_idx + 1]
        words = self.cat_threshold[lo:hi]
        v = np.asarray(value)
        iv = np.where(np.isfinite(v), v, -1).astype(np.int64)
        ok = (iv >= 0) & (iv < 32 * len(words))
        word_idx = np.clip(iv // 32, 0, len(words) - 1)
        bits = np.asarray(words, np.uint64)[word_idx]
        return ok & ((bits >> (iv % 32).astype(np.uint64)) & 1).astype(bool)

    # ------------------------------------------------------------------
    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:187)."""
        self.leaf_value *= rate
        self.internal_value *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (tree.h:212)."""
        self.leaf_value += val
        self.internal_value += val

    def num_nodes(self) -> int:
        return max(self.num_leaves - 1, 0)

    def max_depth(self) -> int:
        if self.num_leaves <= 1:
            return 0
        depth = {0: 1}
        best = 1
        for i in range(self.num_nodes()):
            d = depth.get(i, 1)
            for c in (self.left_child[i], self.right_child[i]):
                if c >= 0:
                    depth[c] = d + 1
                    best = max(best, d + 1)
                else:
                    best = max(best, d)
        return best

    # ------------------------------------------------------------------
    def _decide(self, node: int, x_col: np.ndarray) -> np.ndarray:
        """Vectorized per-node decision: True -> left.
        NumericalDecision / CategoricalDecision (tree.h:335-412)."""
        dt = self.decision_type[node]
        if dt & _CAT_BIT:
            return self._cat_contains(int(self.threshold[node]), x_col)
        miss = (dt >> _MISSING_SHIFT) & 3
        default_left = bool(dt & _DEFAULT_LEFT_BIT)
        thr = self.threshold[node]
        v = x_col.astype(np.float64, copy=True)
        isnan = np.isnan(v)
        if miss == 1:   # zero-as-missing: NaN -> 0
            v = np.where(isnan, 0.0, v)
            isnan = np.zeros_like(isnan)
        elif miss == 0:  # no missing handling: NaN -> 0 (tree.h converts)
            v = np.where(isnan, 0.0, v)
            isnan = np.zeros_like(isnan)
        go_left = v <= thr
        if miss == 2:
            go_left = np.where(isnan, default_left, go_left)
        return go_left

    def predict(self, X: np.ndarray) -> np.ndarray:
        leaves = self.predict_leaf(X)
        if not self.is_linear:
            return self.leaf_value[leaves]
        return self.linear_leaf_outputs(leaves, X)

    def linear_leaf_outputs(self, leaves: np.ndarray,
                            X: np.ndarray) -> np.ndarray:
        """Linear-leaf outputs given row->leaf: const + coeffs on raw
        feature values; rows with NaN in used features fall back to the
        constant leaf_value (linear_tree_learner.cpp nan path).  Single
        implementation shared by model prediction and train/valid score
        replay."""
        out = self.leaf_value[leaves].astype(np.float64)
        for leaf in range(self.num_leaves):
            feats = self.leaf_features[leaf]
            if not feats:
                continue
            m = leaves == leaf
            if not m.any():
                continue
            sub = X[np.ix_(m, feats)].astype(np.float64)
            val = self.leaf_const[leaf] + sub @ np.asarray(self.leaf_coeff[leaf])
            out[m] = np.where(np.isnan(sub).any(axis=1),
                              self.leaf_value[leaf], val)
        return out

    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Vectorized level-by-level traversal over raw features."""
        n = len(X)
        if self.num_leaves <= 1:
            return np.zeros(n, np.int32)
        node = np.zeros(n, np.int32)   # >=0 internal, <0 -> leaf ~node
        active = node >= 0
        for _ in range(self.num_leaves):  # depth bound
            if not active.any():
                break
            nid = np.clip(node, 0, None)
            # group rows by node for vectorized decisions
            for u in np.unique(nid[active]):
                rows = active & (nid == u)
                go_left = self._decide(int(u), X[rows, self.split_feature[u]])
                nxt = np.where(go_left, self.left_child[u], self.right_child[u])
                node[rows] = nxt
            active = node >= 0
        return (~node).astype(np.int32)

    # ------------------------------------------------------------------
    def to_string(self, index: int) -> str:
        """Tree::ToString (tree.cpp) — reference text block format."""
        def fmt(arr, f="%g"):
            return " ".join(f % v for v in arr)
        n = self.num_nodes()
        lines = [
            f"Tree={index}",
            f"num_leaves={self.num_leaves}",
            f"num_cat={self.num_cat}",
            f"split_feature={fmt(self.split_feature[:n], '%d')}",
            f"split_gain={fmt(self.split_gain[:n])}",
            f"threshold={fmt(self.threshold[:n], '%.17g')}",
            f"decision_type={fmt(self.decision_type[:n], '%d')}",
            f"left_child={fmt(self.left_child[:n], '%d')}",
            f"right_child={fmt(self.right_child[:n], '%d')}",
            f"leaf_value={fmt(self.leaf_value, '%.17g')}",
            f"leaf_weight={fmt(self.leaf_weight, '%g')}",
            f"leaf_count={fmt(self.leaf_count, '%d')}",
            f"internal_value={fmt(self.internal_value[:n])}",
            f"internal_weight={fmt(self.internal_weight[:n])}",
            f"internal_count={fmt(self.internal_count[:n], '%d')}",
        ]
        if self.num_cat > 0:
            lines.append(f"cat_boundaries={fmt(self.cat_boundaries, '%d')}")
            lines.append(f"cat_threshold={fmt(self.cat_threshold, '%d')}")
        lines.append(f"is_linear={int(self.is_linear)}")
        if self.is_linear:
            # linear-tree block (gbdt_model_text per-leaf linear model lines)
            lines.append(f"leaf_const={fmt(self.leaf_const, '%.17g')}")
            lines.append("num_features=" + " ".join(
                str(len(f_)) for f_ in self.leaf_features))
            lines.append("leaf_features=" + " ".join(
                " ".join(str(int(v)) for v in f_) for f_ in self.leaf_features
                if len(f_)))
            lines.append("leaf_coeff=" + " ".join(
                " ".join(f"{v:.17g}" for v in c_) for c_ in self.leaf_coeff
                if len(c_)))
        lines.append(f"shrinkage={self.shrinkage:g}")
        lines.append("")
        return "\n".join(lines)

    @classmethod
    def from_string(cls, block: str) -> "Tree":
        kv: Dict[str, str] = {}
        for line in block.strip().splitlines():
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k.strip()] = v.strip()
        nl = int(kv["num_leaves"])
        t = cls(nl)

        def arr(key, dtype, size):
            if key not in kv or kv[key] == "":
                return np.zeros(size, dtype)
            return np.asarray(kv[key].split(" "), dtype=dtype)

        n = max(nl - 1, 0)
        t.split_feature = arr("split_feature", np.int32, n)
        t.split_gain = arr("split_gain", np.float64, n)
        t.threshold = arr("threshold", np.float64, n)
        t.decision_type = arr("decision_type", np.int32, n)
        t.left_child = arr("left_child", np.int32, n)
        t.right_child = arr("right_child", np.int32, n)
        t.leaf_value = arr("leaf_value", np.float64, nl)
        t.leaf_weight = arr("leaf_weight", np.float64, nl)
        t.leaf_count = arr("leaf_count", np.int64, nl)
        t.internal_value = arr("internal_value", np.float64, n)
        t.internal_weight = arr("internal_weight", np.float64, n)
        t.internal_count = arr("internal_count", np.int64, n)
        t.num_cat = int(kv.get("num_cat", "0"))
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split(" ")]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split(" ")]
        t.shrinkage = float(kv.get("shrinkage", "1"))
        t.is_linear = bool(int(kv.get("is_linear", "0")))
        if t.is_linear and "leaf_const" in kv:
            t.leaf_const = arr("leaf_const", np.float64, nl)
            nfeat = [int(v) for v in kv.get("num_features", "").split(" ")
                     if v != ""]
            flat_f = [int(v) for v in kv.get("leaf_features", "").split(" ")
                      if v != ""]
            flat_c = [float(v) for v in kv.get("leaf_coeff", "").split(" ")
                      if v != ""]
            t.leaf_features, t.leaf_coeff = [], []
            pos = 0
            for cnt in nfeat:
                t.leaf_features.append(flat_f[pos:pos + cnt])
                t.leaf_coeff.append(flat_c[pos:pos + cnt])
                pos += cnt
            while len(t.leaf_features) < nl:
                t.leaf_features.append([])
                t.leaf_coeff.append([])
        return t
