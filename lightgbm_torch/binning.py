"""Feature discretization (value -> bin), copied from the JAX package.

Re-implements the reference BinMapper semantics
(include/LightGBM/bin.h:61-235, src/io/bin.cpp ``FindBin`` /
``GreedyFindBin``): greedy equal-count numerical binning with
``min_data_in_bin``, a dedicated zero bin (|v| <= kZeroThreshold), three
missing-value modes (None/Zero/NaN, bin.h ``MissingType``), and count-sorted
categorical bins.  Host-side preprocessing in NumPy (the reference also bins
on CPU); the binned matrix handed to the learner is a device array.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence

import numpy as np

kZeroThreshold = 1e-35


class BinType(enum.Enum):
    NUMERICAL = 0
    CATEGORICAL = 1


class MissingType(enum.Enum):
    NONE = 0
    ZERO = 1
    NAN = 2


def _forced_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int, min_data_in_bin: int,
                     forced_bounds) -> List[float]:
    """FindBinWithPredefinedBin analog (src/io/bin.cpp; forced bounds come
    from ``forcedbins_filename``, dataset_loader.cpp:519-524): the forced
    upper bounds become mandatory boundaries; the remaining bin budget is
    distributed over the inter-boundary segments proportionally to their
    sample counts and filled greedily within each segment."""
    forced = sorted({float(f) for f in forced_bounds})
    lo = float(distinct_values[0]) if len(distinct_values) else 0.0
    hi = float(distinct_values[-1]) if len(distinct_values) else 0.0
    forced = [f for f in forced if lo <= f < hi][:max(max_bin - 1, 0)]
    if not forced:
        return _greedy_find_bin(distinct_values, counts, max_bin, total_cnt,
                                min_data_in_bin)
    edges = [-np.inf] + forced + [np.inf]
    seg_budget_total = max_bin - len(forced)
    segs = []
    for i in range(len(edges) - 1):
        m = (distinct_values > edges[i]) & (distinct_values <= edges[i + 1])
        segs.append((distinct_values[m], counts[m]))
    seg_cnts = np.array([int(c.sum()) for _, c in segs], dtype=np.float64)
    weights = seg_cnts / max(seg_cnts.sum(), 1.0)
    bounds: List[float] = list(forced)
    for (vals, cnts), w in zip(segs, weights):
        if len(vals) == 0:
            continue
        b = max(1, int(round(seg_budget_total * w)))
        sub = _greedy_find_bin(vals, cnts, b, int(cnts.sum()),
                               min_data_in_bin)
        bounds.extend(x for x in sub if np.isfinite(x))
    uniq = sorted(set(bounds))
    if len(uniq) > max_bin - 1:
        # per-segment minimum budgets (max(1, ...)) can overshoot; drop
        # GREEDY bounds only — forced boundaries are mandatory (they were
        # already capped to max_bin-1 above, so they always fit)
        fset = set(forced)
        greedy_keep = (max_bin - 1) - len(fset)
        uniq = sorted(fset | set(
            [x for x in uniq if x not in fset][:max(greedy_keep, 0)]))
    return uniq + [np.inf]


def _zero_aware_find_bin(distinct: np.ndarray, counts: np.ndarray,
                         max_bin: int, total_cnt: int,
                         min_data_in_bin: int) -> np.ndarray:
    """FindBinWithZeroAsOneBin (bin.cpp:256): the numeric axis is split
    at zero — negative values bin with a budget proportional to their
    share, the band (-kZeroThreshold, kZeroThreshold] is ALWAYS its own
    bin whenever positive values exist (even with zero count 0: the
    reference reserves it so unseen zeros at prediction time land in a
    well-defined bin), and positives take the remaining budget.
    ``distinct`` is sorted with near-zeros already collapsed to 0.0."""
    left = distinct < 0.0
    right = distinct > 0.0
    cnt_zero = int(counts[(~left) & (~right)].sum())
    left_cnt = int(counts[left].sum())
    right_cnt = int(counts[right].sum())
    bounds: List[float] = []
    if left.any() and max_bin > 1:
        denom = max(total_cnt - cnt_zero, 1)
        left_max_bin = max(1, int(left_cnt / denom * (max_bin - 1)))
        lb = _greedy_find_bin(distinct[left], counts[left], left_max_bin,
                              left_cnt, min_data_in_bin)
        if lb:
            lb[-1] = -kZeroThreshold
        bounds = list(lb)
    right_max_bin = max_bin - 1 - len(bounds)
    if right.any() and right_max_bin > 0:
        rb = _greedy_find_bin(distinct[right], counts[right],
                              right_max_bin, right_cnt, min_data_in_bin)
        bounds.append(kZeroThreshold)
        bounds.extend(rb)
    else:
        bounds.append(np.inf)
    return np.asarray(bounds, dtype=np.float64)


def _greedy_find_bin(distinct_values: np.ndarray, counts: np.ndarray,
                     max_bin: int, total_cnt: int, min_data_in_bin: int) -> List[float]:
    """Greedy equal-count bin upper bounds over sorted distinct values.

    Equivalent of GreedyFindBin (src/io/bin.cpp): when few distinct values,
    one bin per value (merged up to min_data_in_bin); otherwise large-count
    values get dedicated bins and the rest are accumulated to the running
    mean bin size.  Returns upper bounds; last bound is +inf.
    """
    bounds: List[float] = []
    num_distinct = len(distinct_values)
    if num_distinct == 0:
        return [np.inf]
    if num_distinct <= max_bin:
        cur_cnt = 0
        for i in range(num_distinct - 1):
            cur_cnt += int(counts[i])
            if cur_cnt >= min_data_in_bin:
                bounds.append((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
                cur_cnt = 0
        bounds.append(np.inf)
        return bounds

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, total_cnt // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    # values whose count alone exceeds the mean get their own bin
    is_big = counts >= mean_bin_size
    rest_cnt = total_cnt - int(counts[is_big].sum())
    rest_bins = max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_bin_size = rest_cnt / rest_bins
    else:
        mean_bin_size = np.inf

    if not is_big.any():
        # continuous fast path (no value large enough to demand its own
        # bin — the overwhelmingly common case for real-valued columns):
        # the sequential accumulate-and-reset closes a bin at the first
        # index where the count accumulated since the last close reaches
        # mean_bin_size, i.e. at searchsorted(cumsum, last + mean) —
        # one binary search per BIN instead of one Python iteration per
        # DISTINCT VALUE (a 2000-feature Epsilon-shaped construct spent
        # ~50 s in this loop; this form is milliseconds).  Output is
        # identical to the loop below.
        cum = np.cumsum(counts)
        total = float(cum[-1])
        last = 0.0
        for closed in range(max_bin - 1):
            j = int(np.searchsorted(cum, last + mean_bin_size,
                                    side="left"))
            if j >= num_distinct - 1:
                break
            bounds.append((float(distinct_values[j])
                           + float(distinct_values[j + 1])) / 2.0)
            last = float(cum[j])
            # adaptive mean (bin.cpp GreedyFindBin recomputes
            # mean_bin_size from the REMAINING samples and bins after
            # every close) — a fixed mean drifts high when early bins
            # overshoot and silently loses tail bins
            mean_bin_size = (total - last) / (max_bin - closed - 1)
        bounds.append(np.inf)
        return bounds

    # mixed big/small values: the reference's sequential form with BOTH
    # of its subtleties — a pending small bin closes early before a big
    # value only once it holds >= half the mean, and the mean is
    # recomputed from the REMAINING small samples/bins after every
    # small-bin close (GreedyFindBin, bin.cpp:78)
    cur_cnt = 0
    bin_cnt = 0
    rest_sample = rest_cnt
    for i in range(num_distinct - 1):
        if not is_big[i]:
            rest_sample -= int(counts[i])
        cur_cnt += int(counts[i])
        close = (bool(is_big[i]) or cur_cnt >= mean_bin_size
                 or (bool(is_big[i + 1])
                     and cur_cnt >= max(1.0, mean_bin_size * 0.5)))
        if close:
            bounds.append((float(distinct_values[i]) + float(distinct_values[i + 1])) / 2.0)
            bin_cnt += 1
            if bin_cnt >= max_bin - 1:
                break
            cur_cnt = 0
            if not is_big[i]:
                rest_bins -= 1
                mean_bin_size = rest_sample / max(rest_bins, 1)
    bounds.append(np.inf)
    return bounds


class BinMapper:
    """Per-feature value->bin mapping (bin.h:61-235 analog)."""

    def __init__(self):
        self.num_bin: int = 1
        self.bin_type: BinType = BinType.NUMERICAL
        self.missing_type: MissingType = MissingType.NONE
        self.is_trivial: bool = True
        self.bin_upper_bound: np.ndarray = np.array([np.inf])
        # categorical
        self.categories: np.ndarray = np.array([], dtype=np.int64)  # bin i -> category
        self._cat_to_bin: Dict[int, int] = {}
        self.default_bin: int = 0      # bin of value 0.0 (most common for sparse)
        self.most_freq_bin: int = 0
        self.sparse_rate: float = 0.0
        # exact fraction of the fit sample that lands in bin 0 (incl.
        # NaNs when they map there); 1.0 = "unknown" — the conservative
        # value for the EFB pigeonhole pre-check (dataset.py), which
        # needs a LOWER bound on the non-default rate
        self.bin0_frac: float = 1.0

    # -- fit ---------------------------------------------------------------
    def find_bin(self, values: np.ndarray, total_sample_cnt: int, max_bin: int,
                 min_data_in_bin: int, min_split_data: int = 0,
                 pre_filter: bool = False, bin_type: BinType = BinType.NUMERICAL,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_bounds: Optional[Sequence[float]] = None) -> None:
        """Fit the mapping from sampled ``values`` (bin.cpp FindBin analog).

        ``values`` are the sampled non-trivial rows; zeros that were not
        sampled are accounted through ``total_sample_cnt``.
        """
        values = np.asarray(values, dtype=np.float64)
        na_cnt = int(np.isnan(values).sum())
        vals = values[~np.isnan(values)]
        zero_cnt = int(total_sample_cnt - len(vals) - na_cnt
                       + (np.abs(vals) <= kZeroThreshold).sum())

        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NAN if na_cnt > 0 else MissingType.NONE

        if bin_type == BinType.CATEGORICAL:
            self._find_bin_categorical(vals, total_sample_cnt, max_bin, min_data_in_bin)
            return

        # collapse |v|<=eps to exactly 0 so the zero bin is well defined
        vals = np.where(np.abs(vals) <= kZeroThreshold, 0.0, vals)
        n_implicit_zero = total_sample_cnt - len(values)
        distinct, counts = np.unique(vals, return_counts=True)
        if len(distinct) > 0 and n_implicit_zero > 0:
            zpos = np.searchsorted(distinct, 0.0)
            if zpos < len(distinct) and distinct[zpos] == 0.0:
                counts[zpos] += n_implicit_zero
            else:
                distinct = np.insert(distinct, zpos, 0.0)
                counts = np.insert(counts, zpos, n_implicit_zero)
        elif len(distinct) == 0 and n_implicit_zero > 0:
            distinct, counts = np.array([0.0]), np.array([n_implicit_zero])

        self._fit_numerical_from_distinct(
            distinct, counts, na_cnt, max_bin, min_data_in_bin,
            min_split_data, pre_filter, forced_bounds)

    def _fit_numerical_from_distinct(
            self, distinct: np.ndarray, counts: np.ndarray, na_cnt: int,
            max_bin: int, min_data_in_bin: int, min_split_data: int = 0,
            pre_filter: bool = False,
            forced_bounds: Optional[Sequence[float]] = None) -> None:
        """The numerical FindBin tail shared by the raw-values path above
        and the streaming sketch path (:meth:`find_bin_from_sketch`):
        ``distinct``/``counts`` are the sorted distinct non-NaN values
        (|v| <= kZeroThreshold already collapsed to 0.0, implicit zeros
        already merged) with their sample counts.  ``self.missing_type``
        must already be decided by the caller."""
        distinct = np.asarray(distinct, dtype=np.float64)
        counts = np.asarray(counts)
        zero_cnt = int(counts[distinct == 0.0].sum()) if len(distinct) else 0
        budget = max_bin - 1 if self.missing_type == MissingType.NAN else max_bin
        budget = max(budget, 2) if len(distinct) > 1 else max(budget, 1)
        total_non_na = int(counts.sum())
        if forced_bounds:
            bounds = _forced_find_bin(distinct, counts, budget, total_non_na,
                                      min_data_in_bin, forced_bounds)
        else:
            bounds = _zero_aware_find_bin(distinct, counts, budget,
                                          total_non_na, min_data_in_bin)

        # make sure zero sits alone in its bin boundary band when present
        # (FindBin carves [-kZeroThreshold, kZeroThreshold] out, bin.cpp)
        ub = np.array(bounds, dtype=np.float64)
        self.bin_upper_bound = ub
        self.num_bin = len(ub) + (1 if self.missing_type == MissingType.NAN else 0)
        self.is_trivial = self.num_bin <= 1
        if not self.is_trivial and pre_filter and min_split_data > 0:
            # NeedFilter (bin.cpp:54): a feature is useful only if SOME
            # threshold puts >= min_split_data rows on both sides —
            # e.g. a constant non-zero column has 2 bins (the reserved
            # zero bin is empty) but can never split, so it is trivial
            cnt_in_bin = np.zeros(len(ub), np.int64)
            np.add.at(cnt_in_bin, np.searchsorted(ub, distinct,
                                                  side="left"),
                      counts.astype(np.int64))
            if self.missing_type == MissingType.NAN:
                cnt_in_bin = np.append(cnt_in_bin, na_cnt)
            left = np.cumsum(cnt_in_bin[:-1])
            total_all = int(cnt_in_bin.sum())
            if not ((left >= min_split_data)
                    & (total_all - left >= min_split_data)).any():
                self.is_trivial = True
        # bin of literal zero / most frequent bin
        self.default_bin = int(np.searchsorted(ub, 0.0, side="left"))
        if len(counts) > 0:
            mf_val = distinct[int(np.argmax(counts))]
            self.most_freq_bin = int(np.searchsorted(ub, mf_val, side="left"))
            self.sparse_rate = float(counts.max() / max(total_non_na, 1))
        # exact bin-0 occupancy of the sample: cumulative count of the
        # distinct values at/below the first upper bound (bin 0 may merge
        # SEVERAL distinct values — sparse_rate, the single most frequent
        # VALUE's share, underestimates it), plus NaN rows when the
        # missing policy routes them to the zero bin
        if len(counts) > 0 and len(ub) > 0:
            in_bin0 = int(counts[distinct <= ub[0]].sum())
            if self.missing_type == MissingType.ZERO:
                in_bin0 += na_cnt
            self.bin0_frac = in_bin0 / max(total_non_na + na_cnt, 1)
        if self.missing_type == MissingType.ZERO and zero_cnt + na_cnt == 0:
            self.missing_type = MissingType.NONE

    def _find_bin_categorical(self, vals: np.ndarray, total_sample_cnt: int,
                              max_bin: int, min_data_in_bin: int) -> None:
        cats = vals.astype(np.int64)
        cats = cats[cats >= 0]  # negative categoricals treated as missing (bin.cpp warns)
        uniq, counts = np.unique(cats, return_counts=True)
        self._fit_categorical_from_distinct(uniq, counts, max_bin)

    def _fit_categorical_from_distinct(self, uniq: np.ndarray,
                                       counts: np.ndarray,
                                       max_bin: int) -> None:
        """Categorical FindBin tail over distinct non-negative categories
        and their counts (shared with the sketch path)."""
        self.bin_type = BinType.CATEGORICAL
        if len(uniq) == 0:
            self.num_bin = 1
            self.is_trivial = True
            return
        order = np.argsort(-counts, kind="stable")  # count-sorted, most frequent first
        uniq, counts = uniq[order], counts[order]
        # drop overly rare cats beyond the bin budget (rare -> unseen at split)
        keep = min(len(uniq), max_bin - 1 if self.missing_type != MissingType.NONE else max_bin)
        cut = counts >= 1
        uniq, counts = uniq[:keep][cut[:keep]], counts[:keep][cut[:keep]]
        self.categories = uniq
        self._cat_to_bin = {int(c): i for i, c in enumerate(uniq)}
        self.num_bin = len(uniq) + (1 if self.missing_type == MissingType.NAN else 0)
        self.is_trivial = len(uniq) <= 1
        self.most_freq_bin = 0
        self.default_bin = self._cat_to_bin.get(0, 0)

    def find_bin_from_sketch(self, sketch: "QuantileSketch", max_bin: int,
                             min_data_in_bin: int, min_split_data: int = 0,
                             pre_filter: bool = False,
                             use_missing: bool = True,
                             zero_as_missing: bool = False,
                             forced_bounds: Optional[Sequence[float]] = None
                             ) -> None:
        """Fit the mapping from a streaming :class:`QuantileSketch`
        instead of materialized raw values — the one-pass out-of-core
        binning path (lightgbm_tpu/ingest.py) and the distributed
        sketch-allgather path (parallel/dist_data.py).

        Equivalence contract (docs/Ingest.md): while the sketch never
        compacted (``sketch.compactions == 0`` — every distinct value
        retained, the dense small-bin regime) the fitted bounds are
        BYTE-IDENTICAL to :meth:`find_bin` over the same rows; after
        compaction each greedy boundary's rank displacement is bounded
        by the sketch's rank-error bound (~2·n/capacity rows per
        compaction generation)."""
        na_cnt = int(sketch.na_cnt)
        if not use_missing:
            self.missing_type = MissingType.NONE
        elif zero_as_missing:
            self.missing_type = MissingType.ZERO
        else:
            self.missing_type = MissingType.NAN if na_cnt > 0 \
                else MissingType.NONE
        if sketch.categorical:
            uniq, counts = sketch.categorical_counts()
            self._fit_categorical_from_distinct(uniq, counts, max_bin)
            return
        self._fit_numerical_from_distinct(
            sketch.values, sketch.counts, na_cnt, max_bin,
            min_data_in_bin, min_split_data, pre_filter, forced_bounds)

    # -- transform ---------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized ValueToBin (bin.h:486-524)."""
        values = np.asarray(values, dtype=np.float64)
        if self.bin_type == BinType.CATEGORICAL:
            out = np.zeros(len(values), dtype=np.int32)
            cats = np.where(np.isnan(values), -1, values).astype(np.int64)
            if len(self.categories) > 0:
                sorter = np.argsort(self.categories)
                sorted_cats = self.categories[sorter]
                pos = np.searchsorted(sorted_cats, cats)
                pos = np.clip(pos, 0, len(sorted_cats) - 1)
                found = sorted_cats[pos] == cats
                out = np.where(found, sorter[pos], 0).astype(np.int32)
            if self.missing_type == MissingType.NAN:
                out = np.where(np.isnan(values) | (values < 0), self.num_bin - 1, out)
            return out

        nan_mask = np.isnan(values)
        vals = np.where(nan_mask, 0.0, values)
        vals = np.where(np.abs(vals) <= kZeroThreshold, 0.0, vals)
        if self.missing_type == MissingType.ZERO:
            vals = np.where(nan_mask, 0.0, vals)  # NaN -> zero bin
        bins = np.searchsorted(self.bin_upper_bound, vals, side="left").astype(np.int32)
        if self.missing_type == MissingType.NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins

    def bin_to_value(self, b: int) -> float:
        """Representative value of a bin (used for threshold real values)."""
        if self.bin_type == BinType.CATEGORICAL:
            if 0 <= b < len(self.categories):
                return float(self.categories[b])
            return -1.0
        if self.missing_type == MissingType.NAN and b == self.num_bin - 1:
            return float("nan")
        return float(self.bin_upper_bound[min(b, len(self.bin_upper_bound) - 1)])

    @property
    def na_bin(self) -> int:
        if self.missing_type == MissingType.NAN:
            return self.num_bin - 1
        if self.missing_type == MissingType.ZERO:
            return self.default_bin
        return -1

    # -- serialization (dataset binary cache) -------------------------------
    def to_state(self) -> dict:
        return {
            "num_bin": self.num_bin,
            "bin_type": self.bin_type.value,
            "missing_type": self.missing_type.value,
            "is_trivial": self.is_trivial,
            "bin_upper_bound": self.bin_upper_bound,
            "categories": self.categories,
            "default_bin": self.default_bin,
            "most_freq_bin": self.most_freq_bin,
            "sparse_rate": self.sparse_rate,
            "bin0_frac": self.bin0_frac,
        }

    @classmethod
    def from_state(cls, st: dict) -> "BinMapper":
        m = cls()
        m.num_bin = int(st["num_bin"])
        m.bin_type = BinType(int(st["bin_type"]))
        m.missing_type = MissingType(int(st["missing_type"]))
        m.is_trivial = bool(st["is_trivial"])
        m.bin_upper_bound = np.asarray(st["bin_upper_bound"], dtype=np.float64)
        m.categories = np.asarray(st["categories"], dtype=np.int64)
        m._cat_to_bin = {int(c): i for i, c in enumerate(m.categories)}
        m.default_bin = int(st["default_bin"])
        m.most_freq_bin = int(st["most_freq_bin"])
        m.sparse_rate = float(st["sparse_rate"])
        m.bin0_frac = float(st.get("bin0_frac", 1.0))
        return m


# ---------------------------------------------------------------------------
# Mergeable quantile sketch (streaming / distributed FindBin substrate)
# ---------------------------------------------------------------------------

class QuantileSketch:
    """Fixed-capacity mergeable summary of one feature's value
    distribution — the streaming substrate FindBin fits from when the
    raw rows never fit in host RAM (arXiv:1804.06755's per-shard
    sketches merged into global bin bounds; arXiv:1611.01276's
    ship-summaries-not-samples communication argument).

    The sketch keeps sorted distinct (value, count) pairs and is EXACT
    — a lossless ``np.unique`` of everything it has seen — until the
    distinct count exceeds ``capacity``.  Past capacity it compacts
    deterministically: representatives are picked at equal
    cumulative-count targets (first, last and the 0.0 zero-band value
    are always retained — the zero-aware FindBin carve-out needs the
    exact zero count) and each dropped value's count folds into the
    nearest retained representative on its left.  One compaction moves
    no value's rank by more than the largest folded segment, ~2·n/
    capacity rows; ``compactions`` counts the generations so callers
    can report the bound (docs/Ingest.md "Equivalence").

    ``update`` and ``merge`` are deterministic pure functions of the
    (state, input) pair — every process merging the same shard
    sketches in the same rank order derives byte-identical global
    bounds, which is what lets ``parallel/dist_data.py`` allgather
    sketches instead of raw samples.

    Categorical mode (``categorical=True``) never compacts: category
    ids are identity-significant, so the sketch is an exact value->
    count map (real categorical cardinalities are far below any sane
    capacity; a pathological one should raise, not silently merge
    categories).
    """

    __slots__ = ("capacity", "categorical", "values", "counts", "n",
                 "na_cnt", "compactions")

    STATE_VERSION = 1

    def __init__(self, capacity: int = 2048, categorical: bool = False):
        self.capacity = max(16, int(capacity))
        self.categorical = bool(categorical)
        self.values = np.empty(0, np.float64)
        self.counts = np.empty(0, np.int64)
        self.n = 0                  # total non-NaN rows seen
        self.na_cnt = 0
        self.compactions = 0

    # -- ingest -----------------------------------------------------------
    def update(self, values: np.ndarray) -> "QuantileSketch":
        """Fold a batch of raw values (NaNs counted separately)."""
        values = np.asarray(values, dtype=np.float64)
        nan_mask = np.isnan(values)
        self.na_cnt += int(nan_mask.sum())
        vals = values[~nan_mask]
        if len(vals) == 0:
            return self
        if not self.categorical:
            # the FindBin preprocessing, applied at ingest time so the
            # lossless regime reproduces find_bin() byte-for-byte
            vals = np.where(np.abs(vals) <= kZeroThreshold, 0.0, vals)
        distinct, counts = np.unique(vals, return_counts=True)
        self._fold(distinct, counts.astype(np.int64))
        self.n += int(len(vals))
        return self

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Deterministically absorb another sketch (same feature)."""
        if other.categorical != self.categorical:
            raise ValueError("cannot merge categorical and numerical "
                             "sketches")
        self._fold(other.values, other.counts)
        self.n += int(other.n)
        self.na_cnt += int(other.na_cnt)
        self.compactions = max(self.compactions, int(other.compactions))
        return self

    def _fold(self, distinct: np.ndarray, counts: np.ndarray) -> None:
        if len(self.values) == 0:
            merged_v, merged_c = distinct, counts
        else:
            allv = np.concatenate([self.values, distinct])
            allc = np.concatenate([self.counts, counts])
            order = np.argsort(allv, kind="stable")
            allv, allc = allv[order], allc[order]
            # sum counts of duplicate values
            uniq_mask = np.empty(len(allv), bool)
            uniq_mask[0] = True
            np.not_equal(allv[1:], allv[:-1], out=uniq_mask[1:])
            idx = np.cumsum(uniq_mask) - 1
            merged_v = allv[uniq_mask]
            merged_c = np.zeros(len(merged_v), np.int64)
            np.add.at(merged_c, idx, allc)
        if not self.categorical and len(merged_v) > self.capacity:
            merged_v, merged_c = self._compact(merged_v, merged_c)
            self.compactions += 1
        self.values, self.counts = merged_v, merged_c

    def _compact(self, v: np.ndarray, c: np.ndarray):
        """Deterministic capacity-bounded compaction (class docstring)."""
        k = self.capacity
        cum = np.cumsum(c, dtype=np.float64)
        total = cum[-1]
        # representative index per equal-weight target (one per slot)
        targets = (np.arange(1, k + 1) / k) * total
        keep = np.searchsorted(cum, targets, side="left")
        keep = np.minimum(keep, len(v) - 1)
        keep = np.union1d(keep, [0, len(v) - 1])
        zpos = np.searchsorted(v, 0.0)
        if zpos < len(v) and v[zpos] == 0.0:
            keep = np.union1d(keep, [zpos])   # exact zero count survives
        new_v = v[keep]
        # fold each dropped value's count into the retained
        # representative at or to its RIGHT (ranks never move left past
        # a representative, so bin upper bounds stay upper bounds)
        seg = np.searchsorted(keep, np.arange(len(v)), side="left")
        new_c = np.zeros(len(keep), np.int64)
        np.add.at(new_c, seg, c)
        return new_v, new_c

    # -- queries ----------------------------------------------------------
    def zero_count(self) -> int:
        z = np.searchsorted(self.values, 0.0)
        if z < len(self.values) and self.values[z] == 0.0:
            return int(self.counts[z])
        return 0

    def categorical_counts(self):
        """(uniq int64 cats >= 0, counts) for the categorical tail."""
        cats = self.values.astype(np.int64)
        ok = cats >= 0
        return cats[ok], self.counts[ok]

    # -- serialization (the distributed allgather payload) ----------------
    def to_state(self) -> dict:
        return {"version": self.STATE_VERSION,
                "capacity": int(self.capacity),
                "categorical": bool(self.categorical),
                "values": self.values, "counts": self.counts,
                "n": int(self.n), "na_cnt": int(self.na_cnt),
                "compactions": int(self.compactions)}

    @classmethod
    def from_state(cls, st: dict) -> "QuantileSketch":
        if int(st.get("version", -1)) != cls.STATE_VERSION:
            raise ValueError(
                f"unsupported sketch state version {st.get('version')!r}")
        s = cls(int(st["capacity"]), bool(st["categorical"]))
        s.values = np.asarray(st["values"], np.float64)
        s.counts = np.asarray(st["counts"], np.int64)
        s.n = int(st["n"])
        s.na_cnt = int(st["na_cnt"])
        s.compactions = int(st["compactions"])
        return s


def sketch_features(x: np.ndarray, sketches: List[QuantileSketch]) -> None:
    """Fold one raw row-chunk ``[n, F]`` into F per-feature sketches."""
    if x.shape[1] != len(sketches):
        raise ValueError(f"chunk has {x.shape[1]} features, "
                         f"{len(sketches)} sketches")
    for f, sk in enumerate(sketches):
        sk.update(x[:, f])


def fit_mappers_from_sketches(sketches: Sequence[QuantileSketch],
                              config, cat_idx: Optional[set] = None
                              ) -> List[BinMapper]:
    """One BinMapper per feature sketch under ``config``'s binning
    params — the FindBin step of the streaming ingest pass
    (lightgbm_tpu/ingest.py) and of the distributed sketch allgather
    (parallel/dist_data.py).  ``config`` is duck-typed (a
    ``config.Config``): only the binning-relevant attributes are read."""
    cat_idx = cat_idx or set()
    mbf = config.max_bin_by_feature
    mappers: List[BinMapper] = []
    for f, sk in enumerate(sketches):
        m = BinMapper()
        mb = int(mbf[f]) if mbf else config.max_bin
        m.find_bin_from_sketch(
            sk, mb, config.min_data_in_bin,
            min_split_data=config.min_data_in_leaf,
            pre_filter=config.feature_pre_filter,
            use_missing=config.use_missing,
            zero_as_missing=config.zero_as_missing)
        mappers.append(m)
    return mappers
