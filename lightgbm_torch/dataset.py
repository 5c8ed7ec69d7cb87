"""Dataset: the binned training matrix + metadata.

A copy of the JAX package's ``dataset.py`` (the analog of the reference
Dataset/DatasetLoader/Metadata
(include/LightGBM/dataset.h:45-849, src/io/dataset.cpp,
src/io/dataset_loader.cpp)).  Instead of per-group packed ``Bin`` storage the
binned matrix is ONE dense uint8/uint16 ``[num_data, num_features]`` array
handed to the device learner; bin offsets per feature index into a
concatenated histogram axis.

The port covers dense input.  The branches that reach modules it has not
ported yet raise ``NotImplementedError`` naming the ROADMAP item: sparse
binned storage (A11), out-of-core ingest (A17) and the atomic binary-cache
writer (A12).

Supports: numpy / pandas construction, sampled bin-mapper fitting
(bin_construct_sample_cnt, dataset_loader.cpp:961), categorical features,
validation-set alignment to a reference Dataset (dataset.h ``CreateValid``),
and a binary cache file (save_binary, dataset.cpp ``SaveBinaryFile`` analog).
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .binning import BinMapper, BinType, MissingType
from .config import Config
from .efb import EFBInfo, bin_grouped, find_bundles, unbundle


class Metadata:
    """Label / weight / query-boundary / init-score storage
    (dataset.h:45-265, src/io/metadata.cpp analog)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None  # [num_queries+1]
        self.init_score: Optional[np.ndarray] = None

    @staticmethod
    def _avoid_inf(arr: np.ndarray, f32: bool = True) -> np.ndarray:
        """Metadata fields sanitize NaN->0 and clamp +-inf to a large
        finite value (Common::AvoidInf, common.h:658/670: 1e38 for
        float fields, 1e300 for double) — the reference applies this on
        every SetField so downstream math never sees non-finite
        metadata."""
        lim = 1e38 if f32 else 1e300
        return np.nan_to_num(arr, nan=0.0, posinf=lim, neginf=-lim)

    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(label) != self.num_data:
            raise ValueError(f"label length {len(label)} != num_data {self.num_data}")
        self.label = self._avoid_inf(label)

    def set_weight(self, weight) -> None:
        if weight is None:
            self.weight = None
            return
        weight = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(weight) != self.num_data:
            raise ValueError("weight length mismatch")
        weight = self._avoid_inf(weight)
        if (weight < 0).any():
            raise ValueError("weights must be non-negative")
        self.weight = weight

    def set_group(self, group) -> None:
        """``group`` is per-query sizes (python API convention); converted to
        boundaries like Metadata::SetQuery (metadata.cpp)."""
        if group is None:
            self.query_boundaries = None
            return
        group = np.asarray(group, dtype=np.int64).reshape(-1)
        bounds = np.concatenate([[0], np.cumsum(group)])
        if bounds[-1] != self.num_data:
            raise ValueError(f"sum(group)={bounds[-1]} != num_data {self.num_data}")
        self.query_boundaries = bounds.astype(np.int32)

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        s = self._avoid_inf(np.asarray(init_score, dtype=np.float64),
                            f32=False)
        if s.size % self.num_data != 0:
            raise ValueError("init_score size must be num_data * num_class")
        self.init_score = s.reshape(self.num_data, -1) if s.ndim > 1 or s.size != self.num_data \
            else s.reshape(-1)

    @property
    def num_queries(self) -> int:
        if self.query_boundaries is None:
            return 0
        return len(self.query_boundaries) - 1


def fingerprint_arrays(label, weight=None) -> str:
    """The snapshot data fingerprint as a pure function of label/weight
    arrays — shared by :meth:`Dataset.fingerprint` and the elastic
    multi-process snapshot writer (``GBDTModel.snapshot_state``), which
    must stamp the GLOBAL gathered arrays with byte-identical hashing
    so a shrunk relaunch over the full data matches the manifest."""
    import hashlib
    h = hashlib.sha256()
    if label is None:
        h.update(b"unlabeled")
    else:
        lab = np.asarray(label, np.float32).reshape(-1)
        h.update(str(len(lab)).encode())
        h.update(lab.tobytes())
    if weight is not None:
        h.update(np.asarray(weight, np.float32).reshape(-1).tobytes())
    return h.hexdigest()[:16]


def _is_scipy_sparse(data) -> bool:
    return hasattr(data, "tocsc") and hasattr(data, "nnz")


def _sample_rows(rng, n: int, cnt: int) -> np.ndarray:
    """cnt sorted unique row indices, unbiased, in O(cnt) memory (choice
    without replacement builds an O(n) permutation — fatal for out-of-core
    n when cnt << n)."""
    if cnt >= n:
        return np.arange(n, dtype=np.int64)
    if 2 * cnt >= n:  # dense sampling: O(n) = O(2 cnt), permutation is fine
        return np.sort(rng.permutation(n)[:cnt]).astype(np.int64)
    u = np.unique(rng.randint(0, n, size=int(cnt * 1.3) + 16).astype(np.int64))
    while len(u) < cnt:  # collision top-up; cnt < n/2 so this converges fast
        more = rng.randint(0, n, size=cnt).astype(np.int64)
        u = np.unique(np.concatenate([u, more]))
    if len(u) > cnt:  # drop uniformly, NOT from the tail (index bias)
        u = np.sort(rng.choice(u, size=cnt, replace=False))
    return u


class Sequence:
    """Generic batched row-access object for out-of-core construction
    (basic.py:621 ``Sequence`` analog).

    Subclasses implement ``__getitem__`` (int -> 1-D row; slice/list ->
    2-D rows) and ``__len__``.  ``batch_size`` controls how many rows are
    materialized at a time while binning.
    """

    batch_size = 4096

    def __getitem__(self, idx):
        raise NotImplementedError(
            "Sub-classes of lightgbm_torch.Sequence must implement __getitem__()")

    def __len__(self) -> int:
        raise NotImplementedError(
            "Sub-classes of lightgbm_torch.Sequence must implement __len__()")


def _is_seq_input(data) -> bool:
    if isinstance(data, Sequence):
        return True
    return (isinstance(data, (list, tuple)) and len(data) > 0
            and all(isinstance(s, Sequence) for s in data))


def _to_numpy_2d(data) -> tuple:
    """Accept numpy / pandas / scipy-sparse / list-of-lists; return
    (float64 2-D array, names, cat_cols)."""
    feature_names = None
    pandas_categorical: List[int] = []
    if _is_scipy_sparse(data):  # CSR/CSC/COO... (LGBM_*FromCSR/CSC analog)
        arr = np.asarray(data.todense(), dtype=np.float64)
        return np.ascontiguousarray(arr), None, []
    if hasattr(data, "values") and hasattr(data, "columns"):  # pandas DataFrame
        feature_names = [str(c) for c in data.columns]
        cols = []
        for i, c in enumerate(data.columns):
            col = data[c]
            if str(col.dtype) == "category":
                cols.append(col.cat.codes.to_numpy().astype(np.float64))
                pandas_categorical.append(i)
            else:
                cols.append(col.to_numpy().astype(np.float64))
        arr = np.column_stack(cols) if cols else np.empty((len(data), 0))
    elif (isinstance(data, (list, tuple)) and len(data)
          and all(isinstance(c, np.ndarray) and c.ndim == 2
                  for c in data)):
        # list of 2-D row chunks (LGBM_DatasetCreateFromMats semantics —
        # the reference's chunked-dataset path vstacks row blocks)
        arr = np.vstack([np.asarray(c, np.float64) for c in data])
    else:
        arr = np.asarray(data, dtype=np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(-1, 1)
    return np.ascontiguousarray(arr), feature_names, pandas_categorical


class Dataset:
    """Binned dataset (dataset.h:355 analog).

    Lazily constructed like the python-package Dataset (basic.py:1135): raw
    data + params are held until ``construct()`` fits bin mappers and
    produces the packed binned matrix.
    """

    def __init__(self, data, label=None, weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List] = "auto",
                 reference: Optional["Dataset"] = None,
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = False,
                 bin_mappers: Optional[List["BinMapper"]] = None):
        self._raw_input = data
        self._label_in, self._weight_in = label, weight
        self._group_in, self._init_score_in = group, init_score
        self._feature_name_in = feature_name
        self._categorical_in = categorical_feature
        self.reference = reference
        self.params: Dict[str, Any] = dict(params or {})
        self.free_raw_data = free_raw_data
        # externally-fitted mappers (distributed binning,
        # parallel/dist_data.py — dataset_loader.cpp:1104-1186 analog)
        self._preset_mappers = bin_mappers

        self._constructed = False
        self.used_indices = None       # set by subset()
        # filled by construct():
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.bin_mappers: List[BinMapper] = []
        self.used_features: List[int] = []      # indices of non-trivial features
        self.binned: Optional[np.ndarray] = None  # [N, num_used] uint8/uint16
        # k-hot sparse binned storage (sparse_data.py, the sparse_bin.hpp
        # analog) — set INSTEAD of ``binned`` when it is smaller
        self.binned_sparse = None
        self.bin_offsets: Optional[np.ndarray] = None  # [num_used+1] cumulative bins
        self.metadata: Optional[Metadata] = None
        self.feature_names: List[str] = []
        self.raw_data: Optional[np.ndarray] = None
        self.max_bin: int = 255
        self.efb: Optional[EFBInfo] = None  # set when bundling merged columns

    # ------------------------------------------------------------------
    @staticmethod
    def _bin_signature(cfg: Config) -> dict:
        """The config fields that shape binning — a mismatch after
        construction means training would silently use stale bins
        (255-bin histograms could then be measured while 63 bins are
        reported)."""
        return {
            "max_bin": cfg.max_bin,
            "min_data_in_bin": cfg.min_data_in_bin,
            "bin_construct_sample_cnt": cfg.bin_construct_sample_cnt,
            "max_bin_by_feature": tuple(cfg.max_bin_by_feature or ()),
            "enable_bundle": cfg.enable_bundle,
            "categorical_feature": cfg.categorical_feature,
            "use_missing": cfg.use_missing,
            "zero_as_missing": cfg.zero_as_missing,
            "forcedbins_filename": cfg.forcedbins_filename,
        }

    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self._constructed:
            # reference parity (basic.py "Ignoring params... dataset already
            # constructed"): binning params cannot change after construction
            # — warn loudly instead of silently training on the old bins
            built = getattr(self, "_built_bin_sig", None)
            if config is not None and built is not None \
                    and self._bin_signature(config) != built:
                # warn only about binning params the caller EXPLICITLY
                # passed (a booster config carries defaults for every
                # param — a dataset built with its own max_bin would
                # otherwise warn on every construct(self.config) touch)
                from .config import _ALIASES
                explicit = {_ALIASES.get(k, k) for k in config.raw_params}
                sig_now = self._bin_signature(config)
                conflict = {k for k, v in sig_now.items()
                            if k in explicit and built.get(k) != v}
                if conflict:
                    from .utils.log import Log
                    Log.warning(
                        "Ignoring binning params passed at train time "
                        f"({sorted(conflict)}): Dataset was already "
                        f"constructed with {built}; pass params to the "
                        "Dataset constructor instead")
            return self
        cfg = config or Config(self.params)
        self._built_bin_sig = self._bin_signature(cfg)
        if _is_seq_input(self._raw_input):
            return self._construct_from_seqs(cfg)
        sparse_in = _is_scipy_sparse(self._raw_input)
        if sparse_in:
            # CSR/CSC input (LGBM_DatasetCreateFromCSR/CSC, c_api.h:109-313
            # analog): bin column-at-a-time off the CSC layout — the only
            # dense product is the packed uint8 binned matrix.
            csc = self._raw_input.tocsc()
            if not csc.has_sorted_indices:
                # the sampled-column searchsorted path needs sorted
                # per-column indices; copy so the caller's matrix is untouched
                csc = csc.copy()
                csc.sort_indices()
            names, pandas_cat = None, []
            self.num_data, self.num_total_features = csc.shape

            def colfn(f: int) -> np.ndarray:
                out = np.zeros(self.num_data, np.float64)
                lo, hi = csc.indptr[f], csc.indptr[f + 1]
                out[csc.indices[lo:hi]] = csc.data[lo:hi]
                return out

            def sample_col_factory(rows: np.ndarray):
                # O(nnz_col)-per-column sampled access straight off the CSC
                # layout — no N-length dense intermediate
                def col(f: int) -> np.ndarray:
                    lo, hi = csc.indptr[f], csc.indptr[f + 1]
                    idx, dat = csc.indices[lo:hi], csc.data[lo:hi]
                    out = np.zeros(len(rows), np.float64)
                    if len(idx):
                        pos = np.minimum(np.searchsorted(idx, rows),
                                         len(idx) - 1)
                        hit = idx[pos] == rows
                        out[hit] = dat[pos[hit]]
                    return out
                return col

            arr = None
        else:
            arr, names, pandas_cat = _to_numpy_2d(self._raw_input)
            self.num_data, self.num_total_features = arr.shape

            def colfn(f: int) -> np.ndarray:
                return arr[:, f]

            sample_col_factory = None
        self._set_metadata_inputs()
        self._resolve_names(names)
        cat_idx = self._resolve_cats(cfg, pandas_cat)

        if self._preset_mappers is not None:
            self.bin_mappers = list(self._preset_mappers)
            self._finalize_mappers()
        elif self.reference is not None:
            # validation set: reuse the training set's bin mappers
            # (Dataset::CreateValid, dataset.cpp)
            ref = self.reference.construct(config)
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.bin_offsets = ref.bin_offsets
            self.max_bin = ref.max_bin
            self.efb = ref.efb
        else:
            self._fit_bin_mappers(colfn, cfg, cat_idx,
                                  sample_col_factory=sample_col_factory)

        self._bin_data(colfn, cfg, csc if sparse_in else None)
        keep_raw = (not self.free_raw_data) or bool(cfg.linear_tree)
        self._built_linear_tree = bool(cfg.linear_tree)  # save_binary raw rule
        if sparse_in:
            if cfg.linear_tree and self.num_total_features:
                # linear trees need dense raw values (dataset.h:836 raw_data_)
                self.raw_data = np.column_stack(
                    [colfn(f) for f in range(self.num_total_features)])
            elif keep_raw:
                # keep the sparse matrix itself: predict() accepts CSR, so
                # init_model / refit paths keep working without densifying
                self.raw_data = csc.tocsr()
            else:
                self.raw_data = None
        else:
            self.raw_data = arr if keep_raw else None
        self._constructed = True
        self._raw_input = None
        return self

    def _set_metadata_inputs(self) -> None:
        self.metadata = Metadata(self.num_data)
        if self._label_in is not None:
            self.metadata.set_label(self._label_in)
        self.metadata.set_weight(self._weight_in)
        self.metadata.set_group(self._group_in)
        self.metadata.set_init_score(self._init_score_in)

    def _resolve_names(self, names) -> None:
        if self._feature_name_in != "auto" and self._feature_name_in is not None:
            self.feature_names = list(self._feature_name_in)
        elif names is not None:
            self.feature_names = names
        else:
            self.feature_names = [f"Column_{i}" for i in range(self.num_total_features)]

    def _resolve_cats(self, cfg: Config, pandas_cat) -> set:
        cat_idx = set(pandas_cat)
        if self._categorical_in != "auto" and self._categorical_in is not None:
            for c in self._categorical_in:
                if isinstance(c, str):
                    if c in self.feature_names:
                        cat_idx.add(self.feature_names.index(c))
                else:
                    cat_idx.add(int(c))
        elif isinstance(cfg.categorical_feature, str) and cfg.categorical_feature:
            for tok in cfg.categorical_feature.split(","):
                tok = tok.strip()
                if tok:
                    cat_idx.add(int(tok))
        return cat_idx

    def _construct_from_seqs(self, cfg: Config) -> "Dataset":
        """Out-of-core construction from ``Sequence`` objects
        (basic.py:1574 ``__init_from_seqs``): sample rows for bin-mapper
        fitting, then bin batch-by-batch — the full raw matrix is never
        materialized."""
        if cfg.linear_tree:
            raise ValueError("linear_tree requires in-memory raw data; "
                             "Sequence input is streaming-only")
        seqs = ([self._raw_input] if isinstance(self._raw_input, Sequence)
                else list(self._raw_input))
        lens = [len(s) for s in seqs]
        self.num_data = int(sum(lens))
        probe = np.asarray(seqs[0][0], dtype=np.float64).reshape(-1)
        self.num_total_features = probe.shape[0]
        self._set_metadata_inputs()
        self._resolve_names(None)
        cat_idx = self._resolve_cats(cfg, [])

        if self._preset_mappers is not None:
            # distributed binning handoff (parallel/dist_data.py) works for
            # streaming input too
            self.bin_mappers = list(self._preset_mappers)
            self._finalize_mappers()
        elif self.reference is not None:
            ref = self.reference.construct(cfg)
            self.bin_mappers = ref.bin_mappers
            self.used_features = ref.used_features
            self.bin_offsets = ref.bin_offsets
            self.max_bin = ref.max_bin
            self.efb = ref.efb
        else:
            sample_cnt = min(self.num_data, int(cfg.bin_construct_sample_cnt))
            rng = np.random.RandomState(cfg.data_random_seed)
            gidx = _sample_rows(rng, self.num_data, sample_cnt)
            bounds = np.concatenate([[0], np.cumsum(lens)])
            rows = []
            for si, s in enumerate(seqs):
                loc = gidx[(gidx >= bounds[si]) & (gidx < bounds[si + 1])] \
                    - bounds[si]
                if len(loc) == 0:
                    continue
                try:  # list indexing is optional in the Sequence protocol
                    rows.append(np.asarray(s[list(loc)], dtype=np.float64))
                except (TypeError, IndexError):
                    rows.append(np.asarray([s[int(i)] for i in loc],
                                           dtype=np.float64))
            sample = np.vstack(rows)
            # EFB bundling needs whole-column access; fresh streaming input
            # stays un-bundled (do_bundle=False skips the conflict-graph work)
            self._fit_bin_mappers(lambda f: sample[:, f], cfg, cat_idx,
                                  n=len(sample), do_bundle=False)

        dtype = np.uint8 if self.max_bin <= 256 else np.uint16
        nf = len(self.used_features)
        out = np.zeros((self.num_data, max(nf, 1)), dtype=dtype)
        row = 0
        for s in seqs:
            bs = int(getattr(s, "batch_size", None) or Sequence.batch_size)
            for i in range(0, len(s), bs):
                chunk = np.atleast_2d(np.asarray(s[i:min(i + bs, len(s))],
                                                 dtype=np.float64))
                for j, f in enumerate(self.used_features):
                    out[row:row + len(chunk), j] = \
                        self.bin_mappers[f].value_to_bin(chunk[:, f]).astype(dtype)
                row += len(chunk)
        if self.efb is not None:
            # a bundled reference set: regroup the per-feature bins into the
            # EFB-grouped layout consumers read (models/gbdt.py)
            self.binned = bin_grouped(lambda j: out[:, j].astype(np.int64),
                                      self.efb, self.num_data)
        else:
            self.binned = out
        self.raw_data = None
        self._constructed = True
        if self.free_raw_data:
            self._raw_input = None
        # else: keep the Sequence list — get_data() returns it (basic.py
        # keeps self.data = the sequences when free_raw_data=False)
        return self

    def _fit_bin_mappers(self, colfn, cfg: Config, cat_idx: set,
                         n: Optional[int] = None,
                         do_bundle: bool = True,
                         sample_col_factory=None) -> None:
        n = self.num_data if n is None else n
        sample_cnt = min(n, int(cfg.bin_construct_sample_cnt))
        # deterministic sampled rows (SampleTextDataFromFile analog,
        # dataset_loader.cpp:961) via data_random_seed
        if sample_cnt < n:
            rng = np.random.RandomState(cfg.data_random_seed)
            sample_rows = _sample_rows(rng, n, sample_cnt)
            if sample_col_factory is not None:
                sample_col = sample_col_factory(sample_rows)
            else:
                sample_col = lambda f: colfn(f)[sample_rows]  # noqa: E731
        elif sample_col_factory is not None:
            sample_col = sample_col_factory(np.arange(n, dtype=np.int64))
        else:
            sample_col = colfn
        # may arrive as list OR ndarray (the reference accepts both;
        # `if ndarray` would raise on truthiness)
        max_bin_by_feature = cfg.max_bin_by_feature
        if max_bin_by_feature is not None and len(max_bin_by_feature) == 0:
            max_bin_by_feature = None
        forced = {}
        if getattr(cfg, "forcedbins_filename", ""):
            # forced bin upper bounds (dataset_loader.cpp:519-524): JSON
            # list of {"feature": i, "bin_upper_bound": [...]}
            import json
            with open(cfg.forcedbins_filename) as fh:
                for entry in json.load(fh):
                    forced[int(entry["feature"])] = [
                        float(v) for v in entry.get("bin_upper_bound", [])]
        self.bin_mappers = []
        for f in range(self.num_total_features):
            m = BinMapper()
            mb = int(max_bin_by_feature[f]) if max_bin_by_feature is not None \
                else cfg.max_bin
            bt = BinType.CATEGORICAL if f in cat_idx else BinType.NUMERICAL
            m.find_bin(sample_col(f), sample_cnt, mb, cfg.min_data_in_bin,
                       # the reference scales the pre-filter threshold
                       # to the SAMPLE (dataset_loader.cpp:687:
                       # min_data_in_leaf * sample_size / num_data) —
                       # num_data is the true row count, NOT the n the
                       # streaming path passes (= its sample length)
                       min_split_data=int(cfg.min_data_in_leaf
                                          * sample_cnt
                                          / max(self.num_data, 1)),
                       pre_filter=cfg.feature_pre_filter, bin_type=bt,
                       use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
                       forced_bounds=forced.get(f))
            self.bin_mappers.append(m)
        self._finalize_mappers()

        if do_bundle and cfg.enable_bundle and len(self.used_features) > 1:
            # EFB over the fitting sample (FastFeatureBundling,
            # dataset.cpp:239; see efb.py)
            mappers = [self.bin_mappers[f] for f in self.used_features]
            # pigeonhole pre-check: a pair can bundle only if
            # nz_i + nz_j - S <= budget (their non-default rows can't
            # all avoid each other otherwise).  If even the two
            # sparsest features fail that bound, no bundle is possible
            # and the whole conflict-sampling pass — a second
            # value_to_bin over every feature, the dominant cost on
            # wide DENSE data like Epsilon — is provably a no-op.
            # nz comes from the mapper's EXACT bin-0 occupancy
            # (bin0_frac; NOT 1-sparse_rate, which is the single most
            # frequent VALUE's share and under-counts a bin 0 that
            # merged several values — that would disable real bundles).
            # Unknown occupancy (loaded mappers) is 1.0 -> nz 0 -> the
            # gate never fires and the full conflict count runs.
            nz_frac = np.sort([1.0 - m.bin0_frac for m in mappers])
            if nz_frac[0] + nz_frac[1] - 1.0 > cfg.max_conflict_rate:
                self.efb = None
                return
            sample_bins = np.column_stack(
                [m.value_to_bin(sample_col(f)) for m, f
                 in zip(mappers, self.used_features)])
            efb = find_bundles(
                sample_bins,
                np.asarray([m.num_bin for m in mappers]),
                np.asarray([m.bin_type == BinType.CATEGORICAL
                            for m in mappers]),
                np.asarray([m.most_freq_bin for m in mappers]),
                max_conflict_rate=cfg.max_conflict_rate)
            self.efb = efb if efb.any_bundled else None

    def _finalize_mappers(self) -> None:
        self.used_features = [f for f in range(self.num_total_features)
                              if not self.bin_mappers[f].is_trivial]
        if not self.used_features and self.num_total_features > 0:
            # ALL features trivial (constant data): keep one
            # unsplittable placeholder column so training degrades to
            # stump trees — predictions become the boosted average,
            # matching the reference, which happily trains on constant
            # data (test_engine.py check_constant_features) instead of
            # erroring out
            self.used_features = [0]
        nbins = [self.bin_mappers[f].num_bin for f in self.used_features]
        self.bin_offsets = np.concatenate([[0], np.cumsum(nbins)]).astype(np.int32)
        self.max_bin = max([2] + nbins)

    def _try_sparse_bin(self, cfg, csc) -> bool:
        """Sparse binned storage decision (sparse_bin.hpp:73 /
        multi_val_sparse_bin.hpp analog — see sparse_data.py).

        Taken only for scipy-sparse input with ``is_enable_sparse`` on:
        collect the non-default-bin entries O(nnz) off the CSC layout,
        then keep the padded k-hot layout iff it is smaller than the
        dense (post-EFB bundled) matrix it replaces — for Allstate-class
        width (13.2M x 4228, docs/Experiments.rst:32) that is ~4K bytes/row
        vs G bytes/row, the difference between fitting one chip's HBM or
        not.  Never chosen under linear_tree (needs dense raw values)."""
        nf = len(self.used_features)
        if (cfg is None or csc is None or not cfg.is_enable_sparse
                or cfg.linear_tree or nf == 0):
            return False
        raise NotImplementedError(
            "sparse binned storage (sparse_data.py) is not ported to "
            "lightgbm_torch yet (ROADMAP A11); construct the Dataset with "
            "is_enable_sparse=false to bin sparse input densely")

    def _bin_data(self, colfn, cfg=None, csc=None) -> None:
        nf = len(self.used_features)
        if self._try_sparse_bin(cfg, csc):
            return
        if self.efb is not None:
            self.binned = bin_grouped(
                lambda j: self.bin_mappers[self.used_features[j]]
                .value_to_bin(colfn(self.used_features[j])),
                self.efb, self.num_data)
            return
        dtype = np.uint8 if self.max_bin <= 256 else np.uint16
        out = np.zeros((self.num_data, max(nf, 1)), dtype=dtype)
        for j, f in enumerate(self.used_features):
            out[:, j] = self.bin_mappers[f].value_to_bin(colfn(f)).astype(dtype)
        self.binned = out

    def feature_binned(self) -> np.ndarray:
        """Per-feature binned matrix [N, F] (ungrouping EFB bundles if
        present) — for learners that take the flat layout."""
        self.construct()
        if self.binned_sparse is not None:
            if self.binned_sparse.nbytes() > 2**28:
                from .utils.log import Log
                Log.warning("densifying a large sparse-binned dataset "
                            "([N, F] materialization) — prefer the serial/"
                            "data-parallel learners, which consume the "
                            "sparse layout directly")
            return self.binned_sparse.densify()
        if self.efb is None:
            return self.binned
        nb = np.asarray([self.bin_mappers[f].num_bin
                         for f in self.used_features])
        return unbundle(self.binned, self.efb, nb)

    # ------------------------------------------------------------------
    @property
    def num_features(self) -> int:
        """Number of used (non-trivial) features."""
        return len(self.used_features)

    @property
    def num_total_bins(self) -> int:
        return int(self.bin_offsets[-1]) if self.bin_offsets is not None else 0

    def get_label(self) -> np.ndarray:
        self.construct()
        return self.metadata.label

    def get_init_score(self):
        self.construct()
        return self.metadata.init_score

    def get_data(self):
        """Raw feature values (basic.py get_data).  Raises once the raw
        values were freed (free_raw_data=True after construction), like
        the reference, instead of silently returning None."""
        if self.raw_data is not None:
            return self.raw_data
        if self._raw_input is not None:
            return self._raw_input
        if self.used_indices is not None and self.reference is not None:
            # subset of a Sequence-backed parent: gather rows lazily
            # through the Sequence protocol only when actually asked
            rows = self.reference._raw_rows(self.used_indices)
            if rows is not None:
                return rows
        raise ValueError(
            "raw data was freed: construct the Dataset with "
            "free_raw_data=False to keep it available")

    def get_field(self, field_name: str):
        """Generic metadata accessor (basic.py get_field)."""
        self.construct()
        md = self.metadata
        if field_name == "label":
            return md.label
        if field_name == "weight":
            return md.weight
        if field_name in ("group", "query"):
            return md.query_boundaries
        if field_name == "init_score":
            return md.init_score
        raise ValueError(f"unknown field {field_name!r}")

    def set_field(self, field_name: str, data) -> "Dataset":
        """Generic metadata setter (basic.py set_field)."""
        if field_name == "label":
            return self.set_label(data)
        if field_name == "weight":
            return self.set_weight(data)
        if field_name in ("group", "query"):
            return self.set_group(data)
        if field_name == "init_score":
            return self.set_init_score(data)
        raise ValueError(f"unknown field {field_name!r}")

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Align binning with another dataset (basic.py set_reference);
        only valid before construction."""
        if self._constructed:
            raise ValueError(
                "cannot set reference after the dataset is constructed")
        self.reference = reference
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        if self._constructed:
            raise ValueError("cannot change categorical_feature after "
                             "construction")
        self._categorical_in = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        names = list(feature_name)
        # validate against whatever width is known NOW — post-construct
        # the resolved names, pre-construct the raw input's column count
        # (a silently accepted wrong-sized list would only surface much
        # later as an IndexError inside plotting/dataframe helpers)
        nf = len(self.feature_names) if getattr(self, "feature_names",
                                                None) else 0
        if not nf:
            raw = getattr(self, "_raw_input", None)
            if raw is not None and hasattr(raw, "shape") \
                    and len(raw.shape) == 2:
                nf = raw.shape[1]
        if nf and len(names) != nf:
            raise ValueError(f"{len(names)} names for {nf} features")
        self._feature_name_in = names
        if getattr(self, "feature_names", None):
            self.feature_names = list(names)
        return self

    def feature_num_bin(self, feature: int) -> int:
        """Bin count of one feature (basic.py feature_num_bin);
        trivial/unused features report 0 like the reference's
        LGBM_DatasetGetFeatureNumBin."""
        self.construct()
        m = self.bin_mappers[int(feature)]
        return 0 if m.is_trivial else int(m.num_bin)

    def get_ref_chain(self, ref_limit: int = 100):
        """The reference chain (basic.py get_ref_chain)."""
        chain, seen = [], set()
        node = self
        while node is not None and id(node) not in seen \
                and len(chain) < ref_limit:
            chain.append(node)
            seen.add(id(node))
            node = node.reference
        return chain

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append other's feature columns (Dataset::AddFeaturesFrom,
        LGBM_DatasetAddFeaturesFrom)."""
        from .basic import LightGBMError
        if not self._constructed or not other._constructed:
            # reference semantics: both handles must exist (basic.py
            # add_features_from raises before touching the C API)
            raise LightGBMError(
                "Both source and target Datasets must be constructed "
                "before adding features")
        if self.num_data != other.num_data:
            raise LightGBMError(
                f"Cannot add features from other Dataset with a "
                f"different number of rows ({other.num_data} vs "
                f"{self.num_data})")
        nt = self.num_total_features
        self.binned = np.concatenate(
            [self.feature_binned(), other.feature_binned()], axis=1)
        self.bin_offsets = None
        self.efb = None                # bundles no longer match columns
        self.binned_sparse = None      # merged matrix is dense flat layout
        self.bin_mappers = list(self.bin_mappers) + list(other.bin_mappers)
        self.used_features = list(self.used_features) + [
            nt + f for f in other.used_features]
        self.num_total_features = nt + other.num_total_features
        self.feature_names = (list(self.feature_names)
                              + list(other.feature_names))
        if self.raw_data is not None and other.raw_data is not None \
                and hasattr(self.raw_data, "shape") \
                and hasattr(other.raw_data, "shape"):
            self.raw_data = np.concatenate(
                [np.asarray(self.raw_data), np.asarray(other.raw_data)],
                axis=1)
        else:
            self.raw_data = None
        return self

    def get_weight(self):
        self.construct()
        return self.metadata.weight

    def get_group(self):
        self.construct()
        if self.metadata.query_boundaries is None:
            return None
        return np.diff(self.metadata.query_boundaries)

    def get_feature_name(self):
        self.construct()
        return list(self.feature_names)

    def _dump_text(self, path) -> "Dataset":
        """Deterministic text dump of the constructed dataset
        (LGBM_DatasetDumpText's debugging role, c_api.cpp DumpText):
        names, per-feature bin bounds, and the binned rows — two
        datasets with identical content dump identical text regardless
        of HOW they were built (direct construct vs add_features_from),
        which is exactly what the reference's add_features tests
        compare."""
        self.construct()
        flat = self.feature_binned()
        used = set(self.used_features)
        with open(path, "w") as f:
            f.write(f"num_data={self.num_data} "
                    f"num_features={self.num_total_features}\n")
            f.write("feature_names=" + ",".join(self.feature_names) + "\n")
            col = 0
            for j in range(self.num_total_features):
                m = self.bin_mappers[j]
                bounds = ",".join(f"{b:.17g}" for b in
                                  np.asarray(m.bin_upper_bound).ravel()) \
                    if m.bin_upper_bound is not None else ""
                f.write(f"feature {j} used={j in used} "
                        f"num_bin={int(m.num_bin)} bounds=[{bounds}]\n")
            for i in range(self.num_data):
                row = []
                col = 0
                for j in range(self.num_total_features):
                    if j in used:
                        row.append(str(int(flat[i, col])))
                        col += 1
                    else:
                        row.append("-")
                f.write(" ".join(row) + "\n")
        return self

    # -- reference attribute surface --------------------------------------
    # basic.py keeps label/weight/init_score/group/feature_name as plain
    # Dataset attributes refreshed from the C side on every set_field;
    # here they are live views of the same state (metadata once
    # constructed, the constructor inputs before), so
    # ``ds.label``/``ds.get_label()``/``ds.get_field('label')`` always
    # agree (test_basic.py::test_consistent_state_for_dataset_fields).
    @property
    def label(self):
        return self.metadata.label if self.metadata is not None \
            else self._label_in

    @label.setter
    def label(self, value):
        self.set_label(value)

    @property
    def weight(self):
        return self.metadata.weight if self.metadata is not None \
            else self._weight_in

    @weight.setter
    def weight(self, value):
        self.set_weight(value)

    @property
    def init_score(self):
        return self.metadata.init_score if self.metadata is not None \
            else self._init_score_in

    @init_score.setter
    def init_score(self, value):
        self.set_init_score(value)

    @property
    def group(self):
        if self.metadata is not None:
            if self.metadata.query_boundaries is None:
                return None
            return np.diff(self.metadata.query_boundaries)
        return self._group_in

    @group.setter
    def group(self, value):
        self.set_group(value)

    @property
    def feature_name(self):
        if getattr(self, "feature_names", None):
            return list(self.feature_names)
        return self._feature_name_in

    @feature_name.setter
    def feature_name(self, value):
        self.set_feature_name(value)

    def set_label(self, label):
        if self.metadata is None:
            self._label_in = label
        else:
            self.metadata.set_label(label)
        return self

    def set_weight(self, weight):
        if self.metadata is None:
            self._weight_in = weight
        else:
            self.metadata.set_weight(weight)
        return self

    def set_group(self, group):
        if self.metadata is None:
            self._group_in = group
        else:
            self.metadata.set_group(group)
        return self

    def set_init_score(self, init_score):
        if self.metadata is None:
            self._init_score_in = init_score
        else:
            self.metadata.set_init_score(init_score)
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, weight=weight, group=group,
                       init_score=init_score, reference=self,
                       params=params or self.params)

    def _raw_rows(self, idx: np.ndarray):
        """Raw feature rows for ``idx``, from whichever raw source
        survives: the kept ndarray/CSR, or the kept Sequence list
        (gathered through the Sequence protocol)."""
        if self.raw_data is not None:
            return self.raw_data[idx]
        src = self._raw_input
        if src is None:
            return None
        if isinstance(src, Sequence) or (isinstance(src, (list, tuple))
                                         and len(src)
                                         and isinstance(src[0], Sequence)):
            seqs = [src] if isinstance(src, Sequence) else list(src)
            bounds = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
            rows = []
            for i in idx:
                si = int(np.searchsorted(bounds, i, side="right") - 1)
                rows.append(np.asarray(seqs[si][int(i - bounds[si])],
                                       np.float64).reshape(-1))
            return np.asarray(rows)
        if hasattr(src, "shape"):
            return np.asarray(src, np.float64)[idx]
        return None

    def subset(self, used_indices, params=None) -> "Dataset":
        """Row-subset copy (Dataset::CopySubrow, dataset.h:486 analog).
        Indices are SORTED like the reference python subset (basic.py
        used_indices sort) — rows keep their original relative order."""
        self.construct()
        idx = np.sort(np.asarray(used_indices, dtype=np.int64))
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update({k: v for k, v in self.__dict__.items()})
        sub.num_data = len(idx)
        sub.binned = self.binned[idx] if self.binned is not None else None
        sub.binned_sparse = self.binned_sparse.subset_rows(idx) \
            if self.binned_sparse is not None else None
        # raw rows slice cheaply when the parent holds them in memory;
        # a Sequence-backed parent stays LAZY (get_data gathers through
        # the protocol on demand via used_indices + reference) — eager
        # gathering here would materialize dense row blocks for every
        # cv fold of an out-of-core dataset
        sub.raw_data = self.raw_data[idx] if self.raw_data is not None \
            else None
        sub._raw_input = None
        sub.used_indices = idx
        sub.metadata = Metadata(len(idx))
        if self.metadata.label is not None:
            sub.metadata.label = self.metadata.label[idx]
        if self.metadata.weight is not None:
            sub.metadata.weight = self.metadata.weight[idx]
        if self.metadata.init_score is not None:
            sub.metadata.init_score = self.metadata.init_score[idx]
        if self.metadata.query_boundaries is not None:
            # per-query counts of the selected rows, empty queries
            # dropped — partial queries shrink (Metadata::CopySubrow's
            # query handling; sorted idx keeps rows query-contiguous)
            qb = self.metadata.query_boundaries
            qidx = np.searchsorted(qb, idx, side="right") - 1
            sub.metadata.set_group(np.unique(qidx, return_counts=True)[1])
        sub.reference = self
        return sub

    def _group_from_parent(self, parent: "Dataset", idx: np.ndarray) -> None:
        """Reconstruct query boundaries for a row subset whose indices cover
        whole queries (cv fold construction)."""
        qb = parent.metadata.query_boundaries
        if qb is None:
            return
        qid = np.searchsorted(qb, np.asarray(idx), side="right") - 1
        # run-length encode consecutive query ids
        change = np.nonzero(np.diff(qid))[0] + 1
        starts = np.concatenate([[0], change, [len(qid)]])
        sizes = np.diff(starts)
        self.metadata.set_group(sizes)

    def fingerprint(self) -> str:
        """Cheap content fingerprint for snapshot manifests (snapshot.py):
        row count + f32 label/weight bytes, computed identically before
        and after ``construct()`` so the manifest written mid-training
        matches the check a resuming run performs on its yet-unbinned
        dataset.  A guard against resuming onto the wrong data — not a
        cryptographic identity of the feature matrix."""
        lab = wgt = None
        if self.metadata is not None:
            lab, wgt = self.metadata.label, self.metadata.weight
        if lab is None:
            lab = getattr(self, "_label_in", None)
        if wgt is None:
            wgt = getattr(self, "_weight_in", None)
        return fingerprint_arrays(lab, wgt)

    # -- binary cache ----------------------------------------------------
    def save_binary(self, path: str) -> None:
        """Binary dataset cache (dataset.cpp SaveBinaryFile analog)."""
        raise NotImplementedError(
            "save_binary needs the atomic file writer of utils/resilience.py, "
            "which lightgbm_torch does not have yet (ROADMAP A12)")

    @classmethod
    def from_ingest(cls, source: str, params: Optional[Dict[str, Any]] = None,
                    **kwargs) -> "Dataset":
        """Streaming out-of-core construction from a chunked text source
        (file or directory of chunks) via the survivable ingest pipeline
        (the JAX package's ingest.py): checkpointed chunk spool + manifest,
        retry/quarantine per chunk, bin mappers fitted from merged
        quantile sketches.  Keyword args pass through to
        ``ingest.ingest_dataset`` (``has_header``, ``label_column``,
        ``categorical_idx``, ``spool_dir``, ``reference``)."""
        raise NotImplementedError(
            "out-of-core ingest (ingest.py) is not ported to lightgbm_torch "
            "yet (ROADMAP A17)")

    @classmethod
    def load_binary(cls, path: str) -> "Dataset":
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        z = np.load(path, allow_pickle=True)
        ds = cls.__new__(cls)
        ds.params = {}
        ds.reference = None
        ds.free_raw_data = False
        ds._constructed = True
        ds._raw_input = None
        ds.used_features = [int(x) for x in z["used_features"]]
        if "sparse_flat" in z.files:
            raise NotImplementedError(
                "a sparse-binned dataset cache needs sparse_data.py, which "
                "lightgbm_torch does not have yet (ROADMAP A11)")
        else:
            ds.binned = z["binned"]
            ds.binned_sparse = None
            ds.num_data = ds.binned.shape[0]
        ds.bin_offsets = z["bin_offsets"]
        ds.num_total_features = int(z["num_total_features"])
        ds.max_bin = int(z["max_bin"])
        ds.feature_names = [str(x) for x in z["feature_names"]]
        n_mappers = int(z["num_mappers"])
        ds.bin_mappers = []
        for i in range(n_mappers):
            st = {k.split("_", 1)[1]: z[k] for k in z.files if k.startswith(f"mapper{i}_")}
            ds.bin_mappers.append(BinMapper.from_state(st))
        ds.metadata = Metadata(ds.num_data)
        if "label" in z.files:
            ds.metadata.label = z["label"]
        if "weight" in z.files:
            ds.metadata.weight = z["weight"]
        if "query_boundaries" in z.files:
            ds.metadata.query_boundaries = z["query_boundaries"]
        if "init_score" in z.files:
            ds.metadata.init_score = z["init_score"]
        if "raw_data" in z.files:
            ds.raw_data = z["raw_data"]
        elif "raw_csr_data" in z.files:
            import scipy.sparse as _sp
            ds.raw_data = _sp.csr_matrix(
                (z["raw_csr_data"], z["raw_csr_indices"], z["raw_csr_indptr"]),
                shape=tuple(z["raw_csr_shape"]))
        else:
            ds.raw_data = None
        ds.efb = None
        if "efb_group_of_feat" in z.files:
            sizes = z["efb_group_sizes"]
            members = [int(x) for x in z["efb_group_members"]]
            groups, pos = [], 0
            for sz in sizes:
                groups.append(members[pos:pos + int(sz)])
                pos += int(sz)
            ds.efb = EFBInfo(groups=groups,
                             group_of_feat=z["efb_group_of_feat"],
                             off_of_feat=z["efb_off_of_feat"],
                             group_num_bin=z["efb_group_num_bin"])
        return ds

    def num_bins_of(self, used_feature_slot: int) -> int:
        f = self.used_features[used_feature_slot]
        return self.bin_mappers[f].num_bin
