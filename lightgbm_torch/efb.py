"""EFB — exclusive feature bundling.

Analog of the reference's ``Dataset::FindGroups`` / ``FastFeatureBundling``
(src/io/dataset.cpp:100, :239): sparse, mutually-exclusive
features (e.g. one-hot blocks) are folded into one shared column so the
binned matrix narrows from F to G columns, which cuts the bytes streamed
per histogram pass, the bandwidth-bound term.

This is the host half of the JAX package's ``efb.py``: bundle finding,
grouped binning and unbundling, which ``dataset.py`` imports.  The device
half (the group -> feature histogram expansion) is not ported yet
(ROADMAP A9/B9), so the port's trainer refuses a bundled dataset.

Scheme (bundle of features j1..jk, each with default bin 0):
  group bin 0            = every constituent at its default bin
  group bins [off_j, off_j + nb_j - 1)  = feature j's bins 1..nb_j-1
Per-feature histograms are reconstructed by a gather over the
group histogram plus the reference's FixHistogram trick
(src/io/dataset.cpp:1292): the default bin is recovered as
``leaf_total - sum(other bins)``.  With ``max_conflict_rate=0`` (default)
bundling is exactly lossless — split decisions match the unbundled run
bit-for-bit; a nonzero rate trades accuracy for width like the reference.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np


class EFBInfo(NamedTuple):
    """Bundling description, feature indices in used-feature slot space."""
    groups: List[List[int]]          # per group: constituent feature slots
    group_of_feat: np.ndarray        # [F] int32
    off_of_feat: np.ndarray          # [F] int32; -1 => identity (singleton)
    group_num_bin: np.ndarray        # [G] int32

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def max_group_bin(self) -> int:
        return int(self.group_num_bin.max()) if len(self.group_num_bin) else 2

    @property
    def any_bundled(self) -> bool:
        return bool((self.off_of_feat >= 0).any())


def find_bundles(sample_bins: np.ndarray, num_bin: np.ndarray,
                 is_cat: np.ndarray, most_freq_bin: np.ndarray,
                 max_conflict_rate: float = 0.0,
                 max_group_bins: int = 2048,
                 dense_rate: float = 0.8) -> EFBInfo:
    """Greedy conflict-bounded grouping (FindGroups, dataset.cpp:100).

    sample_bins: [S, F] binned sample rows used for conflict counting.
    Only numerical features whose default (most frequent) bin is 0 and whose
    non-default rate is <= dense_rate are bundling candidates; everything
    else gets a singleton group.  ``max_group_bins`` bounds a bundle's bin
    axis so the histogram row-block tile ([block, group_bins]
    in VMEM) stays well under the ~16 MB VMEM budget — oversize bundles are
    split into multiple groups automatically.
    """
    s, f = sample_bins.shape
    budget = int(max_conflict_rate * s)
    nz_count = (sample_bins != 0).sum(axis=0)   # [F] non-default counts

    eligible = [j for j in range(f)
                if not is_cat[j] and most_freq_bin[j] == 0
                and nz_count[j] <= dense_rate * s]
    # densest first so heavy features seed groups (reference sorts by
    # conflict count; non-zero count is the same ordering at rate 0)
    eligible.sort(key=lambda j: -int(nz_count[j]))

    # the reference caps the per-feature scan at max_search_group total:
    # max_search_group-1 randomly sampled groups + the newest group
    # (dataset.cpp:106 and :138, rand.Sample(last, max_search_group-1))
    # — without the cap wide unbundleable data (Allstate-shaped 4228
    # columns) degenerates to an O(F^2 * S) scan.  The scanned groups'
    # conflict counts are ONE [search, S] @ [S] matvec per feature rather
    # than a python loop of masked sums.
    max_search_group = 100
    # ...but only as a FALLBACK: the sampled subset hits the one
    # compatible group with probability ~max_search_group/ngr, which
    # shatters real bundles on data with hundreds of them (400 exclusive
    # 5-blocks collapsed to 400 groups under exact search degrade to
    # ~1600 under blind sampling).  The cap exists to bound the
    # O(F * ngr * S) scan on DEGENERATE width (unbundleable data where
    # ngr ~ F); below full_search_groups the exact matvec is affordable,
    # so correctness wins and the sample only kicks in past it.
    full_search_groups = 512
    grp_rng = np.random.RandomState(s)
    # group occupancy rows are allocated geometrically as groups actually
    # form (a full [eligible, S] matrix would be ~GBs on Allstate-shaped
    # 4228 x 200k samples that bundle into a few dozen groups); the
    # per-feature non-default mask is a strided column read, never a
    # [S, F] bool materialization
    cap = 64
    mask_arr = np.zeros((cap, s), np.uint8)
    bins_arr = np.zeros(cap, np.int64)                  # 1 + sum(nb-1)
    confl_arr = np.zeros(cap, np.int64)
    groups: List[List[int]] = []
    ngr = 0
    for j in eligible:
        nb1 = int(num_bin[j]) - 1
        nzj = (sample_bins[:, j] != 0).astype(np.uint8)
        if ngr <= full_search_groups:
            search = np.arange(ngr)
        else:
            idx = grp_rng.choice(ngr - 1, size=max_search_group - 1,
                                 replace=False)
            search = np.concatenate([[ngr - 1], idx])
        hit = -1
        if len(search):
            # int64 accumulation: a uint8 matvec would wrap counts at 256
            # and admit heavily-conflicting features into "exclusive"
            # bundles (the conflict sample is up to 200k rows)
            counts = mask_arr[search] @ nzj.astype(np.int64)
            ok = (bins_arr[search] + nb1 <= max_group_bins) \
                & (confl_arr[search] + counts <= budget)
            hits = np.nonzero(ok)[0]
            if len(hits):
                hit = int(hits[0])
        if hit >= 0:
            gi = int(search[hit])
            groups[gi].append(j)
            mask_arr[gi] |= nzj
            confl_arr[gi] += int(counts[hit])
            bins_arr[gi] += nb1
        else:
            if ngr == cap:
                cap *= 2
                mask_arr = np.concatenate(
                    [mask_arr, np.zeros((cap - ngr, s), np.uint8)])
                bins_arr = np.concatenate(
                    [bins_arr, np.zeros(cap - ngr, np.int64)])
                confl_arr = np.concatenate(
                    [confl_arr, np.zeros(cap - ngr, np.int64)])
            groups.append([j])
            mask_arr[ngr] = nzj
            bins_arr[ngr] = 1 + nb1
            ngr += 1
    group_bins = [int(b) for b in bins_arr[:ngr]]

    # drop the synthetic bin-0 for groups that stayed singletons, and add
    # singleton groups for ineligible features
    final_groups: List[List[int]] = []
    final_bins: List[int] = []
    for gi, g in enumerate(groups):
        if len(g) == 1:
            final_groups.append(g)
            final_bins.append(int(num_bin[g[0]]))
        else:
            final_groups.append(g)
            final_bins.append(group_bins[gi])
    in_bundle = {j for g in final_groups for j in g}
    for j in range(f):
        if j not in in_bundle:
            final_groups.append([j])
            final_bins.append(int(num_bin[j]))

    group_of = np.zeros(f, np.int32)
    off_of = np.full(f, -1, np.int32)
    for gi, g in enumerate(final_groups):
        if len(g) == 1:
            group_of[g[0]] = gi
        else:
            off = 1
            for j in g:
                group_of[j] = gi
                off_of[j] = off
                off += int(num_bin[j]) - 1
    return EFBInfo(groups=final_groups, group_of_feat=group_of,
                   off_of_feat=off_of,
                   group_num_bin=np.asarray(final_bins, np.int32))


def bin_grouped(feature_cols, efb: EFBInfo, num_data: int) -> np.ndarray:
    """Fold per-feature bin columns into the grouped matrix [N, G].

    ``feature_cols(j) -> [N] int array`` supplies feature j's bins lazily so
    the full [N, F] matrix never materializes for wide sparse data.
    """
    dtype = np.uint8 if efb.max_group_bin <= 256 else np.uint16
    out = np.zeros((num_data, efb.num_groups), dtype=dtype)
    for gi, g in enumerate(efb.groups):
        if len(g) == 1:
            out[:, gi] = feature_cols(g[0]).astype(dtype)
        else:
            col = np.zeros(num_data, dtype=np.int64)
            for j in g:
                b = feature_cols(j)
                nzr = b != 0
                col[nzr] = int(efb.off_of_feat[j]) + b[nzr] - 1
            out[:, gi] = col.astype(dtype)
    return out


def unbundle(binned_grouped: np.ndarray, efb: EFBInfo,
             num_bin: np.ndarray) -> np.ndarray:
    """Reconstruct the per-feature binned matrix [N, F] (for learners that
    do not take the grouped layout, e.g. the distributed shard_map path)."""
    f = len(efb.group_of_feat)
    dtype = np.uint8 if int(num_bin.max()) <= 256 else np.uint16
    out = np.zeros((binned_grouped.shape[0], f), dtype=dtype)
    for j in range(f):
        g = int(efb.group_of_feat[j])
        gcol = binned_grouped[:, g].astype(np.int64)
        off = int(efb.off_of_feat[j])
        if off < 0:
            out[:, j] = gcol.astype(dtype)
        else:
            hi = off + int(num_bin[j]) - 1
            sel = (gcol >= off) & (gcol < hi)
            out[sel, j] = (gcol[sel] - off + 1).astype(dtype)
    return out


def expansion_maps(efb: EFBInfo, num_bin: np.ndarray, max_bin: int):
    """Precompute the device gather maps for group->feature histogram
    expansion: (col_idx [F, B] int32 with -1 = masked, fix0 [F] bool)."""
    f = len(efb.group_of_feat)
    col_idx = np.full((f, max_bin), -1, np.int32)
    fix0 = np.zeros(f, bool)
    for j in range(f):
        nb = int(num_bin[j])
        off = int(efb.off_of_feat[j])
        if off < 0:
            col_idx[j, :nb] = np.arange(nb)
        else:
            fix0[j] = True
            col_idx[j, 1:nb] = off + np.arange(nb - 1)
    return col_idx, fix0
