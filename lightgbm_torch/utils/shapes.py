"""Shape helpers shared by the port.

The JAX package buckets every trace-relevant dimension (rows, leaf
budget, split batch, channels) so that one XLA trace covers a family of
sizes.  The port keeps the walk lengths of the binned tree walk
(``round_up_pow2`` of a tree's depth for a walk of one known tree, and
``traversal_steps`` for the walk inside a training iteration, which
cannot read the depth of the tree it just grew without a host round
trip) and the serving engine's buckets (``bucket_rows``,
``bucket_nodes``, ``bucket_leaf_slots``, ``bucket_bins``,
``bucket_steps``; the JAX package's ``utils/shapes.py`` rules, copied).
A CUDA kernel does not recompile per shape, so in the port the buckets
bound the number of distinct launch shapes and allocations, and they
keep co-hosted versions of one model family on identical table shapes.
The batched grower's width K is resolved by the JAX package's rules
(``SPLIT_BATCH_SET``, ``snap_split_batch``, ``fit_split_batch``), so both
packages grow the same trees; ``bucket_leaves`` is its padded leaf
budget, which the port does not pad to but keeps for parity.
"""

from __future__ import annotations

# the super-step widths K of the batched grower: 1 = strict leaf-wise
# growth, 8 and 16 = the automatic choices (64 and 128 leaves on), 32 and
# 64 = the wide widths
SPLIT_BATCH_SET = (1, 8, 16, 32, 64)
# the smallest padded leaf budget of the JAX package's leaf buckets
LEAF_BUCKET_FLOOR = 64


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def _pow2_floor(n: int, floor: int) -> int:
    """The bucketing rule every policy below delegates to: pow2 with a
    floor."""
    return max(int(floor), round_up_pow2(max(int(n), 1)))


def bucket_rows(n: int, min_bucket: int = 16, cap: int | None = None) -> int:
    """Pow2 row bucket with a floor (and an optional pow2'd cap): the
    serving engine's batch policy."""
    b = _pow2_floor(n, min_bucket)
    if cap is not None:
        b = min(b, round_up_pow2(int(cap)))
    return b


def bucket_leaves(num_leaves: int, floor: int = LEAF_BUCKET_FLOOR) -> int:
    """Padded leaf budget covering ``num_leaves``: pow2 with a floor
    (31 / 40 / 63 -> 64; 127 -> 128; 255 -> 256)."""
    return _pow2_floor(num_leaves, floor)


def bucket_nodes(n: int, floor: int = 16) -> int:
    """Padded per-tree node-slot count of the serving tables (padded
    rows are never reached: their children are -1)."""
    return _pow2_floor(n, floor)


def bucket_leaf_slots(n: int, floor: int = 8) -> int:
    """Padded per-tree leaf-slot count of the serving leaf-value table
    (padded slots hold 0.0 and are never gathered)."""
    return _pow2_floor(n, floor)


def bucket_bins(n: int, floor: int = 16) -> int:
    """Padded width of the device binning tables (threshold and
    known-category slots, padded with +inf)."""
    return _pow2_floor(n, floor)


def bucket_steps(depth: int, floor: int = 8) -> int:
    """Padded walk length (forest max depth): a finished row keeps its
    leaf through the padded levels, so extra steps change no result."""
    return _pow2_floor(depth, floor)


def traversal_steps(max_depth: int, leaf_budget: int) -> int:
    """Level count of the valid-set walk inside a training iteration
    (the JAX package's ``utils/shapes.traversal_steps``): ``max_depth``
    when bounded, else ``leaf_budget - 1`` (a leaf-wise tree of L leaves is
    at most L - 1 deep), rounded up to a power of two.  A row stops at its
    leaf, so surplus levels change no result."""
    cap = int(max_depth) if int(max_depth) > 0 else max(int(leaf_budget) - 1,
                                                        1)
    return round_up_pow2(max(cap, 1))


def padded_bins(num_bins: int) -> int:
    """The JAX package's padded bin axis (its ``obs/flops.py``
    ``padded_bins``: a multiple of 64, at least 64), copied for the
    autotuner's table key (``ops/hist_tune.shape_key``), so both packages
    key a shape alike."""
    return max(64, -(-int(num_bins) // 64) * 64)


def snap_split_batch(k: int) -> int:
    """Nearest width of ``SPLIT_BATCH_SET`` at or above the request
    (capped at the largest); 0 and 1 pass through."""
    k = int(k)
    if k <= 1:
        return k
    for s in SPLIT_BATCH_SET:
        if k <= s:
            return s
    return SPLIT_BATCH_SET[-1]


def fit_split_batch(k: int, num_leaves: int) -> int:
    """``snap_split_batch`` and then under the leaf budget: a super-step
    splits at most ``num_leaves - 1`` leaves, so a width past the budget
    steps down the set (31 leaves at K = 32 run K = 16)."""
    k = snap_split_batch(k)
    cap = int(num_leaves) - 1
    if k <= cap:
        return k
    fit = 1
    for s in SPLIT_BATCH_SET:
        if s <= cap:
            fit = s
    return fit
