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
"""

from __future__ import annotations


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
