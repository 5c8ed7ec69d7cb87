"""Shape helpers shared by the port.

The JAX package buckets every trace-relevant dimension (rows, leaf
budget, split batch, channels) so that one XLA trace covers a family of
sizes.  The port keeps only the walk lengths of the binned tree walk:
``round_up_pow2`` of a tree's depth for a walk of one known tree, and
``traversal_steps`` for the walk inside a training iteration, which
cannot read the depth of the tree it just grew without a host round trip.
"""

from __future__ import annotations


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p


def traversal_steps(max_depth: int, leaf_budget: int) -> int:
    """Level count of the valid-set walk inside a training iteration
    (the JAX package's ``utils/shapes.traversal_steps``): ``max_depth``
    when bounded, else ``leaf_budget - 1`` (a leaf-wise tree of L leaves is
    at most L - 1 deep), rounded up to a power of two.  A row stops at its
    leaf, so surplus levels change no result."""
    cap = int(max_depth) if int(max_depth) > 0 else max(int(leaf_budget) - 1,
                                                        1)
    return round_up_pow2(max(cap, 1))
