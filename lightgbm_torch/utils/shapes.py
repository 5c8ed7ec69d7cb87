"""Shape helpers shared by the port.

The JAX package buckets every trace-relevant dimension (rows, leaf
budget, split batch, channels) so that one XLA trace covers a family of
sizes.  PyTorch runs eagerly and traces nothing, so the port keeps only
the rule that changes results: the number of levels a binned tree walk
takes (``round_up_pow2`` of the tree depth, models/gbdt.py).
"""

from __future__ import annotations


def round_up_pow2(x: int) -> int:
    """Smallest power of two >= x (>= 1)."""
    p = 1
    while p < x:
        p *= 2
    return p
