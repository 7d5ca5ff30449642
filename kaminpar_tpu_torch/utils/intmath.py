"""Integer math helpers: powers of two and the sqrt(2) shape ladder.

Counterpart of ``kaminpar_tpu/utils/intmath.py``; the ladder decides the
padded sizes of every hierarchy level, so it must match it number for
number (the bucketed layout and the LP draws are shaped by it).
"""

from __future__ import annotations


def next_pow2(x: int, minimum: int = 1) -> int:
    """Smallest power of two >= max(x, minimum)."""
    return max(minimum, 1 << (int(max(x, 1)) - 1).bit_length())


# ceil(sqrt(2) * 2^15): integer sqrt(2) multiplier for the mid rung.
_SQRT2_Q15 = 46341
_BUCKET_ALIGN = 128


def next_shape_bucket(x: int, minimum: int = 1) -> int:
    """Smallest rung strictly > x of the ladder {2^k} plus the mid rungs
    ceil(2^k * sqrt(2)) aligned up to 128.  Strictly greater, so a padded
    graph always has at least one pad node (the anchor)."""
    x = int(max(x, 0))
    p = 1 << x.bit_length()
    half = p >> 1
    mid = (half * _SQRT2_Q15 + (1 << 15) - 1) >> 15
    mid = -(-mid // _BUCKET_ALIGN) * _BUCKET_ALIGN
    cand = mid if x < mid < p else p
    return max(minimum, cand)
