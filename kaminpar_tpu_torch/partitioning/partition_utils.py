"""Deep-multilevel k arithmetic (a copy of
``kaminpar_tpu/partitioning/partition_utils.py``).

Reference: ``kaminpar-shm/partitioning/partition_utils.cc:138``
(``compute_k_for_n``, ``compute_final_k``): on the way up, the partition is
extended so that a graph with n nodes carries ``min(k, 2^floor(log2(n/C)))``
blocks; each intermediate block b is responsible for a contiguous range of
final blocks whose budgets sum to its intermediate budget.

The intermediate→final block mapping is defined by **recursive bisection**:
``[0, k)`` is split into a ceil/floor pair of sub-ranges, recursively, so
that the cur_k-way split is always *refined* by the new_k-way split for any
extension step cur_k → new_k with new_k ∈ {2·cur_k, 4·cur_k, ..., k}
(intermediate k values are powers of two, plus the final k).  This refinement
property is what makes intermediate block budgets consistent across extension
steps — without it, a block refined under one budget could later be split
into final blocks whose summed budget is smaller, making balance unreachable.
"""

from __future__ import annotations

import math

import numpy as np


def compute_k_for_n(n: int, contraction_limit: int, k: int) -> int:
    """Blocks a graph with n nodes should carry.

    DIVERGENCE (DIVERGENCES.md #13) from partition_utils.cc:92-100: the
    reference floors n/C before ceil_log2; we *ceil* it, so for n just
    above 2C this returns 4 where the reference returns 2.  Extension is
    thereby front-loaded onto coarse levels, where bisections are cheap
    and every subsequent level refines at the higher k; flooring would
    back-load a large extension jump onto the finest level where
    refinement can no longer recover it."""
    if n < 2 * contraction_limit:
        return 2
    ratio = -(n // -contraction_limit)  # ceil(n / C)
    kk = 1 << max(ratio - 1, 1).bit_length()  # 2^ceil_log2(ratio)
    return int(min(max(kk, 2), k))


def split_offsets(k: int, cur_k: int) -> np.ndarray:
    """Offsets into the final block range per intermediate block:
    intermediate block b owns final blocks ``[off[b], off[b+1])``.

    Defined by recursive bisection (left child takes ``ceil``), so
    ``split_offsets(k, new_k)`` refines ``split_offsets(k, cur_k)`` whenever
    cur_k and new_k are powers of two with cur_k <= new_k, or new_k == k.
    """
    assert 1 <= cur_k <= k
    out: list[int] = []

    def rec(lo: int, hi: int, parts: int) -> None:
        if parts == 1:
            out.append(lo)
            return
        lp = (parts + 1) // 2
        size = hi - lo
        lsize = -((-size * lp) // parts)  # ceil(size * lp / parts)
        rec(lo, lo + lsize, lp)
        rec(lo + lsize, hi, parts - lp)

    rec(0, k, cur_k)
    out.append(k)
    return np.asarray(out, dtype=np.int64)


def split_counts(k: int, cur_k: int) -> np.ndarray:
    """How many final blocks each of the cur_k intermediate blocks becomes
    (reference: ``compute_final_k``)."""
    return np.diff(split_offsets(k, cur_k))


def intermediate_block_weights(final_max_bw: np.ndarray, cur_k: int) -> np.ndarray:
    """Intermediate block budgets = sums of the final budgets each block will
    be split into (so imbalance does not accumulate through extension)."""
    k = len(final_max_bw)
    off = split_offsets(k, cur_k)
    return np.array(
        [final_max_bw[off[b] : off[b + 1]].sum() for b in range(cur_k)], dtype=np.int64
    )
