"""Threshold edge sparsification of a coarse graph, the linear-time tier
(counterpart of ``kaminpar_tpu/coarsening/sparsifier.py``).

Every edge strictly heavier than the (m - target_m + 1)-smallest weight is
kept; edges of exactly that weight survive with the leftover probability,
by a hash of the unordered endpoint pair, so both directions of an edge
survive or die together.  Host numpy, as in the JAX package: the level's
edges come off the device in one transfer and the sparsified graph goes
back to it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..utils import RandomState, sync_stats


def _symmetric_hash01(u: np.ndarray, v: np.ndarray, seed: int) -> np.ndarray:
    """splitmix-style mix of the unordered pair (u, v), uniform in [0, 1)."""
    h = (
        (np.maximum(u, v).astype(np.uint64) << np.uint64(32))
        | np.minimum(u, v).astype(np.uint64)
    ) + np.uint64(seed)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xFF51AFD7ED558CCD)
    h ^= h >> np.uint64(33)
    h *= np.uint64(0xC4CEB9FE1A85EC53)
    h ^= h >> np.uint64(33)
    h &= np.uint64((1 << 32) - 1)
    return h.astype(np.float64) / float((1 << 32) - 1)


def sparsify_threshold(graph: CSRGraph, target_m: int) -> CSRGraph:
    """``graph`` with about ``target_m`` of its heaviest edges, on its
    device, sharing its node weights; the tie dice's seed is one draw from
    the run's host stream."""
    m = graph.m
    if target_m >= m or m == 0:
        return graph
    packed = sync_stats.pull(torch.cat([graph.col_idx, graph.edge_w, graph.edge_u]))
    packed = packed.astype(np.int64)
    col, ew, u = packed[:m], packed[m : 2 * m], packed[2 * m :]

    if target_m < 2:
        keep = np.zeros(m, dtype=bool)
    else:
        kth = m - target_m
        threshold = int(np.partition(ew, kth)[kth])
        n_larger = int((ew > threshold).sum())
        n_equal = int((ew == threshold).sum())
        p_equal = (target_m - n_larger) / max(n_equal, 1)
        seed = int(RandomState.numpy_rng().integers(1 << 62))
        dice = _symmetric_hash01(u, col, seed) < p_equal
        keep = (ew > threshold) | ((ew == threshold) & dice)

    row_ptr = np.zeros(graph.n + 1, dtype=np.int64)
    np.cumsum(np.bincount(u[keep], minlength=graph.n), out=row_ptr[1:])
    # built from the host row_ptr: its layout inputs are the new graph's own
    sg = CSRGraph(row_ptr, col[keep].astype(np.int32), graph.node_w,
                  ew[keep].astype(np.int32), device=graph.device)
    sg._total_node_weight = graph._total_node_weight
    sg._max_node_weight = graph._max_node_weight
    return sg
