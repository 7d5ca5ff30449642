"""Isolated-node strip + re-integration (host-side numpy), a copy of
``kaminpar_tpu/graph/isolated.py``.

Isolated nodes never affect the cut but dilute coarsening and refinement,
so the facade strips them before partitioning and bin-packs them into the
lightest blocks afterwards.
"""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np


def strip_isolated_csr(
    row_ptr: np.ndarray,
    col_idx,
    node_w,
    n: int,
    k: int,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Strip zero-degree nodes from a host CSR.

    Returns ``(keep, isolated, new_row_ptr, new_col_idx, new_node_w)``
    (``new_row_ptr`` int64, ``new_col_idx`` remapped to the stripped id
    space), or None when stripping does not apply — no isolated nodes,
    nothing BUT isolated nodes, or too few survivors for ``k`` blocks.
    Edge weights pass through unchanged (isolated nodes carry no edges).

    ``col_idx`` / ``node_w`` may be zero-arg callables, resolved only when
    stripping applies — the common no-isolated-nodes case then reads
    ``row_ptr`` alone (no O(m) host materialization of a device graph).
    """
    deg = row_ptr[1:] - row_ptr[:-1]
    isolated = np.flatnonzero(deg == 0)
    if not (0 < len(isolated) < n and k <= n - len(isolated)):
        return None
    col_idx = np.asarray(col_idx() if callable(col_idx) else col_idx)
    node_w = np.asarray(node_w() if callable(node_w) else node_w)
    keep = np.flatnonzero(deg > 0)
    remap = np.full(n, -1, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    new_rp = np.zeros(len(keep) + 1, dtype=np.int64)
    np.cumsum(deg[keep], out=new_rp[1:])
    return keep, isolated, new_rp, remap[col_idx], node_w[keep]


def assign_isolated_nodes(
    full_n: int,
    k: int,
    keep: np.ndarray,
    isolated: np.ndarray,
    work_part: np.ndarray,
    work_node_w: np.ndarray,
    node_w: np.ndarray,
    caps: np.ndarray,
) -> np.ndarray:
    """Re-integrate stripped isolated nodes: greedy lightest-block
    assignment respecting the caps.  A k-entry heap keeps this
    O(n_iso log k) — RMAT graphs can have millions of isolated nodes.
    Returns the full (``full_n``,) partition."""
    full_part = np.zeros(full_n, dtype=work_part.dtype)
    full_part[keep] = work_part
    bw = np.bincount(work_part, weights=work_node_w, minlength=k).astype(np.int64)
    iso_w = node_w[isolated]
    order = np.argsort(-iso_w)  # heaviest first packs tightest
    heap = [(int(bw[b]), b) for b in range(k)]
    heapq.heapify(heap)
    for u, w in zip(isolated[order], iso_w[order]):
        w = int(w)
        popped = []
        while heap and heap[0][0] + w > caps[heap[0][1]]:
            popped.append(heapq.heappop(heap))
        if heap:
            wt, b = heapq.heappop(heap)
        else:  # nothing fits: overload the lightest block
            popped.sort()
            wt, b = popped.pop(0)
        full_part[u] = b
        heapq.heappush(heap, (wt + w, b))
        for item in popped:
            heapq.heappush(heap, item)
    return full_part
