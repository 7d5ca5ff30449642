"""Synthetic graph generators (host-side numpy).

A copy of ``kaminpar_tpu/graph/generators.py``: the same seed gives the
same graph as there, so a test can hand one input to both packages.
:func:`rmat_graph` can also build that graph with torch on a device
(``device=``), which is minutes faster at scale 22 on a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import sync_stats
from .csr import CSRGraph, from_edge_list, from_numpy_csr


def star_graph(n_leaves: int, **kw) -> CSRGraph:
    e = np.stack([np.zeros(n_leaves, dtype=np.int64), np.arange(1, n_leaves + 1)], axis=1)
    return from_edge_list(n_leaves + 1, e, **kw)


def grid2d_graph(rows: int, cols: int, **kw) -> CSRGraph:
    """4-neighbour grid."""
    ids = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    return from_edge_list(rows * cols, np.concatenate([right, down]), **kw)


def rmat_edges(scale: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0) -> np.ndarray:
    """The (E, 2) edge array of :func:`rmat_graph` before symmetrization."""
    n = 1 << scale
    num_edges = edge_factor * n
    rng = np.random.default_rng(seed)
    u = np.zeros(num_edges, dtype=np.int64)
    v = np.zeros(num_edges, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(num_edges)
        right = r >= ab
        down = (r >= a) & (r < ab) | (r >= abc)
        u = (u << 1) | right.astype(np.int64)
        v = (v << 1) | down.astype(np.int64)
    # permute node ids to break the power-law ordering correlation
    perm = rng.permutation(n)
    return np.stack([perm[u], perm[v]], axis=1)


def rmat_graph(scale: int, edge_factor: int = 16, a: float = 0.57,
               b: float = 0.19, c: float = 0.19, seed: int = 0, device=None,
               **kw) -> CSRGraph:
    """Graph500-style RMAT: 2**scale nodes, ~edge_factor * 2**scale
    undirected edges before deduplication.

    With ``device``, the same numpy draws are turned into the edge list,
    symmetrized, sorted and merged by torch on that device; the result is
    the same graph, on the host (``from_edge_list``'s options then do not
    apply)."""
    if device is None:
        edges = rmat_edges(scale, edge_factor, a, b, c, seed)
        return from_edge_list(1 << scale, edges, **kw)
    if kw:
        raise ValueError(f"rmat_graph(device=...) takes no from_edge_list options: {sorted(kw)}")
    return _rmat_graph_on(torch.device(device), scale, edge_factor, a, b, c, seed)


def _rmat_graph_on(device: torch.device, scale: int, edge_factor: int, a: float,
                   b: float, c: float, seed: int) -> CSRGraph:
    """:func:`rmat_edges` followed by :func:`from_edge_list` (unit weights,
    symmetrized, duplicates merged), computed on ``device``."""
    n = 1 << scale
    num_edges = edge_factor * n
    rng = np.random.default_rng(seed)
    u = torch.zeros(num_edges, dtype=torch.int64, device=device)
    v = torch.zeros(num_edges, dtype=torch.int64, device=device)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = torch.from_numpy(rng.random(num_edges)).to(device)
        right = r >= ab
        down = (r >= a) & (r < ab) | (r >= abc)
        u = (u << 1) | right.to(torch.int64)
        v = (v << 1) | down.to(torch.int64)
    del r, right, down
    perm = torch.from_numpy(rng.permutation(n)).to(device)
    u, v = perm[u], perm[v]
    keep = u != v
    u, v = u[keep], v[keep]
    key = torch.cat([u * n + v, v * n + u])
    del u, v, keep
    key, w = torch.unique_consecutive(torch.sort(key).values, return_counts=True)
    src = key // n
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(src, minlength=n), 0, out=row_ptr[1:])
    row_ptr, col, w = sync_stats.pull(row_ptr, (key - src * n).to(torch.int32),
                                      w.to(torch.int32))
    return from_numpy_csr(row_ptr, col, None, w)


def rgg2d_graph(n: int, radius: float | None = None, seed: int = 0, **kw) -> CSRGraph:
    """Random geometric graph in the unit square (O(n) cell grid)."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = float(np.sqrt(8.0 / n))
    pts = rng.random((n, 2))
    ncell = max(1, int(1.0 / radius))
    cell = (pts * ncell).astype(np.int64)
    cell_id = cell[:, 0] * ncell + cell[:, 1]
    order = np.argsort(cell_id, kind="stable")
    pts_s, cid_s = pts[order], cell_id[order]
    starts = np.searchsorted(cid_s, np.arange(ncell * ncell))
    ends = np.searchsorted(cid_s, np.arange(ncell * ncell), side="right")
    out_u, out_v = [], []
    r2 = radius * radius
    for cx in range(ncell):
        for cy in range(ncell):
            me = slice(starts[cx * ncell + cy], ends[cx * ncell + cy])
            if me.start == me.stop:
                continue
            for dx, dy in ((0, 0), (0, 1), (1, -1), (1, 0), (1, 1)):
                ox, oy = cx + dx, cy + dy
                if not (0 <= ox < ncell and 0 <= oy < ncell):
                    continue
                other = slice(starts[ox * ncell + oy], ends[ox * ncell + oy])
                if other.start == other.stop:
                    continue
                d = pts_s[me, None, :] - pts_s[None, other, :]
                close = (d * d).sum(-1) <= r2
                if dx == 0 and dy == 0:
                    # same-cell pairs once (i < j), like cross-cell pairs
                    close = np.triu(close, k=1)
                ii, jj = np.nonzero(close)
                out_u.append(order[np.arange(me.start, me.stop)[ii]])
                out_v.append(order[np.arange(other.start, other.stop)[jj]])
    u = np.concatenate(out_u) if out_u else np.zeros(0, dtype=np.int64)
    v = np.concatenate(out_v) if out_v else np.zeros(0, dtype=np.int64)
    mask = u != v
    return from_edge_list(n, np.stack([u[mask], v[mask]], axis=1), **kw)
