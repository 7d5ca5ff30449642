"""CSR graph held in torch tensors.

Counterpart of ``kaminpar_tpu/graph/csr.py``: four flat int32 arrays
``(row_ptr, col_idx, node_w, edge_w)`` plus ``edge_u``, the source node of
every CSR slot.  Every undirected edge is stored twice.  Graphs are built
on the host (numpy in, CPU tensors) and moved to a device with
:meth:`CSRGraph.to`.

:class:`PaddedView` pads a graph onto the sqrt(2) shape ladder
(``utils/intmath.next_shape_bucket``): pad nodes have weight 0 and degree
0, except the last one (the anchor), which owns every pad edge; pad edges
are weight-0 self-loops on the anchor.  Padding is therefore inert in
ratings, cuts and contraction.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..resilience.errors import GraphValidationError
from ..resilience.faults import maybe_inject
from ..utils import sync_stats
from ..utils.intmath import next_shape_bucket

IDX = torch.int32


def _next_bucket(x: int, minimum: int = 256) -> int:
    return next_shape_bucket(x, minimum)


def _as_index_tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=IDX).contiguous()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x), dtype=np.int32)).to(device)


class PaddedView(NamedTuple):
    row_ptr: torch.Tensor
    col_idx: torch.Tensor
    node_w: torch.Tensor
    edge_w: torch.Tensor
    edge_u: torch.Tensor
    n: int
    m: int

    @property
    def n_pad(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def m_pad(self) -> int:
        return int(self.col_idx.shape[0])

    @property
    def anchor(self) -> int:
        return self.n_pad - 1

    def pad_node_array(self, arr: torch.Tensor, fill) -> torch.Tensor:
        """Pad an (n,) array to (n_pad,) with ``fill``."""
        arr = torch.as_tensor(arr, device=self.row_ptr.device)
        pad = torch.full((self.n_pad - self.n,), fill, dtype=arr.dtype,
                         device=arr.device)
        return torch.cat([arr, pad])


class CSRGraph:
    def __init__(self, row_ptr, col_idx, node_w=None, edge_w=None, *,
                 edge_u=None, device=None):
        if device is None:
            device = (row_ptr.device if isinstance(row_ptr, torch.Tensor)
                      else torch.device("cpu"))
        self.device = torch.device(device)
        # Host copy of row_ptr when built from numpy: the layout plan and
        # edge_u then need no device readback.
        self._host_row_ptr = (
            np.asarray(row_ptr, dtype=np.int64)
            if not isinstance(row_ptr, torch.Tensor) else None
        )
        self.row_ptr = _as_index_tensor(row_ptr, self.device)
        self.col_idx = _as_index_tensor(col_idx, self.device)
        self.n = int(self.row_ptr.shape[0]) - 1
        self.m = int(self.col_idx.shape[0])
        self.node_w = (
            torch.ones(self.n, dtype=IDX, device=self.device)
            if node_w is None else _as_index_tensor(node_w, self.device)
        )
        self.edge_w = (
            torch.ones(self.m, dtype=IDX, device=self.device)
            if edge_w is None else _as_index_tensor(edge_w, self.device)
        )
        self.edge_u = (
            _compute_edge_u(self.row_ptr, self._host_row_ptr, self.m)
            if edge_u is None else _as_index_tensor(edge_u, self.device)
        )
        self._padded: Optional[PaddedView] = None
        self._bucketed = None
        self._total_node_weight: Optional[int] = None
        self._max_node_weight: Optional[int] = None
        # set by the contraction's readback (ops/contraction.py)
        self._total_edge_weight: Optional[int] = None
        # The DeviceCompressedView a finest graph was decoded from (its LP
        # refinement pass rates off the compressed stream), else None.
        self._compressed_view = None

    def to(self, device) -> "CSRGraph":
        """The same graph with its arrays on ``device``."""
        g = CSRGraph.__new__(CSRGraph)
        g.device = torch.device(device)
        for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
            setattr(g, attr, getattr(self, attr).to(g.device))
        g.n, g.m = self.n, self.m
        g._host_row_ptr = self._host_row_ptr
        g._padded = None
        g._bucketed = None
        g._total_node_weight = self._total_node_weight
        g._max_node_weight = self._max_node_weight
        g._total_edge_weight = self._total_edge_weight
        g._compressed_view = None
        return g

    def community_masked(self, comm: torch.Tensor) -> "CSRGraph":
        """This graph with every edge between two communities (``comm``:
        (n,) int32 per node) at weight 0.  It shares this graph's arrays
        and host ``row_ptr``, and its bucketed layout is this graph's with
        the slot weights masked (``bucketed.mask_bucketed_view``), so it
        costs no readback and no new plan."""
        from .bucketed import mask_bucketed_view

        g = CSRGraph.__new__(CSRGraph)
        g.__dict__.update(self.__dict__)
        keep = comm[self.edge_u] == comm[self.col_idx]
        g.edge_w = torch.where(keep, self.edge_w, torch.zeros((), dtype=IDX, device=self.device))
        g._total_edge_weight = None  # the masked edges no longer count
        g._padded = None
        g._bucketed = mask_bucketed_view(self.bucketed(), comm, self.padded().n_pad)
        g._compressed_view = None
        return g

    def host_row_ptr(self) -> np.ndarray:
        if self._host_row_ptr is None:
            self._host_row_ptr = sync_stats.pull(self.row_ptr).astype(np.int64)
        return self._host_row_ptr

    def padded(self) -> PaddedView:
        if self._padded is None:
            n_pad = _next_bucket(self.n)
            m_pad = _next_bucket(self.m)
            n_fill, m_fill = n_pad - self.n, m_pad - self.m
            dev = self.device

            def full(size, value):
                return torch.full((size,), value, dtype=IDX, device=dev)

            # A fresh shape bucket: the "compile" fault-injection point,
            # under the JAX package's site string.
            maybe_inject("compile", site=f"padded_bucket:{n_pad}x{m_pad}")

            self._padded = PaddedView(
                torch.cat([self.row_ptr, full(n_fill - 1, self.m), full(1, m_pad)]),
                torch.cat([self.col_idx, full(m_fill, n_pad - 1)]),
                torch.cat([self.node_w, full(n_fill, 0)]),
                torch.cat([self.edge_w, full(m_fill, 0)]),
                torch.cat([self.edge_u, full(m_fill, n_pad - 1)]),
                self.n, self.m,
            )
        return self._padded

    def bucketed(self):
        """Degree-bucketed layout (cached), over the PaddedView's node space."""
        if self._bucketed is None:
            from .bucketed import build_bucketed_view

            self._bucketed = build_bucketed_view(
                self.host_row_ptr(), self.col_idx, self.edge_w, self.n,
                self.padded().anchor,
            )
        return self._bucketed

    @property
    def total_node_weight(self) -> int:
        if self._total_node_weight is None:
            self._total_node_weight = int(sync_stats.pull(self.node_w.sum(dtype=torch.int64)))
        return self._total_node_weight

    @property
    def max_node_weight(self) -> int:
        if self._max_node_weight is None:
            self._max_node_weight = (int(sync_stats.pull(self.node_w.max()))
                                     if self.n > 0 else 0)
        return self._max_node_weight

    @property
    def total_edge_weight(self) -> int:
        if self._total_edge_weight is None:
            self._total_edge_weight = int(sync_stats.pull(self.edge_w.sum(dtype=torch.int64)))
        return self._total_edge_weight

    def has_uniform_edge_weights(self) -> bool:
        if self.m == 0:
            return True
        return bool(sync_stats.pull(self.edge_w.min() == self.edge_w.max()))

    def __repr__(self):
        return f"CSRGraph(n={self.n}, m={self.m}, device={self.device})"


def _compute_edge_u(row_ptr: torch.Tensor, host_row_ptr, m: int) -> torch.Tensor:
    """edge_u[e] = source node of CSR slot e."""
    if m == 0:
        return torch.zeros(0, dtype=IDX, device=row_ptr.device)
    if host_row_ptr is not None:
        deg = np.diff(host_row_ptr)
        eu = np.repeat(np.arange(len(deg), dtype=np.int32), deg)
        return torch.from_numpy(eu).to(row_ptr.device)
    deg = (row_ptr[1:] - row_ptr[:-1]).to(torch.int64)
    n = int(deg.shape[0])
    return torch.repeat_interleave(
        torch.arange(n, dtype=IDX, device=row_ptr.device), deg
    )


def validate_csr_input(row_ptr, col_idx, node_w=None, edge_w=None) -> None:
    """The facade's input guard: reject malformed CSR input with a
    :class:`~..resilience.errors.GraphValidationError` (a ``ValueError``,
    ``site="csr_ingest"``) under the JAX package's messages, before a
    non-monotone row_ptr or an out-of-range column turns into garbage in
    a kernel.  O(n + m) numpy, structural checks only.  The port's
    tensors are int32, so sizes and weight totals are held to the int32
    range under the port's own messages (the JAX package's name its
    ``use_64bit_ids`` build, which the port does not have)."""

    def _reject(msg: str):
        raise GraphValidationError(f"rejected graph input: {msg}", site="csr_ingest")

    rp = np.asarray(row_ptr)
    col = np.asarray(col_idx)
    if rp.ndim != 1 or rp.size < 1:
        _reject(f"row_ptr must be 1-D with n+1 entries, got shape {rp.shape}")
    if col.ndim != 1:
        _reject(f"col_idx must be 1-D, got shape {col.shape}")
    if not np.issubdtype(rp.dtype, np.integer) or not np.issubdtype(col.dtype, np.integer):
        _reject(f"row_ptr/col_idx must be integer arrays, got {rp.dtype}/{col.dtype}")
    n, m = rp.size - 1, col.size
    if rp[0] != 0:
        _reject(f"row_ptr[0] must be 0, got {int(rp[0])}")
    if int(rp[-1]) != m:
        _reject(f"row_ptr[-1] ({int(rp[-1])}) must equal len(col_idx) ({m})")
    # a signed diff: on an unsigned row_ptr a descending step would wrap
    drp = np.diff(rp.astype(np.int64))
    if n > 0 and np.any(drp < 0):
        bad = int(np.argmax(drp < 0))
        _reject(f"row_ptr is non-monotone at node {bad} "
                f"({int(rp[bad])} -> {int(rp[bad + 1])})")
    if m > 0:
        cmin, cmax = int(col.min()), int(col.max())
        if cmin < 0 or cmax >= n:
            _reject(f"col_idx out of range: [{cmin}, {cmax}] vs n={n}")
    id_max = np.iinfo(np.int32).max
    if m > id_max or n > id_max:
        _reject(f"n={n}/m={m} exceed the port's int32 index space")
    for name, w, count in (("node", node_w, n), ("edge", edge_w, m)):
        if w is None:
            continue
        w = np.asarray(w)
        if w.shape != (count,):
            _reject(f"{name}_weights must have shape ({count},), got {w.shape}")
        if not np.issubdtype(w.dtype, np.integer):
            # a float weight would be truncated by the int32 cast: a
            # different problem, not a rounding detail
            _reject(f"{name}_weights must be an integer array, got {w.dtype}")
        if w.size and int(w.min()) < 0:
            _reject(f"negative {name} weight {int(w.min())} at index {int(np.argmin(w))}")
        # A total that wraps corrupts every block cap; the count x max
        # bound clears healthy graphs, else the exact total decides (an
        # int64 sum where it cannot wrap, Python ints where it could).
        if w.size:
            wmax = int(w.max())
            if wmax > id_max:
                _reject(f"{name} weight {wmax} exceeds the port's int32 index space")
            if count * wmax > id_max:
                if count * wmax <= np.iinfo(np.int64).max:
                    total = int(w.astype(np.int64).sum())
                else:
                    total = int(np.add.reduce(w.astype(object)))
                if total > id_max:
                    _reject(f"total {name} weight {total} exceeds the port's "
                            "int32 index space")


def from_numpy_csr(row_ptr, col_idx, node_w=None, edge_w=None, *,
                   validate_input: bool = False, device="cpu") -> CSRGraph:
    if validate_input:
        validate_csr_input(row_ptr, col_idx, node_w, edge_w)
    return CSRGraph(
        np.asarray(row_ptr, dtype=np.int64),
        np.asarray(col_idx, dtype=np.int32),
        None if node_w is None else np.asarray(node_w, dtype=np.int32),
        None if edge_w is None else np.asarray(edge_w, dtype=np.int32),
        device=device,
    )


def from_edge_list(n: int, edges, edge_weights=None, node_weights=None, *,
                   symmetrize: bool = True, dedup: bool = True) -> CSRGraph:
    """CSR graph from an (E, 2) undirected edge array, built on the host:
    self-loops dropped, duplicate edges merged with summed weights."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    w = (
        np.ones(len(edges), dtype=np.int64)
        if edge_weights is None
        else np.asarray(edge_weights, dtype=np.int64)
    )
    mask = edges[:, 0] != edges[:, 1]
    edges, w = edges[mask], w[mask]
    if symmetrize:
        edges = np.concatenate([edges, edges[:, ::-1]], axis=0)
        w = np.concatenate([w, w])
    if dedup and len(edges):
        # Duplicates are merged whatever their order, so an unstable sort
        # gives the same graph; the merged edges come out sorted by (u, v).
        key = edges[:, 0] * n + edges[:, 1]
        order = np.argsort(key)
        key, edges, w = key[order], edges[order], w[order]
        first = np.ones(len(key), dtype=bool)
        first[1:] = key[1:] != key[:-1]
        seg = np.cumsum(first) - 1
        w = np.bincount(seg, weights=w, minlength=int(seg[-1]) + 1).astype(np.int64)
        edges = edges[first]
    else:
        order = np.lexsort((edges[:, 1], edges[:, 0]))
        edges, w = edges[order], w[order]
    deg = np.bincount(edges[:, 0], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    return from_numpy_csr(row_ptr, edges[:, 1], node_weights, w)
