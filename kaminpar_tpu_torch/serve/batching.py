"""Bucket-batched multi-graph packing for the serving runtime (counterpart
of ``kaminpar_tpu/serve/batching.py``).

Requests landing in the same shape cell — ``(node-bucket, edge-bucket, k)``
on the sqrt(2) geometric ladder of :func:`utils.intmath.next_shape_bucket`,
the same ladder every ``CSRGraph.padded()`` view compiles against — are
micro-batched.  The batch's graphs are packed as *disjoint components* into
one union CSR buffer (host-side concatenation with node-id offsets; the
components never share an edge, so per-graph structure is preserved
exactly), and per-graph quality metrics for the whole batch are computed in
a **single dispatch** over the packed buffer via graph-id segment
reductions (:func:`batched_metrics`), with one batched readback for all of
them.  The metrics are plain torch scatter and segment sums (no kernel).

The partitions themselves come from the engine (per graph or lane-stacked,
both bit-identical to sequential ``KaMinPar.compute_partition`` runs) and
are checked and unpacked against the packed buffer here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..graph.csr import CSRGraph, _next_bucket
from ..utils import sync_stats


class ShapeCell(NamedTuple):
    """Batching key: two padded-shape rungs plus the block count."""

    n_bucket: int
    m_bucket: int
    k: int


def shape_cell(graph, k: int) -> ShapeCell:
    """The (node-bucket, edge-bucket, k) cell a request lands in.  Uses the
    same geometric ladder (and the same minimum rung) as
    ``CSRGraph.padded()``, so one cell == one set of top-level compile
    shapes."""
    return ShapeCell(_next_bucket(graph.n), _next_bucket(graph.m), int(k))


class PackedBatch(NamedTuple):
    """Disjoint union of a batch's graphs plus unpack metadata.

    ``node_offsets``/``edge_offsets`` are (b+1,) prefix sums; graph ``i``
    owns nodes ``[node_offsets[i], node_offsets[i+1])`` of the union.
    ``node_gid``/``edge_gid`` map every union slot back to its graph."""

    union: CSRGraph
    node_offsets: np.ndarray
    edge_offsets: np.ndarray
    node_gid: np.ndarray
    edge_gid: np.ndarray

    @property
    def num_graphs(self) -> int:
        return len(self.node_offsets) - 1


def pack_graphs(graphs: Sequence[CSRGraph], device=None) -> PackedBatch:
    """Pack graphs as disjoint components into one padded-buffer-ready CSR.

    Host-side (batch formation is orchestration): concatenates the CSR
    arrays with node-id offsets.  The union is a structurally valid graph
    whose padded view lands on the bucket ladder like any other graph; it
    is built on ``device`` (default: the first graph's)."""
    if not graphs:
        raise ValueError("cannot pack an empty batch")
    idt = np.int32
    n_off = np.zeros(len(graphs) + 1, dtype=np.int64)
    m_off = np.zeros(len(graphs) + 1, dtype=np.int64)
    np.cumsum([g.n for g in graphs], out=n_off[1:])
    np.cumsum([g.m for g in graphs], out=m_off[1:])
    row_ptr = np.zeros(int(n_off[-1]) + 1, dtype=idt)
    col_idx = np.empty(int(m_off[-1]), dtype=idt)
    node_w = np.empty(int(n_off[-1]), dtype=idt)
    edge_w = np.empty(int(m_off[-1]), dtype=idt)
    node_gid = np.empty(int(n_off[-1]), dtype=np.int32)
    edge_gid = np.empty(int(m_off[-1]), dtype=np.int32)
    for i, g in enumerate(graphs):
        ns, ne = int(n_off[i]), int(n_off[i + 1])
        ms, me = int(m_off[i]), int(m_off[i + 1])
        # one counted readback per member graph (zero-copy for a CPU
        # graph, a real pull on the card)
        rp_h, col_h, nw_h, ew_h = sync_stats.pull(
            g.row_ptr, g.col_idx, g.node_w, g.edge_w, phase="serve_pack"
        )
        row_ptr[ns + 1 : ne + 1] = rp_h[1:] + ms
        col_idx[ms:me] = col_h + ns
        node_w[ns:ne] = nw_h
        edge_w[ms:me] = ew_h
        node_gid[ns:ne] = i
        edge_gid[ms:me] = i
    union = CSRGraph(row_ptr, col_idx, node_w, edge_w,
                     device=graphs[0].device if device is None else device)
    return PackedBatch(union, n_off, m_off, node_gid, edge_gid)


def unpack_partition(labels: np.ndarray, node_offsets: np.ndarray) -> List[np.ndarray]:
    """Split a union-node-space label array back into per-graph arrays
    (host arrays in, host arrays out — the engine pulls before unpacking)."""
    labels = np.asarray(labels)
    return [
        labels[int(node_offsets[i]) : int(node_offsets[i + 1])]
        for i in range(len(node_offsets) - 1)
    ]


def form_batches(requests: Sequence, max_batch: int) -> List[list]:
    """Group requests into same-cell batches of at most ``max_batch``,
    FIFO-fair: each batch is seeded by the oldest unbatched request and
    collects later same-cell requests in arrival order.  Items must carry a
    ``.cell`` attribute (``ServeRequest`` does)."""
    batches: List[list] = []
    remaining = list(requests)
    while remaining:
        cell = remaining[0].cell
        take = [r for r in remaining if r.cell == cell][: max(1, int(max_batch))]
        taken = set(map(id, take))
        remaining = [r for r in remaining if id(r) not in taken]
        batches.append(take)
    return batches


def _packed_metrics(edge_u, col_idx, edge_w, labels, edge_gid, node_w, node_gid,
                    num_graphs: int, k: int):
    """Per-graph edge cuts and block weights of a packed batch: graph-id
    segment sums over the union buffer (pad slots are inert, weight 0, as
    in graph/metrics.py).  Returns one flat int64 tensor ``[cut_0 ..
    cut_{b-1}, bw_0_0 .. bw_{b-1}_{k-1}]``, so the caller reads the whole
    batch back in one pull."""
    from ..utils import compile_stats

    compile_stats.record("serve_packed_metrics", (edge_u, labels), (num_graphs, k))
    dev = labels.device
    ew = edge_w.to(torch.int64)
    cut = labels[edge_u.long()] != labels[col_idx.long()]
    cuts = torch.zeros(num_graphs, dtype=torch.int64, device=dev).index_add_(
        0, edge_gid.long(), torch.where(cut, ew, 0)) // 2
    seg = node_gid.long() * k + labels.long()
    bw = torch.zeros(num_graphs * k, dtype=torch.int64, device=dev).index_add_(
        0, seg, node_w.to(torch.int64))
    return torch.cat([cuts, bw])


def batched_metrics(
    packed: PackedBatch,
    parts: Sequence[np.ndarray],
    k: int,
    pad_to: Optional[int] = None,
):
    """(cuts (b,), block_weights (b, k)) for every graph of the batch —
    single dispatch over the packed union buffer, single counted readback
    (utils/sync_stats phase ``serve_batch_metrics``).

    ``pad_to`` buckets the graph count at the engine's max batch: the
    trailing segments sum nothing, so every occupancy of one (union bucket,
    k) cell has the same shapes, as the JAX package keeps them."""
    from ..utils import sync_stats

    b = packed.num_graphs
    nb = max(b, int(pad_to or 0))
    pv = packed.union.padded()
    labels = np.zeros(pv.n_pad, dtype=np.int32)
    labels[: pv.n] = np.concatenate(list(parts))
    egid = np.zeros(pv.m_pad, dtype=np.int32)
    egid[: pv.m] = packed.edge_gid
    ngid = np.zeros(pv.n_pad, dtype=np.int32)
    ngid[: pv.n] = packed.node_gid
    dev = pv.node_w.device
    flat = _packed_metrics(
        pv.edge_u, pv.col_idx, pv.edge_w, torch.from_numpy(labels).to(dev),
        torch.from_numpy(egid).to(dev), pv.node_w, torch.from_numpy(ngid).to(dev),
        num_graphs=nb, k=int(k),
    )
    flat = sync_stats.pull(flat, phase="serve_batch_metrics")
    return flat[:b], flat[nb:].reshape(nb, int(k))[:b]
