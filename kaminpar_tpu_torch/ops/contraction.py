"""Cluster contraction as a stable sort-reduce (counterpart of
``kaminpar_tpu/ops/contraction.py``).

1. relabel-compact cluster ids (presence mask + prefix sum),
2. map both edge endpoints to coarse ids, drop intra-cluster edges,
3. stable sort by (coarse_u, coarse_v) and sum the weights of each run,
4. compact the runs and build the coarse CSR.

A contraction reads back once (``utils/sync_stats.pull``): the coarse node
and edge counts, the largest coarse node weight and the coarse total edge
weight, and the caller's extra device scalars (the clusterer's moved
count), packed into one small tensor.  The coarsening's quality probe
(``telemetry/probes.py``) reads its values from that pull.  Everything
else stays on the device: no boolean-mask index, no ``bincount``.

Deterministic, so it equals the JAX package array for array.  The labels
cover the graph's PaddedView; pad nodes carry the anchor label and form the
pure-padding cluster, always the last coarse id, which is dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..graph.csr import CSRGraph
from ..telemetry import probes
from ..utils import sync_stats
from .segment import run_ids, run_starts2, segment_sum


def _contract_core(labels, edge_u, col_idx, edge_w, node_w, extra=()):
    """Returns (coarse_of, n_c, c_node_w, out_u, out_v, out_w, row_ptr,
    max_node_w, total_edge_w, extra_host): coarse ids over the padded node
    space (the last coarse id is the padding cluster), the compacted
    coarse edges sorted by (u, v), the coarse row_ptr over the first
    n_c + 1 entries, the largest coarse node weight, the coarse total edge
    weight and the host values of the device scalars ``extra``.  The one
    readback of a contraction is a packed (n_c, m_c, max node weight,
    total edge weight, *extra) tensor; every other step keeps its sizes on
    the device or takes them from that readback."""
    pre = contract_device(labels, edge_u, col_idx, edge_w, node_w, extra)
    return contract_finish(pre, sync_stats.pull(pre.stats))


class ContractPre(NamedTuple):
    """The device half of a contraction, up to its one readback: ``stats``
    is the packed (n_c, m_c, max node weight, total edge weight, *extra)
    int64 tensor that :func:`contract_finish` needs on the host."""

    coarse_of: torch.Tensor
    c_node_w: torch.Tensor
    su: torch.Tensor
    sv: torch.Tensor
    rid: torch.Tensor
    run_w: torch.Tensor
    valid: torch.Tensor
    row_ptr: torch.Tensor
    stats: torch.Tensor


def contract_device(labels, edge_u, col_idx, edge_w, node_w, extra=()) -> ContractPre:
    """Steps 1-3 of the contraction on the device, no readback.  A
    lane-stacked caller stacks several lanes' ``stats`` into one pull."""
    n = int(labels.shape[0])
    m = int(col_idx.shape[0])
    dev = labels.device
    present = torch.zeros(n, dtype=torch.int32, device=dev)
    # index_fill_, not an indexed assignment of 1, which copies the 1 to
    # the card and waits for it
    present.index_fill_(0, labels.long(), 1)
    cmap = torch.cumsum(present, 0, dtype=torch.int32) - 1
    coarse_of = cmap[labels]
    c_node_w = segment_sum(node_w, coarse_of, n)

    cu = coarse_of[edge_u]
    cv = coarse_of[col_idx]
    keep = cu != cv
    # dropped edges sort last under the sentinel key n
    ku = torch.where(keep, cu, torch.full_like(cu, n)).to(torch.int64)
    kv = torch.where(keep, cv, torch.zeros_like(cv)).to(torch.int64)
    order = torch.sort(ku * (n + 1) + kv, stable=True).indices
    su, sv = ku[order], kv[order]
    sw = torch.where(keep[order], edge_w[order], torch.zeros_like(edge_w[order]))
    first = run_starts2(su, sv)
    rid = run_ids(first)
    run_w = segment_sum(sw, rid, m)
    # The kept runs are runs 0 .. m_c - 1 (the dropped edges sort last), so
    # a kept run's first slot goes to position rid, and the degree of a
    # coarse node counts the kept runs it starts.
    valid = first & (su < n)
    deg_c = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(
        0, torch.where(valid, su, torch.zeros_like(su)), valid.to(torch.int32))
    row_ptr = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(deg_c, 0)]).to(torch.int32)
    stats = torch.stack([present.sum(dtype=torch.int64), valid.sum(dtype=torch.int64),
                         c_node_w.max().to(torch.int64), sw.sum(dtype=torch.int64),
                         *(torch.as_tensor(x, device=dev).to(torch.int64) for x in extra)])
    return ContractPre(coarse_of, c_node_w, su, sv, rid, run_w, valid, row_ptr, stats)


def contract_finish(pre: ContractPre, stats_host):
    """Step 4, the compaction, from the host values of ``pre.stats``;
    returns :func:`_contract_core`'s tuple."""
    n_c, m_c, max_node_w, total_edge_w, *extra_host = (int(x) for x in stats_host)
    su, sv = pre.su, pre.sv
    dev = su.device
    slot = torch.where(pre.valid, pre.rid.to(torch.int64), torch.full_like(su, m_c))
    out_u = torch.zeros(m_c + 1, dtype=torch.int64, device=dev).scatter_(0, slot, su)
    out_v = torch.zeros(m_c + 1, dtype=torch.int64, device=dev).scatter_(0, slot, sv)
    out_w = pre.run_w[:m_c]
    return (pre.coarse_of, n_c, pre.c_node_w, out_u[:m_c].to(torch.int32),
            out_v[:m_c].to(torch.int32), out_w, pre.row_ptr, max_node_w, total_edge_w,
            tuple(extra_host))


def _coarse_graph(outs, n: int, m: int, total_node_weight, device):
    """The coarse graph and fine -> coarse map of ``_contract_core``'s
    outputs for a fine graph of n nodes and m edges; the pure-padding
    anchor cluster (always last) is dropped.  With extra scalars the host
    values come third."""
    (coarse_of, n_c, c_node_w, out_u, out_v, out_w, row_ptr, max_node_w,
     total_edge_w, extra_host) = outs
    n_c -= 1
    coarse = CSRGraph(row_ptr[: n_c + 1], out_v, c_node_w[:n_c], out_w,
                      edge_u=out_u, device=device)
    coarse._total_node_weight = total_node_weight
    coarse._max_node_weight = max_node_w if n_c > 0 else 0
    coarse._total_edge_weight = total_edge_w
    probes.contraction_level(n=n, m=m, n_c=coarse.n, m_c=coarse.m,
                             max_node_weight=coarse._max_node_weight,
                             total_edge_weight=total_edge_w)
    out = (coarse, coarse_of[:n])
    return out + (extra_host,) if extra_host else out


def contract_clustering(graph: CSRGraph, labels_padded, extra_scalars=()):
    """Contract a clustering (over ``graph.padded()``) into a coarse graph.
    Returns ``(coarse_graph, coarse_of)`` with ``coarse_of[u]`` the coarse
    node of fine node u (u < graph.n), and with ``extra_scalars`` (device
    scalars packed into the contraction's one readback) their host values
    as a third item."""
    pv = graph.padded()
    outs = _contract_core(labels_padded, pv.edge_u, pv.col_idx, pv.edge_w, pv.node_w,
                          extra_scalars)
    return _coarse_graph(outs, graph.n, graph.m, graph._total_node_weight, graph.device)


def contract_compressed(cv, labels_padded, extra_scalars=()):
    """:func:`contract_clustering` off a ``DeviceCompressedView``: the fine
    edges are decoded (``decode_flat_padded``) straight into the
    sort-reduce and die with it, so no dense finest CSR stays resident.
    The result equals contract_clustering on the decompressed graph."""
    from ..graph.device_compressed import decode_flat_padded

    _, col, ew, eu = decode_flat_padded(cv.stream, cv.wstart_pad, cv.width_pad,
                                        cv.degree_pad, m=cv.m, m_pad=cv.m_pad)
    outs = _contract_core(labels_padded, eu, col, ew, cv.node_w_pad, extra_scalars)
    del col, ew, eu
    return _coarse_graph(outs, cv.n, cv.m, cv.total_node_weight, cv.device)


def project_partition(coarse_of: torch.Tensor, coarse_partition: torch.Tensor) -> torch.Tensor:
    """fine_partition[u] = coarse_partition[coarse_of[u]]."""
    return coarse_partition[coarse_of]
