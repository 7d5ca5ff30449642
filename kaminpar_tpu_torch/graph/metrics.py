"""Partition quality metrics (counterpart of ``kaminpar_tpu/graph/metrics.py``):
edge cut, block weights, imbalance, overload and underload, and
feasibility against maximum and minimum block weights."""

from __future__ import annotations

import numpy as np
import torch

from ..utils import sync_stats
from .csr import CSRGraph


def _labels(graph: CSRGraph, partition) -> torch.Tensor:
    return torch.as_tensor(partition, device=graph.device).to(torch.int64)


def block_weights(graph: CSRGraph, partition, k: int) -> np.ndarray:
    """(k,) int64 host array of block weights."""
    bw = torch.zeros(k, dtype=torch.int64, device=graph.device)
    bw.index_add_(0, _labels(graph, partition), graph.node_w.to(torch.int64))
    return sync_stats.pull(bw)


def _directed_cut(graph: CSRGraph, lab) -> torch.Tensor:
    """Twice the edge cut of the int64 labels ``lab``, a device scalar."""
    cut = lab[graph.edge_u.long()] != lab[graph.col_idx.long()]
    return torch.where(cut, graph.edge_w.to(torch.int64), 0).sum()


def edge_cut_device(graph: CSRGraph, partition) -> torch.Tensor:
    """The edge cut as an int64 device scalar (no readback: the quality
    probes pack it into an existing pull)."""
    return _directed_cut(graph, _labels(graph, partition)) // 2


def quality_scalars_device(graph: CSRGraph, partition, k: int):
    """Device ``(cut, max block weight)`` int64 scalars for the quality
    probes (``telemetry/probes.py``): no readback, so that they can ride
    an existing pull."""
    lab = _labels(graph, partition)
    bw = torch.zeros(k, dtype=torch.int64, device=graph.device)
    bw.index_add_(0, lab, graph.node_w.to(torch.int64))
    return _directed_cut(graph, lab) // 2, bw.max()


def edge_cut(graph: CSRGraph, partition) -> int:
    """Total weight of cut edges, each undirected edge counted once."""
    if graph.m == 0:
        return 0
    return int(sync_stats.pull(_directed_cut(graph, _labels(graph, partition)))) // 2


def cut_and_overloaded(graph: CSRGraph, partition, k: int, max_block_weights):
    """(edge cut, whether any block is above its maximum), read back
    together."""
    lab = _labels(graph, partition)
    bw = torch.zeros(k, dtype=torch.int64, device=graph.device)
    bw.index_add_(0, lab, graph.node_w.to(torch.int64))
    caps = torch.as_tensor(max_block_weights, dtype=torch.int64, device=graph.device)
    over = (bw > caps).any().to(torch.int64)
    cut2, overloaded = (int(x) for x in sync_stats.pull(torch.stack([_directed_cut(graph, lab), over])))
    return cut2 // 2, bool(overloaded)


def imbalance(graph: CSRGraph, partition, k: int) -> float:
    """max_b w(b) / ceil(W/k) - 1."""
    bw = block_weights(graph, partition, k)
    perfect = -(graph.total_node_weight // -k)
    return float(bw.max() / perfect - 1.0) if perfect > 0 else 0.0


def total_overload(graph: CSRGraph, partition, k: int, max_block_weights) -> int:
    bw = block_weights(graph, partition, k)
    return int(np.maximum(bw - np.asarray(max_block_weights, dtype=np.int64), 0).sum())


def is_feasible(graph: CSRGraph, partition, k: int, max_block_weights) -> bool:
    return total_overload(graph, partition, k, max_block_weights) == 0


def total_underload(graph: CSRGraph, partition, k: int, min_block_weights) -> int:
    """Sum of weight missing below the per-block minimums."""
    bw = block_weights(graph, partition, k)
    return int(np.maximum(np.asarray(min_block_weights, dtype=np.int64) - bw, 0).sum())


def is_min_feasible(graph: CSRGraph, partition, k: int, min_block_weights) -> bool:
    return total_underload(graph, partition, k, min_block_weights) == 0
