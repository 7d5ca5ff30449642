"""Partition state over a CSR graph (counterpart of
``kaminpar_tpu/graph/partitioned.py``).  Refiners return new partitions;
block weights are recomputed on demand."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import metrics
from .csr import CSRGraph


@dataclass
class PartitionedGraph:
    graph: CSRGraph
    k: int
    partition: torch.Tensor  # (n,) int32 block ids on the graph's device
    max_block_weights: np.ndarray  # (k,) int64
    min_block_weights: Optional[np.ndarray] = None  # (k,) int64, None = unconstrained

    @classmethod
    def create(cls, graph: CSRGraph, k: int, partition, max_block_weights,
               min_block_weights=None) -> "PartitionedGraph":
        part = torch.as_tensor(np.asarray(partition) if not isinstance(
            partition, torch.Tensor) else partition, device=graph.device)
        return cls(graph, int(k), part.to(torch.int32),
                   np.asarray(max_block_weights, dtype=np.int64),
                   None if min_block_weights is None
                   else np.asarray(min_block_weights, dtype=np.int64))

    def block_weights(self) -> np.ndarray:
        return metrics.block_weights(self.graph, self.partition, self.k)

    def edge_cut(self) -> int:
        return metrics.edge_cut(self.graph, self.partition)

    def imbalance(self) -> float:
        return metrics.imbalance(self.graph, self.partition, self.k)

    def is_feasible(self) -> bool:
        return metrics.is_feasible(self.graph, self.partition, self.k,
                                   self.max_block_weights)

    def is_min_feasible(self) -> bool:
        if self.min_block_weights is None:
            return True
        return metrics.is_min_feasible(self.graph, self.partition, self.k,
                                       self.min_block_weights)

    def with_partition(self, partition) -> "PartitionedGraph":
        return PartitionedGraph(
            self.graph, self.k, torch.as_tensor(partition, device=self.graph.device),
            self.max_block_weights, self.min_block_weights,
        )
