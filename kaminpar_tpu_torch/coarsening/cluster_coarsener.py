"""Cluster coarsener: clustering + contraction hierarchy (counterpart of
``kaminpar_tpu/coarsening/cluster_coarsener.py`` without communities and
without the compressed view)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch

from ..context import Context
from ..graph.csr import CSRGraph
from ..ops.contraction import contract_clustering, project_partition
from ..utils.logger import Logger, OutputLevel
from .lp_clusterer import LPClustering
from .max_cluster_weights import compute_max_cluster_weight


@dataclass
class CoarseLevel:
    graph: CSRGraph  # the coarse graph produced at this level
    coarse_of: torch.Tensor  # fine node -> coarse node


class ClusterCoarsener:
    def __init__(self, ctx: Context, graph: CSRGraph):
        self.ctx = ctx
        self.input_graph = graph
        self.hierarchy: List[CoarseLevel] = []
        pinned = ctx.coarsening.lp.weighted_mode
        weighted = (bool(pinned) if pinned is not None
                    else graph.m > 0 and not graph.has_uniform_edge_weights())
        self.clusterer = LPClustering(ctx.coarsening.lp, weighted_graph=weighted)

    @property
    def current_graph(self) -> CSRGraph:
        return self.hierarchy[-1].graph if self.hierarchy else self.input_graph

    @property
    def num_levels(self) -> int:
        return len(self.hierarchy)

    def coarsen_once(self, k: int, epsilon: float) -> bool:
        """One level; False when it shrank by less than the convergence
        threshold (the level is then not pushed)."""
        graph = self.current_graph
        n_cur, m_cur = graph.n, graph.m
        max_cw = compute_max_cluster_weight(
            self.ctx.coarsening, n_cur, graph.total_node_weight, k, epsilon
        )
        # Bound the per-level shrink: cap cluster weight at ~shrink factor x
        # the average node weight, so synchronous LP keeps a gradual
        # hierarchy.
        sf = self.ctx.coarsening.max_shrink_factor
        if sf > 0:
            avg_w = graph.total_node_weight / max(n_cur, 1)
            max_cw = min(max_cw, max(int(sf * avg_w), 1))
        labels = self.clusterer.compute_clustering(graph, max_cw)
        coarse, coarse_of = contract_clustering(graph, labels)
        Logger.log(
            f"  coarsening level {len(self.hierarchy)}: n={n_cur} -> {coarse.n}, "
            f"m={m_cur} -> {coarse.m} (max_cw={max_cw})",
            OutputLevel.DEBUG,
        )
        if 1.0 - coarse.n / max(n_cur, 1) < self.ctx.coarsening.convergence_threshold:
            return False
        self.hierarchy.append(CoarseLevel(coarse, coarse_of))
        return True

    def coarsen(self, k: int, epsilon: float, target_n: int) -> CSRGraph:
        """Coarsen until n <= target_n or convergence."""
        while self.current_graph.n > target_n:
            if not self.coarsen_once(k, epsilon):
                break
        return self.current_graph

    def uncoarsen(self, partition: torch.Tensor) -> torch.Tensor:
        """Pop one level and project the partition to the finer graph."""
        level = self.hierarchy.pop()
        return project_partition(level.coarse_of, partition)
