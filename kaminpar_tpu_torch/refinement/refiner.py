"""Refiner interface and the keep-best refiner pipeline (counterpart of
``kaminpar_tpu/refinement/refiner.py``)."""

from __future__ import annotations

from typing import Sequence

from ..graph.partitioned import PartitionedGraph
from ..utils.logger import Logger, OutputLevel


class Refiner:
    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        raise NotImplementedError


class MultiRefiner(Refiner):
    """Ordered refiner pipeline that never returns a partition worse than
    its input, ranked lexicographically on (infeasible, edge cut), where
    feasible means within the maximum and, when set, above the minimum
    block weights."""

    def __init__(self, refiners: Sequence[Refiner]):
        self.refiners = list(refiners)

    @staticmethod
    def _rank(p_graph: PartitionedGraph):
        infeasible = not (p_graph.is_feasible() and p_graph.is_min_feasible())
        return (infeasible, p_graph.edge_cut())

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        debug = Logger.level >= OutputLevel.DEBUG
        best = p_graph
        best_rank = self._rank(p_graph)
        prev_cut = best_rank[1]
        for r in self.refiners:
            p_graph = r.refine(p_graph)
            rank = self._rank(p_graph)
            if debug:
                Logger.log(f"    {type(r).__name__}: cut {prev_cut} -> {rank[1]}",
                           OutputLevel.DEBUG)
            prev_cut = rank[1]
            if rank <= best_rank:
                best, best_rank = p_graph, rank
        return best


class NoopRefiner(Refiner):
    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        return p_graph
