"""Single-shot k-way multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/kway.py``): coarsen until ``n <= max(C·k,
2C)``, partition the coarsest graph into k blocks by recursive bisection
(every bisection on the graph's device when ``ip_backend`` resolves to
"device"), then uncoarsen with refinement at k on every level.

Also the host materialization of a graph for the initial partitioner,
``graph_to_host``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..coarsening.cluster_coarsener import ClusterCoarsener
from ..context import Context
from ..factories import create_refiner
from ..graph.csr import CSRGraph
from ..graph.partitioned import PartitionedGraph
from ..initial.bipartitioner import HostCSR, recursive_bipartition
from ..utils import RandomState
from ..utils.logger import Logger, OutputLevel


def graph_to_host(graph: CSRGraph) -> HostCSR:
    """The graph's four CSR arrays as int64 numpy arrays, copied from the
    device in one transfer."""
    n, m = graph.n, graph.m
    packed = torch.cat([graph.row_ptr, graph.col_idx, graph.node_w, graph.edge_w])
    packed = packed.cpu().numpy().astype(np.int64)
    return HostCSR(
        packed[: n + 1],
        packed[n + 1 : n + 1 + m],
        packed[n + 1 + m : n + 1 + m + n],
        packed[n + 1 + m + n :],
    )


def initial_partition(graph: CSRGraph, ctx: Context) -> np.ndarray:
    """k-way partition of the coarsest graph by recursive bisection; returns
    the (n,) int32 host partition."""
    return recursive_bipartition(
        graph_to_host(graph), ctx.partition.k,
        np.asarray(ctx.partition.max_block_weights, dtype=np.int64),
        RandomState.numpy_rng(), ctx.initial_partitioning, device=graph.device,
    )


class KWayMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: CSRGraph):
        self.ctx = ctx
        self.graph = graph
        # Of the last partition() call, as DeepMultilevelPartitioner records
        # them: the host seconds of its phases, the coarsest graph's n, m
        # and block count, the number of levels and the node count of each
        # (the input's first), whether coarsening converged above the
        # target, and the coarsener's sparsification counts.
        self.phase_seconds = {}
        self.coarsest = {}
        self.num_levels = 0
        self.level_n = []
        self.converged = False
        self.sparsification = {}

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        k = ctx.partition.k
        C = ctx.coarsening.contraction_limit
        max_bw, min_bw = ctx.partition.max_block_weights, ctx.partition.min_block_weights
        t0 = time.perf_counter()
        coarsener = ClusterCoarsener(ctx, self.graph)
        coarsest = coarsener.coarsen(k, ctx.partition.epsilon, max(C * k, 2 * C))
        self.num_levels = coarsener.num_levels
        self.level_n = [self.graph.n] + [level.graph.n for level in coarsener.hierarchy]
        self.coarsest = dict(n=coarsest.n, m=coarsest.m, k0=k)
        self.converged = coarsener.converged
        self.sparsification = coarsener.sparsification
        Logger.log(f"  kway: coarsest n={coarsest.n} m={coarsest.m} "
                   f"levels={coarsener.num_levels}", OutputLevel.DEBUG)
        t1 = time.perf_counter()
        part = initial_partition(coarsest, ctx)
        t2 = time.perf_counter()
        p_graph = PartitionedGraph.create(coarsest, k, part, max_bw, min_bw)
        p_graph = create_refiner(ctx, coarse_level=coarsener.num_levels > 0).refine(p_graph)
        while coarsener.num_levels > 0:
            fine_part = coarsener.uncoarsen(p_graph.partition)
            p_graph = PartitionedGraph.create(coarsener.current_graph, k, fine_part, max_bw,
                                              min_bw)
            p_graph = create_refiner(ctx, coarse_level=coarsener.num_levels > 0).refine(p_graph)
        self.phase_seconds = {
            "coarsening": t1 - t0,
            "initial_partitioning": t2 - t1,
            "uncoarsening": time.perf_counter() - t2,
        }
        return p_graph
