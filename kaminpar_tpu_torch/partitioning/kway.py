"""Single-shot k-way multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/kway.py``): coarsen until ``n <= max(C·k,
2C)``, partition the coarsest graph into k blocks by recursive bisection
(every bisection on the graph's device when ``ip_backend`` resolves to
"device"), then uncoarsen with refinement at k on every level.

Also the host materialization of a graph for the initial partitioner,
``graph_to_host``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coarsening.cluster_coarsener import ClusterCoarsener
from ..context import Context
from ..factories import create_refiner
from ..graph.csr import CSRGraph
from ..graph.partitioned import PartitionedGraph
from ..initial.bipartitioner import HostCSR, recursive_bipartition, resolve_ip_backend
from ..telemetry import probes
from ..utils import RandomState, sync_stats
from ..utils.logger import Logger, OutputLevel
from ..utils.timer import ScopeClock, scoped_timer


# The keys of ``phase_seconds`` read from the timer tree, and their scopes
# below the scheme's "partitioning" (the deep scheme adds its extension).
PHASE_SCOPES = {"partitioning": (), "coarsening": ("coarsening",),
                "initial_partitioning": ("initial_partitioning",),
                "uncoarsening": ("uncoarsening",),
                "uncoarsening.extension": ("extend_partition",)}


def graph_to_host(graph: CSRGraph) -> HostCSR:
    """The graph's four CSR arrays as int64 numpy arrays, copied from the
    device in one transfer."""
    n, m = graph.n, graph.m
    packed = torch.cat([graph.row_ptr, graph.col_idx, graph.node_w, graph.edge_w])
    packed = sync_stats.pull(packed).astype(np.int64)
    return HostCSR(
        packed[: n + 1],
        packed[n + 1 : n + 1 + m],
        packed[n + 1 + m : n + 1 + m + n],
        packed[n + 1 + m + n :],
    )


def initial_partition(graph: CSRGraph, ctx: Context) -> np.ndarray:
    """k-way partition of the coarsest graph by recursive bisection; returns
    the (n,) int32 host partition."""
    rng = RandomState.numpy_rng()
    pre = sync_stats.phase_count("initial_partitioning")
    with scoped_timer("initial_partitioning"):
        part = recursive_bipartition(
            graph_to_host(graph), ctx.partition.k,
            np.asarray(ctx.partition.max_block_weights, dtype=np.int64),
            rng, ctx.initial_partitioning, device=graph.device,
        )
    if resolve_ip_backend(ctx.initial_partitioning, graph.device) == "device":
        # one packed graph pull and at most one readback a bisection (k - 1
        # of them)
        sync_stats.assert_phase_budget("initial_partitioning", max(ctx.partition.k, 1),
                                       since=pre)
    return part


class KWayMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: CSRGraph):
        self.ctx = ctx
        self.graph = graph
        # Of the last partition() call, as DeepMultilevelPartitioner records
        # them: its share of the timer tree (``deep.PHASE_SCOPES``), the
        # coarsest graph's n, m and block count, the number of levels and
        # the node count of each (the input's first), whether coarsening
        # converged above the target, the coarsener's sparsification counts,
        # and its contractions and the readbacks of its "coarsening" phase.
        self.phase_seconds = {}
        self.coarsest = {}
        self.num_levels = 0
        self.level_n = []
        self.converged = False
        self.sparsification = {}
        self.contractions = 0
        self.coarsening_pulls = 0

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        k = ctx.partition.k
        C = ctx.coarsening.contraction_limit
        max_bw, min_bw = ctx.partition.max_block_weights, ctx.partition.min_block_weights
        clock = ScopeClock("partitioning", {key: path for key, path in PHASE_SCOPES.items()
                                            if key != "uncoarsening.extension"})
        coarsener = ClusterCoarsener(ctx, self.graph)
        with scoped_timer("partitioning"):
            sync_pre = sync_stats.phase_count("coarsening")
            coarsest = coarsener.coarsen(k, ctx.partition.epsilon, max(C * k, 2 * C))
            self.contractions = coarsener.contractions
            self.coarsening_pulls = sync_stats.phase_count("coarsening") - sync_pre
            self.num_levels = coarsener.num_levels
            self.level_n = [self.graph.n] + [level.graph.n for level in coarsener.hierarchy]
            self.coarsest = dict(n=coarsest.n, m=coarsest.m, k0=k)
            self.converged = coarsener.converged
            self.sparsification = coarsener.sparsification
            Logger.log(f"  kway: coarsest n={coarsest.n} m={coarsest.m} "
                       f"levels={coarsener.num_levels}", OutputLevel.DEBUG)
            part = initial_partition(coarsest, ctx)
            p_graph = PartitionedGraph.create(coarsest, k, part, max_bw, min_bw)
            p_graph = create_refiner(ctx, coarse_level=coarsener.num_levels > 0).refine(
                p_graph)
            while coarsener.num_levels > 0:
                fine_part = coarsener.uncoarsen(p_graph.partition)
                fine_graph = coarsener.current_graph
                p_graph = PartitionedGraph.create(fine_graph, k, fine_part, max_bw, min_bw)
                p_graph = create_refiner(ctx, coarse_level=coarsener.num_levels > 0).refine(
                    p_graph)
                # a marker row of host-known sizes (the refiners' own rows
                # carry what their existing pulls read)
                probes.uncoarsening_level(level=coarsener.num_levels, n=fine_graph.n,
                                          m=fine_graph.m, k=k, kind="kway_level")
        self.phase_seconds = clock.seconds()
        return p_graph
