"""Recursive-bisection multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/rb.py``): k blocks by recursive bisection,
every bisection a whole k-way multilevel run with k = 2 on the subgraph.
The subgraphs are built on the parent graph's device, so a CUDA run keeps
every inner pipeline on the card.
"""

from __future__ import annotations

import copy
import time
from collections import Counter

import numpy as np

from ..context import Context, PartitioningMode
from ..graph.csr import CSRGraph, from_numpy_csr
from ..graph.partitioned import PartitionedGraph
from ..initial.bipartitioner import extract_subgraph
from ..refinement.balancer import UnderloadBalancer
from ..telemetry import probes
from ..utils import sync_stats
from ..utils.timer import scoped_timer
from .kway import KWayMultilevelPartitioner, graph_to_host


class RBMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: CSRGraph):
        self.ctx = ctx
        self.graph = graph
        # Of the last partition() call: the host seconds of its phases, the
        # number of bisections (each a k = 2 pipeline), and the subgraphs
        # built for the recursion, counted by device.
        self.phase_seconds = {}
        self.bisections = 0
        self.subgraph_devices = Counter()

    def _bisect(self, graph: CSRGraph, max_bw: np.ndarray) -> np.ndarray:
        sub_ctx = copy.deepcopy(self.ctx)
        sub_ctx.mode = PartitioningMode.KWAY
        sub_ctx.partition.k = 2
        sub_ctx.partition.max_block_weights = max_bw
        # the final k's minimums do not apply to a bisection
        sub_ctx.partition.min_block_weights = None
        p = KWayMultilevelPartitioner(sub_ctx, graph).partition()
        self.bisections += 1
        return sync_stats.pull(p.partition).astype(np.int32)

    def _recurse(self, graph: CSRGraph, k: int, max_bw: np.ndarray) -> np.ndarray:
        if k <= 1 or graph.n == 0:
            return np.zeros(graph.n, dtype=np.int32)
        k0 = (k + 1) // 2
        k1 = k - k0
        budgets = np.array([max_bw[:k0].sum(), max_bw[k0:].sum()], dtype=np.int64)
        bi = self._bisect(graph, budgets)
        # a marker row per bisection (host-known sizes); the bisection's
        # own pipeline records its levels
        probes.refinement_pass("rb_bisection", n=graph.n, m=graph.m, k0=k0, k1=k1)
        part = np.zeros(graph.n, dtype=np.int32)
        host = graph_to_host(graph)
        for side, (kk, offset) in enumerate(((k0, 0), (k1, k0))):
            sub, nodes = extract_subgraph(host, bi, side)
            if kk > 1:
                subgraph = from_numpy_csr(sub.row_ptr, sub.col_idx, sub.node_w, sub.edge_w,
                                          device=graph.device)
                self.subgraph_devices[str(subgraph.device)] += 1
                subpart = self._recurse(subgraph, kk, max_bw[offset : offset + kk])
            else:
                subpart = np.zeros(sub.n, dtype=np.int32)
            part[nodes] = subpart + offset
        return part

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        self.bisections = 0
        self.subgraph_devices = Counter()
        t0 = time.perf_counter()
        with scoped_timer("partitioning"):
            part = self._recurse(self.graph, ctx.partition.k,
                                 np.asarray(ctx.partition.max_block_weights, dtype=np.int64))
        p_graph = PartitionedGraph.create(self.graph, ctx.partition.k, part,
                                          ctx.partition.max_block_weights,
                                          ctx.partition.min_block_weights)
        t1 = time.perf_counter()
        # The bisections refine without the final k's minimums: one k-way
        # underload pass enforces them.
        if ctx.partition.min_block_weights is not None:
            p_graph = UnderloadBalancer(ctx.refinement.balancer).refine(p_graph)
        self.phase_seconds = {"bisections": t1 - t0,
                              "underload_balancing": time.perf_counter() - t1}
        return p_graph
