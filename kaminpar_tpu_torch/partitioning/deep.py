"""Deep multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/deep.py``).

``partition() = uncoarsen(initial_partition(coarsen()))``: coarsen until
``n <= 2C``, bipartition the coarsest graph recursively into a small k0 with
the bipartitioning pool, then uncoarsen: project, *extend* the partition
towards k where the level carries more blocks (``compute_k_for_n``), and
refine.  Extension splits each block's subgraph by recursive bipartitioning,
or, for splits into four or more parts of subgraphs of at least
``nested_extension_n`` nodes, with a nested deep pipeline.  Every bisection
runs on the graph's device when ``ip_backend`` resolves to "device" (a CUDA
graph under "auto"), else on the host.

The input is a CSRGraph, or a ``CompressedGraph`` (the TeraPart tier).
Under ``device_decode`` "finest"/"auto" a ``DeviceCompressedView`` stands
in for the finest CSR during coarsening; under "off" the finest CSR is
decompressed on the host.  Either way it is released while the coarse
levels are worked on and decoded again at level 0.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import numpy as np
import torch

from ..coarsening.cluster_coarsener import ClusterCoarsener
from ..context import Context
from ..factories import create_refiner
from ..graph.compressed import CompressedGraph
from ..graph.csr import CSRGraph, from_numpy_csr
from ..graph.device_compressed import build_device_view
from ..graph.partitioned import PartitionedGraph
from ..initial.bipartitioner import HostCSR, extract_all_subgraphs, recursive_bipartition
from ..utils import RandomState
from ..utils.logger import Logger, OutputLevel
from .kway import graph_to_host
from .partition_utils import compute_k_for_n, intermediate_block_weights, split_offsets


def extend_partition(graph: CSRGraph, part: np.ndarray, cur_k: int, new_k: int,
                     ctx: Context, jobs: dict) -> np.ndarray:
    """Split every block of a cur_k-way partition so that the result has
    new_k blocks; returns the (n,) int32 host partition.  The block
    subgraphs are extracted on the host; block b's job runs under its own
    seed, so the result does not depend on job order.  ``jobs`` accumulates
    the count and seconds of both kinds of job (``bisections`` /
    ``bisections_s`` and ``nested`` / ``nested_s``)."""
    final_bw = np.asarray(ctx.partition.max_block_weights, dtype=np.int64)
    k = len(final_bw)
    off_new = split_offsets(k, new_k)
    off_cur = split_offsets(k, cur_k)
    # off_new refines off_cur: intermediate block b splits into the new
    # blocks [lo_of[b], lo_of[b + 1]).
    lo_of = np.searchsorted(off_new, off_cur)
    if not np.array_equal(off_new[lo_of], off_cur):
        raise AssertionError("split refinement violated")
    host = graph_to_host(graph)
    base_seed = int(RandomState.numpy_rng().integers(1 << 30))
    out = np.zeros(graph.n, dtype=np.int32)
    for b, (sub, nodes) in enumerate(extract_all_subgraphs(host, part, cur_k)):
        lo, hi = int(lo_of[b]), int(lo_of[b + 1])
        sub_k = hi - lo
        if sub_k <= 1:
            out[nodes] = lo
            continue
        # budgets of the new blocks = sums of their final budgets
        budgets = np.array(
            [final_bw[off_new[j] : off_new[j + 1]].sum() for j in range(lo, hi)],
            dtype=np.int64,
        )
        t0 = time.perf_counter()
        with RandomState.scoped(base_seed ^ (b * 0x9E3779B9 & 0x7FFFFFFF)):
            if sub_k >= 4 and sub.n >= ctx.initial_partitioning.nested_extension_n:
                kind = "nested"
                subpart = _nested_partition(sub, sub_k, budgets, ctx, graph.device)
            else:
                kind = "bisections"
                subpart = recursive_bipartition(
                    sub, sub_k, budgets, RandomState.numpy_rng(),
                    ctx.initial_partitioning, device=graph.device,
                )
        jobs[kind] += 1
        jobs[kind + "_s"] += time.perf_counter() - t0
        out[nodes] = subpart + lo
    return out


def _nested_partition(sub: HostCSR, sub_k: int, budgets: np.ndarray, ctx: Context,
                      device) -> np.ndarray:
    """Partition one extension subgraph with a nested deep pipeline on
    ``device``; the best of ``nested_extension_reps`` attempts (feasible
    first, then cut) wins."""
    sub_ctx = copy.deepcopy(ctx)
    sub_ctx.compression.enabled = False
    sub_ctx.partition.k = sub_k
    sub_ctx.partition.max_block_weights = np.asarray(budgets, dtype=np.int64)
    g = from_numpy_csr(sub.row_ptr, sub.col_idx, sub.node_w, sub.edge_w, device=device)
    best_part, best_score = None, None
    for _ in range(max(ctx.initial_partitioning.nested_extension_reps, 1)):
        p = DeepMultilevelPartitioner(sub_ctx, g).partition()
        score = (not p.is_feasible(), p.edge_cut())
        if best_score is None or score < best_score:
            best_part, best_score = p.partition.cpu().numpy().astype(np.int32), score
    return best_part


class DeepMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: Optional[CSRGraph], *,
                 compressed: Optional[CompressedGraph] = None, device=None):
        """``graph``, or ``compressed`` (with ``graph`` None) and the
        ``device`` to partition it on."""
        self.ctx = ctx
        self.graph = graph
        self.compressed = compressed
        self.device = graph.device if graph is not None else torch.device(device)
        # Host seconds of the three phases of the last partition() call
        # (and of the extension steps inside uncoarsening, split into
        # recursive-bisection and nested-pipeline jobs), the number of
        # extension jobs of each kind, the coarsest graph's n, m and block
        # count k0, and the number of coarsening levels it built.
        self.phase_seconds = {}
        self.extension_jobs = {}
        self.coarsest = {}
        self.num_levels = 0
        # The DeviceCompressedView the finest level ran off, if any.
        self.compressed_view = None

    def _refine(self, graph: CSRGraph, part, cur_k: int, coarse: bool) -> PartitionedGraph:
        max_bw = intermediate_block_weights(
            np.asarray(self.ctx.partition.max_block_weights, dtype=np.int64), cur_k
        )
        if coarse:
            # Relax caps on coarse graphs by their max node weight: moves
            # need headroom when one coarse node weighs a large fraction of
            # a block's budget.
            eps = self.ctx.partition.epsilon
            relaxed = np.ceil(max_bw / (1.0 + eps)).astype(np.int64) + int(
                graph.max_node_weight
            )
            max_bw = np.maximum(max_bw, relaxed)
        p_graph = PartitionedGraph.create(graph, cur_k, part, max_bw)
        return create_refiner(self.ctx).refine(p_graph)

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        k = ctx.partition.k
        C = ctx.coarsening.contraction_limit
        t0 = time.perf_counter()
        cview = None
        if self.graph is None:
            cview = build_device_view(ctx.compression, self.compressed, self.device)
            self.compressed_view = cview
            if cview is None:
                self.graph = self.compressed.decompress(self.device)
        coarsener = ClusterCoarsener(ctx, self.graph, compressed_view=cview)
        coarsest = coarsener.coarsen(k, ctx.partition.epsilon, 2 * C)
        if self.compressed is not None and coarsener.num_levels > 0:
            # Only the compressed form and the coarse graphs stay resident
            # until uncoarsening is back at level 0.
            coarsener.release_input_graph(self.compressed)
            self.graph = None
        self.num_levels = coarsener.num_levels
        t1 = time.perf_counter()

        cur_k = min(k, compute_k_for_n(coarsest.n, C, k))
        self.coarsest = dict(n=coarsest.n, m=coarsest.m, k0=cur_k)
        Logger.log(
            f"  deep: coarsest n={coarsest.n} m={coarsest.m} "
            f"levels={coarsener.num_levels} k0={cur_k}",
            OutputLevel.DEBUG,
        )
        rng = RandomState.numpy_rng()
        budgets = intermediate_block_weights(
            np.asarray(ctx.partition.max_block_weights, dtype=np.int64), cur_k
        )
        part = recursive_bipartition(
            graph_to_host(coarsest), cur_k, budgets, rng, ctx.initial_partitioning,
            device=coarsest.device,
        )
        t2 = time.perf_counter()
        p_graph = self._refine(coarsest, part, cur_k, coarsener.num_levels > 0)

        extension_s = 0.0
        jobs = {"bisections": 0, "bisections_s": 0.0, "nested": 0, "nested_s": 0.0}
        while True:
            graph = coarsener.current_graph
            target_k = compute_k_for_n(graph.n, C, k) if coarsener.num_levels > 0 else k
            if cur_k < target_k:
                te = time.perf_counter()
                part = extend_partition(
                    graph, p_graph.partition.cpu().numpy(), cur_k, target_k, ctx, jobs
                )
                extension_s += time.perf_counter() - te
                cur_k = target_k
                p_graph = self._refine(graph, part, cur_k, coarsener.num_levels > 0)
            if coarsener.num_levels == 0:
                break
            fine_part = coarsener.uncoarsen(p_graph.partition)
            p_graph = self._refine(
                coarsener.current_graph, fine_part, cur_k, coarsener.num_levels > 0
            )
        self.phase_seconds = {
            "coarsening": t1 - t0,
            "initial_partitioning": t2 - t1,
            "uncoarsening": time.perf_counter() - t2,
            "uncoarsening.extension": extension_s,
            "uncoarsening.extension.bisections": jobs["bisections_s"],
            "uncoarsening.extension.nested": jobs["nested_s"],
        }
        self.extension_jobs = {"bisections": jobs["bisections"], "nested": jobs["nested"]}
        return p_graph
