"""The ``KaMinPar`` facade, the port's public entry point (counterpart of
``kaminpar_tpu/kaminpar.py``).

It owns a graph and a :class:`Context`, sets up the block-weight limits,
strips isolated nodes, runs the partitioner of ``ctx.mode`` (deep, k-way,
recursive bisection or v-cycle) on its device and re-inserts the isolated nodes into the lightest blocks; where that
leaves a block below its minimum weight, the underload balancer repairs
it on the whole graph.  A compressed
graph (``set_graph(CompressedGraph)``, or any graph under a context with
``compression.enabled``, as the ``terapart`` preset sets) is partitioned
from its compressed form: budgets come from its metadata and the isolated
nodes stay in, for LP's isolated-node pass.  The device is
``cuda:0`` unless the caller names another one; without CUDA the facade
raises instead of running on the CPU.  Tests pass ``device="cpu"``, where
every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .context import Context, PartitioningMode
from .factories import create_partitioner
from .graph.compressed import CompressedGraph, compress
from .graph.csr import CSRGraph, from_numpy_csr
from .graph.isolated import assign_isolated_nodes, strip_isolated_csr
from .graph.partitioned import PartitionedGraph
from .presets import create_context_by_preset_name
from .refinement.balancer import UnderloadBalancer
from .utils import Logger, OutputLevel, RandomState, Timer, log_result_line, sync_stats
from .utils.assertions import HEAVY, LIGHT, kassert


def resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "KaMinPar runs on cuda:0 by default and CUDA is not available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda", 0)
    return torch.device(device)


def strip_to_work_graph(graph: CSRGraph, k: int, device):
    """The facade's work graph on ``device``: ``graph`` without its
    isolated nodes (``graph/isolated.strip_isolated_csr``), built from the
    host arrays of one readback.  Returns ``(work_graph, stripped,
    node_w)``: ``stripped`` is the strip's (keep, isolated, row_ptr,
    col_idx, node_w) or None, ``node_w`` the whole graph's host node
    weights, both for :func:`reinsert_isolated`."""
    row_ptr = graph.host_row_ptr()
    col_idx, node_w, edge_w = sync_stats.pull(graph.col_idx, graph.node_w, graph.edge_w)
    stripped = strip_isolated_csr(row_ptr, lambda: col_idx, node_w, graph.n, k)
    if stripped is not None:
        _, isolated, new_rp, new_col, new_nw = stripped
        Logger.log(f"Removed {len(isolated)} isolated nodes")
        return from_numpy_csr(new_rp, new_col, new_nw, edge_w, device=device), stripped, node_w
    return from_numpy_csr(row_ptr, col_idx, node_w, edge_w, device=device), None, node_w


def reinsert_isolated(n: int, k: int, stripped, work_part: np.ndarray, node_w: np.ndarray,
                      max_bw: np.ndarray) -> np.ndarray:
    """The whole graph's (n,) int32 partition from the work graph's: the
    isolated nodes go to the lightest blocks."""
    if stripped is None:
        return work_part
    keep, isolated, _, _, new_nw = stripped
    return assign_isolated_nodes(n, k, keep, isolated, work_part, new_nw, node_w,
                                 max_bw).astype(np.int32)


class KaMinPar:
    """Usage::

        import kaminpar_tpu_torch as kp
        solver = kp.KaMinPar("default")        # on cuda:0
        solver.copy_graph(row_ptr, col_idx)    # numpy CSR
        partition = solver.compute_partition(k=16, epsilon=0.03)
    """

    def __init__(self, ctx_or_preset: Union[Context, str] = "default", device=None,
                 engine=None):
        if isinstance(ctx_or_preset, str):
            ctx_or_preset = create_context_by_preset_name(ctx_or_preset)
        self.ctx = ctx_or_preset
        # An optional warm serving engine (serve/engine.py):
        # compute_partition delegates to it instead of running the pipeline
        # in this process's thread.
        self._engine = engine
        self.device = engine.device if engine is not None and device is None \
            else resolve_device(device)
        self.graph: Optional[CSRGraph] = None
        self.compressed_graph: Optional[CompressedGraph] = None
        self._last: Optional[PartitionedGraph] = None
        # The partitioner of the last run (its scheme's stats: phase times,
        # levels, coarsest graph, and the scheme's own counts).
        self.last_partitioner = None

    def set_graph(self, graph: Union[CSRGraph, CompressedGraph]) -> None:
        """A CSRGraph, or a CompressedGraph; with ``ctx.compression.enabled``
        a CSRGraph is stored compressed."""
        if isinstance(graph, CompressedGraph):
            self.graph, self.compressed_graph = None, graph
        elif self.ctx.compression.enabled:
            self.graph, self.compressed_graph = None, compress(graph)
            Logger.log(f"compressed input: {self.compressed_graph.memory_bytes()} B "
                       f"({self.compressed_graph.compression_ratio():.2f}x)")
        else:
            self.graph, self.compressed_graph = graph, None

    def copy_graph(self, row_ptr: np.ndarray, col_idx: np.ndarray,
                   node_weights: Optional[np.ndarray] = None,
                   edge_weights: Optional[np.ndarray] = None) -> None:
        """CSR input as numpy arrays, validated here."""
        self.set_graph(from_numpy_csr(row_ptr, col_idx, node_weights, edge_weights,
                                      validate_input=True))

    def set_engine(self, engine) -> None:
        """Attach (or with None detach) a warm ``serve.PartitionEngine``;
        later ``compute_partition`` calls are served by it (its context
        governs the pipeline; the results equal a direct run under the same
        context bit for bit)."""
        self._engine = engine

    def compute_partition(self, k: int, epsilon: float = 0.03,
                          max_block_weights: Optional[Sequence[int]] = None,
                          min_epsilon: float = 0.0,
                          min_block_weights: Optional[Sequence[int]] = None,
                          resume=None) -> np.ndarray:
        """Partition into k blocks; returns the (n,) int32 block array.

        ``resume``: a checkpoint file or directory (its latest boundary), or
        a loaded ``CheckpointState``, of a DEEP run that was killed; its
        fingerprint is checked against this graph and context, and the run
        goes on from the recorded level boundary, bit for bit as the
        uninterrupted run (``resilience/checkpoint.py``; DEEP mode and
        dense inputs only, else ``ValueError``).

        Block weight limit: ``max((1+epsilon)*ceil(W/k), ceil(W/k) +
        max_node_weight)`` per block, or the absolute ``max_block_weights``.
        Minimum block weight: ``min(ceil((1-min_epsilon)*ceil(W/k)), W // k)``
        per block when ``min_epsilon`` > 0, or the absolute
        ``min_block_weights``; the underload balancer enforces it.
        """
        if self._engine is not None and self.graph is not None and resume is None:
            # Delegation to the warm engine: its dispatcher runs the same
            # facade path on its own context, so this facade's state
            # (weighted-mode pin, last partition) is untouched.  Compressed
            # inputs and resumes stay in this process.
            return self._engine.partition(
                self.graph, k, epsilon, max_block_weights=max_block_weights,
                min_epsilon=min_epsilon, min_block_weights=min_block_weights)
        graph = self.graph if self.graph is not None else self.compressed_graph
        if graph is None:
            raise ValueError("call set_graph or copy_graph first")
        ctx = self.ctx
        if k <= 0:
            raise ValueError("k must be positive")
        if k > max(graph.n, 1):
            raise ValueError(f"k={k} exceeds number of nodes {graph.n}")

        RandomState.reseed(ctx.seed)
        Timer.reset_global()
        start = time.perf_counter()
        lp_ctx = ctx.coarsening.lp
        pinned = lp_ctx.weighted_mode
        try:
            # The weighted clustering mode follows the user's graph, also in
            # nested pipelines whose subgraphs carry accumulated weights.
            if pinned is None and graph.m > 0:
                lp_ctx.weighted_mode = not graph.has_uniform_edge_weights()
            return self._partition(graph, k, epsilon, max_block_weights, min_epsilon,
                                   min_block_weights, start, resume)
        finally:
            lp_ctx.weighted_mode = pinned

    def _partition(self, graph: Union[CSRGraph, CompressedGraph], k: int,
                   epsilon: float, max_block_weights, min_epsilon: float,
                   min_block_weights, start: float, resume=None) -> np.ndarray:
        ctx = self.ctx
        total_node_weight = graph.total_node_weight
        max_node_weight = (int(graph.node_w.max(initial=0))
                           if isinstance(graph, CompressedGraph) else graph.max_node_weight)
        ctx.partition.setup(total_node_weight, k, epsilon, min_epsilon)
        if max_block_weights is not None:
            max_bw = np.asarray(max_block_weights, dtype=np.int64)
            if max_bw.shape != (k,):
                raise ValueError(
                    f"max_block_weights must have length k={k}, got {max_bw.shape}"
                )
            ctx.partition.max_block_weights = max_bw
        else:
            perfect = (total_node_weight + k - 1) // k
            ctx.partition.max_block_weights = np.maximum(
                ctx.partition.max_block_weights, perfect + max_node_weight
            )
        if min_block_weights is not None:
            min_bw = np.asarray(min_block_weights, dtype=np.int64)
            if min_bw.shape != (k,):
                raise ValueError(
                    f"min_block_weights must have length k={k}, got {min_bw.shape}"
                )
            ctx.partition.min_block_weights = min_bw
        max_bw = np.asarray(ctx.partition.max_block_weights, dtype=np.int64)
        min_bw = ctx.partition.min_block_weights
        if graph.n == 0:
            return np.zeros(0, dtype=np.int32)
        if resume is not None and (isinstance(graph, CompressedGraph)
                                   or ctx.mode != PartitioningMode.DEEP):
            raise ValueError("resume= is supported for DEEP-mode dense inputs only "
                             "(resilience/checkpoint.py envelope)")

        if isinstance(graph, CompressedGraph):
            # The isolated nodes stay in: the strip needs a full CSR rebuild,
            # and LP's isolated-node pass clusters them.
            partitioner = create_partitioner(ctx, None, compressed=graph,
                                             device=self.device)
            p_graph = partitioner.partition()
            self.last_partitioner = partitioner
            self._last = PartitionedGraph.create(p_graph.graph, k, p_graph.partition, max_bw,
                                                 min_bw)
            part = sync_stats.pull(self._last.partition).astype(np.int32)
            self._check_output(part, k)
            log_result_line(self._last.edge_cut(), self._last.imbalance(),
                            self._last.is_feasible(), k, time.perf_counter() - start)
            Logger.log(Timer.global_().machine_readable(), OutputLevel.EXPERIMENT)
            return part

        # Strip isolated nodes on the host; they go to the lightest blocks
        # afterwards.  The work graph is held to the whole graph's minimum
        # block weights.
        work_graph, stripped, node_w = strip_to_work_graph(graph, k, self.device)

        partitioner = create_partitioner(ctx, work_graph)
        if ctx.mode == PartitioningMode.DEEP:
            # The top-level DEEP run may write checkpoints and resume; its
            # fingerprint is the work graph's (isolated nodes stripped),
            # the graph the partitioner sees.
            partitioner._checkpoint_top_level = True
            if resume is not None:
                from .resilience import checkpoint

                partitioner.resume_state = (
                    resume if isinstance(resume, checkpoint.CheckpointState)
                    else checkpoint.load(resume))
        p_graph = partitioner.partition()
        self.last_partitioner = partitioner
        work_part = sync_stats.pull(p_graph.partition).astype(np.int32)
        # Isolated nodes carry no edges: the work graph's cut is the cut.
        cut = p_graph.edge_cut()
        part = reinsert_isolated(graph.n, k, stripped, work_part, node_w, max_bw)
        self._last = PartitionedGraph.create(graph, k, part, max_bw, min_bw)
        if stripped is not None and not self._last.is_min_feasible():
            # The work graph was held to minimums its own weight may not
            # reach, so its underload balancer found no donor, and packing
            # the isolated nodes into the lightest blocks can leave a block
            # short.  On the whole graph the heavier blocks can donate.
            whole = PartitionedGraph.create(graph.to(self.device), k, part, max_bw, min_bw)
            whole = UnderloadBalancer(ctx.refinement.balancer).refine(whole)
            part = sync_stats.pull(whole.partition).astype(np.int32)
            cut = whole.edge_cut()
            self._last = PartitionedGraph.create(graph, k, part, max_bw, min_bw)
        self._check_output(part, k)
        log_result_line(cut, self._last.imbalance(), self._last.is_feasible(), k,
                        time.perf_counter() - start)
        Logger.log(Timer.global_().machine_readable(), OutputLevel.EXPERIMENT)
        return part

    def _check_output(self, part: np.ndarray, k: int) -> None:
        """The assertion ladder on the output: the labels' range at the light
        level, the block weight caps at the heavy level."""
        kassert(lambda: part.size == 0 or (part.min() >= 0 and part.max() < k),
                "partition labels out of range", LIGHT)
        kassert(lambda: self._last.is_feasible(), "partition violates block weight caps",
                HEAVY)

    @property
    def last_partition(self) -> Optional[PartitionedGraph]:
        return self._last
