"""Deep multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/deep.py``).

``partition() = uncoarsen(initial_partition(coarsen()))``: coarsen until
``n <= 2C``, bipartition the coarsest graph recursively into a small k0 with
the bipartitioning pool, then uncoarsen: project, *extend* the partition
towards k where the level carries more blocks (``compute_k_for_n``), and
refine.  Extension splits each block's subgraph by recursive bipartitioning,
or, for splits into four or more parts of subgraphs of at least
``nested_extension_n`` nodes, with a nested deep pipeline; the blocks' jobs
run in a thread pool.  Under ``device_extension`` (the largek presets),
levels of at least ``device_extension_n`` nodes are extended on the device
instead (``partitioning/extension.py``).  Every bisection runs on the
graph's device when ``ip_backend`` resolves to "device" (a CUDA graph
under "auto"), else on the host.

The input is a CSRGraph, or a ``CompressedGraph`` (the TeraPart tier).
Under ``device_decode`` "finest"/"auto" a ``DeviceCompressedView`` stands
in for the finest CSR during coarsening; under "off" the finest CSR is
decompressed on the host.  Either way it is released while the coarse
levels are worked on and decoded again at level 0.

In a v-cycle (``partitioning/vcycle.py``) the pipeline takes the previous
cycle's partition as ``communities``: coarsening never merges across
them, the coarsest partition is the coarsest level's communities, and
under ``restrict_vcycle_refinement`` every refinement's moves across the
previous cycle's blocks are reverted (:meth:`DeepMultilevelPartitioner._restrict`).
"""

from __future__ import annotations

import contextlib
import copy
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..coarsening.cluster_coarsener import ClusterCoarsener
from ..context import ClusteringAlgorithm, Context
from ..factories import create_refiner
from ..graph import metrics
from ..graph.compressed import CompressedGraph
from ..graph.csr import CSRGraph, from_numpy_csr
from ..graph.device_compressed import build_device_view
from ..graph.partitioned import PartitionedGraph
from ..initial.bipartitioner import (HostCSR, extract_all_subgraphs, recursive_bipartition,
                                     resolve_ip_backend)
from ..refinement.balancer import _balance_round, draw_balance_round
from ..resilience import checkpoint as _ckpt
from ..resilience.faults import maybe_inject
from ..telemetry import probes
from ..utils import RandomState, debug as debug_dumps, platform, sync_stats
from ..utils.logger import Logger, OutputLevel
from ..utils.timer import ScopeClock, Timer, scoped_timer
from .extension import extend_partition_device
from .kway import PHASE_SCOPES, graph_to_host
from .partition_utils import compute_k_for_n, intermediate_block_weights, split_offsets


def extend_partition(graph: CSRGraph, part: np.ndarray, cur_k: int, new_k: int,
                     ctx: Context, jobs: dict) -> np.ndarray:
    """Split every block of a cur_k-way partition so that the result has
    new_k blocks; returns the (n,) int32 host partition.  Graphs of at
    least ``device_extension_n`` nodes take device extension when the
    context asks for it (``partitioning/extension.py``: one restricted
    nested multilevel over all blocks, the best of
    ``device_extension_reps`` attempts by cut), all others the per-block
    host jobs.  ``jobs`` accumulates the counts and seconds of both (see
    :func:`new_job_stats`)."""
    ipc = ctx.initial_partitioning
    if ipc.device_extension and new_k > cur_k and graph.n >= ipc.device_extension_n:
        t0 = time.perf_counter()
        best = extend_partition_device(graph, part, cur_k, new_k, ctx, jobs)
        if ipc.device_extension_reps > 1:
            best_cut = metrics.edge_cut(graph, best)
            for _ in range(ipc.device_extension_reps - 1):
                cand = extend_partition_device(graph, part, cur_k, new_k, ctx, jobs)
                cut = metrics.edge_cut(graph, cand)
                if cut < best_cut:
                    best, best_cut = cand, cut
        jobs["device"] += 1
        jobs["device_s"] += time.perf_counter() - t0
        return best
    return _extend_partition_host(graph, part, cur_k, new_k, ctx, jobs)


def new_job_stats() -> dict:
    """Counters of the extension steps: host jobs of each kind (count and
    summed seconds; the jobs overlap in the thread pool, so the sums can
    exceed the wall), the wall of the pooled sections (``pooled_s``) and
    the device-extension steps (count and wall, their nested host jobs
    included)."""
    return {"bisections": 0, "bisections_s": 0.0, "nested": 0, "nested_s": 0.0,
            "pooled_s": 0.0, "device": 0, "device_s": 0.0}


def _on_device(device):
    """The CUDA current-device scope of ``device`` (kernel launches in a
    worker thread take the thread's current device), or no scope."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _extend_partition_host(graph: CSRGraph, part: np.ndarray, cur_k: int, new_k: int,
                           ctx: Context, jobs: dict) -> np.ndarray:
    """Per-block host extension: the block subgraphs are extracted on the
    host, and every block's job (recursive bisection, or a nested deep
    pipeline for splits into four or more parts of large subgraphs) runs
    in a thread pool (``platform.extension_workers`` threads) under its
    own seed, so that the result depends on neither the job order nor the
    number of workers."""
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
    todo = []
    for b, (sub, nodes) in enumerate(extract_all_subgraphs(host, part, cur_k)):
        lo, hi = int(lo_of[b]), int(lo_of[b + 1])
        if hi - lo <= 1:
            out[nodes] = lo
            continue
        # budgets of the new blocks = sums of their final budgets
        budgets = np.array(
            [final_bw[off_new[j] : off_new[j + 1]].sum() for j in range(lo, hi)],
            dtype=np.int64,
        )
        todo.append((b, lo, hi - lo, sub, nodes, budgets))

    def run_job(job):
        b, lo, sub_k, sub, nodes, budgets = job
        t0 = time.perf_counter()
        # the job's readbacks count against the extension, not "untracked"
        with _on_device(graph.device), sync_stats.scoped("extend_partition"), \
                RandomState.scoped(base_seed ^ (b * 0x9E3779B9 & 0x7FFFFFFF)):
            if sub_k >= 4 and sub.n >= ctx.initial_partitioning.nested_extension_n:
                kind = "nested"
                subpart = _nested_partition(sub, sub_k, budgets, ctx, graph.device)
            else:
                kind = "bisections"
                subpart = recursive_bipartition(
                    sub, sub_k, budgets, RandomState.numpy_rng(),
                    ctx.initial_partitioning, device=graph.device,
                )
        return nodes, subpart + lo, kind, time.perf_counter() - t0

    if todo:
        t0 = time.perf_counter()
        workers = platform.extension_workers(len(todo), graph.device)
        # The jobs' scopes would land in the workers' subtrees and merge as
        # top-level phases: the timer records none of them, as the JAX
        # package's does not.
        timer = Timer.global_()
        timer.disable()
        try:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                results = list(pool.map(run_job, todo))
        finally:
            timer.enable()
        jobs["pooled_s"] += time.perf_counter() - t0
        for nodes, subpart, kind, seconds in results:
            out[nodes] = subpart
            jobs[kind] += 1
            jobs[kind + "_s"] += seconds
    return out


def _nested_partition(sub: HostCSR, sub_k: int, budgets: np.ndarray, ctx: Context,
                      device) -> np.ndarray:
    """Partition one extension subgraph with a nested deep pipeline on
    ``device`` (no minimum block weights); the best of
    ``nested_extension_reps`` attempts (feasible first, then cut) wins."""
    sub_ctx = copy.deepcopy(ctx)
    sub_ctx.compression.enabled = False
    sub_ctx.partition.k = sub_k
    sub_ctx.partition.max_block_weights = np.asarray(budgets, dtype=np.int64)
    sub_ctx.partition.min_block_weights = None
    g = from_numpy_csr(sub.row_ptr, sub.col_idx, sub.node_w, sub.edge_w, device=device)
    best_part, best_score = None, None
    for _ in range(max(ctx.initial_partitioning.nested_extension_reps, 1)):
        p = DeepMultilevelPartitioner(sub_ctx, g).partition()
        score = (not p.is_feasible(), p.edge_cut())
        if best_score is None or score < best_score:
            best_part = sync_stats.pull(p.partition, phase="extend_partition").astype(np.int32)
            best_score = score
    return best_part


class DeepMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: Optional[CSRGraph], *,
                 compressed: Optional[CompressedGraph] = None, device=None,
                 communities: Optional[torch.Tensor] = None, communities_k: int = 0):
        """``graph``, or ``compressed`` (with ``graph`` None) and the
        ``device`` to partition it on; in a v-cycle, ``communities``, the
        previous cycle's ``communities_k``-way partition of ``graph``."""
        self.ctx = ctx
        self.graph = graph
        self.compressed = compressed
        self.communities = communities
        self.communities_k = communities_k
        self.device = graph.device if graph is not None else torch.device(device)
        # Host seconds of the last partition() call: its scopes in the
        # timer tree ("partitioning" and, under it, "coarsening",
        # "initial_partitioning", "uncoarsening": the projections, and
        # "extend_partition" as "uncoarsening.extension"), and of the
        # extension steps inside uncoarsening (the summed
        # seconds of the recursive-bisection and nested-pipeline jobs,
        # which overlap in the thread pool, the wall of the pooled
        # sections and of device extension; see new_job_stats), the number
        # of extension steps of each kind, the coarsest graph's n, m and
        # block count k0, the number of coarsening levels it built and the
        # node count of every level, the input's first.
        self.phase_seconds = {}
        self.extension_jobs = {}
        self.coarsest = {}
        self.num_levels = 0
        self.level_n = []
        # Its coarsening's contractions and the readbacks counted in the
        # "coarsening" phase meanwhile (one each).
        self.contractions = 0
        self.coarsening_pulls = 0
        # the readbacks of its initial partitioning (of the coarsest graph)
        self.ip_pulls = 0
        # The DeviceCompressedView the finest level ran off, if any.
        self.compressed_view = None
        # Checkpoints (resilience/checkpoint.py): the facade marks its own
        # top-level DEEP run eligible and may hand it a loaded
        # CheckpointState to resume from.  Nested pipelines (extension
        # jobs, v-cycle cycles) never set the flag, so an armed
        # KPTPU_CHECKPOINT cannot make them overwrite the run's files.
        self._checkpoint_top_level = False
        self.resume_state = None
        # The last run's checkpoint writer (None when disarmed) and the
        # seconds of its restore (0.0 without a resume).
        self.checkpoint_writer = None
        self.restore_s = 0.0

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
        # Minimum block weights apply once the partition carries the final
        # k (an intermediate block merges several final blocks).
        min_bw = (self.ctx.partition.min_block_weights
                  if cur_k == self.ctx.partition.k else None)
        p_graph = PartitionedGraph.create(graph, cur_k, part, max_bw, min_bw)
        return create_refiner(self.ctx, coarse_level=coarse).refine(p_graph)

    def _restrict(self, p_graph: PartitionedGraph, pre_part, cur_k: int,
                  communities: Optional[torch.Tensor], draw=None) -> PartitionedGraph:
        """Restricted v-cycle refinement: revert the moves of the last
        refinement that crossed the previous cycle's blocks (``pre_part``:
        the partition before it), then, if that broke a budget, rebalance
        inside the previous cycle's blocks (``draw`` as there)."""
        if (not self.ctx.restrict_vcycle_refinement or communities is None
                or self.communities_k <= 0):
            return p_graph
        k = self.ctx.partition.k
        off_cur = split_offsets(k, cur_k)
        off_prev = split_offsets(k, self.communities_k)
        # the previous cycle's block that holds each current block
        blk_comm = np.searchsorted(off_prev, off_cur[:cur_k], side="right") - 1
        dev = p_graph.graph.device
        part = p_graph.partition
        bad = torch.as_tensor(blk_comm, dtype=torch.int32, device=dev)[part.long()] != communities
        if sync_stats.pull(bad.any()):
            pre = torch.as_tensor(pre_part, device=dev).to(torch.int32)
            p_graph = p_graph.with_partition(torch.where(bad, pre, part))
            if not p_graph.is_feasible():
                # Reverted moves can overload a block again, and the
                # refiners cannot repair that across the communities.
                p_graph = self._rebalance_restricted(p_graph, communities, blk_comm, draw)
        return p_graph

    def _rebalance_restricted(self, p_graph: PartitionedGraph, communities: torch.Tensor,
                              blk_comm: np.ndarray, draw=None) -> PartitionedGraph:
        """Group-restricted overload rounds (the group of a block: the
        previous cycle's block holding it) on the community-masked graph.
        ``draw(round)`` gives a round's ``BalanceDraws``; by default they
        are drawn from the run's generator."""
        graph = p_graph.graph
        mg = graph.community_masked(communities)
        pv, bv = mg.padded(), mg.bucketed()
        max_bw = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32,
                                 device=graph.device)
        group_of = torch.as_tensor(blk_comm, dtype=torch.int32, device=graph.device)
        if draw is None:
            gen = RandomState.generator(graph.device)
            draw = lambda _: draw_balance_round(gen, bv, pv.n_pad)  # noqa: E731
        labels = pv.pad_node_array(p_graph.partition, 0)
        for r in range(self.ctx.refinement.balancer.max_num_rounds):
            labels, flags = _balance_round(labels, draw(r), bv, pv.node_w, max_bw,
                                           k=p_graph.k, group_of=group_of)
            num_moved, still = sync_stats.pull(flags)
            if not still or num_moved == 0:
                break
        return p_graph.with_partition(labels[: pv.n])

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        k = ctx.partition.k
        C = ctx.coarsening.contraction_limit
        clock = ScopeClock("partitioning", PHASE_SCOPES)
        cview = None
        if self.graph is None:
            if ctx.coarsening.algorithm != ClusteringAlgorithm.LP:
                # Only LP clusters off the compressed stream: the others
                # get the dense CSR, decompressed onto the device up front.
                Logger.log(f"  terapart: {ctx.coarsening.algorithm.value} clusters the dense "
                           f"CSR; decompressing the input onto {self.device}")
                self.graph = self.compressed.decompress(self.device)
            else:
                sync_pre_cb = sync_stats.phase_count("compressed_build")
                with scoped_timer("compressed_build"):
                    cview = build_device_view(ctx.compression, self.compressed, self.device)
                # host packing and host-to-device copies: no readback
                sync_stats.assert_phase_budget("compressed_build", 0, since=sync_pre_cb)
                self.compressed_view = cview
                if cview is None:
                    self.graph = self.compressed.decompress(self.device)
        coarsener = ClusterCoarsener(ctx, self.graph, compressed_view=cview)
        if self.communities is not None:
            coarsener.set_communities(self.communities)
        n0 = coarsener.current_n
        jobs = new_job_stats()

        # Checkpoints: the top-level run writes its resumable state at every
        # level boundary (and may itself be a resumed run).  The writer's
        # readbacks count under their own phase, held to its exact
        # entitlement below, and to 0 when disarmed.
        resume = self.resume_state if self._checkpoint_top_level else None
        sync_pre_cw = sync_stats.phase_count("checkpoint_write")
        sync_pre_cr = sync_stats.phase_count("checkpoint_restore")
        ckpt = (_ckpt.writer_for(ctx, self.graph, communities=self.communities,
                                 compressed=self.compressed, resume=resume)
                if self._checkpoint_top_level else None)
        self.checkpoint_writer = ckpt
        resumed_up = resume is not None and resume.stage == "uncoarsening"
        p_graph = None
        if resume is not None:
            _ckpt.validate_fingerprint(resume, ctx, self.graph)
            t0 = time.perf_counter()
            with scoped_timer("checkpoint_restore"):
                _ckpt.restore_into(coarsener, resume, self.device)
                if resumed_up:
                    # the dead run's initial partitioning and refinement up
                    # to this level are in the restored partition
                    p_graph = PartitionedGraph.create(
                        coarsener.current_graph, resume.cur_k,
                        _ckpt.to_device(resume.partition, self.device),
                        intermediate_block_weights(
                            np.asarray(ctx.partition.max_block_weights, dtype=np.int64),
                            resume.cur_k),
                        ctx.partition.min_block_weights if resume.cur_k == k else None)
                # every later draw equals the uninterrupted run's
                RandomState.restore(resume.rng)
            self.restore_s = time.perf_counter() - t0

        def coarsen_boundary(c):
            if ckpt is not None:
                ckpt.on_coarsen_level(c)
            # after the write: a kill here finds the boundary on disk
            maybe_inject("preempt", site=f"deep_coarsen:{c.num_levels}")

        with scoped_timer("partitioning"):
            sync_pre = sync_stats.phase_count("coarsening")
            if resumed_up:
                # the restored stack is the whole hierarchy: the dead run
                # had finished coarsening
                coarsest = coarsener.current_graph
            else:
                coarsest = coarsener.coarsen(
                    k, ctx.partition.epsilon, 2 * C,
                    on_level=coarsen_boundary if self._checkpoint_top_level else None)
            self.contractions = coarsener.contractions
            self.coarsening_pulls = sync_stats.phase_count("coarsening") - sync_pre
            # one readback a contraction (ops/contraction.py)
            sync_stats.assert_phase_budget("coarsening", coarsener.contractions,
                                           since=sync_pre)
            self.level_n = [n0] + [level.graph.n for level in coarsener.hierarchy]
            if self.compressed is not None and coarsener.num_levels > 0:
                # Only the compressed form and the coarse graphs stay resident
                # until uncoarsening is back at level 0.
                coarsener.release_input_graph(self.compressed)
                self.graph = None
            self.num_levels = coarsener.num_levels

            if resumed_up:
                cur_k = resume.cur_k
            elif self.communities is not None:
                # v-cycle: the coarsest partition is the previous cycle's,
                # projected to the coarsest level
                RandomState.numpy_rng()  # unused here, drawn as the reference does
                cur_k = self.communities_k
                part = sync_stats.pull(coarsener.current_communities,
                                       phase="initial_partitioning").astype(np.int32)
                with scoped_timer("initial_partitioning"):
                    pass
            else:
                cur_k = min(k, compute_k_for_n(coarsest.n, C, k))
                budgets = intermediate_block_weights(
                    np.asarray(ctx.partition.max_block_weights, dtype=np.int64), cur_k
                )
                rng = RandomState.numpy_rng()
                sync_pre_ip = sync_stats.phase_count("initial_partitioning")
                with scoped_timer("initial_partitioning"):
                    part = recursive_bipartition(
                        graph_to_host(coarsest), cur_k, budgets, rng,
                        ctx.initial_partitioning, device=coarsest.device,
                    )
                self.ip_pulls = sync_stats.phase_count("initial_partitioning") - sync_pre_ip
                if resolve_ip_backend(ctx.initial_partitioning, coarsest.device) == "device":
                    # one packed graph pull and at most one readback a
                    # bisection (cur_k - 1 of them): the device pool's budget
                    sync_stats.assert_phase_budget("initial_partitioning", max(cur_k, 1),
                                                   since=sync_pre_ip)
            self.coarsest = dict(n=coarsest.n, m=coarsest.m, k0=cur_k)
            Logger.log(
                f"  deep: coarsest n={coarsest.n} m={coarsest.m} "
                f"levels={coarsener.num_levels} k0={cur_k}",
                OutputLevel.DEBUG,
            )
            if not resumed_up:
                p_graph = self._refine(coarsest, part, cur_k, coarsener.num_levels > 0)
                p_graph = self._restrict(p_graph, part, cur_k, coarsener.current_communities)

            # A resume at an uncoarsening boundary re-enters the loop at that
            # boundary: it writes and injects nothing there, so the later
            # boundaries keep the dead run's numbers.
            at_resumed_boundary = resumed_up
            sync_pre_cd = sync_stats.phase_count("compressed_decode")
            while True:
                graph = coarsener.current_graph
                target_k = compute_k_for_n(graph.n, C, k) if coarsener.num_levels > 0 else k
                if cur_k < target_k:
                    with scoped_timer("extend_partition"):
                        # the level's quality row (cut, max block weight)
                        # rides this readback, packed behind the partition
                        part = extend_partition(
                            graph,
                            probes.pull_partition_with_quality(p_graph,
                                                               level=coarsener.num_levels),
                            cur_k, target_k, ctx, jobs)
                    cur_k = target_k
                    p_graph = self._refine(graph, part, cur_k, coarsener.num_levels > 0)
                    p_graph = self._restrict(p_graph, part, cur_k,
                                             coarsener.current_communities)
                # Level boundary: this level's extension and refinement are
                # done.  Write the resumable state, then the preemption point.
                if at_resumed_boundary:
                    at_resumed_boundary = False
                else:
                    if ckpt is not None:
                        ckpt.on_uncoarsen_boundary(coarsener, p_graph, cur_k)
                    if self._checkpoint_top_level:
                        maybe_inject("preempt", site=f"deep_uncoarsen:{coarsener.num_levels}")
                if coarsener.num_levels == 0:
                    break
                debug_dumps.dump_graph_hierarchy(graph, coarsener.num_levels, ctx)
                debug_dumps.dump_partition_hierarchy(p_graph, coarsener.num_levels, ctx)
                fine_part = coarsener.uncoarsen(p_graph.partition)
                p_graph = self._refine(
                    coarsener.current_graph, fine_part, cur_k, coarsener.num_levels > 0
                )
                p_graph = self._restrict(p_graph, fine_part, cur_k,
                                         coarsener.current_communities)
            # the finest level's decode on the device reads nothing back
            sync_stats.assert_phase_budget("compressed_decode", 0, since=sync_pre_cd)
            # The writer's exact entitlement (5 pulls a newly cached level, 1
            # a written uncoarsening boundary), 0 when disarmed; the restore
            # copies to the device only.
            sync_stats.assert_phase_budget(
                "checkpoint_write", ckpt.pull_budget if ckpt is not None else 0,
                since=sync_pre_cw)
            sync_stats.assert_phase_budget("checkpoint_restore", 0, since=sync_pre_cr)
            debug_dumps.dump_partition_hierarchy(p_graph, 0, ctx)
        self.phase_seconds = clock.seconds()
        self.phase_seconds.update({
            "uncoarsening.extension.bisections": jobs["bisections_s"],
            "uncoarsening.extension.nested": jobs["nested_s"],
            "uncoarsening.extension.pooled": jobs["pooled_s"],
            "uncoarsening.extension.device": jobs["device_s"],
        })
        self.extension_jobs = {key: jobs[key] for key in ("bisections", "nested", "device")}
        return p_graph
