"""Lane-stacked serve execution: one lockstep multilevel run per
micro-batch (counterpart of ``kaminpar_tpu/serve/lanestack.py``).

A batch's graphs (one per lane) go through coarsening, initial
partitioning and uncoarsening in lockstep.  Every device step runs once
for all lanes over the disjoint union of their layouts
(``ops/lanestack.py``): the LP rounds of clustering, of the overload
balancer and of the LP refiner launch kernel #1 once per union bucket and
kernel #3 once per round on the card.  Every per-level scalar readback is
one stacked pull for all lanes (lane-accounted in ``utils/sync_stats``).

**Bit-identity** with the port's own sequential ``KaMinPar(ctx)
.compute_partition`` is the contract (``tests/test_torch_lanestack.py``):

- every lane owns a :class:`LaneChain`, the ``RandomState`` its own run
  would use (reseeded from ``ctx.seed``: its host generator and, created
  in the order that run creates them, its device generators), and draws
  exactly what its run draws, with the same shapes, when its run draws;
  a lane whose round loop has ended draws nothing more;
- each lane keeps its own graphs, padded views and layouts, so every
  shape a lane sees is its sequential run's;
- the host-orchestrated stages (initial bipartitioning, extension) run
  per lane through the very same functions, with the lane's chain
  swapped into the thread-local ``RandomState`` (:func:`lane_rng`).

Lanes whose coarsening ends at a different depth peel off into their own
cohort; each cohort uncoarsens in lockstep (the union of a step takes
whichever lanes the step has, so lanes with different n, k or block counts
share it).

Eligibility is an explicit envelope (:func:`check_eligibility`): the deep
mode with LP coarsening and the (overload balancer, LP[, underload])
refiner chain on dense inputs without per-request overrides, the serve
preset's configuration.  The JAX package also bails off its Pallas LP
kernels there; the port has no such knob (a CUDA tensor always takes the
kernels), so that bail is gone.  Ineligible batches raise
:class:`LaneStackUnsupported` and the engine serves them graph by graph.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..context import ClusteringAlgorithm, Context, PartitioningMode, RefinementAlgorithm
from ..coarsening.lp_clusterer import LPClustering
from ..coarsening.max_cluster_weights import compute_max_cluster_weight
from ..graph.csr import CSRGraph
from ..initial.bipartitioner import HostCSR, recursive_bipartition
from ..ops import lanestack as lops
from ..ops import lp
from ..partitioning.partition_utils import compute_k_for_n, intermediate_block_weights
from ..refinement.balancer import draw_balance_round
from ..telemetry import probes
from ..utils import RandomState, sync_stats
from ..utils.timer import scoped_timer


class LaneStackUnsupported(Exception):
    """A batch or context outside the lane-stack envelope; the engine
    serves it graph by graph (counted)."""


# ---------------------------------------------------------------------------
# Per-lane random streams
# ---------------------------------------------------------------------------


class LaneChain:
    """The ``RandomState`` one sequential facade run threads through its
    pipeline: reseeded from ``seed`` (the facade's per-call reseed), with
    its host generator and its device generators, created on first use
    in the order the run creates them."""

    def __init__(self, seed: int):
        saved = getattr(RandomState._tls, "state", None)
        RandomState.reseed(seed)
        self.state = RandomState._tls.state
        RandomState._tls.state = saved

    def generator(self, device) -> torch.Generator:
        """The lane's generator on ``device`` (created from the lane's host
        stream on first use, as ``RandomState.generator`` does)."""
        with lane_rng(self):
            return RandomState.generator(device)


@contextmanager
def lane_rng(chain: LaneChain):
    """Swap a lane's chain into this thread's ``RandomState``: unmodified
    sequential code below draws from the lane's streams, and the caller's
    streams are back untouched afterwards."""
    tls = RandomState._tls
    saved = getattr(tls, "state", None)
    tls.state = chain.state
    try:
        yield
    finally:
        chain.state = tls.state
        tls.state = saved


# ---------------------------------------------------------------------------
# Eligibility
# ---------------------------------------------------------------------------

_REFINER_CHAINS = (
    (RefinementAlgorithm.OVERLOAD_BALANCER, RefinementAlgorithm.LP),
    (RefinementAlgorithm.OVERLOAD_BALANCER, RefinementAlgorithm.LP,
     RefinementAlgorithm.UNDERLOAD_BALANCER),
)


def check_eligibility(ctx: Context, graphs: Sequence, k: int) -> None:
    """Raise :class:`LaneStackUnsupported` unless the batch fits the
    lockstep envelope (the serve preset's pipeline)."""

    def bail(reason: str):
        raise LaneStackUnsupported(reason)

    if ctx.mode != PartitioningMode.DEEP:
        bail(f"mode {ctx.mode.value!r} (deep only)")
    if ctx.vcycles or ctx.restrict_vcycle_refinement:
        bail("v-cycle configuration")
    if ctx.compression.enabled:
        bail("compressed inputs")
    if ctx.use_64bit_ids:
        bail("64-bit id build")
    if ctx.coarsening.algorithm != ClusteringAlgorithm.LP:
        bail(f"coarsening algorithm {ctx.coarsening.algorithm.value!r}")
    if ctx.coarsening.overlay_levels > 1:
        bail("overlay clustering")
    if ctx.coarsening.sparsification.enabled:
        bail("sparsification")
    if ctx.coarsening.lp.weighted_mode is not None:
        bail("explicit weighted-mode pin (auto-detection only)")
    if tuple(ctx.refinement.algorithms) not in _REFINER_CHAINS:
        bail(f"refiner chain {tuple(a.value for a in ctx.refinement.algorithms)}")
    if ctx.initial_partitioning.device_extension:
        bail("device extension")
    if ctx.resilience.checkpoint_dir:
        bail("checkpoints armed")
    if k < 2:
        bail("k < 2")
    for g in graphs:
        if not isinstance(g, CSRGraph) or g.n <= 0:
            bail("empty or non-CSR graph")
        if k > g.n:
            bail("k exceeds n")


# ---------------------------------------------------------------------------
# Lanes and cohorts
# ---------------------------------------------------------------------------


@dataclass
class _Lane:
    slot: int  # position in the request batch
    graph: CSRGraph  # the request's graph
    chain: LaneChain
    ctx: Context  # the lane's own partition tree and weighted-mode pin
    caps: np.ndarray  # final (k,) max block weights, int64
    stripped: object  # the facade's isolated-node strip, or None
    node_w: np.ndarray  # the whole graph's host node weights
    weighted: bool
    # levels[0] is the work graph, levels[i] the i-th coarse graph;
    # coarse_of[i] maps levels[i]'s nodes to levels[i + 1]'s
    levels: List[CSRGraph] = field(default_factory=list)
    coarse_of: List[torch.Tensor] = field(default_factory=list)
    cur_k: int = 0
    part: Optional[torch.Tensor] = None  # current (n,) partition on the device


@dataclass
class LaneStackReport:
    """What one lane-stacked batch execution did (the engine's stats)."""

    lanes: int = 0
    cohorts: int = 0
    splits: int = 0
    levels: int = 0
    stacked_pulls: int = 0
    # per request, in request order: the cohort its lane rode
    lane_cohorts: tuple = ()
    # the union shapes this run dispatched, with (k, epsilon) the key of
    # the engine's warm accounting for stacked batches
    layout_key: tuple = ()
    # per request: the final (k,) max block weights the facade would leave
    # in ctx.partition.max_block_weights
    caps: Optional[List[np.ndarray]] = None
    # launches of each kernel during the run (ops/lp_kernels.LAUNCHES)
    launches: Dict[str, int] = field(default_factory=dict)


class LaneStackRunner:
    """One batch execution; :meth:`run` returns the partitions in request
    order, each equal to its sequential facade run's."""

    def __init__(self, ctx: Context, graphs: Sequence, k: int, epsilon: float,
                 device="cpu"):
        self.base_ctx = ctx
        self.graphs = list(graphs)
        self.k = int(k)
        self.epsilon = float(epsilon)
        self.device = torch.device(device)
        self.report = LaneStackReport(lanes=len(self.graphs))
        self._shapes: set = set()
        self._pull0 = 0

    # -- facade replica ----------------------------------------------------

    def _prep_lane(self, slot: int, graph: CSRGraph) -> _Lane:
        from ..kaminpar import strip_to_work_graph

        ctx = self.base_ctx
        k = self.k
        weighted = graph.m > 0 and not graph.has_uniform_edge_weights()
        lane_ctx = copy.copy(ctx)
        lane_ctx.partition = dataclasses.replace(ctx.partition)
        lane_ctx.coarsening = dataclasses.replace(
            ctx.coarsening,
            lp=dataclasses.replace(ctx.coarsening.lp,
                                   weighted_mode=weighted if graph.m > 0 else None))
        tnw, mnw = graph.total_node_weight, graph.max_node_weight
        lane_ctx.partition.setup(tnw, k, self.epsilon, 0.0)
        perfect = (tnw + k - 1) // k
        lane_ctx.partition.max_block_weights = np.maximum(
            lane_ctx.partition.max_block_weights, perfect + mnw)
        caps = np.asarray(lane_ctx.partition.max_block_weights, dtype=np.int64)
        with sync_stats.scoped("serve_lanestack"):
            work, stripped, node_w = strip_to_work_graph(graph, k, self.device)
        lane = _Lane(slot, graph, LaneChain(ctx.seed), lane_ctx, caps, stripped, node_w,
                     weighted)
        lane.levels.append(work)
        return lane

    def _finalize(self, lane: _Lane, work_part: np.ndarray) -> np.ndarray:
        from ..kaminpar import reinsert_isolated

        part = reinsert_isolated(lane.graph.n, self.k, lane.stripped, work_part,
                                 lane.node_w, lane.caps)
        if part.size and (part.min() < 0 or part.max() >= self.k):
            raise AssertionError("partition labels out of range")
        return part

    def _pull(self, *tensors, phase: str, lanes: int):
        self.report.stacked_pulls += 1
        return sync_stats.pull(*tensors, phase=phase, lanes=lanes)

    # -- lockstep coarsening -----------------------------------------------

    def _coarsen(self, lanes: List[_Lane]) -> List[List[_Lane]]:
        """Coarsen every lane in lockstep; returns the cohorts, lanes
        grouped by the depth where their coarsening ended."""
        cc = self.base_ctx.coarsening
        target_n = 2 * cc.contraction_limit
        depth_groups: Dict[int, List[_Lane]] = {}
        active = list(lanes)
        while active:
            go = [ln for ln in active if ln.levels[-1].n > target_n]
            for ln in active:
                if ln.levels[-1].n <= target_n:
                    depth_groups.setdefault(len(ln.levels) - 1, []).append(ln)
            if not go:
                break
            if len(go) < len(active):
                self.report.splits += 1
            active = go
            self.report.levels += 1
            graphs = [ln.levels[-1] for ln in active]
            gens = [ln.chain.generator(self.device) for ln in active]
            max_cw = []
            for g in graphs:
                mcw = compute_max_cluster_weight(cc, g.n, g.total_node_weight, self.k,
                                                 self.epsilon)
                if cc.max_shrink_factor > 0:
                    avg_w = g.total_node_weight / max(g.n, 1)
                    mcw = min(mcw, max(int(cc.max_shrink_factor * avg_w), 1))
                max_cw.append(mcw)
            bvs = [g.bucketed() for g in graphs]
            n_pads = [g.padded().n_pad for g in graphs]
            probs = [LPClustering.sweep_plan(cc.lp, g, ln.weighted)[1]
                     for g, ln in zip(graphs, active)]
            with scoped_timer("coarsening"):
                pre = sync_stats.phase_count("lanestack_coarsening")
                labels, moved = lops.lane_cluster(
                    graphs,
                    lambda j, i: lp.draw_lp_round(gens[j], bvs[j], n_pads[j],
                                                  active_prob=probs[j]),
                    lambda j: lp.draw_two_hop(gens[j], bvs[j], n_pads[j]),
                    max_cw, cc.lp, [ln.weighted for ln in active])
                coarse, stats = lops.lane_contract(graphs, labels, moved)
                self.report.stacked_pulls += (
                    sync_stats.phase_count("lanestack_coarsening") - pre)
            self._shapes.add(("lvl", tuple((g.padded().n_pad, g.padded().m_pad)
                                           for g in graphs)))
            cont = []
            for i, (ln, g, (cg, coarse_of)) in enumerate(zip(active, graphs, coarse)):
                probes.coarsening_level(
                    level=len(ln.levels) - 1, n=g.n, m=g.m, n_c=cg.n, m_c=cg.m,
                    max_cluster_weight=max_cw[i], max_node_weight=int(stats[i, 2]),
                    total_edge_weight=int(stats[i, 3]), lp_moved=int(stats[i, 4]),
                    lp_rounds_budget=cc.lp.num_iterations, lane=ln.slot)
                if 1.0 - cg.n / max(g.n, 1) < cc.convergence_threshold:
                    depth_groups.setdefault(len(ln.levels) - 1, []).append(ln)
                else:
                    ln.levels.append(cg)
                    ln.coarse_of.append(coarse_of)
                    cont.append(ln)
            if cont and len(cont) < len(active):
                self.report.splits += 1
            lops.lane_host_row_ptrs([ln.levels[-1] for ln in cont], "lanestack_coarsening")
            if cont:
                self.report.stacked_pulls += 1
            active = cont
        return [sorted(grp, key=lambda ln: ln.slot)
                for _, grp in sorted(depth_groups.items(), reverse=True)]

    # -- initial partitioning (per lane, host orchestration) ---------------

    def _initial_partition(self, lanes: List[_Lane]) -> None:
        graphs = [ln.levels[-1] for ln in lanes]
        packed = self._pull(torch.cat([torch.cat([g.row_ptr, g.col_idx, g.node_w, g.edge_w])
                                       for g in graphs]),
                            phase="lanestack_ip", lanes=len(lanes)).astype(np.int64)
        pos = 0
        C = self.base_ctx.coarsening.contraction_limit
        for ln, g in zip(lanes, graphs):
            n, m = g.n, g.m
            row = packed[pos : pos + 2 * n + 2 * m + 1]
            pos += 2 * n + 2 * m + 1
            host = HostCSR(row[: n + 1], row[n + 1 : n + 1 + m],
                           row[n + 1 + m : n + 1 + m + n], row[n + 1 + m + n :])
            ln.cur_k = min(self.k, compute_k_for_n(n, C, self.k))
            budgets = intermediate_block_weights(ln.caps, ln.cur_k)
            with lane_rng(ln.chain), scoped_timer("initial_partitioning"):
                rng = RandomState.numpy_rng()
                part = recursive_bipartition(host, ln.cur_k, budgets, rng,
                                             ln.ctx.initial_partitioning, device=g.device)
            ln.part = torch.as_tensor(np.asarray(part, dtype=np.int32), device=g.device)

    # -- lockstep refinement -----------------------------------------------

    def _refine(self, lanes: List[_Lane], level: int) -> None:
        """The keep-best refiner chain (overload balancer, LP refiner) of
        every lane on its graph ``levels[level]`` (``deep._refine``
        replica; the trailing underload balancer is a no-op without
        minimum block weights and cannot change the keep-best outcome)."""
        ctx = self.base_ctx
        eps = self.epsilon
        graphs = [ln.levels[level] for ln in lanes]
        pvs = [g.padded() for g in graphs]
        bvs = [g.bucketed() for g in graphs]
        union = lops.lane_union(bvs, [pv.n_pad for pv in pvs])
        self._shapes.add(("ref", tuple((pv.n_pad, pv.m_pad, ln.cur_k)
                                       for pv, ln in zip(pvs, lanes))))
        edges = lops.LaneEdges.build(union, graphs)
        caps = []
        for ln, g in zip(lanes, graphs):
            mb = intermediate_block_weights(ln.caps, ln.cur_k)
            if level > 0:
                relaxed = np.ceil(mb / (1.0 + eps)).astype(np.int64) + int(g.max_node_weight)
                mb = np.maximum(mb, relaxed)
            caps.append(mb)
        L = len(lanes)
        dev = pvs[0].node_w.device
        node_w = torch.cat([pv.node_w for pv in pvs])
        blocks = lops.LaneBlocks.build(union, [ln.cur_k for ln in lanes])
        max_bw = torch.as_tensor(np.concatenate(caps), dtype=torch.int32, device=dev)
        gens = [ln.chain.generator(dev) for ln in lanes]
        labels = torch.cat([pv.pad_node_array(ln.part, 0) for pv, ln in zip(pvs, lanes)])

        def ranks(q):
            out = []
            for j in range(L):
                bw = q[L + blocks.off[j] : L + blocks.off[j + 1]]
                out.append((bool(np.any(bw > caps[j])), int(q[j])))
            return out

        with scoped_timer("partitioning"):
            snapshots = [labels]
            best_idx = [0] * L
            pre = sync_stats.phase_count("lanestack_refinement")
            best = ranks(lops.lane_quality(union, edges, blocks, labels, node_w))
            lab = labels
            live = [True] * L
            with scoped_timer("overload_balancer"):
                for _ in range(ctx.refinement.balancer.max_num_rounds):
                    draws = [draw_balance_round(gens[j], bvs[j], pvs[j].n_pad) if live[j]
                             else None for j in range(L)]
                    lab, flags = lops.lane_balance_round(union, blocks, lab, draws, node_w,
                                                         max_bw)
                    host = sync_stats.pull(flags, phase="lanestack_refinement", lanes=L)
                    for j in range(L):
                        if live[j] and (not host[j, 1] or host[j, 0] == 0):
                            live[j] = False
                    if not any(live):
                        break
            snapshots.append(lab)
            for j, r in enumerate(ranks(lops.lane_quality(union, edges, blocks, lab,
                                                          node_w))):
                if r <= best[j]:
                    best[j], best_idx[j] = r, 1
            rl = ctx.refinement.lp
            with scoped_timer("lp_refinement"):
                lab_lp = lops.lane_lp_refine(
                    union, lab, node_w, caps,
                    lambda j, i: lp.draw_lp_round(gens[j], bvs[j], pvs[j].n_pad,
                                                  active_prob=rl.active_prob,
                                                  allow_tie_moves=rl.allow_tie_moves),
                    rl)
            snapshots.append(lab_lp)
            for j, r in enumerate(ranks(lops.lane_quality(union, edges, blocks, lab_lp,
                                                          node_w))):
                if r <= best[j]:
                    best[j], best_idx[j] = r, 2
            out = lops.lane_select_best(snapshots, best_idx, union)
            self.report.stacked_pulls += sync_stats.phase_count("lanestack_refinement") - pre
        off = union.node_off
        for j, ln in enumerate(lanes):
            ln.part = out[off[j] : off[j] + union.n[j]]

    # -- extension (per lane, host orchestration) --------------------------

    def _extend(self, lanes: List[_Lane], level: int, target_ks: List[int]) -> None:
        from ..partitioning.deep import extend_partition, new_job_stats

        parts = self._pull(torch.cat([ln.part for ln in lanes]), phase="lanestack_extend",
                           lanes=len(lanes))
        pos = 0
        for ln, tk in zip(lanes, target_ks):
            g = ln.levels[level]
            part = parts[pos : pos + g.n].astype(np.int32)
            pos += g.n
            with lane_rng(ln.chain), scoped_timer("extend_partition"):
                ext = extend_partition(g, part, ln.cur_k, tk, ln.ctx, new_job_stats())
            ln.cur_k = tk
            ln.part = torch.as_tensor(np.asarray(ext, dtype=np.int32), device=g.device)

    # -- the deep uncoarsening loop ------------------------------------------

    def _uncoarsen(self, cohort: List[_Lane]) -> None:
        C = self.base_ctx.coarsening.contraction_limit
        level = len(cohort[0].levels) - 1
        self._initial_partition(cohort)
        self._refine(cohort, level)
        while True:
            tks = [compute_k_for_n(ln.levels[level].n, C, self.k) if level > 0 else self.k
                   for ln in cohort]
            ext = [(ln, tk) for ln, tk in zip(cohort, tks) if ln.cur_k < tk]
            if ext:
                if len(ext) < len(cohort):
                    self.report.splits += 1
                self._extend([ln for ln, _ in ext], level, [tk for _, tk in ext])
                self._refine([ln for ln, _ in ext], level)
            if level == 0:
                return
            with scoped_timer("uncoarsening"):
                for ln, fine in zip(cohort, lops.lane_project(
                        [ln.coarse_of[level - 1] for ln in cohort],
                        [ln.part for ln in cohort])):
                    ln.part = fine
            level -= 1
            self._refine(cohort, level)

    # -- entry ---------------------------------------------------------------

    def run(self) -> List[np.ndarray]:
        from ..ops import lp_kernels

        check_eligibility(self.base_ctx, self.graphs, self.k)
        before = dict(lp_kernels.LAUNCHES)
        with scoped_timer("serve_lanestack"):
            lanes = [self._prep_lane(i, g) for i, g in enumerate(self.graphs)]
            self.report.caps = [ln.caps for ln in lanes]
            self._shapes.add(("l0", tuple((ln.levels[0].padded().n_pad,
                                           ln.levels[0].padded().m_pad) for ln in lanes)))
            cohorts = self._coarsen(lanes)
            self.report.cohorts = len(cohorts)
            lane_cohorts = [0] * len(lanes)
            for ci, cohort in enumerate(cohorts):
                for ln in cohort:
                    lane_cohorts[ln.slot] = ci
                self._uncoarsen(cohort)
            self.report.lane_cohorts = tuple(lane_cohorts)
            works = self._pull(torch.cat([ln.part for ln in lanes]),
                               phase="lanestack_refinement", lanes=len(lanes))
            results, pos = [], 0
            for ln in lanes:
                n = ln.levels[0].n
                results.append(self._finalize(ln, works[pos : pos + n].astype(np.int32)))
                pos += n
        self.report.layout_key = tuple(sorted(self._shapes, key=repr))
        self.report.launches = {name: lp_kernels.LAUNCHES[name] - before.get(name, 0)
                                for name in lp_kernels.LAUNCHES}
        return results


def run_lanestacked(ctx: Context, graphs: Sequence, k: int, epsilon: float,
                    device="cpu", trace_lane: str = ""):
    """Execute a batch lane-stacked on ``device``; returns (partitions,
    report).  Raises :class:`LaneStackUnsupported` for batches outside the
    envelope.  With ``trace_lane`` and an active trace recorder, the whole
    execution also lands as one closed span on that synthetic lane row."""
    from ..resilience.faults import maybe_inject
    from ..telemetry import trace as ttrace

    # the stacked path's "execute" injection point, before any lane state
    maybe_inject("execute", site="lanestack")
    runner = LaneStackRunner(ctx, graphs, k, epsilon, device)
    rec = ttrace.active() if trace_lane else None
    t0 = time.perf_counter()
    parts = runner.run()
    if rec is not None:
        rec.lane_span(trace_lane, "lanestack_batch", rec.to_us(t0),
                      rec.to_us(time.perf_counter()), lanes=runner.report.lanes,
                      cohorts=runner.report.cohorts, splits=runner.report.splits)
    return parts, runner.report
