"""V-cycle deep multilevel partitioning (counterpart of
``kaminpar_tpu/partitioning/vcycle.py``): partition for the increasing k
of ``ctx.vcycles`` and then the final k; each cycle's partition becomes
the communities of the next (coarsening never merges across them, and the
coarsest graph starts from them).  A cycle's block budgets are the sums of
the final budgets its blocks split into (``intermediate_block_weights``,
by the recursive-bisection split offsets), so every step must refine the
one before under that split: powers of two and divisors of k do.
Minimum block weights apply at the final k only.
"""

from __future__ import annotations

import copy

import numpy as np

from ..context import Context
from ..graph.csr import CSRGraph
from ..graph.partitioned import PartitionedGraph
from ..telemetry import probes
from ..utils.logger import Logger, OutputLevel
from .deep import DeepMultilevelPartitioner
from .partition_utils import intermediate_block_weights, split_offsets


class VcycleDeepMultilevelPartitioner:
    def __init__(self, ctx: Context, graph: CSRGraph):
        self.ctx = ctx
        self.graph = graph
        # Of the last partition() call: per cycle its k and its deep
        # pipeline's stats; and, as the deep scheme records them, the
        # phase seconds and extension steps summed over the cycles and
        # the last cycle's coarsest graph and levels.
        self.cycles = []
        self.phase_seconds = {}
        self.extension_jobs = {}
        self.coarsest = {}
        self.num_levels = 0

    def partition(self) -> PartitionedGraph:
        ctx = self.ctx
        k = ctx.partition.k
        steps = [int(s) for s in ctx.vcycles] + [k]
        if len(steps) == 1:
            Logger.log("vcycle: ctx.vcycles is empty, running a single deep cycle",
                       OutputLevel.APPLICATION)
        for prev_k, cur_k in zip(steps, steps[1:]):
            off_prev = split_offsets(k, prev_k)
            if not np.array_equal(np.intersect1d(off_prev, split_offsets(k, cur_k)), off_prev):
                raise ValueError(
                    f"v-cycle step {prev_k} -> {cur_k} does not refine under recursive "
                    "bisection; use powers of two or divisors of k")
        final_bw = np.asarray(ctx.partition.max_block_weights, dtype=np.int64)
        self.cycles, self.phase_seconds, self.extension_jobs = [], {}, {}
        communities, communities_k, p_graph = None, 0, None
        for step_k in steps:
            cycle_ctx = copy.deepcopy(ctx)
            cycle_ctx.partition.k = step_k
            cycle_ctx.partition.max_block_weights = intermediate_block_weights(final_bw, step_k)
            cycle_ctx.partition.min_block_weights = (
                ctx.partition.min_block_weights if step_k == k else None)
            Logger.log(f"  vcycle: partitioning for k={step_k}"
                       + (f" (communities k={communities_k})" if communities is not None
                          else ""), OutputLevel.DEBUG)
            partitioner = DeepMultilevelPartitioner(cycle_ctx, self.graph,
                                                    communities=communities,
                                                    communities_k=communities_k)
            p_graph = partitioner.partition()
            communities, communities_k = p_graph.partition, step_k
            # The cycle's row.  The port hands the communities on without a
            # readback (the JAX package pulls them and packs the cut in),
            # so the row carries the host-known sizes only.
            probes.uncoarsening_level(level=len(self.cycles), n=self.graph.n,
                                      m=self.graph.m, k=step_k, kind="vcycle_quality")
            self.cycles.append(dict(k=step_k, levels=partitioner.num_levels,
                                    coarsest=partitioner.coarsest,
                                    phase_s=partitioner.phase_seconds))
            for stats, part in ((self.phase_seconds, partitioner.phase_seconds),
                                (self.extension_jobs, partitioner.extension_jobs)):
                for key, val in part.items():
                    stats[key] = stats.get(key, 0) + val
            self.coarsest, self.num_levels = partitioner.coarsest, partitioner.num_levels
        return PartitionedGraph.create(self.graph, k, p_graph.partition,
                                       ctx.partition.max_block_weights,
                                       ctx.partition.min_block_weights)
