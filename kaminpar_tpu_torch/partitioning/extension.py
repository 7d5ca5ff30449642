"""Device extension: one restricted nested multilevel over all blocks
(counterpart of ``kaminpar_tpu/partitioning/extension.py``).

Host extension extracts every block's subgraph and splits each on its own.
Device extension splits all blocks at once, in the dense kernels:

1. **restricted coarsening**: the graph is coarsened with the current
   blocks as communities, so no cluster spans two blocks, down to about
   ``device_extension_cpb`` coarse nodes per new block;
2. **extension of the nested coarsest graph** by the host job path
   (``deep._extend_partition_host``: per-block bisections or nested
   pipelines in the thread pool), with the coarse communities as its
   partition;
3. **restricted uncoarsening**: project up, and on every level zero the
   cross-block edge weights, run the group-restricted overload balancer
   and LP refinement over the new blocks.  A masked edge rates 0 and LP
   adopts only labels rated above 0, so no node leaves its parent block;
   the balancer's lightest-block fallback is restricted to the mover's
   group explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..coarsening.cluster_coarsener import ClusterCoarsener
from ..context import Context
from ..graph.csr import CSRGraph
from ..ops import lp
from ..refinement.balancer import _balance_round, draw_balance_round
from ..utils import RandomState, sync_stats
from ..utils.logger import Logger, OutputLevel
from .partition_utils import intermediate_block_weights, split_offsets


def extend_partition_device(graph: CSRGraph, part: np.ndarray, cur_k: int, new_k: int,
                            ctx: Context, jobs: dict) -> np.ndarray:
    """Split every block of ``part`` (cur_k blocks) into its share of
    new_k blocks on ``graph``'s device; returns the (n,) int32 host
    partition.  ``jobs`` accumulates the host jobs of the nested coarsest
    graph's extension (see ``deep.new_job_stats``)."""
    from .deep import _extend_partition_host

    final_bw = np.asarray(ctx.partition.max_block_weights, dtype=np.int64)
    k = len(final_bw)
    off_new = split_offsets(k, new_k)
    lo_of = np.searchsorted(off_new, split_offsets(k, cur_k))
    # the parent (current block) of each new block
    parent_of_new = (np.searchsorted(lo_of, np.arange(new_k), side="right") - 1).astype(
        np.int32)

    ipc = ctx.initial_partitioning
    coarsener = ClusterCoarsener(ctx, graph)
    coarsener.set_communities(torch.from_numpy(np.asarray(part, dtype=np.int32)))
    target_n = max(new_k * ipc.device_extension_cpb, 2 * ctx.coarsening.contraction_limit)
    coarsest = coarsener.coarsen(new_k, ctx.partition.epsilon, target_n)
    coarse_comm = sync_stats.pull(coarsener.current_communities, phase="extend_partition")
    Logger.log(f"  device-ext: n={graph.n} coarsened to {coarsest.n} "
               f"({coarsener.num_levels} nested levels) for k {cur_k}->{new_k}",
               OutputLevel.DEBUG)

    cpart = _extend_partition_host(coarsest, coarse_comm, cur_k, new_k, ctx, jobs)

    inter_bw = intermediate_block_weights(final_bw, new_k)
    group_of = torch.from_numpy(parent_of_new).to(graph.device)
    labels = torch.from_numpy(cpart).to(graph.device)
    while True:
        labels = _restricted_refine(coarsener.current_graph, labels,
                                    coarsener.current_communities, new_k, group_of,
                                    inter_bw, ctx)
        if coarsener.num_levels == 0:
            break
        labels = coarsener.uncoarsen(labels)
    return sync_stats.pull(labels, phase="extend_partition").astype(np.int32)


def _restricted_refine(graph: CSRGraph, labels: torch.Tensor, comm: torch.Tensor,
                       new_k: int, group_of: torch.Tensor, inter_bw: np.ndarray,
                       ctx: Context) -> torch.Tensor:
    """Group-restricted balance rounds, then LP refinement over ``new_k``
    labels, both on the community-masked graph, with the caps relaxed by
    the level's max node weight (coarse nodes are chunky relative to the
    new blocks' budgets).  Returns the (n,) labels."""
    mg = graph.community_masked(comm)
    pv, bv = mg.padded(), mg.bucketed()
    eps = ctx.partition.epsilon
    relaxed = np.ceil(inter_bw / (1.0 + eps)).astype(np.int64) + int(graph.max_node_weight)
    max_bw = torch.as_tensor(np.maximum(inter_bw, relaxed), dtype=torch.int32,
                             device=graph.device)
    padded = pv.pad_node_array(labels, 0)
    gen = RandomState.generator(graph.device)
    for _ in range(ctx.refinement.balancer.max_num_rounds):
        padded, flags = _balance_round(padded, draw_balance_round(gen, bv, pv.n_pad), bv,
                                       pv.node_w, max_bw, k=new_k, group_of=group_of)
        num_moved, still = sync_stats.pull(flags)
        if not still or num_moved == 0:
            break

    lctx = ctx.refinement.lp
    state = lp.lp_iterate_bucketed(
        lp.init_state(padded, pv.node_w, new_k),
        lambda _: lp.draw_lp_round(gen, bv, pv.n_pad, active_prob=lctx.active_prob,
                                   allow_tie_moves=lctx.allow_tie_moves),
        bv, pv.node_w, max_bw, int(lctx.min_moved_fraction * pv.n), lctx.num_iterations,
        num_labels=new_k, active_prob=lctx.active_prob,
        allow_tie_moves=lctx.allow_tie_moves,
    )
    return state.labels[: pv.n]
