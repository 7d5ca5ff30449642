"""LP clusterer: the LP engine instantiated for coarsening (counterpart of
the dense path of ``kaminpar_tpu/coarsening/lp_clusterer.py``).

Labels are node ids over the graph's PaddedView (pad nodes start in the
anchor's cluster and never move); up to ``num_iterations`` sweeps with an
early exit, then isolated-node and two-hop clustering.  The graph is a
CSRGraph, or at the finest level of the TeraPart tier a
``DeviceCompressedView`` (same ``n_pad``, same draws, same labels), whose
rounds rate off the compressed stream.

With ``overlay_levels`` > 1, that many independent clusterings are
intersected (overlay clustering): two nodes share a cluster only if every
clustering puts them together.  Intersection only splits clusters, so the
weight cap holds.
"""

from __future__ import annotations

import torch

from ..context import LabelPropagationContext
from ..graph.device_compressed import DeviceCompressedView
from ..ops import lp
from ..ops.segment import run_ids, run_starts2, segment_min
from ..resilience.faults import maybe_inject
from ..utils import RandomState
from ..utils.timer import scoped_timer


def _intersect_clusterings(la: torch.Tensor, lb: torch.Tensor) -> torch.Tensor:
    """u and v share a cluster iff they share one in both ``la`` and
    ``lb``; each (la, lb) run is relabelled to its smallest member, so
    labels stay node ids.  One stable sort of the key la << 32 | lb, the
    order of the lexsort of (lb, la)."""
    n = int(la.shape[0])
    order = torch.sort((la.long() << 32) | lb.long(), stable=True).indices
    rid = run_ids(run_starts2(la[order], lb[order]))
    rep = segment_min(order.to(la.dtype), rid, n)
    out = torch.zeros_like(la)
    out[order] = rep[rid.long()]
    return out


class LPClustering:
    def __init__(self, ctx: LabelPropagationContext, overlay_levels: int = 1, *,
                 weighted_graph: bool = False):
        self.ctx = ctx
        self.overlay_levels = max(int(overlay_levels), 1)
        # Decided once from the coarsener's input graph, so the mode cannot
        # flip as contraction accumulates edge weights.
        self.weighted_graph = weighted_graph
        self.last_num_moved = None

    @staticmethod
    def sweep_plan(ctx: LabelPropagationContext, graph, weighted_graph: bool):
        """(sweeps, active_prob) of one clustering of ``graph``."""
        iters = ctx.num_iterations
        active_prob = ctx.active_prob
        if weighted_graph:
            # Weighted graphs: a small active fraction and more sweeps
            # emulate asynchronous growth across light-edge valleys.
            active_prob = min(active_prob, ctx.weighted_active_prob)
            iters *= max(ctx.weighted_sweep_factor, 1)
        elif graph.n > 0 and graph.m / graph.n < ctx.low_degree_boost_threshold:
            # sparse graphs propagate one hop per sweep: sweep longer
            iters *= max(ctx.low_degree_boost_factor, 1)
        return iters, active_prob

    def compute_clustering(self, graph, max_cluster_weight: int) -> torch.Tensor:
        """Padded (n_pad,) cluster labels; pad nodes carry the anchor label
        (after an overlay, the pads' smallest member's)."""
        with scoped_timer("lp_clustering", sync=True) as ts:
            labels = self._one_clustering(graph, max_cluster_weight)
            for _ in range(self.overlay_levels - 1):
                labels = _intersect_clusterings(
                    labels, self._one_clustering(graph, max_cluster_weight))
            ts.note(labels)
        return labels

    def _one_clustering(self, graph, max_cluster_weight: int) -> torch.Tensor:
        if isinstance(graph, DeviceCompressedView):
            layout, node_w, row_ptr = graph, graph.node_w_pad, graph.row_ptr_like()
            n, n_pad, anchor = graph.n, graph.n_pad, graph.anchor
        else:
            pv = graph.padded()
            layout, node_w, row_ptr = graph.bucketed(), pv.node_w, pv.row_ptr
            n, n_pad, anchor = pv.n, pv.n_pad, pv.anchor
        dev = node_w.device
        labels = torch.cat([
            torch.arange(n, dtype=torch.int32, device=dev),
            torch.full((n_pad - n,), anchor, dtype=torch.int32, device=dev),
        ])
        state = lp.init_state(labels, node_w, n_pad)
        # a scalar cap: the clustering weight limit is uniform
        max_w = torch.full((), int(max_cluster_weight), dtype=torch.int32, device=dev)

        iters, active_prob = self.sweep_plan(self.ctx, graph, self.weighted_graph)
        gen = RandomState.generator(dev)
        # The "execute" fault-injection point of the LP kernels' dispatch,
        # under the JAX package's site string.  An injected fault stops the
        # run: the port has no plain-version fallback to demote to.
        maybe_inject("execute", site="lp_pallas")
        state = lp.lp_iterate_bucketed(
            state,
            lambda _: lp.draw_lp_round(gen, layout, n_pad, active_prob=active_prob),
            layout, node_w, max_w,
            int(self.ctx.min_moved_fraction * n), iters,
            num_labels=n_pad, active_prob=active_prob,
            tie_break=self.ctx.tie_breaking.value,
        )
        if self.ctx.cluster_isolated_nodes:
            state = lp.cluster_isolated_nodes(state, row_ptr, node_w, max_w,
                                              num_labels=n_pad)
        if self.ctx.cluster_two_hop_nodes:
            state = lp.cluster_two_hop_nodes_bucketed(
                state, lp.draw_two_hop(gen, layout, n_pad), layout, node_w, max_w,
                num_labels=n_pad)
        # the last round's moved count, a device scalar the coarsener packs
        # into the contraction's readback for its quality row
        self.last_num_moved = state.num_moved
        return state.labels
