"""LP clusterer: the LP engine instantiated for coarsening (counterpart of
the dense path of ``kaminpar_tpu/coarsening/lp_clusterer.py``).

Labels are node ids over the graph's PaddedView (pad nodes start in the
anchor's cluster and never move); up to ``num_iterations`` sweeps with an
early exit, then isolated-node and two-hop clustering.
"""

from __future__ import annotations

import torch

from ..context import LabelPropagationContext
from ..graph.csr import CSRGraph
from ..ops import lp
from ..utils import RandomState


class LPClustering:
    def __init__(self, ctx: LabelPropagationContext, *, weighted_graph: bool = False):
        self.ctx = ctx
        # Decided once from the coarsener's input graph, so the mode cannot
        # flip as contraction accumulates edge weights.
        self.weighted_graph = weighted_graph

    def compute_clustering(self, graph: CSRGraph, max_cluster_weight: int) -> torch.Tensor:
        """Padded (n_pad,) cluster labels; pad nodes carry the anchor label."""
        pv = graph.padded()
        bv = graph.bucketed()
        n_pad = pv.n_pad
        dev = graph.device
        labels = torch.cat([
            torch.arange(pv.n, dtype=torch.int32, device=dev),
            torch.full((n_pad - pv.n,), pv.anchor, dtype=torch.int32, device=dev),
        ])
        state = lp.init_state(labels, pv.node_w, n_pad)
        # a scalar cap: the clustering weight limit is uniform
        max_w = torch.tensor(int(max_cluster_weight), dtype=torch.int32, device=dev)

        iters = self.ctx.num_iterations
        active_prob = self.ctx.active_prob
        if self.weighted_graph:
            # Weighted graphs: a small active fraction and more sweeps
            # emulate asynchronous growth across light-edge valleys.
            active_prob = min(active_prob, self.ctx.weighted_active_prob)
            iters *= max(self.ctx.weighted_sweep_factor, 1)
        elif graph.n > 0 and graph.m / graph.n < self.ctx.low_degree_boost_threshold:
            # sparse graphs propagate one hop per sweep: sweep longer
            iters *= max(self.ctx.low_degree_boost_factor, 1)
        gen = RandomState.generator(dev)
        state = lp.lp_iterate_bucketed(
            state,
            lambda _: lp.draw_lp_round(gen, bv, n_pad, active_prob=active_prob),
            bv, pv.node_w, max_w,
            int(self.ctx.min_moved_fraction * pv.n), iters,
            num_labels=n_pad, active_prob=active_prob,
            tie_break=self.ctx.tie_breaking.value,
        )
        if self.ctx.cluster_isolated_nodes:
            state = lp.cluster_isolated_nodes(
                state, pv.row_ptr, pv.node_w, max_w, num_labels=n_pad
            )
        if self.ctx.cluster_two_hop_nodes:
            state = lp.cluster_two_hop_nodes_bucketed(
                state, lp.draw_two_hop(gen, bv, n_pad), bv, pv.node_w, max_w,
                num_labels=n_pad,
            )
        return state.labels
