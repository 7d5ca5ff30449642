"""LP refiner: the LP engine with blocks as labels (counterpart of the
dense branch of ``kaminpar_tpu/refinement/lp_refiner.py``).

The label space is padded to ``num_labels_bucket(k)``: pad labels carry
weight 0 and cap 0 and are adjacent to nothing, so they are inert.  On the
finest graph of the TeraPart tier, which carries the
``DeviceCompressedView`` it was decoded from, the pass rates off the
compressed stream (same draws, same result as the dense pass).
"""

from __future__ import annotations

import torch

from ..context import LabelPropagationContext
from ..graph.partitioned import PartitionedGraph
from ..ops import lp
from ..telemetry import probes
from ..utils import RandomState
from ..utils.timer import scoped_timer
from .refiner import Refiner


class LPRefiner(Refiner):
    def __init__(self, ctx: LabelPropagationContext):
        self.ctx = ctx

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        graph = p_graph.graph
        pv = graph.padded()
        cview = graph._compressed_view
        layout = cview if cview is not None else graph.bucketed()
        k = p_graph.k
        k_pad = lp.num_labels_bucket(k)
        part = pv.pad_node_array(p_graph.partition, 0)  # pads are inert (w=0)
        state = lp.init_state(part, pv.node_w, k_pad)
        max_w = torch.zeros(k_pad, dtype=torch.int32, device=graph.device)
        max_w[:k] = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32)
        gen = RandomState.generator(graph.device)
        active_prob = self.ctx.active_prob
        allow_tie_moves = self.ctx.allow_tie_moves
        with scoped_timer("lp_refinement", sync=True) as ts:
            state = lp.lp_iterate_bucketed(
                state,
                lambda _: lp.draw_lp_round(gen, layout, pv.n_pad, active_prob=active_prob,
                                           allow_tie_moves=allow_tie_moves),
                layout, pv.node_w, max_w,
                int(self.ctx.min_moved_fraction * pv.n), self.ctx.num_iterations,
                num_labels=k_pad, active_prob=active_prob,
                allow_tie_moves=allow_tie_moves,
            )
            ts.note(state.labels)
            # a marker row of host-known sizes: the pass's moved count and
            # cut stay on the device (the next existing pull of the deep
            # scheme carries the level's cut)
            probes.refinement_pass("lp_refinement", n=pv.n, k=k,
                                   rounds_budget=self.ctx.num_iterations)
        return p_graph.with_partition(state.labels[: pv.n])
