"""Colored LP refiner (counterpart of ``kaminpar_tpu/refinement/clp_refiner.py``).

The graph is coloured once per ``refine`` (``ops/coloring.py``); then an
iteration runs one LP superstep per colour class, in which only that
class's nodes may move.  A colour class is an independent set, so every
gain is exact and zero-gain moves cannot oscillate.  The supersteps are
the LP round's two kernels: the rating kernel with caps and the commit
kernel with the class as its ``active`` mask.  The label space is padded
to ``num_labels_bucket(k)``.  The colour count is read back once, the
moved count once per iteration; the better of input and output by cut is
kept.
"""

from __future__ import annotations

import torch

from ..context import ColoredLPContext
from ..graph import metrics
from ..graph.partitioned import PartitionedGraph
from ..ops import lp
from ..ops.bucketed_gains import I32MAX
from ..ops.coloring import color_graph, num_colors_device
from ..telemetry import probes, trace as ttrace
from ..utils import RandomState, sync_stats
from ..utils.timer import scoped_timer
from .refiner import Refiner


class CLPRefiner(Refiner):
    def __init__(self, ctx: ColoredLPContext):
        self.ctx = ctx

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        graph = p_graph.graph
        pv, bv = graph.padded(), graph.bucketed()
        dev = graph.device
        k = p_graph.k
        k_pad = lp.num_labels_bucket(k)
        max_w = torch.zeros(k_pad, dtype=torch.int32, device=dev)
        max_w[:k] = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32)
        part = pv.pad_node_array(p_graph.partition, 0)
        gen = RandomState.generator(dev)

        with scoped_timer("clp_refinement", sync=True) as ts:
            mask = torch.arange(pv.n_pad, device=dev) < pv.n
            raw, _ = color_graph(
                lambda i: torch.randint(0, I32MAX, (pv.n_pad,), generator=gen, device=dev,
                                        dtype=torch.int32),
                pv.edge_u, pv.col_idx, mask, n=pv.n_pad)
            colors = torch.clamp(raw, min=0)
            nc = int(sync_stats.pull(num_colors_device(colors, mask)))
            state = lp.init_state(part, pv.node_w, k_pad)
            before = p_graph.edge_cut()
            allow_tie_moves = self.ctx.allow_tie_moves
            rec = ttrace.active()
            for it in range(self.ctx.num_iterations):
                state = lp.clp_iterate_colors(
                    state,
                    lambda c: lp.draw_lp_round(gen, bv, pv.n_pad,
                                               allow_tie_moves=allow_tie_moves),
                    bv, pv.node_w, max_w, colors, nc, num_labels=k_pad,
                    allow_tie_moves=allow_tie_moves,
                )
                if rec is not None:
                    # the iteration's cut rides its one readback, packed
                    # with the moved count (exact in int32: the cut is at
                    # most the total edge weight)
                    cut = metrics.edge_cut_device(graph, state.labels[: pv.n])
                    moved, cut = (int(x) for x in sync_stats.pull(
                        torch.stack([state.num_moved, cut.to(state.num_moved.dtype)])))
                    probes.refinement_round("clp_refinement", round_idx=it, moved=moved, cut=cut)
                else:
                    moved = int(sync_stats.pull(state.num_moved))
                if moved == 0:
                    break
            ts.note(state.labels)
        # Tie diffusion can wander: keep the better of input and output.
        out = p_graph.with_partition(state.labels[: pv.n])
        if out.edge_cut() > before:
            return p_graph
        return out
