"""JET refiner: filtered bulk moves with best-snapshot rollback
(counterpart of ``kaminpar_tpu/refinement/jet.py``).

Per iteration:

1. **Find**: every unlocked node rates its best external block by gain
   (the rating kernel with ``external_only`` and no caps, over ``k``
   labels) and stays a candidate if ``gain > -floor(temp * conn(u,
   own block))``, the threshold computed in float32: the temperature
   admits negative moves.
2. **Filter**: a candidate u re-evaluates its gain assuming every
   candidate neighbour v of higher priority (``gain_v > gain_u``, or equal
   gains and ``v < u``) executes its move, and stays a candidate only if
   that pessimistic gain is positive (one masked sum over the bucketed
   layout, :func:`bucketed_gains.bucketed_neighbor_reduce`).
3. **Execute** the moves (balance may break), rebalance with the overload
   balancer and keep the best feasible partition.  The nodes that just
   moved sit out the next find step.

The rating ties of a round come in from outside, as the pair
:func:`bucketed_gains.draw_ties` returns.  An iteration reads back the cut
and the feasibility of its partition, once.
"""

from __future__ import annotations

import threading
from typing import Tuple

import torch

from ..context import BalancerContext, JetContext
from ..graph import metrics
from ..graph.bucketed import BucketedView
from ..graph.partitioned import PartitionedGraph
from ..ops.bucketed_gains import bucketed_best_moves, bucketed_neighbor_reduce, draw_ties
from ..ops.segment import segment_sum
from ..utils import RandomState
from ..utils.timer import scoped_timer
from .balancer import OverloadBalancer
from .refiner import Refiner


# Refine calls and move rounds since the last reset_jet_stats();
# ``min_rounds`` is the fewest rounds one call ran (None before a call).
_stats_lock = threading.Lock()
JET_STATS = {"calls": 0, "rounds": 0, "min_rounds": None}


def reset_jet_stats() -> None:
    with _stats_lock:
        JET_STATS.update(calls=0, rounds=0, min_rounds=None)


def jet_stats_snapshot() -> dict:
    with _stats_lock:
        return dict(JET_STATS)


def _jet_move_round(labels, locked, ties, bv: BucketedView, node_w, max_bw, temp, *,
                    k: int):
    """One find + filter round over the padded graph; returns (new_labels,
    moved), each (n_pad,).  ``ties`` is the round's (per-bucket ties,
    heavy ties) pair; ``temp`` is a float32 scalar tensor (or a number,
    taken as float32)."""
    n_pad = labels.shape[0]
    block_weights = segment_sum(node_w, labels, k)

    # -- find ---------------------------------------------------------------
    target, tconn, oconn, has = bucketed_best_moves(
        labels, bv, node_w, block_weights, max_bw, *ties,
        external_only=True, respect_caps=False,
    )
    gain = tconn - oconn
    temp = torch.as_tensor(temp, dtype=torch.float32, device=labels.device)
    threshold = -torch.floor(temp * oconn.to(torch.float32)).to(gain.dtype)
    cand = has & ~locked & (gain > threshold)

    # -- filter (pessimistic gain over the neighbours) ----------------------
    zero = torch.zeros((), dtype=torch.int32, device=labels.device)

    def contrib_fn(urow, cols, w):
        gu, gv = gain[urow], gain[cols]
        v_before = cand[cols] & ((gv > gu) | ((gv == gu) & (cols < urow)))
        eff_v = torch.where(v_before, target[cols], labels[cols])
        return (torch.where(eff_v == target[urow], w, zero)
                - torch.where(eff_v == labels[urow], w, zero))

    gain2 = bucketed_neighbor_reduce(contrib_fn, bv, n_pad)
    move = cand & (gain2 > 0)
    return torch.where(move, target, labels), move


class JetRefiner(Refiner):
    def __init__(self, ctx: JetContext, balancer_ctx: BalancerContext, *,
                 coarse_level: bool = False):
        self.ctx = ctx
        self.balancer = OverloadBalancer(balancer_ctx)
        self.coarse_level = coarse_level

    def temperatures(self) -> Tuple[float, float]:
        """(initial, final) gain temperature of this refiner's level."""
        ctx = self.ctx
        if self.coarse_level:
            return ctx.initial_gain_temp_on_coarse_level, ctx.final_gain_temp_on_coarse_level
        return ctx.initial_gain_temp_on_fine_level, ctx.final_gain_temp_on_fine_level

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        # "4xjet" chains num_rounds invocations.
        for _ in range(max(self.ctx.num_rounds, 1)):
            p_graph = self._refine_once(p_graph)
        return p_graph

    def _refine_once(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        graph = p_graph.graph
        pv, bv = graph.padded(), graph.bucketed()
        k = p_graph.k
        ctx = self.ctx
        max_bw = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32,
                                 device=graph.device)
        t0, t1 = self.temperatures()
        gen = RandomState.generator(graph.device)

        p_graph = self.balancer.refine(p_graph)
        best = p_graph
        best_cut = p_graph.edge_cut()
        labels = pv.pad_node_array(p_graph.partition, 0)
        locked = torch.zeros(pv.n_pad, dtype=torch.bool, device=graph.device)
        fruitless = 0
        rounds = 0
        with scoped_timer("jet_refinement"):
            for it in range(ctx.num_iterations):
                # Linear temperature anneal from initial to final.
                frac = it / max(ctx.num_iterations - 1, 1)
                temp = torch.full((), t0 + (t1 - t0) * frac, dtype=torch.float32,
                                  device=graph.device)
                labels, moved = _jet_move_round(labels, locked, draw_ties(gen, bv), bv,
                                                pv.node_w, max_bw, temp, k=k)
                rounds += 1
                locked = moved
                cur = self.balancer.refine(p_graph.with_partition(labels[: pv.n]))
                labels = pv.pad_node_array(cur.partition, 0)
                cut, overloaded = metrics.cut_and_overloaded(graph, cur.partition, k,
                                                             p_graph.max_block_weights)
                if cut <= best_cut and not overloaded:
                    if best_cut - cut > (1.0 - ctx.fruitless_threshold) * best_cut:
                        fruitless = 0
                    else:
                        fruitless += 1
                    best, best_cut = cur, cut
                else:
                    fruitless += 1
                if fruitless >= ctx.num_fruitless_iterations:
                    break
        with _stats_lock:
            JET_STATS["calls"] += 1
            JET_STATS["rounds"] += rounds
            low = JET_STATS["min_rounds"]
            JET_STATS["min_rounds"] = rounds if low is None else min(low, rounds)
        return best
