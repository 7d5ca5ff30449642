"""Overload and underload balancers: move weight by relative gain
(counterpart of ``kaminpar_tpu/refinement/balancer.py``).

Overload rounds (:func:`_balance_round`):

1. every node of an overloaded block rates its best feasible external
   block (the rating kernel with ``external_only`` and caps); without one
   it falls back to the lightest block (of its group, in the restricted
   mode of device extension),
2. per *source* block, movers are admitted in decreasing relative-gain
   order until the overload is covered (a per-block gain threshold found
   by bisection),
3. per *target* block, admitted movers pass the same bisection as a strict
   capacity check, so no receiver becomes overloaded.

Underload rounds (:func:`_underload_round`) pull weight into blocks below
their minimum: donors never drop below their own minimum, receivers fill
their deficit and stay within their cap.  The underload balancer is a
no-op without minimum block weights.

The random inputs of a round of either kind (the rating ties and the gain
jitter) come in through :class:`BalanceDraws`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..context import BalancerContext
from ..graph.bucketed import BucketedView
from ..graph.partitioned import PartitionedGraph
from ..ops.bucketed_gains import bucketed_best_moves, draw_ties
from ..ops.segment import first_argmin, segment_max, segment_min, segment_sum
from ..telemetry import probes
from ..utils import RandomState, sync_stats
from ..utils.timer import scoped_timer
from .refiner import Refiner

_NEG = -3.4e38
_POS = 3.4e38


class BalanceDraws(NamedTuple):
    ties: Tuple[torch.Tensor, ...]  # per bucket (R, w) int32 in [0, 2^31-1)
    heavy_tie: Optional[torch.Tensor]  # (S,) int32, None without heavy rows
    jitter: torch.Tensor  # (n_pad,) float32 in [0, 1e-3)


def draw_balance_round(gen: torch.Generator, bv: BucketedView, n_pad: int) -> BalanceDraws:
    ties, heavy_tie = draw_ties(gen, bv)
    jitter = torch.rand(n_pad, generator=gen, device=bv.gather_idx.device) * 1e-3
    return BalanceDraws(ties, heavy_tie, jitter)


def _admit_by_budget(mask, block_of, rel, node_w, budget, k: int, *, inclusive: bool):
    """Per-block greedy admission by decreasing relative gain: bisect a
    per-block threshold (24 rounds) to the lowest value whose admitted
    weight fits the block's budget.  ``inclusive``: admitted weight never
    exceeds the budget.  Otherwise the single best still-pending candidate
    of every uncovered block is admitted as well, so each round covers
    some overload."""
    n = mask.shape[0]
    dev = mask.device
    zero = torch.zeros((), dtype=node_w.dtype, device=dev)
    b_idx = torch.where(mask, block_of, torch.zeros_like(block_of))
    w = torch.where(mask, node_w, zero)
    lo = segment_min(torch.where(mask, rel, torch.full_like(rel, _POS)), b_idx, k)
    hi = segment_max(torch.where(mask, rel, torch.full_like(rel, _NEG)), b_idx, k)
    hi = hi + torch.clamp(hi.abs(), min=1.0) * 1e-3
    for _ in range(24):
        mid = 0.5 * (lo + hi)
        adm = mask & (rel >= mid[b_idx])
        fits = segment_sum(torch.where(adm, w, zero), b_idx, k) <= budget
        lo, hi = torch.where(fits, lo, mid), torch.where(fits, mid, hi)
    adm_lo = mask & (rel >= lo[b_idx])
    d_lo = segment_sum(torch.where(adm_lo, w, zero), b_idx, k)
    thr = torch.where(d_lo <= budget, lo, hi)
    admitted = mask & (rel >= thr[b_idx])
    if not inclusive:
        adm_w = segment_sum(torch.where(admitted, w, zero), b_idx, k)
        pend = mask & ~admitted & (adm_w < budget)[b_idx]
        best = segment_max(torch.where(pend, rel, torch.full_like(rel, _NEG)), b_idx, k)
        cand = pend & (rel == best[b_idx])
        idx = torch.arange(n, dtype=torch.int32, device=dev)
        first_idx = segment_min(torch.where(cand, idx, torch.full_like(idx, n)), b_idx, k)
        admitted = admitted | (cand & (idx == first_idx[b_idx]))
    return admitted


def _relative_gain(tconn, oconn, node_w, jitter):
    rel = (tconn - oconn).to(torch.float32) / torch.clamp(node_w, min=1).to(torch.float32)
    # jitter scaled to the gain so it stays above one float32 ulp
    return rel + jitter * torch.clamp(rel.abs(), min=1.0)


def _balance_round(labels, draws: BalanceDraws, bv: BucketedView, node_w, max_bw, *,
                   k: int, group_of=None):
    """One round; returns ``(new_labels, flags)`` with ``flags`` =
    (moved count, still overloaded) as one (2,) int32 tensor.

    ``group_of`` ((k,) int32 block -> group, optional) is the restricted
    mode of device extension: the lightest-block fallback stays inside the
    mover's group.  Rated targets are already in-group when the caller has
    masked the cross-group edge weights."""
    block_weights = segment_sum(node_w, labels, k)
    target, tconn, oconn, has = bucketed_best_moves(
        labels, bv, node_w, block_weights, max_bw, draws.ties, draws.heavy_tie,
        external_only=True, respect_caps=True,
    )
    new_labels, commit = _balance_commit(labels, target, tconn, oconn, has, block_weights,
                                         node_w, max_bw, draws.jitter, k=k,
                                         group_of=group_of)
    still = (segment_sum(node_w, new_labels, k) > max_bw).any()
    flags = torch.stack([commit.sum(dtype=torch.int32), still.to(torch.int32)])
    return new_labels, flags


def _balance_commit(labels, target, tconn, oconn, has, block_weights, node_w, max_bw,
                    jitter, *, k: int, group_of=None, movable=None):
    """The round after the rating: the lightest-block fallback, admission
    at the sources and the targets; returns ``(new_labels, commit)``.
    ``movable`` (optional (n,) bool) freezes the nodes outside it: the
    lane-stacked round (``ops/lanestack.py``) freezes the lanes whose
    round loop has ended."""
    zero = torch.zeros((), dtype=torch.int32, device=labels.device)
    overloaded = block_weights > max_bw
    mover = overloaded[labels] & (node_w > 0)  # weight-0 nodes are padding
    if movable is not None:
        mover = mover & movable

    # Movers without a feasible adjacent target fall back to the lightest
    # block (of their group).
    if group_of is None:
        light = first_argmin(block_weights).to(torch.int32)
    else:
        gw_min = segment_min(block_weights, group_of, k)
        blk = torch.arange(k, dtype=torch.int32, device=labels.device)
        light_of_group = segment_min(
            torch.where(block_weights == gw_min[group_of], blk, torch.full_like(blk, k)),
            group_of, k)
        light = torch.clamp(light_of_group[group_of[labels]], 0, k - 1)
    # a one-element index: a 0-d one is read back to the host
    at = light.reshape(-1) if light.dim() == 0 else light
    fallback_ok = block_weights[at] + node_w <= max_bw[at]
    use_fb = mover & ~has & fallback_ok & (labels != light)
    target = torch.where(use_fb, light, target)
    tconn = torch.where(use_fb, zero, tconn)
    eligible = mover & (has | use_fb)
    rel = _relative_gain(tconn, oconn, node_w, jitter)

    overload = torch.clamp(block_weights - max_bw, min=0)
    src_ok = _admit_by_budget(eligible, labels, rel, node_w, overload, k, inclusive=False)
    admitted = eligible & src_ok
    tgt_ok = _admit_by_budget(admitted, target, rel, node_w,
                              torch.clamp(max_bw - block_weights, min=0), k,
                              inclusive=True)
    commit = admitted & tgt_ok
    return torch.where(commit, target, labels), commit


def _underload_round(labels, draws: BalanceDraws, bv: BucketedView, node_w, max_bw,
                     min_bw, *, k: int):
    """One pull round: underloaded blocks admit the best relative-gain donor
    nodes until their minimum is covered.  Returns ``(new_labels, flags)``
    with ``flags`` = (moved count, still underloaded), (2,) int32."""
    n = labels.shape[0]
    dev = labels.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    block_weights = segment_sum(node_w, labels, k)
    underloaded = block_weights < min_bw
    # Only underloaded blocks can receive: every other block's cap
    # collapses to its current weight.
    eff_max = torch.where(underloaded, max_bw, block_weights)
    target, tconn, oconn, has = bucketed_best_moves(
        labels, bv, node_w, block_weights, eff_max, draws.ties, draws.heavy_tie,
        external_only=True, respect_caps=True,
    )
    surplus = torch.clamp(block_weights - min_bw, min=0)
    mover = (~underloaded)[labels] & (node_w > 0)

    # Movers without an adjacent underloaded target spread over all deficit
    # blocks (deficit-descending, round-robin by node index), so that every
    # underloaded block can fill in one round, adjacent nodes or not.
    deficit = torch.clamp(min_bw - block_weights, min=0)
    by_deficit = torch.argsort(-deficit, stable=True).to(torch.int32)
    num_needy = torch.clamp((deficit > 0).sum(dtype=torch.int32), min=1)
    slot = torch.arange(n, dtype=torch.int32, device=dev) % num_needy
    fb = by_deficit[slot]
    fallback_ok = (deficit[fb] > 0) & (block_weights[fb] + node_w <= max_bw[fb])
    use_fb = mover & ~has & fallback_ok & (labels != fb)
    target = torch.where(use_fb, fb, target)
    tconn = torch.where(use_fb, zero, tconn)
    eligible = mover & (has | use_fb)
    rel = _relative_gain(tconn, oconn, node_w, draws.jitter)

    # donors never drop below their minimum; receivers fill their deficit
    # and stay within their cap
    src_ok = _admit_by_budget(eligible, labels, rel, node_w, surplus, k, inclusive=True)
    admitted = eligible & src_ok
    fill_ok = _admit_by_budget(admitted, target, rel, node_w, deficit, k, inclusive=False)
    cap_ok = _admit_by_budget(admitted, target, rel, node_w,
                              torch.clamp(max_bw - block_weights, min=0), k,
                              inclusive=True)
    commit = admitted & fill_ok & cap_ok
    new_labels = torch.where(commit, target, labels)
    still = (segment_sum(node_w, new_labels, k) < min_bw).any()
    flags = torch.stack([commit.sum(dtype=torch.int32), still.to(torch.int32)])
    return new_labels, flags


class OverloadBalancer(Refiner):
    def __init__(self, ctx: BalancerContext):
        self.ctx = ctx

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        graph = p_graph.graph
        pv = graph.padded()
        bv = graph.bucketed()
        max_bw = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32,
                                 device=graph.device)
        labels = pv.pad_node_array(p_graph.partition, 0)
        gen = RandomState.generator(graph.device)
        with scoped_timer("overload_balancer"):
            for rnd in range(self.ctx.max_num_rounds):
                labels, flags = _balance_round(
                    labels, draw_balance_round(gen, bv, pv.n_pad), bv, pv.node_w,
                    max_bw, k=p_graph.k,
                )
                num_moved, still = sync_stats.pull(flags)
                # the round's quality row, from its existing pull
                probes.refinement_round("overload_balancer", round_idx=rnd,
                                        moved=int(num_moved))
                if not still or num_moved == 0:
                    break
        return p_graph.with_partition(labels[: pv.n])


class UnderloadBalancer(Refiner):
    """Minimum-block-weight balancer: underload rounds until every block
    reaches its minimum, no node moves or the round budget runs out.  A
    no-op without minimum block weights."""

    def __init__(self, ctx: BalancerContext):
        self.ctx = ctx

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        if p_graph.min_block_weights is None or p_graph.is_min_feasible():
            return p_graph
        graph = p_graph.graph
        pv = graph.padded()
        bv = graph.bucketed()
        max_bw = torch.as_tensor(p_graph.max_block_weights, dtype=torch.int32,
                                 device=graph.device)
        min_bw = torch.as_tensor(p_graph.min_block_weights, dtype=torch.int32,
                                 device=graph.device)
        labels = pv.pad_node_array(p_graph.partition, 0)
        gen = RandomState.generator(graph.device)
        with scoped_timer("underload_balancer"):
            for rnd in range(self.ctx.max_num_rounds):
                labels, flags = _underload_round(
                    labels, draw_balance_round(gen, bv, pv.n_pad), bv, pv.node_w,
                    max_bw, min_bw, k=p_graph.k,
                )
                num_moved, still = sync_stats.pull(flags)
                # the round's quality row, from its existing pull
                probes.refinement_round("underload_balancer", round_idx=rnd,
                                        moved=int(num_moved))
                if not still or num_moved == 0:
                    break
        return p_graph.with_partition(labels[: pv.n])
