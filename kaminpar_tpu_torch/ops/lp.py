"""The label-propagation engine (counterpart of ``kaminpar_tpu/ops/lp.py``).

Synchronous rounds: every node rates its neighbours' labels against the
labels at the start of the round (``bucketed_gains``), then the moves are
committed in bulk through a strict capacity auction (:func:`_commit_moves`,
the plain version of the commit kernel ``csrc/lp_commit.cu``).  One engine
serves clustering (labels = node ids, ``num_labels = n_pad``, a scalar
weight cap) and refinement (labels = blocks, ``num_labels =
num_labels_bucket(k)``, a per-block cap table).

All random draws of a round come in through :class:`LPDraws`, drawn by
:func:`draw_lp_round` from the run's generator on the data's device, or
built by a test from the JAX package's own draws.  Integers are int32.

Every round runs over a degree-bucketed layout: the dense ``BucketedView``
or, at the finest level of the TeraPart tier, the ``DeviceCompressedView``,
whose rows are decoded inside the rating kernel (:func:`best_moves` picks
the rating by the layout's type).  Both layouts of one graph have the same
bucket shapes, so they take the same draws and give the same results.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..graph.device_compressed import DeviceCompressedView
from ..utils import sync_stats
from .bucketed_gains import (
    I32MAX, _heavy_moves, assemble_moves, bucketed_best_moves, draw_ties, lookup,
)
from .segment import run_starts, segment_max, segment_min, segment_sum


class LPState(NamedTuple):
    labels: torch.Tensor  # (n,) label per node
    label_weights: torch.Tensor  # (num_labels,) node weight per label
    num_moved: torch.Tensor  # () int32, nodes moved in the last round


class LPDraws(NamedTuple):
    """The random inputs of one LP round."""

    ties: Tuple[torch.Tensor, ...]  # per bucket (R, w) int32 in [0, 2^31-1)
    heavy_tie: Optional[torch.Tensor]  # (S,) int32, None without heavy rows
    prio: torch.Tensor  # (n_pad,) int32 auction priorities in [0, 2^30-1)
    coin: Optional[torch.Tensor] = None  # (n_pad,) bool tie-move coins
    act: Optional[torch.Tensor] = None  # (n_pad,) bool active subset


_RADIX_BITS = 5
_RADIX = 1 << _RADIX_BITS
_PRIO_BITS = 30  # 6 radix-32 levels resolve the threshold exactly
_RADIX_HIST_BYTE_LIMIT = 1 << 29


def num_labels_bucket(k: int, floor: int = 64) -> int:
    """Label-space size for refinement (num_labels = k padded): pad labels
    carry weight 0 and cap 0 and are adjacent to nothing, so they are inert."""
    from ..utils.intmath import next_pow2

    return max(floor, next_pow2(k))


def init_state(labels: torch.Tensor, node_w: torch.Tensor, num_labels: int) -> LPState:
    return LPState(labels, segment_sum(node_w, labels, num_labels),
                   torch.zeros((), dtype=torch.int32, device=labels.device))


def use_radix_auction(num_labels: int) -> bool:
    """Whether the (num_labels, 32) int32 radix histogram fits the budget
    (else the 30-level bitwise auction runs)."""
    return num_labels * _RADIX * 4 <= _RADIX_HIST_BYTE_LIMIT


def draw_lp_round(gen: torch.Generator, bv, n_pad: int, *,
                  active_prob: float = 1.0, allow_tie_moves: bool = False) -> LPDraws:
    """The draws of one LP round over either layout (``draw_ties``)."""
    dev = bv.gather_idx.device
    ties, heavy_tie = draw_ties(gen, bv)
    prio = torch.randint(0, (1 << _PRIO_BITS) - 1, (n_pad,), generator=gen,
                         device=dev, dtype=torch.int32)
    coin = act = None
    if allow_tie_moves:
        coin = torch.rand(n_pad, generator=gen, device=dev) < 0.5
    if active_prob < 1.0:
        act = torch.rand(n_pad, generator=gen, device=dev) < active_prob
    return LPDraws(ties, heavy_tie, prio, coin, act)


def draw_two_hop(gen: torch.Generator, bv, n_pad: int) -> LPDraws:
    """Draws of the two-hop pass: rating ties and the pairing priorities
    (uniform in [0, 2^31 - 1))."""
    ties, heavy_tie = draw_ties(gen, bv)
    prio = torch.randint(0, I32MAX, (n_pad,), generator=gen,
                         device=bv.gather_idx.device, dtype=torch.int32)
    return LPDraws(ties, heavy_tie, prio)


# ---------------------------------------------------------------------------
# Capacity auction: admit movers into their target in priority order while
# base_weight + admitted <= max_weight.  A per-label priority threshold is
# resolved radix-32 (6 levels of a (num_labels, 32) histogram) or bit by
# bit (30 levels); both give the same maximal admitted set.
# ---------------------------------------------------------------------------


def _auction_slack(movers, target, node_w, base_weights, max_weights, num_labels: int):
    zero = torch.zeros((), dtype=torch.int32, device=movers.device)
    t_idx = torch.where(movers, target, zero)
    w_mover = torch.where(movers, node_w, zero)
    max_w_l = (max_weights.expand(num_labels) if max_weights.ndim == 0
               else max_weights)
    return t_idx, w_mover, max_w_l - base_weights


def _auction_radix(prio, movers, target, node_w, base_weights, max_weights,
                   num_labels: int):
    t_idx, w_mover, slack = _auction_slack(
        movers, target, node_w, base_weights, max_weights, num_labels
    )
    zero = torch.zeros((), dtype=torch.int32, device=movers.device)
    thr = torch.zeros(num_labels, dtype=torch.int32, device=movers.device)
    admitted = torch.zeros_like(thr)
    for shift in range(_PRIO_BITS - _RADIX_BITS, -1, -_RADIX_BITS):
        thr_t = thr[t_idx]
        # movers still inside the undecided window [thr, thr + 32 << shift)
        in_window = movers & (
            (prio >> (shift + _RADIX_BITS)) == (thr_t >> (shift + _RADIX_BITS))
        ) & (prio >= thr_t)
        digit = (prio >> shift) & (_RADIX - 1)
        seg = torch.where(in_window, t_idx * _RADIX + digit,
                          torch.full_like(t_idx, num_labels * _RADIX))
        hist = segment_sum(torch.where(in_window, w_mover, zero), seg,
                           num_labels * _RADIX + 1)[:-1].reshape(num_labels, _RADIX)
        cum = torch.cumsum(hist, dim=1, dtype=torch.int32)
        room = (slack - admitted)[:, None]
        j = ((cum <= room) & (room >= 0)).sum(dim=1, dtype=torch.int32)
        prev = torch.clamp(j - 1, min=0).to(torch.int64)[:, None]
        admitted = admitted + torch.where(j > 0, cum.gather(1, prev)[:, 0], zero)
        thr = thr + (j << shift)
    return movers & (prio < thr[t_idx])


def _auction_bitwise(prio, movers, target, node_w, base_weights, max_weights,
                     num_labels: int):
    t_idx, w_mover, slack = _auction_slack(
        movers, target, node_w, base_weights, max_weights, num_labels
    )
    zero = torch.zeros((), dtype=torch.int32, device=movers.device)
    thr = torch.zeros(num_labels, dtype=torch.int32, device=movers.device)
    for i in range(_PRIO_BITS):
        cand = thr + (1 << (_PRIO_BITS - 1 - i))
        adm = movers & (prio < cand[t_idx])
        demand = segment_sum(torch.where(adm, w_mover, zero), t_idx, num_labels)
        thr = torch.where(demand <= slack, cand, thr)
    return movers & (prio < thr[t_idx])


def _commit_moves(state: LPState, target, tconn, own_conn, node_w,
                  max_label_weights, num_labels: int, prio, coin=None, act=None,
                  *, active_prob: float = 1.0, allow_tie_moves: bool = False,
                  active=None, radix: Optional[bool] = None) -> LPState:
    """Plain version of the commit kernel.  Moves only on a strict rating
    improvement (or a tie with ``coin`` when ``allow_tie_moves``), only
    nodes in ``active`` (a colour class) and, for ``active_prob`` < 1, in
    ``act``; then the capacity auction, the new labels and label weights.
    ``radix`` None picks the auction by :func:`use_radix_auction`."""
    labels, label_weights, _ = state
    better = tconn > own_conn
    if allow_tie_moves:
        better = better | ((tconn == own_conn) & coin)
    desired = torch.where(better, target, labels)
    moved = desired != labels
    if active is not None:
        moved = moved & active
    if active_prob < 1.0:
        moved = moved & act
    if radix is None:
        radix = use_radix_auction(num_labels)
    auction = _auction_radix if radix else _auction_bitwise
    accept = auction(prio, moved, desired, node_w, label_weights,
                     max_label_weights, num_labels)
    commit = moved & accept
    new_labels = torch.where(commit, desired, labels)
    return LPState(new_labels, segment_sum(node_w, new_labels, num_labels),
                   commit.sum(dtype=torch.int32))


def compressed_best_moves(labels, cv: DeviceCompressedView, node_w, label_weights,
                          max_label_weights, ties, heavy_tie, *,
                          external_only: bool = True, respect_caps: bool = True,
                          tie_break: str = "uniform"):
    """``bucketed_best_moves`` over the compressed layout: each bucket goes
    through the decode-fused rating kernel's wrapper (the CUDA kernel on a
    CUDA tensor, decode + the plain rating on a CPU tensor); heavy rows
    take the same flat path."""
    from .lp_kernels import rate_compressed_bucket

    outs = [
        rate_compressed_bucket(labels, node_w, label_weights, max_label_weights,
                               cv.stream, cb, tie, external_only=external_only,
                               respect_caps=respect_caps, tie_break=tie_break)
        for cb, tie in zip(cv.buckets, ties)
    ]
    if cv.heavy.nodes.shape[0] > 0:
        outs.append(_heavy_moves(
            labels, cv.heavy, node_w, label_weights, max_label_weights, heavy_tie,
            external_only=external_only, respect_caps=respect_caps, tie_break=tie_break,
        ))
    return assemble_moves(outs, cv.gather_idx, labels, cv.n, int(labels.shape[0]))


def best_moves(labels, layout, node_w, label_weights, max_label_weights, ties,
               heavy_tie, **flags):
    """The best move per node over either layout: the dense ``BucketedView``
    (``bucketed_best_moves``) or the ``DeviceCompressedView``
    (:func:`compressed_best_moves`)."""
    fn = (compressed_best_moves if isinstance(layout, DeviceCompressedView)
          else bucketed_best_moves)
    return fn(labels, layout, node_w, label_weights, max_label_weights, ties, heavy_tie,
              **flags)


def lp_round_bucketed(state: LPState, draws: LPDraws, layout, node_w,
                      max_label_weights, *, num_labels: int,
                      active_prob: float = 1.0, allow_tie_moves: bool = False,
                      tie_break: str = "uniform") -> LPState:
    """One synchronous LP round over a bucketed layout, dense or compressed:
    the rating kernel per bucket, the flat heavy path, then the commit
    kernel.  Both layouts of one graph give the same result."""
    from .lp_kernels import commit_moves

    target, tconn, own_conn, _ = best_moves(
        state.labels, layout, node_w, state.label_weights, max_label_weights,
        draws.ties, draws.heavy_tie, external_only=False, respect_caps=True,
        tie_break=tie_break,
    )
    return commit_moves(
        state, target, tconn, own_conn, node_w, max_label_weights, num_labels,
        draws.prio, draws.coin, draws.act, active_prob=active_prob,
        allow_tie_moves=allow_tie_moves,
    )


def lp_iterate_bucketed(state: LPState, draw: Callable[[int], LPDraws], layout,
                        node_w, max_label_weights, min_moved: int,
                        max_iterations: int, **round_kwargs) -> LPState:
    """Up to ``max_iterations`` rounds of :func:`lp_round_bucketed`; stops
    once a round moves at most ``min_moved`` nodes.  ``draw(i)`` gives round
    i's draws.  The moved count is read back once per round."""
    state = state._replace(num_moved=torch.full(
        (), I32MAX, dtype=torch.int32, device=state.labels.device))
    moved = I32MAX
    i = 0
    while i < max_iterations and moved > min_moved:
        state = lp_round_bucketed(state, draw(i), layout, node_w, max_label_weights,
                                  **round_kwargs)
        moved = int(sync_stats.pull(state.num_moved))
        i += 1
    return state


def lp_round_colored(state: LPState, draws: LPDraws, bv, node_w, max_label_weights,
                     active, *, num_labels: int, allow_tie_moves: bool = True) -> LPState:
    """One colored superstep (CLP): only ``active`` (one colour class, an
    independent set) may move.  The rating kernel rates every node with
    caps, and the commit kernel takes ``active`` as its mask."""
    from .lp_kernels import commit_moves

    target, tconn, own_conn, _ = bucketed_best_moves(
        state.labels, bv, node_w, state.label_weights, max_label_weights,
        draws.ties, draws.heavy_tie, external_only=False, respect_caps=True,
    )
    return commit_moves(
        state, target, tconn, own_conn, node_w, max_label_weights, num_labels,
        draws.prio, draws.coin, allow_tie_moves=allow_tie_moves, active=active,
    )


def clp_iterate_colors(state: LPState, draw: Callable[[int], LPDraws], bv, node_w,
                       max_label_weights, colors, num_colors: int, *, num_labels: int,
                       allow_tie_moves: bool = True) -> LPState:
    """One CLP iteration: the superstep of every colour class ``c`` in
    order, with ``draw(c)``'s draws.  The moved counts are summed on the
    device; the returned state carries the iteration's total."""
    moved = torch.zeros((), dtype=torch.int32, device=state.labels.device)
    for c in range(num_colors):
        state = lp_round_colored(state, draw(c), bv, node_w, max_label_weights,
                                 colors == c, num_labels=num_labels,
                                 allow_tie_moves=allow_tie_moves)
        moved = moved + state.num_moved
    return state._replace(num_moved=moved)


def cluster_isolated_nodes(state: LPState, row_ptr, node_w, max_label_weights, *,
                           num_labels: int) -> LPState:
    """Pack isolated (degree-0) nodes by prefix weight into clusters of
    width ``cap - w_max + 1``, so no cluster exceeds the cap."""
    labels, _, num_moved = state
    n = labels.shape[0]
    zero = torch.zeros((), dtype=torch.int32, device=labels.device)
    deg = row_ptr[1:] - row_ptr[:-1]
    iso = (deg == 0) & (node_w > 0)  # weight-0 degree-0 nodes are padding
    w = torch.where(iso, node_w, zero)
    cap = torch.clamp(lookup(max_label_weights, zero.long()), min=1)
    width = torch.clamp(cap - w.max() + 1, min=1)
    start = torch.cumsum(w, 0, dtype=torch.int32) - w
    bucket = torch.where(iso, torch.clamp(start // width, 0, n - 1),
                         torch.full_like(start, n))
    ids = torch.arange(n, dtype=torch.int32, device=labels.device)
    rep = segment_min(torch.where(iso, ids, torch.full_like(ids, n)), bucket, n + 1)
    new_labels = torch.where(iso, rep[bucket], labels)
    return LPState(new_labels, segment_sum(node_w, new_labels, num_labels), num_moved)


def cluster_two_hop_nodes_bucketed(state: LPState, draws: LPDraws, layout, node_w,
                                   max_label_weights, *, num_labels: int) -> LPState:
    """Match singleton clusters that favour the same cluster (two-hop
    clustering); the favoured cluster is rated by the rating kernel of the
    layout (dense or compressed) with caps ignored."""
    favored, fconn, _, _ = best_moves(
        state.labels, layout, node_w, state.label_weights, max_label_weights,
        draws.ties, draws.heavy_tie, external_only=False, respect_caps=False,
    )
    return two_hop_match(state, draws.prio, favored, fconn, node_w,
                         max_label_weights, num_labels=num_labels)


# The JAX package's names for the compressed layout's functions.
lp_round_compressed = lp_round_bucketed
lp_iterate_compressed = lp_iterate_bucketed
cluster_two_hop_nodes_compressed = cluster_two_hop_nodes_bucketed


def two_hop_match(state: LPState, prio, favored, fconn, node_w,
                  max_label_weights, *, num_labels: int) -> LPState:
    """Sort singletons by (favoured cluster, priority) and merge each odd
    run position into the preceding node's cluster, within the scalar
    weight limit."""
    labels, _, num_moved = state
    n = labels.shape[0]
    dev = labels.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    sizes = segment_sum(torch.ones(n, dtype=torch.int32, device=dev), labels, num_labels)
    singleton = (labels == ids) & (sizes[labels] == 1)
    has = fconn > 0
    fkey = torch.where(singleton & has, favored, torch.full_like(favored, n))
    order2 = torch.sort((fkey.to(torch.int64) << 31) | prio.to(torch.int64),
                        stable=True).indices
    f_s = fkey[order2]
    first2 = run_starts(f_s)
    rid2 = torch.cumsum(first2.to(torch.int32), 0, dtype=torch.int32) - 1
    starts = segment_max(torch.where(first2, ids, torch.zeros_like(ids)), rid2, n)
    pos_in_run = ids - starts[rid2]
    prev_node = torch.cat([order2[:1], order2[:-1]])
    partner_label = labels[prev_node]
    valid = (f_s < n) & (pos_in_run % 2 == 1)
    w_s = node_w[order2]
    w_prev = torch.cat([w_s[:1], w_s[:-1]])
    cap = lookup(max_label_weights, torch.zeros((), dtype=torch.int64, device=dev))
    merge = valid & (w_s + w_prev <= cap)
    new_labels = labels.clone()
    new_labels[order2] = torch.where(merge, partner_label, labels[order2])
    return LPState(new_labels, segment_sum(node_w, new_labels, num_labels), num_moved)
