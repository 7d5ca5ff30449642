"""Lane-batched initial bipartitioning pool (counterpart of
``kaminpar_tpu/ops/bipartition.py``).

Every repetition of the pool (BFS, greedy graph growing, random, each
followed by a forced balance pass and round-based 2-way FM) is one row of
an ``(R, n_pad)`` block-0 membership tensor, and every step runs on all
rows at once with fixed shapes:

- *seeded region growing* (BFS/GGG): each trip sums every node's edge
  weight into block 0 (a prefix sum over ``(R, m_pad)``), and admits
  the maximal prefix of the frontier, ordered randomly (BFS) or by
  connection into block 0 (GGG), that fits the remaining weight budget;
- *random*: the maximal random-order prefix of all nodes;
- *forced balance*: each overweight side gives up its least-loss prefix;
- *FM rounds*, alternating sides: the best positive-gain prefix of the
  source side (gain-0 moves by a coin) that fits the receiving side; each
  lane keeps the best state it visits (least overload, then least cut).

The winning lane (feasible first, then least overload, then least cut,
then the lowest lane) is chosen on the device, and a bisection makes one
readback: the winning labels with six stats packed behind them.  No op in
between reads a value back to the host.

All random draws come in through :class:`PoolDraws`, drawn per trip and
per round on demand: :class:`GeneratorPoolDraws` on the graph's device in
production, or a test's implementation that hands out the JAX package's
own draws.  A lane's draws do not depend on how many lanes run beside it.
Graph arrays and draws are int32; connections and the sums that compare
against budgets are int64 (the reference's int32 values: the caller keeps
every weight sum below 2^31).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils import sync_stats

# Packed-stats layout appended to the winning labels (int32):
# [cut, feasible, winner_lane, num_feasible_lanes, w0, w1].
STATS_LEN = 6
I32MAX = 2**31 - 1
# Bytes of the (R, m_pad) temporaries of one connection pass per lane and
# edge (the gathered membership, the masked weights and their int64 prefix
# sums); a pool whose pass does not fit the card's memory runs method by
# method (:func:`lane_chunks`).
_EDGE_TEMP_BYTES = 13


def grow_trip_count(n_pad: int) -> int:
    """Frontier-expansion trips for an n_pad-bucket graph: about the
    eccentricity of the grown half (2 sqrt(n) on meshes), capped at 192;
    the forced balance pass fills a lane the trips left underweight."""
    return int(min(n_pad, 192, max(16, 2 * math.isqrt(int(n_pad)))))


def fm_round_count(n_pad: int, fm_iterations: int) -> int:
    """Refinement rounds: at least the configured FM iteration count per
    side, scaled with sqrt(n) (a round straightens a mesh boundary by one
    staircase step)."""
    return int(min(256, max(2 * max(int(fm_iterations), 1),
                            8 * math.isqrt(int(n_pad)))))


def method_lane_counts(ipc, final_k: int) -> Tuple[Tuple[Tuple[str, int], ...], int]:
    """The (method, lane count) layout of a pool call and the repetitions
    asked for: ``min_num_repetitions`` scaled by ceil(log2(final_k)) - 1,
    clamped to ``max_num_repetitions``, rounded up to a power of two (the
    extra lanes are more repetitions).  Lane order is bfs, ggg, random."""
    from ..utils.intmath import next_pow2

    reps = max(ipc.min_num_repetitions, 1)
    if ipc.use_adaptive_bipartitioner_selection and final_k > 2:
        mult = max(1, int(math.ceil(math.log2(final_k))) - 1)
        reps = min(reps * mult, ipc.max_num_repetitions)
    lanes = next_pow2(reps)
    methods = []
    if ipc.enable_bfs_bipartitioner:
        methods.append(("bfs", lanes))
    if ipc.enable_ggg_bipartitioner:
        methods.append(("ggg", lanes))
    if ipc.enable_random_bipartitioner:
        methods.append(("random", lanes))
    if not methods:
        raise ValueError("no bipartitioner enabled")
    return tuple(methods), reps


def grow_lane_count(methods) -> int:
    """Lanes that grow a region (bfs and ggg); they come first."""
    return sum(cnt for name, cnt in methods if name != "random")


# ---------------------------------------------------------------------------
# Draws.
# ---------------------------------------------------------------------------


class PoolDraws:
    """The random inputs of one pool call, over all lanes in kernel order
    (``method_lane_counts``); G is the number of grow lanes, Rr of random
    lanes, R of all lanes.  Priorities are int32 in ``[0, 2^31 - 1)``.
    Each call with the same arguments returns the same values, so the pool
    may ask again for the lanes of another chunk."""

    def seed(self, n: int) -> torch.Tensor:
        """(G,) int64: each grow lane's seed node, uniform in [0, max(n, 1))."""
        raise NotImplementedError

    def order(self) -> torch.Tensor:
        """(Rr, n_pad) int32: the random lanes' fill priorities."""
        raise NotImplementedError

    def grow(self, t: int) -> torch.Tensor:
        """(G, n_pad) int32: the priorities of grow trip t."""
        raise NotImplementedError

    def rebalance(self, i: int) -> torch.Tensor:
        """(R, n_pad) int32: the priorities of balance pass i (side i)."""
        raise NotImplementedError

    def fm(self, t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(R, n_pad) int32 priorities and (R, n_pad) bool coins of FM
        round t."""
        raise NotImplementedError


_KIND = {"seed": 1, "order": 2, "grow": 3, "rebalance": 4, "fm_prio": 5, "fm_coin": 6}


class GeneratorPoolDraws(PoolDraws):
    """Production draws: a ``torch.Generator`` on ``device``, re-seeded for
    every (kind, index) from the bisection's seed, so that each draw is a
    function of its arguments (no host synchronisation: seeding is a host
    operation)."""

    def __init__(self, seed: int, methods, n_pad: int, device):
        self.seed_, self.n_pad = int(seed), int(n_pad)
        self.device = torch.device(device)
        self.G = grow_lane_count(methods)
        self.R = sum(cnt for _, cnt in methods)
        self._gen = torch.Generator(device=self.device)

    def _gen_for(self, kind: str, index: int) -> torch.Generator:
        mixed = (self.seed_ * 0x9E3779B97F4A7C15 + _KIND[kind] * 0xBF58476D1CE4E5B9
                 + index * 0x94D049BB133111EB) % (1 << 63)
        return self._gen.manual_seed(mixed)

    def _prio(self, rows: int, kind: str, index: int) -> torch.Tensor:
        return torch.randint(0, I32MAX, (rows, self.n_pad), generator=self._gen_for(kind, index),
                             device=self.device, dtype=torch.int32)

    def seed(self, n: int) -> torch.Tensor:
        return torch.randint(0, max(n, 1), (self.G,), generator=self._gen_for("seed", 0),
                             device=self.device, dtype=torch.int64)

    def order(self) -> torch.Tensor:
        return self._prio(self.R - self.G, "order", 0)

    def grow(self, t: int) -> torch.Tensor:
        return self._prio(self.G, "grow", t)

    def rebalance(self, i: int) -> torch.Tensor:
        return self._prio(self.R, "rebalance", i)

    def fm(self, t: int):
        coin = torch.rand((self.R, self.n_pad), generator=self._gen_for("fm_coin", t),
                          device=self.device) < 0.5
        return self._prio(self.R, "fm_prio", t), coin


class RecordedPoolDraws(PoolDraws):
    """Every draw of one pool call taken from ``source`` once and kept, so
    that the same draws can be replayed on another device (:meth:`to`)."""

    def __init__(self, source: PoolDraws, methods, n: int, grow_trips: int,
                 fm_rounds: int):
        G = grow_lane_count(methods)
        R = sum(cnt for _, cnt in methods)
        self.n = n
        self._seed = source.seed(n) if G else None
        self._order = source.order() if G < R else None
        self._grow = [source.grow(t) for t in range(grow_trips)] if G else []
        self._reb = [source.rebalance(i) for i in range(2)]
        self._fm = [source.fm(t) for t in range(fm_rounds)]

    def to(self, device) -> "RecordedPoolDraws":
        out = RecordedPoolDraws.__new__(RecordedPoolDraws)
        out.n = self.n
        mv = lambda x: None if x is None else x.to(device)  # noqa: E731
        out._seed, out._order = mv(self._seed), mv(self._order)
        out._grow = [mv(x) for x in self._grow]
        out._reb = [mv(x) for x in self._reb]
        out._fm = [(mv(p), mv(c)) for p, c in self._fm]
        return out

    def seed(self, n: int) -> torch.Tensor:
        if n != self.n:
            raise ValueError(f"draws recorded for n={self.n}, asked for n={n}")
        return self._seed

    def order(self) -> torch.Tensor:
        return self._order

    def grow(self, t: int) -> torch.Tensor:
        return self._grow[t]

    def rebalance(self, i: int) -> torch.Tensor:
        return self._reb[i]

    def fm(self, t: int):
        return self._fm[t]


# ---------------------------------------------------------------------------
# Batched lane steps: every tensor carries a leading lane axis (R, n_pad).
# ---------------------------------------------------------------------------


class PoolGraph(NamedTuple):
    """The padded graph a pool runs on (weight-0 padding is inert in
    ratings, budgets and cuts), its per-node incident edge weight and each
    node's edge range, shifted by one (``row_ptr[:-1]``, ``row_ptr[1:]``)."""

    col_idx: torch.Tensor  # (m_pad,) int32
    edge_w: torch.Tensor  # (m_pad,) int32
    node_w: torch.Tensor  # (n_pad,) int32
    degw: torch.Tensor  # (n_pad,) int64
    row_lo: torch.Tensor  # (n_pad,) int64
    row_hi: torch.Tensor  # (n_pad,) int64
    total: int  # total node weight

    @property
    def n_pad(self) -> int:
        return int(self.node_w.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.col_idx.shape[0])

    @staticmethod
    def from_padded(pv, total: int) -> "PoolGraph":
        rp = pv.row_ptr.to(torch.int64)
        degw = torch.zeros(pv.n_pad, dtype=torch.int64, device=rp.device)
        degw.index_add_(0, pv.edge_u, pv.edge_w.to(torch.int64))
        return PoolGraph(pv.col_idx, pv.edge_w, pv.node_w, degw, rp[:-1], rp[1:], int(total))


def _connections(in0: torch.Tensor, g: PoolGraph):
    """Per lane and node: edge weight into block 0 and into block 1
    (int64).  Each lane's masked edge weights follow a zero in one
    (R, m_pad + 1) row, so a node's sum is the difference of two prefix
    sums at its row_ptr entries.  The card scans the rows as one flat
    int64 array (one device-wide scan; the carry across lanes cancels in
    the differences), the CPU row by row in int32: the same values."""
    R = in0.shape[0]
    buf = torch.empty((R, g.m_pad + 1), dtype=g.edge_w.dtype, device=in0.device)
    buf[:, 0] = 0
    torch.mul(in0[:, g.col_idx], g.edge_w, out=buf[:, 1:])
    if buf.is_cuda:
        cum = torch.cumsum(buf.view(-1), 0, dtype=torch.int64).view(R, -1)
    else:  # a row's sums stay below 2^31
        cum = torch.cumsum(buf, 1, dtype=torch.int32)
    to0 = cum.gather(1, g.row_hi.expand(R, -1)) - cum.gather(1, g.row_lo.expand(R, -1))
    return to0, g.degw - to0


def _sort_order(prio: torch.Tensor, neg: Optional[torch.Tensor]) -> torch.Tensor:
    """Per lane, the node order of ``lexsort((prio, neg))``: ``neg`` the
    primary key (int32), ``prio`` (non-negative int32) the secondary, the
    node index the last (a stable sort of one int64 key)."""
    key = prio.to(torch.int64)
    if neg is not None:
        key = key + (neg.to(torch.int64) << 32)
    return torch.sort(key, dim=1, stable=True).indices


def _prefix(prio, neg, cand, node_w):
    """Candidates in sort order: (order, candidate mask, weights, running
    weight sums), all (R, n_pad)."""
    order = _sort_order(prio, neg)
    cand_s = cand.gather(1, order)
    w_s = torch.where(cand_s, node_w[order], 0)
    return order, cand_s, w_s, torch.cumsum(w_s, dim=1)


def _admit_prefix(prio, neg, cand, node_w, budget):
    """Admit candidates in sorted order while the admitted weight stays
    within ``budget`` ((R,) int64); candidates heavier than the whole
    budget are dropped first, so they cannot block lighter ones.  Returns
    (admit mask, admitted weight (R,) int64)."""
    cand = cand & (node_w <= budget[:, None])
    order, cand_s, w_s, cum = _prefix(prio, neg, cand, node_w)
    ok_s = cand_s & (cum <= budget[:, None])
    admit = torch.zeros_like(cand).scatter_(1, order, ok_s)
    return admit, torch.where(ok_s, w_s, 0).sum(1)


def _block0_weight(in0, node_w):
    return torch.where(in0, node_w, 0).sum(1)


def _rebalance_side(prio, in0, g: PoolGraph, max_w0: int, max_w1: int, *, side: int):
    """Force-repair one overweight side: move its least-loss (max-gain)
    prefix out, covering the overload, within the receiving side's room.
    No-op on lanes whose side fits."""
    conn0, conn1 = _connections(in0, g)
    w0 = _block0_weight(in0, g.node_w)
    w1 = g.total - w0
    if side == 0:
        over = torch.clamp(w0 - max_w0, min=0)
        room = torch.clamp(max_w1 - w1, min=0)
        cand, gain = in0, conn1 - conn0
    else:
        over = torch.clamp(w1 - max_w1, min=0)
        room = torch.clamp(max_w0 - w0, min=0)
        cand, gain = (~in0) & (g.node_w > 0), conn0 - conn1
    cand = cand & (g.node_w <= room[:, None])
    order, cand_s, w_s, cum = _prefix(prio, -gain, cand, g.node_w)
    # Minimal covering prefix: admit while the weight moved before this
    # node is still short of the overload and the receiver keeps fitting.
    move_s = cand_s & (cum - w_s < over[:, None]) & (cum <= room[:, None])
    move = torch.zeros_like(in0).scatter_(1, order, move_s)
    return in0 & ~move if side == 0 else in0 | move


def _fm_round(prio, coin, in0, conn, g: PoolGraph, max_w0: int, max_w1: int, side0: bool):
    """One boundary FM round from one source side, given the lanes'
    connections ``conn = (conn0, conn1)``: move the best positive-gain
    prefix (gain-0 nodes by their coin) that fits the receiving side."""
    conn0, conn1 = conn
    w0 = _block0_weight(in0, g.node_w)
    w1 = g.total - w0
    if side0:
        gain, src = conn1 - conn0, in0
        room = torch.clamp(max_w1 - w1, min=0)
    else:
        gain, src = conn0 - conn1, (~in0) & (g.node_w > 0)
        room = torch.clamp(max_w0 - w0, min=0)
    movers = src & ((gain > 0) | ((gain == 0) & coin))
    move, _ = _admit_prefix(prio, -gain, movers, g.node_w, room)
    return in0 & ~move if side0 else in0 | move


def _score(in0, conn, g: PoolGraph, max_w0: int, max_w1: int):
    """Per lane (overload, cut with every cut edge counted from both ends):
    lexicographically smaller is better; overload 0 is feasibility."""
    conn0, conn1 = conn
    w0 = _block0_weight(in0, g.node_w)
    w1 = g.total - w0
    over = torch.clamp(w0 - max_w0, min=0) + torch.clamp(w1 - max_w1, min=0)
    cut = torch.where(in0, conn1, conn0).sum(1)
    return over, cut


def _lane_bipartition(draws: PoolDraws, lanes: slice, G: int, n_bfs: int, g: PoolGraph,
                      n: int, target: int, max_w0: int, max_w1: int, *,
                      grow_trips: int, fm_rounds: int):
    """Lanes ``lanes`` of the pool (grow lanes below ``G``, BFS below
    ``n_bfs``): grow or fill, forced balance, FM rounds.  Returns each
    lane's best state, its overload and its (doubled) cut."""
    dev, n_pad = g.node_w.device, g.n_pad
    a, b = lanes.start, lanes.stop
    parts = []
    if a < G:
        ga, gb = a, min(b, G)
        seed = draws.seed(n)[ga:gb]
        seed_w = g.node_w[seed]
        seed_fits = seed_w <= target
        in0 = torch.zeros((gb - ga, n_pad), dtype=torch.bool, device=dev)
        in0.scatter_(1, seed[:, None], seed_fits[:, None])
        w0 = torch.where(seed_fits, seed_w, 0).to(torch.int64)
        # GGG orders the frontier by connection into block 0, BFS by the
        # priorities alone (a zero primary key).
        ggg = (torch.arange(ga, gb, device=dev) >= n_bfs)[:, None]
        for t in range(grow_trips):
            conn0 = _connections(in0, g)[0]
            cand = (~in0) & (conn0 > 0)
            neg = torch.where(ggg, -conn0, 0)
            adm, w_adm = _admit_prefix(draws.grow(t)[ga:gb], neg, cand, g.node_w, target - w0)
            in0 = in0 | adm
            w0 = w0 + w_adm
        parts.append(in0)
    if b > G:
        ra, rb = max(a, G), b
        prio = draws.order()[ra - G:rb - G]
        budget = torch.full((rb - ra,), target, dtype=torch.int64, device=dev)
        cand = (g.node_w > 0).expand(rb - ra, n_pad)
        parts.append(_admit_prefix(prio, None, cand, g.node_w, budget)[0])
    in0 = torch.cat(parts) if len(parts) > 1 else parts[0]

    for side in (0, 1):
        in0 = _rebalance_side(draws.rebalance(side)[a:b], in0, g, max_w0, max_w1, side=side)

    conn = _connections(in0, g)
    best = in0
    b_over, b_cut = _score(in0, conn, g, max_w0, max_w1)
    for t in range(fm_rounds):
        prio, coin = draws.fm(t)
        in0 = _fm_round(prio[a:b], coin[a:b], in0, conn, g, max_w0, max_w1, t % 2 == 0)
        conn = _connections(in0, g)
        over, cut = _score(in0, conn, g, max_w0, max_w1)
        better = (over < b_over) | ((over == b_over) & (cut < b_cut))
        best = torch.where(better[:, None], in0, best)
        b_over = torch.where(better, over, b_over)
        b_cut = torch.where(better, cut, b_cut)
    return best, b_over, b_cut


def edge_temp_budget(device) -> Optional[int]:
    """Bytes the connection passes of one pool call may take on ``device``:
    half of what the card can still hand out (free device memory plus the
    allocator's cached, unused blocks).  None on the CPU, where the pool
    always runs whole."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return (free + cached) // 2


def lane_chunks(methods, m_pad: int, budget: Optional[int]):
    """The lane ranges that run together: the whole pool, or method by
    method when one connection pass over all lanes would need more than
    ``budget`` bytes of temporaries (None: no limit).  Each chunk asks the
    draws for all R lanes and keeps its own rows: (R, n_pad) per step,
    against the pass's (R, m_pad) temporaries."""
    R = sum(cnt for _, cnt in methods)
    if budget is None or R * m_pad * _EDGE_TEMP_BYTES <= budget:
        return [slice(0, R)]
    out, off = [], 0
    for _, cnt in methods:
        out.append(slice(off, off + cnt))
        off += cnt
    return out


def _pool_kernel(draws: PoolDraws, g: PoolGraph, n: int, target: int,
                 max_w0: int, max_w1: int, *, methods, grow_trips: int,
                 fm_rounds: int, chunks=None) -> torch.Tensor:
    """Run every lane, in the lane ranges ``chunks`` (default: all at
    once), and select the winner on the device.  Returns one packed
    (n_pad + STATS_LEN,) int32 tensor: the winning labels followed by
    [cut, feasible, winner_lane, num_feasible, w0, w1]."""
    G = grow_lane_count(methods)
    n_bfs = sum(cnt for name, cnt in methods if name == "bfs")
    if chunks is None:
        chunks = lane_chunks(methods, g.m_pad, None)
    runs = [_lane_bipartition(draws, lanes, G, n_bfs, g, n, target, max_w0, max_w1,
                              grow_trips=grow_trips, fm_rounds=fm_rounds)
            for lanes in chunks]
    in0, over, cut2 = (torch.cat(x) if len(runs) > 1 else x[0] for x in zip(*runs))
    cut = cut2 // 2
    w0 = _block0_weight(in0, g.node_w)
    w1 = g.total - w0
    feasible = over == 0
    # Feasible first, then least overload, then least cut, then the lowest
    # lane: overload 0 is feasibility, and argmin takes the first minimum.
    win = torch.argmin((over << 32) + cut).view(1)
    labels = torch.where(in0.index_select(0, win)[0], 0, 1)
    stats = torch.cat([cut.gather(0, win), feasible.gather(0, win).to(torch.int64), win,
                       feasible.sum().view(1), w0.gather(0, win), w1.gather(0, win)])
    return torch.cat([labels.to(torch.int32), stats.to(torch.int32)])


# ---------------------------------------------------------------------------
# Host orchestration: padding, draws, the single readback, accounting.
# ---------------------------------------------------------------------------

_stats_lock = threading.Lock()
_pool_stats: Dict[str, float] = {
    "calls": 0, "lanes_launched": 0, "lanes_requested": 0, "feasible_lanes": 0,
    "wall_s": 0.0, "host_bisections": 0, "chunked_calls": 0,
}


def reset_pool_stats() -> None:
    with _stats_lock:
        for key in _pool_stats:
            _pool_stats[key] = 0


def count_host_bisection() -> None:
    """Record one bisection that a device-pool backend served from the host
    pool because its weights do not fit the pool's int32 arithmetic."""
    with _stats_lock:
        _pool_stats["host_bisections"] += 1


def pool_stats_snapshot() -> dict:
    """Pool census: calls, lanes launched and asked for, feasible lanes,
    wall seconds (summed over calls, which overlap where extension jobs
    run on several threads), host bisections, calls run method by method
    (``chunked_calls``), and the two ratios."""
    with _stats_lock:
        snap = dict(_pool_stats)
    launched = snap["lanes_launched"]
    snap["lane_occupancy"] = snap["lanes_requested"] / launched if launched else None
    snap["feasible_lane_frac"] = snap["feasible_lanes"] / launched if launched else None
    return snap


def weights_fit_int32(node_w, edge_w, max_w) -> bool:
    """Whether the pool's int32 arithmetic carries these weights: total
    node weight, both budgets and total edge weight below 2^31."""
    total = int(np.asarray(node_w, dtype=np.int64).sum())
    total_ew = int(np.asarray(edge_w, dtype=np.int64).sum())
    return max(total, int(max_w[0]), int(max_w[1]), total_ew) < 2**31


def grow_target(total: int, max_w0: int, max_w1: int) -> int:
    """Weight to grow block 0 toward: the proportional share of the total,
    capped by block 0's budget (the host pool's ``_grow_target``), in host
    integers."""
    share = -((-total * max_w0) // max(max_w0 + max_w1, 1))
    return min(max_w0, share)


def pool_bipartition_device(row_ptr: np.ndarray, col_idx: np.ndarray, node_w: np.ndarray,
                            edge_w: np.ndarray, max_w, seed: int, ipc, final_k: int = 2, *,
                            device="cpu", draws=None) -> Tuple[np.ndarray, dict]:
    """One pool bisection of a host CSR graph on ``device``.

    Builds the padded graph on the device, takes the draws from
    ``draws(seed, methods, n_pad)`` (default: :class:`GeneratorPoolDraws`
    on the device), runs every lane, and reads back the packed winner
    once.  Returns ``(labels[:n] int32, stats dict)``.  Raises
    ``ValueError`` for weights the int32 pool cannot carry."""
    from ..graph.csr import from_numpy_csr

    n = int(len(row_ptr)) - 1
    if not weights_fit_int32(node_w, edge_w, max_w):
        raise ValueError("the device pool requires weight sums below 2^31")
    total = int(np.asarray(node_w, dtype=np.int64).sum())
    mw0, mw1 = int(max_w[0]), int(max_w[1])
    methods, reps = method_lane_counts(ipc, final_k)
    lanes = sum(cnt for _, cnt in methods)
    target = grow_target(total, mw0, mw1)

    t0 = time.perf_counter()
    pv = from_numpy_csr(row_ptr, col_idx, node_w, edge_w, device=device).padded()
    g = PoolGraph.from_padded(pv, total)
    if draws is None:
        pool_draws = GeneratorPoolDraws(seed, methods, pv.n_pad, device)
    else:
        pool_draws = draws(seed, methods, pv.n_pad)
    chunks = lane_chunks(methods, pv.m_pad, edge_temp_budget(device))
    packed = _pool_kernel(
        pool_draws, g, n, target, mw0, mw1, methods=methods,
        grow_trips=grow_trip_count(pv.n_pad),
        fm_rounds=fm_round_count(pv.n_pad, ipc.fm_num_iterations), chunks=chunks,
    )
    host = sync_stats.pull(packed)  # the bisection's one readback
    wall = time.perf_counter() - t0

    labels = host[:n].astype(np.int32)
    cut, feasible, win, n_feasible, w0, w1 = (int(x) for x in host[pv.n_pad:])
    stats = {
        "cut": cut, "feasible": bool(feasible), "winner_lane": win,
        "num_feasible": n_feasible, "block_weights": (w0, w1),
        "lanes": lanes, "lanes_requested": reps * len(methods),
    }
    with _stats_lock:
        _pool_stats["calls"] += 1
        _pool_stats["lanes_launched"] += lanes
        _pool_stats["lanes_requested"] += reps * len(methods)
        _pool_stats["feasible_lanes"] += n_feasible
        _pool_stats["wall_s"] += wall
        _pool_stats["chunked_calls"] += int(len(chunks) > 1)
    return labels, stats
