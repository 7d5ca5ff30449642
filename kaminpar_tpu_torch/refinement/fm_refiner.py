"""k-way FM refiner, the eco/strong quality tier (counterpart of
``kaminpar_tpu/refinement/fm_refiner.py``).

As in the JAX package, FM is a sequential host pass in numpy: a global
k-way FM with localized searches (border seeds consumed in random order,
each region grown through its own priority queue), lazy revalidation on
pop and rollback to each region's best prefix.  JET is the device
refiner; FM squeezes the last few percent, gated by ``max_n`` (a bound on
the sequential pass's wall time).

The block connections live in a dense (n, k) table up to
``dense_nk_threshold`` entries, else in a border-row table built on first
touch (:class:`_SparseConn`) whose size is bounded by ``max_entries``;
when it would outgrow that, the pass ends after rolling its region back
(:class:`_ConnBudgetExceeded`).  Connections are int32 when the total
edge weight is below 2^31, else int64.

The graph and the partition come off the device in one transfer per
array before the first pass; the result goes back in one copy.  The host
generator is ``RandomState.numpy_rng()``.
"""

from __future__ import annotations

import heapq
import threading
import time

import numpy as np

from ..context import FMContext
from ..graph.partitioned import PartitionedGraph
from ..utils import RandomState, sync_stats
from ..utils.timer import scoped_timer
from ..utils.logger import Logger, OutputLevel
from .refiner import Refiner

# Refine calls that ran, their passes and host seconds since the last
# reset_fm_stats(); ``skipped`` counts graphs above max_n.
_stats_lock = threading.Lock()
FM_STATS = {"calls": 0, "passes": 0, "seconds": 0.0, "skipped": 0}


def reset_fm_stats() -> None:
    with _stats_lock:
        FM_STATS.update(calls=0, passes=0, seconds=0.0, skipped=0)


def fm_stats_snapshot() -> dict:
    with _stats_lock:
        return dict(FM_STATS)


class _DenseConn:
    """Dense (n, k) connection matrix (dense_gain_cache.h analog)."""

    def __init__(self, n: int, k: int, dtype):
        self.k = k
        self.buf = np.zeros((n, k), dtype=dtype)
        self.dtype = dtype

    def reset(self, row_ptr, col_idx, edge_w, u_arr, part):
        self.buf.fill(0)
        np.add.at(self.buf, (u_arr, part[col_idx]), edge_w)

    def get_rows(self, nodes, part):
        return self.buf[nodes]

    def get_row(self, u, part):
        return self.buf[u]

    def add(self, nbrs, block, ws):
        np.add.at(self.buf, (nbrs, block), ws)


class _ConnBudgetExceeded(Exception):
    """Raised when the sparse table would outgrow its entry budget; the
    pass ends early (keeping its best prefix) instead of the host OOMing."""


class _SparseConn:
    """Lazily-materialized border-row connection table.

    The reference avoids the O(n*k) dense cache at scale with sparse /
    compact-hashing gain caches (sparse_gain_cache.h:538); the NumPy
    rendition: ``slot_of[u]`` maps a touched node to a row in a growable
    (cap, k) table.  A row is built on first touch from the *live*
    partition (O(deg + k)) and updated incrementally afterwards, which
    keeps it consistent with the dense variant's "initial + all deltas"
    value.  Untouched nodes cost nothing; ``max_entries`` bounds the table
    (a near-all-border level would otherwise rebuild the dense blow-up the
    sparse path exists to avoid), ending the pass via
    :class:`_ConnBudgetExceeded` when the active set outgrows it."""

    def __init__(self, n: int, k: int, dtype, row_ptr, col_idx, edge_w,
                 max_entries: int = 1 << 28):
        self.k = k
        self.dtype = dtype
        self.slot_of = np.full(n, -1, dtype=np.int64)
        cap = 1024
        self.rows = np.zeros((cap, k), dtype=dtype)
        self.used = 0
        self.max_rows = max(max_entries // max(k, 1), 1024)
        self.row_ptr = row_ptr
        self.col_idx = col_idx
        self.edge_w = edge_w

    def reset(self, row_ptr, col_idx, edge_w, u_arr, part):
        self.slot_of.fill(-1)
        self.used = 0

    def _ensure(self, nodes, part):
        new = nodes[self.slot_of[nodes] < 0]
        if len(new) == 0:
            return
        new = np.unique(new)
        need = self.used + len(new)
        if need > self.max_rows:
            raise _ConnBudgetExceeded
        if need > self.rows.shape[0]:
            cap = min(max(need, 2 * self.rows.shape[0]), self.max_rows)
            grown = np.zeros((cap, self.k), dtype=self.rows.dtype)
            grown[: self.used] = self.rows[: self.used]
            self.rows = grown
        degs = (self.row_ptr[new + 1] - self.row_ptr[new]).astype(np.int64)
        total = int(degs.sum())
        starts = self.row_ptr[new]
        base = np.repeat(starts - np.concatenate([[0], np.cumsum(degs)[:-1]]), degs)
        idx = base + np.arange(total, dtype=np.int64)
        rloc = np.repeat(np.arange(len(new), dtype=np.int64), degs)
        tmp = np.zeros((len(new), self.k), dtype=self.dtype)
        np.add.at(tmp, (rloc, part[self.col_idx[idx]]), self.edge_w[idx])
        self.rows[self.used : self.used + len(new)] = tmp
        self.slot_of[new] = np.arange(self.used, self.used + len(new))
        self.used += len(new)

    def get_rows(self, nodes, part):
        self._ensure(nodes, part)
        return self.rows[self.slot_of[nodes]]

    def get_row(self, u, part):
        s = self.slot_of[u]
        if s < 0:
            self._ensure(np.asarray([u]), part)
            s = self.slot_of[u]
        return self.rows[s]

    def add(self, nbrs, block, ws):
        slots = self.slot_of[nbrs]
        m = slots >= 0
        if m.any():
            np.add.at(self.rows, (slots[m], block), ws[m])


def _kway_fm_pass(row_ptr, col_idx, edge_w, node_w, u_arr, part, bw, max_bw, k, rng, ctx, conn):
    """One FM pass; mutates part/bw in place, returns the cut delta (<= 0)."""
    n = len(row_ptr) - 1
    _NEG = np.iinfo(conn.dtype).min // 2

    conn.reset(row_ptr, col_idx, edge_w, u_arr, part)

    def best_moves_rows(nodes):
        """Vectorized best feasible move per node: (to, gain) arrays.

        Targets must be adjacent (connection > 0, matching the reference's
        iteration over rating-map entries), not the own block, and fit the
        target block's weight budget."""
        rows = conn.get_rows(nodes, part)  # (b, k)
        own = part[nodes]
        internal = rows[np.arange(len(nodes)), own]
        w = node_w[nodes]
        valid = (rows > 0) & (bw[None, :] + w[:, None] <= max_bw[None, :])
        valid[np.arange(len(nodes)), own] = False
        gains = np.where(valid, rows - internal[:, None], _NEG)
        to = np.argmax(gains, axis=1)
        g = gains[np.arange(len(nodes)), to]
        has = g > _NEG
        return np.where(has, to, -1), np.where(has, g, 0).astype(np.int64)

    def best_move(u):
        """Scalar fast path of best_moves_rows (per-pop revalidation)."""
        row = conn.get_row(u, part)
        own = part[u]
        w_u = node_w[u]
        valid = (row > 0) & (bw + w_u <= max_bw)
        valid[own] = False
        if not valid.any():
            return -1, 0
        gains = np.where(valid, row - row[own], _NEG)
        to = int(np.argmax(gains))
        # Real gains stay strictly above _NEG: the int32 path is gated on
        # directed edge_w.sum() < 2^31, so internal < 2^30 = -_NEG.  Guard
        # anyway so a masked block can never be selected if that invariant
        # ever weakens (mirrors best_moves_rows' `g > _NEG` filter).
        if int(gains[to]) <= _NEG:
            return -1, 0
        return to, int(gains[to])

    # Border nodes seed the PQ (fm_refiner.cc: shared border-node queue).
    border_mask = np.zeros(n, dtype=bool)
    np.logical_or.at(border_mask, u_arr, part[u_arr] != part[col_idx])
    border = np.flatnonzero(border_mask)

    # Localized searches (the reference's core FM design, fm_refiner.cc:
    # 48-110): border seeds are consumed in random order; each search grows
    # a *region* through a region-local PQ (only nodes adjacent to the
    # region enter), so negative-gain excursions stay spatially coherent —
    # the move that pays for an earlier negative one is in the same
    # neighborhood, not wherever the global best gain happens to be.
    # Each region rolls back to its own best prefix
    # (fm_refiner.cc commits the best prefix per localized search);
    # rolled-back nodes are unlocked for other searches
    # (unlock_locally_moved_nodes = true, presets.cc:353).
    locked = np.zeros(n, dtype=bool)
    total_delta = 0
    budget_hit = False
    work = 0
    work_budget = (
        int(ctx.pass_work_budget_factor * n)
        if ctx.pass_work_budget_factor > 0
        else None
    )

    order = rng.permutation(border) if len(border) else border
    ptr = 0
    while ptr < len(order) and not budget_hit:
        if work_budget is not None and work > work_budget:
            break
        seeds = []
        while ptr < len(order) and len(seeds) < ctx.num_seed_nodes:
            u = int(order[ptr])
            ptr += 1
            if not locked[u]:
                seeds.append(u)
        if not seeds:
            continue

        moves: list = []  # (u, from) — this region only
        cur_delta = 0
        best_delta = 0
        best_prefix = 0
        fruitless = 0
        try:
            seeds_arr = np.asarray(seeds)
            tos, gains = best_moves_rows(seeds_arr)
            ok = tos >= 0
            heap = [
                (-int(g), int(p), int(u), int(t))
                for u, t, g, p in zip(
                    seeds_arr[ok], tos[ok], gains[ok],
                    rng.integers(1 << 30, size=int(ok.sum())),
                )
            ]
            heapq.heapify(heap)

            while heap:
                if fruitless >= max(
                    ctx.num_fruitless_moves, int(ctx.alpha * np.sqrt(len(moves) + 1))
                ):
                    break
                neg_gain, _, u, to = heapq.heappop(heap)
                if locked[u]:
                    continue
                # Lazy revalidation (reference: compute_best_gain on pop).
                cur_to, cur_gain = best_move(u)
                if cur_to < 0:
                    continue
                if cur_to != to or -neg_gain != cur_gain:
                    heapq.heappush(
                        heap, (-cur_gain, int(rng.integers(1 << 30)), u, cur_to)
                    )
                    continue

                src = part[u]
                w_u = int(node_w[u])
                part[u] = cur_to
                bw[src] -= w_u
                bw[cur_to] += w_u
                locked[u] = True
                moves.append((u, src))
                work += int(row_ptr[u + 1] - row_ptr[u])
                cur_delta -= cur_gain
                if cur_delta < best_delta:
                    best_delta = cur_delta
                    best_prefix = len(moves)
                    fruitless = 0
                else:
                    fruitless += 1

                # u moved src -> cur_to: each neighbor's connection row
                # shifts by the connecting edge weight; then push the
                # unlocked neighbors into the *region* PQ.
                s, e = row_ptr[u], row_ptr[u + 1]
                nbrs = col_idx[s:e]
                ws = edge_w[s:e]
                conn.add(nbrs, src, -ws)
                conn.add(nbrs, cur_to, ws)
                live = nbrs[~locked[nbrs]]
                if len(live):
                    live = np.unique(live)
                    tos, gains = best_moves_rows(live)
                    ok = tos >= 0
                    for v, t, g in zip(live[ok], tos[ok], gains[ok]):
                        heapq.heappush(
                            heap,
                            (-int(g), int(rng.integers(1 << 30)), int(v), int(t)),
                        )
        except _ConnBudgetExceeded:
            # Sparse table outgrew its entry budget: end the pass after
            # rolling this region back to its best prefix like any other
            # (the dense blow-up this bounds is what the old max_nk gate
            # prevented).
            budget_hit = True

        # Region rollback to its best prefix; undone nodes unlock.
        for u, src in moves[best_prefix:][::-1]:
            w_u = int(node_w[u])
            to = part[u]
            bw[to] -= w_u
            bw[src] += w_u
            part[u] = src
            locked[u] = False
            s, e = row_ptr[u], row_ptr[u + 1]
            conn.add(col_idx[s:e], to, -edge_w[s:e])
            conn.add(col_idx[s:e], src, edge_w[s:e])
        total_delta += best_delta

    return total_delta


class FMRefiner(Refiner):
    def __init__(self, ctx: FMContext):
        self.ctx = ctx

    def refine(self, p_graph: PartitionedGraph) -> PartitionedGraph:
        g = p_graph.graph
        if g.n > self.ctx.max_n:
            Logger.log(f"  fm: skipped (n={g.n} exceeds max_n={self.ctx.max_n})",
                       OutputLevel.DEBUG)
            with _stats_lock:
                FM_STATS["skipped"] += 1
            return p_graph
        t0 = time.perf_counter()
        with scoped_timer("fm_refinement"):
            return self._refine(p_graph, g, t0)

    def _refine(self, p_graph: PartitionedGraph, g, t0: float) -> PartitionedGraph:
        # One transfer per array off the device.
        row_ptr = g.host_row_ptr().astype(np.int64)
        col_idx, ew64, node_w, part = sync_stats.pull(g.col_idx, g.edge_w, g.node_w,
                                                      p_graph.partition)
        col_idx = col_idx.astype(np.int32, copy=False)
        ew64 = ew64.astype(np.int64)
        small_w = int(ew64.sum()) < 2**31
        edge_w = ew64.astype(np.int32) if small_w else ew64
        node_w = node_w.astype(np.int64)
        u_arr = np.repeat(np.arange(g.n, dtype=np.int32), np.diff(row_ptr))
        part = part.astype(np.int32).copy()
        max_bw = np.asarray(p_graph.max_block_weights, dtype=np.int64)
        k = p_graph.k
        bw = np.bincount(part, weights=node_w, minlength=k).astype(np.int64)
        rng = RandomState.numpy_rng()

        # Connection entries are bounded by a node's incident edge weight,
        # itself at most the total edge weight.
        conn_dtype = np.int32 if small_w else np.int64
        if g.n * k <= self.ctx.dense_nk_threshold:
            conn = _DenseConn(g.n, k, conn_dtype)
        else:
            conn = _SparseConn(g.n, k, conn_dtype, row_ptr, col_idx, edge_w)

        total = 0
        passes = 0
        cut = int(p_graph.edge_cut())
        for _ in range(self.ctx.num_iterations):
            delta = _kway_fm_pass(
                row_ptr, col_idx, edge_w, node_w, u_arr, part, bw, max_bw,
                k, rng, self.ctx, conn
            )
            passes += 1
            total += delta
            if delta == 0:
                break
            # Stop when a pass improves the current cut by less than
            # (1 - abortion_threshold) of it.
            if -delta < (1.0 - self.ctx.abortion_threshold) * max(cut, 1):
                break
            cut += delta
        Logger.log(f"  fm: cut delta {total}", OutputLevel.DEBUG)
        out = p_graph.with_partition(part)
        with _stats_lock:
            FM_STATS["calls"] += 1
            FM_STATS["passes"] += passes
            FM_STATS["seconds"] += time.perf_counter() - t0
        return out
