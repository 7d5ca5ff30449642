"""Lane-stacked steps of the multilevel pipeline (counterpart of
``kaminpar_tpu/ops/lanestack.py``).

The serve engine runs a micro-batch of requests in lockstep: every device
step of the pipeline runs once for all lanes (one graph per lane).  The
JAX package vmaps each step over a leading lane axis; a hand-written
kernel cannot be vmapped, so here a step runs on the **disjoint union** of
the lanes' layouts (:class:`LaneUnion`):

- lane ``j``'s nodes are offset by ``node_off[j]`` (the sum of the earlier
  lanes' ``n_pad``) and its labels by the step's label offset (its node
  offset in clustering, the sum of the earlier lanes' block counts in
  refinement); pad nodes keep their own label and never move, as in the
  lane's own run;
- the real rows of one width class from every lane form one union bucket,
  so the rating kernel (#1, ``kp_rate_bucket``) runs once per width class
  and the commit kernel (#3, ``kp_commit_moves``) once per round for the
  whole stack; each lane's scalar weight cap becomes an entry per label of
  a per-label cap table, which both kernels accept;
- heavy rows (degree > 4096) take the plain flat path lane by lane (no
  kernel rates them in the lane's own run either).

Every lane draws exactly what its own run draws, with the same shapes,
from its own generator (``serve/lanestack.LaneChain``), and a row's
result depends on its own row and draws only.  So each lane's result
equals its sequential ``KaMinPar.compute_partition`` bit for bit
(``tests/test_torch_lanestack.py``).  Per-lane moved counts come from a
segment sum of changed labels over the lanes' node ranges and ride the
round's one stacked readback; a lane whose round loop has ended is frozen
by the commit's ``active`` mask and draws nothing more.

The JAX package's ``lane_layout_plan``, ``lane_bucketed`` and
``lane_extract_padded`` build one stacked layout and stacked padded
arrays for lanes of one shape signature.  Here every lane keeps its own
graph, whose ``padded()`` view and ``bucketed()`` layout are its
sequential run's, and :func:`lane_union` joins whatever layouts a step
has: so those three have no counterpart, and lanes need no common shape
to share a step.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.bucketed import Bucket, BucketedView, HeavyPart
from ..refinement.balancer import BalanceDraws, _balance_commit
from ..utils import compile_stats, sync_stats
from ..utils.intmath import next_pow2
from . import lp
from .bucketed_gains import I32MAX, _heavy_moves
from .contraction import contract_device, contract_finish
from .lp_kernels import commit_moves, rate_bucket
from .segment import segment_max, segment_sum


class LaneUnion(NamedTuple):
    """The disjoint union of L lanes' bucketed layouts."""

    buckets: Tuple[Bucket, ...]  # one per width class, the lanes' real rows
    real_rows: Tuple[int, ...]  # real rows of each union bucket
    # per union bucket: ((lane, lane-local bucket index, rows), ...)
    members: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    heavy: Tuple[Optional[HeavyPart], ...]  # per lane, nodes offset
    gather: torch.Tensor  # (sum n_j,) union row of every lane's real node
    real_nodes: torch.Tensor  # (sum n_j,) union id of every lane's real node
    lane_of_node: torch.Tensor  # (N,) int64 lane of every union node
    node_off: Tuple[int, ...]  # (L + 1,) prefix sums of the lanes' n_pad
    n: Tuple[int, ...]  # real nodes per lane

    @property
    def L(self) -> int:
        return len(self.n)

    @property
    def N(self) -> int:
        return self.node_off[-1]


def lane_union(layouts: Sequence[BucketedView], n_pads: Sequence[int]) -> LaneUnion:
    """The union of the lanes' layouts (``layouts[j]`` over ``n_pads[j]``
    padded nodes).  One host-to-device copy per lane (its row map), no
    readback."""
    L = len(layouts)
    dev = layouts[0].gather_idx.device
    node_off = np.zeros(L + 1, dtype=np.int64)
    node_off[1:] = np.cumsum(n_pads)
    widths = sorted({int(b.cols.shape[1]) for bv in layouts for b in bv.buckets})
    # lane-local position of each bucket's first row, and of the heavy rows
    local_start = []
    for bv in layouts:
        starts, pos = [], 0
        for b in bv.buckets:
            starts.append(pos)
            pos += int(b.nodes.shape[0])
        local_start.append((starts, pos))
    remap = [np.zeros(local_start[j][1] + int(bv.heavy.nodes.shape[0]), dtype=np.int64)
             for j, bv in enumerate(layouts)]
    buckets, real_rows, members = [], [], []
    base = 0
    for w in widths:
        parts_n, parts_c, parts_w, mem = [], [], [], []
        rows = 0
        for j, bv in enumerate(layouts):
            for bi, b in enumerate(bv.buckets):
                if int(b.cols.shape[1]) != w:
                    continue
                r = int(bv.real_rows[bi])
                off = int(node_off[j])
                parts_n.append(b.nodes[:r] + off)
                parts_c.append(b.cols[:r] + off)
                parts_w.append(b.wgts[:r])
                s = local_start[j][0][bi]
                remap[j][s : s + r] = base + rows + np.arange(r)
                mem.append((j, bi, r))
                rows += r
        R = next_pow2(max(rows, 1), 8)
        pad = R - rows
        nodes = torch.cat(parts_n + [torch.zeros(pad, dtype=torch.int32, device=dev)])
        cols = torch.cat(parts_c + [torch.zeros((pad, w), dtype=torch.int32, device=dev)])
        wgts = torch.cat(parts_w + [torch.zeros((pad, w), dtype=torch.int32, device=dev)])
        buckets.append(Bucket(nodes, cols, wgts))
        real_rows.append(rows)
        members.append(tuple(mem))
        base += R
    heavy = []
    for j, bv in enumerate(layouts):
        h = bv.heavy
        hr = int(h.nodes.shape[0])
        if hr == 0:
            heavy.append(None)
            continue
        off = int(node_off[j])
        heavy.append(HeavyPart(h.nodes + off, h.row, h.cols + off, h.wgts))
        s = local_start[j][1]
        remap[j][s : s + hr] = base + np.arange(hr)
        base += hr
    gather = torch.cat([
        torch.from_numpy(remap[j]).to(dev)[bv.gather_idx.long()] for j, bv in enumerate(layouts)
    ])
    real_nodes = torch.cat([
        torch.arange(bv.n, dtype=torch.int64, device=dev) + int(node_off[j])
        for j, bv in enumerate(layouts)
    ])
    lane_of_node = torch.repeat_interleave(
        torch.arange(L, dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(n_pads, dtype=np.int64), device=dev),
        output_size=int(node_off[-1]),
    )
    compile_stats.record("lane_union", arrays=[b.cols for b in buckets], statics=(L,))
    return LaneUnion(tuple(buckets), tuple(real_rows), tuple(members), tuple(heavy),
                     gather, real_nodes, lane_of_node, tuple(int(x) for x in node_off),
                     tuple(int(bv.n) for bv in layouts))


def union_ties(union: LaneUnion, ties: Sequence[Optional[tuple]]):
    """The union buckets' tie draws from the lanes' own ``(R, w)`` draws
    (``ties[j]``, None for a frozen lane: zeros, never read)."""
    out = []
    for b, mem in zip(union.buckets, union.members):
        R, w = b.cols.shape
        parts, rows = [], 0
        for j, bi, r in mem:
            t = ties[j]
            parts.append(t[bi][:r] if t is not None
                         else torch.zeros((r, w), dtype=torch.int32, device=b.cols.device))
            rows += r
        parts.append(torch.zeros((R - rows, w), dtype=torch.int32, device=b.cols.device))
        out.append(torch.cat(parts))
    return out


def union_best_moves(union: LaneUnion, labels, node_w, label_weights, max_label_weights,
                     ties, heavy_ties, *, external_only: bool, respect_caps: bool,
                     tie_break: str = "uniform"):
    """``bucketed_best_moves`` of every lane at once: kernel #1 once per
    union bucket, the lanes' heavy rows on the flat path; (target, tconn,
    own_conn, has), each (N,), with the pad defaults on pad nodes.
    ``ties``: the lanes' bucket ties (``ties[j]`` per lane), ``heavy_ties``
    their heavy ties."""
    flags = dict(external_only=external_only, respect_caps=respect_caps,
                 tie_break=tie_break)
    outs = [rate_bucket(labels, node_w, label_weights, max_label_weights, b, t,
                        real_rows=r, **flags)
            for b, t, r in zip(union.buckets, union_ties(union, ties), union.real_rows)]
    for j, h in enumerate(union.heavy):
        if h is None:
            continue
        tie = heavy_ties[j]
        if tie is None:
            tie = torch.zeros(h.cols.shape, dtype=torch.int32, device=h.cols.device)
        outs.append(_heavy_moves(labels, h, node_w, label_weights, max_label_weights,
                                 tie, **flags))
    target = labels.clone()
    tconn = torch.zeros_like(labels)
    own_conn = torch.zeros_like(labels)
    has = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for dst, i in ((target, 0), (tconn, 1), (own_conn, 2), (has, 3)):
        dst[union.real_nodes] = torch.cat([o[i] for o in outs])[union.gather]
    return target, tconn, own_conn, has


def _lane_vector(union: LaneUnion, parts, fill, dtype):
    """(N,) concatenation of per-lane (n_pad_j,) tensors (None: ``fill``)."""
    dev = union.lane_of_node.device
    return torch.cat([
        p if p is not None else torch.full((union.node_off[j + 1] - union.node_off[j],),
                                           fill, dtype=dtype, device=dev)
        for j, p in enumerate(parts)
    ])


def lane_counts(union: LaneUnion, mask: torch.Tensor) -> torch.Tensor:
    """(L,) int32 count of ``mask`` over each lane's nodes."""
    return segment_sum(mask.to(torch.int32), union.lane_of_node, union.L)


def lane_lp_round(union: LaneUnion, state: lp.LPState, draws: Sequence[Optional[lp.LPDraws]],
                  node_w, max_label_weights, *, num_labels: int,
                  active_probs: Sequence[float], allow_tie_moves: bool = False,
                  tie_break: str = "uniform") -> Tuple[lp.LPState, torch.Tensor]:
    """One LP round of every lane whose ``draws`` is not None (the others
    are frozen): kernel #1 over the union buckets, kernel #3 once.
    Returns the new state and the (L,) moved counts on the device."""
    target, tconn, own_conn, _ = union_best_moves(
        union, state.labels, node_w, state.label_weights, max_label_weights,
        [d.ties if d is not None else None for d in draws],
        [d.heavy_tie if d is not None else None for d in draws],
        external_only=False, respect_caps=True, tie_break=tie_break,
    )
    prio = _lane_vector(union, [d.prio if d is not None else None for d in draws], 0,
                        torch.int32)
    coin = act = None
    if allow_tie_moves:
        coin = _lane_vector(union, [d.coin if d is not None else None for d in draws],
                            False, torch.bool)
    use_act = any(p < 1.0 for p in active_probs)
    if use_act:
        act = _lane_vector(union, [d.act if d is not None and d.act is not None else None
                                   for d in draws], True, torch.bool)
    active = None
    if any(d is None for d in draws):
        live = torch.tensor([d is not None for d in draws], dtype=torch.bool,
                            device=union.lane_of_node.device)
        active = live[union.lane_of_node]
    new = commit_moves(state, target, tconn, own_conn, node_w, max_label_weights, num_labels,
                       prio, coin, act, active_prob=min(active_probs) if use_act else 1.0,
                       allow_tie_moves=allow_tie_moves, active=active)
    return new, lane_counts(union, new.labels != state.labels)


def lane_lp_iterate(union: LaneUnion, state: lp.LPState,
                    draw: Callable[[int, int], lp.LPDraws], node_w, max_label_weights,
                    min_moved: Sequence[int], max_iterations: Sequence[int], *,
                    num_labels: int, active_probs: Sequence[float],
                    allow_tie_moves: bool = False, tie_break: str = "uniform",
                    phase: str) -> Tuple[lp.LPState, List[int]]:
    """Every lane's ``lp_iterate_bucketed`` in lockstep: lane j runs up to
    ``max_iterations[j]`` rounds and stops once a round moves at most
    ``min_moved[j]`` nodes; ``draw(j, i)`` gives its round i's draws.  The
    round's moved counts are read back in one stacked pull.  Returns the
    state and each lane's last moved count (I32MAX before any round)."""
    L = union.L
    moved = [I32MAX] * L
    live = [max_iterations[j] > 0 for j in range(L)]
    i = 0
    while any(live):
        draws = [draw(j, i) if live[j] else None for j in range(L)]
        state, counts = lane_lp_round(union, state, draws, node_w, max_label_weights,
                                      num_labels=num_labels, active_probs=active_probs,
                                      allow_tie_moves=allow_tie_moves, tie_break=tie_break)
        host = sync_stats.pull(counts, phase=phase, lanes=L)
        i += 1
        for j in range(L):
            if live[j]:
                moved[j] = int(host[j])
                live[j] = i < max_iterations[j] and moved[j] > min_moved[j]
    return state, moved


# ---------------------------------------------------------------------------
# Clustering and contraction (coarsening/lp_clusterer.py, ops/contraction.py)
# ---------------------------------------------------------------------------


def lane_cluster(graphs: Sequence, draw_round: Callable[[int, int], lp.LPDraws],
                 draw_two_hop: Callable[[int], lp.LPDraws],
                 max_cluster_weights: Sequence[int], lp_ctx, weighted: Sequence[bool]):
    """One LP clustering of every lane's graph (``LPClustering`` without
    overlays): the lockstep rounds, then each lane's isolated-node pass,
    then the two-hop pass rated over the union.  ``draw_round(j, i)``
    gives lane j's round i draws and ``draw_two_hop(j)`` its two-hop
    draws (the runner draws them from the lane's generator, as
    ``LPClustering`` does; the tests take the JAX package's).  Returns the
    lanes' padded (n_pad_j,) labels and their last rounds' moved
    counts."""
    from ..coarsening.lp_clusterer import LPClustering

    pvs = [g.padded() for g in graphs]
    bvs = [g.bucketed() for g in graphs]
    union = lane_union(bvs, [pv.n_pad for pv in pvs])
    dev = pvs[0].node_w.device
    L = len(graphs)
    off = union.node_off
    labels = torch.cat([
        torch.cat([torch.arange(pv.n, dtype=torch.int32, device=dev),
                   torch.full((pv.n_pad - pv.n,), pv.anchor, dtype=torch.int32, device=dev)])
        + off[j] for j, pv in enumerate(pvs)
    ])
    node_w = torch.cat([pv.node_w for pv in pvs])
    caps = [int(c) for c in max_cluster_weights]
    max_w = torch.cat([torch.full((pv.n_pad,), caps[j], dtype=torch.int32, device=dev)
                       for j, pv in enumerate(pvs)])
    iters, probs = [], []
    for g, w in zip(graphs, weighted):
        it, ap = LPClustering.sweep_plan(lp_ctx, g, w)
        iters.append(it)
        probs.append(ap)
    min_moved = [int(lp_ctx.min_moved_fraction * pv.n) for pv in pvs]
    state = lp.init_state(labels, node_w, union.N)
    state, moved = lane_lp_iterate(
        union, state, draw_round, node_w, max_w, min_moved, iters, num_labels=union.N,
        active_probs=probs,
        tie_break=lp_ctx.tie_breaking.value, phase="lanestack_coarsening",
    )
    out = [state.labels[off[j]:off[j + 1]] - off[j] for j in range(L)]
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    cap_t = [torch.full((), c, dtype=torch.int32, device=dev) for c in caps]
    if lp_ctx.cluster_isolated_nodes:
        out = [lp.cluster_isolated_nodes(
            lp.init_state(out[j], pv.node_w, pv.n_pad), pv.row_ptr, pv.node_w, cap_t[j],
            num_labels=pv.n_pad).labels for j, pv in enumerate(pvs)]
    if lp_ctx.cluster_two_hop_nodes:
        draws = [draw_two_hop(j) for j in range(L)]
        lab_u = torch.cat([out[j] + off[j] for j in range(L)])
        favored, fconn, _, _ = union_best_moves(
            union, lab_u, node_w, segment_sum(node_w, lab_u, union.N), max_w,
            [d.ties for d in draws], [d.heavy_tie for d in draws],
            external_only=False, respect_caps=False,
        )
        out = [lp.two_hop_match(
            lp.LPState(out[j], segment_sum(pv.node_w, out[j], pv.n_pad), zero),
            draws[j].prio, favored[off[j]:off[j + 1]] - off[j], fconn[off[j]:off[j + 1]],
            pv.node_w, cap_t[j], num_labels=pv.n_pad).labels for j, pv in enumerate(pvs)]
    return out, moved


def lane_contract(graphs: Sequence, labels: Sequence[torch.Tensor], lp_moved: Sequence[int]):
    """Every lane's ``contract_clustering`` with one stacked readback of
    the lanes' packed stats (each widened by its moved count, as the
    sequential contraction packs it).  Returns the coarse graphs, the
    fine -> coarse maps and the (L, 5) host stats (n_c + 1, m_c, max node
    weight, total edge weight, moved)."""
    from .contraction import _coarse_graph

    pres = []
    for g, lab, mv in zip(graphs, labels, lp_moved):
        pv = g.padded()
        pres.append(contract_device(lab, pv.edge_u, pv.col_idx, pv.edge_w, pv.node_w,
                                    (torch.full((), mv, dtype=torch.int64,
                                                device=lab.device),)))
    stats = sync_stats.pull(torch.stack([p.stats for p in pres]),
                            phase="lanestack_coarsening", lanes=len(graphs))
    out = []
    for g, pre, row in zip(graphs, pres, stats):
        coarse, coarse_of, _ = _coarse_graph(contract_finish(pre, row), g.n, g.m,
                                             g._total_node_weight, g.device)
        out.append((coarse, coarse_of))
    return out, stats


def lane_host_row_ptrs(graphs: Sequence, phase: str) -> None:
    """Read every lane's row_ptr back in one stacked pull and cache it as
    the graph's host copy (its bucketed layout's plan needs it)."""
    todo = [g for g in graphs if g._host_row_ptr is None]
    if not todo:
        return
    host = sync_stats.pull(torch.cat([g.row_ptr for g in todo]), phase=phase,
                           lanes=len(todo)).astype(np.int64)
    pos = 0
    for g in todo:
        g._host_row_ptr = host[pos : pos + g.n + 1]
        pos += g.n + 1


# ---------------------------------------------------------------------------
# Refinement (refinement/{balancer,lp_refiner,refiner}.py)
# ---------------------------------------------------------------------------


class LaneBlocks(NamedTuple):
    """A refinement step's block spaces: lane j's blocks are offset by
    ``off[j]`` in a union of ``K`` labels."""

    off: Tuple[int, ...]  # (L + 1,)
    of_node: torch.Tensor  # (N,) int32 label offset of every union node
    lane: torch.Tensor  # (K,) int32 lane of every union label

    @property
    def K(self) -> int:
        return self.off[-1]

    @staticmethod
    def build(union: LaneUnion, sizes: Sequence[int]) -> "LaneBlocks":
        dev = union.lane_of_node.device
        off = np.zeros(len(sizes) + 1, dtype=np.int64)
        off[1:] = np.cumsum(sizes)
        off_t = torch.as_tensor(off[:-1], dtype=torch.int32, device=dev)
        lane = torch.repeat_interleave(
            torch.arange(len(sizes), dtype=torch.int32, device=dev),
            torch.as_tensor(np.asarray(sizes, dtype=np.int64), device=dev),
            output_size=int(off[-1]))
        return LaneBlocks(tuple(int(x) for x in off), off_t[union.lane_of_node], lane)


def lane_balance_round(union: LaneUnion, blocks: LaneBlocks, labels,
                       draws: Sequence[Optional[BalanceDraws]], node_w, max_bw):
    """One overload-balancer round of every lane whose ``draws`` is not
    None (``refinement/balancer._balance_round``): kernel #1 over the
    union in its external-only mode, the lightest-block fallback inside
    each lane (the lanes are the groups of the grouped round), frozen
    lanes held by the ``movable`` mask.  ``labels`` are lane-local block
    ids; returns the new ones and the (L, 2) int32 (moved, still
    overloaded) flags."""
    L, K = union.L, blocks.K
    lab = labels + blocks.of_node
    block_weights = segment_sum(node_w, lab, K)
    target, tconn, oconn, has = union_best_moves(
        union, lab, node_w, block_weights, max_bw,
        [d.ties if d is not None else None for d in draws],
        [d.heavy_tie if d is not None else None for d in draws],
        external_only=True, respect_caps=True,
    )
    jitter = torch.cat([
        d.jitter if d is not None else torch.zeros(union.node_off[j + 1] - union.node_off[j],
                                                   device=lab.device)
        for j, d in enumerate(draws)
    ])
    movable = None
    if any(d is None for d in draws):
        live = torch.tensor([d is not None for d in draws], dtype=torch.bool,
                            device=lab.device)
        movable = live[union.lane_of_node]
    new, commit = _balance_commit(lab, target, tconn, oconn, has, block_weights, node_w,
                                  max_bw, jitter, k=K, group_of=blocks.lane,
                                  movable=movable)
    over = (segment_sum(node_w, new, K) > max_bw).to(torch.int32)
    flags = torch.stack([lane_counts(union, commit),
                         segment_max(over, blocks.lane, L)], dim=1)
    return new - blocks.of_node, flags


def lane_lp_refine(union: LaneUnion, labels, node_w, caps: Sequence[np.ndarray],
                   draw: Callable[[int, int], lp.LPDraws], rl_ctx):
    """Every lane's LP refiner pass (``refinement/lp_refiner.py``) in
    lockstep; lane j's label space is its ``num_labels_bucket(k_j)``
    padded blocks (``caps[j]`` its k_j block caps), ``draw(j, i)`` its
    round i draws.  ``labels`` are lane-local block ids."""
    sizes = [lp.num_labels_bucket(len(c)) for c in caps]
    blocks = LaneBlocks.build(union, sizes)
    dev = labels.device
    max_w = torch.zeros(blocks.K, dtype=torch.int32, device=dev)
    for j, c in enumerate(caps):
        max_w[blocks.off[j] : blocks.off[j] + len(c)] = torch.as_tensor(
            np.asarray(c), dtype=torch.int32, device=dev)
    state = lp.init_state(labels + blocks.of_node, node_w, blocks.K)
    ap, tie_moves = rl_ctx.active_prob, rl_ctx.allow_tie_moves
    state, _ = lane_lp_iterate(
        union, state, draw, node_w, max_w, [int(rl_ctx.min_moved_fraction * n) for n in union.n],
        [rl_ctx.num_iterations] * union.L, num_labels=blocks.K,
        active_probs=[ap] * union.L, allow_tie_moves=tie_moves,
        phase="lanestack_refinement",
    )
    return state.labels - blocks.of_node


class LaneEdges(NamedTuple):
    """The lanes' real edges in union node ids, for :func:`lane_quality`."""

    edge_u: torch.Tensor
    col_idx: torch.Tensor
    edge_w: torch.Tensor
    lane: torch.Tensor  # (M,) int64 lane of every edge

    @staticmethod
    def build(union: LaneUnion, graphs: Sequence) -> "LaneEdges":
        dev = union.lane_of_node.device
        off = union.node_off
        return LaneEdges(
            torch.cat([g.edge_u.long() + off[j] for j, g in enumerate(graphs)]),
            torch.cat([g.col_idx.long() + off[j] for j, g in enumerate(graphs)]),
            torch.cat([g.edge_w.to(torch.int64) for g in graphs]),
            torch.repeat_interleave(torch.arange(len(graphs), dtype=torch.int64, device=dev),
                                    torch.as_tensor([g.m for g in graphs], device=dev),
                                    output_size=sum(g.m for g in graphs)),
        )


def lane_quality(union: LaneUnion, edges: LaneEdges, blocks: LaneBlocks, labels, node_w,
                 *, phase: str = "lanestack_refinement") -> np.ndarray:
    """Every lane's (edge cut, block weights) in one stacked pull: an
    int64 host array of L cuts followed by the K block weights (lane j's
    at ``blocks.off[j]``), as ``metrics.edge_cut`` and
    ``metrics.block_weights`` compute them."""
    L = union.L
    cut = labels[edges.edge_u] != labels[edges.col_idx]
    cuts = torch.zeros(L, dtype=torch.int64, device=labels.device).index_add_(
        0, edges.lane, torch.where(cut, edges.edge_w, 0)) // 2
    bw = torch.zeros(blocks.K, dtype=torch.int64, device=labels.device).index_add_(
        0, (labels + blocks.of_node).long(), node_w.to(torch.int64))
    return sync_stats.pull(torch.cat([cuts, bw]), phase=phase, lanes=L)


def lane_project(coarse_of: Sequence[torch.Tensor], coarse_labels: Sequence[torch.Tensor]):
    """Every lane's uncoarsening projection, fine[u] = coarse[coarse_of[u]]."""
    return [c[co] for co, c in zip(coarse_of, coarse_labels)]


def lane_select_best(snapshots: Sequence[torch.Tensor], best: Sequence[int],
                     union: LaneUnion) -> torch.Tensor:
    """(N,) labels taking lane j's nodes from ``snapshots[best[j]]``."""
    idx = torch.as_tensor(np.asarray(best, dtype=np.int64),
                          device=union.lane_of_node.device)[union.lane_of_node]
    return torch.stack(list(snapshots)).gather(0, idx[None, :])[0]
