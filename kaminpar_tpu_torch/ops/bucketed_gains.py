"""Best-move computation over the degree-bucketed layout.

Counterpart of ``kaminpar_tpu/ops/bucketed_gains.py``.  :func:`_bucket_moves`
is the plain PyTorch version of the rating kernel (``csrc/lp_rate.cu``,
dispatched by ``ops/lp_kernels.rate_bucket``): per row of an ``(R, w)``
bucket, gather the neighbour labels, stable-sort the row, reduce runs of
equal labels to ratings, filter by the weight cap and break ties.  Heavy
rows (degree > MAX_WIDTH) take the flat edge-parallel path
(:func:`flat_best_moves`), which stays plain PyTorch.

The tie-break randoms come in as arguments (``tie`` is read at the
*sorted* slot position, as in the JAX package), so a test can feed both
packages the same draws.
"""

from __future__ import annotations

import torch

from ..graph.bucketed import Bucket, BucketedView, HeavyPart
from .segment import run_starts2, segment_max, segment_min

I32MAX = 2**31 - 1


def lookup(table_or_scalar: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Index a per-label table, or broadcast a scalar limit."""
    return table_or_scalar if table_or_scalar.ndim == 0 else table_or_scalar[idx]


def _first_argmax_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first maximum (``jnp.argmax`` semantics)."""
    w = x.shape[1]
    pos = torch.arange(w, dtype=torch.int64, device=x.device)
    hit = x == x.max(dim=1).values[:, None]
    return torch.where(hit, pos, w).min(dim=1).values


def _bucket_moves(labels, bucket: Bucket, node_w, label_weights, max_label_weights,
                  tie, *, external_only: bool, respect_caps: bool,
                  tie_break: str = "uniform"):
    """Per-row best move for one (R, w) bucket; returns (target, tconn,
    own_conn, has), each (R,)."""
    nodes, cols, wgts = bucket
    R, w = cols.shape
    own = labels[nodes]
    nw = node_w[nodes]
    L = labels[cols]
    W = wgts
    zero = torch.zeros((), dtype=W.dtype, device=W.device)
    own_conn = torch.where(L == own[:, None], W, zero).sum(dim=1, dtype=torch.int32)

    Ls, perm = torch.sort(L, dim=1, stable=True)
    Ws = W.gather(1, perm)
    c = torch.cumsum(Ws, dim=1, dtype=torch.int32)
    change = Ls[:, 1:] != Ls[:, :-1]
    ones = torch.ones((R, 1), dtype=torch.bool, device=L.device)
    start = torch.cat([ones, change], dim=1)
    end = torch.cat([change, ones], dim=1)
    # Rating of the run covering each slot, valid at run ends: cumsum minus
    # the cumsum just before the run began (propagated by a row cummax,
    # monotone because weights are non-negative).
    base = torch.where(start, c - Ws, zero)
    rating = c - torch.cummax(base, dim=1).values

    is_cur = Ls == own[:, None]
    # rating > 0 excludes all-pad runs (pad slots have weight 0).
    ok = end & (rating > 0)
    if external_only:
        ok = ok & ~is_cur
    if respect_caps:
        fits = label_weights[Ls] + nw[:, None] <= lookup(max_label_weights, Ls)
        ok = ok & fits if external_only else ok & (is_cur | fits)

    score = torch.where(ok, rating, torch.full_like(rating, -1))
    best = score.max(dim=1).values
    has = best >= 0
    eligible = ok & (rating == best[:, None]) & has[:, None]
    if tie_break == "lightest":
        lw = lookup(label_weights, Ls)
        lw_m = torch.where(eligible, lw, torch.full_like(lw, I32MAX))
        eligible = eligible & (lw_m == lw_m.min(dim=1).values[:, None])
    tie_m = torch.where(eligible, tie, torch.full_like(tie, -1))
    slot = _first_argmax_rows(tie_m)
    target = torch.where(has, Ls.gather(1, slot[:, None])[:, 0], own)
    tconn = torch.where(has, best, zero)
    return target, tconn, own_conn, has


def flat_best_moves(row, cand, w, own, node_w_row, label_weights,
                    max_label_weights, tie, *, num_rows: int,
                    external_only: bool, respect_caps: bool,
                    tie_break: str = "uniform"):
    """Flat run-reduce best moves over (row, candidate label, weight) slot
    triples: one sort by (row, label), run ratings by cumsum/cummax, per-row
    reductions by segment max/min.  ``tie`` is (S,), read at sorted
    positions."""
    S = cand.shape[0]
    key = (row.to(torch.int64) << 32) | cand.to(torch.int64)
    order = torch.sort(key, stable=True).indices
    sr, sc, sw = row[order], cand[order], w[order]
    first = run_starts2(sr, sc)
    zero = torch.zeros((), dtype=sw.dtype, device=sw.device)
    c = torch.cumsum(sw, 0, dtype=torch.int32)
    base = torch.where(first, c - sw, zero)
    rating = c - torch.cummax(base, 0).values
    end = torch.cat([first[1:], torch.ones(1, dtype=torch.bool, device=first.device)])
    rating = torch.where(end, rating, zero)

    is_cur = sc == own[sr]
    own_conn = torch.clamp(
        segment_max(torch.where(end & is_cur, rating, zero), sr, num_rows), min=0
    )
    ok = end & (rating > 0)
    if external_only:
        ok = ok & ~is_cur
    if respect_caps:
        fits = label_weights[sc] + node_w_row[sr] <= lookup(max_label_weights, sc)
        ok = ok & fits if external_only else ok & (is_cur | fits)

    score = torch.where(ok, rating, torch.full_like(rating, -1))
    best = segment_max(score, sr, num_rows)
    eligible = ok & (rating == best[sr])
    if tie_break == "lightest":
        lw = lookup(label_weights, sc)
        lw_m = torch.where(eligible, lw, torch.full_like(lw, I32MAX))
        eligible = eligible & (lw_m == segment_min(lw_m, sr, num_rows)[sr])
    tie_m = torch.where(eligible, tie, torch.full_like(tie, -1))
    winner = eligible & (tie_m == segment_max(tie_m, sr, num_rows)[sr])
    slot = torch.arange(S, dtype=torch.int32, device=sc.device)
    best_slot = segment_min(torch.where(winner, slot, torch.full_like(slot, S)),
                            sr, num_rows)
    has = best >= 0
    safe = torch.clamp(best_slot, 0, max(S - 1, 0))
    target = torch.where(has, sc[safe], own)
    tconn = torch.where(has, best, zero)
    return target, tconn, own_conn, has


def _heavy_moves(labels, heavy: HeavyPart, node_w, label_weights,
                 max_label_weights, tie, *, external_only: bool,
                 respect_caps: bool, tie_break: str = "uniform"):
    """Heavy rows: the flat path with the dense heavy-row index as row key."""
    hnodes, hrow, hcols, hw = heavy
    return flat_best_moves(
        hrow, labels[hcols], hw, labels[hnodes], node_w[hnodes], label_weights,
        max_label_weights, tie, num_rows=int(hnodes.shape[0]),
        external_only=external_only, respect_caps=respect_caps,
        tie_break=tie_break,
    )


def draw_ties(gen: torch.Generator, layout):
    """The tie-break randoms of one rating pass over a bucketed layout
    (dense ``BucketedView`` or ``DeviceCompressedView``): an (R, w) int32
    array per bucket and an (S,) array for the heavy part (None without
    heavy rows), uniform in [0, 2^31 - 1).  Drawn from the layout's shapes
    alone, so both layouts of one graph take the same draws."""
    dev = layout.gather_idx.device

    def draw(shape):
        return torch.randint(0, I32MAX, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    ties = tuple(draw(shape) for shape in layout.bucket_shapes)
    heavy = draw(tuple(layout.heavy.cols.shape)) if layout.heavy.nodes.shape[0] else None
    return ties, heavy


def bucketed_best_moves(labels, bv: BucketedView, node_w, label_weights,
                        max_label_weights, ties, heavy_tie, *,
                        external_only: bool = True, respect_caps: bool = True,
                        tie_break: str = "uniform"):
    """Best move of every node of the padded graph; returns (target, tconn,
    own_conn, has), each (n_pad,), inert on pad nodes.  Each bucket goes
    through the rating kernel's wrapper (CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor)."""
    from .lp_kernels import rate_bucket

    outs = [
        rate_bucket(labels, node_w, label_weights, max_label_weights, b, tie,
                    external_only=external_only, respect_caps=respect_caps,
                    tie_break=tie_break, real_rows=real)
        for b, tie, real in zip(bv.buckets, ties, bv.real_rows)
    ]
    if bv.heavy.nodes.shape[0] > 0:
        outs.append(_heavy_moves(
            labels, bv.heavy, node_w, label_weights, max_label_weights,
            heavy_tie, external_only=external_only, respect_caps=respect_caps,
            tie_break=tie_break,
        ))
    return assemble_moves(outs, bv.gather_idx, labels, bv.n, int(labels.shape[0]))


def assemble_moves(outs, gather_idx, labels, n: int, n_pad: int):
    """Gather per-row results into (n_pad,) node arrays; pad nodes get no
    candidate and no move."""
    parts = [torch.cat([o[i] for o in outs])[gather_idx] for i in range(4)]
    target, tconn, own_conn, has = parts
    pad = n_pad - n
    if pad:
        target = torch.cat([target, labels[n:]])
        tconn = torch.cat([tconn, tconn.new_zeros(pad)])
        own_conn = torch.cat([own_conn, own_conn.new_zeros(pad)])
        has = torch.cat([has, has.new_zeros(pad)])
    return target, tconn, own_conn, has


def bucketed_neighbor_reduce(fn, bv: BucketedView, n_pad: int) -> torch.Tensor:
    """Per-node sum over neighbours in the bucketed layout: ``fn(nodes,
    cols, wgts)`` gives the (R, w) int32 contributions of a bucket (nodes
    as an (R, 1) column) or the (S,) ones of the heavy slots; they are
    summed per row (int32, wrapping) and gathered into an (n_pad,) array,
    0 on pad nodes.  JET's pessimistic-gain filter runs on it."""
    outs = [fn(b.nodes[:, None], b.cols, b.wgts).sum(dim=1, dtype=torch.int32)
            for b in bv.buckets]
    hnodes, hrow, hcols, hw = bv.heavy
    if hnodes.shape[0] > 0:
        contrib = fn(hnodes[hrow], hcols, hw)
        outs.append(torch.zeros(hnodes.shape[0], dtype=torch.int32,
                                device=contrib.device).index_add_(0, hrow, contrib))
    flat = torch.cat(outs)[bv.gather_idx]
    pad = n_pad - bv.n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat
