"""Greedy node colouring (counterpart of ``kaminpar_tpu/ops/coloring.py``).

Colours the nodes so that no edge is monochromatic; the colored LP refiner
then moves one colour class per superstep.  Jones-Plassmann style, bulk
synchronous: in each round every uncoloured node takes the smallest colour
absent from its coloured neighbourhood (an OR of neighbour colour bits,
built as sort + first-of-run dedup + segment sum) unless an uncoloured
neighbour with the same candidate holds a higher (priority, id).  Up to
62 colours (two int32 words); at most ``max_rounds`` rounds, after which
stragglers take colour 0, so that on a graph whose dense core needs more
colours (RMAT from scale 14 on) the edges between stragglers, and between
a straggler and a node of colour 0, are monochromatic.

Each round's priorities come in from the caller (``draw_prio(i)``: (n,)
int32 in [0, 2^31 - 1)), so a test can feed the JAX package's draws.  The
loop reads back whether any node is still uncoloured once per round.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils import sync_stats
from .segment import run_starts2, segment_max, segment_sum

MAX_COLORS = 62
UNCOLORED = -1


def used_masks(nbr_colors, edge_u, n: int):
    """Per-node OR of the (per-edge) neighbour colour bits, as two int32
    words (colours 0-30 and 31-61); an edge with a colour of -1 does not
    contribute."""
    valid = nbr_colors >= 0
    # dedup (u, colour) pairs, so that the segment sum acts as an OR
    key_c = torch.where(valid, nbr_colors, torch.full_like(nbr_colors, MAX_COLORS))
    key = (edge_u.to(torch.int64) << 8) | key_c.to(torch.int64)
    skey = torch.sort(key).values
    su, sc = (skey >> 8).to(torch.int32), (skey & 0xFF).to(torch.int32)
    first = run_starts2(su, sc)
    use = first & (sc < MAX_COLORS)
    one = torch.ones((), dtype=torch.int32, device=sc.device)
    zero = torch.zeros((), dtype=torch.int32, device=sc.device)
    lo_bit = torch.where(use & (sc < 31), one << torch.clamp(sc, 0, 30), zero)
    hi_bit = torch.where(use & (sc >= 31), one << torch.clamp(sc - 31, 0, 30), zero)
    return segment_sum(lo_bit, su, n), segment_sum(hi_bit, su, n)


# Masks of the bits whose index has bit b set, for b = 4 ... 0 (31 bits).
_INDEX_BIT_MASKS = ((16, 0x7FFF0000), (8, 0x7F00FF00), (4, 0x70F0F0F0),
                    (2, 0x4CCCCCCC), (1, 0x2AAAAAAA))


def _lowest_set_bit_index(x):
    """Index of the lowest set bit of x in [0, 2^31), or 31 for x = 0, in
    exact integer operations."""
    iso = x & -x  # the lowest set bit alone (0 when x == 0)
    idx = torch.zeros_like(x)
    for b, mask in _INDEX_BIT_MASKS:
        idx = idx + torch.where((iso & mask) != 0, b, 0).to(x.dtype)
    return torch.where(iso > 0, idx, torch.full_like(idx, 31))


def _smallest_free(lo, hi):
    """Lowest colour index whose bit is clear in (lo, hi)."""
    free_lo = _lowest_set_bit_index(~lo & 0x7FFFFFFF)
    free_hi = 31 + _lowest_set_bit_index(~hi & 0x7FFFFFFF)
    return torch.where(free_lo < 31, free_lo, free_hi).to(torch.int32)


def coloring_round(colors, prio, edge_u, col_idx, *, n: int):
    """One round: every uncoloured node claims its smallest free colour
    unless it loses to an uncoloured neighbour with the same candidate."""
    lo, hi = used_masks(colors[col_idx], edge_u, n)
    cand = _smallest_free(lo, hi)
    u, v = edge_u, col_idx
    both = (colors[u] < 0) & (colors[v] < 0) & (u != v)
    same = both & (cand[u] == cand[v])
    neg = torch.full_like(prio[v], -1)
    rival = torch.where(same, prio[v], neg)
    best_rival = segment_max(rival, u, n)
    tie_rival = segment_max(torch.where(same & (prio[v] == best_rival[u]), v, neg), u, n)
    me = torch.arange(n, dtype=col_idx.dtype, device=colors.device)
    wins = (prio > best_rival) | ((prio == best_rival) & (me > tie_rival))
    # cand == MAX_COLORS would collide with the "no colour" key in
    # used_masks: such nodes stay uncoloured and retry.
    newly = (colors < 0) & wins & (cand < MAX_COLORS)
    return torch.where(newly, cand, colors)


def color_graph(draw_prio: Callable[[int], torch.Tensor], edge_u, col_idx, node_mask, *,
                n: int, max_rounds: int = 64):
    """Colour the graph of the flat (m,) edge arrays; ``node_mask`` marks
    the real nodes (pad nodes keep colour 0: they have no edges to other
    nodes).  Returns ((n,) int32 colours with -1 on the stragglers, the
    number of rounds run).  The reference gives the stragglers colour 0
    (``clamp(min=0)``): supersteps stay correct, only their exactness
    degrades."""
    colors = torch.where(node_mask, UNCOLORED, 0).to(torch.int32)
    i = 0
    while i < max_rounds and sync_stats.pull((colors < 0).any()):
        colors = coloring_round(colors, draw_prio(i), edge_u, col_idx, n=n)
        i += 1
    return colors, i


def num_colors_device(colors, node_mask):
    """The colour count as a device scalar (pads hold colour 0)."""
    return (torch.where(node_mask, colors, 0).max() + 1).to(torch.int32)
