"""Heavy-edge matching (HEM) clusterer (counterpart of
``kaminpar_tpu/coarsening/hem_clusterer.py``).

Every unmatched node proposes to its heaviest eligible neighbour (both
endpoints unmatched, not a self-loop, edge weight above 0, the pair within
the cluster weight cap); mutual proposals match.  A fixed number of
rounds; unmatched nodes stay singletons, so a level shrinks by at most 2x.

Plain torch segment operations, as the JAX package's are XLA: no kernel.
The round's jitter (the tie-break among equally heavy edges) comes in
from outside, one (m_pad,) int32 draw in [0, 2^31 - 1) a round.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..context import LabelPropagationContext
from ..graph.csr import PaddedView
from ..ops.segment import segment_max, segment_min
from ..utils import RandomState
from ..utils.timer import scoped_timer

I32MAX = 2**31 - 1


def draw_hem_jitter(gen: torch.Generator, pv: PaddedView) -> torch.Tensor:
    """One round's jitter: (m_pad,) int32 in [0, 2^31 - 1)."""
    return torch.randint(0, I32MAX, (pv.m_pad,), generator=gen, dtype=torch.int32,
                         device=pv.col_idx.device)


def _hem_round(match: torch.Tensor, jitter: torch.Tensor, pv: PaddedView,
               max_cw) -> torch.Tensor:
    """One propose / handshake round over the padded view; ``match[u]`` is
    u's partner (u itself while unmatched).  Returns the new match array."""
    n_pad, m_pad = pv.n_pad, pv.m_pad
    dev = match.device
    node = torch.arange(n_pad, dtype=match.dtype, device=dev)
    unmatched = match == node
    u, v, w = pv.edge_u, pv.col_idx, pv.edge_w
    ul, vl = u.long(), v.long()
    # pads are weight-0 self-loops on the anchor: never eligible
    ok = (unmatched[ul] & unmatched[vl] & (u != v) & (w > 0)
          & (pv.node_w[ul] + pv.node_w[vl] <= max_cw))

    # The heaviest eligible weight first, then the largest jitter among the
    # maxima, then the smallest slot among equal jitters.
    neg = torch.full_like(w, -1)
    w_ok = torch.where(ok, w, neg)
    best_w = segment_max(w_ok, u, n_pad)[ul]
    at_max = ok & (w_ok == best_w) & (best_w > 0)
    j_ok = torch.where(at_max, jitter, neg)
    is_best = at_max & (j_ok == segment_max(j_ok, u, n_pad)[ul])
    slot = torch.arange(m_pad, dtype=torch.int32, device=dev)
    first = segment_min(torch.where(is_best, slot, torch.full_like(slot, I32MAX)), u, n_pad)
    proposal = torch.where(first < I32MAX, v[torch.clamp(first, 0, m_pad - 1).long()],
                           node).to(match.dtype)

    # handshake: mutual proposals match
    mutual = (proposal[proposal.long()] == node) & (proposal != node)
    return torch.where(mutual & unmatched, proposal, match)


class HEMClustering:
    """Clusterer with the LPClustering interface: padded labels, the pads
    carrying the anchor label."""

    def __init__(self, ctx: LabelPropagationContext, num_rounds: int = 5):
        self.ctx = ctx
        self.num_rounds = num_rounds

    def compute_clustering(self, graph, max_cluster_weight: int, *,
                           draw: Optional[Callable[[int], torch.Tensor]] = None
                           ) -> torch.Tensor:
        """``draw(round)`` gives a round's jitter; by default it is drawn from
        the run's generator on the graph's device."""
        pv = graph.padded()
        dev = pv.col_idx.device
        if draw is None:
            gen = RandomState.generator(dev)
            draw = lambda _: draw_hem_jitter(gen, pv)  # noqa: E731
        node = torch.arange(pv.n_pad, dtype=torch.int32, device=dev)
        match = node
        max_cw = torch.full((), int(max_cluster_weight), dtype=torch.int32, device=dev)
        with scoped_timer("hem_clustering"):
            for r in range(self.num_rounds):
                match = _hem_round(match, draw(r), pv, max_cw)
        # label = min(u, partner); every pad carries the anchor label (the
        # contraction's pad contract)
        labels = torch.minimum(match, node)
        return torch.where(node >= pv.n, torch.full_like(node, pv.anchor), labels)
