"""Cluster coarsener: clustering + contraction hierarchy (counterpart of
``kaminpar_tpu/coarsening/cluster_coarsener.py``).

With a ``DeviceCompressedView`` in place of the finest CSR (the TeraPart
tier under ``device_decode="finest"``), level 0 is clustered and contracted
straight off the compressed stream; the finest CSR is decoded on the
device only when uncoarsening comes back to level 0.

The clusterer is ``ctx.coarsening.algorithm``'s: LP (with
``overlay_levels``), heavy-edge matching, or none (no level is built).
With ``ctx.coarsening.sparsification.enabled`` a contracted level keeps
only about target_m of its heaviest edges (``coarsening/sparsifier.py``)
when it has more than ``laziness_factor`` x target_m.

With communities (``set_communities``: device extension's current blocks,
or the previous v-cycle's partition), no cluster spans two communities:
the clustering runs on the community-masked graph, and every level
carries its nodes' communities.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional

import torch

from ..context import ClusteringAlgorithm, Context
from ..graph.compressed import CompressedGraph
from ..graph.csr import CSRGraph
from ..graph.device_compressed import DeviceCompressedView
from ..ops.contraction import contract_clustering, contract_compressed, project_partition
from ..ops.segment import segment_max
from ..telemetry import probes
from ..utils.logger import Logger, OutputLevel
from ..utils.timer import scoped_timer
from .hem_clusterer import HEMClustering
from .lp_clusterer import LPClustering
from .max_cluster_weights import compute_max_cluster_weight
from .sparsifier import sparsify_threshold


@dataclass
class CoarseLevel:
    graph: CSRGraph  # the coarse graph produced at this level
    coarse_of: torch.Tensor  # fine node -> coarse node
    communities: Optional[torch.Tensor] = None  # community per coarse node


class ClusterCoarsener:
    def __init__(self, ctx: Context, graph: Optional[CSRGraph],
                 compressed_view: Optional[DeviceCompressedView] = None):
        """``graph`` is the finest CSR, or None when ``compressed_view``
        stands in for it."""
        self.ctx = ctx
        self.input_graph = graph
        self.input_cview = compressed_view
        self._compressed: Optional[CompressedGraph] = None
        self._device = None
        self.hierarchy: List[CoarseLevel] = []
        # Contractions made, the last one of a converged run (not pushed)
        # included: each reads back once (ops/contraction.py), the budget
        # the deep scheme asserts for the "coarsening" phase.
        self.contractions = 0
        algorithm = ctx.coarsening.algorithm
        if algorithm == ClusteringAlgorithm.LP:
            pinned = ctx.coarsening.lp.weighted_mode
            if pinned is not None:
                weighted = bool(pinned)
            else:
                src = graph if graph is not None else compressed_view.cg
                weighted = not src.has_uniform_edge_weights()
            self.clusterer = LPClustering(ctx.coarsening.lp, ctx.coarsening.overlay_levels,
                                          weighted_graph=weighted)
        elif algorithm == ClusteringAlgorithm.HEM:
            self.clusterer = HEMClustering(ctx.coarsening.lp)
        else:
            self.clusterer = None
        self.input_communities: Optional[torch.Tensor] = None
        self._masked_clusterer = None
        # Levels sparsified, and their edges before and after; whether a
        # level shrank by less than the convergence threshold.
        self.sparsification = {"levels": 0, "edges_before": 0, "edges_after": 0}
        self.converged = False

    def set_communities(self, communities: torch.Tensor) -> None:
        """Restrict clustering to ``communities`` ((n,) int32 per input
        node).  The clustering then rates the community-masked graph
        (cross-community edges at weight 0, and LP adopts only labels
        rated above 0) without the isolated-node and two-hop passes, which
        merge nodes regardless of edges; contraction keeps the true
        weights.  Not for a compressed-view input, whose stream carries no
        per-edge weights to mask."""
        if self.input_cview is not None:
            raise ValueError("communities cannot restrict the clustering of a "
                             "compressed view")
        self.input_communities = torch.as_tensor(
            communities, device=self.input_graph.device).to(torch.int32)
        if isinstance(self.clusterer, LPClustering):
            self._masked_clusterer = LPClustering(
                dataclasses.replace(self.ctx.coarsening.lp, cluster_isolated_nodes=False,
                                    cluster_two_hop_nodes=False),
                self.ctx.coarsening.overlay_levels,
                weighted_graph=self.clusterer.weighted_graph,
            )
        else:
            # HEM's eligibility already needs an edge weight above 0
            self._masked_clusterer = self.clusterer

    def release_input_graph(self, compressed: CompressedGraph) -> None:
        """Drop the finest level once coarse levels exist: while the
        pipeline works on them, no m-sized array of the finest graph is
        held.  ``current_graph`` decodes it again at level 0: on the device
        from the compressed view, or on the host from ``compressed``."""
        if self.hierarchy:
            self._compressed = compressed
            self._device = self.hierarchy[0].graph.device
            self.input_graph = None

    @property
    def current_graph(self) -> CSRGraph:
        if self.hierarchy:
            return self.hierarchy[-1].graph
        if self.input_graph is None:
            if self.input_cview is not None:
                Logger.log("  terapart: decoding the finest CSR on the device",
                           OutputLevel.DEBUG)
                with scoped_timer("compressed_decode"):
                    self.input_graph = self.input_cview.materialize_csr()
            else:
                Logger.log("  terapart: decompressing the finest CSR on the host",
                           OutputLevel.DEBUG)
                self.input_graph = self._compressed.decompress(self._device)
        return self.input_graph

    @property
    def current_n(self) -> int:
        """Node count of the current level without decoding it."""
        if self.hierarchy:
            return self.hierarchy[-1].graph.n
        if self.input_graph is not None:
            return self.input_graph.n
        return self.input_cview.n

    @property
    def current_communities(self) -> Optional[torch.Tensor]:
        """The current level's communities per node, or None."""
        if self.hierarchy:
            return self.hierarchy[-1].communities
        return self.input_communities

    @property
    def num_levels(self) -> int:
        return len(self.hierarchy)

    def coarsen_once(self, k: int, epsilon: float) -> bool:
        """One level; False when it shrank by less than the convergence
        threshold (the level is then not pushed), or when there is no
        clusterer."""
        if self.clusterer is None:
            return False
        # Level 0 off the compressed view: the finest CSR is not decoded.
        off_stream = not self.hierarchy and self.input_graph is None
        src = self.input_cview if off_stream else self.current_graph
        n_cur, m_cur = src.n, src.m
        max_cw = compute_max_cluster_weight(
            self.ctx.coarsening, n_cur, src.total_node_weight, k, epsilon
        )
        # Bound the per-level shrink: cap cluster weight at ~shrink factor x
        # the average node weight, so synchronous LP keeps a gradual
        # hierarchy.
        sf = self.ctx.coarsening.max_shrink_factor
        if sf > 0:
            avg_w = src.total_node_weight / max(n_cur, 1)
            max_cw = min(max_cw, max(int(sf * avg_w), 1))
        comm = self.current_communities
        with scoped_timer("coarsening"):
            clusterer = self.clusterer if comm is None else self._masked_clusterer
            labels = clusterer.compute_clustering(
                src if comm is None else src.community_masked(comm), max_cw)
            contract = contract_compressed if off_stream else contract_clustering
            self.contractions += 1
            # The clusterer's moved count rides the contraction's one
            # readback, for the level's quality row.
            lp_moved = getattr(clusterer, "last_num_moved", None)
            if lp_moved is not None:
                coarse, coarse_of, (lp_moved,) = contract(src, labels, (lp_moved,))
            else:
                coarse, coarse_of = contract(src, labels)
            # Clusters never span communities: any member's community is
            # the cluster's.
            coarse_comm = None if comm is None else segment_max(comm, coarse_of, coarse.n)
        coarse_m = coarse.m
        coarse = self._sparsify(coarse, n_cur, m_cur)
        # The level's quality row: host values of the contraction's readback
        # only (a sparsified level has no cached total edge weight).
        probes.coarsening_level(
            level=len(self.hierarchy), n=n_cur, m=m_cur, n_c=coarse.n, m_c=coarse.m,
            max_cluster_weight=max_cw, max_node_weight=coarse._max_node_weight,
            total_edge_weight=coarse._total_edge_weight, lp_moved=lp_moved,
            lp_rounds_budget=getattr(getattr(clusterer, "ctx", None), "num_iterations", None),
        )
        Logger.log(
            f"  coarsening level {len(self.hierarchy)}: n={n_cur} -> {coarse.n}, "
            f"m={m_cur} -> {coarse.m} (max_cw={max_cw})",
            OutputLevel.DEBUG,
        )
        if 1.0 - coarse.n / max(n_cur, 1) < self.ctx.coarsening.convergence_threshold:
            self.converged = True
            return False
        if coarse.m < coarse_m:
            self.sparsification["levels"] += 1
            self.sparsification["edges_before"] += coarse_m
            self.sparsification["edges_after"] += coarse.m
        self.hierarchy.append(CoarseLevel(coarse, coarse_of, coarse_comm))
        return True

    def _sparsify(self, coarse: CSRGraph, n: int, m: int) -> CSRGraph:
        """Threshold sparsification of a level contracted from n nodes and m
        edges: target_m = min(edge_target x m, density_target x m/n x n_c),
        at most the level's edges; only when target_m >= 2 and the level
        has more than laziness x target_m edges."""
        s_ctx = self.ctx.coarsening.sparsification
        if not s_ctx.enabled or coarse.m == 0:
            return coarse
        target_m = min(s_ctx.edge_target_factor * m,
                       s_ctx.density_target_factor * m / max(n, 1) * coarse.n)
        target_m = int(min(target_m, coarse.m))
        if target_m >= 2 and coarse.m > s_ctx.laziness_factor * target_m:
            return sparsify_threshold(coarse, target_m)
        return coarse

    def coarsen(self, k: int, epsilon: float, target_n: int, on_level=None) -> CSRGraph:
        """Coarsen until n <= target_n or convergence.  ``on_level(self)``
        runs after each pushed level (the deep scheme's checkpoint
        boundary); a hierarchy restored from a checkpoint goes on from
        ``current_n``."""
        while self.current_n > target_n:
            if not self.coarsen_once(k, epsilon):
                break
            if on_level is not None:
                on_level(self)
        return self.current_graph

    def uncoarsen(self, partition: torch.Tensor) -> torch.Tensor:
        """Pop one level and project the partition to the finer graph."""
        level = self.hierarchy.pop()
        with scoped_timer("uncoarsening", sync=True) as ts:
            out = project_partition(level.coarse_of, partition)
            ts.note(out)
        return out
