"""NetworKit bindings (counterpart of
``kaminpar_tpu/integrations/networkit.py``).

Role counterpart: bindings/networkit/src/kaminpar_networkit.{h,cc} — a
KaMinPar subclass that accepts a ``networkit.Graph``, plus partition
results returned in NetworKit's preferred shape.  NetworKit is an optional
dependency (not bundled with this framework); the import is deferred to
call time so the module always loads, and any object that quacks like a
``networkit.Graph`` (numberOfNodes / iterNeighborsWeights / isWeighted)
works — which is also how the adapter is tested without NetworKit.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..graph.csr import CSRGraph, from_numpy_csr
from ..kaminpar import KaMinPar

__all__ = ["KaMinParNetworKit", "networkit_to_csr"]


def networkit_to_csr(G) -> CSRGraph:
    """Convert a networkit.Graph (or duck-typed equivalent) to CSRGraph.

    Mirrors KaMinParNetworKit::copyGraph: iterates each node's weighted
    neighborhood; edge weights are rounded to integers (NetworKit stores
    doubles; the reference's CSR variant takes integral adjwgt).
    Directed graphs are rejected — partitioning is defined on undirected
    graphs (the reference asserts the same).
    """
    if getattr(G, "isDirected", lambda: False)():
        raise ValueError("partitioning requires an undirected graph")
    n = int(G.numberOfNodes())
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    cols: list = []
    wgts: list = []
    weighted = bool(getattr(G, "isWeighted", lambda: False)())
    for u in range(n):
        neigh = list(G.iterNeighborsWeights(u)) if weighted else [
            (v, 1) for v in G.iterNeighbors(u)
        ]
        row_ptr[u + 1] = row_ptr[u] + len(neigh)
        cols.extend(int(v) for v, _ in neigh)
        wgts.extend(max(int(round(w)), 1) for _, w in neigh)
    col_idx = np.asarray(cols, dtype=np.int64)
    edge_w = np.asarray(wgts, dtype=np.int64)
    if not weighted:
        edge_w = None
    return from_numpy_csr(row_ptr, col_idx, None, edge_w, validate_input=True)


class KaMinParNetworKit(KaMinPar):
    """KaMinPar facade accepting NetworKit graphs (kaminpar_networkit.h:20).

    Usage::

        import networkit as nk
        G = nk.readGraph("graph.metis", nk.Format.METIS)
        solver = KaMinParNetworKit(G)
        part = solver.compute_partition_k(64)   # list of block ids

    It runs on ``cuda:0`` unless ``device`` names another device.
    """

    def __init__(self, G=None, ctx=None, device=None):
        super().__init__("default" if ctx is None else ctx, device=device)
        if G is not None:
            self.copy_graph(G)

    def copy_graph(self, G) -> None:
        self.set_graph(networkit_to_csr(G))

    # Reference method names, camelCase->snake_case, each returning a
    # plain list of ints (NetworKit's Partition-compatible shape).
    def compute_partition_k(self, k: int) -> list:
        return self.compute_partition(k).tolist()

    def compute_partition_with_epsilon(self, k: int, epsilon: float) -> list:
        return self.compute_partition(k, epsilon=epsilon).tolist()

    def compute_partition_with_factors(
        self, factors: Sequence[float]
    ) -> list:
        """Per-block max weights as factors of the total weight
        (computePartitionWithFactors)."""
        total = int(self.graph.total_node_weight)
        weights = [int(np.ceil(f * total)) for f in factors]
        return self.compute_partition_with_weights(weights)

    def compute_partition_with_weights(
        self, max_block_weights: Sequence[int],
        min_block_weights: Optional[Sequence[int]] = None,
    ) -> list:
        return self.compute_partition(
            len(max_block_weights), max_block_weights=list(max_block_weights),
            # `is not None`, not truthiness: an empty min list must reach the
            # downstream k/length validation as a mismatch, not silently
            # drop the constraint (ADVICE r5 #5).
            min_block_weights=(
                list(min_block_weights) if min_block_weights is not None else None
            ),
        ).tolist()
