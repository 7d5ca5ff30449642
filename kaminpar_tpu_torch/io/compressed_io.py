"""Compressed-graph binary format (counterpart of
``kaminpar_tpu/io/compressed_io.py``; the same container, key for key).

Reference: ``kaminpar-io/graph_compression_binary.cc`` — serialize the
in-memory compressed graph so huge inputs are compressed once and loaded
directly in compressed form (the TeraPart storage tier never materializes
the CSR).  The container is a magic-tagged ``.npz`` holding the
fixed-width gap-packing arrays of :class:`..graph.compressed.CompressedGraph`.
"""

from __future__ import annotations

import numpy as np

from ..graph.compressed import CompressedGraph, compress
from ..graph.csr import CSRGraph

MAGIC = "kaminpar-tpu-compressed-v1"


def write_compressed(graph, path: str) -> None:
    """Serialize a CompressedGraph (or compress a CSRGraph first)."""
    if isinstance(graph, CSRGraph):
        graph = compress(graph)
    if not isinstance(graph, CompressedGraph):
        raise TypeError(f"expected a CSRGraph or CompressedGraph, got {type(graph).__name__}")
    payload = {
        "magic": np.array(MAGIC),
        "n": np.int64(graph.n),
        "m": np.int64(graph.m),
        "words": graph.words,
        "word_start": graph.word_start,
        "width": graph.width,
        "degree": graph.degree,
        "node_w": graph.node_w,
    }
    if graph.edge_w is not None:
        payload["edge_w"] = graph.edge_w
    with open(path, "wb") as fh:
        np.savez_compressed(fh, **payload)


def read_compressed(path: str) -> CompressedGraph:
    """Load a CompressedGraph in host memory; ``KaMinPar.set_graph`` takes
    it as it is (the facade partitions compressed inputs without holding
    the CSR)."""
    with np.load(path, allow_pickle=False) as z:
        if "magic" not in z or str(z["magic"]) != MAGIC:
            raise ValueError(f"{path}: not a {MAGIC} file")
        return CompressedGraph(
            n=int(z["n"]),
            m=int(z["m"]),
            words=z["words"],
            word_start=z["word_start"],
            width=z["width"],
            degree=z["degree"],
            node_w=z["node_w"],
            edge_w=z["edge_w"] if "edge_w" in z else None,
        )
