"""Graph + partition IO — public API (counterpart of ``kaminpar_tpu/io/``).

Mirrors ``include/kaminpar-io/kaminpar_io.h:22-54``: ``read_graph(path,
format)`` with auto-detection, ``write_graph``, and partition read/write
(one block id per line, the de-facto experiment interface used by the
reference's refinement benchmark, kaminpar_io.h:46-52).  Readers return
the graph in host memory; ``KaMinPar.set_graph`` places it on the solver's
device.  Writers take a graph on any device.
"""

from __future__ import annotations

import enum
import os

import numpy as np

from ..graph.csr import CSRGraph
from .compressed_io import read_compressed, write_compressed
from .metis import read_metis, write_metis
from .parhip import read_parhip, write_parhip


class GraphFileFormat(enum.Enum):
    METIS = "metis"
    PARHIP = "parhip"
    # compressed binary (reference: graph_compression_binary.cc; ours is the
    # fixed-width gap-packed scheme — io/compressed_io.py)
    COMPRESSED = "compressed"


def _detect(path: str) -> GraphFileFormat:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".parhip", ".bgf", ".bin"):
        return GraphFileFormat.PARHIP
    if ext in (".metis", ".graph"):
        return GraphFileFormat.METIS
    if ext in (".npz", ".compressed"):
        return GraphFileFormat.COMPRESSED
    # sniff: a ParHIP header's first 8 bytes are a small bitmask (< 64)
    with open(path, "rb") as f:
        head = f.read(8)
    if len(head) == 8:
        v = int(np.frombuffer(head, dtype=np.uint64)[0])
        if v < 64:
            return GraphFileFormat.PARHIP
    return GraphFileFormat.METIS


def read_graph(
    path: str,
    file_format: GraphFileFormat | str | None = None,
    *,
    use_64bit: bool = False,
    decompress: bool = False,
):
    """Returns a CSRGraph — or, for the COMPRESSED format, a CompressedGraph
    (the facade partitions it directly without materializing the CSR;
    reference: read_graph's compress flag, kaminpar_io.h:22-54).  Pass
    ``decompress=True`` when the caller needs CSR arrays unconditionally."""
    if file_format is None:
        file_format = _detect(path)
    elif isinstance(file_format, str):
        file_format = GraphFileFormat(file_format.lower())
    if file_format == GraphFileFormat.METIS:
        return read_metis(path, use_64bit=use_64bit)
    if file_format == GraphFileFormat.COMPRESSED:
        cg = read_compressed(path)
        return cg.decompress() if decompress else cg
    return read_parhip(path, use_64bit=use_64bit)


def write_graph(
    graph: CSRGraph,
    path: str,
    file_format: GraphFileFormat | str | None = None,
    *,
    use_64bit: bool = False,
) -> None:
    if file_format is None:
        ext = os.path.splitext(path)[1].lower()
        if ext in (".parhip", ".bgf", ".bin"):
            file_format = GraphFileFormat.PARHIP
        elif ext in (".npz", ".compressed"):
            file_format = GraphFileFormat.COMPRESSED
        else:
            file_format = GraphFileFormat.METIS
    elif isinstance(file_format, str):
        file_format = GraphFileFormat(file_format.lower())
    if file_format == GraphFileFormat.METIS:
        write_metis(graph, path)
    elif file_format == GraphFileFormat.COMPRESSED:
        write_compressed(graph, path)
    else:
        write_parhip(graph, path, use_64bit=use_64bit)


def write_partition(path: str, partition) -> None:
    np.savetxt(path, np.asarray(partition, dtype=np.int64), fmt="%d")


def read_partition(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.int64).reshape(-1)


def write_block_sizes(path: str, k: int, partition, node_weights=None) -> None:
    """Per-block total node weight (node count when unweighted).
    Reference: write_block_sizes (kaminpar_io.h:50)."""
    part = np.asarray(partition, dtype=np.int64)
    w = None if node_weights is None else np.asarray(node_weights, dtype=np.int64)
    sizes = np.bincount(part, weights=w, minlength=k)
    np.savetxt(path, sizes.astype(np.int64), fmt="%d")


__all__ = [
    "GraphFileFormat", "read_compressed", "read_graph", "read_metis", "read_parhip",
    "read_partition", "write_block_sizes", "write_compressed", "write_graph",
    "write_metis", "write_parhip", "write_partition",
]
