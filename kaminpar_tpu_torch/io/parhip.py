"""ParHIP graph format (binary) reader/writer (counterpart of
``kaminpar_tpu/io/parhip.py``; byte-identical files).

Reference: ``kaminpar-io/parhip_parser.cc`` — header of 3 uint64s
(version-bitflags, n, m) where a version bit of **0** means the feature is
present/64-bit (parhip_parser.cc:82-93):

    bit 0: edge weights present      bit 3: 64-bit node ids
    bit 1: node weights present      bit 4: 64-bit node weights
    bit 2: 64-bit edge ids           bit 5: 64-bit edge weights

Layout after the header: xadj[n+1] (edge-id width; entries are **byte
offsets** into the file, based at the start of the adjncy section,
parhip_parser.cc:111-114), adjncy[m] (node-id width), node weights [n],
edge weights [m].  Read by a direct cast of an ``np.memmap``.  The graph
comes back in host memory, in the port's int32 (a file beyond that range
raises ``ValueError``, whatever ``use_64bit`` says).
"""

from __future__ import annotations

import numpy as np

from ..graph.csr import CSRGraph, from_numpy_csr
from ..partitioning.kway import graph_to_host

_HDR = 24  # 3 * uint64


def read_parhip(path: str, *, use_64bit: bool = False) -> CSRGraph:
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    version, n, m = np.frombuffer(raw[:_HDR], dtype=np.uint64)
    version, n, m = int(version), int(n), int(m)
    has_ew = (version & 1) == 0
    has_nw = (version & 2) == 0
    eid_w = 8 if (version & 4) == 0 else 4
    nid_w = 8 if (version & 8) == 0 else 4
    nw_w = 8 if (version & 16) == 0 else 4
    ew_w = 8 if (version & 32) == 0 else 4
    eid_t = np.uint64 if eid_w == 8 else np.uint32
    nid_t = np.uint64 if nid_w == 8 else np.uint32
    nw_t = np.int64 if nw_w == 8 else np.int32
    ew_t = np.int64 if ew_w == 8 else np.int32

    off = _HDR
    xadj_bytes = np.frombuffer(raw[off : off + (n + 1) * eid_w], dtype=eid_t)
    off += (n + 1) * eid_w
    adj_base = off
    adjncy = np.frombuffer(raw[off : off + m * nid_w], dtype=nid_t)
    off += m * nid_w
    # the weights are copied: the graph must not alias the mapped file
    node_w = None
    if has_nw:
        node_w = np.frombuffer(raw[off : off + n * nw_w], dtype=nw_t).copy()
        off += n * nw_w
    edge_w = None
    if has_ew:
        edge_w = np.frombuffer(raw[off : off + m * ew_w], dtype=ew_t).copy()

    # xadj entries are byte offsets based at the adjncy section
    row_ptr = (xadj_bytes.astype(np.int64) - adj_base) // nid_w
    return from_numpy_csr(row_ptr, adjncy.astype(np.int64), node_w, edge_w,
                          validate_input=True)


def write_parhip(graph: CSRGraph, path: str, *, use_64bit: bool = False) -> None:
    rp, col, nw, ew = graph_to_host(graph)
    has_nw = not np.all(nw == 1)
    has_ew = not np.all(ew == 1)
    n, m = graph.n, graph.m
    width = 8 if use_64bit else 4
    eid_t = np.uint64 if use_64bit else np.uint32
    nid_t = np.uint64 if use_64bit else np.uint32
    w_t = np.int64 if use_64bit else np.int32

    # version bit = 0 means present/64-bit (see module docstring)
    version = 0
    if not has_ew:
        version |= 1
    if not has_nw:
        version |= 2
    if not use_64bit:
        version |= 4 | 8 | 16 | 32

    adj_base = _HDR + (n + 1) * width
    if not use_64bit:
        # astype would silently wrap; the reference hard-fails on width
        # mismatch (ParHIPHeader::validate), so raise rather than corrupt.
        max_off = adj_base + int(rp[-1]) * width
        if max_off > 2**32 - 1 or (n and n > 2**32 - 1):
            raise ValueError("graph too large for 32-bit ParHIP; pass use_64bit=True")
        for name, arr, lim in (
            ("node weight", nw, 2**31 - 1),
            ("edge weight", ew, 2**31 - 1),
        ):
            if arr.size and int(arr.max()) > lim:
                raise ValueError(
                    f"{name} exceeds 32-bit range; pass use_64bit=True"
                )
    with open(path, "wb") as f:
        f.write(np.array([version, n, m], dtype=np.uint64).tobytes())
        f.write((adj_base + rp * width).astype(eid_t).tobytes())
        f.write(col.astype(nid_t).tobytes())
        if has_nw:
            f.write(nw.astype(w_t).tobytes())
        if has_ew:
            f.write(ew.astype(w_t).tobytes())
