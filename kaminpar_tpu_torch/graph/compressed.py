"""Compressed graph representation, the TeraPart storage tier (counterpart
of ``kaminpar_tpu/graph/compressed.py``; host numpy, same encoding bit for
bit).

Each neighbourhood is sorted ascending and stored as gaps: the first
neighbour as a signed delta from the node id, the rest as consecutive
differences, all zig-zag encoded.  Every gap of node u is packed at one
fixed bit width w(u) = bits of u's largest zig-zag gap, back to back into a
shared uint32 word stream, starting at a word boundary.  Decoding one edge
is a gather of (at most) two words plus shifts and masks: no
data-dependent control flow, so the decode fuses into the LP rating kernel
(``csrc/lp_rate.cu``).

Edge weights, when not all 1, are stored uncompressed in decode order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils import sync_stats


def _zigzag(x: np.ndarray) -> np.ndarray:
    return (x << 1) ^ (x >> 63)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return (z >> 1) ^ -(z & 1)


@dataclass
class CompressedGraph:
    n: int
    m: int
    words: np.ndarray  # uint32 packed gap stream
    word_start: np.ndarray  # (n+1,) uint32 word offset per node
    width: np.ndarray  # (n,) uint8 bits per gap
    degree: np.ndarray  # (n,) int32 node degrees
    node_w: np.ndarray  # (n,) int32
    edge_w: object  # None when all 1, else (m,) int32 in decode order

    @property
    def total_node_weight(self) -> int:
        return int(self.node_w.astype(np.int64).sum())

    def memory_bytes(self) -> int:
        b = self.words.nbytes + self.word_start.nbytes + self.width.nbytes
        b += self.degree.nbytes + self.node_w.nbytes
        if self.edge_w is not None:
            b += self.edge_w.nbytes
        return b

    def uncompressed_bytes(self) -> int:
        """CSR (int32) footprint of the same graph."""
        b = 4 * (self.n + 1) + 4 * self.m + 4 * self.n
        if self.edge_w is not None:
            b += 4 * self.m
        return b

    def compression_ratio(self) -> float:
        return self.uncompressed_bytes() / max(self.memory_bytes(), 1)

    def has_uniform_edge_weights(self) -> bool:
        """The rule of ``CSRGraph.has_uniform_edge_weights``."""
        if self.m == 0 or self.edge_w is None:
            return True
        return bool(self.edge_w.min() == self.edge_w.max())

    def decompress(self, device="cpu"):
        """The CSRGraph on ``device``, decoded on the host."""
        from .csr import from_numpy_csr

        return from_numpy_csr(*self.decompress_arrays(), device=device)

    def decompress_arrays(self):
        """Decode to numpy ``(row_ptr, col, node_w, edge_w or None)``."""
        deg = self.degree.astype(np.int64)
        row_ptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(deg, out=row_ptr[1:])
        m = int(row_ptr[-1])
        u_arr = np.repeat(np.arange(self.n), deg)
        pos = np.arange(m) - row_ptr[u_arr]  # gap index within the node

        w = self.width[u_arr].astype(np.int64)
        bit = pos * w
        word0 = self.word_start[u_arr].astype(np.int64) + (bit >> 5)
        shift = bit & 31
        lo = self.words[word0].astype(np.uint64)
        hi = self.words[np.minimum(word0 + 1, len(self.words) - 1)].astype(np.uint64)
        both = lo | (hi << np.uint64(32))
        mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
        z = (both >> shift.astype(np.uint64)) & mask
        gaps = _unzigzag(z.astype(np.int64))

        # the first gap is relative to u; the rest accumulate (a segmented
        # prefix sum: global cumsum minus the value before each row's start)
        vals = np.where(pos == 0, u_arr, 0) + gaps
        c = np.cumsum(vals)
        c_ext = np.concatenate([np.zeros(1, c.dtype), c])
        col = c - np.repeat(c_ext[row_ptr[:-1]], deg)

        if m >= 2**31:
            raise ValueError("edge count exceeds int32")
        return (
            row_ptr.astype(np.int32),
            col.astype(np.int32),
            np.asarray(self.node_w),
            None if self.edge_w is None else np.asarray(self.edge_w),
        )


def compress(graph) -> CompressedGraph:
    """Compress a CSRGraph on the host (its arrays are copied to numpy)."""
    row_ptr = graph.host_row_ptr().astype(np.int64)
    col, ew, node_w = sync_stats.pull(graph.col_idx, graph.edge_w, graph.node_w)
    col = col.astype(np.int64)
    n = graph.n
    deg = np.diff(row_ptr)
    u_arr = np.repeat(np.arange(n), deg)

    # neighbourhoods ascending, stable by (u, v), weights alongside; the
    # sort is skipped when they already are (from_edge_list's output is)
    firsts = np.zeros(len(col), dtype=bool)
    firsts[row_ptr[:-1][deg > 0]] = True
    if not bool(np.all(firsts[1:] | (col[1:] >= col[:-1]))):
        order = np.argsort(u_arr * max(n, 1) + col, kind="stable")
        col = col[order]
        ew = ew[order]
    if bool((ew == 1).all()):
        ew_out = None
    else:
        if int(ew.max(initial=0)) >= 2**31:
            raise ValueError("edge weight exceeds int32")
        ew_out = ew.astype(np.int32)

    # gaps: the first neighbour relative to u (zig-zag for the sign), then
    # consecutive differences
    prev = np.concatenate([[0], col[:-1]])
    z = _zigzag(np.where(firsts, col - u_arr, col - prev))

    # per-node width = bits of the largest zig-zag gap (at least 1)
    width = np.ones(n, dtype=np.int64)
    if len(z):
        # rows are contiguous: a max over each non-empty row's slice
        zmax = np.zeros(n, dtype=np.int64)
        zmax[deg > 0] = np.maximum.reduceat(z, row_ptr[:-1][deg > 0])
        width = np.maximum(
            np.ceil(np.log2(np.maximum(zmax, 1) + 1)).astype(np.int64), 1
        )
    if int(width.max(initial=1)) > 32:
        raise ValueError("neighbourhood gap exceeds 32 bits")

    words_per_node = (width * deg + 31) // 32
    word_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(words_per_node, out=word_start[1:])
    total_words = int(word_start[-1]) + 1  # +1 sentinel for straddle reads

    # Pack: each gap lands in one word, or straddles into the next.  The
    # bit fields of one word never overlap, so OR equals a sum, and a
    # float64 bincount is exact (every word stays below 2^32 < 2^53).
    w_e = width[u_arr]
    bit = (np.arange(len(z)) - row_ptr[u_arr]) * w_e
    word0 = word_start[u_arr] + (bit >> 5)
    shift = bit & 31
    lo_part = (z << shift) & 0xFFFFFFFF
    words = np.bincount(word0, weights=lo_part, minlength=total_words)
    straddle = shift + w_e > 32
    if straddle.any():
        hi_part = z[straddle] >> (32 - shift[straddle])
        words += np.bincount(word0[straddle] + 1, weights=hi_part,
                             minlength=total_words)

    return CompressedGraph(
        n=n,
        m=int(deg.sum()),
        words=words.astype(np.uint32),
        word_start=word_start.astype(np.uint32),
        width=width.astype(np.uint8),
        degree=deg.astype(np.int32),
        node_w=node_w.astype(np.int32),
        edge_w=ew_out,
    )
