"""Device-resident compressed graph view, the TeraPart compute tier
(counterpart of ``kaminpar_tpu/graph/device_compressed.py``).

:class:`DeviceCompressedView` keeps the packed word stream and per-node
``(word_start, width, degree, node_w)`` on the device, padded like the
dense ``PaddedView`` of the same graph (same ``n_pad``/``m_pad``, so LP
states share shapes with the dense path).  Its *compressed bucketed
layout* groups nodes into the dense layout's degree buckets (same plan,
same ``R_pad``, same ``gather_idx``), but a bucket row stores only
``(node, word_start, width, degree, edge_start)``: the ``(R, w)`` neighbour
matrix is decoded inside the rating kernel (``csrc/lp_rate.cu``,
``kp_rate_compressed_bucket``) and never exists in device memory.  Heavy
rows (degree > MAX_WIDTH) stay dense, as in the dense layout.

The decode functions here are plain torch: :func:`decode_rows` is the
kernel's decode (its plain version decodes, then rates), and
:func:`decode_flat_padded` feeds the level-0 contraction and the finest
re-materialisation.  Decoded arrays equal the dense layout of the
decompressed graph bit for bit, so ``device_decode="finest"`` partitions
equal ``"off"`` ones.

The packed words are held as int32 bit patterns (torch has no full uint32
arithmetic); the kernel reads them as uint32.

Envelope: the port has LP clustering and 32-bit ids only, so every graph
with edges in the int32 range is inside it; anything outside raises.
There is no dense fallback.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..resilience.faults import maybe_inject
from ..utils.intmath import next_pow2, next_shape_bucket
from .bucketed import HeavyPart, node_width_plan
from .compressed import CompressedGraph
from .csr import CSRGraph, PaddedView, _next_bucket

DEVICE_DECODE_MODES = ("off", "finest", "auto")


class CompressedStream(NamedTuple):
    """The device-resident byte streams: packed gap words plus the
    uncompressed edge-weight side stream, a (1,) dummy when every weight
    is 1."""

    words: torch.Tensor  # (W_pad,) int32 bit patterns of the uint32 words
    edge_w: torch.Tensor  # (m_pad,) weights in decode order, or (1,) dummy

    @property
    def weighted(self) -> bool:
        return int(self.edge_w.shape[0]) > 1


class CompressedBucket(NamedTuple):
    """One degree bucket of width ``w``: per-row decode metadata instead
    of the dense (R, w) neighbour matrix."""

    nodes: torch.Tensor  # (R,) node id per row (pad rows -> anchor)
    wstart: torch.Tensor  # (R,) first word of the row's gap stream
    width: torch.Tensor  # (R,) bits per gap (pad rows -> 1)
    deg: torch.Tensor  # (R,) degree (pad rows -> 0)
    estart: torch.Tensor  # (R,) first edge slot (weight-stream base)
    w: int  # slots per row


# -- decode (plain torch) ------------------------------------------------------


def _funnel_unpack(words: torch.Tensor, w0, bit_in_word, wd) -> torch.Tensor:
    """The ``wd``-bit zig-zag value starting at bit ``bit_in_word`` of word
    ``w0`` (clipped to ``[0, len - 2]``), as the signed int64 gap."""
    s0 = torch.clamp(w0, 0, words.shape[0] - 2).long()
    lo = words[s0].long() & 0xFFFFFFFF
    hi = words[s0 + 1].long() & 0xFFFFFFFF
    # Bits [sh, sh + wd) of hi:lo never reach bit 63, so the arithmetic
    # shift of the signed 64-bit concatenation is exact.
    z = ((lo | (hi << 32)) >> bit_in_word.long()) & ((1 << wd.long()) - 1)
    return (z >> 1) ^ -(z & 1)


def decode_rows(stream: CompressedStream, nodes, wstart, width, deg, estart,
                w: int):
    """The (R, w) ``(cols, wgts)`` of bucket rows, decoded from the word
    stream: per slot a two-word gather, shift and mask, zig-zag decode,
    then a row cumsum (the first gap is relative to the node id).  Pad
    slots are ``col = node`` with weight 0, as in the dense layout."""
    slot = torch.arange(w, dtype=torch.int64, device=nodes.device)[None, :]
    wd = width.long()[:, None]
    bit = slot * wd
    gap = _funnel_unpack(stream.words, wstart.long()[:, None] + (bit >> 5),
                         bit & 31, wd)
    valid = slot < deg.long()[:, None]
    node = nodes.long()[:, None]
    vals = torch.where(valid, torch.where(slot == 0, node + gap, gap),
                       torch.zeros((), dtype=torch.int64, device=nodes.device))
    cols = torch.where(valid, torch.cumsum(vals, dim=1), node).to(torch.int32)
    if stream.weighted:
        eidx = torch.clamp(estart.long()[:, None] + slot, 0, stream.edge_w.shape[0] - 1)
        wgts = torch.where(valid, stream.edge_w[eidx],
                           torch.zeros((), dtype=torch.int32, device=nodes.device))
    else:
        wgts = valid.to(torch.int32)
    return cols, wgts


def decode_bucket(stream: CompressedStream, cb: CompressedBucket):
    """(cols, wgts) of one :class:`CompressedBucket` (see decode_rows)."""
    return decode_rows(stream, cb.nodes, cb.wstart, cb.width, cb.deg, cb.estart, cb.w)


# Edges per step of the flat decode: bounds its int64 temporaries to a few
# hundred MB while the m-sized arrays stay int32.
DECODE_CHUNK = 1 << 24


def decode_flat_padded(stream: CompressedStream, wstart, width, deg, *, m: int,
                       m_pad: int):
    """``(row_ptr, col_idx, edge_w, edge_u)`` of the whole graph (``m``
    edges), padded exactly like the dense ``CSRGraph.padded()`` of the
    decompressed graph: pad edges are weight-0 self-loops on the anchor
    (the last node), whose row_ptr entry closes at ``m_pad``.

    The gaps are unpacked in chunks of ``DECODE_CHUNK`` edges; the column
    ids are a segmented prefix sum in int32: the global cumsum minus its
    value just before each row's start.  The cumsum wraps modulo 2^32, as
    in the JAX package, and the difference is exact because every column
    id fits in int32."""
    dev = deg.device
    i64, i32 = torch.int64, torch.int32
    n_pad = int(deg.shape[0])
    anchor = n_pad - 1
    rp = torch.cat([torch.zeros(1, dtype=i64, device=dev), torch.cumsum(deg, 0, dtype=i64)])
    eu = torch.full((m_pad,), anchor, dtype=i32, device=dev)
    eu[:m] = torch.repeat_interleave(torch.arange(n_pad, dtype=i32, device=dev),
                                     deg.long(), output_size=m)
    vals = torch.empty(m, dtype=i32, device=dev)
    for s in range(0, m, DECODE_CHUNK):
        u = eu[s: min(s + DECODE_CHUNK, m)].long()
        pos = torch.arange(s, s + u.shape[0], dtype=i64, device=dev) - rp[u]
        wd = width[u].long()
        bit = pos * wd
        gap = _funnel_unpack(stream.words, wstart[u].long() + (bit >> 5), bit & 31, wd)
        vals[s: s + u.shape[0]] = torch.where(pos == 0, u + gap, gap).to(i32)
        del u, pos, wd, bit, gap
    c = torch.cumsum(vals, 0, dtype=i32)
    del vals
    before = torch.cat([torch.zeros(1, dtype=i32, device=dev), c])[rp[:-1]]
    col = torch.full((m_pad,), anchor, dtype=i32, device=dev)
    col[:m] = c
    del c
    col[:m] -= before[eu[:m]]
    del before
    ew = torch.zeros(m_pad, dtype=i32, device=dev)
    ew[:m] = stream.edge_w[:m] if stream.weighted else 1
    row_ptr = rp.to(i32)
    row_ptr[-1] = m_pad
    return row_ptr, col, ew, eu


def _decode_neighbors_host(cg: CompressedGraph, nodes: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """The concatenated (ascending) neighbour lists of ``nodes``, decoded on
    the host, and their edge slots (for the weight side stream): the heavy
    rows at view build."""
    deg_all = cg.degree.astype(np.int64)
    rp_all = np.concatenate([[0], np.cumsum(deg_all)])
    deg = deg_all[nodes]
    total = int(deg.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    u_arr = np.repeat(nodes.astype(np.int64), deg)
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    pos = np.arange(total) - np.repeat(starts, deg)
    slots = np.repeat(rp_all[nodes], deg) + pos
    w = cg.width[u_arr].astype(np.int64)
    bit = pos * w
    word0 = cg.word_start[u_arr].astype(np.int64) + (bit >> 5)
    lo = cg.words[word0].astype(np.uint64)
    hi = cg.words[np.minimum(word0 + 1, len(cg.words) - 1)].astype(np.uint64)
    mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
    z = (((lo | (hi << np.uint64(32))) >> (bit & 31).astype(np.uint64)) & mask).astype(np.int64)
    gaps = (z >> 1) ^ -(z & 1)
    c = np.cumsum(np.where(pos == 0, u_arr + gaps, gaps))
    c_ext = np.concatenate([np.zeros(1, c.dtype), c])
    return c - np.repeat(c_ext[starts], deg), slots


class DeviceCompressedView:
    """The compressed graph and its compressed bucketed layout on ``device``.

    Resident: the :class:`CompressedStream`, per-node ``node_w / degree /
    wstart / width`` (``n_pad``, as the dense PaddedView), the per-bucket
    row metadata, the dense heavy part and ``gather_idx``.  ``real_rows``
    (host integers) counts each bucket's rows before its pad rows, as the
    dense ``BucketedView.real_rows`` does.  The m-sized
    structural arrays (col_idx, edge_u, the bucketed neighbour matrices)
    exist only inside the kernels and the level-0 contraction.
    """

    def __init__(self, cg: CompressedGraph, device):
        self.device = torch.device(device)
        self.cg = cg
        self.n = int(cg.n)
        self.m = int(cg.m)
        self.n_pad = _next_bucket(self.n)
        self.m_pad = _next_bucket(self.m)
        deg = cg.degree.astype(np.int64)
        node_w = np.asarray(cg.node_w).astype(np.int32)
        wstart = cg.word_start[: self.n].astype(np.int64)
        width = cg.width.astype(np.int64)

        # The word stream gets its own shape bucket, strictly above its
        # length, so the straddle read at +1 stays in bounds.
        words = np.zeros(next_shape_bucket(len(cg.words) + 1, 256), dtype=np.uint32)
        words[: len(cg.words)] = cg.words
        if cg.edge_w is None:
            ew = np.zeros(1, dtype=np.int32)
        else:
            ew = np.zeros(self.m_pad, dtype=np.int32)
            ew[: self.m] = cg.edge_w
        self.stream = CompressedStream(self._put(words.view(np.int32)), self._put(ew))

        fill = self.n_pad - self.n

        def node_array(x, pad_value):
            return self._put(np.concatenate(
                [x.astype(np.int32), np.full(fill, pad_value, dtype=np.int32)]))

        self.node_w_pad = node_array(node_w, 0)
        self.degree_pad = node_array(deg, 0)
        self.wstart_pad = node_array(wstart, 0)
        self.width_pad = node_array(width, 1)
        self.buckets, self.heavy, self.gather_idx, self.real_rows = self._build_buckets(
            deg, wstart, width)
        self.total_node_weight = int(node_w.astype(np.int64).sum())
        self.max_node_weight = int(node_w.max(initial=0))
        self.total_edge_weight = (self.m if cg.edge_w is None
                                  else int(cg.edge_w.astype(np.int64).sum()))
        self._row_ptr = None

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    @property
    def anchor(self) -> int:
        return self.n_pad - 1

    @property
    def bucket_shapes(self):
        return tuple((int(cb.nodes.shape[0]), cb.w) for cb in self.buckets)

    def _build_buckets(self, deg, wstart, width):
        """The dense layout's bucket plan (``bucketed.node_width_plan``, same
        ascending node order, ``R_pad`` and ``gather_idx``) with per-row
        decode metadata."""
        n, anchor = self.n, self.anchor
        erp = np.concatenate([[0], np.cumsum(deg)])  # decode-order row_ptr
        bwidth, heavy_mask = node_width_plan(deg)
        buckets, real_rows = [], []
        offsets = np.zeros(n, dtype=np.int64)
        offset = 0
        for w in sorted(int(x) for x in np.unique(bwidth[~heavy_mask])):
            nodes = np.nonzero((~heavy_mask) & (bwidth == w))[0]
            R = len(nodes)
            R_pad = next_pow2(R, 8)
            real_rows.append(R)

            def rows(values, pad_value):
                out = np.full(R_pad, pad_value, dtype=np.int32)
                out[:R] = values
                return self._put(out)

            buckets.append(CompressedBucket(
                rows(nodes, anchor), rows(wstart[nodes], 0), rows(width[nodes], 1),
                rows(deg[nodes], 0), rows(erp[nodes], 0), w,
            ))
            offsets[nodes] = offset + np.arange(R)
            offset += R_pad

        hn = np.nonzero(heavy_mask)[0]
        Hr = len(hn)
        if Hr:
            hdeg = deg[hn]
            Hs = int(hdeg.sum())
            Hr_pad = next_pow2(Hr + 1, 8)  # strictly > Hr: the last row is a pad
            Hs_pad = next_pow2(Hs, 8)
            hcols = np.full(Hs_pad, anchor, dtype=np.int32)
            hw = np.zeros(Hs_pad, dtype=np.int32)
            hrow = np.full(Hs_pad, Hr_pad - 1, dtype=np.int32)
            cols, slots = _decode_neighbors_host(self.cg, hn)
            hcols[:Hs] = cols
            hw[:Hs] = 1 if self.cg.edge_w is None else self.cg.edge_w[slots]
            hrow[:Hs] = np.repeat(np.arange(Hr, dtype=np.int32), hdeg)
            hnodes = np.full(Hr_pad, anchor, dtype=np.int32)
            hnodes[:Hr] = hn
            heavy = HeavyPart(self._put(hnodes), self._put(hrow), self._put(hcols),
                              self._put(hw))
            offsets[hn] = offset + np.arange(Hr)
        else:
            z = torch.zeros(0, dtype=torch.int32, device=self.device)
            heavy = HeavyPart(z, z, z, z)
        return (tuple(buckets), heavy, self._put(offsets.astype(np.int32)),
                tuple(real_rows))

    def row_ptr_like(self) -> torch.Tensor:
        """(n_pad + 1,) twin of the dense PaddedView's row_ptr (cached; the
        isolated-node pass reads its degrees)."""
        if self._row_ptr is None:
            rp = torch.cat([torch.zeros(1, dtype=torch.int32, device=self.device),
                            torch.cumsum(self.degree_pad, 0, dtype=torch.int32)])
            rp[-1] = self.m_pad
            self._row_ptr = rp
        return self._row_ptr

    def resident_bytes(self) -> int:
        """Device bytes of the compressed adjacency tier (the finest level's
        steady-state footprint under device decode)."""
        arrays = [*self.stream, self.node_w_pad, self.degree_pad, self.wstart_pad,
                  self.width_pad, self.gather_idx, *self.heavy]
        for cb in self.buckets:
            arrays += [cb.nodes, cb.wstart, cb.width, cb.deg, cb.estart]
        return sum(a.numel() * a.element_size() for a in arrays)

    def dense_resident_bytes(self) -> int:
        """Bytes the dense path keeps resident for the same level: the padded
        CSR (row_ptr, col, edge_w, edge_u, node_w) and the dense bucketed
        layout (cols, wgts, nodes per bucket; the heavy part; gather_idx)."""
        csr = 4 * (self.n_pad + 1 + self.n_pad + 3 * self.m_pad)
        slots = sum(R * w for R, w in self.bucket_shapes)
        bucketed = 4 * (2 * slots + self.n_pad) + sum(4 * a.numel() for a in self.heavy)
        return csr + bucketed

    def materialize_csr(self) -> CSRGraph:
        """The finest CSR, decoded on the device (no host round trip).  The
        graph carries ``_compressed_view = self``, so the finest LP
        refinement pass rates off the compressed stream."""
        rp, col, ew, eu = decode_flat_padded(
            self.stream, self.wstart_pad, self.width_pad, self.degree_pad,
            m=self.m, m_pad=self.m_pad,
        )
        n, m = self.n, self.m
        g = CSRGraph(rp[: n + 1], col[:m], self.node_w_pad[:n], ew[:m], edge_u=eu[:m],
                     device=self.device)
        g._padded = PaddedView(rp, col, self.node_w_pad, ew, eu, n, m)
        rp_host = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(self.cg.degree.astype(np.int64), out=rp_host[1:])
        g._host_row_ptr = rp_host
        g._total_node_weight = self.total_node_weight
        g._max_node_weight = self.max_node_weight
        g._compressed_view = self
        return g


# -- routing -------------------------------------------------------------------


def resolve_device_decode(mode: str) -> str:
    """``GraphCompressionContext.device_decode`` as a concrete mode: "off"
    or "finest" ("auto" is "finest": the port is always inside the
    envelope)."""
    if mode not in DEVICE_DECODE_MODES:
        raise ValueError(f"device_decode must be one of {DEVICE_DECODE_MODES}, got {mode!r}")
    return "finest" if mode == "auto" else mode


def check_device_decode_envelope(cg: CompressedGraph) -> None:
    """Raise ``NotImplementedError`` naming the reason when the finest
    level cannot run off the compressed stream."""
    if cg.n == 0:
        raise NotImplementedError("device decode: the graph is empty")
    if cg.m >= 2**31 or cg.n >= 2**31 - 1:
        raise NotImplementedError("device decode: the graph exceeds 32-bit ids")


def build_device_view(compression_ctx, cg: CompressedGraph, device):
    """The deep partitioner's switch: a :class:`DeviceCompressedView` on
    ``device`` under "finest"/"auto", None under "off"."""
    if resolve_device_decode(compression_ctx.device_decode) == "off":
        return None
    check_device_decode_envelope(cg)
    # The "execute" fault-injection point of the device-decode gate; an
    # injected fault stops the run (no demotion to the dense path).
    maybe_inject("execute", site="device_decode")
    return DeviceCompressedView(cg, device)
