"""Degree-bucketed adjacency view: the layout the LP kernels stream.

Counterpart of the host builder of ``kaminpar_tpu/graph/bucketed.py``.
Nodes are grouped by degree into power-of-two width classes (8 ... 4096);
each class is a dense ``(R, w)`` matrix with ``R`` padded to a power of two
(at least 8).  Nodes of degree > MAX_WIDTH go to the heavy part, a flat
slot list rated edge-parallel.

The plan (which node goes to which class) is computed on the host from the
degrees alone; the ``(R, w)`` matrices are gathered with torch on the
graph's device.  The result equals the JAX host builder's, array for array.

Layout conventions:
- pad slots inside a row: ``col = the row's own node id``, weight 0 (an
  inert zero-weight run of the node's own label); heavy pad slots use
  ``col = anchor``;
- pad rows: ``node = anchor``; their results are never gathered, and
  ``real_rows`` (a host integer per bucket) says where they begin, so the
  rating kernel answers them without loading their slots;
- ``gather_idx[u]`` = position of node u's row in the concatenation of
  all bucket rows (buckets in order, then heavy rows).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..utils.intmath import next_pow2

MIN_WIDTH = 8
MAX_WIDTH = 4096
MIN_ROWS = 256


class Bucket(NamedTuple):
    nodes: torch.Tensor  # (R,)   node id per row (pad rows -> anchor)
    cols: torch.Tensor  # (R, w) neighbour ids (pad slots -> own node id)
    wgts: torch.Tensor  # (R, w) edge weights (pad slots -> 0)


class HeavyPart(NamedTuple):
    nodes: torch.Tensor  # (Hr,) heavy node per dense row (pads -> anchor)
    row: torch.Tensor  # (Hs,) dense row index per slot, ascending
    cols: torch.Tensor  # (Hs,) neighbour ids (pads -> anchor)
    wgts: torch.Tensor  # (Hs,) edge weights (pads -> 0)


class BucketedView(NamedTuple):
    buckets: Tuple[Bucket, ...]
    heavy: HeavyPart
    gather_idx: torch.Tensor  # (n,)
    n: int
    real_rows: Tuple[int, ...]  # rows before the pad rows, per bucket

    @property
    def bucket_shapes(self):
        return tuple(tuple(b.cols.shape) for b in self.buckets)

    @property
    def num_rows(self) -> int:
        r = sum(int(b.nodes.shape[0]) for b in self.buckets)
        return r + int(self.heavy.nodes.shape[0])


def node_width_plan(deg: np.ndarray, *, min_width: int = MIN_WIDTH,
                    max_width: int = MAX_WIDTH, min_rows: int = MIN_ROWS):
    """(per-node bucket width, heavy mask).  Width = next power of two >=
    degree, clamped; a class with fewer than ``min_rows`` nodes merges into
    the next naturally occupied class."""
    deg = np.asarray(deg, dtype=np.int64)
    width = np.maximum(
        min_width, 2 ** np.ceil(np.log2(np.maximum(deg, 1))).astype(np.int64)
    )
    heavy_mask = deg > max_width
    width = np.minimum(width, max_width)
    natural = set(int(x) for x in np.unique(width[~heavy_mask]))
    for w in sorted(natural)[:-1]:
        sel = (~heavy_mask) & (width == w)
        cnt = int(sel.sum())
        if 0 < cnt < min_rows:
            bigger = min(x for x in natural if x > w)
            width[sel] = bigger
    return width, heavy_mask


def build_bucketed_view(row_ptr: np.ndarray, col_idx: torch.Tensor,
                        edge_w: torch.Tensor, n: int, anchor: int, *,
                        min_width: int = MIN_WIDTH, max_width: int = MAX_WIDTH,
                        min_rows: int = MIN_ROWS) -> BucketedView:
    """``row_ptr`` on the host (numpy); ``col_idx``/``edge_w`` tensors on
    the device the view is built on."""
    rp = np.asarray(row_ptr, dtype=np.int64)
    col = torch.as_tensor(col_idx)
    ew = torch.as_tensor(edge_w, device=col.device)
    dev = col.device
    idt = torch.int32
    m = int(col.shape[0])
    deg = np.diff(rp[: n + 1])
    width, heavy_mask = node_width_plan(
        deg, min_width=min_width, max_width=max_width, min_rows=min_rows
    )
    rp_t = torch.from_numpy(rp[: n + 1]).to(dev)
    deg_t = torch.from_numpy(deg).to(dev)

    buckets, real_rows = [], []
    offsets = np.zeros(n, dtype=np.int64)
    offset = 0
    for w in sorted(int(x) for x in np.unique(width[~heavy_mask])):
        nodes = np.nonzero((~heavy_mask) & (width == w))[0]
        R = len(nodes)
        R_pad = next_pow2(R, 8)
        real_rows.append(R)
        nodes_t = torch.from_numpy(nodes).to(dev)
        slot = torch.arange(w, dtype=torch.int64, device=dev)
        idx = rp_t[nodes_t][:, None] + slot[None, :]
        valid = slot[None, :] < deg_t[nodes_t][:, None]
        safe = torch.clamp(idx, max=max(m - 1, 0))
        cols_full = torch.full((R_pad, w), anchor, dtype=idt, device=dev)
        wgts_full = torch.zeros((R_pad, w), dtype=idt, device=dev)
        if m:
            cols_full[:R] = torch.where(valid, col[safe], nodes_t[:, None].to(idt))
            wgts_full[:R] = torch.where(valid, ew[safe], torch.zeros((), dtype=idt, device=dev))
        else:
            cols_full[:R] = nodes_t[:, None].to(idt)
        del idx, valid, safe
        nodes_full = torch.full((R_pad,), anchor, dtype=idt, device=dev)
        nodes_full[:R] = nodes_t.to(idt)
        buckets.append(Bucket(nodes_full, cols_full, wgts_full))
        offsets[nodes] = offset + np.arange(R)
        offset += R_pad

    hn = np.nonzero(heavy_mask)[0]
    Hr = len(hn)
    if Hr:
        hdeg = deg[hn]
        Hs = int(hdeg.sum())
        Hr_pad = next_pow2(Hr + 1, 8)  # strictly > Hr: the last row is a pad
        Hs_pad = next_pow2(Hs, 8)
        hrow = np.repeat(np.arange(Hr, dtype=np.int32), hdeg)
        base = np.repeat(rp[hn] - np.concatenate([[0], np.cumsum(hdeg)[:-1]]), hdeg)
        hslots = torch.from_numpy(base + np.arange(Hs, dtype=np.int64)).to(dev)
        hcols = torch.full((Hs_pad,), anchor, dtype=idt, device=dev)
        hw = torch.zeros(Hs_pad, dtype=idt, device=dev)
        hrow_full = np.full(Hs_pad, Hr_pad - 1, dtype=np.int32)
        hrow_full[:Hs] = hrow
        hcols[:Hs] = col[hslots]
        hw[:Hs] = ew[hslots]
        hnodes = np.full(Hr_pad, anchor, dtype=np.int32)
        hnodes[:Hr] = hn
        heavy = HeavyPart(torch.from_numpy(hnodes).to(dev),
                          torch.from_numpy(hrow_full).to(dev), hcols, hw)
        offsets[hn] = offset + np.arange(Hr)
    else:
        z = torch.zeros(0, dtype=idt, device=dev)
        heavy = HeavyPart(z, z, z, z)

    return BucketedView(
        buckets=tuple(buckets),
        heavy=heavy,
        gather_idx=torch.from_numpy(offsets.astype(np.int32)).to(dev),
        n=n,
        real_rows=tuple(real_rows),
    )


def mask_bucketed_view(bv: BucketedView, comm: torch.Tensor, n_pad: int) -> BucketedView:
    """``bv`` with the weight of every slot whose two end nodes lie in
    different communities (``comm``: (n,) int32 per real node) set to 0:
    the layout ``build_bucketed_view`` gives for the masked edge weights,
    regathered through the same plan.  Pad slots and rows keep weight 0
    whatever community their nodes take here."""
    dev = bv.gather_idx.device
    cp = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    cp[: comm.shape[0]] = comm
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    buckets = tuple(
        b._replace(wgts=torch.where(cp[b.nodes][:, None] == cp[b.cols], b.wgts, zero))
        for b in bv.buckets
    )
    h = bv.heavy
    heavy = h._replace(wgts=torch.where(cp[h.nodes[h.row]] == cp[h.cols], h.wgts, zero))
    return bv._replace(buckets=buckets, heavy=heavy)
