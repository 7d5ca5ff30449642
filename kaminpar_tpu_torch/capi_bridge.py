"""Python side of the C API (counterpart of ``kaminpar_tpu/capi_bridge.py``;
``capi/kaminpar_tpu_c.cc`` calls into this).

The embedded-C shim only juggles memoryviews and opaque handles; everything
with semantics lives here so it is testable from Python and the C layer
stays a thin marshalling skin.  Counterpart role: the reference's
ckaminpar.cc, which likewise adapts buffer-style C arguments onto the C++
facade.  C callers pass no device, so they run on ``cuda:0`` (and fail
without CUDA, as the facade does); Python callers may pass ``device``.
"""

from __future__ import annotations

import numpy as np

from .graph.csr import from_numpy_csr
from .graph.metrics import edge_cut
from .kaminpar import KaMinPar
from .utils.logger import Logger, OutputLevel

__all__ = ["CSolver", "set_output_level"]


def set_output_level(level: int) -> None:
    Logger.level = OutputLevel(int(level))


class CSolver:
    """One C-side solver handle: facade + pending balance constraints."""

    def __init__(self, preset: str, device=None):
        self.kp = KaMinPar(preset, device=device)
        self.n = 0
        self.max_block_weights = None
        self.min_block_weights = None

    def set_seed(self, seed: int) -> None:
        self.kp.ctx.seed = int(seed)

    def copy_graph(self, n, xadj_mv, adjncy_mv, vwgt_mv, adjwgt_mv) -> None:
        n = int(n)
        row_ptr = np.frombuffer(xadj_mv, dtype=np.uint64).copy()
        if row_ptr.shape[0] != n + 1:
            raise ValueError(f"xadj must have n+1={n + 1} entries")
        m = int(row_ptr[-1])
        col = np.frombuffer(adjncy_mv, dtype=np.uint32).copy()
        if col.shape[0] != m:
            raise ValueError(f"adjncy must have xadj[n]={m} entries")
        node_w = (
            np.frombuffer(vwgt_mv, dtype=np.int64).copy()
            if vwgt_mv is not None else None
        )
        edge_w = (
            np.frombuffer(adjwgt_mv, dtype=np.int64).copy()
            if adjwgt_mv is not None else None
        )
        # The port's graphs are int32: values beyond that range raise
        # instead of wrapping.
        self.kp.set_graph(from_numpy_csr(row_ptr, col, node_w, edge_w,
                                         validate_input=True))
        self.n = n

    def set_max_block_weights(self, k, mv) -> None:
        w = np.frombuffer(mv, dtype=np.int64).copy()
        if w.shape[0] != int(k):
            raise ValueError(f"expected {int(k)} block weights, got {w.shape[0]}")
        self.max_block_weights = [int(x) for x in w]

    def set_min_block_weights(self, k, mv) -> None:
        w = np.frombuffer(mv, dtype=np.int64).copy()
        if w.shape[0] != int(k):
            raise ValueError(f"expected {int(k)} block weights, got {w.shape[0]}")
        self.min_block_weights = [int(x) for x in w]

    def clear_block_weights(self) -> None:
        self.max_block_weights = None
        self.min_block_weights = None

    def compute(self, k, epsilon, out_mv) -> int:
        if self.n == 0:
            raise RuntimeError("no graph set (call kptpu_copy_graph first)")
        for name, bw in (("max", self.max_block_weights),
                         ("min", self.min_block_weights)):
            if bw is not None and len(bw) != int(k):
                raise ValueError(
                    f"{name}_block_weights has {len(bw)} entries but k={int(k)}"
                )
        out = np.frombuffer(out_mv, dtype=np.uint32)
        if out.shape[0] != self.n:  # fail before the multi-second pipeline
            raise ValueError(
                f"partition buffer holds {out.shape[0]} ids, graph has {self.n}"
            )
        part = self.kp.compute_partition(
            int(k), epsilon=float(epsilon),
            max_block_weights=self.max_block_weights,
            min_block_weights=self.min_block_weights,
        )
        out[:] = np.asarray(part, dtype=np.uint32)
        return int(edge_cut(self.kp.graph, part))
