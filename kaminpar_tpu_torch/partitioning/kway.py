"""Host materialization of a graph for the host-side initial partitioner
(``graph_to_host`` of ``kaminpar_tpu/partitioning/kway.py``)."""

from __future__ import annotations

import numpy as np
import torch

from ..graph.csr import CSRGraph
from ..initial.bipartitioner import HostCSR


def graph_to_host(graph: CSRGraph) -> HostCSR:
    """The graph's four CSR arrays as int64 numpy arrays, copied from the
    device in one transfer."""
    n, m = graph.n, graph.m
    packed = torch.cat([graph.row_ptr, graph.col_idx, graph.node_w, graph.edge_w])
    packed = packed.cpu().numpy().astype(np.int64)
    return HostCSR(
        packed[: n + 1],
        packed[n + 1 : n + 1 + m],
        packed[n + 1 + m : n + 1 + m + n],
        packed[n + 1 + m + n :],
    )
