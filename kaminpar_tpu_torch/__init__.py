"""PyTorch/CUDA port of the deep multilevel graph partitioner.

The package mirrors ``kaminpar_tpu`` module for module.  It imports torch
and numpy only.  The LP round's two hand-written CUDA kernels
(``csrc/lp_rate.cu``, ``csrc/lp_commit.cu``) run on CUDA tensors; on CPU
tensors their plain PyTorch versions run (``ops/lp_kernels.py``).
"""

from .context import Context
from .graph.csr import CSRGraph, from_edge_list, from_numpy_csr
from .kaminpar import KaMinPar
from .presets import create_context_by_preset_name

__all__ = [
    "CSRGraph",
    "Context",
    "KaMinPar",
    "create_context_by_preset_name",
    "from_edge_list",
    "from_numpy_csr",
]
