"""Component factories: refinement enum list -> refiner pipeline, mode ->
partitioner (counterpart of ``kaminpar_tpu/factories.py``)."""

from __future__ import annotations

from typing import Optional

from .context import Context, PartitioningMode, RefinementAlgorithm
from .graph.compressed import CompressedGraph
from .graph.csr import CSRGraph
from .refinement.balancer import OverloadBalancer, UnderloadBalancer
from .refinement.lp_refiner import LPRefiner
from .refinement.refiner import MultiRefiner, NoopRefiner, Refiner


def create_refiner(ctx: Context) -> Refiner:
    refiners = []
    for algo in ctx.refinement.algorithms:
        if algo == RefinementAlgorithm.NOOP:
            continue
        if algo == RefinementAlgorithm.LP:
            refiners.append(LPRefiner(ctx.refinement.lp))
        elif algo == RefinementAlgorithm.OVERLOAD_BALANCER:
            refiners.append(OverloadBalancer(ctx.refinement.balancer))
        elif algo == RefinementAlgorithm.UNDERLOAD_BALANCER:
            refiners.append(UnderloadBalancer(ctx.refinement.balancer))
        else:
            raise ValueError(f"unhandled refinement algorithm {algo}")
    if not refiners:
        return NoopRefiner()
    return MultiRefiner(refiners)


def create_partitioner(ctx: Context, graph: Optional[CSRGraph], *,
                       compressed: Optional[CompressedGraph] = None, device=None):
    """The partitioner of ``graph``, or of ``compressed`` on ``device``."""
    from .partitioning.deep import DeepMultilevelPartitioner

    if ctx.mode == PartitioningMode.DEEP:
        return DeepMultilevelPartitioner(ctx, graph, compressed=compressed, device=device)
    raise ValueError(f"unhandled partitioning mode {ctx.mode}")
