"""Component factories: refinement enum list -> refiner pipeline, mode ->
partitioner (counterpart of ``kaminpar_tpu/factories.py``)."""

from __future__ import annotations

from typing import Optional

from .context import Context, PartitioningMode, RefinementAlgorithm
from .graph.compressed import CompressedGraph
from .graph.csr import CSRGraph
from .refinement.balancer import OverloadBalancer, UnderloadBalancer
from .refinement.clp_refiner import CLPRefiner
from .refinement.fm_refiner import FMRefiner
from .refinement.jet import JetRefiner
from .refinement.lp_refiner import LPRefiner
from .refinement.refiner import MultiRefiner, NoopRefiner, Refiner


def create_refiner(ctx: Context, *, coarse_level: bool = False) -> Refiner:
    """The refiner pipeline of ``ctx.refinement.algorithms``; ``coarse_level``
    selects JET's coarse-level temperatures."""
    refiners = []
    for algo in ctx.refinement.algorithms:
        if algo == RefinementAlgorithm.NOOP:
            continue
        if algo == RefinementAlgorithm.LP:
            refiners.append(LPRefiner(ctx.refinement.lp))
        elif algo in (RefinementAlgorithm.OVERLOAD_BALANCER,
                      RefinementAlgorithm.GREEDY_BALANCER):
            refiners.append(OverloadBalancer(ctx.refinement.balancer))
        elif algo == RefinementAlgorithm.UNDERLOAD_BALANCER:
            refiners.append(UnderloadBalancer(ctx.refinement.balancer))
        elif algo == RefinementAlgorithm.KWAY_FM:
            refiners.append(FMRefiner(ctx.refinement.fm))
        elif algo == RefinementAlgorithm.CLP:
            refiners.append(CLPRefiner(ctx.refinement.clp))
        elif algo == RefinementAlgorithm.JET:
            refiners.append(JetRefiner(ctx.refinement.jet, ctx.refinement.balancer,
                                       coarse_level=coarse_level))
        else:
            raise ValueError(f"unhandled refinement algorithm {algo}")
    if not refiners:
        return NoopRefiner()
    return MultiRefiner(refiners)


def create_partitioner(ctx: Context, graph: Optional[CSRGraph], *,
                       compressed: Optional[CompressedGraph] = None, device=None):
    """The partitioner of ``ctx.mode`` for ``graph``, or for ``compressed``
    on ``device``: the deep scheme partitions it from its compressed form,
    the other schemes decompress it onto ``device`` first."""
    from .partitioning.deep import DeepMultilevelPartitioner
    from .partitioning.kway import KWayMultilevelPartitioner
    from .partitioning.rb import RBMultilevelPartitioner
    from .partitioning.vcycle import VcycleDeepMultilevelPartitioner

    if ctx.mode == PartitioningMode.DEEP:
        return DeepMultilevelPartitioner(ctx, graph, compressed=compressed, device=device)
    if graph is None:
        graph = compressed.decompress(device)
    schemes = {PartitioningMode.KWAY: KWayMultilevelPartitioner,
               PartitioningMode.RB: RBMultilevelPartitioner,
               PartitioningMode.VCYCLE: VcycleDeepMultilevelPartitioner}
    if ctx.mode not in schemes:
        raise ValueError(f"unhandled partitioning mode {ctx.mode}")
    return schemes[ctx.mode](ctx, graph)
