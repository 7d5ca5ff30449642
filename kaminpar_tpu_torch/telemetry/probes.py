"""Per-level quality probes (counterpart of
``kaminpar_tpu/telemetry/probes.py``).

While a trace is recorded (``telemetry.run``), the pipeline's sites write
per-level quality rows into it: the coarsening's level sizes and shrink,
the refiners' moved counts, the uncoarsening's cut and imbalance.  One
rule holds for every probe:

    **a probe adds no readback and no card sync.**  It records host values
    that an existing pull already produced (the contraction's packed
    stats, the CLP iteration's moved count, the balancer round's flags),
    or it packs device scalars into an existing pull
    (:func:`pull_partition_with_quality` widens the deep scheme's
    extension readback by two ints).

So the readback budgets (``utils/sync_stats.assert_phase_budget``) pass
unchanged with a trace armed.  Without a recorder every probe is one
attribute load.  The JAX package's dist-tier probes come with the dist
tier.
"""

from __future__ import annotations

from typing import Optional

from . import trace


def _rec() -> Optional[trace.TraceRecorder]:
    return trace.active()


def contraction_level(*, n, m, n_c, m_c, max_node_weight, total_edge_weight) -> None:
    """Counter sample emitted by ``ops/contraction.contract_clustering`` from
    the values its single batched stats readback already pulled."""
    rec = _rec()
    if rec is None:
        return
    rec.counter("contraction", {
        "n": int(n), "m": int(m), "n_c": int(n_c), "m_c": int(m_c),
        "max_node_weight": int(max_node_weight),
        "total_edge_weight": int(total_edge_weight),
    })


def coarsening_level(*, level, n, m, n_c, m_c, max_cluster_weight,
                     max_node_weight, total_edge_weight,
                     lp_moved=None, lp_rounds_budget=None,
                     lane=None) -> None:
    """The coarsener's per-level quality row: sizes, shrink, the LP moved
    count, all host values from the level's one batched readback.
    ``lane`` tags the rows of one lane of a lane-stacked serve batch (the
    stacked readback carries the same values per lane)."""
    rec = _rec()
    if rec is None:
        return
    row = dict(
        level=int(level), n=int(n), m=int(m), n_c=int(n_c), m_c=int(m_c),
        shrink=round(1.0 - n_c / max(n, 1), 4),
        max_cluster_weight=int(max_cluster_weight),
        max_node_weight=int(max_node_weight) if max_node_weight is not None else None,
        total_edge_weight=(
            int(total_edge_weight) if total_edge_weight is not None else None
        ),
        lp_moved=int(lp_moved) if lp_moved is not None else None,
        lp_rounds_budget=(
            int(lp_rounds_budget) if lp_rounds_budget is not None else None
        ),
    )
    if lane is not None:
        row["lane"] = int(lane)
    rec.quality_row("coarsening_level", **row)


def refinement_round(phase: str, *, round_idx, moved, cut=None) -> None:
    """One refiner round whose moved count (and, when packed, cut) already
    rode an existing readback (CLP per-iteration pull, balancer round pull)."""
    rec = _rec()
    if rec is None:
        return
    rec.quality_row(phase, round_idx=int(round_idx), moved=int(moved),
                    cut=int(cut) if cut is not None else None)


def refinement_pass(phase: str, **values) -> None:
    """Marker row for a refinement pass whose state stays fully on device
    (the LP refiner performs zero readbacks; its moved count and cut are
    deliberately NOT pulled — the span + host-known sizes are the record)."""
    rec = _rec()
    if rec is None:
        return
    rec.quality_row(phase, **{k: int(v) for k, v in values.items()})


def uncoarsening_level(*, level, n, m, k, cut=None, max_block_weight=None,
                       total_node_weight=None, kind="level_quality") -> None:
    """Per-level quality row on the way up: cut and imbalance of the refined
    partition at this level (values packed into an existing pull)."""
    rec = _rec()
    if rec is None:
        return
    imbalance = None
    if (
        max_block_weight is not None
        and total_node_weight
        and k > 0
    ):
        perfect = -(int(total_node_weight) // -int(k))  # ceil(W/k)
        if perfect > 0:
            imbalance = round(int(max_block_weight) / perfect - 1.0, 6)
    rec.quality_row(
        kind,
        level=int(level), n=int(n), m=int(m), k=int(k),
        cut=int(cut) if cut is not None else None,
        max_block_weight=(
            int(max_block_weight) if max_block_weight is not None else None
        ),
        imbalance=imbalance,
    )


def pull_partition_with_quality(p_graph, *, level, kind="level_quality"):
    """Pull a partition to the host (the deep scheme's existing readback
    of a level) and, while a trace is recorded, let the level's cut and
    maximum block weight ride the same pull, packed behind the partition:
    the readback count is the same either way, and no card sync is added.

    Returns the (n,) host partition array, as
    ``sync_stats.pull(p_graph.partition)`` does."""
    from ..utils import sync_stats

    part = p_graph.partition
    rec = _rec()
    if rec is None:
        return sync_stats.pull(part)

    import torch

    from ..graph import metrics

    graph = p_graph.graph
    cut, bw_max = metrics.quality_scalars_device(graph, part, int(p_graph.k))
    # Exact in the partition's int32: the cut is at most the total edge
    # weight and the block weight at most the total node weight, both
    # below 2^31 (the input guard, graph/csr.validate_csr_input).
    packed = torch.cat([part, torch.stack([cut, bw_max]).to(part.dtype)])
    host = sync_stats.pull(packed)  # still one readback
    part_host, cut_v, bw_v = host[:-2], int(host[-2]), int(host[-1])
    uncoarsening_level(
        level=level, n=graph.n, m=graph.m, k=int(p_graph.k),
        cut=cut_v, max_block_weight=bw_v,
        # only a cached total: reading the property could read back
        total_node_weight=graph._total_node_weight,
        kind=kind,
    )
    return part_host
