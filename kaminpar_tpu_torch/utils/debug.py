"""Hierarchy debug dumps (counterpart of ``kaminpar_tpu/utils/debug.py``).

Reference: ``kaminpar-shm/partitioning/debug.{h,cc}`` —
``dump_graph_hierarchy`` / ``dump_partition_hierarchy`` write each
multilevel level to disk for offline inspection, with filename patterns
substituting %graph/%n/%m/%k/%seed.  Enabled through
:class:`..context.DebugContext`; both are off by default.  A level on the
card is read back for the dump.
"""

from __future__ import annotations

import os

import numpy as np

from . import sync_stats


def _filename(pattern: str, ctx, graph, suffix: str) -> str:
    name = pattern
    for key, val in (
        ("%graph", ctx.debug.graph_name or "graph"),
        ("%n", str(graph.n)),
        ("%m", str(graph.m)),
        ("%k", str(ctx.partition.k)),
        ("%seed", str(ctx.seed)),
    ):
        name = name.replace(key, val)
    return name + suffix


def dump_graph_hierarchy(graph, level: int, ctx) -> None:
    """Write the level-``level`` coarse graph as METIS (debug.cc:60-76)."""
    if not ctx.debug.dump_graph_hierarchy:
        return
    from ..io.metis import write_metis

    path = _filename(
        ctx.debug.dump_dir + "/%graph_level" + str(level), ctx, graph, ".metis"
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_metis(graph, path)


def dump_partition_hierarchy(p_graph, level: int, ctx) -> None:
    """Write the level-``level`` partition, one block id per line
    (debug.cc:96-117)."""
    if not ctx.debug.dump_partition_hierarchy:
        return
    path = _filename(
        ctx.debug.dump_dir + "/%graph_level" + str(level) + "_k%k", ctx,
        p_graph.graph, ".part",
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, sync_stats.pull(p_graph.partition), fmt="%d")
