"""Canonical phase-name registry (counterpart of
``kaminpar_tpu/telemetry/phases.py``).

One list of phase names shared by the timer tree (``utils/timer.scoped_timer``
pushes them as sync-accounting phases), :mod:`..utils.sync_stats` (budget
assertions key on them) and the run trace (spans carry them).  A budget
asserted against a misspelled phase counts a phase nobody pushed and passes
trivially, so :func:`check` warns (once per name and process) when a scope
opens under an unregistered name, and ``tests/test_torch_telemetry.py``
scans the package for phase literals and fails on drift either way.

The names are the JAX package's for every phase the port has.
"""

from __future__ import annotations

import warnings

# The partitioning spine's phases: every scoped_timer scope in the package
# uses one of these names.
CORE_PHASES = (
    "partitioning",
    "coarsening",
    "lp_clustering",
    "hem_clustering",
    "initial_partitioning",
    "extend_partition",
    "uncoarsening",
    "lp_refinement",
    "clp_refinement",
    "fm_refinement",
    "jet_refinement",
    "overload_balancer",
    "underload_balancer",
)

# Phases outside the spine.
AUX_PHASES = (
    "untracked",          # sync_stats' phase for unscoped pulls
    # The compressed tier: building the device view (host packing and
    # host-to-device copies, no readback; asserted with a 0 budget in
    # partitioning/deep.py) and decoding the finest CSR on the device at
    # the last uncoarsening step (no readback; asserted).
    "compressed_build",
    "compressed_decode",
    # The flight recorder's heartbeat thread (telemetry/flight_recorder.py):
    # it reads the phase board and /proc, never the device.
    "heartbeat",
    # Checkpoints of the deep pipeline (resilience/checkpoint.py).
    # checkpoint_write: each new coarse level's arrays are pulled once and
    # cached on the host, and each written uncoarsening boundary pulls its
    # partition; partitioning/deep.py asserts the writer's exact
    # entitlement, and 0 when checkpoints are disarmed.
    # checkpoint_restore: the level stack rebuilt onto the device from the
    # host arrays, host-to-device copies only (0 pulls, asserted).
    "checkpoint_write",
    "checkpoint_restore",
    # The serve tier (serve/): the packed-batch metrics readback and the
    # per-member CSR readbacks of batching.py; the lane-stacked execution
    # (serve/lanestack.py) and its stacked readbacks, one pull serving
    # every lane (lanestack_coarsening: the clustering rounds' moved
    # counts, a level's contraction stats and its coarse row_ptrs;
    # lanestack_refinement: the refinement rounds' flags and moved counts
    # and the keep-best quality rows); the admission preflight (host arithmetic, no
    # readback); the journal's admit records (one graph pull each) and its
    # replay (host-to-device copies); the request traces and SLO burn
    # rates (host work only).
    "serve_batch_metrics",
    "serve_pack",
    "serve_lanestack",
    "lanestack_coarsening",
    "lanestack_ip",
    "lanestack_refinement",
    "lanestack_extend",
    "capacity_preflight",
    "journal_write",
    "journal_replay",
    "reqtrace_export",
    "slo_eval",
)

KNOWN_PHASES = frozenset(CORE_PHASES + AUX_PHASES)

_warned: set = set()


def is_known(name: str) -> bool:
    return name in KNOWN_PHASES


def check(name: str) -> bool:
    """Warn once per process about an unregistered phase name.  Tests and
    ad-hoc scopes may use any name; the warning keeps a misspelled library
    phase from escaping the sync budget unseen."""
    if name in KNOWN_PHASES:
        return True
    if name not in _warned:
        _warned.add(name)
        warnings.warn(
            f"kaminpar_tpu_torch: timer phase {name!r} is not in the canonical "
            "phase registry (kaminpar_tpu_torch/telemetry/phases.py); sync-budget "
            "assertions and trace readers key on registered names",
            RuntimeWarning,
            stacklevel=3,
        )
    return False
