"""Run telemetry (counterpart of ``kaminpar_tpu/telemetry/``): the phase
registry (:mod:`.phases`) and the per-run event trace (:mod:`.trace`).

Typical use::

    from kaminpar_tpu_torch import telemetry

    with telemetry.run(trace_out="trace.json") as rec:
        solver.compute_partition(k=64)
    # trace.json opens in chrome://tracing or Perfetto
"""

from __future__ import annotations

from . import phases, trace
from .trace import TraceRecorder, active, run, start, stop, validate_chrome_trace

__all__ = [
    "TraceRecorder",
    "active",
    "phases",
    "run",
    "start",
    "stop",
    "trace",
    "validate_chrome_trace",
]
