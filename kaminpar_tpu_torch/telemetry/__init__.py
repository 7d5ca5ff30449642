"""Run telemetry (counterpart of ``kaminpar_tpu/telemetry/``):

- :mod:`.phases`: the phase-name registry shared by the timer tree, the
  readback budgets and the trace;
- :mod:`.trace`: the per-run event trace (spans, counter samples, quality
  rows) with Chrome trace-event export;
- :mod:`.probes`: per-level quality rows that ride existing readbacks
  (no added pull, no added card sync);
- :mod:`.flight_recorder`: the heartbeat sidecar and dossier of a process
  that may be killed.

The JAX package's ledger, request traces, SLO accounting, capacity model,
Prometheus exposition and its drivers' ``TelemetryContext`` come with the
port's ``tools/`` and ``serve/``.

Typical use::

    from kaminpar_tpu_torch import telemetry

    with telemetry.run(trace_out="trace.json") as rec:
        solver.compute_partition(k=64)
    # rec.quality: the per-level rows; trace.json opens in chrome://tracing
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
