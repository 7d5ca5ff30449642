"""Error surface of the partition-serving runtime.

Mirrors the error taxonomy of standard inference-serving stacks: admission
rejection (backpressure, carries a retry-after hint), deadline expiry,
cancellation, and engine-stopped.  All derive from :class:`ServeError` so
callers can catch the whole family at once.

These are the *control-flow* outcomes of admission and request
lifecycle; *failures* (execute faults, compile timeouts, capacity
exhaustion, backend loss, poisoned cells, hung workers) are typed by the
unified taxonomy in ``resilience/errors.py`` — every
dispatch-site ``except`` routes through ``resilience.errors.classify``
and
``classify``/``is_control_flow`` pass this module's classes through
untouched so admission semantics never change under classification.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class of every serving-runtime error."""


class QueueFullError(ServeError):
    """Admission control rejected the request: the bounded queue is full.

    ``retry_after_s`` is the engine's estimate of when capacity frees up
    (queue depth x smoothed per-request service time / batch width) — the
    standard reject-with-retry-after backpressure contract."""

    def __init__(self, retry_after_s: float = 0.1):
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"serve queue full; retry after {self.retry_after_s:.3f}s"
        )


class CapacityError(ServeError):
    """Admission preflight rejected the request: its predicted device-memory
    watermark exceeds the engine's per-device ceiling.  Raised BEFORE the request is queued — nothing
    was compiled or dispatched.  Carries the prediction so SLO-aware
    routers can steer the request to a bigger device instead of retrying.
    """

    def __init__(self, predicted_bytes: int, ceiling_bytes: int,
                 cell=(), device_kind: str = ""):
        self.predicted_bytes = int(predicted_bytes)
        self.ceiling_bytes = int(ceiling_bytes)
        self.cell = tuple(cell)
        self.device_kind = device_kind
        super().__init__(
            f"predicted device-memory watermark {self.predicted_bytes} B exceeds the "
            f"{device_kind or 'device'} admission ceiling "
            f"{self.ceiling_bytes} B for shape cell {self.cell} "
            "(telemetry/capacity.py; raise ServeContext.capacity_ceiling_"
            "bytes or use a larger device kind)"
        )


class DeadlineExceededError(ServeError):
    """The request's deadline expired before execution started.

    A running device computation is not interruptible, so deadlines are
    enforced at admission and at batch formation — a request that starts
    executing runs to completion."""


class RequestCancelledError(ServeError):
    """The request was cancelled (``ServeFuture.cancel``) before it ran."""


class EngineStoppedError(ServeError):
    """The engine is not running (never started, draining, or shut down)."""
