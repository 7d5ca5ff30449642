"""Typed failure classes and the one classifier (counterpart of
``kaminpar_tpu/resilience/errors.py``).

Every failure the resilience layer reports is one of seven typed classes,
each with a stable ``failure_class`` name (the names fault plans use), the
``site`` that saw it and whether the fault injector raised it.
:func:`classify` maps any exception to exactly one of them; it maps torch
and card failures the way the JAX package maps jaxlib's:

==========================================  ======================
exception                                   class
==========================================  ======================
``torch.cuda.OutOfMemoryError``,            ``CapacityExceeded``
``MemoryError``, "out of memory" messages
a CUDA launch or runtime error (a           ``ExecuteFault``
``RuntimeError`` naming CUDA, the error
``ops/lp_kernels.py`` raises after a
failed launch), and anything unknown
no visible device, a failed CUDA init,      ``BackendUnavailable``
``ImportError``
``TimeoutError`` at a compile or build      ``CompileTimeout``
site (elsewhere: ``ExecuteFault``)
==========================================  ======================

The serve tier's admission errors (queue full, deadline, cancelled, engine
stopped; ``serve/errors.py``) are control flow, not faults: the classifier
wraps one that reaches it anyway as an ``ExecuteFault`` with the original
chained, and :func:`is_control_flow` tells them apart so dispatch sites
re-raise them untouched.  The admission preflight's ``CapacityError`` is
classified as ``CapacityExceeded``.

Pure stdlib: the classifier must work when torch itself is what broke.
"""

from __future__ import annotations

from typing import Optional, Tuple


class ResilienceError(RuntimeError):
    """Base of the typed failures: ``failure_class`` names the class,
    ``site`` the dispatch site that saw it, ``injected`` marks a fault the
    injector raised (``resilience/faults.py``)."""

    failure_class = "unclassified"

    def __init__(self, message: str = "", *, site: str = "", injected: bool = False):
        self.site = str(site)
        self.injected = bool(injected)
        super().__init__(message or self.failure_class)


class CompileTimeout(ResilienceError):
    """A kernel build or a fresh shape bucket exceeded its budget."""

    failure_class = "compile-timeout"


class ExecuteFault(ResilienceError):
    """A device execution or its readback failed or timed out."""

    failure_class = "execute-fault"


class CapacityExceeded(ResilienceError):
    """The card's allocator refused (out of memory)."""

    failure_class = "capacity-exceeded"


class BackendUnavailable(ResilienceError):
    """No visible card, or CUDA failed to initialise."""

    failure_class = "backend-unavailable"


class PoisonedCell(ResilienceError):
    """A (shape cell, path) circuit breaker is open: further dispatches of
    the cell are rejected until the half-open probe (``retry_after_s``)."""

    failure_class = "poisoned-cell"

    def __init__(self, cell: Tuple = (), retry_after_s: float = 0.0, *,
                 site: str = "", injected: bool = False):
        self.cell = tuple(cell)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"shape cell {self.cell} is poisoned (circuit breaker open); "
            f"half-open probe in {self.retry_after_s:.3f}s",
            site=site, injected=injected,
        )


class WorkerHung(ResilienceError):
    """A worker thread died or hung mid-batch."""

    failure_class = "worker-hung"


class GraphValidationError(ResilienceError, ValueError):
    """Malformed graph input rejected at the facade (non-monotone row_ptr,
    out-of-range columns, negative or overflowing weights).  Also a
    ``ValueError``, so callers that catch the facade's validation errors
    keep working."""

    failure_class = "graph-validation"


#: failure-class name -> error type (fault plans name errors by class)
FAILURE_CLASSES = {
    cls.failure_class: cls
    for cls in (
        CompileTimeout, ExecuteFault, CapacityExceeded, BackendUnavailable,
        PoisonedCell, WorkerHung, GraphValidationError,
    )
}

# Message fragments of card bring-up failures and of allocator exhaustion,
# the JAX package's list plus the CUDA runtime's own wording.
_BACKEND_MARKERS = (
    "unavailable", "failed to initialize", "no visible device",
    "backend", "failed precondition", "deadline_exceeded",
    "unable to initialize", "device or resource busy",
    "cuda is not available", "no cuda gpus are available",
    "cuda driver initialization failed", "found no nvidia driver",
)
_CAPACITY_MARKERS = (
    "resource_exhausted", "resource exhausted", "out of memory", "oom",
    "allocation", "hbm", "bytes_limit",
)


def _is_cuda_oom(exc: BaseException) -> bool:
    """``torch.cuda.OutOfMemoryError`` without importing torch (the class
    is looked up by name so the classifier stays stdlib-only)."""
    return any(cls.__name__ == "OutOfMemoryError" and cls.__module__.startswith("torch")
               for cls in type(exc).__mro__)


def _passthrough(exc: BaseException) -> Optional[BaseException]:
    """Typed errors and the serve tier's control-flow outcomes."""
    if isinstance(exc, ResilienceError):
        return exc
    try:
        from ..serve import errors as serve_errors
    except Exception:  # noqa: BLE001 - the classifier works without the serve tier
        return None
    if isinstance(exc, (serve_errors.QueueFullError, serve_errors.DeadlineExceededError,
                        serve_errors.RequestCancelledError,
                        serve_errors.EngineStoppedError)):
        return exc
    return None


def _is_capacity_preflight(exc: BaseException) -> bool:
    try:
        from ..serve.errors import CapacityError
    except Exception:  # noqa: BLE001
        return False
    return isinstance(exc, CapacityError)


def classify(exc: BaseException, site: str = "") -> ResilienceError:
    """Map an exception to exactly one typed failure class (see the module
    table).  Idempotent on typed errors; the original exception is chained
    as ``__cause__``."""
    hit = _passthrough(exc)
    if isinstance(hit, ResilienceError):
        return hit
    if hit is not None:
        # a control-flow serve error reached the classifier: the caller
        # still gets a typed error (callers should re-raise these instead,
        # see is_control_flow)
        err = ExecuteFault(f"{type(exc).__name__}: {exc}", site=site)
        err.__cause__ = exc
        return err
    msg = str(exc).lower()
    name = type(exc).__name__
    out: ResilienceError
    if _is_capacity_preflight(exc) or _is_cuda_oom(exc) or isinstance(exc, MemoryError) or any(
        m in msg for m in _CAPACITY_MARKERS
    ):
        out = CapacityExceeded(f"{name}: {exc}", site=site)
    elif isinstance(exc, TimeoutError):
        out = (
            CompileTimeout(f"{name}: {exc}", site=site)
            if "compile" in (site or "").lower() or "compile" in msg
            else ExecuteFault(f"{name}: {exc}", site=site)
        )
    elif isinstance(exc, (ImportError, ModuleNotFoundError)) or any(
        m in msg for m in _BACKEND_MARKERS
    ):
        out = BackendUnavailable(f"{name}: {exc}", site=site)
    else:
        out = ExecuteFault(f"{name}: {exc}", site=site)
    out.__cause__ = exc
    return out


def is_control_flow(exc: BaseException) -> bool:
    """True for the serve tier's admission and lifecycle outcomes (queue
    full, deadline, cancelled, engine stopped), which dispatch sites
    re-raise untouched instead of classifying as faults."""
    hit = _passthrough(exc)
    return hit is not None and not isinstance(hit, ResilienceError)
