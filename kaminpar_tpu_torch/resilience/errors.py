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

The JAX package also passes the serve tier's admission errors (queue full,
deadline, cancelled, engine stopped) through untouched, and tells them
apart with ``is_control_flow``; both come with the port's serve tier,
which does not exist yet.

Pure stdlib: the classifier must work when torch itself is what broke.
"""

from __future__ import annotations

from typing import Tuple


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


def classify(exc: BaseException, site: str = "") -> ResilienceError:
    """Map an exception to exactly one typed failure class (see the module
    table).  Idempotent on typed errors; the original exception is chained
    as ``__cause__``."""
    if isinstance(exc, ResilienceError):
        return exc
    msg = str(exc).lower()
    name = type(exc).__name__
    out: ResilienceError
    if _is_cuda_oom(exc) or isinstance(exc, MemoryError) or any(
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
