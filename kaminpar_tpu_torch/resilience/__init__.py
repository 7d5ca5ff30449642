"""The resilience layer (counterpart of ``kaminpar_tpu/resilience/``).

- :mod:`.errors`: the typed failure classes (CompileTimeout, ExecuteFault,
  CapacityExceeded, BackendUnavailable, PoisonedCell, WorkerHung,
  GraphValidationError) and :func:`errors.classify`, which maps any
  exception, torch's and the card's included, to one of them.
- :mod:`.faults`: deterministic fault injection at named points of the
  main path (compile, execute, readback, preempt), armed by a plan string
  or ``KPTPU_FAULTS``.  An injected fault raises its typed error; nothing
  demotes a kernel, the device pool or device decode to a plain version.
- :mod:`.breakers`: per-(path, cell) circuit breakers with the serve and
  fleet rungs of the degradation ladder only.
- :mod:`.watchdog`: a deadline guard whose dossier names the dying phase
  from the phase board.
- :mod:`.checkpoint`: level-boundary checkpoints of the deep pipeline and
  bit-identical resume (imported on use: it needs torch).

:mod:`.errors`, :mod:`.faults`, :mod:`.breakers` and :mod:`.watchdog`
import no torch, so they work when the card is what broke.
"""

from .breakers import BreakerRegistry, CircuitBreaker, global_registry
from .errors import (
    BackendUnavailable,
    CapacityExceeded,
    CompileTimeout,
    ExecuteFault,
    GraphValidationError,
    PoisonedCell,
    ResilienceError,
    WorkerHung,
    classify,
)
from .faults import FaultPlan, injected_faults, maybe_inject
from .watchdog import ExecutionWatchdog

__all__ = [
    "BackendUnavailable",
    "BreakerRegistry",
    "CapacityExceeded",
    "CircuitBreaker",
    "CompileTimeout",
    "ExecuteFault",
    "ExecutionWatchdog",
    "FaultPlan",
    "GraphValidationError",
    "PoisonedCell",
    "ResilienceError",
    "WorkerHung",
    "classify",
    "global_registry",
    "injected_faults",
    "maybe_inject",
]
