"""Shape-cell census and kernel-build accounting (counterpart of the part
of ``kaminpar_tpu/utils/compile_stats.py`` that the serve tier reads).

:func:`record`, :func:`distinct`, :func:`snapshot` and :func:`reset` keep
the JAX package's pure-Python census of distinct (kind, shape) cells.  The
JAX package records a cell inside a jitted body, so there a cell is one
XLA compile; the port has no tracing compiler, so here a cell is a shape
the serve tier has run, and nothing is compiled per cell.

The port's only compiles are builds of native code: ``nvcc`` building the
LP kernels (``ops/lp_kernels.build``) and ``g++`` building the METIS
parser (``io/native.py``).  :func:`enable_compile_time_tracking` turns on
their accounting and :func:`compile_time_snapshot` reports it under the
JAX package's keys: ``compile_events`` counts builds that ran in this
process (a library found already built costs none) and
``backend_compile_s`` their seconds; ``trace_s`` stays 0.

The JAX package's executable census (XLA's ``cost_analysis`` and
``memory_analysis`` of compiled programs, ``harvest*``/``census_*``) has
no counterpart: nothing in torch compiles a program whose analysis could
be read.  :func:`executable_census_armed` is always False and
:func:`census_prometheus_families` exports no family.
"""

from __future__ import annotations

import threading
from collections import defaultdict

from ..telemetry import trace as _ttrace

_lock = threading.Lock()
_shapes: dict = defaultdict(set)
_builds = {"backend_compile_s": 0.0, "compile_events": 0}
_by_kind: dict = {}
_tracking = [False]


def _sig_of(arrays, statics) -> tuple:
    sig = []
    for a in arrays:
        if hasattr(a, "shape"):
            sig.append((tuple(a.shape), str(a.dtype)))
        else:
            sig.append(repr(a))
    return tuple(sig), tuple(statics)


def record(kind: str, arrays=(), statics=()) -> None:
    """Record one (kind, shape) cell; a trace counter sample marks each new
    one."""
    sig = _sig_of(arrays, statics)
    with _lock:
        new = sig not in _shapes[kind]
        _shapes[kind].add(sig)
        total = sum(len(v) for v in _shapes.values())
    if new:
        rec = _ttrace.active()
        if rec is not None:
            rec.counter("compiled_shapes", {"total": total})


def distinct(kind: str | None = None) -> int:
    with _lock:
        if kind is not None:
            return len(_shapes.get(kind, ()))
        return sum(len(v) for v in _shapes.values())


def snapshot() -> dict:
    """{kind: distinct cells} plus a total."""
    with _lock:
        out = {k: len(v) for k, v in sorted(_shapes.items())}
    out["total"] = sum(out.values())
    return out


def reset() -> None:
    with _lock:
        _shapes.clear()
        _builds.update({"backend_compile_s": 0.0, "compile_events": 0})
        _by_kind.clear()


def enable_compile_time_tracking() -> None:
    """Count the native builds from now on (idempotent)."""
    _tracking[0] = True


def record_build(kind: str, seconds: float) -> None:
    """One native build that ran in this process (``kind``: "nvcc" for the
    LP kernels, "g++" for the METIS parser) and its seconds.  The build functions
    call this whether or not tracking is on; only tracked builds count."""
    if not _tracking[0]:
        return
    with _lock:
        _builds["backend_compile_s"] += float(seconds)
        _builds["compile_events"] += 1
        row = _by_kind.setdefault(kind, {"builds": 0, "seconds": 0.0})
        row["builds"] += 1
        row["seconds"] += float(seconds)


def compile_time_snapshot() -> dict:
    with _lock:
        return {
            "backend_compile_s": round(_builds["backend_compile_s"], 2),
            "trace_s": 0.0,
            "compile_events": _builds["compile_events"],
            "builds": {k: dict(v) for k, v in sorted(_by_kind.items())},
        }


def executable_census_armed() -> bool:
    """Always False: the port has no executable census (module docstring)."""
    return False


def census_prometheus_families() -> list:
    """No families: the port has no executable census."""
    return []
