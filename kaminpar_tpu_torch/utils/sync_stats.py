"""Blocking device-to-host readback accounting (counterpart of
``kaminpar_tpu/utils/sync_stats.py``).

On the card every readback (``.cpu()``, ``.item()``, ``.tolist()``,
``int(t)``, a boolean-mask index, ``bincount``, ...) waits until the
stream has drained: the host stops queueing work.  This module makes the
number of readbacks a counted, testable metric:

- :func:`pull` is the one sanctioned readback: it copies each tensor to
  the host (``.cpu().numpy()``) and counts one transfer and its bytes per
  tensor against the innermost open phase.  Code that needs several
  scalars of a level packs them into one small tensor first, so a
  contraction costs one pull.
- Phases come from the timer tree: ``utils/timer.scoped_timer`` pushes its
  scope name as the phase, so the counts line up with the timer report.
  Every thread's phase stack is on a board that other threads read
  (:func:`current_phases`): the flight recorder's heartbeat and the
  watchdog's dossier name the phase a process died in from it.
- Every :func:`pull` is the ``readback`` fault-injection point
  (``resilience/faults.py``).
- :func:`tripwire` patches ``torch.Tensor.__int__``, ``__float__``,
  ``__bool__``, ``item`` and ``tolist`` to count *implicit* pulls, the
  ``int(x)``-style strays.  It counts them on CPU tensors too, so CPU
  tests find the strays that would stall the card.
- :func:`count_device_syncs` counts, per phase, every synchronizing CUDA
  call the card makes outside :func:`pull` (``torch.cuda`` sync debug
  mode "warn"), host-to-device copies from pageable memory included.
  :func:`guard` makes such a call raise instead (mode "error"), and
  :func:`allow_transfers` (entered by every :func:`pull`) is the window
  in which they pass.  The sync debug mode is process-global: a window
  opened by one thread also lets the calls of other threads pass.

The counters are process-global; :func:`enable_budget_checks` arms the
budget assertions of the pipelines (off by default, since concurrent
pipelines in one process would count against each other's budgets).
"""

from __future__ import annotations

import threading
import warnings
from contextlib import contextmanager
from typing import Dict, Tuple

import numpy as np
import torch

from ..resilience.faults import maybe_inject
from ..telemetry import trace as _ttrace

_lock = threading.Lock()
# phase -> [explicit_count, explicit_bytes, implicit_count, implicit_bytes,
#           lane_pulls, stacked_count, shard_pulls, sharded_count]
# The lane pair counts lane-stacked readbacks (one transfer that serves L
# lanes counts once, and L in lane_pulls), the shard pair mesh-wide ones;
# both are kept under the JAX package's names for the tiers still to port.
_counts: Dict[str, list] = {}
# phase -> synchronizing CUDA calls outside pull (count_device_syncs)
_device_syncs: Dict[str, int] = {}
_tls = threading.local()
_budget_checks = False
_DEFAULT_PHASE = "untracked"
_SYNC_WARNING = "called a synchronizing CUDA operation"
# thread ident -> (thread name, that thread's live phase stack); read by
# other threads without the owner's lock (a torn read sees a stack one
# push or pop off, never an error)
_phase_board: Dict[int, tuple] = {}


def _phase() -> str:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else _DEFAULT_PHASE


def active_phase() -> str:
    """This thread's innermost open phase ("untracked" outside any scope)."""
    return _phase()


def push_phase(name: str) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
        with _lock:
            _phase_board[threading.get_ident()] = (
                threading.current_thread().name or "thread", stack)
    stack.append(name)


def pop_phase() -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def current_phases() -> Dict[str, str]:
    """{thread name: innermost open phase} over every thread that ever
    pushed one ("" for an empty stack)."""
    with _lock:
        board = list(_phase_board.values())
    out = {}
    for name, stack in board:
        # one read of the live list: its owner may pop between a check
        # and an index
        top = stack[-1:]
        out[name] = top[0] if top else ""
    return out


@contextmanager
def scoped(name: str):
    """Count the readbacks inside the block against phase ``name`` (the
    timer tree pushes its scope names through this)."""
    push_phase(name)
    try:
        yield
    finally:
        pop_phase()


def _bump(kind_offset: int, count: int, nbytes: int, phase: str | None = None,
          lanes: int = 0, shards: int = 0) -> None:
    ph = phase or _phase()
    with _lock:
        row = _counts.get(ph)
        if row is None:
            row = _counts[ph] = [0, 0, 0, 0, 0, 0, 0, 0]
        row[kind_offset] += count
        row[kind_offset + 1] += nbytes
        if lanes > 0:
            row[4] += lanes * count
            row[5] += count
        if shards > 0:
            row[6] += shards * count
            row[7] += count
        total_count = sum(r[0] for r in _counts.values())
        total_bytes = sum(r[1] for r in _counts.values())
        total_implicit = sum(r[2] for r in _counts.values())
    rec = _ttrace.active()
    if rec is not None:
        rec.counter("host_sync", {"count": total_count, "bytes": total_bytes,
                                  "implicit": total_implicit})


def _cuda_sync_mode() -> int:
    """The sync debug mode (0 when CUDA was never initialised)."""
    if not torch.cuda.is_initialized():
        return 0
    return torch.cuda.get_sync_debug_mode()


@contextmanager
def allow_transfers():
    """Let synchronizing CUDA calls pass inside :func:`guard` and uncounted
    by :func:`count_device_syncs`: sync debug mode 0, the previous mode
    restored on exit (process-global, see the module docstring)."""
    prev = _cuda_sync_mode()
    if prev:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if prev:
            torch.cuda.set_sync_debug_mode(prev)


def pull(*tensors, phase: str | None = None, lanes: int = 0, shards: int = 0):
    """The sanctioned blocking readback: each tensor copied to the host as
    a numpy array (a CPU tensor's shares its memory), one transfer and its
    bytes counted per tensor against ``phase`` or the current phase.
    ``lanes``/``shards`` mark a stacked or mesh-wide readback as in the JAX
    package.  Returns one array for one input, else a tuple."""
    maybe_inject("readback", site=phase or _phase())
    out = []
    with allow_transfers():
        for t in tensors:
            host = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
            _bump(0, 1, int(host.nbytes), phase, lanes=lanes, shards=shards)
            out.append(host)
    return out[0] if len(out) == 1 else tuple(out)


def record_transfer(nbytes: int, count: int = 1, phase: str | None = None) -> None:
    """Count a blocking transfer made outside :func:`pull`."""
    _bump(0, count, int(nbytes), phase)


def phase_count(name: str, implicit: bool = False) -> int:
    with _lock:
        row = _counts.get(name)
        if row is None:
            return 0
        return row[2] if implicit else row[0]


def lane_phase_count(name: str) -> Tuple[int, int]:
    """(lane_pulls, stacked_count) of phase ``name``."""
    with _lock:
        row = _counts.get(name)
        return (0, 0) if row is None else (row[4], row[5])


def shard_phase_count(name: str) -> Tuple[int, int]:
    """(shard_pulls, sharded_count) of phase ``name``."""
    with _lock:
        row = _counts.get(name)
        return (0, 0) if row is None else (row[6], row[7])


def device_sync_count(name: str) -> int:
    """Synchronizing CUDA calls outside :func:`pull` seen in phase ``name``
    while :func:`count_device_syncs` was active."""
    with _lock:
        return _device_syncs.get(name, 0)


def snapshot() -> dict:
    """{phase: {count, bytes, implicit, implicit_bytes, lane_pulls,
    stacked_count, shard_pulls, sharded_count}} plus totals (the JAX
    package's layout), and ``device_syncs``: {phase: synchronizing CUDA
    calls outside pull}."""
    with _lock:
        phases = {
            k: {
                "count": v[0],
                "bytes": v[1],
                "implicit": v[2],
                "implicit_bytes": v[3],
                "lane_pulls": v[4],
                "stacked_count": v[5],
                "shard_pulls": v[6],
                "sharded_count": v[7],
            }
            for k, v in sorted(_counts.items())
        }
        device_syncs = dict(sorted(_device_syncs.items()))
    return {
        "phases": phases,
        "count": sum(p["count"] for p in phases.values()),
        "bytes": sum(p["bytes"] for p in phases.values()),
        "implicit": sum(p["implicit"] for p in phases.values()),
        "lane_pulls": sum(p["lane_pulls"] for p in phases.values()),
        "stacked_count": sum(p["stacked_count"] for p in phases.values()),
        "shard_pulls": sum(p["shard_pulls"] for p in phases.values()),
        "sharded_count": sum(p["sharded_count"] for p in phases.values()),
        "device_syncs": device_syncs,
    }


def reset() -> None:
    with _lock:
        _counts.clear()
        _device_syncs.clear()


def enable_budget_checks(on: bool = True) -> None:
    """Arm the budget assertions of the pipelines."""
    global _budget_checks
    _budget_checks = bool(on)


def budget_checks_enabled() -> bool:
    return _budget_checks


def assert_phase_budget(name: str, budget: int, since: int = 0,
                        shards: int = 0, count_since: int = 0) -> None:
    """Raise when phase ``name`` made more than ``budget`` blocking
    transfers since the ``since`` reading of :func:`phase_count`.  No-op
    unless :func:`enable_budget_checks` armed it.  With ``shards=P`` the
    budget is per shard, checked in shard pulls (``since`` a reading of
    :func:`shard_phase_count`) and in plain transfers (``count_since``)."""
    if not _budget_checks:
        return
    if shards > 0:
        used = shard_phase_count(name)[0] - since
        allowed = budget * shards
        if used > allowed:
            raise AssertionError(
                f"per-shard sync budget exceeded in phase {name!r}: "
                f"{used} logical shard pulls > {budget} per shard x "
                f"{shards} shards = {allowed} (see utils/sync_stats.py)"
            )
        used_count = phase_count(name) - count_since
        if used_count > budget:
            raise AssertionError(
                f"sync budget exceeded in phase {name!r}: {used_count} "
                f"blocking transfers > budget {budget} (includes pulls "
                f"missing their shards= tag; see utils/sync_stats.py)"
            )
        return
    used = phase_count(name) - since
    if used > budget:
        raise AssertionError(
            f"sync budget exceeded in phase {name!r}: {used} blocking "
            f"transfers > budget {budget} (one batched readback per level "
            f"is the contract; see utils/sync_stats.py)"
        )


# ---------------------------------------------------------------------------
# Implicit-pull tripwire: int()/float()/bool()/.item()/.tolist() on tensors.
# ---------------------------------------------------------------------------

_trip_depth = 0
_trip_saved: Dict[str, object] = {}
_TRIP_METHODS: Tuple[str, ...] = ("__int__", "__float__", "__bool__", "item", "tolist")


def _install_tripwire() -> None:
    for name in _TRIP_METHODS:
        orig = torch.Tensor.__dict__.get(name)
        _trip_saved[name] = orig
        base = getattr(torch.Tensor, name)

        def make(base):
            def patched(self, *args, **kwargs):
                try:
                    _bump(2, 1, int(self.numel() * self.element_size()))
                except Exception:  # noqa: BLE001 - accounting must never break math
                    pass
                return base(self, *args, **kwargs)

            return patched

        setattr(torch.Tensor, name, make(base))


def _uninstall_tripwire() -> None:
    for name, orig in _trip_saved.items():
        if orig is None:
            delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, orig)
    _trip_saved.clear()


@contextmanager
def tripwire():
    """Count implicit scalar pulls (``int(t)``, ``float(t)``, ``bool(t)``,
    ``t.item()``, ``t.tolist()``) while active.  Nests; meant for tests:
    every such conversion pays a Python call more."""
    global _trip_depth
    with _lock:
        _trip_depth += 1
        if _trip_depth == 1:
            _install_tripwire()
    try:
        yield
    finally:
        with _lock:
            _trip_depth -= 1
            if _trip_depth == 0:
                _uninstall_tripwire()


@contextmanager
def guard():
    """Make every synchronizing CUDA call outside :func:`pull` raise (sync
    debug mode "error", process-global).  A no-op without CUDA: on the CPU
    use :func:`tripwire`."""
    if not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextmanager
def count_device_syncs():
    """Count the synchronizing CUDA calls made outside :func:`pull`, per
    phase (:func:`device_sync_count`, ``snapshot()["device_syncs"]``).
    Sync debug mode "warn" turns each such call into a warning, which is
    counted against the phase of the thread that made it; other warnings
    are kept in the list this yields.  The mode and the warnings hook are
    process-global.  Without CUDA nothing is counted."""
    with warnings.catch_warnings(record=True) as others:
        warnings.simplefilter("always")

        def showwarning(message, category, filename, lineno, file=None, line=None):
            if _SYNC_WARNING in str(message):
                ph = _phase()
                with _lock:
                    _device_syncs[ph] = _device_syncs.get(ph, 0) + 1
            else:
                others.append(warnings.WarningMessage(message, category, filename,
                                                      lineno, file, line))

        warnings.showwarning = showwarning
        if not torch.cuda.is_available():
            yield others
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield others
        finally:
            torch.cuda.set_sync_debug_mode(prev)
