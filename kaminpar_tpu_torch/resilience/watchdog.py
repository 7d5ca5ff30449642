"""Execution watchdog (counterpart of ``kaminpar_tpu/resilience/watchdog.py``).

:meth:`ExecutionWatchdog.guard` runs a block under a deadline.  When the
block overruns, a monitor thread assembles a dossier: the dying phase from
the sync-accounting phase board (``utils/sync_stats.current_phases``, the
board the flight recorder's heartbeat reads), every thread's Python stack
and the resident set, and calls the caller's ``on_timeout`` once.  A
Python thread cannot be interrupted, so the guarded block is abandoned,
not cancelled: it runs on, and its late exit is noted in the dossier.

Pure stdlib at import time; the phase board is read lazily.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional


def _board_phases() -> Dict[str, str]:
    """Best-effort read of the phase board ({thread: phase}), as the flight
    recorder's heartbeat reads it."""
    try:
        sync_stats = sys.modules.get("kaminpar_tpu_torch.utils.sync_stats")
        if sync_stats is None:
            return {}
        return {k: v for k, v in sync_stats.current_phases().items() if v}
    except Exception:  # noqa: BLE001 — forensics must never raise
        return {}


def _all_stacks(tail_lines: int = 20) -> List[str]:
    """Every thread's Python stack as plain strings (``sys._current_frames``;
    faulthandler would need a file descriptor).  The tail limit applies
    per thread, so the hung thread's stack is never cut away by the
    others'."""
    try:
        names = {t.ident: t.name for t in threading.enumerate()}
        lines: List[str] = []
        for tid, frame in sys._current_frames().items():
            stack = [
                ln.rstrip()
                for entry in traceback.format_stack(frame)
                for ln in entry.splitlines()
            ]
            lines.append(f"Thread {names.get(tid, tid)}:")
            lines.extend(stack[-int(tail_lines):])
    except Exception:  # noqa: BLE001
        return []
    return lines


class ExecutionWatchdog:
    """Deadline guard over compile and execute dispatches; the dossiers of
    fired guards accumulate on :attr:`dossiers` (the last 16) and, with
    ``dossier_path``, in a JSON-lines file."""

    MAX_DOSSIERS = 16

    def __init__(self, dossier_path: str = ""):
        self.dossier_path = dossier_path
        self.fired = 0
        self.guards = 0
        self.dossiers: List[dict] = []
        self._lock = threading.Lock()

    def _record(self, dossier: dict) -> None:
        with self._lock:
            self.fired += 1
            self.dossiers.append(dossier)
            del self.dossiers[: -self.MAX_DOSSIERS]
        if self.dossier_path:
            try:
                import json

                with open(self.dossier_path, "a") as fh:
                    fh.write(json.dumps(dossier) + "\n")
            except Exception:  # noqa: BLE001 - forensics must not end the run
                pass

    @contextmanager
    def guard(
        self,
        phase: str,
        timeout_s: float,
        on_timeout: Optional[Callable[[dict], None]] = None,
    ):
        """Run the block under a deadline; ``timeout_s <= 0`` disarms.

        On overrun the monitor thread assembles the dossier and calls
        ``on_timeout(dossier)`` once.  The guarded block keeps running
        (threads are not interruptible); if it ever exits, the dossier's
        ``completed_late`` says so."""
        self.guards += 1
        if timeout_s <= 0:
            yield
            return
        done = threading.Event()
        fired = threading.Event()

        def _monitor():
            if done.wait(timeout_s):
                return
            fired.set()
            from ..telemetry.flight_recorder import _rss_bytes, classify_phase

            phases = _board_phases()
            dossier = {
                "phase": phase,
                "phase_class": classify_phase(phase),
                "timeout_s": timeout_s,
                "t_mono_s": round(time.monotonic(), 3),
                "board_phases": phases,
                "rss_bytes": _rss_bytes(),
                "stack_tail": _all_stacks(),
                "completed_late": False,
            }
            self._record(dossier)
            if on_timeout is not None:
                try:
                    on_timeout(dossier)
                except Exception:  # noqa: BLE001 — the timeout callback
                    # must never take down the monitor thread
                    pass

        monitor = threading.Thread(
            target=_monitor, name="kpt-watchdog", daemon=True
        )
        monitor.start()
        try:
            yield
        finally:
            done.set()
            if fired.is_set():
                # The abandoned block returned (or raised) after all: a
                # slow block, not a hang.
                with self._lock:
                    if self.dossiers:
                        self.dossiers[-1]["completed_late"] = True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "guards": self.guards,
                "fired": self.fired,
                "dossiers": [
                    {k: d[k] for k in ("phase", "phase_class", "timeout_s",
                                       "completed_late")}
                    for d in self.dossiers
                ],
            }
