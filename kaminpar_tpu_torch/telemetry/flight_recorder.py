"""Flight recorder for a process that may be killed (counterpart of
``kaminpar_tpu/telemetry/flight_recorder.py``).

- A daemon heartbeat thread appends one JSON line per tick to a sidecar
  file: monotonic and wall time, each thread's innermost phase from the
  phase board (``utils/sync_stats.current_phases``, fed by the timer
  stack) and the resident set, so a killed process leaves a record of what
  it was doing when it died.
- ``faulthandler.dump_traceback_later``, armed just under the parent's
  kill timeout, dumps every thread's stack to a second sidecar.
- :func:`read_dossier`, run by the parent after the child died, assembles
  both and the port's environment variables into a dossier, and
  :func:`classify_phase` maps the dying phase to init, compile or execute.

The child arms it from the environment (:func:`arm_from_env`;
``KPTPU_FLIGHT_RECORDER`` names the heartbeat file, ``KPTPU_HEARTBEAT_S``
the period); the CLI does so before it reads its graph.

Pure stdlib at import time, and the phase board is read lazily, so the
recorder can beat before torch is imported.  A phase that opened and
closed between two ticks is not seen: the attribution's grain is one
heartbeat period.
"""

from __future__ import annotations

import faulthandler
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: The environment variables a dossier carries: those that decide which
#: device a child uses and what the port's run does.
ENV_FINGERPRINT_KEYS = (
    "CUDA_VISIBLE_DEVICES", "KPTPU_CHECKPOINT", "KPTPU_CHECKPOINT_EVERY",
    "KPTPU_FAULTS", "KPTPU_FAULTS_SEED", "KAMINPAR_TPU_NO_NATIVE",
    "KAMINPAR_TPU_ASSERT",
)

# the port's sync-accounting module, looked up (never imported) by name
_SYNC_STATS = "kaminpar_tpu_torch.utils.sync_stats"

_PAGE = 4096
try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    pass


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * _PAGE
    except Exception:  # noqa: BLE001 - heartbeats must never raise
        return None


def _board_phases() -> Dict[str, str]:
    """Best-effort read of the phase board ({thread: phase}); empty until
    the package is imported (the explicit note covers that stretch)."""
    try:
        import sys

        sync_stats = sys.modules.get(_SYNC_STATS)
        if sync_stats is None:
            return {}
        return {k: v for k, v in sync_stats.current_phases().items() if v}
    except Exception:  # noqa: BLE001
        return {}


class FlightRecorder:
    """One heartbeat sidecar and one armed stack dump per process.

    Usage::

        rec = FlightRecorder(hb_path, interval_s=5.0,
                             stack_path=stack_path, stack_after_s=1170.0)
        rec.start()
        rec.note("backend_init")
        torch.cuda.init()                  # may hang: the heartbeats go
        rec.note("partition")              # on, the stacks dump at 1170 s
    """

    def __init__(self, path: str, interval_s: float = 10.0,
                 stack_path: str = "", stack_after_s: Optional[float] = None):
        self.path = path
        self.interval_s = max(float(interval_s), 0.05)
        self.stack_path = stack_path
        self.stack_after_s = stack_after_s
        self._note = "startup"
        self._seq = 0
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stack_file = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FlightRecorder":
        if self._thread is not None:
            return self
        if self.stack_path and self.stack_after_s:
            try:
                # Keep the handle alive for faulthandler; the dump fires
                # once, just under the parent's kill timeout, with every
                # thread's stack.
                self._stack_file = open(self.stack_path, "w")
                faulthandler.dump_traceback_later(
                    float(self.stack_after_s), repeat=False,
                    file=self._stack_file, exit=False,
                )
            except Exception:  # noqa: BLE001 - forensics must not kill the run
                self._stack_file = None
        self.beat()  # line 0 proves the recorder armed before any hang
        self._thread = threading.Thread(
            target=self._loop, name="kpt-flight-recorder", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self.stack_after_s and self._stack_file is not None:
            try:
                faulthandler.cancel_dump_traceback_later()
                self._stack_file.close()
            except Exception:  # noqa: BLE001
                pass
            self._stack_file = None

    def note(self, phase: str) -> None:
        """Explicit phase marker for stretches the timer stack does not
        cover (device start-up, reading the input); beats at once, so the
        transition itself is on record."""
        self._note = str(phase)
        self.beat()

    # -- heartbeat ---------------------------------------------------------

    def beat(self) -> None:
        """Append one heartbeat line now (also called each tick)."""
        phases = _board_phases()
        main_phase = phases.get("MainThread") or self._note
        line = {
            "seq": self._seq,
            "t_mono_s": round(time.monotonic() - self._t0, 3),
            "ts": round(time.time(), 3),
            "iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "phase": main_phase,
            "note": self._note,
            "rss_bytes": _rss_bytes(),
        }
        if phases:
            line["phases"] = phases
        self._seq += 1
        try:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        except Exception:  # noqa: BLE001 - a full disk must not kill the run
            pass

    def _loop(self) -> None:
        # The tick runs under the registered "heartbeat" phase: the
        # recorder never reads from the device, and a stray readback here
        # would be counted where it shows.
        while not self._stop.wait(self.interval_s):
            try:
                import sys

                sync_stats = sys.modules.get(_SYNC_STATS)
                if sync_stats is not None:
                    with sync_stats.scoped("heartbeat"):
                        self.beat()
                else:
                    self.beat()
            except Exception:  # noqa: BLE001
                pass


def arm_from_env() -> Optional[FlightRecorder]:
    """Start a recorder from the environment: ``KPTPU_FLIGHT_RECORDER``
    (heartbeat file; unset: no recorder), ``KPTPU_HEARTBEAT_S``,
    ``KPTPU_FLIGHT_STACK``, ``KPTPU_FLIGHT_STACK_AFTER_S``."""
    path = os.environ.get("KPTPU_FLIGHT_RECORDER", "")
    if not path:
        return None
    try:
        rec = FlightRecorder(
            path,
            interval_s=float(os.environ.get("KPTPU_HEARTBEAT_S", 10.0)),
            stack_path=os.environ.get("KPTPU_FLIGHT_STACK", ""),
            stack_after_s=float(os.environ.get("KPTPU_FLIGHT_STACK_AFTER_S", 0))
            or None,
        )
        return rec.start()
    except Exception:  # noqa: BLE001 - forensics must not kill the child
        return None


# -- parent-side dossier assembly -------------------------------------------


def classify_phase(phase: Optional[str]) -> str:
    """Map a dying phase name to its hang class: ``init`` (device
    start-up), ``compile`` (warmup, kernel builds, trace export) or
    ``execute`` (a pipeline phase)."""
    p = (phase or "").lower()
    if p in ("", "startup", "backend_init", "devices", "init"):
        return "init"
    if any(tag in p for tag in ("warmup", "compile", "aot", "lowering",
                                "trace_export")):
        return "compile"
    return "execute"


def read_dossier(hb_path: str, stack_path: str = "",
                 tail_lines: int = 30) -> Optional[dict]:
    """The dossier of a killed child: its last heartbeat (phase, resident
    set, age), the heartbeat count, the stack dump's tail and the
    environment variables of :data:`ENV_FINGERPRINT_KEYS`.  None when no
    heartbeat line survives (the child died before arming)."""
    last = None
    count = 0
    try:
        with open(hb_path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    last = json.loads(line)
                    count += 1
                except ValueError:
                    continue  # a torn last line is expected after a kill
    except OSError:
        return None
    if last is None:
        return None
    dossier: dict = {
        "phase": last.get("phase") or last.get("note"),
        "phase_class": classify_phase(last.get("phase") or last.get("note")),
        "heartbeats": count,
        "last_heartbeat": {
            k: last.get(k)
            for k in ("seq", "t_mono_s", "iso", "rss_bytes", "phases")
            if last.get(k) is not None
        },
        "env": {
            k: os.environ[k] for k in ENV_FINGERPRINT_KEYS if k in os.environ
        },
    }
    tail = _stack_tail(stack_path, tail_lines)
    if tail:
        dossier["stack_tail"] = tail
    return dossier


def _stack_tail(stack_path: str, tail_lines: int) -> List[str]:
    if not stack_path:
        return []
    try:
        with open(stack_path) as fh:
            lines = [ln.rstrip() for ln in fh.readlines() if ln.strip()]
    except OSError:
        return []
    return lines[-int(tail_lines):]
