"""Structured per-run event trace with Chrome trace-event export
(counterpart of ``kaminpar_tpu/telemetry/trace.py``).

One :class:`TraceRecorder` per run collects

- **span events**, a begin/end pair for every ``scoped_timer`` scope
  (``utils/timer.py`` emits them),
- **counter samples**: the readback census (``utils/sync_stats.py``,
  ``host_sync``) and the device memory at every scope exit
  (``utils/heap_profiler.py``, ``device_bytes``),
- **quality rows**: the per-level records of the probes
  (``telemetry/probes.py``: level sizes, cut, imbalance, moved counts),
  exported under ``otherData.quality``.

The trace exports to Chrome trace-event JSON (``chrome://tracing``,
Perfetto's JSON importer).  Timestamps are microseconds on one
process-wide monotonic clock (``time.perf_counter`` since the recorder
started).  Around the phases named in ``profile_phases`` the recorder arms
``torch.profiler`` (CPU and, where there is a card, CUDA activity) and
writes its Chrome trace next to the run's, so that device kernels line up
with the host spans; the JAX package arms its own profiler there.

Everything is a no-op while no recorder is active (:func:`active` is None):
an instrumented scope pays one attribute load.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Dict, List, Optional

_PID = os.getpid()
_active_lock = threading.Lock()
_active: Optional["TraceRecorder"] = None


class TraceRecorder:
    """Thread-safe event accumulator for one run.

    Events follow the Chrome trace-event format: ``B``/``E`` duration pairs
    per (pid, tid), ``C`` counter samples, ``i`` instants, ``M`` metadata.
    Thread ids are small sequential ints named by ``thread_name`` metadata.
    """

    #: Past this many events only the ``E`` of an admitted ``B`` is taken
    #: (pairs stay matched); the drops are counted in the export.
    DEFAULT_MAX_EVENTS = 500_000

    def __init__(self, profile_phases=(), profile_dir: str = "",
                 max_events: int = DEFAULT_MAX_EVENTS):
        self._t0 = time.perf_counter()
        self.epoch_s = time.time()
        self._lock = threading.RLock()
        self._events: List[dict] = []
        self.max_events = int(max_events)
        self.dropped_events = 0
        # per tid: was each open span's B admitted?
        self._span_admitted: Dict[int, List[bool]] = {}
        #: the per-level quality rows of the probes (telemetry/probes.py),
        #: exported in the trace's otherData
        self.quality: List[dict] = []
        #: free-form run metadata (graph, k, preset, ...), exported as is
        self.meta: Dict[str, object] = {}
        self.profile_phases = frozenset(profile_phases)
        self.profile_dir = profile_dir or ".torch_profile"
        #: the torch.profiler Chrome traces written by armed phases
        self.profile_traces: List[str] = []
        self._profiler = None
        self._profile_phase = ""
        self._tids: Dict[int, int] = {}

    # -- event intake ------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def to_us(self, t_perf: float) -> float:
        """A ``time.perf_counter()`` reading taken elsewhere on this trace's
        clock (microseconds since the recorder started, at least 0); the
        request-trace registry (``telemetry/reqtrace.py``) replays its
        events onto lanes with it."""
        return max(0.0, (float(t_perf) - self._t0) * 1e6)

    def lane_tid(self, lane: str) -> int:
        """tid of a synthetic lane row, named by ``thread_name`` metadata
        like a thread's and fed by :meth:`lane_span` with explicit
        timestamps.  Lane keys are strings, so they never collide with the
        threads' integer idents."""
        key = f"lane:{lane}"
        tid = self._tids.get(key)
        if tid is None:
            with self._lock:
                tid = self._tids.get(key)
                if tid is None:
                    tid = self._tids[key] = len(self._tids)
                    self._events.append({
                        "name": "thread_name", "ph": "M", "ts": 0.0,
                        "pid": _PID, "tid": tid, "args": {"name": lane},
                    })
        return tid

    def lane_span(self, lane: str, name: str, ts_begin_us: float,
                  ts_end_us: float, **args) -> None:
        """One closed span on a synthetic lane row with explicit
        timestamps; its B/E pair is admitted or dropped as one, so the
        event cap never orphans half a span."""
        tid = self.lane_tid(lane)
        t0 = float(ts_begin_us)
        t1 = float(max(ts_end_us, ts_begin_us))
        b = {"name": name, "ph": "B", "ts": t0, "pid": _PID, "tid": tid}
        if args:
            b["args"] = args
        e = {"name": name, "ph": "E", "ts": t1, "pid": _PID, "tid": tid}
        with self._lock:
            if len(self._events) + 1 >= self.max_events:
                self.dropped_events += 2
                return
            self._events.append(b)
            self._events.append(e)

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.get(ident)
                if tid is None:
                    tid = self._tids[ident] = len(self._tids)
                    self._events.append({
                        "name": "thread_name", "ph": "M", "ts": 0.0,
                        "pid": _PID, "tid": tid,
                        "args": {"name": threading.current_thread().name},
                    })
        return tid

    def _emit(self, ev: dict) -> None:
        """Capped intake of the events that are not span ends."""
        with self._lock:
            if len(self._events) >= self.max_events:
                self.dropped_events += 1
                return
            self._events.append(ev)

    def begin(self, name: str, **args) -> None:
        tid = self._tid()
        ev = {"name": name, "ph": "B", "ts": self._now_us(), "pid": _PID, "tid": tid}
        if args:
            ev["args"] = args
        with self._lock:
            admitted = len(self._events) < self.max_events
            self._span_admitted.setdefault(tid, []).append(admitted)
            if admitted:
                self._events.append(ev)
            else:
                self.dropped_events += 1

    def end(self, name: str) -> None:
        tid = self._tid()
        ev = {"name": name, "ph": "E", "ts": self._now_us(), "pid": _PID, "tid": tid}
        with self._lock:
            stack = self._span_admitted.get(tid)
            admitted = stack.pop() if stack else True
            # the E of an admitted B always lands, even past the cap
            if admitted:
                self._events.append(ev)
            else:
                self.dropped_events += 1

    def instant(self, name: str, **args) -> None:
        ev = {"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
              "pid": _PID, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, values: Dict[str, float]) -> None:
        """One counter sample; the keys of ``values`` are the series."""
        self._emit({"name": name, "ph": "C", "ts": self._now_us(),
                    "pid": _PID, "tid": self._tid(),
                    "args": {k: v for k, v in values.items() if v is not None}})

    def quality_row(self, kind: str, **values) -> dict:
        """Record a per-level quality row and its counter sample (numeric
        values only on the counter track)."""
        row = {"kind": kind, "t_us": round(self._now_us(), 1)}
        row.update(values)
        with self._lock:
            self.quality.append(row)
        self.counter(f"quality/{kind}",
                     {k: v for k, v in values.items()
                      if isinstance(v, (int, float)) and not isinstance(v, bool)})
        return row

    # -- torch.profiler arming ----------------------------------------------

    def arm_profiler(self, phase: str) -> bool:
        """Start a ``torch.profiler`` capture if ``phase`` is configured and
        none is running; returns whether this call started it."""
        if phase not in self.profile_phases or self._profiler is not None:
            return False
        try:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as exc:  # noqa: BLE001 - profiling must never end a run
            self.instant("torch_profiler_error", phase=phase,
                         error=f"{type(exc).__name__}: {exc}"[:200])
            return False
        self._profiler, self._profile_phase = prof, phase
        self.instant("torch_profiler_start", phase=phase, log_dir=self.profile_dir)
        return True

    def disarm_profiler(self) -> None:
        """Stop the running capture and write its Chrome trace to
        ``profile_dir/<phase>.<pid>.<n>.json``."""
        prof, self._profiler = self._profiler, None
        if prof is None:
            return
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = os.path.join(self.profile_dir, f"{self._profile_phase}.{_PID}."
                                f"{len(self.profile_traces)}.json")
            prof.export_chrome_trace(path)
            self.profile_traces.append(path)
        except Exception as exc:  # noqa: BLE001
            self.instant("torch_profiler_error",
                         error=f"{type(exc).__name__}: {exc}"[:200])
            return
        self.instant("torch_profiler_stop", path=path)

    # -- export ------------------------------------------------------------

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object: events sorted by timestamp
        (stably, so B/E nesting per thread holds), every span still open
        closed at the export time."""
        now = self._now_us()
        with self._lock:
            events = sorted(self._events, key=lambda e: e.get("ts", 0.0))
            quality = list(self.quality)
            meta = dict(self.meta)
        open_spans: Dict[tuple, list] = {}
        for ev in events:
            key = (ev.get("pid"), ev.get("tid"))
            if ev.get("ph") == "B":
                open_spans.setdefault(key, []).append(ev["name"])
            elif ev.get("ph") == "E":
                stack = open_spans.get(key)
                if stack:
                    stack.pop()
        for (pid, tid), stack in open_spans.items():
            for name in reversed(stack):
                events.append({"name": name, "ph": "E", "ts": now, "pid": pid, "tid": tid})
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "kaminpar_tpu_torch.telemetry",
                "epoch_s": round(self.epoch_s, 3),
                "dropped_events": self.dropped_events,
                "profile_traces": list(self.profile_traces),
                "quality": quality,
                **meta,
            },
        }

    def write(self, path: str) -> str:
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path

    def span_seconds(self, *path: str) -> List[float]:
        """Seconds of every closed span at ``path`` (its name and the names
        of the spans enclosing it on its thread, outermost first; e.g.
        ``span_seconds("partitioning", "coarsening")`` gives the top-level
        coarsening levels, not those of nested pipelines), in the order
        the spans began."""
        with self._lock:
            events = list(self._events)
        out, stacks = [], {}
        path = list(path)
        for ev in events:
            stack = stacks.setdefault(ev.get("tid"), [])
            if ev.get("ph") == "B":
                stack.append((ev["name"], ev["ts"]))
            elif ev.get("ph") == "E" and stack:
                if [name for name, _ in stack] == path:
                    out.append((ev["ts"] - stack[-1][1]) / 1e6)
                stack.pop()
        return out

    def summary(self) -> dict:
        with self._lock:
            events = list(self._events)
            n_quality = len(self.quality)
        return {
            "events": len(events),
            "spans": sum(1 for e in events if e.get("ph") == "B"),
            "counter_samples": sum(1 for e in events if e.get("ph") == "C"),
            "quality_rows": n_quality,
            "dropped_events": self.dropped_events,
            "duration_s": round(self._now_us() / 1e6, 3),
        }


# -- module-level run management --------------------------------------------


def active() -> Optional[TraceRecorder]:
    """The run's recorder, or None when no run is recorded."""
    return _active


def start(profile_phases=(), profile_dir: str = "") -> TraceRecorder:
    global _active
    with _active_lock:
        if _active is not None:
            raise RuntimeError("a telemetry run is already active (one recorder per "
                               "process; call telemetry.trace.stop() first)")
        _active = TraceRecorder(profile_phases=profile_phases, profile_dir=profile_dir)
    return _active


def stop() -> Optional[TraceRecorder]:
    global _active
    with _active_lock:
        rec, _active = _active, None
    if rec is not None:
        rec.disarm_profiler()
    return rec


@contextmanager
def run(trace_out: str = "", profile_phases=(), profile_dir: str = ""):
    """Record one run; writes the Chrome trace to ``trace_out`` (when given)
    on exit, also when the run raises."""
    rec = start(profile_phases=profile_phases,
                profile_dir=profile_dir or (trace_out + ".profile" if trace_out else ""))
    try:
        yield rec
    finally:
        stop()
        if trace_out:
            try:
                rec.write(trace_out)
            except OSError as exc:
                # a failed write must not mask the run's own exception
                warnings.warn(f"kaminpar_tpu_torch: could not write trace "
                              f"{trace_out!r}: {exc}", RuntimeWarning, stacklevel=2)


# -- validation --------------------------------------------------------------


def validate_chrome_trace(obj: dict) -> dict:
    """Validate a Chrome trace-event object; raises ValueError on any
    malformation and returns a summary.

    Checks: ``traceEvents`` is a list, every non-metadata event carries
    name/ph/ts/pid/tid, timestamps never decrease per (pid, tid), every
    ``E`` closes the innermost open ``B`` of its thread and none stays
    open, and counter samples carry numeric args.
    """
    if not isinstance(obj, dict) or not isinstance(obj.get("traceEvents"), list):
        raise ValueError("not a Chrome trace: missing traceEvents list")
    events = obj["traceEvents"]
    stacks: Dict[tuple, list] = {}
    last_ts: Dict[tuple, float] = {}
    spans = counters = instants = 0
    span_names: set = set()
    counter_names: set = set()
    ts_min = ts_max = None
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph == "M":
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} ({ph!r}) missing {field!r}")
        ts = ev["ts"]
        if not isinstance(ts, (int, float)):
            raise ValueError(f"event {i} has non-numeric ts {ts!r}")
        key = (ev["pid"], ev["tid"])
        if ts < last_ts.get(key, float("-inf")):
            raise ValueError(f"event {i} ({ev['name']!r}): ts {ts} goes backwards on "
                             f"pid/tid {key}")
        last_ts[key] = ts
        ts_min = ts if ts_min is None else min(ts_min, ts)
        ts_max = ts if ts_max is None else max(ts_max, ts)
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
            span_names.add(ev["name"])
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                raise ValueError(f"event {i}: E {ev['name']!r} without open B")
            top = stack.pop()
            if top != ev["name"]:
                raise ValueError(f"event {i}: E {ev['name']!r} does not match open B {top!r}")
            spans += 1
        elif ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in args.values()
            ):
                raise ValueError(f"event {i}: counter args must be numeric")
            counters += 1
            counter_names.add(ev["name"])
        elif ph in ("i", "I"):
            instants += 1
        else:
            raise ValueError(f"event {i}: unknown phase type {ph!r}")
    unmatched = {k: v for k, v in stacks.items() if v}
    if unmatched:
        raise ValueError(f"unmatched B events at end of trace: {unmatched}")
    return {
        "events": len(events),
        "spans": spans,
        "counters": counters,
        "instants": instants,
        "span_names": sorted(span_names),
        "counter_names": sorted(counter_names),
        "duration_us": (ts_max - ts_min) if ts_max is not None else 0.0,
        "quality_rows": len((obj.get("otherData") or {}).get("quality", [])),
    }
