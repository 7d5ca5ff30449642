"""Request-scoped distributed tracing.

Every ``submit()`` — engine or fleet — mints a **trace id** that rides the
request through its whole life: the fleet steer decision (with the
per-replica score inputs that chose the winner), queue admission, batch
dispatch, lane-stack cohort membership, demotion-ladder rungs, resteer
hops across replicas, and journal replay after a crash.  One request is
one connected event chain even when it crosses process or replica
boundaries, because the trace id is (a) shared between a fleet and all of
its replicas via one :class:`ReqTrace` registry and (b) persisted in the
serve journal's admit records, so a restarted engine re-binds replayed
work to the original id.

Design constraints (mirrors the ``TraceRecorder`` probes):

* **Host-only by construction.**  Events are plain dict appends under one
  lock; nothing here ever touches a device value, so arming request
  tracing adds ZERO blocking transfers — the armed ``assert_phase_budget``
  suites pass unchanged (asserted in tests/test_reqtrace.py).
* **Bounded.**  The registry keeps at most ``capacity`` traces (oldest
  evicted) and at most ``max_events`` events per trace, so a long-lived
  serve process cannot grow without bound.
* **Chrome export reuses the span machinery.**  On terminal events the
  engine exports the event chain onto a per-request lane of the *existing*
  Chrome trace (``TraceRecorder.lane_span``), linked by trace id rather
  than re-instrumented; the pipeline's per-level spans stay as
  they are and correlate via the ``trace_id`` arg on the request lane.

The post-hoc query surface is :meth:`ReqTrace.dossier` (structured event
chain + connectivity verdict), wrapped by ``engine.explain(request_id)``
and ``fleet.explain(...)``.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import OrderedDict
from typing import List, Optional

# Events considered chain *roots* (a trace with none of these but with
# request-scoped events is disconnected) and chain *terminals* (a trace is
# resolved once one of these lands with final=True).
ROOT_EVENTS = ("steer", "admit")
TERMINAL_EVENTS = ("resolve", "error")


def _session_token() -> str:
    # Trace ids must stay unique across engine restarts that share a
    # journal (replayed ids come from the dead process; fresh mints must
    # not collide with them).  pid + coarse start-time is enough — ids are
    # correlation keys, not security tokens.
    return f"{os.getpid():x}-{int(time.time() * 1000) & 0xFFFFFF:x}"


class ReqTrace:
    """Bounded, thread-safe registry of per-request event chains."""

    def __init__(self, capacity: int = 2048, max_events: int = 256,
                 chrome_lane_budget: int = 64):
        self.capacity = int(capacity)
        self.max_events = int(max_events)
        self.chrome_lane_budget = int(chrome_lane_budget)
        self._lock = threading.Lock()
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._by_request: "OrderedDict[int, str]" = OrderedDict()
        self._by_fleet: "OrderedDict[int, str]" = OrderedDict()
        self._ids = itertools.count(1)
        self._session = _session_token()
        self._exported_lanes = 0
        self.minted = 0
        self.recorded = 0
        self.dropped_events = 0
        self.evicted_traces = 0

    # -- identity ----------------------------------------------------------

    def mint(self) -> str:
        with self._lock:
            self.minted += 1
            return f"t{self._session}-{next(self._ids)}"

    def bind(self, request_id: int, trace_id: str) -> None:
        """Associate an engine request id with a trace (lookup key for
        ``engine.explain``).  Replayed requests bind both the new engine id
        and the original journal id."""
        if not trace_id:
            return
        with self._lock:
            self._by_request[int(request_id)] = trace_id
            while len(self._by_request) > 4 * self.capacity:
                self._by_request.popitem(last=False)

    def bind_fleet(self, fleet_id: int, trace_id: str) -> None:
        if not trace_id:
            return
        with self._lock:
            self._by_fleet[int(fleet_id)] = trace_id
            while len(self._by_fleet) > 4 * self.capacity:
                self._by_fleet.popitem(last=False)

    # -- recording ---------------------------------------------------------

    def record(self, trace_id: str, event: str, **fields) -> None:
        """Append one event to a trace.  Pure host work: a timestamped dict
        append under a lock — never touches the device."""
        if not trace_id:
            return
        ev = {"event": str(event), "t": time.perf_counter(),
              "wall": time.time()}
        ev.update(fields)
        with self._lock:
            chain = self._traces.get(trace_id)
            if chain is None:
                chain = []
                self._traces[trace_id] = chain
                while len(self._traces) > self.capacity:
                    self._traces.popitem(last=False)
                    self.evicted_traces += 1
            if len(chain) >= self.max_events:
                self.dropped_events += 1
                return
            chain.append(ev)
            self.recorded += 1

    # -- query -------------------------------------------------------------

    def trace_for_request(self, request_id: int) -> Optional[str]:
        with self._lock:
            return self._by_request.get(int(request_id))

    def trace_for_fleet(self, fleet_id: int) -> Optional[str]:
        with self._lock:
            return self._by_fleet.get(int(fleet_id))

    def events(self, trace_id: str) -> List[dict]:
        with self._lock:
            chain = self._traces.get(trace_id)
            return [dict(ev) for ev in chain] if chain else []

    def dossier(self, trace_id: str) -> Optional[dict]:
        """Structured dossier for one trace: the time-ordered event chain
        plus a connectivity verdict.

        Connectivity contract (asserted by the resteer/replay continuity
        tests): an event that names a ``request_id`` is an **orphan**
        unless the same trace holds an ``admit`` event for that request id
        — so a journal-replayed resolution only connects if the replay
        re-admitted under the same trace id, and a resteered request's
        second-replica events only connect through its second admit.  A
        trace is *connected* when it has at least one root event and zero
        orphans.
        """
        evs = self.events(trace_id)
        if not evs:
            return None
        evs.sort(key=lambda ev: ev["t"])
        admits = {ev.get("request_id") for ev in evs
                  if ev["event"] == "admit" and ev.get("request_id")
                  is not None}
        orphans = [ev for ev in evs
                   if ev.get("request_id") is not None
                   and ev["event"] != "admit"
                   and ev["request_id"] not in admits]
        roots = sum(1 for ev in evs if ev["event"] in ROOT_EVENTS)
        terminal = next((ev for ev in reversed(evs)
                         if ev["event"] in TERMINAL_EVENTS
                         and ev.get("final", True)), None)
        engines = sorted({str(ev["engine"]) for ev in evs
                          if ev.get("engine")})
        summary = {
            "roots": roots,
            "admits": sum(1 for ev in evs if ev["event"] == "admit"),
            "replays": sum(1 for ev in evs
                           if ev["event"] == "journal_replay"),
            "resteers": sum(1 for ev in evs if ev["event"] == "resteer"),
            "demotions": sum(1 for ev in evs if ev["event"] == "demote"),
            "engines": engines,
            "orphan_events": len(orphans),
            "connected": bool(roots) and not orphans,
            "resolved": terminal is not None,
            "outcome": (terminal["event"] if terminal else None),
        }
        return {"trace_id": trace_id, "events": evs, "summary": summary,
                "orphans": orphans}

    def explain_request(self, request_id: int) -> Optional[dict]:
        tid = self.trace_for_request(request_id)
        return self.dossier(tid) if tid else None

    def explain_fleet(self, fleet_id: int) -> Optional[dict]:
        tid = self.trace_for_fleet(fleet_id)
        return self.dossier(tid) if tid else None

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "traces": len(self._traces),
                "minted": self.minted,
                "recorded_events": self.recorded,
                "dropped_events": self.dropped_events,
                "evicted_traces": self.evicted_traces,
                "chrome_lanes_exported": self._exported_lanes,
            }

    # -- Chrome export -----------------------------------------------------

    def export_chrome(self, rec, trace_id: str) -> bool:
        """Render one trace onto a per-request lane of the active Chrome
        trace.  Each chain segment becomes a span named after the event
        that *opened* it (``req.admit`` covers queued time until dispatch,
        ``req.dispatch`` covers execution until resolve, ...), so the
        request's life reads left-to-right on its own lane next to the
        pipeline lanes.  Lane count is budgeted — long serve runs keep
        the trace file bounded."""
        if rec is None:
            return False
        evs = self.events(trace_id)
        if len(evs) < 2:
            return False
        with self._lock:
            if self._exported_lanes >= self.chrome_lane_budget:
                return False
            self._exported_lanes += 1
        evs.sort(key=lambda ev: ev["t"])
        lane = f"req:{trace_id}"

        def span_args(ev: dict) -> dict:
            # An event field may shadow a recorder parameter ("lane" from
            # the lanestack event vs lane_span's lane) — remap collisions
            # instead of exploding the **kwargs call.
            out = {}
            for key, value in ev.items():
                if key in ("t", "wall", "event"):
                    continue
                if not isinstance(value, (str, int, float, bool)):
                    continue
                out[f"ev_{key}" if key in ("lane", "name") else key] = value
            out["trace_id"] = trace_id
            return out

        for prev, nxt in zip(evs, evs[1:]):
            rec.lane_span(
                lane, f"req.{prev['event']}",
                rec.to_us(prev["t"]), rec.to_us(nxt["t"]), **span_args(prev),
            )
        last = evs[-1]
        rec.instant(f"req.{last['event']}", **span_args(last))
        return True
