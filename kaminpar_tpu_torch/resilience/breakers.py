"""Per-(path, shape cell) circuit breakers and the degradation ladder
(counterpart of ``kaminpar_tpu/resilience/breakers.py``).

A breaker keyed by ``(path, cell)`` runs the state machine::

    closed --[threshold consecutive failures]--> open
    open   --[cooldown elapsed; one probe]-----> half-open
    half-open --[probe succeeds]--> closed
    half-open --[probe fails]----> open         (cooldown restarts)

and the ladder names what an open breaker demotes a path to.  The port
keeps only the serve and fleet rungs:

==================  ================  ===================================
rung (primary)      demotes to        dispatch site
==================  ================  ===================================
``lanestack``       ``per-graph``     the serve engine's stacked batches
``quality_strong``  ``quality_fast``  the serve engine under capacity trips
``cell``            ``reject``        serve admission (``PoisonedCell``)
``replica``         ``resteer``       the fleet router
==================  ================  ===================================

The JAX package's ``lp_pallas``, ``device_decode`` and ``ip_device`` rungs
are left out on purpose: demoting the LP kernels, device decode or the
device pool to a plain version is exactly the fallback the port forbids,
so no main-path site consults a breaker and a fault there stops the run.

The defaults can be set from the environment (``KPTPU_BREAKER_THRESHOLD``,
``KPTPU_BREAKER_COOLDOWN_S``).
"""

from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Dict, Optional, Tuple

#: rung -> fallback (the serve and fleet rungs; see the module docstring)
LADDER = {
    "lanestack": "per-graph",
    "quality_strong": "quality_fast",
    "cell": "reject",
    "replica": "resteer",
}

DEFAULT_THRESHOLD = 3
DEFAULT_COOLDOWN_S = 30.0


def _default_threshold() -> int:
    return int(os.environ.get("KPTPU_BREAKER_THRESHOLD", DEFAULT_THRESHOLD))


def _default_cooldown() -> float:
    return float(
        os.environ.get("KPTPU_BREAKER_COOLDOWN_S", DEFAULT_COOLDOWN_S)
    )


class CircuitBreaker:
    """One (path, cell) breaker.  Thread-safe; clock = time.monotonic."""

    def __init__(self, key: Tuple, threshold: int, cooldown_s: float):
        self.key = key
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._open_until = 0.0
        self._probe_deadline = 0.0
        # True while the granted half-open probe has neither reported an
        # outcome nor gone stale: concurrent callers racing a cooled-down
        # breaker claim exactly one probe (claim and transition are one
        # locked step).
        self._probe_inflight = False
        self.trips = 0
        self.total_failures = 0
        self.total_successes = 0
        self.probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self, now: Optional[float] = None) -> bool:
        """May the primary path be dispatched right now?

        closed: yes.  open: no until the cooldown elapses — the first
        caller after that flips to half-open and atomically CLAIMS the
        ONE probe slot; half-open: no while that claimed probe is in
        flight.  A probe that never reports back (a caller that cannot
        observe its own outcome) goes stale after one further cooldown
        and a new probe is granted — a lost probe must not pin the path
        demoted forever."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open" and now >= self._open_until:
                self._state = "half-open"
                self.probes += 1
                self._probe_inflight = True
                self._probe_deadline = now + self.cooldown_s
                return True
            if self._state == "half-open":
                if not self._probe_inflight:
                    # Half-open without a live claim (an outcome was
                    # recorded by a path that did not close the breaker):
                    # grant and claim a fresh probe.
                    self.probes += 1
                    self._probe_inflight = True
                    self._probe_deadline = now + self.cooldown_s
                    return True
                if now >= self._probe_deadline:
                    # Stale claim — the prober vanished; re-claim.
                    self.probes += 1
                    self._probe_deadline = now + self.cooldown_s
                    return True
            return False

    def would_allow(self, now: Optional[float] = None,
                    claim: bool = False) -> bool:
        """:meth:`allow` as a pure peek — same decision, but never
        consumes the probe slot or mutates state.  Callers that may still
        filter the path out after this check (the fleet router's
        candidate scan) peek first and consume only when the path is
        actually dispatched; ``claim=True`` is that consumption — it is
        exactly :meth:`allow`, named so call sites read as the
        peek/claim pair they are."""
        now = time.monotonic() if now is None else now
        if claim:
            return self.allow(now)
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                return now >= self._open_until
            # half-open: a fresh probe is only available when no claimed
            # probe is in flight (or the claim went stale).
            return (not self._probe_inflight) or now >= self._probe_deadline

    def retry_after_s(self, now: Optional[float] = None) -> float:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._state == "open":
                return max(0.0, self._open_until - now)
            if self._state == "half-open":
                # A probe is in flight: callers told "retry in 0s" would
                # hot-spin against repeated rejections until it resolves —
                # hint the probe deadline instead.
                return max(0.0, self._probe_deadline - now)
            return 0.0

    def record_success(self) -> bool:
        """Returns True when this success CLOSED a half-open breaker —
        the primary path is restored (callers log the recovery)."""
        with self._lock:
            restored = self._state == "half-open"
            self._state = "closed"
            self._consecutive = 0
            self._probe_inflight = False
            self.total_successes += 1
            return restored

    def reset(self) -> None:
        """Close the breaker administratively (a deliberately drained path
        coming back needs no half-open probe).  Lifetime counters are
        kept; only the state machine rewinds."""
        with self._lock:
            self._state = "closed"
            self._consecutive = 0
            self._probe_inflight = False

    def trip(self, now: Optional[float] = None) -> bool:
        """Force-open now, whatever the threshold (one hang seen by the
        watchdog is conclusive).  Returns True when this call opened a
        non-open breaker."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self.total_failures += 1
            opened = self._state != "open"
            self._state = "open"
            self._open_until = now + self.cooldown_s
            self._probe_inflight = False
            self._consecutive = max(self._consecutive + 1, self.threshold)
            if opened:
                self.trips += 1
            return opened

    def record_failure(self, now: Optional[float] = None) -> bool:
        """Returns True when this failure TRIPPED the breaker open (from
        closed at the threshold, or the half-open probe failing)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self.total_failures += 1
            if self._state == "half-open":
                self._state = "open"
                self._open_until = now + self.cooldown_s
                self._probe_inflight = False
                self.trips += 1
                self._consecutive = self.threshold
                return True
            self._consecutive += 1
            if self._state == "closed" and self._consecutive >= self.threshold:
                self._state = "open"
                self._open_until = now + self.cooldown_s
                self.trips += 1
                return True
            return False

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "trips": self.trips,
                "failures": self.total_failures,
                "successes": self.total_successes,
                "probes": self.probes,
                "retry_after_s": round(
                    max(0.0, self._open_until - time.monotonic()), 3
                ) if self._state == "open" else 0.0,
            }


class BreakerRegistry:
    """Breakers keyed by (path, cell), created on first use, and the
    demotion census of the ladder.  ``scope`` names the tier that owns the
    registry ("engine", "pipeline" for the process-global one, "fleet")
    and labels every exported sample."""

    def __init__(self, threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None,
                 scope: str = "engine"):
        self.threshold = (
            _default_threshold() if threshold is None else int(threshold)
        )
        self.cooldown_s = (
            _default_cooldown() if cooldown_s is None else float(cooldown_s)
        )
        self.scope = str(scope)
        self._lock = threading.Lock()
        self._breakers: Dict[Tuple, CircuitBreaker] = {}
        self._demotions: Dict[str, int] = {}
        self._restorations: Dict[str, int] = {}
        self._warned: set = set()

    def get(self, path: str, cell: Tuple = ()) -> CircuitBreaker:
        key = (str(path), tuple(cell))
        with self._lock:
            br = self._breakers.get(key)
            if br is None:
                br = self._breakers[key] = CircuitBreaker(
                    key, self.threshold, self.cooldown_s
                )
            return br

    # -- ladder accounting --------------------------------------------------

    def record_demotion(self, path: str, reason: str = "",
                        warn: bool = True) -> None:
        """Count one demotion of ``path`` to its ladder fallback; warn
        ONCE per rung per registry (repeat demotions ride the counter,
        not the warning stream)."""
        fallback = LADDER.get(path, "fallback")
        with self._lock:
            self._demotions[path] = self._demotions.get(path, 0) + 1
            first = path not in self._warned
            if first:
                self._warned.add(path)
        if warn and first:
            warnings.warn(
                f"kaminpar_tpu_torch resilience: degrading {path} -> {fallback}"
                + (f" ({reason})" if reason else "")
                + "; demotions are counted in the registry's snapshot and "
                "reversed by half-open probing after the breaker cooldown.",
                RuntimeWarning,
                stacklevel=3,
            )

    def record_restoration(self, path: str) -> None:
        """Count a half-open probe closing the breaker — primary restored."""
        with self._lock:
            self._restorations[path] = self._restorations.get(path, 0) + 1
            # Re-arm the once-per-rung warning: a NEW demotion after a
            # recovery is fresh news.
            self._warned.discard(path)

    def demotions(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._demotions)

    def open_count(self, path: Optional[str] = None) -> int:
        """Breakers currently not closed (open or half-open), optionally of
        one rung only."""
        with self._lock:
            breakers = list(self._breakers.items())
        return sum(
            1 for (p, _cell), br in breakers
            if (path is None or p == path) and br.state != "closed"
        )

    def snapshot(self) -> dict:
        with self._lock:
            breakers = {
                f"{path}|{','.join(map(str, cell))}": br
                for (path, cell), br in self._breakers.items()
            }
            demotions = dict(self._demotions)
            restorations = dict(self._restorations)
        return {
            "scope": self.scope,
            "threshold": self.threshold,
            "cooldown_s": self.cooldown_s,
            "breakers": {name: br.snapshot() for name, br in breakers.items()},
            "demotions": demotions,
            "restorations": restorations,
        }

    def reset(self) -> None:
        with self._lock:
            self._breakers.clear()
            self._demotions.clear()
            self._restorations.clear()
            self._warned.clear()


_global_lock = threading.Lock()
_global: list = [None]


def global_registry() -> BreakerRegistry:
    """The process-global registry, for sites outside any engine (no
    main-path site consults it; see the module docstring).  Created on
    first use, so defaults set in the environment apply."""
    with _global_lock:
        if _global[0] is None:
            _global[0] = BreakerRegistry(scope="pipeline")
        return _global[0]


def reset_global_registry() -> None:
    with _global_lock:
        _global[0] = None


def prometheus_families(*registries, prefix: str = "kaminpar_resilience") -> list:
    """Breaker and demotion metric families for ``telemetry/prometheus.render``,
    merged over the given registries (the engine passes its own and the
    process-global one)."""
    state_samples, trip_samples = [], []
    demo_samples, restore_samples = [], []
    state_code = {"closed": 0, "open": 1, "half-open": 2}
    merged_demo: Dict[str, int] = {}
    merged_restore: Dict[str, int] = {}
    for reg in registries:
        snap = reg.snapshot()
        scope = snap.get("scope", "engine")
        for name, br in snap["breakers"].items():
            path, _, cell = name.partition("|")
            labels = {"path": path, "cell": cell, "scope": scope}
            state_samples.append((labels, state_code.get(br["state"], -1)))
            trip_samples.append((labels, br["trips"]))
        for path, count in snap["demotions"].items():
            merged_demo[path] = merged_demo.get(path, 0) + count
        for path, count in snap["restorations"].items():
            merged_restore[path] = merged_restore.get(path, 0) + count
    for path, count in sorted(merged_demo.items()):
        demo_samples.append(
            ({"path": path, "fallback": LADDER.get(path, "fallback")}, count)
        )
    for path, count in sorted(merged_restore.items()):
        restore_samples.append(({"path": path}, count))
    from . import faults

    inj = faults.snapshot()
    inj_samples = [
        ({"point": pt}, row["injected"]) for pt, row in inj["points"].items()
    ] or [({}, 0)]
    return [
        (f"{prefix}_breaker_state", "gauge",
         "Circuit breaker state per (path, cell): 0 closed, 1 open, "
         "2 half-open",
         state_samples or [({}, None)]),
        (f"{prefix}_breaker_trips_total", "counter",
         "Times each (path, cell) breaker opened",
         trip_samples or [({}, 0)]),
        (f"{prefix}_demotions_total", "counter",
         "Degradation-ladder demotions by rung (see the README ladder "
         "table; reversed by half-open probing)",
         demo_samples or [({}, 0)]),
        (f"{prefix}_restorations_total", "counter",
         "Half-open probes that restored a primary path",
         restore_samples or [({}, 0)]),
        (f"{prefix}_faults_injected_total", "counter",
         "Chaos-harness fault injections by point (zero in production)",
         inj_samples),
    ]
