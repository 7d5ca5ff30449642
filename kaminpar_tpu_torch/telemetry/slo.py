"""SLO objectives and error-budget burn-rate accounting.

The serve stack's routing and autoscaling act on raw signals (queue drain
estimates, p99 execute) with no notion of *declared objectives*.  This
module adds that layer:

* **Objectives** are declared on ``ServeContext`` (``slo_strong_ms`` /
  ``slo_fast_ms`` per-quality-tier latency targets, ``slo_availability``,
  ``slo_capacity_reject_rate``) — all default **off** (0.0), so nothing
  changes unless a deployment arms them.
* **Burn rates** are computed over rolling multi-window event rings
  (default 60 s / 600 s — the classic fast/slow burn pair), fed from the
  exact sites that feed the existing ``ServeStats`` reservoirs (the
  engine records both in the same breath, so the SLO view and the
  latency reservoirs can never disagree about which requests happened).
  ``burn = bad_fraction / error_budget``; burn > 1 means the budget is
  being spent faster than the objective allows.
* **Pressure** (``max(0, worst_burn - 1)``) is the single dimensionless
  control signal exported to the fleet: an additive term in the fleet's steering score and a boost on the fleet's autoscale drain estimate.
  Pressure is a *control input only* — it changes which replica serves a
  request and when the fleet scales, never the partitioning math, so
  partitions stay bit-identical with SLO armed or off (asserted in
  tests).

Everything here is pure host arithmetic over timestamped counters — no
device values, no blocking transfers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import List, Optional, Tuple

# Latency objectives burn against this compliance budget when no explicit
# availability objective is armed (i.e. up to 1% of requests in a window
# may miss their tier's latency target before burn exceeds 1).
DEFAULT_COMPLIANCE = 0.99


class BurnTracker:
    """Rolling multi-window error-budget accounting for one engine."""

    def __init__(self, *, strong_ms: float = 0.0, fast_ms: float = 0.0,
                 availability: float = 0.0,
                 capacity_reject_rate: float = 0.0,
                 windows_s: Tuple[float, ...] = (60.0, 600.0),
                 cap: int = 8192):
        self.strong_ms = float(strong_ms)
        self.fast_ms = float(fast_ms)
        self.availability = float(availability)
        self.capacity_reject_rate = float(capacity_reject_rate)
        self.windows_s = tuple(float(w) for w in windows_s) or (60.0,)
        self._lock = threading.Lock()
        # (t, kind, quality, latency_s) — kind: "ok" | "fail" | "reject"
        self._events: deque = deque(maxlen=int(cap))
        self._pressure_cache: Tuple[float, float] = (-1.0, 0.0)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_serve(cls, serve) -> Optional["BurnTracker"]:
        """Build a tracker from ``ServeContext`` knobs; ``None`` when no
        objective is armed (the engine then skips all SLO recording)."""
        strong = float(getattr(serve, "slo_strong_ms", 0.0) or 0.0)
        fast = float(getattr(serve, "slo_fast_ms", 0.0) or 0.0)
        avail = float(getattr(serve, "slo_availability", 0.0) or 0.0)
        rej = float(getattr(serve, "slo_capacity_reject_rate", 0.0) or 0.0)
        if not (strong or fast or avail or rej):
            return None
        windows = tuple(getattr(serve, "slo_windows_s", (60.0, 600.0))
                        or (60.0, 600.0))
        return cls(strong_ms=strong, fast_ms=fast, availability=avail,
                   capacity_reject_rate=rej, windows_s=windows)

    # -- recording (pure host; called from the ServeStats record sites) ----

    def record_request(self, quality: str, latency_s: float,
                       ok: bool) -> None:
        with self._lock:
            self._events.append((
                time.monotonic(), "ok" if ok else "fail",
                str(quality or "strong"), float(latency_s),
            ))
            self._pressure_cache = (-1.0, 0.0)

    def record_reject(self, capacity: bool = False) -> None:
        with self._lock:
            self._events.append((
                time.monotonic(), "reject" if capacity else "full", "", 0.0,
            ))
            self._pressure_cache = (-1.0, 0.0)

    # -- evaluation --------------------------------------------------------

    def _window_burns(self, window_s: float, now: float) -> dict:
        horizon = now - window_s
        ok = fail = rejects = 0
        tier_total = {"strong": 0, "fast": 0}
        tier_miss = {"strong": 0, "fast": 0}
        targets = {"strong": self.strong_ms, "fast": self.fast_ms}
        for t, kind, quality, latency_s in self._events:
            if t < horizon:
                continue
            if kind == "reject":
                rejects += 1
                continue
            if kind == "full":
                continue
            if kind == "ok":
                ok += 1
            else:
                fail += 1
            tgt = targets.get(quality, 0.0)
            if tgt > 0.0 and kind == "ok":
                tier_total[quality] += 1
                if latency_s * 1000.0 > tgt:
                    tier_miss[quality] += 1
        finished = ok + fail
        burns = {}
        compliance = self.availability or DEFAULT_COMPLIANCE
        lat_budget = max(1e-9, 1.0 - compliance)
        for tier in ("strong", "fast"):
            if targets[tier] > 0.0 and tier_total[tier]:
                frac = tier_miss[tier] / tier_total[tier]
                burns[f"latency_{tier}"] = frac / lat_budget
        if self.availability > 0.0 and finished:
            budget = max(1e-9, 1.0 - self.availability)
            burns["availability"] = (fail / finished) / budget
        if self.capacity_reject_rate > 0.0:
            submitted = finished + rejects
            if submitted:
                burns["capacity_reject"] = (
                    (rejects / submitted) / self.capacity_reject_rate
                )
        return {"window_s": window_s, "requests": finished,
                "rejects": rejects, "burn": burns}

    def summary(self) -> dict:
        """Per-window burn rates + the worst burn and the derived control
        pressure.  Pure host arithmetic over the event ring."""
        now = time.monotonic()
        with self._lock:
            windows = [self._window_burns(w, now) for w in self.windows_s]
        worst = 0.0
        for win in windows:
            for burn in win["burn"].values():
                worst = max(worst, burn)
        return {
            "armed": True,
            "objectives": {
                "strong_ms": self.strong_ms,
                "fast_ms": self.fast_ms,
                "availability": self.availability,
                "capacity_reject_rate": self.capacity_reject_rate,
            },
            "windows": windows,
            "worst_burn": worst,
            "pressure": max(0.0, worst - 1.0),
        }

    def pressure(self, max_age_s: float = 0.05) -> float:
        """The steering/autoscale control signal, memoized briefly — the
        router scores every replica per submit and must not re-scan the
        event ring each time."""
        now = time.monotonic()
        with self._lock:
            cached_at, value = self._pressure_cache
        if cached_at >= 0.0 and now - cached_at <= max_age_s:
            return value
        value = float(self.summary()["pressure"])
        with self._lock:
            self._pressure_cache = (now, value)
        return value


def prometheus_families(tracker: Optional[BurnTracker]) -> List[tuple]:
    """``kaminpar_slo_*`` families for one engine (empty when disarmed)."""
    if tracker is None:
        return []
    summ = tracker.summary()
    burn_samples = []
    for win in summ["windows"]:
        for objective, burn in win["burn"].items():
            burn_samples.append((
                {"objective": objective,
                 "window": f"{int(win['window_s'])}s"},
                burn,
            ))
    families = [
        ("kaminpar_slo_burn_rate", "gauge",
         "Error-budget burn rate per objective per rolling window "
         "(>1 = budget burning faster than the objective allows)",
         burn_samples),
        ("kaminpar_slo_worst_burn", "gauge",
         "Worst burn rate across all objectives and windows",
         [({}, summ["worst_burn"])]),
        ("kaminpar_slo_pressure", "gauge",
         "Control pressure max(0, worst_burn - 1) fed to fleet steering "
         "and autoscale",
         [({}, summ["pressure"])]),
    ]
    return [fam for fam in families if fam[3]]
