"""Serving-runtime metrics: counters, occupancy, latency percentiles
(counterpart of ``kaminpar_tpu/serve/stats.py``).

The structured snapshot the engine exposes (``PartitionEngine.stats()``)
is built on the existing observability layers — ``utils/compile_stats``
(distinct shape cells seen and the kernel builds' seconds),
``utils/sync_stats``
(blocking-transfer census), and the timer tree's phase names — plus the
serving-specific signals an operator needs: queue depth, admission /
reject / timeout counts, micro-batch occupancy, warm-cache hit rate, and
per-phase latency percentiles (queue wait, execute, total).

The JAX package's snapshot also carries the mesh-collective census
(``collective_*`` keys, from ``utils/collective_stats``); that census comes
with the port's dist tier, so this snapshot leaves those keys out.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import numpy as np


class LatencyReservoir:
    """Fixed-capacity ring of samples; summarizes to p50/p90/p99/mean/max.

    A ring (latest ``cap`` samples win) keeps steady-state serving numbers
    current instead of diluting them with warmup-era outliers."""

    def __init__(self, cap: int = 4096):
        self._cap = int(cap)
        self._buf = np.zeros(self._cap, dtype=np.float64)
        self._next = 0
        self._count = 0

    def add(self, value: float) -> None:
        self._buf[self._next % self._cap] = float(value)
        self._next += 1
        self._count = min(self._count + 1, self._cap)

    def summary(self) -> Dict[str, float]:
        if self._count == 0:
            return {"count": 0}
        vals = self._buf[: self._count]
        p50, p90, p99 = np.percentile(vals, [50, 90, 99])
        return {
            "count": int(self._count if self._next <= self._cap else self._next),
            "p50": round(float(p50), 3),
            "p90": round(float(p90), 3),
            "p99": round(float(p99), 3),
            "mean": round(float(vals.mean()), 3),
            "max": round(float(vals.max()), 3),
        }


class ServeStats:
    """Thread-safe accumulator for the engine's serving metrics."""

    _COUNTERS = (
        "submitted", "admitted", "rejected_full", "rejected_capacity",
        "timed_out", "cancelled",
        "completed", "failed", "batches", "warm_hits", "warm_misses",
        # Lane-stacked execution census:
        # batches run as one lane-stacked union, total lanes they carried,
        # cohort splits inside them, and batches that fell back to the
        # per-graph loop.
        "lanestacked_batches", "lanestacked_lanes", "lanestack_splits",
        "lanestack_fallbacks",
        # Resilience census: fast
        # admission rejects from a poisoned (open-breaker) shape cell,
        # in-flight requests force-resolved by the bounded drain after the
        # worker died/hung, watchdog deadline overruns, strong->fast
        # quality demotions, and contained warmup-pass faults.
        "rejected_poisoned", "worker_hung", "watchdog_timeouts",
        "demoted_quality", "warmup_faults",
        # Crash-safe journal census:
        # unresolved admits re-enqueued at start() and resolution records
        # appended at first-wins finalization — replay conservation means
        # every journaled admit eventually gains exactly ONE resolution.
        "journal_replayed", "journal_resolutions",
    )

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        """Zero everything (bench sweep points reset between loads)."""
        with self._lock:
            self._c = {name: 0 for name in self._COUNTERS}
            self._occupancy_sum = 0
            self._occupancy_max = 0
            self._lat = {
                "queue_wait_ms": LatencyReservoir(),
                "execute_ms": LatencyReservoir(),
                "total_ms": LatencyReservoir(),
            }
            # Smoothed per-request service seconds; feeds the retry-after
            # estimate of the admission-reject path.
            self.ema_service_s = 0.0

    def bump(self, counter: str, by: int = 1) -> None:
        with self._lock:
            self._c[counter] += by

    def record_warm(self, hit: bool) -> None:
        self.bump("warm_hits" if hit else "warm_misses")

    def record_batch(self, occupancy: int) -> None:
        with self._lock:
            self._c["batches"] += 1
            self._occupancy_sum += int(occupancy)
            self._occupancy_max = max(self._occupancy_max, int(occupancy))

    def record_request(
        self, queue_wait_s: float, execute_s: float, failed: bool = False,
        service_s: Optional[float] = None,
    ) -> None:
        """Latency percentiles take ``execute_s`` (a lane-stacked request's
        amortized share); the retry-after EMA takes ``service_s`` — the
        UNAMORTIZED cost of the dispatch that served the request (the batch
        wall for lane-stacked work) — because :meth:`retry_after_estimate`
        divides the EMA by the batch width itself.  None = execute_s."""
        with self._lock:
            self._c["failed" if failed else "completed"] += 1
            self._lat["queue_wait_ms"].add(queue_wait_s * 1e3)
            self._lat["execute_ms"].add(execute_s * 1e3)
            self._lat["total_ms"].add((queue_wait_s + execute_s) * 1e3)
            alpha = 0.2
            svc = execute_s if service_s is None else service_s
            self.ema_service_s = (
                svc if self.ema_service_s == 0.0
                else (1 - alpha) * self.ema_service_s + alpha * svc
            )

    def seed_service_time(self, seconds: float) -> None:
        """Initialize the service-time EMA from the warmup report's warm
        execution cost: retry-after estimates are real
        from the first admission reject instead of falling back to a blind
        floor until the first completion.  A live EMA (completions already
        recorded) is never overwritten."""
        with self._lock:
            if self.ema_service_s == 0.0 and seconds > 0.0:
                self.ema_service_s = float(seconds)

    def execute_p99_s(self) -> float:
        """p99 of the execute-stage reservoir in SECONDS (0.0 before any
        sample) — the fleet router's tail-latency steering term, read
        without materializing the full snapshot."""
        with self._lock:
            summary = self._lat["execute_ms"].summary()
        return float(summary.get("p99", 0.0)) / 1e3

    def service_time_estimate(self) -> float:
        """The smoothed UNAMORTIZED per-request service seconds (the EMA
        the retry-after estimate divides by the batch width; 0.0 before
        any completion or warmup seed)."""
        with self._lock:
            return float(self.ema_service_s)

    def retry_after_estimate(self, queue_depth: int, max_batch: int) -> float:
        """Backpressure hint: depth x smoothed service time / batch width,
        floored so callers never busy-spin on a zero.  The EMA is seeded
        from warmup (:meth:`seed_service_time`), so the pre-first-completion
        fallback constant only applies to engines started without warmup."""
        with self._lock:
            per = self.ema_service_s or 0.1
        return max(0.05, queue_depth * per / max(1, max_batch))

    def counter(self, name: str) -> int:
        with self._lock:
            return self._c[name]

    def snapshot(self, queue_depth: Optional[int] = None) -> dict:
        """Structured stats record (every field documented in the README
        "Serving" section)."""
        from ..utils import compile_stats, sync_stats

        with self._lock:
            counts = dict(self._c)
            batches = counts["batches"]
            out = {
                **counts,
                "batch_occupancy_mean": round(
                    self._occupancy_sum / batches, 3
                ) if batches else 0.0,
                "batch_occupancy_max": self._occupancy_max,
                "warm_hit_rate": round(
                    counts["warm_hits"]
                    / max(1, counts["warm_hits"] + counts["warm_misses"]),
                    4,
                ),
                # Mean lanes per stacked batch — the realized device
                # parallelism of the lane-stacked path.
                "lanestack_occupancy_mean": round(
                    counts["lanestacked_lanes"]
                    / counts["lanestacked_batches"], 3
                ) if counts["lanestacked_batches"] else 0.0,
                "latency_ms": {k: v.summary() for k, v in self._lat.items()},
                "ema_service_s": round(self.ema_service_s, 4),
            }
        if queue_depth is not None:
            out["queue_depth"] = int(queue_depth)
        out["compiled_shape_count"] = compile_stats.snapshot()
        out["compile"] = compile_stats.compile_time_snapshot()
        sync_snap = sync_stats.snapshot()
        out["host_sync_count"] = sync_snap["count"]
        out["host_sync_bytes"] = sync_snap["bytes"]
        return out

    def prometheus_families(
        self,
        queue_depth: Optional[int] = None,
        running: Optional[bool] = None,
        warm_cells: Optional[int] = None,
    ) -> list:
        """The snapshot as Prometheus metric families:
        ``[(name, type, help, [(labels, value), ...]), ...]`` rendered by
        ``telemetry/prometheus.py`` into
        ``PartitionEngine.metrics_text()`` / the serve CLI's ``/metrics``
        endpoint."""
        snap = self.snapshot(queue_depth=queue_depth)
        outcome_counters = (
            "submitted", "admitted", "rejected_full", "rejected_capacity",
            "rejected_poisoned", "timed_out", "cancelled", "completed",
            "failed", "worker_hung",
        )
        lat_samples = []
        count_samples = []
        for stage, summary in snap["latency_ms"].items():
            base = stage[:-3] if stage.endswith("_ms") else stage
            count_samples.append(({"stage": base}, summary.get("count", 0)))
            for quantile, key in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                if key in summary:
                    lat_samples.append(
                        ({"stage": base, "quantile": quantile}, summary[key])
                    )
        return [
            ("kaminpar_serve_queue_depth", "gauge",
             "Requests currently waiting in the bounded queue",
             [({}, snap.get("queue_depth"))]),
            ("kaminpar_serve_requests_total", "counter",
             "Requests by admission/completion outcome",
             [({"outcome": name}, snap[name]) for name in outcome_counters]),
            ("kaminpar_serve_warm_lookups_total", "counter",
             "Warm-cache lookups by result",
             [({"result": "hit"}, snap["warm_hits"]),
              ({"result": "miss"}, snap["warm_misses"])]),
            ("kaminpar_serve_warm_hit_rate", "gauge",
             "Fraction of submissions landing in a warmed shape cell",
             [({}, snap["warm_hit_rate"])]),
            ("kaminpar_serve_batches_total", "counter",
             "Micro-batches dispatched",
             [({}, snap["batches"])]),
            ("kaminpar_serve_batch_occupancy", "gauge",
             "Requests per dispatched micro-batch",
             [({"stat": "mean"}, snap["batch_occupancy_mean"]),
              ({"stat": "max"}, snap["batch_occupancy_max"])]),
            ("kaminpar_serve_lanestack_batches_total", "counter",
             "Micro-batches by lane-stack execution outcome",
             [({"result": "stacked"}, snap["lanestacked_batches"]),
              ({"result": "fallback"}, snap["lanestack_fallbacks"])]),
            ("kaminpar_serve_lanestack_lanes_total", "counter",
             "Total lanes executed by the lane-stacked pipeline",
             [({}, snap["lanestacked_lanes"])]),
            ("kaminpar_serve_lanestack_splits_total", "counter",
             "Cohort splits inside lane-stacked batches (a high split rate "
             "means lanes diverged and degenerated toward per-lane cohorts "
             "— mandatory context for any lane-stack throughput figure)",
             [({}, snap["lanestack_splits"])]),
            ("kaminpar_serve_lanestack_occupancy", "gauge",
             "Mean lanes per lane-stacked batch",
             [({}, snap["lanestack_occupancy_mean"])]),
            ("kaminpar_serve_resilience_events_total", "counter",
             "Resilience-layer events: watchdog deadline overruns, "
             "strong->fast quality demotions, contained warmup faults "
             "(breaker detail rides the "
             "kaminpar_resilience_* families)",
             [({"event": "watchdog_timeout"}, snap["watchdog_timeouts"]),
              ({"event": "demoted_quality"}, snap["demoted_quality"]),
              ({"event": "warmup_fault"}, snap["warmup_faults"])]),
            ("kaminpar_serve_latency_ms", "gauge",
             "Latency percentiles in milliseconds over the rolling reservoir",
             lat_samples),
            ("kaminpar_serve_latency_samples", "gauge",
             "Total latency samples recorded per stage (the percentile "
             "reservoir keeps only the most recent window)",
             count_samples),
            ("kaminpar_serve_ema_service_seconds", "gauge",
             "Smoothed per-request service time feeding retry-after estimates",
             [({}, snap["ema_service_s"])]),
            ("kaminpar_serve_host_sync_transfers_total", "counter",
             "Blocking device-to-host transfers (process-wide census)",
             [({}, snap["host_sync_count"])]),
            ("kaminpar_serve_host_sync_bytes_total", "counter",
             "Bytes moved by blocking device-to-host transfers (process-wide)",
             [({}, snap["host_sync_bytes"])]),
            ("kaminpar_serve_compiled_shapes", "gauge",
             "Distinct (kind, shape) cells the kernels ran on (process-wide census)",
             [({}, snap["compiled_shape_count"].get("total", 0))]),
            ("kaminpar_serve_running", "gauge",
             "Whether the engine dispatcher is accepting work",
             [({}, None if running is None else int(bool(running)))]),
            ("kaminpar_serve_warm_cells", "gauge",
             "Distinct (n-bucket, m-bucket, k) cells warmed so far",
             [({}, warm_cells)]),
        ]
