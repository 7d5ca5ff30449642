"""The partition-serving engine: one long-lived warm device context
(counterpart of ``kaminpar_tpu/serve/engine.py``).

``KaMinPar.compute_partition`` is a cold, single-graph, synchronous call.
:class:`PartitionEngine` keeps its machinery warm between requests, the
standard inference-stack shape:

* **Warmup**: at startup the engine runs one synthetic partition per cell
  of ``warm_ladder`` x ``warm_ks`` (and, with ``warm_lanes``, one
  lane-stacked batch per lane count), so every padded bucket the
  hierarchy visits below a rung has run once on this engine's device: the
  kernels are loaded and the caching allocator's segments and the pool's
  buffers exist.  "Warm" never means compiled here; the port's only
  compiles are the kernels' ``nvcc`` build at first use, which warmup
  reports (``builds``, from ``utils/compile_stats``) in
  :attr:`warmup_report`.
* **Bounded async queue**: ``submit`` runs admission control (the device
  memory preflight, the bounded queue with a retry-after estimate, the
  cells' circuit breakers) and returns a :class:`ServeFuture`; deadlines
  expire queued work, and ``shutdown(drain=True)`` drains.
* **Micro-batching**: requests of one (node-bucket, edge-bucket, k) shape
  cell are dispatched as one batch.  An eligible batch runs lane-stacked
  (``serve/lanestack.py``: kernels #1 and #3 over the union of the
  lanes); otherwise the warm facade runs each graph.  Either way every
  partition equals the sequential facade run of its request bit for bit.
  The batch's cuts and block weights come from one dispatch over the
  packed disjoint-union buffer and one readback (``serve/batching.py``).

The engine runs on ``cuda:0`` unless the caller names another device
(``device="cpu"`` runs the plain PyTorch versions, as the tests do).  A
synchronous wrapper (:meth:`partition`) lets the facade delegate to a warm
engine (``KaMinPar(ctx, engine=...)``).
"""

from __future__ import annotations

import copy
import itertools
import threading
import time
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Union

import numpy as np

from ..context import Context, ServeContext
from .batching import ShapeCell, batched_metrics, pack_graphs, shape_cell
from .errors import (
    CapacityError,
    DeadlineExceededError,
    EngineStoppedError,
    QueueFullError,
    RequestCancelledError,
)
from .queue import BoundedServeQueue
from .stats import ServeStats


@dataclass
class ServeResult:
    """What a fulfilled request resolves to."""

    partition: np.ndarray
    cut: int
    feasible: bool
    batch_size: int
    queue_wait_s: float
    execute_s: float
    warm_hit: bool
    request_id: int


class ServeFuture:
    """Completion handle for a submitted request."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        self._ev = threading.Event()
        self._result: Optional[ServeResult] = None
        self._error: Optional[BaseException] = None
        self._cancelled = False
        self._started = False
        # First-wins claim, distinct from the waiter event:
        # the finalization hook must run BETWEEN claiming the outcome and
        # releasing the waiter — a caller must never act on a result the
        # journal has not recorded — so _done claims under the lock,
        # _on_done fires outside it, and only then does _ev wake waiters.
        self._done = False
        self._lock = threading.Lock()
        # Finalization hook: invoked exactly
        # once — on the FIRST-WINS resolution/rejection, outside the lock
        # but BEFORE the waiter event — with (result | None, error |
        # None).  The engine points it at the journal's resolution
        # writer, so every terminal path (dispatcher, watchdog, deadline,
        # drain) journals through one funnel.
        self._on_done = None

    def cancel(self) -> bool:
        """Cancel if execution has not started; returns success.  A running
        device computation cannot be interrupted: late cancels return False."""
        with self._lock:
            if self._started or self._done:
                return False
            self._cancelled = True
        return True

    @property
    def cancelled(self) -> bool:
        with self._lock:
            return self._cancelled

    def _mark_started(self) -> bool:
        """Engine-side: claim the request for execution; False if it was
        cancelled first."""
        with self._lock:
            if self._cancelled:
                return False
            self._started = True
            return True

    def _resolve(self, result: ServeResult) -> bool:
        """First resolution wins: the execution watchdog may
        force-reject a hung batch's futures from its monitor thread; if
        the abandoned dispatch later returns, its late result is
        discarded here.  Returns whether THIS call resolved the future.

        The finalization hook fires BEFORE the waiter event:
        a journaled resolution must be durable before ``result()`` can
        return it (serve/journal.py durability contract)."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self._result = result
        self._fire_on_done(result, None)
        self._ev.set()
        return True

    def _reject(self, error: BaseException) -> bool:
        with self._lock:
            if self._done:
                return False
            self._done = True
            self._error = error
        self._fire_on_done(None, error)
        self._ev.set()
        return True

    def _fire_on_done(self, result, error) -> None:
        cb = self._on_done
        if cb is None:
            return
        try:
            cb(result, error)
        except Exception:  # noqa: BLE001 — a journaling failure must never
            pass           # un-resolve a finished request

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        """Block for the result; raises the request's error (deadline,
        cancellation, engine-stopped, or the pipeline's own exception)."""
        if not self._ev.wait(timeout):
            raise TimeoutError(
                f"request {self.request_id} not finished within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result


@dataclass
class ServeRequest:
    """One queued unit of work (internal; carries the batching cell)."""

    id: int
    graph: object
    k: int
    epsilon: float
    cell: ShapeCell
    future: ServeFuture
    enqueue_t: float
    deadline_t: Optional[float]  # absolute monotonic; None = no deadline
    warm_hit: bool
    max_block_weights: Optional[Sequence[int]] = None
    min_epsilon: float = 0.0
    min_block_weights: Optional[Sequence[int]] = None
    # Quality tier: "strong" = the engine's full pipeline;
    # "fast" = the trimmed-refinement solver.  The quality_strong ->
    # quality_fast ladder rung demotes strong requests per shape cell
    # under capacity-class failures (counted, reversible).
    quality: str = "strong"
    # Request-scoped trace id: minted at
    # submit (or inherited from the fleet / the journal on replay) and
    # carried for the request's whole life — one connected event chain per
    # request even across resteers and crash replays.
    trace_id: str = ""
    # Queue depth observed at admission (stamped by BoundedServeQueue.put;
    # rides the admit trace event).
    queue_position: int = 0
    # The tier that actually served the request ("" until dispatch; may
    # differ from ``quality`` under a quality_strong demotion) — warm
    # accounting is tier-keyed, because the two tiers compile different
    # executable sets.
    quality_served: str = ""
    # Filled during execution:
    partition: Optional[np.ndarray] = None
    caps: Optional[np.ndarray] = None
    execute_s: float = 0.0
    queue_wait_s: float = 0.0
    # Unamortized service cost feeding the retry-after EMA.  Lane-stacked
    # requests report execute_s = batch wall / occupancy (the latency
    # share), but the drain-rate estimate divides the EMA by max_batch
    # itself — feeding it the amortized share would double-count the batch
    # width.  None = use execute_s (the per-graph loop, where they agree).
    service_s: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.deadline_t is not None and now > self.deadline_t


class PartitionEngine:
    """Persistent partition-serving runtime over one warm device context.

    Usage::

        from kaminpar_tpu_torch.serve import PartitionEngine
        with PartitionEngine("serve") as engine:        # on cuda:0; starts + warms
            fut = engine.submit(graph, k=8)             # async
            part = fut.result().partition
            part2 = engine.partition(graph2, k=8)       # sync wrapper

    Thread model: ``submit``/``partition`` are called from any thread; a
    single dispatcher thread owns the pipeline (batch formation, the warm
    facade, the packed metrics dispatch), so device work is never launched
    concurrently and per-request RNG streams stay deterministic.
    """

    def __init__(
        self,
        ctx: Union[Context, str, None] = None,
        name: str = "",
        device=None,
        **serve_overrides,
    ):
        from ..kaminpar import resolve_device
        from ..presets import create_context_by_preset_name

        # cuda:0 unless the caller names a device; no CPU fallback
        self.device = resolve_device(device)

        # Replica tag: names the dispatcher
        # thread (so per-replica trace lanes fall out of the trace
        # recorder's thread_name metadata) and prefixes log/warning text.
        self.name = str(name)

        if ctx is None:
            ctx = create_context_by_preset_name("serve")
        elif isinstance(ctx, str):
            ctx = create_context_by_preset_name(ctx)
        else:
            # The engine owns its tree: a caller mutating the context they
            # passed must not skew results of in-flight requests.
            ctx = copy.deepcopy(ctx)
        self.ctx = ctx
        if serve_overrides:
            ctx.serve = replace(ctx.serve, **serve_overrides)
        self.serve: ServeContext = ctx.serve
        # This engine owns its runtime (its device and sync-timer flag),
        # made current on the thread around every engine-side pipeline run,
        # so engines on different devices coexist in one process.
        from ..context import EngineRuntime
        from ..utils import timer as _timer

        self.runtime = EngineRuntime(str(self.device), _timer.sync_mode())
        lane_mode = str(getattr(self.serve, "lane_stack", "off")).strip().lower()
        if lane_mode not in ("auto", "on", "off"):
            raise ValueError(
                f"ServeContext.lane_stack {self.serve.lane_stack!r}: "
                "expected 'auto', 'on', or 'off'"
            )
        self._queue = BoundedServeQueue(self.serve.queue_bound)
        self.stats_ = ServeStats()
        # Request-scoped tracing and SLO burn accounting
        # (telemetry/{reqtrace,slo}.py).  A fleet replaces ``reqtrace`` with
        # one registry shared across its replicas so resteered requests
        # keep one connected event chain.  ``_slo`` is None unless the
        # ServeContext arms at least one objective.
        from ..telemetry.reqtrace import ReqTrace
        from ..telemetry.slo import BurnTracker

        self.reqtrace = ReqTrace()
        self._slo = BurnTracker.from_serve(self.serve)
        # (n_bucket, k, tier): warm-hit accounting, keyed by the quality
        # tier that served the cell (the two tiers run different pipelines,
        # so a fast-served cell is not warm for strong).
        self._warm_nk: set = set()
        self._warm_cells: set = set()  # exact (n_bucket, m_bucket, k) cells
        # Lane-stack shape keys THIS engine has already run (warmup rows or
        # a served batch): (LaneStackReport.layout_key, k, epsilon).
        self._warm_stack_keys: set = set()
        # Unified resilience layer:
        # this engine owns a private breaker registry for the serve-tier
        # ladder rungs: per-cell "lanestack" breakers (reversible by
        # half-open probing), per-cell "cell" breakers (a poisoned shape cell
        # fast-fails new admissions instead of wedging the queue), and
        # per-cell "quality_strong" breakers (capacity-class failures
        # demote strong requests to the fast tier).  The watchdog bounds
        # hung executes.
        from ..resilience.breakers import BreakerRegistry
        from ..resilience.watchdog import ExecutionWatchdog

        self.resilience = ctx.resilience
        self.breakers = BreakerRegistry(
            threshold=self.resilience.breaker_threshold,
            cooldown_s=self.resilience.breaker_cooldown_s,
        )
        self.watchdog = ExecutionWatchdog(self.resilience.dossier_path)
        self.warmup_report: List[dict] = []
        # True once a journal's warm-state record restored the warm state
        # of the engine that wrote it; the warmup passes then skip every
        # restored cell and the auxiliary passes.
        self._inherited = False
        # Requests currently being executed by the dispatcher (the bounded
        # shutdown force-resolves these when the worker dies mid-batch).
        self._inflight: List[ServeRequest] = []
        # Lazily-built trimmed-refinement solver serving quality="fast"
        # requests and quality_strong demotions.
        self._fast_solver = None
        # Whether THIS engine armed the process-wide fault plan (start()
        # arms, shutdown() disarms — injections must not outlive us).
        self._armed_faults = False
        # Admission-preflight ceiling: resolved lazily at start()
        # — explicit override > measured allocator limit > device-kind
        # table; None disables (no ceiling is knowable, e.g. CPU without
        # allocator stats).
        self._capacity_ceiling: Optional[int] = None
        self._device_kind: str = ""
        # Crash-safe journal: admitted
        # requests are journaled at admit and at first-wins resolution;
        # start() replays unresolved entries + restores the warm state.
        # Env KPTPU_SERVE_JOURNAL overrides (reaches child processes).
        import os as _os

        env_journal = _os.environ.get("KPTPU_SERVE_JOURNAL", "")
        if env_journal and self.name:
            # A fleet's replicas all see the same env var: suffix by the
            # engine name or N engines would interleave one journal file
            # with colliding request ids (the context-knob path gets its
            # per-replica suffix from the fleet constructor).
            env_journal += f".{self.name}"
        self._journal_path = env_journal or getattr(
            self.serve, "journal_path", ""
        )
        self._journal = None
        self._ids = itertools.count(1)
        self._solver = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._gate = threading.Event()  # pause/resume; set == dispatching
        self._gate.set()
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True) -> "PartitionEngine":
        """Initialize the warm context (idempotent).  ``warmup=True`` runs
        the warmup ladder before the first request is accepted."""
        with self._lock:
            if self._running:
                return self
            if self._queue.closed:
                # Restart after shutdown: the old queue was closed to drain
                # the dispatcher, so a fresh one is needed (warm state —
                # solver caches, warm cells, stats — carries over).
                self._queue = BoundedServeQueue(self.serve.queue_bound)
            from ..kaminpar import KaMinPar

            # The internal facade owns an EngineRuntime built from the same
            # context, so its per-graph runs see this engine's settings
            # regardless of other engines in the process.
            if self._solver is None:
                self._solver = KaMinPar(copy.deepcopy(self.ctx), device=self.device)
            # Always count the native builds (idempotent): the lane-stack
            # dispatch reads them for its warm-hit accounting, also on
            # warmup=False engines.
            from ..utils import compile_stats

            compile_stats.enable_compile_time_tracking()
            if self.resilience.fault_plan:
                # Arm the context's chaos plan process-wide (seed-keyed, so
                # the run replays bit-for-bit); env KPTPU_FAULTS outranks
                # it by arming earlier via the lazy env discovery.  The
                # engine remembers that IT armed and disarms at shutdown —
                # chaos injections must not outlive the engine and leak
                # into unrelated engines/pipelines in the process.
                from ..resilience import faults

                if faults.active_plan() is None:
                    faults.arm(faults.FaultPlan.parse(
                        self.resilience.fault_plan,
                        seed=self.resilience.fault_seed,
                    ))
                    self._armed_faults = True
                else:
                    import warnings

                    warnings.warn(
                        "kaminpar_tpu_torch serve: a fault plan is already "
                        "armed in this process — this engine's "
                        "resilience.fault_plan is ignored (one plan per "
                        "process; disarm the active one first).",
                        RuntimeWarning,
                        stacklevel=2,
                    )
            recovery = None
            if self._journal_path and self._journal is None:
                # Crash recovery: parse the
                # journal BEFORE warmup: the warm-state record seeds the
                # warm sets through the inheritance path, so warmup below
                # skips the restored cells; unresolved admits replay once
                # the queue exists.
                from . import journal as _journal

                recovery = _journal.read_journal(self._journal_path)
                if recovery["max_id"]:
                    # Resume the id counter past the dead run's ids so a
                    # fresh admission can never collide with a journal
                    # entry awaiting replay.
                    self._ids = itertools.count(recovery["max_id"] + 1)
                if recovery["warm_state"] is not None:
                    _journal.apply_warm_state(self, recovery["warm_state"])
            try:
                self._resolve_capacity_ceiling()
                if warmup:
                    self._warmup()
            except BaseException:
                # start() failing after arming must not leak the chaos
                # plan into the process (shutdown's disarm is unreachable
                # for a never-running engine).
                self._disarm_faults()
                raise
            if recovery is not None:
                from ..utils.timer import scoped_timer
                from . import journal as _journal

                self._journal = _journal.ServeJournal(
                    self._journal_path,
                    fsync_every=self.serve.journal_fsync_every,
                )
                # Durable warm state as of THIS start (first runs write
                # their fresh warmup here; restarts refresh the record).
                self._journal.append(
                    _journal.warm_state_record(self), force_fsync=True
                )
                if recovery["unresolved"]:
                    with scoped_timer("journal_replay"):
                        self._replay_journal(recovery["unresolved"])
            self._running = True
            thread_name = "kaminpar-serve-dispatch" + (
                f"-{self.name}" if self.name else ""
            )
            self._thread = threading.Thread(
                target=self._loop, name=thread_name, daemon=True
            )
            self._thread.start()
        return self

    def _resolve_capacity_ceiling(self) -> None:
        """Resolve the admission-preflight ceiling: the explicit
        ServeContext override, else the card's allocator limit
        (``heap_profiler.memory_summary()["bytes_limit"]``), else the
        device-kind table (telemetry/capacity.py); None when nothing is
        knowable (the CPU)."""
        import torch

        from ..telemetry import capacity
        from ..utils import heap_profiler

        self._device_kind = (torch.cuda.get_device_name(self.device)
                             if self.device.type == "cuda" else "")
        explicit = int(getattr(self.serve, "capacity_ceiling_bytes", 0) or 0)
        if explicit > 0:
            self._capacity_ceiling = explicit
            return
        limit = (heap_profiler.memory_summary().get("bytes_limit")
                 if self.device.type == "cuda" else None)
        if limit:
            # the allocator's whole pool; the table path applies the
            # planner's headroom instead
            self._capacity_ceiling = int(limit)
            return
        self._capacity_ceiling = capacity.device_ceiling_bytes(self._device_kind)

    def _capacity_preflight(self, graph, k: int) -> None:
        """Reject a predicted-oversize request with :class:`CapacityError`
        BEFORE it is queued: host arithmetic over the graph's padded shape
        cell, no device work.  Nothing happens when the preflight is off
        or no ceiling is knowable."""
        mode = str(getattr(self.serve, "capacity_preflight", "auto")).strip().lower()
        if mode == "off" or self._capacity_ceiling is None:
            return
        from ..telemetry import capacity
        from ..utils.timer import scoped_timer

        try:
            with scoped_timer("capacity_preflight"):
                capacity.preflight(graph, k, ceiling_bytes=self._capacity_ceiling,
                                   device_kind=self._device_kind)
        except CapacityError:
            self.stats_.bump("rejected_capacity")
            from ..telemetry import trace as ttrace

            rec = ttrace.active()
            if rec is not None:
                rec.instant(
                    "serve.reject_capacity", k=int(k),
                    ceiling_bytes=self._capacity_ceiling,
                )
            raise

    def _warm_row(self, before: dict, wall: float, **fields) -> dict:
        """A warmup-report row: ``fields``, the wall and the native builds
        (``builds``, ``backend_compile_s``) that ran during it."""
        from ..utils import compile_stats

        after = compile_stats.compile_time_snapshot()
        return {
            **fields,
            "wall_s": round(wall, 3),
            "builds": after["compile_events"] - before["compile_events"],
            "backend_compile_s": round(
                after["backend_compile_s"] - before["backend_compile_s"], 3),
            "trace_s": 0.0,
        }

    def _warmup(self) -> None:
        """Run one synthetic RMAT partition per warm_ladder x warm_ks cell
        on this engine's device; every padded bucket the hierarchy visits
        below each rung runs too.  Cells restored from a journal are
        skipped."""
        from ..graph.generators import rmat_graph
        from ..utils import compile_stats

        # one synthetic graph per rung, shared by every warm pass
        rung_graphs: dict = {}

        def rung_graph(n):
            if n not in rung_graphs:
                scale = max(2, int(np.ceil(np.log2(max(int(n), 4)))))
                rung_graphs[n] = (scale, rmat_graph(
                    scale, edge_factor=self.serve.warm_edge_factor, seed=1
                ))
            return rung_graphs[n]

        compile_stats.enable_compile_time_tracking()
        from ..resilience.errors import ResilienceError, classify
        from ..resilience.faults import maybe_inject

        try:
            # Named "warmup" injection point: a warmup-pass fault degrades
            # the engine to cold-start serving, never fails start().
            maybe_inject("warmup", site="engine_warmup")
        except ResilienceError as exc:
            self._warmup_fault(exc, "warmup pass")
            return
        for n in self.serve.warm_ladder:
            for k in self.serve.warm_ks:
                scale, g = rung_graph(n)
                if k > (1 << scale):
                    continue
                cell = shape_cell(g, k)
                if self._inherited and cell in self._warm_cells:
                    continue  # imported: already warm
                before = compile_stats.compile_time_snapshot()
                t0 = time.perf_counter()
                try:
                    maybe_inject("compile", site=f"warmup_cell:{n}:{k}")
                    with self.watchdog.guard(
                        "warmup_compile", self.resilience.compile_timeout_s,
                        on_timeout=lambda d, c=cell: self._on_hang(c, d),
                    ):
                        self._solver.set_graph(g)
                        self._solver.compute_partition(int(k), 0.03)
                except Exception as exc:  # noqa: BLE001 — one poisoned warm
                    # cell must not abort the ladder; classify, count,
                    # keep warming the rest.
                    self._warmup_fault(
                        classify(exc, site=f"warmup_cell:{n}:{k}"),
                        f"warm cell (n={n}, k={k})",
                    )
                    continue
                self.warmup_report.append(self._warm_row(
                    before, time.perf_counter() - t0, n=1 << scale, k=int(k),
                    n_bucket=cell.n_bucket, m_bucket=cell.m_bucket))
                self._note_warm(cell)
        if not self._inherited:
            self._warm_ip_pool(rung_graph)
            self._warm_lanestack(rung_graph)
        # Seed the retry-after service-time EMA from the warm runs' walls
        # less their builds, so the first admission rejects carry a real
        # estimate; inherited rows (zero wall) are left out.
        execs = [
            max(r["wall_s"] - r["backend_compile_s"], 1e-3)
            for r in self.warmup_report
            if "kind" not in r and not r.get("inherited")
        ]
        if execs:
            self.stats_.seed_service_time(float(np.mean(execs)))

    def _warmup_fault(self, err, what: str) -> None:
        """Count + surface one contained warmup failure (typed; the engine
        serves cold-start for whatever was not warmed)."""
        import warnings

        self.stats_.bump("warmup_faults")
        warnings.warn(
            f"kaminpar_tpu_torch serve: {what} failed during warmup "
            f"({err.failure_class}: {err}); continuing, and unwarmed cells "
            "pay their first run on the first request.",
            RuntimeWarning,
            stacklevel=3,
        )

    def _on_hang(self, cell: ShapeCell, dossier: dict,
                 live: Optional[List[ServeRequest]] = None) -> None:
        """Watchdog timeout callback (monitor thread): convert the hang
        into a breaker trip + typed future resolutions instead of a
        killed process.  The hung dispatch itself is abandoned; the
        idempotent futures discard its late result."""
        from ..resilience.errors import ExecuteFault

        self.stats_.bump("watchdog_timeouts")
        key = (cell.n_bucket, cell.m_bucket, cell.k)
        # Force the trip (not one counted failure): each further probe of
        # a hung cell wedges the single dispatcher thread for a full
        # deadline; one observed hang is conclusive, the next request
        # fast-fails with PoisonedCell until the cooldown's half-open
        # probe.
        self.breakers.get("cell", key).trip()
        for req in (live or []):
            if req.future._reject(ExecuteFault(
                f"request {req.id} abandoned: {dossier['phase']} exceeded "
                f"the {dossier['timeout_s']}s watchdog deadline in cell "
                f"{key} (dossier on engine.stats()['resilience'])",
                site="watchdog",
            )):
                self._trace_event(req, "error", final=False,
                                  failure_class="worker-hung",
                                  site="watchdog")
                self.stats_.record_request(
                    time.monotonic() - req.enqueue_t, 0.0, failed=True
                )

    def _warm_lanestack(self, rung_graph) -> None:
        """Run the lane-stacked pipeline once per (rung, k, lane count)
        cell (``serve.warm_lanes``; kind="lanestack" report rows): L copies
        of the rung's synthetic graph, one cohort, every union step of the
        lockstep pipeline at lane count L."""
        if self._lane_stack_mode() == "off" or not self.serve.warm_lanes:
            return
        from ..utils import compile_stats
        from .lanestack import LaneStackUnsupported, run_lanestacked

        for n in self.serve.warm_ladder:
            scale, g = rung_graph(n)
            for k in self.serve.warm_ks:
                if k < 2 or k > (1 << scale):
                    continue  # per-cell envelope bound, not config-wide
                for lanes in self.serve.warm_lanes:
                    before = compile_stats.compile_time_snapshot()
                    t0 = time.perf_counter()
                    try:
                        with self.runtime.activate():
                            _, rep = run_lanestacked(
                                self._solver.ctx, [g] * int(lanes), int(k), 0.03,
                                device=self.device,
                            )
                    except LaneStackUnsupported:
                        return  # config outside the envelope: nothing to warm
                    self._warm_stack_keys.add((rep.layout_key, int(k), 0.03))
                    cell = shape_cell(g, int(k))
                    self.warmup_report.append(self._warm_row(
                        before, time.perf_counter() - t0, kind="lanestack",
                        n=1 << scale, k=int(k), n_bucket=cell.n_bucket,
                        m_bucket=cell.m_bucket, lanes=int(lanes)))

    def _warm_ip_pool(self, rung_graph) -> None:
        """One device-pool bisection per (rung, lane layout) cell: the lane
        layouts the adaptive repetition rule picks for every final k of
        the warm ks' bisection chains, on the rung's synthetic graph.
        Nothing is compiled; the run leaves the pool's buffers in the
        allocator.  Device backend only: the host pool keeps no device
        state."""
        from ..initial.bipartitioner import resolve_ip_backend
        from ..ops import bipartition as bip
        from ..partitioning.kway import graph_to_host
        from ..utils import compile_stats

        ipc = self.ctx.initial_partitioning
        if resolve_ip_backend(ipc, self.device) != "device":
            return
        # Recursive bisection halves final_k per level (k, ceil(k/2), ...,
        # 2), and each final_k maps to its own lane layout through the
        # adaptive repetition rule: warm the whole chain.
        finals = {}
        for k in (2, *self.serve.warm_ks):
            k = int(k)
            while k > 1:
                finals.setdefault(bip.method_lane_counts(ipc, k)[0], k)
                k = (k + 1) // 2 if k > 2 else 1
        for n in self.serve.warm_ladder:
            g = rung_graph(n)[1]
            host = graph_to_host(g)
            pv = g.padded()
            total = int(host.node_w.sum())
            max_w = np.full(2, (total + 1) // 2 + int(host.node_w.max()), dtype=np.int64)
            for methods, final_k in sorted(finals.items()):
                before = compile_stats.compile_time_snapshot()
                t0 = time.perf_counter()
                with self.runtime.activate():
                    bip.pool_bipartition_device(
                        host.row_ptr, host.col_idx, host.node_w, host.edge_w, max_w,
                        1, ipc, final_k, device=self.device)
                self.warmup_report.append(self._warm_row(
                    before, time.perf_counter() - t0, kind="ip_pool", n=int(n), k=2,
                    n_bucket=pv.n_pad, m_bucket=pv.m_pad,
                    lanes=sum(cnt for _, cnt in methods)))

    def _note_warm(self, cell: ShapeCell, tier: str = "strong") -> None:
        self._warm_cells.add(cell)
        self._warm_nk.add((cell.n_bucket, cell.k, tier))

    @property
    def running(self) -> bool:
        return self._running

    def pause(self) -> None:
        """Hold the dispatcher (maintenance window; queued work waits IN
        the queue — where a fleet drain can requeue it — and admission
        stays open up to the queue bound).  Takes effect before the next
        batch is *extracted*: the gate-aware pop leaves work queued, so a
        paused burst accumulates to full batches."""
        self._gate.clear()

    def resume(self) -> None:
        self._gate.set()
        self._queue.poke()

    def shutdown(self, drain: bool = True, timeout_s: Optional[float] = None) -> None:
        """Stop the engine.  ``drain=True`` serves everything already
        queued first; ``drain=False`` rejects queued work with
        :class:`EngineStoppedError`.  Idempotent.

        The drain is bounded: if the dispatcher thread dies or hangs
        mid-batch, everything still unresolved (queued + in-flight) is
        force-resolved with a typed ``resilience.errors.WorkerHung`` after
        ``timeout_s`` (default ``ServeContext.drain_timeout_s``) instead
        of blocking callers forever."""
        with self._lock:
            if not self._running:
                return
            self._queue.close()
            if not drain:
                for req in self._queue.drain_items():
                    self.stats_.bump("cancelled")
                    req.future._reject(
                        EngineStoppedError("engine shut down before execution")
                    )
            self._gate.set()
            thread = self._thread
        if thread is not None:
            # `is not None`, not truthiness: an explicit timeout_s=0.0
            # means "force-resolve immediately", not "use the default".
            budget = (
                timeout_s if timeout_s is not None
                else self.serve.drain_timeout_s
            )
            thread.join(budget)
            if thread.is_alive():
                # The worker is hung (or wedged on a poisoned batch): the
                # drain contract still holds — every outstanding future is
                # resolved, with a typed error naming the cause.
                from ..resilience.errors import WorkerHung

                stuck = list(self._queue.drain_items())
                with self._lock:
                    stuck.extend(self._inflight)
                hung = 0
                for req in stuck:
                    if req.future._reject(WorkerHung(
                        f"request {req.id} unresolved: the dispatcher "
                        "thread did not finish draining within "
                        f"{budget}s "
                        "(worker dead or hung mid-batch)",
                        site="shutdown",
                    )):
                        hung += 1
                        self.stats_.record_request(
                            time.monotonic() - req.enqueue_t, 0.0, failed=True
                        )
                if hung:
                    self.stats_.bump("worker_hung", hung)
        # Final warm-state record + journal close (fsynced): a clean
        # shutdown leaves zero unresolved entries — EngineStopped/
        # WorkerHung force-resolutions above deliberately stay
        # UNRESOLVED in the journal so a restart replays them.
        self._close_journal()
        self._disarm_faults()
        with self._lock:
            self._running = False

    def _disarm_faults(self) -> None:
        """Disarm the process-wide fault plan iff THIS engine armed it."""
        if self._armed_faults:
            from ..resilience import faults

            faults.disarm()
            self._armed_faults = False

    # -- crash-safe journal -------------------

    def _journal_admit(self, req: ServeRequest) -> None:
        """Journal one accepted request (admit record: params + graph
        payload, ONE counted bulk pull under ``journal_write``).  The
        future's resolution hook is installed by the submit path BEFORE
        the queue insert — a dispatcher racing ahead of this append just
        writes the resolve record first, which read_journal tolerates."""
        from ..utils.timer import scoped_timer
        from . import journal as _journal

        with scoped_timer("journal_write"):
            record = {
                "t": "admit",
                "id": req.id,
                "k": req.k,
                "epsilon": req.epsilon,
                "quality": req.quality,
                "min_epsilon": req.min_epsilon,
                "max_block_weights": (
                    None if req.max_block_weights is None
                    else [int(x) for x in req.max_block_weights]
                ),
                "min_block_weights": (
                    None if req.min_block_weights is None
                    else [int(x) for x in req.min_block_weights]
                ),
                # Trace continuity across crashes: replay
                # re-binds the replayed request to this id, so the
                # restarted process extends the SAME event chain.
                "trace_id": req.trace_id,
                "graph": _journal.encode_graph(req.graph),
            }
            self._journal.append(record)

    def _journal_resolution(self, jid: int, result, error) -> None:
        """Append the terminal record of journal entry ``jid`` — except
        for "the engine gave it back" classes (EngineStoppedError /
        WorkerHung), which leave the entry unresolved so a restart
        replays it (losing accepted work is the one thing the journal
        exists to prevent)."""
        jr = self._journal
        if jr is None:
            return
        if error is not None:
            from ..resilience.errors import WorkerHung

            if isinstance(error, (EngineStoppedError, WorkerHung)):
                return
            record = {
                "t": "resolve", "id": jid, "ok": 0,
                "error": getattr(
                    error, "failure_class", type(error).__name__
                ),
            }
        else:
            record = {
                "t": "resolve", "id": jid, "ok": 1,
                "cut": int(result.cut), "feasible": int(result.feasible),
            }
        jr.append(record, force_fsync=True)
        self.stats_.bump("journal_resolutions")

    def _replay_journal(self, entries) -> None:
        """Re-enqueue the journal's unresolved admits idempotently: each
        replayed request keeps its ORIGINAL journal id for the resolution
        record (no second admit record is written), runs without a
        deadline (the original deadline died with its process), and
        bypasses the admission bound — the work was admitted once
        already.  Decode is host->device puts only (zero pulls)."""
        from . import journal as _journal

        now = time.monotonic()
        for entry in entries:
            try:
                graph = _journal.decode_graph(entry["graph"])
            except (KeyError, ValueError) as exc:
                import warnings

                warnings.warn(
                    f"kaminpar_tpu_torch serve: journal entry {entry.get('id')} "
                    f"unreplayable ({type(exc).__name__}: {exc}) — skipped",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            cell = shape_cell(graph, int(entry["k"]))
            quality = str(entry.get("quality", "strong"))
            req = ServeRequest(
                id=next(self._ids),
                graph=graph,
                k=int(entry["k"]),
                epsilon=float(entry["epsilon"]),
                cell=cell,
                future=ServeFuture(0),
                enqueue_t=now,
                deadline_t=None,
                warm_hit=(cell.n_bucket, int(entry["k"]), quality)
                in self._warm_nk,
                max_block_weights=entry.get("max_block_weights"),
                min_epsilon=float(entry.get("min_epsilon", 0.0) or 0.0),
                min_block_weights=entry.get("min_block_weights"),
                quality=quality,
                trace_id=str(entry.get("trace_id", "") or ""),
            )
            req.future.request_id = req.id
            req.future._on_done = (
                lambda result, error, _id=int(entry["id"]):
                    self._journal_resolution(_id, result, error)
            )
            # Trace continuity: re-bind the journaled trace id
            # (minting a fresh one only for journals without one) under
            # BOTH the new engine id and the original journal id, record a
            # replayed admit + an explicit journal_replay hop — the
            # restarted process extends the same event chain the dead one
            # started, so explain() shows admit -> replay -> resolution
            # connected.
            if not req.trace_id:
                req.trace_id = self.reqtrace.mint()
            self.reqtrace.bind(req.id, req.trace_id)
            self.reqtrace.bind(int(entry["id"]), req.trace_id)
            self.reqtrace.record(
                req.trace_id, "admit", request_id=req.id,
                engine=self.name, k=req.k, quality=quality,
                replayed=True, journal_id=int(entry["id"]),
            )
            self.reqtrace.record(
                req.trace_id, "journal_replay", request_id=req.id,
                engine=self.name, journal_id=int(entry["id"]),
            )
            self.stats_.record_warm(req.warm_hit)
            self._queue.put(req, force=True)
            self.stats_.bump("journal_replayed")

    def _close_journal(self) -> None:
        jr = self._journal
        if jr is None:
            return
        from . import journal as _journal

        try:
            jr.append(_journal.warm_state_record(self), force_fsync=True)
        finally:
            jr.close()
            self._journal = None
        try:
            # Clean shutdown compacts the history down to what recovery
            # needs (unresolved admits + the final warm state): an
            # append-only file would otherwise grow one graph payload
            # per request forever and tax every restart's parse.
            _journal.compact(jr.path)
        except OSError as exc:
            import warnings

            warnings.warn(
                f"kaminpar_tpu_torch serve: journal compaction failed "
                f"({exc}); the full history remains valid",
                RuntimeWarning,
                stacklevel=2,
            )

    def __enter__(self) -> "PartitionEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=True)

    # -- request path ------------------------------------------------------

    def submit(
        self,
        graph,
        k: int,
        epsilon: float = 0.03,
        *,
        deadline_ms: Optional[float] = None,
        max_block_weights: Optional[Sequence[int]] = None,
        min_epsilon: float = 0.0,
        min_block_weights: Optional[Sequence[int]] = None,
        quality: str = "strong",
        trace_id: str = "",
    ) -> ServeFuture:
        """Enqueue one partition request; returns a :class:`ServeFuture`.

        Raises :class:`EngineStoppedError` when not running,
        :class:`QueueFullError` (with ``retry_after_s``) when admission
        control rejects the request, and
        ``resilience.errors.PoisonedCell`` (with
        ``retry_after_s``) when the request's shape cell tripped its
        circuit breaker — a deterministically failing cell fast-fails at
        admission instead of wedging the queue.

        ``quality``: "strong" (the engine's full pipeline) or "fast"
        (trimmed refinement — the tiered-SLO knob; strong requests can be
        demoted per cell by the quality_strong ladder rung under
        capacity-class failures).

        ``trace_id``: request-scoped trace id — the fleet
        passes the id it minted at steer time so the engine extends the
        same event chain; direct callers leave it empty and the engine
        mints one (queryable via :meth:`explain`)."""
        if quality not in ("strong", "fast"):
            raise ValueError(
                f"quality must be 'strong' or 'fast', got {quality!r}"
            )
        if not self._running:
            raise EngineStoppedError("engine not started (call start())")
        self.stats_.bump("submitted")
        from ..resilience.errors import PoisonedCell
        from ..resilience.faults import maybe_inject

        tid = str(trace_id) or self.reqtrace.mint()
        maybe_inject("queue-admit", site="submit")
        try:
            self._capacity_preflight(graph, k)
        except CapacityError:
            self.reqtrace.record(tid, "reject", engine=self.name,
                                 reason="capacity")
            if self._slo is not None:
                self._slo.record_reject(capacity=True)
            raise
        cell = shape_cell(graph, k)
        cell_key = (cell.n_bucket, cell.m_bucket, cell.k)
        cell_breaker = self.breakers.get("cell", cell_key)
        if not cell_breaker.allow():
            # Poisoned cell: reject fast with the cooldown as the retry
            # hint; the post-cooldown half-open probe re-admits ONE
            # request, and its success restores the cell.
            self.stats_.bump("rejected_poisoned")
            self.reqtrace.record(tid, "reject", engine=self.name,
                                 reason="poisoned")
            raise PoisonedCell(
                cell_key, cell_breaker.retry_after_s(), site="submit"
            )
        warm = (cell.n_bucket, int(k), quality) in self._warm_nk
        self.stats_.record_warm(warm)
        if deadline_ms is None:
            deadline_ms = self.serve.default_deadline_ms
        now = time.monotonic()
        req = ServeRequest(
            id=next(self._ids),
            graph=graph,
            k=int(k),
            epsilon=float(epsilon),
            cell=cell,
            future=ServeFuture(0),
            enqueue_t=now,
            deadline_t=now + deadline_ms / 1e3 if deadline_ms else None,
            warm_hit=warm,
            max_block_weights=max_block_weights,
            min_epsilon=float(min_epsilon),
            min_block_weights=min_block_weights,
            quality=quality,
            trace_id=tid,
        )
        req.future.request_id = req.id
        from ..telemetry import trace as ttrace

        rec = ttrace.active()
        if self._journal is not None:
            # Install the resolution funnel BEFORE the queue insert: the
            # dispatcher may resolve the request the instant it is
            # queued, and a first-wins finalization racing ahead of the
            # hook would leave the entry unresolved forever (replayed as
            # duplicate work on every restart).  A resolve record landing
            # before its admit record is fine — read_journal matches by
            # id, not by order.
            req.future._on_done = (
                lambda result, error, _id=req.id:
                    self._journal_resolution(_id, result, error)
            )
        try:
            self._queue.put(req)
        except QueueFullError:
            if self._journal is not None:
                req.future._on_done = None  # never admitted: nothing to log
            self.stats_.bump("rejected_full")
            retry_after = self.stats_.retry_after_estimate(
                len(self._queue), self.serve.max_batch
            )
            self.reqtrace.record(tid, "reject", engine=self.name,
                                 reason="queue_full",
                                 retry_after_s=round(retry_after, 3))
            if self._slo is not None:
                self._slo.record_reject(capacity=False)
            if rec is not None:
                rec.instant("serve.reject", request_id=req.id,
                            retry_after_s=round(retry_after, 3))
            raise QueueFullError(retry_after) from None
        self.stats_.bump("admitted")
        self.reqtrace.bind(req.id, tid)
        self.reqtrace.record(
            tid, "admit", request_id=req.id, engine=self.name, k=req.k,
            n_bucket=cell.n_bucket, m_bucket=cell.m_bucket, warm_hit=warm,
            quality=quality, queue_position=req.queue_position,
        )
        if self._journal is not None:
            # Admitted => journaled: from here on, the only ways out of
            # the journal are a resolution record or a replay after
            # restart (serve/journal.py).
            self._journal_admit(req)
        if rec is not None:
            # Queue lifecycle point: admission (the matching dispatch/resolve
            # events come from the dispatcher thread's batch span).
            rec.instant("serve.admit", request_id=req.id, k=req.k,
                        n_bucket=cell.n_bucket, m_bucket=cell.m_bucket,
                        warm_hit=warm)
            rec.counter("serve.queue", {"depth": len(self._queue)})
        return req.future

    def partition(
        self,
        graph,
        k: int,
        epsilon: float = 0.03,
        *,
        deadline_ms: Optional[float] = None,
        max_block_weights: Optional[Sequence[int]] = None,
        min_epsilon: float = 0.0,
        min_block_weights: Optional[Sequence[int]] = None,
        quality: str = "strong",
    ) -> np.ndarray:
        """Synchronous convenience wrapper: submit + wait, returning the
        (n,) block array — the facade delegates here when constructed with
        an engine.  Auto-starts a not-yet-started engine *without* warmup
        (call :meth:`start` yourself to pay warmup at a chosen moment)."""
        if not self._running:
            self.start(warmup=False)
        fut = self.submit(
            graph, k, epsilon,
            deadline_ms=deadline_ms,
            max_block_weights=max_block_weights,
            min_epsilon=min_epsilon,
            min_block_weights=min_block_weights,
            quality=quality,
        )
        return fut.result().partition

    # -- request tracing -----------------

    def _final_error(self, error) -> bool:
        """Whether a typed failure terminates the request's trace chain.
        The "engine gave it back" classes (EngineStoppedError, WorkerHung,
        watchdog/shutdown ExecuteFault) are resteerable or replayable —
        the chain continues on a sibling replica or after restart."""
        from ..resilience.errors import ExecuteFault, WorkerHung

        if isinstance(error, (EngineStoppedError, WorkerHung)):
            return False
        return not (
            isinstance(error, ExecuteFault)
            and getattr(error, "site", "") in ("watchdog", "shutdown")
        )

    def _trace_event(self, req: ServeRequest, event: str,
                     final: bool = False, **fields) -> None:
        """Record one request-trace event (pure host dict append).  On a
        terminal event (``final=True``) the request's whole chain is
        rendered onto a per-request lane of the active Chrome trace."""
        tid = req.trace_id
        if not tid:
            return
        if event in ("resolve", "error"):
            fields["final"] = bool(final)
        self.reqtrace.record(tid, event, request_id=req.id,
                             engine=self.name, **fields)
        if final:
            from ..telemetry import trace as ttrace

            rec = ttrace.active()
            if rec is not None:
                from ..utils.timer import scoped_timer

                with scoped_timer("reqtrace_export"):
                    self.reqtrace.export_chrome(rec, tid)

    def explain(self, request_id: int) -> Optional[dict]:
        """Structured dossier for one request: its time-ordered trace
        event chain (admit, dispatch, lane-stack cohort, demotion,
        resolve/error, journal replay ...) plus a connectivity verdict —
        ``None`` for unknown/evicted ids.  Pure host work (counted under
        ``reqtrace_export``; a device pull here is a contract
        violation)."""
        from ..utils.timer import scoped_timer

        with scoped_timer("reqtrace_export"):
            return self.reqtrace.explain_request(int(request_id))

    # -- dispatcher --------------------------------------------------------

    def _loop(self) -> None:
        if self.device.type == "cuda":
            import torch

            # the dispatcher's launches and allocations land on the
            # engine's card
            torch.cuda.set_device(self.device)
        while True:
            self._gate.wait()
            batch = self._queue.pop_batch(
                self.serve.max_batch, self.serve.batch_window_ms / 1e3,
                gate=self._gate,
            )
            if batch is None:
                return  # closed + drained: graceful exit
            try:
                self._execute_batch(batch)
            except Exception as exc:  # noqa: BLE001 — a poisoned batch must
                # not kill the dispatcher; classify the failure and reject
                # its requests with the typed error.
                from ..resilience.errors import classify

                err = classify(exc, site="dispatch")
                if batch:
                    key = (
                        batch[0].cell.n_bucket, batch[0].cell.m_bucket,
                        batch[0].cell.k,
                    )
                    self.breakers.get("cell", key).record_failure()
                for req in batch:
                    if req.future._reject(err):
                        self._trace_event(
                            req, "error",
                            final=self._final_error(err),
                            failure_class=getattr(
                                err, "failure_class", type(err).__name__
                            ),
                            site="dispatch",
                        )
                        wait = time.monotonic() - req.enqueue_t
                        self.stats_.record_request(wait, 0.0, failed=True)
                        if self._slo is not None:
                            self._slo.record_request(
                                req.quality, wait, ok=False
                            )

    def _execute_batch(self, batch: List[ServeRequest]) -> None:
        now = time.monotonic()
        live: List[ServeRequest] = []
        for req in batch:
            if req.future.cancelled:
                self.stats_.bump("cancelled")
                self._trace_event(req, "error", final=True,
                                  failure_class="cancelled")
                req.future._reject(RequestCancelledError(f"request {req.id}"))
            elif req.expired(now):
                self.stats_.bump("timed_out")
                wait = now - req.enqueue_t
                self._trace_event(req, "error", final=True,
                                  failure_class="deadline",
                                  queue_wait_ms=round(wait * 1e3, 1))
                if self._slo is not None:
                    self._slo.record_request(req.quality, wait, ok=False)
                req.future._reject(DeadlineExceededError(
                    f"request {req.id} expired after "
                    f"{(now - req.enqueue_t) * 1e3:.1f}ms in queue"
                ))
            elif req.future._mark_started():
                live.append(req)
            else:
                self.stats_.bump("cancelled")
                self._trace_event(req, "error", final=True,
                                  failure_class="cancelled")
                req.future._reject(RequestCancelledError(f"request {req.id}"))
        if not live:
            return
        self.stats_.record_batch(len(live))
        for req in live:
            # Batch-join lifecycle point: this request dispatches as part
            # of a formed micro-batch (occupancy = the lane axis).
            self._trace_event(req, "dispatch", occupancy=len(live))
        from ..telemetry import trace as ttrace

        rec = ttrace.active()
        if rec is not None:
            cell = live[0].cell
            rec.begin("serve.batch", occupancy=len(live), k=cell.k,
                      n_bucket=cell.n_bucket, m_bucket=cell.m_bucket)

        with self._lock:
            self._inflight = list(live)
        try:
            # Execution watchdog: a hung compile/execute inside
            # this batch has its futures force-resolved with a typed
            # ExecuteFault and its cell breaker tripped after
            # resilience.execute_timeout_s (0 disarms) — the dispatch is
            # abandoned, not cancelled, and its late result discarded by
            # the idempotent futures.
            with self.watchdog.guard(
                "serve_execute", self.resilience.execute_timeout_s,
                on_timeout=lambda d, c=live[0].cell, lv=list(live):
                    self._on_hang(c, d, lv),
            ):
                self._execute_live(live)
        finally:
            with self._lock:
                self._inflight = []
            if rec is not None:
                rec.end("serve.batch")
                rec.counter("serve.queue", {"depth": len(self._queue)})

    def _lane_stack_mode(self) -> str:
        """Effective lane-stack routing: env kill switch > serve context.
        Values are normalized (case/whitespace); an unrecognized value at
        dispatch time disables the stacked path (kill-switch-biased — a
        typo'd override must never silently keep the feature on), while
        an invalid *configured* value raises at engine construction."""
        import os

        mode = (
            os.environ.get("KAMINPAR_TPU_LANE_STACK", "")
            or getattr(self.serve, "lane_stack", "off")
        ).strip().lower()
        return mode if mode in ("auto", "on", "off") else "off"

    def _lanestack_fallback(self, reason: str, warn: bool) -> None:
        """Count one lane-stack fallback to the per-graph loop and, when
        ``warn``, surface the reason as a RuntimeWarning."""
        self.stats_.bump("lanestack_fallbacks")
        if warn:
            import warnings

            warnings.warn(
                f"kaminpar_tpu_torch serve: {reason}; falling back to the "
                "per-graph loop.",
                RuntimeWarning,
                stacklevel=3,
            )

    def _try_lanestacked(
        self, live: List[ServeRequest]
    ) -> Optional[List[ServeRequest]]:
        """Run the whole batch as ONE lane-stacked lockstep run
        (serve/lanestack.py) when routing and eligibility allow; returns
        the fulfilled requests, or None to fall back to the per-graph loop
        (fallbacks are counted, and warned under ``lane_stack="on"``)."""
        mode = self._lane_stack_mode()
        if mode == "off" or (mode != "on" and len(live) < 2):
            return None
        cell_key = (
            live[0].cell.n_bucket, live[0].cell.m_bucket, live[0].cell.k
        )
        breaker = self.breakers.get("lanestack", cell_key)
        if not breaker.allow():
            # Breaker open:
            # skip the doomed stacked attempt — the demotion counter keeps
            # surfacing the lost parallelism, the trip itself already
            # warned, and the post-cooldown half-open probe re-arms the
            # stacked path without an engine restart.
            self.stats_.bump("lanestack_fallbacks")
            self.breakers.record_demotion(
                "lanestack", "circuit breaker open", warn=False
            )
            return None
        # Per-request constraint overrides (and non-strong quality tiers)
        # are outside the lockstep envelope: the stacked pipeline computes
        # every lane's caps from (k, epsilon), which the shape cell
        # already holds fixed, on the full-refinement chain.
        if any(
            r.max_block_weights is not None
            or r.min_block_weights is not None
            or r.min_epsilon
            or r.quality != "strong"
            for r in live
        ) or len({r.epsilon for r in live}) != 1:
            self._lanestack_fallback(
                "lane_stack=on but the batch carries per-request "
                "constraint overrides or mixed epsilons",
                warn=mode == "on",
            )
            return None
        from ..utils import compile_stats
        from .lanestack import LaneStackUnsupported, run_lanestacked

        pre_compiles = compile_stats.compile_time_snapshot()["compile_events"]
        t0 = time.perf_counter()
        try:
            with self.runtime.activate():
                parts, report = run_lanestacked(
                    self._solver.ctx, [r.graph for r in live],
                    live[0].k, live[0].epsilon, device=self.device,
                    trace_lane=self.name,
                )
        except LaneStackUnsupported as exc:
            self._lanestack_fallback(
                f"lane_stack=on but the batch is outside the lane-stack "
                f"envelope ({exc})",
                warn=mode == "on",
            )
            return None
        except Exception as exc:  # noqa: BLE001 — a lane-stack failure must
            # not reject a batch the per-graph loop can still serve; fall
            # back LOUDLY in every mode (the per-graph results remain
            # correct, the warning and counter surface the lost
            # parallelism).  The failure is classified and recorded on the
            # per-cell lanestack breaker; tripping it skips the doomed
            # attempt on later batches until the half-open probe recovers.
            from ..resilience.errors import classify

            err = classify(exc, site="lanestack")
            self._lanestack_fallback(
                f"lane-stacked execution failed "
                f"({err.failure_class}: {exc})",
                warn=True,
            )
            self.breakers.record_demotion(
                "lanestack", err.failure_class, warn=False
            )
            if breaker.record_failure():
                import warnings

                warnings.warn(
                    "kaminpar_tpu_torch serve: lane-stacked execution failed on "
                    f"{breaker.threshold} consecutive batches in cell "
                    f"{cell_key} — disabling the stacked path for this "
                    "cell (the per-graph loop keeps serving; a half-open "
                    f"probe re-arms it after {breaker.cooldown_s}s).",
                    RuntimeWarning,
                    stacklevel=2,
                )
            return None
        wall = time.perf_counter() - t0
        if breaker.record_success():
            self.breakers.record_restoration("lanestack")
        # The stacked path serves these requests INSTEAD of the per-graph
        # loop, so it must also report the cell breaker's outcome — a
        # half-open cell probe served stacked would otherwise never close
        # the breaker and pin a healthy cell at one-probe-per-cooldown.
        cbr = self.breakers.get("cell", cell_key)
        if cbr.record_success():
            self.breakers.record_restoration("cell")
        # Key warm accounting on what this batch ran: the runner's layout
        # key (the lanes' padded buckets at every level, cohort by cohort)
        # with (k, epsilon).  The request cell alone cannot name it: the
        # isolated-node strip moves work graphs across buckets and cohort
        # splits change lane counts.  A stacked batch is warm when this
        # engine ran its key before, or when a kernel build ran during it
        # it is cold whatever the key.
        stack_key = (report.layout_key, live[0].k, live[0].epsilon)
        compiled = (
            stack_key not in self._warm_stack_keys
            or compile_stats.compile_time_snapshot()["compile_events"]
            > pre_compiles
        )
        # The submit-time warm flag covers the per-graph (bucket, k) cell;
        # a stacked batch's warmth is the lane-stack key's: correct the
        # accounting in both directions.
        for req in live:
            if compiled and req.warm_hit:
                req.warm_hit = False
                self.stats_.bump("warm_hits", -1)
                self.stats_.bump("warm_misses")
            elif not compiled and not req.warm_hit:
                req.warm_hit = True
                self.stats_.bump("warm_hits")
                self.stats_.bump("warm_misses", -1)
        self._warm_stack_keys.add(stack_key)
        share = wall / len(live)
        self.stats_.bump("lanestacked_batches")
        self.stats_.bump("lanestacked_lanes", len(live))
        self.stats_.bump("lanestack_splits", report.splits)
        lane_cohorts = getattr(report, "lane_cohorts", ()) or ()
        for i, req in enumerate(live):
            # One stacked program serves all lanes; each request's execute
            # share is the batch wall over occupancy, and the rest of the
            # stacked wall counts as queue wait so queue_wait + execute
            # still covers the full submit->resolve wall (the per-graph
            # loop's percentile invariant).
            req.queue_wait_s = time.monotonic() - req.enqueue_t - share
            req.partition = parts[i]
            req.caps = report.caps[i]
            req.execute_s = share
            req.service_s = wall
            # Lane-stack lifecycle point: which cohort of the stacked
            # program this request's lane rode (cohort splits re-bucket
            # lanes whose work graphs left the request cell).
            self._trace_event(
                req, "lanestack", lane=i,
                cohort=(int(lane_cohorts[i])
                        if i < len(lane_cohorts) else 0),
                cohorts=report.cohorts, lanes=report.lanes,
                splits=report.splits,
            )
        return list(live)

    def _request_solver(self, req: ServeRequest):
        """The solver serving this request, after the quality ladder rung:
        explicit ``quality="fast"`` requests take the trimmed solver; a
        "strong" request is demoted to it when the cell's quality breaker
        is open (capacity-class failures tripped it) — counted, warned
        once, and restored by the half-open probe."""
        if req.quality == "fast":
            return self._get_fast_solver(), False
        key = (req.cell.n_bucket, req.cell.m_bucket, req.cell.k)
        qbreaker = self.breakers.get("quality_strong", key)
        if not qbreaker.allow():
            self.stats_.bump("demoted_quality")
            self.breakers.record_demotion(
                "quality_strong", "capacity pressure in this cell"
            )
            # Demotion-ladder lifecycle point: the quality_strong rung
            # served this strong request with the fast tier.
            self._trace_event(req, "demote", rung="quality_strong",
                              served="fast")
            return self._get_fast_solver(), False
        return self._solver, True

    def _get_fast_solver(self):
        """Lazily-built trimmed-refinement solver: the balancer+LP chain
        with halved LP sweeps and single-rep extension — the same
        deterministic pipeline shape, a lighter quality tier."""
        if self._fast_solver is None:
            from ..context import RefinementAlgorithm
            from ..kaminpar import KaMinPar

            fast = copy.deepcopy(self.ctx)
            keep = (
                RefinementAlgorithm.OVERLOAD_BALANCER,
                RefinementAlgorithm.LP,
                RefinementAlgorithm.UNDERLOAD_BALANCER,
                RefinementAlgorithm.GREEDY_BALANCER,
            )
            fast.refinement.algorithms = tuple(
                a for a in fast.refinement.algorithms if a in keep
            ) or (RefinementAlgorithm.OVERLOAD_BALANCER,
                  RefinementAlgorithm.LP)
            fast.refinement.lp.num_iterations = max(
                1, fast.refinement.lp.num_iterations // 2
            )
            fast.initial_partitioning.nested_extension_reps = 1
            fast.initial_partitioning.device_extension_reps = 1
            self._fast_solver = KaMinPar(fast, device=self.device)
        return self._fast_solver

    def _execute_live(self, live: List[ServeRequest]) -> None:
        from ..resilience.errors import classify
        from ..resilience.faults import maybe_inject

        ok = self._try_lanestacked(live)
        stacked = ok is not None
        if ok is None:
            ok = []
            for req in live:
                # Queue wait runs until THIS request's execution starts, so
                # a late batch member's wait includes in-batch serialization
                # — reported percentiles must cover the full submit->resolve
                # wall.
                req.queue_wait_s = time.monotonic() - req.enqueue_t
                t0 = time.perf_counter()
                key = (req.cell.n_bucket, req.cell.m_bucket, req.cell.k)
                # Provisional tier for the except path (a fault can fire
                # before _request_solver resolves the actual tier).
                strong = req.quality == "strong"
                try:
                    maybe_inject("execute", site="engine_request")
                    solver, strong = self._request_solver(req)
                    req.quality_served = "strong" if strong else "fast"
                    # The warm facade runs the *identical* code path a cold
                    # sequential KaMinPar.compute_partition runs (including
                    # its per-call RNG reseed), so per-graph results are
                    # bit-identical to single-graph runs by construction.
                    solver.set_graph(req.graph)
                    req.partition = solver.compute_partition(
                        req.k, req.epsilon, req.max_block_weights,
                        req.min_epsilon, req.min_block_weights,
                    )
                    req.caps = np.asarray(
                        solver.ctx.partition.max_block_weights,
                        dtype=np.int64,
                    ).copy()
                    req.execute_s = time.perf_counter() - t0
                    ok.append(req)
                    if not req.future.done():
                        # A done future means the watchdog already rejected
                        # this request as hung and TRIPPED the breaker —
                        # the late-returning dispatch must not record a
                        # success that would silently close it (the next
                        # request would re-enter the same hang).
                        cbr = self.breakers.get("cell", key)
                        if cbr.record_success():
                            self.breakers.record_restoration("cell")
                        if strong:
                            qbr = self.breakers.get("quality_strong", key)
                            if qbr.record_success():
                                self.breakers.record_restoration(
                                    "quality_strong"
                                )
                except Exception as exc:  # noqa: BLE001 — per-request isolation
                    # Route through the ONE classifier: callers
                    # get a typed failure, and the failure class picks the
                    # breaker — capacity pressure trips the quality rung
                    # (later strong requests demote to fast), everything
                    # else trips the cell breaker (enough repeats poison
                    # the cell at admission).  A False reject means the
                    # watchdog already force-resolved this future AND
                    # recorded the failure + breaker trip — don't
                    # double-count the late arrival.
                    err = classify(exc, site="engine_request")
                    if req.future._reject(err):
                        if err.failure_class == "capacity-exceeded" and strong:
                            self.breakers.get(
                                "quality_strong", key
                            ).record_failure()
                        else:
                            # Fast-tier capacity failures land here too:
                            # a cell that OOMs even under the trimmed
                            # solver has no further rung to demote to —
                            # it must poison at admission, not burn a
                            # doomed dispatch per request.
                            self.breakers.get("cell", key).record_failure()
                        exec_s = time.perf_counter() - t0
                        self._trace_event(
                            req, "error", final=self._final_error(err),
                            failure_class=err.failure_class,
                            site="engine_request",
                        )
                        self.stats_.record_request(
                            req.queue_wait_s, exec_s, failed=True,
                        )
                        if self._slo is not None:
                            self._slo.record_request(
                                req.quality_served or req.quality,
                                req.queue_wait_s + exec_s, ok=False,
                            )
        if not ok:
            return

        # Whole-batch quality metrics in ONE dispatch over the packed
        # disjoint-union buffer + one batched readback (serve/batching.py).
        t_metrics = time.perf_counter()
        cuts, bws = batched_metrics(
            pack_graphs([r.graph for r in ok], device=self.device),
            [r.partition for r in ok],
            ok[0].k,
            pad_to=self.serve.max_batch,
        )
        metrics_share_s = (time.perf_counter() - t_metrics) / len(ok)
        from ..telemetry import trace as ttrace

        rec = ttrace.active()
        for i, req in enumerate(ok):
            req.execute_s += metrics_share_s
            if not stacked:
                # A stacked batch traces only lane-stack executables — it
                # does not warm the per-graph (bucket, k) cell, so marking
                # it here would report a later lone request in this cell
                # as a warm hit while it pays the full per-graph compile
                # (the stacked path tracks its own _warm_stack_keys).
                self._note_warm(
                    req.cell, req.quality_served or req.quality
                )
            feasible = bool(np.all(bws[i] <= req.caps))
            resolved = req.future._resolve(ServeResult(
                partition=req.partition,
                cut=int(cuts[i]),
                feasible=feasible,
                batch_size=len(ok),
                queue_wait_s=req.queue_wait_s,
                execute_s=req.execute_s,
                warm_hit=req.warm_hit,
                request_id=req.id,
            ))
            if not resolved:
                # The watchdog already force-resolved this future (the
                # dispatch was abandoned as hung and came back late): the
                # failure was recorded there — don't double-count.
                continue
            self.stats_.record_request(
                req.queue_wait_s, req.execute_s, service_s=req.service_s
            )
            self._trace_event(
                req, "resolve", final=True, cut=int(cuts[i]),
                feasible=feasible, batch=len(ok),
                quality=req.quality_served or req.quality,
                queue_wait_ms=round(req.queue_wait_s * 1e3, 2),
                execute_ms=round(req.execute_s * 1e3, 2),
            )
            if self._slo is not None:
                self._slo.record_request(
                    req.quality_served or req.quality,
                    req.queue_wait_s + req.execute_s, ok=True,
                )
            if rec is not None:
                rec.instant(
                    "serve.resolve", request_id=req.id, cut=int(cuts[i]),
                    feasible=feasible,
                    queue_wait_ms=round(req.queue_wait_s * 1e3, 2),
                    execute_ms=round(req.execute_s * 1e3, 2),
                )

    # -- observability -----------------------------------------------------

    def warmup_cell_counts(self) -> dict:
        """Inherited against locally warmed warmup cells."""
        inherited = sum(
            1 for r in self.warmup_report if r.get("inherited")
        )
        return {
            "inherited": inherited,
            "local": len(self.warmup_report) - inherited,
        }

    def stats(self) -> dict:
        """Structured snapshot: queue depth, admission/reject/timeout
        counts, batch occupancy, warm-cache hit rate, latency percentiles,
        plus the compile-shape and blocking-transfer censuses."""
        snap = self.stats_.snapshot(queue_depth=len(self._queue))
        snap["running"] = self._running
        snap["warm_cells"] = len(self._warm_cells)
        snap["warmup"] = list(self.warmup_report)
        snap["warmup_cells"] = self.warmup_cell_counts()
        # Resilience surface: this engine's breaker registry
        # (lanestack/cell/quality rungs), the process-global pipeline
        # registry (lp_pallas/ip_device/device_decode rungs), the
        # watchdog's guard/fire census + dossier heads, and the chaos
        # harness's injection counters.
        from ..resilience import breakers as rbreakers
        from ..resilience import faults as rfaults

        snap["resilience"] = {
            "engine": self.breakers.snapshot(),
            "pipeline": rbreakers.global_registry().snapshot(),
            "watchdog": self.watchdog.snapshot(),
            "faults": rfaults.snapshot(),
        }
        # Crash-safe journal surface:
        # append/fsync counts of the live journal file — the replay and
        # resolution counters ride the standard counter block above.
        if self._journal is not None:
            snap["journal"] = self._journal.snapshot()
        # SLO burn surface: per-window
        # error-budget burn rates + the control pressure the fleet
        # steering/autoscale consume.  Pure host scan of the event ring,
        # counted under slo_eval.
        from ..utils.timer import scoped_timer

        with scoped_timer("slo_eval"):
            snap["slo"] = (
                self._slo.summary() if self._slo is not None
                else {"armed": False}
            )
        snap["reqtrace"] = self.reqtrace.snapshot()
        return snap

    def metrics_text(self) -> str:
        """Prometheus text exposition of the serving metrics:
        queue depth, admission/reject/timeout counts, batch occupancy,
        warm-cache hit rate, p50/p90/p99 latencies, and the compile-shape /
        blocking-transfer censuses.  The serve CLI's ``--metrics-port``
        serves this at ``/metrics``; scrape-friendly and dependency-free
        (telemetry/prometheus.py)."""
        from ..telemetry import prometheus
        from ..utils import compile_stats

        families = self.stats_.prometheus_families(
            queue_depth=len(self._queue),
            running=self._running,
            warm_cells=len(self._warm_cells),
        )
        # the executable census's families (none in the port:
        # utils/compile_stats.py)
        families.extend(compile_stats.census_prometheus_families())
        # Resilience families: breaker states/trips, ladder
        # demotions + restorations, chaos injections — merged over this
        # engine's registry and the process-global pipeline registry.
        from ..resilience import breakers as rbreakers

        families.extend(rbreakers.prometheus_families(
            self.breakers, rbreakers.global_registry()
        ))
        families.append((
            "kaminpar_resilience_watchdog_fired_total", "counter",
            "Execution-watchdog deadline overruns converted into breaker "
            "trips + typed future resolutions",
            [({}, self.watchdog.fired)],
        ))
        # How many warmup cells were restored (a journal's warm state)
        # against warmed by this engine.
        cells = self.warmup_cell_counts()
        families.append((
            "kaminpar_serve_warmup_cells_total", "counter",
            "Warmup-report cells by source: inherited from the fleet's "
            "warm state against locally warmed",
            [({"source": "inherited"}, cells["inherited"]),
             ({"source": "local"}, cells["local"])],
        ))
        # SLO burn families — empty unless
        # the ServeContext arms at least one objective.
        from ..telemetry import slo as slo_mod

        families.extend(slo_mod.prometheus_families(self._slo))
        return prometheus.render(families)
