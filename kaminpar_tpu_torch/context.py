"""Configuration tree of the port.

A trimmed copy of ``kaminpar_tpu/context.py``: only the dataclasses and
fields the port's presets (``presets.py``) read.  Defaults are the JAX
package's.  There is no ``lp_kernel`` knob: the LP round runs the CUDA
kernels on a CUDA tensor and their plain PyTorch versions on a CPU tensor
(``ops/lp_kernels.py``).
"""

from __future__ import annotations

import contextlib
import enum
import math
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class PartitioningMode(enum.Enum):
    """Orchestration scheme: deep multilevel, recursive bisection, single-
    shot k-way, or deep v-cycles over increasing k."""

    DEEP = "deep"
    RB = "rb"
    KWAY = "kway"
    VCYCLE = "vcycle"


class ClusteringAlgorithm(enum.Enum):
    """Coarsening clusterer: none, label propagation or heavy-edge
    matching."""

    NOOP = "noop"
    LP = "lp"
    HEM = "hem"


class RefinementAlgorithm(enum.Enum):
    NOOP = "noop"
    LP = "lp"
    CLP = "clp"  # colored LP
    JET = "jet"
    KWAY_FM = "kway-fm"
    OVERLOAD_BALANCER = "overload-balancer"
    UNDERLOAD_BALANCER = "underload-balancer"
    GREEDY_BALANCER = "greedy-balancer"  # alias of the overload balancer


class TieBreakingStrategy(enum.Enum):
    """LP tie-breaking among equally rated labels: uniformly at random, or
    the lightest label first (then at random)."""

    UNIFORM = "uniform"
    LIGHTEST = "lightest"


class ClusterWeightLimit(enum.Enum):
    EPSILON_BLOCK_WEIGHT = "epsilon-block-weight"
    BLOCK_WEIGHT = "block-weight"
    ONE = "one"
    ZERO = "zero"


@dataclass
class LabelPropagationContext:
    num_iterations: int = 5
    tie_breaking: TieBreakingStrategy = TieBreakingStrategy.UNIFORM
    # Stop sweeping once at most this fraction of the nodes moved.
    min_moved_fraction: float = 0.001
    cluster_isolated_nodes: bool = True
    cluster_two_hop_nodes: bool = True
    # Fraction of nodes allowed to move per synchronous round.
    active_prob: float = 1.0
    # Accept zero-gain moves with probability 1/2.
    allow_tie_moves: bool = False
    # Levels with average degree below the threshold sweep factor x longer.
    low_degree_boost_threshold: float = 8.0
    low_degree_boost_factor: int = 3
    # Graphs with non-uniform edge weights: small active fraction, more
    # sweeps.  ``weighted_mode`` None = detect from the coarsener's input.
    weighted_active_prob: float = 0.1
    weighted_sweep_factor: int = 6
    weighted_mode: object = None


@dataclass
class SparsificationContext:
    """Threshold edge sparsification after contraction (the linear-time
    tier): keep about target_m of the heaviest coarse edges, where
    target_m = min(edge_target_factor x m, density_target_factor x m/n x
    n_c), and only when the coarse graph has more than laziness_factor x
    target_m edges."""

    enabled: bool = False
    density_target_factor: float = 0.5
    edge_target_factor: float = 0.5
    laziness_factor: float = 4.0


@dataclass
class CoarseningContext:
    algorithm: ClusteringAlgorithm = ClusteringAlgorithm.LP
    lp: LabelPropagationContext = field(
        default_factory=lambda: LabelPropagationContext(active_prob=0.5)
    )
    # Deep mode coarsens until n <= 2 * contraction_limit.
    contraction_limit: int = 2000
    # Cluster weight additionally capped at max_shrink_factor x the average
    # node weight (0 disables).
    max_shrink_factor: float = 3.5
    # Stop when a level shrinks by less than this fraction.
    convergence_threshold: float = 0.05
    cluster_weight_limit: ClusterWeightLimit = ClusterWeightLimit.EPSILON_BLOCK_WEIGHT
    cluster_weight_multiplier: float = 1.0
    # Intersect this many independent LP clusterings (overlay clustering);
    # <= 1 disables.
    overlay_levels: int = 1
    sparsification: SparsificationContext = field(default_factory=SparsificationContext)


@dataclass
class InitialPartitioningContext:
    """The bipartitioning pool: the host pool + 2-way FM
    (``initial/bipartitioner.py``) or the lane-batched device pool
    (``ops/bipartition.py``).  ``ip_backend`` "auto" runs the device pool
    for a graph on a CUDA device and the host pool on the CPU; "device"
    forces the device pool (also on CPU tensors, as the parity tests do);
    "host" is for CPU graphs only and is refused for a CUDA graph."""

    ip_backend: str = "auto"
    use_adaptive_epsilon: bool = True
    min_num_repetitions: int = 4
    max_num_repetitions: int = 12
    use_adaptive_bipartitioner_selection: bool = True
    enable_bfs_bipartitioner: bool = True
    enable_ggg_bipartitioner: bool = True
    enable_random_bipartitioner: bool = True
    fm_num_iterations: int = 5
    fm_alpha: float = 1.0
    coarsening_contraction_limit: int = 20
    coarsening_convergence_threshold: float = 0.05
    # Extension splits into >= 4 parts on subgraphs at least this large run
    # a nested deep pipeline; best of ``nested_extension_reps`` attempts.
    nested_extension_n: int = 4096
    nested_extension_reps: int = 2
    # Device extension (``partitioning/extension.py``): on graphs of at
    # least ``device_extension_n`` nodes, one restricted nested multilevel
    # over all blocks, its coarsest graph holding about
    # ``device_extension_cpb`` coarse nodes per new block; the best of
    # ``device_extension_reps`` attempts by cut.
    device_extension: bool = False
    device_extension_n: int = 1 << 15
    device_extension_cpb: int = 320
    device_extension_reps: int = 1
    # Up to this size, also run the flat pool and keep the better result.
    flat_pool_fallback_n: int = 2048


@dataclass
class JetContext:
    # Full JET invocations chained per refinement step ("4xjet": 4).
    num_rounds: int = 1
    num_iterations: int = 12
    num_fruitless_iterations: int = 12
    fruitless_threshold: float = 0.999
    # Negative-gain admission temperatures on fine and coarse levels,
    # annealed linearly from initial to final over the iterations.
    initial_gain_temp_on_fine_level: float = 0.25
    final_gain_temp_on_fine_level: float = 0.25
    initial_gain_temp_on_coarse_level: float = 0.75
    final_gain_temp_on_coarse_level: float = 0.75


@dataclass
class BalancerContext:
    max_num_rounds: int = 8


@dataclass
class ColoredLPContext:
    num_iterations: int = 2
    # Zero-gain moves are safe inside a colour class (an independent set).
    allow_tie_moves: bool = True


@dataclass
class FMContext:
    """k-way FM, a sequential host pass (``refinement/fm_refiner.py``)."""

    num_iterations: int = 10
    alpha: float = 1.0  # adaptive stopping (Osipov/Sanders)
    num_fruitless_moves: int = 100
    abortion_threshold: float = 0.999
    # Border seeds consumed per localized search region.
    num_seed_nodes: int = 10
    # A pass stops (after its current region) once the summed degree of
    # the moved nodes exceeds factor * n; <= 0 disables.
    pass_work_budget_factor: float = 32.0
    # Graphs above max_n nodes skip FM (a wall-time bound on the pass);
    # up to dense_nk_threshold connection entries the pass keeps a dense
    # (n, k) table, above it a border-row table.
    max_n: int = 1 << 23
    dense_nk_threshold: int = 1 << 26


@dataclass
class RefinementContext:
    algorithms: tuple = (
        RefinementAlgorithm.OVERLOAD_BALANCER,
        RefinementAlgorithm.LP,
    )
    lp: LabelPropagationContext = field(
        default_factory=lambda: LabelPropagationContext(num_iterations=5)
    )
    jet: JetContext = field(default_factory=JetContext)
    balancer: BalancerContext = field(default_factory=BalancerContext)
    fm: FMContext = field(default_factory=FMContext)
    clp: ColoredLPContext = field(default_factory=ColoredLPContext)


@dataclass
class PartitionContext:
    k: int = 2
    epsilon: float = 0.03
    # Minimum block-weight imbalance; 0 disables minimum weights.
    min_epsilon: float = 0.0
    max_block_weights: Optional[object] = None  # (k,) int64, set by setup()
    min_block_weights: Optional[object] = None  # (k,) int64 or None

    def setup(self, total_node_weight: int, k: int, epsilon: float,
              min_epsilon: float = 0.0) -> None:
        self.k = int(k)
        self.epsilon = float(epsilon)
        self.min_epsilon = float(min_epsilon)
        perfect = (total_node_weight + k - 1) // k
        max_bw = int((1.0 + epsilon) * perfect)
        self.max_block_weights = np.full(k, max(max_bw, perfect + 1), dtype=np.int64)
        if min_epsilon > 0.0:
            # ceil((1 - min_eps) * perfect), clamped so that k * min_bw <= W
            # stays satisfiable (perfect is rounded up).
            min_bw = min(math.ceil((1.0 - min_epsilon) * perfect), total_node_weight // k)
            self.min_block_weights = np.full(k, min_bw, dtype=np.int64)
        else:
            self.min_block_weights = None


@dataclass
class GraphCompressionContext:
    """Whether the input graph is stored compressed (``graph/compressed.py``,
    the TeraPart storage tier), and whether the finest level runs off the
    device-resident compressed stream (``graph/device_compressed.py``):

    - "off": the storage tier only; the deep partitioner decompresses the
      finest CSR on the host before coarsening;
    - "finest": level-0 clustering, contraction and the final LP refinement
      pass decode the stream inside the kernels, and the finest CSR is
      re-decoded on the device at uncoarsening;
    - "auto": "finest" (the port is always inside its envelope).
    """

    enabled: bool = False
    device_decode: str = "off"


@dataclass
class DebugContext:
    """The hierarchy dumps of ``utils/debug.py`` (reference: the debug dump
    options consumed by kaminpar-shm/partitioning/debug.cc); off by
    default."""

    save_hierarchy: bool = False
    validate_graph: bool = False
    graph_name: str = ""
    dump_dir: str = "."
    dump_graph_hierarchy: bool = False
    dump_partition_hierarchy: bool = False


@dataclass
class ServeContext:
    """Knobs of the partition-serving runtime (``serve/``), the JAX
    package's fields and defaults.

    A ``PartitionEngine`` owns one long-lived device context: it warms
    every cell of the ``warm_ladder`` x ``warm_ks`` grid at startup (runs
    it once, so the kernels are loaded and the allocator's segments exist),
    and serves a bounded queue with admission control, deadlines and
    micro-batches of same-shape-cell requests."""

    # Node-count rungs to warm at startup (each rung runs one synthetic
    # partition, which visits its whole padded bucket chain).
    warm_ladder: tuple = (256, 1024)
    # k values to warm per rung.
    warm_ks: tuple = (8,)
    # Edge factor of the synthetic (RMAT) warmup graphs.
    warm_edge_factor: int = 8
    # Max requests fused into one micro-batch (same (n-bucket, m-bucket, k)
    # shape cell only; see serve/batching.py).
    max_batch: int = 8
    # Admission bound of the request queue; submits beyond it are rejected
    # with a retry-after estimate (backpressure) instead of queueing without
    # limit.
    queue_bound: int = 64
    # After the first request of a batch arrives, wait up to this long for
    # more same-cell requests before dispatching the batch.
    batch_window_ms: float = 2.0
    # Default per-request deadline; 0 disables (requests wait forever).
    default_deadline_ms: float = 0.0
    # Graceful-shutdown budget: how long shutdown(drain=True) waits for the
    # queue to empty before giving up on the dispatcher thread.
    drain_timeout_s: float = 60.0
    # Lane-stacked batch execution: run a
    # whole same-cell micro-batch through the multilevel pipeline as ONE
    # lane-stacked union (the kernels run over all lanes at once) instead of
    # once per graph.  "auto" lane-stacks
    # eligible batches of >= 2 requests; "on" additionally stacks
    # single-request batches (and makes fallbacks warn); "off" keeps the
    # per-graph loop.  KAMINPAR_TPU_LANE_STACK overrides.
    lane_stack: str = "auto"
    # Lane counts to warm the lane-stacked pipeline at per (rung, k) cell
    # during startup warmup (kind="lanestack" warmup-report rows); empty
    # disables the pass (the per-graph warmup stays as is).
    warm_lanes: tuple = ()
    # Device-memory admission preflight: "auto"
    # rejects a request whose predicted watermark exceeds the engine's
    # ceiling when a ceiling is known (explicit override below, measured
    # allocator limit, or the device-kind table — CPU without allocator
    # stats has none, so "auto" passes everything there); "off" disables.
    capacity_preflight: str = "auto"
    # Explicit admission ceiling in bytes; 0 = derive (allocator bytes_limit
    # when the backend exposes one, else the per-device-kind memory table at
    # the planner's headroom).  Tests pin small values to force rejection.
    capacity_ceiling_bytes: int = 0
    # Crash-safe serve journal: append-only
    # JSONL path ("" = off; env KPTPU_SERVE_JOURNAL overrides).  Every
    # admitted request is journaled at admit (graph payload + params) and
    # again at resolution; a restarted engine replays unresolved entries
    # idempotently — restart mid-burst loses zero accepted requests — and
    # restores the warm state (warmup report, warm cells, breaker trips,
    # EMA seed) recorded alongside, so the replacement skips warmup.
    journal_path: str = ""
    # fsync the journal every N appended records (durability against latency;
    # the un-fsynced suffix is the crash-loss window).  Resolutions and
    # the warm-state record force an fsync regardless.
    journal_fsync_every: int = 8
    # -- SLO objectives ------------------------
    # Declared service objectives; ALL default off (0.0), which disables
    # burn-rate accounting entirely.  When any is armed the engine keeps
    # rolling multi-window error budgets (slo_windows_s), exposes them in
    # stats()["slo"] + kaminpar_slo_* Prometheus families, and exports a
    # dimensionless pressure signal max(0, worst_burn - 1) that the fleet
    # steering score and the autoscaler consume.  Pressure is a control
    # input only — it never reaches the partitioning math, so partitions
    # stay bit-identical with SLOs armed or off (asserted in tests).
    #
    # Per-quality-tier latency targets in milliseconds (queue wait +
    # execute, i.e. the caller-observed service path of a completed
    # request); a completed request over its tier's target spends latency
    # error budget (budget = 1 - slo_availability, or 1% when no
    # availability objective is set).
    slo_strong_ms: float = 0.0
    slo_fast_ms: float = 0.0
    # Availability target as a fraction (e.g. 0.999): failed/expired
    # requests spend the (1 - target) error budget.
    slo_availability: float = 0.0
    # Tolerated capacity-reject rate as a fraction of submissions (e.g.
    # 0.01): typed CapacityError rejections beyond it burn budget.
    slo_capacity_reject_rate: float = 0.0
    # Rolling evaluation windows in seconds (fast burn / slow burn pair).
    slo_windows_s: tuple = (60.0, 600.0)


@dataclass
class ResilienceContext:
    """Knobs of the resilience layer (``resilience/``), the JAX package's
    names and defaults: all disarmed, breakers at the documented
    threshold and cooldown."""

    # Fault plan a serve engine arms at start (resilience/faults.py syntax
    # "point[@site]:error[:key=val ...]", comma-separated; "" = disarmed).
    # KPTPU_FAULTS (with KPTPU_FAULTS_SEED) arms every process instead.
    fault_plan: str = ""
    fault_seed: int = 0
    # Consecutive failures that open a (path, cell) breaker of a serve
    # engine, and how long it stays open before the half-open probe.
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    # Watchdog deadlines of a serve engine (resilience/watchdog.py); 0
    # disables.  A batch overrunning execute_timeout_s has its futures
    # rejected with ExecuteFault and its cell breaker tripped.
    execute_timeout_s: float = 0.0
    compile_timeout_s: float = 0.0
    # JSONL file of watchdog dossiers ("" = in memory only).
    dossier_path: str = ""

    # Directory of the deep pipeline's level-boundary checkpoints
    # (resilience/checkpoint.py; "" = disarmed, KPTPU_CHECKPOINT arms every
    # process).  KaMinPar.compute_partition(resume=...) continues from one
    # bit for bit.
    checkpoint_dir: str = ""
    # Write a checkpoint every N level boundaries (>= 1;
    # KPTPU_CHECKPOINT_EVERY overrides).
    checkpoint_every_levels: int = 1
    # Keep every boundary's file instead of the latest only.
    checkpoint_keep_all: bool = False


_tls_runtime = threading.local()


@dataclass(frozen=True)
class EngineRuntime:
    """What a serve engine owns of its runs: its device and its sync-timer
    flag, made current on a thread (a stack, so nested runs and several
    engines' dispatcher threads stay apart) around every pipeline run
    (counterpart of the JAX package's ``EngineRuntime``).

    On activation a CUDA device becomes the thread's current device
    (kernel launches and allocations of the run land on it), and
    ``utils/timer.scoped_timer(..., sync=True)`` waits per this runtime's
    flag instead of the process default.  The JAX package's runtime also
    owns a persistent compilation-cache directory and a layout-build mode;
    torch compiles nothing per shape and the port builds its layouts one way,
    so this runtime has neither."""

    device: str = "cpu"
    sync_timers: bool = False

    @contextlib.contextmanager
    def activate(self):
        import torch

        stack = getattr(_tls_runtime, "stack", None)
        if stack is None:
            stack = _tls_runtime.stack = []
        dev = torch.device(self.device)
        stack.append(self)
        try:
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                yield self
        finally:
            stack.pop()


def current_runtime() -> Optional[EngineRuntime]:
    """This thread's innermost active runtime, or None."""
    stack = getattr(_tls_runtime, "stack", None)
    return stack[-1] if stack else None


def propagate_runtime(fn):
    """Wrap a pool worker so that the submitting thread's active runtime is
    active inside it too (activation is thread-local); ``fn`` itself
    outside any activation."""
    rt = current_runtime()
    if rt is None:
        return fn

    def _wrapped(*args, **kwargs):
        with rt.activate():
            return fn(*args, **kwargs)

    return _wrapped


@dataclass
class Context:
    preset_name: str = "default"
    mode: PartitioningMode = PartitioningMode.DEEP
    partition: PartitionContext = field(default_factory=PartitionContext)
    coarsening: CoarseningContext = field(default_factory=CoarseningContext)
    initial_partitioning: InitialPartitioningContext = field(
        default_factory=InitialPartitioningContext
    )
    refinement: RefinementContext = field(default_factory=RefinementContext)
    compression: GraphCompressionContext = field(default_factory=GraphCompressionContext)
    debug: DebugContext = field(default_factory=DebugContext)
    resilience: ResilienceContext = field(default_factory=ResilienceContext)
    serve: ServeContext = field(default_factory=ServeContext)
    seed: int = 0
    # v-cycle mode: the intermediate k values partitioned before the final k.
    vcycles: tuple = ()
    # v-cycle mode: revert refinement moves across the previous cycle's
    # blocks.
    restrict_vcycle_refinement: bool = False
    # The JAX package's 64-bit ids and weights; the port's graphs stay
    # int32, and the readers reject files beyond that range either way.
    use_64bit_ids: bool = False


__all__ = [
    "BalancerContext", "ClusterWeightLimit", "ClusteringAlgorithm",
    "CoarseningContext", "ColoredLPContext", "Context", "DebugContext", "EngineRuntime",
    "FMContext",
    "GraphCompressionContext", "InitialPartitioningContext", "JetContext",
    "LabelPropagationContext", "PartitionContext", "PartitioningMode",
    "RefinementAlgorithm", "RefinementContext", "ResilienceContext", "ServeContext",
    "SparsificationContext",
    "TieBreakingStrategy",
]
