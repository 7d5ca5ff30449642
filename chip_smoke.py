#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # largek at RMAT scale 21; terapart, jet, kway
                                          # and linear-time-kway 20; default and vcycle
                                          # 18; the scheme checks 16; strong 13
    python3 chip_smoke.py --scale 16      # a quicker run
    python3 chip_smoke.py --path-scale 22 # terapart at scale 22 too
    python3 chip_smoke.py --kernels-only  # phases 1-3 and 6's kernels, no path
    python3 chip_smoke.py --partition F   # also save terapart's final partition in F
    python3 chip_smoke.py --kernels-only --partition F  # and time the commit on it

The terapart and jet paths run on ``rmat_graph(path_scale, 16, seed=1)``
(``path_scale`` = scale - 2 unless ``--path-scale`` gives it), the default
path on ``rmat_graph(scale - 4)`` and the largek path on
``rmat_graph(scale - LARGEK_SCALE_CUT)``: the largek path's time pushed
the earlier paths below its scale, default first, and the serve phase
(16) took largek itself from scale 22 to 21 (k = 1024 stays), when the
script passed 1,100 s of its 1,200 s on a slow host.  Each graph is built once, on the card
(``rmat_graph(device=...)``, the host build's graph).  Phases, each of
which fails the run when it fails:

1. device: the card's name, the device count and its power limit;
2. build: nvcc compiles the LP kernels from ``kaminpar_tpu_torch/csrc``;
3. compressed kernel: the graph is compressed as ``KaMinPar("terapart")``
   compresses it, and the decode-fused rating kernel is compared with its
   plain version (decode, then rate) on every bucket of its
   ``DeviceCompressedView``, for its own stream, the same structure
   unweighted and with numpy-random weights, and timed; then the commit
   kernel at the view's level-0 clustering shape (the isolated nodes stay
   in, so ``L = n_pad``; a synthetic instance, and the path's first round
   on its own data) and at the same level's LP-refinement shape
   (``L = 64``, a synthetic instance), each run twice, compared with the
   plain version and timed, with the device time of each of its launches
   (``torch.profiler``).  All comparisons on the card, exact (all values
   are integers);
4. terapart path: ``KaMinPar("terapart").compute_partition(k)`` on that
   graph, with the launch counters set to 0 just before and read just
   after and the host decompress refused; the partition must be feasible
   and every kernel must have run, the compressed one included.  Peak
   device memory is read per clustering, contraction and re-decode call
   and between them, and the commit calls are counted by (n, L), with the
   most movers one target had in them; then the refinement commit on the
   path's own data (its final partition, the moves rated on its level-0
   view) is compared and timed;
5. ``device_decode`` "off" against "finest" on ``rmat_graph(scale - 4)``
   into ``OFF_FINEST_K`` blocks: equal partitions;
6. kernels of the default path: on the degree-bucketed layout of the
   terapart path's graph with its isolated nodes stripped (the shapes the
   default path gives them at that scale) the dense rating kernel and the
   commit kernel are compared with their plain versions and timed;
6a. jet path: ``KaMinPar("jet").compute_partition(k)`` on the terapart
   path's graph, counters and peaks as in 4; feasible, all k blocks used,
   the cut below 0.95x a random partition's and no higher than the
   terapart path's (the default pipeline's) on the same graph, JET rounds
   in every refine call, kernel #1 launched in JET's find mode; its phase
   split and peak printed; then on its own final partition kernel #1 in
   the find mode (``L = k``, no caps) and kernel #3 with a colour class as
   its ``active`` mask and tie moves (a CLP superstep), each compared with
   its plain version and timed;
6b. CLP: ``CLPRefiner`` on the jet path's final partition on the card:
   the cut does not rise and both kernels run; then the graph's colouring
   (the refiner's entry point) is proper outside its stragglers (RMAT's
   dense core needs more than the 62 colours, so the nodes left
   uncoloured take colour 0, as in the reference), with the stragglers'
   and the monochromatic edges' shares under their bounds; the colour
   count, rounds, stragglers, monochromatic edges, the nodes moved and
   the time are printed;
6c. FM at the jet path's scale: one k-way FM pass (``FMRefiner``, one
   iteration) on the jet path's final partition, its work bounded by
   ``FM_PASS_WORK_FACTOR`` x n summed degree of moved nodes (the
   strong preset's bound is 32x n): the cut does not rise; its host
   seconds, moves and cut change are printed;
6c'. strong path: ``KaMinPar("strong")`` into k blocks of
   ``rmat_graph(STRONG_SCALE)``, a small functional check of the preset:
   feasible, all blocks used, the cut below 0.95x random, FM's passes
   (> 0) and host seconds printed;
6e. kway path: ``KaMinPar("kway").compute_partition(k)`` on the terapart
   path's graph, counters and peaks as in 4; feasible, all k blocks used,
   the cut below 0.95x random, both kernels run, every bisection on the
   device pool, the coarsest graph at most max(C·k, 2C) nodes (unless
   coarsening converged first) and partitioned into k blocks at once; its
   phase split, levels, coarsest graph, peak and cut over the terapart
   path's printed; then kernels #1 (refinement flags, ``L = k``) and #3 on
   its coarsest level (kept as the path refined it, ``RefineCapture``)
   and on its finest graph with its final partition, each compared with
   its plain version and timed;
6f. linear-time-kway path: the same with ``KaMinPar("linear-time-kway")``
   (2 LP sweeps a level, threshold sparsification); at least one level
   must have been sparsified, and the sparsifier's counts (levels, edges
   before and after) are printed; then kernels #1 and #3 as in 6e on the
   finest sparsified level, with the partition refined there;
6g. scheme checks on ``rmat_graph(SCHEME_SCALE)`` into k blocks, each
   feasible, all blocks used, cut below random, both kernels run, every
   bisection on the device pool: ``restricted-vcycle`` with one
   intermediate cycle at k = 4, recursive bisection (every subgraph built
   on the card), ``default`` with HEM coarsening (no level shrinking by
   more than 2x) and ``kway`` with two overlaid clusterings;
6c'. sync budget: ``KaMinPar("default")`` into k blocks of the scheme
   checks' graph with the readback budgets armed, the tripwire on, the
   card's synchronizing calls counted (``sync_stats.count_device_syncs``,
   sync debug mode "warn"), the heap profiler on and the run traced to a
   file, and no peak tracker or capture wrapper (their own readbacks would
   count): the coarsening's pulls equal its contractions, no card sync
   outside a pull in coarsening, the initial partitioning's pulls at most
   its k0 (asserted in ``partitioning/deep.py``), a valid trace with the
   quality probes' rows (the trace arms them) and device bytes in the heap
   report; no phase's synchronizing calls outside a pull above the
   figures of the run before the probes (``SYNCS_BEFORE_PROBES``);
6d. round reference, on a small graph: one whole LP round, one balancer
   round, one underload round, one group-restricted balancer round, one
   JET move round, one colouring and one colored LP iteration on the card
   are compared with the plain versions on the CPU, with the same draws;
   then one HEM round and a HEM clustering, one overlay intersection, and
   the restricted v-cycle's revert with its restricted rebalance, each on
   the card against the CPU with the same draws;
7. default path: ``KaMinPar("default").compute_partition(k)`` on
   ``rmat_graph(scale - 4)``, counters and peaks as in 4; the partition must be
   feasible, use all k blocks and cut less than 0.95x the edge weight a
   random partition cuts (RMAT graphs are expander-like: a good k=16 cut
   is about 0.9x random), and both dense-path kernels must have run.
   Every path's line gives the coarsest graph's n, m and k0, the
   extension split (``phase_s``: the summed seconds of the
   recursive-bisection and nested-pipeline jobs, which overlap in the
   thread pool, the wall of the pooled sections and of device extension;
   ``extension_jobs``: their counts) and the bipartition pool's stats
   (its ``wall_s`` is summed over calls, which overlap too); every
   bisection of every path must have run on the device pool;
   Every path's line also carries the run's timer tree, three scopes deep
   (``timer``: seconds and starts per path), and its readback census
   (``sync``: explicit and implicit pulls and their bytes per phase);
7a. vcycle path: ``KaMinPar("vcycle")`` with one intermediate cycle at
   k = 4 into k blocks of the default path's graph, as 7: both cycles ran,
   and the cut at most 1.25x the default path's;
8. the device bipartition pool on the default path's coarsest graph (its
   first bisection): on the card and on the CPU from the same recorded
   draws, labels and stats equal; the lane loop on the card with host
   synchronisation made an error; one bisection timed on the card, with
   the device events it launched and their device time;
9. largek path: ``KaMinPar("largek").compute_partition(LARGE_K)`` on its
   graph, counters and peaks as in 4; feasible, all blocks filled, the cut
   below ``LARGE_K_CUT_BOUND`` x a random partition's, device extension fired, both
   dense-path kernels run; its phase split printed; the run is traced
   (``telemetry.run``) and its line gives each top-level coarsening
   level's span seconds (``coarsening_levels_s``) and the summed seconds
   of device extension's nested coarsening levels; then the rating and
   commit kernels at ``L = LARGE_K`` on the path's own final partition,
   compared with their plain versions and timed;
10. minimum weights: ``KaMinPar("default")`` into k blocks of
    ``rmat_graph(scale - 4)`` with ``min_epsilon`` = epsilon: feasible and
    min-feasible;
11. pooled = serial: largek into ``POOLED_SERIAL_K`` blocks of
    ``rmat_graph(POOLED_SERIAL_SCALE)`` (device extension from 2,048
    nodes) with the extension jobs on a pool of one thread a job (up to
    the core count) and on one thread, the card's own width: equal
    partitions, both walls;
12. pool width: one device-pool bisection of a small graph timed alone
    (wall, device events, device ms), then 8 of them on 1 and on 8
    threads;
13. a small graph partitioned on the card (device pool) and on the CPU
    (host pool): both feasible, cuts within 1.3x of each other.
14. files and entry points, run right after 7: ``rmat_graph(SCHEME_SCALE)``
    (the host build) written as METIS by the port's ``write_graph`` and read
    back by the native and the NumPy parser, both equal to the graph, each
    parser's seconds and MB/s printed; the default path's graph written as
    ParHIP and partitioned by ``python -m kaminpar_tpu_torch <file> k -P
    default -o ... --block-sizes ... -E --trace-out ...`` in a subprocess
    with no ``--device`` (rc 0, phase 7's partition and cut, the block
    sizes of that partition, a valid trace, its wall printed; its launches
    are read at its exit through a ``sitecustomize`` hook on its
    ``PYTHONPATH``); the scale-16 graph's compressed container partitioned
    by ``cli.main([..., "-P", "terapart"])`` in this process, counters set
    to 0 just before and read just after: kernel #2 launched, the partition
    feasible.  Both CLI runs join ``launches_by_path``.
15. preemption, right after 14, on its ParHIP file of the default path's
    graph: ``python -m kaminpar_tpu_torch <file> k -P default -o ...`` in a
    subprocess with checkpoints armed at every boundary
    (``KPTPU_CHECKPOINT`` under ``build/``), a fault plan that sends it
    SIGTERM at the first uncoarsening boundary and the flight recorder
    beating every 0.5 s: it must die by SIGTERM, leave a checkpoint of
    that boundary and a dossier whose last phase is the deep pipeline's.
    Then ``KaMinPar("default").compute_partition(k, resume=dir)`` in this
    process, counters set to 0 just before and read just after, must give
    phase 7's partition bit for bit, launch kernels #1 and #3 (the
    ``resume`` path of ``launches_by_path``) and make no pull and no card
    sync outside a pull in ``checkpoint_restore``.  It prints each
    boundary's write seconds and bytes (the child's checkpoint log lines),
    the restore and resume seconds, and the writer's pulls against its
    entitlement.
16. serve, right after 15: ``PartitionEngine("serve",
    warm_ladder=(16384,), warm_ks=(8,), max_batch=8)`` on the card (its
    warmup report must show 0 nvcc builds: phase 2 built the kernels);
    a burst of ``SERVE_BURST`` requests, ``rmat_graph(14, 8,
    seed=100 + i)`` into 8 blocks, submitted at once, must run as one
    lane-stacked batch of 8 lanes (kernels #1 and #3 over the union of the
    lanes: the ``serve`` path of ``launches_by_path``) with 0 fallbacks
    and no breaker tripped; every partition feasible and equal bit for
    bit to ``KaMinPar("serve").compute_partition(8)`` of its graph on the
    card (the ``serve-pergraph`` path).  It prints the stacked wall beside
    the eight sequential walls, the stacked pulls against the lane pulls
    and the sequential pulls, p50/p99 latency, batch and lane occupancy,
    and the burst's peak memory against ``capacity.predict_for_graph``.
    Then admission: with ``queue_bound=2`` the third request is rejected
    with ``QueueFullError`` and ``retry_after_s > 0``, and with
    ``capacity_ceiling_bytes`` pinned below the prediction a request is
    rejected with ``CapacityError`` before it is queued; neither launches a
    kernel.  ``engine.metrics_text()`` must parse with
    ``telemetry/prometheus.validate``.  Last, ``python -m
    kaminpar_tpu_torch.serve --demo 4 --ladder 4096 --warm-ks 8
    --max-batch 4 --trace-out ...`` in a subprocess with no ``--device``:
    rc 0, its stats JSON, a valid trace; its launches (the ``serve-cli``
    path) come back through phase 14's hook.

The rating kernels are also timed bucket by bucket: one JSON line per
bucket with its width, rows, real rows, time and bound, beside the
earlier slices' bound (which counted pad rows and a bitonic network).

A kernel's ``ms`` is its time on the card: the card sleeps while the host
queues the timed calls.  Each kernel's own line also gives
``host_paced_ms``, the same calls timed with the card starting at once,
which includes the wrapper's host overhead where that is the longer.

It prints one JSON line per kernel, the ``{"kernels": [...]}`` line (each
kernel's ``launches`` summed over the paths that launch it, with
``launches_by_path``), the
``nvidia-smi`` name and power limit, and as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits with
code 2 before printing any result.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile
import time


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# The data sheet's float32 rate outside the tensor cores.  It lists no
# int32 rate, and scalar integer operations run no faster than this, so a
# time reckoned from it is a lower bound.
SCALAR_OPS_PER_S = 67e12
RATE_SOURCE = "kaminpar_tpu_torch/csrc/lp_rate.cu"
COMMIT_SOURCE = "kaminpar_tpu_torch/csrc/lp_commit.cu"
RATE_REPLACES = "kaminpar_tpu/ops/pallas_lp.py:245"
RATE_COMPRESSED_REPLACES = "kaminpar_tpu/ops/pallas_lp.py:370"
COMMIT_REPLACES = "kaminpar_tpu/ops/pallas_lp.py:654"
K, EPSILON = 16, 0.03  # BASELINE.md config 2: RMAT scale 22, k = 16
# Fewer blocks than K keep the two whole runs of the comparison short (the
# host-side extension grows with the number of blocks).
OFF_FINEST_K = 4
# The largek path: KaMinPar("largek"), which KaMinPar's users run for large
# k (BASELINE.md:21), at k = 1024.  Its cut must stay below 0.97x a random
# partition's, not the 0.95x of the k = 16 paths: the reference's own
# largek cuts RMAT graphs into 1024 blocks above 0.95x random (on
# rmat_graph(14), JAX's device pool 0.9596x, its host pool 0.9501x), and
# the port cuts as it does (0.9606x on the card there; 0.961x at scale
# 22).  ``tests/test_torch_extension.largek_rmat_cut_ratios`` gives both
# packages' ratios; PERF.md §6 has the table.
LARGE_K = 1024
LARGE_K_CUT_BOUND = 0.97
# The largek path runs this many scales below --scale (0 until the serve
# phase joined the script; at scale 22 the whole run then took 1,163 s of
# its 1,200 s on an NVIDIA H100 80GB HBM3 at 700 W).
LARGEK_SCALE_CUT = 1
# The pooled = serial check: largek into 64 blocks of rmat_graph(12) (its
# level 0, 3,352 nodes, extends on the device; at scale 13 the check took
# 89 s of the script's time limit on a card whose host paced it slowly).
POOLED_SERIAL_SCALE, POOLED_SERIAL_K = 12, 64
# CLP's colouring on the jet path's finest graph: the reference's 62
# colours and 64 rounds leave RMAT's dense core uncoloured, at colour 0
# (3,448 stragglers, 0.53% of the nodes, and 13.1% of the edges
# monochromatic, each at a straggler, on an H100 at scale 20).  The bounds,
# the measured shares with headroom, catch a regression of the colouring.
CLP_MAX_STRAGGLER_SHARE = 0.01
CLP_MAX_MONOCHROMATIC_SHARE = 0.2
# The strong path: KaMinPar("strong") into K blocks of rmat_graph(13) (14
# until the files-and-entry-points phase joined the script, which then ran
# 1,097-1,145 s against its 1,100 s budget; strong's 62 s is mostly host
# FM); its k-way FM is a sequential host pass, so at the jet path's scale
# one pass is timed alone, its work bounded to FM_PASS_WORK_FACTOR x n.
STRONG_SCALE = 13
FM_PASS_WORK_FACTOR = 0.25
# The other schemes' small functional checks (restricted v-cycle, recursive
# bisection, HEM coarsening, overlay clustering) run on rmat_graph(16) into
# K blocks; the v-cycle paths run one intermediate cycle at k = 4.
SCHEME_SCALE = 16
VCYCLES = (4,)
# The v-cycle path's cut may be at most this much above the default path's
# on the same graph (the JAX package's own bound, tests/test_vcycle.py).
VCYCLE_CUT_BOUND = 1.25
# HEM coarsening on RMAT shrinks a level by less than the default 5%
# convergence threshold (hubs match at most one neighbour); the HEM check
# lowers it to 1%, as the CPU parity cell does, so that HEM builds levels.
HEM_CONVERGENCE = 0.01
# The timer tree in every path's line: three scopes deep.
TIMER_DEPTH = 2
# The sync budget run's synchronizing calls outside a pull per phase before
# the quality probes joined the main path (H100 80GB HBM3, 700 W; every
# phase not named had none): with the trace arming the probes, no phase may
# have more.
SYNCS_BEFORE_PROBES = dict(extend_partition=75, lp_clustering=59, partitioning=56,
                           initial_partitioning=15, untracked=5)
# The preemption phase: the flight recorder's heartbeat period, and the
# boundary the fault plan kills the CLI at (the first uncoarsening one, so
# that the resume restores the level stack and a partition).
HEARTBEAT_S = 0.5
PREEMPT_PLAN = "preempt@deep_uncoarsen:execute-fault"
# The serve phase: a burst of SERVE_BURST requests of rmat_graph(14, 8)
# (the serve preset's edge factor; about 16k nodes and 0.23M directed edges
# each, all in one shape cell) into SERVE_K blocks, served as one
# lane-stacked batch by an engine warmed at SERVE_N nodes.
SERVE_SCALE, SERVE_N, SERVE_K, SERVE_BURST = 14, 16384, 8, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def run_accounting() -> dict:
    """The last run's timer tree (``TIMER_DEPTH`` + 1 scopes deep) and the
    readback census since the last ``sync_stats.reset()``."""
    from kaminpar_tpu_torch.utils import Timer, sync_stats

    return dict(timer=Timer.global_().paths(TIMER_DEPTH), sync=sync_stats.snapshot())


# Cycles the card sleeps before a timed run, so that the host has queued
# the run's launches before the start event: about 10 ms at the H100's
# clocks, longer than the host takes to queue 20 calls of a wrapper.
SLEEP_AHEAD_CYCLES = 20_000_000


def cuda_time_ms(fn, iters: int, warmup: int = 2, sleep_ahead: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls.  With ``sleep_ahead``
    the card sleeps first while the host queues the calls, so a call whose
    device time is below the host's time to launch it is timed on the
    device, not the host.  Without it the card starts at once, and a call
    that is quicker on the card than on the host is timed at the host's
    pace: the wrapper's overhead that the path pays on every launch."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_ahead:
        torch.cuda._sleep(SLEEP_AHEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(ref, out) -> int:
    """Largest absolute difference over the tensors of two result tuples."""
    import torch

    err = 0
    for r, o in zip(ref, out):
        d = (r.cpu().to(torch.int64) - o.cpu().to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


class PeakTracker:
    """Peak device memory of a run, split by the calls that may set it:
    the LP clustering of each level, the contractions (level 0 off the
    compressed stream or dense) and the finest level's re-decode.  Each
    such call is bracketed by a synchronize and a reset of the peak
    statistic, so the run's peak is the largest of the per-segment peaks;
    ``outside`` is the largest peak between the calls.  Where extension
    jobs run in threads, one thread's reset can fall between another's
    allocation and its read, so a peak may be missed there.  It also counts the
    commit kernel's calls by (n, L) in ``commit_calls``, with the most
    movers one target had in them (one read-back per call)."""

    TARGETS = (
        ("kaminpar_tpu_torch.coarsening.lp_clusterer", "LPClustering", "compute_clustering"),
        ("kaminpar_tpu_torch.coarsening.cluster_coarsener", None, "contract_compressed"),
        ("kaminpar_tpu_torch.coarsening.cluster_coarsener", None, "contract_clustering"),
        ("kaminpar_tpu_torch.graph.device_compressed", "DeviceCompressedView",
         "materialize_csr"),
    )

    def __enter__(self):
        import importlib

        import torch

        self.calls, self.outside, self._saved = [], 0, []
        for module, cls, name in self.TARGETS:
            owner = importlib.import_module(module)
            owner = getattr(owner, cls) if cls else owner
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            setattr(owner, name, self._wrap(name, fn))
        self._count_commits()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return self

    def _count_commits(self):
        import threading

        from kaminpar_tpu_torch.ops import lp_kernels

        self.commit_calls = collections.Counter()
        self.commit_hubs = collections.Counter()  # the most movers on one target
        commit = lp_kernels.commit_moves
        self._saved.append((lp_kernels, "commit_moves", commit))
        lock = threading.Lock()  # extension jobs commit from a thread pool

        def counted(*args, **kwargs):
            L = kwargs["num_labels"] if "num_labels" in kwargs else args[6]
            key = (int(args[1].shape[0]), int(L))
            hub = commit_movers(args, kwargs)[1]
            with lock:
                self.commit_calls[key] += 1
                self.commit_hubs[key] = max(self.commit_hubs[key], hub)
            return commit(*args, **kwargs)

        lp_kernels.commit_moves = counted

    def commit_log(self, path: str) -> list:
        """Logs the commit calls by (n, L), with the most movers that one
        target had in any of them, on a line of their own; returns them."""
        calls = [dict(n=n, L=L, calls=c, largest_target=self.commit_hubs[(n, L)])
                 for (n, L), c in sorted(self.commit_calls.items())]
        log(json.dumps(dict(phase="commit_calls", path=path, total=sum(
            self.commit_calls.values()), calls=calls)))
        return calls

    def _wrap(self, name, fn):
        import torch

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            self.outside = max(self.outside, torch.cuda.max_memory_allocated())
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls.append(dict(
                call=name, n=next((a.n for a in args if hasattr(a, "n")), None),
                before=before, peak=torch.cuda.max_memory_allocated(),
                after=torch.cuda.memory_allocated()))
            torch.cuda.reset_peak_memory_stats()
            return out

        return wrapped

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self.outside = max(self.outside, torch.cuda.max_memory_allocated())
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    @property
    def peak(self) -> int:
        return max([self.outside] + [c["peak"] for c in self.calls])


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} x{count}; torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")
    return name, count, smi


def phase_build():
    from kaminpar_tpu_torch.ops import lp_kernels

    t0 = time.perf_counter()
    lp_kernels.build()
    lines = [
        ln.strip() for ln in lp_kernels.BUILD_INFO["log"].splitlines()
        if any(s in ln for s in ("registers", "spill", "smem", "Compiling entry"))
    ]
    log(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    for ln in lines:
        log(f"  ptxas: {ln}")


def finest_graph(graph, k, device):
    """The graph the main path partitions: isolated nodes stripped, on the
    card (as the facade builds it)."""
    from kaminpar_tpu_torch.graph.csr import from_numpy_csr
    from kaminpar_tpu_torch.graph.isolated import strip_isolated_csr

    stripped = strip_isolated_csr(
        graph.host_row_ptr(), lambda: graph.col_idx.numpy(), graph.node_w.numpy(),
        graph.n, k,
    )
    if stripped is None:
        return graph.to(device)
    _, _, rp, col, nw = stripped
    return from_numpy_csr(rp, col, nw, graph.edge_w.numpy(), device=device)


def table_bytes(n_pad: int, L: int, maxw_len: int) -> int:
    """The label, node-weight, label-weight and cap tables, read once."""
    return 4 * (2 * n_pad + L + maxw_len)


def dense_bucket_bytes(R: int, real: int, w: int) -> int:
    """Bytes one dense bucket must move: the node, cols, wgts and tie of its
    real rows (pad rows have a fixed answer) and the four outputs of all
    rows."""
    return 4 * real + 3 * 4 * real * w + R * (3 * 4 + 1)


def dense_bucket_bytes_all_rows(R: int, w: int) -> int:
    """The bound of the earlier slices: every row's inputs, pad rows too."""
    return dense_bucket_bytes(R, R, w)


def rating_ops(rows: int, w: int) -> int:
    """Least integer operations of rating ``rows`` rows of width ``w``,
    whatever the design: a comparison sort of each row (w log2 w
    comparisons) and, per slot, the label gather's address, the own-label
    test and add, the run-sum add and the run-end test."""
    lg = w.bit_length() - 1
    return rows * w * (lg + 4)


def bitonic_ops(R: int, w: int) -> int:
    """The operation count of the earlier slices: a bitonic network's
    compare-exchanges over every row, one design's work."""
    lg = w.bit_length() - 1
    return R * (w // 2) * lg * (lg + 1) // 2 + 2 * R * w


def commit_bytes(n: int, L: int, maxw_len: int, act: bool, coin: bool,
                 active: bool = False) -> int:
    """The commit's inputs read once (labels, node_w, target, tconn,
    own_conn, prio; the flags it uses: the active share, the tie coins, the
    colour-class mask; label weights and caps) and its outputs written once
    (new labels, new label weights, the count)."""
    return (4 * (6 * n + L + maxw_len) + n * (int(act) + int(coin) + int(active))
            + 4 * (n + L + 1))


def commit_ops(n: int, movers: int) -> int:
    """Least operations of one commit: per node the movers test (compare,
    select, compare, mask) and the accept step (compare, select, weight
    add); per mover its demand add and threshold compare."""
    return 7 * n + 2 * movers


def bound(nbytes: int, ops: int):
    """(bound_ms, bound_by): the larger of the byte time and the op time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_buckets(kernel: str, launch, buckets) -> list:
    """Times ``launch(i)`` on every bucket ``i`` alone and logs one line per
    bucket: its shape, real rows, time, and its bound beside the earlier
    slices' bound.  ``buckets`` holds per bucket ``(w, R, real, nbytes,
    ops, old_bytes, old_ops)``."""
    lines = []
    for i, (w, R, real, nbytes, ops, old_bytes, old_ops) in enumerate(buckets):
        bound_ms, bound_by = bound(nbytes, ops)
        line = dict(kernel=kernel, bucket=i, w=w, R=R, real_rows=real,
                    ms=cuda_time_ms(lambda: launch(i), iters=20), bound_ms=bound_ms,
                    bound_by=bound_by, old_bound_ms=bound(old_bytes, old_ops)[0])
        log(json.dumps(line))
        lines.append(line)
    return lines


def pass_bounds(buckets, tables: int, extra_ops: int = 0):
    """(bound_ms, bound_by, old_bound_ms) of one pass over ``buckets`` (as
    for time_buckets), the tables read once."""
    nbytes = tables + sum(b[3] for b in buckets)
    ops = extra_ops + sum(b[4] for b in buckets)
    old = bound(tables + sum(b[5] for b in buckets), extra_ops + sum(b[6] for b in buckets))
    return (*bound(nbytes, ops), old[0])


# The rating kernels' inputs as the path gives them: (instantiation,
# external_only, respect_caps, tie_break) of the clustering round, the
# two-hop pass, LP refinement and the balancer, with both tie-breaks.
RATE_CONFIGS = [
    ("cluster", False, True, "uniform"),
    ("cluster", False, True, "lightest"),
    ("cluster", False, False, "uniform"),
    ("refine", False, True, "uniform"),
    ("refine", True, True, "uniform"),
    ("refine", False, True, "lightest"),
]


def rating_tables(inst: str, node_w, k: int, randint):
    """Random labels, their label weights and the cap of one rating
    instantiation: clustering (``L = n_pad``, a scalar cap near the median
    cluster weight) or refinement (``L = num_labels_bucket(k)``, a cap
    table 3% above the mean block weight); returns (labels, lw, maxw, L)."""
    import torch

    from kaminpar_tpu_torch.ops import lp

    n_pad, device = int(node_w.shape[0]), node_w.device
    L = n_pad if inst == "cluster" else lp.num_labels_bucket(k)
    labels = randint(0, max(n_pad // 3, 1) if inst == "cluster" else k, (n_pad,))
    lw = torch.zeros(L, dtype=torch.int32, device=device).index_add_(0, labels, node_w)
    if inst == "cluster":
        maxw = (lw[lw > 0].float().median().int() + 1).to(torch.int32)
    else:
        maxw = torch.zeros(L, dtype=torch.int32, device=device)
        maxw[:k] = int(lw[:k].float().mean() * 1.03)
    return labels, lw, maxw, L


def rate_dense(labels, node_w, lw, maxw, bv, i: int, tie, **flags):
    """Kernel #1 on bucket ``i`` of ``bv``, as the LP round calls it."""
    from kaminpar_tpu_torch.ops import lp_kernels

    return lp_kernels.rate_bucket(labels, node_w, lw, maxw, bv.buckets[i], tie,
                                  real_rows=bv.real_rows[i], **flags)


def phase_kernels(work, device, k: int):
    """Each kernel against its plain version, both on the card, on the
    inputs the finest graph's bucketed layout gives them."""
    import torch

    from kaminpar_tpu_torch.ops import bucketed_gains, lp, lp_kernels

    pv, bv = work.padded(), work.bucketed()
    n_pad = pv.n_pad
    gen = torch.Generator(device=device).manual_seed(7)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    shapes = [tuple(b.cols.shape) for b in bv.buckets]
    log(f"kernels: finest graph n={work.n} m={work.m} n_pad={n_pad}; buckets (R, w): "
        f"{shapes}; heavy rows {int(bv.heavy.nodes.shape[0])}")

    # -- rating kernel: both instantiations, every flag combination the
    #    path uses, both tie-breaks, every bucket -----------------------
    rate_err = 0
    timed = None
    for inst, ext, caps, tie_break in RATE_CONFIGS:
        labels, lw, maxw, L = rating_tables(inst, pv.node_w, k, randint)
        ties = [randint(0, 2**31 - 1, s) for s in shapes]
        args = (labels, pv.node_w, lw, maxw)
        flags = dict(external_only=ext, respect_caps=caps, tie_break=tie_break)
        for i, (b, tie) in enumerate(zip(bv.buckets, ties)):
            ref = bucketed_gains._bucket_moves(labels, b, pv.node_w, lw, maxw, tie, **flags)
            out = rate_dense(*args, bv, i, tie, **flags)
            err = max_abs_err(ref, out)
            if err:
                raise AssertionError(f"rating kernel != plain: {inst} {flags} w={b.cols.shape[1]}")
            rate_err = max(rate_err, err)
        if timed is None:  # the clustering round's instantiation
            timed = dict(args=args, ties=ties, flags=flags, L=L, maxw_len=int(maxw.numel()))
        log(f"  rate {inst} external_only={ext} respect_caps={caps} {tie_break}: "
            f"equal on {len(shapes)} buckets")

    def kernel_pass():
        for i, tie in enumerate(timed["ties"]):
            rate_dense(*timed["args"], bv, i, tie, **timed["flags"])

    def plain_pass():
        labels, node_w, lw, maxw = timed["args"]
        for b, tie in zip(bv.buckets, timed["ties"]):
            bucketed_gains._bucket_moves(labels, b, node_w, lw, maxw, tie, **timed["flags"])

    buckets = [(w, R, real, dense_bucket_bytes(R, real, w), rating_ops(real, w),
                dense_bucket_bytes_all_rows(R, w), bitonic_ops(R, w))
               for (R, w), real in zip(shapes, bv.real_rows)]
    bound_ms, bound_by, old_bound_ms = pass_bounds(
        buckets, table_bytes(n_pad, timed["L"], timed["maxw_len"]))
    rate = dict(
        kernel="lp_rate", what="one rating pass over all buckets of the default path's "
        "finest graph, clustering instantiation", n=n_pad, L=timed["L"],
        kernel_ms=cuda_time_ms(kernel_pass, iters=20),
        host_paced_ms=cuda_time_ms(kernel_pass, iters=20, sleep_ahead=False),
        plain_ms=cuda_time_ms(plain_pass, iters=3, warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, old_bound_ms=old_bound_ms, library_ms=None,
        max_abs_err=rate_err,
    )
    rate["buckets"] = time_buckets(
        "lp_rate", lambda i: rate_dense(*timed["args"], bv, i, timed["ties"][i],
                                        **timed["flags"]), buckets)
    log(json.dumps(rate))

    # -- commit kernel: the clustering instantiation (n = L = n_pad, scalar
    #    cap) and the refinement one (L = 64, cap table), against both
    #    plain auctions
    n = n_pad
    node_w = pv.node_w
    cluster_call = clustering_commit_call(node_w, pv.n, pv.anchor, randint, gen)
    _, target, tconn, own, _, _, _, prio, _, act = cluster_call
    Lr = lp.num_labels_bucket(k)
    blocks = randint(0, k, (n,))
    lw_r = torch.zeros(Lr, dtype=torch.int32, device=device).index_add_(0, blocks, node_w)
    caps = torch.zeros(Lr, dtype=torch.int32, device=device)
    caps[:k] = int(lw_r[:k].float().mean() * 1.01)
    refine_call = (lp.LPState(blocks, lw_r, None), torch.remainder(target, k), tconn, own,
                   node_w, caps, Lr, prio, None, act)
    commit_err = 0
    for inst, call in (("cluster", cluster_call), ("refine", refine_call)):
        commit_err = max(commit_err, check_commit(inst, call, CLUSTER_OPTS, (True, False)))
    commit = time_commit(cluster_call, commit_err, CLUSTER_OPTS,
                         "the finest level of the default path, clustering instantiation")
    return rate, commit


def clustering_commit_call(node_w, n: int, anchor: int, randint, gen):
    """Inputs of one commit of the clustering instantiation over ``n_pad =
    len(node_w)`` nodes: labels are node ids (pad nodes on the anchor),
    ``L = n_pad``, a scalar cap of 4, random targets and priorities, half
    the nodes active."""
    import torch

    from kaminpar_tpu_torch.ops import lp

    n_pad, device = int(node_w.shape[0]), node_w.device
    ids = torch.cat([torch.arange(n, dtype=torch.int32, device=device),
                     torch.full((n_pad - n,), anchor, dtype=torch.int32, device=device)])
    lw = torch.zeros(n_pad, dtype=torch.int32, device=device).index_add_(0, ids, node_w)
    target, tconn, own = randint(0, n, (n_pad,)), randint(0, 8, (n_pad,)), randint(0, 8, (n_pad,))
    prio = randint(0, (1 << 30) - 1, (n_pad,))
    act = torch.rand(n_pad, generator=gen, device=device) < 0.5
    maxw = torch.tensor(4, dtype=torch.int32, device=device)
    return (lp.LPState(ids, lw, None), target, tconn, own, node_w, maxw, n_pad, prio, None, act)


def path_clustering_commit_call(ctx, cv, k: int, eps: float):
    """Inputs and flags of the first commit of the terapart path's level-0
    clustering, on the path's own data: labels are node ids (pad nodes on
    the anchor), the cap and the active share as the coarsener and
    ``LPClustering`` set them for this level (a graph with edge weights
    takes the weighted share), a round's draws and the targets rated by
    the decode-fused kernel on the compressed view ``cv``."""
    import torch

    from kaminpar_tpu_torch.coarsening.max_cluster_weights import compute_max_cluster_weight
    from kaminpar_tpu_torch.ops import lp

    c = ctx.coarsening
    device, n, n_pad = cv.node_w_pad.device, cv.n, cv.n_pad
    weighted = (bool(c.lp.weighted_mode) if c.lp.weighted_mode is not None
                else not cv.cg.has_uniform_edge_weights())
    active_prob = min(c.lp.active_prob, c.lp.weighted_active_prob) if weighted else (
        c.lp.active_prob)
    max_cw = compute_max_cluster_weight(c, n, cv.total_node_weight, k, eps)
    if c.max_shrink_factor > 0:
        max_cw = min(max_cw, max(int(c.max_shrink_factor * cv.total_node_weight / max(n, 1)), 1))
    labels = torch.cat([torch.arange(n, dtype=torch.int32, device=device),
                        torch.full((n_pad - n,), cv.anchor, dtype=torch.int32, device=device)])
    state = lp.init_state(labels, cv.node_w_pad, n_pad)
    maxw = torch.tensor(max_cw, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(10)
    draws = lp.draw_lp_round(gen, cv, n_pad, active_prob=active_prob)
    target, tconn, own, _ = lp.best_moves(
        labels, cv, cv.node_w_pad, state.label_weights, maxw, draws.ties, draws.heavy_tie,
        external_only=False, respect_caps=True, tie_break=c.lp.tie_breaking.value)
    return ((state, target, tconn, own, cv.node_w_pad, maxw, n_pad, draws.prio, None, draws.act),
            dict(active_prob=active_prob))


# The commit's flags: the clustering round's (half the nodes active) and
# LP refinement's (the refinement context: active_prob 1.0, no tie moves).
CLUSTER_OPTS = dict(active_prob=0.5)
REFINE_OPTS = dict(active_prob=1.0)


def refinement_commit_call(node_w, n: int, k: int, randint, gen):
    """Inputs of one LP-refinement commit over ``n_pad = len(node_w)``
    nodes, synthetic: random blocks, ``L = num_labels_bucket(k)``, 5% of the
    real nodes rating another block higher, priorities as the round draws
    them (ties among them at this n), and caps that leave the even blocks
    contested (each fits half its movers' weight) and the odd ones not."""
    import torch

    from kaminpar_tpu_torch.ops import lp

    n_pad, device = int(node_w.shape[0]), node_w.device
    i32 = torch.int32
    L = lp.num_labels_bucket(k)
    blocks = torch.cat([randint(0, k, (n,)), torch.zeros(n_pad - n, dtype=i32, device=device)])
    lw = torch.zeros(L, dtype=i32, device=device).index_add_(0, blocks, node_w)
    target = torch.remainder(blocks + randint(1, k, (n_pad,)), k)
    move = (torch.rand(n_pad, generator=gen, device=device) < 0.05) & (
        torch.arange(n_pad, device=device) < n)
    tconn = torch.where(move, randint(1, 8, (n_pad,)), torch.zeros_like(blocks))
    prio = randint(0, (1 << 30) - 1, (n_pad,))
    demand = torch.zeros(L, dtype=i32, device=device).index_add_(
        0, target[move], node_w[move])
    caps = torch.zeros(L, dtype=i32, device=device)
    even = torch.arange(k, device=device) % 2 == 0
    caps[:k] = lw[:k] + torch.where(even, demand[:k] // 2, demand[:k] + 1)
    return (lp.LPState(blocks, lw, None), target, tconn, torch.zeros_like(blocks), node_w,
            caps, L, prio, None, None)


def check_commit(inst: str, call, opts: dict, auctions=None) -> int:
    """The commit kernel, run twice, against its plain version with each
    auction in ``auctions`` (radix or not; default: the one
    ``lp.use_radix_auction`` picks for L) on ``call``; raises on any
    difference, also between the two kernel runs (the kernel's mover list
    is appended in another order each run)."""
    from kaminpar_tpu_torch.ops import lp, lp_kernels

    L = call[6]
    auctions = auctions or (lp.use_radix_auction(L),)
    outs = [lp_kernels.commit_moves(*call, **opts) for _ in range(2)]
    if max_abs_err(outs[0], outs[1]):
        raise AssertionError(f"commit kernel: two runs differ: {inst}")
    err = 0
    for radix in auctions:
        err = max(err, max_abs_err(lp._commit_moves(*call, **opts, radix=radix), outs[0]))
        if err:
            raise AssertionError(f"commit kernel != plain: {inst} radix={radix}")
    log(f"  commit {inst} n={int(call[4].shape[0])} L={L} radix={list(auctions)}: equal, "
        f"two runs equal (moved {int(outs[0].num_moved)})")
    return err


def time_commit(call, err: int, opts: dict, what: str) -> dict:
    """The commit kernel (card time and host-paced) and its plain version,
    with the auction ``lp.use_radix_auction`` picks for L, timed on
    ``call``; the bound counts this call's movers."""
    import torch

    from kaminpar_tpu_torch.ops import lp, lp_kernels

    n, L = int(call[4].shape[0]), call[6]
    act = opts["active_prob"] < 1.0
    movers, largest = commit_movers(call, opts)
    bound_ms, bound_by = bound(
        commit_bytes(n, L, int(call[5].numel()), act=act,
                     coin=opts.get("allow_tie_moves", False),
                     active=opts.get("active") is not None),
        commit_ops(n, movers))
    radix = lp.use_radix_auction(L)
    meas = dict(
        kernel="lp_commit", what=f"one commit at {what} (n = {n}, L = {L}; the plain "
        f"version's auction: {'radix' if radix else 'bitwise'})", n=n, L=L, movers=movers,
        largest_target=largest,
        kernel_ms=cuda_time_ms(lambda: lp_kernels.commit_moves(*call, **opts), iters=20),
        host_paced_ms=cuda_time_ms(lambda: lp_kernels.commit_moves(*call, **opts), iters=20,
                                   sleep_ahead=False),
        plain_ms=cuda_time_ms(lambda: lp._commit_moves(*call, **opts, radix=radix), iters=3,
                              warmup=1),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None, max_abs_err=err,
        launch_ms=launch_ms(lambda: lp_kernels.commit_moves(*call, **opts)),
    )
    log(json.dumps(meas))
    return meas


def commit_movers(call, opts: dict):
    """(movers, the most movers on one target) of a commit call: its
    positional arguments as ``lp_kernels.commit_moves`` takes them and its
    keyword flags, by the rule the kernel applies."""
    import torch

    state, target, tconn, own = call[:4]
    better = tconn > own
    if opts.get("allow_tie_moves", False):
        better |= (tconn == own) & call[8]
    moved = torch.where(better, target, state.labels) != state.labels
    if opts.get("active") is not None:
        moved &= opts["active"]
    if opts.get("active_prob", 1.0) < 1.0:
        moved &= call[9]
    t = target[moved]
    return int(t.numel()), int(torch.bincount(t).max()) if t.numel() else 0


def launch_ms(fn, calls: int = 10) -> dict:
    """Device milliseconds per call of ``fn`` in each of its launches
    (kernels and memsets, by name), traced with ``torch.profiler``; empty
    when three traces recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = {}
    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if us > 0 and ("kernel" in ev.key or "Memset" in ev.key):
                name = re.search(r"\w+_kernel(<\w+>)?|Memset", ev.key)
                name = name.group(0) if name else ev.key
                rows[name] = rows.get(name, 0.0) + us / calls / 1e3
        if rows:
            break
    return rows


def compressed_buckets(cg, cv) -> list:
    """Per bucket of the compressed view, as time_buckets takes them.  The
    bytes a bucket must move: per real row its node, word start, width,
    degree and edge start; the stream words and, when weighted, the edge
    weights of its rows; the tie entries of the rows with edges (a row of
    degree 0 has a fixed answer, as do pad rows); the four outputs of all
    rows.  The operations: the rating's (rating_ops) over the rows with
    edges plus, per edge, the least decode work (a funnel shift, a mask,
    the zig-zag shift, and, xor, and the cumsum add).  The earlier slices'
    bound counted every row's metadata and tie row and a bitonic network."""
    import numpy as np

    words_of = np.diff(cg.word_start.astype(np.int64))
    out = []
    for cb, real in zip(cv.buckets, cv.real_rows):
        R, w = int(cb.nodes.shape[0]), cb.w
        nodes = cb.nodes[:real].cpu().numpy()
        deg = cg.degree[nodes].astype(np.int64)
        words, edges, busy = int(words_of[nodes].sum()), int(deg.sum()), int((deg > 0).sum())
        stream = 4 * words + (4 * edges if cv.stream.weighted else 0)
        out.append((w, R, real,
                    20 * real + stream + 4 * busy * w + 13 * R,
                    rating_ops(busy, w) + 6 * edges,
                    20 * R + stream + 4 * R * w + 13 * R,
                    bitonic_ops(R, w) + 6 * edges))
    return out


def phase_compressed_kernel(cg, ctx, device, k: int, eps: float):
    """The decode-fused rating kernel against its plain version, both on the
    card, on every bucket of the compressed view of ``cg`` (the view the
    terapart path builds), for its own stream, the same structure
    unweighted and with numpy-random weights; then the commit kernel at the
    view's level-0 clustering shape (synthetic, and the path's first round
    under the solver context ``ctx``) and its refinement shape (synthetic).
    Returns both measurements."""
    import dataclasses

    import numpy as np
    import torch

    from kaminpar_tpu_torch.graph.device_compressed import DeviceCompressedView
    from kaminpar_tpu_torch.ops import lp, lp_kernels

    gen = torch.Generator(device=device).manual_seed(8)

    def randint(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=device, dtype=torch.int32)

    variants = [
        ("own", cg),
        ("unweighted", dataclasses.replace(cg, edge_w=None)),
        ("numpy-weights", dataclasses.replace(cg, edge_w=np.random.default_rng(11).integers(
            1, 100, cg.m, dtype=np.int32))),
    ]
    err_max, meas = 0, None
    for vname, vcg in variants:
        cv = DeviceCompressedView(vcg, device)
        n_pad = cv.n_pad
        if meas is None:
            log(f"compressed kernel: n={cv.n} m={cv.m} n_pad={n_pad}; buckets (R, w): "
                f"{list(cv.bucket_shapes)}; heavy rows {int(cv.heavy.nodes.shape[0])}; "
                f"resident {cv.resident_bytes()} B vs dense {cv.dense_resident_bytes()} B")
        timed = None
        for inst, ext, caps, tie_break in RATE_CONFIGS:
            labels, lw, maxw, L = rating_tables(inst, cv.node_w_pad, k, randint)
            ties = [randint(0, 2**31 - 1, shape) for shape in cv.bucket_shapes]
            args = (labels, cv.node_w_pad, lw, maxw)
            flags = dict(external_only=ext, respect_caps=caps, tie_break=tie_break)
            for cb, tie in zip(cv.buckets, ties):
                ref = lp_kernels.rate_compressed_bucket_plain(*args, cv.stream, cb, tie, **flags)
                out = lp_kernels.rate_compressed_bucket(*args, cv.stream, cb, tie, **flags)
                err = max_abs_err(ref, out)
                if err:
                    raise AssertionError(
                        f"compressed rating kernel != plain: {vname} {inst} {flags} w={cb.w}")
                err_max = max(err_max, err)
            if timed is None:
                timed = dict(args=args, ties=ties, flags=flags, L=L, maxw_len=int(maxw.numel()))
        log(f"  rate_compressed {vname} stream (weighted={cv.stream.weighted}): equal on "
            f"{len(cv.buckets)} buckets for {len(RATE_CONFIGS)} configurations")
        if meas is None:  # the terapart path's own stream, clustering instantiation

            def kernel_pass():
                for cb, tie in zip(cv.buckets, timed["ties"]):
                    lp_kernels.rate_compressed_bucket(*timed["args"], cv.stream, cb, tie,
                                                      **timed["flags"])

            def plain_pass():
                for cb, tie in zip(cv.buckets, timed["ties"]):
                    lp_kernels.rate_compressed_bucket_plain(*timed["args"], cv.stream, cb,
                                                            tie, **timed["flags"])

            buckets = compressed_buckets(vcg, cv)
            bound_ms, bound_by, old_bound_ms = pass_bounds(
                buckets, table_bytes(n_pad, timed["L"], timed["maxw_len"]))
            meas = dict(
                kernel="lp_rate_compressed", what="one compressed rating pass over all "
                "buckets of the finest graph, clustering instantiation, its own stream",
                kernel_ms=cuda_time_ms(kernel_pass, iters=20),
                host_paced_ms=cuda_time_ms(kernel_pass, iters=20, sleep_ahead=False),
                plain_ms=cuda_time_ms(plain_pass, iters=3, warmup=1),
                bound_ms=bound_ms, bound_by=bound_by, old_bound_ms=old_bound_ms,
                library_ms=None,
            )
            meas["buckets"] = time_buckets(
                "lp_rate_compressed",
                lambda i: lp_kernels.rate_compressed_bucket(
                    *timed["args"], cv.stream, cv.buckets[i], timed["ties"][i],
                    **timed["flags"]), buckets)
            # The commit at the level-0 clustering of the terapart path (the
            # isolated nodes stay in, so L = n_pad) and an LP-refinement
            # commit at the same level (L = 64).
            call = clustering_commit_call(cv.node_w_pad, cv.n, cv.anchor, randint, gen)
            err = check_commit("cluster, terapart level 0", call, CLUSTER_OPTS)
            commit = time_commit(call, err, CLUSTER_OPTS,
                                 "terapart level 0, clustering instantiation")
            call = refinement_commit_call(cv.node_w_pad, cv.n, k, randint, gen)
            err = check_commit("refine (synthetic), terapart level 0", call, REFINE_OPTS,
                               (True, False))
            commit["instances"] = [commit.copy(), time_commit(
                call, err, REFINE_OPTS, "terapart level 0, refinement instantiation, "
                "synthetic: 5% of the nodes move, even blocks contested")]
            call, opts = path_clustering_commit_call(ctx, cv, k, eps)
            err = check_commit("cluster (path data), terapart level 0", call, opts)
            commit["instances"].append(time_commit(
                call, err, opts, "terapart level 0, clustering instantiation, the path's "
                "first round: node ids as labels, its cap and active share, moves rated on the view"))
            del call
        del cv, timed
        torch.cuda.empty_cache()
    meas["max_abs_err"] = err_max
    log(json.dumps(meas))
    return meas, commit


def phase_refinement_commit(cv, partition, max_block_weights, device, k: int) -> dict:
    """The commit of an LP-refinement round at the terapart path's finest
    level, on the path's own data: the run's final ``partition`` as labels
    and caps as ``LPRefiner.refine`` builds them, the targets rated by the
    decode-fused kernel on the level's compressed view ``cv`` with a
    round's draws (the refinement context's flags: active_prob 1.0, no tie
    moves); checked against both plain auctions and timed."""
    import numpy as np
    import torch

    from kaminpar_tpu_torch.ops import lp

    if tuple(partition.shape) != (cv.n,):
        raise AssertionError("the final partition does not match the compressed view")
    L = lp.num_labels_bucket(k)
    labels = torch.zeros(cv.n_pad, dtype=torch.int32, device=device)
    labels[: cv.n] = torch.as_tensor(partition).to(device=device, dtype=torch.int32)
    state = lp.init_state(labels, cv.node_w_pad, L)
    caps = torch.zeros(L, dtype=torch.int32, device=device)
    caps[:k] = torch.as_tensor(np.asarray(max_block_weights), dtype=torch.int32)
    gen = torch.Generator(device=device).manual_seed(9)
    draws = lp.draw_lp_round(gen, cv, cv.n_pad)
    target, tconn, own, _ = lp.best_moves(labels, cv, cv.node_w_pad, state.label_weights,
                                          caps, draws.ties, draws.heavy_tie,
                                          external_only=False, respect_caps=True)
    call = (state, target, tconn, own, cv.node_w_pad, caps, L, draws.prio, None, None)
    err = check_commit("refine (path data), terapart level 0", call, REFINE_OPTS,
                       (True, False))
    return time_commit(call, err, REFINE_OPTS, "terapart level 0, refinement "
                       "instantiation, the path's final partition and rated moves")


def phase_terapart_path(solver, graph, k: int, eps: float, compress_s: float):
    """``compute_partition`` of the terapart solver (the graph already set
    and compressed), with the host decompress refused."""
    import torch

    from kaminpar_tpu_torch.graph.compressed import CompressedGraph
    from kaminpar_tpu_torch.ops import bipartition, lp_kernels
    from kaminpar_tpu_torch.utils import sync_stats

    def refuse(self, device="cpu"):
        raise AssertionError("the terapart path decompressed on the host")

    host_decompress = CompressedGraph.decompress
    CompressedGraph.decompress = refuse
    try:
        with PeakTracker() as mem:
            lp_kernels.reset_launches()
            bipartition.reset_pool_stats()
            sync_stats.reset()
            t0 = time.perf_counter()
            part = solver.compute_partition(k, epsilon=eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(lp_kernels.LAUNCHES)
            pool = bipartition.pool_stats_snapshot()
    finally:
        CompressedGraph.decompress = host_decompress
    p = solver.last_partition
    cv = solver.last_partitioner.compressed_view
    cut = int(p.edge_cut())
    bw = p.block_weights()
    feasible = bool(p.is_feasible())
    total_ew = graph.total_edge_weight // 2
    info = dict(phase="terapart_path", n=graph.n, m=graph.m, k=k, epsilon=eps, cut=cut,
                random_cut_expected=int(total_ew * (1 - 1 / k)), feasible=feasible,
                max_block_weight=int(bw.max()), min_block_weight=int(bw.min()),
                wall_s=wall, compress_s=compress_s, peak_bytes=mem.peak,
                peak_outside_bytes=mem.outside, peak_calls=mem.calls,
                resident_bytes=cv.resident_bytes(),
                dense_resident_bytes=cv.dense_resident_bytes(),
                compressed_host_bytes=solver.compressed_graph.memory_bytes(),
                levels=solver.last_partitioner.num_levels,
                coarsest=solver.last_partitioner.coarsest,
                phase_s=solver.last_partitioner.phase_seconds,
                extension_jobs=solver.last_partitioner.extension_jobs, pool=pool,
                launches=launches, commit_calls=mem.commit_log("terapart"),
                **run_accounting())
    log(json.dumps(info))
    check_pool_served(pool, "terapart")
    if not feasible:
        raise AssertionError("terapart partition is infeasible")
    if part.shape != (graph.n,) or bw.min() <= 0:
        raise AssertionError("terapart partition does not use all k blocks")
    if cut >= 0.95 * total_ew * (1 - 1 / k):
        raise AssertionError("terapart cut is not clearly below a random partition's")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the terapart path: {launches}")
    return info


def phase_off_vs_finest(g, scale: int, k: int, eps: float):
    """``device_decode`` "off" (host decompress, dense layout) against
    "finest" (decode-fused kernels) on the card: equal partitions."""
    import numpy as np

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.ops import lp_kernels

    parts, info = {}, dict(phase="off_vs_finest", graph=f"rmat_graph({scale}, 16, seed=1)",
                           k=k)
    for mode in ("off", "finest"):
        solver = kp.KaMinPar("terapart")
        solver.ctx.compression.device_decode = mode
        solver.set_graph(g)
        lp_kernels.reset_launches()
        t0 = time.perf_counter()
        parts[mode] = solver.compute_partition(k, epsilon=eps)
        info[mode] = dict(wall_s=time.perf_counter() - t0,
                          cut=int(solver.last_partition.edge_cut()),
                          launches=dict(lp_kernels.LAUNCHES))
    info["equal"] = bool(np.array_equal(parts["off"], parts["finest"]))
    log(json.dumps(info))
    if not info["equal"]:
        raise AssertionError('device_decode "off" and "finest" partitions differ')


def phase_round_reference(device):
    """One LP clustering round, one balancer round, one underload round,
    one group-restricted balancer round (on the group-masked graph), one
    JET move round, one colouring and one colored LP iteration through the
    wrappers: the kernels on the card against the plain versions on the
    CPU, with the same draws (a small graph: the CPU side is slow)."""
    import torch

    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.ops import bucketed_gains, coloring, lp
    from kaminpar_tpu_torch.refinement import balancer, jet

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        items = [None if v is None else to(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)

    g = generators.rmat_graph(14, 16, seed=3)
    pv, bv = g.padded(), g.bucketed()
    dg = g.to(device)
    dpv, dbv = dg.padded(), dg.bucketed()
    gen = torch.Generator().manual_seed(5)
    ids = torch.cat([torch.arange(pv.n, dtype=torch.int32),
                     torch.full((pv.n_pad - pv.n,), pv.anchor, dtype=torch.int32)])
    draws = lp.draw_lp_round(gen, bv, pv.n_pad, active_prob=0.5)
    cap = torch.tensor(40, dtype=torch.int32)
    ref = lp.lp_round_bucketed(lp.init_state(ids, pv.node_w, pv.n_pad), draws, bv,
                               pv.node_w, cap, num_labels=pv.n_pad, active_prob=0.5)
    out = lp.lp_round_bucketed(lp.init_state(ids.to(device), dpv.node_w, pv.n_pad),
                               to(draws), dbv, dpv.node_w, cap.to(device),
                               num_labels=pv.n_pad, active_prob=0.5)
    if max_abs_err(ref, out):
        raise AssertionError("LP round on the card != plain round on the CPU")
    k = 4
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.randint(0, 2, (pv.n,), generator=gen, dtype=torch.int32)
    max_bw = torch.full((k,), int(g.total_node_weight / k * 1.03) + 1, dtype=torch.int32)
    bdraws = balancer.draw_balance_round(gen, bv, pv.n_pad)
    bref = balancer._balance_round(part, bdraws, bv, pv.node_w, max_bw, k=k)
    bout = balancer._balance_round(part.to(device), to(bdraws), dbv, dpv.node_w,
                                   max_bw.to(device), k=k)
    if max_abs_err(bref, bout):
        raise AssertionError("balancer round on the card != plain round on the CPU")

    # an underload round (minimums 3% under the mean, one block nearly
    # empty) and a grouped balancer round on the group-masked graph, as
    # device extension runs it (8 blocks in groups of 2)
    k = 8
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.randint(0, k - 1, (pv.n,), generator=gen, dtype=torch.int32)
    W = g.total_node_weight
    max_bw = torch.full((k,), int(W / k * 1.03) + 1, dtype=torch.int32)
    min_bw = torch.full((k,), int(W / k * 0.97), dtype=torch.int32)
    udraws = balancer.draw_balance_round(gen, bv, pv.n_pad)
    uref = balancer._underload_round(part, udraws, bv, pv.node_w, max_bw, min_bw, k=k)
    uout = balancer._underload_round(part.to(device), to(udraws), dbv, dpv.node_w,
                                     max_bw.to(device), min_bw.to(device), k=k)
    if max_abs_err(uref, uout):
        raise AssertionError("underload round on the card != plain round on the CPU")
    group_of = torch.arange(k, dtype=torch.int32) // 2
    comm = group_of[part[: pv.n].long()]
    mg, dmg = g.community_masked(comm), dg.community_masked(comm.to(device))
    mbv = mg.bucketed()
    gdraws = balancer.draw_balance_round(gen, mbv, pv.n_pad)
    part[: pv.n] = torch.where(part[: pv.n] % 2 == 1, part[: pv.n] - 1, part[: pv.n])
    gref = balancer._balance_round(part, gdraws, mbv, pv.node_w, max_bw, k=k,
                                   group_of=group_of)
    gout = balancer._balance_round(part.to(device), to(gdraws), dmg.bucketed(),
                                   dmg.padded().node_w, max_bw.to(device), k=k,
                                   group_of=group_of.to(device))
    if max_abs_err(gref, gout):
        raise AssertionError("grouped balancer round on the card != plain round on the CPU")
    log(f"round reference: rmat_graph(14, 16, seed=3): one LP round (moved "
        f"{int(out.num_moved)}), one balancer round (moved {int(bout[1][0])}), one "
        f"underload round (moved {int(uout[1][0])}) and one grouped balancer round (moved "
        f"{int(gout[1][0])}) on the card equal the plain rounds on the CPU")
    if min(int(uout[1][0]), int(gout[1][0])) <= 0:
        raise AssertionError("the underload or grouped round moved nothing")

    # the quality refiners' rounds: one JET move round (kernel #1 in its
    # find mode), one colouring and one colored LP iteration (kernel #3
    # with colour-class masks), 16 blocks
    k = 16
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.randint(0, k, (pv.n,), generator=gen, dtype=torch.int32)
    locked = torch.zeros(pv.n_pad, dtype=torch.bool)
    locked[: pv.n] = torch.rand(pv.n, generator=gen) < 0.2
    max_bw = torch.full((k,), int(W / k * 1.03) + 1, dtype=torch.int32)
    ties = bucketed_gains.draw_ties(gen, bv)
    jref = jet._jet_move_round(part, locked, ties, bv, pv.node_w, max_bw, 0.75, k=k)
    jout = jet._jet_move_round(part.to(device), locked.to(device), to(ties), dbv,
                               dpv.node_w, max_bw.to(device), 0.75, k=k)
    if max_abs_err(jref, jout):
        raise AssertionError("JET move round on the card != plain round on the CPU")
    prios = [torch.randint(0, 2**31 - 1, (pv.n_pad,), generator=gen, dtype=torch.int32)
             for _ in range(64)]
    mask = torch.arange(pv.n_pad) < pv.n
    cref, crounds = coloring.color_graph(lambda i: prios[i], pv.edge_u, pv.col_idx, mask,
                                         n=pv.n_pad)
    cout, drounds = coloring.color_graph(lambda i: prios[i].to(device), dpv.edge_u,
                                         dpv.col_idx, mask.to(device), n=pv.n_pad)
    if max_abs_err((cref,), (cout,)) or crounds != drounds:
        raise AssertionError("colouring on the card != colouring on the CPU")
    colors = torch.clamp(cref, min=0)
    nc = int(coloring.num_colors_device(colors, mask))
    L = lp.num_labels_bucket(k)
    caps = torch.zeros(L, dtype=torch.int32)
    caps[:k] = int(W / k * 1.05) + 1
    cdraws = [lp.draw_lp_round(gen, bv, pv.n_pad, allow_tie_moves=True) for _ in range(nc)]
    sref = lp.clp_iterate_colors(lp.init_state(part, pv.node_w, L), lambda c: cdraws[c], bv,
                                 pv.node_w, caps, colors, nc, num_labels=L)
    sout = lp.clp_iterate_colors(lp.init_state(part.to(device), dpv.node_w, L),
                                 lambda c: to(cdraws[c]), dbv, dpv.node_w, caps.to(device),
                                 colors.to(device), nc, num_labels=L)
    if max_abs_err(sref, sout):
        raise AssertionError("CLP iteration on the card != plain iteration on the CPU")
    log(f"round reference: one JET move round (moved {int(jout[1].sum())}), one colouring "
        f"({nc} colours, {crounds} rounds, {int((cref < 0).sum())} stragglers) and one CLP "
        f"iteration ({nc} supersteps, moved {int(sout.num_moved)}) on the card equal the "
        f"plain versions on the CPU")
    if int(jout[1].sum()) <= 0 or int(sout.num_moved) <= 0:
        raise AssertionError("the JET round or the CLP iteration moved nothing")


def check_pool_served(pool: dict, path: str) -> None:
    """Every bisection of a path on the card ran on the device pool."""
    if pool["calls"] <= 0 or pool["host_bisections"]:
        raise AssertionError(f"the {path} path's bisections did not all take the device "
                             f"pool: {pool}")


class CoarsestCapture:
    """Keeps the first graph the deep partitioner bisects, its coarsest
    (host CSR), with its block count k0 and block budgets."""

    def __enter__(self):
        from kaminpar_tpu_torch.partitioning import deep

        self._deep, self._orig = deep, deep.recursive_bipartition
        self.graph = None

        def capture(g, k, budgets, rng, ctx=None, **kwargs):
            if self.graph is None:
                self.graph, self.k0, self.budgets, self.ctx = g, k, budgets.copy(), ctx
            return self._orig(g, k, budgets, rng, ctx, **kwargs)

        deep.recursive_bipartition = capture
        return self

    def __exit__(self, *exc):
        self._deep.recursive_bipartition = self._orig


class RefineCapture:
    """Keeps host copies of two levels a single-shot k-way run refines, each
    with the partition its refiner returned there and the block caps: the
    coarsest (the first refine call) and the finest level the coarsener
    sparsified (the last refine call on a graph ``sparsify_threshold``
    returned).  The copies fall inside the path's wall; their seconds are
    counted in ``seconds``."""

    def __enter__(self):
        import weakref

        import numpy as np

        from kaminpar_tpu_torch.coarsening import cluster_coarsener
        from kaminpar_tpu_torch.partitioning import kway

        self._mods = (kway, cluster_coarsener)
        self._orig = (kway.create_refiner, cluster_coarsener.sparsify_threshold)
        sparsified = weakref.WeakSet()
        self.levels = {}
        self.seconds = 0.0

        def keep(name, p_graph):
            t0 = time.perf_counter()
            g = p_graph.graph
            self.levels[name] = dict(
                csr=[x.cpu().numpy() for x in (g.row_ptr, g.col_idx, g.node_w, g.edge_w)],
                part=p_graph.partition.cpu().numpy(),
                caps=np.asarray(p_graph.max_block_weights))
            self.seconds += time.perf_counter() - t0

        def sparsify(graph, target_m):
            out = self._orig[1](graph, target_m)
            sparsified.add(out)
            return out

        def create_refiner(ctx, **kwargs):
            refiner = self._orig[0](ctx, **kwargs)
            inner = refiner.refine

            def refine(p_graph):
                first = not self.levels
                out = inner(p_graph)
                if first:
                    keep("coarsest", out)
                if p_graph.graph in sparsified:
                    keep("sparsified", out)
                return out

            refiner.refine = refine
            return refiner

        kway.create_refiner = create_refiner
        cluster_coarsener.sparsify_threshold = sparsify
        return self

    def __exit__(self, *exc):
        self._mods[0].create_refiner, self._mods[1].sparsify_threshold = self._orig


def phase_captured_kernels(cap: RefineCapture, level: str, path: str, device, k: int):
    """Kernels #1 and #3 (``phase_refine_kernels``) on a level a k-way path
    refined, rebuilt on the card from its ``RefineCapture`` copy, with the
    partition the path's refiner returned there."""
    from kaminpar_tpu_torch.graph.csr import from_numpy_csr

    if level not in cap.levels:
        raise AssertionError(f"the {path} path refined no {level} level")
    saved = cap.levels[level]
    g = from_numpy_csr(*saved["csr"], device=device)
    return phase_refine_kernels(
        g, saved["part"], saved["caps"], device, k,
        f"the {path} path's {level} level ({g.n} nodes, {g.m} edges), the partition "
        "its refiner returned there", seed=14)


def device_activity(fn):
    """Device events (kernels, memsets, copies) that one call of ``fn``
    launches and the device milliseconds they take, traced with
    ``torch.profiler``; (None, None) when three traces recorded no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a trace now and then comes back without device events
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if events:
            return len(events), sum(ev.time_range.elapsed_us() for ev in events) / 1e3
    return None, None


def phase_pool(cap, device):
    """The device pool on the default path's coarsest graph (its first
    bisection: the same budgets and block count): on the card and on the
    CPU from the same draws (drawn on the CPU by a seeded generator, copied
    to the card), exact; the lane loop on the card under
    ``set_sync_debug_mode("error")`` (no host synchronisation before the
    one readback); then one bisection with the production draws timed on
    the card, with the device events it launched and their device time."""
    import numpy as np
    import torch

    from kaminpar_tpu_torch.graph.csr import from_numpy_csr
    from kaminpar_tpu_torch.initial.bipartitioner import _twoway_budgets
    from kaminpar_tpu_torch.ops import bipartition as bip

    g, k0, ctx = cap.graph, cap.k0, cap.ctx
    mw = _twoway_budgets(g, k0, cap.budgets, (k0 + 1) // 2, ctx.use_adaptive_epsilon)
    methods, _ = bip.method_lane_counts(ctx, k0)
    dpv = from_numpy_csr(g.row_ptr, g.col_idx, g.node_w, g.edge_w, device=device).padded()
    trips, rounds = bip.grow_trip_count(dpv.n_pad), bip.fm_round_count(
        dpv.n_pad, ctx.fm_num_iterations)
    seed = 20260
    t0 = time.perf_counter()
    rec = bip.RecordedPoolDraws(bip.GeneratorPoolDraws(seed, methods, dpv.n_pad, "cpu"),
                                methods, g.n, trips, rounds)
    rec_card = rec.to(device)
    draw_s = time.perf_counter() - t0
    args = (g.row_ptr, g.col_idx, g.node_w, g.edge_w, mw, seed, ctx, k0)
    t0 = time.perf_counter()
    cpu_labels, cpu_stats = bip.pool_bipartition_device(*args, device="cpu",
                                                        draws=lambda *a: rec)
    cpu_s = time.perf_counter() - t0
    card_labels, card_stats = bip.pool_bipartition_device(*args, device=device,
                                                          draws=lambda *a: rec_card)
    equal = bool(np.array_equal(cpu_labels, card_labels)) and cpu_stats == card_stats

    pg = bip.PoolGraph.from_padded(dpv, int(g.node_w.sum()))
    target = bip.grow_target(pg.total, int(mw[0]), int(mw[1]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = bip._pool_kernel(rec_card, pg, g.n, target, int(mw[0]), int(mw[1]),
                                  methods=methods, grow_trips=trips, fm_rounds=rounds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    sync_free_equal = bool(np.array_equal(packed.cpu().numpy()[: g.n], card_labels))

    def bisect():
        return bip.pool_bipartition_device(*args, device=device)

    bisect()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        bisect()  # ends in its readback
        walls.append((time.perf_counter() - t0) * 1e3)
    events, device_ms = device_activity(bisect)
    ms = sorted(walls)[1]
    lanes = sum(c for _, c in methods)
    budget = bip.edge_temp_budget(device)
    info = dict(phase="pool", graph="the default path's coarsest graph", n=g.n,
                m=int(len(g.col_idx)), n_pad=dpv.n_pad, m_pad=dpv.m_pad, k0=k0,
                budgets=[int(x) for x in mw], methods=[list(x) for x in methods],
                lanes=lanes, grow_trips=trips, fm_rounds=rounds,
                pass_bytes=lanes * dpv.m_pad * bip._EDGE_TEMP_BYTES, edge_temp_budget=budget,
                chunks=len(bip.lane_chunks(methods, dpv.m_pad, budget)),
                equal=equal, sync_free=sync_free_equal, stats=card_stats,
                cpu_s=cpu_s, draw_record_s=draw_s, ms=ms, walls_ms=walls,
                device_events=events, device_ms=device_ms,
                device_idle_share=None if device_ms is None else 1 - device_ms / ms)
    log(json.dumps(info))
    if not equal:
        raise AssertionError("the pool on the card differs from the pool on the CPU")
    if not sync_free_equal:
        raise AssertionError("the sync-free pool run differs from the pool on the card")
    return info


SCHEME_STATS = ("level_n", "converged", "sparsification", "cycles", "bisections",
                "subgraph_devices")


def drive_dense_path(preset: str, phase: str, graph, k: int, eps: float, cut_bound: float,
                     capture=None, configure=None, trace=False):
    """``KaMinPar(preset).compute_partition(k)`` on the card (its context
    changed by ``configure``, if given), with the launch counters and pool
    stats set to 0 just before and read just after and the peaks tracked
    (and ``capture`` entered, if given); logs the path's line, with the
    scheme's own stats (``SCHEME_STATS``), and checks it: feasible, all k
    blocks used, the cut below ``cut_bound`` x a random partition's, both
    dense-path kernels run and every bisection on the device pool.  With
    ``trace`` the run is recorded (``telemetry.run``) and the line gives
    the span seconds of every top-level coarsening level and the summed
    ones of device extension's nested levels.  Returns (line, solver,
    partition)."""
    import contextlib

    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch import telemetry
    from kaminpar_tpu_torch.ops import bipartition, lp_kernels
    from kaminpar_tpu_torch.refinement import fm_refiner, jet
    from kaminpar_tpu_torch.utils import sync_stats

    solver = kp.KaMinPar(preset)  # no device: cuda:0
    if configure is not None:
        configure(solver.ctx)
    solver.set_graph(graph)
    recording = telemetry.run() if trace else contextlib.nullcontext()
    with PeakTracker() as mem, capture or contextlib.nullcontext(), recording as rec:
        lp_kernels.reset_launches()
        bipartition.reset_pool_stats()
        jet.reset_jet_stats()
        fm_refiner.reset_fm_stats()
        sync_stats.reset()
        t0 = time.perf_counter()
        part = solver.compute_partition(k, epsilon=eps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(lp_kernels.LAUNCHES)
        rate_modes = dict(lp_kernels.RATE_MODES)
        pool = bipartition.pool_stats_snapshot()
        jet_stats = jet.jet_stats_snapshot()
        fm_stats = fm_refiner.fm_stats_snapshot()
    p = solver.last_partition
    cut = int(p.edge_cut())
    bw = p.block_weights()
    feasible = bool(p.is_feasible())
    total_ew = graph.total_edge_weight // 2
    part_info = solver.last_partitioner
    info = dict(phase=phase, n=graph.n, m=graph.m, k=k, epsilon=eps, cut=cut,
                random_cut_expected=int(total_ew * (1 - 1 / k)), feasible=feasible,
                max_block_weight=int(bw.max()), min_block_weight=int(bw.min()),
                wall_s=wall, peak_bytes=mem.peak, peak_outside_bytes=mem.outside,
                peak_calls=mem.calls, scheme=type(part_info).__name__,
                levels=getattr(part_info, "num_levels", None),
                coarsest=getattr(part_info, "coarsest", None),
                phase_s=part_info.phase_seconds,
                extension_jobs=getattr(part_info, "extension_jobs", {}), pool=pool,
                launches=launches, rate_modes=rate_modes, jet=jet_stats, fm=fm_stats,
                commit_calls=mem.commit_log(preset), **run_accounting())
    if trace:
        info["coarsening_levels_s"] = rec.span_seconds("partitioning", "coarsening")
        nested = rec.span_seconds("partitioning", "extend_partition", "coarsening")
        info["extension_coarsening"] = dict(levels=len(nested), s=sum(nested))
        info["trace"] = rec.summary()
    info.update({key: dict(getattr(part_info, key)) if key == "subgraph_devices"
                 else getattr(part_info, key)
                 for key in SCHEME_STATS if hasattr(part_info, key)})
    log(json.dumps(info))
    check_pool_served(pool, preset)
    if not feasible:
        raise AssertionError(f"{preset} partition is infeasible")
    if part.shape != (graph.n,) or bw.min() <= 0:
        raise AssertionError(f"{preset} partition does not use all k blocks")
    if cut >= cut_bound * total_ew * (1 - 1 / k):
        raise AssertionError(f"{preset} cut is not clearly below a random partition's")
    if launches["lp_rate"] <= 0 or launches["lp_commit"] <= 0:
        raise AssertionError(f"a kernel did not run on the {preset} path: {launches}")
    return info, solver, part


def phase_main_path(graph, k: int, eps: float):
    cap = CoarsestCapture()
    info, _, part = drive_dense_path("default", "main_path", graph, k, eps, 0.95, cap)
    return info, cap, part


# Loaded by the CLI subprocess of phase 14 from its PYTHONPATH: at exit it
# writes the process's kernel launch counts to the file that
# CHIP_SMOKE_LAUNCHES names, so that the subprocess's launches join the
# kernels line.  It changes nothing else of the run.
LAUNCH_HOOK = """import atexit, json, os, sys

def _dump():
    mod = sys.modules.get("kaminpar_tpu_torch.ops.lp_kernels")
    with open(os.environ["CHIP_SMOKE_LAUNCHES"], "w") as f:
        json.dump(dict(mod.LAUNCHES) if mod else None, f)

atexit.register(_dump)
"""


def parse_rate(read, path: str, graph, what: str) -> dict:
    """Read ``path`` with ``read`` (three times, the median kept) and hold
    the arrays to ``graph``'s."""
    import numpy as np

    walls, got = [], None
    for _ in range(3):
        t0 = time.perf_counter()
        got = read(path)
        walls.append(time.perf_counter() - t0)
    for name in ("row_ptr", "col_idx", "node_w", "edge_w"):
        if not np.array_equal(getattr(got, name).numpy(), getattr(graph, name).cpu().numpy()):
            raise AssertionError(f"the {what} parser read {name} wrong")
    s = sorted(walls)[1]
    return dict(s=s, mb_per_s=os.path.getsize(path) / s / 1e6, walls_s=walls)


def phase_files_and_entry_points(default_graph, default_part, default_cut: int, k: int,
                                 eps: float, tmp: str) -> dict:
    """Phase 14: graph files and the entry points users run, on the card.
    (a) ``rmat_graph(SCHEME_SCALE)`` (the host build) written as METIS and
    read back by the native and the NumPy parser, each equal to the graph,
    with its seconds and MB/s; (b) the default path's graph written as
    ParHIP and partitioned by ``python -m kaminpar_tpu_torch`` in a
    subprocess with no ``--device``: rc 0, phase 7's partition and cut,
    the block sizes of that partition, a valid trace; (c) the scale-16
    graph's compressed container partitioned by ``cli.main`` under
    ``-P terapart`` in this process, with the launch counters set to 0 just
    before and read just after: kernel #2 launched, the partition feasible.
    Its files go into ``tmp`` (the ParHIP file is ``g.parhip`` there, for
    phase 15).  Returns the launch counts of (b) and (c) as two paths."""
    import numpy as np

    from kaminpar_tpu_torch import cli, io as kio
    from kaminpar_tpu_torch.graph import generators, metrics
    from kaminpar_tpu_torch.io import native
    from kaminpar_tpu_torch.ops import lp_kernels
    from kaminpar_tpu_torch.telemetry import validate_chrome_trace
    from kaminpar_tpu_torch.utils import Logger, OutputLevel

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    # (a) METIS through both parsers
    host = generators.rmat_graph(SCHEME_SCALE, 16, seed=1)
    metis = os.path.join(tmp, "g.metis")
    t0 = time.perf_counter()
    kio.write_graph(host, metis)
    write_s = time.perf_counter() - t0
    level = Logger.level
    Logger.level = OutputLevel.QUIET
    try:
        rates = dict(native=parse_rate(kio.read_metis, metis, host, "native"))
        os.environ[native.NO_NATIVE_ENV] = "1"
        try:
            rates["numpy"] = parse_rate(kio.read_metis, metis, host, "NumPy")
        finally:
            del os.environ[native.NO_NATIVE_ENV]
    finally:
        Logger.level = level
    log(json.dumps(dict(phase="files_metis", graph=f"rmat_graph({SCHEME_SCALE}, 16, seed=1)",
                        n=host.n, m=host.m, bytes=os.path.getsize(metis), write_s=write_s,
                        parsers=rates)))

    # (b) the CLI in a subprocess on the default path's graph as ParHIP
    parhip, part_file, sizes_file, trace_file, launches_file = (
        os.path.join(tmp, name) for name in
        ("g.parhip", "g.part", "g.sizes", "g.trace.json", "launches.json"))
    kio.write_graph(default_graph, parhip)
    hook_dir = os.path.join(tmp, "hook")
    os.makedirs(hook_dir)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_HOOK)
    env = dict(os.environ, CHIP_SMOKE_LAUNCHES=launches_file,
               PYTHONPATH=os.pathsep.join([hook_dir, root]))
    cmd = [sys.executable, "-m", "kaminpar_tpu_torch", parhip, str(k), "-P", "default",
           "-o", part_file, "--block-sizes", sizes_file, "-E", "--trace-out", trace_file]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    result = re.search(r"RESULT cut=(\d+) .*time=([0-9.e+-]+)", res.stdout)
    info = dict(phase="files_cli", graph="the default path's graph, ParHIP",
                bytes=os.path.getsize(parhip), rc=res.returncode, wall_s=wall,
                partition_s=float(result.group(2)) if result else None,
                cut=int(result.group(1)) if result else None, phase7_cut=default_cut)
    if res.returncode != 0:
        log(json.dumps(info))
        raise AssertionError(f"the CLI failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    part = kio.read_partition(part_file)
    with open(launches_file) as f:
        cli_launches = json.load(f)
    with open(trace_file) as f:
        info["trace"] = validate_chrome_trace(json.load(f))
    sizes = np.loadtxt(sizes_file, dtype=np.int64)
    info.update(launches=cli_launches, equal_to_phase7=bool(np.array_equal(part, default_part)),
                sizes_equal=bool(np.array_equal(
                    sizes, metrics.block_weights(default_graph, part, k))))
    log(json.dumps(info))
    if not info["equal_to_phase7"] or info["cut"] != default_cut:
        raise AssertionError("the CLI's partition of the file differs from phase 7's")
    if not info["sizes_equal"]:
        raise AssertionError("the CLI's block sizes are not its partition's")

    # (c) the compressed container under -P terapart, in this process
    compressed, part_c = os.path.join(tmp, "g.compressed"), os.path.join(tmp, "c.part")
    kio.write_graph(host, compressed)
    lp_kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        rc = cli.main([compressed, str(k), "-P", "terapart", "-o", part_c, "-q"])
    finally:
        Logger.level = level
    import torch

    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    terapart_launches = dict(lp_kernels.LAUNCHES)
    part = kio.read_partition(part_c)
    bw = metrics.block_weights(host, part, k)
    perfect = -(-host.total_node_weight // k)
    cap = max(int((1.0 + eps) * perfect), perfect + host.max_node_weight)
    info = dict(phase="files_cli_terapart", graph=f"rmat_graph({SCHEME_SCALE}), compressed",
                bytes=os.path.getsize(compressed), rc=rc, wall_s=wall_c,
                launches=terapart_launches, max_block_weight=int(bw.max()), cap=cap,
                cut=metrics.edge_cut(host, part))
    log(json.dumps(info))
    if rc != 0 or terapart_launches["lp_rate_compressed"] <= 0:
        raise AssertionError(f"the terapart CLI run did not launch kernel #2: {info}")
    if part.shape != (host.n,) or int(bw.max()) > cap:
        raise AssertionError("the terapart CLI run's partition is infeasible")
    log(json.dumps(dict(phase="files_and_entry_points", s=time.perf_counter() - t_phase)))
    return dict(cli_default=dict(launches=cli_launches),
                cli_terapart=dict(launches=terapart_launches))


CHECKPOINT_LINE = re.compile(
    r"checkpoint: boundary (\d+) \((\w+), (\d+) levels\) written in ([0-9.]+) s, (\d+) B")


def phase_serve(tmp: str) -> dict:
    """Phase 16 (module docstring): the serve engine's burst, admission,
    /metrics and the serve CLI on the card.  Returns the launch counts of
    the ``serve``, ``serve-pergraph`` and ``serve-cli`` paths."""
    import numpy as np
    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.ops import lp_kernels
    from kaminpar_tpu_torch.serve import CapacityError, PartitionEngine, QueueFullError
    from kaminpar_tpu_torch.telemetry import capacity, prometheus
    from kaminpar_tpu_torch.telemetry.trace import validate_chrome_trace
    from kaminpar_tpu_torch.utils import Logger, OutputLevel, Timer, sync_stats

    t_phase = time.perf_counter()
    level = Logger.level
    Logger.level = OutputLevel.QUIET
    try:
        t0 = time.perf_counter()
        engine = PartitionEngine("serve", warm_ladder=(SERVE_N,), warm_ks=(SERVE_K,),
                                 max_batch=SERVE_BURST)  # no device: cuda:0
        engine.start()
        warm_s = time.perf_counter() - t0
        log(json.dumps(dict(phase="serve_warmup", wall_s=warm_s, report=engine.warmup_report,
                            capacity_ceiling_bytes=engine._capacity_ceiling,
                            device_kind=engine._device_kind)))
        builds = sum(row.get("builds", 0) for row in engine.warmup_report)
        if builds:
            raise AssertionError(f"the engine's warmup built kernels ({builds} builds)")
        graphs = [generators.rmat_graph(SERVE_SCALE, 8, seed=100 + i)
                  for i in range(SERVE_BURST)]
        engine.pause()
        futures = [engine.submit(g, SERVE_K, EPSILON) for g in graphs]
        lp_kernels.reset_launches()
        sync_stats.reset()
        Timer.reset_global()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_bytes = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.resume()
        results = [f.result(timeout=600) for f in futures]
        burst_wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        stacked_launches = dict(lp_kernels.LAUNCHES)
        stacked_timer = Timer.global_().paths(TIMER_DEPTH + 1)
        sync = sync_stats.snapshot()["phases"]
        stats = engine.stats()
        lanes_phases = {ph: row for ph, row in sync.items() if ph.startswith("lanestack")
                        or ph == "serve_lanestack"}
        stacked_pulls = sum(row["stacked_count"] for row in lanes_phases.values())
        lane_pulls = sum(row["lane_pulls"] for row in lanes_phases.values())
        pred = capacity.predict_for_graph(graphs[0], SERVE_K, lanes=SERVE_BURST,
                                          device_kind=engine._device_kind)
        metrics_text = engine.metrics_text()
        families = prometheus.validate(metrics_text)
        breakers = engine.breakers.snapshot()
        engine.shutdown()

        # the sequential reference runs on the card
        lp_kernels.reset_launches()
        sync_stats.reset()
        seq_walls, equal, seq_phase_s = [], [], collections.Counter()
        for g, res in zip(graphs, results):
            solver = kp.KaMinPar("serve")  # no device: cuda:0
            solver.set_graph(g)
            t0 = time.perf_counter()
            ref = solver.compute_partition(SERVE_K, EPSILON)
            torch.cuda.synchronize()
            seq_walls.append(time.perf_counter() - t0)
            equal.append(bool(np.array_equal(ref, res.partition)))
            seq_phase_s.update(solver.last_partitioner.phase_seconds)
        seq_launches = dict(lp_kernels.LAUNCHES)
        seq_pulls = sync_stats.snapshot()["count"]
        info = dict(
            phase="serve", graphs=f"rmat_graph({SERVE_SCALE}, 8, seed=100..{99 + SERVE_BURST})",
            k=SERVE_K, requests=SERVE_BURST, burst_wall_s=burst_wall,
            stacked_execute_s=max(r.execute_s for r in results) * SERVE_BURST,
            sequential_walls_s=seq_walls, sequential_sum_s=sum(seq_walls),
            stacked_timer=stacked_timer, sequential_phase_s=dict(seq_phase_s),
            batch_sizes=[r.batch_size for r in results],
            cuts=[r.cut for r in results], feasible=[r.feasible for r in results],
            equal_to_sequential=equal, launches=stacked_launches,
            sequential_launches=seq_launches,
            stacked_pulls=stacked_pulls, lane_pulls=lane_pulls, sequential_pulls=seq_pulls,
            lanestack_phases=lanes_phases,
            latency_ms=stats["latency_ms"],
            batch_occupancy_mean=stats["batch_occupancy_mean"],
            lanestack_occupancy_mean=stats["lanestack_occupancy_mean"],
            lanestacked_batches=stats["lanestacked_batches"],
            lanestack_fallbacks=stats["lanestack_fallbacks"],
            lanestack_splits=stats["lanestack_splits"],
            peak_bytes=peak, peak_over_base_bytes=peak - base_bytes,
            predicted_peak_bytes=pred.predicted_peak_bytes, prediction=pred.to_dict(),
            metrics_families=len(families), breakers=breakers)
        log(json.dumps(info, default=str))
        if stats["lanestacked_batches"] != 1 or set(info["batch_sizes"]) != {SERVE_BURST}:
            raise AssertionError("the burst did not run as one lane-stacked batch of "
                                 f"{SERVE_BURST} lanes")
        if stats["lanestack_fallbacks"] or breakers["demotions"] or any(
                br["trips"] for br in breakers["breakers"].values()):
            raise AssertionError(f"a fallback or a breaker trip in the burst: {breakers}")
        if not all(info["feasible"]) or not all(equal):
            raise AssertionError("a served partition is infeasible or differs from its "
                                 "sequential run")
        for name, counts in (("serve", stacked_launches), ("serve-pergraph", seq_launches)):
            if counts["lp_rate"] <= 0 or counts["lp_commit"] <= 0:
                raise AssertionError(f"kernels #1 and #3 did not run on the {name} path")

        # admission: a full queue and the capacity preflight launch nothing
        small = generators.rmat_graph(10, 8, seed=7)
        lp_kernels.reset_launches()
        full = PartitionEngine("serve", queue_bound=2, warm_ladder=(), warm_ks=())
        full.start(warmup=False)
        full.pause()
        full.submit(small, SERVE_K)
        full.submit(small, SERVE_K)
        try:
            full.submit(small, SERVE_K)
            raise AssertionError("a third request entered a queue bounded at 2")
        except QueueFullError as exc:
            retry = exc.retry_after_s
        full.shutdown(drain=False)
        need = capacity.predict_for_graph(small, SERVE_K).predicted_peak_bytes
        tight = PartitionEngine("serve", warm_ladder=(), warm_ks=(),
                                capacity_ceiling_bytes=need - 1)
        tight.start(warmup=False)
        try:
            tight.submit(small, SERVE_K)
            raise AssertionError("a request above the capacity ceiling was admitted")
        except CapacityError as exc:
            cap_err = dict(predicted=exc.predicted_bytes, ceiling=exc.ceiling_bytes)
        rejected = tight.stats()["rejected_capacity"]
        tight.shutdown()
        admission_launches = dict(lp_kernels.LAUNCHES)
        log(json.dumps(dict(phase="serve_admission", retry_after_s=retry, capacity=cap_err,
                            rejected_capacity=rejected, launches=admission_launches)))
        if retry <= 0 or rejected != 1 or any(admission_launches.values()):
            raise AssertionError("the admission rejections are wrong or launched a kernel")
    finally:
        Logger.level = level

    # the serve CLI in a subprocess, on the card by default
    root = os.path.dirname(os.path.abspath(__file__))
    hook_dir = os.path.join(tmp, "serve_hook")
    os.makedirs(hook_dir, exist_ok=True)
    with open(os.path.join(hook_dir, "sitecustomize.py"), "w") as f:
        f.write(LAUNCH_HOOK)
    launches_file = os.path.join(tmp, "serve_launches.json")
    trace_file = os.path.join(tmp, "serve.trace.json")
    env = dict(os.environ, CHIP_SMOKE_LAUNCHES=launches_file,
               PYTHONPATH=os.pathsep.join([hook_dir, root]))
    cmd = [sys.executable, "-m", "kaminpar_tpu_torch.serve", "--demo", "4", "--ladder",
           "4096", "--warm-ks", "8", "--max-batch", "4", "--trace-out", trace_file]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the serve CLI failed:\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    cli_stats = json.loads(res.stdout.strip().splitlines()[-1])
    with open(trace_file) as f:
        trace = validate_chrome_trace(json.load(f))
    with open(launches_file) as f:
        cli_launches = json.load(f)
    log(json.dumps(dict(phase="serve_cli", rc=res.returncode, wall_s=wall,
                        completed=cli_stats.get("completed"),
                        lanestacked_batches=cli_stats.get("lanestacked_batches"),
                        latency_ms=cli_stats.get("latency_ms"), trace=trace,
                        launches=cli_launches)))
    if cli_stats.get("completed") != 4 or cli_launches["lp_rate"] <= 0 \
            or cli_launches["lp_commit"] <= 0:
        raise AssertionError("the serve CLI did not serve its demo through the kernels")
    log(json.dumps(dict(phase="serve_total", s=time.perf_counter() - t_phase)))
    return {"serve": dict(launches=stacked_launches),
            "serve-pergraph": dict(launches=seq_launches),
            "serve-cli": dict(launches=cli_launches)}


def phase_preemption(default_graph, default_part, k: int, eps: float, tmp: str) -> dict:
    """Phase 15: a default run of the CLI on phase 14's ParHIP file (in
    ``tmp``) killed by SIGTERM at its first uncoarsening boundary, with
    checkpoints at every boundary and the flight recorder on, then resumed
    in this process on the card: phase 7's partition bit for bit, kernels
    #1 and #3 launched, no pull and no card sync outside a pull in the
    restore.  Returns the resume's launch counts as a path."""
    import signal

    import numpy as np
    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.ops import lp_kernels
    from kaminpar_tpu_torch.resilience import checkpoint
    from kaminpar_tpu_torch.telemetry import flight_recorder, phases
    from kaminpar_tpu_torch.utils import sync_stats

    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    ckpt_dir, hb = os.path.join(tmp, "ckpt"), os.path.join(tmp, "heartbeat.jsonl")
    env = dict(os.environ, PYTHONPATH=root, KPTPU_CHECKPOINT=ckpt_dir,
               KPTPU_CHECKPOINT_EVERY="1", KPTPU_FAULTS=PREEMPT_PLAN,
               KPTPU_FLIGHT_RECORDER=hb, KPTPU_HEARTBEAT_S=str(HEARTBEAT_S))
    cmd = [sys.executable, "-m", "kaminpar_tpu_torch", os.path.join(tmp, "g.parhip"), str(k),
           "-P", "default", "-o", os.path.join(tmp, "killed.part")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
    killed_s = time.perf_counter() - t0
    writes = [dict(boundary=int(b), stage=stage, levels=int(levels), s=float(sec),
                   bytes=int(nbytes))
              for b, stage, levels, sec, nbytes in CHECKPOINT_LINE.findall(res.stdout)]
    dossier = flight_recorder.read_dossier(hb) or {}
    latest = checkpoint.latest(ckpt_dir)
    info = dict(phase="preemption", graph="the default path's graph, ParHIP", plan=PREEMPT_PLAN,
                rc=res.returncode, killed_wall_s=killed_s, writes=writes,
                files=sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else [],
                dossier=dict(phase=dossier.get("phase"), phase_class=dossier.get("phase_class"),
                             heartbeats=dossier.get("heartbeats"),
                             last_heartbeat=dossier.get("last_heartbeat")))
    if res.returncode != -signal.SIGTERM or latest is None:
        log(json.dumps(info))
        raise AssertionError(f"the CLI did not die by SIGTERM with a checkpoint on disk:\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    state = checkpoint.load(latest)
    if state.stage != "uncoarsening" or not writes or writes[-1]["stage"] != "uncoarsening":
        raise AssertionError(f"the kill did not land at the first uncoarsening boundary: {info}")
    if dossier.get("phase") not in phases.CORE_PHASES + ("checkpoint_write",):
        raise AssertionError(f"the dossier names no pipeline phase: {info['dossier']}")

    solver = kp.KaMinPar("default")  # no device: cuda:0
    solver.set_graph(default_graph)
    lp_kernels.reset_launches()
    sync_stats.reset()
    sync_stats.enable_budget_checks(True)
    try:
        with sync_stats.count_device_syncs():
            t0 = time.perf_counter()
            part = solver.compute_partition(k, epsilon=eps, resume=ckpt_dir)
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
    finally:
        sync_stats.enable_budget_checks(False)
    launches = dict(lp_kernels.LAUNCHES)
    snap = sync_stats.snapshot()
    restore_pulls = snap["phases"].get("checkpoint_restore", {}).get("count", 0)
    restore_syncs = snap["device_syncs"].get("checkpoint_restore", 0)
    census = state.meta["census"]
    info.update(
        boundary=state.boundary, stage=state.stage, restored_levels=len(state.levels),
        cur_k=state.cur_k, checkpoint_bytes=os.path.getsize(latest),
        write_pulls=census["checkpoint_write_pulls"],
        write_pulls_entitled=census["checkpoint_write_entitled"],
        restore_s=solver.last_partitioner.restore_s, resume_s=resume_s,
        restore_pulls=restore_pulls, restore_device_syncs=restore_syncs, launches=launches,
        equal_to_phase7=bool(np.array_equal(part, default_part)),
        s=time.perf_counter() - t_phase)
    log(json.dumps(info))
    if not info["equal_to_phase7"]:
        raise AssertionError("the resumed partition differs from phase 7's")
    if launches["lp_rate"] <= 0 or launches["lp_commit"] <= 0:
        raise AssertionError(f"the resume did not launch kernels #1 and #3: {launches}")
    if info["write_pulls"] != info["write_pulls_entitled"]:
        raise AssertionError("the killed run's checkpoint pulls differ from its entitlement")
    if restore_pulls or restore_syncs:
        raise AssertionError(f"checkpoint_restore made {restore_pulls} pulls and "
                             f"{restore_syncs} card syncs outside pull")
    return dict(resume=dict(launches=launches))


def work_partition(graph, part, k: int):
    """The path's partition restricted to the graph the deep partitioner
    ran on (isolated nodes stripped, as ``finest_graph`` strips them)."""
    from kaminpar_tpu_torch.graph.isolated import strip_isolated_csr

    stripped = strip_isolated_csr(graph.host_row_ptr(), lambda: graph.col_idx.numpy(),
                                  graph.node_w.numpy(), graph.n, k)
    return part if stripped is None else part[stripped[0]]


def phase_largek_path(graph, k: int, eps: float):
    """``KaMinPar("largek").compute_partition(k)`` on the graph, as the
    default path (``drive_dense_path``, cut bound ``LARGE_K_CUT_BOUND``);
    device extension must have fired.  Logs the phase split; returns the
    path's line, its partition and block caps."""
    info, solver, part = drive_dense_path("largek", "largek_path", graph, k, eps,
                                          LARGE_K_CUT_BOUND, trace=True)
    log("largek split (s): " + ", ".join(
        f"{key} {val:.3f}" for key, val in info["phase_s"].items())
        + "; coarsening levels (s): " + ", ".join(
            f"{val:.3f}" for val in info["coarsening_levels_s"]))
    if info["extension_jobs"]["device"] <= 0:
        raise AssertionError("device extension did not fire on the largek path")
    return info, part, solver.last_partition.max_block_weights


def phase_refine_kernels(work, part, max_bw, device, k: int, source: str, seed: int = 12):
    """Kernels #1 and #3 in LP refinement's instantiation on a path's own
    data (``source`` names it): ``part`` as labels on ``work``, caps as
    ``LPRefiner`` builds them at ``L = num_labels_bucket(k)`` and a
    refinement round's draws (active_prob 1.0, no tie moves).  The rating
    kernel against its plain version on every bucket and timed as one
    pass; the commit on the rated moves against both plain auctions,
    twice, and timed.  All exact."""
    import numpy as np
    import torch

    from kaminpar_tpu_torch.ops import bucketed_gains, lp

    pv, bv = work.padded(), work.bucketed()
    L = lp.num_labels_bucket(k)
    labels = pv.pad_node_array(torch.as_tensor(part).to(device=device, dtype=torch.int32), 0)
    state = lp.init_state(labels, pv.node_w, L)
    caps = torch.zeros(L, dtype=torch.int32, device=device)
    caps[:k] = torch.as_tensor(np.asarray(max_bw), dtype=torch.int32)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = lp.draw_lp_round(gen, bv, pv.n_pad)
    flags = dict(external_only=False, respect_caps=True, tie_break="uniform")
    args = (labels, pv.node_w, state.label_weights, caps)
    err = 0
    for i, (b, tie) in enumerate(zip(bv.buckets, draws.ties)):
        ref = bucketed_gains._bucket_moves(labels, b, pv.node_w, state.label_weights, caps,
                                           tie, **flags)
        err = max(err, max_abs_err(ref, rate_dense(*args, bv, i, tie, **flags)))
        if err:
            raise AssertionError(f"rating kernel != plain at L = {L}, w={b.cols.shape[1]}")
    log(f"  rate refine L={L} ({source}, n={pv.n}, m={work.m}): equal on "
        f"{len(bv.buckets)} buckets")

    def kernel_pass():
        for i, tie in enumerate(draws.ties):
            rate_dense(*args, bv, i, tie, **flags)

    def plain_pass():
        for b, tie in zip(bv.buckets, draws.ties):
            bucketed_gains._bucket_moves(labels, b, pv.node_w, state.label_weights, caps,
                                         tie, **flags)

    shapes = [tuple(b.cols.shape) for b in bv.buckets]
    buckets = [(w, R, real, dense_bucket_bytes(R, real, w), rating_ops(real, w),
                dense_bucket_bytes_all_rows(R, w), bitonic_ops(R, w))
               for (R, w), real in zip(shapes, bv.real_rows)]
    bound_ms, bound_by, _ = pass_bounds(buckets, table_bytes(pv.n_pad, L, L))
    rate = dict(
        kernel="lp_rate", what=f"one rating pass over all buckets of {source}, "
        f"refinement instantiation at L = {L}",
        n=pv.n_pad, L=L, kernel_ms=cuda_time_ms(kernel_pass, iters=20),
        host_paced_ms=cuda_time_ms(kernel_pass, iters=20, sleep_ahead=False),
        plain_ms=cuda_time_ms(plain_pass, iters=3, warmup=1), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, max_abs_err=err)
    log(json.dumps(rate))
    target, tconn, own, _ = lp.best_moves(labels, bv, pv.node_w, state.label_weights, caps,
                                          draws.ties, draws.heavy_tie, **flags)
    call = (state, target, tconn, own, pv.node_w, caps, L, draws.prio, None, None)
    err = check_commit(f"refine (path data), {source}, L={L}", call, REFINE_OPTS,
                       (True, False))
    commit = time_commit(call, err, REFINE_OPTS, f"{source}, refinement instantiation "
                         f"(L = {L}), the rated moves")
    return rate, commit


JET_FIND_MODE = "lp_rate:external_only=1,respect_caps=0"


def phase_jet_path(graph, k: int, eps: float, terapart_cut: int):
    """``KaMinPar("jet").compute_partition(k)`` on the terapart path's graph,
    as the default path (``drive_dense_path``); its cut must also be no
    higher than the terapart path's (the default pipeline's) on the same
    graph, JET must have run at least one round in every refine call (one
    call a level and extension step) and the rating kernel must have
    launched in JET's find mode.  Logs the phase split and the peak;
    returns the path's line, its partition and block caps."""
    info, solver, part = drive_dense_path("jet", "jet_path", graph, k, eps, 0.95)
    stats = info["jet"]
    log("jet split (s): " + ", ".join(
        f"{key} {val:.3f}" for key, val in info["phase_s"].items())
        + f"; peak {info['peak_bytes']} B; JET calls {stats['calls']}, rounds "
        f"{stats['rounds']}, fewest in a call {stats['min_rounds']}")
    if info["cut"] > terapart_cut:
        raise AssertionError(f"jet cut {info['cut']} is above the terapart path's "
                             f"{terapart_cut} on the same graph")
    if stats["calls"] < info["levels"] + 1 or not stats["min_rounds"]:
        raise AssertionError(f"JET did not run a round on every level: {stats}")
    if info["rate_modes"].get(JET_FIND_MODE, 0) <= 0:
        raise AssertionError(f"kernel #1 did not launch in JET's find mode: "
                             f"{info['rate_modes']}")
    return info, part, solver.last_partition.max_block_weights


def phase_jet_kernels(work, part, max_bw, device, k: int):
    """Kernels #1 and #3 in the new refiners' modes on the jet path's own
    data (its final partition on its finest graph): the rating kernel in
    JET's find mode (``external_only``, no caps, ``L = k`` block weights,
    one JET round's ties) against its plain version on every bucket and
    timed as one pass; the commit kernel with colour class 0 of the graph's
    colouring as its ``active`` mask and tie moves (a CLP superstep at
    ``L = num_labels_bucket(k)``, the moves rated with caps) against both
    plain auctions, twice, and timed."""
    import numpy as np
    import torch

    from kaminpar_tpu_torch.ops import bucketed_gains, coloring, lp
    from kaminpar_tpu_torch.ops.segment import segment_sum

    pv, bv = work.padded(), work.bucketed()
    labels = pv.pad_node_array(torch.as_tensor(part).to(device=device, dtype=torch.int32), 0)
    bw = segment_sum(pv.node_w, labels, k)
    caps_k = torch.as_tensor(np.asarray(max_bw), dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(13)
    ties, _ = bucketed_gains.draw_ties(gen, bv)
    flags = dict(external_only=True, respect_caps=False, tie_break="uniform")
    args = (labels, pv.node_w, bw, caps_k)
    err = 0
    for i, (b, tie) in enumerate(zip(bv.buckets, ties)):
        ref = bucketed_gains._bucket_moves(labels, b, pv.node_w, bw, caps_k, tie, **flags)
        err = max(err, max_abs_err(ref, rate_dense(*args, bv, i, tie, **flags)))
        if err:
            raise AssertionError(f"rating kernel != plain in JET's find mode, "
                                 f"w={b.cols.shape[1]}")
    log(f"  rate JET find L={k} (jet path data): equal on {len(bv.buckets)} buckets")

    def kernel_pass():
        for i, tie in enumerate(ties):
            rate_dense(*args, bv, i, tie, **flags)

    def plain_pass():
        for b, tie in zip(bv.buckets, ties):
            bucketed_gains._bucket_moves(labels, b, pv.node_w, bw, caps_k, tie, **flags)

    shapes = [tuple(b.cols.shape) for b in bv.buckets]
    buckets = [(w, R, real, dense_bucket_bytes(R, real, w), rating_ops(real, w),
                dense_bucket_bytes_all_rows(R, w), bitonic_ops(R, w))
               for (R, w), real in zip(shapes, bv.real_rows)]
    bound_ms, bound_by, _ = pass_bounds(buckets, table_bytes(pv.n_pad, k, k))
    rate = dict(
        kernel="lp_rate", what=f"one rating pass over all buckets of the jet path's "
        f"finest graph in JET's find mode (external_only, no caps, L = {k}), its final "
        "partition", n=pv.n_pad, L=k, kernel_ms=cuda_time_ms(kernel_pass, iters=20),
        host_paced_ms=cuda_time_ms(kernel_pass, iters=20, sleep_ahead=False),
        plain_ms=cuda_time_ms(plain_pass, iters=3, warmup=1), bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None, max_abs_err=err)
    log(json.dumps(rate))

    L = lp.num_labels_bucket(k)
    caps = torch.zeros(L, dtype=torch.int32, device=device)
    caps[:k] = caps_k
    state = lp.init_state(labels, pv.node_w, L)
    mask = torch.arange(pv.n_pad, device=device) < pv.n
    colors, _ = coloring.color_graph(
        lambda i: torch.randint(0, 2**31 - 1, (pv.n_pad,), generator=gen, device=device,
                                dtype=torch.int32), pv.edge_u, pv.col_idx, mask, n=pv.n_pad)
    colors = torch.clamp(colors, min=0)
    draws = lp.draw_lp_round(gen, bv, pv.n_pad, allow_tie_moves=True)
    target, tconn, own, _ = lp.best_moves(labels, bv, pv.node_w, state.label_weights, caps,
                                          draws.ties, draws.heavy_tie, external_only=False,
                                          respect_caps=True)
    active = colors == 0
    call = (state, target, tconn, own, pv.node_w, caps, L, draws.prio, draws.coin, None)
    opts = dict(active_prob=1.0, allow_tie_moves=True, active=active)
    err = check_commit(f"colour class 0 of {int(active.sum())} nodes (jet path data), "
                       f"L={L}", call, opts, (True, False))
    commit = time_commit(call, err, opts, f"the jet path's finest level, a CLP superstep "
                         f"(colour class 0 as the active mask, tie moves, L = {L}), its "
                         "final partition and rated moves")
    return rate, commit


def phase_clp(work, part, max_bw, device, k: int) -> dict:
    """``CLPRefiner`` on the jet path's final partition on its finest graph,
    on the card, with the launch counters set to 0 just before: the cut
    must not rise and the rating and commit kernels must have run.  Then
    the graph is coloured through the refiner's entry point
    (``coloring.color_graph``, seeded here): proper outside its stragglers
    (nodes the 62 colours or 64 rounds left uncoloured, at colour 0), the
    stragglers at most ``CLP_MAX_STRAGGLER_SHARE`` of the nodes and the
    monochromatic edges at most ``CLP_MAX_MONOCHROMATIC_SHARE`` of m.  Logs
    the colour count, rounds, stragglers, monochromatic edges, the nodes
    CLP moved and its time."""
    import torch

    from kaminpar_tpu_torch.context import ColoredLPContext
    from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
    from kaminpar_tpu_torch.ops import coloring, lp_kernels
    from kaminpar_tpu_torch.refinement.clp_refiner import CLPRefiner

    p = PartitionedGraph.create(work, k, torch.as_tensor(part).to(device), max_bw)
    cut_in = int(p.edge_cut())
    lp_kernels.reset_launches()
    t0 = time.perf_counter()
    out = CLPRefiner(ColoredLPContext()).refine(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lp_kernels.LAUNCHES)
    cut_out = int(out.edge_cut())

    gen = torch.Generator(device=device).manual_seed(17)
    pv = work.padded()
    mask = torch.arange(pv.n_pad, device=device) < pv.n
    raw, rounds = coloring.color_graph(
        lambda i: torch.randint(0, 2**31 - 1, (pv.n_pad,), generator=gen, device=device,
                                dtype=torch.int32), pv.edge_u, pv.col_idx, mask, n=pv.n_pad)
    strag = raw[: work.n] < 0
    colors = torch.clamp(raw[: work.n], min=0)
    u, v = work.edge_u.long(), work.col_idx.long()
    mono = (colors[u] == colors[v]) & (u != v)
    info = dict(phase="clp", graph="the jet path's finest graph", n=work.n, m=work.m, k=k,
                cut_in=cut_in, cut_out=cut_out, feasible=bool(out.is_feasible()),
                wall_s=wall, nodes_moved=int((out.partition != p.partition).sum()),
                colors=int(coloring.num_colors_device(raw.clamp(min=0), mask)),
                rounds=rounds, stragglers=int(strag.sum()),
                monochromatic_edges=int(mono.sum()) // 2, proper=not bool(mono.any()),
                proper_outside_stragglers=not bool((mono & ~strag[u] & ~strag[v]).any()),
                launches=launches)
    info["straggler_share"] = info["stragglers"] / max(work.n, 1)
    info["monochromatic_share"] = 2 * info["monochromatic_edges"] / max(work.m, 1)
    log(json.dumps(info))
    if cut_out > cut_in:
        raise AssertionError("CLP raised the cut")
    if launches["lp_rate"] <= 0 or launches["lp_commit"] <= 0:
        raise AssertionError(f"a kernel did not run in CLP: {launches}")
    if not info["proper_outside_stragglers"]:
        raise AssertionError("the colouring is not proper outside its stragglers")
    if (info["straggler_share"] > CLP_MAX_STRAGGLER_SHARE
            or info["monochromatic_share"] > CLP_MAX_MONOCHROMATIC_SHARE):
        raise AssertionError(
            f"the colouring left {info['stragglers']} stragglers and "
            f"{info['monochromatic_edges']} monochromatic edges, above the bounds "
            f"{CLP_MAX_STRAGGLER_SHARE} of n and {CLP_MAX_MONOCHROMATIC_SHARE} of m")
    return info


def phase_fm_pass(work, part, max_bw, device, k: int) -> dict:
    """One k-way FM pass on the jet path's final partition on its finest
    graph (the graph and partition on the card, the pass on the host), its
    work bounded to ``FM_PASS_WORK_FACTOR`` x n: the cut must not rise.
    Logs its host seconds (transfers, tables and the pass), the nodes it
    moved and the cut change."""
    import torch

    from kaminpar_tpu_torch.context import FMContext
    from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
    from kaminpar_tpu_torch.refinement import fm_refiner

    p = PartitionedGraph.create(work, k, torch.as_tensor(part).to(device), max_bw)
    cut_in = int(p.edge_cut())
    fm_refiner.reset_fm_stats()
    ctx = FMContext(num_iterations=1, pass_work_budget_factor=FM_PASS_WORK_FACTOR)
    out = fm_refiner.FMRefiner(ctx).refine(p)
    stats = fm_refiner.fm_stats_snapshot()
    info = dict(phase="fm_pass", graph="the jet path's finest graph", n=work.n, m=work.m,
                k=k, work_budget_factor=FM_PASS_WORK_FACTOR, cut_in=cut_in,
                cut_out=int(out.edge_cut()), feasible=bool(out.is_feasible()),
                nodes_moved=int((out.partition != p.partition).sum()), passes=stats["passes"],
                host_s=stats["seconds"])
    log(json.dumps(info))
    if stats["passes"] != 1 or info["cut_out"] > cut_in or not info["feasible"]:
        raise AssertionError(f"the FM pass failed: {info}")
    return info


def phase_strong_path(scale: int, k: int, eps: float):
    """``KaMinPar("strong").compute_partition(k)`` on ``rmat_graph(scale)``,
    as the default path (``drive_dense_path``), a small functional check of
    the preset (its FM is a host pass); FM must have run passes.
    Logs FM's passes and host seconds."""
    from kaminpar_tpu_torch.graph import generators

    t0 = time.perf_counter()
    g = generators.rmat_graph(scale, 16, seed=1, device="cuda")
    log(f"graph: rmat_graph({scale}, 16, seed=1) n={g.n} m={g.m} "
        f"({time.perf_counter() - t0:.1f} s, built on the card)")
    info, _, _ = drive_dense_path("strong", "strong_path", g, k, eps, 0.95)
    fm = info["fm"]
    log(f"strong: FM {fm['calls']} calls, {fm['passes']} passes, {fm['seconds']:.3f} host "
        f"s of {info['wall_s']:.3f} s")
    if fm["passes"] <= 0:
        raise AssertionError(f"FM ran no pass on the strong path: {fm}")
    return info


def phase_kway_path(graph, preset: str, k: int, eps: float, terapart_cut: int,
                    capture: RefineCapture, need_sparsified: bool = False):
    """``KaMinPar(preset).compute_partition(k)`` for a single-shot k-way
    preset (``kway`` or ``linear-time-kway``) on the terapart path's graph,
    as the default path (``drive_dense_path``, cut bound 0.95); its
    coarsest graph must have at most max(C·k, 2C) nodes unless coarsening
    converged above it, and with ``need_sparsified`` at least one level
    must have been sparsified.  Logs the phase split, levels, coarsest
    graph, peak, the sparsifier's counts and the cut over the terapart
    path's (the deep default pipeline's) on the same graph, and the seconds
    ``capture`` took inside the wall; returns the path's line, its
    partition and block caps."""
    phase = preset.replace("-", "_") + "_path"
    info, solver, part = drive_dense_path(preset, phase, graph, k, eps, 0.95, capture)
    C = solver.ctx.coarsening.contraction_limit
    target = max(C * k, 2 * C)
    info["cut_over_terapart"] = info["cut"] / terapart_cut
    log(json.dumps(dict(phase=phase + "_summary", wall_s=info["wall_s"],
                        phase_s=info["phase_s"], levels=info["levels"],
                        level_n=info["level_n"], coarsest=info["coarsest"],
                        target_n=target, converged=info["converged"],
                        peak_bytes=info["peak_bytes"], sparsification=info["sparsification"],
                        cut=info["cut"], terapart_cut=terapart_cut,
                        cut_over_terapart=info["cut_over_terapart"],
                        capture_s=capture.seconds)))
    if info["coarsest"]["n"] > target and not info["converged"]:
        raise AssertionError(f"{preset} stopped coarsening above {target} nodes without "
                             f"converging: {info['level_n']}")
    if info["coarsest"]["k0"] != k:
        raise AssertionError(f"{preset} did not partition its coarsest graph into k blocks")
    if need_sparsified and info["sparsification"]["levels"] <= 0:
        raise AssertionError(f"{preset} sparsified no level: {info['level_n']}")
    return info, part, solver.last_partition.max_block_weights


def set_vcycles(ctx):
    ctx.vcycles = VCYCLES


def phase_vcycle_path(graph, k: int, eps: float, default_cut: int):
    """``KaMinPar("vcycle")`` with ``ctx.vcycles = VCYCLES`` into k blocks of
    the default path's graph, as the default path (``drive_dense_path``);
    both cycles must have run, and the cut may be at most
    ``VCYCLE_CUT_BOUND`` x the default path's.  Returns the path's line."""
    info, _, _ = drive_dense_path("vcycle", "vcycle_path", graph, k, eps, 0.95,
                                  configure=set_vcycles)
    info["cut_over_default"] = info["cut"] / default_cut
    log(f"vcycle: cycles {[c['k'] for c in info['cycles']]}, wall {info['wall_s']:.3f} s, "
        f"cut {info['cut']} = {info['cut_over_default']:.4f} x the default path's "
        f"{default_cut}")
    if [c["k"] for c in info["cycles"]] != [*VCYCLES, k]:
        raise AssertionError(f"the v-cycle did not run its cycles: {info['cycles']}")
    if info["cut"] > VCYCLE_CUT_BOUND * default_cut:
        raise AssertionError(f"the v-cycle cut {info['cut']} is above "
                             f"{VCYCLE_CUT_BOUND} x the default path's {default_cut}")
    return info


def phase_scheme_checks(graph, scale: int, k: int, eps: float) -> dict:
    """Small functional checks of the other schemes on ``graph``, each
    through ``drive_dense_path`` (feasible, all k blocks, both kernels,
    every bisection on the device pool; the cut only below a random
    partition's): ``restricted-vcycle`` (both cycles ran), recursive
    bisection (``default`` in ``PartitioningMode.RB``: k - 1 bisections,
    every subgraph a CUDA graph), ``default`` with HEM coarsening (at least
    one level, none shrinking by more than 2x) and ``kway`` with
    ``overlay_levels`` = 2 (at least one level).  Returns the lines."""
    from kaminpar_tpu_torch.context import ClusteringAlgorithm, PartitioningMode

    def rb(ctx):
        ctx.mode = PartitioningMode.RB

    def hem(ctx):
        ctx.coarsening.algorithm = ClusteringAlgorithm.HEM
        ctx.coarsening.convergence_threshold = HEM_CONVERGENCE

    def overlay(ctx):
        ctx.coarsening.overlay_levels = 2

    out = {}
    for name, preset, configure in (("restricted_vcycle", "restricted-vcycle", set_vcycles),
                                    ("rb", "default", rb), ("hem", "default", hem),
                                    ("kway_overlay", "kway", overlay)):
        info, _, _ = drive_dense_path(preset, f"{name}_scale{scale}", graph, k, eps, 1.0,
                                      configure=configure)
        out[name] = info
        if name == "restricted_vcycle" and [c["k"] for c in info["cycles"]] != [*VCYCLES, k]:
            raise AssertionError(f"the restricted v-cycle did not run its cycles: "
                                 f"{info['cycles']}")
        if name == "rb" and (info["bisections"] != k - 1
                             or set(info["subgraph_devices"]) != {"cuda:0"}):
            raise AssertionError(f"recursive bisection: {info['bisections']} bisections, "
                                 f"subgraphs on {info['subgraph_devices']}")
        if name in ("hem", "kway_overlay") and info["levels"] < 1:
            raise AssertionError(f"{name} built no coarse level")
        n = info.get("level_n", [])
        if name == "hem" and any(b < a / 2 for a, b in zip(n, n[1:])):
            raise AssertionError(f"a HEM level shrank by more than 2x: {n}")
    log("scheme checks (s): " + ", ".join(f"{name} {info['wall_s']:.3f}"
                                          for name, info in out.items()))
    return out


def phase_sync_budget(graph, scale: int, k: int, eps: float) -> dict:
    """``KaMinPar("default").compute_partition(k)`` on ``graph`` with the
    readback budgets armed (``partitioning/deep.py`` asserts the
    coarsening's, the initial partitioning's and the compressed tier's),
    the tripwire on, the card's synchronizing calls counted per phase
    (``sync_stats.count_device_syncs``), the heap profiler on and the run
    traced to a file; no peak tracker or capture wrapper, whose own
    readbacks would count.  Holds: coarsening's pulls equal its
    contractions, no card sync outside a pull in coarsening, at most k0
    initial-partitioning pulls, a valid trace, device bytes in the heap
    report.  Returns its line."""
    import tempfile

    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch import telemetry
    from kaminpar_tpu_torch.utils import heap_profiler, sync_stats

    solver = kp.KaMinPar("default")  # no device: cuda:0
    solver.set_graph(graph)
    heap_profiler.HeapProfiler.reset(enabled=True)
    sync_stats.reset()
    sync_stats.enable_budget_checks(True)
    with tempfile.TemporaryDirectory() as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        try:
            with telemetry.run(trace_out=trace_path), sync_stats.tripwire(), \
                    sync_stats.count_device_syncs() as other_warnings:
                t0 = time.perf_counter()
                solver.compute_partition(k, epsilon=eps)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            sync_stats.enable_budget_checks(False)
        with open(trace_path) as fh:
            trace = telemetry.validate_chrome_trace(json.load(fh))
    acc = run_accounting()
    report = heap_profiler.HeapProfiler.report()
    heap_profiler.HeapProfiler.reset(enabled=False)
    memory = heap_profiler.memory_summary()
    scheme = solver.last_partitioner
    phases = acc["sync"]["phases"]
    syncs = acc["sync"]["device_syncs"]
    p = solver.last_partition
    info = dict(phase="sync_budget", graph=f"rmat_graph({scale}, 16, seed=1)", k=k,
                epsilon=eps, wall_s=wall, cut=int(p.edge_cut()),
                feasible=bool(p.is_feasible()), levels=scheme.num_levels,
                coarsest=scheme.coarsest, contractions=scheme.contractions,
                coarsening_pulls=scheme.coarsening_pulls, ip_pulls=scheme.ip_pulls,
                pulls={ph: row["count"] for ph, row in phases.items()},
                implicit={ph: row["implicit"] for ph, row in phases.items()
                          if row["implicit"]},
                device_syncs=syncs, other_warnings=len(other_warnings),
                trace={key: trace[key] for key in ("events", "spans", "counters",
                                                   "quality_rows")},
                syncs_before_probes=SYNCS_BEFORE_PROBES,
                heap=memory, heap_report_lines=len(report.splitlines()), **acc)
    log(json.dumps(info))
    if not info["feasible"]:
        raise AssertionError("the sync budget run's partition is infeasible")
    if scheme.contractions < 1 or scheme.coarsening_pulls != scheme.contractions:
        raise AssertionError(f"coarsening pulled {scheme.coarsening_pulls} times for "
                             f"{scheme.contractions} contractions")
    if syncs.get("coarsening", 0):
        raise AssertionError(f"{syncs['coarsening']} card syncs outside pull in coarsening")
    if scheme.ip_pulls > max(scheme.coarsest["k0"], 1):
        raise AssertionError(f"initial partitioning pulled {scheme.ip_pulls} times "
                             f"for k0 = {scheme.coarsest['k0']}")
    if not trace["spans"] or memory.get("peak_bytes_in_use", 0) <= 0 \
            or "entry=0 exit=0" in report.splitlines()[1]:
        raise AssertionError("no spans in the trace or no device bytes in the heap report")
    if not trace["quality_rows"]:
        raise AssertionError("the traced run wrote no quality rows")
    risen = {ph: n for ph, n in syncs.items() if n > SYNCS_BEFORE_PROBES.get(ph, 0)}
    if risen:
        raise AssertionError(f"card syncs outside pull rose with the probes armed: {risen} "
                             f"(before: {SYNCS_BEFORE_PROBES})")
    return info


def phase_scheme_round_reference(device):
    """The new schemes' rounds through their entry points, on the card and
    on the CPU with the same draws: one HEM round (and a whole HEM
    clustering), one overlay intersection, and the restricted v-cycle's
    ``_restrict`` with its ``_rebalance_restricted`` rounds."""
    import numpy as np
    import torch

    from kaminpar_tpu_torch.coarsening import hem_clusterer as hem
    from kaminpar_tpu_torch.coarsening.lp_clusterer import _intersect_clusterings
    from kaminpar_tpu_torch.context import LabelPropagationContext
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
    from kaminpar_tpu_torch.partitioning.deep import DeepMultilevelPartitioner
    from kaminpar_tpu_torch.presets import create_context_by_preset_name
    from kaminpar_tpu_torch.refinement import balancer

    def to(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        items = [None if v is None else to(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)

    g = generators.rmat_graph(14, 16, seed=3)
    dg = g.to(device)
    pv, dpv = g.padded(), dg.padded()
    gen = torch.Generator().manual_seed(6)
    jitters = [hem.draw_hem_jitter(gen, pv) for _ in range(5)]
    ids = torch.arange(pv.n_pad, dtype=torch.int32)
    cap = torch.tensor(8, dtype=torch.int32)
    ref = hem._hem_round(ids, jitters[0], pv, cap)
    out = hem._hem_round(ids.to(device), jitters[0].to(device), dpv, cap.to(device))
    clusterer = hem.HEMClustering(LabelPropagationContext())
    cref = clusterer.compute_clustering(g, 8, draw=lambda r: jitters[r])
    cout = clusterer.compute_clustering(dg, 8, draw=lambda r: jitters[r].to(device))
    if max_abs_err((ref, cref), (out, cout)):
        raise AssertionError("HEM on the card != HEM on the CPU")
    la = torch.randint(0, 64, (pv.n_pad,), generator=gen, dtype=torch.int32)
    lb = torch.randint(0, 64, (pv.n_pad,), generator=gen, dtype=torch.int32)
    iref = _intersect_clusterings(la, lb)
    iout = _intersect_clusterings(la.to(device), lb.to(device))
    if max_abs_err((iref,), (iout,)):
        raise AssertionError("overlay intersection on the card != on the CPU")

    # _restrict: 16 blocks under 4 communities, block 4c holding about half
    # of community c, 15% of the nodes moved to random blocks; the reverted
    # partition stays overloaded, so the restricted rebalance runs
    k, ck = 16, 4
    n = g.n
    rng = np.random.default_rng(21)
    comm = (np.arange(n) * ck // n).astype(np.int32)
    pre = (4 * comm + np.where(rng.random(n) < 0.5, 0, rng.integers(1, 4, n))).astype(np.int32)
    post = pre.copy()
    moved = rng.random(n) < 0.15
    post[moved] = rng.integers(0, k, int(moved.sum()))
    caps = np.full(k, int(np.ceil(g.total_node_weight / k * 1.03)) + 1, dtype=np.int64)
    mbv = g.community_masked(torch.from_numpy(comm)).bucketed()
    draws = [balancer.draw_balance_round(gen, mbv, pv.n_pad) for _ in range(8)]
    parts, moved_back = [], 0
    for graph, dev_draw in ((g, lambda r: draws[r]), (dg, lambda r: to(draws[r]))):
        ctx = create_context_by_preset_name("restricted-vcycle")
        ctx.partition.k, ctx.partition.max_block_weights = k, caps
        c = torch.as_tensor(comm, device=graph.device)
        deep = DeepMultilevelPartitioner(ctx, graph, communities=c, communities_k=ck)
        p = deep._restrict(PartitionedGraph.create(graph, k, post, caps), pre, k, c,
                           draw=dev_draw)
        parts.append(p)
    if max_abs_err((parts[0].partition,), (parts[1].partition,)):
        raise AssertionError("_restrict on the card != _restrict on the CPU")
    part = parts[1].partition.cpu().numpy()
    if (part // 4 != comm).any() or not parts[1].is_feasible():
        raise AssertionError("_restrict left a node outside its community or an overload")
    log(f"scheme round reference: rmat_graph(14, 16, seed=3): one HEM round (matched "
        f"{int((out != ids.to(device)).sum())}) and a HEM clustering, one overlay "
        f"intersection and one _restrict with its restricted rebalance ({int((part != pre).sum())} "
        f"nodes off the partition before refinement) on the card equal the CPU's")


def phase_min_weights(g, scale: int, k: int, eps: float):
    """``KaMinPar("default").compute_partition(k, eps, min_epsilon=eps)``
    on the card: feasible and min-feasible.  Returns its line."""
    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.ops import lp_kernels
    from kaminpar_tpu_torch.utils import sync_stats

    solver = kp.KaMinPar("default")
    solver.set_graph(g)
    lp_kernels.reset_launches()
    sync_stats.reset()
    t0 = time.perf_counter()
    solver.compute_partition(k, epsilon=eps, min_epsilon=eps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lp_kernels.LAUNCHES)
    p = solver.last_partition
    bw = p.block_weights()
    info = dict(phase="min_weights", graph=f"rmat_graph({scale}, 16, seed=1)", k=k,
                epsilon=eps, min_epsilon=eps, wall_s=wall, cut=int(p.edge_cut()),
                feasible=bool(p.is_feasible()), min_feasible=bool(p.is_min_feasible()),
                max_block_weight=int(bw.max()), min_block_weight=int(bw.min()),
                required_min=int(p.min_block_weights.min()),
                allowed_max=int(p.max_block_weights.max()), launches=launches,
                **run_accounting())
    log(json.dumps(info))
    if not (info["feasible"] and info["min_feasible"]):
        raise AssertionError("the minimum-weight partition is not feasible and min-feasible")
    return info


def phase_pooled_serial(scale: int, k: int):
    """``KaMinPar("largek")`` into ``k`` blocks on ``rmat_graph(scale)`` with
    device extension from 2,048 nodes, the extension jobs on a pool of
    ``host_pool_workers`` threads (at most the core count) and on one
    thread (the card's own width, ``platform.extension_workers``): equal
    partitions on the card; both walls timed."""
    import numpy as np

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.utils import platform

    g = generators.rmat_graph(scale, 16, seed=1)
    width = platform.extension_workers
    info = dict(phase="pooled_serial", graph=f"rmat_graph({scale}, 16, seed=1)",
                preset="largek", k=k, device_extension_n=2048,
                pooled_workers=platform.host_pool_workers(1 << 20))
    parts = {}
    for name, workers in (("pooled", lambda jobs, device: platform.host_pool_workers(jobs)),
                          ("serial", lambda jobs, device: 1)):
        platform.extension_workers = workers
        try:
            solver = kp.KaMinPar("largek")
            solver.ctx.initial_partitioning.device_extension_n = 2048
            solver.set_graph(g)
            t0 = time.perf_counter()
            parts[name] = solver.compute_partition(k)
            info[name] = dict(wall_s=time.perf_counter() - t0,
                              cut=int(solver.last_partition.edge_cut()),
                              feasible=bool(solver.last_partition.is_feasible()),
                              extension_jobs=solver.last_partitioner.extension_jobs,
                              phase_s=solver.last_partitioner.phase_seconds)
        finally:
            platform.extension_workers = width
    info["equal"] = bool(np.array_equal(parts["pooled"], parts["serial"]))
    log(json.dumps(info))
    if not info["equal"]:
        raise AssertionError("the pooled and the serial extension partitions differ")
    if info["pooled"]["extension_jobs"]["device"] <= 0:
        raise AssertionError("device extension did not fire in the pooled = serial phase")


def phase_pool_width(device):
    """The extension pool's width on the card: one device-pool bisection of
    a small graph (``rmat_graph(10, 8, seed=2)``, as small as the
    subgraphs the k = 1024 extension bisects) timed alone, with the device
    events it launches and their device time; then 8 such bisections on
    one thread and on eight."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from kaminpar_tpu_torch.context import InitialPartitioningContext
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.ops import bipartition as bip
    from kaminpar_tpu_torch.partitioning.kway import graph_to_host

    g = generators.rmat_graph(10, 8, seed=2)
    h = graph_to_host(g)
    ipc = InitialPartitioningContext()
    half = int(h.node_w.sum()) // 2 + 10
    mw = np.array([half, half])

    def bisect(seed):
        with torch.cuda.device(device):
            return bip.pool_bipartition_device(h.row_ptr, h.col_idx, h.node_w, h.edge_w, mw,
                                               seed, ipc, 2, device=device)

    bisect(1)
    walls = []
    for seed in range(3):
        t0 = time.perf_counter()
        bisect(seed)
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = sorted(walls)[1]
    events, device_ms = device_activity(lambda: bisect(3))
    by_workers = {}
    for workers in (1, 8):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(bisect, range(8)))
        torch.cuda.synchronize()
        by_workers[workers] = time.perf_counter() - t0
    log(json.dumps(dict(phase="pool_width", graph="rmat_graph(10, 8, seed=2)", n=g.n,
                        n_pad=g.padded().n_pad, ms=ms, walls_ms=walls, device_events=events,
                        device_ms=device_ms,
                        device_idle_share=None if device_ms is None else 1 - device_ms / ms,
                        seconds_8_bisections_by_workers=by_workers)))


def phase_small_reference():
    """A small graph on the card (kernels, the device bipartition pool:
    ``ip_backend`` "auto") and on the CPU (plain versions, the host pool):
    both feasible, cuts within 1.3x, the bound this comparison had when
    both ran the host pool.  The two runs draw different random streams and
    bisect with different pools, so the partitions differ."""
    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.ops import bipartition

    g = generators.rmat_graph(12, 8, seed=1)
    cuts, pool_calls = {}, {}
    for dev in ("cuda", "cpu"):
        solver = kp.KaMinPar("default", device=dev)
        solver.set_graph(g)
        bipartition.reset_pool_stats()
        solver.compute_partition(8)
        pool_calls[dev] = bipartition.pool_stats_snapshot()["calls"]
        if not solver.last_partition.is_feasible():
            raise AssertionError(f"small reference infeasible on {dev}")
        cuts[dev] = solver.last_partition.edge_cut()
    ratio = cuts["cuda"] / max(cuts["cpu"], 1)
    log(json.dumps(dict(phase="small_reference", graph="rmat_graph(12, 8, seed=1)", k=8,
                        cut_cuda=cuts["cuda"], cut_cpu=cuts["cpu"], ratio=ratio,
                        pool_calls=pool_calls)))
    if pool_calls["cuda"] <= 0 or pool_calls["cpu"] != 0:
        raise AssertionError(f"the card run must take the device pool, the CPU run the "
                             f"host pool: {pool_calls}")
    if not 1 / 1.3 <= ratio <= 1.3:
        raise AssertionError(f"card and CPU cuts differ by more than 1.3x: {cuts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22,
                    help="base RMAT scale (2^scale nodes): the largek path runs at "
                    "scale minus LARGEK_SCALE_CUT, the other paths below it")
    ap.add_argument("--path-scale", type=int, metavar="S",
                    help="RMAT scale of the terapart path and of the dense kernels' "
                    "shapes (default: --scale minus 2)")
    ap.add_argument("--kernels-only", action="store_true",
                    help="build, check and time the kernels (phases 1-3 and the kernel "
                    "part of 6) and stop: no path runs, no result line")
    ap.add_argument("--partition", metavar="FILE",
                    help="the whole run saves the terapart path's final partition and "
                    "block caps there (.npz); --kernels-only times the refinement commit "
                    "on the partition saved there at the same scale")
    args = ap.parse_args()

    name, count, smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np
    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.graph.device_compressed import DeviceCompressedView
    from kaminpar_tpu_torch.utils import Logger, OutputLevel

    Logger.level = OutputLevel.EXPERIMENT
    phase_build()

    def rmat(scale):
        t0 = time.perf_counter()
        g = generators.rmat_graph(scale, 16, seed=1, device=device)
        log(f"graph: rmat_graph({scale}, 16, seed=1) n={g.n} m={g.m} "
            f"({time.perf_counter() - t0:.1f} s, built on the card)")
        return g

    device = torch.device("cuda", 0)
    path_scale = args.scale - 2 if args.path_scale is None else args.path_scale
    graph = rmat(path_scale)
    terapart = kp.KaMinPar("terapart")  # no device: cuda:0
    t0 = time.perf_counter()
    terapart.set_graph(graph)  # compresses on the host
    compress_s = time.perf_counter() - t0
    rate_c, commit = phase_compressed_kernel(terapart.compressed_graph, terapart.ctx, device,
                                             K, EPSILON)
    if args.kernels_only:
        if args.partition:
            saved = np.load(args.partition)
            cv = DeviceCompressedView(terapart.compressed_graph, device)
            phase_refinement_commit(cv, saved["partition"], saved["caps"], device, K)
            del cv
        del terapart
        torch.cuda.empty_cache()
        phase_kernels(finest_graph(graph, K, device), device, K)
        log(smi)
        return 0
    tinfo = phase_terapart_path(terapart, graph, K, EPSILON, compress_s)
    p = terapart.last_partition
    if args.partition:
        np.savez_compressed(args.partition, partition=p.partition.cpu().numpy().astype(np.int32),
                            caps=np.asarray(p.max_block_weights))
    commit["instances"].append(phase_refinement_commit(
        terapart.last_partitioner.compressed_view, p.partition, p.max_block_weights, device, K))
    del p
    del terapart
    torch.cuda.empty_cache()
    work = finest_graph(graph, K, device)
    rate, commit_default = phase_kernels(work, device, K)
    commit["instances"].insert(1, commit_default)
    torch.cuda.empty_cache()
    jinfo, jpart, jcaps = phase_jet_path(graph, K, EPSILON, tinfo["cut"])
    torch.cuda.empty_cache()
    jpart = work_partition(graph, jpart, K)
    rate_j, commit_j = phase_jet_kernels(work, jpart, jcaps, device, K)
    cinfo = phase_clp(work, jpart, jcaps, device, K)
    phase_fm_pass(work, jpart, jcaps, device, K)
    del work, jpart
    torch.cuda.empty_cache()
    kcap = RefineCapture()
    kinfo, kpart, kcaps = phase_kway_path(graph, "kway", K, EPSILON, tinfo["cut"], kcap)
    torch.cuda.empty_cache()
    work = finest_graph(graph, K, device)
    rate_kf, commit_kf = phase_refine_kernels(
        work, work_partition(graph, kpart, K), kcaps, device, K,
        "the kway path's finest graph, its final partition", seed=15)
    del work, kpart
    rate_kc, commit_kc = phase_captured_kernels(kcap, "coarsest", "kway", device, K)
    del kcap
    torch.cuda.empty_cache()
    ltcap = RefineCapture()
    ltinfo, _, _ = phase_kway_path(graph, "linear-time-kway", K, EPSILON, tinfo["cut"],
                                   ltcap, need_sparsified=True)
    rate_ls, commit_ls = phase_captured_kernels(ltcap, "sparsified", "linear-time-kway",
                                                device, K)
    del ltcap
    del graph
    torch.cuda.empty_cache()
    sinfo = phase_strong_path(STRONG_SCALE, K, EPSILON)
    torch.cuda.empty_cache()
    sg = rmat(SCHEME_SCALE)
    scheme_infos = phase_scheme_checks(sg, SCHEME_SCALE, K, EPSILON)
    phase_sync_budget(sg, SCHEME_SCALE, K, EPSILON)
    del sg
    torch.cuda.empty_cache()

    small = rmat(args.scale - 4)
    phase_off_vs_finest(small, args.scale - 4, OFF_FINEST_K, EPSILON)
    phase_round_reference(device)
    phase_scheme_round_reference(device)
    info, coarsest, default_part = phase_main_path(small, K, EPSILON)
    torch.cuda.empty_cache()
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as files_dir:
        cli_paths = phase_files_and_entry_points(small, default_part, info["cut"], K, EPSILON,
                                                 files_dir)
        torch.cuda.empty_cache()
        cli_paths.update(phase_preemption(small, default_part, K, EPSILON, files_dir))
        torch.cuda.empty_cache()
        cli_paths.update(phase_serve(files_dir))
    del default_part
    phase_pool(coarsest, device)
    torch.cuda.empty_cache()
    vinfo = phase_vcycle_path(small, K, EPSILON, info["cut"])
    torch.cuda.empty_cache()

    graph = rmat(args.scale - LARGEK_SCALE_CUT)
    linfo, lpart, lcaps = phase_largek_path(graph, LARGE_K, EPSILON)
    torch.cuda.empty_cache()
    work = finest_graph(graph, LARGE_K, device)
    rate_l, commit_l = phase_refine_kernels(
        work, work_partition(graph, lpart, LARGE_K), lcaps, device, LARGE_K,
        "the largek path's finest graph, its final partition")
    rate["instances"] = [rate.copy(), rate_l, rate_j, rate_kc, rate_kf, rate_ls]
    commit["instances"] += [commit_l, commit_j, commit_kc, commit_kf, commit_ls]
    del work, graph
    torch.cuda.empty_cache()
    minfo = phase_min_weights(small, args.scale - 4, K, EPSILON)
    del small
    phase_pooled_serial(POOLED_SERIAL_SCALE, POOLED_SERIAL_K)
    phase_pool_width(device)
    phase_small_reference()

    paths = dict(terapart=tinfo, default=info, largek=linfo, min_weights=minfo, jet=jinfo,
                 clp=cinfo, strong=sinfo, kway=kinfo, linear_time_kway=ltinfo, vcycle=vinfo,
                 **scheme_infos, **cli_paths)
    kernels = []
    for meas, source, replaces in (
            (rate, RATE_SOURCE, RATE_REPLACES),
            (rate_c, RATE_SOURCE, RATE_COMPRESSED_REPLACES),
            (commit, COMMIT_SOURCE, COMMIT_REPLACES)):
        by_path = {name: path["launches"][meas["kernel"]] for name, path in paths.items()
                   if path["launches"][meas["kernel"]]}
        kernels.append(dict(
            name=meas["kernel"], route="cuda", source=source, replaces=replaces,
            status="ported", launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=meas["max_abs_err"], ms=meas["kernel_ms"],
            plain_ms=meas["plain_ms"], bound_ms=meas["bound_ms"],
            bound_by=meas["bound_by"], library_ms=meas["library_ms"],
        ))
        if "instances" in meas:  # every instance timed
            kernels[-1]["instances"] = [
                {key: inst[key] for key in ("what", "n", "L", "movers", "largest_target",
                                            "kernel_ms", "host_paced_ms", "plain_ms",
                                            "bound_ms") if key in inst}
                for inst in meas["instances"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
