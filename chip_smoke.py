#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # RMAT scale 22, k = 16, cuda:0
    python3 chip_smoke.py --scale 16      # a quicker run
    python3 chip_smoke.py --kernels-only  # phases 1-3 and 6's kernels, no path
    python3 chip_smoke.py --partition F   # also save terapart's final partition in F
    python3 chip_smoke.py --kernels-only --partition F  # and time the commit on it

``rmat_graph(scale, 16, seed=1)`` is generated once.  Phases, each of
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
6. kernels of the default path: on the degree-bucketed layout of
   ``rmat_graph(scale - 2)`` with its isolated nodes stripped (the shapes
   that path gives them) the dense rating kernel and the commit kernel
   are compared with their plain versions and timed; then, on a small
   graph, one whole LP round and one balancer round on the card are
   compared with the plain rounds on the CPU, with the same draws;
7. default path: ``KaMinPar("default").compute_partition(k)`` on
   ``rmat_graph(scale - 2)``, counters and peaks as in 4; the partition
   must be feasible, use all k blocks and cut less than 0.95x the edge
   weight a random partition cuts (RMAT graphs are expander-like: a good
   k=16 cut is about 0.9x random), and both dense-path kernels must have
   run.  Both paths run below the terapart path's scale to keep the run
   inside its time limit: their host-side initial partitioning and
   extension take minutes (PERF.md);
8. a small graph partitioned on the card and on the CPU: both feasible,
   cuts within 1.3x of each other.

The rating kernels are also timed bucket by bucket: one JSON line per
bucket with its width, rows, real rows, time and bound, beside the
earlier slices' bound (which counted pad rows and a bitonic network).

A kernel's ``ms`` is its time on the card: the card sleeps while the host
queues the timed calls.  Each kernel's own line also gives
``host_paced_ms``, the same calls timed with the card starting at once,
which includes the wrapper's host overhead where that is the longer.

It prints one JSON line per kernel, the ``{"kernels": [...]}`` line, the
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


def log(msg: str) -> None:
    print(msg, flush=True)


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
    ``outside`` is the largest peak between the calls.  It also counts the
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
        from kaminpar_tpu_torch.ops import lp_kernels

        self.commit_calls = collections.Counter()
        self.commit_hubs = collections.Counter()  # the most movers on one target
        commit = lp_kernels.commit_moves
        self._saved.append((lp_kernels, "commit_moves", commit))

        def counted(*args, **kwargs):
            L = kwargs["num_labels"] if "num_labels" in kwargs else args[6]
            key = (int(args[1].shape[0]), int(L))
            self.commit_calls[key] += 1
            self.commit_hubs[key] = max(self.commit_hubs[key], commit_movers(args, kwargs)[1])
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


def commit_bytes(n: int, L: int, maxw_len: int, act: bool, coin: bool) -> int:
    """The commit's inputs read once (labels, node_w, target, tconn,
    own_conn, prio; the flags it uses; label weights and caps) and its
    outputs written once (new labels, new label weights, the count)."""
    return 4 * (6 * n + L + maxw_len) + n * (int(act) + int(coin)) + 4 * (n + L + 1)


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
        kernel="lp_rate", what="one rating pass over all buckets of the finest graph, "
        "clustering instantiation", kernel_ms=cuda_time_ms(kernel_pass, iters=20),
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
        commit_bytes(n, L, int(call[5].numel()), act=act, coin=False), commit_ops(n, movers))
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
    from kaminpar_tpu_torch.ops import lp_kernels

    def refuse(self, device="cpu"):
        raise AssertionError("the terapart path decompressed on the host")

    host_decompress = CompressedGraph.decompress
    CompressedGraph.decompress = refuse
    try:
        with PeakTracker() as mem:
            lp_kernels.reset_launches()
            t0 = time.perf_counter()
            part = solver.compute_partition(k, epsilon=eps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(lp_kernels.LAUNCHES)
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
                phase_s=solver.last_partitioner.phase_seconds, launches=launches,
                commit_calls=mem.commit_log("terapart"))
    log(json.dumps(info))
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
    """One LP clustering round and one balancer round through the wrappers:
    the kernels on the card against the plain versions on the CPU, with the
    same draws (a small graph: the CPU side is slow)."""
    import torch

    from kaminpar_tpu_torch.graph import generators
    from kaminpar_tpu_torch.ops import lp
    from kaminpar_tpu_torch.refinement import balancer

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
    log(f"round reference: rmat_graph(14, 16, seed=3): one LP round (moved "
        f"{int(out.num_moved)}) and one balancer round (moved {int(bout[1][0])}) on the "
        f"card equal the plain rounds on the CPU")


def phase_main_path(graph, k: int, eps: float):
    import torch

    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.ops import lp_kernels
    solver = kp.KaMinPar("default")  # no device: cuda:0
    solver.set_graph(graph)
    with PeakTracker() as mem:
        lp_kernels.reset_launches()
        t0 = time.perf_counter()
        part = solver.compute_partition(k, epsilon=eps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(lp_kernels.LAUNCHES)
    p = solver.last_partition
    cut = int(p.edge_cut())
    bw = p.block_weights()
    feasible = bool(p.is_feasible())
    total_ew = graph.total_edge_weight // 2
    part_info = solver.last_partitioner
    info = dict(phase="main_path", n=graph.n, m=graph.m, k=k, epsilon=eps, cut=cut,
                random_cut_expected=int(total_ew * (1 - 1 / k)), feasible=feasible,
                max_block_weight=int(bw.max()), min_block_weight=int(bw.min()),
                wall_s=wall, peak_bytes=mem.peak, peak_outside_bytes=mem.outside,
                peak_calls=mem.calls, levels=part_info.num_levels,
                phase_s=part_info.phase_seconds, launches=launches,
                commit_calls=mem.commit_log("default"))
    log(json.dumps(info))
    if not feasible:
        raise AssertionError("main path partition is infeasible")
    if part.shape != (graph.n,) or bw.min() <= 0:
        raise AssertionError("main path partition does not use all k blocks")
    if cut >= 0.95 * total_ew * (1 - 1 / k):
        raise AssertionError("main path cut is not clearly below a random partition's")
    if launches["lp_rate"] <= 0 or launches["lp_commit"] <= 0:
        raise AssertionError(f"a kernel did not run on the main path: {launches}")
    return info


def phase_small_reference():
    """A small graph on the card and on the CPU (plain versions): both
    feasible, cuts within 1.3x.  The two devices draw different random
    streams, so the partitions differ."""
    import kaminpar_tpu_torch as kp
    from kaminpar_tpu_torch.graph import generators

    g = generators.rmat_graph(12, 8, seed=1)
    cuts = {}
    for dev in ("cuda", "cpu"):
        solver = kp.KaMinPar("default", device=dev)
        solver.set_graph(g)
        solver.compute_partition(8)
        if not solver.last_partition.is_feasible():
            raise AssertionError(f"small reference infeasible on {dev}")
        cuts[dev] = solver.last_partition.edge_cut()
    ratio = cuts["cuda"] / max(cuts["cpu"], 1)
    log(json.dumps(dict(phase="small_reference", graph="rmat_graph(12, 8, seed=1)", k=8,
                        cut_cuda=cuts["cuda"], cut_cpu=cuts["cpu"], ratio=ratio)))
    if not 1 / 1.3 <= ratio <= 1.3:
        raise AssertionError(f"card and CPU cuts differ by more than 1.3x: {cuts}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=int, default=22, help="RMAT scale (2^scale nodes)")
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
        g = generators.rmat_graph(scale, 16, seed=1)
        log(f"graph: rmat_graph({scale}, 16, seed=1) n={g.n} m={g.m} "
            f"({time.perf_counter() - t0:.1f} s on the host)")
        return g

    graph = rmat(args.scale)
    device = torch.device("cuda", 0)
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
        del terapart, graph
        torch.cuda.empty_cache()
        phase_kernels(finest_graph(rmat(args.scale - 2), K, device), device, K)
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
    del terapart, graph
    torch.cuda.empty_cache()
    phase_off_vs_finest(rmat(args.scale - 4), args.scale - 4, OFF_FINEST_K, EPSILON)

    graph = rmat(args.scale - 2)
    work = finest_graph(graph, K, device)
    rate, commit_default = phase_kernels(work, device, K)
    commit["instances"].insert(1, commit_default)
    del work
    torch.cuda.empty_cache()
    phase_round_reference(device)
    info = phase_main_path(graph, K, EPSILON)
    phase_small_reference()

    kernels = []
    for meas, source, replaces, path in (
            (rate, RATE_SOURCE, RATE_REPLACES, info),
            (rate_c, RATE_SOURCE, RATE_COMPRESSED_REPLACES, tinfo),
            (commit, COMMIT_SOURCE, COMMIT_REPLACES, tinfo)):
        kernels.append(dict(
            name=meas["kernel"], route="cuda", source=source, replaces=replaces,
            status="ported", launches=path["launches"][meas["kernel"]],
            max_abs_err=meas["max_abs_err"], ms=meas["kernel_ms"],
            plain_ms=meas["plain_ms"], bound_ms=meas["bound_ms"],
            bound_by=meas["bound_by"], library_ms=meas["library_ms"],
        ))
        if "instances" in meas:  # the commit: every instance timed
            kernels[-1]["instances"] = [
                {key: inst[key] for key in ("what", "n", "L", "movers", "largest_target",
                                            "kernel_ms", "host_paced_ms", "plain_ms",
                                            "bound_ms")}
                for inst in meas["instances"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
