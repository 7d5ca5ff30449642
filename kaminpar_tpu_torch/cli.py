"""Command-line application: the ``KaMinPar`` binary equivalent
(counterpart of ``kaminpar_tpu/cli.py``, with the same flags).

Reference: ``apps/KaMinPar.cc:385`` (parse → read graph → facade → write
partition) with the core flag surface of ``kaminpar-cli/kaminpar_arguments.cc``
(preset -P, epsilon -e, seed, output, verbosity, format).  Usage::

    python -m kaminpar_tpu_torch <graph> <k> [-P preset] [-e eps] [-o out.part]
    python -m kaminpar_tpu_torch <graph> <k> --device cpu   # no card

It runs on ``cuda:0`` unless ``--device`` names another device; without
CUDA it exits with the facade's error instead of running on the CPU.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import io as kio
from .context import Context
from .kaminpar import KaMinPar, resolve_device
from .presets import create_context_by_preset_name, get_preset_names
from .utils.logger import Logger, OutputLevel
from .utils.timer import Timer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="kaminpar_tpu_torch",
        description="Balanced k-way graph partitioner on an NVIDIA GPU "
        "(KaMinPar-equivalent; PyTorch and CUDA).",
    )
    p.add_argument("graph", nargs="?", default=None,
                   help="input graph (METIS or ParHIP format)")
    p.add_argument("k", nargs="?", type=int, default=None,
                   help="number of blocks")
    p.add_argument(
        "-P", "--preset", default="default", choices=get_preset_names(),
        help="configuration preset (speed/quality ladder)",
    )
    p.add_argument("-e", "--epsilon", type=float, default=None,
                   help="max block-weight imbalance factor (default 0.03)")
    p.add_argument("--min-epsilon", type=float, default=None,
                   help="max allowed imbalance for minimum block weights; 0 "
                        "disables minimum weights (default)")
    p.add_argument("-f", "--format", default=None, choices=["metis", "parhip"],
                   help="input format (default: auto-detect)")
    p.add_argument("-o", "--output", default=None, help="partition output file")
    p.add_argument("--block-sizes", default=None,
                   help="write per-block weight sums to this file")
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-E", "--experiment", action="store_true",
                   help="print RESULT/TIME lines (machine readable)")
    p.add_argument("--max-timer-depth", type=int, default=3)
    p.add_argument("--use-64bit", action="store_true",
                   help="64-bit node/edge ids and weights")
    p.add_argument("--vcycles", default=None, metavar="K1,K2,...",
                   help="intermediate k values for the vcycle presets "
                        "(reference: --vcycles)")
    p.add_argument("--heap-profile", action="store_true",
                   help="print device allocator statistics after partitioning")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace-event / Perfetto JSON of the "
                        "run: timer-tree spans, per-level quality probes, "
                        "sync/compile/memory counter samples")
    p.add_argument("--profile-phases", default=None, metavar="P1,P2,...",
                   help="arm torch.profiler around these phases (needs "
                        "--trace-out; its capture lands in "
                        "<trace-out>.profile/)")
    p.add_argument("-C", "--config", default=None, metavar="FILE",
                   help="load a TOML config over the chosen preset")
    p.add_argument("--dump-config", action="store_true",
                   help="print the effective config as TOML and exit")
    p.add_argument("--device", default=None,
                   help="torch device to partition on (default: cuda:0; "
                        "'cpu' runs the kernels' plain PyTorch versions)")
    return p


def main(argv=None) -> int:
    # A parent that may kill this process names a heartbeat file in
    # KPTPU_FLIGHT_RECORDER: its last line says which phase the run died in.
    from .telemetry import flight_recorder

    flight_recorder.arm_from_env()
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.dump_config:
        from .config import dump_toml, load_toml_file

        ctx_dump: Context = create_context_by_preset_name(args.preset)
        if args.config:
            ctx_dump = load_toml_file(args.config, ctx_dump)
        if args.seed is not None:
            ctx_dump.seed = args.seed
        if args.use_64bit:
            ctx_dump.use_64bit_ids = True
        print(dump_toml(ctx_dump))
        return 0
    if args.graph is None or args.k is None:
        parser.error("graph and k are required (unless --dump-config)")
    if args.profile_phases and not args.trace_out:
        # Reject the invalid combination before the (possibly multi-minute)
        # graph read, not after.
        parser.error("--profile-phases requires --trace-out")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        # No card and no --device: fail before the graph read, never fall
        # back to the CPU.
        parser.exit(1, f"{parser.prog}: error: {exc}\n")

    if args.quiet:
        Logger.level = OutputLevel.QUIET
    elif args.verbose:
        Logger.level = OutputLevel.DEBUG
    else:
        Logger.level = OutputLevel.EXPERIMENT if args.experiment else OutputLevel.APPLICATION

    ctx: Context = create_context_by_preset_name(args.preset)
    if args.config:
        from .config import load_toml_file

        ctx = load_toml_file(args.config, ctx)
    # CLI flags override the config file only when explicitly passed.
    if args.seed is not None:
        ctx.seed = args.seed
    if args.use_64bit:
        ctx.use_64bit_ids = True
    if args.vcycles:
        ctx.vcycles = tuple(int(s) for s in args.vcycles.split(","))
    if args.heap_profile:
        from .utils.heap_profiler import HeapProfiler

        HeapProfiler.reset(enabled=True)

    t0 = time.perf_counter()
    graph = kio.read_graph(args.graph, args.format, use_64bit=ctx.use_64bit_ids)
    Logger.log(
        f"Input graph: n={graph.n} m={graph.m // 2} "
        f"(read in {time.perf_counter() - t0:.2f}s)"
    )

    trace_rec = None
    if args.trace_out:
        from .telemetry import trace as ttrace

        profile_phases = tuple(
            s.strip() for s in (args.profile_phases or "").split(",") if s.strip()
        )
        trace_rec = ttrace.start(
            profile_phases=profile_phases,
            profile_dir=args.trace_out + ".profile",
        )
        trace_rec.meta.update({
            "graph": args.graph, "k": int(args.k), "preset": args.preset,
            "seed": ctx.seed,
        })

    solver = KaMinPar(ctx, device=device)
    solver.set_graph(graph)
    try:
        part = solver.compute_partition(
            k=args.k,
            epsilon=args.epsilon if args.epsilon is not None else ctx.partition.epsilon,
            min_epsilon=(
                args.min_epsilon
                if args.min_epsilon is not None
                else ctx.partition.min_epsilon
            ),
        )
    finally:
        if trace_rec is not None:
            from .telemetry import trace as ttrace

            ttrace.stop()
            try:
                trace_rec.write(args.trace_out)
                summ = trace_rec.summary()
                Logger.log(
                    f"Telemetry trace written to {args.trace_out} "
                    f"({summ['spans']} spans, {summ['counter_samples']} counter "
                    f"samples, {summ['quality_rows']} quality rows)"
                )
            except OSError as exc:
                # A failed trace write must neither void a finished
                # partition nor mask the run's own exception.
                Logger.warning(f"could not write trace {args.trace_out}: {exc}")

    p_graph = solver.last_partition
    Logger.log(
        f"Partition: cut={p_graph.edge_cut()} imbalance={p_graph.imbalance():.4f} "
        f"feasible={p_graph.is_feasible()}"
    )
    if Logger.level >= OutputLevel.APPLICATION:
        Logger.log(Timer.global_().render(max_depth=args.max_timer_depth))

    if args.output:
        kio.write_partition(args.output, part)
        Logger.log(f"Partition written to {args.output}")
    if args.block_sizes:
        kio.write_block_sizes(
            args.block_sizes, args.k, part, np.asarray(graph.node_w)
        )
    if args.heap_profile:
        from .utils.heap_profiler import HeapProfiler

        Logger.log(HeapProfiler.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
