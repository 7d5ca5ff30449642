"""``python -m kaminpar_tpu_torch.serve``: the serving CLI (counterpart of
the JAX package's serve CLI; every flag but ``--fleet``, plus
``--device``).

It serves on ``cuda:0`` unless ``--device`` names another device
(``--device cpu`` runs the plain PyTorch versions); without a card and
without ``--device`` it exits 1 before starting the engine.  Three modes:

* ``--warmup-only``: start the engine (the warmup ladder), print the
  per-cell warmup report and the stats snapshot as JSON, exit.
* graph files as positionals: serve each file through the warm engine
  (one request per file), optionally writing ``<graph>.part`` outputs.
* ``--demo N`` (default when no graphs are given): run a synthetic
  burst workload of N RMAT requests across the warm ladder and print the
  stats snapshot — the quickest way to see batching/queueing behave.

Observability: ``--metrics-port P`` serves the engine's Prometheus text
exposition at ``http://127.0.0.1:P/metrics`` for the session's duration,
and a JSON liveness probe at ``/healthz`` (queue and dispatcher liveness
with the SLO burn summary; 200 healthy, 503 not); ``--trace-out FILE``
records the whole session (engine queue
lifecycle events + pipeline spans + quality probes) as a Chrome trace.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _int_tuple(text: str) -> tuple:
    return tuple(int(s) for s in text.split(",") if s.strip())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m kaminpar_tpu_torch.serve",
        description="Partition-serving runtime: warm engine, bucket-batched "
        "dispatch, bounded async queue.",
    )
    p.add_argument("graphs", nargs="*", help="graph files to serve (METIS/ParHIP)")
    p.add_argument("-P", "--preset", default="serve")
    p.add_argument("-k", type=int, default=8, help="blocks per request")
    p.add_argument("-e", "--epsilon", type=float, default=0.03)
    p.add_argument("--ladder", type=_int_tuple, default=None,
                   help="warmup node-count rungs, e.g. 256,1024")
    p.add_argument("--warm-ks", type=_int_tuple, default=None,
                   help="warmup k values, e.g. 4,8")
    p.add_argument("--max-batch", type=int, default=None)
    p.add_argument("--queue-bound", type=int, default=None)
    p.add_argument("--batch-window-ms", type=float, default=None)
    p.add_argument("--deadline-ms", type=float, default=None,
                   help="per-request deadline (0 = none)")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: cuda:0; "
                        "'cpu' runs the plain PyTorch versions)")
    p.add_argument("--warmup-only", action="store_true")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--demo", type=int, default=16, metavar="N",
                   help="synthetic burst requests when no graphs are given")
    p.add_argument("--demo-edge-factor", type=int, default=8)
    p.add_argument("-o", "--output", action="store_true",
                   help="write <graph>.part next to each served graph file")
    p.add_argument("--metrics-port", type=int, default=0, metavar="PORT",
                   help="serve Prometheus metrics at "
                        "http://127.0.0.1:PORT/metrics (0 = off)")
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write a Chrome trace-event JSON of the session")
    return p


def _health_snapshot(engine) -> dict:
    """Liveness probe body: per-replica queue/dispatcher
    liveness plus the SLO burn summary.  Deliberately cheap — no
    ``stats()`` call, no device work — so a load balancer can poll it at
    high frequency without perturbing the serve path it is probing."""
    replicas = getattr(engine, "replicas", None) or [engine]
    rows = []
    for eng in replicas:
        queue = getattr(eng, "_queue", None)
        thread = getattr(eng, "_thread", None)
        tracker = getattr(eng, "_slo", None)
        rows.append({
            "engine": getattr(eng, "name", "") or "engine",
            "queue_open": bool(queue is not None and not queue.closed),
            "dispatcher_alive": bool(thread is not None and thread.is_alive()),
            "slo": (tracker.summary() if tracker is not None
                    else {"armed": False}),
        })
    healthy = bool(rows) and all(
        row["queue_open"] and row["dispatcher_alive"] for row in rows
    )
    return {"healthy": healthy, "replicas": rows}


def _start_metrics_server(engine, port: int):
    """Serve ``engine.metrics_text()`` at /metrics and a JSON liveness
    probe at /healthz (200 healthy / 503 not) on a daemon thread;
    returns the server (caller shuts it down)."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 — http.server API
            path = self.path.split("?")[0].rstrip("/")
            if path in ("", "/metrics"):
                body = engine.metrics_text().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/healthz":
                health = _health_snapshot(engine)
                body = json.dumps(health).encode()
                self.send_response(200 if health["healthy"] else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(404)
                self.end_headers()

        def log_message(self, *args):  # silence per-scrape stderr noise
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(
        target=server.serve_forever, name="kaminpar-serve-metrics", daemon=True
    ).start()
    return server


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..kaminpar import resolve_device
    from ..presets import create_context_by_preset_name
    from .engine import PartitionEngine

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        # no card and no --device: fail before the engine starts, never
        # fall back to the CPU
        print(f"error: {exc}", file=sys.stderr)
        return 1

    ctx = create_context_by_preset_name(args.preset)
    overrides = {}
    if args.ladder is not None:
        overrides["warm_ladder"] = args.ladder
    if args.warm_ks is not None:
        overrides["warm_ks"] = args.warm_ks
    for flag, knob in (("max_batch", "max_batch"),
                       ("queue_bound", "queue_bound"),
                       ("batch_window_ms", "batch_window_ms"),
                       ("deadline_ms", "default_deadline_ms")):
        val = getattr(args, flag)
        if val is not None:
            overrides[knob] = val
    engine = PartitionEngine(ctx, device=device, **overrides)
    from ..telemetry import trace as ttrace

    rec = None
    if args.trace_out:
        rec = ttrace.start()
        rec.meta.update({"mode": "serve", "preset": args.preset,
                         "device": str(device)})
    metrics_server = None
    try:
        # Inside the try: a failed warmup or an already-bound metrics port
        # must still drain/shut the engine and write the requested trace.
        engine.start(warmup=not args.no_warmup)
        if args.metrics_port:
            metrics_server = _start_metrics_server(engine, args.metrics_port)
            print(f"metrics: http://127.0.0.1:{args.metrics_port}/metrics",
                  file=sys.stderr)
        if args.warmup_only:
            print(json.dumps({"warmup": engine.warmup_report,
                              "stats": engine.stats()}, default=str))
            return 0
        if args.graphs:
            from .. import io as kio

            futures = []
            for path in args.graphs:
                g = kio.read_graph(path)
                futures.append((path, engine.submit(g, args.k, args.epsilon)))
            for path, fut in futures:
                res = fut.result()
                print(f"RESULT graph={path} k={args.k} cut={res.cut} "
                      f"feasible={int(res.feasible)} "
                      f"batch={res.batch_size} warm={int(res.warm_hit)} "
                      f"wait_ms={res.queue_wait_s * 1e3:.1f} "
                      f"exec_ms={res.execute_s * 1e3:.1f}")
                if args.output:
                    kio.write_partition(path + ".part", res.partition)
        else:
            from ..graph.generators import rmat_graph

            ladder = engine.serve.warm_ladder or (256,)
            t0 = time.perf_counter()
            futures = []
            for i in range(args.demo):
                n = ladder[i % len(ladder)]
                scale = max(2, (int(n) - 1).bit_length())
                g = rmat_graph(scale, edge_factor=args.demo_edge_factor,
                               seed=100 + i)
                futures.append(engine.submit(g, args.k, args.epsilon))
            for fut in futures:
                fut.result()
            wall = time.perf_counter() - t0
            print(f"demo: {args.demo} requests in {wall:.2f}s "
                  f"({args.demo / wall:.2f} graphs/s)")
        print(json.dumps(engine.stats(), default=str))
        return 0
    finally:
        try:
            engine.shutdown(drain=True)
        finally:
            # A failed/interrupted drain must still stop the metrics server
            # and write the requested trace.
            if metrics_server is not None:
                metrics_server.shutdown()
            if rec is not None:
                ttrace.stop()
                try:
                    rec.write(args.trace_out)
                    print(f"trace written to {args.trace_out} "
                          f"({rec.summary()['events']} events)", file=sys.stderr)
                except OSError as exc:
                    # A failed trace write must neither mask the session's
                    # own exception nor crash a finished session at exit.
                    print(f"warning: could not write trace {args.trace_out}: "
                          f"{exc}", file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
