"""Port parity of the serve tier (``serve/``): batching, the queue, the
engine, the journal and the serve CLI, on the CPU.

- ``shape_cell``, ``pack_graphs``, ``unpack_partition`` and
  ``batched_metrics`` equal the JAX package's exactly on the same graphs
  and partitions.
- The queue and the engine behave as ``tests/test_serve.py`` asserts of
  the JAX package: queue-full with a retry-after, deadline, cancel, drain
  and non-draining shutdown; the facade delegates to an engine.
- Served partitions (lane-stacked and per graph) equal the port's own
  sequential facade runs bit for bit, and each served cut is at most 1.2x
  the JAX package's sequential ``KaMinPar("serve")`` cut on the same
  graph.
- Journal records are the JAX package's JSON, and a journal left with
  unresolved admits replays each of them exactly once.
- ``python -m kaminpar_tpu_torch.serve --device cpu --demo 4`` gives rc 0.

Graphs have at most a few thousand nodes; torch runs on one thread; no
JAX engine is started.
"""

import json
import time

import jax
import numpy as np
import pytest
import torch

from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.kaminpar import KaMinPar as JKaMinPar
from kaminpar_tpu.serve import batching as jbatch
from kaminpar_tpu.serve import journal as jjournal
from kaminpar_tpu_torch import KaMinPar
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics
from kaminpar_tpu_torch.serve import (BoundedServeQueue, DeadlineExceededError,
                                      EngineStoppedError, PartitionEngine, QueueFullError,
                                      RequestCancelledError, batched_metrics, form_batches,
                                      pack_graphs, shape_cell, unpack_partition)
from kaminpar_tpu_torch.serve import __main__ as serve_cli
from kaminpar_tpu_torch.serve import journal as tjournal


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(warm_ladder=(), warm_ks=(), max_batch=4, queue_bound=8, device="cpu")


def pair(kind, seed):
    make = {"rmat": lambda m: m.rmat_graph(8, 4, seed=seed),
            "grid": lambda m: m.grid2d_graph(16, 16),
            "star": lambda m: m.star_graph(99)}[kind]
    return make(jgen), make(tgen)


def _rmat(seed, scale=8):
    return tgen.rmat_graph(scale, 4, seed=seed)


class _Item:
    def __init__(self, cell):
        self.cell = cell


# -- batching against the JAX package ----------------------------------------


def test_batching_matches_jax():
    pairs = [pair("rmat", 1), pair("grid", 0), pair("star", 0)]
    jg, tg = [p[0] for p in pairs], [p[1] for p in pairs]
    for a, b in zip(jg, tg):
        assert tuple(shape_cell(b, 4)) == tuple(jbatch.shape_cell(a, 4))
    jp, tp = jbatch.pack_graphs(jg), pack_graphs(tg)
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w"):
        assert np.array_equal(np.asarray(getattr(jp.union, attr)),
                              getattr(tp.union, attr).numpy()), attr
    for attr in ("node_offsets", "edge_offsets", "node_gid", "edge_gid"):
        assert np.array_equal(getattr(jp, attr), getattr(tp, attr)), attr
    rng = np.random.default_rng(4)
    parts = [rng.integers(0, 4, g.n).astype(np.int32) for g in tg]
    labels = np.concatenate(parts)
    for a, b in zip(jbatch.unpack_partition(labels, jp.node_offsets),
                    unpack_partition(labels, tp.node_offsets)):
        assert np.array_equal(a, b)
    jc, jb = jbatch.batched_metrics(jp, parts, 4, pad_to=8)
    tc, tb = batched_metrics(tp, parts, 4, pad_to=8)
    assert np.array_equal(np.asarray(jc), tc) and np.array_equal(np.asarray(jb), tb)
    for g, p, cut in zip(tg, parts, tc):
        assert cut == metrics.edge_cut(g, p)


def test_queue_admission_order_and_form_batches():
    q = BoundedServeQueue(bound=2)
    q.put(_Item(("a",)))
    q.put(_Item(("b",)))
    with pytest.raises(QueueFullError):
        q.put(_Item(("c",)))
    assert [i.cell for i in q.pop_batch(max_batch=4, window_s=0.0)] == [("a",)]
    q.close()
    with pytest.raises(EngineStoppedError):
        q.put(_Item(("d",)))
    assert q.pop_batch(4)[0].cell == ("b",)
    assert q.pop_batch(4) is None
    items = [_Item(("a",)), _Item(("b",)), _Item(("a",)), _Item(("c",))]
    assert [[i.cell for i in b] for b in form_batches(items, 4)] == \
        [[i.cell for i in b] for b in jbatch.form_batches(items, 4)]


# -- the engine's lifecycle and admission ------------------------------------


def test_engine_queue_full_deadline_cancel_and_drain():
    eng = PartitionEngine("serve", **dict(SMALL, queue_bound=2))
    eng.pause()
    eng.start(warmup=False)
    try:
        late = eng.submit(_rmat(40), 4, deadline_ms=10)
        gone = eng.submit(_rmat(41), 4)
        with pytest.raises(QueueFullError) as exc:
            eng.submit(_rmat(42), 4)
        assert exc.value.retry_after_s > 0
        assert gone.cancel()
        time.sleep(0.05)
        eng.resume()
        with pytest.raises(DeadlineExceededError):
            late.result(timeout=60)
        with pytest.raises(RequestCancelledError):
            gone.result(timeout=60)
        snap = eng.stats()
        assert (snap["rejected_full"], snap["timed_out"], snap["cancelled"]) == (1, 1, 1)
    finally:
        eng.shutdown(drain=True)
    assert not eng.running
    with pytest.raises(EngineStoppedError):
        eng.submit(_rmat(1), 4)

    eng = PartitionEngine("serve", **SMALL)
    eng.pause()
    eng.start(warmup=False)
    futs = [eng.submit(_rmat(20 + i), 4) for i in range(2)]
    eng.shutdown(drain=False, timeout_s=30)
    for f in futs:
        with pytest.raises(EngineStoppedError):
            f.result(timeout=30)


def test_engine_warmup_serves_and_facade_delegates():
    eng = PartitionEngine("serve", warm_ladder=(256,), warm_ks=(4,), max_batch=4,
                          queue_bound=8, lane_stack="off", device="cpu")
    eng.start(warmup=True)
    try:
        row = eng.warmup_report[0]
        assert row["k"] == 4 and row["builds"] == 0 and row["wall_s"] > 0
        graphs = [_rmat(10 + i) for i in range(3)]
        results = [f.result(timeout=300) for f in [eng.submit(g, 4) for g in graphs]]
        for g, res in zip(graphs, results):
            assert res.partition.shape == (g.n,) and res.feasible
            assert res.cut == metrics.edge_cut(g, res.partition)
        snap = eng.stats()
        assert snap["completed"] == 3 and snap["warm_hits"] == 3
        assert "collective_count" not in snap
        solver = KaMinPar("serve", engine=eng)
        solver.set_graph(graphs[0])
        assert np.array_equal(solver.compute_partition(4), results[0].partition)
    finally:
        eng.shutdown(drain=True)


# -- served partitions: the port's sequential runs and JAX's cuts ------------


def _serve(graphs, k, **kw):
    eng = PartitionEngine("serve", **dict(SMALL, max_batch=8, **kw))
    eng.pause()
    eng.start(warmup=False)
    try:
        futs = [eng.submit(g, k) for g in graphs]
        eng.resume()
        return [f.result(timeout=600) for f in futs], eng.stats()
    finally:
        eng.shutdown(drain=True)


@pytest.mark.parametrize("lane_stack", ["auto", "off"])
def test_served_partitions_equal_sequential_runs(lane_stack):
    graphs = [_rmat(100 + s, 9) for s in range(3)] + [tgen.grid2d_graph(20, 20)]
    results, stats = _serve(graphs, 4, lane_stack=lane_stack)
    if lane_stack == "auto":
        assert stats["lanestacked_batches"] >= 1 and stats["lanestack_fallbacks"] == 0
    else:
        assert stats["lanestacked_batches"] == 0
    for g, res in zip(graphs, results):
        solo = KaMinPar("serve", device="cpu")
        solo.set_graph(g)
        assert np.array_equal(res.partition, solo.compute_partition(4, 0.03))


def test_served_cuts_within_jax_sequential_cuts():
    """Each served cut (lane-stacked) is at most 1.2x the JAX package's
    sequential serve cut on the same graph."""
    pairs = [(jgen.rmat_graph(10, 8, seed=s), tgen.rmat_graph(10, 8, seed=s)) for s in (3, 4)]
    results, stats = _serve([p[1] for p in pairs], 8)
    assert stats["lanestacked_batches"] == 1
    for (jg, tg), res in zip(pairs, results):
        ref = JKaMinPar("serve")
        ref.set_graph(jg)
        jcut = metrics.edge_cut(tg, np.asarray(ref.compute_partition(8, 0.03)))
        assert res.feasible and res.cut <= 1.2 * jcut, (res.cut, jcut)


# -- the journal --------------------------------------------------------------


def test_journal_records_equal_jax(tmp_path):
    jg, tg = pair("rmat", 9)
    assert tjournal.encode_graph(tg) == jjournal.encode_graph(jg)
    back = tjournal.decode_graph(tjournal.encode_graph(tg))
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w"):
        assert torch.equal(getattr(back, attr), getattr(tg, attr))
    # the same admit/resolve/warm-state lines parse to the same recovery view
    path = tmp_path / "j.jsonl"
    lines = [{"t": "admit", "id": i, "k": 4, "epsilon": 0.03, "graph": {}} for i in (1, 2, 3)]
    lines += [{"t": "resolve", "id": 2, "ok": 1, "cut": 5, "feasible": 1},
              {"t": "warm_state", "warmup_report": [], "warm_cells": [[256, 1024, 4]]}]
    path.write_text("\n".join(json.dumps(x) for x in lines) + "\n{\"t\": \"adm")
    assert tjournal.read_journal(str(path)) == jjournal.read_journal(str(path))


def test_truncated_journal_replays_each_unresolved_entry_once(tmp_path):
    path = tmp_path / "serve.jsonl"
    e1 = PartitionEngine("serve", journal_path=str(path), **SMALL)
    e1.start(warmup=False)
    e1.pause()
    graphs = [_rmat(50 + i, 7) for i in range(4)]
    for g in graphs:
        e1.submit(g, 4)
    e1.shutdown(drain=False)  # "given back": the admits stay unresolved
    with open(path, "a") as f:
        f.write('{"t": "resolve", "id": ')  # a kill mid-append
    view = tjournal.read_journal(str(path))
    assert view["admits"] == 4 and len(view["unresolved"]) == 4 and view["torn"] == 1

    e2 = PartitionEngine("serve", journal_path=str(path), **SMALL)
    e2.start(warmup=False)
    try:
        deadline = time.monotonic() + 120
        while tjournal.read_journal(str(path))["unresolved"] and time.monotonic() < deadline:
            time.sleep(0.05)
        view = tjournal.read_journal(str(path))
        assert not view["unresolved"]
        assert len(view["resolved"]) == 4 and all(c == 1 for c in view["resolved"].values())
    finally:
        e2.shutdown(drain=True)
    stats = e2.stats()
    assert stats["journal_replayed"] == 4 and stats["journal_resolutions"] == 4


# -- the serve CLI --------------------------------------------------------------


def test_serve_cli_demo_on_cpu(capsys, tmp_path):
    trace = tmp_path / "serve.trace.json"
    rc = serve_cli.main(["--device", "cpu", "--demo", "4", "--ladder", "256", "--warm-ks",
                         "4", "-k", "4", "--max-batch", "4", "--trace-out", str(trace)])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["completed"] == 4
    from kaminpar_tpu_torch.telemetry import validate_chrome_trace

    assert validate_chrome_trace(json.loads(trace.read_text()))["spans"] > 0
