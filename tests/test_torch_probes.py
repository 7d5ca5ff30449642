"""Port parity of the per-level quality probes
(``kaminpar_tpu_torch/telemetry/probes.py``) and their call sites, on the
CPU, against the JAX package.

- Both packages contract the same host clustering: their ``contraction``
  counter samples and the coarseners' ``coarsening_level`` rows are equal.
- ``pull_partition_with_quality`` returns the JAX package's partition,
  cut and maximum block weight on the same graph and partition, in one
  readback, and writes an equal ``level_quality`` row.
- The overload balancer and the colored LP refiner fed the JAX package's
  draws write equal ``refinement_round`` rows (CLP's with the cut packed
  into its moved-count pull); the LP refiner's pass row is equal.
- A probe adds no readback: with a trace armed, each scheme's partition
  is bit-identical to the unarmed run and every phase's pull count is
  unchanged.
- The CLI's ``--trace-out`` carries the JAX CLI's quality row kinds on
  the same file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu import cli as jcli
from kaminpar_tpu import telemetry as jtelemetry
from kaminpar_tpu.coarsening.cluster_coarsener import ClusterCoarsener as JaxCoarsener
from kaminpar_tpu.graph.partitioned import PartitionedGraph as JaxPartitionedGraph
from kaminpar_tpu.ops import contraction as jcontraction
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.context import ColoredLPContext as JaxCLPContext
from kaminpar_tpu.refinement import balancer as jbal
from kaminpar_tpu.refinement import clp_refiner as jclp
from kaminpar_tpu.refinement.lp_refiner import LPRefiner as JaxLPRefiner
from kaminpar_tpu.telemetry import probes as jprobes
from kaminpar_tpu.utils import Logger as JLogger
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch import KaMinPar, cli, telemetry
from kaminpar_tpu_torch import io as kio
from kaminpar_tpu_torch.coarsening.cluster_coarsener import ClusterCoarsener
from kaminpar_tpu_torch.context import ColoredLPContext, RefinementAlgorithm
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
from kaminpar_tpu_torch.ops import coloring as tcol
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops.contraction import contract_clustering
from kaminpar_tpu_torch.presets import create_context_by_preset_name
from kaminpar_tpu_torch.refinement import balancer as tbal
from kaminpar_tpu_torch.refinement import clp_refiner as tclp
from kaminpar_tpu_torch.refinement.lp_refiner import LPRefiner
from kaminpar_tpu_torch.telemetry import probes
from kaminpar_tpu_torch.utils import Logger, sync_stats
from test_torch_lp_kernels import graph_pair, jax_round_draws, jax_ties, t
from test_torch_refiners import jax_prio


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends (each holds
    memory mappings; see test_torch_lp_kernels.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (see
    test_torch_refiners.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _keep_log_levels():
    levels = Logger.level, JLogger.level
    yield
    Logger.level, JLogger.level = levels


def _rows(rec, kind):
    return [{key: val for key, val in row.items() if key != "t_us"}
            for row in rec.quality if row["kind"] == kind]


def _counters(rec, name):
    return [ev["args"] for ev in rec.chrome_trace()["traceEvents"]
            if ev.get("ph") == "C" and ev["name"] == name]


def _pair_clustering(n_pad, n, anchor, seed=5):
    """A host clustering over the padded node space: random pairs and
    singletons, pads in the anchor's cluster."""
    rng = np.random.default_rng(seed)
    labels = np.arange(n_pad, dtype=np.int32)
    perm = rng.permutation(n)
    half = (n // 2) // 2 * 2
    labels[perm[1:half:2]] = perm[0:half:2]
    labels[n:] = anchor
    return labels


@pytest.mark.parametrize("name", ["rmat", "hub", "grid"])
def test_contraction_and_coarsening_rows_match_jax(name, monkeypatch):
    jg, tg = graph_pair(name)
    pv = jg.padded()
    labels = _pair_clustering(pv.n_pad, pv.n, pv.anchor)
    with jtelemetry.run() as jrec:
        jcontraction.contract_clustering(jg, jnp.asarray(labels))
    with telemetry.run() as trec:
        contract_clustering(tg, torch.from_numpy(labels))
    assert _counters(trec, "contraction") == _counters(jrec, "contraction")

    # the coarseners' level rows, both clusterers handing out the labels
    jc, tc = JaxCoarsener(jax_preset("default"), jg), ClusterCoarsener(
        create_context_by_preset_name("default"), tg)
    monkeypatch.setattr(jc.clusterer, "compute_clustering", lambda *a: jnp.asarray(labels))
    monkeypatch.setattr(tc.clusterer, "compute_clustering", lambda *a: torch.from_numpy(labels))
    with jtelemetry.run() as jrec:
        jc.coarsen_once(8, 0.03)
    with telemetry.run() as trec:
        tc.coarsen_once(8, 0.03)
    rows = _rows(trec, "coarsening_level")
    assert len(rows) == 1 and rows == _rows(jrec, "coarsening_level")
    assert rows[0]["total_edge_weight"] is not None and rows[0]["lp_moved"] is None


def test_coarsening_row_carries_the_lp_moved_count():
    tg = tgen.rmat_graph(10, 8, seed=2)
    coarsener = ClusterCoarsener(create_context_by_preset_name("default"), tg)
    sync_stats.reset()
    with telemetry.run() as rec:
        assert coarsener.coarsen_once(8, 0.03)
    (row,) = _rows(rec, "coarsening_level")
    assert row["lp_moved"] is not None and row["lp_rounds_budget"] == 5
    assert row["n_c"] == coarsener.current_graph.n
    assert row["total_edge_weight"] == int(coarsener.current_graph.edge_w.sum())
    assert sync_stats.phase_count("coarsening") == 1  # still one readback


def test_community_masked_graph_recounts_its_edge_weight():
    """The contraction caches a coarse graph's total edge weight; a
    community-masked copy (the v-cycle's and extension's clusterer input)
    zeroes the cross-community edges and must not inherit that total."""
    tg = tgen.rmat_graph(10, 8, seed=2)
    coarse = ClusterCoarsener(create_context_by_preset_name("default"), tg)
    assert coarse.coarsen_once(8, 0.03)
    g = coarse.current_graph
    assert g._total_edge_weight == int(g.edge_w.sum())
    comm = torch.from_numpy((np.arange(g.n) % 3).astype(np.int32))
    masked = g.community_masked(comm)
    assert masked.total_edge_weight == int(masked.edge_w.sum()) < g.total_edge_weight


@pytest.mark.parametrize("name,k", [("rmat", 8), ("grid", 4), ("hub", 16)])
def test_pull_partition_with_quality_matches_jax(name, k):
    jg, tg = graph_pair(name)
    part = np.random.default_rng(3).integers(0, k, jg.n).astype(np.int32)
    bw = np.full(k, jg.total_node_weight)
    tg._total_node_weight = int(jg.total_node_weight)
    jp = JaxPartitionedGraph.create(jg, k, part, bw)
    tp = PartitionedGraph.create(tg, k, part, bw)
    with jtelemetry.run() as jrec:
        jhost = jprobes.pull_partition_with_quality(jp, level=2)
    sync_stats.reset()
    with telemetry.run() as trec:
        thost = probes.pull_partition_with_quality(tp, level=2)
    assert sync_stats.snapshot()["count"] == 1
    assert np.array_equal(thost, np.asarray(jhost)) and np.array_equal(thost, part)
    rows = _rows(trec, "level_quality")
    assert rows == _rows(jrec, "level_quality")
    assert rows[0]["cut"] == int(tp.edge_cut())
    assert rows[0]["max_block_weight"] == int(tp.block_weights().max())
    # unarmed: the plain pull, same partition
    assert np.array_equal(probes.pull_partition_with_quality(tp, level=2), part)


def _balance_draws(key, jbv, n_pad):
    """An overload round's draws from its key (``_balance_round`` splits
    it three ways: rating ties from the first, gain jitter from the
    second)."""
    from kaminpar_tpu_torch.refinement.balancer import BalanceDraws

    kb, ks = jax.random.split(key, 3)[:2]
    ties, heavy = jax_ties(kb, jbv)
    return BalanceDraws(ties, heavy,
                        t(jax.random.uniform(ks, (n_pad,), minval=0.0, maxval=1e-3)))


@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_refiner_rows_match_jax_draws(name, monkeypatch):
    jg, tg = graph_pair(name)
    k = 8
    rng = np.random.default_rng(4)
    part = np.where(rng.random(jg.n) < 0.4, 0, rng.integers(1, k, jg.n)).astype(np.int32)
    max_bw = np.full(k, int(jg.total_node_weight / k * 1.03) + 1)
    keys = []

    def recording_key():
        keys.append(next_key())
        return keys[-1]

    monkeypatch.setattr(jbal, "next_key", recording_key)
    jbv = jg.bucketed()
    n_pad = jg.padded().n_pad
    calls = iter(range(1000))
    monkeypatch.setattr(tbal, "draw_balance_round",
                        lambda gen, bv, n: _balance_draws(keys[next(calls)], jbv, n_pad))
    jctx, tctx = jax_preset("default"), create_context_by_preset_name("default")
    with jtelemetry.run() as jrec:
        jout = jbal.OverloadBalancer(jctx.refinement.balancer).refine(
            JaxPartitionedGraph.create(jg, k, part, max_bw))
        JaxLPRefiner(jctx.refinement.lp).refine(jout)
    with telemetry.run() as trec:
        tout = tbal.OverloadBalancer(tctx.refinement.balancer).refine(
            PartitionedGraph.create(tg, k, part, max_bw))
        LPRefiner(tctx.refinement.lp).refine(tout)
    rows = _rows(trec, "overload_balancer")
    assert rows and rows == _rows(jrec, "overload_balancer")
    assert sum(r["moved"] for r in rows) > 0
    assert np.array_equal(tout.partition.numpy(), np.asarray(jout.partition))
    assert _rows(trec, "lp_refinement") == _rows(jrec, "lp_refinement")


@pytest.mark.parametrize("name", ["grid", "rmat"])
def test_clp_round_rows_match_jax_draws(name, monkeypatch):
    """The colored LP refiner fed the JAX package's colouring priorities
    and round draws: each iteration's ``clp_refinement`` row (moved count
    and cut, packed into the iteration's one pull) equals the JAX row, and
    so does the refined partition."""
    jg, tg = graph_pair(name)
    k = 4
    rng = np.random.default_rng(6)
    part = np.minimum(np.arange(jg.n) * k // jg.n, k - 1).astype(np.int32)
    noisy = rng.random(jg.n) < 0.2
    part[noisy] = rng.integers(0, k, int(noisy.sum()))
    max_bw = np.maximum(np.full(k, int(jg.total_node_weight / k * 1.05) + 1),
                        np.bincount(part, minlength=k))
    keys = []

    def recording_key():
        keys.append(next_key())
        return keys[-1]

    monkeypatch.setattr(jclp, "next_key", recording_key)
    with jtelemetry.run() as jrec:
        jout = jclp.CLPRefiner(JaxCLPContext()).refine(
            JaxPartitionedGraph.create(jg, k, part, max_bw))
    jbv, n_pad = jg.bucketed(), jg.padded().n_pad
    rounds = iter(range(1, 10_000))
    monkeypatch.setattr(tclp, "color_graph", lambda prio, *a, **kw: tcol.color_graph(
        jax_prio(keys[0], n_pad), *a, **kw))
    monkeypatch.setattr(tlp, "draw_lp_round", lambda gen, bv, n, **kw: jax_round_draws(
        keys[next(rounds)], jbv, n_pad, **kw))
    with telemetry.run() as trec:
        tout = tclp.CLPRefiner(ColoredLPContext()).refine(
            PartitionedGraph.create(tg, k, part, max_bw))
    rows = _rows(trec, "clp_refinement")
    assert rows and rows == _rows(jrec, "clp_refinement")
    assert np.array_equal(tout.partition.numpy(), np.asarray(jout.partition))


def _configure(ctx, scheme):
    ctx.coarsening.contraction_limit = 60
    if scheme == "clp":
        ctx.refinement.algorithms = (RefinementAlgorithm.OVERLOAD_BALANCER,
                                     RefinementAlgorithm.CLP)
    return ctx


@pytest.mark.parametrize("scheme", ["default", "kway", "clp"])
def test_probes_add_no_readback_and_change_nothing(scheme):
    k = 4 if scheme == "kway" else 8  # k-way coarsens down to C x k nodes

    def run(armed):
        graph = tgen.rmat_graph(10, 8, seed=1)
        preset = "kway" if scheme == "kway" else "default"
        solver = KaMinPar(_configure(create_context_by_preset_name(preset), scheme),
                          device="cpu")
        solver.set_graph(graph)
        sync_stats.reset()
        sync_stats.enable_budget_checks(True)
        try:
            if armed:
                with telemetry.run() as rec:
                    part = solver.compute_partition(k)
            else:
                rec, part = None, solver.compute_partition(k)
        finally:
            sync_stats.enable_budget_checks(False)
        pulls = {ph: row["count"] for ph, row in sync_stats.snapshot()["phases"].items()}
        return part, pulls, rec

    plain, plain_pulls, _ = run(False)
    armed, armed_pulls, rec = run(True)
    assert np.array_equal(plain, armed)
    assert armed_pulls == plain_pulls
    kinds = {row["kind"] for row in rec.quality}
    want = {"default": {"coarsening_level", "level_quality", "lp_refinement"},
            "kway": {"coarsening_level", "kway_level", "lp_refinement"},
            "clp": {"coarsening_level", "level_quality", "clp_refinement"}}[scheme]
    assert want <= kinds, kinds


def test_cli_trace_quality_rows_match_jax(tmp_path):
    graph_file, cfg = tmp_path / "g.metis", tmp_path / "c.toml"
    kio.write_graph(tgen.rmat_graph(9, 8, seed=1), str(graph_file))
    cfg.write_text("seed = 3\n[coarsening]\ncontraction_limit = 60\n")
    traces = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        out = tmp_path / f"{name}.json"
        assert main([str(graph_file), "16", "-q", "-C", str(cfg), "--trace-out", str(out),
                     *extra]) == 0
        traces[name] = json.loads(out.read_text())
    kinds = {name: {row["kind"] for row in tr["otherData"]["quality"]}
             for name, tr in traces.items()}
    assert kinds["port"] == kinds["jax"], kinds
    assert {"coarsening_level", "level_quality"} <= kinds["port"]
    telemetry.validate_chrome_trace(traces["port"])
    jtelemetry.validate_chrome_trace(traces["port"])
