"""Port parity of the timing and readback accounting: the timer tree, the
readback census with its budgets and tripwire, the heap profiler and the
run trace (``kaminpar_tpu_torch/utils/{timer,sync_stats,heap_profiler}.py``,
``kaminpar_tpu_torch/telemetry/``), against the JAX package's modules.

- One scripted scope sequence runs through both packages' modules: the
  tree's paths and starts, the TIME line's keys, the per-phase counts, the
  heap profiler's scope tree, the trace's spans and the budget errors'
  messages are equal.
- ``default``, ``terapart`` and ``kway`` run once in each package on the
  same graph (a lowered contraction limit, so that both coarsen): the sets
  of timer-tree paths are equal.  Whole-pipeline draws differ between the
  packages, so the port's runs are held to invariants, not to JAX's
  counts: its "coarsening" readbacks equal its contractions, its armed
  budgets pass, and on ``default`` the tripwire counts no implicit pull in
  coarsening, initial partitioning and uncoarsening.  Its Chrome trace
  passes both packages' validators.
- ``terapart`` with HEM coarsening decompresses its input and runs; its
  cut is held to 1.2x the JAX package's at one matched seed, as the other
  whole-pipeline tests hold theirs.
"""

import re
import warnings
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu import telemetry as jtelemetry
from kaminpar_tpu.context import ClusteringAlgorithm as JCA
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.utils import heap_profiler as jheap
from kaminpar_tpu.utils import sync_stats as jsync
from kaminpar_tpu.utils import timer as jtimer
import kaminpar_tpu_torch as kp
from kaminpar_tpu_torch import telemetry
from kaminpar_tpu_torch.context import ClusteringAlgorithm as TCA
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.telemetry import phases
from kaminpar_tpu_torch.utils import heap_profiler, sync_stats, timer

PACKAGES = {
    "jax": SimpleNamespace(timer=jtimer, sync=jsync, heap=jheap, trace=jtelemetry.trace,
                           array=jnp.asarray),
    "port": SimpleNamespace(timer=timer, sync=sync_stats, heap=heap_profiler,
                            trace=telemetry.trace, array=torch.from_numpy),
}
PRESETS = ("default", "terapart", "kway")
GRAPH = "grid2d_graph(24, 24)"
K = 4
CONTRACTION_LIMIT = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (see
    test_torch_refiners.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    yield
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _clean_state():
    """Both packages' counters, budget switches and heap profilers as a run
    outside this module finds them."""
    yield
    for pkg in PACKAGES.values():
        pkg.sync.reset()
        pkg.sync.enable_budget_checks(False)
        pkg.heap.HeapProfiler.reset(enabled=False)


def tree(t) -> dict:
    """{path: starts} of a timer's merged tree."""
    out = {}

    def walk(node, prefix):
        for child in node.children.values():
            path = prefix + child.name
            out[path] = child.starts
            walk(child, path + ".")

    walk(t.merged_root(), "")
    return out


def time_keys(t) -> set:
    line = t.machine_readable()
    assert line.startswith("TIME ")
    return {part.split("=")[0] for part in line[5:].split()}


def heap_tree(heap) -> list:
    out = []

    def walk(node, depth):
        for ch in node.children:
            out.append((depth, ch.name))
            walk(ch, depth + 1)

    walk(heap.HeapProfiler._root, 0)
    return out


def scripted_run(pkg) -> dict:
    """One scope sequence through a package's timer, sync accounting, heap
    profiler and trace."""
    pkg.timer.Timer.reset_global()
    pkg.sync.reset()
    pkg.heap.HeapProfiler.reset(enabled=True)
    st = pkg.timer.scoped_timer
    x = pkg.array(np.arange(16, dtype=np.int32))
    with pkg.trace.run() as rec:
        with st("partitioning"):
            for _ in range(2):
                with st("coarsening"):
                    with st("lp_clustering", sync=True) as ts:
                        pkg.sync.pull(x)
                        ts.note(x)
                    pkg.sync.pull(x, x)
            with st("initial_partitioning"):
                host = pkg.sync.pull(x, phase="extend_partition")
            with st("uncoarsening", sync=True) as ts:
                ts.note(x)
        with pkg.sync.tripwire():
            with st("lp_refinement"):
                assert int(x[3]) == 3 and float(x[3]) == 3.0 and bool(x[3] > 0)
        with pkg.sync.scoped("extend_partition"):
            pkg.sync.pull(x, shards=4)
    int(x[3])  # the tripwire is off again: not counted
    snap = pkg.sync.snapshot()
    errors = []
    pkg.sync.enable_budget_checks(True)
    for args in ((("coarsening", 3), {}), (("extend_partition", 0), {"shards": 4}),
                 (("extend_partition", 1), {"shards": 4})):
        try:
            pkg.sync.assert_phase_budget(*args[0], **args[1])
        except AssertionError as exc:
            errors.append(str(exc))
    pkg.sync.assert_phase_budget("coarsening", 4)
    obj = rec.chrome_trace()
    return dict(
        tree=tree(pkg.timer.Timer.global_()),
        time_keys=time_keys(pkg.timer.Timer.global_()),
        phases={ph: {key: row[key] for key in ("count", "bytes", "implicit",
                                               "implicit_bytes", "shard_pulls",
                                               "sharded_count")}
                for ph, row in snap["phases"].items()},
        host=np.asarray(host),
        errors=errors,
        heap=heap_tree(pkg.heap),
        spans=[(ev["ph"], ev["name"]) for ev in obj["traceEvents"] if ev["ph"] in "BE"],
        host_sync_samples=sum(1 for ev in obj["traceEvents"]
                              if ev["ph"] == "C" and ev["name"] == "host_sync"),
        validated=pkg.trace.validate_chrome_trace(obj),
    )


def test_scripted_scopes_match_jax():
    ref, port = scripted_run(PACKAGES["jax"]), scripted_run(PACKAGES["port"])
    assert port["tree"] == ref["tree"]
    assert port["tree"]["partitioning.coarsening.lp_clustering"] == 2
    assert port["time_keys"] == ref["time_keys"]
    assert port["phases"] == ref["phases"]
    assert port["phases"]["lp_refinement"]["implicit"] == 3
    assert np.array_equal(port["host"], ref["host"])
    assert port["errors"] == ref["errors"] and len(port["errors"]) == 3
    assert port["heap"] == ref["heap"]
    assert port["spans"] == ref["spans"]
    assert port["host_sync_samples"] == ref["host_sync_samples"] == 11
    assert port["validated"]["span_names"] == ref["validated"]["span_names"]


def test_timer_disable_nests_and_threads_merge():
    """disable()/enable() nest as a depth counter, and another thread's
    scopes merge into the report as top-level phases."""
    import threading

    timer.Timer.reset_global()
    t = timer.Timer.global_()
    t.disable()
    t.disable()
    t.enable()
    with timer.scoped_timer("coarsening"):
        pass
    t.enable()

    def in_worker():
        with timer.scoped_timer("coarsening"):
            pass

    worker = threading.Thread(target=in_worker)
    with timer.scoped_timer("coarsening"):
        assert t.current_path() == ("coarsening",)
    worker.start()
    worker.join()
    assert tree(t) == {"coarsening": 2}
    assert t.phase_seconds("coarsening") >= 0.0 and t.phase_seconds("uncoarsening") is None
    assert "coarsening" in t.render()


def test_trace_validator_rejects_malformed_traces():
    good = {"traceEvents": [{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 0},
                            {"name": "a", "ph": "E", "ts": 1, "pid": 1, "tid": 0}]}
    assert telemetry.validate_chrome_trace(good)["spans"] == 1
    for events in ([{"name": "a", "ph": "E", "ts": 0, "pid": 1, "tid": 0}],
                   [{"name": "a", "ph": "B", "ts": 0, "pid": 1, "tid": 0}],
                   [{"name": "a", "ph": "C", "ts": 0, "pid": 1, "tid": 0,
                     "args": {"x": "y"}}]):
        for validate in (telemetry.validate_chrome_trace, jtelemetry.validate_chrome_trace):
            with pytest.raises(ValueError):
                validate({"traceEvents": events})


_PHASE_LITERAL_PATTERNS = (
    re.compile(r'scoped_timer\(\s*"([a-z_]+)"'),
    re.compile(r'sync_stats\.scoped\(\s*"([a-z_]+)"'),
    re.compile(r'assert_phase_budget\(\s*"([a-z_]+)"'),
    re.compile(r'phase_count\(\s*"([a-z_]+)"'),
    re.compile(r'phase="([a-z_]+)"'),
)


def test_phase_registry_matches_port_source():
    """Every phase literal of the port is registered, every registered
    phase is used, and every one bears the JAX package's name."""
    root = Path(kp.__file__).parent
    found = set()
    for path in root.rglob("*.py"):
        for pattern in _PHASE_LITERAL_PATTERNS:
            found.update(pattern.findall(path.read_text()))
    assert found <= phases.KNOWN_PHASES, found - phases.KNOWN_PHASES
    assert phases.KNOWN_PHASES - {"untracked"} <= found
    assert phases.KNOWN_PHASES <= jtelemetry.phases.KNOWN_PHASES


def test_unknown_phase_warns_once():
    phases._warned.discard("zz_not_a_phase")
    with pytest.warns(RuntimeWarning, match="phase registry"):
        with timer.scoped_timer("zz_not_a_phase"):
            pass
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with timer.scoped_timer("zz_not_a_phase"):
            pass


def test_heap_watermark_report_on_the_cpu():
    report = heap_profiler.watermark_report()
    assert report["backend"] == "cpu_rss_proxy"
    assert report["rss_bytes"] > 0 and report["peak_rss_bytes"] > 0
    keep = torch.zeros(1 << 20, dtype=torch.uint8)
    assert heap_profiler.live_array_bytes() >= keep.numel()
    heap_profiler.HeapProfiler.reset(enabled=True)
    with timer.scoped_timer("coarsening"):
        pass
    assert "coarsening: entry=" in heap_profiler.HeapProfiler.report()


def test_pull_returns_host_arrays_and_counts_bytes():
    x = torch.arange(6, dtype=torch.int64)
    with sync_stats.scoped("coarsening"):
        a, b = sync_stats.pull(x, x[:2])
        sync_stats.record_transfer(100, count=2)
    assert isinstance(a, np.ndarray) and a.tolist() == list(range(6)) and len(b) == 2
    snap = sync_stats.snapshot()
    assert snap["phases"]["coarsening"]["count"] == 4
    assert snap["phases"]["coarsening"]["bytes"] == 48 + 16 + 100
    assert snap["device_syncs"] == {}
    assert sync_stats.active_phase() == "untracked"


def jax_solver(preset: str, seed: int = 1, algorithm=None):
    s = JaxKaMinPar(preset)
    s.ctx.seed = seed
    s.ctx.coarsening.contraction_limit = CONTRACTION_LIMIT
    s.ctx.initial_partitioning.ip_backend = "host"
    if algorithm is not None:
        s.ctx.coarsening.algorithm = algorithm
        s.ctx.coarsening.convergence_threshold = 0.01
    s.set_graph(eval("jgen." + GRAPH))
    return s


def port_solver(preset: str, seed: int = 1, algorithm=None):
    s = kp.KaMinPar(preset, device="cpu")
    s.ctx.seed = seed
    s.ctx.coarsening.contraction_limit = CONTRACTION_LIMIT
    if algorithm is not None:
        s.ctx.coarsening.algorithm = algorithm
        s.ctx.coarsening.convergence_threshold = 0.01
    s.set_graph(eval("tgen." + GRAPH))
    return s


def test_pipelines_match_jax_tree_and_budgets():
    """Each preset once in each package, the port's runs with armed
    budgets, under the tripwire and a trace.  One test for the three
    presets: the JAX package's first pipeline in a process compiles for
    most of its 20-30 s, and the tests of one module spread over the
    suite's workers, so a fixture shared by several tests would compile
    once a worker."""
    for preset in PRESETS:
        jtimer.Timer.reset_global()
        jax_solver(preset).compute_partition(K)
        ref_tree = tree(jtimer.Timer.global_())
        sync_stats.reset()
        sync_stats.enable_budget_checks(True)
        solver = port_solver(preset)
        try:
            with telemetry.run() as rec, sync_stats.tripwire():
                solver.compute_partition(K)
        finally:
            sync_stats.enable_budget_checks(False)
        got = tree(timer.Timer.global_())
        snap = sync_stats.snapshot()["phases"]

        # the same timer-tree paths; the TIME line names each of them
        assert set(got) == set(ref_tree), (preset, got, ref_tree)
        assert "partitioning.coarsening.lp_clustering" in got
        line = timer.Timer.global_().machine_readable()
        assert {part.split("=")[0] for part in line[5:].split()} == set(got)

        # one pull a contraction, nothing implicit where JAX has nothing
        scheme = solver.last_partitioner
        assert scheme.num_levels >= 1 and scheme.contractions >= scheme.num_levels
        assert scheme.coarsening_pulls == scheme.contractions
        assert snap["coarsening"]["count"] == scheme.contractions
        assert got["partitioning.coarsening"] == scheme.contractions
        assert 0 < scheme.phase_seconds["coarsening"] < scheme.phase_seconds["partitioning"]
        if preset == "default":
            assert "partitioning.uncoarsening" in got
            for phase in ("coarsening", "initial_partitioning", "uncoarsening"):
                # a phase that pulled nothing has no row
                assert snap.get(phase, {"implicit": 0})["implicit"] == 0, (phase, snap)

        # the port's Chrome trace passes both packages' validators
        obj = rec.chrome_trace()
        ours = telemetry.validate_chrome_trace(obj)
        assert ours == jtelemetry.validate_chrome_trace(obj)
        assert {"partitioning", "coarsening", "lp_clustering"} <= set(ours["span_names"])
        assert "host_sync" in ours["counter_names"]


def test_terapart_with_hem_decompresses_and_matches_jax_quality():
    """With a compressed input and HEM coarsening the port decompresses the
    input onto its device and runs the dense path (it used to raise)."""
    jsolver = jax_solver("terapart", algorithm=JCA.HEM)
    jpart = np.asarray(jsolver.compute_partition(K))
    jg = jsolver.graph if jsolver.graph is not None else eval("jgen." + GRAPH)
    jcut = int(jmetrics.edge_cut(jg, jpart))
    tsolver = port_solver("terapart", algorithm=TCA.HEM)
    assert tsolver.compressed_graph is not None
    tpart = tsolver.compute_partition(K)
    scheme = tsolver.last_partitioner
    assert scheme.compressed_view is None and scheme.num_levels >= 2
    assert tsolver.last_partition.is_feasible() and len(np.unique(tpart)) == K
    tcut = int(tsolver.last_partition.edge_cut())
    print(f"terapart + HEM: JAX cut {jcut}, port cut {tcut}")
    assert tcut <= 1.2 * jcut, (tcut, jcut)
