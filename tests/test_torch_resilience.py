"""Port parity of the resilience layer (``kaminpar_tpu_torch/resilience/``)
against the JAX package's, on the CPU.

- Fault plans: the same strings are accepted or rejected alike by both
  packages' ``FaultPlan.parse``; the seeded coin decides alike for the
  same (seed, spec, hit) (both hash with the standard library).
- ``classify`` gives both packages' classes for the JAX tests'
  exceptions, and the port's documented classes for torch's and the
  card's exceptions.
- The input guard raises ``GraphValidationError`` (class, ``site`` and
  message the JAX package's) for every malformed input the JAX guard
  rejects.
- Injected faults at the main path's points (``readback`` in ``pull``,
  ``execute`` at the LP dispatch, the device pool and the decode gate,
  ``compile`` at a padded bucket) raise their typed error and stop the
  run: no breaker records a demotion.
- Breakers: the state machine of the JAX tests that needs no engine and
  no ``lp_pallas`` rung; the ladder has no kernel, pool or decode rung.
- The watchdog times out a sleeping block, and its dossier names the
  phase from the board; the flight recorder's heartbeat and dossier name
  the phase a process was in.
"""

import json
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from kaminpar_tpu.graph import csr as jcsr
from kaminpar_tpu.resilience import errors as jerrors
from kaminpar_tpu.resilience import faults as jfaults
from kaminpar_tpu.telemetry import flight_recorder as jflight
from kaminpar_tpu_torch import KaMinPar
from kaminpar_tpu_torch.graph import csr as tcsr
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.resilience import breakers, errors, faults
from kaminpar_tpu_torch.resilience.breakers import BreakerRegistry, CircuitBreaker
from kaminpar_tpu_torch.resilience.errors import (CapacityExceeded, CompileTimeout,
                                                  ExecuteFault, GraphValidationError,
                                                  classify)
from kaminpar_tpu_torch.resilience.faults import FaultPlan, injected_faults
from kaminpar_tpu_torch.resilience.watchdog import ExecutionWatchdog
from kaminpar_tpu_torch.telemetry import flight_recorder
from kaminpar_tpu_torch.utils import sync_stats
from kaminpar_tpu_torch.utils.timer import scoped_timer


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
def _clean_state():
    """Disarmed injectors and fresh breaker registries in both packages."""
    for mod in (faults, jfaults):
        mod.reset()
    breakers.reset_global_registry()
    yield
    for mod in (faults, jfaults):
        mod.reset()
    breakers.reset_global_registry()


# -- fault plans -------------------------------------------------------------

PLANS = [
    "execute@lanestack:execute-fault:n=2,queue-admit:capacity-exceeded:after=1,"
    "readback:execute-fault:p=0.5:delay=0.1",
    "preempt@deep_uncoarsen:execute-fault",
    "compile:compile-timeout:n=0",
    "execute:execute-fault:n=1,execute:execute-fault:after=10:n=1",
    "execute@a:execute-fault,execute@b:execute-fault,execute@a:capacity-exceeded",
    " , readback:worker-hung , ",
    "bogus:execute-fault",
    "execute:bogus-class",
    "execute:execute-fault:n=abc",
    "execute:execute-fault:after=1.5x",
    "execute:execute-fault:p=lots",
    "execute:execute-fault:delay=soon",
    "execute:execute-fault:p=1.5",
    "execute:execute-fault:n=-1",
    "execute:execute-fault:after=-2",
    "execute:execute-fault:bogus=1",
    "readback:execute-fault:n=1,execute:execute-fault:n=zz",
    "execute:execute-fault:n=1,execute:execute-fault:n=1",
    "execute@site:execute-fault,execute@site:execute-fault",
]


def _parse(mod, text, seed=3):
    try:
        plan = mod.FaultPlan.parse(text, seed=seed)
    except ValueError as exc:
        return "rejected", str(exc)
    return "accepted", [(s.point, s.site, s.error, s.count, s.after, s.p, s.delay_s)
                        for s in plan.specs]


@pytest.mark.parametrize("text", PLANS)
def test_fault_plan_parse_matches_jax(text):
    assert _parse(faults, text) == _parse(jfaults, text)


@pytest.mark.parametrize("seed", [0, 7, 12345])
@pytest.mark.parametrize("p", [0.1, 0.4, 0.9])
def test_seeded_coin_matches_jax(seed, p):
    hits = range(1, 200)
    for spec_idx in (0, 3):
        port = [faults._coin(seed, spec_idx, h, p) for h in hits]
        assert port == [jfaults._coin(seed, spec_idx, h, p) for h in hits]
        assert 0 < sum(port) < len(port)

    def decisions(mod):
        plan = mod.FaultPlan.parse(f"readback:execute-fault:p={p}:n=0", seed=seed)
        out = []
        with mod.injected_faults(plan):
            for _ in range(64):
                try:
                    mod.maybe_inject("readback")
                    out.append(0)
                except mod.FAILURE_CLASSES["execute-fault"]:
                    out.append(1)
        return out

    assert decisions(faults) == decisions(jfaults)


def test_injection_counts_site_filter_and_census():
    with injected_faults("execute@right:execute-fault:n=2") as plan:
        faults.maybe_inject("execute", site="wrong-site")  # filtered
        with pytest.raises(ExecuteFault) as ei:
            faults.maybe_inject("execute", site="right-site")
        assert ei.value.injected and ei.value.site == "right-site"
        with pytest.raises(ExecuteFault):
            faults.maybe_inject("execute", site="right-site")
        faults.maybe_inject("execute", site="right-site")  # n=2 exhausted
        assert plan.specs[0].injected == 2
    assert faults.snapshot()["points"]["execute"] == {"hits": 4, "injected": 2}


def test_plan_armed_from_the_environment(monkeypatch):
    monkeypatch.setenv("KPTPU_FAULTS", "readback:capacity-exceeded")
    monkeypatch.setenv("KPTPU_FAULTS_SEED", "5")
    faults.reset()
    with pytest.raises(CapacityExceeded):
        sync_stats.pull(torch.zeros(3))
    snap = faults.snapshot()
    assert snap["source"] == "env:readback:capacity-exceeded" and snap["seed"] == 5
    # unparseable: warned and ignored
    monkeypatch.setenv("KPTPU_FAULTS", "nonsense")
    faults.reset()
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        sync_stats.pull(torch.zeros(3))
    assert any("unparseable" in str(w.message) for w in wrec)


# -- the classifier ------------------------------------------------------------

# the JAX tests' exceptions (tests/test_resilience.py) and the site each
# is classified at
JAX_CASES = [
    (MemoryError("oom"), ""),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), ""),
    (RuntimeError("UNAVAILABLE: failed to initialize backend"), ""),
    (TimeoutError("x"), "warmup_compile"),
    (TimeoutError("x"), "engine"),
    (ZeroDivisionError("kernel bug"), "engine"),
    (ImportError("no module"), ""),
    (ValueError("plain"), "lp_pallas"),
]


@pytest.mark.parametrize("exc,site", JAX_CASES, ids=lambda x: type(x).__name__)
def test_classify_matches_jax(exc, site):
    port, ref = classify(exc, site=site), jerrors.classify(exc, site=site)
    assert port.failure_class == ref.failure_class
    assert port.site == ref.site == site
    assert port.__cause__ is exc


# torch's and the card's exceptions, and the class the port gives each
TORCH_CASES = [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "capacity-exceeded"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "execute-fault"),
    (RuntimeError("kp_rate_bucket failed with cudaError_t 700"), "execute-fault"),
    (RuntimeError("CUDA error: out of memory"), "capacity-exceeded"),
    (RuntimeError("No CUDA GPUs are available"), "backend-unavailable"),
    (RuntimeError("KaMinPar runs on cuda:0 by default and CUDA is not available; pass "
                  "device='cpu' to run the plain PyTorch versions"), "backend-unavailable"),
    (RuntimeError("Found no NVIDIA driver on your system"), "backend-unavailable"),
    (TimeoutError("nvcc did not finish"), "compile-timeout"),
]


@pytest.mark.parametrize("exc,cls", TORCH_CASES, ids=lambda x: getattr(x, "__name__", "e"))
def test_classify_torch_exceptions(exc, cls):
    site = "kernel_compile" if isinstance(exc, TimeoutError) else "lp_pallas"
    out = classify(exc, site=site)
    assert out.failure_class == cls
    assert classify(out) is out


def test_failure_classes_match_jax():
    assert set(errors.FAILURE_CLASSES) == set(jerrors.FAILURE_CLASSES)
    err = GraphValidationError("bad input")
    assert isinstance(err, ValueError) and isinstance(err, errors.ResilienceError)
    assert err.failure_class == "graph-validation"


# -- the input guard -------------------------------------------------------------

BAD_INPUTS = {
    "nonmonotone": (np.array([0, 2, 1, 4]), np.array([1, 2, 0, 0]), None, None, False),
    "origin": (np.array([1, 2]), np.array([0]), None, None, False),
    "tail": (np.array([0, 1, 3]), np.array([1, 0]), None, None, False),
    "column-high": (np.array([0, 1, 2]), np.array([1, 9]), None, None, False),
    "column-negative": (np.array([0, 1, 2]), np.array([-1, 0]), None, None, False),
    "negative-edge": (np.array([0, 1, 2]), np.array([1, 0]), None, np.array([1, -3]), False),
    "negative-node": (np.array([0, 1, 2]), np.array([1, 0]), np.array([-1, 1]), None, False),
    "shape": (np.array([0, 1, 2]), np.array([1, 0]), np.array([1, 1, 1]), None, False),
    "overflow32": (np.array([0, 1, 2]), np.array([1, 0]),
                   np.array([np.iinfo(np.int32).max, 2], dtype=np.int64), None, False),
    "overflow64": (np.array([0, 1, 2, 3, 4]), np.array([1, 0, 3, 2]),
                   np.array([1 << 62] * 4, dtype=np.int64), None, True),
    "float-weights": (np.array([0, 1, 2]), np.array([1, 0]), np.array([1.9, 2.9]), None, False),
    "unsigned-nonmonotone": (np.array([0, 2, 1, 4], dtype=np.uint32), np.array([1, 2, 0, 0]),
                             None, None, False),
    "float-indices": (np.array([0.0, 1.0, 2.0]), np.array([1, 0]), None, None, False),
    "2d-row-ptr": (np.zeros((2, 2), dtype=np.int64), np.array([0]), None, None, False),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
def test_graph_validation_matches_jax(name):
    """Same class and site as the JAX guard; the same message, except
    for the range checks: the port's tensors are int32 whatever the
    context says, so it rejects under its own message where the JAX
    package advises its 64-bit build (and rejects ``overflow64`` too,
    which only the JAX package's 64-bit build sees)."""
    rp, col, nw, ew, use_64bit = BAD_INPUTS[name]
    with pytest.raises(jerrors.GraphValidationError) as ref:
        jcsr.validate_csr_input(rp, col, nw, ew, use_64bit=use_64bit)
    with pytest.raises(GraphValidationError) as port:
        tcsr.validate_csr_input(rp, col, nw, ew)
    if name.startswith("overflow"):
        assert str(port.value).endswith("exceeds the port's int32 index space")
        assert "use_64bit" not in str(port.value)
    else:
        assert str(port.value) == str(ref.value)
    assert port.value.site == ref.value.site == "csr_ingest"
    assert port.value.failure_class == ref.value.failure_class == "graph-validation"
    with pytest.raises(GraphValidationError):  # the facade's guard
        KaMinPar("default", device="cpu").copy_graph(rp, col, nw, ew)


def test_valid_input_accepted():
    s = KaMinPar("default", device="cpu")
    s.copy_graph(np.array([0, 1, 2]), np.array([1, 0]), np.array([1, 1]), np.array([1, 1]))
    assert s.graph.n == 2


# -- injected faults stop the run --------------------------------------------------


def _solver(preset="default", **ip):
    s = KaMinPar(preset, device="cpu")
    s.ctx.coarsening.contraction_limit = 60
    for key, val in ip.items():
        setattr(s.ctx.initial_partitioning, key, val)
    s.set_graph(tgen.rmat_graph(9, 4, seed=3))
    return s


@pytest.mark.parametrize("plan,preset,ip,cls", [
    ("execute@lp_pallas:execute-fault", "default", {}, ExecuteFault),
    ("readback@coarsening:execute-fault", "default", {}, ExecuteFault),
    ("readback:execute-fault:after=5", "default", {}, ExecuteFault),
    ("execute@ip_device:execute-fault", "default", {"ip_backend": "device"}, ExecuteFault),
    ("execute@device_decode:execute-fault", "terapart", {}, ExecuteFault),
    ("compile@padded_bucket:compile-timeout", "default", {}, CompileTimeout),
])
def test_injected_fault_raises_typed_error_and_nothing_demotes(plan, preset, ip, cls):
    """The run stops with the typed error; the breakers of the process
    record no demotion (the port has no rung to demote to)."""
    solver = _solver(preset, **ip)
    with injected_faults(plan) as armed:
        with pytest.raises(cls) as ei:
            solver.compute_partition(4)
    assert ei.value.injected
    assert armed.specs[0].injected == 1
    assert breakers.global_registry().demotions() == {}
    # the same solver, disarmed, partitions
    assert solver.compute_partition(4).shape == (1 << 9,)


def test_readback_fault_in_pull():
    with injected_faults("readback@lp_refinement:execute-fault"):
        sync_stats.pull(torch.ones(2))  # untracked: filtered
        with scoped_timer("lp_refinement"):
            with pytest.raises(ExecuteFault) as ei:
                sync_stats.pull(torch.ones(2))
    assert ei.value.site == "lp_refinement"


# -- breakers ------------------------------------------------------------------------


def test_ladder_has_no_kernel_pool_or_decode_rung():
    assert set(breakers.LADDER) == {"lanestack", "quality_strong", "cell", "replica"}
    assert not {"lp_pallas", "ip_device", "device_decode"} & set(breakers.LADDER)


def test_breaker_trip_cooldown_halfopen_close():
    br = CircuitBreaker(("x", ()), threshold=2, cooldown_s=0.15)
    assert br.allow() and br.state == "closed"
    assert not br.record_failure()
    assert br.record_failure(), "threshold-th failure must trip"
    assert br.state == "open" and not br.allow()
    assert br.retry_after_s() > 0
    time.sleep(0.16)
    assert br.allow(), "post-cooldown: the half-open probe is admitted"
    assert br.state == "half-open"
    assert not br.allow(), "only ONE probe while half-open"
    assert br.record_success(), "probe success closes (reports restoration)"
    assert br.state == "closed" and br.allow()


def test_breaker_halfopen_failure_reopens():
    br = CircuitBreaker(("x", ()), threshold=1, cooldown_s=0.1)
    br.record_failure()
    time.sleep(0.11)
    assert br.allow()
    assert br.record_failure(), "probe failure re-trips"
    assert br.state == "open" and not br.allow()


def test_breaker_retry_after_in_half_open():
    br = CircuitBreaker(("x", ()), threshold=1, cooldown_s=0.2)
    br.record_failure()
    time.sleep(0.21)
    assert br.allow()
    assert br.state == "half-open"
    assert br.retry_after_s() > 0


def test_breaker_stale_probe_renewal():
    br = CircuitBreaker(("x", ()), threshold=1, cooldown_s=0.1)
    br.record_failure()
    time.sleep(0.11)
    assert br.allow()  # probe 1, never reported
    assert not br.allow()
    time.sleep(0.11)
    assert br.allow()  # stale -> probe 2
    assert br.probes == 2


def test_breaker_halfopen_probe_race_burns_one_slot():
    br = CircuitBreaker(("x", ()), threshold=1, cooldown_s=0.05)
    br.record_failure()
    time.sleep(0.06)
    n = 8
    barrier = threading.Barrier(n)
    grants, lock = [], threading.Lock()

    def racer():
        barrier.wait()
        ok = br.allow()
        with lock:
            grants.append(ok)

    threads = [threading.Thread(target=racer) for _ in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert grants.count(True) == 1, grants
    assert br.probes == 1
    assert not br.allow() and not br.would_allow()
    assert br.record_success()
    assert br.allow()


def test_breaker_would_allow_peek_vs_claim():
    br = CircuitBreaker(("x", ()), threshold=1, cooldown_s=0.05)
    br.record_failure()
    time.sleep(0.06)
    assert br.would_allow() and br.would_allow()
    assert br.probes == 0
    assert br.would_allow(claim=True)
    assert br.probes == 1
    assert not br.would_allow() and not br.would_allow(claim=True)
    br.record_failure()
    time.sleep(0.06)
    assert br.would_allow()
    assert br.allow()
    assert br.probes == 2


def test_trip_reset_and_registry_census(monkeypatch):
    monkeypatch.setenv("KPTPU_BREAKER_THRESHOLD", "5")
    monkeypatch.setenv("KPTPU_BREAKER_COOLDOWN_S", "0.5")
    reg = BreakerRegistry(scope="engine")
    assert (reg.threshold, reg.cooldown_s) == (5, 0.5)
    br = reg.get("cell", (4096, 65536, 16))
    assert br.trip() and br.state == "open" and not br.trip()
    assert reg.open_count() == 1 and reg.open_count("lanestack") == 0
    br.reset()
    assert br.state == "closed" and br.trips == 1
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        reg.record_demotion("lanestack", "test")
        reg.record_demotion("lanestack", "test")
    assert sum("degrading lanestack -> per-graph" in str(w.message) for w in wrec) == 1
    reg.record_restoration("lanestack")
    snap = reg.snapshot()
    assert snap["demotions"] == {"lanestack": 2} and snap["restorations"] == {"lanestack": 1}
    assert "cell|4096,65536,16" in snap["breakers"]


# -- watchdog and flight recorder --------------------------------------------------


def test_watchdog_times_out_and_names_the_phase(tmp_path):
    path = tmp_path / "dossiers.jsonl"
    wd = ExecutionWatchdog(dossier_path=str(path))
    seen = []
    with scoped_timer("coarsening"):
        with wd.guard("execute", 0.05, on_timeout=seen.append):
            time.sleep(0.3)
    assert wd.fired == 1 and wd.guards == 1 and len(seen) == 1
    dossier = seen[0]
    assert dossier["board_phases"].get(threading.current_thread().name) == "coarsening"
    assert dossier["phase_class"] == "execute"
    assert any("test_watchdog_times_out_and_names_the_phase" in ln
               for ln in dossier["stack_tail"])
    assert wd.dossiers[-1]["completed_late"]
    assert json.loads(path.read_text().splitlines()[0])["phase"] == "execute"
    with wd.guard("execute", 5.0):  # finishes in time
        pass
    with wd.guard("execute", 0):  # disarmed
        pass
    assert wd.fired == 1 and wd.snapshot()["guards"] == 3


def test_phase_board_sees_other_threads():
    started, release = threading.Event(), threading.Event()

    def worker():
        with sync_stats.scoped("extend_partition"):
            started.set()
            release.wait(5)

    th = threading.Thread(target=worker, name="kpt-test-worker")
    th.start()
    started.wait(5)
    try:
        assert sync_stats.current_phases()["kpt-test-worker"] == "extend_partition"
    finally:
        release.set()
        th.join()
    assert sync_stats.current_phases()["kpt-test-worker"] == ""


def test_flight_recorder_heartbeat_and_dossier(tmp_path, monkeypatch):
    hb, stack = str(tmp_path / "hb.jsonl"), str(tmp_path / "stack.txt")
    monkeypatch.setenv("KPTPU_FLIGHT_RECORDER", hb)
    monkeypatch.setenv("KPTPU_HEARTBEAT_S", "0.05")
    monkeypatch.setenv("KPTPU_FLIGHT_STACK", stack)
    monkeypatch.setenv("KPTPU_FLIGHT_STACK_AFTER_S", "0.2")
    monkeypatch.setenv("KPTPU_CHECKPOINT", "/nowhere")
    rec = flight_recorder.arm_from_env()
    try:
        with scoped_timer("partitioning"), scoped_timer("lp_refinement"):
            time.sleep(0.4)
    finally:
        rec.stop()
    dossier = flight_recorder.read_dossier(hb, stack)
    assert dossier["heartbeats"] >= 3
    phases = [json.loads(ln)["phase"] for ln in open(hb)]
    assert "lp_refinement" in phases and phases[0] == "startup"
    assert dossier["env"]["KPTPU_CHECKPOINT"] == "/nowhere"
    assert dossier["stack_tail"]  # the armed dump fired at 0.2 s
    assert flight_recorder.read_dossier(str(tmp_path / "none.jsonl")) is None


@pytest.mark.parametrize("phase", ["", "startup", "backend_init", "warmup_cell",
                                   "kernel_compile", "trace_export", "coarsening",
                                   "checkpoint_write", None])
def test_classify_phase_matches_jax(phase):
    assert flight_recorder.classify_phase(phase) == jflight.classify_phase(phase)
