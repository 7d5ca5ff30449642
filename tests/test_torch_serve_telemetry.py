"""Port parity of the serve tier's telemetry and admission pieces.

- ``telemetry/{reqtrace,slo,prometheus}.py`` fed the same event sequence on
  an injected clock give the JAX package's dicts and exposition text; the
  breakers' Prometheus families too.
- ``telemetry/capacity.py``: ``family_shape``, the resident and workspace
  models, and ``predict`` with the JAX package's fallback temp term equal
  the JAX package's; the port's resident prediction is within
  ``VALIDATION_TOLERANCE`` of ``heap_profiler.live_array_bytes()``; the
  preflight rejects with a typed ``CapacityError`` and no readback.
- ``utils/compile_stats.py``'s census equals the JAX package's; its
  executable census is absent.
- ``resilience/errors``: the serve errors pass through ``classify`` and
  ``is_control_flow`` as in the JAX package; the probes' ``lane`` tag;
  the engine runtime's thread-local activation.
"""

import pytest
import torch

from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.resilience import breakers as jbreakers
from kaminpar_tpu.resilience import errors as jerrors
from kaminpar_tpu.serve import errors as jserve_errors
from kaminpar_tpu.telemetry import capacity as jcapacity
from kaminpar_tpu.telemetry import prometheus as jprom
from kaminpar_tpu.telemetry import reqtrace as jreqtrace
from kaminpar_tpu.telemetry import slo as jslo
from kaminpar_tpu.utils import compile_stats as jcompile_stats
from kaminpar_tpu_torch import telemetry
from kaminpar_tpu_torch.context import EngineRuntime, current_runtime
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.resilience import breakers as tbreakers
from kaminpar_tpu_torch.resilience import errors as terrors
from kaminpar_tpu_torch.serve import errors as tserve_errors
from kaminpar_tpu_torch.telemetry import capacity as tcapacity
from kaminpar_tpu_torch.telemetry import probes
from kaminpar_tpu_torch.telemetry import prometheus as tprom
from kaminpar_tpu_torch.telemetry import reqtrace as treqtrace
from kaminpar_tpu_torch.telemetry import slo as tslo
from kaminpar_tpu_torch.utils import compile_stats as tcompile_stats
from kaminpar_tpu_torch.utils import sync_stats
from kaminpar_tpu_torch.utils import timer as ttimer


class FakeTime:
    """An injected clock: every read advances it by 0.25 s."""

    def __init__(self):
        self.now = 1000.0

    def _tick(self):
        self.now += 0.25
        return self.now

    perf_counter = time = monotonic = _tick


@pytest.fixture
def clocks(monkeypatch):
    for mod in (jreqtrace, treqtrace, jslo, tslo):
        monkeypatch.setattr(mod, "time", FakeTime())
    for mod in (jreqtrace, treqtrace):
        monkeypatch.setattr(mod, "_session_token", lambda: "fixed")


def _drive_reqtrace(mod):
    rt = mod.ReqTrace(capacity=4, max_events=5)
    out = []
    for r in range(6):
        tid = rt.mint()
        rt.bind(r, tid)
        rt.record(tid, "admit", request_id=r, engine="e", k=8, queue_position=r)
        rt.record(tid, "dispatch", request_id=r, engine="e", occupancy=2)
        if r % 3 == 2:
            rt.record(tid, "error", request_id=r, final=False, failure_class="worker-hung")
        rt.record(tid, "resolve", request_id=r, final=True, cut=10 * r)
        out.append(rt.explain_request(r))
    rt.record("", "admit")
    out.append(rt.explain_request(12345))
    out.append(rt.snapshot())
    return out


def test_reqtrace_matches_jax_on_an_injected_clock(clocks):
    assert _drive_reqtrace(treqtrace) == _drive_reqtrace(jreqtrace)


def _drive_slo(mod):
    bt = mod.BurnTracker(strong_ms=100.0, fast_ms=50.0, availability=0.9,
                         capacity_reject_rate=0.05, windows_s=(2.0, 10.0))
    for i in range(20):
        bt.record_request("strong" if i % 2 else "fast", 0.03 * (i % 5), ok=i % 7 != 0)
        if i % 6 == 0:
            bt.record_reject(capacity=bool(i % 12))
    fams = mod.prometheus_families(bt)
    return bt.summary(), bt.pressure(max_age_s=0.0), fams, mod.prometheus_families(None)


def test_slo_and_exposition_match_jax_on_an_injected_clock(clocks):
    port, ref = _drive_slo(tslo), _drive_slo(jslo)
    assert port[:2] == ref[:2]
    text = tprom.render(port[2] + port[3])
    assert text == jprom.render(ref[2] + ref[3])
    assert tprom.validate(text) == jprom.validate(text)
    assert tprom.get_sample(tprom.validate(text), "kaminpar_slo_pressure") == \
        jprom.get_sample(jprom.validate(text), "kaminpar_slo_pressure")


def test_breaker_families_match_jax():
    def drive(mod):
        reg = mod.BreakerRegistry(threshold=2, cooldown_s=30.0)
        for _ in range(2):
            reg.get("cell", (256, 1024, 8)).record_failure()
        reg.get("lanestack", (256, 1024, 8)).record_success()
        reg.record_demotion("lanestack", "test", warn=False)
        return mod.prometheus_families(reg)

    port, ref = drive(tbreakers), drive(jbreakers)
    assert tprom.render(port) == jprom.render(ref)
    with pytest.raises(ValueError):
        tprom.validate("bad line without a value")


# -- capacity ------------------------------------------------------------------


def test_capacity_models_match_jax():
    for fam in ("rmat", "rgg", "grid"):
        assert tcapacity.family_shape(fam, 14, 8) == jcapacity.family_shape(fam, 14, 8)
    tg, jg = tgen.rmat_graph(10, 8, seed=3), jgen.rmat_graph(10, 8, seed=3)
    deg = tcapacity.host_degrees(tg)
    assert (deg == jcapacity.host_degrees(jg)).all()
    pv = tg.padded()
    assert tcapacity.model_dense_resident_bytes(pv.n_pad, pv.m_pad, deg=deg) == \
        jcapacity.model_dense_resident_bytes(pv.n_pad, pv.m_pad, deg=deg)
    assert tcapacity.model_dense_resident_bytes(pv.n_pad, pv.m_pad) == \
        jcapacity.model_dense_resident_bytes(pv.n_pad, pv.m_pad)
    assert tcapacity.model_workspace_bytes(pv.n_pad, 8, 3) == \
        jcapacity.model_workspace_bytes(pv.n_pad, 8, 3)
    for kw in (dict(), dict(lanes=4), dict(device_decode=True), dict(P=4),
               dict(n=5000, m=80000, deg=None)):
        port = tcapacity.predict("rmat", 14, 8, temp_model="fallback", **kw).to_dict()
        ref = jcapacity.predict("rmat", 14, 8, harvest=False, **kw).to_dict()
        for key in ("n_pad", "m_pad", "resident_bytes", "workspace_bytes", "temp_bytes",
                    "hierarchy_bytes", "predicted_peak_bytes"):
            assert port[key] == ref[key], (kw, key)
    # the port's own temp term: its contraction's bytes per node and edge
    own = tcapacity.predict("rmat", 14, 8)
    assert own.temp_bytes == own.m_pad * tcapacity.CONTRACTION_BYTES_PER_EDGE \
        + own.n_pad * tcapacity.CONTRACTION_BYTES_PER_NODE
    assert tcapacity.device_ceiling_bytes("NVIDIA H100 80GB HBM3") == int(80 * 2**30 * 0.6)
    assert tcapacity.device_ceiling_bytes("") is None


def test_resident_prediction_within_tolerance_of_live_bytes():
    out = tcapacity.validate_cpu(scale=11, edge_factor=16)
    assert out["watermark_backend"] == "cpu_rss_proxy"
    assert out["rel_err"] <= tcapacity.VALIDATION_TOLERANCE, out


def test_preflight_rejects_with_no_readback():
    g = tgen.rmat_graph(9, 8, seed=2)
    need = tcapacity.predict_for_graph(g, 8).predicted_peak_bytes
    sync_stats.reset()
    assert tcapacity.preflight(g, 8, ceiling_bytes=need).fits
    with pytest.raises(tserve_errors.CapacityError) as exc:
        tcapacity.preflight(g, 8, ceiling_bytes=need - 1)
    assert exc.value.predicted_bytes == need and exc.value.ceiling_bytes == need - 1
    assert sync_stats.snapshot()["count"] == 0
    assert terrors.classify(exc.value).failure_class == "capacity-exceeded"


# -- compile census, errors, probes, runtime ---------------------------------


def test_compile_census_matches_jax():
    tcompile_stats.reset()
    jcompile_stats.reset()
    a, b = torch.zeros(4, dtype=torch.int32), torch.zeros((2, 8), dtype=torch.int32)
    for mod in (tcompile_stats, jcompile_stats):
        mod.record("lane_union", arrays=[a, b], statics=(3,))
        mod.record("lane_union", arrays=[a, b], statics=(3,))
        mod.record("lane_union", arrays=[b], statics=(3,))
        mod.record("serve_packed_metrics", arrays=[a], statics=(8, 4))
    assert tcompile_stats.snapshot() == jcompile_stats.snapshot()
    assert tcompile_stats.distinct("lane_union") == jcompile_stats.distinct("lane_union") == 2
    tcompile_stats.enable_compile_time_tracking()
    tcompile_stats.record_build("nvcc", 1.5)
    snap = tcompile_stats.compile_time_snapshot()
    assert snap["compile_events"] == 1 and snap["builds"]["nvcc"]["builds"] == 1
    assert not tcompile_stats.executable_census_armed()
    assert tcompile_stats.census_prometheus_families() == []
    tcompile_stats.reset()
    jcompile_stats.reset()


def test_serve_errors_pass_through_classify_as_in_jax():
    cases = [(tserve_errors.QueueFullError(0.5), jserve_errors.QueueFullError(0.5)),
             (tserve_errors.DeadlineExceededError("x"), jserve_errors.DeadlineExceededError("x")),
             (tserve_errors.RequestCancelledError("x"), jserve_errors.RequestCancelledError("x")),
             (tserve_errors.EngineStoppedError("x"), jserve_errors.EngineStoppedError("x")),
             (tserve_errors.CapacityError(2, 1), jserve_errors.CapacityError(2, 1)),
             (RuntimeError("CUDA error: an illegal memory access"),
              RuntimeError("CUDA error: an illegal memory access"))]
    for port, ref in cases:
        assert terrors.is_control_flow(port) == jerrors.is_control_flow(ref)
        tc, jc = terrors.classify(port, site="s"), jerrors.classify(ref, site="s")
        assert (tc.failure_class, tc.site) == (jc.failure_class, jc.site)
        assert tc.__cause__ is port


def test_probe_rows_carry_the_lane_tag():
    with telemetry.run() as rec:
        probes.coarsening_level(level=0, n=10, m=20, n_c=5, m_c=8, max_cluster_weight=3,
                                max_node_weight=2, total_edge_weight=8, lane=3)
        probes.coarsening_level(level=0, n=10, m=20, n_c=5, m_c=8, max_cluster_weight=3,
                                max_node_weight=2, total_edge_weight=8)
    rows = [r for r in rec.quality if r.get("kind") == "coarsening_level"] or rec.quality
    assert rows[0]["lane"] == 3 and "lane" not in rows[1]


def test_engine_runtime_is_thread_local_and_owns_the_sync_flag():
    ttimer.set_sync_mode(False)
    rt = EngineRuntime("cpu", sync_timers=True)
    assert current_runtime() is None and not ttimer.sync_mode()
    with rt.activate():
        assert current_runtime() is rt and ttimer.sync_mode()
        with EngineRuntime("cpu").activate():
            assert not ttimer.sync_mode()
        assert ttimer.sync_mode()
    assert current_runtime() is None and not ttimer.sync_mode()
