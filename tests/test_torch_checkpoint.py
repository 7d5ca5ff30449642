"""Checkpoint/resume of the port's deep pipeline
(``kaminpar_tpu_torch/resilience/checkpoint.py``), on the CPU.

The port's version of every fast case of ``tests/test_checkpoint.py``:
disarmed runs write and pull nothing; every level boundary (coarsening
and uncoarsening) resumes to the uninterrupted partition bit for bit,
with the writer's readbacks at its exact entitlement and none in the
restore; the directory's latest file and a loaded state resume alike;
every-N thinning, keep-latest, foreign fingerprints, the knob digest,
arming from the environment, the envelope, a stray temporary file and an
armed resume that does not rewrite its boundary; and one real SIGTERM
through the port's CLI.  Against the JAX package: one table of context
and graph changes gives the same accept, warn or reject in both
packages' ``validate_fingerprint``.  The random streams' chain position
restores the next 1,000 host and generator draws.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import warnings
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from kaminpar_tpu.presets import create_context_by_preset_name as jax_context
from kaminpar_tpu.resilience import checkpoint as jckpt
from kaminpar_tpu_torch import KaMinPar
from kaminpar_tpu_torch import io as kio
from kaminpar_tpu_torch.context import PartitioningMode
from kaminpar_tpu_torch.graph import generators
from kaminpar_tpu_torch.graph.compressed import compress
from kaminpar_tpu_torch.presets import create_context_by_preset_name
from kaminpar_tpu_torch.resilience import checkpoint as ckpt
from kaminpar_tpu_torch.resilience.checkpoint import CheckpointMismatchError
from kaminpar_tpu_torch.telemetry import flight_recorder, phases
from kaminpar_tpu_torch.utils import RandomState, sync_stats

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
def _no_env_arming(monkeypatch):
    for name in ("KPTPU_CHECKPOINT", "KPTPU_CHECKPOINT_EVERY", "KPTPU_FAULTS"):
        monkeypatch.delenv(name, raising=False)


def _ctx(d=None, seed=7, every=1, keep_all=True, climit=60):
    ctx = create_context_by_preset_name("default")
    ctx.seed = seed
    # a small contraction limit: several levels on a small graph, so the
    # boundaries of both stages are cheap
    ctx.coarsening.contraction_limit = climit
    if d is not None:
        ctx.resilience.checkpoint_dir = str(d)
        ctx.resilience.checkpoint_every_levels = every
        ctx.resilience.checkpoint_keep_all = keep_all
    return ctx


def _solve(g, k=4, d=None, resume=None, solver=False, **kw):
    s = KaMinPar(_ctx(d, **kw), device="cpu")
    s.set_graph(g)
    part = s.compute_partition(k, resume=resume)
    return (part, s) if solver else part


def _files(d):
    return sorted(glob.glob(os.path.join(str(d), "ckpt_deep_b*.npz")))


def _meta(path):
    with np.load(path) as npz:
        return json.loads(str(npz["meta"][()]))


def _graph():
    return generators.rmat_graph(9, 4, seed=3)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted partition and an armed run's files (every
    boundary kept), made once for the module."""
    d = str(tmp_path_factory.mktemp("armed"))
    g = _graph()
    ref = _solve(g)
    sync_stats.enable_budget_checks(True)
    try:
        armed, s = _solve(g, d=d, solver=True)
    finally:
        sync_stats.enable_budget_checks(False)
    return SimpleNamespace(g=g, ref=ref, armed=armed, dir=d, files=_files(d),
                           writer=s.last_partitioner.checkpoint_writer)


def test_disarmed_writes_nothing_and_pulls_nothing(tmp_path):
    g = _graph()
    sync_stats.reset()
    sync_stats.enable_budget_checks(True)
    try:
        _part, s = _solve(g, solver=True)
    finally:
        sync_stats.enable_budget_checks(False)
    assert _files(tmp_path) == []
    assert sync_stats.phase_count("checkpoint_write") == 0
    assert s.last_partitioner.checkpoint_writer is None
    assert {"checkpoint_write", "checkpoint_restore"} <= phases.KNOWN_PHASES


def test_armed_run_equals_reference_and_pulls_its_entitlement(reference):
    assert np.array_equal(reference.ref, reference.armed)
    assert len(reference.files) >= 5
    metas = [_meta(f) for f in reference.files]
    assert {m["stage"] for m in metas} == {"coarsening", "uncoarsening"}
    levels = max(m["num_levels"] for m in metas)
    n_up = sum(m["stage"] == "uncoarsening" for m in metas)
    # 5 pulls a cached level, 1 a written uncoarsening boundary
    assert reference.writer.pull_budget == 5 * levels + n_up
    assert [w["boundary"] for w in reference.writer.writes] == [m["boundary"] for m in metas]
    assert all(w["bytes"] > 0 and w["s"] >= 0 for w in reference.writer.writes)
    assert all(m["fingerprint"]["device"] == "cpu" for m in metas)


def test_every_boundary_resumes_bit_identical(reference):
    for f in reference.files:
        sync_stats.reset()
        sync_stats.enable_budget_checks(True)
        try:
            got, s = _solve(reference.g, resume=f, solver=True)
        finally:
            sync_stats.enable_budget_checks(False)
        assert np.array_equal(reference.ref, got), f"resume from {f} diverged"
        assert sync_stats.phase_count("checkpoint_restore") == 0
        assert s.last_partitioner.restore_s > 0


def test_resume_state_object_and_directory_latest(reference):
    assert ckpt.latest(reference.dir) == reference.files[-1]
    state = ckpt.load(reference.dir)
    assert state.path == reference.files[-1]
    assert np.array_equal(reference.ref, _solve(reference.g, resume=state))
    assert np.array_equal(reference.ref, _solve(reference.g, resume=reference.dir))


def test_checkpoint_every_levels_thins_boundaries(tmp_path, reference):
    d2 = tmp_path / "every2"
    _solve(reference.g, d=d2, every=2)
    assert 0 < len(_files(d2)) < len(reference.files)
    assert {_meta(f)["boundary"] for f in _files(d2)} == {
        b for b in (_meta(f)["boundary"] for f in reference.files) if b % 2 == 0}


def test_keep_latest_only_by_default(tmp_path):
    _solve(_graph(), d=tmp_path, keep_all=False)
    files = _files(tmp_path)
    assert len(files) == 1
    assert _meta(files[0])["num_levels"] == 0  # the final boundary


def test_fingerprint_rejects_foreign_runs(reference):
    f = reference.files[-1]
    with pytest.raises(CheckpointMismatchError, match="seed"):
        _solve(reference.g, resume=f, seed=99)
    with pytest.raises(CheckpointMismatchError, match="k="):
        _solve(reference.g, k=8, resume=f)
    other = generators.rmat_graph(8, 4, seed=4)
    with pytest.raises(CheckpointMismatchError, match="graph_"):
        _solve(other, resume=f)


def test_device_field_is_strict(reference):
    """A checkpoint written on the card is rejected on the CPU: its CUDA
    generator's state does not restore into a CPU generator."""
    state = ckpt.load(reference.files[-1])
    state.fingerprint = dict(state.fingerprint, device="cuda")
    with pytest.raises(CheckpointMismatchError, match="device='cuda' vs 'cpu'"):
        _solve(reference.g, resume=state)


def test_knob_digest_governs_not_preset_name(reference):
    f = reference.files[-1]
    with pytest.raises(CheckpointMismatchError, match="knobs_digest"):
        _solve(reference.g, resume=f, climit=61)
    state = ckpt.load(f)
    state.fingerprint = dict(state.fingerprint, preset="renamed")
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        got = _solve(reference.g, resume=state)
    assert any("preset" in str(w.message) for w in wrec)
    assert np.array_equal(reference.ref, got)


def test_env_arming_and_every_override(tmp_path, monkeypatch):
    d = tmp_path / "envdir"
    monkeypatch.setenv("KPTPU_CHECKPOINT", str(d))
    monkeypatch.setenv("KPTPU_CHECKPOINT_EVERY", "2")
    _solve(_graph())  # the context is not armed: the environment alone arms
    files = _files(d)
    assert files
    assert all(_meta(f)["boundary"] % 2 == 0 for f in files)


def test_envelope_warns_once_and_disarms(tmp_path):
    ctx = _ctx(tmp_path)
    ckpt._warned_envelope[0] = False
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        assert ckpt.writer_for(ctx, None) is None
        assert ckpt.writer_for(ctx, None) is None  # second call: silent
    assert sum("envelope" in str(w.message) for w in wrec) == 1
    ckpt._warned_envelope[0] = False


def test_resume_outside_the_envelope_raises(reference):
    s = KaMinPar(_ctx(), device="cpu")
    s.ctx.mode = PartitioningMode.KWAY
    s.set_graph(reference.g)
    with pytest.raises(ValueError, match="DEEP-mode dense inputs only"):
        s.compute_partition(4, resume=reference.dir)
    s = KaMinPar(_ctx(), device="cpu")
    s.set_graph(compress(reference.g))
    with pytest.raises(ValueError, match="DEEP-mode dense inputs only"):
        s.compute_partition(4, resume=reference.dir)


def test_atomic_format_tolerates_stray_tmp(tmp_path):
    _solve(_graph(), d=tmp_path, keep_all=False)
    f = _files(tmp_path)[0]
    (tmp_path / "ckpt_deep_b9999.npz.tmp12345").write_bytes(b"torn")
    assert ckpt.latest(str(tmp_path)) == f
    assert ckpt.load(str(tmp_path)).path == f


def test_armed_resume_does_not_rewrite_restored_boundary(tmp_path, reference):
    uncoarsen = [f for f in reference.files if _meta(f)["stage"] == "uncoarsening"]
    state = ckpt.load(uncoarsen[0])
    d2 = tmp_path / "resumed"
    got = _solve(reference.g, d=d2, resume=state)
    assert np.array_equal(reference.ref, got)
    resumed = [_meta(f)["boundary"] for f in _files(d2)]
    assert resumed == [_meta(f)["boundary"] for f in reference.files
                       if _meta(f)["boundary"] > state.boundary]


def test_sigterm_through_the_cli_resumes_bit_identical(tmp_path, reference):
    """A real kill: the CLI (``--device cpu``) on a METIS file dies by
    SIGTERM at the first uncoarsening boundary, after that boundary's
    checkpoint is on disk; its flight recorder names a pipeline phase, and
    the resume in this process gives the uninterrupted partition."""
    graph_file, cfg = tmp_path / "g.metis", tmp_path / "c.toml"
    kio.write_graph(reference.g, str(graph_file))
    cfg.write_text("seed = 7\n[coarsening]\ncontraction_limit = 60\n")
    ckpt_dir, hb = tmp_path / "ckpt", tmp_path / "hb.jsonl"
    env = dict(os.environ, PYTHONPATH=_REPO, KPTPU_CHECKPOINT=str(ckpt_dir),
               KPTPU_CHECKPOINT_EVERY="1", KPTPU_FAULTS="preempt@deep_uncoarsen:execute-fault",
               KPTPU_FLIGHT_RECORDER=str(hb), KPTPU_HEARTBEAT_S="0.05",
               # the NumPy parser: the test is about the kill, not the read
               KAMINPAR_TPU_NO_NATIVE="1")
    child = subprocess.run(
        [sys.executable, "-m", "kaminpar_tpu_torch", str(graph_file), "4", "-P", "default",
         "-C", str(cfg), "--device", "cpu", "-o", str(tmp_path / "g.part")],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert child.returncode == -signal.SIGTERM, child.stderr[-2000:]
    files = _files(ckpt_dir)
    assert files, "no checkpoint survived the kill"
    assert _meta(files[-1])["stage"] == "uncoarsening"
    assert not (tmp_path / "g.part").exists()
    dossier = flight_recorder.read_dossier(str(hb))
    assert dossier["phase"] in phases.CORE_PHASES + ("checkpoint_write",), dossier
    assert dossier["heartbeats"] >= 2
    graph = kio.read_graph(str(graph_file))
    assert np.array_equal(reference.ref, _solve(graph, resume=str(ckpt_dir)))


# -- the fingerprint rules, against the JAX package ---------------------------

CHANGES = {
    "same": {},
    "k": {"k": 8},
    "epsilon": {"epsilon": 0.05},
    "seed": {"seed": 8},
    "coarsening-knob": {"climit": 61},
    "preset-name-only": {"preset": "renamed"},
    "n": {"n": 1},
    "m": {"m": 2},
}


def _verdict(mod, make_ctx, change):
    base_graph = SimpleNamespace(n=500, m=4000, device="cpu")

    def context(**kw):
        ctx = make_ctx("default")
        ctx.seed = kw.get("seed", 7)
        ctx.coarsening.contraction_limit = kw.get("climit", 60)
        ctx.partition.k = kw.get("k", 4)
        ctx.partition.epsilon = kw.get("epsilon", 0.03)
        ctx.preset_name = kw.get("preset", "default")
        return ctx

    state = SimpleNamespace(fingerprint=mod.fingerprint(context(), base_graph))
    graph = SimpleNamespace(n=base_graph.n + change.get("n", 0),
                            m=base_graph.m + change.get("m", 0), device="cpu")
    with warnings.catch_warnings(record=True) as wrec:
        warnings.simplefilter("always")
        try:
            mod.validate_fingerprint(state, context(**change), graph)
        except mod.CheckpointMismatchError:
            return "reject"
    return "warn" if any("checkpoint" in str(w.message) for w in wrec) else "accept"


@pytest.mark.parametrize("name", sorted(CHANGES))
def test_fingerprint_rules_match_jax(name):
    port = _verdict(ckpt, create_context_by_preset_name, CHANGES[name])
    assert port == _verdict(jckpt, jax_context, CHANGES[name])
    assert port == {"same": "accept", "preset-name-only": "warn"}.get(name, "reject")


# -- the random streams' chain position ------------------------------------------


def test_chain_position_restores_the_next_draws():
    def draws():
        gen = RandomState.generator("cpu")
        host = RandomState.numpy_rng()
        return (torch.randint(0, 1 << 30, (1000,), generator=gen).numpy(),
                torch.rand(1000, generator=gen).numpy(),
                host.integers(1 << 40, size=1000),
                np.array([RandomState.numpy_rng().integers(1 << 30) for _ in range(1000)]))

    RandomState.reseed(11)
    torch.rand(17, generator=RandomState.generator("cpu"))
    RandomState.numpy_rng()
    pos = json.loads(json.dumps({**RandomState.chain_position(), "gens": []}))
    pos["gens"] = RandomState.chain_position()["gens"]
    first = draws()
    RandomState.reseed(999)  # anything in between
    draws()
    RandomState.restore(pos)
    for a, b in zip(first, draws()):
        assert np.array_equal(a, b)
    assert RandomState.phase_draws()["untracked"] == 1002
