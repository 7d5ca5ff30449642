"""The port's quality presets (eco, strong, jet and their variants) against
the JAX package: their contexts field for field, the refiner factory, and
the facade on small graphs.

The two facades draw from different random streams, so the whole-run
comparisons are on quality: both sides feasible and the port's cut at
most 1.30x the JAX cut on the small cells (the bound of the other facade
cells, ``test_torch_extension.py``), at most 1.05x for strong and jet on
``rmat_graph(10, 8)`` into 8 blocks, where they must also cut below the
port's default.
"""

import dataclasses
import enum

import jax
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu_torch.context import RefinementAlgorithm
from kaminpar_tpu_torch.factories import create_refiner
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics as tmetrics
from kaminpar_tpu_torch.presets import _PRESETS
from kaminpar_tpu_torch.presets import create_context_by_preset_name as port_preset
from kaminpar_tpu_torch.refinement.balancer import OverloadBalancer, UnderloadBalancer
from kaminpar_tpu_torch.refinement.clp_refiner import CLPRefiner
from kaminpar_tpu_torch.refinement.fm_refiner import FMRefiner
from kaminpar_tpu_torch.refinement.jet import JetRefiner
from kaminpar_tpu_torch.refinement.lp_refiner import LPRefiner


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends (each holds
    memory mappings; see test_torch_lp_kernels.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work: in a run with
    several workers on few cores, torch's thread pools oversubscribe the
    cores and these small-graph tests slow down twentyfold; alone they
    take about as long on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


NEW_PRESETS = ["eco", "eco-devext", "fm", "strong", "flow", "jet", "4xjet", "noref",
               "largek-eco", "largek-strong", "terapart-eco", "esa21-smallk",
               "esa21-largek", "esa21-largek-fast", "esa21-strong"]


def context_differences(port, ref, path=""):
    """The fields of the port's context (recursively) whose value differs
    from the JAX context's; enums compare by value."""
    if dataclasses.is_dataclass(port):
        out = []
        for f in dataclasses.fields(port):
            if not hasattr(ref, f.name):
                out.append(f"{path}.{f.name}: missing in the JAX context")
            else:
                out += context_differences(getattr(port, f.name), getattr(ref, f.name),
                                           f"{path}.{f.name}")
        return out
    if isinstance(port, enum.Enum):
        return [] if port.value == ref.value else [f"{path}: {port} vs {ref}"]
    if isinstance(port, tuple):
        if len(port) != len(ref):
            return [f"{path}: {port} vs {ref}"]
        return [d for i, (a, b) in enumerate(zip(port, ref))
                for d in context_differences(a, b, f"{path}[{i}]")]
    if port is None or ref is None:
        return [] if port is ref else [f"{path}: {port} vs {ref}"]
    return [] if np.array_equal(np.asarray(port), np.asarray(ref)) else [
        f"{path}: {port} vs {ref}"]


def test_every_preset_context_equals_jax():
    assert set(NEW_PRESETS) <= set(_PRESETS)
    for name in sorted(_PRESETS):
        diff = context_differences(port_preset(name), jax_preset(name), name)
        assert not diff, diff
    strong = port_preset("strong").refinement.algorithms
    assert strong.index(RefinementAlgorithm.LP) < strong.index(RefinementAlgorithm.JET) \
        < strong.index(RefinementAlgorithm.KWAY_FM)
    assert port_preset("4xjet").refinement.jet.num_rounds == 4
    assert port_preset("noref").refinement.algorithms == ()


def test_create_refiner_builds_each_algorithm_and_coarse_temperatures():
    ctx = port_preset("default")
    ctx.refinement.algorithms = tuple(RefinementAlgorithm)
    refiners = create_refiner(ctx).refiners
    assert [type(r) for r in refiners] == [LPRefiner, CLPRefiner, JetRefiner, FMRefiner,
                                           OverloadBalancer, UnderloadBalancer,
                                           OverloadBalancer]
    jet = port_preset("jet")
    jet.refinement.jet.initial_gain_temp_on_coarse_level = 0.9
    fine = create_refiner(jet).refiners[0]
    coarse = create_refiner(jet, coarse_level=True).refiners[0]
    assert fine.temperatures() == (0.25, 0.25)
    assert coarse.temperatures() == (0.9, 0.75)
    assert type(create_refiner(port_preset("noref"))).__name__ == "NoopRefiner"


def test_deep_scheme_passes_the_coarse_flag(monkeypatch):
    """Coarse levels build JET with the coarse temperatures, the finest
    level with the fine ones."""
    from kaminpar_tpu_torch.partitioning import deep

    seen = []
    real = deep.create_refiner

    def spy(ctx, *, coarse_level=False):
        seen.append(coarse_level)
        return real(ctx, coarse_level=coarse_level)

    monkeypatch.setattr(deep, "create_refiner", spy)
    solver = kp.KaMinPar("noref", device="cpu")
    solver.ctx.coarsening.contraction_limit = 64
    solver.set_graph(tgen.grid2d_graph(24, 24))
    solver.compute_partition(4)
    assert seen[-1] is False and True in seen


def test_aliases_and_variants_run_on_the_cpu():
    g = tgen.grid2d_graph(12, 12)
    for name in ("fm", "flow", "largek-strong", "esa21-smallk", "esa21-largek",
                 "esa21-largek-fast", "esa21-strong"):
        solver = kp.KaMinPar(name, device="cpu")
        solver.set_graph(g)
        part = solver.compute_partition(4)
        assert solver.last_partition.is_feasible() and part.shape == (g.n,), name


# (preset, graph, k, bound): each quality preset on one of the two small
# graphs, the port's cut at most bound x the JAX cut.  strong and jet are
# held to 1.05x on rmat_graph(10, 8) into 8 blocks, where both also cut
# below the port's default; strong's FM runs FM_ITERATIONS pass a level on
# both sides (its host passes dominate the test's time).
FACADE_CELLS = {
    "eco-grid32": ("eco", "grid32", 4, 1.30),
    "jet-rmat10": ("jet", "rmat10", 8, 1.05),
    "strong-rmat10": ("strong", "rmat10", 8, 1.05),
    "4xjet-grid32": ("4xjet", "grid32", 4, 1.30),
    "noref-rmat10": ("noref", "rmat10", 8, 1.30),
    "largek-eco-grid32": ("largek-eco", "grid32", 8, 1.30),
    "terapart-eco-grid32": ("terapart-eco", "grid32", 4, 1.30),
    "eco-devext-grid32": ("eco-devext", "grid32", 4, 1.30),
}
GRAPHS = {"grid32": lambda m: m.grid2d_graph(32, 32),
          "rmat10": lambda m: m.rmat_graph(10, 8, seed=1)}
FM_ITERATIONS = 1


def facade_pair(preset, graph, k, fm_iterations=None, **ipc):
    """Both facades (seed 1, the JAX side on its host pool) on the same
    graph; returns per side (cut, feasible, solver)."""
    out = {}
    for side, gen, metrics, make in (("jax", jgen, jmetrics, JaxKaMinPar),
                                     ("port", tgen, tmetrics,
                                      lambda p: kp.KaMinPar(p, device="cpu"))):
        g = GRAPHS[graph](gen)
        solver = make(preset)
        solver.ctx.seed = 1
        if side == "jax":
            solver.ctx.initial_partitioning.ip_backend = "host"
        for key, val in ipc.items():
            setattr(solver.ctx.initial_partitioning, key, val)
        if fm_iterations is not None:
            solver.ctx.refinement.fm.num_iterations = fm_iterations
        solver.set_graph(g)
        part = np.asarray(solver.compute_partition(k))
        out[side] = (int(metrics.edge_cut(g, part)),
                     bool(metrics.is_feasible(g, part, k,
                                              solver.ctx.partition.max_block_weights)),
                     solver)
    return out


@pytest.mark.parametrize("cell", list(FACADE_CELLS))
def test_facade_quality_matches_jax_facade(cell):
    preset, graph, k, bound = FACADE_CELLS[cell]
    # eco-devext's device extension at this size
    ipc = {"device_extension_n": 256} if preset == "eco-devext" else {}
    fm_iterations = FM_ITERATIONS if preset == "strong" else None
    r = facade_pair(preset, graph, k, fm_iterations, **ipc)
    assert r["jax"][1] and r["port"][1], cell
    assert r["port"][0] <= bound * r["jax"][0], \
        f"{cell}: port {r['port'][0]} vs JAX {r['jax'][0]}"
    solver = r["port"][2]
    if preset == "eco-devext":
        assert solver.last_partitioner.extension_jobs["device"] > 0
    if preset == "terapart-eco":
        assert solver.last_partitioner.compressed_view is not None
    if preset in ("strong", "jet"):
        default = kp.KaMinPar("default", device="cpu")
        default.ctx.seed = 1
        default.set_graph(GRAPHS[graph](tgen))
        default.compute_partition(k)
        assert r["port"][0] < default.last_partition.edge_cut(), cell
