"""The port's main path as a whole against the JAX facade.

``KaMinPar("default", device="cpu").compute_partition`` and the JAX
facade (host initial-partitioning pool, seed 1) partition the same graphs.
The two packages draw from different random streams (torch generators
against threefry), so the partitions differ and this is a quality
comparison, not an identity one.  Tolerances, set before the port was
measured:

- both sides are feasible in every cell (the balance guarantee is exact);
- the port's cut is at most 1.30x the JAX cut in every cell (one seed of a
  randomized multilevel run varies by tens of percent on small graphs);
- the geometric mean of port/JAX over the six cells is at most 1.10 (the
  per-cell noise averages out; a systematic loss in the port would not).
"""

import math

import jax
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics as tmetrics
from kaminpar_tpu_torch.ops import lp_kernels
from kaminpar_tpu_torch.utils import Logger, OutputLevel


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that runs several JAX-heavy
    modules in one process can otherwise reach the kernel's limit on them."""
    yield
    jax.clear_caches()


GRAPHS = {
    "rmat10": lambda m: m.rmat_graph(10, 8, seed=1),
    "grid32": lambda m: m.grid2d_graph(32, 32),
    "rgg2048": lambda m: m.rgg2d_graph(2048, seed=1),
}


def test_port_quality_matches_jax_facade():
    ratios = []
    for name, make in GRAPHS.items():
        jg, tg = make(jgen), make(tgen)
        for k in (2, 8):
            js = JaxKaMinPar("default")
            js.ctx.seed = 1
            js.ctx.initial_partitioning.ip_backend = "host"
            js.set_graph(jg)
            jpart = js.compute_partition(k)
            ts = kp.KaMinPar("default", device="cpu")
            ts.ctx.seed = 1
            ts.set_graph(tg)
            tpart = ts.compute_partition(k)
            assert jmetrics.is_feasible(jg, jpart, k, js.ctx.partition.max_block_weights)
            assert tmetrics.is_feasible(tg, tpart, k, ts.ctx.partition.max_block_weights)
            jcut = jmetrics.edge_cut(jg, jpart)
            tcut = tmetrics.edge_cut(tg, tpart)
            ratio = tcut / max(jcut, 1)
            assert ratio <= 1.30, f"{name} k={k}: port cut {tcut} vs JAX cut {jcut}"
            ratios.append(ratio)
    geo = math.exp(sum(math.log(max(r, 1e-9)) for r in ratios) / len(ratios))
    assert geo <= 1.10, f"geometric mean port/JAX cut ratio {geo:.3f}: {ratios}"


def test_copy_graph_result_line_and_isolated_nodes(capsys):
    """copy_graph takes the numpy CSR the JAX package's from_numpy_csr
    takes; isolated nodes are stripped and re-inserted; the RESULT line is
    printed at the experiment level."""
    g = tgen.rmat_graph(9, 4, seed=3)  # RMAT: many isolated nodes
    rp, col = g.row_ptr.numpy(), g.col_idx.numpy()
    assert (np.diff(rp) == 0).any()
    solver = kp.KaMinPar("fast", device="cpu")
    solver.copy_graph(rp, col)
    level = Logger.level
    Logger.level = OutputLevel.EXPERIMENT
    try:
        part = solver.compute_partition(4, epsilon=0.05)
    finally:
        Logger.level = level
    out = capsys.readouterr().out
    assert "RESULT cut=" in out and "feasible=1 k=4" in out
    assert part.dtype == np.int32 and part.shape == (g.n,)
    assert set(np.unique(part)) == set(range(4))
    assert solver.last_partition.is_feasible()


def test_explicit_block_weights_and_deterministic_seed():
    g = tgen.grid2d_graph(20, 20)
    caps = [150, 150, 60, 60]
    parts = []
    for _ in range(2):
        solver = kp.KaMinPar("default", device="cpu")
        solver.set_graph(g)
        parts.append(solver.compute_partition(4, max_block_weights=caps))
    assert np.array_equal(parts[0], parts[1])
    bw = np.bincount(parts[0], minlength=4)
    assert (bw <= caps).all()


@pytest.mark.parametrize("scale,edge_factor,seed", [(6, 4, 0), (10, 8, 1), (13, 16, 1)])
def test_rmat_graph_built_by_torch_equals_the_host_build_and_jax(scale, edge_factor, seed):
    """``rmat_graph(device=...)`` (torch, here on the CPU) gives the host
    build's graph, array for array, and so the JAX package's."""
    host = tgen.rmat_graph(scale, edge_factor, seed=seed)
    built = tgen.rmat_graph(scale, edge_factor, seed=seed, device="cpu")
    ref = jgen.rmat_graph(scale, edge_factor, seed=seed)
    for name in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert torch.equal(getattr(host, name), getattr(built, name)), name
    assert np.array_equal(built._host_row_ptr, host._host_row_ptr)
    for name in ("row_ptr", "col_idx", "edge_w"):
        assert np.array_equal(np.asarray(getattr(ref, name)),
                              getattr(built, name).numpy()), name
    with pytest.raises(ValueError, match="node_weights"):
        tgen.rmat_graph(scale, edge_factor, seed=seed, device="cpu", node_weights=None)


def test_facade_rejects_what_the_port_does_not_run():
    g = tgen.grid2d_graph(8, 8)
    solver = kp.KaMinPar("default", device="cpu")
    solver.set_graph(g)
    with pytest.raises(ValueError, match="min_block_weights"):
        solver.compute_partition(2, min_block_weights=[1, 1, 1])
    with pytest.raises(ValueError):
        solver.compute_partition(100)
    with pytest.raises(ValueError):
        kp.KaMinPar("no-such-preset", device="cpu")
    with pytest.raises(ValueError):
        solver.copy_graph(np.array([0, 2, 1]), np.array([1, 0]))


def test_default_device_is_cuda_and_never_the_cpu():
    if torch.cuda.is_available():
        assert kp.KaMinPar().device == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            kp.KaMinPar()


def test_cpu_run_launches_no_kernel():
    lp_kernels.reset_launches()
    solver = kp.KaMinPar("fast", device="cpu")
    solver.set_graph(tgen.grid2d_graph(16, 16))
    solver.compute_partition(2)
    assert lp_kernels.LAUNCHES == {"lp_rate": 0, "lp_rate_compressed": 0, "lp_commit": 0}
