"""Port parity of the other schemes and their coarsening options: HEM, the
threshold sparsifier, overlay clustering, the v-cycle's restriction, the
k-way, recursive-bisection and v-cycle presets, against the JAX package.

The rounds and levels are compared exactly, given the JAX package's own
draws (its threefry keys, reproduced from its seed chain) or the same
numpy seed: every value is an integer.  Whole pipelines draw from torch
generators in the port and threefry in the JAX package, so they are
compared on quality: both sides feasible with all blocks used, and the
port's cut at most 1.2x the JAX package's for the same graph, preset and
seeds (the median over the same seeds on both sides; see
``SCHEME_SEEDS``).

k-way coarsens only down to max(C·k, 2C) nodes and deep to 2C, so the
facade cells lower ``contraction_limit`` to 128 on both sides, and the
port's side must build at least two levels.  Three more settings, the same
on both sides, make the small graphs exercise what the cell is about: the
linear-time-kway cells lower ``sparsification.laziness_factor`` from 4 to
1 (the preset's factor sparsifies RMAT from about scale 16, where a coarse
level keeps more than twice the fine level's average degree; at scale 11
and on the geometric graph no level does), so that at least one level is
sparsified; the HEM cells lower ``convergence_threshold`` from 0.05 to
0.01, because a matching shrinks a power-law graph's level by less than 5%
(hubs match at most one neighbour), so that HEM builds levels on RMAT too.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.coarsening import cluster_coarsener as jcc
from kaminpar_tpu.coarsening import hem_clusterer as jhem
from kaminpar_tpu.coarsening import lp_clusterer as jlpc
from kaminpar_tpu.coarsening import sparsifier as jsp
from kaminpar_tpu.context import ClusteringAlgorithm as JCA
from kaminpar_tpu.context import LabelPropagationContext as JLPContext
from kaminpar_tpu.context import PartitioningMode as JPM
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.graph.csr import CSRGraph as JaxCSRGraph
from kaminpar_tpu.graph.csr import from_edge_list as jax_from_edge_list
from kaminpar_tpu.graph.partitioned import PartitionedGraph as JPartitionedGraph
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.ops.contraction import contract_clustering as jax_contract
from kaminpar_tpu.partitioning.deep import DeepMultilevelPartitioner as JaxDeep
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.utils import RandomState as JaxRandomState
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch.coarsening import cluster_coarsener as tcc
from kaminpar_tpu_torch.coarsening import hem_clusterer as them
from kaminpar_tpu_torch.coarsening import lp_clusterer as tlpc
from kaminpar_tpu_torch.coarsening import sparsifier as tsp
from kaminpar_tpu_torch.context import ClusteringAlgorithm as TCA
from kaminpar_tpu_torch.context import LabelPropagationContext as TLPContext
from kaminpar_tpu_torch.context import PartitioningMode as TPM
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph.csr import CSRGraph
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
from kaminpar_tpu_torch.ops.contraction import contract_clustering
from kaminpar_tpu_torch.partitioning.deep import DeepMultilevelPartitioner
from kaminpar_tpu_torch.presets import create_context_by_preset_name as port_preset
from test_torch_extension import balance_draws, jax_masked
from test_torch_lp_kernels import assert_equal, t
from test_torch_presets import context_differences

I32MAX = 2**31 - 1


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends (each holds
    memory mappings; see test_torch_lp_kernels.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (see
    test_torch_presets.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_keys(seed: int, count: int):
    """The first ``count`` keys of the JAX package's chain after
    ``reseed(seed)``; the chain is reseeded again, so that the JAX code under
    test draws the same keys."""
    JaxRandomState.reseed(seed)
    keys = [next_key() for _ in range(count)]
    JaxRandomState.reseed(seed)
    return keys


def jitter(key, m_pad: int) -> torch.Tensor:
    """A HEM round's jitter as the JAX round draws it from its key."""
    return t(jax.random.randint(key, (m_pad,), 0, I32MAX, dtype=jnp.int32))


def assert_graphs_equal(jg, tg, what=""):
    for name in ("row_ptr", "col_idx", "node_w", "edge_w"):
        assert_equal(getattr(jg, name), getattr(tg, name), f"{what} {name}")


def weighted_grid_pair():
    """A 16 x 16 grid with edge weights 1-4 (many equal weights)."""
    g = tgen.grid2d_graph(16, 16)
    u, v = g.edge_u.numpy(), g.col_idx.numpy()
    edges = np.stack([u[u < v], v[u < v]], axis=1)
    w = np.random.default_rng(5).integers(1, 5, len(edges))
    return (jax_from_edge_list(g.n, edges, edge_weights=w),
            from_edge_list(g.n, edges, edge_weights=w))


def path_pair():
    """The path 0-1-2-3 with edge weights 1, 100, 1 (``test_hem.py``)."""
    row_ptr = np.array([0, 1, 3, 5, 6])
    col_idx = np.array([1, 0, 2, 1, 3, 2])
    edge_w = np.array([1, 1, 100, 100, 1, 1])
    return (JaxCSRGraph(row_ptr, col_idx, None, edge_w),
            CSRGraph(row_ptr, col_idx, None, edge_w))


# (graph pair, max cluster weight)
HEM_CASES = {
    "weighted-grid": (weighted_grid_pair, 8),
    "rmat10": (lambda: (jgen.rmat_graph(10, 8, seed=1), tgen.rmat_graph(10, 8, seed=1)), 4),
    "grid16": (lambda: (jgen.grid2d_graph(16, 16), tgen.grid2d_graph(16, 16)), 100),
    "heavy-path": (path_pair, 100),
    "weight-cap": (lambda: (jgen.grid2d_graph(8, 8, node_weights=np.full(64, 10)),
                            tgen.grid2d_graph(8, 8, node_weights=np.full(64, 10))), 15),
}


@pytest.mark.parametrize("case", ["weighted-grid", "rmat10"])
def test_hem_round_matches_jax(case):
    """Five HEM rounds, each given the JAX round's jitter, equal to the JAX
    rounds bit for bit."""
    make, max_cw = HEM_CASES[case]
    jg, tg = make()
    jpv, tpv = jg.padded(), tg.padded()
    j_match = jnp.arange(jpv.n_pad, dtype=jpv.row_ptr.dtype)
    t_match = torch.arange(tpv.n_pad, dtype=torch.int32)
    cap = jnp.asarray(max_cw, dtype=jpv.row_ptr.dtype)
    matched = 0
    for rnd, key in enumerate(jax.random.split(jax.random.key(7), 5)):
        j_match = jhem._hem_round(key, j_match, jpv.edge_u, jpv.col_idx, jpv.edge_w,
                                  jpv.node_w, cap, n_pad=jpv.n_pad)
        t_match = them._hem_round(t_match, jitter(key, jpv.m_pad), tpv,
                                  torch.tensor(max_cw, dtype=torch.int32))
        assert_equal(j_match, t_match, f"{case} round {rnd}")
        matched = int((t_match != torch.arange(tpv.n_pad)).sum())
    assert matched > 0, case


@pytest.mark.parametrize("case", list(HEM_CASES))
def test_hem_clustering_matches_jax(case):
    """``HEMClustering`` given the JAX clusterer's per-round jitter equals
    it bit for bit, and keeps the properties ``test_hem.py`` checks: at
    most two nodes a cluster, most grid nodes matched, the heavy pair of
    the path matched, no pair above the weight cap."""
    make, max_cw = HEM_CASES[case]
    jg, tg = make()
    m_pad = jg.padded().m_pad
    keys = jax_keys(3, 5)
    j_labels = jhem.HEMClustering(JLPContext()).compute_clustering(jg, max_cw)
    t_labels = them.HEMClustering(TLPContext()).compute_clustering(
        tg, max_cw, draw=lambda r: jitter(keys[r], m_pad))
    assert_equal(j_labels, t_labels, case)
    lab = t_labels[: tg.n].numpy()
    assert np.bincount(lab).max() <= 2
    if case == "grid16":
        assert len(np.unique(lab)) <= 0.75 * tg.n
    if case == "heavy-path":
        assert lab[1] == lab[2] and lab[0] != lab[1] and lab[3] != lab[2]
    if case == "weight-cap":
        assert len(np.unique(lab)) == 64
    anchor = tg.padded().anchor
    assert (t_labels[tg.n :] == anchor).all()


def contracted_rmat_level(cluster_size: int = 8):
    """rmat_graph(10, 8, seed=1) contracted by both packages with the
    clustering u -> u // cluster_size (pads on the anchor), which keeps more
    than twice the fine average degree; returns (jax coarse, port coarse,
    padded labels)."""
    jg, tg = jgen.rmat_graph(10, 8, seed=1), tgen.rmat_graph(10, 8, seed=1)
    pv = jg.padded()
    labels = np.full(pv.n_pad, pv.anchor, dtype=np.int32)
    labels[: pv.n] = np.arange(pv.n) // cluster_size
    jc, _ = jax_contract(jg, jnp.asarray(labels))
    tc, _ = contract_clustering(tg, t(labels))
    assert_graphs_equal(jc, tc, "contracted level")
    return jg, tg, jc, tc, labels


class FixedSeed:
    """Stands in for a package's ``RandomState`` in its sparsifier: every
    ``numpy_rng()`` is the same seeded generator."""

    def __init__(self, seed):
        self.seed = seed

    def numpy_rng(self):
        return np.random.default_rng(self.seed)


def assert_symmetric(g: CSRGraph):
    u, v, w = g.edge_u.numpy(), g.col_idx.numpy(), g.edge_w.numpy()
    fwd = sorted(zip(u.tolist(), v.tolist(), w.tolist()))
    bwd = sorted(zip(v.tolist(), u.tolist(), w.tolist()))
    assert fwd == bwd


@pytest.mark.parametrize("fraction", [0.25, 0.6, "one-edge"])
def test_sparsify_threshold_matches_jax(fraction, monkeypatch):
    """``sparsify_threshold`` on a contracted RMAT level with the same
    numpy seed equals the JAX sparsifier bit for bit, keeps both directions
    of every edge, shares the node weights, and keeps target_m edges up to
    the equal-weight dice (target_m < 2 keeps none)."""
    _, _, jc, tc, _ = contracted_rmat_level()
    target = 1 if fraction == "one-edge" else int(fraction * tc.m)
    monkeypatch.setattr(jsp, "RandomState", FixedSeed(11))
    monkeypatch.setattr(tsp, "RandomState", FixedSeed(11))
    js = jsp.sparsify_threshold(jc, target)
    ts = tsp.sparsify_threshold(tc, target)
    assert_graphs_equal(js, ts, f"sparsified to {target}")
    assert ts.m < tc.m and ts.node_w is tc.node_w and ts.device == tc.device
    assert_symmetric(ts)
    assert_equal(ts.edge_u, np.repeat(np.arange(ts.n), np.diff(ts.host_row_ptr())))
    if fraction == "one-edge":
        assert ts.m == 0
    else:
        assert abs(ts.m - target) <= 0.1 * target, (ts.m, target)


def test_intersect_clusterings_matches_jax():
    """The overlay intersection on random label pairs with many ties (and
    pad runs) equals the JAX package's bit for bit; every output cluster is
    one (la, lb) pair, labelled by its smallest member."""
    rng = np.random.default_rng(4)
    for n, labels in ((512, 12), (1000, 40), (64, 2)):
        la = rng.integers(0, labels, n).astype(np.int32)
        lb = rng.integers(0, labels, n).astype(np.int32)
        la[-5:] = lb[-5:] = n - 1  # a pad run on the anchor
        j = jlpc._intersect_clusterings(jnp.asarray(la), jnp.asarray(lb))
        out = tlpc._intersect_clusterings(t(la), t(lb))
        assert_equal(j, out, f"n={n}")
        out = out.numpy()
        key = la.astype(np.int64) << 32 | lb
        for pair in np.unique(key):
            members = np.flatnonzero(key == pair)
            assert (out[members] == members.min()).all()


def test_hem_coarsening_level_matches_jax():
    """One coarsening level under ``ClusteringAlgorithm.HEM``, the port's
    clusterer given the JAX clusterer's jitter: the same clustering, coarse
    graph and fine -> coarse map; the level shrinks by at most 2x."""
    jg, tg = weighted_grid_pair()
    jctx, tctx = jax_preset("default"), port_preset("default")
    jctx.coarsening.algorithm, tctx.coarsening.algorithm = JCA.HEM, TCA.HEM
    jco, tco = jcc.ClusterCoarsener(jctx, jg), tcc.ClusterCoarsener(tctx, tg)
    assert isinstance(tco.clusterer, them.HEMClustering)
    m_pad = jg.padded().m_pad
    keys = jax_keys(9, 5)
    tco.clusterer.compute_clustering = functools.partial(
        tco.clusterer.compute_clustering, draw=lambda r: jitter(keys[r], m_pad))
    assert jco.coarsen_once(4, 0.03) and tco.coarsen_once(4, 0.03)
    jl, tl = jco.hierarchy[0], tco.hierarchy[0]
    assert_graphs_equal(jl.graph, tl.graph, "HEM level")
    assert_equal(jl.coarse_of, tl.coarse_of, "HEM coarse_of")
    assert tg.n / 2 <= tl.graph.n < tg.n


def test_sparsified_coarsening_level_matches_jax(monkeypatch):
    """One coarsening level of the linear-time-kway context, both
    clusterers returning the same clustering and both sparsifiers the same
    seed: the level is sparsified (target_m = min(0.5 m, 0.5 m / n x n_c))
    to the same graph, and the port counts it."""
    jg, tg, _, tc, labels = contracted_rmat_level()
    jctx, tctx = jax_preset("linear-time-kway"), port_preset("linear-time-kway")
    jco, tco = jcc.ClusterCoarsener(jctx, jg), tcc.ClusterCoarsener(tctx, tg)
    jco.clusterer.compute_clustering = lambda graph, max_cw: jnp.asarray(labels)
    tco.clusterer.compute_clustering = lambda graph, max_cw: t(labels)
    monkeypatch.setattr(jsp, "RandomState", FixedSeed(13))
    monkeypatch.setattr(tsp, "RandomState", FixedSeed(13))
    assert jco.coarsen_once(4, 0.03) and tco.coarsen_once(4, 0.03)
    jl, tl = jco.hierarchy[0], tco.hierarchy[0]
    assert_graphs_equal(jl.graph, tl.graph, "sparsified level")
    assert_equal(jl.coarse_of, tl.coarse_of, "coarse_of")
    target = int(min(0.5 * tg.m, 0.5 * tg.m / tg.n * tc.n))
    assert tl.graph.m < tc.m and abs(tl.graph.m - target) <= 0.1 * target
    assert tco.sparsification == {"levels": 1, "edges_before": tc.m,
                                  "edges_after": tl.graph.m}


def restrict_case(name, mode):
    """(jax graph, port graph, communities, partition before the last
    refinement, partition after it, caps): 16 blocks under 4 communities
    (blocks 4c..4c+3 in community c), 15% of the nodes moved to random
    blocks by the "refinement".  ``rebalance``: block 4c holds about half of
    its community, so that the reverted partition is still overloaded and
    the restricted rebalance runs; ``revert``: the caps have 50% slack, so
    that the revert alone gives a feasible partition."""
    jg, tg = ((jgen.rmat_graph(10, 8, seed=1), tgen.rmat_graph(10, 8, seed=1))
              if name == "rmat" else (jgen.grid2d_graph(24, 24), tgen.grid2d_graph(24, 24)))
    rng = np.random.default_rng(21)
    n = tg.n
    comm = (np.arange(n) * 4 // n).astype(np.int32)
    if mode == "rebalance":
        within = np.where(rng.random(n) < 0.5, 0, rng.integers(1, 4, n))
    else:
        within = np.arange(n) % 4
    pre = (4 * comm + within).astype(np.int32)
    post = pre.copy()
    moved = rng.random(n) < 0.15
    post[moved] = rng.integers(0, 16, int(moved.sum()))
    slack = 1.03 if mode == "rebalance" else 1.5
    caps = np.full(16, int(np.ceil(n / 16 * slack)) + 1, dtype=np.int64)
    return jg, tg, comm, pre, post, caps


@pytest.mark.parametrize("mode", ["rebalance", "revert"])
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_restrict_matches_jax(name, mode):
    """``_restrict`` (and in the ``rebalance`` cases ``_rebalance_restricted``,
    its group-restricted balance rounds on the community-masked graph),
    given the JAX package's draws: the same partition bit for bit, no node
    outside its community's blocks, and a feasible partition after the
    rebalance."""
    jg, tg, comm, pre, post, caps = restrict_case(name, mode)
    jctx, tctx = jax_preset("restricted-vcycle"), port_preset("restricted-vcycle")
    for ctx in (jctx, tctx):
        ctx.partition.k = 16
        ctx.partition.max_block_weights = caps
    jdeep = JaxDeep(jctx, jg, communities=jnp.asarray(comm), communities_k=4)
    tdeep = DeepMultilevelPartitioner(tctx, tg, communities=t(comm), communities_k=4)
    jbv, n_pad = jax_masked(jg, comm).bucketed(), jg.padded().n_pad
    keys = jax_keys(17, jctx.refinement.balancer.max_num_rounds)
    jp = jdeep._restrict(JPartitionedGraph.create(jg, 16, post, caps), pre, 16,
                         jnp.asarray(comm))
    tp = tdeep._restrict(PartitionedGraph.create(tg, 16, post, caps), pre, 16, t(comm),
                         draw=lambda r: balance_draws(keys[r], jbv, n_pad, 3))
    assert_equal(jp.partition, tp.partition, f"{name} {mode}")
    part = tp.partition.numpy()
    assert (part // 4 == comm).all()
    if mode == "revert":
        assert tp.is_feasible()
        assert np.array_equal(part, np.where(post // 4 == comm, post, pre))
    else:
        assert not PartitionedGraph.create(tg, 16, pre, caps).is_feasible()
        assert not np.array_equal(part, pre) and tp.is_feasible()


def test_vcycle_rejects_non_refining_steps():
    """3 -> 4 does not refine under recursive bisection: both packages
    raise before any work."""
    for make, preset in ((JaxKaMinPar, jax_preset), (lambda c: kp.KaMinPar(c, device="cpu"),
                                                     port_preset)):
        ctx = preset("vcycle")
        ctx.vcycles = (3, 4)
        solver = make(ctx)
        solver.set_graph((jgen if make is JaxKaMinPar else tgen).grid2d_graph(16, 16))
        with pytest.raises(ValueError, match="refine"):
            solver.compute_partition(16)


@pytest.mark.parametrize("name", ["kway", "mtkahypar-kway", "linear-time-kway", "vcycle",
                                  "restricted-vcycle"])
def test_scheme_presets_equal_jax(name):
    """The five presets, field for field."""
    ctx = port_preset(name)
    assert not context_differences(ctx, jax_preset(name), name)
    assert ctx.mode == {"kway": TPM.KWAY, "mtkahypar-kway": TPM.KWAY,
                        "linear-time-kway": TPM.KWAY}.get(name, TPM.VCYCLE)


# (preset, context changes): every cell at contraction_limit 128 and k = 4,
# the JAX side on its host pool.
SCHEME_CELLS = {
    "kway": ("kway", {}),
    "linear-time-kway": ("linear-time-kway", {"laziness_factor": 1.0}),
    "rb": ("default", {"mode": "rb"}),
    "vcycle": ("vcycle", {"vcycles": (2,)}),
    "restricted-vcycle": ("restricted-vcycle", {"vcycles": (2,)}),
    "hem": ("default", {"algorithm": "hem", "convergence_threshold": 0.01}),
    "overlay": ("kway", {"overlay_levels": 2}),
}
SCHEME_GRAPHS = {"rmat11": lambda m: m.rmat_graph(11, 16, seed=1),
                 "rgg2048": lambda m: m.rgg2d_graph(2048)}
SCHEME_K = 4
# Each cell runs both packages with the same seeds and compares the medians
# of their cuts.  On rmat_graph(11) (cuts of about 14,000) each package's
# cut varies by under 8% over seeds 1-3 (JAX: k-way 14,493-15,189, vcycle
# 16,032-17,224; the port: 13,726-14,306 and 16,743-17,346) and the port's
# cut at a matched seed 1 is 0.90-1.07x JAX's in every cell, so one seed
# leaves the 1.2x bound a margin.  On rgg2d_graph(2048) (cuts of about
# 1,000) a single cut varies by up to 50% over seeds (linear-time-kway,
# seeds 1-5: JAX 1,105-1,702, the port 1,110-1,584; at seed 1 alone 1.43x),
# so the rgg cells take the median of three seeds on both sides.  A JAX
# pipeline takes 5-75 s on the CPU whatever the graph's size (rmat_graph(10)
# took as long as 11), so the rgg graph runs the two k-way schemes, the
# slice's main path, and the other five schemes run on RMAT only.
SCHEME_SEEDS = {"rmat11": (1,), "rgg2048": (1, 2, 3)}
SCHEME_RUNS = [(cell, "rmat11") for cell in SCHEME_CELLS] + [
    ("kway", "rgg2048"), ("linear-time-kway", "rgg2048")]


def configure(ctx, changes: dict, modes, algorithms, seed: int = 1):
    ctx.seed = seed
    ctx.coarsening.contraction_limit = 128
    for key, val in changes.items():
        if key == "mode":
            ctx.mode = modes(val)
        elif key == "algorithm":
            ctx.coarsening.algorithm = algorithms(val)
        elif key == "vcycles":
            ctx.vcycles = val
        elif key == "laziness_factor":
            ctx.coarsening.sparsification.laziness_factor = val
        else:
            setattr(ctx.coarsening, key, val)
    return ctx


@pytest.fixture
def _clear_jax_after():
    """Each cell's JAX pipeline compiles many shapes; drop them after the
    cell, so that a worker that runs several cells stays far from the
    limit on memory mappings."""
    yield
    jax.clear_caches()


def check_port_scheme(cell: str, scheme):
    """The structure of the port's run: levels built, the scheme's own
    counts."""
    if cell == "rb":
        assert scheme.bisections == SCHEME_K - 1
        assert set(scheme.subgraph_devices) == {"cpu"}
    elif cell in ("vcycle", "restricted-vcycle"):
        assert [c["k"] for c in scheme.cycles] == [2, SCHEME_K]
        assert scheme.num_levels >= 2
    else:
        assert scheme.num_levels >= 2, scheme.level_n
    if cell == "linear-time-kway":
        assert scheme.sparsification["levels"] >= 1, scheme.sparsification
    if cell == "hem":
        n = scheme.level_n
        assert all(b >= a / 2 for a, b in zip(n, n[1:])), n


@pytest.mark.parametrize("cell,graph", SCHEME_RUNS, ids=[f"{c}-{g}" for c, g in SCHEME_RUNS])
def test_scheme_facade_quality_matches_jax(cell, graph, _clear_jax_after):
    preset, changes = SCHEME_CELLS[cell]
    jg, tg = SCHEME_GRAPHS[graph](jgen), SCHEME_GRAPHS[graph](tgen)
    jcuts, tcuts = [], []
    for seed in SCHEME_SEEDS[graph]:
        jsolver = JaxKaMinPar(configure(jax_preset(preset), changes, JPM, JCA, seed))
        jsolver.ctx.initial_partitioning.ip_backend = "host"
        jsolver.set_graph(jg)
        jpart = np.asarray(jsolver.compute_partition(SCHEME_K))
        assert jmetrics.is_feasible(jg, jpart, SCHEME_K,
                                    jsolver.ctx.partition.max_block_weights)
        assert len(np.unique(jpart)) == SCHEME_K
        jcuts.append(int(jmetrics.edge_cut(jg, jpart)))
        tsolver = kp.KaMinPar(configure(port_preset(preset), changes, TPM, TCA, seed),
                              device="cpu")
        tsolver.set_graph(tg)
        tpart = tsolver.compute_partition(SCHEME_K)
        assert tsolver.last_partition.is_feasible() and len(np.unique(tpart)) == SCHEME_K
        assert np.array_equal(tsolver.ctx.partition.max_block_weights,
                              jsolver.ctx.partition.max_block_weights)
        check_port_scheme(cell, tsolver.last_partitioner)
        tcuts.append(int(tsolver.last_partition.edge_cut()))
    jcut, tcut = int(np.median(jcuts)), int(np.median(tcuts))
    print(f"{cell} on {graph}: JAX cuts {jcuts} (median {jcut}), port cuts {tcuts} "
          f"(median {tcut})")
    assert tcut <= 1.2 * jcut, (cell, graph, tcuts, jcuts)
