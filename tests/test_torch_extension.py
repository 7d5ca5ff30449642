"""Port parity of the extension and balancing layer: the grouped overload
round and the underload round against the JAX package's rounds given its
draws, the community-masked clustering and layout, device extension, the
pooled extension jobs, minimum block weights through the facade and the
largek presets.

The round and layout comparisons are exact (integers, or float32 computed
by the same operations in the same order).  Device extension and the
facades draw from different random streams in the two packages, so they
are compared on quality; tolerances, set before the port was measured:
every partition feasible (and min-feasible where minimums are set), the
port's cut at most 1.30x the JAX package's, as in
``test_torch_pipeline.test_port_quality_matches_jax_facade``.
"""

import math
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.graph.csr import CSRGraph as JaxCSRGraph
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.partitioning.deep import extend_partition as jax_extend_partition
from kaminpar_tpu.presets import create_context_by_preset_name as jax_preset
from kaminpar_tpu.refinement import balancer as jbal
from kaminpar_tpu.utils import RandomState as JaxRandomState
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch import kaminpar as tkaminpar
from kaminpar_tpu_torch.coarsening.cluster_coarsener import ClusterCoarsener
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics as tmetrics
from kaminpar_tpu_torch.graph.compressed import compress
from kaminpar_tpu_torch.graph.device_compressed import DeviceCompressedView
from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops import lp_kernels
from kaminpar_tpu_torch.ops.segment import segment_max, segment_min
from kaminpar_tpu_torch.partitioning import deep as tdeep
from kaminpar_tpu_torch.partitioning.partition_utils import (
    intermediate_block_weights, split_offsets,
)
from kaminpar_tpu_torch.presets import create_context_by_preset_name as port_preset
from kaminpar_tpu_torch.refinement import balancer as tbal
from kaminpar_tpu_torch.utils import RandomState, platform
from test_torch_lp_kernels import assert_equal, graph_pair, jax_round_draws, jax_ties, t


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that runs several JAX-heavy
    modules in one process can otherwise reach the kernel's limit on them."""
    yield
    jax.clear_caches()


def grid_pair(rows, cols):
    return jgen.grid2d_graph(rows, cols), tgen.grid2d_graph(rows, cols)


def padded_part(n_pad, part):
    out = np.zeros(n_pad, dtype=np.int32)
    out[: len(part)] = part
    return out


def balance_draws(key, jbv, n_pad, splits):
    """A balancer round's draws from its key: the rating ties from the
    first split, the gain jitter from the second (``_balance_round``
    splits three ways, ``_underload_round`` two)."""
    kb, ks = jax.random.split(key, splits)[:2]
    ties, heavy = jax_ties(kb, jbv)
    jitter = t(jax.random.uniform(ks, (n_pad,), minval=0.0, maxval=1e-3))
    return tbal.BalanceDraws(ties, heavy, jitter)


def jax_masked(jg, comm):
    """The community-masked graph as the JAX package builds it
    (``extension._restricted_refine``)."""
    c = jnp.asarray(comm)
    masked_ew = jnp.where(c[jg.edge_u] == c[jg.col_idx], jg.edge_w, 0)
    mg = JaxCSRGraph(jg.row_ptr, jg.col_idx, jg.node_w, masked_ew,
                     sorted_by_degree=jg.sorted_by_degree, edge_u=jg.edge_u)
    mg._deg_hist = jg._deg_hist
    mg._layout_mode = jg._layout_mode
    mg._host_row_ptr = jg._host_row_ptr
    return mg


# -- the grouped overload round and the underload round ---------------------


def grouped_case(name):
    """(jax graph, port graph, k, part, group_of, max_bw): 8 blocks in 4
    groups of 2.  ``rmat``/``hub``: random blocks, block 0 overloaded;
    ``grid-empty``: blocks 0 and 4 hold everything, so that each
    overloaded block's group partner (1, 5) is empty and the in-group
    fallback must find it, while the globally lightest block lies in
    another group."""
    k = 8
    group_of = np.repeat(np.arange(4, dtype=np.int32), 2)
    if name == "grid-empty":
        jg, tg = grid_pair(24, 24)
        n = jg.n
        part = np.where(np.arange(n) < n // 2, 0, 4).astype(np.int32)
        part[: n // 8] = 2  # group 1: block 2 full, block 3 empty
        part[n // 2 : n // 2 + n // 8] = 6
        max_bw = np.full(k, int(n / 4 * 1.2), dtype=np.int32)
        return jg, tg, k, part, group_of, max_bw
    jg, tg = graph_pair(name)
    rng = np.random.default_rng(12)
    part = np.where(rng.random(jg.n) < 0.35, 0, rng.integers(1, k, jg.n)).astype(np.int32)
    max_bw = np.full(k, int(jg.total_node_weight / k * 1.03) + 1, dtype=np.int32)
    return jg, tg, k, part, group_of, max_bw


@pytest.mark.parametrize("name", ["rmat", "hub", "grid-empty"])
def test_grouped_balance_round_matches_jax(name):
    """Rounds of the overload balancer in its group-restricted mode on the
    group-masked graph (as device extension runs them), given the JAX
    package's draws, until the round stops moving; each equals the JAX
    round bit for bit, and no node leaves its group."""
    jg, tg, k, part, group_of, max_bw = grouped_case(name)
    comm = group_of[part]
    jg, tg = jax_masked(jg, comm), tg.community_masked(t(comm))
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    j_labels = jnp.asarray(padded_part(jpv.n_pad, part))
    t_labels = t(padded_part(jpv.n_pad, part))
    moved = 0
    for rnd in range(4):
        key = next_key()
        j_labels, j_flags = jbal._balance_round(
            key, j_labels, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
            jnp.asarray(max_bw), k=k, group_of=jnp.asarray(group_of),
        )
        t_labels, t_flags = tbal._balance_round(
            t_labels, balance_draws(key, jbv, jpv.n_pad, 3), tbv, tg.padded().node_w,
            t(max_bw), k=k, group_of=t(group_of),
        )
        assert_equal(j_labels, t_labels, f"labels, round {rnd}")
        assert_equal(j_flags, t_flags, f"flags, round {rnd}")
        moved += int(t_flags[0])
        if int(t_flags[0]) == 0 or int(t_flags[1]) == 0:
            break
    assert moved > 0
    # nobody left their group
    final = t_labels[: jpv.n].numpy()
    assert np.array_equal(group_of[final], group_of[part])


def underload_case(name):
    """The JAX package's hard cases (tests/test_refinement.py): empty
    blocks, donor minimums, many empty blocks; and an rmat graph with
    random blocks and one thin block."""
    if name == "empty-blocks":
        jg, tg = grid_pair(8, 8)
        return jg, tg, 4, np.zeros(64, dtype=np.int32), np.full(4, 64), np.full(4, 12)
    if name == "donor-minimums":
        jg, tg = grid_pair(8, 8)
        part = np.zeros(64, dtype=np.int32)
        part[40:] = 1
        return jg, tg, 3, part, np.full(3, 64), np.full(3, 16)
    if name == "many-empty-blocks":
        jg, tg = grid_pair(16, 16)
        return jg, tg, 10, np.zeros(256, dtype=np.int32), np.full(10, 256), np.full(10, 20)
    jg, tg = graph_pair("rmat")
    rng = np.random.default_rng(13)
    k = 6
    part = rng.integers(0, k - 1, jg.n).astype(np.int32)
    part[rng.random(jg.n) < 0.02] = k - 1
    W = int(jg.total_node_weight)
    return (jg, tg, k, part, np.full(k, int(W / k * 1.2)), np.full(k, int(W / k * 0.9)))


@pytest.mark.parametrize("name", ["empty-blocks", "donor-minimums", "many-empty-blocks",
                                  "rmat"])
def test_underload_round_matches_jax(name):
    """Underload rounds given the JAX package's draws, as the balancer runs
    them, each equal to the JAX round bit for bit; the minimums are met
    at the end and no donor dropped below its own."""
    jg, tg, k, part, max_bw, min_bw = underload_case(name)
    max_bw, min_bw = max_bw.astype(np.int32), min_bw.astype(np.int32)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    j_labels = jnp.asarray(padded_part(jpv.n_pad, part))
    t_labels = t(padded_part(jpv.n_pad, part))
    for rnd in range(8):
        key = next_key()
        j_labels, j_flags = jbal._underload_round(
            key, j_labels, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
            jnp.asarray(max_bw), jnp.asarray(min_bw), k=k,
        )
        t_labels, t_flags = tbal._underload_round(
            t_labels, balance_draws(key, jbv, jpv.n_pad, 2), tbv, tg.padded().node_w,
            t(max_bw), t(min_bw), k=k,
        )
        assert_equal(j_labels, t_labels, f"labels, round {rnd}")
        assert_equal(j_flags, t_flags, f"flags, round {rnd}")
        if int(t_flags[0]) == 0 or int(t_flags[1]) == 0:
            break
    bw = np.bincount(t_labels[: jpv.n].numpy(), weights=tg.node_w.numpy(), minlength=k)
    assert (bw >= min_bw).all() and (bw <= max_bw).all(), bw


def test_underload_balancer_fills_blocks_and_is_a_noop_without_minimums():
    g = tgen.grid2d_graph(16, 16)
    RandomState.reseed(3)
    pg = PartitionedGraph.create(g, 10, np.zeros(256, dtype=np.int32),
                                 np.full(10, 256), np.full(10, 20))
    assert not pg.is_min_feasible()
    out = tbal.UnderloadBalancer(port_preset("default").refinement.balancer).refine(pg)
    assert out.is_min_feasible() and out.is_feasible()
    assert out.min_block_weights is pg.min_block_weights
    free = PartitionedGraph.create(g, 10, np.zeros(256, dtype=np.int32), np.full(10, 256))
    assert tbal.UnderloadBalancer(port_preset("default").refinement.balancer).refine(
        free) is free


# -- communities: masked layout, masked LP round, restricted coarsening -----


def community_of(n, parts, seed):
    return np.random.default_rng(seed).integers(0, parts, n).astype(np.int32)


@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_masked_layout_and_lp_round_match_jax(name):
    """The community-masked layout (the unmasked plan regathered) equals
    the JAX package's layout of the masked graph, and one clustering LP
    round on it equals JAX's given its draws; no node adopts a label of
    another community."""
    jg, tg = graph_pair(name)
    comm = community_of(jg.n, 3, 14)
    jmg = jax_masked(jg, comm)
    tmg = tg.community_masked(t(comm))
    assert tmg._host_row_ptr is tg._host_row_ptr
    jbv, tbv = jmg.bucketed(), tmg.bucketed()
    for jb, tb in zip(jbv.buckets, tbv.buckets):
        assert_equal(jb.wgts, tb.wgts, "bucket weights")
        assert_equal(jb.cols, tb.cols, "bucket cols")
    assert_equal(jbv.heavy.wgts, tbv.heavy.wgts, "heavy weights")
    assert_equal(jmg.edge_w, tmg.edge_w, "masked edge weights")

    jpv = jmg.padded()
    n_pad = jpv.n_pad
    ids = np.concatenate([np.arange(jpv.n), np.full(n_pad - jpv.n, jpv.anchor)]).astype(
        np.int32)
    js = jlp.init_state(jnp.asarray(ids), jpv.node_w, n_pad)
    ts = tlp.init_state(t(ids), tmg.padded().node_w, n_pad)
    key = next_key()
    max_w = 30
    js = jlp.lp_round_bucketed(js, key, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
                               jnp.asarray(max_w, jnp.int32), num_labels=n_pad,
                               active_prob=0.5)
    ts = tlp.lp_round_bucketed(ts, jax_round_draws(key, jbv, n_pad, active_prob=0.5), tbv,
                               tmg.padded().node_w, torch.tensor(max_w, dtype=torch.int32),
                               num_labels=n_pad, active_prob=0.5)
    assert_equal(js.labels, ts.labels, "labels")
    assert int(js.num_moved) == int(ts.num_moved) > 0
    lab = ts.labels[: jpv.n].numpy()
    assert np.array_equal(comm[lab], comm)


def test_restricted_coarsening_keeps_communities():
    """Coarsening with communities: no cluster spans two communities, and
    each coarse node carries its members' community, level after level."""
    g = tgen.rmat_graph(9, 8, seed=1)
    ctx = port_preset("default")
    comm = community_of(g.n, 4, 15)
    c = ClusterCoarsener(ctx, g)
    c.set_communities(torch.from_numpy(comm))
    assert c.coarsen(4, 0.03, 64).n < g.n
    assert c.num_levels >= 2
    fine_comm = torch.from_numpy(comm)
    for level in c.hierarchy:
        n_c = level.graph.n
        lo = segment_min(fine_comm, level.coarse_of, n_c)
        hi = segment_max(fine_comm, level.coarse_of, n_c)
        assert torch.equal(lo, hi), "a cluster spans two communities"
        assert torch.equal(level.communities, hi)
        fine_comm = level.communities
    assert torch.equal(c.current_communities, fine_comm)


def test_communities_refused_on_a_compressed_view():
    g = tgen.grid2d_graph(16, 16)
    cv = DeviceCompressedView(compress(g), "cpu")
    c = ClusterCoarsener(port_preset("terapart"), None, compressed_view=cv)
    with pytest.raises(ValueError, match="compressed"):
        c.set_communities(torch.zeros(g.n, dtype=torch.int32))


# -- device extension and the pooled host jobs ------------------------------


def extension_ctx(preset_fn, W, k, **ipc):
    ctx = preset_fn("default")
    ctx.seed = 1
    ctx.coarsening.contraction_limit = 64
    ctx.initial_partitioning.device_extension = True
    ctx.initial_partitioning.device_extension_n = 256
    ctx.initial_partitioning.device_extension_cpb = 16
    for key, value in ipc.items():
        setattr(ctx.initial_partitioning, key, value)
    ctx.partition.setup(W, k, 0.03)
    return ctx


def test_device_extension_refines_blocks_balances_and_matches_jax_cut():
    """Device extension of a 4-way partition of a 32x32 grid into 16
    blocks (nested coarsening down to 256 nodes): every node's new block
    lies in its old block's range, the intermediate budgets hold, all
    blocks are filled, and the cut is within 1.30x of the JAX package's
    device extension."""
    jg, tg = grid_pair(32, 32)
    k, cur_k, new_k = 16, 4, 16
    rows = np.arange(jg.n) // 32
    cols = np.arange(jg.n) % 32
    part4 = ((rows >= 16) * 2 + (cols >= 16)).astype(np.int32)

    JaxRandomState.reseed(7)
    jctx = extension_ctx(jax_preset, int(jg.total_node_weight), k, ip_backend="host")
    jout = jax_extend_partition(jg, part4, cur_k, new_k, jctx)

    RandomState.reseed(7)
    tctx = extension_ctx(port_preset, tg.total_node_weight, k)
    jobs = tdeep.new_job_stats()
    tout = tdeep.extend_partition(tg, part4, cur_k, new_k, tctx, jobs)
    assert jobs["device"] == 1 and jobs["device_s"] > 0 and jobs["bisections"] == cur_k

    off_new, off_cur = split_offsets(k, new_k), split_offsets(k, cur_k)
    lo_of = np.searchsorted(off_new, off_cur)
    parent_of_new = np.searchsorted(lo_of, np.arange(new_k), side="right") - 1
    assert tout.shape == (tg.n,) and tout.dtype == np.int32
    assert np.array_equal(parent_of_new[tout], part4)
    inter = intermediate_block_weights(np.asarray(tctx.partition.max_block_weights), new_k)
    bw = np.bincount(tout, minlength=new_k)
    assert (bw <= inter).all(), (bw, inter)
    assert len(np.unique(tout)) == new_k
    tcut = tmetrics.edge_cut(tg, tout)
    jcut = int(jmetrics.edge_cut(jg, jout))
    assert tcut <= 1.30 * jcut, (tcut, jcut)


@pytest.mark.parametrize("preset,k,ipc", [
    ("largek", 64, dict(device_extension_n=256)),
    ("default", 16, dict(nested_extension_n=64)),
], ids=["largek-device-extension", "default-nested-jobs"])
def test_pooled_extension_equals_serial(monkeypatch, preset, k, ipc):
    """The whole facade with the extension jobs on 8 worker threads and on
    one: the same partition and the same job counts (every job runs under
    its own seed, and the launch counters are locked)."""
    g = tgen.rmat_graph(10, 8, seed=1)
    results = []
    for workers in (8, 1):
        monkeypatch.setattr(platform, "host_pool_workers",
                            lambda jobs, w=workers: min(max(jobs, 1), w))
        solver = kp.KaMinPar(preset, device="cpu")
        solver.ctx.seed = 2
        for key, value in ipc.items():
            setattr(solver.ctx.initial_partitioning, key, value)
        solver.set_graph(g)
        part = solver.compute_partition(k)
        assert solver.last_partition.is_feasible()
        results.append((part, dict(solver.last_partitioner.extension_jobs)))
    assert np.array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]
    jobs = results[0][1]
    assert jobs["device" if preset == "largek" else "nested"] > 0


def test_extension_pool_width_by_device():
    """One thread a job (up to the cores, at most 16) for CPU tensors; one
    thread on a CUDA device, where concurrent jobs contend for the GIL."""
    assert platform.extension_workers(5, "cpu") == platform.host_pool_workers(5) >= 1
    assert platform.extension_workers(40, torch.device("cpu")) <= 16
    assert platform.extension_workers(5, torch.device("cuda", 0)) == 1


def test_launch_counter_survives_concurrent_increments():
    """Many threads bumping the kernel launch counter with a short switch
    interval lose no update."""
    saved = sys.getswitchinterval()
    lp_kernels.reset_launches()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [lp_kernels._count_launch("lp_commit")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(saved)
    assert lp_kernels.LAUNCHES["lp_commit"] == 16 * 2000
    lp_kernels.reset_launches()


# -- minimum block weights and the largek presets through the facade --------


def expected_min_bw(W, k, min_eps):
    return min(math.ceil((1.0 - min_eps) * -(-W // k)), W // k)


def test_min_weights_reach_the_stripped_work_graph(monkeypatch):
    """With isolated nodes stripped, the work graph is held to the whole
    graph's minimums (as the JAX facade holds it), and the returned
    partition, isolated nodes re-inserted, meets them."""
    g = tgen.rmat_graph(9, 4, seed=3)
    assert (np.diff(g.host_row_ptr()) == 0).any()
    seen = []
    create = tkaminpar.create_partitioner

    def spy(ctx, graph, **kwargs):
        seen.append((graph.n, np.array(ctx.partition.min_block_weights)))
        return create(ctx, graph, **kwargs)

    monkeypatch.setattr(tkaminpar, "create_partitioner", spy)
    k, min_eps = 4, 0.05
    solver = kp.KaMinPar("default", device="cpu")
    solver.set_graph(g)
    part = solver.compute_partition(k, epsilon=0.05, min_epsilon=min_eps)
    W = g.total_node_weight
    want = np.full(k, expected_min_bw(W, k, min_eps))
    (work_n, work_min), = seen
    assert work_n < g.n and np.array_equal(work_min, want)
    js = JaxKaMinPar("default")
    js.set_graph(jgen.rmat_graph(9, 4, seed=3))
    js.ctx.initial_partitioning.ip_backend = "host"
    js.compute_partition(k, epsilon=0.05, min_epsilon=min_eps)
    assert np.array_equal(js.ctx.partition.min_block_weights, want)
    p = solver.last_partition
    assert p.is_feasible() and p.is_min_feasible()
    assert np.array_equal(p.min_block_weights, want)
    assert (np.bincount(part, weights=g.node_w.numpy(), minlength=k) >= want).all()


def test_explicit_min_block_weights_are_held():
    g = tgen.grid2d_graph(20, 20)
    solver = kp.KaMinPar("default", device="cpu")
    solver.set_graph(g)
    part = solver.compute_partition(4, max_block_weights=[130, 130, 130, 130],
                                    min_block_weights=[70, 70, 70, 120])
    bw = np.bincount(part, minlength=4)
    assert (bw >= [70, 70, 70, 120]).all() and (bw <= 130).all(), bw


QUALITY_CELLS = {
    "largek-grid32-k32": ("largek", lambda m: m.grid2d_graph(32, 32), 32, 0.0),
    "default-min-rmat10-k8": ("default", lambda m: m.rmat_graph(10, 8, seed=1), 8, 0.03),
    "default-min-rgg2048-k4": ("default", lambda m: m.rgg2d_graph(2048, seed=1), 4, 0.03),
}


@pytest.mark.parametrize("cell", list(QUALITY_CELLS))
def test_facade_quality_matches_jax_facade(cell):
    """The port's facade against the JAX facade (host pool, seed 1): both
    feasible and min-feasible, the port's cut at most 1.30x. The largek
    cell lowers ``device_extension_n`` on both sides so that device
    extension runs at this size."""
    preset, make, k, min_eps = QUALITY_CELLS[cell]
    jg, tg = make(jgen), make(tgen)
    js = JaxKaMinPar(preset)
    ts = kp.KaMinPar(preset, device="cpu")
    js.ctx.initial_partitioning.ip_backend = "host"
    for s in (js, ts):
        s.ctx.seed = 1
        s.ctx.initial_partitioning.device_extension_n = 512
    js.set_graph(jg)
    ts.set_graph(tg)
    jpart = js.compute_partition(k, epsilon=0.03, min_epsilon=min_eps)
    tpart = ts.compute_partition(k, epsilon=0.03, min_epsilon=min_eps)
    assert jmetrics.is_feasible(jg, jpart, k, js.ctx.partition.max_block_weights)
    assert tmetrics.is_feasible(tg, tpart, k, ts.ctx.partition.max_block_weights)
    if min_eps:
        assert jmetrics.is_min_feasible(jg, jpart, k, js.ctx.partition.min_block_weights)
        assert tmetrics.is_min_feasible(tg, tpart, k, ts.ctx.partition.min_block_weights)
    if preset == "largek":
        assert ts.last_partitioner.extension_jobs["device"] > 0
        assert len(np.unique(tpart)) == k
    jcut, tcut = int(jmetrics.edge_cut(jg, jpart)), tmetrics.edge_cut(tg, tpart)
    assert tcut <= 1.30 * jcut, f"{cell}: port cut {tcut} vs JAX cut {jcut}"


def largek_rmat_cut_ratios(scale: int, k: int, seed: int = 1,
                           device_extension_n: int = 2048,
                           ip_backend: str = "host") -> dict:
    """``KaMinPar("largek")`` of both packages on the CPU (solver seed 1,
    both sides' bisections on ``ip_backend``: "host" or the device pool,
    "device") into ``k`` blocks of ``rmat_graph(scale, 16, seed)``: per
    side the cut, its ratio to a random k-way partition's expected cut
    W (1 - 1/k), feasibility and the blocks used.  The test below runs it
    at scale 11; the larger runs in PERF.md come from running it alone,
    for example ``cd tests && PYTHONPATH=.. JAX_PLATFORMS=cpu python -c
    "import test_torch_extension as t; print(t.largek_rmat_cut_ratios(14,
    1024, device_extension_n=32768, ip_backend='device'))"``."""
    out = {}
    for side, gen, metrics, make in (("jax", jgen, jmetrics, JaxKaMinPar),
                                     ("port", tgen, tmetrics,
                                      lambda preset: kp.KaMinPar(preset, device="cpu"))):
        g = gen.rmat_graph(scale, 16, seed=seed)
        solver = make("largek")
        solver.ctx.initial_partitioning.ip_backend = ip_backend
        solver.ctx.seed = 1
        solver.ctx.initial_partitioning.device_extension_n = device_extension_n
        solver.set_graph(g)
        part = np.asarray(solver.compute_partition(k, epsilon=0.03))
        cut = int(metrics.edge_cut(g, part))
        random_cut = int(g.total_edge_weight) // 2 * (1 - 1 / k)
        out[side] = dict(cut=cut, ratio=cut / random_cut, blocks=len(np.unique(part)),
                         feasible=bool(metrics.is_feasible(
                             g, part, k, solver.ctx.partition.max_block_weights)))
    return out


def test_largek_rmat_cut_at_large_k_tracks_jax():
    """RMAT graphs into many small blocks cut close to a random
    partition's under the reference's largek too: on ``rmat_graph(11)``
    into 128 blocks both packages are feasible with every block used, and
    the port's cut is within 5% of the JAX package's (tighter than the
    1.30x of the quality cells: a cut over a hundred blocks varies
    little between seeds)."""
    r = largek_rmat_cut_ratios(11, 128, device_extension_n=256)
    assert r["jax"]["feasible"] and r["port"]["feasible"], r
    assert r["jax"]["blocks"] == r["port"]["blocks"] == 128, r
    assert r["port"]["cut"] <= 1.05 * r["jax"]["cut"], r


def test_largek_presets_and_terapart_largek_on_the_cpu():
    for name in ("largek", "largek-fast", "terapart-largek"):
        jctx, tctx = jax_preset(name), port_preset(name)
        assert tctx.coarsening.contraction_limit == jctx.coarsening.contraction_limit == 640
        assert tctx.initial_partitioning.device_extension is True
        assert tctx.refinement.lp.num_iterations == jctx.refinement.lp.num_iterations
        assert tctx.compression.enabled == jctx.compression.enabled
    with pytest.raises(ValueError, match="largek-fast"):
        port_preset("no-such-preset")
    g = tgen.rmat_graph(10, 8, seed=1)
    solver = kp.KaMinPar("terapart-largek", device="cpu")
    solver.ctx.initial_partitioning.device_extension_n = 256
    solver.set_graph(g)
    part = solver.compute_partition(32)
    assert solver.last_partitioner.compressed_view is not None
    assert solver.last_partitioner.extension_jobs["device"] > 0
    assert solver.last_partition.is_feasible() and part.shape == (g.n,)


def test_min_weights_repaired_on_the_whole_graph(monkeypatch):
    """rmat_graph(11, 16, seed=1) into 16 blocks at min_epsilon 0.01: the
    work graph cannot reach the whole graph's minimums, and packing the
    isolated nodes leaves a block short; the facade then runs the
    underload balancer on the whole graph, and the result is feasible and
    min-feasible."""
    calls = []
    refine = tbal.UnderloadBalancer.refine

    def spy(self, p_graph):
        calls.append(p_graph.graph.n)
        return refine(self, p_graph)

    monkeypatch.setattr(tbal.UnderloadBalancer, "refine", spy)
    g = tgen.rmat_graph(11, 16, seed=1)
    solver = kp.KaMinPar("default", device="cpu")
    solver.ctx.seed = 0
    solver.set_graph(g)
    part = solver.compute_partition(16, epsilon=0.03, min_epsilon=0.01)
    assert calls[-1] == g.n  # the repair on the whole graph ran
    p = solver.last_partition
    assert p.is_feasible() and p.is_min_feasible()
    assert tmetrics.edge_cut(g, part) == p.edge_cut()
