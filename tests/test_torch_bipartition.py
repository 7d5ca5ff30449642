"""Port parity of the device bipartition pool (``ops/bipartition.py``).

The port's pool and its steps run on CPU tensors against the JAX
package's pool (``kaminpar_tpu/ops/bipartition.py``, on the CPU), both fed
the JAX package's own draws (:class:`JaxPoolDraws` hands out what the
reference draws from its lane keys).  Every value is an integer, so every
comparison is exact: labels and all six stats.  The JAX pool compiles once
per (n_pad, m_pad, lanes) cell, so the graphs share few cells.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.context import InitialPartitioningContext as JIPC
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.initial import bipartitioner as jbi
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.ops import bipartition as jbip
from kaminpar_tpu.partitioning.kway import graph_to_host
from kaminpar_tpu_torch.context import InitialPartitioningContext as TIPC
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics as tmetrics
from kaminpar_tpu_torch.graph.csr import from_numpy_csr
from kaminpar_tpu_torch.initial import bipartitioner as tbi
from kaminpar_tpu_torch.ops import bipartition as tbip


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that runs several JAX-heavy
    modules in one process can otherwise reach the kernel's limit on them."""
    yield
    jax.clear_caches()


I32MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.partial(jax.jit, static_argnums=(1,))
def _prio(keys, n_pad):
    return jax.vmap(lambda k: jbip._rand_prio(k)((n_pad,)))(keys)


@functools.partial(jax.jit, static_argnums=(2,))
def _prio_fold(keys, t, n_pad):
    return jax.vmap(lambda k: jbip._rand_prio(jax.random.fold_in(k, t))((n_pad,)))(keys)


def _fm_draws_one(key, n_pad):
    """``_fm_round``'s priorities and coins from its key."""
    kp_, kc = jax.random.split(key)
    return jbip._rand_prio(kp_)((n_pad,)), jax.random.bernoulli(kc, 0.5, (n_pad,))


@functools.partial(jax.jit, static_argnums=(2,))
def _fm_draws(keys, t, n_pad):
    return jax.vmap(lambda k: _fm_draws_one(jax.random.fold_in(k, t), n_pad))(keys)


@jax.jit
def _seed_draws(keys, n):
    return jax.vmap(lambda k: jax.random.randint(k, (), 0, jnp.maximum(n, 1)))(keys)


class JaxPoolDraws(tbip.PoolDraws):
    """The reference pool's draws: lane keys from ``method_lane_keys``,
    ``k_seed, k_grow, k_reb, k_fm = split(lane_key, 4)``, and each draw as
    ``_lane_bipartition`` and ``_fm_round`` take it."""

    def __init__(self, seed, methods, n_pad):
        keys = jbip.method_lane_keys(seed, methods)
        ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
        self.k_seed, self.k_grow, self.k_reb, self.k_fm = (ks[:, i] for i in range(4))
        self.G = tbip.grow_lane_count(methods)
        self.n_pad = n_pad

    def seed(self, n):
        return _t(_seed_draws(self.k_seed[: self.G], jnp.asarray(n, jnp.int32))).long()

    def order(self):
        return _t(_prio(self.k_seed[self.G :], self.n_pad))

    def grow(self, t):
        return _t(_prio_fold(self.k_grow[: self.G], jnp.asarray(t, jnp.int32), self.n_pad))

    def rebalance(self, i):
        return _t(_prio_fold(self.k_reb, jnp.asarray(i, jnp.int32), self.n_pad))

    def fm(self, t):
        p, c = _fm_draws(self.k_fm, jnp.asarray(t, jnp.int32), self.n_pad)
        return _t(p), _t(c)


GRAPHS = {
    "rmat": lambda: jgen.rmat_graph(7, 8, seed=1),
    "grid": lambda: jgen.grid2d_graph(12, 12),
    "star": lambda: jgen.star_graph(48),
}


@functools.lru_cache(maxsize=None)
def host_graph(name):
    return graph_to_host(GRAPHS[name]())


def pool_graphs(host):
    """The reference's padded view and the port's PoolGraph of one host
    graph (the same n_pad, m_pad and padding)."""
    from kaminpar_tpu.graph.csr import from_numpy_csr as jax_from_numpy_csr

    jpv = jax_from_numpy_csr(host.row_ptr, host.col_idx, host.node_w, host.edge_w).padded()
    tpv = from_numpy_csr(host.row_ptr, host.col_idx, host.node_w, host.edge_w).padded()
    assert (jpv.n_pad, jpv.m_pad) == (tpv.n_pad, tpv.m_pad)
    return jpv, tbip.PoolGraph.from_padded(tpv, host.total_node_weight)


def random_membership(rng, R, n_pad, n, p):
    in0 = rng.random((R, n_pad)) < p
    in0[:, n:] = False
    return in0


# ---------------------------------------------------------------------------
# Layout and step functions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("final_k", [1, 2, 3, 4, 8, 16, 64])
def test_method_lane_counts_and_trip_counts_match(final_k):
    variants = [
        {},
        dict(min_num_repetitions=1, max_num_repetitions=3),
        dict(min_num_repetitions=5, max_num_repetitions=20),
        dict(use_adaptive_bipartitioner_selection=False),
        dict(enable_bfs_bipartitioner=False),
        dict(enable_ggg_bipartitioner=False, enable_random_bipartitioner=False),
    ]
    for kw in variants:
        assert tbip.method_lane_counts(TIPC(**kw), final_k) == jbip.method_lane_counts(
            JIPC(**kw), final_k)
    none = dict(enable_bfs_bipartitioner=False, enable_ggg_bipartitioner=False,
                enable_random_bipartitioner=False)
    with pytest.raises(ValueError):
        tbip.method_lane_counts(TIPC(**none), final_k)
    for n_pad in (256, 384, 1024, 5888, 65536, 2**22):
        assert tbip.grow_trip_count(n_pad) == jbip.grow_trip_count(n_pad)
        for it in (1, 5, 300):
            assert tbip.fm_round_count(n_pad, it) == jbip.fm_round_count(n_pad, it)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_connections_match(name):
    host = host_graph(name)
    jpv, g = pool_graphs(host)
    in0 = random_membership(np.random.default_rng(1), 5, g.n_pad, host.n, 0.5)
    ref = jax.vmap(lambda m: jbip._connections(m, jpv.edge_u, jpv.col_idx, jpv.edge_w,
                                               jpv.n_pad))(jnp.asarray(in0))
    out = tbip._connections(torch.from_numpy(in0), g)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r), o.numpy())


ADMIT_CASES = ["ties", "heavy", "gain-keys"]


@pytest.mark.parametrize("case", ADMIT_CASES)
def test_admit_prefix_matches(case):
    """Ties (priorities from 4 values, so the node index decides), a
    candidate heavier than the whole budget at the head of the order, and
    (prio, -gain) keys with negative gains and INT32-range priorities."""
    rng = np.random.default_rng(3)
    R, n = 6, 300
    node_w = rng.integers(1, 5, n).astype(np.int32)
    cand = rng.random((R, n)) < 0.6
    budget = rng.integers(0, 200, R).astype(np.int64)
    neg = None
    if case == "ties":
        prio = rng.integers(0, 4, (R, n)).astype(np.int32)
    else:
        prio = rng.integers(0, I32MAX, (R, n)).astype(np.int32)
    if case == "heavy":
        node_w[int(np.argmin(prio[0]))] = 10_000
        cand[0, int(np.argmin(prio[0]))] = True
    if case == "gain-keys":
        neg = rng.integers(-50, 50, (R, n)).astype(np.int32)
    keys = (jnp.asarray(prio),) if neg is None else (jnp.asarray(prio), jnp.asarray(neg))
    ref = jax.vmap(lambda ks, c, b: jbip._admit_prefix(ks, c, jnp.asarray(node_w), b))(
        keys, jnp.asarray(cand), jnp.asarray(budget, jnp.int32))
    out = tbip._admit_prefix(torch.from_numpy(prio),
                             None if neg is None else torch.from_numpy(neg),
                             torch.from_numpy(cand), torch.from_numpy(node_w),
                             torch.from_numpy(budget))
    np.testing.assert_array_equal(np.asarray(ref[0]), out[0].numpy())
    np.testing.assert_array_equal(np.asarray(ref[1]), out[1].numpy())
    if case == "heavy":
        assert not out[0][0, int(np.argmin(prio[0]))]


def _reference_keys(R, seed=9):
    return jax.vmap(lambda i: jax.random.fold_in(jax.random.key(seed), i))(
        jnp.arange(R, dtype=jnp.uint32))


@pytest.mark.parametrize("side", [0, 1])
def test_rebalance_side_matches(side):
    host = host_graph("rmat")
    jpv, g = pool_graphs(host)
    R = 6
    in0 = random_membership(np.random.default_rng(4 + side), R, g.n_pad, host.n,
                            0.75 if side == 0 else 0.25)
    W = host.total_node_weight
    mw0, mw1 = int(0.55 * W), int(0.52 * W)
    keys = _reference_keys(R)
    ref = jax.vmap(lambda k, m: jbip._rebalance_side(
        k, m, jpv.edge_u, jpv.col_idx, jpv.edge_w, jpv.node_w, jnp.asarray(mw0, jnp.int32),
        jnp.asarray(mw1, jnp.int32), side=side))(keys, jnp.asarray(in0))
    out = tbip._rebalance_side(_t(_prio(keys, g.n_pad)), torch.from_numpy(in0), g, mw0, mw1,
                               side=side)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert not np.array_equal(out.numpy(), in0)  # the pass moved nodes


def test_rebalance_skips_unmovable_heavy_node():
    """The reference's case: path 0-1-2, node 0 heavy, block 0 = {0, 1}
    overweight by 1; only node 1 can move."""
    row_ptr = np.array([0, 1, 3, 4], dtype=np.int64)
    col = np.array([1, 0, 2, 1], dtype=np.int64)
    nw = np.array([100, 1, 1], dtype=np.int64)
    host = jbi.HostCSR(row_ptr, col, nw, np.ones(4, dtype=np.int64))
    jpv, g = pool_graphs(host)
    in0 = np.zeros((1, g.n_pad), dtype=bool)
    in0[0, :2] = True
    keys = _reference_keys(1, seed=0)
    ref = jax.vmap(lambda k, m: jbip._rebalance_side(
        k, m, jpv.edge_u, jpv.col_idx, jpv.edge_w, jpv.node_w, jnp.asarray(100, jnp.int32),
        jnp.asarray(50, jnp.int32), side=0))(keys, jnp.asarray(in0))
    out = tbip._rebalance_side(_t(_prio(keys, g.n_pad)), torch.from_numpy(in0), g, 100, 50,
                               side=0).numpy()
    np.testing.assert_array_equal(np.asarray(ref), out)
    assert out[0, 0] and not out[0, 1]


@pytest.mark.parametrize("side0", [True, False])
def test_fm_round_matches(side0):
    host = host_graph("grid")
    jpv, g = pool_graphs(host)
    R = 6
    in0 = random_membership(np.random.default_rng(6), R, g.n_pad, host.n, 0.5)
    W = host.total_node_weight
    mw0 = mw1 = int(0.6 * W)
    keys = _reference_keys(R, seed=2)
    ref = jax.vmap(lambda k, m: jbip._fm_round(
        k, m, jpv.edge_u, jpv.col_idx, jpv.edge_w, jpv.node_w, jnp.asarray(mw0, jnp.int32),
        jnp.asarray(mw1, jnp.int32), side0))(keys, jnp.asarray(in0))
    prio, coin = jax.vmap(lambda k: _fm_draws_one(k, g.n_pad))(keys)
    t_in0 = torch.from_numpy(in0)
    out = tbip._fm_round(_t(prio), _t(coin), t_in0, tbip._connections(t_in0, g), g, mw0, mw1,
                         side0)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert not np.array_equal(out.numpy(), in0)


# ---------------------------------------------------------------------------
# The whole pool.
# ---------------------------------------------------------------------------


def budgets(host, kind):
    W = host.total_node_weight
    frac = {"loose": (0.55, 0.55), "tight": None, "uneven": (0.30, 0.75),
            "infeasible": (1 / 3, 1 / 3)}[kind]
    if frac is None:
        return np.array([W // 2 + 1, W // 2 + 1], dtype=np.int64)
    return np.array([int(frac[0] * W), int(frac[1] * W)], dtype=np.int64)


POOL_CASES = [("rmat", "loose", 2), ("rmat", "uneven", 2), ("rmat", "loose", 16),
              ("grid", "loose", 2), ("grid", "tight", 2), ("grid", "infeasible", 2),
              ("star", "loose", 2), ("star", "tight", 2), ("star", "infeasible", 2)]


@pytest.mark.parametrize("name,budget,final_k", POOL_CASES)
def test_pool_matches_reference(name, budget, final_k):
    host = host_graph(name)
    mw = budgets(host, budget)
    args = (host.row_ptr, host.col_idx, host.node_w, host.edge_w, mw, 5)
    jl, js = jbip.pool_bipartition_device(*args, JIPC(), final_k)
    tl, ts = tbip.pool_bipartition_device(*args, TIPC(), final_k, draws=JaxPoolDraws)
    np.testing.assert_array_equal(jl, tl)
    assert ts == js
    assert tl.dtype == np.int32 and tl.shape == (host.n,)
    if budget == "tight":
        assert ts["feasible"] and ts["num_feasible"] == ts["lanes"]
    if budget == "infeasible":
        assert not ts["feasible"] and ts["num_feasible"] == 0


def test_pool_method_by_method_equals_whole_pool(monkeypatch):
    """Lanes are independent: the pool run method by method (what a pool
    too large for one pass does) gives the whole pool's result, with the
    reference's and with the production draws."""
    host = host_graph("rmat")
    mw = budgets(host, "loose")
    args = (host.row_ptr, host.col_idx, host.node_w, host.edge_w, mw, 3, TIPC(), 4)
    methods = (("bfs", 4), ("ggg", 4), ("random", 4))
    assert tbip.edge_temp_budget("cpu") is None
    assert tbip.lane_chunks(methods, 1 << 10, None) == [slice(0, 12)]
    assert tbip.lane_chunks(methods, 1 << 10, 12 * 13 << 10) == [slice(0, 12)]
    assert tbip.lane_chunks(methods, 1 << 10, (12 * 13 << 10) - 1) == [
        slice(0, 4), slice(4, 8), slice(8, 12)]
    tbip.reset_pool_stats()
    whole = [tbip.pool_bipartition_device(*args, draws=d) for d in (JaxPoolDraws, None)]
    assert tbip.pool_stats_snapshot()["chunked_calls"] == 0
    monkeypatch.setattr(tbip, "edge_temp_budget", lambda device: 0)
    split = [tbip.pool_bipartition_device(*args, draws=d) for d in (JaxPoolDraws, None)]
    assert tbip.pool_stats_snapshot()["chunked_calls"] == 2
    for (wl, ws), (sl, ss) in zip(whole, split):
        np.testing.assert_array_equal(wl, sl)
        assert ws == ss


def test_generator_draws_are_functions_of_their_arguments():
    methods = (("bfs", 4), ("ggg", 4), ("random", 4))
    a = tbip.GeneratorPoolDraws(7, methods, 256, "cpu")
    b = tbip.GeneratorPoolDraws(7, methods, 256, "cpu")
    g1 = a.grow(3)
    a.fm(0)
    assert torch.equal(g1, a.grow(3)) and torch.equal(g1, b.grow(3))
    assert g1.shape == (8, 256) and a.order().shape == (4, 256)
    assert not torch.equal(g1, a.grow(4))
    assert not torch.equal(g1, tbip.GeneratorPoolDraws(8, methods, 256, "cpu").grow(3))
    seeds = a.seed(100)
    assert seeds.shape == (8,) and int(seeds.min()) >= 0 and int(seeds.max()) < 100
    prio, coin = a.fm(5)
    assert prio.dtype == torch.int32 and coin.dtype == torch.bool
    assert 0 <= int(prio.min()) and int(prio.max()) < I32MAX
    rec = tbip.RecordedPoolDraws(a, methods, 100, grow_trips=4, fm_rounds=6)
    assert torch.equal(rec.grow(3), g1) and torch.equal(rec.fm(5)[1], coin)
    with pytest.raises(ValueError):
        rec.seed(99)


def test_recursive_bipartition_device_matches_reference():
    """k = 4 with ip_backend="device" on both sides: the same host rng
    draws each bisection's seed, the same draws run each pool."""
    host = host_graph("grid")
    W = host.total_node_weight
    mbw = np.full(4, -(-W // 4) + 2, dtype=np.int64)
    jctx = dataclasses.replace(JIPC(), ip_backend="device")
    tctx = dataclasses.replace(TIPC(), ip_backend="device")
    jpart = jbi.recursive_bipartition(host, 4, mbw, np.random.default_rng(11), jctx)
    tpart = tbi.recursive_bipartition(host, 4, mbw, np.random.default_rng(11), tctx,
                                      draws=JaxPoolDraws)
    np.testing.assert_array_equal(jpart, tpart)
    assert set(np.unique(tpart)) == {0, 1, 2, 3}


def test_resolve_ip_backend_modes():
    ipc = TIPC()
    assert ipc.ip_backend == "auto"
    assert tbi.resolve_ip_backend(ipc, torch.device("cpu")) == "host"
    assert tbi.resolve_ip_backend(ipc, None) == "host"
    assert tbi.resolve_ip_backend(ipc, torch.device("cuda", 0)) == "device"
    assert tbi.resolve_ip_backend(ipc, "cuda") == "device"
    assert tbi.resolve_ip_backend(None, "cuda") == "device"
    for mode, devices in (("host", ("cpu",)), ("device", ("cpu", "cuda"))):
        for dev in devices:
            assert tbi.resolve_ip_backend(dataclasses.replace(ipc, ip_backend=mode), dev) == mode
    # The card path cannot be switched off: "host" is for CPU graphs only.
    with pytest.raises(ValueError):
        tbi.resolve_ip_backend(dataclasses.replace(ipc, ip_backend="host"), "cuda")
    with pytest.raises(ValueError):
        tbi.resolve_ip_backend(dataclasses.replace(ipc, ip_backend="gpu"), "cpu")


def test_int32_guard_sends_the_bisection_to_the_host_pool(capsys):
    """Weights at or beyond 2^31 are decided up front: the host pool serves
    the bisection (the same partition as ip_backend="host"), the decision is
    logged and counted, and the pool itself refuses such weights."""
    host = graph_to_host(jgen.path_graph(6))
    big = host._replace(node_w=np.full(6, 2**29, dtype=np.int64))
    mw = np.array([2**31, 2**31], dtype=np.int64)
    ctx = dataclasses.replace(TIPC(), ip_backend="device")
    tbip.reset_pool_stats()
    part = tbi.multilevel_bipartition(big, mw, np.random.default_rng(2), ctx)
    host_part = tbi.multilevel_bipartition(
        big, mw, np.random.default_rng(2), dataclasses.replace(ctx, ip_backend="host"))
    np.testing.assert_array_equal(part, host_part)
    snap = tbip.pool_stats_snapshot()
    assert snap["host_bisections"] == 1 and snap["calls"] == 0
    assert "host pool" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tbip.pool_bipartition_device(big.row_ptr, big.col_idx, big.node_w, big.edge_w, mw, 0,
                                     ctx)
    # Within range, the same graph takes the pool.
    small_mw = np.array([4, 4], dtype=np.int64)
    tbi.multilevel_bipartition(host, small_mw, np.random.default_rng(2), ctx)
    snap = tbip.pool_stats_snapshot()
    assert snap["calls"] == 1 and snap["lanes_launched"] == 12
    assert snap["lane_occupancy"] == 1.0


def test_facade_device_pool_quality_matches_jax_facade():
    """KaMinPar("default") with ip_backend="device" in both packages (the
    port on CPU tensors, its own generator draws): both feasible, the
    port's cut within 1.30x of the JAX cut, as in
    test_torch_pipeline.test_port_quality_matches_jax_facade."""
    jg, tg = jgen.rmat_graph(8, 8, seed=1), tgen.rmat_graph(8, 8, seed=1)
    k = 4
    js = JaxKaMinPar("default")
    js.ctx.seed = 1
    js.ctx.initial_partitioning.ip_backend = "device"
    js.set_graph(jg)
    jpart = js.compute_partition(k)
    ts = kp.KaMinPar("default", device="cpu")
    ts.ctx.seed = 1
    ts.ctx.initial_partitioning.ip_backend = "device"
    ts.set_graph(tg)
    tbip.reset_pool_stats()
    tpart = ts.compute_partition(k)
    assert tbip.pool_stats_snapshot()["calls"] > 0
    assert jmetrics.is_feasible(jg, jpart, k, js.ctx.partition.max_block_weights)
    assert tmetrics.is_feasible(tg, tpart, k, ts.ctx.partition.max_block_weights)
    jcut, tcut = jmetrics.edge_cut(jg, jpart), tmetrics.edge_cut(tg, tpart)
    assert tcut / max(jcut, 1) <= 1.30, f"port cut {tcut} vs JAX cut {jcut}"
    coarsest = ts.last_partitioner.coarsest
    assert coarsest["k0"] >= 2 and coarsest["n"] > 0
    assert ts.last_partitioner.extension_jobs["bisections"] > 0
