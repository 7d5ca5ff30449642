"""Port parity of the quality refiners: JET, k-way FM and colored LP.

Each piece runs in both packages on the same seeded input:

- JET's move round (find + filter) bit for bit, given the JAX package's
  rating ties (drawn per bucket from the round key, as
  ``bucketed_best_moves`` draws them); the neighbour reduce under JET's
  contribution function bit for bit; the whole ``JetRefiner`` on a fixed
  input partition within 5% of the JAX cut (the balancer rounds inside it
  draw from each package's own stream);
- FM's host pass and refiner bit for bit, both packages' numpy generator
  given the same seed: the dense and the sparse connection table, int64
  connections, the sparse table's budget and the ``max_n`` skip;
- the colouring bit for bit given the JAX package's per-round priorities,
  the colored LP superstep and iteration bit for bit against the JAX
  package's XLA round and its Pallas round (interpret mode), given its
  keys, and ``CLPRefiner``'s keep-the-better rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu import context as jctx
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph.partitioned import PartitionedGraph as JPartitionedGraph
from kaminpar_tpu.ops import bucketed_gains as jbg
from kaminpar_tpu.ops import coloring as jcol
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.ops import pallas_lp
from kaminpar_tpu.refinement import fm_refiner as jfm
from kaminpar_tpu.refinement import jet as jjet
from kaminpar_tpu.utils import RandomState as JRandomState
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch import context as tctx
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
from kaminpar_tpu_torch.ops import bucketed_gains as tbg
from kaminpar_tpu_torch.ops import coloring as tcol
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.refinement import clp_refiner as tclp
from kaminpar_tpu_torch.refinement import fm_refiner as tfm
from kaminpar_tpu_torch.refinement import jet as tjet
from kaminpar_tpu_torch.utils import RandomState
from test_torch_lp_kernels import (I32MAX, assert_equal, assert_state_equal, graph_pair,
                                   jax_round_draws, jax_ties, t)


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


def random_blocks(n_pad, n, k, rng):
    part = np.zeros(n_pad, dtype=np.int32)
    part[:n] = rng.integers(0, k, n)
    return part


def stripe_blocks(n, k, rng, noise=0.1):
    """Contiguous id ranges as blocks, a share of the nodes moved to a
    random block: a partition with a border everywhere but no disorder."""
    part = (np.arange(n) * k // n).astype(np.int32)
    flip = rng.random(n) < noise
    part[flip] = rng.integers(0, k, int(flip.sum()))
    return part


# -- JET ---------------------------------------------------------------------


# (graph, temperature, locked share): the fine and the coarse temperature,
# with and without a locked set; rmat-heavy's connections reach 2^31, where
# float64 and float32 thresholds differ.
JET_CASES = [("rmat", 0.25, 0.0), ("rmat", 0.75, 0.3), ("hub", 0.75, 0.0),
             ("grid", 0.25, 0.2), ("rmat-heavy", 0.75, 0.1)]


@pytest.mark.parametrize("name,temp,locked_share", JET_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in JET_CASES])
def test_jet_move_round_matches_jax(name, temp, locked_share):
    jg, tg = graph_pair(name)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    rng = np.random.default_rng(11)
    k = 8
    labels = random_blocks(jpv.n_pad, jpv.n, k, rng)
    locked = np.zeros(jpv.n_pad, dtype=bool)
    locked[: jpv.n] = rng.random(jpv.n) < locked_share
    max_bw = np.full(k, int(jg.total_node_weight / k * 1.03) + 1, dtype=np.int32)
    key = next_key()
    j_labels, j_move = jjet._jet_move_round(
        key, jnp.asarray(labels), jnp.asarray(locked), jbv.buckets, jbv.heavy,
        jbv.gather_idx, jpv.node_w, jnp.asarray(max_bw), jnp.float32(temp), k=k,
    )
    t_labels, t_move = tjet._jet_move_round(
        t(labels), t(locked), jax_ties(key, jbv), tbv,
        tg.padded().node_w, t(max_bw), temp, k=k,
    )
    assert_equal(j_labels, t_labels, f"{name} labels")
    assert_equal(j_move, t_move, f"{name} moved")
    moved = int(t_move.sum())
    assert moved > 0 and not bool((t_move & t(locked)).any())


def jet_contrib_pair(n_pad, k, rng):
    """JET's filter contribution over random gains, candidates, targets and
    labels, once in each package."""
    gain = rng.integers(-5, 6, n_pad).astype(np.int32)
    cand = rng.random(n_pad) < 0.5
    target = rng.integers(0, k, n_pad).astype(np.int32)
    labels = rng.integers(0, k, n_pad).astype(np.int32)

    def make(xp, where, arrays):
        g, c, tg, lb = arrays

        def fn(urow, cols, w):
            gu, gv = g[urow], g[cols]
            v_before = c[cols] & ((gv > gu) | ((gv == gu) & (cols < urow)))
            eff_v = where(v_before, tg[cols], lb[cols])
            return where(eff_v == tg[urow], w, 0 * w) - where(eff_v == lb[urow], w, 0 * w)

        return fn

    jfn = make(jnp, jnp.where, [jnp.asarray(x) for x in (gain, cand, target, labels)])
    tfn = make(torch, torch.where, [t(x) for x in (gain, cand, target, labels)])
    return jfn, tfn


@pytest.mark.parametrize("name", ["hub", "rmat-heavy"])
def test_neighbor_reduce_matches_jax(name):
    """``hub`` has a heavy row (the flat path); ``rmat-heavy``'s sums wrap
    int32."""
    jg, tg = graph_pair(name)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    jfn, tfn = jet_contrib_pair(jpv.n_pad, 8, np.random.default_rng(3))
    ref = jbg.bucketed_neighbor_reduce(jfn, jbv.buckets, jbv.heavy, jbv.gather_idx,
                                       jpv.n_pad)
    out = tbg.bucketed_neighbor_reduce(tfn, tbv, jpv.n_pad)
    assert_equal(ref, out, name)
    assert int(out.abs().max()) > 0


@pytest.mark.parametrize("coarse", [False, True], ids=["fine", "coarse"])
def test_jet_refiner_tracks_jax(coarse):
    """Both JetRefiners from the same noisy stripe partition of a grid:
    both feasible, the port's cut within 5% of the JAX package's."""
    k = 4
    jg, tg = jgen.grid2d_graph(32, 32), tgen.grid2d_graph(32, 32)
    part = stripe_blocks(tg.n, k, np.random.default_rng(4), noise=0.15)
    max_bw = np.full(k, int(tg.total_node_weight / k * 1.03) + 1, dtype=np.int64)
    jref = jjet.JetRefiner(jctx.JetContext(), jctx.BalancerContext(), coarse_level=coarse)
    tref = tjet.JetRefiner(tctx.JetContext(), tctx.BalancerContext(), coarse_level=coarse)
    tjet.reset_jet_stats()
    jout = jref.refine(JPartitionedGraph.create(jg, k, part, max_bw))
    tin = PartitionedGraph.create(tg, k, part, max_bw)
    tout = tref.refine(tin)
    assert jout.is_feasible() and tout.is_feasible()
    jcut, tcut = jout.edge_cut(), tout.edge_cut()
    assert tcut < tin.edge_cut()
    assert tcut <= 1.05 * jcut, f"port cut {tcut} vs JAX cut {jcut}"
    stats = tjet.jet_stats_snapshot()
    assert stats["calls"] == 1 and stats["min_rounds"] == stats["rounds"] >= 1


# -- FM ----------------------------------------------------------------------


def fm_inputs(name, k, rng):
    """Host arrays of a graph as FMRefiner builds them, and a noisy stripe
    partition with its block weights and caps."""
    _, tg = graph_pair(name)
    row_ptr = tg.host_row_ptr().astype(np.int64)
    col_idx = tg.col_idx.numpy().astype(np.int32)
    ew64 = tg.edge_w.numpy().astype(np.int64)
    small = int(ew64.sum()) < 2**31
    edge_w = ew64.astype(np.int32) if small else ew64
    node_w = tg.node_w.numpy().astype(np.int64)
    u_arr = np.repeat(np.arange(tg.n, dtype=np.int32), np.diff(row_ptr))
    part = stripe_blocks(tg.n, k, rng, noise=0.05)
    bw = np.bincount(part, weights=node_w, minlength=k).astype(np.int64)
    max_bw = np.full(k, int(node_w.sum() / k * 1.05) + 1, dtype=np.int64)
    max_bw = np.maximum(max_bw, bw.max())
    return (row_ptr, col_idx, edge_w, node_w, u_arr, part, bw, max_bw,
            np.int32 if small else np.int64)


# (graph, connection table, sparse budget): the sparse table forced with a
# small dense_nk_threshold; rmat-heavy's total edge weight is above 2^31
# (int64 connections); a budget of 2,048 entries ends the sparse pass
# early.
FM_PASS_CASES = [("grid", "dense", None), ("rmat", "dense", None), ("grid", "sparse", None),
                 ("rmat-heavy", "dense", None), ("rmat", "sparse", 2048)]


@pytest.mark.parametrize("name,table,max_entries", FM_PASS_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in FM_PASS_CASES])
def test_fm_pass_matches_jax(name, table, max_entries):
    k = 4
    arrays = fm_inputs(name, k, np.random.default_rng(6))
    row_ptr, col_idx, edge_w, node_w, u_arr, part, bw, max_bw, dtype = arrays
    if name == "rmat-heavy":
        assert dtype is np.int64
    n = len(row_ptr) - 1
    out = {}
    for side, mod, ctx in (("jax", jfm, jctx.FMContext()), ("port", tfm, tctx.FMContext())):
        if table == "dense":
            conn = mod._DenseConn(n, k, dtype)
        else:
            kw = {} if max_entries is None else {"max_entries": max_entries}
            conn = mod._SparseConn(n, k, dtype, row_ptr, col_idx, edge_w, **kw)
        p, b = part.copy(), bw.copy()
        delta = mod._kway_fm_pass(row_ptr, col_idx, edge_w, node_w, u_arr, p, b, max_bw, k,
                                  np.random.default_rng(9), ctx, conn)
        out[side] = (p, b, delta, getattr(conn, "used", None))
    assert np.array_equal(out["jax"][0], out["port"][0])
    assert np.array_equal(out["jax"][1], out["port"][1])
    assert out["jax"][2:] == out["port"][2:]
    assert out["port"][2] < 0, "the pass found no improvement"
    if max_entries is not None:  # the budget ended the pass: the table is full
        assert out["port"][3] > 0


def fm_refine_both(monkeypatch, name, k, **fm):
    """Both FMRefiners on the same input, both packages' host generator
    seeded alike; returns (JAX partition, port PartitionedGraph, input)."""
    jg, tg = graph_pair(name)
    part = stripe_blocks(tg.n, k, np.random.default_rng(12), noise=0.05)
    W = tg.total_node_weight
    max_bw = np.full(k, int(W / k * 1.05) + 1, dtype=np.int64)
    max_bw = np.maximum(max_bw, np.bincount(part, weights=tg.node_w.numpy(),
                                            minlength=k).astype(np.int64))
    monkeypatch.setattr(JRandomState, "numpy_rng", lambda: np.random.default_rng(21))
    monkeypatch.setattr(RandomState, "numpy_rng", lambda: np.random.default_rng(21))
    jc, tc = jctx.FMContext(**fm), tctx.FMContext(**fm)
    jout = jfm.FMRefiner(jc).refine(JPartitionedGraph.create(jg, k, part, max_bw))
    tin = PartitionedGraph.create(tg, k, part, max_bw)
    tfm.reset_fm_stats()
    tout = tfm.FMRefiner(tc).refine(tin)
    return np.asarray(jout.partition), tout, tin


@pytest.mark.parametrize("name,fm", [("grid", {}), ("grid", {"dense_nk_threshold": 64})],
                         ids=["grid-dense", "grid-sparse"])
def test_fm_refiner_matches_jax(monkeypatch, name, fm):
    jpart, tout, tin = fm_refine_both(monkeypatch, name, 4, **fm)
    assert np.array_equal(jpart, tout.partition.numpy())
    assert tout.partition.dtype == torch.int32 and tout.is_feasible()
    assert tout.edge_cut() < tin.edge_cut()
    stats = tfm.fm_stats_snapshot()
    assert stats["calls"] == 1 and stats["passes"] >= 1 and stats["skipped"] == 0


def test_fm_refiner_skips_graphs_above_max_n(monkeypatch):
    jpart, tout, tin = fm_refine_both(monkeypatch, "grid", 4, max_n=100)
    assert tout is tin
    assert np.array_equal(jpart, tin.partition.numpy())
    assert tfm.fm_stats_snapshot()["skipped"] == 1


# -- colouring and colored LP ----------------------------------------------


def jax_prio(key, n_pad):
    """The colouring's round-i priorities as ``color_graph`` draws them."""
    return lambda i: t(jax.random.randint(jax.random.fold_in(key, i), (n_pad,), 0, I32MAX,
                                          dtype=jnp.int32))


def assert_proper(colors, tg):
    u, v = tg.edge_u.long(), tg.col_idx.long()
    c = colors[: tg.n]
    assert not bool(((c[u] == c[v]) & (u != v)).any()), "an edge is monochromatic"


@pytest.mark.parametrize("name", ["rmat", "grid", "hub", "star"])
def test_coloring_matches_jax(name):
    jg, tg = graph_pair(name)
    jpv, tpv = jg.padded(), tg.padded()
    key = next_key()
    jmask = jnp.arange(jpv.n_pad) < jpv.n
    ref = jcol.color_graph(key, jpv.edge_u, jpv.col_idx, jmask, n=jpv.n_pad)
    tmask = torch.arange(tpv.n_pad) < tpv.n
    out, _ = tcol.color_graph(jax_prio(key, tpv.n_pad), tpv.edge_u, tpv.col_idx, tmask,
                              n=tpv.n_pad)
    assert bool((out >= 0).all()), "a straggler"
    assert_equal(ref, out, name)
    assert_proper(out, tg)
    assert int(tcol.num_colors_device(out, tmask)) == int(jcol.num_colors_device(ref, jmask))


def test_coloring_stragglers_match_jax():
    """``rmat_graph(10, 64, seed=1)``'s dense core needs more than the 62
    colours: in both packages the stragglers take colour 0 after 64
    rounds, so some edges between nodes of colour 0 are monochromatic, and
    no other edge is."""
    jg, tg = jgen.rmat_graph(10, 64, seed=1), tgen.rmat_graph(10, 64, seed=1)
    jpv, tpv = jg.padded(), tg.padded()
    key = next_key()
    ref = jcol.color_graph(key, jpv.edge_u, jpv.col_idx, jnp.arange(jpv.n_pad) < jpv.n,
                           n=jpv.n_pad)
    tmask = torch.arange(tpv.n_pad) < tpv.n
    raw, rounds = tcol.color_graph(jax_prio(key, tpv.n_pad), tpv.edge_u, tpv.col_idx,
                                   tmask, n=tpv.n_pad)
    out = torch.clamp(raw, min=0)
    assert_equal(ref, out)
    assert rounds == 64 and int((raw < 0).sum()) > 0
    u, v = tg.edge_u.long(), tg.col_idx.long()
    mono = (out[u] == out[v]) & (u != v)
    assert bool(mono.any()) and bool((out[u][mono] == 0).all())


def test_lowest_set_bit_index_is_exact():
    x = torch.tensor([0, 1, 2, 3, 12, 2**30, 2**30 + 2**29, 2**31 - 1, 6 << 20],
                     dtype=torch.int32)
    ref = jcol._lowest_set_bit_index(jnp.asarray(x.numpy()))
    assert_equal(ref, tcol._lowest_set_bit_index(x))
    assert tcol._lowest_set_bit_index(x).tolist() == [31, 0, 1, 0, 2, 30, 29, 0, 21]


def clp_setup(name, k, rng):
    jg, tg = graph_pair(name)
    jpv = jg.padded()
    L = jlp.num_labels_bucket(k)
    part = random_blocks(jpv.n_pad, jpv.n, k, rng)
    caps = np.zeros(L, dtype=np.int32)
    caps[:k] = int(jg.total_node_weight / k * 1.05) + 1
    js = jlp.init_state(jnp.asarray(part), jpv.node_w, L)
    ts = tlp.init_state(t(part), tg.padded().node_w, L)
    key = next_key()
    colors = jcol.color_graph(key, jpv.edge_u, jpv.col_idx, jnp.arange(jpv.n_pad) < jpv.n,
                              n=jpv.n_pad)
    nc = int(jcol.num_colors_device(colors, jnp.arange(jpv.n_pad) < jpv.n))
    return jg, tg, L, js, ts, caps, colors, nc


def test_lp_round_colored_matches_xla_and_pallas():
    """Two supersteps on the hub graph (its heavy row takes the flat
    path)."""
    jg, tg, L, js, ts, caps, colors, nc = clp_setup("hub", 8, np.random.default_rng(7))
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    for c in range(min(nc, 2)):
        key = next_key()
        active = colors == c
        args = (key, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w, jnp.asarray(caps),
                active)
        ref = jlp.lp_round_colored(js, *args, num_labels=L, allow_tie_moves=True)
        ref_pallas = pallas_lp.lp_round_colored(js, *args, num_labels=L,
                                                allow_tie_moves=True)
        assert_state_equal(ref, ref_pallas, f"XLA vs Pallas, colour {c}")
        draws = jax_round_draws(key, jbv, jpv.n_pad, allow_tie_moves=True)
        ts = tlp.lp_round_colored(ts, draws, tbv, tg.padded().node_w, t(caps),
                                  t(active), num_labels=L, allow_tie_moves=True)
        assert_state_equal(ref, ts, f"colour {c}")
        assert int(ts.num_moved) > 0
        moved = np.flatnonzero(np.asarray(ref.labels) != np.asarray(js.labels))
        assert (np.asarray(colors)[moved] == c).all()
        js = ref


def test_clp_iterate_colors_matches_xla_and_pallas():
    name = "grid"
    jg, tg, L, js, ts, caps, colors, nc = clp_setup(name, 8, np.random.default_rng(8))
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    keys = [next_key() for _ in range(nc)]
    args = (jnp.stack(keys), jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
            jnp.asarray(caps), colors, jnp.int32(nc))
    labels0 = np.asarray(js.labels)  # both iterations donate their input state
    ref_pallas = pallas_lp.clp_iterate_colors(js, *args, num_labels=L, allow_tie_moves=True)
    ref = jlp.clp_iterate_colors(jlp.init_state(jnp.asarray(labels0), jpv.node_w, L), *args,
                                 num_labels=L, allow_tie_moves=True)
    assert_state_equal(ref, ref_pallas, "XLA vs Pallas")
    out = tlp.clp_iterate_colors(
        ts, lambda c: jax_round_draws(keys[c], jbv, jpv.n_pad, allow_tie_moves=True), tbv,
        tg.padded().node_w, t(caps), t(colors), nc, num_labels=L, allow_tie_moves=True)
    assert_state_equal(ref, out, name)
    assert int(out.num_moved) > 0


def test_clp_refiner_keeps_the_better_of_input_and_output(monkeypatch):
    """On a noisy stripe partition CLP lowers the cut, through a proper
    colouring; with supersteps that scramble the labels it returns its
    input."""
    tg = tgen.rmat_graph(9, 8, seed=2)
    k = 4
    part = stripe_blocks(tg.n, k, np.random.default_rng(2), noise=0.2)
    max_bw = np.full(k, int(tg.total_node_weight / k * 1.05) + 1, dtype=np.int64)
    max_bw = np.maximum(max_bw, np.bincount(part, minlength=k))
    pin = PartitionedGraph.create(tg, k, part, max_bw)
    colourings = []

    def color_graph(*args, **kw):
        colourings.append(tcol.color_graph(*args, **kw))
        return colourings[-1]

    monkeypatch.setattr(tclp, "color_graph", color_graph)
    ref = tclp.CLPRefiner(tctx.ColoredLPContext())
    out = ref.refine(pin)
    assert out.edge_cut() < pin.edge_cut() and out.is_feasible()
    (raw, rounds), = colourings
    assert bool((raw >= 0).all()) and rounds >= 1
    assert_proper(raw, tg)

    def scramble(state, draw, bv, node_w, max_w, colors, nc, *, num_labels, **kw):
        labels = torch.remainder(state.labels + 1 + torch.arange(state.labels.shape[0],
                                                                 dtype=torch.int32), k)
        return tlp.init_state(labels.to(torch.int32), node_w, num_labels)._replace(
            num_moved=torch.tensor(0, dtype=torch.int32))

    monkeypatch.setattr(tlp, "clp_iterate_colors", scramble)
    assert ref.refine(pin) is pin
