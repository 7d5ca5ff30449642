"""Port parity of the lane-stacked serve path (``ops/lanestack.py``,
``serve/lanestack.py``).

- The lane ops against the JAX package's lane ops on 2-4 lanes, exact:
  ``lane_contract``, ``lane_quality``, ``lane_project`` and
  ``lane_select_best`` on the same inputs; ``lane_cluster``,
  ``lane_lp_refine`` and ``lane_balance_round`` fed each lane's JAX
  threefry draws (``LPDraws``/``BalanceDraws``), as the sequential round
  tests feed them.  The JAX side stacks identical layouts (one graph per
  lane, each lane with its own key), as its runner stacks lanes of one
  signature.
- The union round's host decisions: a per-label cap table gives what the
  scalar cap gives, both auctions give the same union commit, and the
  rating's sort-key plan takes the union's label count.
- Lane-stacked partitions equal the port's own sequential facade runs bit
  for bit: rmat, grid and rgg, k in {2, 8}, 2-4 lanes, and a batch whose
  cohorts split; ineligible batches raise ``LaneStackUnsupported``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.ops import lanestack as jlops
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.ops.contraction import STATS_LEN
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch import KaMinPar
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.ops import lanestack as lops
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops import lp_kernels
from kaminpar_tpu_torch.presets import create_context_by_preset_name
from kaminpar_tpu_torch.refinement import balancer as tbal
from kaminpar_tpu_torch.serve.lanestack import (LaneStackUnsupported, check_eligibility,
                                                run_lanestacked)
from test_torch_lp_kernels import I32MAX, assert_equal, graph_pair, jax_round_draws, jax_ties, t


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends (each holds
    memory mappings; see test_torch_lp_kernels.py)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Torch on one thread: the suite's workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def stack(tree, L):
    """A JAX pytree with every leaf repeated along a new leading lane axis."""
    return jax.tree_util.tree_map(lambda x: jnp.stack([x] * L), tree)


def lanes_of(name, L):
    """L lanes of one graph: the JAX graph, the port's L graphs, the port's
    union and its padded views."""
    jg, tg = graph_pair(name)
    tgs = [tg] + [copy.deepcopy(tg) for _ in range(L - 1)]
    pvs = [g.padded() for g in tgs]
    union = lops.lane_union([g.bucketed() for g in tgs], [pv.n_pad for pv in pvs])
    return jg, tgs, pvs, union


def split_lanes(x, union):
    off = union.node_off
    return [x[off[j]:off[j + 1]] for j in range(union.L)]


# -- the lane ops against the JAX package's ---------------------------------


@pytest.mark.parametrize("L", [3])
def test_lane_contract_matches_jax(L):
    jg, tgs, pvs, _ = lanes_of("rmat", L)
    jpv = jg.padded()
    rng = np.random.default_rng(L)
    labels = []
    for _ in range(L):
        lab = np.full(jpv.n_pad, jpv.anchor, dtype=np.int32)
        lab[: jpv.n] = rng.integers(0, jpv.n // 3, jpv.n)
        labels.append(lab)
    moved = [int(x) for x in rng.integers(0, 100, L)]
    ref = jlops.lane_contract(
        jnp.asarray(np.stack(labels)), *(stack(a, L) for a in (jpv.edge_u, jpv.col_idx,
                                                                 jpv.edge_w, jpv.node_w)),
        jnp.asarray(moved, dtype=jnp.int32))
    coarse_of, stats, c_node_w, out_u, out_v, out_w, row_ptr = (np.asarray(x) for x in ref)
    out, host = lops.lane_contract(tgs, [t(lab) for lab in labels], moved)
    for j, (cg, co) in enumerate(out):
        n_c, m_c = int(stats[j, 0]) - 1, int(stats[j, 1])
        assert (cg.n, cg.m) == (n_c, m_c)
        assert_equal(co, coarse_of[j, : jpv.n], "coarse_of")
        assert_equal(cg.row_ptr, row_ptr[j, : n_c + 1], "row_ptr")
        assert_equal(cg.col_idx, out_v[j, :m_c], "col_idx")
        assert_equal(cg.edge_w, out_w[j, :m_c], "edge_w")
        assert_equal(cg.node_w, c_node_w[j, :n_c], "node_w")
        assert list(host[j, :4]) == list(stats[j, :4])
        assert int(host[j, 4]) == int(stats[j, STATS_LEN]) == moved[j]


@pytest.mark.parametrize("L", [2])
def test_lane_quality_project_and_select_match_jax(L):
    jg, tgs, pvs, union = lanes_of("grid", L)
    jpv = jg.padded()
    k = 4
    rng = np.random.default_rng(11)
    parts = np.zeros((L, jpv.n_pad), dtype=np.int32)
    parts[:, : jpv.n] = rng.integers(0, k, (L, jpv.n))
    ref = np.asarray(jlops.lane_quality(
        jnp.asarray(parts), *(stack(a, L) for a in (jpv.node_w, jpv.edge_u, jpv.col_idx,
                                                     jpv.edge_w)), k=k))
    blocks = lops.LaneBlocks.build(union, [k] * L)
    edges = lops.LaneEdges.build(union, tgs)
    node_w = torch.cat([pv.node_w for pv in pvs])
    q = lops.lane_quality(union, edges, blocks, t(parts.reshape(-1)), node_w)
    assert list(q[:L]) == list(ref[:, 0])
    assert_equal(q[L:].reshape(L, k), ref[:, 1:], "block weights")

    # projection through a contraction's map, and the keep-best selection
    coarse_of = rng.integers(0, 50, (L, jpv.n_pad)).astype(np.int32)
    coarse = rng.integers(0, k, (L, 64)).astype(np.int32)
    jproj = np.asarray(jlops.lane_project(jnp.asarray(coarse_of), jnp.asarray(coarse)))
    tproj = lops.lane_project([t(c) for c in coarse_of], [t(c) for c in coarse])
    for j in range(L):
        assert_equal(tproj[j], jproj[j], "projection")
    snaps = rng.integers(0, k, (3, L, jpv.n_pad)).astype(np.int32)
    best = [int(x) for x in rng.integers(0, 3, L)]
    jsel = np.asarray(jlops.lane_select_best(jnp.asarray(snaps),
                                             jnp.asarray(best, dtype=jnp.int32)))
    tsel = lops.lane_select_best([t(s.reshape(-1)) for s in snaps], best, union)
    assert_equal(tsel, jsel.reshape(-1), "selection")


@pytest.mark.parametrize("name", ["hub"])
def test_lane_cluster_matches_jax_on_its_draws(name):
    """Every lane's clustering (lockstep rounds, isolated nodes, two-hop)
    equals the JAX package's ``lane_cluster`` given its threefry keys."""
    L = 3
    jg, tgs, pvs, _ = lanes_of(name, L)
    jpv, jbv = jg.padded(), jg.bucketed()
    ctx = create_context_by_preset_name("serve").coarsening.lp
    caps = [40, 60, 25]
    keys_it = [next_key() for _ in range(L)]
    keys_2h = [next_key() for _ in range(L)]
    iters, probs = zip(*(tlp_plan(ctx, g) for g in tgs))
    min_moved = [int(ctx.min_moved_fraction * pv.n) for pv in pvs]
    ref, moved = jlops.lane_cluster(
        stack(jpv.row_ptr, L), stack(jpv.node_w, L), stack(jbv.buckets, L),
        stack(jbv.heavy, L), stack(jbv.gather_idx, L), jnp.stack(keys_it),
        jnp.stack(keys_2h), jnp.full(L, jpv.n), jnp.asarray(caps), jnp.asarray(min_moved),
        jnp.asarray(iters), num_labels=jpv.n_pad, active_prob=probs[0],
        tie_break=ctx.tie_breaking.value, cluster_isolated=ctx.cluster_isolated_nodes,
        cluster_two_hop=ctx.cluster_two_hop_nodes)

    def two_hop(j):
        kr, kp = jax.random.split(keys_2h[j])
        ties, heavy = jax_ties(kr, jbv)
        prio = t(jax.random.randint(kp, (jpv.n_pad,), 0, I32MAX, dtype=jnp.int32))
        return tlp.LPDraws(ties, heavy, prio)

    out, tmoved = lops.lane_cluster(
        tgs,
        lambda j, i: jax_round_draws(jax.random.fold_in(keys_it[j], i), jbv, jpv.n_pad,
                                     active_prob=probs[j]),
        two_hop, caps, ctx, [False] * L)
    for j in range(L):
        assert_equal(out[j], np.asarray(ref)[j], f"lane {j} labels")
        assert tmoved[j] == int(moved[j])


def tlp_plan(ctx, g):
    from kaminpar_tpu_torch.coarsening.lp_clusterer import LPClustering

    return LPClustering.sweep_plan(ctx, g, False)


@pytest.mark.parametrize("L", [4])
def test_lane_lp_refine_and_balance_round_match_jax_on_its_draws(L):
    jg, tgs, pvs, union = lanes_of("rmat", L)
    jpv, jbv = jg.padded(), jg.bucketed()
    k = 8
    rng = np.random.default_rng(5 + L)
    parts = np.zeros((L, jpv.n_pad), dtype=np.int32)
    parts[:, : jpv.n] = np.where(rng.random((L, jpv.n)) < 0.4, 0,
                                 rng.integers(1, k, (L, jpv.n)))
    node_w = torch.cat([pv.node_w for pv in pvs])
    cap = int(jg.total_node_weight / k * 1.03) + 1
    caps = [np.full(k, cap + 10 * j, dtype=np.int64) for j in range(L)]

    # one balancer round, the last lane frozen
    keys = [next_key() for _ in range(L)]
    active = [True] * (L - 1) + [False]
    jlab, jflags = jlops.lane_balance_round(
        jnp.stack(keys), jnp.asarray(parts), stack(jbv.buckets, L), stack(jbv.heavy, L),
        stack(jbv.gather_idx, L), stack(jpv.node_w, L),
        jnp.asarray(np.stack(caps).astype(np.int32)), jnp.asarray(active), k=k)

    def bdraw(j):
        kb, ks, _ = jax.random.split(keys[j], 3)
        ties, heavy = jax_ties(kb, jbv)
        return tbal.BalanceDraws(ties, heavy, t(jax.random.uniform(
            ks, (jpv.n_pad,), minval=0.0, maxval=1e-3)))

    blocks = lops.LaneBlocks.build(union, [k] * L)
    max_bw = torch.as_tensor(np.concatenate(caps), dtype=torch.int32)
    tlab, tflags = lops.lane_balance_round(
        union, blocks, t(parts.reshape(-1)),
        [bdraw(j) if active[j] else None for j in range(L)], node_w, max_bw)
    assert_equal(tlab, np.asarray(jlab).reshape(-1), "balancer labels")
    assert_equal(tflags[: L - 1], np.asarray(jflags)[: L - 1], "balancer flags")

    # the LP refiner pass from the balanced labels
    rl = create_context_by_preset_name("serve").refinement.lp
    kp = jlp.num_labels_bucket(k)
    max_w = np.zeros((L, kp), dtype=np.int32)
    max_w[:, :k] = np.stack(caps)
    rkeys = [next_key() for _ in range(L)]
    min_moved = [int(rl.min_moved_fraction * jpv.n)] * L
    jref = jlops.lane_lp_refine(
        jlab, jnp.stack(rkeys), stack(jbv.buckets, L), stack(jbv.heavy, L),
        stack(jbv.gather_idx, L), stack(jpv.node_w, L), jnp.asarray(max_w),
        jnp.asarray(min_moved), jnp.full(L, rl.num_iterations), jnp.full(L, jpv.n),
        num_labels=kp, active_prob=rl.active_prob, allow_tie_moves=rl.allow_tie_moves)
    tref = lops.lane_lp_refine(
        union, tlab, node_w, caps,
        lambda j, i: jax_round_draws(jax.random.fold_in(rkeys[j], i), jbv, jpv.n_pad,
                                     active_prob=rl.active_prob,
                                     allow_tie_moves=rl.allow_tie_moves), rl)
    assert_equal(tref, np.asarray(jref).reshape(-1), "LP refinement labels")


# -- the union round's host decisions ----------------------------------------


@pytest.mark.parametrize("radix", [True, False])
def test_union_round_cap_table_and_auctions(radix, monkeypatch):
    """A lane's scalar cluster-weight cap as an entry per label of the
    union's cap table gives what the scalar gives, under either auction."""
    graphs = [tgen.rmat_graph(9, 8, seed=s) for s in (2, 3)] + [tgen.grid2d_graph(24, 24)]
    pvs = [g.padded() for g in graphs]
    bvs = [g.bucketed() for g in graphs]
    union = lops.lane_union(bvs, [pv.n_pad for pv in pvs])
    gen = torch.Generator().manual_seed(9)
    draws = [tlp.draw_lp_round(gen, bv, pv.n_pad, active_prob=0.5)
             for bv, pv in zip(bvs, pvs)]
    caps = [30, 45, 12]
    monkeypatch.setattr(tlp, "use_radix_auction", lambda num_labels: radix)
    off = union.node_off
    labels = torch.cat([torch.arange(pv.n_pad, dtype=torch.int32) + off[j]
                        for j, pv in enumerate(pvs)])
    node_w = torch.cat([pv.node_w for pv in pvs])
    table = torch.cat([torch.full((pv.n_pad,), c, dtype=torch.int32)
                       for pv, c in zip(pvs, caps)])
    st, moved = lops.lane_lp_round(union, tlp.init_state(labels, node_w, union.N), draws,
                                   node_w, table, num_labels=union.N, active_probs=[0.5] * 3)
    for j, (pv, bv, c) in enumerate(zip(pvs, bvs, caps)):
        lab = torch.arange(pv.n_pad, dtype=torch.int32)
        for cap in (torch.tensor(c, dtype=torch.int32),
                    torch.full((pv.n_pad,), c, dtype=torch.int32)):
            ref = tlp.lp_round_bucketed(tlp.init_state(lab, pv.node_w, pv.n_pad), draws[j],
                                        bv, pv.node_w, cap, num_labels=pv.n_pad,
                                        active_prob=0.5)
            assert_equal(split_lanes(st.labels, union)[j] - off[j], ref.labels, f"lane {j}")
            assert int(moved[j]) == int(ref.num_moved)


def test_sort_key_plan_takes_the_union_label_count():
    """The union's label count adds log2(lanes) label bits, and the warp
    path's 64-bit keys start where label bits + log2(w) pass 32."""
    n_pad = 23296
    assert lp_kernels.sort_key_plan(n_pad, 64) == (15, False)
    assert lp_kernels.sort_key_plan(8 * n_pad, 64) == (18, False)
    assert lp_kernels.sort_key_plan(1 << 26, 64) == (26, False)
    assert lp_kernels.sort_key_plan((1 << 26) + 1, 64) == (27, True)
    assert lp_kernels.sort_key_plan((1 << 26) + 1, 128) == (27, False)  # the block path
    assert tlp.use_radix_auction(8 * n_pad) and not tlp.use_radix_auction(1 << 23)


# -- lane-stacked runs against the port's sequential runs --------------------


def _ctx(limit=32):
    ctx = create_context_by_preset_name("serve")
    ctx.coarsening.contraction_limit = limit
    return ctx


def _assert_stacked_equals_sequential(ctx, graphs, k):
    parts, report = run_lanestacked(ctx, graphs, k, 0.03)
    for g, part in zip(graphs, parts):
        solver = KaMinPar(copy.deepcopy(ctx), device="cpu")
        solver.set_graph(g)
        assert np.array_equal(solver.compute_partition(k, 0.03), part)
    return report


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("family", ["rmat", "grid", "rgg"])
def test_lanestacked_equals_sequential(family, k):
    make = {"rmat": lambda s: tgen.rmat_graph(9, 8, seed=s),
            "grid": lambda s: tgen.grid2d_graph(20 + s, 22),
            "rgg": lambda s: tgen.rgg2d_graph(512, seed=s)}[family]
    lanes = (1, 2) if k == 2 else (1, 2, 3)
    report = _assert_stacked_equals_sequential(_ctx(), [make(s) for s in lanes], k)
    assert report.levels > 0 and report.lanes == len(lanes)
    assert report.stacked_pulls > 0


def test_lanestacked_cohorts_split_and_lane_counts():
    """Lanes of different sizes end their coarsening at different depths:
    their cohorts split, and every lane still equals its own run; the
    same graph gives the same partition at 2 and 4 lanes."""
    graphs = [tgen.rmat_graph(10, 8, seed=4), tgen.grid2d_graph(10, 10),
              tgen.rgg2d_graph(1024, seed=8), tgen.rmat_graph(8, 8, seed=5)]
    report = _assert_stacked_equals_sequential(_ctx(), graphs, 4)
    assert report.cohorts >= 2 and report.splits >= 1
    two, _ = run_lanestacked(_ctx(), graphs[:2], 4, 0.03)
    four, _ = run_lanestacked(_ctx(), graphs, 4, 0.03)
    assert all(np.array_equal(a, b) for a, b in zip(two, four))


def test_ineligible_batches_raise():
    g = tgen.rmat_graph(8, 8, seed=1)
    for tweak in (lambda c: setattr(c.compression, "enabled", True),
                  lambda c: setattr(c.coarsening, "overlay_levels", 2),
                  lambda c: setattr(c.initial_partitioning, "device_extension", True),
                  lambda c: setattr(c.refinement, "algorithms", ())):
        ctx = _ctx()
        tweak(ctx)
        with pytest.raises(LaneStackUnsupported):
            check_eligibility(ctx, [g], 4)
    with pytest.raises(LaneStackUnsupported):
        check_eligibility(_ctx(), [g], 1)
    with pytest.raises(LaneStackUnsupported):
        check_eligibility(_ctx(), [g], g.n + 1)
