"""Port parity of the LP round: the rating kernel's and the commit kernel's
plain versions (what the kernel wrappers run on CPU tensors) against the
JAX package's Pallas kernels in interpret mode, and the whole LP round,
sweep loop, balancer round and two-hop pass against the JAX package with
the JAX package's own random draws fed in.

Every value is an integer (or a float32 computed by the same IEEE
operations in the same order), so every comparison is exact.

The CUDA kernels themselves are compared with these plain versions on the
card in ``test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph.csr import from_edge_list as jax_from_edge_list
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.ops import pallas_lp
from kaminpar_tpu.refinement import balancer as jbal
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph.compressed import compress
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.graph.device_compressed import DeviceCompressedView
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops import lp_kernels
from kaminpar_tpu_torch.refinement import balancer as tbal
from test_torch_cuda import COMMIT_CASES, commit_call, commit_case, commit_movers


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that runs several JAX-heavy
    modules in one process can otherwise reach the kernel's limit on them."""
    yield
    jax.clear_caches()


I32MAX = 2**31 - 1


def _hub_edges():
    rng = np.random.default_rng(7)
    star = np.stack([np.zeros(4300, dtype=np.int64), np.arange(1, 4301)], axis=1)
    return 4400, np.concatenate([star, rng.integers(1, 4400, (3000, 2))])


def graph_pair(name):
    """The same graph built by both packages; ``hub`` has one node of
    degree 4300 > MAX_WIDTH, which takes the flat heavy path;
    ``rmat-heavy`` is ``rmat`` with edge weights in [2^27, 2^28), so that
    the rows' weight sums wrap int32."""
    if name == "hub":
        n, edges = _hub_edges()
        return jax_from_edge_list(n, edges), from_edge_list(n, edges)
    if name == "rmat-heavy":
        g = tgen.rmat_graph(9, 8, seed=2)
        u, v = g.edge_u.numpy(), g.col_idx.numpy()
        edges = np.stack([u[u < v], v[u < v]], axis=1)
        w = np.random.default_rng(3).integers(2**27, 2**28, len(edges))
        return (jax_from_edge_list(g.n, edges, edge_weights=w),
                from_edge_list(g.n, edges, edge_weights=w))
    make = {
        "rmat": lambda m: m.rmat_graph(9, 8, seed=2),
        "grid": lambda m: m.grid2d_graph(24, 24),
        "star": lambda m: m.star_graph(96),
    }[name]
    return make(jgen), make(tgen)


def t(x, dtype=None):
    """numpy/jax array -> CPU tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def assert_equal(a, b, what=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, what
    bad = np.flatnonzero(a.ravel() != b.ravel())
    assert bad.size == 0, (
        f"{what}: first divergence at {bad[0]}: {a.ravel()[bad[0]]} vs {b.ravel()[bad[0]]}"
    )


def assert_state_equal(js, ts, what=""):
    assert_equal(js.labels, ts.labels, f"labels {what}")
    assert_equal(js.label_weights, ts.label_weights, f"label weights {what}")
    assert int(js.num_moved) == int(ts.num_moved), f"num_moved {what}"


# -- the JAX package's draws, reproduced -----------------------------------


def jax_ties(kr, jbv):
    """Rating ties as bucketed_gains draws them: per bucket fold_in(kr, i),
    the heavy part fold_in(kr, len(buckets))."""
    ties = tuple(
        t(jax.random.randint(jax.random.fold_in(kr, i), b.cols.shape, 0, I32MAX,
                             dtype=jnp.int32))
        for i, b in enumerate(jbv.buckets)
    )
    heavy = None
    if jbv.heavy.nodes.shape[0] > 0:
        heavy = t(jax.random.randint(jax.random.fold_in(kr, len(jbv.buckets)),
                                     jbv.heavy.cols.shape, 0, I32MAX, dtype=jnp.int32))
    return ties, heavy


def jax_round_draws(key, jbv, n_pad, *, active_prob=1.0, allow_tie_moves=False):
    """The draws of lp.lp_round_bucketed(key): split into rating and
    commit keys, the commit key split three ways (lp._commit_moves)."""
    kr, kp = jax.random.split(key)
    ties, heavy = jax_ties(kr, jbv)
    kp, ka, kt = jax.random.split(kp, 3)
    prio = t(jax.random.randint(kp, (n_pad,), 0, (1 << 30) - 1, dtype=jnp.int32))
    coin = t(jax.random.bernoulli(kt, 0.5, (n_pad,))) if allow_tie_moves else None
    act = t(jax.random.bernoulli(ka, active_prob, (n_pad,))) if active_prob < 1.0 else None
    return tlp.LPDraws(ties, heavy, prio, coin, act)


def clustering_setup(jg, tg):
    pv = jg.padded()
    labels = np.concatenate(
        [np.arange(pv.n), np.full(pv.n_pad - pv.n, pv.anchor)]
    ).astype(np.int32)
    js = jlp.init_state(jnp.asarray(labels), pv.node_w, pv.n_pad)
    ts = tlp.init_state(t(labels), tg.padded().node_w, pv.n_pad)
    return pv.n_pad, js, ts


def refinement_setup(jg, tg, k, rng):
    pv = jg.padded()
    part = np.zeros(pv.n_pad, dtype=np.int32)
    part[: pv.n] = rng.integers(0, k, pv.n)
    L = jlp.num_labels_bucket(k)
    assert L == tlp.num_labels_bucket(k)
    js = jlp.init_state(jnp.asarray(part), pv.node_w, L)
    ts = tlp.init_state(t(part), tg.padded().node_w, L)
    caps = np.zeros(L, dtype=np.int32)
    caps[:k] = int(jg.total_node_weight / k * 1.1)
    return L, js, ts, caps


# -- rating kernel #1 -------------------------------------------------------

# (instantiation, external_only, respect_caps, tie_break): the clustering
# round, the two-hop favoured cluster, the balancer and an LP refinement
# round with lightest-first ties.
RATE_CONFIGS = [
    ("cluster", False, True, "uniform"),
    ("cluster", False, False, "lightest"),
    ("refine", True, True, "uniform"),
    ("refine", False, True, "lightest"),
]


# rmat runs every configuration; grid and star one of each instantiation
# and tie-break (each configuration is one interpret-mode compile per
# bucket shape).  The hub's heavy row never reaches this kernel: the round
# and balancer tests below cover the flat heavy path.
RATE_CASES = (
    [("rmat", c) for c in RATE_CONFIGS]
    + [(name, RATE_CONFIGS[i]) for name in ("grid", "star") for i in (0, 3)]
)


@pytest.mark.parametrize("name,config", RATE_CASES,
                         ids=lambda c: c if isinstance(c, str) else "-".join(map(str, c)))
def test_rating_plain_matches_pallas_kernel(name, config):
    check_rating_against_pallas(name, config)


@pytest.mark.parametrize("config", [RATE_CONFIGS[0], RATE_CONFIGS[3]],
                         ids=lambda c: "-".join(map(str, c)))
def test_rating_plain_matches_pallas_kernel_wrapping_weights(config):
    """Rows whose weight sums wrap int32: the run rating is the cumsum
    minus the cummax of the run bases, both wrapping, as in the JAX
    package (the kernels must follow that, not the exact run sum)."""
    _, tg = graph_pair("rmat-heavy")
    assert int(tg.edge_w.max()) >= 2**27 and int(tg.padded().row_ptr.diff().max()) >= 16
    check_rating_against_pallas("rmat-heavy", config)


def check_rating_against_pallas(name, config):
    inst, external_only, respect_caps, tie_break = config
    rng = np.random.default_rng(1)
    jg, tg = graph_pair(name)
    pv = jg.padded()
    n_pad = pv.n_pad
    if inst == "cluster":
        # a mid-run clustering: labels are node ids, several nodes per label
        labels = rng.integers(0, n_pad // 3, n_pad).astype(np.int32)
        L = n_pad
    else:
        labels = rng.integers(0, 8, n_pad).astype(np.int32)
        L = 64
    lw = np.bincount(labels, weights=np.asarray(pv.node_w), minlength=L).astype(np.int32)
    if inst == "cluster":
        maxw = np.asarray(int(np.median(lw[lw > 0])) + 1, dtype=np.int32)
        maxw_j = jnp.asarray(maxw).reshape(1)
    else:
        maxw = np.zeros(L, dtype=np.int32)
        maxw[:8] = np.sort(lw[:8])[4] + rng.integers(0, 3, 8)
        maxw_j = jnp.asarray(maxw)
    jbv, tbv = jg.bucketed(), tg.bucketed()
    for jb, tb, real in zip(jbv.buckets, tbv.buckets, tbv.real_rows):
        tie = rng.integers(0, I32MAX, jb.cols.shape).astype(np.int32)
        ref = pallas_lp._rate_bucket(
            jnp.asarray(labels), pv.node_w, jnp.asarray(lw), maxw_j, jb, jnp.asarray(tie),
            external_only=external_only, respect_caps=respect_caps,
            tie_break=tie_break, maxw_scalar=inst == "cluster",
        )
        out = lp_kernels.rate_bucket(
            t(labels), tg.padded().node_w, t(lw), t(maxw), tb, t(tie), real_rows=real,
            external_only=external_only, respect_caps=respect_caps,
            tie_break=tie_break,
        )
        for r, o, what in zip(ref, out, ("target", "tconn", "own_conn", "has")):
            assert_equal(r, o, f"{what} w={jb.cols.shape[1]}")


# -- commit kernel #3 -------------------------------------------------------


def pallas_commit(labels, node_w, lw, maxw, target, tconn, own, prio, coin, act,
                  color, L, *, active_prob, allow_tie_moves, has_active, radix):
    """The Pallas commit body run as pallas_lp.commit_moves runs it, with
    caller-given prio/coin/act/color and a chosen auction variant."""
    n = labels.shape[0]
    kernel = pallas_lp._make_commit_kernel(
        L, active_prob, allow_tie_moves, has_active, maxw.ndim == 0, radix, jnp.int32
    )
    spec = pl.BlockSpec(memory_space=pltpu.VMEM)
    maxw_arr = maxw.reshape(1) if maxw.ndim == 0 else maxw
    new_labels, new_weights, moved = pl.pallas_call(
        kernel, in_specs=[spec] * 11, out_specs=(spec, spec, spec),
        out_shape=(
            jax.ShapeDtypeStruct((n,), jnp.int32),
            jax.ShapeDtypeStruct((L,), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
        ),
        interpret=True,
    )(*(jnp.asarray(x) for x in (labels, node_w, lw, maxw_arr, target, tconn, own,
                                 prio, coin, act, color)))
    return new_labels, new_weights, moved[0]


@pytest.mark.parametrize("radix", [True, False], ids=["radix", "bitwise"])
def test_commit_plain_matches_pallas_kernel(radix):
    """Contended capacities: many movers per target, tight caps."""
    rng = np.random.default_rng(3)
    n, k = 512, 6
    labels = rng.integers(0, k, n).astype(np.int32)
    node_w = rng.integers(1, 4, n).astype(np.int32)
    lw = np.bincount(labels, weights=node_w, minlength=k).astype(np.int32)
    target = rng.integers(0, k, n).astype(np.int32)
    tconn = rng.integers(0, 20, n).astype(np.int32)
    own = rng.integers(0, 20, n).astype(np.int32)
    maxw = np.full(k, lw.max() + 15, dtype=np.int32)
    prio = rng.integers(0, (1 << 30) - 1, n).astype(np.int32)
    coin = rng.random(n) < 0.5
    act = rng.random(n) < 0.8
    color = rng.random(n) < 0.7
    for has_active in (False, True):
        ref = pallas_commit(labels, node_w, lw, maxw, target, tconn, own, prio, coin,
                            act, color, k, active_prob=0.8, allow_tie_moves=True,
                            has_active=has_active, radix=radix)
        out = lp_kernels.commit_moves(
            tlp.LPState(t(labels), t(lw), None), t(target), t(tconn), t(own),
            t(node_w), t(maxw), k, t(prio), t(coin), t(act), active_prob=0.8,
            allow_tie_moves=True, active=t(color) if has_active else None, radix=radix,
        )
        assert_equal(ref[0], out.labels, "labels")
        assert_equal(ref[1], out.label_weights, "label weights")
        assert int(ref[2]) == int(out.num_moved)
        assert int(out.label_weights.max()) <= int(maxw.max())


def test_commit_scalar_cap_radix_and_bitwise_agree():
    """The clustering instantiation (scalar cap, L = n): both auctions
    admit the same set, and equal the Pallas kernel's."""
    rng = np.random.default_rng(4)
    n = 1024
    labels = np.arange(n, dtype=np.int32)
    node_w = rng.integers(1, 3, n).astype(np.int32)
    lw = node_w.copy()
    target = rng.integers(0, 40, n).astype(np.int32)
    tconn = rng.integers(1, 9, n).astype(np.int32)
    own = np.zeros(n, dtype=np.int32)
    prio = rng.integers(0, (1 << 30) - 1, n).astype(np.int32)
    maxw = np.asarray(12, dtype=np.int32)
    zeros = np.zeros(n, dtype=bool)
    ref = pallas_commit(labels, node_w, lw, maxw, target, tconn, own, prio, zeros,
                        zeros, zeros, n, active_prob=1.0, allow_tie_moves=False,
                        has_active=False, radix=True)
    for radix in (True, False):
        out = lp_kernels.commit_moves(
            tlp.LPState(t(labels), t(lw), None), t(target), t(tconn), t(own),
            t(node_w), t(maxw), n, t(prio), radix=radix,
        )
        assert_equal(ref[0], out.labels, f"labels radix={radix}")
        assert_equal(ref[1], out.label_weights, f"weights radix={radix}")


def auction_oracle(c):
    """The commit by the fact the kernel rests on: a mover i with target t
    is admitted iff D_t(p_i) <= slack_t, D_t(p) the weight of t's movers
    with priority <= p and slack_t = cap_t - label_w_t.  int64 numpy, one
    target at a time, every pair of its movers compared."""
    n, L = c["labels"].shape[0], c["L"]
    moved, desired = commit_movers(c)
    slack = (np.broadcast_to(c["maxw"], (L,)).astype(np.int64)
             - c["lw"].astype(np.int64))
    accept = np.zeros(n, dtype=bool)
    for tgt in np.unique(desired[moved]):
        i = np.flatnonzero(moved & (desired == tgt))
        p, w = c["prio"][i].astype(np.int64), c["node_w"][i].astype(np.int64)
        d = ((p[None, :] <= p[:, None]) * w[None, :]).sum(axis=1)
        accept[i] = d <= slack[tgt]
    new_labels = np.where(accept, desired, c["labels"]).astype(np.int32)
    new_weights = np.zeros(L, dtype=np.int64)
    np.add.at(new_weights, new_labels, c["node_w"].astype(np.int64))
    return new_labels, new_weights, int(accept.sum())


@pytest.mark.parametrize("inst", ["cluster", "refine"])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_auction_fact_matches_pallas_and_plain(case, inst):
    """Admitting a mover iff D_t(p_i) <= slack_t equals the Pallas commit
    body (both auctions, interpret mode) and the plain version (both
    auctions) on the edge cases of the auction, in both instantiations
    (the same cases run against the CUDA kernel in test_torch_cuda.py)."""
    c = commit_case(case, inst)
    ref = auction_oracle(c)
    assert 0 < ref[2] and int(ref[1].sum()) == int(c["node_w"].astype(np.int64).sum())
    f = c["flags"]
    for radix in (True, False):
        out = pallas_commit(c["labels"], c["node_w"], c["lw"], c["maxw"], c["target"],
                            c["tconn"], c["own"], c["prio"], c["coin"], c["act"],
                            c["color"], c["L"], radix=radix, **f)
        what = f"{case} {inst} radix={radix}"
        assert_equal(ref[0], out[0], f"Pallas labels {what}")
        assert_equal(ref[1], out[1], f"Pallas weights {what}")
        assert int(out[2]) == ref[2], what
        args, kwargs = commit_call(c, "cpu")
        out = lp_kernels.commit_moves(*args, **kwargs, radix=radix)
        assert_equal(ref[0], out.labels, f"plain labels {what}")
        assert_equal(ref[1], out.label_weights, f"plain weights {what}")
        assert int(out.num_moved) == ref[2], what


# -- whole rounds with the JAX package's draws -----------------------------


@pytest.mark.parametrize("name", ["rmat", "grid", "star", "hub"])
def test_lp_round_clustering_matches_jax(name):
    jg, tg = graph_pair(name)
    n_pad, js, ts = clustering_setup(jg, tg)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    max_w = 25
    for rnd in range(3):
        key = next_key()
        js = jlp.lp_round_bucketed(
            js, key, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
            jnp.asarray(max_w, jnp.int32), num_labels=n_pad, active_prob=0.5,
        )
        ts = tlp.lp_round_bucketed(
            ts, jax_round_draws(key, jbv, n_pad, active_prob=0.5), tbv,
            tg.padded().node_w, torch.tensor(max_w, dtype=torch.int32),
            num_labels=n_pad, active_prob=0.5,
        )
        assert_state_equal(js, ts, f"{name} round {rnd}")


TIES_LIGHTEST = dict(active_prob=0.5, allow_tie_moves=True, tie_break="lightest")


@pytest.mark.parametrize("name,options", [
    ("rmat", {}), ("rmat", TIES_LIGHTEST), ("hub", TIES_LIGHTEST),
], ids=["rmat-default", "rmat-ties-lightest", "hub-ties-lightest"])
def test_lp_round_refinement_matches_jax(name, options):
    jg, tg = graph_pair(name)
    L, js, ts, caps = refinement_setup(jg, tg, 8, np.random.default_rng(5))
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    for rnd in range(3):
        key = next_key()
        js = jlp.lp_round_bucketed(
            js, key, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
            jnp.asarray(caps), num_labels=L, **options,
        )
        draws = jax_round_draws(
            key, jbv, jpv.n_pad, active_prob=options.get("active_prob", 1.0),
            allow_tie_moves=options.get("allow_tie_moves", False),
        )
        ts = tlp.lp_round_bucketed(ts, draws, tbv, tg.padded().node_w, t(caps),
                                   num_labels=L, **options)
        assert_state_equal(js, ts, f"{name} round {rnd}")


@pytest.mark.parametrize("mode", ["cluster", "refine"])
def test_lp_iterate_matches_jax(mode):
    jg, tg = graph_pair("rmat")
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    if mode == "cluster":
        L, js, ts = clustering_setup(jg, tg)
        caps, active_prob = np.asarray(40, dtype=np.int32), 0.5
    else:
        L, js, ts, caps = refinement_setup(jg, tg, 8, np.random.default_rng(6))
        active_prob = 1.0
    key = next_key()
    js = jlp.lp_iterate_bucketed(
        js, key, jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w, jnp.asarray(caps),
        jnp.int32(1), jnp.int32(6), num_labels=L, active_prob=active_prob,
    )
    ts = tlp.lp_iterate_bucketed(
        ts, lambda i: jax_round_draws(jax.random.fold_in(key, i), jbv, jpv.n_pad,
                                      active_prob=active_prob),
        tbv, tg.padded().node_w, t(caps), 1, 6, num_labels=L, active_prob=active_prob,
    )
    assert_state_equal(js, ts, mode)


@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_balance_round_matches_jax(name):
    """One overload-balancer round with the JAX package's three draws
    (balancer.py: rating ties, gain jitter)."""
    jg, tg = graph_pair(name)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    rng = np.random.default_rng(8)
    k = 4
    part = np.zeros(jpv.n_pad, dtype=np.int32)
    part[: jpv.n] = np.where(rng.random(jpv.n) < 0.55, 0, rng.integers(1, k, jpv.n))
    max_bw = np.full(k, int(jg.total_node_weight / k * 1.03) + 1, dtype=np.int32)
    key = next_key()
    j_labels, j_flags = jbal._balance_round(
        key, jnp.asarray(part), jbv.buckets, jbv.heavy, jbv.gather_idx, jpv.node_w,
        jnp.asarray(max_bw), k=k,
    )
    kb, ks, _ = jax.random.split(key, 3)
    ties, heavy = jax_ties(kb, jbv)
    jitter = t(jax.random.uniform(ks, (jpv.n_pad,), minval=0.0, maxval=1e-3))
    t_labels, t_flags = tbal._balance_round(
        t(part), tbal.BalanceDraws(ties, heavy, jitter), tbv, tg.padded().node_w,
        t(max_bw), k=k,
    )
    assert_equal(j_labels, t_labels, "labels")
    assert_equal(j_flags, t_flags, "flags")
    assert int(t_flags[0]) > 0


def test_isolated_and_two_hop_match_jax():
    jg, tg = graph_pair("rmat")
    n_pad, js, ts = clustering_setup(jg, tg)
    jpv, jbv, tbv = jg.padded(), jg.bucketed(), tg.bucketed()
    tpv = tg.padded()
    max_w = jnp.asarray(6, jnp.int32)
    key = next_key()
    js = jlp.lp_round_bucketed(js, key, jbv.buckets, jbv.heavy, jbv.gather_idx,
                               jpv.node_w, max_w, num_labels=n_pad)
    ts = tlp.lp_round_bucketed(ts, jax_round_draws(key, jbv, n_pad), tbv, tpv.node_w,
                               torch.tensor(6, dtype=torch.int32), num_labels=n_pad)
    js = jlp.cluster_isolated_nodes(js, jpv.row_ptr, jpv.node_w, max_w, num_labels=n_pad)
    ts = tlp.cluster_isolated_nodes(ts, tpv.row_ptr, tpv.node_w,
                                    torch.tensor(6, dtype=torch.int32), num_labels=n_pad)
    assert_state_equal(js, ts, "isolated")
    key = next_key()
    js = jlp.cluster_two_hop_nodes_bucketed(js, key, jbv.buckets, jbv.heavy,
                                            jbv.gather_idx, jpv.node_w, max_w,
                                            num_labels=n_pad)
    kr, kp = jax.random.split(key)
    ties, heavy = jax_ties(kr, jbv)
    prio = t(jax.random.randint(kp, (n_pad,), 0, I32MAX, dtype=jnp.int32))
    ts = tlp.cluster_two_hop_nodes_bucketed(
        ts, tlp.LPDraws(ties, heavy, prio), tbv, tpv.node_w,
        torch.tensor(6, dtype=torch.int32), num_labels=n_pad,
    )
    assert_state_equal(js, ts, "two-hop")


# -- what the rating wrappers decide on the host ----------------------------


@pytest.mark.parametrize("name", ["rmat", "grid", "star", "hub"])
def test_real_rows_match_the_layouts(name):
    """``real_rows`` (dense and compressed layout) counts the rows before
    the pad rows: the JAX builder's rows whose node is not the anchor, all
    of them first."""
    jg, tg = graph_pair(name)
    anchor = jg.padded().anchor
    tbv = tg.bucketed()
    assert tbv.real_rows == tuple(int((np.asarray(b.nodes) != anchor).sum())
                                  for b in jg.bucketed().buckets)
    for b, real in zip(tbv.buckets, tbv.real_rows):
        nodes = b.nodes.numpy()
        assert (nodes[:real] != anchor).all() and (nodes[real:] == anchor).all()
    assert DeviceCompressedView(compress(tg), "cpu").real_rows == tbv.real_rows


@pytest.mark.parametrize("name", ["rmat", "star", "hub"])
def test_fixed_rows_rate_to_their_own_label(name):
    """The rows the kernels answer without loading a slot give (labels[node],
    0, 0, False) in the plain versions for every flag set: the dense
    layout's pad rows and the compressed layout's rows of degree 0 (pad
    rows and isolated nodes)."""
    jg, tg = graph_pair(name)
    pv, bv = tg.padded(), tg.bucketed()
    cv = DeviceCompressedView(compress(tg), "cpu")
    rng = np.random.default_rng(5)
    labels = t(rng.integers(0, pv.n_pad, pv.n_pad), torch.int32)
    lw = t(rng.integers(0, 5, pv.n_pad), torch.int32)
    fixed_rows = 0
    for ext, caps, tie_break in [(False, True, "uniform"), (True, True, "lightest"),
                                 (False, False, "uniform")]:
        flags = dict(external_only=ext, respect_caps=caps, tie_break=tie_break)
        args = (labels, pv.node_w, lw, torch.tensor(4, dtype=torch.int32))
        for b, cb, real in zip(bv.buckets, cv.buckets, bv.real_rows):
            tie = t(rng.integers(0, I32MAX, tuple(b.cols.shape)), torch.int32)
            for out, rows in (
                    (lp_kernels.rate_bucket(*args, b, tie, real_rows=real, **flags),
                     torch.arange(real, b.nodes.shape[0])),
                    (lp_kernels.rate_compressed_bucket(*args, cv.stream, cb, tie, **flags),
                     torch.nonzero(cb.deg == 0)[:, 0])):
                target, tconn, own_conn, has = out
                assert_equal(target[rows], labels[b.nodes[rows]], f"target {flags}")
                assert not tconn[rows].any() and not own_conn[rows].any()
                assert not has[rows].any()
                fixed_rows += len(rows)
    assert fixed_rows > 0


@pytest.mark.parametrize("name", ["rmat", "grid", "hub"])
def test_sort_key_plan_fits_the_layout(name):
    """The sort's label bits hold every label below L (and no fewer bits
    would), and the warp path's 32-bit (label, slot) key is taken exactly
    when it holds the label and the slot: for every bucket width of the
    layout, at the clustering L = n_pad and the refinement L, and at the
    edges of the key width."""
    _, tg = graph_pair(name)
    n_pad = tg.padded().n_pad
    for w in [w for _, w in tg.bucketed().bucket_shapes] + [8, 256, 512, 4096]:
        for L in (n_pad, tlp.num_labels_bucket(8), 1, 2, 2**6, 2**20, 2**23, 2**26,
                  2**26 + 1, 2**27 + 1, 2**31 - 1):
            bits, key64 = lp_kernels.sort_key_plan(L, w)
            assert L - 1 < 2**bits and (bits == 1 or L - 1 >= 2**(bits - 1)), (L, bits)
            log2w = w.bit_length() - 1
            assert key64 == (w <= lp_kernels.WARP_MAX_WIDTH and bits + log2w > 32), (L, w)
    assert lp_kernels.sort_key_plan(2**26, 64) == (26, False)
    assert lp_kernels.sort_key_plan(2**26 + 1, 64) == (27, True)
    assert lp_kernels.sort_key_plan(2**26 + 1, 128) == (27, False)


def test_rate_wrapper_checks_real_rows():
    """``real_rows`` must be given and lie in [0, R], on either device; on
    the CPU the plain version rates every row, so the answer does not
    depend on it."""
    jg, tg = graph_pair("rmat")
    pv, bv = tg.padded(), tg.bucketed()
    b, real = bv.buckets[0], bv.real_rows[0]
    tie = t(np.random.default_rng(2).integers(0, I32MAX, tuple(b.cols.shape)), torch.int32)
    args = (t(np.arange(pv.n_pad), torch.int32), pv.node_w,
            torch.zeros(pv.n_pad, dtype=torch.int32), torch.tensor(9, dtype=torch.int32))
    flags = dict(external_only=False, respect_caps=True)
    for bad in (-1, int(b.nodes.shape[0]) + 1):
        with pytest.raises(ValueError):
            lp_kernels.rate_bucket(*args, b, tie, real_rows=bad, **flags)
    with pytest.raises(TypeError):
        lp_kernels.rate_bucket(*args, b, tie, **flags)
    R = int(b.nodes.shape[0])
    ref = lp_kernels.rate_bucket(*args, b, tie, real_rows=real, **flags)
    for rows in (0, R):
        for r, o in zip(ref, lp_kernels.rate_bucket(*args, b, tie, real_rows=rows, **flags)):
            assert_equal(r, o)


def test_wrappers_route_by_device_and_count_only_kernel_launches():
    """CPU tensors take the plain version and leave the launch counters
    alone; a tensor on a device without a kernel raises."""
    jg, tg = graph_pair("grid")
    n_pad, _, ts = clustering_setup(jg, tg)
    tbv = tg.bucketed()
    lp_kernels.reset_launches()
    draws = tlp.draw_lp_round(torch.Generator().manual_seed(0), tbv, n_pad)
    tlp.lp_round_bucketed(ts, draws, tbv, tg.padded().node_w,
                          torch.tensor(9, dtype=torch.int32), num_labels=n_pad)
    assert lp_kernels.LAUNCHES == {"lp_rate": 0, "lp_rate_compressed": 0, "lp_commit": 0}
    b = tbv.buckets[0]
    meta = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        lp_kernels.rate_bucket(meta, meta, meta, meta, b, draws.ties[0],
                               real_rows=tbv.real_rows[0], external_only=False,
                               respect_caps=True)
