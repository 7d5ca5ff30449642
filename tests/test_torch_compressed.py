"""Port parity of the TeraPart tier: compression, the device view, the
decode, the decode-fused rating (the plain version of kernel #2, what its
wrapper runs on CPU tensors, against the JAX package's Pallas kernel in
interpret mode), the compressed LP round, sweep and two-hop pass with the
JAX package's own draws fed in, contraction and re-materialisation: all
exact, every value being an integer.

The slice as a whole: the port's ``terapart`` partitions identically with
``device_decode="finest"`` and ``"off"``, never decompresses on the host
under "finest", raises outside its envelope, and cuts about as well as the
JAX ``terapart`` facade.  The two packages draw from different random
streams (torch generators against threefry), so that last comparison is
one of quality, with the tolerances of ``test_torch_pipeline.py``, set
before the port was measured: both sides feasible in every cell, the
port's cut at most 1.30x the JAX cut per cell (one seed of a randomized
multilevel run varies by tens of percent on small graphs), and the
geometric mean of port/JAX at most 1.10 (per-cell noise averages out; a
systematic loss would not).

The CUDA kernel itself is compared with the plain version on the card in
``test_torch_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph import metrics as jmetrics
from kaminpar_tpu.graph.compressed import compress as jax_compress
from kaminpar_tpu.graph.csr import from_edge_list as jax_from_edge_list
from kaminpar_tpu.graph.device_compressed import DeviceCompressedView as JaxView
from kaminpar_tpu.graph.device_compressed import _decode_flat_padded_jit, decode_bucket
from kaminpar_tpu.kaminpar import KaMinPar as JaxKaMinPar
from kaminpar_tpu.ops import contraction as jcontraction
from kaminpar_tpu.ops import lp as jlp
from kaminpar_tpu.ops import pallas_lp
from kaminpar_tpu.utils import next_key
from kaminpar_tpu_torch.graph import device_compressed as tdc
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph import metrics as tmetrics
from kaminpar_tpu_torch.graph.compressed import CompressedGraph, compress
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.ops import lp as tlp
from kaminpar_tpu_torch.ops import lp_kernels
from kaminpar_tpu_torch.ops.contraction import contract_clustering, contract_compressed
from kaminpar_tpu_torch.presets import create_context_by_preset_name


@pytest.fixture(scope="module", autouse=True)
def _release_jax_executables():
    """Drop this module's compiled JAX programs when it ends: each holds
    memory mappings, and an xdist worker that runs several JAX-heavy
    modules in one process can otherwise reach the kernel's limit on them."""
    yield
    jax.clear_caches()


I32MAX = 2**31 - 1


def _weighted_edges():
    """rmat_graph(9, 8)'s edges with numpy-random weights (each undirected
    edge once; from_edge_list stores both directions with its weight)."""
    g = tgen.rmat_graph(9, 8, seed=1)
    u = g.edge_u.numpy()
    v = g.col_idx.numpy()
    keep = u < v
    edges = np.stack([u[keep], v[keep]], axis=1)
    w = np.random.default_rng(5).integers(1, 10, len(edges))
    return g.n, edges, w


def _hub_edges():
    """One hub of degree 4300 > MAX_WIDTH (the heavy part) and random edges."""
    rng = np.random.default_rng(7)
    star = np.stack([np.zeros(4300, dtype=np.int64), np.arange(1, 4301)], axis=1)
    return 4400, np.concatenate([star, rng.integers(1, 4400, (3000, 2))]), None


FAMILIES = {
    "rmat": lambda m: m.rmat_graph(9, 8, seed=1),
    "grid": lambda m: m.grid2d_graph(16, 32),
    "star": lambda m: m.star_graph(512),
}
EDGE_LISTS = {"weighted": _weighted_edges, "hub": _hub_edges}
ALL = sorted(FAMILIES) + sorted(EDGE_LISTS)


def graph_pair(name):
    """The same graph built by both packages."""
    if name in FAMILIES:
        return FAMILIES[name](jgen), FAMILIES[name](tgen)
    n, edges, w = EDGE_LISTS[name]()
    return (jax_from_edge_list(n, edges, edge_weights=w),
            from_edge_list(n, edges, edge_weights=w))


def views(name):
    """(JAX view, port view, port compressed graph) of one graph."""
    jg, tg = graph_pair(name)
    cg = compress(tg)
    return JaxView(jax_compress(jg)), tdc.DeviceCompressedView(cg, "cpu"), cg


def t(x, dtype=None):
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(a, b, what=""):
    a, b = np_of(a), np_of(b)
    assert a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}"
    bad = np.flatnonzero(a.ravel() != b.ravel())
    assert bad.size == 0, (
        f"{what}: first divergence at {bad[0]}: {a.ravel()[bad[0]]} vs {b.ravel()[bad[0]]}"
    )


def assert_state_equal(js, ts, what=""):
    assert_equal(js.labels, ts.labels, f"labels {what}")
    assert_equal(js.label_weights, ts.label_weights, f"label weights {what}")
    assert int(js.num_moved) == int(ts.num_moved), f"num_moved {what}"


# -- the JAX package's draws, reproduced -----------------------------------


def jax_ties(kr, jv):
    """Rating ties as lp.compressed_best_moves draws them: (R, w) per bucket
    from fold_in(kr, i), the heavy part from fold_in(kr, len(buckets))."""
    ties = tuple(
        t(jax.random.randint(jax.random.fold_in(kr, i),
                             (cb.nodes.shape[0], cb.slot.shape[0]), 0, I32MAX,
                             dtype=jnp.int32))
        for i, cb in enumerate(jv.buckets)
    )
    heavy = None
    if jv.heavy.nodes.shape[0] > 0:
        heavy = t(jax.random.randint(jax.random.fold_in(kr, len(jv.buckets)),
                                     jv.heavy.cols.shape, 0, I32MAX, dtype=jnp.int32))
    return ties, heavy


def jax_round_draws(key, jv, *, active_prob=1.0, allow_tie_moves=False):
    """The draws of lp.lp_round_compressed(key): rating and commit keys,
    the commit key split three ways (lp._commit_moves)."""
    kr, kp_ = jax.random.split(key)
    ties, heavy = jax_ties(kr, jv)
    kp_, ka, kt = jax.random.split(kp_, 3)
    n_pad = jv.n_pad
    prio = t(jax.random.randint(kp_, (n_pad,), 0, (1 << 30) - 1, dtype=jnp.int32))
    coin = t(jax.random.bernoulli(kt, 0.5, (n_pad,))) if allow_tie_moves else None
    act = t(jax.random.bernoulli(ka, active_prob, (n_pad,))) if active_prob < 1.0 else None
    return tlp.LPDraws(ties, heavy, prio, coin, act)


def clustering_states(jv, tv):
    labels = np.concatenate(
        [np.arange(jv.n), np.full(jv.n_pad - jv.n, jv.anchor)]
    ).astype(np.int32)
    js = jlp.init_state(jnp.asarray(labels), jv.node_w_pad, jv.n_pad)
    ts = tlp.init_state(t(labels), tv.node_w_pad, tv.n_pad)
    return js, ts


def refinement_states(jv, tv, k, rng):
    part = np.zeros(jv.n_pad, dtype=np.int32)
    part[: jv.n] = rng.integers(0, k, jv.n)
    L = tlp.num_labels_bucket(k)
    js = jlp.init_state(jnp.asarray(part), jv.node_w_pad, L)
    ts = tlp.init_state(t(part), tv.node_w_pad, L)
    caps = np.zeros(L, dtype=np.int32)
    caps[:k] = int(jv.total_node_weight / k * 1.1)
    return L, js, ts, caps


# -- storage and layout ----------------------------------------------------


@pytest.mark.parametrize("name", ALL)
def test_compress_matches_jax(name):
    jg, tg = graph_pair(name)
    jc, tc = jax_compress(jg), compress(tg)
    assert (jc.n, jc.m) == (tc.n, tc.m)
    for attr in ("words", "word_start", "width", "degree", "node_w"):
        a, b = getattr(jc, attr), getattr(tc, attr)
        assert a.dtype == b.dtype, attr
        assert_equal(a, b, attr)
    assert (jc.edge_w is None) == (tc.edge_w is None)
    # grid and star have unit weights (no weight stream); RMAT's merged
    # duplicate edges and the random weights give weighted streams
    assert (tc.edge_w is None) == (name in ("grid", "star"))
    if tc.edge_w is not None:
        assert_equal(jc.edge_w, tc.edge_w, "edge_w")
    # the host decompress restores the graph
    row_ptr, col, _, _ = tc.decompress_arrays()
    assert_equal(row_ptr, tg.row_ptr, "row_ptr")
    assert_equal(col, tg.col_idx, "col_idx")


@pytest.mark.parametrize("name", ALL)
def test_view_matches_jax(name):
    jv, tv, _ = views(name)
    assert (jv.n, jv.m, jv.n_pad, jv.m_pad) == (tv.n, tv.m, tv.n_pad, tv.m_pad)
    assert_equal(jv.stream.words, np_of(tv.stream.words).view(np.uint32), "words")
    assert_equal(jv.stream.edge_w, tv.stream.edge_w, "edge_w")
    for attr in ("node_w_pad", "degree_pad", "wstart_pad", "width_pad", "gather_idx"):
        assert_equal(getattr(jv, attr), getattr(tv, attr), attr)
    assert len(jv.buckets) == len(tv.buckets)
    for jb, tb in zip(jv.buckets, tv.buckets):
        assert int(jb.slot.shape[0]) == tb.w
        for attr in ("nodes", "wstart", "width", "deg", "estart"):
            assert_equal(getattr(jb, attr), getattr(tb, attr), f"{attr} w={tb.w}")
    for a, b in zip(jv.heavy, tv.heavy):
        assert_equal(a, b, "heavy")
    if name == "hub":
        assert tv.heavy.nodes.shape[0] > 0
    assert tv.resident_bytes() == jv.resident_bytes()
    assert tv.dense_resident_bytes() == jv.dense_resident_bytes()


@pytest.mark.parametrize("name", ALL)
def test_decode_matches_jax_and_dense_layout(name):
    """decode_rows per bucket and decode_flat_padded equal the JAX decode
    and the port's dense bucketed/padded views of the decompressed graph."""
    jv, tv, cg = views(name)
    dense = cg.decompress()
    bv, pv = dense.bucketed(), dense.padded()
    dec = jax.jit(lambda s, cb: decode_bucket(s, cb, jnp.int32))
    assert len(bv.buckets) == len(tv.buckets)
    assert_equal(bv.gather_idx, tv.gather_idx, "gather_idx")
    for jb, tb, db in zip(jv.buckets, tv.buckets, bv.buckets):
        cols, wgts = tdc.decode_bucket(tv.stream, tb)
        jcols, jwgts = dec(jv.stream, jb)
        assert_equal(jcols, cols, f"cols w={tb.w}")
        assert_equal(jwgts, wgts, f"wgts w={tb.w}")
        assert_equal(db.cols, cols, f"dense cols w={tb.w}")
        assert_equal(db.wgts, wgts, f"dense wgts w={tb.w}")
    for a, b in zip(bv.heavy, tv.heavy):
        assert_equal(a, b, "heavy vs dense")
    flat = tdc.decode_flat_padded(tv.stream, tv.wstart_pad, tv.width_pad, tv.degree_pad,
                                  m=tv.m, m_pad=tv.m_pad)
    jflat = _decode_flat_padded_jit(jv.stream, jv.wstart_pad, jv.width_pad,
                                    jv.degree_pad, m_pad=jv.m_pad)
    for what, ours, theirs, ref in zip(("row_ptr", "col_idx", "edge_w", "edge_u"), flat,
                                       jflat, (pv.row_ptr, pv.col_idx, pv.edge_w,
                                               pv.edge_u)):
        assert_equal(theirs, ours, what)
        assert_equal(ref, ours, f"dense {what}")


def test_flat_decode_wraps_and_chunks_exactly(monkeypatch):
    """The flat decode's int32 cumsum wraps (the column ids of a 64K-node
    grid sum past 2^32) and its gap unpacking runs in chunks that split
    rows; both must leave the padded CSR of the decompressed graph."""
    g = tgen.grid2d_graph(256, 256)
    cg = compress(g)
    assert int(g.col_idx.to(torch.int64).sum()) > 2**32
    monkeypatch.setattr(tdc, "DECODE_CHUNK", 1000)
    tv = tdc.DeviceCompressedView(cg, "cpu")
    flat = tdc.decode_flat_padded(tv.stream, tv.wstart_pad, tv.width_pad, tv.degree_pad,
                                  m=tv.m, m_pad=tv.m_pad)
    pv = cg.decompress().padded()
    for what, ours, ref in zip(("row_ptr", "col_idx", "edge_w", "edge_u"), flat,
                               (pv.row_ptr, pv.col_idx, pv.edge_w, pv.edge_u)):
        assert_equal(ref, ours, what)


def test_materialize_csr_matches_host_decompress():
    _, tv, cg = views("weighted")
    g = tv.materialize_csr()
    ref = cg.decompress()
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert_equal(getattr(ref, attr), getattr(g, attr), attr)
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert_equal(getattr(ref.padded(), attr), getattr(g.padded(), attr), f"padded {attr}")
    assert_equal(ref.host_row_ptr(), g.host_row_ptr(), "host row_ptr")
    assert g._compressed_view is tv
    assert g.total_node_weight == ref.total_node_weight
    assert g.max_node_weight == ref.max_node_weight


# -- rating kernel #2 --------------------------------------------------------

# (instantiation, external_only, respect_caps, tie_break): the clustering
# round, the two-hop favoured cluster, the balancer and an LP refinement
# round with lightest-first ties: both instantiations, the three flag
# combinations, both tie-breaks.
RATE_CONFIGS = [
    ("cluster", False, True, "uniform"),
    ("cluster", False, False, "lightest"),
    ("refine", True, True, "uniform"),
    ("refine", False, True, "lightest"),
]
# Every configuration on a weighted stream (rmat: merged duplicate edges)
# and an unweighted one (grid); the random weights and the star (one wide
# row) with one configuration of each instantiation or one in all.
RATE_CASES = (
    [(name, c) for name in ("rmat", "grid") for c in RATE_CONFIGS]
    + [("weighted", RATE_CONFIGS[i]) for i in (0, 3)] + [("star", RATE_CONFIGS[0])]
)


@pytest.mark.parametrize("name,config", RATE_CASES,
                         ids=lambda c: c if isinstance(c, str) else "-".join(map(str, c)))
def test_compressed_rating_plain_matches_pallas_kernel(name, config):
    inst, external_only, respect_caps, tie_break = config
    rng = np.random.default_rng(1)
    jv, tv, _ = views(name)
    n_pad = jv.n_pad
    node_w = np.asarray(jv.node_w_pad)
    if inst == "cluster":
        labels = rng.integers(0, n_pad // 3, n_pad).astype(np.int32)
        L = n_pad
    else:
        labels = rng.integers(0, 8, n_pad).astype(np.int32)
        L = 64
    lw = np.bincount(labels, weights=node_w, minlength=L).astype(np.int32)
    if inst == "cluster":
        maxw = np.asarray(int(np.median(lw[lw > 0])) + 1, dtype=np.int32)
        maxw_j = jnp.asarray(maxw).reshape(1)
    else:
        maxw = np.zeros(L, dtype=np.int32)
        maxw[:8] = np.sort(lw[:8])[4] + rng.integers(0, 3, 8)
        maxw_j = jnp.asarray(maxw)
    for jb, tb in zip(jv.buckets, tv.buckets):
        tie = rng.integers(0, I32MAX, (tb.nodes.shape[0], tb.w)).astype(np.int32)
        ref = pallas_lp._rate_compressed_bucket(
            jnp.asarray(labels), jv.node_w_pad, jnp.asarray(lw), maxw_j, jv.stream, jb,
            jnp.asarray(tie), external_only=external_only, respect_caps=respect_caps,
            tie_break=tie_break, maxw_scalar=inst == "cluster",
        )
        out = lp_kernels.rate_compressed_bucket(
            t(labels), tv.node_w_pad, t(lw), t(maxw), tv.stream, tb, t(tie),
            external_only=external_only, respect_caps=respect_caps, tie_break=tie_break,
        )
        for r, o, what in zip(ref, out, ("target", "tconn", "own_conn", "has")):
            assert_equal(r, o, f"{what} w={tb.w}")


# -- whole rounds with the JAX package's draws -----------------------------


@pytest.mark.parametrize("name", ["rmat", "weighted", "hub"])
def test_lp_round_compressed_matches_jax(name):
    jv, tv, _ = views(name)
    js, ts = clustering_states(jv, tv)
    for rnd in range(2):
        key = next_key()
        js = jlp.lp_round_compressed(
            js, key, jv.buckets, jv.stream, jv.heavy, jv.gather_idx, jv.node_w_pad,
            jnp.asarray(25, jnp.int32), num_labels=jv.n_pad, active_prob=0.5,
        )
        ts = tlp.lp_round_compressed(
            ts, jax_round_draws(key, jv, active_prob=0.5), tv, tv.node_w_pad,
            torch.tensor(25, dtype=torch.int32), num_labels=tv.n_pad, active_prob=0.5,
        )
        assert_state_equal(js, ts, f"{name} round {rnd}")


@pytest.mark.parametrize("mode", ["cluster", "refine"])
def test_lp_iterate_compressed_matches_pallas(mode):
    """The sweep loop against the JAX package's decode-fused Pallas sweep
    (interpret mode): the same early exit and key folding."""
    jv, tv, _ = views("rmat")
    if mode == "cluster":
        js, ts = clustering_states(jv, tv)
        L, caps, options = jv.n_pad, np.asarray(40, dtype=np.int32), dict(active_prob=0.5)
    else:
        L, js, ts, caps = refinement_states(jv, tv, 8, np.random.default_rng(6))
        options = dict(allow_tie_moves=True, tie_break="lightest")
    key = next_key()
    js = pallas_lp.lp_iterate_compressed(
        js, key, jv.buckets, jv.stream, jv.heavy, jv.gather_idx, jv.node_w_pad,
        jnp.asarray(caps), jnp.int32(1), jnp.int32(5), num_labels=L, **options,
    )
    ts = tlp.lp_iterate_compressed(
        ts, lambda i: jax_round_draws(
            jax.random.fold_in(key, i), jv, active_prob=options.get("active_prob", 1.0),
            allow_tie_moves=options.get("allow_tie_moves", False)),
        tv, tv.node_w_pad, t(caps), 1, 5, num_labels=L, **options,
    )
    assert_state_equal(js, ts, mode)


@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_isolated_and_two_hop_compressed_match_jax(name):
    jv, tv, _ = views(name)
    js, ts = clustering_states(jv, tv)
    max_w = 6
    key = next_key()
    js = jlp.lp_round_compressed(js, key, jv.buckets, jv.stream, jv.heavy, jv.gather_idx,
                                 jv.node_w_pad, jnp.asarray(max_w, jnp.int32),
                                 num_labels=jv.n_pad)
    ts = tlp.lp_round_compressed(ts, jax_round_draws(key, jv), tv, tv.node_w_pad,
                                 torch.tensor(max_w, dtype=torch.int32), num_labels=tv.n_pad)
    js = jlp.cluster_isolated_nodes(js, jv.row_ptr_like(), jv.node_w_pad,
                                    jnp.asarray(max_w, jnp.int32), num_labels=jv.n_pad)
    ts = tlp.cluster_isolated_nodes(ts, tv.row_ptr_like(), tv.node_w_pad,
                                    torch.tensor(max_w, dtype=torch.int32),
                                    num_labels=tv.n_pad)
    assert_state_equal(js, ts, "isolated")
    key = next_key()
    js = jlp.cluster_two_hop_nodes_compressed(
        js, key, jv.buckets, jv.stream, jv.heavy, jv.gather_idx, jv.node_w_pad,
        jnp.asarray(max_w, jnp.int32), num_labels=jv.n_pad,
    )
    kr, kp_ = jax.random.split(key)
    ties, heavy = jax_ties(kr, jv)
    prio = t(jax.random.randint(kp_, (jv.n_pad,), 0, I32MAX, dtype=jnp.int32))
    ts = tlp.cluster_two_hop_nodes_compressed(
        ts, tlp.LPDraws(ties, heavy, prio), tv, tv.node_w_pad,
        torch.tensor(max_w, dtype=torch.int32), num_labels=tv.n_pad,
    )
    assert_state_equal(js, ts, "two-hop")


def test_dense_and_compressed_layouts_take_the_same_draws():
    _, tv, cg = views("hub")
    bv = cg.decompress().bucketed()
    assert tv.bucket_shapes == bv.bucket_shapes
    a = tlp.draw_lp_round(torch.Generator().manual_seed(3), tv, tv.n_pad, active_prob=0.5)
    b = tlp.draw_lp_round(torch.Generator().manual_seed(3), bv, tv.n_pad, active_prob=0.5)
    for x, y in zip(a.ties + (a.heavy_tie, a.prio, a.act), b.ties + (b.heavy_tie, b.prio, b.act)):
        assert torch.equal(x, y)


# -- contraction ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["rmat", "weighted"])
def test_contract_compressed_matches_jax_and_dense(name):
    jv, tv, cg = views(name)
    rng = np.random.default_rng(3)
    labels = np.full(tv.n_pad, tv.anchor, dtype=np.int32)
    labels[: tv.n] = rng.integers(0, tv.n // 3, tv.n)
    jc, j_of = jcontraction.contract_compressed(jv, jnp.asarray(labels))
    tc, t_of = contract_compressed(tv, torch.from_numpy(labels))
    dc, d_of = contract_clustering(cg.decompress(), torch.from_numpy(labels))
    assert (jc.n, jc.m) == (tc.n, tc.m) == (dc.n, dc.m)
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert_equal(getattr(jc, attr), getattr(tc, attr), attr)
        assert_equal(getattr(dc, attr), getattr(tc, attr), f"dense {attr}")
    assert_equal(j_of, t_of, "coarse_of")
    assert_equal(d_of, t_of, "dense coarse_of")
    assert tc.total_node_weight == cg.total_node_weight


# -- the slice as a whole ----------------------------------------------------


def _terapart(graph, k, mode):
    s = kp.KaMinPar("terapart", device="cpu")
    # a small contraction limit: at least one coarse level on small graphs
    s.ctx.coarsening.contraction_limit = 48
    s.ctx.compression.device_decode = mode
    s.set_graph(graph)
    return s.compute_partition(k), s


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_terapart_off_and_finest_partition_identically(family, k):
    g = FAMILIES[family](tgen)
    off, _ = _terapart(g, k, "off")
    fin, solver = _terapart(g, k, "finest")
    assert np.array_equal(off, fin)
    assert solver.last_partitioner.compressed_view is not None
    assert solver.last_partitioner.num_levels >= 1
    assert solver.last_partition.is_feasible()


def test_finest_never_decompresses_on_the_host(monkeypatch):
    def refuse(self, device="cpu"):
        raise AssertionError("host decompress under device_decode=finest")

    monkeypatch.setattr(CompressedGraph, "decompress", refuse)
    g = tgen.rmat_graph(9, 8, seed=1)
    part, solver = _terapart(g, 4, "finest")
    assert solver.last_partition.is_feasible() and part.shape == (g.n,)
    with pytest.raises(AssertionError, match="host decompress"):
        _terapart(g, 4, "off")


def test_compressed_input_and_envelope():
    """set_graph takes a CompressedGraph; "auto" resolves to "finest";
    outside the envelope the view build raises (no dense fallback); an
    unknown mode is refused."""
    g = tgen.grid2d_graph(16, 16)
    s = kp.KaMinPar("default", device="cpu")
    s.set_graph(compress(g))
    assert s.graph is None and s.compressed_graph is not None
    assert s.compute_partition(2).shape == (g.n,)
    assert s.last_partitioner.compressed_view is None  # default: "off"
    ctx = create_context_by_preset_name("terapart")
    assert ctx.compression.device_decode == "auto"
    assert tdc.resolve_device_decode("auto") == "finest"
    empty = compress(from_edge_list(0, np.zeros((0, 2), dtype=np.int64)))
    with pytest.raises(NotImplementedError, match="empty"):
        tdc.build_device_view(ctx.compression, empty, "cpu")
    ctx.compression.device_decode = "sometimes"
    with pytest.raises(ValueError):
        tdc.build_device_view(ctx.compression, compress(g), "cpu")


def test_terapart_quality_matches_jax_facade():
    ratios = []
    for make in (lambda m: m.rmat_graph(10, 8, seed=1), lambda m: m.grid2d_graph(32, 32)):
        jg, tg = make(jgen), make(tgen)
        for k in (2, 8):
            js = JaxKaMinPar("terapart")
            js.ctx.seed = 1
            js.ctx.initial_partitioning.ip_backend = "host"
            js.set_graph(jg)
            jpart = js.compute_partition(k)
            ts = kp.KaMinPar("terapart", device="cpu")
            ts.ctx.seed = 1
            ts.set_graph(tg)
            tpart = ts.compute_partition(k)
            assert jmetrics.is_feasible(jg, jpart, k, js.ctx.partition.max_block_weights)
            assert tmetrics.is_feasible(tg, tpart, k, ts.ctx.partition.max_block_weights)
            jcut = jmetrics.edge_cut(jg, jpart)
            tcut = tmetrics.edge_cut(tg, tpart)
            ratio = tcut / max(jcut, 1)
            assert ratio <= 1.30, f"k={k}: port cut {tcut} vs JAX cut {jcut}"
            ratios.append(ratio)
    geo = math.exp(sum(math.log(max(r, 1e-9)) for r in ratios) / len(ratios))
    assert geo <= 1.10, f"geometric mean port/JAX cut ratio {geo:.3f}: {ratios}"


def test_cpu_terapart_launches_no_kernel():
    lp_kernels.reset_launches()
    _terapart(tgen.grid2d_graph(16, 16), 2, "finest")
    assert lp_kernels.LAUNCHES == {"lp_rate": 0, "lp_rate_compressed": 0, "lp_commit": 0}
