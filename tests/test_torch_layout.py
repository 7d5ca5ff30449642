"""Port parity of the graph layer: generators, the padded view and the
degree-bucketed layout must equal the JAX package's array for array (all
integer data, so the comparison is exact)."""

import numpy as np
import pytest
import torch

from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph.bucketed import build_bucketed_view as jax_build_bucketed
from kaminpar_tpu.utils.intmath import next_pow2 as jax_next_pow2
from kaminpar_tpu.utils.intmath import next_shape_bucket as jax_next_shape_bucket
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.graph.bucketed import build_bucketed_view as torch_build_bucketed
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.utils.intmath import next_pow2, next_shape_bucket


def hub_edges():
    """A hub adjacent to 4300 nodes (degree > MAX_WIDTH = 4096, so it takes
    the heavy path) plus random edges among the other nodes."""
    rng = np.random.default_rng(7)
    star = np.stack([np.zeros(4300, dtype=np.int64), np.arange(1, 4301)], axis=1)
    rand = rng.integers(1, 4400, (3000, 2))
    return 4400, np.concatenate([star, rand])


GRAPHS = {
    "rmat": (lambda m: m.rmat_graph(9, 8, seed=2)),
    "grid": (lambda m: m.grid2d_graph(24, 24)),
    "star": (lambda m: m.star_graph(96)),
}


def graph_pair(name):
    """The same graph built by both packages."""
    if name == "hub":
        from kaminpar_tpu.graph.csr import from_edge_list as jax_from_edge_list

        n, edges = hub_edges()
        return jax_from_edge_list(n, edges), from_edge_list(n, edges)
    return GRAPHS[name](jgen), GRAPHS[name](tgen)


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("name", ["rmat", "grid", "star", "hub"])
def test_graph_and_padded_view_equal(name):
    jg, tg = graph_pair(name)
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert np.array_equal(np_of(getattr(jg, attr)), np_of(getattr(tg, attr))), attr
    jp, tp = jg.padded(), tg.padded()
    assert (jp.n_pad, jp.m_pad, jp.anchor) == (tp.n_pad, tp.m_pad, tp.anchor)
    for attr in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert np.array_equal(np_of(getattr(jp, attr)), np_of(getattr(tp, attr))), attr


@pytest.mark.parametrize("gen", ["rgg", "rmat_weighted", "edge_list", "edge_list_nodedup"])
def test_generators_equal(gen):
    from kaminpar_tpu.graph.csr import from_edge_list as jax_from_edge_list

    if gen == "rgg":
        jg, tg = jgen.rgg2d_graph(700, seed=3), tgen.rgg2d_graph(700, seed=3)
    elif gen == "rmat_weighted":
        jg, tg = jgen.rmat_graph(8, 4, seed=9), tgen.rmat_graph(8, 4, seed=9)
    else:
        # weighted duplicates and self-loops, merged or kept
        rng = np.random.default_rng(4)
        edges = rng.integers(0, 300, (2000, 2))
        w = rng.integers(1, 9, 2000)
        kw = dict(dedup=gen == "edge_list")
        jg = jax_from_edge_list(300, edges, edge_weights=w, **kw)
        tg = from_edge_list(300, edges, edge_weights=w, **kw)
    for attr in ("row_ptr", "col_idx", "edge_w"):
        assert np.array_equal(np_of(getattr(jg, attr)), np_of(getattr(tg, attr))), attr


@pytest.mark.parametrize("name", ["rmat", "grid", "star", "hub"])
def test_bucketed_layout_equal(name):
    jg, tg = graph_pair(name)
    jv = jax_build_bucketed(
        np.asarray(jg.row_ptr), np.asarray(jg.col_idx), np.asarray(jg.edge_w),
        jg.n, jg.padded().anchor,
    )
    tv = tg.bucketed()
    assert len(jv.buckets) == len(tv.buckets)
    for jb, tb in zip(jv.buckets, tv.buckets):
        for a in ("nodes", "cols", "wgts"):
            assert np.array_equal(np_of(getattr(jb, a)), np_of(getattr(tb, a))), a
    for a in ("nodes", "row", "cols", "wgts"):
        assert np.array_equal(np_of(getattr(jv.heavy, a)), np_of(getattr(tv.heavy, a))), a
    assert np.array_equal(np_of(jv.gather_idx), np_of(tv.gather_idx))
    assert jv.num_rows == tv.num_rows
    if name == "hub":
        assert tv.heavy.nodes.shape[0] > 0  # the flat heavy path is covered


def test_shape_ladders_equal():
    for x in list(range(0, 3000, 7)) + [2**k + d for k in range(8, 25) for d in (-1, 0, 1)]:
        assert next_shape_bucket(x, 256) == jax_next_shape_bucket(x, 256), x
        assert next_pow2(x, 8) == jax_next_pow2(x, 8), x
