"""Port parity of contraction, projection and the host initial partitioner.

Contraction is a deterministic stable sort-reduce and the host pool is the
same numpy code driven by the same numpy ``Generator``, so both must equal
the JAX package's results exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaminpar_tpu.context import InitialPartitioningContext as JaxIPContext
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.initial import bipartitioner as jbip
from kaminpar_tpu.ops.contraction import contract_clustering as jax_contract
from kaminpar_tpu.ops.contraction import project_partition as jax_project
from kaminpar_tpu_torch.context import InitialPartitioningContext
from kaminpar_tpu_torch.graph import generators as tgen
from kaminpar_tpu_torch.initial import bipartitioner as tbip
from kaminpar_tpu_torch.ops.contraction import contract_clustering, project_partition
from kaminpar_tpu_torch.partitioning.kway import graph_to_host

GRAPHS = {
    "rmat": lambda m: m.rmat_graph(9, 8, seed=2),
    "grid": lambda m: m.grid2d_graph(24, 24),
    "star": lambda m: m.star_graph(96),
}


def np_of(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("clusters", [3, 40])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_contraction_matches_jax(name, clusters):
    jg, tg = GRAPHS[name](jgen), GRAPHS[name](tgen)
    pv = jg.padded()
    rng = np.random.default_rng(clusters)
    # clusters named by node ids, pads in the anchor's cluster
    reps = rng.choice(pv.n, size=max(pv.n // clusters, 1), replace=False)
    labels = np.full(pv.n_pad, pv.anchor, dtype=np.int32)
    labels[: pv.n] = reps[rng.integers(0, len(reps), pv.n)]
    jc, j_of = jax_contract(jg, jnp.asarray(labels))
    tc, t_of = contract_clustering(tg, torch.from_numpy(labels))
    assert (jc.n, jc.m) == (tc.n, tc.m)
    for attr in ("row_ptr", "col_idx", "edge_w", "node_w", "edge_u"):
        assert np.array_equal(np_of(getattr(jc, attr)), np_of(getattr(tc, attr))), attr
    assert np.array_equal(np_of(j_of), np_of(t_of))
    assert tc.total_node_weight == jg.total_node_weight
    coarse_part = rng.integers(0, 4, tc.n).astype(np.int32)
    assert np.array_equal(
        np_of(jax_project(j_of, jnp.asarray(coarse_part))),
        np_of(project_partition(t_of, torch.from_numpy(coarse_part))),
    )


@pytest.mark.parametrize("k", [2, 5])
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_recursive_bipartition_matches_jax(name, k):
    tg = GRAPHS[name](tgen)
    host = graph_to_host(tg)
    budgets = np.full(k, int(host.node_w.sum() / k * 1.03) + 1, dtype=np.int64)
    ctx = InitialPartitioningContext(ip_backend="host")
    jctx = JaxIPContext(ip_backend="host")
    for field in dataclasses.fields(ctx):
        assert getattr(ctx, field.name) == getattr(jctx, field.name), field.name
    jhost = jbip.HostCSR(*host)
    ref = jbip.recursive_bipartition(jhost, k, budgets, np.random.default_rng(11), jctx)
    out = tbip.recursive_bipartition(host, k, budgets, np.random.default_rng(11), ctx)
    assert np.array_equal(ref, out)
    assert np.bincount(out, weights=host.node_w, minlength=k).max() <= budgets.max()
