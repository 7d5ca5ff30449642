"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither jax nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

All values are integers, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu_torch.graph import generators
from kaminpar_tpu_torch.graph.compressed import compress
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.graph.device_compressed import DeviceCompressedView
from kaminpar_tpu_torch.ops import lp, lp_kernels
from kaminpar_tpu_torch.refinement import balancer

I32MAX = 2**31 - 1

# (instantiation, external_only, respect_caps, tie_break)
RATE_CONFIGS = [
    ("cluster", False, True, "uniform"),
    ("cluster", False, False, "lightest"),
    ("refine", True, True, "uniform"),
    ("refine", False, True, "lightest"),
]


def make_graph(name):
    if name == "hub":  # one node of degree 4300 > MAX_WIDTH: the heavy path
        rng = np.random.default_rng(7)
        star = np.stack([np.zeros(4300, dtype=np.int64), np.arange(1, 4301)], axis=1)
        return from_edge_list(4400, np.concatenate([star, rng.integers(1, 4400, (3000, 2))]))
    if name == "rmat":
        return generators.rmat_graph(11, 16, seed=2)
    return generators.grid2d_graph(40, 40)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def to(x, dev):
    """A tensor, or a NamedTuple of tensors, on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    items = [None if v is None else to(v, dev) for v in x]
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def assert_equal(ref, out, what):
    for r, o in zip(ref, out):
        assert torch.equal(r.cpu(), o.cpu()), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "grid", "hub"])
def test_rate_kernel_matches_plain(cuda, name):
    g = make_graph(name)
    pv, bv = g.padded(), g.bucketed()
    gen = torch.Generator().manual_seed(2)
    for inst, external_only, respect_caps, tie_break in RATE_CONFIGS:
        L = pv.n_pad if inst == "cluster" else 64
        hi = pv.n_pad // 3 if inst == "cluster" else 8
        labels = torch.randint(0, hi, (pv.n_pad,), generator=gen, dtype=torch.int32)
        lw = torch.zeros(L, dtype=torch.int32).index_add_(0, labels, pv.node_w)
        maxw = (torch.tensor(5, dtype=torch.int32) if inst == "cluster"
                else torch.full((L,), int(lw.max()), dtype=torch.int32))
        flags = dict(external_only=external_only, respect_caps=respect_caps,
                     tie_break=tie_break)
        for b in bv.buckets:
            tie = torch.randint(0, I32MAX, tuple(b.cols.shape), generator=gen,
                                dtype=torch.int32)
            args = (labels, pv.node_w, lw, maxw)
            ref = lp_kernels.rate_bucket(*args, b, tie, **flags)
            out = lp_kernels.rate_bucket(*to(args, cuda), to(b, cuda), tie.to(cuda), **flags)
            torch.cuda.synchronize()
            assert_equal(ref, out, f"{name} {inst} {flags} w={b.cols.shape[1]}")


def weighted_grid():
    """grid2d_graph(40, 40) with random edge weights: a weighted stream."""
    g = generators.grid2d_graph(40, 40)
    u, v = g.edge_u.numpy(), g.col_idx.numpy()
    keep = u < v
    w = np.random.default_rng(9).integers(1, 20, int(keep.sum()))
    return from_edge_list(g.n, np.stack([u[keep], v[keep]], axis=1), edge_weights=w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "grid", "weighted-grid", "hub"])
def test_rate_compressed_kernel_matches_plain(cuda, name):
    """Kernel #2 on the card against its plain version (decode, then the
    plain rating) on the CPU, on every bucket of the compressed layout."""
    g = weighted_grid() if name == "weighted-grid" else make_graph(name)
    cg = compress(g)
    cv, dcv = DeviceCompressedView(cg, "cpu"), DeviceCompressedView(cg, cuda)
    assert cv.stream.weighted == (name in ("rmat", "weighted-grid", "hub"))
    gen = torch.Generator().manual_seed(6)
    for inst, external_only, respect_caps, tie_break in RATE_CONFIGS:
        L = cv.n_pad if inst == "cluster" else 64
        hi = cv.n_pad // 3 if inst == "cluster" else 8
        labels = torch.randint(0, hi, (cv.n_pad,), generator=gen, dtype=torch.int32)
        lw = torch.zeros(L, dtype=torch.int32).index_add_(0, labels, cv.node_w_pad)
        maxw = (torch.tensor(5, dtype=torch.int32) if inst == "cluster"
                else torch.full((L,), int(lw.max()), dtype=torch.int32))
        flags = dict(external_only=external_only, respect_caps=respect_caps,
                     tie_break=tie_break)
        for cb, dcb in zip(cv.buckets, dcv.buckets):
            tie = torch.randint(0, I32MAX, (int(cb.nodes.shape[0]), cb.w), generator=gen,
                                dtype=torch.int32)
            args = (labels, cv.node_w_pad, lw, maxw)
            ref = lp_kernels.rate_compressed_bucket(*args, cv.stream, cb, tie, **flags)
            before = lp_kernels.LAUNCHES["lp_rate_compressed"]
            out = lp_kernels.rate_compressed_bucket(*to(args, cuda), dcv.stream, dcb,
                                                    tie.to(cuda), **flags)
            torch.cuda.synchronize()
            assert lp_kernels.LAUNCHES["lp_rate_compressed"] == before + 1
            assert_equal(ref, out, f"{name} {inst} {flags} w={cb.w}")


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [True, False], ids=["radix", "bitwise"])
@pytest.mark.parametrize("scalar_cap", [True, False], ids=["cluster", "refine"])
def test_commit_kernel_matches_plain(cuda, radix, scalar_cap):
    gen = torch.Generator().manual_seed(3)
    n = 20000
    L = n if scalar_cap else 6
    labels = (torch.arange(n, dtype=torch.int32) if scalar_cap
              else torch.randint(0, L, (n,), generator=gen, dtype=torch.int32))
    node_w = torch.randint(1, 4, (n,), generator=gen, dtype=torch.int32)
    lw = torch.zeros(L, dtype=torch.int32).index_add_(0, labels, node_w)
    target = torch.randint(0, min(L, 300), (n,), generator=gen, dtype=torch.int32)
    tconn = torch.randint(0, 20, (n,), generator=gen, dtype=torch.int32)
    own = torch.randint(0, 20, (n,), generator=gen, dtype=torch.int32)
    maxw = (torch.tensor(9, dtype=torch.int32) if scalar_cap
            else torch.full((L,), int(lw.max()) + 40, dtype=torch.int32))
    prio = torch.randint(0, (1 << 30) - 1, (n,), generator=gen, dtype=torch.int32)
    coin = torch.rand(n, generator=gen) < 0.5
    act = torch.rand(n, generator=gen) < 0.8
    color = torch.rand(n, generator=gen) < 0.7
    for active in (None, color):
        args = (lp.LPState(labels, lw, None), target, tconn, own, node_w, maxw)
        opts = dict(active_prob=0.8, allow_tie_moves=True, radix=radix)
        ref = lp_kernels.commit_moves(*args, L, prio, coin, act, active=active, **opts)
        out = lp_kernels.commit_moves(
            *to(args, cuda), L, prio.to(cuda), coin.to(cuda), act.to(cuda),
            active=None if active is None else active.to(cuda), **opts,
        )
        torch.cuda.synchronize()
        assert_equal(ref, out, f"radix={radix} scalar_cap={scalar_cap}")
        assert int(out.num_moved) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_round_and_balancer_on_card_match_cpu(cuda, name):
    """A whole LP round and a balancer round: the kernels on the card equal
    the plain versions on the CPU with the same draws."""
    g = make_graph(name)
    pv, bv = g.padded(), g.bucketed()
    dg = g.to(cuda)
    dpv, dbv = dg.padded(), dg.bucketed()
    gen = torch.Generator().manual_seed(4)
    labels = torch.cat([torch.arange(pv.n, dtype=torch.int32),
                        torch.full((pv.n_pad - pv.n,), pv.anchor, dtype=torch.int32)])
    draws = lp.draw_lp_round(gen, bv, pv.n_pad, active_prob=0.5)
    cap = torch.tensor(12, dtype=torch.int32)
    ref = lp.lp_round_bucketed(lp.init_state(labels, pv.node_w, pv.n_pad), draws, bv,
                               pv.node_w, cap, num_labels=pv.n_pad, active_prob=0.5)
    out = lp.lp_round_bucketed(lp.init_state(labels.to(cuda), dpv.node_w, pv.n_pad),
                               to(draws, cuda), dbv, dpv.node_w, cap.to(cuda),
                               num_labels=pv.n_pad, active_prob=0.5)
    assert_equal(ref, out, "LP round")

    k = 4
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.where(torch.rand(pv.n, generator=gen) < 0.55, 0,
                               torch.randint(1, k, (pv.n,), generator=gen, dtype=torch.int32))
    max_bw = torch.full((k,), int(g.total_node_weight / k * 1.03) + 1, dtype=torch.int32)
    bdraws = balancer.draw_balance_round(gen, bv, pv.n_pad)
    ref = balancer._balance_round(part, bdraws, bv, pv.node_w, max_bw, k=k)
    out = balancer._balance_round(part.to(cuda), to(bdraws, cuda), dbv, dpv.node_w,
                                  max_bw.to(cuda), k=k)
    assert_equal(ref, out, "balancer round")


@pytest.mark.cuda
def test_partition_on_card_launches_both_kernels(cuda):
    g = generators.rmat_graph(12, 8, seed=1)
    lp_kernels.reset_launches()
    solver = kp.KaMinPar("default")  # the default device is cuda:0
    solver.set_graph(g)
    part = solver.compute_partition(8)
    assert solver.device == torch.device("cuda", 0)
    assert solver.last_partition.is_feasible()
    assert part.shape == (g.n,) and set(np.unique(part)) == set(range(8))
    assert lp_kernels.LAUNCHES["lp_rate"] > 0 and lp_kernels.LAUNCHES["lp_commit"] > 0


@pytest.mark.cuda
def test_terapart_on_card_runs_off_the_stream(cuda):
    """The terapart path on the card: the decode-fused kernel runs, and the
    partition equals the one of device_decode="off"."""
    g = generators.rmat_graph(12, 8, seed=1)
    parts = {}
    for mode in ("off", "finest"):
        lp_kernels.reset_launches()
        solver = kp.KaMinPar("terapart")
        solver.ctx.compression.device_decode = mode
        solver.set_graph(g)
        parts[mode] = solver.compute_partition(8)
        assert solver.last_partition.is_feasible()
        assert (lp_kernels.LAUNCHES["lp_rate_compressed"] > 0) == (mode == "finest")
    assert np.array_equal(parts["off"], parts["finest"])


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_card(cuda):
    g = make_graph("grid")
    pv, bv = g.padded(), g.bucketed()
    b = to(bv.buckets[0], cuda)
    labels = torch.zeros(pv.n_pad, dtype=torch.int32, device=cuda)
    lw = torch.zeros(pv.n_pad, dtype=torch.int32, device=cuda)
    tie = torch.zeros(tuple(b.cols.shape), dtype=torch.int32, device=cuda)
    maxw = torch.tensor(3, dtype=torch.int32, device=cuda)
    flags = dict(external_only=False, respect_caps=True)
    with pytest.raises(TypeError):
        lp_kernels.rate_bucket(labels.long(), pv.node_w.to(cuda), lw, maxw, b, tie, **flags)
    with pytest.raises(ValueError):
        lp_kernels.rate_bucket(labels, pv.node_w.to(cuda), lw, maxw, b, tie.t(), **flags)
    with pytest.raises(ValueError):
        lp_kernels.rate_bucket(labels, pv.node_w, lw, maxw, b, tie, **flags)  # mixed devices
