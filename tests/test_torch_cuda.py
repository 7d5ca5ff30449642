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
from kaminpar_tpu_torch.graph.bucketed import Bucket
from kaminpar_tpu_torch.graph.device_compressed import (CompressedBucket, CompressedStream,
                                                        DeviceCompressedView)
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
    """A tensor, or a NamedTuple of tensors, on ``dev`` (other fields as
    they are)."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if not isinstance(x, tuple):
        return x
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
        for b, real in zip(bv.buckets, bv.real_rows):
            tie = torch.randint(0, I32MAX, tuple(b.cols.shape), generator=gen,
                                dtype=torch.int32)
            args = (labels, pv.node_w, lw, maxw)
            ref = lp_kernels.rate_bucket(*args, b, tie, real_rows=real, **flags)
            out = lp_kernels.rate_bucket(*to(args, cuda), to(b, cuda), tie.to(cuda),
                                         real_rows=real, **flags)
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


# -- the rating body's edges on synthetic buckets ----------------------------

WIDTHS = [8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096]
# (labels of a row's neighbours, L, weights, ties, label weights).  Every
# row also gets labels at L - 1; L = 2^27 + 1 has 28 label bits, so rows of
# w = 32 and 64 need 64-bit sort keys on the warp path (28 + 5 > 32), w =
# 16 sits at the 32-bit limit, and wider rows sort 28 bits on the block
# path.
EDGE_CASES = {
    "equal": ("equal", 2**6, "unit", "random", "random"),
    "distinct": ("distinct", 2**20, "small", "random", "random"),
    "two": ("two", 2**6, "unit", "dup", "random"),
    "lightest-equal-weights": ("near-top", 2**23, "unit", "dup", "equal"),
    "wrap": ("near-top", 2**20, "wrap", "random", "random"),
    "wrap-distinct": ("distinct", 2**23, "wrap", "dup", "random"),
    "wide-keys": ("near-top", 2**27 + 1, "small", "dup", "random"),
}
# (external_only, respect_caps, tie_break, scalar cap)
EDGE_FLAGS = [
    (False, True, "uniform", True),
    (False, True, "lightest", False),
    (False, False, "uniform", False),
    (True, True, "uniform", False),
    (False, False, "lightest", True),
]


def synthetic_rows(w, case, seed):
    """One (R, w) bucket's rows in both layouts.  Every slot of a real row
    is its own neighbour node (so its label is chosen freely); row 0 is
    full, row 1 has degree 0, the others a random degree; the last quarter
    of the rows are pad rows (node = anchor).  Returns (labels, node_w,
    lw, dense Bucket, real_rows, CompressedStream, CompressedBucket, tie,
    L)."""
    label_mode, L, weight_mode, tie_mode, lw_mode = EDGE_CASES[case]
    rng = np.random.default_rng(seed)
    R = 64 if w <= 256 else 16
    real = R - R // 4
    n_pad = R * w + R + 1
    anchor = n_pad - 1
    owners = np.arange(R * w, R * w + R)
    labels = rng.integers(0, L, n_pad)
    deg = rng.integers(0, w + 1, R)
    deg[0], deg[1], deg[real:] = w, 0, 0
    cols = np.empty((R, w), dtype=np.int64)
    wgts = np.zeros((R, w), dtype=np.int64)
    for r in range(R):
        d = int(deg[r])
        cols[r] = owners[r] if r < real else anchor
        cols[r, :d] = r * w + rng.permutation(w)[:d]
        if weight_mode == "unit":
            wgts[r, :d] = 1
        elif weight_mode == "small":
            wgts[r, :d] = rng.integers(0, 4, d)
        else:  # run sums and the row prefix wrap int32
            wgts[r, :d] = rng.integers(2**29, 2**30, d)
        slots = r * w + np.arange(w)
        own = labels[owners[r]]
        if label_mode == "equal":
            labels[slots] = L - 1
        elif label_mode == "two":
            labels[slots] = np.where(rng.random(w) < 0.5, own, L - 1)
        elif label_mode == "distinct":
            labels[slots] = (rng.choice(L - 1, w, replace=False) if L - 1 >= w
                             else rng.integers(0, L - 1, w))
            labels[slots[0]] = L - 1
        else:  # near-top: many runs just below L, own label among them
            labels[slots] = np.where(rng.random(w) < 0.2, own, L - 1 - rng.integers(0, 8, w))
    node_w = rng.integers(1, 4, n_pad)
    lw = np.full(L, 5, dtype=np.int32) if lw_mode == "equal" else rng.integers(
        0, 40, L, dtype=np.int32)
    tie = rng.integers(0, 3 if tie_mode == "dup" else I32MAX, (R, w))
    nodes = np.where(np.arange(R) < real, owners, anchor)

    # The compressed layout: each row's gaps (the first from the node id),
    # zig-zag, packed at the row's width from a word boundary.
    words, wstart, width, estart, edge_w = [], [], [], [], []
    for r in range(R):
        d = int(deg[r])
        gaps = np.diff(np.concatenate([[nodes[r]], cols[r, :d]]))
        z = [int((g << 1) ^ (g >> 63)) for g in gaps]
        wd = max([1] + [x.bit_length() for x in z])
        acc = 0
        for j, x in enumerate(z):
            acc |= x << (j * wd)
        wstart.append(len(words))
        width.append(wd)
        estart.append(len(edge_w))
        words += [(acc >> (32 * i)) & 0xFFFFFFFF for i in range(-(-d * wd // 32))]
        edge_w += list(wgts[r, :d])
    words = np.array(words + [0, 0], dtype=np.uint32).view(np.int32)
    i32 = torch.int32

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=i32)

    stream = CompressedStream(t(words), t(edge_w + [0]))
    cb = CompressedBucket(t(nodes), t(wstart), t(width), t(deg), t(estart), w)
    return (t(labels), t(node_w), t(lw), Bucket(t(nodes), t(cols), t(wgts)), real, stream,
            cb, t(tie), L)


def edge_cap(L, scalar, seed):
    if scalar:
        return torch.tensor(30, dtype=torch.int32)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(20, 60, L, dtype=np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGE_CASES))
@pytest.mark.parametrize("w", WIDTHS)
def test_rate_kernels_edge_cases_match_plain(cuda, w, case):
    """Both rating kernels against their plain versions on synthetic
    buckets of every width: label patterns, duplicated ties, equal label
    weights under `lightest`, labels at L - 1 on both sides of the sort
    key's 32-bit limit, pad rows, degree-0 rows and weights whose sums wrap
    int32."""
    labels, node_w, lw, b, real, stream, cb, tie, L = synthetic_rows(w, case, w + 7)
    found = False
    for i, (ext, caps, tie_break, scalar) in enumerate(EDGE_FLAGS):
        maxw = edge_cap(L, scalar, i)
        flags = dict(external_only=ext, respect_caps=caps, tie_break=tie_break)
        args = (labels, node_w, lw, maxw)
        ref = lp_kernels.rate_bucket(*args, b, tie, real_rows=real, **flags)
        assert_equal(ref, lp_kernels.rate_compressed_bucket(*args, stream, cb, tie, **flags),
                     f"plain versions differ: {case} w={w} {flags}")
        dargs = to(args, cuda)
        out = lp_kernels.rate_bucket(*dargs, to(b, cuda), tie.to(cuda), real_rows=real,
                                     **flags)
        outc = lp_kernels.rate_compressed_bucket(*dargs, to(stream, cuda), to(cb, cuda),
                                                 tie.to(cuda), **flags)
        torch.cuda.synchronize()
        assert_equal(ref, out, f"kernel #1 {case} w={w} {flags}")
        assert_equal(ref, outc, f"kernel #2 {case} w={w} {flags}")
        found = found or bool(ref[3].any())
    assert found, "no row found a move"


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
    flags = dict(real_rows=bv.real_rows[0], external_only=False, respect_caps=True)
    with pytest.raises(TypeError):
        lp_kernels.rate_bucket(labels.long(), pv.node_w.to(cuda), lw, maxw, b, tie, **flags)
    with pytest.raises(ValueError):
        lp_kernels.rate_bucket(labels, pv.node_w.to(cuda), lw, maxw, b, tie.t(), **flags)
    with pytest.raises(ValueError):
        lp_kernels.rate_bucket(labels, pv.node_w, lw, maxw, b, tie, **flags)  # mixed devices
