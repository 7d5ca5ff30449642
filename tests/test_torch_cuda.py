"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports neither jax nor the JAX package, so
it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

All values are integers, so every comparison is exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kaminpar_tpu_torch as kp
from kaminpar_tpu_torch import io as kio
from kaminpar_tpu_torch.graph import generators
from kaminpar_tpu_torch.graph.compressed import compress
from kaminpar_tpu_torch.graph.csr import from_edge_list
from kaminpar_tpu_torch.graph.bucketed import Bucket
from kaminpar_tpu_torch.graph.device_compressed import (CompressedBucket, CompressedStream,
                                                        DeviceCompressedView)
from kaminpar_tpu_torch.io import native
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
    # Half the priorities from 32 values: ties within a target, which the
    # kernel must admit or refuse together.
    tied = torch.rand(n, generator=gen) < 0.5
    prio = torch.where(tied, torch.randint(0, 32, (n,), generator=gen, dtype=torch.int32) << 25,
                       prio)
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


# -- commit kernel #3: edge cases and regimes --------------------------------
# The cases are numpy-built so that tests/test_torch_lp_kernels.py holds the
# same ones against its oracle and the Pallas commit body.

COMMIT_CASES = ("ties", "zero-weight", "negative-slack", "exact-slack", "hub",
                "uncontested", "heavy")
# Clustering exercises every mask (tie coins, the active subset, a colour
# class); refinement has the refinement context's flags (active_prob 1.0,
# no tie moves).
COMMIT_FLAGS = {"cluster": dict(active_prob=0.8, allow_tie_moves=True, has_active=True),
                "refine": dict(active_prob=1.0, allow_tie_moves=False, has_active=False)}


def commit_movers(c):
    """Mover mask and desired labels of a commit case, as the function
    defines them."""
    f = c["flags"]
    better = c["tconn"] > c["own"]
    if f["allow_tie_moves"]:
        better |= (c["tconn"] == c["own"]) & c["coin"]
    desired = np.where(better, c["target"], c["labels"])
    moved = desired != c["labels"]
    if f["has_active"]:
        moved &= c["color"]
    if f["active_prob"] < 1.0:
        moved &= c["act"]
    return moved, desired


def demand_at(c, moved, desired):
    """Per mover (int64): D_t(p_i), the weight of the movers with its
    target and a priority <= its own."""
    idx = np.flatnonzero(moved)
    key = desired[idx].astype(np.int64) << 31 | c["prio"][idx].astype(np.int64)
    order = np.argsort(key, kind="stable")
    ks, ws = key[order], c["node_w"][idx][order].astype(np.int64)
    cs = np.cumsum(ws)
    tgt = ks >> 31
    first = np.searchsorted(tgt, tgt, side="left")
    before = np.where(first > 0, cs[first - 1], 0)
    last = np.searchsorted(ks, ks, side="right") - 1
    d = np.empty(idx.size, dtype=np.int64)
    d[order] = cs[last] - before
    return idx, d


def commit_case(case, inst, n=1024):
    """numpy inputs of one commit: the clustering instantiation (labels =
    node ids, L = n, a scalar cap) or the refinement one (16 blocks, L = 64,
    a cap table), with contested and uncontested targets; ``case`` bends
    them to one edge of the auction."""
    rng = np.random.default_rng(17 + 2 * COMMIT_CASES.index(case) + (inst == "refine"))
    k = 16
    if inst == "cluster":
        L, labels, hi = n, np.arange(n, dtype=np.int32), 40
    else:
        L, labels, hi = 64, rng.integers(0, k, n).astype(np.int32), k
    node_w = rng.integers(1, 4, n).astype(np.int64)
    if case == "zero-weight":
        node_w[rng.random(n) < 0.3] = 0
    if case == "heavy":  # total weight just under 2^31
        node_w = rng.integers(1 << 20, 1 << 21, n).astype(np.int64)
        node_w = node_w * (2**31 - 1 - n) // int(node_w.sum())
    target = rng.integers(0, hi, n).astype(np.int32)
    if case == "hub":
        target[:] = 3
    prio = rng.integers(0, (1 << 30) - 1, n).astype(np.int32)
    if case == "ties":
        prio = (rng.integers(0, 6, n) << 27).astype(np.int32)
    c = dict(labels=labels, node_w=node_w.astype(np.int32), target=target,
             tconn=rng.integers(0, 20, n).astype(np.int32),
             own=rng.integers(0, 20, n).astype(np.int32), prio=prio,
             coin=rng.random(n) < 0.5, act=rng.random(n) < 0.8, color=rng.random(n) < 0.7,
             L=L, flags=COMMIT_FLAGS[inst])
    lw = np.bincount(labels, weights=node_w, minlength=L).astype(np.int64)
    moved, desired = commit_movers(c)
    dem = np.bincount(desired[moved], weights=node_w[moved], minlength=L).astype(np.int64)
    idx, d = demand_at(c, moved, desired)
    # D_t at the median priority of each target's movers: a cap there
    # leaves the target exactly full at one mover.
    mid = np.zeros(L, dtype=np.int64)
    for t in np.unique(desired[idx]):
        dt = np.sort(d[desired[idx] == t])
        mid[t] = dt[len(dt) // 2]
    if inst == "cluster":
        cap = int(np.median((lw + dem)[:hi]))
        if case == "negative-slack":
            cap = 2  # labels of weight 3 have slack -1, of weight 2 slack 0
        elif case == "hub":
            cap = int(lw[3] + dem[3] // 2)
        elif case == "uncontested":
            cap = 1 << 30
        elif case == "exact-slack":  # label weights need not be the sums
            even = np.arange(L) % 2 == 0
            lw = np.where(dem > 0, cap - np.where(even, dem, mid), lw)
        maxw = np.asarray(cap, dtype=np.int32)
    else:
        half = np.where(np.arange(L) % 2 == 0, lw + dem // 2, lw + dem + 1)
        maxw = np.where(np.arange(L) < k, half, 0)
        if case == "negative-slack":
            maxw[:8] = lw[:8] - 1 - np.arange(8)
        elif case == "hub":
            maxw[3] = lw[3] + dem[3] // 2
        elif case == "uncontested":
            maxw[:k] = lw[:k] + dem[:k] + 10**6
        elif case == "exact-slack":
            maxw[:k] = lw[:k] + np.where(np.arange(k) % 2 == 0, dem[:k], mid[:k])
        maxw = maxw.astype(np.int32)
    c.update(lw=lw.astype(np.int32), maxw=maxw)
    return c


def commit_call(c, dev):
    """(args, kwargs) of ``lp_kernels.commit_moves`` for a case on ``dev``."""
    def T(x):
        return torch.from_numpy(np.array(x)).to(dev)  # a 0-d cap stays 0-d

    f = c["flags"]
    args = (lp.LPState(T(c["labels"]), T(c["lw"]), None), T(c["target"]), T(c["tconn"]),
            T(c["own"]), T(c["node_w"]), T(c["maxw"]), c["L"], T(c["prio"]), T(c["coin"]),
            T(c["act"]))
    kwargs = dict(active_prob=f["active_prob"], allow_tie_moves=f["allow_tie_moves"],
                  active=T(c["color"]) if f["has_active"] else None)
    return args, kwargs


def check_commit_kernel(args, kwargs, dev, what):
    """Both plain auctions on the CPU agree; the kernel equals them on
    ``dev``, twice (the mover list's order differs from run to run)."""
    refs = [lp_kernels.commit_moves(*args, **kwargs, radix=r) for r in (True, False)]
    assert_equal(refs[0], refs[1], f"{what}: the plain auctions differ")
    dargs, dkw = to(args, dev), {k: to(v, dev) for k, v in kwargs.items()}
    outs = [lp_kernels.commit_moves(*dargs, **dkw) for _ in range(2)]
    torch.cuda.synchronize()
    assert_equal(refs[0], outs[0], f"{what}: kernel != plain")
    assert_equal(outs[0], outs[1], f"{what}: two kernel runs differ")
    return refs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("inst", ["cluster", "refine"])
@pytest.mark.parametrize("case", COMMIT_CASES)
def test_commit_kernel_edge_cases_match_plain(cuda, case, inst):
    args, kwargs = commit_call(commit_case(case, inst), "cpu")
    check_commit_kernel(args, kwargs, cuda, f"{case} {inst}")


def commit_regime(regime):
    """(args, kwargs) of a commit in one of the kernel's regimes, on the CPU."""
    gen = torch.Generator().manual_seed(23)
    i32 = torch.int32

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=gen, dtype=i32)

    n = {"L2": 50_000, "L64": 200_000, "hub": 400_000, "n0": 0, "no-movers": 30_000}[regime]
    if regime in ("hub", "no-movers"):
        L, labels = n, torch.arange(n, dtype=i32)
    else:
        L = 2 if regime == "L2" else 64
        labels = randint(0, 2 if regime == "L2" else 16, n)
    node_w = randint(1, 3, n)
    lw = torch.zeros(L, dtype=i32).index_add_(0, labels, node_w)
    prio = randint(0, (1 << 30) - 1, n)
    prio = torch.where(torch.rand(n, generator=gen) < 0.3, randint(0, 64, n) << 24, prio)
    tconn, own = randint(1, 20, n), torch.zeros(n, dtype=i32)
    if regime == "L2":
        target = 1 - labels
        maxw = lw + torch.tensor([n // 8, 3 * n], dtype=i32)  # block 0 contested
    elif regime in ("L64", "n0"):
        target = randint(0, 16, n)
        maxw = torch.zeros(L, dtype=i32)
        maxw[:16] = lw[:16] + n // 64 * (torch.arange(16, dtype=i32) % 4)
    elif regime == "hub":
        # 30% of the nodes move to random labels (few contested); 50 labels
        # take 33-64 movers each (a warp's two items a lane), 20 labels
        # 1,000 each (the block path) and one hub 150,000.
        target = torch.where(torch.rand(n, generator=gen) < 0.3, randint(0, n, n),
                             labels)
        perm = torch.randperm(n, generator=gen)
        target[perm[:150_000]] = 7
        at = 150_000
        for j in range(70):
            size = 1000 if j < 20 else 33 + (7 * j) % 32
            target[perm[at:at + size]] = 1000 + 3 * j
            at += size
        maxw = torch.tensor(6, dtype=i32)
        lw[7] = 0  # label weights need not be the sums
    else:  # no movers: every rating at most the own connection
        target, tconn = randint(0, n, n), torch.zeros(n, dtype=i32)
        maxw = torch.tensor(4, dtype=i32)
    args = (lp.LPState(labels, lw, None), target, tconn, own, node_w, maxw, L, prio)
    return args, {}


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["L2", "L64", "hub", "n0", "no-movers"])
def test_commit_kernel_regimes_match_plain(cuda, regime):
    """L = 2; L = 64 with 16 live blocks; L = n with a scalar cap, few
    contested labels, 20 labels of 100-2000 movers and a hub of 150,000;
    n = 0; no movers."""
    args, kwargs = commit_regime(regime)
    ref = check_commit_kernel(args, kwargs, cuda, regime)
    moved = int(ref.num_moved)
    assert moved == 0 if regime in ("n0", "no-movers") else moved > 0


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
@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_underload_and_grouped_balance_rounds_on_card_match_cpu(cuda, name):
    """An underload round and a group-restricted overload round on the
    group-masked graph: the kernels on the card equal the plain versions
    on the CPU with the same draws."""
    g = make_graph(name)
    pv = g.padded()
    gen = torch.Generator().manual_seed(6)
    k = 8
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.where(torch.rand(pv.n, generator=gen) < 0.4, 0,
                               torch.randint(1, k - 1, (pv.n,), generator=gen,
                                             dtype=torch.int32))
    W = g.total_node_weight
    max_bw = torch.full((k,), int(W / k * 1.03) + 1, dtype=torch.int32)
    min_bw = torch.full((k,), int(W / k * 0.97), dtype=torch.int32)
    bv = g.bucketed()
    dg = g.to(cuda)
    draws = balancer.draw_balance_round(gen, bv, pv.n_pad)
    ref = balancer._underload_round(part, draws, bv, pv.node_w, max_bw, min_bw, k=k)
    out = balancer._underload_round(part.to(cuda), to(draws, cuda), dg.bucketed(),
                                    dg.padded().node_w, max_bw.to(cuda), min_bw.to(cuda),
                                    k=k)
    assert_equal(ref, out, "underload round")
    assert int(ref[1][0]) > 0

    group_of = torch.arange(k, dtype=torch.int32) // 2
    comm = group_of[part[: pv.n].long()]
    mg, dmg = g.community_masked(comm), dg.community_masked(comm.to(cuda))
    mbv = mg.bucketed()
    draws = balancer.draw_balance_round(gen, mbv, pv.n_pad)
    ref = balancer._balance_round(part, draws, mbv, pv.node_w, max_bw, k=k,
                                  group_of=group_of)
    out = balancer._balance_round(part.to(cuda), to(draws, cuda), dmg.bucketed(),
                                  dmg.padded().node_w, max_bw.to(cuda), k=k,
                                  group_of=group_of.to(cuda))
    assert_equal(ref, out, "grouped balance round")
    assert int(ref[1][0]) > 0


@pytest.mark.cuda
def test_pooled_extension_on_card_equals_serial(cuda, monkeypatch):
    """largek on the card with device extension and the extension jobs on
    8 worker threads and on one: the same partition, both kernels run."""
    from kaminpar_tpu_torch.utils import platform

    g = generators.rmat_graph(12, 8, seed=1)
    parts = []
    for workers in (8, 1):
        monkeypatch.setattr(platform, "extension_workers",
                            lambda jobs, device, w=workers: min(max(jobs, 1), w))
        lp_kernels.reset_launches()
        solver = kp.KaMinPar("largek")
        solver.ctx.initial_partitioning.device_extension_n = 1024
        solver.set_graph(g)
        parts.append(solver.compute_partition(64))
        assert solver.last_partition.is_feasible()
        assert solver.last_partitioner.extension_jobs["device"] > 0
        assert lp_kernels.LAUNCHES["lp_rate"] > 0 and lp_kernels.LAUNCHES["lp_commit"] > 0
    assert np.array_equal(parts[0], parts[1])


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


def pool_case(name):
    """A host CSR graph and loose bisection budgets for the pool tests."""
    from kaminpar_tpu_torch.partitioning.kway import graph_to_host

    g = {"rmat": lambda: generators.rmat_graph(10, 8, seed=1),
         "grid": lambda: generators.grid2d_graph(24, 24),
         "star": lambda: generators.star_graph(200)}[name]()
    host = graph_to_host(g)
    W = host.total_node_weight
    return host, np.array([int(0.52 * W), int(0.52 * W)], dtype=np.int64)


def recorded_draws(host, ipc, final_k, seed):
    """Every draw of one pool call, from a seeded generator on the CPU."""
    from kaminpar_tpu_torch.graph.csr import from_numpy_csr
    from kaminpar_tpu_torch.ops import bipartition as bip

    methods, _ = bip.method_lane_counts(ipc, final_k)
    n_pad = from_numpy_csr(host.row_ptr, host.col_idx).padded().n_pad
    rec = bip.RecordedPoolDraws(bip.GeneratorPoolDraws(seed, methods, n_pad, "cpu"), methods,
                                host.n, bip.grow_trip_count(n_pad),
                                bip.fm_round_count(n_pad, ipc.fm_num_iterations))
    return methods, rec


@pytest.mark.cuda
@pytest.mark.parametrize("final_k", [2, 16])
@pytest.mark.parametrize("name", ["rmat", "grid", "star"])
def test_pool_on_card_matches_cpu_from_recorded_draws(cuda, name, final_k):
    from kaminpar_tpu_torch.context import InitialPartitioningContext
    from kaminpar_tpu_torch.ops import bipartition as bip

    host, mw = pool_case(name)
    ipc = InitialPartitioningContext()
    _, rec = recorded_draws(host, ipc, final_k, seed=3)
    rec_card = rec.to(cuda)
    args = (host.row_ptr, host.col_idx, host.node_w, host.edge_w, mw, 3, ipc, final_k)
    ref = bip.pool_bipartition_device(*args, device="cpu", draws=lambda *a: rec)
    out = bip.pool_bipartition_device(*args, device=cuda, draws=lambda *a: rec_card)
    assert np.array_equal(ref[0], out[0])
    assert ref[1] == out[1]
    assert out[1]["feasible"]


@pytest.mark.cuda
def test_pool_lane_loop_makes_no_host_sync(cuda):
    """The whole lane loop and the selection run with host synchronisation
    made an error; the one readback comes after."""
    from kaminpar_tpu_torch.context import InitialPartitioningContext
    from kaminpar_tpu_torch.graph.csr import from_numpy_csr
    from kaminpar_tpu_torch.ops import bipartition as bip

    host, mw = pool_case("rmat")
    ipc = InitialPartitioningContext()
    methods, rec = recorded_draws(host, ipc, 16, seed=4)
    rec_card = rec.to(cuda)
    pv = from_numpy_csr(host.row_ptr, host.col_idx, host.node_w, host.edge_w,
                        device=cuda).padded()
    g = bip.PoolGraph.from_padded(pv, host.total_node_weight)
    target = bip.grow_target(g.total, int(mw[0]), int(mw[1]))
    draws = bip.GeneratorPoolDraws(9, methods, pv.n_pad, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        packed = [bip._pool_kernel(d, g, host.n, target, int(mw[0]), int(mw[1]),
                                   methods=methods, grow_trips=bip.grow_trip_count(pv.n_pad),
                                   fm_rounds=bip.fm_round_count(pv.n_pad, ipc.fm_num_iterations))
                  for d in (rec_card, draws)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref, _ = bip.pool_bipartition_device(host.row_ptr, host.col_idx, host.node_w, host.edge_w,
                                         mw, 4, ipc, 16, device="cpu", draws=lambda *a: rec)
    assert np.array_equal(packed[0].cpu().numpy()[: host.n], ref)
    assert packed[1].shape == (pv.n_pad + bip.STATS_LEN,)


@pytest.mark.cuda
def test_cuda_graph_with_auto_backend_takes_the_device_pool(cuda):
    from kaminpar_tpu_torch.ops import bipartition as bip

    g = generators.rmat_graph(12, 8, seed=1)
    solver = kp.KaMinPar("default")
    assert solver.ctx.initial_partitioning.ip_backend == "auto"
    solver.set_graph(g)
    bip.reset_pool_stats()
    solver.compute_partition(8)
    snap = bip.pool_stats_snapshot()
    assert snap["calls"] > 0 and snap["host_bisections"] == 0
    assert snap["chunked_calls"] == 0
    assert solver.last_partition.is_feasible()
    assert solver.last_partitioner.extension_jobs["bisections"] > 0
    with pytest.raises(ValueError):
        solver.ctx.initial_partitioning.ip_backend = "host"
        solver.compute_partition(8)


@pytest.mark.cuda
def test_pool_on_card_method_by_method_equals_whole_pool(cuda, monkeypatch):
    """The card's memory budget is positive, and a pool run method by method
    (what a pool too large for half the card's free memory does) gives the
    whole pool's result and is counted."""
    from kaminpar_tpu_torch.context import InitialPartitioningContext
    from kaminpar_tpu_torch.ops import bipartition as bip

    host, mw = pool_case("rmat")
    ipc = InitialPartitioningContext()
    assert bip.edge_temp_budget(cuda) > 0
    args = (host.row_ptr, host.col_idx, host.node_w, host.edge_w, mw, 5, ipc, 16)
    bip.reset_pool_stats()
    whole = bip.pool_bipartition_device(*args, device=cuda)
    assert bip.pool_stats_snapshot()["chunked_calls"] == 0
    monkeypatch.setattr(bip, "edge_temp_budget", lambda device: 0)
    split = bip.pool_bipartition_device(*args, device=cuda)
    assert bip.pool_stats_snapshot()["chunked_calls"] == 1
    assert np.array_equal(whole[0], split[0]) and whole[1] == split[1]


@pytest.mark.cuda
def test_rmat_graph_built_on_the_card_equals_the_host_build(cuda):
    host = generators.rmat_graph(14, 16, seed=1)
    built = generators.rmat_graph(14, 16, seed=1, device=cuda)
    assert built.device == torch.device("cpu")
    for name in ("row_ptr", "col_idx", "node_w", "edge_w", "edge_u"):
        assert torch.equal(getattr(host, name), getattr(built, name)), name



# -- the quality refiners: JET, the colouring, colored LP and FM -----------


def random_blocks(pv, k, gen):
    part = torch.zeros(pv.n_pad, dtype=torch.int32)
    part[: pv.n] = torch.randint(0, k, (pv.n,), generator=gen, dtype=torch.int32)
    return part


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "hub"])
def test_jet_round_coloring_and_clp_on_card_match_cpu(cuda, name):
    """One JET move round (kernel #1 in its find mode), one colouring and
    one colored LP iteration (kernel #3 with colour-class masks) on the
    card equal the plain versions on the CPU with the same draws."""
    from kaminpar_tpu_torch.ops import bucketed_gains, coloring
    from kaminpar_tpu_torch.refinement import jet

    g = make_graph(name)
    pv, bv = g.padded(), g.bucketed()
    dg = g.to(cuda)
    dpv, dbv = dg.padded(), dg.bucketed()
    gen = torch.Generator().manual_seed(8)
    k = 8
    labels = random_blocks(pv, k, gen)
    locked = torch.zeros(pv.n_pad, dtype=torch.bool)
    locked[: pv.n] = torch.rand(pv.n, generator=gen) < 0.2
    max_bw = torch.full((k,), int(g.total_node_weight / k * 1.03) + 1, dtype=torch.int32)
    ties = bucketed_gains.draw_ties(gen, bv)
    lp_kernels.reset_launches()
    ref = jet._jet_move_round(labels, locked, ties, bv, pv.node_w, max_bw, 0.75, k=k)
    out = jet._jet_move_round(labels.to(cuda), locked.to(cuda), to(ties, cuda), dbv,
                              dpv.node_w, max_bw.to(cuda), 0.75, k=k)
    assert_equal(ref, out, "JET move round")
    assert int(ref[1].sum()) > 0
    assert lp_kernels.RATE_MODES["lp_rate:" + lp_kernels.rate_mode(True, False)] == len(bv.buckets)

    prios = [torch.randint(0, I32MAX, (pv.n_pad,), generator=gen, dtype=torch.int32)
             for _ in range(64)]
    mask = torch.arange(pv.n_pad) < pv.n
    colors, rounds = coloring.color_graph(lambda i: prios[i], pv.edge_u, pv.col_idx, mask,
                                          n=pv.n_pad)
    dcolors, drounds = coloring.color_graph(lambda i: prios[i].to(cuda), dpv.edge_u,
                                            dpv.col_idx, mask.to(cuda), n=pv.n_pad)
    assert torch.equal(colors, dcolors.cpu()) and rounds == drounds, "colouring"
    assert bool((colors >= 0).all())
    u, v = g.edge_u.long(), g.col_idx.long()
    assert not bool(((colors[u] == colors[v]) & (u != v)).any())

    nc = int(coloring.num_colors_device(colors, mask))
    L = lp.num_labels_bucket(k)
    caps = torch.zeros(L, dtype=torch.int32)
    caps[:k] = int(g.total_node_weight / k * 1.05) + 1
    rounds = [lp.draw_lp_round(gen, bv, pv.n_pad, allow_tie_moves=True) for _ in range(nc)]
    lp_kernels.reset_launches()
    ref = lp.clp_iterate_colors(lp.init_state(labels, pv.node_w, L), lambda c: rounds[c],
                                bv, pv.node_w, caps, colors, nc, num_labels=L)
    out = lp.clp_iterate_colors(lp.init_state(labels.to(cuda), dpv.node_w, L),
                                lambda c: to(rounds[c], cuda), dbv, dpv.node_w,
                                caps.to(cuda), dcolors, nc, num_labels=L)
    assert_equal(ref, out, "CLP iteration")
    assert int(ref.num_moved) > 0 and lp_kernels.LAUNCHES["lp_commit"] == nc


@pytest.mark.cuda
def test_fm_refiner_on_card_equals_cpu(cuda, monkeypatch):
    """FM is a host pass: on a CUDA partitioned graph it reads the graph
    off the card and gives the CPU graph's partition, back on the card."""
    from kaminpar_tpu_torch.context import FMContext
    from kaminpar_tpu_torch.graph.partitioned import PartitionedGraph
    from kaminpar_tpu_torch.refinement import fm_refiner
    from kaminpar_tpu_torch.utils import RandomState

    g = generators.grid2d_graph(40, 40)
    k = 4
    gen = torch.Generator().manual_seed(3)
    part = (torch.arange(g.n) * k // g.n).to(torch.int32)
    flip = torch.rand(g.n, generator=gen) < 0.05
    part[flip] = torch.randint(0, k, (int(flip.sum()),), generator=gen, dtype=torch.int32)
    max_bw = np.full(k, int(g.n / k * 1.05) + 1)
    max_bw = np.maximum(max_bw, np.bincount(part.numpy(), minlength=k))
    outs = []
    for graph in (g, g.to(cuda)):
        monkeypatch.setattr(RandomState, "numpy_rng", lambda: np.random.default_rng(5))
        outs.append(fm_refiner.FMRefiner(FMContext()).refine(
            PartitionedGraph.create(graph, k, part, max_bw)))
    assert outs[1].partition.device.type == "cuda"
    assert torch.equal(outs[0].partition, outs[1].partition.cpu())
    assert outs[0].edge_cut() < PartitionedGraph.create(g, k, part, max_bw).edge_cut()


@pytest.mark.cuda
@pytest.mark.parametrize("preset", ["jet", "strong"])
def test_quality_presets_on_card(cuda, preset):
    """jet and strong on the card: feasible, JET rounds on every refined
    level, kernel #1 launched in JET's find mode; strong's FM ran."""
    from kaminpar_tpu_torch.refinement import fm_refiner, jet

    g = generators.rmat_graph(12, 8, seed=1)
    lp_kernels.reset_launches()
    jet.reset_jet_stats()
    fm_refiner.reset_fm_stats()
    solver = kp.KaMinPar(preset)
    solver.set_graph(g)
    part = solver.compute_partition(8)
    assert solver.last_partition.is_feasible() and len(np.unique(part)) == 8
    stats = jet.jet_stats_snapshot()
    assert stats["calls"] >= solver.last_partitioner.num_levels + 1
    assert stats["min_rounds"] >= 1
    assert lp_kernels.RATE_MODES["lp_rate:" + lp_kernels.rate_mode(True, False)] > 0
    if preset == "strong":
        assert fm_refiner.fm_stats_snapshot()["passes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rmat", "grid"])
def test_hem_round_on_card_matches_cpu(cuda, name):
    """One HEM round (and a whole HEM clustering) on the card, given the
    same jitter, equals the CPU's."""
    from kaminpar_tpu_torch.coarsening import hem_clusterer as hem
    from kaminpar_tpu_torch.context import LabelPropagationContext

    g = make_graph(name)
    dg = g.to(cuda)
    pv, dpv = g.padded(), dg.padded()
    gen = torch.Generator().manual_seed(8)
    jitters = [hem.draw_hem_jitter(gen, pv) for _ in range(5)]
    match = torch.arange(pv.n_pad, dtype=torch.int32)
    cap = torch.tensor(4, dtype=torch.int32)
    ref = hem._hem_round(match, jitters[0], pv, cap)
    out = hem._hem_round(match.to(cuda), jitters[0].to(cuda), dpv, cap.to(cuda))
    assert torch.equal(ref, out.cpu()) and bool((ref != match).any())
    clusterer = hem.HEMClustering(LabelPropagationContext())
    ref = clusterer.compute_clustering(g, 4, draw=lambda r: jitters[r])
    out = clusterer.compute_clustering(dg, 4, draw=lambda r: jitters[r].to(cuda))
    assert torch.equal(ref, out.cpu())


@pytest.mark.cuda
def test_kway_on_card_bisects_on_the_device_pool(cuda):
    """KaMinPar("kway") on the card: feasible, every block used, both
    kernels launched and every bisection of the initial partition on the
    device pool."""
    from kaminpar_tpu_torch.ops import bipartition

    g = generators.rmat_graph(12, 8, seed=1)
    solver = kp.KaMinPar("kway")
    solver.ctx.coarsening.contraction_limit = 64
    solver.set_graph(g)
    lp_kernels.reset_launches()
    bipartition.reset_pool_stats()
    part = solver.compute_partition(8)
    pool = bipartition.pool_stats_snapshot()
    assert solver.last_partition.is_feasible() and len(np.unique(part)) == 8
    assert solver.last_partitioner.num_levels >= 1
    assert pool["calls"] == 7 and pool["host_bisections"] == 0
    assert lp_kernels.LAUNCHES["lp_rate"] > 0 and lp_kernels.LAUNCHES["lp_commit"] > 0


@pytest.mark.cuda
def test_rb_subgraphs_are_cuda_graphs(cuda):
    """Recursive bisection on the card builds every subgraph on the card,
    and each of its k = 2 pipelines bisects on the device pool."""
    from kaminpar_tpu_torch.context import PartitioningMode
    from kaminpar_tpu_torch.ops import bipartition

    g = generators.rmat_graph(11, 8, seed=1)
    solver = kp.KaMinPar("default")
    solver.ctx.mode = PartitioningMode.RB
    solver.ctx.coarsening.contraction_limit = 64
    solver.set_graph(g)
    bipartition.reset_pool_stats()
    part = solver.compute_partition(8)
    rb = solver.last_partitioner
    pool = bipartition.pool_stats_snapshot()
    assert solver.last_partition.is_feasible() and len(np.unique(part)) == 8
    assert rb.bisections == 7 and set(rb.subgraph_devices) == {"cuda:0"}
    assert sum(rb.subgraph_devices.values()) == 6
    assert pool["calls"] == 7 and pool["host_bisections"] == 0


@pytest.mark.cuda
def test_default_on_card_reads_back_only_through_pull_in_coarsening(cuda):
    """The CPU test of the tripwire (tests/test_torch_telemetry.py) on the
    card, with its synchronizing calls counted: the coarsening's pulls
    equal its contractions, no implicit pull in coarsening, initial
    partitioning and uncoarsening, no card sync outside a pull in
    coarsening and uncoarsening, the armed budgets hold (at most k0 pulls in
    the initial partitioning)."""
    from kaminpar_tpu_torch.utils import sync_stats

    g = generators.rmat_graph(12, 16, seed=2)
    solver = kp.KaMinPar("default")
    solver.ctx.coarsening.contraction_limit = 128
    solver.set_graph(g)
    sync_stats.reset()
    sync_stats.enable_budget_checks(True)
    try:
        with sync_stats.tripwire(), sync_stats.count_device_syncs():
            solver.compute_partition(16)
    finally:
        sync_stats.enable_budget_checks(False)
    snap = sync_stats.snapshot()
    sync_stats.reset()
    scheme = solver.last_partitioner
    assert scheme.num_levels >= 1 and scheme.coarsening_pulls == scheme.contractions
    for phase in ("coarsening", "initial_partitioning", "uncoarsening"):
        assert snap["phases"].get(phase, {"implicit": 0})["implicit"] == 0, snap
    for phase in ("coarsening", "uncoarsening"):
        assert snap["device_syncs"].get(phase, 0) == 0, snap["device_syncs"]
    assert 1 <= scheme.ip_pulls <= max(scheme.coarsest["k0"], 1)
    assert solver.last_partition.is_feasible()


@pytest.mark.cuda
def test_guard_refuses_a_card_sync_outside_pull(cuda):
    from kaminpar_tpu_torch.utils import sync_stats

    x = torch.arange(8, device=cuda)
    with sync_stats.guard():
        assert sync_stats.pull(x).tolist() == list(range(8))
        with pytest.raises(RuntimeError, match="synchronizing"):
            x.cpu()
    assert x.cpu().tolist() == list(range(8))
    with sync_stats.count_device_syncs():
        with sync_stats.scoped("coarsening"):
            x.sum().item()
            sync_stats.pull(x)
    assert sync_stats.device_sync_count("coarsening") == 1
    sync_stats.reset()


@pytest.mark.cuda
def test_c_demo_partitions_on_the_card(cuda, tmp_path):
    """The C library and demo built by the port's Makefile (into
    ``build/capi/``) partition a grid on the card through the embedded
    interpreter."""
    root = Path(__file__).resolve().parent.parent
    build = subprocess.run(["make", "-C", str(root / "kaminpar_tpu_torch" / "capi"), "demo",
                            f"PYTHON={sys.executable}"],
                           capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stdout[-2000:] + build.stderr[-2000:]
    env = dict(os.environ, PYTHONPATH=str(root), KPTPU_PYTHON=sys.executable)
    run = subprocess.run([str(root / "build" / "capi" / "demo")], capture_output=True,
                         text=True, env=env, timeout=600, cwd=tmp_path)
    assert run.returncode == 0, (run.stdout[-1000:], run.stderr[-3000:])
    assert "CAPI_OK cut=" in run.stdout
    cut = int(run.stdout.split("cut=")[1].split()[0])
    assert 40 <= cut <= 120, cut  # a 24x24 grid into quarters: 48 at best


@pytest.mark.cuda
def test_native_parser_equals_numpy_parser_at_scale_16(cuda, tmp_path, monkeypatch):
    """The native METIS parser and the NumPy parser read the same scale-16
    RMAT file, written by the port, into equal arrays."""
    g = generators.rmat_graph(16, 16, seed=1)
    path = str(tmp_path / "g.metis")
    kio.write_graph(g, path)
    by_native = kio.read_metis(path)
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    by_numpy = kio.read_metis(path)
    for name in ("row_ptr", "col_idx", "node_w", "edge_w"):
        assert torch.equal(getattr(by_native, name), getattr(by_numpy, name)), name
        assert torch.equal(getattr(by_native, name), getattr(g, name)), name


# -- checkpoints, the random streams' position and the probes on the card ----


@pytest.mark.cuda
def test_cuda_generator_state_round_trips(cuda):
    """The chain position restores a CUDA Philox generator's draws."""
    from kaminpar_tpu_torch.utils import RandomState

    RandomState.reseed(5)
    gen = RandomState.generator(cuda)
    torch.rand(1000, generator=gen, device=cuda)
    pos = RandomState.chain_position()
    assert [dev for dev, _ in pos["gens"]] == ["cuda:0"]
    first = (torch.randint(0, 1 << 30, (1000,), generator=RandomState.generator(cuda),
                           device=cuda), RandomState.numpy_rng().integers(1 << 30, size=10))
    RandomState.restore(pos)
    again = (torch.randint(0, 1 << 30, (1000,), generator=RandomState.generator(cuda),
                           device=cuda), RandomState.numpy_rng().integers(1 << 30, size=10))
    assert torch.equal(first[0], again[0]) and np.array_equal(first[1], again[1])


def _ckpt_solver(device, directory=None):
    solver = kp.KaMinPar("default", device=device)
    solver.ctx.seed = 7
    solver.ctx.coarsening.contraction_limit = 128
    if directory is not None:
        solver.ctx.resilience.checkpoint_dir = str(directory)
        solver.ctx.resilience.checkpoint_keep_all = True
    solver.set_graph(generators.rmat_graph(12, 16, seed=2))
    return solver


@pytest.mark.cuda
def test_every_boundary_resumes_bit_identical_on_card(cuda, tmp_path):
    """Every level boundary of a card run of rmat_graph(12) resumes to the
    uninterrupted partition bit for bit, the restore with no pull and no
    card sync outside a pull; a card checkpoint is rejected on the CPU."""
    from kaminpar_tpu_torch.resilience import checkpoint
    from kaminpar_tpu_torch.utils import sync_stats

    ref = _ckpt_solver(cuda).compute_partition(16)
    sync_stats.enable_budget_checks(True)
    try:
        armed = _ckpt_solver(cuda, tmp_path).compute_partition(16)
    finally:
        sync_stats.enable_budget_checks(False)
    assert np.array_equal(ref, armed)
    files = sorted(tmp_path.glob("ckpt_deep_b*.npz"))
    stages = {checkpoint.load(str(f)).stage for f in files}
    assert stages == {"coarsening", "uncoarsening"}, files
    for f in files:
        sync_stats.reset()
        sync_stats.enable_budget_checks(True)
        try:
            with sync_stats.count_device_syncs():
                got = _ckpt_solver(cuda).compute_partition(16, resume=str(f))
        finally:
            sync_stats.enable_budget_checks(False)
        snap = sync_stats.snapshot()
        assert np.array_equal(ref, got), f
        assert snap["phases"].get("checkpoint_restore", {"count": 0})["count"] == 0
        assert snap["device_syncs"].get("checkpoint_restore", 0) == 0, snap["device_syncs"]
    with pytest.raises(checkpoint.CheckpointMismatchError, match="device='cuda' vs 'cpu'"):
        _ckpt_solver("cpu").compute_partition(16, resume=str(files[-1]))


@pytest.mark.cuda
def test_probes_add_no_card_sync(cuda):
    """With a trace armed (the quality probes live), the card's partition
    and every phase's pulls and synchronizing calls outside a pull are
    those of the unarmed run."""
    from kaminpar_tpu_torch import telemetry
    from kaminpar_tpu_torch.utils import sync_stats

    def run(armed):
        solver = _ckpt_solver(cuda)
        sync_stats.reset()
        with sync_stats.count_device_syncs():
            if armed:
                with telemetry.run() as rec:
                    part = solver.compute_partition(16)
                assert rec.quality
            else:
                part = solver.compute_partition(16)
        snap = sync_stats.snapshot()
        return part, {ph: row["count"] for ph, row in snap["phases"].items()}, \
            snap["device_syncs"]

    plain = run(False)
    armed = run(True)
    assert np.array_equal(plain[0], armed[0])
    assert plain[1] == armed[1]
    assert plain[2] == armed[2]


@pytest.mark.cuda
def test_injected_fault_on_card_raises_typed_error(cuda):
    """An injected execute fault at the LP dispatch and a readback fault
    stop a card run with ExecuteFault; nothing demotes."""
    from kaminpar_tpu_torch.resilience import breakers, errors, faults

    for plan in ("execute@lp_pallas:execute-fault", "readback@coarsening:execute-fault"):
        faults.reset()
        with faults.injected_faults(plan):
            with pytest.raises(errors.ExecuteFault):
                _ckpt_solver(cuda).compute_partition(16)
    faults.reset()
    assert breakers.global_registry().demotions() == {}


def _lane_graphs():
    return [generators.rmat_graph(11, 8, seed=31), generators.grid2d_graph(40, 40),
            generators.rgg2d_graph(2048, seed=5), make_graph("hub")]


@pytest.mark.cuda
def test_lane_union_round_equals_per_lane_rounds_on_card(cuda):
    """One stacked LP round (kernel #1 over the union buckets, kernel #3
    once, per-label cap tables) and one stacked balancer round equal the
    lanes' own rounds on the same draws, for 4 lanes."""
    from kaminpar_tpu_torch.ops import lanestack as lops

    graphs = [g.to(cuda) for g in _lane_graphs()]
    pvs = [g.padded() for g in graphs]
    bvs = [g.bucketed() for g in graphs]
    union = lops.lane_union(bvs, [pv.n_pad for pv in pvs])
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    caps = [40, 25, 60, 9000]
    draws = [lp.draw_lp_round(gen, bv, pv.n_pad, active_prob=0.5) for bv, pv in zip(bvs, pvs)]
    seq = []
    for pv, bv, d, c in zip(pvs, bvs, draws, caps):
        labels = torch.arange(pv.n_pad, dtype=torch.int32, device=cuda)
        st = lp.lp_round_bucketed(lp.init_state(labels, pv.node_w, pv.n_pad), d, bv, pv.node_w,
                                  torch.full((), c, dtype=torch.int32, device=cuda),
                                  num_labels=pv.n_pad, active_prob=0.5)
        seq.append(st)
    off = union.node_off
    labels = torch.cat([torch.arange(pv.n_pad, dtype=torch.int32, device=cuda) + off[j]
                        for j, pv in enumerate(pvs)])
    node_w = torch.cat([pv.node_w for pv in pvs])
    max_w = torch.cat([torch.full((pv.n_pad,), c, dtype=torch.int32, device=cuda)
                       for pv, c in zip(pvs, caps)])
    lp_kernels.reset_launches()
    st, moved = lops.lane_lp_round(union, lp.init_state(labels, node_w, union.N), draws, node_w,
                                   max_w, num_labels=union.N, active_probs=[0.5] * 4)
    if cuda.type == "cuda":  # (the functions also run on CPU tensors, uncounted)
        assert lp_kernels.LAUNCHES["lp_commit"] == 1
        assert lp_kernels.LAUNCHES["lp_rate"] == len(union.buckets)
    for j, s in enumerate(seq):
        assert torch.equal(st.labels[off[j]:off[j + 1]] - off[j], s.labels)
        assert int(moved[j]) == int(s.num_moved)

    # the balancer round, lanes as groups, one lane frozen
    k = 8
    parts = [torch.randint(0, k, (pv.n,), generator=gen, device=cuda, dtype=torch.int32)
             for pv in pvs]
    bdraws = [balancer.draw_balance_round(gen, bv, pv.n_pad) for bv, pv in zip(bvs, pvs)]
    bcaps = [torch.full((k,), int(pv.node_w.sum()) // k, dtype=torch.int32, device=cuda)
             for pv in pvs]
    blocks = lops.LaneBlocks.build(union, [k] * 4)
    lab = torch.cat([pv.pad_node_array(p, 0) for pv, p in zip(pvs, parts)])
    out, flags = lops.lane_balance_round(union, blocks, lab, bdraws[:3] + [None], node_w,
                                         torch.cat(bcaps))
    for j in range(3):
        ref, rflags = balancer._balance_round(pvs[j].pad_node_array(parts[j], 0), bdraws[j],
                                              bvs[j], pvs[j].node_w, bcaps[j], k=k)
        assert torch.equal(out[off[j]:off[j + 1]], ref)
        assert torch.equal(flags[j], rflags)
    assert torch.equal(out[off[3]:off[4]], lab[off[3]:off[4]])


@pytest.mark.cuda
def test_lanestacked_batch_equals_sequential_card_runs(cuda):
    """A 4-lane stacked batch on the card equals each graph's sequential
    ``KaMinPar`` run on the card bit for bit, and launches both kernels."""
    import copy

    from kaminpar_tpu_torch.presets import create_context_by_preset_name
    from kaminpar_tpu_torch.serve.lanestack import run_lanestacked

    ctx = create_context_by_preset_name("serve")
    ctx.coarsening.contraction_limit = 64
    graphs = _lane_graphs()
    lp_kernels.reset_launches()
    parts, rep = run_lanestacked(ctx, graphs, 8, 0.03, device=cuda)
    if cuda.type == "cuda":
        assert rep.launches["lp_rate"] > 0 and rep.launches["lp_commit"] > 0
    assert rep.levels > 0
    for g, part in zip(graphs, parts):
        solver = kp.KaMinPar(copy.deepcopy(ctx), device=cuda)
        solver.set_graph(g)
        assert np.array_equal(solver.compute_partition(8, 0.03), part)
