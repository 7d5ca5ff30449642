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
