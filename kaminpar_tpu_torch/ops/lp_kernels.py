"""The hand-written CUDA kernels of the LP round, their wrappers and build.

Three kernels replace the TPU kernels of ``kaminpar_tpu/ops/pallas_lp.py``:

- ``csrc/lp_rate.cu`` (``kp_rate_bucket``) replaces ``_rate_bucket``: the
  best move of every row of one degree bucket;
- ``csrc/lp_rate.cu`` (``kp_rate_compressed_bucket``) replaces
  ``_rate_compressed_bucket``: the same rating, with each row decoded from
  the compressed word stream inside the kernel;
- ``csrc/lp_commit.cu`` (``kp_commit_moves``) replaces ``commit_moves``:
  movers, capacity auction and label/weight update of one round, in a
  fixed number of launches (one regime for L <= 256 labels, another above).

``csrc/warp_sort.cuh`` holds the warp-level sort and scans that both
sources use.

Dispatch is by device: a CUDA tensor goes to the kernel, a CPU tensor to
the plain PyTorch version (``bucketed_gains._bucket_moves``,
:func:`rate_compressed_bucket_plain`, ``lp._commit_moves``).  There is no
fallback: a kernel that does not build or launch raises.  Each wrapper counts its kernel launches in
:data:`LAUNCHES`, under a lock: the extension jobs launch from a thread
pool.

Build: ``nvcc`` compiles each source for ``sm_90a`` (all at once, one
process per source) and links one shared library with a plain C
interface, loaded with ``ctypes``.  It runs at first use, from the
package's own sources, into ``build/kernels/`` at the repository root, and
again whenever the sources change (the library's name carries their hash).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ..graph.bucketed import Bucket
from ..graph.device_compressed import CompressedBucket, CompressedStream, decode_bucket
from . import bucketed_gains, lp

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("lp_rate.cu", "lp_commit.cu")
HEADERS = ("warp_sort.cuh",)
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

# Launches per kernel since the last reset_launches().
LAUNCHES = {"lp_rate": 0, "lp_rate_compressed": 0, "lp_commit": 0}
# The same launches of the two rating kernels split by their flags, keyed
# by rate_mode(external_only, respect_caps): JET's find step is the only
# caller of (external_only, no caps).
RATE_MODES = {}
# What the last build printed (ptxas register/shared-memory/spill lines)
# and how long it took; empty when the library came from an earlier build.
BUILD_INFO = {"seconds": None, "log": ""}

# Widest rows the rating kernels rate one warp per row; wider rows take
# one block per row (csrc/lp_rate.cu kWarpMaxWidth, checked at load).
WARP_MAX_WIDTH = 64

_lib = None
_lock = threading.Lock()
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        RATE_MODES.clear()


def rate_mode(external_only: bool, respect_caps: bool) -> str:
    return f"external_only={int(external_only)},respect_caps={int(respect_caps)}"


def _count_launch(name: str, mode: Optional[str] = None) -> None:
    with _launch_lock:
        LAUNCHES[name] += 1
        if mode is not None:
            key = f"{name}:{mode}"
            RATE_MODES[key] = RATE_MODES.get(key, 0) + 1


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if the sources changed) and return the library
    path.  Raises on any compiler error."""
    lib_path = BUILD_DIR / f"libkp_lp_{_source_hash()}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        tmp_lib = Path(tmp) / lib_path.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp_lib),
             *(str(obj) for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(logs)
    from ..utils import compile_stats

    compile_stats.record_build("nvcc", BUILD_INFO["seconds"])
    return lib_path


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            P, I = ctypes.c_void_p, ctypes.c_int
            lib.kp_rate_bucket.argtypes = [P, P, P, P, I, P, P, P, P, I, I, I, I, I, I,
                                           I, I, P, P, P, P, P]
            lib.kp_rate_bucket.restype = I
            lib.kp_rate_compressed_bucket.argtypes = [P, P, P, P, I, P, I, P, I, I, P, P,
                                                      P, P, P, P, I, I, I, I, I, I, I, P,
                                                      P, P, P, P]
            lib.kp_rate_compressed_bucket.restype = I
            lib.kp_commit_moves.argtypes = [I, I, P, P, P, P, I, P, P, P, P, P, P, P,
                                            I, I, I, P, P, P, P, P]
            lib.kp_commit_moves.restype = I
            lib.kp_commit_scratch_bytes.argtypes = [I, I]
            lib.kp_commit_scratch_bytes.restype = ctypes.c_longlong
            lib.kp_rate_warp_max_width.argtypes = []
            lib.kp_rate_warp_max_width.restype = I
            if lib.kp_rate_warp_max_width() != WARP_MAX_WIDTH:
                raise RuntimeError(
                    f"csrc/lp_rate.cu's warp path takes rows up to "
                    f"{lib.kp_rate_warp_max_width()}, the wrapper plans keys for "
                    f"{WARP_MAX_WIDTH}")
            _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name: str, t: torch.Tensor, dtype, shape=None, device=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _route(*tensors) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors); anything else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("LP kernel inputs lie on different devices")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no LP kernel for device {dev}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err}")


def _check_bucket_shape(R: int, w: int) -> None:
    if w & (w - 1) or not 8 <= w <= 4096 or R & (R - 1) or R < 8:
        raise ValueError(f"bucket shape ({R}, {w}) is not a power-of-two bucket")


def sort_key_plan(num_labels: int, w: int):
    """(label_bits, key64) of the rating kernels' sort for ``num_labels``
    labels (the length of the label-weight table; labels lie in [0, L))
    and rows of width ``w``: the label's significant bits, ceil(log2 L)
    and at least 1, which the block path (w > WARP_MAX_WIDTH) radix-sorts;
    and whether the warp path needs 64-bit (label, slot) keys, when
    label_bits + log2 w > 32."""
    label_bits = max(1, (int(num_labels) - 1).bit_length())
    return label_bits, w <= WARP_MAX_WIDTH and label_bits + w.bit_length() - 1 > 32


def _check_rate_tables(labels, node_w, label_weights, max_label_weights, dev):
    """Checks the rating kernels' node and label tables; returns the cap as
    a (1,) or (L,) tensor and whether it is a scalar."""
    i32 = torch.int32
    _check("labels", labels, i32, device=dev)
    _check("node_w", node_w, i32, labels.shape, dev)
    _check("label_weights", label_weights, i32, device=dev)
    maxw_scalar = max_label_weights.ndim == 0
    maxw = max_label_weights.reshape(1) if maxw_scalar else max_label_weights
    _check("max_label_weights", maxw, i32,
           None if maxw_scalar else label_weights.shape, dev)
    return maxw, maxw_scalar


def _rate_outputs(R: int, dev):
    i32 = torch.int32
    return (torch.empty(R, dtype=i32, device=dev), torch.empty(R, dtype=i32, device=dev),
            torch.empty(R, dtype=i32, device=dev), torch.empty(R, dtype=torch.bool, device=dev))


def _stream_ptr(dev):
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def rate_bucket(labels, node_w, label_weights, max_label_weights, bucket, tie, *,
                real_rows: int, external_only: bool, respect_caps: bool,
                tie_break: str = "uniform"):
    """Best move of every row of one (R, w) bucket: (target, tconn,
    own_conn, has), each (R,).  Kernel #1 on CUDA tensors.  ``real_rows``
    (the layout's host count, ``BucketedView.real_rows``) is where the pad
    rows begin: the kernel answers them ``(labels[node], 0,
    0, False)``, which is what rating them gives, without loading their
    slots.  Labels lie in ``[0, len(label_weights))`` and ties are >= 0,
    as the LP round draws them."""
    nodes, cols, wgts = bucket
    R, w = cols.shape
    real_rows = int(real_rows)
    if not 0 <= real_rows <= R:
        raise ValueError(f"real_rows {real_rows} is outside [0, {R}]")
    if not _route(labels, node_w, label_weights, max_label_weights, nodes, cols,
                  wgts, tie):
        return bucketed_gains._bucket_moves(
            labels, bucket, node_w, label_weights, max_label_weights, tie,
            external_only=external_only, respect_caps=respect_caps,
            tie_break=tie_break,
        )
    if tie_break not in ("uniform", "lightest"):
        raise ValueError(f"unknown tie_break {tie_break!r}")
    _check_bucket_shape(R, w)
    dev = cols.device
    i32 = torch.int32
    maxw, maxw_scalar = _check_rate_tables(labels, node_w, label_weights,
                                           max_label_weights, dev)
    _check("nodes", nodes, i32, (R,), dev)
    _check("wgts", wgts, i32, (R, w), dev)
    _check("cols", cols, i32, (R, w), dev)
    _check("tie", tie, i32, (R, w), dev)
    for name, t in (("cols", cols), ("wgts", wgts)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it in 16-byte vectors; "
                             "it must be 16-byte aligned")
    label_bits, key64 = sort_key_plan(label_weights.shape[0], w)
    target, tconn, own_conn, has = _rate_outputs(R, dev)
    err = _library().kp_rate_bucket(
        _ptr(labels), _ptr(node_w), _ptr(label_weights), _ptr(maxw),
        int(maxw_scalar), _ptr(nodes), _ptr(cols), _ptr(wgts), _ptr(tie), R, w,
        real_rows, label_bits, int(key64),
        int(external_only), int(respect_caps), int(tie_break == "lightest"),
        _ptr(target), _ptr(tconn), _ptr(own_conn), _ptr(has), _stream_ptr(dev),
    )
    _raise_on(err, "kp_rate_bucket")
    _count_launch("lp_rate", rate_mode(external_only, respect_caps))
    return target, tconn, own_conn, has


def rate_compressed_bucket_plain(labels, node_w, label_weights, max_label_weights,
                                 stream: CompressedStream, cb: CompressedBucket, tie,
                                 **flags):
    """The plain version of kernel #2 on any device: the bucket decoded to
    its (R, w) ``(cols, wgts)`` (``device_compressed.decode_bucket``), then
    the plain rating ``bucketed_gains._bucket_moves``."""
    cols, wgts = decode_bucket(stream, cb)
    return bucketed_gains._bucket_moves(labels, Bucket(cb.nodes, cols, wgts), node_w,
                                        label_weights, max_label_weights, tie, **flags)


def rate_compressed_bucket(labels, node_w, label_weights, max_label_weights,
                           stream: CompressedStream, cb: CompressedBucket, tie, *,
                           external_only: bool, respect_caps: bool,
                           tie_break: str = "uniform"):
    """Best move of every row of one compressed bucket, its (R, w)
    neighbour slots decoded from ``stream``: (target, tconn, own_conn,
    has), each (R,).  Kernel #2 on CUDA tensors (the decoded rows never
    reach device memory); on CPU tensors the plain version decodes the
    bucket and rates it."""
    if not _route(labels, node_w, label_weights, max_label_weights, stream.words,
                  stream.edge_w, *cb[:5], tie):
        return rate_compressed_bucket_plain(
            labels, node_w, label_weights, max_label_weights, stream, cb, tie,
            external_only=external_only, respect_caps=respect_caps, tie_break=tie_break,
        )
    if tie_break not in ("uniform", "lightest"):
        raise ValueError(f"unknown tie_break {tie_break!r}")
    R, w = int(cb.nodes.shape[0]), int(cb.w)
    _check_bucket_shape(R, w)
    dev = cb.nodes.device
    i32 = torch.int32
    maxw, maxw_scalar = _check_rate_tables(labels, node_w, label_weights,
                                           max_label_weights, dev)
    words, edge_w = stream
    _check("words", words, i32, device=dev)
    _check("edge_w", edge_w, i32, device=dev)
    if words.ndim != 1 or words.shape[0] < 2 or edge_w.ndim != 1:
        raise ValueError("words and edge_w must be 1-D, words of at least 2 entries")
    for name, t in zip(("nodes", "wstart", "width", "deg", "estart"), cb[:5]):
        _check(name, t, i32, (R,), dev)
    _check("tie", tie, i32, (R, w), dev)
    label_bits, key64 = sort_key_plan(label_weights.shape[0], w)
    target, tconn, own_conn, has = _rate_outputs(R, dev)
    err = _library().kp_rate_compressed_bucket(
        _ptr(labels), _ptr(node_w), _ptr(label_weights), _ptr(maxw),
        int(maxw_scalar), _ptr(words), int(words.shape[0]), _ptr(edge_w),
        int(edge_w.shape[0]), int(stream.weighted), *(_ptr(t) for t in cb[:5]),
        _ptr(tie), R, w, label_bits, int(key64), int(external_only), int(respect_caps),
        int(tie_break == "lightest"), _ptr(target), _ptr(tconn), _ptr(own_conn),
        _ptr(has), _stream_ptr(dev),
    )
    _raise_on(err, "kp_rate_compressed_bucket")
    _count_launch("lp_rate_compressed", rate_mode(external_only, respect_caps))
    return target, tconn, own_conn, has


def commit_moves(state: "lp.LPState", target, tconn, own_conn, node_w,
                 max_label_weights, num_labels: int, prio, coin=None, act=None, *,
                 active_prob: float = 1.0, allow_tie_moves: bool = False,
                 active=None, radix: Optional[bool] = None) -> "lp.LPState":
    """Commit one LP round: kernel #3 on CUDA tensors, ``lp._commit_moves``
    on CPU tensors.  ``radix`` picks the plain version's auction (None: by
    ``lp.use_radix_auction``); the kernel has one auction for every L and
    gives the same result as both.

    Domain (the LP round's draws keep to it, the kernel relies on it):
    labels and targets lie in ``[0, num_labels)``, priorities in
    ``[0, 2^30 - 1)``, node weights are >= 0 and their total is below
    2^31, so that no int32 sum of weights wraps."""
    labels, label_weights, _ = state
    if not _route(labels, label_weights, target, tconn, own_conn, node_w, prio):
        return lp._commit_moves(
            state, target, tconn, own_conn, node_w, max_label_weights,
            num_labels, prio, coin, act, active_prob=active_prob,
            allow_tie_moves=allow_tie_moves, active=active, radix=radix,
        )
    dev = labels.device
    i32, b8 = torch.int32, torch.bool
    n = int(labels.shape[0])
    L = int(num_labels)
    _check("labels", labels, i32, (n,), dev)
    _check("label_weights", label_weights, i32, (L,), dev)
    for name, t in (("target", target), ("tconn", tconn), ("own_conn", own_conn),
                    ("node_w", node_w), ("prio", prio)):
        _check(name, t, i32, (n,), dev)
    maxw_scalar = max_label_weights.ndim == 0
    maxw = max_label_weights.reshape(1) if maxw_scalar else max_label_weights
    _check("max_label_weights", maxw, i32, (1,) if maxw_scalar else (L,), dev)
    use_act = active_prob < 1.0
    for name, t, used in (("coin", coin, allow_tie_moves), ("act", act, use_act),
                          ("active", active, active is not None)):
        if used:
            if t is None:
                raise ValueError(f"{name} is required")
            _check(name, t, b8, (n,), dev)
    lib = _library()
    scratch = torch.empty(int(lib.kp_commit_scratch_bytes(n, L)), dtype=torch.uint8,
                          device=dev)
    new_labels = torch.empty(n, dtype=i32, device=dev)
    new_weights = torch.empty(L, dtype=i32, device=dev)
    moved_count = torch.empty((), dtype=i32, device=dev)
    err = lib.kp_commit_moves(
        n, L, _ptr(labels), _ptr(node_w), _ptr(label_weights), _ptr(maxw),
        int(maxw_scalar), _ptr(target), _ptr(tconn), _ptr(own_conn), _ptr(prio),
        _ptr(coin if allow_tie_moves else None), _ptr(act if use_act else None),
        _ptr(active), int(allow_tie_moves), int(use_act), int(active is not None),
        _ptr(scratch), _ptr(new_labels), _ptr(new_weights), _ptr(moved_count),
        _stream_ptr(dev),
    )
    _raise_on(err, "kp_commit_moves")
    _count_launch("lp_commit")
    return lp.LPState(new_labels, new_weights, moved_count)
