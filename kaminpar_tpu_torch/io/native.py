"""ctypes loader for the native (C++) METIS parser (counterpart of
``kaminpar_tpu/io/native.py``).

``_native/metis_native.cpp`` is the mmap tokenizer of the reference's IO
layer (``kaminpar-io/metis_parser.cc``).  It is built with ``g++`` at first
use, from the package's own source, into ``build/native/`` at the
repository root; the library's name carries a hash of the source and the
flags, and it is renamed into place atomically, so concurrent builds do
not collide.  It is loaded with ctypes: a plain C ABI, no Python C API.

There is no quiet fallback: a failed build or load raises with the
compiler's output.  The NumPy parser (``metis.read_metis``'s own loop) runs
only where ``KAMINPAR_TPU_NO_NATIVE=1`` asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "_native" / "metis_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NO_NATIVE_ENV = "KAMINPAR_TPU_NO_NATIVE"

_lib = None
_lock = threading.Lock()


class _KpMetisGraph(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("m", ctypes.c_int64),
        ("row_ptr", ctypes.POINTER(ctypes.c_int64)),
        ("col_idx", ctypes.POINTER(ctypes.c_int64)),
        ("node_w", ctypes.POINTER(ctypes.c_int64)),
        ("edge_w", ctypes.POINTER(ctypes.c_int64)),
        ("error", ctypes.c_char_p),
    ]


def native_requested() -> bool:
    """Whether the native parser reads METIS files (the default), or the
    NumPy parser (``KAMINPAR_TPU_NO_NATIVE=1``)."""
    return os.environ.get(NO_NATIVE_ENV) != "1"


def build() -> Path:
    """Compile the parser (if its source changed) and return the library
    path.  Raises ``RuntimeError`` with the compiler's output on failure."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so_path = BUILD_DIR / f"metis_native_{digest}.so"
    if so_path.exists():
        return so_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_name(f"{so_path.name}.tmp{os.getpid()}.{threading.get_ident()}")
    t0 = time.perf_counter()
    try:
        res = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except OSError as exc:
        raise RuntimeError(f"the native METIS parser cannot be built: {exc}") from exc
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{res.stderr}")
    os.replace(tmp, so_path)  # atomic against concurrent builds
    from ..utils import compile_stats

    compile_stats.record_build("g++", time.perf_counter() - t0)
    return so_path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.kp_parse_metis.argtypes = [ctypes.c_char_p, ctypes.POINTER(_KpMetisGraph)]
            lib.kp_parse_metis.restype = ctypes.c_int
            lib.kp_free_graph.argtypes = [ctypes.POINTER(_KpMetisGraph)]
            lib.kp_free_graph.restype = None
            _lib = lib
    return _lib


def parse_metis_native(path: str):
    """Parse with the C++ library; returns (row_ptr, col_idx, node_w,
    edge_w) as int64 NumPy arrays (weights None when absent).  Raises
    ValueError on malformed input, FileNotFoundError on a missing file."""
    lib = _load()
    if not os.path.isfile(path):
        # the same exception type as the NumPy parser's open()
        open(path, "rb").close()
    g = _KpMetisGraph()
    rc = lib.kp_parse_metis(os.fsencode(path), ctypes.byref(g))
    try:
        if rc != 0:
            msg = (g.error or b"parse error").decode()
            raise ValueError(f"{path}: {msg}")
        n, m = g.n, g.m
        row_ptr = np.ctypeslib.as_array(g.row_ptr, shape=(n + 1,)).copy()
        col_idx = (np.ctypeslib.as_array(g.col_idx, shape=(m,)).copy()
                   if m else np.zeros(0, dtype=np.int64))
        node_w = (np.ctypeslib.as_array(g.node_w, shape=(n,)).copy()
                  if g.node_w and n else None)
        edge_w = (np.ctypeslib.as_array(g.edge_w, shape=(m,)).copy()
                  if g.edge_w and m else None)
        return row_ptr, col_idx, node_w, edge_w
    finally:
        lib.kp_free_graph(ctypes.byref(g))
