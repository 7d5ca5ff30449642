"""Port parity of the graph and partition files (``kaminpar_tpu_torch/io/``)
and the hierarchy dumps (``utils/debug.py``).

- METIS and ParHIP (32- and 64-bit) files written by both packages from
  the same graph are byte-identical, weighted or not, and each package
  reads the other's files into equal arrays;
- the compressed container holds equal arrays under every key, and each
  package reads the other's;
- partition and block-size files are byte-identical;
- the port's native METIS parser equals its NumPy parser and the JAX
  package's reader, and all three reject the same malformed inputs with
  the same exception types; a failed native build raises;
- the debug dumps name their files as the JAX package does, and a run
  with both dumps on writes one METIS file per coarse level.

Graphs are generated; every file is written under ``tmp_path``.
"""

import os

import numpy as np
import pytest
import torch

from kaminpar_tpu import io as jio
from kaminpar_tpu.graph import generators as jgen
from kaminpar_tpu.graph.compressed import CompressedGraph as JCompressedGraph
from kaminpar_tpu.graph.csr import CSRGraph as JCSRGraph
from kaminpar_tpu.utils import debug as jdebug
import kaminpar_tpu_torch as kp
from kaminpar_tpu_torch import io as tio
from kaminpar_tpu_torch.graph.compressed import CompressedGraph
from kaminpar_tpu_torch.graph.csr import from_numpy_csr
from kaminpar_tpu_torch.io import metis as tmetis
from kaminpar_tpu_torch.io import native as tnative
from kaminpar_tpu_torch.utils import Logger, OutputLevel
from kaminpar_tpu_torch.utils import debug as tdebug

ARRAYS = ("row_ptr", "col_idx", "node_w", "edge_w")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (several workers
    share the cores in a whole run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _quiet():
    level = Logger.level
    Logger.level = OutputLevel.QUIET
    yield
    Logger.level = level


def graph_pair(kind: str, seed: int = 3):
    """The same graph in both packages: (JAX CSRGraph, port CSRGraph)."""
    rng = np.random.default_rng(seed)
    g = jgen.rmat_graph(9, 6, seed=seed)  # has degree-0 nodes
    rp, col = np.asarray(g.row_ptr), np.asarray(g.col_idx)
    nw = ew = None
    if kind in ("node", "both"):
        nw = rng.integers(1, 9, g.n)
    if kind in ("edge", "both"):
        u = np.asarray(g.edge_u)
        ew = 1 + (np.minimum(u, col) * 31 + np.maximum(u, col)) % 7  # symmetric
    jg = JCSRGraph(rp, col, None if nw is None else nw.astype(np.int32),
                   None if ew is None else ew.astype(np.int32))
    return jg, from_numpy_csr(rp, col, nw, ew)


def assert_same_arrays(jg, tg):
    assert (jg.n, jg.m) == (tg.n, tg.m)
    for name in ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy(), err_msg=name)


@pytest.mark.parametrize("kind", ["unweighted", "node", "edge", "both"])
def test_metis_files_byte_identical_and_cross_read(tmp_path, kind):
    jg, tg = graph_pair(kind)
    jpath, tpath = str(tmp_path / "j.metis"), str(tmp_path / "t.metis")
    jio.write_graph(jg, jpath)
    tio.write_graph(tg, tpath)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert_same_arrays(jio.read_graph(tpath), tio.read_graph(jpath))
    assert tio.read_graph(tpath).row_ptr.dtype == torch.int32


@pytest.mark.parametrize("use_64bit", [False, True])
@pytest.mark.parametrize("kind", ["unweighted", "both"])
def test_parhip_files_byte_identical_and_cross_read(tmp_path, kind, use_64bit):
    jg, tg = graph_pair(kind)
    jpath, tpath = str(tmp_path / "j.parhip"), str(tmp_path / "t.parhip")
    jio.write_graph(jg, jpath, use_64bit=use_64bit)
    tio.write_graph(tg, tpath, use_64bit=use_64bit)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    assert_same_arrays(jio.read_graph(tpath), tio.read_graph(jpath))
    # the ParHIP header sniff: no extension
    bare = str(tmp_path / "bare")
    os.replace(tpath, bare)
    assert tio._detect(bare) == tio.GraphFileFormat.PARHIP
    assert jio._detect(bare).value == tio._detect(bare).value


def test_parhip_beyond_int32_raises(tmp_path):
    """The port holds int32 ids and weights: a 64-bit file whose node
    weights sum past 2^31 is refused, not wrapped."""
    path = tmp_path / "big.parhip"
    n, m = 2, 2
    version = 1  # node weights present, everything 64-bit
    adj_base = 24 + (n + 1) * 8
    with open(path, "wb") as f:
        f.write(np.array([version, n, m], dtype=np.uint64).tobytes())
        f.write((adj_base + np.array([0, 1, 2]) * 8).astype(np.uint64).tobytes())
        f.write(np.array([1, 0], dtype=np.uint64).tobytes())
        f.write(np.array([2**31, 5], dtype=np.int64).tobytes())
    for use_64bit in (False, True):
        with pytest.raises(ValueError, match="int32"):
            tio.read_graph(str(path), use_64bit=use_64bit)


@pytest.mark.parametrize("kind", ["unweighted", "both"])
def test_compressed_container_arrays_equal_and_cross_read(tmp_path, kind):
    jg, tg = graph_pair(kind)
    jpath, tpath = str(tmp_path / "j.compressed"), str(tmp_path / "t.compressed")
    jio.write_graph(jg, jpath)
    tio.write_graph(tg, tpath)
    with np.load(jpath) as jz, np.load(tpath) as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for key in jz.files:
            np.testing.assert_array_equal(jz[key], tz[key], err_msg=key)
    tcg = tio.read_graph(jpath)
    jcg = jio.read_graph(tpath)
    assert isinstance(tcg, CompressedGraph) and isinstance(jcg, JCompressedGraph)
    assert_same_arrays(jcg.decompress(), tio.read_graph(jpath, decompress=True))
    assert_same_arrays(jg, tcg.decompress())


def test_partition_and_block_size_files_byte_identical(tmp_path):
    rng = np.random.default_rng(5)
    part = rng.integers(0, 8, 300)
    node_w = rng.integers(1, 9, 300)
    for name, jw, tw in (
            ("part", lambda p: jio.write_partition(p, part),
             lambda p: tio.write_partition(p, torch.from_numpy(part.astype(np.int32)))),
            ("sizes", lambda p: jio.write_block_sizes(p, 8, part, node_w),
             lambda p: tio.write_block_sizes(p, 8, part, node_w)),
            ("sizes_unweighted", lambda p: jio.write_block_sizes(p, 9, part),
             lambda p: tio.write_block_sizes(p, 9, part))):
        jpath, tpath = str(tmp_path / f"j.{name}"), str(tmp_path / f"t.{name}")
        jw(jpath)
        tw(tpath)
        assert open(jpath, "rb").read() == open(tpath, "rb").read(), name
    np.testing.assert_array_equal(tio.read_partition(str(tmp_path / "j.part")), part)


def test_native_parser_equals_numpy_parser_and_jax(tmp_path, monkeypatch):
    _, tg = graph_pair("both", seed=4)
    path = tmp_path / "w.metis"
    tio.write_metis(tg, str(path))
    lines = path.read_text().split("\n")
    lines.insert(1, "% a comment")
    lines.insert(5, "   % an indented comment")
    path.write_text("\n".join(lines))

    # the JAX package reads first: its loader would take the switch below
    # for its own and keep its NumPy parser for the rest of the process
    jg = jio.read_graph(str(path))
    native = from_numpy_csr(*tnative.parse_metis_native(str(path)))
    via_read = tio.read_metis(str(path))
    numpy_parser = tmetis._read_metis_numpy(str(path))
    monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    via_switch = tio.read_metis(str(path))
    for g in (native, via_read, numpy_parser, via_switch):
        assert_same_arrays(jg, g)
    assert_same_arrays(jg, tg)


MALFORMED = {
    "token": "2 1\n2 x\n1\n",
    "count": "2 2\n2\n1\n",
    "dangling": "2 1 1\n2\n1 1\n",
    "one_token_header": "2\n1\n2\n1\n",
    "huge_header": "1 2305843009213693952\n\n",
    "big_token": "2 1 1\n2 18446744073709551617\n1 1\n",
    "range": "2 1\n3\n1\n",
    "more_lines": "1 0\n\n\n5\n",
    "empty": "",
    "missing": None,
}


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — the type is the result
        return type(exc)
    return None


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_parsers_reject_malformed_alike(tmp_path, monkeypatch, case):
    """The port's two parsers and the JAX package's native parser raise
    the same exception type.  The JAX package's loader is reset first: its
    ``read_metis`` falls back to its NumPy parser for the rest of a process
    once a load failed or ``KAMINPAR_TPU_NO_NATIVE`` was seen, and that
    parser accepts the dangling-weight line."""
    from kaminpar_tpu.io import native as jnative

    path = str(tmp_path / f"{case}.metis")
    if MALFORMED[case] is not None:
        with open(path, "w") as f:
            f.write(MALFORMED[case])
    monkeypatch.delenv(tnative.NO_NATIVE_ENV, raising=False)
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_lib_failed", False)
    assert jnative.native_available()
    native = _raised(lambda: tnative.parse_metis_native(path))
    numpy_parser = _raised(lambda: tmetis._read_metis_numpy(path))
    jax_native = _raised(lambda: jnative.parse_metis_native(path))
    monkeypatch.setenv(tnative.NO_NATIVE_ENV, "1")
    numpy_via_read = _raised(lambda: tio.read_metis(path))
    expected = FileNotFoundError if case == "missing" else ValueError
    assert native is numpy_parser is jax_native is numpy_via_read is expected


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """A source g++ rejects: the build raises with the compiler's output
    and ``read_metis`` raises too; it never falls back to NumPy."""
    bad = tmp_path / "metis_native.cpp"
    bad.write_text("this is not C++\n")
    graph_file = tmp_path / "g.metis"
    graph_file.write_text("2 1\n2\n1\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        tnative.build()
    assert "error" in str(err.value)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tio.read_metis(str(graph_file))
    assert not list((tmp_path / "native").glob("*.so"))


def test_native_library_built_under_build_native():
    lib = tnative.build()
    assert lib.parent.name == "native" and lib.parent.parent.name == "build"
    assert lib.exists() and tnative.build() == lib


def test_debug_filenames_match_jax():
    from kaminpar_tpu import context as jctx
    from kaminpar_tpu_torch import context as tctx

    jg, tg = graph_pair("unweighted")
    for name, seed, k in (("", 0, 2), ("rmat", 7, 16)):
        jc, tc = jctx.Context(), tctx.Context()
        for c in (jc, tc):
            c.debug.graph_name, c.seed, c.partition.k = name, seed, k
        for pattern in ("./%graph_level3", "out/%graph_%n_%m_k%k_s%seed", "plain"):
            for suffix in (".metis", ".part"):
                assert (tdebug._filename(pattern, tc, tg, suffix)
                        == jdebug._filename(pattern, jc, jg, suffix))


def test_hierarchy_dumps_one_file_per_level(tmp_path):
    """Both dumps on: one METIS file per coarse level, read back at that
    level's n, and one partition file per level, level 0 (the graph the
    deep scheme ran on) included."""
    _, g = graph_pair("unweighted", seed=2)
    s = kp.KaMinPar("default", device="cpu")
    s.ctx.coarsening.contraction_limit = 20
    s.ctx.debug.dump_dir = str(tmp_path / "dumps")
    s.ctx.debug.graph_name = "rmat"
    s.ctx.debug.dump_graph_hierarchy = True
    s.ctx.debug.dump_partition_hierarchy = True
    s.set_graph(g)
    s.compute_partition(4)
    level_n = s.last_partitioner.level_n
    levels = s.last_partitioner.num_levels
    assert levels >= 2 and len(level_n) == levels + 1
    dumps = tmp_path / "dumps"
    for level in range(1, levels + 1):
        dumped = tio.read_graph(str(dumps / f"rmat_level{level}.metis"))
        assert dumped.n == level_n[level] and dumped.m > 0
        blocks = tio.read_partition(str(dumps / f"rmat_level{level}_k4.part"))
        assert blocks.shape == (dumped.n,)
    assert not (dumps / "rmat_level0.metis").exists()
    finest = tio.read_partition(str(dumps / "rmat_level0_k4.part"))
    assert finest.shape == (level_n[0],) and 0 <= finest.min() and finest.max() < 4


def test_file_graph_partitions_as_built_graph(tmp_path):
    """A graph read from a file and the same graph built in memory give the
    same partition under the same preset and seed."""
    _, tg = graph_pair("both", seed=6)
    parts = []
    for route in ("memory", "metis", "parhip", "compressed"):
        if route == "memory":
            graph = tg
        else:
            path = str(tmp_path / f"g.{route}")
            tio.write_graph(tg, path)
            graph = tio.read_graph(path, decompress=True)
        s = kp.KaMinPar("default", device="cpu")
        s.ctx.seed = 3
        s.set_graph(graph)
        parts.append(s.compute_partition(4))
        assert parts[-1].dtype == np.int32
    for other in parts[1:]:
        np.testing.assert_array_equal(parts[0], other)
