"""Port parity of the entry points users run: TOML configs
(``kaminpar_tpu_torch/config.py``), the CLI (``cli.py``,
``python -m kaminpar_tpu_torch``), the C API (``capi_bridge.py`` and
``capi/``) and the networkit adapter (``integrations/``).

- ``dump_toml`` of every port preset parses to the JAX package's dump of
  the same preset, restricted to the port's keys, and loads back to the
  same context; an unknown key raises;
- the CLI has every option of the JAX package's, with the same dests and
  defaults, plus ``--device``; with ``--device cpu`` it partitions a file
  as the facade partitions the same graph; without a card and without
  ``--device`` it exits non-zero, naming the missing CUDA device;
- ``CSolver`` takes the C shim's memoryview arguments; the C library and
  its demo build, and the demo fails here with the facade's no-CUDA error
  (there is no CPU fallback);
- the networkit adapter on a duck-typed graph.

Everything runs on the CPU, on graphs of a few thousand nodes at most.
"""

import json
import os
import shutil
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch

from kaminpar_tpu import cli as jcli
from kaminpar_tpu import config as jconfig
from kaminpar_tpu import presets as jpresets
import kaminpar_tpu_torch as kp
from kaminpar_tpu_torch import cli, config, io as tio, presets
from kaminpar_tpu_torch.capi_bridge import CSolver
from kaminpar_tpu_torch.graph import generators
from kaminpar_tpu_torch.graph.metrics import edge_cut, is_feasible
from kaminpar_tpu_torch.integrations import KaMinParNetworKit
from kaminpar_tpu_torch.integrations.networkit import networkit_to_csr
from kaminpar_tpu_torch.telemetry import validate_chrome_trace
from kaminpar_tpu_torch.utils import Logger

ROOT = Path(__file__).resolve().parent.parent
CAPI = ROOT / "kaminpar_tpu_torch" / "capi"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's torch work (several workers
    share the cores in a whole run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _keep_log_level():
    level = Logger.level
    yield
    Logger.level = level


def _subset(port: dict, ref: dict) -> dict:
    """``ref`` restricted to the keys of ``port``, table by table."""
    return {key: _subset(val, ref[key]) if isinstance(val, dict) else ref[key]
            for key, val in port.items()}


@pytest.mark.parametrize("preset", presets.get_preset_names())
def test_dump_toml_matches_jax_and_round_trips(preset):
    ctx = presets.create_context_by_preset_name(preset)
    text = config.dump_toml(ctx)
    port = tomllib.loads(text)
    ref = tomllib.loads(jconfig.dump_toml(jpresets.create_context_by_preset_name(preset)))
    assert port == _subset(port, ref)
    assert config.load_toml(text) == ctx
    assert config.load_toml(text, presets.create_context_by_preset_name("fast")) == ctx


def test_load_toml_overrides_and_rejects_unknown_keys(tmp_path):
    path = tmp_path / "c.toml"
    path.write_text('preset_name = "strong"\nseed = 9\n[coarsening]\ncontraction_limit = 77\n'
                    '[refinement]\nalgorithms = ["overload-balancer", "lp"]\n')
    ctx = config.load_toml_file(str(path))
    assert (ctx.preset_name, ctx.seed, ctx.coarsening.contraction_limit) == ("strong", 9, 77)
    assert [a.value for a in ctx.refinement.algorithms] == ["overload-balancer", "lp"]
    for text in ("no_such_key = 1\n", "[coarsening]\nno_such_key = 1\n"):
        with pytest.raises(ValueError, match="unknown config key"):
            config.load_toml(text)
        with pytest.raises(ValueError, match="unknown config key"):
            jconfig.load_toml(text)
    with pytest.raises(ValueError, match="must be a table"):
        config.load_toml("coarsening = 3\n")


def test_cli_parser_matches_jax():
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    port = {a.dest: a for a in cli.build_parser()._actions}
    assert set(port) == set(ref) | {"device"}
    for dest, action in ref.items():
        assert port[dest].default == action.default, dest
        assert port[dest].option_strings == action.option_strings, dest
        assert port[dest].type == action.type, dest
    assert port["device"].default is None
    assert port["preset"].choices == presets.get_preset_names()
    assert port["format"].choices == ref["format"].choices


def _metis_file(tmp_path, scale=10, seed=5):
    g = generators.rmat_graph(scale, 8, seed=seed)
    path = str(tmp_path / "g.metis")
    tio.write_graph(g, path)
    return g, path


def test_cli_partitions_file_as_the_facade(tmp_path, capsys):
    g, path = _metis_file(tmp_path)
    part_file, sizes_file, trace_file = (str(tmp_path / n) for n in ("p", "bs", "t.json"))
    rc = cli.main([path, "8", "-P", "default", "-s", "4", "-o", part_file,
                   "--block-sizes", sizes_file, "-E", "--trace-out", trace_file,
                   "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "read by the native METIS parser" in out and "RESULT cut=" in out

    s = kp.KaMinPar("default", device="cpu")
    s.ctx.seed = 4
    s.set_graph(g)
    expected = s.compute_partition(8)
    np.testing.assert_array_equal(tio.read_partition(part_file), expected)
    np.testing.assert_array_equal(np.loadtxt(sizes_file, dtype=np.int64),
                                  s.last_partition.block_weights())
    validate_chrome_trace(json.loads(Path(trace_file).read_text()))


def test_cli_dump_config_and_config_file(tmp_path, capsys):
    assert cli.main(["--dump-config", "-P", "jet", "-s", "3", "--use-64bit"]) == 0
    dumped = capsys.readouterr().out
    ctx = config.load_toml(dumped)
    assert (ctx.preset_name, ctx.seed, ctx.use_64bit_ids) == ("jet", 3, True)
    path = tmp_path / "c.toml"
    path.write_text("[coarsening]\ncontraction_limit = 55\n")
    assert cli.main(["--dump-config", "-C", str(path)]) == 0
    assert config.load_toml(capsys.readouterr().out).coarsening.contraction_limit == 55
    with pytest.raises(SystemExit):
        cli.main(["--trace-out", "x", "--device", "cpu"])  # graph and k missing


def test_cli_compressed_input_under_terapart(tmp_path, capsys):
    g = generators.rmat_graph(10, 8, seed=2)
    path = str(tmp_path / "g.compressed")
    tio.write_graph(g, path)
    part_file = str(tmp_path / "p")
    assert cli.main([path, "4", "-P", "terapart", "-o", part_file, "-q", "--device", "cpu"]) == 0
    part = tio.read_partition(part_file)
    s = kp.KaMinPar("terapart", device="cpu")
    s.set_graph(tio.read_graph(path))
    np.testing.assert_array_equal(part, s.compute_partition(4))
    assert is_feasible(g, part, 4, s.ctx.partition.max_block_weights)


def _run_module(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "kaminpar_tpu_torch", *args], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_module_runs_on_cpu_and_refuses_without_card(tmp_path):
    _, path = _metis_file(tmp_path, scale=9)
    ok = _run_module([path, "4", "--device", "cpu", "-o", "p"], tmp_path)
    assert ok.returncode == 0, ok.stderr[-2000:]
    assert tio.read_partition(str(tmp_path / "p")).shape == (512,)
    refused = _run_module([path, "4", "-o", "q"], tmp_path)
    assert refused.returncode != 0
    assert "CUDA is not available" in refused.stderr
    assert "Input graph" not in refused.stdout  # refused before the read
    assert not (tmp_path / "q").exists()


def test_csolver_takes_the_shims_memoryviews():
    """Drive CSolver as ``capi/kaminpar_tpu_c.cc`` does: uint64 xadj,
    uint32 adjncy, int64 weights and max block weights, a writable uint32
    output buffer, all as memoryviews."""
    g = generators.grid2d_graph(12, 12)
    xadj = g.row_ptr.numpy().astype(np.uint64)
    adjncy = g.col_idx.numpy().astype(np.uint32)
    vwgt = np.ones(g.n, dtype=np.int64)
    s = CSolver("fast", device="cpu")
    s.set_seed(2)
    s.copy_graph(g.n, memoryview(xadj), memoryview(adjncy), memoryview(vwgt), None)
    maxw = np.array([40, 40, 40, 40], dtype=np.int64)
    s.set_max_block_weights(4, memoryview(maxw))
    out = np.zeros(g.n, dtype=np.uint32)
    cut = s.compute(4, 0.03, memoryview(out))
    assert cut == edge_cut(g, out.astype(np.int64))
    assert np.bincount(out, minlength=4).max() <= 40
    with pytest.raises(ValueError, match="partition buffer"):
        s.compute(4, 0.03, memoryview(np.zeros(3, dtype=np.uint32)))
    with pytest.raises(ValueError, match="entries"):
        s.copy_graph(g.n + 1, memoryview(xadj), memoryview(adjncy), None, None)
    s.clear_block_weights()
    assert s.max_block_weights is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            CSolver("fast")  # the C shim passes no device


@pytest.mark.skipif(shutil.which("g++") is None or shutil.which("make") is None,
                    reason="native toolchain unavailable")
@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the run without a card")
def test_c_library_builds_and_demo_refuses_without_card():
    build = subprocess.run(["make", "-C", str(CAPI), "demo"], capture_output=True, text=True,
                           timeout=300)
    assert build.returncode == 0, build.stderr[-2000:]
    demo = ROOT / "build" / "capi" / "demo"
    assert demo.exists() and (ROOT / "build" / "capi" / "libkaminpar_tpu_torch.so").exists()
    assert not list(CAPI.glob("*.so")) and not (CAPI / "demo").exists()
    env = dict(os.environ, PYTHONPATH=str(ROOT), KPTPU_PYTHON=sys.executable)
    run = subprocess.run([str(demo)], capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
    assert "CAPI_OK" not in run.stdout


class FakeNkGraph:
    """Duck-typed networkit.Graph over one of the port's CSR graphs."""

    def __init__(self, g, weighted=False, directed=False):
        self.rp = g.row_ptr.numpy()
        self.col = g.col_idx.numpy()
        self.w = g.edge_w.numpy()
        self._weighted = weighted
        self._directed = directed

    def numberOfNodes(self):
        return len(self.rp) - 1

    def isWeighted(self):
        return self._weighted

    def isDirected(self):
        return self._directed

    def iterNeighbors(self, u):
        yield from self.col[self.rp[u]: self.rp[u + 1]]

    def iterNeighborsWeights(self, u):
        for e in range(self.rp[u], self.rp[u + 1]):
            yield self.col[e], float(self.w[e])


def test_networkit_roundtrip_and_partition():
    g = generators.grid2d_graph(16, 16)
    G = FakeNkGraph(g)
    csr = networkit_to_csr(G)
    assert csr.n == g.n and csr.m == g.m
    assert np.array_equal(csr.col_idx.numpy(), g.col_idx.numpy())

    solver = KaMinParNetworKit(G, ctx="fast", device="cpu")
    part = solver.compute_partition_k(4)
    assert isinstance(part, list) and len(part) == g.n
    part = np.asarray(part)
    assert is_feasible(g, part, 4, solver.ctx.partition.max_block_weights)
    assert edge_cut(g, part) < 200  # grid 16x16 into quarters: far below random


def test_networkit_weighted_and_factors():
    g0 = generators.grid2d_graph(8, 8)
    G = FakeNkGraph(g0, weighted=True)
    csr = networkit_to_csr(G)
    assert int(csr.edge_w.sum()) == g0.total_edge_weight

    solver = KaMinParNetworKit(G, ctx="fast", device="cpu")
    part = solver.compute_partition_with_factors([0.6, 0.6])
    bw = np.bincount(part, minlength=2)
    assert bw.max() <= int(np.ceil(0.6 * 64))
    assert len(solver.compute_partition_with_weights([40, 40], [20, 20])) == 64

    with pytest.raises(ValueError, match="undirected"):
        networkit_to_csr(FakeNkGraph(g0, directed=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            KaMinParNetworKit(G)
