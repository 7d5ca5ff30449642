"""The port stands alone: no module of ``kaminpar_tpu_torch`` nor
``chip_smoke.py`` imports jax or the JAX package, none of its C, C++ and
CUDA sources (and build files) names a JAX-package module, and the package
partitions a graph while ``jax`` cannot be imported at all."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "kaminpar_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
NATIVE_PATTERNS = ("*.cc", "*.cpp", "*.c", "*.h", "*.cu", "*.cuh", "Makefile")
NATIVE_FILES = sorted(path for pattern in NATIVE_PATTERNS
                      for path in (ROOT / "kaminpar_tpu_torch").rglob(pattern))


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(PORT_FILES) > 20
    bad = []
    for path in PORT_FILES:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "kaminpar_tpu"):
                bad.append(f"{path.relative_to(ROOT)}: {mod}")
        text = path.read_text()
        for needle in ("import jax", "from jax", "kaminpar_tpu.", "from kaminpar_tpu "):
            if needle in text:
                bad.append(f"{path.relative_to(ROOT)}: text {needle!r}")
    assert not bad, bad


def test_native_sources_name_no_jax_package_module():
    """The C, C++ and CUDA sources and the Makefile carry the same text
    needle as the Python files; the embedded C shim imports the port's
    bridge."""
    names = {path.name for path in NATIVE_FILES}
    assert {"lp_rate.cu", "lp_commit.cu", "warp_sort.cuh", "metis_native.cpp",
            "kaminpar_tpu_c.cc", "kaminpar_tpu_torch.h", "demo.c", "Makefile"} <= names
    bad = [str(path.relative_to(ROOT)) for path in NATIVE_FILES
           if "kaminpar_tpu." in path.read_text()]
    assert not bad, bad
    shim = (ROOT / "kaminpar_tpu_torch" / "capi" / "kaminpar_tpu_c.cc").read_text()
    assert 'PyImport_ImportModule("kaminpar_tpu_torch.capi_bridge")' in shim


def test_partitions_with_jax_unimportable():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kaminpar_tpu'] = None\n"
        "import kaminpar_tpu_torch as kp\n"
        "from kaminpar_tpu_torch.graph import generators\n"
        "g = generators.grid2d_graph(12, 12)\n"
        "s = kp.KaMinPar('fast', device='cpu')\n"
        "s.set_graph(g)\n"
        "part = s.compute_partition(2)\n"
        "assert s.last_partition.is_feasible() and part.shape == (144,)\n"
        "t = kp.KaMinPar('terapart', device='cpu')\n"
        "t.ctx.coarsening.contraction_limit = 20\n"
        "t.set_graph(g)\n"
        "part = t.compute_partition(2)\n"
        "assert t.last_partitioner.compressed_view is not None\n"
        "assert t.last_partitioner.num_levels >= 1\n"
        "assert t.last_partition.is_feasible() and part.shape == (144,)\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_device_pool_runs_with_jax_unimportable():
    """The device bipartition pool (``ops/bipartition.py``, the port's own
    copy of the JAX package's pool) is covered by the import scan and runs
    a whole partition on CPU tensors without jax."""
    assert ROOT / "kaminpar_tpu_torch" / "ops" / "bipartition.py" in PORT_FILES
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kaminpar_tpu'] = None\n"
        "import kaminpar_tpu_torch as kp\n"
        "from kaminpar_tpu_torch.graph import generators\n"
        "from kaminpar_tpu_torch.ops import bipartition\n"
        "s = kp.KaMinPar('default', device='cpu')\n"
        "s.ctx.initial_partitioning.ip_backend = 'device'\n"
        "s.set_graph(generators.grid2d_graph(16, 16))\n"
        "part = s.compute_partition(4)\n"
        "assert s.last_partition.is_feasible() and part.shape == (256,)\n"
        "assert bipartition.pool_stats_snapshot()['calls'] > 0\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_serve_tier_runs_with_jax_unimportable():
    """The serve tier (``serve/``, ``ops/lanestack.py`` and the telemetry
    modules it reads) is covered by the import scan, and an engine serves
    a lane-stacked batch and its /metrics text without jax."""
    for rel in ("serve/engine.py", "serve/lanestack.py", "serve/batching.py",
                "serve/journal.py", "serve/queue.py", "serve/stats.py", "serve/errors.py",
                "serve/__main__.py", "ops/lanestack.py", "telemetry/reqtrace.py",
                "telemetry/slo.py", "telemetry/prometheus.py", "telemetry/capacity.py",
                "utils/compile_stats.py"):
        assert ROOT / "kaminpar_tpu_torch" / rel in PORT_FILES, rel
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kaminpar_tpu'] = None\n"
        "from kaminpar_tpu_torch.graph import generators\n"
        "from kaminpar_tpu_torch.serve import PartitionEngine\n"
        "from kaminpar_tpu_torch.telemetry import prometheus\n"
        "eng = PartitionEngine('serve', device='cpu', warm_ladder=(), warm_ks=())\n"
        "eng.pause()\n"
        "eng.start(warmup=False)\n"
        "futs = [eng.submit(generators.grid2d_graph(12, 12 + i), 4) for i in range(2)]\n"
        "eng.resume()\n"
        "assert all(f.result(timeout=120).feasible for f in futs)\n"
        "assert eng.stats()['lanestacked_batches'] == 1\n"
        "prometheus.validate(eng.metrics_text())\n"
        "eng.shutdown()\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m, v in sys.modules.items() if v)\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
