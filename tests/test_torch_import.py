"""The port's import closure: no jax, nothing of tfidf_tpu, no CUDA."""

import ast
import glob
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tfidf_tpu_torch")

_IMPORT_ALL = r"""
import sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.modules["tfidf_tpu"] = None    # and so does the reference package
import importlib, pkgutil
import tfidf_tpu_torch
for m in pkgutil.walk_packages(tfidf_tpu_torch.__path__,
                               "tfidf_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "tfidf_tpu") and sys.modules[k] is not None
             or k.startswith(("jax.", "jaxlib", "tfidf_tpu.")))
print("LOADED", len([k for k in sys.modules
                     if k.startswith("tfidf_tpu_torch")]))
print("BAD", bad)
print("HAS", " ".join(sorted(k for k in sys.modules
                             if k.startswith("tfidf_tpu_torch."))))
"""

# the worker-engine and dense-plane slices' modules, each of which must be
# in the closure
WORKER_MODULES = ("utils.faults", "utils.storage", "utils.device_nemesis",
                  "native", "cluster.resilience", "engine.checkpoint",
                  "engine.compute_health", "engine.embedder", "engine.dense",
                  "ops.dense")

# the cluster-and-CLI slice's modules
CLUSTER_MODULES = ("cluster", "cluster.admission", "cluster.autopilot",
                   "cluster.batcher", "cluster.coordination",
                   "cluster.election", "cluster.ensemble", "cluster.fencing",
                   "cluster.fusion", "cluster.nemesis", "cluster.node",
                   "cluster.placement", "cluster.protover",
                   "cluster.quarantine", "cluster.rebalance",
                   "cluster.registry", "cluster.resilience",
                   "cluster.router", "cluster.wal", "cluster.wire", "cli",
                   "__main__")


# the streaming-segments and tiering slice's modules
SEGMENT_MODULES = ("ops.blockmax", "ops.dfdelta", "engine.segments",
                   "engine.tiering")

# the device mesh slice's modules
MESH_MODULES = ("parallel", "parallel.mesh", "parallel.collectives",
                "parallel.sharded", "parallel.mesh_index",
                "parallel.mesh_ell", "parallel.mesh_ell_index",
                "parallel.mesh_dense")

# the bench slice's modules
BENCH_MODULES = ("bench", "bench_modes", "utils.textgen")

# the port's graftcheck (its static analysis and runtime witnesses)
TOOLS_MODULES = tuple(f"tools.graftcheck.{m}" for m in (
    "core", "lockgraph", "jitpurity", "devicecheck", "registry_drift",
    "resilience", "wallclock", "protocol", "deadsymbols", "storageseam",
    "witness", "protocol_witness", "device_witness", "__main__")) + (
    "tools", "tools.graftcheck")


def test_whole_port_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED")[1].split()[0]) >= 20
    loaded = set(r.stdout.split("HAS")[1].split())
    for mod in (WORKER_MODULES + CLUSTER_MODULES + SEGMENT_MODULES
                + MESH_MODULES + BENCH_MODULES + TOOLS_MODULES):
        assert f"tfidf_tpu_torch.{mod}" in loaded, mod


def test_worker_modules_import_with_jax_blocked():
    """Each module of the worker-engine and dense-plane slices imports on
    its own with ``jax`` blocked and loads nothing of ``tfidf_tpu``; none
    builds the native library or a kernel at import."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "print(sorted(k for k in sys.modules "
            "if k == 'tfidf_tpu' or k.startswith('tfidf_tpu.')))\n"
            "import tfidf_tpu_torch.native as n\n"
            "print(n._tried, n._lib)\n")
    r = subprocess.run([sys.executable, "-c", code, *WORKER_MODULES],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[:2] == ["[]", "False None"], r.stdout


def test_cluster_modules_import_with_jax_blocked():
    """Each module of the cluster plane and the CLI imports on its own
    with ``jax`` and ``tfidf_tpu`` blocked, and importing them starts no
    CLI run, builds no native library and touches no CUDA state."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfidf_tpu'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "import torch, tfidf_tpu_torch.native as n\n"
            "print(n._lib, torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code, *CLUSTER_MODULES],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "None False", r.stdout


def test_segment_modules_import_with_jax_blocked():
    """Each module of the streaming-segments slice imports on its own with
    ``jax`` and ``tfidf_tpu`` blocked, loads nothing of ``tfidf_tpu``, and
    importing it creates no CUDA stream, builds nothing and touches no
    CUDA state."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfidf_tpu'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "import torch, tfidf_tpu_torch.native as n\n"
            "print(sorted(k for k in sys.modules if k == 'tfidf_tpu' "
            "and sys.modules[k] is not None or k.startswith('tfidf_tpu.')),"
            " n._lib, torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code, *SEGMENT_MODULES],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] None False", r.stdout


def test_mesh_modules_import_with_jax_blocked():
    """Each module of the mesh slice imports on its own with ``jax`` and
    ``tfidf_tpu`` blocked, loads nothing of ``tfidf_tpu``, and importing
    it starts no process group and touches no CUDA state."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfidf_tpu'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "import torch, torch.distributed as dist\n"
            "print(sorted(k for k in sys.modules if k == 'tfidf_tpu' "
            "and sys.modules[k] is not None or k.startswith('tfidf_tpu.')),"
            " dist.is_initialized(), torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code, *MESH_MODULES],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] False False", r.stdout


def test_bench_modules_import_with_jax_blocked():
    """The bench, its modes and the corpus generator import on their own
    with ``jax``, ``tfidf_tpu``, the root ``bench.py`` and
    ``kernel_parity.py`` blocked, load nothing of ``tfidf_tpu``, and
    importing them builds no kernel, starts no process and touches no
    CUDA state."""
    code = ("import sys, importlib\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['tfidf_tpu'] = None\n"
            "sys.modules['bench'] = None\n"
            "sys.modules['kernel_parity'] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "import torch\n"
            "from tfidf_tpu_torch import kernels\n"
            "print(sorted(k for k in sys.modules if k == 'tfidf_tpu' "
            "and sys.modules[k] is not None or k.startswith('tfidf_tpu.')),"
            " kernels.build_count(), torch.cuda.is_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code, *BENCH_MODULES],
                       cwd=ROOT, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[] 0 False", r.stdout


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


def test_graftcheck_modules_import_alone():
    """The port's graftcheck imports with ``jax``, ``tfidf_tpu`` and the
    root ``tools`` package all blocked, and its static passes load no
    torch: they parse the port, never import it."""
    static = [m for m in TOOLS_MODULES if not m.endswith(
        ("witness", "__main__"))]
    code = ("import sys, importlib\n"
            "for blocked in ('jax', 'tfidf_tpu', 'tools'):\n"
            "    sys.modules[blocked] = None\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module('tfidf_tpu_torch.' + m)\n"
            "print('torch' in sys.modules)\n"
            "import tfidf_tpu_torch.tools.graftcheck.device_witness\n"
            "import tfidf_tpu_torch.tools.graftcheck.witness\n"
            "import tfidf_tpu_torch.tools.graftcheck.protocol_witness\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'tfidf_tpu', 'tools') and sys.modules[k] is not None))"
            "\n")
    r = subprocess.run([sys.executable, "-c", code, *static], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "[]"], r.stdout


def test_port_and_chip_smoke_never_import_jax_or_the_reference():
    """Nor the port's root probes (``probe_*_torch.py``, and the three
    that run a part of ``chip_smoke.py`` alone)."""
    probes = sorted(glob.glob(os.path.join(ROOT, "probe_*_torch.py")))
    assert len(probes) >= 3, probes
    probes += [os.path.join(ROOT, f"probe_{p}.py")
               for p in ("streaming", "fleet", "client_stalls")]
    files = [os.path.join(ROOT, "chip_smoke.py"), *probes]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_roots(path):
            top = mod.split(".")[0]
            # nor the root bench.py or kernel_parity.py (which import
            # jax), nor the root tools/ (the JAX package's graftcheck)
            assert top not in ("jax", "jaxlib", "tfidf_tpu", "bench",
                               "kernel_parity", "tools"), (path, mod)


def test_package_init_is_light():
    """Importing the package loads neither torch nor CUDA state."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, tfidf_tpu_torch; print('torch' in sys.modules)"],
        cwd=ROOT, capture_output=True, text=True, timeout=60,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0 and r.stdout.strip() == "False", r


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result
    line; alone in a directory (no package beside it) it fails too."""
    if _cuda():
        return _chip_smoke_alone(tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    _chip_smoke_alone(tmp_path)


def _chip_smoke_alone(tmp_path):
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _cuda():
    import torch
    return torch.cuda.is_available()
