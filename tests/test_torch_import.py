"""The port's import closure: no jax, nothing of tfidf_tpu, no CUDA."""

import ast
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


def test_whole_port_imports_with_jax_blocked():
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert int(r.stdout.split("LOADED")[1].split()[0]) >= 20
    loaded = set(r.stdout.split("HAS")[1].split())
    for mod in WORKER_MODULES + CLUSTER_MODULES:
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


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module)
    return roots


def test_port_and_chip_smoke_never_import_jax_or_the_reference():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _dirs, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_roots(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "tfidf_tpu"), (path, mod)


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
