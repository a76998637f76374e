"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds. Libraries land in ``build/kernels/`` beside the
package (``TFIDF_TORCH_BUILD_DIR`` overrides), named by a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built when this module is imported: the first launch
(or an explicit :func:`build_all`) builds.

A kernel that does not build or load raises :class:`KernelBuildError`,
and one whose launch is refused raises :class:`KernelLaunchError`.
Neither is classified as a compute fault: an ``nvcc`` failure or a bad
launch configuration is deterministic, and absorbing it would hide the
kernel behind the host fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")

# kernel name -> source file under csrc/
SOURCES = {"ell_score": "ell_score.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": build time or 0.0 when reused, "log": nvcc output}
build_info: dict[str, dict] = {}


class KernelBuildError(RuntimeError):
    """A kernel source did not compile, or its library did not load."""


class KernelLaunchError(RuntimeError):
    """A kernel's launch returned a CUDA error."""


def build_dir() -> str:
    return os.environ.get("TFIDF_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "kernels")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, SOURCES[name]), "rb") as f:
        src = f.read()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(build_dir(), f"lib{name}-{digest[:12]}.so")


def build_all(names=None) -> dict[str, dict]:
    """Compile every named kernel (default: all) that has no up-to-date
    library yet, one ``nvcc`` per source, all started together. Raises
    with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.isfile(out):
            build_info.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_info[name] = {"seconds": time.perf_counter() - t0,
                            "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise KernelBuildError("kernel build failed:\n"
                               + "\n".join(failed))
    return {n: build_info[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.isfile(path):
                build_all([name])
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(
                    f"kernel library {path} did not load: {e}") from e
            _libs[name] = lib
    return lib
