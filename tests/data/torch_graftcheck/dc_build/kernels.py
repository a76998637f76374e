import ctypes
import subprocess

_libs = {}


def build_all(names=None):
    subprocess.run(["nvcc", "-o", "lib.so", "k.cu"], check=True)


def load(name):
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL("lib.so")
    return lib
