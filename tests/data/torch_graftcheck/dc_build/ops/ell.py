import ctypes

from tfidf_tpu_torch import kernels


def launch(x):
    lib = kernels.load("ell_score")
    return lib.ell_score_launch(x)


def launch_rebuilding(x):
    kernels.build_all(["ell_score"])
    return launch(x)


def launch_raw(x):
    lib = ctypes.CDLL("libell.so")
    return lib.ell_score_launch(x)
