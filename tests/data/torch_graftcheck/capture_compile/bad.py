import threading
import time

import torch

_CACHE = {}
_LOCK = threading.Lock()


def helper(x):
    time.perf_counter()
    return x


def kernel(x):
    _CACHE["k"] = x
    return helper(x)


def locked(x):
    with _LOCK:
        return x * 2


kernel_c = torch.compile(kernel)
locked_c = torch.compile(locked)
