import threading
import time

import torch

from tfidf_tpu_torch.utils.metrics import global_metrics

_LOCK = threading.Lock()


@torch.compile(mode="reduce-overhead")
def decorated(x):
    time.time()
    return x


@torch.jit.script
def scripted(x):
    time.monotonic()
    return x


def traced(x):
    global_metrics.inc("traced")
    return x


traced_fn = torch.jit.trace(traced, torch.zeros(2))
lam = torch.compile(lambda x: x + time.time())


def graphed(x):
    time.sleep(0)
    return x


graphed_fns = torch.cuda.make_graphed_callables(graphed, (torch.zeros(2),))


class Runner:
    def __init__(self):
        self._lock = threading.Lock()

    def capture(self, g, x):
        with torch.cuda.graph(g):
            with self._lock:
                y = x * 2
        return y

    def capture_raw(self, g, x):
        g.capture_begin()
        global_metrics.inc("captured")
        g.capture_end()
        return x
