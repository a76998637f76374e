"""The boot split of a ``serve`` process: where its seconds go before it
serves.

``python -m tfidf_tpu_torch serve`` starts the interpreter and imports the
CLI, imports ``torch``, creates the CUDA context, loads the hand-written
kernel library, then restores its checkpoint and starts the node.
:class:`BootClock` times each of those steps where it happens, and
:meth:`BootClock.line` gives one ``boot split {...}`` line (JSON, seconds)
that the CLI prints when the node is up. ``chip_smoke.py`` reads that line
from every node's log in its fleet phase.

Keys: ``before_cmd_s`` (process start to the command: the interpreter and
the CLI's light imports), ``torch_import_s``, ``cuda_context_s`` and
``kernel_load_s`` (the card only; the library's first load, which builds
it when no library is in the build directory), ``up_s`` (process start to
the node answering) and ``rest_s`` (``up_s`` less the four: the node's
modules, the restore, the node's start). Process start is read from
``/proc``; where it cannot be read the ages are None.
"""

from __future__ import annotations

import json
import os
import sys
import time

STEPS = ("before_cmd_s", "torch_import_s", "cuda_context_s",
         "kernel_load_s")


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``, 10 ms
    resolution), else None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class BootClock:
    """Created as the command starts; each method times one step."""

    def __init__(self) -> None:
        self.split: dict = {"before_cmd_s": process_age_s()}

    def torch_import(self) -> None:
        """Import torch, timed (0.0 when something imported it first)."""
        already = "torch" in sys.modules
        t = time.perf_counter()
        import torch  # noqa: F401
        self.split["torch_import_s"] = (
            0.0 if already else time.perf_counter() - t)

    def device(self, device, kernel: bool) -> None:
        """On the card: create the CUDA context, then (``kernel``: the
        engine scores through the ELL kernel) load the kernel library,
        each timed. Nothing on the CPU."""
        if device.type != "cuda":
            return
        import torch
        t = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        self.split["cuda_context_s"] = time.perf_counter() - t
        if kernel:
            from tfidf_tpu_torch import kernels
            t = time.perf_counter()
            kernels.load("ell_score")
            self.split["kernel_load_s"] = time.perf_counter() - t

    def line(self) -> str:
        """``boot split {...}``: the steps so far, ``up_s`` and
        ``rest_s``."""
        split = dict(self.split)
        up = process_age_s()
        split["up_s"] = up
        if up is not None and split["before_cmd_s"] is not None:
            split["rest_s"] = up - sum(split.get(k) or 0.0 for k in STEPS)
        return "boot split " + json.dumps(split, sort_keys=True)
