"""Fault injection: named fault points a test or chaos harness can arm.

A copy of ``tfidf_tpu/utils/faults.py`` holding the points this package
fires: the checkpoint publish window, the durable-IO seam
(:mod:`tfidf_tpu_torch.utils.storage`) and the device dispatch seams
(:mod:`tfidf_tpu_torch.utils.device_nemesis`). The names are the JAX
package's, so one chaos config arms both packages. Arming a name ending
in ``*`` matches any point with that prefix.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from tfidf_tpu_torch.utils.tracing import span_event

# Registry of every fault point this package fires: name -> where.
KNOWN_FAULT_POINTS: dict[str, str] = {
    "checkpoint.pre_publish": "checkpoint written but not yet published "
                              "(crash window)",
    "storage.write": "durable-IO seam about to write a file's bytes "
                     "(utils/storage.py; torn-write / ENOSPC window)",
    "storage.fsync": "durable-IO seam about to fsync a file or "
                     "directory (the fsync-EIO window)",
    "storage.read": "durable-IO seam reading a durable file back "
                    "(the bit-rot window — damage here is silent "
                    "unless a checksum catches it)",
    "storage.rename": "durable-IO seam about to atomically publish "
                      "via rename (crash-before/after-rename window)",
    "device.score_ell": "ELL scoring dispatch seam (ops/ell.py "
                        "score_ell_batch) — the device nemesis' primary "
                        "injection point",
    "device.score_coo": "COO scoring dispatch seam "
                        "(ops/scoring.py score_coo_batch)",
}


class FaultInjected(RuntimeError):
    pass


@dataclass
class _Rule:
    action: str            # "raise" | "delay" | "callable"
    probability: float = 1.0
    delay_s: float = 0.0
    remaining: int | None = None   # fire at most N times; None = unlimited
    fn: object = None


class FaultInjector:
    def __init__(self, seed: int | None = None) -> None:
        self._rules: dict[str, _Rule] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.fired: dict[str, int] = {}

    def arm(self, point: str, action: str = "raise", probability: float = 1.0,
            delay_s: float = 0.0, times: int | None = None,
            fn=None) -> None:
        with self._lock:
            self._rules[point] = _Rule(action, probability, delay_s, times, fn)

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)

    def _match(self, point: str) -> tuple[str, _Rule] | None:
        """Exact rule first, then any armed ``prefix*`` wildcard."""
        rule = self._rules.get(point)
        if rule is not None:
            return point, rule
        for key, r in self._rules.items():
            if key.endswith("*") and point.startswith(key[:-1]):
                return key, r
        return None

    def check(self, point: str) -> None:
        if not self._rules:   # unarmed: one emptiness check, no lock
            return
        with self._lock:
            hit = self._match(point)
            if hit is None:
                return
            key, rule = hit
            if rule.remaining is not None:
                if rule.remaining <= 0:
                    return
            if self._rng.random() > rule.probability:
                return
            if rule.remaining is not None:
                rule.remaining -= 1
            # fires are counted under the RULE's name so wildcard chaos
            # configs can assert totals without enumerating instances
            self.fired[key] = self.fired.get(key, 0) + 1
            action, delay_s, fn = rule.action, rule.delay_s, rule.fn
        span_event("fault_injected", point=point, rule=key,
                   action=action)
        if action == "delay":
            time.sleep(delay_s)
        elif action == "callable" and fn is not None:
            fn()
        elif action == "raise":
            raise FaultInjected(f"fault injected at {point!r}")


# Process-wide injector used by library fault points; tests arm/disarm it.
global_injector = FaultInjector()


def fault_point(name: str) -> None:
    """Call at a named site; no-op unless a test armed this point."""
    global_injector.check(name)
