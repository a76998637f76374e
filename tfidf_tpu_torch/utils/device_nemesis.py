"""Scriptable device nemesis: fault injection at the dispatch seams.

A copy of ``tfidf_tpu/utils/device_nemesis.py`` with the same site names,
rule grammar and env arming. The dispatch seams ``score_ell_batch``
(site ``score_ell``) and ``score_segments_batch`` (``score_segments``: the
tiered hot pass, the cold walk and the bypass oracle) in ``ops/ell.py``,
``score_coo_batch`` (``score_coo``, ``ops/scoring.py``), the dense plane
(``dense``, ``ops/dense.py``) and the tier's upload ring (``upload``,
``engine/tiering.py``: one cold segment about to cross to the card)
consult it right before launching device work, so a chaos run can inject
the failure modes a real card produces:

- ``oom``       — device allocation failure (:class:`DeviceOOMError`);
                  with ``min_batch`` set the rule fires only for query
                  batches at or above that size (B fails, B/2 succeeds:
                  the OOM backoff ladder).
- ``compile``   — kernel compilation failure (:class:`DeviceCompileError`).
- ``transient`` — a one-off runtime fault (:class:`DeviceTransientError`).
- ``poison``    — NaN-poisoned output: the seam gets a ``"poison"``
                  verdict back and corrupts, on the device, the rows of
                  queries with at least ``min_uniq`` distinct terms. No
                  exception at the dispatch site; detection happens at the
                  fetch seam (``Searcher._poison_check``).
- ``delay``     — dispatch latency (sleeps ``delay_s``).
- ``sick``      — sticky sick-device mode: once fired, EVERY guarded
                  dispatch raises :class:`DeviceSickError` until
                  :meth:`DeviceNemesis.heal`.

Rules are immutable and live in a copy-on-write tuple, so the read path of
an unarmed nemesis is an emptiness check. Env arming for subprocess chaos
harnesses::

    TFIDF_DEVICE_NEMESIS="score_ell:oom:1.0:min_batch=64,*:delay:0.5:delay_s=0.02"

(comma-separated ``site:kind[:probability[:k=v;k=v]]`` entries; ``site``
is an exact seam name or a ``prefix*`` glob, ``*`` matches every seam).

Every typed fault carries a ``compute_fault`` attribute naming its class,
which is the first thing any compute-fault classifier reads — the JAX
package's ``classify_compute_fault`` included, so a node of either package
classifies this package's faults the same way.
"""

from __future__ import annotations

import fnmatch
import itertools
import os
import threading
import time
from dataclasses import dataclass, field

from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event


class DeviceFault(RuntimeError):
    """Base for injected (and classified) compute-plane faults."""
    compute_fault = "transient"


class DeviceOOMError(DeviceFault):
    """Injected device allocation failure."""
    compute_fault = "oom"


class DeviceCompileError(DeviceFault):
    """Injected kernel compilation failure."""
    compute_fault = "compile"


class DeviceTransientError(DeviceFault):
    """Injected transient device runtime error."""
    compute_fault = "transient"


class DeviceSickError(DeviceFault):
    """Sticky sick-device mode: every dispatch fails until heal()."""
    compute_fault = "transient"


class DevicePoisonedOutput(DeviceFault):
    """Non-finite device output detected at the fetch seam.

    Carries the query strings whose result rows were poisoned, so the
    worker can report per-query blame and innocent cohort queries that
    merely shared the batch are never punished."""
    compute_fault = "poison"

    def __init__(self, queries: tuple[str, ...] = ()) -> None:
        super().__init__(
            f"non-finite device output for {len(queries)} query row(s)")
        self.queries = tuple(queries)


_KINDS = ("oom", "compile", "transient", "poison", "delay", "sick")

_RAISES = {
    "oom": lambda site: DeviceOOMError(
        f"RESOURCE_EXHAUSTED: injected device OOM at device.{site}"),
    "compile": lambda site: DeviceCompileError(
        f"injected kernel compilation failure at device.{site}"),
    "transient": lambda site: DeviceTransientError(
        f"injected transient device error at device.{site}"),
    "sick": lambda site: DeviceSickError(
        f"device sick (injected at device.{site})"),
}


@dataclass(frozen=True)
class _Rule:
    rid: int
    site: str                 # exact seam name, "prefix*", or "*"
    kind: str                 # one of _KINDS
    probability: float = 1.0
    min_batch: int = 0        # fire only when batch cap >= this
    min_uniq: int = 0         # fire only when distinct terms >= this
    count: int | None = None  # fire at most N times; None = unlimited
    delay_s: float = 0.0
    fired: list = field(default_factory=lambda: [0], compare=False)


class DeviceNemesis:
    """Copy-on-write rule set consulted by the device dispatch seams."""

    def __init__(self, env: str | None = None) -> None:
        self._lock = threading.Lock()       # writers only
        self._rules: tuple[_Rule, ...] = ()
        self._sick = False
        self._rid = itertools.count(1)
        spec = (os.environ.get("TFIDF_DEVICE_NEMESIS", "")
                if env is None else env)
        if spec:
            self.script(spec)

    # ---- writer API (copy-on-write; the read path never locks) ----

    def add_rule(self, site: str, kind: str, *, probability: float = 1.0,
                 min_batch: int = 0, min_uniq: int = 0,
                 count: int | None = None, delay_s: float = 0.0) -> int:
        if kind not in _KINDS:
            raise ValueError(f"unknown device-nemesis kind {kind!r} "
                             f"(want one of {_KINDS})")
        with self._lock:
            rid = next(self._rid)
            rule = _Rule(rid, site, kind, probability, min_batch,
                         min_uniq, count, delay_s)
            self._rules = self._rules + (rule,)
            return rid

    def remove_rule(self, rid: int) -> bool:
        with self._lock:
            keep = tuple(r for r in self._rules if r.rid != rid)
            hit = len(keep) != len(self._rules)
            self._rules = keep
            return hit

    def clear(self) -> None:
        """Drop every rule AND lift sick mode (the chaos teardown)."""
        with self._lock:
            self._rules = ()
            self._sick = False

    def heal(self) -> None:
        """Lift sticky sick mode (rules stay armed)."""
        self._sick = False

    def script(self, spec: str) -> list[int]:
        """Arm from a ``TFIDF_DEVICE_NEMESIS``-format string; returns
        the new rule ids."""
        rids = []
        for entry in spec.split(","):
            entry = entry.strip()
            if not entry:
                continue
            parts = entry.split(":")
            if len(parts) < 2:
                raise ValueError(
                    f"bad device-nemesis entry {entry!r} "
                    f"(want site:kind[:probability[:k=v;k=v]])")
            site, kind = parts[0], parts[1]
            prob = float(parts[2]) if len(parts) > 2 and parts[2] else 1.0
            kw: dict = {}
            if len(parts) > 3 and parts[3]:
                for kv in parts[3].split(";"):
                    k, _, v = kv.partition("=")
                    k = k.strip()
                    if k == "delay_s":
                        kw[k] = float(v)
                    elif k in ("min_batch", "min_uniq", "count"):
                        kw[k] = int(v)
                    else:
                        raise ValueError(
                            f"unknown device-nemesis option {k!r}")
            rids.append(self.add_rule(site, kind, probability=prob, **kw))
        return rids

    # ---- read path ----

    @property
    def armed(self) -> bool:
        return bool(self._rules) or self._sick

    @property
    def sick(self) -> bool:
        return self._sick

    def snapshot(self) -> dict:
        rules = self._rules
        return {"sick": self._sick,
                "rules": [{"rid": r.rid, "site": r.site, "kind": r.kind,
                           "probability": r.probability,
                           "min_batch": r.min_batch,
                           "min_uniq": r.min_uniq, "count": r.count,
                           "delay_s": r.delay_s, "fired": r.fired[0]}
                          for r in rules]}

    def check(self, site: str, *, batch: int = 0,
              uniq: int = 0) -> "_Rule | None":
        """Consult the rules at one dispatch seam.

        Returns the fired poison rule when a poison rule fired (the
        caller corrupts the rows its ``min_uniq`` selects via
        :func:`poison_scores`), ``None`` when nothing fired; raises the
        typed fault for oom/compile/transient/sick; sleeps for delay
        rules. Sticky sick mode fails every seam until :meth:`heal`."""
        if self._sick:
            self._fired(site, "sick")
            raise _RAISES["sick"](site)
        rules = self._rules
        if not rules:
            return None
        import random
        for r in rules:
            if r.count is not None and r.fired[0] >= r.count:
                continue
            if not (r.site == "*" or r.site == site
                    or (r.site.endswith("*")
                        and fnmatch.fnmatch(site, r.site))):
                continue
            if batch < r.min_batch:
                continue
            # min_uniq gates non-poison rules on the batch uniq hint; for
            # poison rules it is a ROW filter instead (poison_scores), so
            # the rule fires regardless of the batch-level hint
            if r.kind != "poison" and r.min_uniq and uniq < r.min_uniq:
                continue
            if r.probability < 1.0 and random.random() > r.probability:
                continue
            r.fired[0] += 1
            self._fired(site, r.kind)
            if r.kind == "delay":
                time.sleep(r.delay_s)
                continue
            if r.kind == "poison":
                return r
            if r.kind == "sick":
                self._sick = True
            raise _RAISES[r.kind](site)
        return None

    def _fired(self, site: str, kind: str) -> None:
        global_metrics.inc("device_nemesis_fired")
        span_event("fault_injected", point=f"device.{site}",
                   rule=f"device_nemesis:{kind}", action=kind)


# Process-wide nemesis consulted by the dispatch seams; chaos harnesses
# arm it directly (same process) or via TFIDF_DEVICE_NEMESIS.
global_device_nemesis = DeviceNemesis()


def device_guard(site: str, *, batch: int = 0,
                 uniq: int = 0) -> "_Rule | None":
    """The one call every guarded dispatch seam makes: the registered
    ``device.<site>`` fault point (generic injector) plus the scripted
    nemesis. Unarmed cost: two emptiness checks (the injector's rule
    dict, the nemesis' rule tuple)."""
    global_injector.check("device." + site)
    nem = global_device_nemesis
    if not nem.armed:
        return None
    return nem.check(site, batch=batch, uniq=uniq)


def poison_scores(scores, weights, min_uniq: int):
    """Corrupt a fired poison rule's target rows with NaN, on the scores'
    device (no host transfer). Rows with at least ``min_uniq`` nonzero
    term weights are poisoned (``min_uniq`` 0 poisons every row)."""
    import torch
    nan = torch.tensor(float("nan"), dtype=scores.dtype,
                       device=scores.device)
    if min_uniq <= 0:
        return torch.full_like(scores, float("nan"))
    mask = (weights > 0).sum(dim=1) >= min_uniq        # [B] on device
    return torch.where(mask[:, None], nan, scores)
