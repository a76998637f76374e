"""Poison-query quarantine — the leader/router's memory of queries
that kill devices.

A poisoned output (NaN rows detected at the fetch seam) is a property
of the (query, plan) pair meeting a kernel bug or pathological shape —
NOT of the worker that happened to score it. Retrying or failing over
such a query marches it through the replica set, taking a device down
at every stop (the classic query-of-death cascade). The quarantine
breaks that march: after compute faults on ``poison_quarantine_after``
DISTINCT replicas (one replica could just be a sick device; two
independent devices agreeing indicts the query), the fingerprint is
quarantined and the router answers 422 + ``X-Poison-Quarantined``
without touching any worker.

Wire fingerprint: the worker stamps the offending queries' fingerprints
in ``X-Poison-Fingerprints`` (computed next to the detection), the
router blames per-worker and checks admission per-query with the SAME
function — so worker and router can never disagree on identity.

Entries expire (TTL) — a rolled binary or fixed kernel deserves a
retry — and the table is a bounded LRU, so a hostile query stream
cannot grow it without bound. ``resilience.classify_compute_fault``
guarantees poison is never folded into network-fault accounting.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import OrderedDict

from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event

log = get_logger("cluster.quarantine")


def poison_fingerprint(query: str, mode: str = "sparse") -> str:
    """Stable 12-hex fingerprint of a (query, plan) pair. ``mode`` is
    the serving plan (sparse | dense | hybrid) — the same text can be
    fine on one plane and poisonous on another, so the plan is part of
    the identity."""
    h = hashlib.sha1(f"{mode}\x00{query}".encode("utf-8", "replace"))
    return h.hexdigest()[:12]


class _Entry:
    __slots__ = ("workers", "quarantined_at", "touched_at")

    def __init__(self, now: float) -> None:
        self.workers: set[str] = set()
        self.quarantined_at: float | None = None
        self.touched_at = now


class PoisonQuarantine:
    """Bounded, TTL'd LRU of poison-fingerprint verdicts.

    Thread-safe: the router's merge loop blames from scatter worker
    threads while admission checks run on request threads.
    """

    def __init__(self, *, after: int = 2, ttl_s: float = 300.0,
                 max_entries: int = 256,
                 clock=time.monotonic) -> None:
        self.after = max(1, int(after))
        self.ttl_s = float(ttl_s)
        self.max_entries = max(1, int(max_entries))
        self._clock = clock
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, _Entry] = OrderedDict()

    # ---- internal ----

    def _get(self, fp: str, now: float) -> _Entry:
        e = self._entries.get(fp)
        if e is not None and now - e.touched_at > self.ttl_s:
            del self._entries[fp]
            e = None
        if e is None:
            e = _Entry(now)
            self._entries[fp] = e
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)   # evict LRU
        else:
            self._entries.move_to_end(fp)
            e.touched_at = now
        return e

    # ---- writer: per-worker blame from the scatter merge ----

    def note_fault(self, fp: str, worker: str) -> bool:
        """Record a compute fault for ``fp`` observed on ``worker``.
        Returns True when this observation CROSSES the replica-distinct
        threshold (the quarantine moment — log/trace once, not per
        subsequent hit)."""
        now = self._clock()
        with self._lock:
            e = self._get(fp, now)
            e.workers.add(worker)
            if (e.quarantined_at is None
                    and len(e.workers) >= self.after):
                e.quarantined_at = now
                global_metrics.inc("poison_quarantined")
                span_event("poison.quarantined", fingerprint=fp,
                           replicas=len(e.workers))
                log.warning("poison query quarantined",
                            fingerprint=fp, replicas=len(e.workers))
                return True
        return False

    # ---- reader: admission ----

    def is_quarantined(self, fp: str) -> bool:
        now = self._clock()
        with self._lock:
            e = self._entries.get(fp)
            if e is None or e.quarantined_at is None:
                return False
            if now - e.touched_at > self.ttl_s:
                del self._entries[fp]
                return False
            # a hit keeps the verdict warm: an actively re-sent poison
            # query must not slip back in just by persisting past TTL/2
            e.touched_at = now
            self._entries.move_to_end(fp)
            return True

    # ---- ops surface (/api/quarantine, CLI inspect/clear) ----

    def snapshot(self) -> dict:
        now = self._clock()
        with self._lock:
            live = {fp: e for fp, e in self._entries.items()
                    if now - e.touched_at <= self.ttl_s}
            return {
                "after": self.after,
                "ttl_s": self.ttl_s,
                "max_entries": self.max_entries,
                "tracked": len(live),
                "quarantined": [
                    {"fingerprint": fp,
                     "replicas": sorted(e.workers),
                     "age_s": round(now - (e.quarantined_at or now), 3)}
                    for fp, e in live.items()
                    if e.quarantined_at is not None],
            }

    def clear(self) -> int:
        """Drop every entry (operator override after a fix rolls out);
        returns how many were quarantined."""
        with self._lock:
            n = sum(1 for e in self._entries.values()
                    if e.quarantined_at is not None)
            self._entries.clear()
        if n:
            log.info("poison quarantine cleared", dropped=n)
        return n
