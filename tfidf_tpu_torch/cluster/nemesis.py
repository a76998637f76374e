"""NemesisNet — scripted network faults at the cluster's HTTP seams.

Every chaos harness before this one kills *processes*; none breaks the
*network* — yet partitions, not crashes, are where distributed search
engines silently corrupt state (the reference's only protection is
ZooKeeper session expiry, PAPER.md §1). This module is the missing
nemesis: a transport shim consulted by the shared HTTP client seams —
``node.http_get`` / ``node.http_post`` / ``_ScatterClient.post`` (the
leader→worker data plane), ``coordination.CoordinationClient._rpc`` /
``_poll`` (the control plane), and ``ensemble._post_json`` (Raft peer
replication) — so tests script per-link faults without monkeypatching a
single call site:

- **drop** — the request never leaves the source (symmetric partitions
  compose from two one-way drops; raised as
  :class:`NemesisPartitioned`, a ``ConnectionRefusedError``, so every
  existing failure classifier treats it exactly like a dead link);
- **drop_reply** — the request IS delivered and processed, the reply is
  lost (:class:`NemesisReplyLost`, a ``ConnectionResetError``): the
  jepsen-critical ambiguous-delivery case — an acked-on-the-wire write
  whose ack never arrives;
- **delay** — injected latency (+ optional jitter) before the request
  goes out: the gray-failure generator for the latency-EWMA breaker;
- **truncate** / **corrupt** — the reply arrives damaged, exercising
  the wire layer's ValueError contract and the scatter failure paths;
- **skew** — outbound request headers are masked per link
  (:meth:`NemesisNet.filter_headers`, consulted by the same client
  seams), simulating an old-binary peer that never learned them: the
  version-skew generator for the rolling-upgrade chaos schedule
  (``make chaos-upgrade``; see cluster/protover.py).

Links are identified by ``(source endpoint, destination endpoint)``
where an endpoint is ``host:port``. Sources are stamped on the client
objects (``SearchNode.start`` sets its scatter client's and
coordination client's ``origin``; ensemble members pass
``my_address``); traffic with an unknown source matches only
wildcard-source rules. Self-links (``src == dst``) are exempt — a real
partition never cuts a node's loopback to itself.

The shim is a process-global singleton (:data:`global_nemesis`, like
``faults.global_injector``) so multi-node in-process tests script one
fault plan for the whole cluster. With no rules armed the fast path is
one tuple-emptiness check per RPC; readers never take the lock (the
rule list is replaced copy-on-write).
"""

from __future__ import annotations

import random
import threading
import time
import urllib.parse
from dataclasses import dataclass

from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.nemesis")

DROP = "drop"
DROP_REPLY = "drop_reply"
DELAY = "delay"
TRUNCATE = "truncate"
CORRUPT = "corrupt"
SKEW = "skew"


class NemesisFault(ConnectionError):
    """Base class for injected network faults (tests catch this)."""


class NemesisPartitioned(NemesisFault, ConnectionRefusedError):
    """The request never left the source: the link is partitioned.
    A ``ConnectionRefusedError`` on purpose — provably undelivered, so
    the coordination client's mutation-retry rule and the resilience
    classifiers treat it exactly like a refused TCP connect."""


class NemesisReplyLost(NemesisFault, ConnectionResetError):
    """The request WAS delivered and processed; the reply was lost.
    A ``ConnectionResetError`` on purpose — ambiguous delivery, so a
    coordination mutation must NOT blindly re-send (the write may have
    committed) while idempotent reads may retry."""


def endpoint_of(url_or_addr: str | None) -> str:
    """Normalize a URL or ``host:port`` string to the ``host:port``
    endpoint identity the rule tables key on ('' for unknown)."""
    if not url_or_addr:
        return ""
    s = url_or_addr.strip()
    if "//" in s:
        u = urllib.parse.urlparse(s)
        host = u.hostname or ""
        return f"{host}:{u.port}" if u.port else host
    return s.rstrip("/")


def _ep_set(eps) -> frozenset:
    if eps is None:
        return None
    if isinstance(eps, str):
        eps = (eps,)
    return frozenset(endpoint_of(e) for e in eps)


@dataclass(frozen=True)
class _Rule:
    rid: int
    kind: str
    src: frozenset | None       # None = any KNOWN-or-unknown source
    dst: frozenset | None       # None = any destination
    probability: float = 1.0
    delay_s: float = 0.0
    jitter_s: float = 0.0
    keep_bytes: int = 0         # truncate: reply bytes kept
    # skew: lowercased header names masked off src→dst requests (an
    # old-binary peer that never sends them)
    strip: frozenset | None = None
    # both endpoints inside this set -> the rule does not apply (an
    # isolated MINORITY keeps its internal links; see isolate())
    exempt: frozenset | None = None

    def matches(self, src: str, dst: str) -> bool:
        if src and src == dst:
            return False        # loopback-to-self is never partitioned
        if self.exempt is not None and src in self.exempt \
                and dst in self.exempt:
            return False
        if self.src is not None and src not in self.src:
            return False
        if self.dst is not None and dst not in self.dst:
            return False
        return True


class NemesisNet:
    """The scripted fault plan. All mutators replace the rule tuple
    copy-on-write under a writer lock; the per-RPC read path is
    lock-free (one attribute read + emptiness check)."""

    def __init__(self, seed: int = 0, sleep=time.sleep) -> None:
        self._lock = threading.Lock()       # writers only
        self._rules: tuple[_Rule, ...] = ()
        self._next_id = 1
        # shared across reader threads without a lock: probability and
        # jitter draws need randomness, not thread-safety guarantees
        self._rng = random.Random(seed)
        # injectable like RetryPolicy's: the delay only ever fires when
        # a chaos test ARMED a latency rule — production traffic (no
        # rules) never sleeps here, so the lockgraph pass deliberately
        # does not model armed-nemesis latency as a blocking callee
        # (same discipline as the paced-sleep allowlist precedent)
        self._sleep = sleep

    # ---- scripting API ----

    def _add(self, kind: str, src, dst, **kw) -> int:
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            rule = _Rule(rid, kind, _ep_set(src), _ep_set(dst), **kw)
            self._rules = self._rules + (rule,)
        log.info("nemesis rule armed", kind=kind, rule=rid)
        return rid

    def drop(self, src=None, dst=None, probability: float = 1.0) -> int:
        """One-way request drop: traffic src→dst never leaves src."""
        return self._add(DROP, src, dst, probability=probability)

    def drop_reply(self, src=None, dst=None,
                   probability: float = 1.0) -> int:
        """Deliver src→dst requests but lose the replies (ambiguous
        delivery — the jepsen acked-write-loss probe)."""
        return self._add(DROP_REPLY, src, dst, probability=probability)

    def delay(self, src=None, dst=None, delay_s: float = 0.05,
              jitter_s: float = 0.0, probability: float = 1.0) -> int:
        """Inject latency (+ uniform jitter) before src→dst requests."""
        return self._add(DELAY, src, dst, delay_s=delay_s,
                         jitter_s=jitter_s, probability=probability)

    def truncate(self, src=None, dst=None, keep_bytes: int = 8,
                 probability: float = 1.0) -> int:
        """Cut src→dst replies down to ``keep_bytes`` bytes."""
        return self._add(TRUNCATE, src, dst, keep_bytes=keep_bytes,
                         probability=probability)

    def corrupt(self, src=None, dst=None,
                probability: float = 1.0) -> int:
        """Flip bytes in src→dst replies (wire-validation exercise)."""
        return self._add(CORRUPT, src, dst, probability=probability)

    def skew(self, src=None, dst=None,
             strip=("X-Proto-Version",), probability: float = 1.0) -> int:
        """Version-skew: mask ``strip`` headers off src→dst requests so
        the destination sees an old-binary peer (a request with no
        ``X-Proto-Version`` is implicitly wire version 1 — see
        cluster/protover.py). The rolling-upgrade chaos schedule arms
        this per link to hold mixed-version traffic on the cluster
        while processes restart one at a time."""
        return self._add(SKEW, src, dst, probability=probability,
                         strip=frozenset(h.lower() for h in strip))

    def one_way(self, a, b) -> int:
        """Asymmetric partition: a→b requests drop; b→a flows."""
        return self.drop(src=a, dst=b)

    def partition(self, a, b) -> list[int]:
        """Symmetric partition between endpoint sets ``a`` and ``b``."""
        return [self.drop(src=a, dst=b), self.drop(src=b, dst=a)]

    def isolate(self, endpoints) -> list[int]:
        """Cut ``endpoints`` off from everyone else (both directions).
        Links WITHIN the set — including self-links — keep working: an
        isolated minority still talks among itself, like a real
        partition."""
        eps = _ep_set(endpoints)
        rules = []
        with self._lock:
            for src, dst in ((eps, None), (None, eps)):
                rid = self._next_id
                self._next_id += 1
                self._rules = self._rules + (
                    _Rule(rid, DROP, src, dst, exempt=eps),)
                rules.append(rid)
        log.info("nemesis isolation armed", endpoints=sorted(eps))
        return rules

    def remove(self, rid: int) -> None:
        with self._lock:
            self._rules = tuple(r for r in self._rules if r.rid != rid)

    def heal(self) -> None:
        """Clear every rule (the partition heals)."""
        with self._lock:
            n = len(self._rules)
            self._rules = ()
        if n:
            log.info("nemesis healed", rules_cleared=n)

    def active(self) -> bool:
        return bool(self._rules)

    # ---- the seams ----

    def check_send(self, src, dst) -> None:
        """Called by a transport seam BEFORE a request goes out. May
        raise :class:`NemesisPartitioned` (dropped link) or sleep
        (injected latency)."""
        rules = self._rules
        if not rules:
            return
        s, d = endpoint_of(src), endpoint_of(dst)
        delay = 0.0
        for r in rules:
            if r.kind not in (DROP, DELAY) or not r.matches(s, d):
                continue
            if r.probability < 1.0 and self._rng.random() > r.probability:
                continue
            if r.kind == DROP:
                global_metrics.inc("nemesis_drops")
                raise NemesisPartitioned(
                    f"nemesis: link {s or '?'} -> {d} is partitioned")
            delay += r.delay_s + (self._rng.random() * r.jitter_s
                                  if r.jitter_s > 0 else 0.0)
        if delay > 0:
            global_metrics.inc("nemesis_delays")
            self._sleep(delay)

    def filter_headers(self, src, dst, headers: dict) -> dict:
        """Called by a transport seam with the outbound request headers
        BEFORE they go out; returns the (possibly masked) headers the
        destination will actually see. Only skew rules apply — with
        none armed this returns ``headers`` untouched (same emptiness
        fast path as the other seams)."""
        rules = self._rules
        if not rules:
            return headers
        s, d = endpoint_of(src), endpoint_of(dst)
        strip: set[str] = set()
        for r in rules:
            if r.kind != SKEW or not r.matches(s, d):
                continue
            if r.probability < 1.0 and self._rng.random() > r.probability:
                continue
            strip |= r.strip or frozenset()
        if not strip:
            return headers
        masked = {k: v for k, v in headers.items()
                  if k.lower() not in strip}
        if len(masked) != len(headers):
            global_metrics.inc("nemesis_header_masks")
        return masked

    def filter_reply(self, src, dst, body: bytes) -> bytes:
        """Called by a transport seam AFTER the reply bytes arrived.
        May raise :class:`NemesisReplyLost` (the request was processed;
        its reply is gone) or return damaged bytes."""
        rules = self._rules
        if not rules:
            return body
        s, d = endpoint_of(src), endpoint_of(dst)
        for r in rules:
            if r.kind not in (DROP_REPLY, TRUNCATE, CORRUPT) \
                    or not r.matches(s, d):
                continue
            if r.probability < 1.0 and self._rng.random() > r.probability:
                continue
            if r.kind == DROP_REPLY:
                global_metrics.inc("nemesis_reply_drops")
                raise NemesisReplyLost(
                    f"nemesis: reply {d} -> {s or '?'} lost "
                    f"(request was delivered)")
            if r.kind == TRUNCATE:
                global_metrics.inc("nemesis_corruptions")
                body = body[:max(0, r.keep_bytes)]
            elif r.kind == CORRUPT:
                global_metrics.inc("nemesis_corruptions")
                head = bytes(b ^ 0x5A for b in body[:64])
                body = head + body[64:]
        return body


# Process-wide nemesis used by the library seams; tests script it.
global_nemesis = NemesisNet()
