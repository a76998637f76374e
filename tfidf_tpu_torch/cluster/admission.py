"""Overload-survival front door: admission control, priority lanes,
load shedding, and generation-keyed result caching.

The reference has nothing here — its Spring endpoints accept every
request and queue unboundedly (``Leader.java:39-92``), so a 2x traffic
spike collapses latency for everyone. This module gives the leader an
explicit admission layer, threaded through the ``/leader/*`` handlers
in :mod:`tfidf_tpu_torch.cluster.node`:

- :class:`TokenBucket` / :class:`AdmissionController` — per-client
  token-bucket admission (client id from the ``X-Client-Id`` header or
  the peer IP) with an explicit shed path: a rejected request gets
  ``429`` + ``Retry-After`` instead of a queue slot, so the client
  learns to back off while admitted requests keep their latency.
- priority lanes — ``interactive`` (default) vs ``bulk`` (selected by
  the ``X-Priority: bulk`` header; uploads default to bulk). Under
  backpressure bulk sheds FIRST; the scatter coalescer's weighted
  dequeue (:mod:`tfidf_tpu_torch.cluster.batcher`) guarantees bulk can never
  starve interactive inside an admitted batch either.
- backpressure — keyed on the scatter queue depth: the max of the
  ``last_scatter_queue_depth`` gauge the coalescer already publishes
  (the same signal the k8s HPA scales on) and the coalescer's live
  ``backlog()`` (the gauge is only refreshed at batch formation, so it
  freezes while every dispatcher is blocked in a stalled RPC — the
  live read keeps shedding honest through the stall). Above
  ``admission_queue_high_water`` the bulk lane sheds, above
  ``admission_queue_critical`` interactive sheds too. ``/api/health``
  and ``/api/metrics`` never pass through admission at all (the
  reserved observability lane), so operators can see a shedding
  cluster.
- :class:`ResultCache` — a leader-side query-result cache keyed by the
  node's df-signature + commit-generation token
  (:meth:`SearchNode.df_signature`): every mutation the leader
  orchestrates (confirmed upload legs, reconcile deletes, migration
  flips, membership transitions) advances the token, so a stale entry
  can never be served — correctness falls out of the same version
  plumbing that keys the engine's segment view cache, no TTLs
  involved. Degraded (possibly-incomplete) responses are never cached.
  The invalidation boundary is the cluster's WRITE CONTRACT: mutations
  flow through the leader's ``/leader/*`` front door. A direct
  ``/worker/*`` write on a multi-node topology bypasses the leader's
  placement/replication bookkeeping (the doc lands unmapped and
  unreplicated) and its cache invalidation alike — the worker-side
  ``bump_result_generation`` covers the single-node and dual-role
  deployments where that worker IS the leader.

Metrics: ``admission_admitted``, ``admission_shed_total``,
``admission_shed_rate_limited``, ``admission_shed_backpressure``,
per-lane ``admission_shed_{lane}``, gauges ``admission_last_depth`` /
``admission_clients``; ``cache_hits``, ``cache_misses``,
``cache_evictions``, ``cache_invalidations``, gauge ``cache_entries``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event

log = get_logger("cluster.admission")

# the two request lanes. Interactive is the default for searches; bulk
# is selected by the ``X-Priority: bulk`` header and is the default for
# uploads. Health/metrics endpoints have no lane: they are served
# outside admission entirely (the reserved observability path).
LANE_INTERACTIVE = "interactive"
LANE_BULK = "bulk"


@dataclass(frozen=True)
class AdmissionDecision:
    """One request's verdict. ``retry_after_s`` is the client's backoff
    hint (the 429 reply's ``Retry-After`` header); ``reason`` is the
    shed cause (``rate_limited`` | ``backpressure``) or ``""`` when
    admitted."""
    admitted: bool
    retry_after_s: float = 0.0
    reason: str = ""


_ADMIT = AdmissionDecision(True)


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/second refill up to
    ``burst`` capacity; each admitted request spends one token.

    ``try_take()`` returns 0.0 on admit, else the seconds until one
    token will be available (the ``Retry-After`` hint — honest, not a
    constant: a client that waits exactly that long is admitted)."""

    __slots__ = ("rate", "burst", "_tokens", "_t", "_lock")

    def __init__(self, rate: float, burst: float,
                 clock=time.monotonic) -> None:
        self.rate = rate
        self.burst = max(burst, 1.0)
        self._tokens = self.burst
        self._t = clock()
        self._lock = threading.Lock()

    def try_take(self, now: float) -> float:
        with self._lock:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


class AdmissionController:
    """The leader's front door. ``admit(client, lane)`` decides one
    request's fate from (a) the scatter queue-depth backpressure signal
    and (b) the client's token bucket.

    Shedding order under backpressure: bulk first (at the high-water
    mark), then interactive (at the critical mark) — never the
    health/metrics endpoints, which are not admission-controlled at
    all. Per-client buckets are bounded by ``admission_max_clients``
    (LRU eviction: memory safety for a million distinct client ids; an
    evicted flooder merely restarts with a full burst, which the depth
    backpressure still bounds)."""

    def __init__(self, config, depth_fn, clock=time.monotonic,
                 name: str = "") -> None:
        """``name`` identifies WHICH front door this controller guards
        (the stateless router tier passes ``router``) — surfaced in
        :meth:`snapshot` for /api/health. Metric names stay identical
        across tiers on purpose: each router is its own process, so
        Prometheus separates tiers by scrape target, not by series
        name (the per-router queue-depth gauge the HPA consumes is
        already distinct via the coalescer name)."""
        self.name = name
        self.enabled = config.admission_enabled
        self.rate_qps = config.admission_rate_qps
        self.burst = (config.admission_burst
                      or 2.0 * config.admission_rate_qps)
        self.high_water = config.admission_queue_high_water
        self.critical = config.admission_queue_critical
        self.retry_after_s = config.admission_retry_after_s
        self.max_clients = max(1, config.admission_max_clients)
        self._depth_fn = depth_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()

    def _bucket(self, client: str) -> TokenBucket:
        with self._lock:
            b = self._buckets.get(client)
            if b is None:
                b = self._buckets[client] = TokenBucket(
                    self.rate_qps, self.burst, clock=self._clock)
                while len(self._buckets) > self.max_clients:
                    self._buckets.popitem(last=False)
                global_metrics.set_gauge("admission_clients",
                                         len(self._buckets))
            else:
                self._buckets.move_to_end(client)
            return b

    def _shed(self, lane: str, reason: str,
              retry_after_s: float) -> AdmissionDecision:
        global_metrics.inc("admission_shed_total")
        global_metrics.inc(f"admission_shed_{reason}")
        global_metrics.inc(f"admission_shed_{lane}")
        # the request span is already active (minted at the handler's
        # admission point), so a shed is visible in its trace
        span_event("shed", reason=reason, lane=lane,
                   retry_after_s=round(retry_after_s, 3))
        return AdmissionDecision(False, retry_after_s, reason)

    def admit(self, client: str,
              lane: str = LANE_INTERACTIVE) -> AdmissionDecision:
        if not self.enabled:
            return _ADMIT
        global_injector.check("leader.admission")
        depth = float(self._depth_fn() or 0.0)
        global_metrics.set_gauge("admission_last_depth", depth)
        # backpressure first: a saturated pipeline sheds regardless of
        # any single client's budget — bulk at the high-water mark,
        # interactive only past critical
        if self.critical > 0 and depth >= self.critical:
            return self._shed(lane, "backpressure", self.retry_after_s)
        if (self.high_water > 0 and depth >= self.high_water
                and lane == LANE_BULK):
            return self._shed(lane, "backpressure", self.retry_after_s)
        if self.rate_qps > 0:
            wait = self._bucket(client).try_take(self._clock())
            if wait > 0.0:
                return self._shed(lane, "rate_limited", wait)
        global_metrics.inc("admission_admitted")
        return _ADMIT

    def snapshot(self) -> dict:
        """Operator view for /api/health (lock-light: counts only)."""
        with self._lock:
            n = len(self._buckets)
        return {"enabled": self.enabled, "front_door": self.name,
                "rate_qps": self.rate_qps,
                "burst": self.burst, "queue_high_water": self.high_water,
                "queue_critical": self.critical, "clients_tracked": n}


class ResultCache:
    """Generation-keyed LRU query-result cache.

    Every entry is stamped with the df-signature token current when its
    scatter was DISPATCHED; ``get`` returns it only while the node's
    token is unchanged. Any commit that could change a score — upsert,
    delete, migration flip, membership transition — advances the token,
    so staleness is impossible by construction (the invalidation rides
    the same version plumbing that keys the engine's segment view
    cache; there is no TTL to tune and no explicit invalidation call to
    forget). A stale entry found under a newer token is evicted on
    touch and counted as ``cache_invalidations``."""

    def __init__(self, max_entries: int) -> None:
        self.max_entries = max(1, max_entries)
        self._lock = threading.Lock()
        self._entries: OrderedDict[object, tuple[object, object]] = \
            OrderedDict()

    def get(self, key, token):
        """The cached value for ``key`` at generation ``token``, or
        None (counted as a miss; a generation mismatch also counts as
        an invalidation and evicts the dead entry)."""
        with self._lock:
            e = self._entries.get(key)
            if e is None:
                global_metrics.inc("cache_misses")
                return None
            if e[0] != token:
                del self._entries[key]
                global_metrics.inc("cache_invalidations")
                global_metrics.inc("cache_misses")
                global_metrics.set_gauge("cache_entries",
                                         len(self._entries))
                return None
            self._entries.move_to_end(key)
            global_metrics.inc("cache_hits")
            return e[1]

    def put(self, key, token, value) -> None:
        with self._lock:
            self._entries[key] = (token, value)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                global_metrics.inc("cache_evictions")
            global_metrics.set_gauge("cache_entries", len(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)
