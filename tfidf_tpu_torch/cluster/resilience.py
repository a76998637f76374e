"""Cluster resilience primitives: retry policy + per-worker circuit breakers.

The reference's only failure machinery is the ZooKeeper session timeout
(the failure detector) plus swallow-and-continue scatter tolerance
(``Leader.java:67-69``). That detects *death* but not *degradation*: a
slow or flapping worker is retried at full cost on every RPC forever, and
a transient blip fails a request that one cheap retry would have saved.
This module adds the two missing disciplines, used by every leader→worker
RPC path in :mod:`tfidf_tpu_torch.cluster.node` and the coordination client's
heartbeat/long-poll loops in :mod:`tfidf_tpu_torch.cluster.coordination`:

- :class:`RetryPolicy` — bounded attempts, exponential backoff with
  jitter, an overall deadline, and a retryable-error classifier so only
  *transient* failures are retried (connection resets, 5xx) while
  application rejections (4xx) and timeouts propagate immediately.
- :class:`CircuitBreaker` / :class:`BreakerBoard` — per-worker
  closed → open → half-open breakers: after N consecutive failures the
  leader stops paying the connect/timeout cost for a sick worker and
  fast-fails (degraded, counted honestly) until a half-open probe
  succeeds.

Fault points (``tfidf_tpu_torch.utils.faults``) cover every decision site —
``resilience.backoff`` before each retry sleep, ``resilience.breaker_trip``
when a breaker opens, ``resilience.breaker_probe`` when a half-open probe
is admitted — so the chaos suite can count and bound them.
"""

from __future__ import annotations

import http.client
import random
import socket
import threading
import time
import urllib.error
from concurrent.futures import wait as _futures_wait
from typing import Callable

from tfidf_tpu_torch.utils.faults import FaultInjected, global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event

log = get_logger("cluster.resilience")


class RpcStatusError(RuntimeError):
    """A worker answered with a non-2xx status. Carrying the status as
    data (instead of string-matching ``repr``) lets the retry classifier
    distinguish gateway-transient statuses (retryable) from application
    rejections and deterministic server failures (not).

    ``deadline_exceeded`` marks a 504 that is a DEADLINE refusal — the
    worker (or the leader's own pre-dispatch check) declining to start
    work whose caller budget is already spent. Unlike a gateway 504 it
    is never retried (the budget cannot come back) and never indicts
    the worker (refusing honestly is healthy behavior).

    ``retry_after_s`` carries a 429 shed reply's ``Retry-After`` header
    (the admission layer's honest back-off hint): the retry policy
    never re-attempts BEFORE it has elapsed — see
    :func:`retry_after_of`.

    ``fenced`` marks the distinct leadership-fence rejection (403 +
    ``X-Fence-Rejected: 1``, cluster/fencing.py): the caller's leader
    epoch is STALE — a newer leader exists. Never retried (the epoch
    cannot grow back) and never a worker fault (refusing a deposed
    leader is the worker doing its job); the leader's correct reaction
    is to step down (``SearchNode._fence_step_down``).

    ``proto`` marks the distinct wire-protocol rejection (426 +
    ``X-Proto-Rejected: 1``, cluster/protover.py): the caller's
    declared wire version is below the handler's compat floor. Never
    retried (a binary's version cannot grow back mid-flight) and never
    a worker fault (refusing an out-of-window peer during a rolling
    upgrade is the handler doing its job — a breaker that opened on it
    would amplify a routine upgrade into an outage)."""

    def __init__(self, url: str, status: int,
                 deadline_exceeded: bool = False,
                 retry_after_s: float | None = None,
                 fenced: bool = False,
                 proto: bool = False,
                 compute_fault: str | None = None,
                 poison_fps: tuple[str, ...] = ()) -> None:
        super().__init__(f"{url} -> {status}"
                         + (" (deadline exceeded)" if deadline_exceeded
                            else "")
                         + (" (fenced: stale leader epoch)" if fenced
                            else "")
                         + (" (proto: version outside compat window)"
                            if proto else "")
                         + (f" (compute fault: {compute_fault})"
                            if compute_fault else ""))
        self.url = url
        self.status = status
        self.deadline_exceeded = deadline_exceeded
        self.retry_after_s = retry_after_s
        self.fenced = fenced
        self.proto = proto
        # ``X-Compute-Fault`` reply header: the worker's DEVICE failed
        # (oom/compile/transient/poison taxonomy below), not its
        # process or the network. Never retried (the same batch would
        # hit the same device state — the retry storm the taxonomy
        # exists to prevent); a poison fault additionally never indicts
        # the worker (the QUERY is at fault, and the leader's
        # quarantine — not the breaker — is the right response).
        self.compute_fault = compute_fault
        # ``X-Poison-Fingerprints``: per-query blame for a poison fault
        # (cluster/quarantine.py fingerprints), so a coalesced batch's
        # innocent cohort is never quarantined alongside the poison
        # query.
        self.poison_fps = tuple(poison_fps)


class CircuitOpenError(RuntimeError):
    """Fast-fail: the target worker's breaker is open (or its single
    half-open probe slot is taken). No RPC was attempted."""


class DeadlineExpired(RuntimeError):
    """The caller's budget ran out BEFORE dispatch — no RPC was made.
    Never retried, and (unlike a worker's 504 deadline refusal, which
    proves the worker alive) it carries NO evidence about the target:
    ``worker_call`` releases the breaker without recording success or
    failure."""


# connection-level failures: the peer is unreachable or the socket died.
_CONNECTION_ERRORS = (
    ConnectionError,            # covers reset/refused/aborted/broken pipe
    http.client.BadStatusLine,
    http.client.CannotSendRequest,
    http.client.NotConnected,
    http.client.RemoteDisconnected,
)


# statuses that signal TRANSIENT unavailability (gateway/overload) worth
# a retry. A plain 500 is a deterministic server-side failure — e.g. a
# worker engine crash on this very batch (/worker/process-batch's honest
# failure reply) — and re-running it would multiply the sick worker's
# engine load rpc_max_attempts-fold per scatter; fail fast and count it.
_TRANSIENT_STATUSES = frozenset({502, 503, 504})

# 429 is the admission layer's EXPLICIT shed (cluster/admission.py):
# transient by definition, but retrying before its Retry-After hint has
# elapsed is exactly the hammering the shed exists to stop. The retry
# policy enforces that: see retry_after_of / RetryPolicy.call.
_SHED_STATUS = 429


def retry_after_of(e: BaseException) -> float | None:
    """The shed reply's ``Retry-After`` hint in seconds, or None when
    ``e`` is not a 429 (or carries no parseable hint — the HTTP-date
    form is treated as absent rather than guessed at). The retry policy
    uses it as a FLOOR on the back-off delay: a shed response is never
    re-attempted before the admitting side said a token would exist."""
    if isinstance(e, RpcStatusError) and e.status == _SHED_STATUS:
        return e.retry_after_s if e.retry_after_s is not None else 0.0
    if isinstance(e, urllib.error.HTTPError) and e.code == _SHED_STATUS:
        try:
            return float(e.headers.get("Retry-After", ""))
        except (TypeError, ValueError):
            return 0.0
    return None


# the leadership-fence status (cluster/fencing.py): a worker refusing
# a STALE leader epoch. Distinct from any other 4xx in consequence —
# the leader must step down, not merely fail the request.
_FENCE_STATUS = 403

# the wire-protocol rejection status (cluster/protover.py
# PROTO_STATUS): a handler refusing a peer whose declared wire version
# is below its compat floor. 4xx on purpose — already non-retryable and
# never a worker fault under the classifiers below; the explicit
# ``proto`` flag and :func:`is_proto_rejection` make the distinct
# consequence (surface version skew to the operator, never trip a
# breaker) testable and graftcheck-checkable.
_PROTO_STATUS = 426

# disk full (utils/storage.py STORAGE_FULL_STATUS): an upload or
# checkpoint hit ENOSPC. Deliberately NON-retryable (a full disk does
# not drain on retry timescales; hammering it multiplies write load
# exactly when the disk needs relief) and NEVER a worker fault — the
# node still serves reads perfectly, so a breaker that opened on 507s
# would mark a healthy-for-reads node dead and shrink the very capacity
# the full disk is starving.
_STORAGE_FULL_STATUS = 507


def is_fence_rejection(e: BaseException) -> bool:
    """A worker's leadership-fence rejection (403 +
    ``X-Fence-Rejected: 1``): the calling leader's epoch is stale.
    NEVER retryable (a deposed epoch cannot become current again) and
    NEVER a worker fault (the worker is healthy and doing exactly its
    job); the leader reacts by stepping down."""
    if isinstance(e, RpcStatusError):
        return e.fenced
    if isinstance(e, urllib.error.HTTPError) and e.code == _FENCE_STATUS:
        try:
            return e.headers.get("X-Fence-Rejected") == "1"
        except Exception:
            return False
    return False


def is_proto_rejection(e: BaseException) -> bool:
    """A handler's wire-protocol rejection (426 +
    ``X-Proto-Rejected: 1``): the calling peer's declared wire version
    is below the handler's compat floor (cluster/protover.py). NEVER
    retryable (the binary's version cannot change mid-flight) and NEVER
    a worker fault (the handler is healthy and enforcing the window —
    during a rolling upgrade this is routine, not an outage); callers
    surface it as version skew instead of masking it as a failure."""
    if isinstance(e, RpcStatusError):
        return e.proto
    if isinstance(e, urllib.error.HTTPError) and e.code == _PROTO_STATUS:
        try:
            return e.headers.get("X-Proto-Rejected") == "1"
        except Exception:
            return False
    return False


# message fragments that identify a device fault class when the
# exception type alone cannot; checked in order, first hit wins. Only
# errors the port's own calls can raise: the CUDA runtime's, through
# PyTorch (it runs no cuBLAS or cuDNN call)
_COMPUTE_OOM_MARKS = ("resource_exhausted", "out of memory")
_COMPUTE_TRANSIENT_MARKS = ("cuda error", "illegal memory access",
                            "unspecified launch failure",
                            "uncorrectable ecc")


def classify_compute_fault(e: BaseException) -> str | None:
    """``"oom"`` / ``"compile"`` / ``"transient"`` / ``"poison"``, or
    None for anything that is not a device fault.

    ``torch.cuda.OutOfMemoryError`` and "CUDA out of memory" are
    ``"oom"``; a CUDA runtime error (illegal address, launch failure, ECC)
    is ``"transient"``. A kernel that fails to build or load
    (``kernels.KernelBuildError``) or whose launch is refused
    (``kernels.KernelLaunchError``) is None: both are deterministic, and a
    fallback that absorbed them would hide the kernel. A generic
    ``RuntimeError`` is None."""
    stamped = getattr(e, "compute_fault", None)
    if stamped is not None:
        return stamped
    from tfidf_tpu_torch.kernels import KernelBuildError, KernelLaunchError
    from tfidf_tpu_torch.utils.device_nemesis import (DeviceCompileError,
                                                      DeviceFault,
                                                      DeviceOOMError,
                                                      DevicePoisonedOutput)
    if isinstance(e, DevicePoisonedOutput):
        return "poison"
    if isinstance(e, DeviceOOMError):
        return "oom"
    if isinstance(e, DeviceCompileError):
        return "compile"
    if isinstance(e, DeviceFault):
        return "transient"
    if isinstance(e, (KernelBuildError, KernelLaunchError)):
        return None
    import torch
    if isinstance(e, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(e, RuntimeError):
        msg = str(e).lower()
        if any(m in msg for m in _COMPUTE_OOM_MARKS):
            return "oom"
        if any(m in msg for m in _COMPUTE_TRANSIENT_MARKS):
            return "transient"
    return None


def is_retryable(e: BaseException) -> bool:
    """Default retry classifier: transient transport failures,
    gateway-transient statuses (502/503/504), and 429 admission sheds
    (retried only AFTER their ``Retry-After`` hint — the policy floors
    the back-off delay at it, so internal clients and the CLI honor the
    shed signal instead of hammering a saturated leader). NOT retryable:
    other application-level 4xx (the request itself is wrong — retrying
    cannot fix it), deterministic 500s (see ``_TRANSIENT_STATUSES``),
    and timeouts (the worker may still be processing; a retry would
    double the caller's latency budget, the same reasoning as
    ``_ScatterClient``'s single stale-connection retry).
    ``FaultInjected`` counts as transient so armed chaos faults exercise
    the retry path."""
    if isinstance(e, socket.timeout):   # subclass of OSError — check first
        return False
    if isinstance(e, DeadlineExpired):
        return False   # the budget cannot come back
    if is_fence_rejection(e):
        return False   # a stale epoch cannot become current again
    if is_proto_rejection(e):
        return False   # the binary's wire version cannot change mid-flight
    if isinstance(e, FaultInjected):
        return True
    if isinstance(e, RpcStatusError):
        if e.deadline_exceeded:
            return False   # the caller's budget is spent; honest failure
        if e.compute_fault is not None:
            # a device fault is deterministic on the worker's current
            # device state: re-sending the same batch would multiply
            # the sick device's load attempt-fold (the retry storm).
            # Per-request FAILOVER to a replica — not retry to the same
            # worker — is the recovery path.
            return False
        return e.status in _TRANSIENT_STATUSES or e.status == _SHED_STATUS
    if isinstance(e, urllib.error.HTTPError):
        return e.code in _TRANSIENT_STATUSES or e.code == _SHED_STATUS
    if isinstance(e, urllib.error.URLError):
        return isinstance(e.reason, _CONNECTION_ERRORS + (OSError,)) \
            and not isinstance(e.reason, socket.timeout)
    return isinstance(e, _CONNECTION_ERRORS)


def is_worker_fault(e: BaseException) -> bool:
    """Breaker accounting classifier: does this failure indict the WORKER
    (count toward opening its breaker)? An application rejection (4xx,
    e.g. 415 on a binary upload) comes from a healthy worker and must not
    trip its breaker; everything else — connection failures, timeouts,
    5xx — does. A 429 shed falls under the 4xx rule BY DESIGN: shedding
    is healthy overload behavior (cluster/admission.py), and a breaker
    that opened on sheds would amplify the very overload the shed is
    relieving (fast-fails would mark a live node dead). A leadership-
    fence 403 likewise: the WORKER is healthy — it is the calling
    leader that is deposed (cluster/fencing.py). And a wire-protocol
    426 likewise: the handler is healthy — it is the CALLER that is
    out of the compat window (cluster/protover.py); breakers opening
    on routine rolling-upgrade skew would turn an upgrade into an
    outage."""
    if is_fence_rejection(e):
        return False
    if is_proto_rejection(e):
        return False
    if isinstance(e, RpcStatusError):
        if e.deadline_exceeded:
            return False   # honest refusal from a healthy worker
        if e.compute_fault == "poison":
            # the QUERY is at fault, not the worker: a poison query
            # serially tripping every replica's breaker is exactly the
            # cascade the quarantine exists to stop — the worker stays
            # in rotation and the leader quarantines the fingerprint
            return False
        return e.status >= 500 and e.status != _STORAGE_FULL_STATUS
    if isinstance(e, urllib.error.HTTPError):
        return e.code >= 500 and e.code != _STORAGE_FULL_STATUS
    return True


class RetryPolicy:
    """Bounded retry with exponential backoff + jitter and a deadline.

    ``call(fn)`` runs ``fn`` up to ``max_attempts`` times. An exception
    the classifier rejects propagates immediately; a retryable one sleeps
    ``base * 2**attempt`` (capped at ``max_delay_s``, ±``jitter``
    fraction) and tries again, unless attempts or the overall deadline
    (``deadline_s``; 0 disables) would be exceeded. ``sleep``/``clock``/
    ``rng`` are injectable for deterministic tests."""

    def __init__(self, max_attempts: int = 3, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.25,
                 deadline_s: float = 0.0,
                 classify: Callable[[BaseException], bool] = is_retryable,
                 name: str = "rpc", sleep=time.sleep,
                 clock=time.monotonic, rng: random.Random | None = None
                 ) -> None:
        self.max_attempts = max(1, max_attempts)
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self.deadline_s = deadline_s
        self.classify = classify
        self.name = name
        self._sleep = sleep
        self._clock = clock
        self._rng = rng or random.Random()

    def backoff_delay(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (1-based)."""
        d = min(self.max_delay_s, self.base_delay_s * (2 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(0.0, d)

    def call(self, fn, classify=None):
        classify = classify or self.classify
        t0 = self._clock()
        for attempt in range(1, self.max_attempts + 1):
            try:
                return fn()
            except Exception as e:
                if attempt >= self.max_attempts or not classify(e):
                    raise
                delay = self.backoff_delay(attempt)
                shed_wait = retry_after_of(e)
                if shed_wait is not None:
                    # non-retryable-before-Retry-After: the shed reply's
                    # hint FLOORS the delay — re-attempting sooner is
                    # the hammering the 429 exists to stop
                    delay = max(delay, shed_wait)
                    global_metrics.inc(f"{self.name}_shed_waits")
                if (self.deadline_s > 0
                        and self._clock() - t0 + delay > self.deadline_s):
                    raise   # the budget is spent; honest failure now
                global_metrics.inc(f"{self.name}_retries")
                # visible in the request trace: which attempt failed,
                # with what, and how long the backoff slept
                span_event("retry", attempt=attempt,
                           delay_ms=round(delay * 1e3, 1),
                           err=repr(e)[:120])
                global_injector.check("resilience.backoff")
                self._sleep(delay)
        raise AssertionError("unreachable")   # loop always returns/raises


def hedge_laggards(futures: dict, delay_s: float, on_laggard) -> set:
    """Hedged-read primitive ("The Tail at Scale", Dean & Barroso 2013):
    wait up to ``delay_s`` for the futures in ``futures`` (future ->
    tag); for each one still outstanding at the deadline invoke
    ``on_laggard(tag)`` exactly once and return the set of laggard tags.

    The primitive only DETECTS the laggards — the caller decides what a
    hedge is (the leader re-issues the laggard's ownership slice to the
    next replica) and owns merging/deduping the duplicate results.
    ``on_laggard`` runs on the calling thread and must dispatch async
    work rather than block; a raising callback is counted
    (``hedge_dispatch_failures``) and swallowed so one bad hedge cannot
    take down the primary gather it exists to protect."""
    if delay_s <= 0 or not futures:
        return set()
    _done, pending = _futures_wait(set(futures), timeout=delay_s)
    laggards = set()
    for fut in pending:
        tag = futures[fut]
        laggards.add(tag)
        try:
            on_laggard(tag)
        except Exception as e:
            global_metrics.inc("hedge_dispatch_failures")
            log.warning("hedge dispatch failed", target=str(tag),
                        err=repr(e))
    if laggards:
        global_metrics.inc("hedges_dispatched", len(laggards))
    return laggards


# breaker states
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-target circuit breaker: closed → open after
    ``failure_threshold`` CONSECUTIVE failures → half-open probe after
    ``reset_s`` → closed on probe success, re-open on probe failure.

    ``acquire()`` admits or rejects a call (one probe at a time while
    half-open); the caller reports the outcome via ``record_success`` /
    ``record_failure``. The fault points at the trip and probe sites are
    observe-only: an armed ``raise`` there is swallowed (the fire counter
    still increments) because both run inside callers' error paths."""

    def __init__(self, failure_threshold: int = 5, reset_s: float = 5.0,
                 clock=time.monotonic, name: str = "") -> None:
        self.failure_threshold = max(1, failure_threshold)
        self.reset_s = reset_s
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0
        self._open_until = 0.0
        self._probe_inflight = False
        self.transitions: list[str] = [CLOSED]   # audit trail for tests

    @property
    def state(self) -> str:
        with self._lock:
            if self._state == OPEN and self._clock() >= self._open_until:
                return HALF_OPEN   # would admit a probe
            return self._state

    def is_open(self) -> bool:
        """Non-consuming check: True while calls would be rejected
        outright (does NOT claim the half-open probe slot — use it for
        routing decisions, ``acquire`` for actual calls)."""
        with self._lock:
            if self._state == OPEN:
                return self._clock() < self._open_until
            if self._state == HALF_OPEN:
                return self._probe_inflight
            return False

    def acquire(self) -> None:
        """Admit a call or raise :class:`CircuitOpenError`."""
        with self._lock:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                if self._clock() < self._open_until:
                    raise CircuitOpenError(
                        f"breaker open for {self.name or 'target'}")
                self._transition(HALF_OPEN)
            # half-open: exactly one probe in flight
            if self._probe_inflight:
                raise CircuitOpenError(
                    f"breaker half-open probe in flight for "
                    f"{self.name or 'target'}")
            self._probe_inflight = True
        self._observe("resilience.breaker_probe")
        global_metrics.inc("breaker_probes")

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._transition(CLOSED)
                closed = True
            else:
                closed = False
        if closed:
            global_metrics.inc("breaker_closed")
            log.info("circuit breaker closed", target=self.name)

    def release(self) -> None:
        """Outcome unknown (no RPC was attempted, e.g. the caller's
        budget expired pre-dispatch): free the half-open probe slot
        without recording evidence either way — a breaker must never
        CLOSE on a worker that was not contacted."""
        with self._lock:
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            self._failures += 1
            self._probe_inflight = False
            tripped = False
            if self._state == HALF_OPEN or (
                    self._state == CLOSED
                    and self._failures >= self.failure_threshold):
                self._transition(OPEN)
                self._open_until = self._clock() + self.reset_s
                tripped = True
            elif self._state == OPEN:
                # failure observed while open (e.g. a call admitted just
                # before the trip): push the reset window out
                self._open_until = self._clock() + self.reset_s
        if tripped:
            self._observe("resilience.breaker_trip")
            global_metrics.inc("breaker_opened")
            span_event("breaker_trip", target=self.name)
            log.warning("circuit breaker opened", target=self.name,
                        failures=self._failures)

    def trip_slow(self) -> None:
        """Gray-failure trip: force OPEN now. Called by the latency
        EWMA when a worker is slow-but-ALIVE — its calls succeed, so
        consecutive-failure counting never fires, yet every scatter it
        owns drags to the deadline. The normal half-open probe path
        re-admits it; the EWMA restarts from scratch on trip (the
        caller resets it) so one slow era cannot re-condemn a
        recovered worker forever."""
        with self._lock:
            self._probe_inflight = False
            self._failures = 0
            if self._state != OPEN:
                self._transition(OPEN)
            self._open_until = self._clock() + self.reset_s
        self._observe("resilience.breaker_trip")
        global_metrics.inc("breaker_opened")
        span_event("breaker_trip", target=self.name, gray=1)
        log.warning("circuit breaker opened (gray failure: latency)",
                    target=self.name)

    def _transition(self, state: str) -> None:
        self._state = state
        self.transitions.append(state)
        if len(self.transitions) > 64:   # bounded audit trail: a
            del self.transitions[:-64]   # flapping worker must not leak

    @staticmethod
    def _observe(point: str) -> None:
        try:
            global_injector.check(point)
        except FaultInjected:
            pass   # observe-only site; the fire counter already ticked


class BreakerBoard:
    """One :class:`CircuitBreaker` per worker URL, created on demand and
    pruned when workers leave the registry."""

    def __init__(self, failure_threshold: int = 5, reset_s: float = 5.0,
                 clock=time.monotonic) -> None:
        self.failure_threshold = failure_threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[str, CircuitBreaker] = {}

    def breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(
                    self.failure_threshold, self.reset_s,
                    clock=self._clock, name=key)
            return b

    def is_open(self, key: str) -> bool:
        with self._lock:
            b = self._breakers.get(key)
        return b.is_open() if b is not None else False

    def open_count(self) -> int:
        with self._lock:
            bs = list(self._breakers.values())
        return sum(1 for b in bs if b.is_open())

    def prune(self, live) -> None:
        """Forget breakers for departed workers: a rejoining worker
        (same URL) starts with a clean slate, like its fresh session."""
        with self._lock:
            for key in list(self._breakers):
                if key not in live:
                    del self._breakers[key]

    def snapshot(self) -> dict[str, str]:
        with self._lock:
            bs = dict(self._breakers)
        return {k: b.state for k, b in bs.items()}


class ClusterResilience:
    """The node's resilience bundle: one retry policy + one breaker
    board + per-worker latency EWMAs (gray-failure detection), built
    from :class:`~tfidf_tpu_torch.utils.config.Config` knobs and shared by
    every leader→worker RPC path."""

    # EWMA smoothing for the gray-failure detector: ~5-call memory,
    # heavy enough that one outlier RPC cannot trip a healthy worker
    _SLOW_ALPHA = 0.2

    def __init__(self, config) -> None:
        self.policy = RetryPolicy(
            max_attempts=config.rpc_max_attempts,
            base_delay_s=config.rpc_backoff_base_s,
            max_delay_s=config.rpc_backoff_max_s,
            deadline_s=config.rpc_retry_deadline_s)
        self.board = BreakerBoard(
            failure_threshold=config.breaker_failure_threshold,
            reset_s=config.breaker_reset_s)
        # gray-failure detection (nemesis latency injection, overloaded
        # or swapping workers): a slow-but-ALIVE worker never fails a
        # call, so the consecutive-failure breaker stays closed while
        # every scatter it owns drags to its deadline. Track a
        # successful-call latency EWMA per worker and trip the breaker
        # (breaker_slow_trips) when it crosses the threshold.
        self.slow_threshold_s = config.breaker_slow_threshold_ms / 1e3
        self.slow_min_samples = max(1, config.breaker_slow_min_samples)
        self._lat_lock = threading.Lock()
        self._lat: dict[str, tuple[float, int]] = {}   # worker -> (ewma, n)

    def prune(self, live) -> None:
        """Forget breakers AND latency EWMAs for departed workers."""
        self.board.prune(live)
        if self.slow_threshold_s > 0:
            with self._lat_lock:
                for key in list(self._lat):
                    if key not in live:
                        del self._lat[key]

    def latency_snapshot(self) -> dict[str, tuple[float, int]]:
        """Copy of the per-worker successful-call latency EWMAs:
        ``{worker: (ewma_seconds, samples)}``. The SLO autopilot's
        slow-trip controller derives ``breaker_slow_threshold_ms``
        from the cross-worker spread of these."""
        with self._lat_lock:
            return dict(self._lat)

    def _note_latency(self, worker: str, dt_s: float) -> None:
        if self.slow_threshold_s <= 0:
            return
        with self._lat_lock:
            ewma, n = self._lat.get(worker, (0.0, 0))
            ewma = dt_s if n == 0 else (
                self._SLOW_ALPHA * dt_s + (1.0 - self._SLOW_ALPHA) * ewma)
            n += 1
            trip = (n >= self.slow_min_samples
                    and ewma > self.slow_threshold_s)
            # on trip the EWMA restarts: the half-open probe after
            # reset_s must judge the worker fresh, not against the
            # slow era that condemned it
            self._lat[worker] = (0.0, 0) if trip else (ewma, n)
        if trip:
            global_metrics.inc("breaker_slow_trips")
            log.warning("worker latency EWMA over threshold; tripping "
                        "breaker (gray failure)", target=worker,
                        ewma_ms=round(ewma * 1e3, 1),
                        threshold_ms=round(self.slow_threshold_s * 1e3,
                                           1))
            self.board.breaker(worker).trip_slow()

    def worker_call(self, worker: str, fn, retry: bool = True,
                    track_latency: bool = False):
        """Run one logical RPC against ``worker`` under its breaker.

        The breaker admits/rejects the WHOLE logical call; the retry
        policy runs inside it, so a call that succeeds on attempt 2 of 3
        counts as one breaker success, and only a call that exhausts its
        retries counts as one breaker failure. Application rejections
        (4xx) propagate without indicting the worker.

        ``track_latency=True`` feeds the gray-failure EWMA (see
        ``_note_latency``) — opt-in, for the SCATTER-path call sites
        only: a single EWMA mixing ms-scale scatter RPCs with
        legitimately-minutes-long bulk uploads would condemn a healthy
        worker for doing bulk work. The sample is the successful
        attempt's OWN duration (measured inside ``fn``'s wrapper), so
        retry backoff sleeps and failed-attempt timeouts never
        inflate it."""
        b = self.board.breaker(worker)
        b.acquire()
        run = fn
        measured: list[float] = []
        if track_latency and self.slow_threshold_s > 0:
            def run() -> object:
                t0 = time.monotonic()
                out = fn()
                measured.append(time.monotonic() - t0)
                return out
        try:
            out = self.policy.call(run) if retry else run()
        except Exception as e:
            if isinstance(e, DeadlineExpired):
                b.release()   # never dispatched: no evidence either way
            elif is_worker_fault(e):
                b.record_failure()
            else:
                b.record_success()   # a 4xx proves the worker is alive
            raise
        b.record_success()
        if measured:
            # AFTER the breaker success accounting: a slow trip fired
            # here must not be immediately re-closed by it
            self._note_latency(worker, measured[-1])
        return out
