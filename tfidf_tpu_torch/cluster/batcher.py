"""Server-side query micro-batching.

The scoring kernels are built for a padded ``[B]`` query batch
(:mod:`tfidf_tpu_torch.ops.scoring`), but HTTP requests arrive one query at a
time — the reference scores them one at a time too (``Worker.java:175-186``,
one Lucene search per POST). Running each request as a batch of one leaves
most of the device batch idle. The :class:`QueryBatcher` coalesces
concurrent requests into one device batch: the first arrival waits a short
linger window for company, then the group is scored in a single
``search_batch`` call and results are fanned back to the waiting handler
threads.

Latency math: the linger adds at most ``linger_s`` (default 2 ms) to a lone
query — noise next to an HTTP round-trip — while under concurrent load B
queries cost one kernel launch instead of B.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque

from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import current_span, global_tracer

log = get_logger("cluster.batcher")


class _Waiter:
    __slots__ = ("query", "event", "result", "error", "t0", "key",
                 "lane", "span")

    def __init__(self, query, lane: int = 0) -> None:
        self.query = query   # the submitted item (any shape)
        self.event = threading.Event()
        self.result = None
        self.error: BaseException | None = None
        self.t0 = 0.0   # submit time (linger accounting)
        self.key = None  # group key, stamped at SUBMIT time
        self.lane = lane  # 0 = interactive, 1 = bulk (weighted dequeue)
        self.span = None  # the submitter's active trace span (if any)


class Coalescer:
    """Generic request coalescer: concurrent ``submit(item)`` calls group
    into batches handed to ``batch_fn(items) -> results`` (positional,
    same length). The leader's scatter path uses this to turn N
    concurrent ``/leader/start`` requests into ONE batched RPC per
    worker; the per-item linger wait is recorded as the
    ``{name}_linger`` timing so the serving-path breakdown can attribute
    queueing delay separately from RPC time.

    ``pipeline`` dispatcher threads let one batch's RPC round trip
    overlap the next batch's formation.

    Two priority lanes (``submit(item, lane=...)``): lane 0
    (interactive) and lane 1 (bulk). Batch formation is a WEIGHTED
    dequeue — the interactive queue always fills first (so bulk can
    never starve interactive: every dispatch round that finds an
    interactive item queued dispatches it), but while interactive
    traffic saturates a batch, ``bulk_share`` of the slots are reserved
    for queued bulk items so bulk starves neither. Unused reservation
    in either direction is returned to the other lane."""

    def __init__(self, batch_fn, *, max_batch: int = 128,
                 linger_s: float = 0.002, pipeline: int = 2,
                 name: str = "coalesce", group_key=None,
                 linger_min_s: float | None = None,
                 linger_max_s: float | None = None,
                 bulk_share: float = 0.25) -> None:
        """``group_key(item)``, when given, keeps a batch homogeneous:
        only leading queued items sharing the head's key join it; the
        rest stay queued in order for the next dispatcher round. The
        key is evaluated ONCE, at submit time — so a key derived from
        ambient state (the leader's membership epoch) partitions
        batches by the world the caller saw, not by whatever the
        dispatcher sees later.

        ``linger_min_s``/``linger_max_s`` arm the ADAPTIVE linger: with
        no batch in flight the dispatcher lingers only ``linger_min_s``
        (the executor downstream is idle — waiting would buy batch fill
        at the cost of idle device time), and as the in-flight count
        approaches the dispatcher pipeline depth the linger stretches
        toward ``linger_max_s`` (the device is saturated; fuller
        batches amortize better and the wait hides under in-flight
        work). Leaving them ``None`` keeps the fixed ``linger_s``."""
        self.batch_fn = batch_fn
        self.max_batch = max(1, max_batch)
        self.linger_s = linger_s
        self._linger_lo = linger_s if linger_min_s is None else linger_min_s
        self._linger_hi = linger_s if linger_max_s is None else linger_max_s
        self.name = name
        self.group_key = group_key
        self.bulk_share = min(max(bulk_share, 0.0), 1.0)
        self._lock = threading.Lock()
        self._items: deque[_Waiter] = deque()   # lane 0: interactive
        self._bulk: deque[_Waiter] = deque()    # lane 1: bulk/batch
        self._wake = threading.Event()
        self._stopping = False
        self._dispatching = 0   # batch_fn calls in flight (adaptive linger)
        self._threads = [
            threading.Thread(target=self._run, daemon=True,
                             name=f"{name}-{i}")
            for i in range(max(1, pipeline))]
        for t in self._threads:
            t.start()

    def submit(self, item, lane: int = 0):
        w = _Waiter(item, lane=1 if lane else 0)
        w.t0 = time.perf_counter()
        # trace linkage: the batch this item lands in runs on a
        # dispatcher thread with no request context — capture the
        # submitter's span so the dispatched batch can LINK (not
        # parent) the requests it absorbed
        sp = current_span()
        if sp is not None and sp.sampled:
            w.span = sp
        if self.group_key is not None:
            w.key = self.group_key(item)
        with self._lock:
            if self._stopping:
                raise RuntimeError(f"{self.name} stopped")
            if not any(t.is_alive() for t in self._threads):
                # every dispatcher died without stop() (a BaseException
                # escaped _run): fail fast BEFORE enqueueing — under
                # steady load, abandoned waiters would otherwise grow
                # _items without bound
                raise RuntimeError(f"{self.name} dispatchers died")
            (self._bulk if w.lane else self._items).append(w)
        self._wake.set()
        # bounded-slice wait + shutdown check (graftcheck lockgraph
        # indefinite-wait audit): a dispatcher that died mid-batch must
        # not wedge this caller's thread forever. After stop(), queued
        # waiters are failed by stop() itself; an in-flight batch gets a
        # short grace to settle, then this caller fails loudly — and
        # removes its still-queued waiter so the deque cannot leak.
        while not w.event.wait(timeout=0.5):
            if self._stopping or not any(
                    t.is_alive() for t in self._threads):
                if not w.event.wait(timeout=2.0):
                    with self._lock:
                        try:
                            (self._bulk if w.lane
                             else self._items).remove(w)
                        except ValueError:
                            pass   # already popped into a batch
                    raise RuntimeError(
                        f"{self.name} "
                        + ("stopped" if self._stopping
                           else "dispatchers died"))
                break
        if w.error is not None:
            raise w.error
        return w.result

    def linger_bounds(self) -> tuple[float, float]:
        """Current adaptive-linger bounds ``(lo_s, hi_s)``."""
        return self._linger_lo, self._linger_hi

    def set_linger_bounds(self, lo_s: float | None = None,
                          hi_s: float | None = None) -> None:
        """Retune the adaptive-linger bounds live (the SLO autopilot's
        linger knob). Plain GIL-atomic float writes, matching the
        unlocked reads in ``_effective_linger_s`` — a dispatcher that
        reads one old and one new bound computes one slightly-off
        linger, which is harmless for a latency knob."""
        if lo_s is not None:
            self._linger_lo = lo_s
        if hi_s is not None:
            self._linger_hi = hi_s

    def backlog(self) -> int:
        """LIVE queued items beyond one batch's worth — the admission
        layer's stall-proof overload signal. The ``last_*_queue_depth``
        gauge is only refreshed at batch formation, so it freezes at
        its last value while every dispatcher thread is blocked inside
        a stalled ``batch_fn`` RPC — exactly when the queue grows
        fastest. This reads the deques directly (unlocked ``len`` is a
        single atomic read; an off-by-a-few heuristic is fine for a
        watermark). One batch's worth is subtracted because a healthy
        linger window legitimately accumulates up to ``max_batch``
        items that the next formation round will take."""
        return max(0, len(self._items) + len(self._bulk) - self.max_batch)

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
        self._wake.set()
        for t in self._threads:
            t.join(timeout=2.0)
        with self._lock:
            items = list(self._items) + list(self._bulk)
            self._items, self._bulk = deque(), deque()
        for w in items:
            w.error = RuntimeError(f"{self.name} stopped")
            w.event.set()

    def _effective_linger_s(self) -> float:
        """Adaptive linger: scale between the configured bounds by how
        busy the OTHER dispatcher threads are. 0 in-flight batches ->
        lo (dispatch now, the device is idle); every sibling busy -> hi
        (the wait hides under in-flight work and buys batch fill).

        The deciding thread is never inside ``batch_fn`` itself, so the
        busy fraction is taken over the ``pipeline - 1`` siblings —
        dividing by ``pipeline`` would make ``hi`` unreachable. With a
        single dispatcher there are no siblings to read load from, so
        adaptation is moot and the fixed ``linger_s`` applies."""
        lo, hi = self._linger_lo, self._linger_hi
        if hi <= lo:
            return lo
        siblings = len(self._threads) - 1
        if siblings == 0:
            return self.linger_s
        with self._lock:
            busy = self._dispatching
        frac = min(busy / siblings, 1.0)
        return lo + (hi - lo) * frac

    def _run(self) -> None:
        while True:
            # bounded slice + shutdown re-check: a missed wake (or a
            # peer that never wakes us again) must not park this
            # dispatcher forever — the indefinite-wait audit's contract
            if not self._wake.wait(timeout=0.5):
                if self._stopping:
                    return
                continue
            if self._stopping:
                return
            linger = self._effective_linger_s()
            waited = 0.0   # the linger actually APPLIED (gauged below)
            if linger > 0:
                # linger only while the batch could still fill: at
                # saturation (a full batch already queued) the wait buys
                # nothing and would tax every query's latency
                with self._lock:
                    full = (len(self._items) + len(self._bulk)
                            >= self.max_batch)
                if not full:
                    threading.Event().wait(linger)
                    waited = linger
            with self._lock:
                batch = self._form_batch_locked()
                depth = len(self._items) + len(self._bulk)
                bulk_depth = len(self._bulk)
                if depth == 0 and not self._stopping:
                    # never clear after stop() set the event, or sibling
                    # dispatcher threads park in _wake.wait() forever
                    self._wake.clear()
            # queue depth LEFT BEHIND after this batch formed: the
            # serving-pressure signal the k8s HPA scales workers on
            # (deploy/k8s.yaml) AND the admission layer's backpressure
            # input (cluster/admission.py) — 0 in steady state, grows
            # when offered load outruns the dispatch pipeline
            global_metrics.set_gauge(f"last_{self.name}_queue_depth",
                                     depth)
            global_metrics.set_gauge(f"last_{self.name}_bulk_depth",
                                     bulk_depth)
            if not batch:
                continue
            try:
                self._dispatch_batch(batch, waited)
            except BaseException as e:
                # anything that escapes _dispatch_batch (BaseException
                # from batch_fn, a failure outside its Exception guard)
                # is about to kill THIS dispatcher thread — popped
                # waiters must never outlive it unsignaled, or their
                # submit() calls wedge until stop()
                for w in batch:
                    if not w.event.is_set():
                        w.error = RuntimeError(
                            f"{self.name} dispatcher died: {e!r}")
                        w.event.set()
                raise

    def _form_batch_locked(self) -> list[_Waiter]:
        """Weighted two-lane dequeue; caller holds ``self._lock``.

        The interactive head is popped FIRST whenever that lane is
        nonempty — so a dispatch round can never serve bulk while an
        interactive request waits (bulk starving interactive is
        impossible by construction). While interactive saturates the
        batch, ``bulk_share`` of the slots are reserved for
        key-compatible queued bulk items so bulk makes progress too;
        reservation either lane does not use returns to the other.
        Group-key homogeneity holds across lanes: the batch key is the
        first popped item's submit-time key, and only head items
        matching it (from either lane) join."""
        lead = self._items or self._bulk
        if not lead:
            return []
        first = lead.popleft()
        batch = [first]
        key = first.key   # stamped at submit time

        def head_ok(dq) -> bool:
            return bool(dq) and (self.group_key is None
                                 or dq[0].key == key)

        reserve = 0
        if first.lane == 0 and self.bulk_share > 0 and head_ok(self._bulk):
            reserve = max(1, int(self.max_batch * self.bulk_share))
        while head_ok(self._items) and len(batch) < self.max_batch - reserve:
            batch.append(self._items.popleft())
        while head_ok(self._bulk) and len(batch) < self.max_batch:
            batch.append(self._bulk.popleft())
        while head_ok(self._items) and len(batch) < self.max_batch:
            batch.append(self._items.popleft())
        return batch

    def _dispatch_batch(self, batch: list[_Waiter],
                        waited: float) -> None:
        t0 = time.perf_counter()
        for w in batch:   # queueing delay, attributed separately
            global_metrics.observe(f"{self.name}_linger", t0 - w.t0)
        # gauge the wait that actually happened: at saturation the
        # sleep is skipped, and reporting the computed linger there
        # would misattribute latency exactly where none was added
        global_metrics.set_gauge(f"last_{self.name}_linger_ms",
                                 round(waited * 1e3, 3))
        with self._lock:
            self._dispatching += 1
        # one batch span LINKED (not parented) to every traced request
        # it absorbed — the Dapper coalescing boundary: the batch serves
        # N independent traces, so it gets its OWN trace id, and each
        # request span links forward to it so a trace walk crosses the
        # boundary in either direction. Untraced batches (no submitter
        # had an active sampled span) skip tracing entirely.
        traced = [w.span for w in batch if w.span is not None]
        # sampled=True, never a re-roll: this root exists only because
        # the linked requests already won the sampling draw — an
        # independent draw would drop their scatter sub-trace with
        # probability (1 - sample_rate)
        batch_cm = (global_tracer.span(
            f"{self.name}.batch", sampled=True,
            links=[s.context for s in traced],
            attrs={"items": len(batch), "linked": len(traced)})
            if traced else contextlib.nullcontext())
        try:
            with batch_cm as bsp:
                if bsp is not None:
                    for s in traced:
                        s.add_link(bsp.context)
                results = self.batch_fn([w.query for w in batch])
            for w, r in zip(batch, results):
                w.result = r
        except Exception as e:
            # honest propagation: every coalesced caller sees the
            # SAME failure (never a fabricated empty success), and
            # the counter sizes the blast radius of one bad batch
            global_metrics.inc(f"{self.name}_batch_failures")
            for w in batch:
                w.error = e
        finally:
            with self._lock:
                self._dispatching -= 1
        for w in batch:
            w.event.set()
        global_metrics.observe(f"{self.name}_batch_total",
                               time.perf_counter() - t0)
        global_metrics.inc(f"{self.name}_batches")
        global_metrics.inc(f"{self.name}_items", len(batch))
        global_metrics.set_gauge(f"last_{self.name}_batch_size",
                                 len(batch))


class QueryBatcher(Coalescer):
    """Coalesce concurrent search calls into device-sized batches.

    Thread-safe; callers block until their query's results are ready.
    Queries with differing (k, unbounded) parameters are grouped into
    separate batches (they need different post-processing), preserving
    arrival order within the queue — the ``group_key`` hook of the
    generic :class:`Coalescer` this is built on.

    ``pipeline`` scorer threads run concurrent ``search_batch`` calls
    (the engine is a pure function of its snapshot, so this is safe). On
    a high-RTT device link (remote-TPU tunnel) a second in-flight batch
    hides one batch's result fetch under the next batch's device
    compute — the same trick Searcher.search plays across chunks,
    applied across micro-batches."""

    def __init__(self, engine, max_batch: int = 32,
                 linger_s: float = 0.002, pipeline: int = 1,
                 linger_min_s: float | None = None,
                 linger_max_s: float | None = None) -> None:
        self.engine = engine
        super().__init__(
            self._score, max_batch=max_batch, linger_s=linger_s,
            pipeline=pipeline, name="query",
            group_key=lambda item: (item[1], item[2]),
            linger_min_s=linger_min_s, linger_max_s=linger_max_s)

    def _score(self, items: list[tuple]) -> list:
        k, unbounded = items[0][1], items[0][2]
        return self.engine.search_batch(
            [it[0] for it in items], k=k, unbounded=unbounded)

    def search(self, query: str, k: int | None = None,
               unbounded: bool = False):
        """Submit one query; returns its hit list (blocking)."""
        return self.submit((query, k, unbounded))
