"""Distributed tracing: Dapper-style spans + the phase/profiler hooks.

The reference has none (SURVEY.md §5.1) — its only visibility is log
lines around each request. The cluster survives worker
SIGKILL, partitions, fencing step-downs, hedged reads, and overload
shedding, but nothing reconstructed *which* batch a slow query coalesced
into, which workers it scattered to, or which retries/hedges/failovers
fired along the way. This module adds that reconstruction:

- a trace context (trace id, span id, parent id) minted at admission in
  the cluster plane's node module and carried as ``X-Trace-Id`` /
  ``X-Span-Id`` headers across every leader→worker RPC (the same shared
  HTTP seams the nemesis shim instruments);
- spans *linked* (not parented) through the coalescer: one batch span
  references the N request spans it absorbed, and each request span
  links back to its batch, so a trace walk crosses the coalescing
  boundary in either direction;
- span **events** from the resilience layer (retry attempts, breaker
  trips, hedge dispatches/wins, failover slices, 429 sheds, fence
  rejections, fault-point fires) and the worker's pipeline stages —
  with the existing :func:`trace_phase` phases (analyze / vectorize /
  score / topk) folding into the active span, so engine-level timings
  land inside the request timeline;
- a bounded, lock-free in-process ring buffer of finished spans
  (one stable ``collections.deque``, trim-bounded — appends and
  popleft trims are GIL-atomic), exported
  by ``GET /api/trace`` (by trace id or recent-N), a
  Chrome-trace/Perfetto JSON exporter (:func:`to_chrome_trace`), a
  threshold-gated slow-query log keyed by trace id, and the CLI
  ``trace`` subcommand.

Sampling: the decision is made once, when a ROOT span is minted
(``sample_rate``); children and remote continuations inherit it. An
unsampled span still carries real ids (so the LOCAL node's log lines
stay joinable) but skips event recording, is never written to the
ring, and never propagates headers — with ``trace_sample_rate=0`` the
per-request cost is one object allocation and two contextvar
operations.

``trace_phase`` keeps its original contract: it records wall time into
the global metrics and opens a ``torch.profiler.record_function`` range
so phases show up named in ``torch.profiler`` captures — and ALSO
stamps a ``phase.<name>`` event on the active span. On CUDA the wall
time of a phase is its host time: kernels launched inside it may still
be running when it closes (the fetch phase's device-to-host copy is
where the host waits for them).
"""

from __future__ import annotations

import contextlib
import contextvars
import random
import re
import time
from collections import deque
from typing import Iterator, NamedTuple

from tfidf_tpu_torch.utils.metrics import global_metrics

from torch.profiler import record_function

# the propagation headers (the trace analog of the fencing layer's
# X-Leader-Epoch): injected by the shared HTTP client helpers in
# cluster/node.py, read back by the worker-side handlers
TRACE_HEADER = "X-Trace-Id"
SPAN_HEADER = "X-Span-Id"


def _epoch_anchor() -> float:
    """Wall-clock anchor for span timestamps: one ``time.time()`` read
    at import, after which every span start is ``anchor + monotonic()``
    — timestamps stay human-meaningful (Chrome trace wants epoch
    microseconds) while all span *arithmetic* rides the monotonic
    clock, immune to NTP steps mid-trace (graftcheck wallclock pass:
    this single read is the reviewed exception)."""
    return time.time() - time.monotonic()


_EPOCH0 = _epoch_anchor()


def epoch_now() -> float:
    """Epoch seconds derived from the reviewed wall-clock anchor plus
    the monotonic clock — the timestamp helper for records that must
    be human-meaningful (span starts, autopilot decisions) without
    adding new raw ``time.time()`` reads (graftcheck wallclock pass)."""
    return _EPOCH0 + time.monotonic()

# per-process id entropy: span ids must not collide across the nodes of
# an in-process test cluster, so the generator is seeded from urandom.
# No lock: getrandbits/random are single C-level calls, GIL-atomic in
# CPython — the record path stays lock-free by design.
_rng = random.Random()


def _new_id(bits: int) -> str:
    return f"{_rng.getrandbits(bits):0{bits // 4}x}"


# the id grammar accepted from UNTRUSTED propagation headers (ours are
# 16-hex trace / 8-hex span ids; W3C-style 32-hex accepted too)
_ID_RE = re.compile(r"[0-9a-f]{8,64}")


class SpanContext(NamedTuple):
    """The wire-propagatable part of a span: what ``X-Trace-Id`` /
    ``X-Span-Id`` carry, and what links reference."""
    trace_id: str
    span_id: str
    sampled: bool = True


class Span:
    """One timed operation. Mutation is append-only under the GIL
    (list.append / attribute set), so events from pipeline/pool threads
    need no locking; the span is exported only after :meth:`finish`."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "sampled",
                 "start_s", "end_s", "attrs", "events", "links")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, sampled: bool,
                 attrs: dict | None = None) -> None:
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.start_s = _EPOCH0 + time.monotonic()
        self.end_s: float | None = None
        self.attrs: dict = dict(attrs) if attrs else {}
        # bounded, oldest-dropped: a retry/hedge storm must not grow
        # the ring's memory unboundedly, and the cap must keep the
        # NEWEST events — the late decisive ones (scatter.health
        # verdict, hedge_win) are exactly what chaos suites assert on
        self.events: deque[tuple[float, str, dict]] = deque(
            maxlen=self._MAX_EVENTS)
        self.links: list[tuple[str, str]] = []   # (trace_id, span_id)

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    # per-span event bound (deque maxlen: appends past it drop the
    # OLDEST entry, GIL-atomically)
    _MAX_EVENTS = 512

    def event(self, name: str, **attrs) -> None:
        """Timestamped annotation on this span (retry, breaker trip,
        hedge win, fault fire, pipeline stage, …). No-op when the
        trace is unsampled; bounded per span (newest kept)."""
        if self.sampled:
            self.events.append((_EPOCH0 + time.monotonic(), name, attrs))

    def set_attr(self, key: str, value) -> None:
        if self.sampled:
            self.attrs[key] = value

    def add_link(self, ctx: SpanContext) -> None:
        """Reference a span in ANOTHER trace (the coalescer boundary:
        batch spans link the request spans they absorbed, and vice
        versa). Links are how ``get_trace`` walks across traces."""
        if self.sampled:
            self.links.append((ctx.trace_id, ctx.span_id))

    def to_dict(self) -> dict:
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "start_s": round(self.start_s, 6),
             "duration_ms": round(((self.end_s or self.start_s)
                                   - self.start_s) * 1e3, 3),
             "attrs": dict(self.attrs),
             "events": [{"t_s": round(t, 6), "name": n,
                         "attrs": dict(a)}
                        for t, n, a in list(self.events)],
             "links": [{"trace_id": t, "span_id": s}
                       for t, s in list(self.links)]}
        return d


class Tracer:
    """Process-wide span factory + bounded ring buffer of finished
    spans. The ring is ONE stable ``deque`` bounded by popleft trims
    (never a maxlen rebind — see ``__init__``): appends, trims, and
    snapshot reads are GIL-atomic, so the serving hot path never takes
    a lock to record a span."""

    def __init__(self, max_spans: int = 4096,
                 sample_rate: float = 1.0) -> None:
        # ONE deque for the tracer's whole lifetime: the bound is
        # enforced by trimming, never by rebinding — a rebind would
        # race concurrent finish() appends into a discarded object
        # (the lock-free record path depends on the reference being
        # stable)
        self._ring: deque[Span] = deque()
        self.max_spans = max(16, max_spans)
        self.sample_rate = sample_rate
        self._current: contextvars.ContextVar[Span | None] = \
            contextvars.ContextVar("tfidf_span", default=None)

    def configure(self, max_spans: int | None = None,
                  sample_rate: float | None = None) -> None:
        """Apply Config knobs (idempotent; called by SearchNode). A
        max_spans change re-bounds the ring in place, keeping the
        newest."""
        if sample_rate is not None:
            self.sample_rate = sample_rate
        if max_spans is not None:
            self.max_spans = max(16, max_spans)
            self._trim()

    def _trim(self) -> None:
        # append+popleft are each GIL-atomic; concurrent trimmers can
        # only over-pop by a handful of spans (harmless), never corrupt
        while len(self._ring) > self.max_spans:
            try:
                self._ring.popleft()
            except IndexError:   # raced another trimmer on empty
                break

    # ---- span lifecycle ----

    def current(self) -> Span | None:
        return self._current.get()

    def start(self, name: str,
              parent: "Span | SpanContext | None" = None,
              attrs: dict | None = None, *,
              links: "list[SpanContext] | None" = None,
              sampled: bool | None = None) -> Span:
        """Create (but do not activate) a span. With no parent this
        mints a new root trace and draws the sampling decision; with a
        parent (local span or remote context) the trace id and sampled
        flag are inherited. ``sampled`` overrides the root draw — a
        root that exists ONLY because of already-sampled spans (the
        coalescer's batch span, which links sampled requests) must
        inherit their verdict, not re-roll it: an independent draw
        would drop a sampled request's entire scatter sub-trace with
        probability (1 - sample_rate)."""
        if parent is None:
            trace_id = _new_id(64)
            if sampled is None:
                sampled = (self.sample_rate >= 1.0
                           or _rng.random() < self.sample_rate)
            parent_id = None
        else:
            ctx = parent.context if isinstance(parent, Span) else parent
            trace_id, parent_id, sampled = (ctx.trace_id, ctx.span_id,
                                            ctx.sampled)
        span = Span(name, trace_id, _new_id(32), parent_id, sampled,
                    attrs)
        if links:
            for ctx in links:
                span.add_link(ctx)
        return span

    def finish(self, span: Span) -> None:
        span.end_s = _EPOCH0 + time.monotonic()
        if span.sampled:
            self._ring.append(span)
            self._trim()

    @contextlib.contextmanager
    def span(self, name: str,
             parent: "Span | SpanContext | None" = None,
             attrs: dict | None = None, *,
             links: "list[SpanContext] | None" = None,
             sampled: bool | None = None) -> Iterator[Span]:
        """Start + ACTIVATE a span for the ``with`` body: it becomes
        :meth:`current` on this thread (contextvar token-reset on
        exit), gets an ``error`` attr if the body raises, and is
        finished into the ring either way."""
        sp = self.start(name, parent=parent, attrs=attrs, links=links,
                        sampled=sampled)
        token = self._current.set(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set_attr("error", repr(e)[:200])
            raise
        finally:
            self._current.reset(token)
            self.finish(sp)

    @contextlib.contextmanager
    def activate(self, span: Span | None) -> Iterator[None]:
        """Make an EXISTING span current for the ``with`` body (used by
        pipeline stage threads that execute work submitted under a
        span). Does not finish it. ``None`` is a no-op."""
        if span is None:
            yield
            return
        token = self._current.set(span)
        try:
            yield
        finally:
            self._current.reset(token)

    # ---- export ----

    def recent(self, n: int = 100) -> list[dict]:
        """The newest ``n`` finished spans, newest first."""
        if n <= 0:
            return []
        snap = list(self._ring)
        return [s.to_dict() for s in snap[-n:]][::-1]

    def get_trace(self, trace_id: str,
                  follow_links: bool = True) -> list[dict]:
        """Every finished span of ``trace_id``, start-ordered — plus,
        with ``follow_links``, the spans of every trace reachable over
        one link hop (the coalescer boundary: a request trace pulls in
        its batch trace's scatter/worker/failover spans, and a batch
        trace pulls in its absorbed requests)."""
        snap = list(self._ring)
        want = {trace_id}
        if follow_links:
            for s in snap:
                if s.trace_id == trace_id:
                    want.update(t for t, _sid in s.links)
                elif any(t == trace_id for t, _sid in s.links):
                    want.add(s.trace_id)
        out = [s for s in snap if s.trace_id in want]
        out.sort(key=lambda s: s.start_s)
        return [s.to_dict() for s in out]

    def clear(self) -> None:
        self._ring.clear()


global_tracer = Tracer()


# ---- module-level conveniences (the hot-path API) ----

def current_span() -> Span | None:
    return global_tracer.current()


def current_trace_id() -> str | None:
    """The active trace id (for log-record correlation), or None."""
    s = global_tracer.current()
    return s.trace_id if s is not None else None


def span_event(name: str, **attrs) -> None:
    """Annotate the active span; no-op with no span active (so library
    code — resilience retries, breaker trips, fault fires — can emit
    unconditionally without caring whether a request is traced)."""
    s = global_tracer.current()
    if s is not None:
        s.event(name, **attrs)


def propagation_headers() -> dict[str, str]:
    """``X-Trace-Id``/``X-Span-Id`` for the active span (empty when no
    span is active). The shared HTTP helpers in cluster/node.py merge
    this into every outbound request, so the trace context crosses
    every leader→worker RPC by construction."""
    s = global_tracer.current()
    if s is None or not s.sampled:
        # an unsampled trace never propagates: downstream spans would
        # be recorded against a root nobody kept (remote continuations
        # are always treated as sampled)
        return {}
    return {TRACE_HEADER: s.trace_id, SPAN_HEADER: s.span_id}


def remote_context(trace_id: str | None, span_id: str | None,
                   trusted: bool = True) -> SpanContext | None:
    """Rebuild the propagated context from incoming headers (None when
    the request is untraced).

    ``trusted`` (the worker plane's leader→worker continuation): the
    sampling decision was made where the root was minted, and an
    unsampled trace never propagates — so the context is sampled
    whenever this node has tracing enabled at all.

    Untrusted (the public ``/leader/*`` front door): the caller keeps
    its trace id — correlation still works end to end — but recording
    is subject to THIS node's own sampling draw, exactly like a
    locally-minted root. A client attaching ``X-Trace-Id`` headers
    must not buy 100% recording under a partial ``trace_sample_rate``
    (it would control ring retention and recording cost)."""
    if not trace_id:
        return None
    # ids must be well-formed hex on BOTH paths (ours are 16/8 chars;
    # W3C-style up to 32 accepted) — the worker endpoints share the
    # public listener, so even the "trusted" continuation can carry a
    # hostile header: arbitrary bytes must never be stored in the
    # ring, stamped into key=value log lines (field-injection into
    # the machine-parseable stream), or echoed through response
    # headers. Our own leader always sends valid hex, so the check
    # costs one regex per RPC. Malformed ids fall back to a
    # freshly-minted root.
    if _ID_RE.fullmatch(trace_id) is None or (
            span_id and _ID_RE.fullmatch(span_id) is None):
        return None
    rate = global_tracer.sample_rate
    if trusted:
        sampled = rate > 0
    else:
        sampled = rate >= 1.0 or _rng.random() < rate
    return SpanContext(trace_id, span_id or "", sampled)


# ---- rendering ----

def to_chrome_trace(spans: list[dict]) -> dict:
    """Chrome-trace/Perfetto JSON (``chrome://tracing`` / ui.perfetto.dev
    both load it): one complete ("X") event per span on a per-trace
    track, instant ("i") events for span events."""
    events = []
    tids = {}
    for s in spans:
        tid = tids.setdefault(s["trace_id"], len(tids) + 1)
        events.append({
            "ph": "X", "name": s["name"], "pid": 1, "tid": tid,
            "ts": round(s["start_s"] * 1e6, 1),
            "dur": round(s["duration_ms"] * 1e3, 1),
            "args": {**s["attrs"], "span_id": s["span_id"],
                     "trace_id": s["trace_id"]}})
        for ev in s["events"]:
            events.append({
                "ph": "i", "name": ev["name"], "pid": 1, "tid": tid,
                "ts": round(ev["t_s"] * 1e6, 1), "s": "t",
                "args": dict(ev["attrs"])})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def render_trace_tree(spans: list[dict]) -> str:
    """Human-readable timeline: spans as an indented tree (parent →
    children by span id; link-only spans grouped under their linking
    root), one line per span with offset/duration and its events. The
    CLI ``trace`` subcommand and ``make trace-demo`` both print this."""
    if not spans:
        return "(no spans)"
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str | None, list[dict]] = {}
    for s in spans:
        pid = s["parent_id"] if s["parent_id"] in by_id else None
        children.setdefault(pid, []).append(s)
    for v in children.values():
        v.sort(key=lambda s: s["start_s"])
    t0 = min(s["start_s"] for s in spans)
    out: list[str] = []

    def walk(s: dict, depth: int) -> None:
        off = (s["start_s"] - t0) * 1e3
        attrs = " ".join(f"{k}={v}" for k, v in sorted(
            s["attrs"].items()))
        out.append(f"{'  ' * depth}{off:8.1f}ms "
                   f"+{s['duration_ms']:.1f}ms  {s['name']}"
                   f"  [{s['trace_id'][:8]}]"
                   + (f"  {attrs}" if attrs else ""))
        for ev in s["events"]:
            eoff = (ev["t_s"] - t0) * 1e3
            ea = " ".join(f"{k}={v}" for k, v in sorted(
                ev["attrs"].items()))
            out.append(f"{'  ' * depth}  {eoff:8.1f}ms   "
                       f"· {ev['name']}" + (f"  {ea}" if ea else ""))
        for c in children.get(s["span_id"], ()):
            walk(c, depth + 1)

    for root in children.get(None, ()):
        walk(root, 0)
    return "\n".join(out)


# ---- phase timing hooks (original API, now span-aware) ----

@contextlib.contextmanager
def trace_phase(name: str) -> Iterator[None]:
    t0 = time.perf_counter()
    with record_function(name):
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            global_metrics.observe(f"phase_{name}", dt)
            # fold the engine phase into the request timeline: lands on
            # whatever span is active (the worker's process-batch span,
            # or a pipeline stage's activated submit-time span)
            span_event(f"phase.{name}", ms=round(dt * 1e3, 3))


def phase_timings() -> dict[str, float]:
    """Snapshot of per-phase timing stats (phase_* keys only)."""
    return {k: v for k, v in global_metrics.snapshot().items()
            if k.startswith("phase_")}
