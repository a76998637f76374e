"""Serving pipeline executor: N-deep dispatch/fetch overlap.

The one-deep pipelining trick that lived inside ``Searcher.search``
(dispatch chunk i+1's device program before fetching chunk i's packed
top-k) only overlapped chunks of ONE ``search_batch`` call. Concurrent
callers — the worker data plane serving several ``/worker/process-batch``
scatter RPCs at once — each ran their own dispatch-then-drain loop in
their own handler thread, so their device→host fetches serialized: while
handler A blocked in a fetch, nobody was dispatching B's next chunk, and
the device sat idle for a full RTT per chunk.

:class:`PipelineExecutor` hoists that loop into a shared two-thread
pipeline attached to the searcher:

* the **dispatch thread** runs ``dispatch()`` callbacks strictly in
  submission order — device-program launches (and the host-side query
  vectorization feeding them) stay serialized exactly as before, so
  compiled-shape reuse and the ``_u_floor`` ratchet need no locking;
* the **fetch thread** runs ``fetch()`` callbacks, also in dispatch
  order — each is ONE device→host transfer of the packed top-k buffer
  and nothing else (hit assembly happens on the caller's thread, off
  the critical path);
* a bounded hand-off queue between them enforces the in-flight budget:
  at most ``depth`` dispatched-but-unfetched chunks queue, plus the one
  the dispatch thread is holding — the same depth+1 accounting
  ``Searcher._run_pipelined`` documented (HBM must budget depth+1
  packed buffers).

Because the executor is shared per searcher, chunks from CONCURRENT
search calls interleave at chunk granularity: batch B's device program
launches while batch A's fetch is still on the wire. Each chunk is a
pure function of (snapshot, queries), so interleaving cannot change any
caller's results — the parity gate in ``tests/test_pipeline.py`` holds
bit-identical output against the unpipelined path.

Threads start lazily on first submit and exit after ``idle_s`` without
work (tests build thousands of short-lived engines; parking two threads
forever on each would pile up), reviving transparently on the next
submit.
"""

from __future__ import annotations

import atexit
import threading
import time
import weakref
from collections import deque
from concurrent.futures import Future

from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import current_span, global_tracer

# Every live executor, stopped at interpreter exit: a daemon thread
# reaped DURING finalization while inside XLA's C++ fetch path dies via
# pthread_exit unwinding C++ frames — "terminate called without an
# active exception" and a SIGABRT that can fail a green test run at the
# very last instant. Joining the threads before teardown removes the
# race entirely.
_live_executors: "weakref.WeakSet[PipelineExecutor]" = weakref.WeakSet()


def _stop_all_executors() -> None:
    for ex in list(_live_executors):
        try:
            ex.stop()
        except Exception:
            pass


atexit.register(_stop_all_executors)


class _Job:
    __slots__ = ("dispatch", "fetch", "future", "span")

    def __init__(self, dispatch, fetch, future: Future,
                 span=None) -> None:
        self.dispatch = dispatch
        self.fetch = fetch
        self.future = future
        # the SUBMITTER's active trace span: the stage threads have no
        # request context of their own, so each stage re-activates this
        # span while running — pipeline.dispatch/fetch events (and the
        # engine's trace_phase events inside dispatch) land on the
        # request timeline they belong to
        self.span = span


class PipelineExecutor:
    """Two-stage (dispatch → fetch) pipeline with futures per chunk.

    ``submit(dispatch, fetch)`` returns a :class:`Future` resolving to
    ``fetch(*dispatch())``. Dispatches run in submission order on one
    thread; fetches run in dispatch order on another; at most ``depth``
    dispatched chunks wait unfetched (depth+1 in flight counting the
    one being dispatched). An exception in either stage resolves that
    chunk's future and leaves the pipeline serving later chunks — one
    caller's failure never poisons a concurrent caller's batch.
    """

    def __init__(self, depth: int = 2, *, name: str = "pipeline",
                 idle_s: float = 30.0) -> None:
        self.depth = max(1, depth)
        self.name = name
        self.idle_s = idle_s
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._dispatch_q: deque[_Job] = deque()
        # bounded hand-off: the dispatch thread blocks holding chunk
        # N+depth+1 until the fetch thread drains chunk N+1
        self._fetch_q: deque = deque()
        self._fetch_ready = threading.Condition(self._lock)
        self._space = threading.Condition(self._lock)
        self._fetch_busy = 0   # 1 while a fetch is executing (counts
        #                        toward the depth budget alongside the
        #                        queued hand-offs)
        self._dispatch_thread: threading.Thread | None = None
        self._fetch_thread: threading.Thread | None = None
        self._stopping = False
        _live_executors.add(self)

    # ---- public API ----

    def submit(self, dispatch, fetch) -> Future:
        """Queue one chunk. ``dispatch()`` launches device work and
        returns a state tuple; ``fetch(*state)`` performs the d2h
        transfer and returns the future's result."""
        fut: Future = Future()
        sp = current_span()
        if sp is not None and not sp.sampled:
            sp = None
        with self._lock:
            if self._stopping:
                raise RuntimeError(f"{self.name} executor stopped")
            self._dispatch_q.append(_Job(dispatch, fetch, fut, sp))
            self._ensure_threads_locked()
            self._work.notify()
        return fut

    def stop(self) -> None:
        """Fail pending chunks and stop both threads (idempotent)."""
        with self._lock:
            self._stopping = True
            pending = list(self._dispatch_q)
            self._dispatch_q.clear()
            self._work.notify_all()
            self._fetch_ready.notify_all()
            self._space.notify_all()
            threads = [t for t in (self._dispatch_thread,
                                   self._fetch_thread) if t is not None]
        for job in pending:
            job.future.cancel()
        for t in threads:
            t.join(timeout=2.0)

    # ---- threads ----

    def _ensure_threads_locked(self) -> None:
        if self._dispatch_thread is None \
                or not self._dispatch_thread.is_alive():
            self._dispatch_thread = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=f"{self.name}-dispatch")
            self._dispatch_thread.start()
        if self._fetch_thread is None \
                or not self._fetch_thread.is_alive():
            self._fetch_thread = threading.Thread(
                target=self._fetch_loop, daemon=True,
                name=f"{self.name}-fetch")
            self._fetch_thread.start()

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._dispatch_q and not self._stopping:
                    if not self._work.wait(timeout=self.idle_s):
                        if self._dispatch_q:
                            continue   # work raced the timeout
                        # clear the slot UNDER THE LOCK before exiting:
                        # is_alive() stays True while this frame
                        # unwinds, and _ensure_threads_locked must not
                        # mistake a deciding-to-exit thread for a live
                        # one (a just-submitted job would strand)
                        if self._dispatch_thread \
                                is threading.current_thread():
                            self._dispatch_thread = None
                        return         # idle exit; submit() revives
                if self._stopping:
                    return
                job = self._dispatch_q.popleft()
            if not job.future.set_running_or_notify_cancel():
                continue   # cancelled (an earlier sibling failed)
            try:
                t0 = time.perf_counter()
                with global_tracer.activate(job.span):
                    state = job.dispatch()
                if job.span is not None:
                    job.span.event(
                        "pipeline.dispatch", stage=self.name,
                        ms=round((time.perf_counter() - t0) * 1e3, 3))
            except BaseException as e:
                global_metrics.inc(f"{self.name}_dispatch_failures")
                job.future.set_exception(e)
                continue
            with self._lock:
                # depth+1 accounting: block HOLDING the dispatched
                # state until the fetch pipeline (queued hand-offs plus
                # the one being fetched) has room
                while len(self._fetch_q) + self._fetch_busy >= self.depth \
                        and not self._stopping:
                    self._space.wait(timeout=0.5)
                if self._stopping:
                    # already RUNNING, so cancel() would be a no-op and
                    # the caller would wait forever — fail it instead
                    job.future.set_exception(
                        RuntimeError(f"{self.name} executor stopped"))
                    return
                self._fetch_q.append((job, state))
                self._fetch_ready.notify()
                self._ensure_threads_locked()

    def _fetch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._fetch_q and not self._stopping:
                    if not self._fetch_ready.wait(timeout=self.idle_s):
                        if self._fetch_q:
                            continue
                        if self._fetch_thread \
                                is threading.current_thread():
                            self._fetch_thread = None   # see above
                        return         # idle exit; dispatch revives
                if self._stopping and not self._fetch_q:
                    return
                job, state = self._fetch_q.popleft()
                self._fetch_busy = 1
            try:
                t0 = time.perf_counter()
                with global_tracer.activate(job.span):
                    job.future.set_result(job.fetch(*state))
                if job.span is not None:
                    job.span.event(
                        "pipeline.fetch", stage=self.name,
                        ms=round((time.perf_counter() - t0) * 1e3, 3))
            except BaseException as e:
                global_metrics.inc(f"{self.name}_fetch_failures")
                job.future.set_exception(e)
            finally:
                with self._lock:
                    self._fetch_busy = 0
                    self._space.notify()
