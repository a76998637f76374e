"""Scale-out query plane: the scatter read plane + the stateless router.

The single-coordinator design inherited from the reference (every query
funnels through the elected leader's scatter loop, ``Leader.java:39-92``)
caps the whole cluster's interactive front door near one Python
process's worth of HTTP + merge work — ~92 q/s in OVERLOAD.json against
a 6,243 q/s engine. This module retires that ceiling by splitting the
node into two planes:

- **Read plane** (:class:`ScatterReadPlane`) — the scatter / owner-merge
  / failover / hedge spine, extracted from ``node.py`` so it no longer
  requires leadership. It runs against *any* placement view object: the
  leader's authoritative :class:`~tfidf_tpu_torch.cluster.placement.PlacementMap`,
  or a read-only :class:`~tfidf_tpu_torch.cluster.placement.PlacementFollower`
  loaded from the durable placement znode and refreshed by a data watch.
  A follower-routed merge NEVER falls back to the legacy sum-merge for
  names outside its view (with R replicas both copies would be summed —
  a silent double count); unknown names are dropped and the response is
  marked degraded instead. Every ``/leader/start`` reply is stamped with
  the ``(epoch, generation)`` pair it routed under, and a view that
  cannot be confirmed fresh (coordinator partition) degrades honestly
  (``X-Scatter-Degraded`` carrying ``stale_view=1``, result cache
  bypassed) and self-heals on the next watch fire.

- **Mutation plane** — stays on the elected leader: placement routing,
  replication, reconcile/repair, rebalancing, deletes. A router (and a
  non-leader node) forwards ``/leader/upload[-batch]`` / ``/leader/delete``
  to the leader published at ``/leader_info`` instead of serving them.

:class:`QueryRouter` is the dedicated stateless tier built on the read
plane (``python -m tfidf_tpu_torch router``): it owns its OWN admission
controller, scatter coalescer, generation-keyed result cache, resilience
stack (breakers/retries/hedges/deadlines), and placement follower — so
admitted interactive throughput scales with router count
while correctness still rests on per-request owner assignment. Routers
register ephemeral znodes under ``/router_registry`` so ``status`` and
``/api/routers`` can enumerate the tier; the k8s Deployment + HPA in
``deploy/k8s.yaml`` scale it on the per-router
``tfidf_last_router_scatter_queue_depth`` gauge.
"""

from __future__ import annotations

import contextlib
import email.parser
import email.policy
import json
import math
import threading
import time
import urllib.error
import urllib.parse
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from concurrent.futures import wait as _fwait
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tfidf_tpu_torch.cluster.admission import (LANE_BULK, LANE_INTERACTIVE,
                                               AdmissionController, ResultCache)
from tfidf_tpu_torch.cluster.autopilot import Autopilot
from tfidf_tpu_torch.cluster.batcher import Coalescer
from tfidf_tpu_torch.cluster.coordination import (EPHEMERAL_SEQUENTIAL,
                                                  NoNodeError)
from tfidf_tpu_torch.cluster.fusion import FUSION_METHODS, fuse
from tfidf_tpu_torch.cluster.placement import PlacementFollower, PlacementMap
from tfidf_tpu_torch.cluster.protover import (PROTO_HEADER,
                                              PROTO_REJECTED_HEADER,
                                              PROTO_STATUS, PROTO_VERSION,
                                              in_window, parse_version)
from tfidf_tpu_torch.cluster.quarantine import (PoisonQuarantine,
                                                poison_fingerprint)
from tfidf_tpu_torch.cluster.registry import ServiceRegistry, read_leader_info
from tfidf_tpu_torch.cluster.resilience import (CircuitOpenError,
                                                ClusterResilience,
                                                DeadlineExpired, hedge_laggards)
from tfidf_tpu_torch.cluster.wire import unpack_hit_lists
from tfidf_tpu_torch.utils import storage as _storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import (SPAN_HEADER, TRACE_HEADER,
                                           global_tracer, remote_context,
                                           to_chrome_trace)

log = get_logger("cluster.router")

ROUTER_REGISTRY_NAMESPACE = "/router_registry"
ROUTER_PREFIX = "r_"


def register_router(coord, address: str) -> str:
    """Announce a router to the cluster: an ephemeral-sequential znode
    under ``/router_registry`` whose payload is the router's base URL
    (the same shape as the worker registry). ``/api/routers`` and the
    CLI ``status`` routers block enumerate these."""
    coord.ensure(ROUTER_REGISTRY_NAMESPACE)
    return coord.create(f"{ROUTER_REGISTRY_NAMESPACE}/{ROUTER_PREFIX}",
                        address.encode(), mode=EPHEMERAL_SEQUENTIAL)


def list_routers(coord) -> list[str]:
    """The registered router URLs (empty when none / namespace absent)."""
    try:
        names = coord.get_children(ROUTER_REGISTRY_NAMESPACE)
    except NoNodeError:
        return []
    out = []
    for name in names:
        try:
            out.append(coord.get_data(
                f"{ROUTER_REGISTRY_NAMESPACE}/{name}").decode())
        except NoNodeError:
            continue   # vanished between listing and read
    return out


class ScatterReadPlane:
    """The scatter/merge/failover/hedge spine, shared by the leader,
    any-node reads, and the stateless router tier.

    Hosts must provide (see ``SearchNode.__init__`` /
    ``QueryRouter.__init__``): ``config``, ``registry``, ``placement``,
    ``resilience``, ``_pool``, ``_slice_pool``, ``_scatter``,
    ``scatter_batcher``, ``result_cache``, ``hedge_ms``,
    ``_cluster_epoch``, ``_legacy_hit_workers``, ``_scatter_health``,
    and ``df_signature()``. The policy hooks below route reads through
    the right placement view:

    - :meth:`_read_placement` — the view THIS request routes under
      (authoritative map on the leader; follower view elsewhere).
      ``_gather_merge`` captures it ONCE per request and derives the
      merge policy from the captured object: a FOLLOWER view never
      legacy-sums names outside it (the view being behind means R
      replicas' copies would be silently double-counted — dropped and
      degraded instead), and the stale-view verdict comes from the
      same captured view (a role flip mid-request can change what
      ``_read_placement`` returns, never what this request routed
      under);
    - :meth:`_view_suspect` — whether the CURRENT view can be vouched
      for: gates the result-cache consult before dispatch.
    """

    # attribute contracts for the static analyzers (graftcheck): the
    # hosts construct these in their __init__
    config: Config
    registry: ServiceRegistry
    placement: PlacementMap
    resilience: ClusterResilience
    quarantine: PoisonQuarantine

    # ---- policy hooks ----

    def _read_placement(self) -> PlacementMap:
        """The placement view for one read request (default: the
        host's authoritative map)."""
        return self.placement

    def _view_suspect(self) -> bool:
        """Is the read view possibly stale (degrade honestly)? Gates
        the result-cache consult; the merge itself re-derives the
        marker from the ONE view it captured (see _gather_merge — the
        per-request honesty verdict must never consult ambient state
        a concurrent role flip can change mid-request)."""
        sus = getattr(self._read_placement(), "suspect", None)
        return bool(sus()) if sus is not None else False

    @staticmethod
    def _view_stamp(pmap) -> tuple[int | None, int]:
        """The ``(epoch, generation)`` pair a request routed under —
        stamped on every read reply (``X-Route-Epoch`` /
        ``X-Route-Generation``) so a client (and the chaos suites) can
        tell exactly which placement world produced a result."""
        if isinstance(pmap, PlacementFollower):
            return pmap.loaded_epoch, pmap.loaded_gen
        return pmap.epoch, pmap.gen

    # ---- read path (leader/Leader.java:39-92 lineage) ----

    def leader_search(self, query: str,
                      lane: str = LANE_INTERACTIVE) -> dict[str, float]:
        """Scatter-gather search (``Leader.java:39-92``): fan the query out
        to every registered worker, tolerate per-worker failure, merge
        scores by document name under the per-request owner assignment.

        Default path: concurrent queries coalesce into one batched RPC
        per worker (:meth:`_scatter_search_batch`). The per-query JSON
        fan-out below remains for unbounded-results (parity) configs and
        ``scatter_micro_batch=False``."""
        return self.leader_search_with_health(query, lane=lane)[0]

    # per-query JSON scatter budget (the reference's 10s RestTemplate
    # default) — propagated to workers as X-Deadline-Ms like the
    # batched path's scatter_timeout_s
    _PER_QUERY_BUDGET_S = 10.0

    def leader_search_with_health(self, query: str,
                                  lane: str = LANE_INTERACTIVE,
                                  mode: str = "sparse",
                                  fusion: str | None = None
                                  ) -> tuple[dict[str, float], dict]:
        """``leader_search`` plus this request's OWN health marker —
        ``(merged, {attempted, responded, circuit_open, degraded,
        failovers, dark, dropped, stale_view, ...})``. The handler
        stamps the degraded header from the returned value: reading it
        back off shared node state would let two concurrent scatters
        mislabel each other's replies.

        ``lane`` routes the query through the scatter coalescer's
        weighted dequeue (bulk can never starve interactive). The
        result cache is consulted first — but never while the read
        view is suspect (a stale router serving pre-partition cache
        entries would be silently wrong in exactly the window the
        degraded marker exists for). The generation token is captured
        BEFORE dispatch, so a commit (or view refresh) that lands
        mid-scatter invalidates the entry this request inserts."""
        token = self.df_signature()
        # hybrid plan (wire v3): mode/fusion compose into the cache key
        # (a hybrid result must never answer a sparse query or vice
        # versa) and ride the coalescer item so batches stay homogeneous
        # per (mode, fusion) via the group key.
        qkey = (query if mode == "sparse"
                else f"\x00{mode}\x00{fusion or ''}\x00{query}")
        cache = self.result_cache if not self._view_suspect() else None
        if cache is not None:
            hit = cache.get(qkey, token)
            if hit is not None:
                # a cache hit did no fan-out: its health marker says so
                # (and is never recorded into the shared gauges — it
                # would misreport the last real scatter's health). The
                # route stamp still applies: EVERY read reply names the
                # placement world it was served under, cached or not
                # (the entry's token is that world by construction).
                epoch, gen = self._view_stamp(self._read_placement())
                return hit, {"attempted": 0, "responded": 0,
                             "circuit_open": 0, "degraded": 0,
                             "failovers": 0, "dark": 0, "dropped": 0,
                             "stale_view": 0, "cached": 1,
                             "route_epoch": epoch, "route_gen": gen}
        if self.scatter_batcher is not None:
            result, health = self.scatter_batcher.submit(
                (query, mode, fusion), lane=1 if lane == LANE_BULK else 0)
            if cache is not None and not health.get("degraded"):
                cache.put(qkey, token, result)
            return result, health
        if mode != "sparse":
            # no coalescer (unbounded-results / micro-batch-off
            # configs): staged queries still go through the batched
            # scatter — the per-query JSON path below is sparse-only —
            # as a one-item batch
            result, health = self._scatter_search_batch(
                [(query, mode, fusion)])[0]
            if cache is not None and not health.get("degraded"):
                cache.put(qkey, token, result)
            return result, health
        log.info("scatter search", query=query)
        body = json.dumps({"query": query}).encode()
        t_deadline = time.monotonic() + self._PER_QUERY_BUDGET_S

        def rpc_one(addr: str, live: set[str],
                    deadline: float) -> list[list[tuple[str, float]]]:
            global_injector.check("leader.worker_rpc")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # pre-dispatch: no RPC happens, so the breaker must
                # record NOTHING (DeadlineExpired releases it)
                raise DeadlineExpired(addr + ": budget spent")
            hits = json.loads(self._scatter.post(
                addr, "/worker/process", body, timeout=remaining,
                live=live,
                headers={"X-Deadline-Ms": str(int(remaining * 1e3))}))
            return [[(h["document"]["name"], float(h["score"]))
                     for h in hits]]

        merged, health = self._gather_merge([query], rpc_one, t_deadline)
        result = self._order_merged(merged[0])
        if cache is not None and not health.get("degraded"):
            cache.put(query, token, result)
        return result, health

    def _record_scatter_health(self, attempted: int, responded: int,
                               circuit_open: int, failovers: int = 0,
                               dark: int = 0,
                               uncovered_workers: int = 0,
                               dropped: int = 0,
                               stale_view: int = 0) -> dict:
        """Publish one fan-out's health: gauges in /api/metrics plus a
        last-observed copy on the node (for the CLI summary). Returns
        the marker dict — the handler stamps the degraded header from
        the RETURNED value, which belongs to this request alone.

        ``degraded`` means the RESULTS may be incomplete or stale —
        not merely that a worker failed. A worker death fully absorbed
        by replica failover yields a complete, non-degraded response;
        documents with no live scorer (``dark``), a failed worker
        outside the view's knowledge, hits DROPPED because a follower
        view cannot merge them safely, and a view that cannot be
        confirmed fresh (``stale_view``) all keep the marker honest."""
        degraded = 1 if (dark > 0 or uncovered_workers > 0
                         or dropped > 0 or stale_view) else 0
        health = {
            "attempted": attempted, "responded": responded,
            "circuit_open": circuit_open, "degraded": degraded,
            "failovers": failovers, "dark": dark,
            "dropped": dropped, "stale_view": stale_view}
        self._scatter_health = health
        global_metrics.set_gauge("scatter_last_attempted", attempted)
        global_metrics.set_gauge("scatter_last_responded", responded)
        global_metrics.set_gauge("scatter_last_circuit_open", circuit_open)
        global_metrics.set_gauge("scatter_last_failovers", failovers)
        global_metrics.set_gauge("scatter_last_dark", dark)
        global_metrics.set_gauge("scatter_degraded", degraded)
        global_metrics.set_gauge("breaker_open_workers",
                                 self.resilience.board.open_count())
        if failovers:
            global_metrics.inc("scatter_failovers", failovers)
        if stale_view:
            global_metrics.inc("router_stale_responses")
        if degraded:
            global_metrics.inc("degraded_responses")
        return health

    def _order_merged(self, merged: dict[str, float]) -> dict[str, float]:
        """Truncate + order one query's sum-merged scores."""
        if not self.config.unbounded_results:
            # each document lives on exactly one worker, so the global
            # top-k is contained in the union of per-worker top-ks —
            # truncating the merge to k is exact
            merged = dict(sorted(merged.items(),
                                 key=lambda kv: (-kv[1], kv[0]))
                          [:self.config.top_k])
        if self.config.result_order == "name":
            # alphabetical, the reference's TreeMap order (Leader.java:80-91)
            return dict(sorted(merged.items()))
        return dict(sorted(merged.items(), key=lambda kv: (-kv[1], kv[0])))

    def _scatter_search_batch(
            self, queries: list[str]) -> list[dict[str, float]]:
        """Batched scatter-gather: ONE ``/worker/process-batch`` RPC per
        worker for a whole coalesced query group, packed-binary replies
        (:mod:`tfidf_tpu_torch.cluster.wire`), per-query owner-merge at the
        gatherer (:meth:`_gather_merge`). Collapses the per-(query,
        worker) HTTP + JSON cost that otherwise caps the distributed
        path (the reference pays it by design, one RestTemplate POST
        per worker per query, ``Leader.java:51-70``). A failed worker's
        ownership slice fails over to surviving replicas WITHIN this
        request.

        Items are plain query strings (sparse) or ``(query, mode,
        fusion)`` tuples — the coalescer's group key keeps a batch
        homogeneous in (mode, fusion), so one batch runs ONE plan.
        Staged plans (mode dense|hybrid, wire v3) ask each worker for
        ``2n`` hit lists (n sparse + n dense), owner-merge each stage
        independently (per-stage global top-k is exact — one owner per
        doc), and fuse the two merged maps per query
        (:mod:`tfidf_tpu_torch.cluster.fusion`)."""
        items = [(q, "sparse", None) if isinstance(q, str) else q
                 for q in queries]
        queries = [q for q, _m, _f in items]
        mode = items[0][1]
        fusion = items[0][2] or self.config.fusion_method
        staged = mode != "sparse"
        payload = {"queries": queries, "k": self.config.top_k}
        if staged:
            payload["mode"] = mode
        body = json.dumps(payload).encode()
        t_deadline = time.monotonic() + self.config.scatter_timeout_s

        def rpc_one(addr: str, live: set[str],
                    deadline: float) -> list[list[tuple[str, float]]]:
            global_injector.check("leader.worker_rpc")
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # the budget is already spent: fail locally instead of
                # shipping a batch the worker will (rightly) refuse —
                # and record nothing on the breaker (no RPC happened)
                raise DeadlineExpired(addr + ": budget spent")
            t0 = time.perf_counter()
            raw = self._scatter.post(
                addr, "/worker/process-batch", body,
                timeout=remaining, live=live,
                headers={"X-Deadline-Ms": str(int(remaining * 1e3))})
            global_metrics.observe("scatter_rpc",
                                   time.perf_counter() - t0)
            t1 = time.perf_counter()
            hit_lists = unpack_hit_lists(raw)
            global_metrics.observe("scatter_decode",
                                   time.perf_counter() - t1)
            return hit_lists

        merged, health = self._gather_merge(
            queries, rpc_one, t_deadline,
            slots=len(queries) * 2 if staged else None,
            slice_extra={"mode": mode} if staged else None)
        t0 = time.perf_counter()
        if staged:
            # fuse AFTER the per-stage global owner-merge: each stage's
            # merged map contains the union of per-worker top-ks, so
            # its rank_list is the exact global stage top-k — fusing
            # two exact lists matches the single-node oracle.
            n = len(queries)
            c = self.config
            fused: list[dict[str, float]] = []
            for i in range(n):
                if mode == "dense":
                    fused.append(merged[n + i])
                else:
                    fused.append(fuse(
                        merged[i], merged[n + i], method=fusion,
                        k=c.top_k, rrf_k=c.fusion_rrf_k,
                        w_sparse=c.fusion_weight_sparse,
                        w_dense=c.fusion_weight_dense))
            merged = fused
            global_metrics.inc("hybrid_scatter_batches")
        # one (result, health) pair per coalesced query: every caller in
        # the group shares this batch's fan-out, so each reply carries
        # this batch's marker
        out = [(self._order_merged(m), health) for m in merged]
        global_metrics.observe("scatter_merge", time.perf_counter() - t0)
        return out

    def _slice_call(self, addr: str, queries: list[str],
                    names: list[str], t_deadline: float,
                    live: set[str], trace_parent=None,
                    kind: str = "failover",
                    extra: dict | None = None
                    ) -> list[list[tuple[str, float]]]:
        """Failover / hedged read: score the ``names`` ownership slice
        on a surviving replica (one breaker-gated, retried logical
        RPC). Exact within the slice — the worker computes the full
        ranking host-side and filters, so no slice document can be
        truncated out by documents outside it.

        ``trace_parent`` parents the slice span under the scatter span
        that dispatched it (the slice pool thread has no ambient
        context); ``kind`` distinguishes a failover re-issue from a
        hedged duplicate in the trace. ``extra`` carries additional
        request fields — the staged plan's ``mode``, so a failover
        slice re-issues BOTH scoring stages the dead owner would have
        run."""
        def rpc() -> list[list[tuple[str, float]]]:
            global_injector.check("leader.replica_rpc")
            remaining = t_deadline - time.monotonic()
            if remaining <= 0:
                raise DeadlineExpired(addr + ": budget spent")
            body = json.dumps({"queries": queries,
                               "names": names,
                               **(extra or {})}).encode()
            raw = self._scatter.post(
                addr, "/worker/process-batch", body,
                timeout=remaining, live=live,
                headers={"X-Deadline-Ms": str(int(remaining * 1e3))})
            return unpack_hit_lists(raw)

        def run():
            return self.resilience.worker_call(addr, rpc,
                                               track_latency=True)

        if trace_parent is None:
            return run()
        with global_tracer.span(
                "scatter.slice", parent=trace_parent,
                attrs={"worker": addr, "kind": kind,
                       "names": len(names)}):
            return run()

    def _gather_merge(self, queries: list[str], rpc_one,
                      t_deadline: float, slots: int | None = None,
                      slice_extra: dict | None = None
                      ) -> tuple[list[dict[str, float]], dict]:
        """The scatter/merge/failover spine shared by the per-query and
        batched paths — and by every read-plane host (leader, any-node
        reads, routers).

        1. Capture the read view ONCE (:meth:`_read_placement`) and
           compute this request's OWNER ASSIGNMENT: exactly one live,
           breaker-closed replica scores each mapped document, so the
           merge is double-count-free by construction.
        2. Fan the queries out to every registered worker
           (breaker-gated, retried, deadline-propagated ``rpc_one``).
           With ``scatter_hedge_ms`` set, a laggard's ownership slice
           is speculatively re-issued to the next replica while the
           primary RPC is still outstanding.
        3. Merge epoch 0: an owner's hits are ASSIGNED (not summed);
           non-owner replica hits are dropped; names outside the view
           keep the legacy sum-merge ONLY under an authoritative map —
           a follower view drops them and degrades honestly instead
           (R copies would double-count).
        4. Failover (epoch 1): documents whose owner failed or was
           breaker-open are re-issued — only the orphaned ownership
           slice — to surviving replicas within this same request.
           Hedge results are deduped by owner epoch: if the primary
           answered after all, its epoch-0 hits win and the hedge is
           discarded.

        ``slots`` is the hit-list count each worker reply must carry
        (default ``len(queries)``; the staged hybrid plan sends
        ``2 * len(queries)`` — n sparse + n dense — and each slot is
        owner-merged independently). ``slice_extra`` rides every
        failover/hedge slice request body, so a staged plan's
        re-issued slices run the same stages the dead owner would
        have (a v2 worker ignoring it replies ``len(queries)`` lists
        and fails the slot check — honest degradation, never a
        misaligned merge).
        """
        slots = slots if slots is not None else len(queries)
        workers = self.registry.get_all_service_addresses()
        live = set(workers)
        self.resilience.prune(live)   # breakers + latency EWMAs
        # ONE view per request: owner assignment, failover backups, and
        # the reply's (epoch, generation) stamp must agree on which
        # placement world this request routed under
        pmap = self._read_placement()
        excluded = pmap.pending_moved()
        open_set = frozenset(w for w in workers
                             if self.resilience.board.is_open(w))
        view = pmap.owner_assignment(frozenset(live), open_set)
        # the scatter span this request (or its coalesced batch) is
        # running under: per-worker RPCs become CHILD spans of it, and
        # failover/hedge slices parent under it too (the pool threads
        # have no ambient context of their own). None = untraced; every
        # tracing call below no-ops.
        tparent = global_tracer.current()
        if tparent is not None and not tparent.sampled:
            tparent = None

        # workers whose 2xx reply carried X-Compute-Degraded (served
        # from the host mirror: exact scores, sick device) — a
        # per-request set, recorded on the pool thread that ran the RPC
        # (set.add is atomic under the GIL), so concurrent scatters
        # never mislabel each other
        compute_degraded: set[str] = set()

        def call(addr: str):
            # scatter RPCs feed the gray-failure latency EWMA (slow
            # worker detection is scoped to THIS path — bulk uploads
            # legitimately take minutes and must not condemn a worker)
            def run():
                r = self.resilience.worker_call(
                    addr, lambda: rpc_one(addr, live, t_deadline),
                    track_latency=True)
                if self._scatter.pop_degraded():
                    compute_degraded.add(addr)
                return r
            if tparent is None:
                return run()
            with global_tracer.span("scatter.worker", parent=tparent,
                                    attrs={"worker": addr,
                                           "queries": len(queries)}):
                return run()

        futures = {self._pool.submit(call, w): w for w in workers}

        # hedged duplicate reads (The Tail at Scale): per laggard, the
        # ownership slice goes to the next replica while the primary is
        # still in flight; the merge below dedups by owner epoch
        # the hedge delay is the LIVE knob (autopilot-tunable; equals
        # config.scatter_hedge_ms unless the autopilot moved it),
        # read once so the guard and the wait agree within a request
        hedge_ms = self.hedge_ms
        hedge_futs: dict[str, list[tuple[str, list[str], object]]] = {}
        if hedge_ms > 0 and view.owned:
            def dispatch_hedge(addr: str) -> None:
                names = view.owned.get(addr)
                if not names:
                    return
                global_injector.check("leader.hedge")
                global_metrics.inc("scatter_hedges")
                if tparent is not None:
                    tparent.event("hedge_dispatched", laggard=addr)
                for backup, ns in pmap.backups_for(
                        names, exclude={addr}, live=live,
                        avoid=open_set).items():
                    hedge_futs.setdefault(addr, []).append(
                        (backup, ns, self._slice_pool.submit(
                            self._slice_call, backup, queries, ns,
                            t_deadline, live, tparent, "hedge",
                            slice_extra)))
            hedge_laggards(dict(futures), hedge_ms / 1e3,
                           dispatch_hedge)

        ok: dict[str, list] = {}
        failed: set[str] = set()
        circuit_open = 0
        for fut, addr in futures.items():
            try:
                if addr in hedge_futs:
                    # the laggard is raced by its hedge: wait for
                    # WHICHEVER side lands first — a primary that
                    # answered right after the hedge fired must not
                    # stall behind a slower hedge slice. The primary
                    # wins whenever it made it (owner-epoch dedup);
                    # once every hedge settled it gets only a short
                    # grace. An abandoned primary that lands later
                    # still settles its breaker accounting in the pool
                    # thread; its result is simply not merged.
                    hset = {hf for _b, _ns, hf in hedge_futs[addr]}
                    pending = {fut} | hset
                    while fut in pending and len(pending) > 1:
                        remaining = t_deadline - time.monotonic() + 30.0
                        if remaining <= 0:
                            break
                        _done, pending = _fwait(
                            pending, timeout=remaining,
                            return_when=FIRST_COMPLETED)
                    hedge_ok = any(
                        hf.done() and not hf.cancelled()
                        and hf.exception() is None for hf in hset)
                    if fut.done() or hedge_ok:
                        # primary landed, or a successful hedge stands
                        # ready to supersede it after a short grace
                        hit_lists = fut.result(timeout=0.05)
                    else:
                        # every hedge FAILED (e.g. the backup's breaker
                        # is open): the hedge bought nothing — wait for
                        # the still-in-budget primary like an unhedged
                        # worker instead of abandoning a healthy reply
                        try:
                            hit_lists = fut.result(timeout=max(
                                0.0, t_deadline - time.monotonic())
                                + 30.0)
                        except (FutureTimeout, TimeoutError) as e:
                            raise RuntimeError(
                                "scatter task stalled past deadline"
                            ) from e
                else:
                    # bounded by the request deadline plus grace for
                    # the retry policy's backoff sleeps (lockgraph
                    # indefinite-wait audit: a hung pool task must not
                    # wedge the scatter thread forever). Re-raised as a
                    # plain failure so it is NOT mistaken for a hedge
                    # win below.
                    try:
                        hit_lists = fut.result(timeout=max(
                            0.0, t_deadline - time.monotonic()) + 30.0)
                    except (FutureTimeout, TimeoutError) as e:
                        raise RuntimeError(
                            "scatter task stalled past deadline") from e
            except (FutureTimeout, TimeoutError):
                failed.add(addr)
                won = any(
                    hf.done() and not hf.cancelled()
                    and hf.exception() is None
                    for _b, _ns, hf in hedge_futs.get(addr, ()))
                if won:
                    global_metrics.inc("scatter_hedge_wins")
                    if tparent is not None:
                        tparent.event("hedge_win", laggard=addr)
                    log.info("hedge superseded laggard primary",
                             worker=addr)
                else:
                    # every hedge failed too: this is a plain scatter
                    # failure, not a win — keep the metrics honest
                    global_metrics.inc("scatter_failures")
                    log.warning("laggard primary abandoned with no "
                                "successful hedge", worker=addr)
                continue
            except CircuitOpenError:
                # fast-failed without an RPC: the worker's breaker is
                # open — counted separately so the health marker can
                # distinguish "skipped sick worker" from "RPC failed"
                circuit_open += 1
                failed.add(addr)
                global_metrics.inc("scatter_circuit_open")
                continue
            except Exception as e:
                # per-worker tolerance (Leader.java:67-69) — a reply
                # that fails wire validation degrades exactly like a
                # failed RPC; failover below recovers the mapped slice.
                # A poison verdict (the worker named the guilty query
                # rows in X-Poison-Fingerprints) is blamed per-worker
                # into the quarantine BEFORE failover re-issues the
                # slice: the re-issue may kill the backup's device too,
                # and its blame (a DISTINCT replica) is what crosses
                # the quarantine threshold — stopping the
                # query-of-death march before a third replica dies.
                for fp in getattr(e, "poison_fps", ()):
                    self.quarantine.note_fault(fp, addr)
                failed.add(addr)
                global_metrics.inc("scatter_failures")
                log.warning("worker failed during search", worker=addr,
                            err=repr(e))
                continue
            if len(hit_lists) != slots:
                failed.add(addr)
                global_metrics.inc("scatter_failures")
                log.warning("batch reply length mismatch", worker=addr)
                continue
            ok[addr] = hit_lists

        # ---- merge, epoch 0: owner hits (+ legacy sum for unmapped
        # names on the authoritative leader ONLY) ----
        owner = view.owner
        legacy_addrs: set[str] = set()   # workers with unmapped hits
        # merge policy derived from the CAPTURED view, never from a
        # fresh _read_placement(): a role flip mid-request (worker
        # promoted while this scatter is in flight) must not re-enable
        # the legacy sum-merge on a merge that ROUTED under a follower
        # view — with R replicas that sum silently double-counts, the
        # exact failure the view split exists to prevent
        sum_unmapped = not isinstance(pmap, PlacementFollower)
        dropped = 0
        merged: list[dict[str, float]] = [{} for _ in range(slots)]
        for addr, hit_lists in ok.items():
            skip = excluded.get(addr)
            for m, hits in zip(merged, hit_lists):
                for name, score in hits:
                    own = owner.get(name)
                    if own is not None:
                        if own == addr:
                            # exactly one owner scores each mapped doc:
                            # assignment — the sum-merge cannot double-
                            # count replicas by construction
                            m[name] = float(score)
                        elif skip is not None and name in skip:
                            # pending-reconcile copy on a rejoiner,
                            # already structurally ignored — counted so
                            # operators see the exclusion is active
                            global_metrics.inc("scatter_hits_excluded")
                        continue
                    if skip is not None and name in skip:
                        # unmapped pending-reconcile copy: the
                        # survivor's copy already counts
                        global_metrics.inc("scatter_hits_excluded")
                        continue
                    if not sum_unmapped:
                        # follower-view merge: a name outside the view
                        # (uploaded after this view was read, or the
                        # view is behind) CANNOT be merged safely — with
                        # R replicas each echoing it, the legacy sum
                        # would silently double-count. Drop it and let
                        # the degraded marker say the results may be
                        # incomplete; the next view refresh heals it.
                        dropped += 1
                        continue
                    legacy_addrs.add(addr)
                    m[name] = m.get(name, 0.0) + float(score)
        if dropped:
            global_metrics.inc("router_unmapped_hits_dropped", dropped)

        # ---- failover, epoch 1: re-issue orphaned ownership slices ----
        orphans = [n for n, w in owner.items() if w in failed]
        recovered: set[str] = set()
        if orphans:
            orphan_set = set(orphans)
            failed_backups: set[str] = set()

            def consume_slice(backup: str, ns: list[str], fut) -> None:
                try:
                    hit_lists = fut.result(timeout=max(
                        0.0, t_deadline - time.monotonic()) + 30.0)
                except Exception as e:
                    # replica-distinct poison blame: a backup whose
                    # device ALSO died on the re-issued slice is the
                    # second independent witness the quarantine needs
                    for fp in getattr(e, "poison_fps", ()):
                        self.quarantine.note_fault(fp, backup)
                    failed_backups.add(backup)
                    global_metrics.inc("scatter_failover_failures")
                    log.warning("failover slice failed", worker=backup,
                                names=len(ns), err=repr(e))
                    return
                if len(hit_lists) != slots:
                    failed_backups.add(backup)
                    global_metrics.inc("scatter_failover_failures")
                    return
                ns_set = set(ns) & orphan_set
                for m, hits in zip(merged, hit_lists):
                    for name, score in hits:
                        # owner-epoch dedup: only docs whose owner
                        # actually failed, first slice writer wins
                        if name in ns_set and name not in m:
                            m[name] = float(score)
                recovered.update(ns_set)

            # phase 1 — hedges already in flight for failed primaries
            # ARE the failover slices: consume their OUTCOMES first
            for laggard, entries in hedge_futs.items():
                if laggard not in failed:
                    continue   # primary answered: epoch-0 wins
                for backup, ns, fut in entries:
                    if backup in failed:
                        continue
                    consume_slice(backup, ns, fut)
            # phase 2 — anything a hedge did NOT actually deliver
            # (never dispatched, or the hedge itself failed) gets a
            # fresh slice to the next usable replica: a failed hedge
            # must not suppress re-issue to a remaining live one
            fresh = [n for n in orphans if n not in recovered]
            if fresh:
                fresh_pending = [
                    (backup, ns, self._slice_pool.submit(
                        self._slice_call, backup, queries, ns,
                        t_deadline, live, tparent, "failover",
                        slice_extra))
                    for backup, ns in pmap.backups_for(
                        fresh, exclude=failed | failed_backups,
                        live=live, avoid=open_set).items()]
                for backup, ns, fut in fresh_pending:
                    consume_slice(backup, ns, fut)

        dark = len(view.dark) + len([n for n in orphans
                                     if n not in recovered])
        # a failed worker OUTSIDE the placement view may hold documents
        # the view cannot fail over — stay honest and mark degraded.
        # Same when unmapped documents are in play: legacy sum-merge
        # hits flowing THIS request, or a failed worker that has EVER
        # served unmapped hits (its copies may have been the only ones,
        # so their absence right now proves nothing).
        now = time.monotonic()
        for a in legacy_addrs:
            self._legacy_hit_workers[a] = now
        uncovered_workers = sum(1 for w in failed
                                if w not in view.replica_workers)
        if failed and (legacy_addrs
                       or any(w in self._legacy_hit_workers
                              for w in failed)):
            uncovered_workers += 1
        # staleness verdict from the SAME captured view the request
        # routed under (a promotion mid-request must not strip the
        # marker off a merge that actually ran against a stale view)
        sus = getattr(pmap, "suspect", None)
        health = self._record_scatter_health(
            len(workers), len(ok), circuit_open,
            failovers=len(recovered), dark=dark,
            uncovered_workers=uncovered_workers,
            dropped=dropped,
            stale_view=1 if (sus is not None and sus()) else 0)
        epoch, gen = self._view_stamp(pmap)
        health["route_epoch"] = epoch
        health["route_gen"] = gen
        # compute-plane degradation is a SEPARATE axis from result
        # degradation: a host-fallback reply is complete and exact
        # (bit-compared against the device path), just slower — the
        # `degraded` marker above stays about result completeness,
        # and this count lets the handler stamp X-Compute-Degraded
        # honestly without conflating the two
        health["compute_degraded"] = sum(
            1 for w in compute_degraded if w in ok)
        if health["compute_degraded"]:
            global_metrics.inc("scatter_compute_degraded")
        if tparent is not None:
            # the request story's verdict, on the scatter span itself:
            # chaos suites assert degraded/failover counts from here
            tparent.event("scatter.health", **{
                k: v for k, v in health.items() if v is not None})
        return merged, health

    # ---- mutation forwarding: writes stay on the elected leader ----

    def leader_url(self) -> str | None:
        """The elected leader's published address (``/leader_info``),
        cached briefly — the read plane must not pay one coordination
        read per proxied write."""
        now = time.monotonic()
        ts, cached = self._leader_cache
        if cached is not None and now - ts < 1.0:
            return cached
        try:
            addr = read_leader_info(self.coord)
        except Exception:
            return cached   # unreachable coordinator: last known
        self._leader_cache = (now, addr)
        return addr

    def proxy_write(self, path: str, body: bytes,
                    headers: dict[str, str]
                    ) -> tuple[int, bytes, dict]:
        """Forward one front-door mutation to the elected leader.
        Returns ``(status, body, reply headers)`` — non-2xx leader
        replies (sheds, 4xx rejections) are RELAYED, not raised, so
        the client sees the leader's own verdict. Raises RuntimeError
        when no leader is published (mid-election)."""
        from tfidf_tpu_torch.cluster.node import http_post

        leader = self.leader_url()
        if not leader:
            raise RuntimeError("no leader known")
        global_injector.check("router.write_proxy")
        ctype = headers.pop("Content-Type", "application/json")

        def rpc() -> bytes:
            # NO retry: the proxied mutation is the CLIENT's to retry
            # (an upload re-sent by the proxy could double-apply if
            # the first attempt reached the leader) — the breaker
            # still records leader health across proxied writes
            return http_post(leader + path, body, content_type=ctype,
                             timeout=300.0, headers=headers,
                             origin=self.url)

        try:
            out = self.resilience.worker_call(leader, rpc, retry=False)
        except urllib.error.HTTPError as e:
            payload = e.read() or b""
            global_metrics.inc("router_writes_proxied")
            return e.code, payload, dict(e.headers)
        global_metrics.inc("router_writes_proxied")
        return 200, out, {"Content-Type": "application/json"}


def _linger_bounds(min_ms: float, max_ms: float) -> dict:
    """Coalescer adaptive-linger kwargs from config (negative = keep
    the fixed linger; see Config.batch_linger_min_ms)."""
    if min_ms < 0 or max_ms < 0:
        return {}
    return {"linger_min_s": min_ms / 1e3, "linger_max_s": max_ms / 1e3}


def _parse_multipart(body: bytes, content_type: str
                     ) -> tuple[str | None, bytes]:
    """Extract (filename, payload) from a multipart/form-data body — the
    reference accepts Spring ``MultipartFile`` uploads (``Leader.java:153``,
    ``Worker.java:125``); this keeps ``curl -F file=@doc.txt`` working."""
    msg = email.parser.BytesParser(policy=email.policy.default).parsebytes(
        b"Content-Type: " + content_type.encode() + b"\r\n\r\n" + body)
    for part in msg.iter_parts():
        fn = part.get_filename()
        if fn is not None:
            return fn, part.get_payload(decode=True) or b""
    return None, b""


class _PlaneServer(ThreadingHTTPServer):
    daemon_threads = True
    # the socketserver default backlog (5) refuses connections under a
    # concurrent-client burst; a node serves many clients at once
    request_queue_size = 256


class _HttpHandlerBase(BaseHTTPRequestHandler):
    """HTTP plumbing + the read-plane routes shared by the node handler
    (``cluster/node.py``) and the router handler below: reply framing,
    admission prologue, trace spans, the ``/leader/start`` search
    branch, the streaming download copier, and the metrics/trace
    exposition endpoints. ``self.node`` is the hosting read plane."""

    node: ScatterReadPlane   # bound by the host's __init__
    protocol_version = "HTTP/1.1"
    # the handler's wfile is unbuffered (wbufsize=0): status line, each
    # header, and the body go out as separate small writes — with Nagle
    # on, write N+1 can stall behind the peer's delayed ACK of write N
    disable_nagle_algorithm = True

    def log_message(self, fmt, *args):
        pass

    # ---- plumbing ----

    def _send(self, code: int, body: bytes,
              ctype: str = "application/json",
              headers: dict[str, str] | None = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        headers = headers or {}
        for k, v in headers.items():
            self.send_header(k, v)
        # every response produced inside a request span carries its
        # trace id — uploads, deletes, downloads, and 429 sheds
        # included, not just /leader/start (the documented contract:
        # any /leader/* reply's X-Trace-Id keys `tfidf_tpu_torch trace`)
        if TRACE_HEADER not in headers:
            sp = global_tracer.current()
            if sp is not None:
                self.send_header(TRACE_HEADER, sp.trace_id)
        # every reply declares this binary's wire-protocol version
        # (cluster/protover.py) so either side of any exchange can
        # detect skew; the protocol witness pins the stamp
        if PROTO_HEADER not in headers:
            self.send_header(PROTO_HEADER, str(PROTO_VERSION))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj, code: int = 200,
              headers: dict[str, str] | None = None) -> None:
        self._send(code, json.dumps(obj).encode(), headers=headers)

    def _text(self, s: str, code: int = 200) -> None:
        self._send(code, s.encode(), "text/plain; charset=utf-8")

    def _body(self) -> bytes:
        n = int(self.headers.get("Content-Length", "0"))
        return self.rfile.read(n) if n else b""

    def _query_param(self, u, name: str) -> str | None:
        vals = urllib.parse.parse_qs(u.query).get(name)
        return vals[0] if vals else None

    def _read_upload(self, u) -> tuple[str | None, bytes]:
        body = self._body()
        ctype = self.headers.get("Content-Type", "")
        if ctype.startswith("multipart/form-data"):
            return _parse_multipart(body, ctype)
        return self._query_param(u, "name"), body

    # ---- tracing plumbing (utils/tracing.py) ----

    def _remote_ctx(self, trusted: bool):
        """The propagated trace context from the request headers, or
        None for an untraced request. ``trusted`` distinguishes the
        leader→worker continuation (sampling decided upstream) from
        front-door headers (subject to this node's own draw)."""
        return remote_context(self.headers.get(TRACE_HEADER),
                              self.headers.get(SPAN_HEADER),
                              trusted=trusted)

    @contextlib.contextmanager
    def _request_span(self, name: str, **attrs):
        """Span for one handled front-door request: keeps the caller's
        trace id when headers are present (UNTRUSTED — recording still
        subject to this node's sampling draw), else mints a new ROOT
        trace — the admission point where every client request's
        trace id is born. The span is remembered on the handler so the
        outer 500 path can still stamp the reply/log with the trace id
        AFTER the contextvar is reset (failed requests are the ones
        operators most need to trace)."""
        with global_tracer.span(
                name, parent=self._remote_ctx(trusted=False),
                attrs=attrs or None) as sp:
            self._last_span = sp
            yield sp

    def _worker_span(self, name: str, **attrs):
        """Worker-endpoint span: created ONLY when the caller sent a
        trace context (the leader's propagated scatter — trusted, the
        sampling decision was made at the root). External/reference
        clients (and local benches) hitting /worker/* directly stay
        untraced — the worker plane adds zero per-request tracing cost
        unless the leader asked."""
        ctx = self._remote_ctx(trusted=True)
        if ctx is None:
            return contextlib.nullcontext()
        return global_tracer.span(name, parent=ctx, attrs=attrs or None)

    @contextlib.contextmanager
    def _admitted(self, name: str, default_lane: str):
        """The front-door prologue every /leader/* handler shares:
        resolve the client lane, open the request span, admit-or-shed
        BEFORE the body is read or any work queues. Yields
        ``(span, lane)`` when admitted; ``(None, lane)`` when the shed
        reply was already sent (the caller just returns)."""
        client, lane = self._client_lane(default_lane)
        with self._request_span(name, lane=lane) as sp:
            decision = self.node.admission.admit(client, lane)
            if not decision.admitted:
                self._shed(decision)
                yield None, lane
            else:
                yield sp, lane

    def _deadline_header(self) -> float | None:
        """``X-Deadline-Ms`` (the leader's remaining scatter budget) as
        a local monotonic deadline; None when absent or malformed."""
        dl = self.headers.get("X-Deadline-Ms")
        if dl is None:
            return None
        try:
            return time.monotonic() + float(dl) / 1e3
        except ValueError:
            return None

    def _past_deadline(self) -> bool:
        """Refuse (504 + ``X-Deadline-Exceeded``) when the propagated
        budget is already spent; True when the reply was sent. The
        refusal is emitted inside a worker span when the caller sent a
        trace context, so even a pre-dispatch 504 carries X-Trace-Id
        and the refusal shows up in the leader's request story (the
        protocol witness pins traced-reply stamping on the worker
        plane)."""
        d = self._deadline_header()
        if d is not None and time.monotonic() > d:
            global_metrics.inc("worker_deadline_refusals")
            with self._worker_span("worker.deadline_refusal"):
                self._send(504, b"deadline exceeded",
                           "text/plain; charset=utf-8",
                           headers={"X-Deadline-Exceeded": "1"})
            return True
        return False

    # ---- wire-protocol versioning (cluster/protover.py) ----

    def _proto_gate(self, path: str) -> bool:
        """The compat-window gate on the data planes. ``/leader/*`` and
        ``/worker/*`` requests declaring a wire version below
        ``proto_min_compat`` are answered with the DISTINCT status 426
        + ``X-Proto-Rejected: 1`` — non-retryable and never a worker
        fault (cluster/resilience.py ``is_proto_rejection``), so
        rolling-upgrade skew surfaces honestly instead of tripping
        breakers. A request with no version header is implicitly
        version 1 (the pre-versioning wire); versions newer than ours
        always pass (forward compatibility). Ops endpoints
        (``/api/*``, metrics, traces) are deliberately ungated — an
        operator can inspect any node whatever binary it runs. Returns
        True when dispatch may proceed; False when the rejection reply
        was already sent."""
        # namespace compare, NOT path.startswith("/leader/"): a
        # startswith literal in a handler method would register as a
        # prefix ROUTE in the graftcheck endpoint extraction and make
        # the whole namespace "explained" — the gate is not a route
        ns = path.split("/", 2)[1] if path.startswith("/") else ""
        if ns not in ("leader", "worker"):
            return True
        peer = parse_version(self.headers.get(PROTO_HEADER))
        if in_window(peer, self.node.config.proto_min_compat):
            return True
        global_metrics.inc("proto_rejections")
        self._send(PROTO_STATUS,
                   json.dumps({
                       "error": "wire-protocol version outside the "
                                "compat window",
                       "declared": peer,
                       "min_compat": self.node.config.proto_min_compat,
                       "server_version": PROTO_VERSION}).encode(),
                   headers={PROTO_REJECTED_HEADER: "1"})
        return False

    # ---- admission plumbing (cluster/admission.py) ----

    def _client_lane(self, default_lane: str) -> tuple[str, str]:
        """(client id, lane) for admission: the ``X-Client-Id`` header
        (falling back to the peer IP) and the ``X-Priority`` header
        (``bulk`` selects the bulk lane; anything else keeps the
        endpoint's default)."""
        client = self.headers.get("X-Client-Id") or self.client_address[0]
        prio = (self.headers.get("X-Priority") or "").strip().lower()
        lane = LANE_BULK if prio == "bulk" else (
            LANE_INTERACTIVE if prio == "interactive" else default_lane)
        return client, lane

    def _shed(self, decision) -> None:
        """The explicit shed path: 429 + ``Retry-After``. The header
        carries RFC 9110 delta-seconds (an integer — fractional values
        are rejected or silently dropped by standards-compliant
        clients), rounded UP so an obedient client is never early; the
        JSON body's ``retry_after_s`` keeps the precise time-to-next-
        token the rate-limit path computed. ``Connection: close`` is
        explicit — the request body may be undrained, and a shedding
        node must not hold keep-alive state for a client it just told
        to go away (the header also tells pooled clients to drop the
        connection instead of tripping over the server-side close).
        The request body is drained up to a 1 MB cap first: closing
        with unread data in the receive queue sends RST, which can
        discard the 429 still in the client's buffer — the client
        would see ECONNRESET, classify it transient, and retry with
        no Retry-After floor, the exact hammering the shed exists to
        stop. Beyond the cap the connection closes anyway (a shedding
        node cannot hold the line for an arbitrarily large upload)."""
        self.close_connection = True
        try:
            remaining = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            remaining = 0
        remaining = min(remaining, 1 << 20)
        while remaining > 0:
            chunk = self.rfile.read(min(remaining, 1 << 16))
            if not chunk:
                break
            remaining -= len(chunk)
        body = json.dumps({"error": "overloaded",
                           "reason": decision.reason,
                           "retry_after_s": round(
                               decision.retry_after_s, 3)}).encode()
        self._send(429, body, headers={
            "Retry-After": str(math.ceil(max(decision.retry_after_s,
                                             0.0))),
            "Connection": "close",
            "X-Shed-Reason": decision.reason})

    def _read_query(self) -> str:
        """The search query: accept raw text (the reference POSTs the bare
        query string, ``Leader.java:54-59``) or ``{"query": ...}`` JSON."""
        body = self._body().decode("utf-8", "replace")
        # only attempt JSON when the body can be JSON — this is the
        # per-request hot path, and a raised-and-caught JSONDecodeError
        # per query is measurable at thousands of q/s. Strip leading
        # whitespace first: json.loads tolerates it, so the gate must too
        if body[:1].isspace():
            body = body.lstrip()
        if body[:1] in ('{', '"'):
            try:
                obj = json.loads(body)
                if isinstance(obj, dict) and "query" in obj:
                    return str(obj["query"])
                if isinstance(obj, str):
                    return obj
            except json.JSONDecodeError:
                pass
        return body

    def _read_search_request(self) -> tuple[str, str, str | None]:
        """Query plus retrieval plan for ``/leader/start``: JSON bodies
        may carry ``mode`` (``sparse`` | ``dense`` | ``hybrid``) and
        ``fusion`` (``rrf`` | ``wsum``) beside ``query``. Raw-text
        bodies and absent fields mean ``mode=sparse`` — the field is
        additive, so a v2 client's request is exactly a sparse request
        (cluster/protover.py history, wire v3). Values are returned
        unvalidated; ``_serve_search`` rejects unknown ones with 400."""
        body = self._body().decode("utf-8", "replace")
        if body[:1].isspace():
            body = body.lstrip()
        if body[:1] in ('{', '"'):
            try:
                obj = json.loads(body)
                if isinstance(obj, dict) and "query" in obj:
                    fusion = obj.get("fusion")
                    return (str(obj["query"]),
                            str(obj.get("mode") or "sparse"),
                            str(fusion) if fusion is not None else None)
                if isinstance(obj, str):
                    return obj, "sparse", None
            except json.JSONDecodeError:
                pass
        return body, "sparse", None

    # ---- shared read-plane routes ----

    def _serve_search(self) -> None:
        """The ``/leader/start`` branch, shared by the node and router
        handlers: front-door admission BEFORE any work is queued, the
        request span minted at the admission point, the health-marker
        contract on the reply (degraded header + the (epoch,
        generation) route stamp), the live latency histogram, and the
        slow-query log."""
        node = self.node
        t0 = time.perf_counter()
        with self._admitted("leader.search",
                            LANE_INTERACTIVE) as (sp, lane):
            if sp is None:
                return
            query, mode, fusion = self._read_search_request()
            if mode not in ("sparse", "dense", "hybrid"):
                self._json({"error": "unknown mode",
                            "mode": mode,
                            "allowed": ["sparse", "dense", "hybrid"]},
                           code=400)
                return
            if fusion is not None and fusion not in FUSION_METHODS:
                self._json({"error": "unknown fusion method",
                            "fusion": fusion,
                            "allowed": list(FUSION_METHODS)},
                           code=400)
                return
            if mode != "sparse" and not node.config.embedding_enabled:
                self._json({"error": "dense plane disabled "
                                     "(embedding_enabled=False)",
                            "mode": mode}, code=400)
                return
            # poison-query quarantine (after plan validation — a
            # malformed request is 400, not a quarantine verdict): a
            # (query, plan) pair that killed devices on ≥ N distinct
            # replicas is refused at the front door with 422 — the
            # application-rejection class clients must not retry —
            # before any worker is touched
            fp = poison_fingerprint(query, mode)
            if node.quarantine.is_quarantined(fp):
                global_metrics.inc("poison_quarantine_hits")
                sp.set_attr("poison_quarantined", 1)
                self._json({"error": "query quarantined: repeated "
                                     "compute faults on distinct "
                                     "replicas",
                            "fingerprint": fp,
                            "retry_after_s":
                                node.config.poison_quarantine_ttl_s},
                           code=422,
                           headers={"X-Poison-Quarantined": fp})
                return
            # traffic-capture tap: every ADMITTED search lands in the
            # durable request log (query + arrival offset + lane +
            # client) when capture is armed — shed requests are
            # deliberately not captured, so a replay reproduces the
            # admitted workload, not the overload that was refused
            # (the log records the bare query; replays run sparse)
            rlog = getattr(node, "request_log", None)
            if rlog is not None:
                rlog.record(query, lane,
                            self.headers.get("X-Client-Id")
                            or self.client_address[0])
            result, health = node.leader_search_with_health(
                query, lane=lane, mode=mode, fusion=fusion)
            # degraded marker: the body stays reference-compatible
            # (name -> score); the headers say whether every live
            # worker's shard is represented, which placement world
            # routed the request, and which trace reconstructs it
            hdrs = {TRACE_HEADER: sp.trace_id}
            # staged-plan stamp (wire v3): derived from the REQUEST, not
            # from health, so cache hits stamp identically and the pinned
            # cache-hit health dict stays untouched
            if mode == "dense":
                hdrs["X-Search-Stages"] = "dense"
            elif mode == "hybrid":
                fs = fusion or node.config.fusion_method
                hdrs["X-Search-Stages"] = (
                    "sparse,dense; fusion={} w={:g}/{:g}".format(
                        fs, node.config.fusion_weight_sparse,
                        node.config.fusion_weight_dense))
            if health.get("route_epoch") is not None:
                hdrs["X-Route-Epoch"] = str(health["route_epoch"])
            if health.get("route_gen") is not None:
                hdrs["X-Route-Generation"] = str(health["route_gen"])
            if health.get("cached"):
                sp.set_attr("cached", 1)
            # compute-plane honesty, end to end: some worker served
            # its share from the host mirror (exact scores, sick
            # device) — distinct from X-Scatter-Degraded, which is
            # about result completeness
            if health.get("compute_degraded"):
                hdrs["X-Compute-Degraded"] = str(
                    health["compute_degraded"])
                sp.set_attr("compute_degraded",
                            health["compute_degraded"])
            sp.set_attr("degraded", health.get("degraded", 0))
            if health.get("degraded"):
                hdrs["X-Scatter-Degraded"] = (
                    "attempted={attempted} "
                    "responded={responded} "
                    "circuit_open={circuit_open} "
                    "failovers={failovers} dark={dark} "
                    "dropped={dropped} stale_view={stale_view}"
                    .format(failovers=health.get("failovers", 0),
                            dark=health.get("dark", 0),
                            dropped=health.get("dropped", 0),
                            stale_view=health.get("stale_view", 0),
                            **{k: health[k] for k in
                               ("attempted", "responded",
                                "circuit_open")}))
            dt = time.perf_counter() - t0
            # live front-door latency histogram: the p50/p99
            # operators (and bench.py's cross-validation) read
            global_metrics.observe("leader_search", dt)
            slow_ms = node.config.trace_slow_query_ms
            if slow_ms > 0 and dt * 1e3 >= slow_ms:
                # trace-id-keyed slow-query log: the adapter
                # stamps trace=<id> (the span is active here),
                # so this line joins with /api/trace/<id>
                global_metrics.inc("slow_queries")
                log.warning(
                    "slow query", ms=round(dt * 1e3, 1),
                    query=query[:80],
                    degraded=health.get("degraded", 0))
            self._json(result, headers=hdrs)

    def _serve_leader_download(self, u) -> None:
        """The ``/leader/download`` branch: admission (bulk lane — real
        file I/O per request, first to shed), then the host's stream
        locator (``read_download_stream``: engine + store + worker
        probe on a node; worker + leader probe on a router)."""
        with self._admitted("leader.download",
                            LANE_BULK) as (sp, _lane):
            if sp is None:
                return
            rel = urllib.parse.unquote(
                self._query_param(u, "path") or "")
            sp.set_attr("file", rel)
            try:
                got = self.node.read_download_stream(rel)
            except PermissionError:
                self._text("invalid path", 400)
                return
            if got is None:
                self._text("not found", 404)
            else:
                self._stream(*got)

    def _serve_metrics(self, u) -> bool:
        """The ``/metrics`` + ``/api/metrics`` exposition (never
        admission-controlled — the reserved observability lane).
        Returns True when the path matched and was served."""
        if u.path not in ("/api/metrics", "/metrics"):
            return False
        node = self.node
        fmt = self._query_param(u, "format")
        if u.path == "/metrics" or fmt == "prometheus":
            body = global_metrics.render_prometheus(
                extra_gauges={
                    "breaker_open_workers_now":
                        node.resilience.board.open_count()})
            self._send(body=body.encode(), code=200,
                       ctype="text/plain; version=0.0.4; "
                             "charset=utf-8")
            return True
        snap = global_metrics.snapshot()
        # live per-worker breaker states beside the counters —
        # the CLI's degraded summary reads these
        states = node.resilience.board.snapshot()
        if states:
            snap["breaker_states"] = states
        self._json(snap)
        return True

    def _serve_trace(self, u) -> bool:
        """Trace export (observability lane): ``/api/trace/<trace-id>``
        reconstructs one request's story; ``/api/trace?recent=N`` lists
        the newest finished spans; ``?format=chrome`` renders
        Chrome-trace JSON. Returns True when the path matched."""
        if not (u.path == "/api/trace"
                or u.path.startswith("/api/trace/")):
            return False
        tid = u.path[len("/api/trace/"):] \
            if u.path.startswith("/api/trace/") else \
            (self._query_param(u, "id") or "")
        if tid:
            spans = global_tracer.get_trace(tid)
        else:
            try:
                n = int(self._query_param(u, "recent") or 100)
            except ValueError:
                n = 100
            spans = global_tracer.recent(n)
        if self._query_param(u, "format") == "chrome":
            self._json(to_chrome_trace(spans))
        else:
            self._json({"trace_id": tid or None, "spans": spans})
        return True

    def _forward_write(self, u) -> None:
        """Mutations stay on the elected leader: forward the request
        verbatim (body + the client/lane/trace headers that matter) and
        relay the leader's reply — status, body, and the shed/trace
        headers a polite client acts on. 503 + Retry-After when no
        leader is reachable (unpublished mid-election, or published
        but dead behind a not-yet-expired ephemeral — a transport
        failure must not surface as a bare 500 with no backoff hint).

        ``/leader/*`` forwards pass the LOCAL admission gate (bulk
        lane) BEFORE the body is read — the admit-before-body-read
        discipline the direct path enforces: without it a flood of
        large uploads would buffer whole request bodies on a stateless
        router only for the leader to shed them; a locally shed
        forward pays at most ``_shed``'s 1 MB drain. Ops forwards
        (``/api/*``) stay un-gated, like every ops endpoint."""
        if u.path.startswith("/leader/"):
            with self._admitted("router.proxy", LANE_BULK) as (sp, _l):
                if sp is None:
                    return
                self._forward_admitted(u)
        else:
            with self._request_span("router.proxy", path=u.path):
                self._forward_admitted(u)

    def _forward_admitted(self, u) -> None:
        body = self._body()
        fwd = {}
        for h in ("Content-Type", "X-Client-Id", "X-Priority"):
            v = self.headers.get(h)
            if v:
                fwd[h] = v
        target = u.path + (f"?{u.query}" if u.query else "")
        try:
            status, rbody, rhdrs = self.node.proxy_write(
                target, body, fwd)
        except (RuntimeError, OSError) as e:
            # no leader published, leader unreachable (URLError ⊂
            # OSError), or its breaker is open (CircuitOpenError ⊂
            # RuntimeError): same honest answer — try again shortly
            self._json({"error": "leader unavailable",
                        "detail": repr(e)[:200],
                        "retry_after_s": 1.0}, 503,
                       headers={"Retry-After": "1"})
            return
        relay = {}
        for h in ("Retry-After", "X-Shed-Reason", TRACE_HEADER):
            v = rhdrs.get(h)
            if v:
                relay[h] = v
        self._send(status, rbody,
                   rhdrs.get("Content-Type", "application/json"),
                   headers=relay)

    def _fail_500(self, u, e: BaseException) -> None:
        """The shared outer failure path: the request span's contextvar
        is gone by now; the remembered span keys the error reply + log
        line so a FAILED request stays joinable with its recorded
        (error-attributed) span."""
        sp = getattr(self, "_last_span", None)
        kv = {"trace": sp.trace_id} if sp is not None else {}
        log.warning("request failed", path=u.path, err=repr(e), **kv)
        self._send(500, f"error: {e!r}".encode(),
                   "text/plain; charset=utf-8",
                   headers={TRACE_HEADER: sp.trace_id}
                   if sp is not None else None)

    _STREAM_CHUNK = 1 << 16

    def _stream(self, stream, size: int | None) -> None:
        """Chunked-copy a readable stream to the client with constant
        memory (Content-Length when known, else chunked encoding).

        Once the 200 status line is on the wire a failure can no longer
        become a 500 — writing another status line would inject bytes
        into the declared payload and hand the client a silently
        truncated-then-corrupted file. Mid-stream errors instead ABORT
        the connection (close without the terminating chunk / short of
        Content-Length), which every HTTP client detects as a transfer
        error."""
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            sp = global_tracer.current()
            if sp is not None:   # stream replies bypass _send; same
                self.send_header(TRACE_HEADER, sp.trace_id)  # contract
            self.send_header(PROTO_HEADER, str(PROTO_VERSION))
            chunked = size is None
            if chunked:
                self.send_header("Transfer-Encoding", "chunked")
            else:
                self.send_header("Content-Length", str(size))
            self.end_headers()
            try:
                while True:
                    buf = stream.read(self._STREAM_CHUNK)
                    if not buf:
                        break
                    if chunked:
                        self.wfile.write(b"%x\r\n" % len(buf))
                        self.wfile.write(buf)
                        self.wfile.write(b"\r\n")
                    else:
                        self.wfile.write(buf)
                if chunked:
                    self.wfile.write(b"0\r\n\r\n")
            except Exception as e:
                log.warning("download stream aborted mid-transfer",
                            err=repr(e))
                self.close_connection = True
        finally:
            stream.close()


class _RouterHandler(_HttpHandlerBase):
    """The stateless router's HTTP surface: the read-plane routes
    (search, download, metrics, traces) plus a pass-through proxy that
    keeps every mutation on the elected leader."""

    # front-door mutations a router forwards to the leader verbatim
    _PROXY_POSTS = frozenset({"/leader/upload", "/leader/upload-batch",
                              "/leader/delete", "/api/drain",
                              "/api/autopilot"})

    def do_GET(self) -> None:
        u = urllib.parse.urlparse(self.path)
        router = self.node
        self._last_span = None
        try:
            if not self._proto_gate(u.path):
                return
            if u.path == "/api/health":
                # the reserved observability lane: never admission-
                # controlled, never blocks on coordination (view
                # state is in-memory)
                self._json({
                    "ok": True, "role": "router",
                    "proto_version": PROTO_VERSION,
                    "placement": router.placement.view_snapshot(),
                    "scatter_queue_depth": global_metrics.get(
                        "last_router_scatter_queue_depth", 0.0),
                    "admission": router.admission.snapshot()})
            elif u.path == "/api/status":
                self._text("I am a router")
            elif u.path == "/api/services":
                self._json(router.registry.get_all_service_addresses())
            elif u.path == "/api/leader":
                self._json({"leader": router.leader_url()})
            elif u.path == "/api/router":
                self._json(router.router_snapshot())
            elif u.path == "/api/autopilot":
                # THIS router's autopilot state + decision audit (the
                # POST kill switch still proxies to the leader). Same
                # shape as the node's route, same observability-lane
                # rule: never admission-controlled.
                try:
                    n = int(self._query_param(u, "recent") or 50)
                except ValueError:
                    n = 50
                self._json({"autopilot": router.autopilot.snapshot(),
                            "decisions": router.autopilot.decisions(n)})
            elif u.path == "/api/routers":
                self._json(list_routers(router.coord))
            elif u.path == "/api/quarantine":
                # THIS router's poison-quarantine table (per-router
                # state; observability lane, never admission-controlled)
                self._json(router.quarantine.snapshot())
            elif u.path == "/leader/download":
                self._serve_leader_download(u)
            elif self._serve_metrics(u):
                pass
            elif self._serve_trace(u):
                pass
            else:
                self._text("not found", 404)
        except Exception as e:
            self._fail_500(u, e)

    def do_POST(self) -> None:
        u = urllib.parse.urlparse(self.path)
        router = self.node
        self._last_span = None
        try:
            if not self._proto_gate(u.path):
                return
            if u.path == "/leader/start":
                self._serve_search()
            elif u.path == "/api/quarantine":
                # operator override after a fix rolls out: drop every
                # verdict on THIS router (per-router state — clear each)
                self._json({"cleared": router.quarantine.clear()})
            elif u.path in self._PROXY_POSTS:
                self._forward_write(u)
            else:
                self._text("not found", 404)
        except Exception as e:
            self._fail_500(u, e)


class QueryRouter(ScatterReadPlane):
    """One stateless router: a read-plane process with no engine, no
    shard, and no authority — just the scatter spine pointed at a
    follower view of the placement znode. Kill one and nothing is
    lost; add N and the interactive front door scales ~N-fold."""

    def __init__(self, config: Config | None = None, coord=None,
                 coord_factory=None) -> None:
        # the node/router transport helpers live in cluster.node;
        # imported lazily — node.py imports this module at load time
        # (the read plane is defined here), so a module-level import
        # back into node would be a cycle
        from tfidf_tpu_torch.cluster.node import _ScatterClient

        self.config = config or Config()
        global_tracer.configure(
            max_spans=self.config.trace_ring_spans,
            sample_rate=self.config.trace_sample_rate)
        if coord is None and coord_factory is not None:
            coord = coord_factory()
        assert coord is not None, "a coordination client is required"
        self.coord = coord
        self._coord_factory = coord_factory
        coord.on_session_event(self._on_session_event)
        self._stopping = False
        # membership view ONLY: a router never registers itself as a
        # worker — it serves no shard. The watch keeps the scatter
        # target set fresh; the epoch keys coalesced batches.
        self.registry = ServiceRegistry(
            coord, on_change=self._on_membership_change)
        self._cluster_epoch = 0
        self._pool = ThreadPoolExecutor(
            max_workers=self.config.fanout_workers,
            thread_name_prefix="router-fanout")
        self._slice_pool = ThreadPoolExecutor(
            max_workers=max(4, self.config.fanout_workers // 2),
            thread_name_prefix="router-slice")
        self._scatter = _ScatterClient()
        # the read view: a follower of the durable placement znode
        # (watch-refreshed, staleness-tracked — cluster/placement.py)
        self.placement = PlacementFollower(
            name=str(self.config.port),
            refresh_ms=self.config.router_refresh_ms,
            stale_ms=self.config.router_stale_ms)
        self.placement.bind_store(lambda: self.coord)
        self.resilience = ClusterResilience(self.config)
        self.hedge_ms = float(self.config.scatter_hedge_ms)
        self._legacy_hit_workers: dict[str, float] = {}
        self._scatter_health: dict[str, int] = {}
        # per-router scatter coalescer: its OWN queue-depth gauge
        # (last_router_scatter_queue_depth) is the per-router
        # backpressure signal AND the k8s router-HPA metric. Batches
        # group by (membership epoch, view version): one coalesced
        # batch never spans a membership transition OR a placement
        # refresh — each batch maps onto exactly one world view.
        self.scatter_batcher = (Coalescer(
            self._scatter_search_batch,
            max_batch=self.config.scatter_batch,
            linger_s=self.config.scatter_linger_ms / 1e3,
            pipeline=self.config.scatter_pipeline,
            name="router_scatter",
            # (epoch, view, mode, fusion): batches stay homogeneous in
            # world view AND retrieval plan (items are (q, mode, fusion))
            group_key=lambda q: (self._cluster_epoch,
                                 self.placement.version, q[1], q[2])
            if isinstance(q, tuple) else (self._cluster_epoch,
                                          self.placement.version,
                                          "sparse", None),
            bulk_share=self.config.scatter_bulk_share,
            **_linger_bounds(self.config.scatter_linger_min_ms,
                             self.config.scatter_linger_max_ms))
            if (self.config.scatter_micro_batch
                and not self.config.unbounded_results) else None)
        # per-router admission: same watermarks as the leader's front
        # door, keyed on THIS router's coalescer depth (the max of the
        # gauge and the live backlog — the stall-proof signal, same
        # rationale as SearchNode's depth_fn)
        self.admission = AdmissionController(
            self.config,
            depth_fn=lambda: max(
                global_metrics.get("last_router_scatter_queue_depth",
                                   0.0),
                float(self.scatter_batcher.backlog())
                if self.scatter_batcher is not None else 0.0),
            name="router")
        # per-router generation-keyed result cache: the token is
        # (membership epoch, view version) — every observed placement
        # flush advances it, so staleness is bounded by the leader's
        # flush debounce + watch latency, and a suspect view bypasses
        # the cache entirely (leader_search_with_health)
        self.result_cache = (ResultCache(self.config.router_cache_entries)
                             if (self.config.router_cache_entries > 0
                                 and not self.config.unbounded_results)
                             else None)
        # traffic-capture tap (utils/storage.py RequestLog): admitted
        # /leader/start requests land in a durable replayable log when
        # the knob names a path — bench.py --replay drives load from it
        self.request_log = (_storage.RequestLog(
            self.config.replay_capture_path,
            self.config.replay_capture_max)
            if self.config.replay_capture_path else None)
        # per-router poison-query quarantine: each router learns blame
        # from its OWN scatter failures (no coordination write — a
        # query-of-death hammering one router is quarantined there;
        # other routers learn the same way if it reaches them)
        self.quarantine = PoisonQuarantine(
            after=self.config.poison_quarantine_after,
            ttl_s=self.config.poison_quarantine_ttl_s,
            max_entries=self.config.poison_quarantine_max)
        # per-router SLO autopilot (cluster/autopilot.py): the router
        # owns its OWN admission, hedge, linger, and slow-trip knobs —
        # the same live objects the leader's loop steers — so the
        # closed loop runs here too (duck-typed over the shared
        # scatter plane; the controllers never touch leader-only
        # state). Paced by its own thread because the router has no
        # reconcile sweep to ride.
        self.autopilot = Autopilot(self)
        self._autopilot_thread: threading.Thread | None = None
        self._role = "router"
        self._leader_cache: tuple[float, str | None] = (0.0, None)
        handler = type("Handler", (_RouterHandler,), {"node": self})
        self.httpd = _PlaneServer(
            (self.config.host, self.config.port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{self.config.host}:{self.port}"
        self._server_thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True,
            name=f"router-{self.port}")

    # ---- read-plane policy: always the follower view ----

    def _read_placement(self) -> PlacementMap:
        return self.placement

    def df_signature(self) -> tuple[int, int]:
        """The router result cache's generation token: (membership
        epoch, placement view version). The epoch covers worker
        death/join (which shifts per-shard df); the view version
        advances on every observed placement flush — which the leader
        performs after every df-changing commit — so a cached entry
        can outlive the corpus state it saw by at most the flush
        debounce + watch latency, and never survives a refresh."""
        return (self._cluster_epoch, self.placement.version)

    def _on_membership_change(self, old, new) -> None:
        # watch-dispatch thread: hand off fast, never block
        self._cluster_epoch += 1

    # ---- session-expiry recovery ----

    def _on_session_event(self, ev) -> None:
        """Coordination session expired (a long partition or GC
        pause): the router's ephemeral registry znode and its armed
        watches died with the session. Reconnect with a fresh session
        off-thread — a router with no factory (in-process tests
        passing a client directly) just rides its periodic refresh."""
        log.warning("router coordination session expired", url=self.url)
        if self._stopping or self._coord_factory is None:
            return
        threading.Thread(target=self._rejoin, daemon=True,
                         name=f"router-rejoin-{self.port}").start()

    def _rejoin(self) -> None:
        delay = 0.2
        while not self._stopping:
            try:
                coord = self._coord_factory()
                self.coord = coord
                if getattr(coord, "origin", None) == "":
                    coord.origin = self.url
                coord.on_session_event(self._on_session_event)
                self.registry = ServiceRegistry(
                    coord, on_change=self._on_membership_change)
                self._cluster_epoch += 1
                # the placement store getter reads self.coord
                # dynamically; re-arm the data watch on the NEW
                # session and refresh at once
                self.placement._watch_armed = False
                self.placement._wake.set()
                register_router(coord, self.url)
                global_metrics.inc("router_rejoins")
                log.info("router rejoined after session expiry",
                         url=self.url)
                return
            except Exception as e:
                log.warning("router rejoin attempt failed",
                            err=repr(e))
                time.sleep(delay)
                delay = min(delay * 2, 5.0)

    # ---- lifecycle ----

    def start(self) -> "QueryRouter":
        self._server_thread.start()
        self._scatter.origin = self.url
        if getattr(self.coord, "origin", None) == "":
            self.coord.origin = self.url
        self.placement.start()
        try:
            register_router(self.coord, self.url)
        except Exception as e:
            log.warning("router registration failed", err=repr(e))
        if self.autopilot.enabled:
            self._autopilot_thread = threading.Thread(
                target=self._autopilot_loop, daemon=True,
                name=f"router-autopilot-{self.port}")
            self._autopilot_thread.start()
        global_metrics.inc("router_started")
        log.info("router started", url=self.url,
                 view=self.placement.view_snapshot())
        return self

    def _autopilot_loop(self) -> None:
        """The router's pacing thread for ``Autopilot.maybe_run`` (the
        leader rides its reconcile sweep; a router has none)."""
        while not self._stopping:
            time.sleep(0.1)
            try:
                self.autopilot.maybe_run()
            except Exception as e:
                log.warning("router autopilot pass failed", err=repr(e))

    def stop(self) -> None:
        self._stopping = True
        self.placement.stop()
        self.httpd.shutdown()
        self.httpd.server_close()
        self._pool.shutdown(wait=False)
        self._slice_pool.shutdown(wait=False)
        if self.scatter_batcher is not None:
            self.scatter_batcher.stop()
        if self.request_log is not None:
            self.request_log.close()

    # ---- downloads: probe workers, then the leader's local store ----

    def read_download_stream(self, rel: str):
        """Locate a document for ``/leader/download``: probe every live
        worker's ``/worker/download`` (first 2xx wins, breaker-gated),
        then fall back to the leader (whose own disk/store holds
        leader-local documents). Returns ``(fileobj, size|None)`` or
        None; the caller owns closing the stream."""
        # the shared streaming seam (nemesis + trace propagation);
        # lazy import — node.py imports this module at load time
        from tfidf_tpu_torch.cluster.node import http_get_stream

        q = urllib.parse.quote(rel)
        targets = list(self.registry.get_all_service_addresses())
        leader = self.leader_url()
        probes = [(w, "/worker/download?path=") for w in targets]
        if leader:
            probes.append((leader, "/leader/download?path="))
        for base, route in probes:
            if self.resilience.board.is_open(base):
                continue   # skip sick targets; another may hold the doc
            try:
                # breaker-tracked, no retry: probing the NEXT target is
                # this loop's retry. A 404 (doc lives elsewhere) is an
                # app-level answer from a healthy peer.
                resp = self.resilience.worker_call(
                    base, lambda base=base, route=route: http_get_stream(
                        base + route + q, timeout=30.0,
                        origin=self.url),
                    retry=False)
                size = resp.headers.get("Content-Length")
                return resp, (int(size) if size is not None else None)
            except Exception:
                continue
        return None

    # ---- operator surface ----

    def router_snapshot(self) -> dict:
        """``GET /api/router``: this router's view lag + cache health
        (the CLI ``status`` routers block aggregates these)."""
        hits = global_metrics.get("cache_hits", 0)
        misses = global_metrics.get("cache_misses", 0)
        return {
            "role": "router", "url": self.url,
            "placement": self.placement.view_snapshot(),
            "membership_epoch": self._cluster_epoch,
            "cache": {
                "entries": len(self.result_cache)
                if self.result_cache is not None else 0,
                "hits": int(hits), "misses": int(misses),
                "hit_rate": round(hits / (hits + misses), 4)
                if (hits + misses) else 0.0,
            },
            "writes_proxied": int(global_metrics.get(
                "router_writes_proxied", 0)),
            "stale_responses": int(global_metrics.get(
                "router_stale_responses", 0)),
        }
