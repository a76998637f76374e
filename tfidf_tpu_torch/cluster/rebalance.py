"""Leader-side elastic rebalancing: crash-safe live shard migration,
splitting, and planned decommission (drain).

The reference's placement is static — the registry maps each document
to whichever worker the leader picked at upload time, forever
(``Leader.java:153-207``); a shard that outgrows its worker, or a
freshly joined worker, cannot be fixed without downtime. This module
composes the replication primitives (durable :class:`PlacementMap`, the
``moved``/pending-delete reconcile machinery, the R-way upload fan-out,
per-request owner assignment) into live rebalancing that is safe under
crashes at every step.

**The staged state machine** (per migration, durable in the placement
znode):

``copying``
    The doc range is uploaded to the target replicas through the same
    upload/repair plumbing as anti-entropy repair; each confirmed leg
    is an ordinary NON-primary confirmed replica. Ownership never
    moves in this phase, so a crash of the leader, the source, or the
    target mid-copy loses nothing and double-counts nothing: a new
    leader aborts the record and the trim pass reclaims stray legs; a
    dead target just fails its legs; a dead source is handled by the
    ordinary death path (the half-copied targets may by then be the
    surviving replicas — strictly a bonus).
``flipped``
    One atomic in-memory mutation per range (``flip_migration``):
    targets become the leading replicas, the source leaves the replica
    set, and its copies are scheduled for reconcile-delete. The flip is
    made DURABLE (a leadership-fenced synchronous placement flush)
    while the reconcile machinery is locked out (``_reconcile_serial``)
    — deletes can only run after the flip is in the znode, so a leader
    failover can never believe the source owns already-deleted copies.
    If the flush fails, the flip is rolled back (``unflip_migration``)
    before the lock is released. A flipped range is never re-flipped
    back: the phase rides the durable record.
``reconciled``
    The existing ``moved`` machinery (rejoin reconcile + periodic
    sweep, both crash-safe) deletes the source's old copies;
    the migration record is dropped once the flip is durable because
    that machinery owns the tail from there.

Searches stay EXACT throughout: the per-request owner assignment makes
the flip atomic from the scatter path's perspective — before the flip
the source owns (target hits are dropped as non-owner), after it the
target owns (source hits are dropped, and additionally excluded via
the pending-reconcile set).

**Planning** detects overloaded shards (doc count above
``rebalance_max_shard_docs`` or above the cluster mean plus slack) and
underused capacity (a freshly joined worker sits far below the mean)
from the placement map the leader already maintains, and moves excess
ranges onto the least-loaded workers. **Drain** (``/api/drain``, CLI
``drain``) marks a worker as decommissioning — excluded from new-name
routing and repair targets — and migrates it empty so it can leave the
cluster with zero loss.
"""

from __future__ import annotations

import os
import threading
import time
from typing import TYPE_CHECKING

from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

if TYPE_CHECKING:   # circular at runtime: node.py constructs Rebalancer
    from tfidf_tpu_torch.cluster.node import SearchNode

log = get_logger("cluster.rebalance")

# per-pass migration cap: bounds one sweep's wall time so the sweep
# loop's reconcile/repair duties are never starved by a huge rebalance
MAX_DOCS_PER_PASS = 256


def plan_moves(counts: dict[str, int], max_shard_docs: int
               ) -> dict[str, int]:
    """Pure planning: worker -> doc count in, ``{source: n_to_move}``
    out. A worker donates down to the cluster mean when it sits above
    ``mean + slack`` (slack = mean/4, at least 1) or above the absolute
    ``max_shard_docs`` cap (0 = no cap); receivers are workers below
    the mean, and total movement is bounded by their combined deficit —
    when every worker is loaded alike there is nowhere better to move
    to, and the plan is empty."""
    if len(counts) < 2:
        return {}
    total = sum(counts.values())
    if total <= 0:
        return {}
    mean = -(-total // len(counts))   # ceil
    slack = max(1, mean // 4)
    room = sum(max(0, mean - c) for c in counts.values())
    out: dict[str, int] = {}
    for w, c in sorted(counts.items(), key=lambda kv: (-kv[1], kv[0])):
        if room <= 0:
            break
        hi = mean + slack
        if max_shard_docs > 0:
            hi = min(hi, max_shard_docs)
        if c <= hi:
            continue
        n = min(c - mean, room)
        if n > 0:
            out[w] = n
            room -= n
    return out


class Rebalancer:
    """Leader-side rebalance/drain driver. Constructed on every node;
    does work only while this node is leader (like the reconcile
    sweep it rides on). All mutation goes through the staged migration
    machinery in :class:`~tfidf_tpu_torch.cluster.placement.PlacementMap` and
    the node's existing resilience-wrapped RPC helpers."""

    def __init__(self, node: SearchNode) -> None:
        self.node = node
        # first automatic pass only after a full sweep period: a node
        # that JUST became leader should finish loading/repairing its
        # placement view before it starts planning moves against it
        self._last_run = time.monotonic()
        # one drain loop per worker; re-drain requests join the live one
        self._drain_threads: dict[str, threading.Thread] = {}
        self._drain_lock = threading.Lock()

    # ------------------------------------------------------------------
    # sweep integration
    # ------------------------------------------------------------------

    def maybe_run(self) -> None:
        """Called from the leader's reconcile sweep loop; self-paced by
        ``rebalance_sweep_ms`` (negative disables; the sweep interval
        itself is the floor)."""
        cfg = self.node.config
        if not cfg.rebalance_enabled or cfg.rebalance_sweep_ms < 0:
            return
        now = time.monotonic()
        if now - self._last_run < cfg.rebalance_sweep_ms / 1e3:
            return
        self._last_run = now
        self.run_once()

    def run_once(self) -> dict:
        """One planning + migration pass (public so tests and operators
        can force one without waiting for the timer)."""
        node = self.node
        if node._stopping or not node.config.rebalance_enabled \
                or not node.is_leader():
            return {}
        live = set(node.registry.get_all_service_addresses())
        if len(live) < 2:
            return {}
        self._abort_stale_migrations(live)
        draining = node.placement.draining_snapshot()
        counts = self._doc_counts(live)
        # draining workers neither donate here (their own drain loop
        # migrates them empty) nor receive
        plan = plan_moves({w: c for w, c in counts.items()
                           if w not in draining},
                          node.config.rebalance_max_shard_docs)
        moved = failed = 0
        budget = MAX_DOCS_PER_PASS
        for source, n in plan.items():
            if budget <= 0 or node._stopping:
                break
            names = self._movable_names(source, min(n, budget))
            if not names:
                continue
            out = self.migrate(source, names)
            moved += out.get("moved", 0)
            failed += out.get("failed", 0)
            budget -= len(names)
        if plan:
            log.info("rebalance pass", planned=sum(plan.values()),
                     moved=moved, failed=failed)
        return {"planned": sum(plan.values()), "moved": moved,
                "failed": failed}

    def _doc_counts(self, live: set[str]) -> dict[str, int]:
        counts = dict.fromkeys(live, 0)
        with self.node.placement.lock:
            for _name, ws in self.node.placement.replicas.items():
                for w in ws:
                    if w in counts:
                        counts[w] += 1
        return counts

    def _movable_names(self, source: str, n: int) -> list[str]:
        """Up to ``n`` docs held on ``source`` that are not already
        mid-migration or pending delete from it."""
        pm = self.node.placement
        skip = pm.migrating_names()
        skip |= pm.pending_moved().get(source, frozenset())
        return [name for name in sorted(pm.names_on(source))
                if name not in skip][:n]

    def _abort_stale_migrations(self, live: set[str]) -> None:
        """Drop copying-phase records whose source has left the cluster
        — the ordinary death path already re-owned its docs, and a flip
        against a vanished source is a no-op per name anyway."""
        pm = self.node.placement
        for mid, rec in pm.migration_snapshot().items():
            if rec["phase"] == "copying" and rec["source"] not in live:
                pm.end_migration(mid)
                log.info("aborted migration of departed source",
                         migration=mid, source=rec["source"])
        self._publish_active()

    def _publish_active(self) -> None:
        pm = self.node.placement
        with pm.lock:
            active = len(pm.migrations)
            draining = len(pm.draining)
        global_metrics.set_gauge("rebalance_active", active)
        global_metrics.set_gauge("rebalance_draining_workers", draining)

    # ------------------------------------------------------------------
    # the staged migration itself
    # ------------------------------------------------------------------

    def migrate(self, source: str, names: list[str],
                kind: str = "rebalance") -> dict:
        """Move ``names`` off ``source`` live: copy to chosen targets,
        durably flip ownership, then reconcile-delete the old copies.
        Serialized with the reconcile/repair machinery
        (``_reconcile_serial``) for the copy+flip stages so no delete
        or trim can interleave with a half-done flip; the reconcile
        trigger runs after the lock is released (the sweep retries any
        failure — the moved state is already durable by then)."""
        node = self.node
        out = {"moved": 0, "failed": 0}
        if not names:
            return out
        flipped: list[str] = []
        with node._reconcile_serial:
            if node._stopping or not node.is_leader():
                return out
            targets_by_name = self._choose_targets(source, names)
            if not targets_by_name:
                return out
            mid = node.placement.begin_migration(source, targets_by_name,
                                                 kind)
            self._publish_active()
            try:
                global_injector.check("leader.rebalance_copy")
                # copy phase: the same resilience-wrapped byte-sourcing
                # + upload fan-out as anti-entropy repair (confirmed
                # legs are recorded as replicas by the shared helper)
                node._replicate_to_targets(targets_by_name)
                global_injector.check("leader.rebalance_flip")
                flipped = node.placement.flip_migration(mid)
                if flipped and not self._persist_flip():
                    # the flip could not be made durable: roll it back
                    # BEFORE any delete can run — a non-durable flip
                    # followed by deletes would let a leader failover
                    # resurrect source ownership of deleted copies
                    node.placement.unflip_migration(mid)
                    flipped = []
                if flipped:
                    # a flip changes which shard SCORES each moved doc
                    # (per-shard df shifts with ownership): cached
                    # query results predate it and must die
                    node.bump_result_generation()
                out["moved"] = len(flipped)
                out["failed"] = len(targets_by_name) - len(flipped)
            except Exception as e:
                out["failed"] = len(targets_by_name) - len(flipped)
                log.warning("migration failed", source=source,
                            docs=len(targets_by_name), err=repr(e))
            finally:
                # the record's job ends here either way: a durable flip
                # hands the tail to the moved machinery; an abort leaves
                # confirmed copy legs as plain over-replication for the
                # trim pass to reclaim
                node.placement.end_migration(mid)
                self._publish_active()
        if out["moved"]:
            global_metrics.inc("rebalance_moved_docs", out["moved"])
            log.info("migration flipped", source=source,
                     docs=out["moved"], kind=kind)
        if out["failed"]:
            global_metrics.inc("rebalance_failures", out["failed"])
        if out["moved"]:
            # reconcile phase: trigger the source-side deletes now
            # instead of waiting a sweep period; any failure (including
            # an injected one) is retried by the periodic sweep — the
            # moved state is durable
            try:
                global_injector.check("leader.rebalance_reconcile")
                node.run_reconcile_sweep()
            except Exception as e:
                log.warning("post-flip reconcile trigger failed "
                            "(sweep will retry)", err=repr(e))
        return out

    def _choose_targets(self, source: str,
                        names: list[str]) -> dict[str, list[str]]:
        """Per-name target selection: the least-loaded live, non-source,
        non-draining, breaker-closed worker not already holding the
        name. Names with no viable target are dropped from the
        migration (left where they are)."""
        node = self.node
        live = set(node.registry.get_all_service_addresses())
        draining = node.placement.draining_snapshot()
        pool = [w for w in live
                if w != source and w not in draining
                and not node.resilience.board.is_open(w)]
        if not pool:
            return {}
        try:
            node._ensure_sizes_fresh(pool)
        except Exception as e:
            log.warning("rebalance size poll failed", err=repr(e))
            return {}
        with node._placement_lock:
            sizes = {w: s for w, s in node._size_cache[1].items()
                     if w in pool}
        if not sizes:
            return {}
        out: dict[str, list[str]] = {}
        for name in names:
            reps = node.placement.holders_of(name)
            if source not in reps:
                continue
            cands = sorted((w for w in sizes if w not in reps),
                           key=lambda w: (sizes[w], w))
            if not cands:
                continue
            target = cands[0]
            # grow the local estimate by the doc's projected bytes (the
            # size cache is byte-denominated) so one pass spreads its
            # own load across targets instead of stacking every doc
            # onto the single smallest worker
            sizes[target] += self._est_doc_bytes(name)
            out[name] = [target]
        return out

    def _est_doc_bytes(self, name: str) -> int:
        """Projected on-target size of one doc: the durable-store file
        size when known, else a nominal document size."""
        try:
            return max(1, os.path.getsize(self.node._store_path(name)))
        except Exception:
            return 4096

    def _persist_flip(self) -> bool:
        """Make the flip durable (leadership-fenced inside ``flush``).
        With persistence disabled by config the in-memory map IS the
        authority (per-tenure mode) and the flip stands."""
        node = self.node
        if node.config.placement_flush_ms < 0:
            return True
        try:
            return node.placement.flush()
        except Exception as e:
            log.warning("flip persist failed; rolling back", err=repr(e))
            return False

    # ------------------------------------------------------------------
    # new-leader resume
    # ------------------------------------------------------------------

    def resume_after_election(self) -> dict:
        """Resolve a predecessor's in-flight migrations after the
        durable map loaded: copying-phase records are ABORTED (ownership
        never moved; confirmed copy legs are over-replication the trim
        pass reclaims), flipped records are DROPPED (the flip is
        durable and the loaded ``moved`` state already carries the
        reconcile tail through the sweep), and drain loops restart for
        workers still marked draining."""
        node = self.node
        aborted = resumed = 0
        for mid, rec in node.placement.migration_snapshot().items():
            if rec["phase"] == "copying":
                aborted += 1
            else:
                resumed += 1
            node.placement.end_migration(mid)
        drains = 0
        for w in node.placement.draining_snapshot():
            self._ensure_drain_thread(w)
            drains += 1
        self._publish_active()
        if aborted or resumed or drains:
            log.info("resumed rebalance state after election",
                     aborted_copying=aborted, flipped_resumed=resumed,
                     drains_restarted=drains)
        return {"aborted": aborted, "resumed": resumed, "drains": drains}

    # ------------------------------------------------------------------
    # drain (planned decommission)
    # ------------------------------------------------------------------

    def start_drain(self, worker: str) -> dict:
        """Mark ``worker`` as decommissioning and start migrating it
        empty. Idempotent: a repeated request reports the in-progress
        drain. The draining flag rides the durable placement znode, so
        a leader failover restarts the drain instead of forgetting it."""
        changed = self.node.placement.set_draining(worker, True)
        if changed:
            global_metrics.inc("rebalance_drains_started")
            try:   # make the flag durable promptly (best-effort; the
                self.node.placement.flush()   # dirty flush covers it)
            except Exception:
                pass
        self._ensure_drain_thread(worker)
        self._publish_active()
        return self.drain_status(worker)

    def cancel_drain(self, worker: str) -> dict:
        """Clear the draining flag; the drain loop exits on its next
        check and already-moved docs stay where they landed."""
        self.node.placement.set_draining(worker, False)
        self._publish_active()
        return self.drain_status(worker)

    def drain_status(self, worker: str) -> dict:
        pm = self.node.placement
        remaining = len(pm.names_on(worker))
        pending = len(pm.pending_moved().get(worker, frozenset()))
        return {"worker": worker,
                "draining": worker in pm.draining_snapshot(),
                "remaining": remaining,
                "pending_delete": pending,
                "drained": remaining == 0 and pending == 0}

    def _ensure_drain_thread(self, worker: str) -> None:
        with self._drain_lock:
            t = self._drain_threads.get(worker)
            if t is not None and t.is_alive():
                return
            t = threading.Thread(
                target=self._drain_loop, args=(worker,), daemon=True,
                name=f"drain-{self.node.config.port}")
            self._drain_threads[worker] = t
            t.start()

    def _drain_loop(self, worker: str) -> None:
        node = self.node
        stalls = 0
        # count a completion only when THIS loop saw work to do: a
        # restarted loop over an already-empty draining worker (leader
        # failover, repeated POST) must not re-increment the lifetime
        # counter on its first empty check
        progressed = False
        while not node._stopping:
            if not node.is_leader() \
                    or worker not in node.placement.draining_snapshot():
                return
            pending = node.placement.pending_moved().get(
                worker, frozenset())
            names = [n for n in sorted(node.placement.names_on(worker))
                     if n not in pending][:MAX_DOCS_PER_PASS]
            if names or pending:
                progressed = True
            if not names:
                if not pending:
                    if progressed:
                        global_metrics.inc("rebalance_drains_completed")
                    log.info("drain complete; worker holds no placed "
                             "documents", worker=worker)
                    return
                time.sleep(0.2)   # deletes still landing via the sweep
                continue
            out = self.migrate(worker, names, kind="drain")
            if out.get("moved", 0) == 0:
                # no progress (no capacity — e.g. every live worker
                # already holds these docs — faults, or not leader):
                # back off and retry; the drain never degrades the
                # replication factor, so it WAITS for capacity (a new
                # worker joining) instead of dropping copies. Stay
                # loud: a stalled drain is an operator-visible state.
                stalls += 1
                if stalls % 20 == 1:
                    log.warning(
                        "drain stalled: no viable migration target "
                        "for remaining docs (needs a live, "
                        "non-draining worker not already holding "
                        "them); will keep retrying",
                        worker=worker, remaining=len(names))
                time.sleep(0.5)
            else:
                stalls = 0
