"""R-way document placement: replica map, per-query ownership, durability.

The reference places every document on exactly one worker
(``Leader.java:153-207``); losing that worker loses the shard from every
search until a pod restart re-walks its volume. This module holds the
framework's replicated placement state and the two disciplines built on
top of it:

- **Replica map** — ``doc name -> ordered replica URLs`` (primary
  first), with per-leg upload bookkeeping (in-flight counts, confirmed
  acceptances) so a replica that never accepted an upload can never be
  believed to hold the document, and pending-reconcile state
  (``moved``: worker URL -> names awaiting deletion from it after a
  move or an over-replication trim).
- **Ownership assignment** — for one scatter, exactly one live,
  breaker-closed replica *owns* (scores) each document, so the leader's
  sum-merge stays double-count-free by construction; the assignment is
  cached keyed by ``(map generation, live set, open-breaker set)`` so
  the per-scatter cost is O(changed), not O(corpus).
- **Durable persistence** — the map (and the pending-reconcile state)
  is serialized into a znode through the coordination substrate (the
  quorum ensemble), debounced by a small flush window, so a NEW
  leader resumes with exact ownership instead of an empty in-memory
  map — closing the leader-failover double-count window
  a review flagged (``_moved`` used to be leader-memory-only).
- **Migration state** — the Rebalancer's staged live-migration records
  (``copying -> flipped -> reconciled``; ``cluster/rebalance.py``) and
  the draining-worker set ride the same durable znode, so a leader
  failover mid-migration resumes or rolls back cleanly: a half-copied
  range is never believed owned (copy legs are ordinary non-primary
  confirmed replicas), and a flipped range is never re-flipped back
  (the flip is one atomic in-memory mutation made durable before any
  reconcile delete may run).

Locking: one lock guards all map state. Persistence snapshots under the
lock and performs the coordination write OUTSIDE it (the graftcheck
lockgraph contract: no RPC under a hot-path lock).
"""

from __future__ import annotations

import json
import threading
import time
import zlib
from typing import Callable, NamedTuple

from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  LocalCoordination,
                                                  NoNodeError,
                                                  data_digest)
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.placement")

PLACEMENT_NAMESPACE = "/placement"
PLACEMENT_STATE = "/placement/state"


class OwnerView(NamedTuple):
    """One scatter's ownership assignment (immutable snapshot)."""

    owner: dict            # doc name -> owning worker URL
    owned: dict            # worker URL -> list of owned doc names
    replica_workers: frozenset   # workers appearing in any replica list
    dark: tuple            # mapped names with NO live replica at all


class PlacementMap:
    """Replica map + ownership + durable persistence (see module doc).

    Public mutators take the internal lock themselves; ``*_locked``
    variants exist for the upload planners that must route a whole
    batch atomically (caller holds :attr:`lock`).
    """

    def __init__(self, flush_ms: float = 50.0, name: str = "") -> None:
        self.lock = threading.Lock()
        # doc -> ordered replica URLs (primary first). May include
        # tentative (claimed, unconfirmed) replicas while upload legs
        # are in flight; a leg failure removes its never-confirmed leg.
        self.replicas: dict[str, tuple[str, ...]] = {}
        # worker URL -> names pending deletion from it (moved away or
        # over-replicated); merged search results exclude these names
        # from that worker until the delete lands.
        self.moved: dict[str, set[str]] = {}
        self._confirmed: dict[str, set[str]] = {}
        # name -> its last holders, for names that lost their LAST
        # replica to worker deaths (leader memory only): their copies
        # may be the only ones left, so no delete is pending on them,
        # and a client delete must still reach them when they return
        self._dark: dict[str, set[str]] = {}
        # names of client deletes whose durable flush has not returned:
        # a load in that window (a re-election of this node) must not
        # merge them back from the not-yet-rewritten znode
        self._deleting: set[str] = set()
        # names client deletes removed in this tenure: a copy that shows
        # up later (on a worker away at the time, in an ex-leader's
        # engine) is a ghost to delete, never an orphan to adopt or
        # re-place; a new upload of the name, or a loaded map that holds
        # it again, lifts the tombstone
        self._tombstones: set[str] = set()
        self._inflight: dict[tuple[str, str], int] = {}
        # live-migration records (cluster/rebalance.py): migration id ->
        # {"source", "targets": {name: [urls]}, "phase", "kind"}. Names
        # under an active record are protected from the over-replication
        # trim (the mid-copy target legs ARE over-replication until the
        # flip). Persisted, so a new leader sees in-flight migrations.
        self.migrations: dict[str, dict] = {}
        self._mig_seq = 0
        # workers being decommissioned (drain): excluded from new-name
        # routing and from repair targets. Persisted, so a leader
        # failover does not resurrect routing onto a half-drained node.
        self.draining: set[str] = set()
        self.gen = 0              # bumped on every replica/moved change
        self._name = name
        # leadership epoch (cluster/fencing.py), set by the node at
        # promotion: stamped into the durable znode so the map's
        # lineage is auditable, and checked at flush time — a deposed
        # leader's debounced flush must not clobber the successor's
        # map even in the tiny window before its demotion lands
        self.epoch: int | None = None
        # ---- persistence ----
        self._flush_s = flush_ms / 1e3 if flush_ms >= 0 else -1.0
        self._coord_getter: Callable | None = None
        self._persist_enabled = False
        # optional leadership fence re-checked at every flush: an
        # ex-leader whose demotion callback has not landed yet (or
        # whose session expired while it can still reach the quorum)
        # must not overwrite the new leader's persisted map with its
        # stale snapshot. The check-then-write window remains (the
        # substrate has no compare-and-set), but it shrinks from a
        # whole debounce cycle to one RPC.
        self.persist_gate: Callable[[], bool] | None = None
        self._dirty = False
        self._stopping = False
        self._wake = threading.Event()
        self._persister: threading.Thread | None = None
        # flush write-out ORDER lock: serialize-then-write must be
        # atomic across concurrent flushes (the debounced persister vs
        # a synchronous delete/flip flush) — otherwise a pre-mutation
        # snapshot stuck in slow coordination RPCs can overwrite a
        # later mutation's already-written payload, resurrecting e.g.
        # an acked delete on the next leader's load (a real lost
        # update the partition chaos suite caught). Held across the
        # coordination write BY DESIGN (reviewed; graftcheck
        # allowlist) — it is a serialization lock no hot path takes.
        self._flush_serial = threading.Lock()

    # ------------------------------------------------------------------
    # routing + upload-leg bookkeeping
    # ------------------------------------------------------------------

    def route_locked(self, name: str, workers: list[str],
                     sizes: dict[str, int],
                     candidates: list[str] | None,
                     r: int) -> tuple[tuple[str, ...], bool]:
        """Route one document (caller holds :attr:`lock`): a held name
        goes to its live replicas (upserts update every copy — judged
        against the REGISTRY list, like the single-copy router, so a
        transient poll failure cannot re-place a placed name); a new
        name claims the ``r`` least-loaded candidates. Tracks one
        in-flight upload leg per returned worker. Returns
        ``(replicas, is_new_claim)``."""
        self._tombstones.discard(name)
        held = self.replicas.get(name)
        if held:
            live_held = tuple(w for w in held if w in workers)
            if live_held:
                for w in live_held:
                    self._track_leg(name, w)
                return live_held, False
        live = {w: sizes[w] for w in (candidates or workers) if w in sizes}
        if not live:
            raise RuntimeError("no reachable workers")
        # least-loaded first; equal loads tie-break by a per-NAME hash
        # (crc32: deterministic across processes, unlike str hash) so
        # the PRIMARY — the replica that owns/scores the doc in steady
        # state — spreads across replicas instead of piling the whole
        # owner load onto the lexically-smallest worker
        chosen = tuple(sorted(
            live, key=lambda w: (live[w],
                                 zlib.crc32(f"{name}|{w}".encode()), w))
            [:max(1, r)])
        self.replicas[name] = chosen
        self.gen += 1
        for w in chosen:
            # a worker gaining a copy must not still be scheduled to
            # have that very name deleted from it
            self._unmove_locked(w, name)
            self._track_leg(name, w)
        return chosen, True

    def _track_leg(self, name: str, worker: str) -> None:
        key = (name, worker)
        self._inflight[key] = self._inflight.get(key, 0) + 1

    def leg_success(self, name: str, worker: str,
                    moved_from: str | None = None) -> bool:
        """One upload leg accepted by ``worker``: the placement of
        ``name`` on it is confirmed (and becomes persistable AND
        ownable — confirmation changes the owner-candidate set, so the
        generation bumps). ``moved_from``: the leg re-places the name
        away from that (dead) worker; its pending delete there is
        recorded in the same step, under the same rule as
        :meth:`note_moved`, so no reader sees the new copy without the
        old one's pending delete. Returns whether it was recorded."""
        noted = False
        with self.lock:
            key = (name, worker)
            n = self._inflight.get(key, 1) - 1
            if n > 0:
                self._inflight[key] = n
            else:
                self._inflight.pop(key, None)
            conf = self._confirmed.setdefault(name, set())
            if worker not in conf:
                conf.add(worker)
                self.gen += 1
            reps = self.replicas.get(name, ())
            if worker not in reps:
                self.replicas[name] = reps + (worker,)
                self.gen += 1
            self._unmove_locked(worker, name)
            if moved_from is not None \
                    and moved_from not in self.replicas[name]:
                moved = self.moved.setdefault(moved_from, set())
                if name not in moved:
                    moved.add(name)
                    self.gen += 1
                    noted = True
            self._mark_dirty_locked()
        return noted

    def reset_for_follower(self) -> None:
        """Demotion: a non-leader's map has no authority — clear it so
        a LATER re-promotion loads the durable map fresh instead of
        letting stale previous-tenure entries win the load merge (an
        ex-leader's memory is older than the map its successors
        persisted, not newer). Upload legs still settling after the
        reset re-insert only what a worker really accepted."""
        with self.lock:
            self.replicas.clear()
            self.moved.clear()
            self._confirmed.clear()
            self._dark.clear()
            self._tombstones.clear()
            self.migrations.clear()
            self.draining.clear()
            self._owner_cache = None
            self.gen += 1
            self._dirty = False

    def leg_failure(self, name: str, worker: str) -> None:
        """One upload leg failed. Once no legs for ``(name, worker)``
        remain in flight and no leg EVER succeeded there, the tentative
        replica is removed — a worker that never accepted the document
        must never be assigned to score it (it would silently answer
        without the doc). An empty replica list drops the entry
        entirely (phantom cleanup: retries may re-place anywhere)."""
        with self.lock:
            key = (name, worker)
            n = self._inflight.get(key, 1) - 1
            if n > 0:
                self._inflight[key] = n
                return
            self._inflight.pop(key, None)
            if worker in self._confirmed.get(name, ()):
                return   # an earlier upload confirmed this copy; keep it
            reps = self.replicas.get(name)
            if reps and worker in reps:
                reps = tuple(w for w in reps if w != worker)
                if reps:
                    self.replicas[name] = reps
                else:
                    del self.replicas[name]
                    self._confirmed.pop(name, None)
                self.gen += 1
                self._mark_dirty_locked()

    def holders_of(self, name: str) -> tuple[str, ...]:
        with self.lock:
            return self.replicas.get(name, ())

    def names_on(self, worker: str) -> list[str]:
        with self.lock:
            return [n for n, ws in self.replicas.items() if worker in ws]

    # ------------------------------------------------------------------
    # death / rejoin / repair transitions
    # ------------------------------------------------------------------

    def drop_worker(self, worker: str) -> tuple[list[str], list[str]]:
        """Remove a dead worker from every replica list. Returns
        ``(still_replicated, lost)``: names that keep at least one
        replica (the dead worker's copy becomes pending-delete for its
        possible rejoin) and names that lost their LAST replica (the
        caller must re-place them from the durable store)."""
        kept: list[str] = []
        lost: list[str] = []
        with self.lock:
            # a dead worker is no longer draining — the drain's purpose
            # (migrate it empty before it leaves) is moot once it left.
            # The clear must be PERSISTED even when the worker held no
            # docs (the completed-drain decommission case): load()
            # unions the draining set, so a stale durable flag would
            # resurrect forever and exclude a later pod at the same
            # stable URL from routing.
            was_draining = worker in self.draining
            self.draining.discard(worker)
            for name, reps in list(self.replicas.items()):
                if worker not in reps:
                    continue
                rest = tuple(w for w in reps if w != worker)
                self._confirmed.get(name, set()).discard(worker)
                if rest:
                    self.replicas[name] = rest
                    self.moved.setdefault(worker, set()).add(name)
                    kept.append(name)
                else:
                    del self.replicas[name]
                    self._confirmed.pop(name, None)
                    lost.append(name)
            # a name that lost its LAST replica keeps no pending delete
            # anywhere: an earlier death's copy, scheduled away while
            # this worker still held the name, may now be the only one
            # left (a rejoin would delete it, and the residue pass would
            # call every other surviving copy a ghost). Its holders are
            # remembered, so a client delete still reaches them.
            for name in lost:
                dark = self._dark.setdefault(name, set())
                dark.add(worker)
                for w, ns in list(self.moved.items()):
                    if name in ns:
                        dark.add(w)
                        ns.discard(name)
                        if not ns:
                            del self.moved[w]
            if kept or lost or was_draining:
                self.gen += 1
                self._mark_dirty_locked()
        return kept, lost

    def note_moved(self, names: list[str], old_worker: str) -> int:
        """Record names as moved away from ``old_worker`` — only those
        whose CURRENT replica set exists and excludes it (deleting the
        sole copy stays impossible by construction)."""
        n = 0
        with self.lock:
            moved = self.moved.setdefault(old_worker, set())
            for name in names:
                reps = self.replicas.get(name)
                if reps and old_worker not in reps:
                    if name not in moved:
                        moved.add(name)
                        n += 1
            if n:
                self.gen += 1
                self._mark_dirty_locked()
        return n

    def moved_resolved(self, worker: str, names: set[str]) -> None:
        """The worker confirmed deletion of ``names``; clear them from
        its pending set (names moved DURING the RPC stay pending)."""
        with self.lock:
            cur = self.moved.get(worker)
            if cur is not None:
                cur -= names
                if not cur:
                    del self.moved[worker]
                self.gen += 1
                self._mark_dirty_locked()

    def pending_moved(self) -> dict[str, frozenset]:
        with self.lock:
            return {w: frozenset(ns) for w, ns in self.moved.items()
                    if ns}

    def forget(self, names: list[str],
               also: frozenset | set = frozenset()
               ) -> dict[str, list[str]]:
        """Client-driven deletion: drop each name from the replica map
        (scatters stop assigning it an owner immediately) and schedule
        worker-side deletion through the pending-reconcile (``moved``)
        machinery — merged results exclude the copies at once, and the
        sweep retries the deletes until every holder confirms.

        Scheduled on every CONFIRMED holder AND every worker in
        ``also`` (the caller passes the full live set): a GHOST copy —
        an upload leg recorded as failed whose request the worker
        actually processed — is invisible to the map, masked by owner
        assignment while the name is mapped, and would resurrect
        through the legacy sum-merge the moment the delete unmaps the
        name. Blanket scheduling deletes (and excludes) it everywhere;
        a worker without the doc confirms a zero-row delete and its
        entry clears.

        Returns ``worker -> names`` scheduled. A concurrent upsert of
        the same name simply wins (its leg confirmation re-creates the
        entry): last writer wins, like any upsert race."""
        out: dict[str, list[str]] = {}
        changed = False
        with self.lock:
            self._deleting.update(names)
            self._tombstones.update(names)
            for name in names:
                reps = self.replicas.pop(name, None)
                dark = self._dark.pop(name, ())
                if reps is None and not also and not dark:
                    continue
                conf = self._confirmed.pop(name, set())
                targets = set(also) | set(dark)
                targets.update(w for w in reps or () if w in conf)
                for w in targets:
                    self.moved.setdefault(w, set()).add(name)
                    out.setdefault(w, []).append(name)
                changed = True
            if changed:
                self._owner_cache = None
                self.gen += 1
                self._mark_dirty_locked()
        return out

    def delete_settled(self, names) -> None:
        """The durable flush of a client delete of ``names`` returned,
        either way: a later load may merge them again."""
        with self.lock:
            self._deleting.difference_update(names)

    def add_replica(self, name: str, worker: str) -> bool:
        """Repair/migration confirmed a new copy of ``name`` on
        ``worker``. Returns False ONLY when the map no longer knows the
        name (deleted mid-copy) — the caller must ``note_stray`` the
        landed copy so it can neither resurrect through the legacy
        sum-merge nor linger on the worker's disk."""
        with self.lock:
            reps = self.replicas.get(name)
            if reps is None:
                return False
            if worker in reps:
                return True
            self.replicas[name] = reps + (worker,)
            self._confirmed.setdefault(name, set()).add(worker)
            self._unmove_locked(worker, name)
            self.gen += 1
            self._mark_dirty_locked()
            return True

    def note_stray(self, name: str, worker: str) -> None:
        """A copy of ``name`` landed on ``worker`` but the map no
        longer maps the name (a client delete won the race against an
        in-flight repair/migration copy): schedule the stray for
        deletion through the pending-reconcile machinery — excluded
        from merges immediately, removed by the sweep."""
        with self.lock:
            reps = self.replicas.get(name)
            if reps and worker in reps:
                return   # re-created meanwhile (upsert): legitimate
            self.moved.setdefault(worker, set()).add(name)
            self.gen += 1
            self._mark_dirty_locked()
        global_metrics.inc("placement_stray_copies")

    def reconcile_residue(self, worker: str, names: list[str],
                          protected: set[str]
                          ) -> tuple[list[str], list[str]]:
        """Anti-entropy for UNMAPPED engine residue: ``names`` is what
        ``worker``'s engine ACTUALLY serves. A copy the map does not
        credit to it is partition leftover that owner assignment can
        only mask, never clean — it silently skews that shard's df/N
        statistics and resurfaces the moment the name leaves the map:

        - **ghost** (the name is mapped elsewhere, or is pending
          deletion anywhere): schedule it for deletion from ``worker``
          through the moved machinery;
        - **orphan** (the name is mapped nowhere): a write that landed
          but whose placement was lost to a partition — ADOPT it as a
          confirmed replica (durability wins: an ambiguous write that
          survived becomes first-class; the repair pass restores R).

        Names in ``protected`` (mid-migration) or with any in-flight
        upload leg are skipped — their own machinery owns them.
        Returns ``(ghosts, orphans)``."""
        ghosts: list[str] = []
        orphans: list[str] = []
        with self.lock:
            inflight_names = {k[0] for k in self._inflight}
            for name in names:
                if name in protected or name in inflight_names:
                    continue
                if name in self.moved.get(worker, ()):
                    continue          # already scheduled away
                reps = self.replicas.get(name)
                if reps is not None and worker in reps:
                    continue          # the map credits this copy
                pending_anywhere = name in self._tombstones or any(
                    name in ns for ns in self.moved.values())
                if reps is None and not pending_anywhere:
                    self.replicas[name] = (worker,)
                    self._confirmed[name] = {worker}
                    self._dark.pop(name, None)
                    orphans.append(name)
                else:
                    self.moved.setdefault(worker, set()).add(name)
                    ghosts.append(name)
            if ghosts or orphans:
                self._owner_cache = None
                self.gen += 1
                self._mark_dirty_locked()
        return ghosts, orphans

    def unplaced_of(self, names, protected: set[str]) -> list[str]:
        """Names mapped nowhere, pending deletion nowhere, and with no
        in-flight upload legs — the leader's own-engine orphan check
        (an ex-worker-turned-leader can hold the ONLY copy of a doc
        whose placement was lost to a partition; its engine serves no
        scatter, so the copy is unreachable until re-placed)."""
        out: list[str] = []
        with self.lock:
            inflight_names = {k[0] for k in self._inflight}
            for name in names:
                if name in protected or name in inflight_names:
                    continue
                if name in self.replicas or name in self._tombstones:
                    continue
                if any(name in ns for ns in self.moved.values()):
                    continue
                out.append(name)
        return out

    def trim_plan(self, live: set[str], r: int) -> dict[str, list[str]]:
        """Over-replication trim: for every name with more than ``r``
        LIVE confirmed replicas, schedule the extras (last in priority
        order) for deletion; returns ``worker -> names`` newly moved.
        The deletes themselves flow through the reconcile machinery."""
        out: dict[str, list[str]] = {}
        with self.lock:
            changed = False
            # names under an active migration are protected: their
            # freshly-copied target legs ARE over-replication until the
            # flip lands — trimming them would undo the copy phase
            protected: set[str] = set()
            for rec in self.migrations.values():
                protected.update(rec.get("targets", ()))
            for name, reps in list(self.replicas.items()):
                if name in protected:
                    continue
                # keepers are chosen among CONFIRMED live replicas
                # only: a tentative in-flight upload leg must neither
                # protect a slot (its leg may yet fail, and the trimmed
                # confirmed copy would already be on the delete wire)
                # nor be trimmed (it holds nothing to delete yet)
                conf = self._confirmed.get(name, ())
                confirmed_live = [w for w in reps
                                  if w in live and w in conf]
                if len(confirmed_live) <= r:
                    continue
                extras = confirmed_live[r:]
                if not extras:
                    continue
                rest = tuple(w for w in reps if w not in extras)
                self.replicas[name] = rest
                for w in extras:
                    self._confirmed.get(name, set()).discard(w)
                    self.moved.setdefault(w, set()).add(name)
                    out.setdefault(w, []).append(name)
                changed = True
            if changed:
                self.gen += 1
                self._mark_dirty_locked()
        return out

    def under_replicated(self, live: set[str],
                         r: int) -> dict[str, tuple[str, ...]]:
        """Names whose LIVE replica count is below ``r`` -> their live
        replicas (possibly empty)."""
        with self.lock:
            out = {}
            for name, reps in self.replicas.items():
                live_reps = tuple(w for w in reps if w in live)
                if len(live_reps) < r:
                    out[name] = live_reps
            return out

    def _unmove_locked(self, worker: str, name: str) -> None:
        cur = self.moved.get(worker)
        if cur is not None:
            cur.discard(name)
            if not cur:
                del self.moved[worker]

    # ------------------------------------------------------------------
    # live migration (the Rebalancer's staged state machine)
    # ------------------------------------------------------------------

    def begin_migration(self, source: str,
                        targets_by_name: dict[str, list[str]],
                        kind: str = "rebalance") -> str:
        """Record a new migration in phase ``copying`` (durably, via
        the normal dirty flush). Crash here or anywhere in the copy
        phase is safe by construction: the copy legs land as ordinary
        NON-primary confirmed replicas, so ownership never moves until
        the flip — a new leader aborts a copying-phase record and the
        trim pass reclaims any legs that confirmed."""
        with self.lock:
            self._mig_seq += 1
            mid = f"m{self._mig_seq}"
            self.migrations[mid] = {
                "source": source,
                "targets": {n: list(ts)
                            for n, ts in targets_by_name.items()},
                "phase": "copying", "kind": kind}
            self.gen += 1
            self._mark_dirty_locked()
        return mid

    def flip_migration(self, mid: str) -> list[str]:
        """ONE atomic in-memory ownership flip for every name whose
        migration targets CONFIRMED their copy: targets become the
        leading replicas, the source leaves the replica set and its
        copy is scheduled for reconcile-delete (``moved``). Names whose
        copy never confirmed (or whose source already vanished) are
        skipped — a half-copied range is never believed owned.

        The caller must make the flip durable (``flush()``) BEFORE any
        reconcile delete may run, and call :meth:`unflip_migration` if
        it cannot — a non-durable flip followed by deletes would let a
        leader failover resurrect source ownership of deleted copies.
        Returns the flipped names."""
        with self.lock:
            rec = self.migrations.get(mid)
            if rec is None or rec.get("phase") != "copying":
                return []
            src = rec["source"]
            flipped: list[str] = []
            prior: dict[str, tuple[str, ...]] = {}
            for name, targets in rec["targets"].items():
                reps = self.replicas.get(name)
                if not reps or src not in reps:
                    continue   # source already dropped/moved elsewhere
                conf = self._confirmed.get(name, set())
                tgts = [t for t in targets if t in conf and t in reps]
                if not tgts:
                    continue   # copy never confirmed: stays put
                prior[name] = reps
                rest = tuple(w for w in reps
                             if w != src and w not in tgts)
                self.replicas[name] = tuple(tgts) + rest
                conf.discard(src)
                self.moved.setdefault(src, set()).add(name)
                flipped.append(name)
            if flipped:
                rec["phase"] = "flipped"
                rec["prior"] = prior          # in-memory only (unflip)
                rec["flipped"] = list(flipped)
                self._owner_cache = None
                self.gen += 1
                self._mark_dirty_locked()
            return flipped

    def unflip_migration(self, mid: str) -> None:
        """Roll a non-durable flip back (the flush failed or leadership
        was lost): restore each flipped name's pre-flip replica order,
        re-confirm the source (it held the doc before the flip and no
        delete has run — the caller serializes against the reconcile
        machinery), and cancel the scheduled deletes."""
        with self.lock:
            rec = self.migrations.get(mid)
            if rec is None or rec.get("phase") != "flipped":
                return
            src = rec["source"]
            for name, reps in rec.get("prior", {}).items():
                if name not in self.replicas:
                    continue
                self.replicas[name] = tuple(reps)
                self._confirmed.setdefault(name, set()).add(src)
                self._unmove_locked(src, name)
            rec["phase"] = "copying"
            rec.pop("prior", None)
            rec.pop("flipped", None)
            self._owner_cache = None
            self.gen += 1
            self._mark_dirty_locked()

    def end_migration(self, mid: str) -> None:
        """Drop a migration record: after a DURABLE flip (the ``moved``
        machinery owns the reconcile tail from here), or to abort a
        copying-phase migration (confirmed copy legs become plain
        over-replication for the trim pass to reclaim)."""
        with self.lock:
            if self.migrations.pop(mid, None) is not None:
                self.gen += 1
                self._mark_dirty_locked()

    def migration_snapshot(self) -> dict[str, dict]:
        with self.lock:
            return {mid: {"source": rec["source"],
                          "phase": rec.get("phase", "copying"),
                          "kind": rec.get("kind", "rebalance"),
                          "targets": {n: list(ts) for n, ts
                                      in rec.get("targets", {}).items()}}
                    for mid, rec in self.migrations.items()}

    def migrating_names(self) -> set[str]:
        with self.lock:
            out: set[str] = set()
            for rec in self.migrations.values():
                out.update(rec.get("targets", ()))
            return out

    def set_draining(self, worker: str, on: bool) -> bool:
        """Mark/unmark a worker as decommissioning. Returns True when
        the flag actually changed."""
        with self.lock:
            if on == (worker in self.draining):
                return False
            if on:
                self.draining.add(worker)
            else:
                self.draining.discard(worker)
            self.gen += 1
            self._mark_dirty_locked()
            return True

    def draining_snapshot(self) -> frozenset:
        with self.lock:
            return frozenset(self.draining)

    # ------------------------------------------------------------------
    # ownership
    # ------------------------------------------------------------------

    _owner_cache: tuple | None = None

    def owner_assignment(self, live: frozenset,
                         open_set: frozenset) -> OwnerView:
        """Per-scatter ownership: for each mapped doc, the FIRST live
        replica whose breaker is closed (falling back to the first live
        replica if every one is open — an honest attempt beats a silent
        omission). Cached by ``(gen, live, open_set)`` so steady-state
        scatters pay O(1), not O(corpus)."""
        key = (self.gen, live, open_set)
        with self.lock:
            cached = self._owner_cache
            if cached is not None and cached[0] == key:
                return cached[1]
            snap = {n: (ws, frozenset(self._confirmed.get(n, ())))
                    for n, ws in self.replicas.items()}
            gen = self.gen
        owner: dict[str, str] = {}
        owned: dict[str, list[str]] = {}
        replica_workers: set[str] = set()
        dark: list[str] = []
        for name, (reps, conf) in snap.items():
            # CONFIRMED replicas only may own: a tentative in-flight
            # upload leg cannot be believed to hold the doc, and making
            # it the owner would drop the confirmed replica's real hits
            # as non-owner. A brand-new name with no confirmation yet
            # falls back to its planned replicas (the NRT upload race:
            # at worst a transiently missing hit, never a double count
            # — the owner is still unique).
            cand = [w for w in reps if w in live and w in conf] \
                or [w for w in reps if w in live]
            if not cand:
                dark.append(name)
                continue
            replica_workers.update(cand)
            own = next((w for w in cand if w not in open_set), cand[0])
            owner[name] = own
            owned.setdefault(own, []).append(name)
        view = OwnerView(owner, owned, frozenset(replica_workers),
                         tuple(dark))
        with self.lock:
            if self.gen == gen:
                self._owner_cache = (key, view)
        return view

    def backups_for(self, names: list[str], exclude: set[str],
                    live: set[str],
                    avoid: frozenset = frozenset()
                    ) -> dict[str, list[str]]:
        """Group orphaned names by the next usable replica. Preference
        order: CONFIRMED and not in ``avoid`` (open breakers) first,
        then confirmed-but-avoided, then tentative (a tentative leg
        holds nothing to slice-score; an avoided replica will likely
        fast-fail — both are last-resort fallbacks, never silently
        skipped). Names with no live non-excluded replica are omitted
        (dark)."""
        with self.lock:
            snap = {n: (self.replicas.get(n, ()),
                        frozenset(self._confirmed.get(n, ())))
                    for n in names}
        out: dict[str, list[str]] = {}
        for name, (reps, conf) in snap.items():
            usable = [w for w in reps
                      if w in live and w not in exclude]
            if not usable:
                continue
            backup = min(usable,
                         key=lambda w: (w not in conf, w in avoid,
                                        reps.index(w)))
            out.setdefault(backup, []).append(name)
        return out

    # ------------------------------------------------------------------
    # durability (znode through the coordination substrate)
    # ------------------------------------------------------------------

    def bind_store(self, coord_getter: Callable) -> None:
        """``coord_getter()`` returns the CURRENT coordination client
        (rebound after a session-expiry rejoin)."""
        self._coord_getter = coord_getter

    def _store(self) -> "CoordinationClient | LocalCoordination":
        """The bound coordination client. A typed accessor so the
        static lock graph sees the flush's coordination-client edges
        (the raw ``_coord_getter`` callable is opaque to the resolver
        — the lockdep witness cross-checks these orderings)."""
        return self._coord_getter()

    def start_persister(self) -> None:
        if self._flush_s < 0 or self._persister is not None:
            return
        self._persister = threading.Thread(
            target=self._persist_loop, daemon=True,
            name=f"placement-persist-{self._name}")
        self._persister.start()

    def stop(self) -> None:
        self._stopping = True
        self._wake.set()

    def set_persist_enabled(self, enabled: bool) -> None:
        """Leader-only writes: the map is the LEADER's authoritative
        state; a worker must never clobber it."""
        self._persist_enabled = enabled
        if enabled:
            self._wake.set()

    def _mark_dirty_locked(self) -> None:
        self._dirty = True
        self._wake.set()

    def _persist_loop(self) -> None:
        # bounded waits + stop re-checks throughout (the lockgraph
        # indefinite-wait audit's contract)
        while not self._stopping:
            if not self._wake.wait(timeout=0.5):
                continue
            self._wake.clear()
            if self._stopping:
                return
            if not (self._dirty and self._persist_enabled):
                continue
            if self._flush_s > 0:
                # debounce: coalesce a burst of mutations into one write
                time.sleep(self._flush_s)
            try:
                self.flush()
            except Exception as e:
                global_metrics.inc("placement_persist_failures")
                log.warning("placement persist failed", err=repr(e))
                # stay dirty; retry on the next wake/timeout
                with self.lock:
                    self._mark_dirty_locked()
                time.sleep(0.2)

    def flush(self) -> bool:
        """Persist the current CONFIRMED state now (synchronous; also
        used by tests and the resign path). Returns False when
        persistence is disabled/unbound."""
        if self._coord_getter is None or self._flush_s < 0 \
                or not self._persist_enabled:
            return False
        if self.persist_gate is not None:
            try:
                if not self.persist_gate():
                    return False   # not (or no longer) the leader
            except Exception:
                return False       # can't prove leadership: don't write
        with self._flush_serial:
            # snapshot + write as one ordered unit (see __init__)
            with self.lock:
                self._dirty = False
                payload = self._serialize_locked()
            global_injector.check("leader.placement_persist")
            coord = self._store()
            if self.epoch is not None and self._fenced_by_stored(coord):
                return False
            coord.ensure(PLACEMENT_NAMESPACE)
            coord.ensure(PLACEMENT_STATE)
            coord.set_data(PLACEMENT_STATE, payload)
        global_metrics.inc("placement_persists")
        return True

    def _fenced_by_stored(
            self, coord: "CoordinationClient | LocalCoordination"
    ) -> bool:
        """Epoch fence on the durable map itself: when the stored
        znode carries a HIGHER leadership epoch than ours, a successor
        already owns the map — skip the write (the persist_gate's
        is_leader re-check covers the reachable-coordinator case; this
        covers the race where a deposed leader's flush is already past
        the gate). Unreadable/absent stored state never blocks: the
        gate vouched for leadership, so writing is correct."""
        try:
            raw = coord.get_data(PLACEMENT_STATE)
            stored = json.loads(raw.decode()).get("epoch") if raw \
                else None
        except NoNodeError:
            return False
        except Exception:
            return False
        if stored is not None and int(stored) > self.epoch:
            global_metrics.inc("placement_fence_skips")
            log.warning("placement flush fenced: durable map belongs "
                        "to a newer leader", ours=self.epoch,
                        stored=stored)
            return True
        return False

    def _serialize_locked(self) -> bytes:
        # only CONFIRMED replicas are durable: a tentative claim whose
        # upload never landed must not resurrect on the next leader
        reps = {}
        for name, ws in self.replicas.items():
            conf = self._confirmed.get(name, ())
            keep = [w for w in ws if w in conf]
            if keep:
                reps[name] = keep
        out = {
            "v": 2,
            "replicas": reps,
            "moved": {w: sorted(ns) for w, ns in self.moved.items() if ns},
            # the writing leader's in-memory map generation: follower
            # views (PlacementFollower) report it so operators can see
            # each router's lag behind the leader in GENERATIONS, not
            # just wall-clock age (additive; old payloads load fine)
            "gen": self.gen,
        }
        if self.epoch is not None:
            # the writing leader's fencing epoch: audited by operators,
            # checked by _fenced_by_stored on every later flush
            out["epoch"] = self.epoch
        # migration records persist only their durable fields — the
        # unflip bookkeeping ("prior") is same-process-rollback state
        if self.migrations:
            out["migrations"] = {
                mid: {"source": rec["source"],
                      "targets": rec.get("targets", {}),
                      "phase": rec.get("phase", "copying"),
                      "kind": rec.get("kind", "rebalance")}
                for mid, rec in self.migrations.items()}
        if self.draining:
            out["draining"] = sorted(self.draining)
        return json.dumps(out).encode()

    def load(self) -> int:
        """Merge the persisted map into memory (new-leader resume).
        In-memory entries win on conflict — they are at least as fresh
        on this node. Returns the number of documents loaded."""
        if self._coord_getter is None:
            return 0
        coord = self._store()
        try:
            raw = coord.get_data(PLACEMENT_STATE)
        except NoNodeError:
            return 0
        if not raw:
            return 0
        state = json.loads(raw.decode())
        loaded = {n: tuple(ws) for n, ws in state.get("replicas",
                                                      {}).items()}
        moved = {w: set(ns) for w, ns in state.get("moved", {}).items()}
        migrations = state.get("migrations", {})
        draining = set(state.get("draining", ()))
        with self.lock:
            n = 0
            for name, ws in loaded.items():
                if name in self._deleting:
                    continue
                self._tombstones.discard(name)
                if name not in self.replicas:
                    self.replicas[name] = ws
                    self._confirmed[name] = set(ws)
                    n += 1
            for w, ns in moved.items():
                cur = self.moved.setdefault(w, set())
                # never schedule a live replica's copy for deletion
                cur |= {nm for nm in ns
                        if w not in self.replicas.get(nm, ())}
                if not cur:
                    del self.moved[w]
            # a predecessor's in-flight migrations: adopt the records
            # (the Rebalancer's resume pass then aborts copying-phase
            # ones and lets the moved machinery finish flipped ones)
            # and keep the id sequence past them so new migrations this
            # tenure never collide with a loaded record
            for mid, rec in migrations.items():
                self.migrations.setdefault(mid, dict(rec))
                if mid[:1] == "m" and mid[1:].isdigit():
                    self._mig_seq = max(self._mig_seq, int(mid[1:]))
            self.draining |= draining
            if n or moved or migrations or draining:
                self.gen += 1
        global_metrics.inc("placement_loads")
        global_metrics.set_gauge("placement_loaded_docs", n)
        log.info("placement map loaded from coordination substrate",
                 docs=n, moved_workers=len(moved))
        return n


class PlacementFollower(PlacementMap):
    """Read-only follower view of the durable placement znode — the
    scale-out query plane's routing table (cluster/router.py).

    The leader's :class:`PlacementMap` is authoritative, leader-memory
    + durable znode; every OTHER read-serving party — a dedicated
    stateless router, or a non-leader node answering ``/leader/start``
    — routes through one of these instead: the znode payload is loaded
    wholesale (REPLACE semantics, never the new-leader merge of
    :meth:`PlacementMap.load`), a data watch on the znode triggers a
    refresh the moment the leader flushes (``NodeDataChanged``, armed
    via ``exists`` and re-armed after every fire — one-shot semantics),
    and a periodic pass re-reads as a missed-watch backstop. Writes
    never happen here: persistence is structurally disabled and the
    mutating entry points are unused by the read plane.

    **Staleness is tracked, not hidden.** ``version`` bumps on every
    observed payload change (the router's result-cache token rides it);
    ``loaded_epoch``/``loaded_gen`` echo the writing leader's fencing
    epoch and map generation so operators can read each router's lag;
    and when the view cannot be confirmed fresh — the coordinator is
    unreachable (every refresh failing) or a test froze the view — for
    longer than ``stale_ms``, :meth:`suspect` turns True and the read
    plane marks every response degraded (``X-Scatter-Degraded`` with
    ``stale_view=1``) and stops serving from its result cache. The
    marker self-heals on the next successful refresh.

    ``freeze()`` is the deterministic nemesis hook: it pins the view
    exactly like a coordinator partition would (refreshes fail, the
    watch never fires through), without needing the HTTP transport.
    """

    def __init__(self, name: str = "", refresh_ms: float = 1000.0,
                 stale_ms: float = 5000.0) -> None:
        super().__init__(flush_ms=-1.0, name=name)   # never persists
        self._refresh_s = max(refresh_ms, 10.0) / 1e3
        self._stale_s = stale_ms / 1e3
        self.version = 0          # bumped per observed payload change
        self.loaded = False       # a payload has been installed
        self.loaded_epoch: int | None = None
        self.loaded_gen = -1
        self._started = False
        self._last_ok: float | None = None
        self._last_raw: bytes | None = None
        self._last_digest: str | None = None
        self._frozen = False
        self._watch_armed = False
        self._refresher: threading.Thread | None = None

    # ---- lifecycle ----

    def start(self) -> None:
        """Arm the watch + start the periodic refresh backstop. One
        immediate refresh runs on the caller's thread so a router that
        could reach the coordinator at boot serves from a real view
        from its first request."""
        if self._started or self._coord_getter is None:
            return
        self._started = True
        try:
            self.refresh()
        except Exception as e:
            log.warning("initial placement view refresh failed",
                        err=repr(e))
        self._refresher = threading.Thread(
            target=self._refresh_loop, daemon=True,
            name=f"placement-follow-{self._name}")
        self._refresher.start()

    def _refresh_loop(self) -> None:
        # bounded waits + stop re-checks (the lockgraph indefinite-wait
        # audit's contract); the watch event sets _wake so a flush on
        # the leader propagates at watch latency, not poll latency
        while not self._stopping:
            self._wake.wait(timeout=self._refresh_s)
            self._wake.clear()
            if self._stopping:
                return
            try:
                self.refresh()
            except Exception as e:
                global_metrics.inc("router_view_refresh_failures")
                log.warning("placement view refresh failed", err=repr(e))

    # ---- the follower read path ----

    def _on_event(self, _ev) -> None:
        """Watch fire (watch-dispatch thread — hand off fast): the
        one-shot registration is consumed; wake the refresh loop,
        which re-reads and re-arms. Never refresh inline here — the
        read is a coordination RPC and would stall every other
        client's events behind it."""
        self._watch_armed = False
        self._wake.set()

    def refresh(self) -> bool:
        """One follower pass: (re-)arm the data watch, read the znode,
        install the payload if it changed. Returns True when the view
        was confirmed current (payload read, changed or not). A frozen
        view (the deterministic partition hook) fails exactly like an
        unreachable coordinator."""
        global_injector.check("router.view_refresh")
        if self._frozen:
            global_metrics.inc("router_view_refresh_failures")
            return False
        coord = self._store()
        if not self._watch_armed:
            # arm BEFORE the read: a flush landing between the read and
            # a later arm would be invisible until the periodic backstop
            coord.exists(PLACEMENT_STATE, watcher=self._on_event)
            self._watch_armed = True
        # a conditional read: an unchanged map comes back as a small
        # reply, not as the whole znode (tens of MB at a million docs)
        try:
            if self._last_digest is None:
                raw = coord.get_data(PLACEMENT_STATE)
            else:
                raw = coord.get_data_if_changed(PLACEMENT_STATE,
                                                self._last_digest)
                if raw is None:
                    raw = self._last_raw
        except NoNodeError:
            raw = None   # pre-first-flush cluster: an EMPTY view is
            #              current, not a failure
        self._last_ok = time.monotonic()
        global_metrics.inc("router_view_refreshes")
        if raw != self._last_raw:
            self._install(raw)
            self._last_raw = raw
            self._last_digest = None if raw is None else data_digest(raw)
        return True

    def _install(self, raw: bytes | None) -> None:
        """REPLACE the in-memory view with one payload (never merge:
        a follower has no local truth to preserve)."""
        state = json.loads(raw.decode()) if raw else {}
        reps = {n: tuple(ws)
                for n, ws in state.get("replicas", {}).items()}
        moved = {w: set(ns) for w, ns in state.get("moved", {}).items()}
        with self.lock:
            self.replicas = reps
            self._confirmed = {n: set(ws) for n, ws in reps.items()}
            self.moved = moved
            self.draining = set(state.get("draining", ()))
            self._owner_cache = None
            self.gen += 1
            self.loaded = True
            self.loaded_epoch = state.get("epoch")
            self.loaded_gen = int(state.get("gen", -1))
            self.version += 1
        global_metrics.set_gauge("router_placement_version",
                                 self.version)
        global_metrics.set_gauge("router_placement_docs", len(reps))
        global_metrics.set_gauge("router_placement_gen",
                                 self.loaded_gen)
        if self.loaded_epoch is not None:
            global_metrics.set_gauge("router_placement_epoch",
                                     self.loaded_epoch)
        log.info("placement view refreshed", docs=len(reps),
                 version=self.version, epoch=self.loaded_epoch,
                 gen=self.loaded_gen)

    # ---- staleness honesty ----

    def freeze(self) -> None:
        """Deterministic partition hook (tests / nemesis suites): pin
        the view — refreshes fail until :meth:`unfreeze`."""
        self._frozen = True

    def unfreeze(self) -> None:
        self._frozen = False
        self._wake.set()   # self-heal on the next loop pass

    def age_s(self) -> float | None:
        """Seconds since the view was last CONFIRMED current (None
        before the first successful refresh)."""
        if self._last_ok is None:
            return None
        return time.monotonic() - self._last_ok

    def suspect(self) -> bool:
        """True when the view can no longer be vouched for: the
        follower is running but has not confirmed the znode within
        ``stale_ms`` (coordinator partition, frozen view, or never
        reachable since start)."""
        if not self._started or self._stale_s <= 0:
            return False
        age = self.age_s()
        return age is None or age > self._stale_s

    def view_snapshot(self) -> dict:
        """Operator view for ``/api/router`` and the CLI routers
        summary: where this view sits vs the leader's map."""
        with self.lock:
            docs = len(self.replicas)
        age = self.age_s()
        return {"loaded": self.loaded, "docs": docs,
                "version": self.version, "epoch": self.loaded_epoch,
                "gen": self.loaded_gen,
                "age_s": round(age, 3) if age is not None else None,
                "stale": bool(self.suspect()),
                "frozen": self._frozen}
