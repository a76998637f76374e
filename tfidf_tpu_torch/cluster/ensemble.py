"""Replicated coordination ensemble — Raft-style, over the HTTP plumbing.

The reference points its clients at a ZooKeeper *ensemble* and gets
leader-based quorum replication for free (``ZookeeperConfig.java:15-21``).
This module closes that gap for the framework's own substrate: an
:class:`EnsembleNode` wraps one :class:`~.coordination.CoordinationCore`
per coordinator process and replicates its command log across peers with
the understandable-consensus recipe of Raft (Ongaro & Ousterhout,
ATC'14), persisted through :class:`~.wal.DurableStore`:

- **Terms + persisted votes** — ``current_term`` / ``voted_for`` are
  fsynced (``meta.json``) before any vote or append response leaves the
  node, so a restart can never double-vote in a term.
- **Leader append / quorum commit** — every client write becomes a WAL
  entry on the leader, is replicated via ``POST /ensemble/append``, and
  is **acknowledged only after a majority has it durably** (then applied
  to the deterministic core). A 3-member ensemble therefore survives
  SIGKILL of any single member — leader included — with zero lost
  acknowledged writes.
- **Follower write-redirect** — client-facing ops on a follower answer
  421 + the leader hint (``coordination._CoordHandler._gate_leader``);
  the client's multi-address failover follows it.
- **Leader-owned session-expiry clock** — only the leader's reaper may
  declare a session dead, and the expiry itself is a *logged command*
  (``expire_session``) so every replica drops the same ephemerals at the
  same log position. A freshly-elected leader grants all sessions a
  liveness grace (``core.touch_all_sessions``) before its clock starts.
- **Snapshots + log compaction** — every ``snapshot_every`` applied
  commands the core state is snapshotted and the WAL truncated; a
  far-behind or fresh peer is caught up via ``POST /ensemble/snapshot``.

A standalone durable coordinator is simply an ensemble of one: quorum
size 1 means append+fsync *is* commit, and restart recovery replays
snapshot + WAL into the core.

Fault points: ``ensemble.vote`` (handling a RequestVote),
``ensemble.replicate_append.<peer>`` (leader about to send
AppendEntries/InstallSnapshot to that peer).
"""

from __future__ import annotations

import json
import random
import threading
import time
import urllib.error
import urllib.request

from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                  CoordinationUnavailable,
                                                  NotLeaderError)
from tfidf_tpu_torch.cluster.nemesis import global_nemesis
from tfidf_tpu_torch.cluster.protover import proto_headers
from tfidf_tpu_torch.cluster.wal import DurableStore
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.ensemble")

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"
_ROLE_GAUGE = {FOLLOWER: 0, CANDIDATE: 1, LEADER: 2}
_MAX_BATCH = 128          # entries per AppendEntries RPC


def _post_json(address: str, path: str, obj: dict,
               timeout_s: float, origin: str = "") -> dict:
    # peer-replication seam for the network nemesis (cluster/nemesis.py):
    # ensemble splits are scripted per (member, member) link
    global_nemesis.check_send(origin, address)
    body = json.dumps(obj).encode()
    h = {"Content-Type": "application/json"}
    h.update(proto_headers())
    h = global_nemesis.filter_headers(origin, address, h)
    req = urllib.request.Request(
        f"http://{address}{path}", data=body, headers=h)
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(global_nemesis.filter_reply(
            origin, address, resp.read()))


class _Waiter:
    __slots__ = ("term", "event", "result", "error")

    def __init__(self, term: int) -> None:
        self.term = term
        self.event = threading.Event()
        self.result: object = None
        self.error: Exception | None = None


class EnsembleNode:
    """One member of the replicated coordination ensemble.

    Owns the durable store (WAL + snapshots + hard state), the in-memory
    log suffix, and the Raft role machinery; mutates ``core`` only by
    applying committed log entries in order.
    """

    def __init__(self, core: CoordinationCore, data_dir: str, node_id: str,
                 peers: dict[str, str], my_address: str,
                 election_timeout_s: float = 1.0,
                 heartbeat_interval_s: float = 0.25,
                 commit_timeout_s: float = 5.0,
                 snapshot_every: int = 512,
                 wal_fsync: bool = True,
                 rpc_timeout_s: float = 2.0) -> None:
        self.core = core
        self.node_id = node_id
        self.peers = dict(peers)            # id -> "host:port" (not self)
        self.my_address = my_address
        self.election_timeout_s = election_timeout_s
        self.heartbeat_interval_s = heartbeat_interval_s
        self.commit_timeout_s = commit_timeout_s
        self.snapshot_every = max(1, snapshot_every)
        self.rpc_timeout_s = rpc_timeout_s

        self._lock = threading.RLock()
        self._alive = threading.Event()
        self._alive.set()
        self._rng = random.Random(f"{node_id}:{my_address}")

        # --- durable recovery: snapshot -> core, WAL -> in-memory log ---
        self.store = DurableStore(data_dir, fsync=wal_fsync)
        meta, snapshot, entries = self.store.load()
        self.term: int = int(meta.get("term", 0))
        self.voted_for: str | None = meta.get("voted_for")
        if snapshot is not None:
            self.base_index = int(snapshot["last_index"])
            self.base_term = int(snapshot["last_term"])
            self._snap_state = snapshot["state"]
            self.core.restore_state(self._snap_state)
        else:
            self.base_index = 0
            self.base_term = 0
            self._snap_state = self.core.state_snapshot()
        self.entries: list[dict] = entries      # {"i","t","c"}, i > base
        # Raft: commit_index is NOT persisted — recovered entries are
        # re-applied only once commitment is re-established (instantly
        # for a solo node; via the new leader's appends otherwise)
        self.commit_index = self.base_index
        self.last_applied = self.base_index
        self._applied_since_snap = 0
        self._snap_in_progress = False

        self.role = FOLLOWER
        # a new leader may not SERVE until its term-start no-op commits
        # (Raft §8): before that, its state machine may lag the log it
        # holds (e.g. a restarted solo node pre-replay) — readiness is
        # commit_index reaching the no-op's index
        self._ready_index = 0
        self.leader_id: str | None = None
        self._last_heartbeat = time.monotonic()
        self._timeout = self._new_timeout()
        self._next_index: dict[str, int] = {}
        self._match_index: dict[str, int] = {}
        self._waiters: dict[int, _Waiter] = {}
        self._rep_events: dict[str, threading.Event] = {
            pid: threading.Event() for pid in self.peers}
        self._threads: list[threading.Thread] = []

        # route all core mutations through quorum replication; only the
        # leader's reaper may run the session-expiry clock
        self.core._submit = self.submit
        self.core.expiry_enabled = self.is_leader
        self._publish_gauges()
        log.info("ensemble member recovered", node=node_id,
                 term=self.term, base=self.base_index,
                 wal_entries=len(self.entries), peers=sorted(self.peers))

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def start(self) -> None:
        if not self.peers:
            # ensemble of one: quorum = 1, leadership is unconditional
            with self._lock:
                self._become_leader_locked()
        t = threading.Thread(target=self._election_loop, daemon=True,
                             name=f"ensemble-elect-{self.node_id}")
        t.start()
        self._threads.append(t)
        for pid in self.peers:
            t = threading.Thread(target=self._replicate_loop, args=(pid,),
                                 daemon=True,
                                 name=f"ensemble-rep-{self.node_id}-{pid}")
            t.start()
            self._threads.append(t)

    def close(self) -> None:
        self._alive.clear()
        for ev in self._rep_events.values():
            ev.set()
        with self._lock:
            self._fail_waiters_locked(
                CoordinationUnavailable("ensemble member shutting down"))
        self.store.close()

    def kill(self) -> None:
        """Crash simulation — identical to :meth:`close` on purpose:
        neither path flushes anything the append path hasn't already
        fsynced, so recovery exercises the real WAL contract."""
        self.close()

    # ------------------------------------------------------------------
    # log helpers (call with self._lock held)
    # ------------------------------------------------------------------

    def last_index(self) -> int:
        return self.base_index + len(self.entries)

    def _term_at(self, index: int) -> int:
        if index == self.base_index:
            return self.base_term
        if index < self.base_index or index > self.last_index():
            raise IndexError(index)
        return self.entries[index - self.base_index - 1]["t"]

    def _last_log_term(self) -> int:
        return self.entries[-1]["t"] if self.entries else self.base_term

    def _majority(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    def is_leader(self) -> bool:
        """Leader AND ready to serve: the term-start no-op has committed,
        so every entry from prior terms is applied to the core."""
        return (self.role == LEADER and self._alive.is_set()
                and self.commit_index >= self._ready_index)

    def leader_address(self) -> str | None:
        with self._lock:
            if self.role == LEADER:
                return self.my_address
            if self.leader_id is not None:
                return self.peers.get(self.leader_id)
            return None

    def status(self) -> dict:
        with self._lock:
            return {"node_id": self.node_id, "role": self.role,
                    "term": self.term, "leader": self.leader_id,
                    "last_index": self.last_index(),
                    "commit_index": self.commit_index,
                    "applied": self.last_applied,
                    "base_index": self.base_index,
                    "peers": sorted(self.peers)}

    def _publish_gauges(self) -> None:
        g = global_metrics.set_gauge
        g(f"ensemble_role_{self.node_id}", _ROLE_GAUGE[self.role])
        g(f"ensemble_term_{self.node_id}", self.term)
        g(f"ensemble_commit_{self.node_id}", self.commit_index)
        if self.role == LEADER and self.peers:
            lag = self.last_index() - min(
                self._match_index.get(p, 0) for p in self.peers)
            g(f"ensemble_replication_lag_{self.node_id}", lag)

    # ------------------------------------------------------------------
    # client writes: leader append -> quorum commit -> apply -> ack
    # ------------------------------------------------------------------

    def submit(self, cmd: dict) -> object:
        with self._lock:
            if not self._alive.is_set():
                raise CoordinationUnavailable("ensemble member stopped")
            if self.role != LEADER:
                raise NotLeaderError(self.leader_address())
            index = self.last_index() + 1
            entry = {"i": index, "t": self.term, "c": cmd}
            # durability FIRST: a failed append must never be acked
            self.store.append([entry])
            self.entries.append(entry)
            waiter = _Waiter(self.term)
            self._waiters[index] = waiter
            if not self.peers:
                self._advance_commit_locked()
        self._kick_replicators()
        if not waiter.event.wait(self.commit_timeout_s):
            with self._lock:
                self._waiters.pop(index, None)
            global_metrics.inc("ensemble_commit_timeouts")
            raise CoordinationUnavailable(
                f"no quorum within {self.commit_timeout_s}s "
                f"(write NOT acknowledged)")
        if waiter.error is not None:
            raise waiter.error
        self._maybe_snapshot()
        return waiter.result

    def _kick_replicators(self) -> None:
        for ev in self._rep_events.values():
            ev.set()

    def _advance_commit_locked(self) -> None:
        """Leader: commit = highest n with a durable majority AND
        n's entry from the current term (Raft §5.4.2)."""
        for n in range(self.last_index(), self.commit_index, -1):
            if self._term_at(n) != self.term:
                break
            votes = 1 + sum(1 for p in self.peers
                            if self._match_index.get(p, 0) >= n)
            if votes >= self._majority():
                self.commit_index = n
                break
        self._apply_committed_locked()

    def _apply_committed_locked(self) -> None:
        while self.last_applied < self.commit_index:
            e = self.entries[self.last_applied - self.base_index]
            self.last_applied += 1
            try:
                result, error = self.core.apply(e["c"]), None
            except Exception as ex:   # deterministic app error (result)
                result, error = None, ex
            w = self._waiters.pop(e["i"], None)
            if w is not None:
                if w.term != e["t"]:
                    w.error = NotLeaderError(self.leader_address())
                else:
                    w.result, w.error = result, error
                w.event.set()
            self._applied_since_snap += 1
        self._publish_gauges()

    def _maybe_snapshot(self) -> None:
        """Snapshot + compact when due. Called from OUTSIDE the
        ensemble lock: the expensive half (full-state JSON + fsync)
        runs unlocked so heartbeats, votes, and appends are never
        stalled behind a large snapshot write (which would trigger
        spurious elections)."""
        with self._lock:
            if (self._applied_since_snap < self.snapshot_every
                    or self._snap_in_progress
                    or not self._alive.is_set()):
                return
            self._snap_in_progress = True
            snap_index = self.last_applied
            snap_term = self._term_at(snap_index)
            state = self.core.state_snapshot()
        try:
            self.store.write_snapshot(state, snap_index, snap_term)
            with self._lock:
                remaining = [e for e in self.entries
                             if e["i"] > snap_index]
                self.store.rewrite(remaining)
                self._snap_state = state
                self.base_index = snap_index
                self.base_term = snap_term
                self.entries = remaining
                self._applied_since_snap = self.last_applied - snap_index
            log.info("snapshot saved", node=self.node_id,
                     last_index=snap_index, wal_entries=len(remaining))
        except Exception as e:
            log.warning("snapshot failed", node=self.node_id,
                        err=repr(e))
        finally:
            self._snap_in_progress = False

    def _fail_waiters_locked(self, exc: Exception) -> None:
        for w in self._waiters.values():
            w.error = exc
            w.event.set()
        self._waiters.clear()

    # ------------------------------------------------------------------
    # terms / roles
    # ------------------------------------------------------------------

    def _persist_meta_locked(self) -> None:
        self.store.set_meta(self.term, self.voted_for)

    def _observe_term_locked(self, term: int) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_meta_locked()
            if self.role != FOLLOWER:
                log.info("stepping down", node=self.node_id, term=term)
            self._step_down_locked()

    def _step_down_locked(self) -> None:
        self.role = FOLLOWER
        # AMBIGUOUS, not NotLeaderError: the waiter's entry is already
        # durably in our log and may still commit under the new leader —
        # a retry-safe 421 would let the client re-send the mutation and
        # commit it twice (e.g. two EPHEMERAL_SEQUENTIAL znodes)
        self._fail_waiters_locked(CoordinationUnavailable(
            "leadership lost mid-commit; write outcome unknown"))
        self._publish_gauges()

    def _become_leader_locked(self) -> None:
        self.role = LEADER
        self.leader_id = self.node_id
        # not ready to serve until the no-op below commits
        self._ready_index = self.last_index() + 1
        for pid in self.peers:
            self._next_index[pid] = self.last_index() + 1
            self._match_index[pid] = 0
        # commit a no-op from the new term so prior-term entries commit
        # (Raft §8) and the tenure is findable in the log
        entry = {"i": self.last_index() + 1, "t": self.term,
                 "c": {"op": "noop"}}
        self.store.append([entry])
        self.entries.append(entry)
        if not self.peers:
            self._advance_commit_locked()
        # sessions get a fresh grace before the new expiry clock starts
        self.core.touch_all_sessions()
        global_metrics.inc("ensemble_elections_won")
        self._publish_gauges()
        log.info("became ensemble leader", node=self.node_id,
                 term=self.term, last_index=self.last_index())
        self._kick_replicators()

    # ------------------------------------------------------------------
    # election
    # ------------------------------------------------------------------

    def _new_timeout(self) -> float:
        return self.election_timeout_s * (1.0 + self._rng.random())

    def _election_loop(self) -> None:
        while self._alive.is_set():
            time.sleep(self.election_timeout_s / 8)
            self._maybe_snapshot()     # catch-all (e.g. boot recovery)
            with self._lock:
                if (self.role == LEADER
                        or time.monotonic() - self._last_heartbeat
                        < self._timeout):
                    continue
                if not self.peers:
                    self._become_leader_locked()
                    continue
                # start an election
                self.term += 1
                self.voted_for = self.node_id
                self._persist_meta_locked()
                self.role = CANDIDATE
                self.leader_id = None
                self._last_heartbeat = time.monotonic()
                self._timeout = self._new_timeout()
                term = self.term
                req = {"term": term, "candidate": self.node_id,
                       "last_log_index": self.last_index(),
                       "last_log_term": self._last_log_term()}
                peers = dict(self.peers)
                self._publish_gauges()
            global_metrics.inc("ensemble_elections_started")
            log.info("election started", node=self.node_id, term=term)
            votes = {"n": 1}
            for pid, addr in peers.items():
                threading.Thread(
                    target=self._request_vote, daemon=True,
                    args=(pid, addr, req, votes),
                    name=f"ensemble-vote-{self.node_id}-{pid}").start()

    def _request_vote(self, pid: str, addr: str, req: dict,
                      votes: dict) -> None:
        try:
            resp = _post_json(addr, "/ensemble/vote", req,
                              self.rpc_timeout_s,
                              origin=self.my_address)
        except Exception:
            return
        with self._lock:
            if resp.get("term", 0) > self.term:
                self._observe_term_locked(resp["term"])
                return
            if (self.role != CANDIDATE or self.term != req["term"]
                    or not resp.get("granted")):
                return
            votes["n"] += 1
            if votes["n"] >= self._majority():
                self._become_leader_locked()

    def handle_vote(self, req: dict) -> dict:
        global_injector.check("ensemble.vote")
        with self._lock:
            if req["term"] < self.term:
                return {"term": self.term, "granted": False}
            self._observe_term_locked(req["term"])
            up_to_date = ((req["last_log_term"], req["last_log_index"])
                          >= (self._last_log_term(), self.last_index()))
            if (self.voted_for in (None, req["candidate"])
                    and up_to_date):
                if self.voted_for != req["candidate"]:
                    self.voted_for = req["candidate"]
                    self._persist_meta_locked()
                self._last_heartbeat = time.monotonic()
                return {"term": self.term, "granted": True}
            return {"term": self.term, "granted": False}

    # ------------------------------------------------------------------
    # replication (leader side)
    # ------------------------------------------------------------------

    def _replicate_loop(self, pid: str) -> None:
        ev = self._rep_events[pid]
        while self._alive.is_set():
            ev.wait(self.heartbeat_interval_s)
            ev.clear()
            if not self._alive.is_set() or self.role != LEADER:
                continue
            try:
                self._sync_peer(pid)
            except Exception as e:
                global_metrics.inc("ensemble_replicate_failures")
                log.debug("replication to peer failed", peer=pid,
                          err=repr(e))
            self._maybe_snapshot()

    def _sync_peer(self, pid: str) -> None:
        """One catch-up pass: send appends (or a snapshot) until the
        peer matches our last index or we stop being leader."""
        addr = self.peers[pid]
        for _ in range(64):       # bounded catch-up per pass
            with self._lock:
                if self.role != LEADER or not self._alive.is_set():
                    return
                ni = self._next_index.get(pid, self.last_index() + 1)
                if ni <= self.base_index:
                    req = {"kind": "snapshot", "term": self.term,
                           "leader_id": self.node_id,
                           "last_index": self.base_index,
                           "last_term": self.base_term,
                           "state": self._snap_state}
                else:
                    prev = ni - 1
                    lo = prev - self.base_index
                    ents = self.entries[lo:lo + _MAX_BATCH]
                    req = {"kind": "append", "term": self.term,
                           "leader_id": self.node_id,
                           "prev_index": prev,
                           "prev_term": self._term_at(prev),
                           "entries": ents,
                           "commit": self.commit_index}
                term_sent = self.term
            global_injector.check(f"ensemble.replicate_append.{pid}")
            if req["kind"] == "snapshot":
                resp = _post_json(addr, "/ensemble/snapshot", req,
                                  self.rpc_timeout_s,
                                  origin=self.my_address)
                with self._lock:
                    if resp.get("term", 0) > self.term:
                        self._observe_term_locked(resp["term"])
                        return
                    self._next_index[pid] = req["last_index"] + 1
                    self._match_index[pid] = max(
                        self._match_index.get(pid, 0), req["last_index"])
                continue
            resp = _post_json(addr, "/ensemble/append", req,
                              self.rpc_timeout_s,
                              origin=self.my_address)
            with self._lock:
                if resp.get("term", 0) > self.term:
                    self._observe_term_locked(resp["term"])
                    return
                if self.role != LEADER or self.term != term_sent:
                    return
                if resp.get("success"):
                    match = req["prev_index"] + len(req["entries"])
                    self._match_index[pid] = max(
                        self._match_index.get(pid, 0), match)
                    self._next_index[pid] = self._match_index[pid] + 1
                    self._advance_commit_locked()
                    if self._match_index[pid] >= self.last_index():
                        return
                else:
                    hint = resp.get("hint")
                    nxt = self._next_index.get(pid, 1) - 1
                    if hint is not None:
                        nxt = min(nxt, int(hint) + 1)
                    self._next_index[pid] = max(1, nxt)

    # ------------------------------------------------------------------
    # replication (follower side)
    # ------------------------------------------------------------------

    def handle_append(self, req: dict) -> dict:
        resp = self._handle_append_locked(req)
        if resp.get("success"):
            self._maybe_snapshot()     # compaction outside the lock
        return resp

    def _handle_append_locked(self, req: dict) -> dict:
        with self._lock:
            if req["term"] < self.term:
                return {"term": self.term, "success": False}
            self._observe_term_locked(req["term"])
            if self.role != FOLLOWER:
                self._step_down_locked()
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            prev_i, prev_t = req["prev_index"], req["prev_term"]
            if prev_i > self.last_index():
                return {"term": self.term, "success": False,
                        "hint": self.last_index()}
            if prev_i >= self.base_index and \
                    self._term_at(prev_i) != prev_t:
                # conflicting suffix: drop it (durably) and ask for more
                keep = [e for e in self.entries if e["i"] < prev_i]
                self.store.rewrite(keep)
                self.entries = keep
                return {"term": self.term, "success": False,
                        "hint": max(self.base_index, prev_i - 1)}
            new: list[dict] = []
            for e in req["entries"]:
                if e["i"] <= self.base_index:
                    continue
                if e["i"] <= self.last_index():
                    if self._term_at(e["i"]) == e["t"]:
                        continue
                    keep = [x for x in self.entries if x["i"] < e["i"]]
                    self.store.rewrite(keep)
                    self.entries = keep
                new.append(e)
            if new:
                self.store.append(new)
                self.entries.extend(new)
            self.commit_index = max(
                self.commit_index,
                min(int(req.get("commit", 0)), self.last_index()))
            self._apply_committed_locked()
            return {"term": self.term, "success": True}

    def handle_install_snapshot(self, req: dict) -> dict:
        with self._lock:
            if req["term"] < self.term:
                return {"term": self.term}
            self._observe_term_locked(req["term"])
            self.leader_id = req["leader_id"]
            self._last_heartbeat = time.monotonic()
            li, lt = int(req["last_index"]), int(req["last_term"])
            if li <= self.base_index:
                return {"term": self.term}
            self.store.save_snapshot(req["state"], li, lt, [])
            self._snap_state = req["state"]
            self.core.restore_state(req["state"])
            self.base_index = li
            self.base_term = lt
            self.entries = []
            self.commit_index = li
            self.last_applied = li
            self._applied_since_snap = 0
            self._publish_gauges()
            log.info("snapshot installed", node=self.node_id,
                     last_index=li, term=self.term)
            return {"term": self.term}
