"""Coordination substrate — ZooKeeper's semantics, framework-native.

The reference outsources coordination to an external ZooKeeper ensemble
(``config/ZookeeperConfig.java:11-24``) and uses exactly four of its
primitives (SURVEY.md §2, §5.8):

1. persistent znodes as namespaces (``/election``, ``/service_registry`` —
   ``LeaderElection.java:30-47``, ``ServiceRegistry.java:35-51``);
2. EPHEMERAL and EPHEMERAL_SEQUENTIAL znodes with data payloads, whose
   lifetime is the client session (``LeaderElection.java:49-55``,
   ``ServiceRegistry.java:54-64``, ``OnElectionAction.java:45-54``);
3. one-shot watches on node deletion and on a node's children
   (``LeaderElection.java:100-113``, ``ServiceRegistry.java:91-122``);
4. session timeout as the cluster failure detector (3000 ms,
   ``ZookeeperConfig.java:17``).

This module implements those four primitives directly so the framework has
no external coordination dependency:

- :class:`CoordinationCore` — the znode tree + sessions + watches, pure
  in-process data structure (also the fake for tests, SURVEY.md §4).
- :class:`CoordinationServer` — serves a core over HTTP/JSON so many node
  processes share one substrate (the "zookeeper:2181" role). Events reach
  clients via long-polling.
- :class:`CoordinationClient` / :class:`LocalCoordination` — the client
  bean (``ZookeeperConfig.zooKeeper()`` analog): same API over HTTP or
  in-process, with automatic heartbeats and watch dispatch.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, NamedTuple
from urllib.parse import parse_qs, urlparse

from tfidf_tpu_torch.cluster.nemesis import global_nemesis
from tfidf_tpu_torch.cluster.protover import (PROTO_HEADER, PROTO_VERSION,
                                              proto_headers)
from tfidf_tpu_torch.cluster.resilience import RetryPolicy
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.coordination")

# Event types (names follow ZooKeeper's EventType for recognizability).
NODE_CREATED = "NodeCreated"
NODE_DELETED = "NodeDeleted"
NODE_DATA_CHANGED = "NodeDataChanged"
CHILDREN_CHANGED = "NodeChildrenChanged"
SESSION_EXPIRED = "SessionExpired"

PERSISTENT = "persistent"
EPHEMERAL = "ephemeral"
EPHEMERAL_SEQUENTIAL = "ephemeral_sequential"


def data_digest(data: bytes) -> str:
    """The digest a reader quotes to ``get_data_if_changed``."""
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class Event(NamedTuple):
    type: str
    path: str


class NodeExistsError(Exception):
    pass


class NoNodeError(Exception):
    pass


class NotLeaderError(Exception):
    """Raised on a write/read addressed to an ensemble follower; carries
    the current leader's address (or None) as a failover hint."""

    def __init__(self, leader: str | None = None) -> None:
        super().__init__(f"not the ensemble leader (leader={leader})")
        self.leader = leader


class CoordinationUnavailable(Exception):
    """No quorum / commit timed out — the write was NOT acknowledged."""


class _Znode:
    __slots__ = ("data", "ephemeral_owner", "seq", "children")

    def __init__(self, data: bytes = b"",
                 ephemeral_owner: int | None = None) -> None:
        self.data = data
        self.ephemeral_owner = ephemeral_owner
        self.seq = 0                      # next sequential-child counter
        self.children: dict[str, _Znode] = {}


class _Session:
    __slots__ = ("id", "last_seen", "queue", "cond", "ephemerals", "expired")

    def __init__(self, sid: int) -> None:
        self.id = sid
        self.last_seen = time.monotonic()
        # unbounded on purpose: an evicted event would be a one-shot
        # watch fire lost forever (the registration was consumed).
        # Ensemble followers don't accumulate here — they redirect all
        # client reads, so their watch tables stay empty.
        self.queue: deque[Event] = deque()
        self.cond = threading.Condition()
        self.ephemerals: set[str] = set()
        self.expired = False


def _split(path: str) -> list[str]:
    parts = [p for p in path.split("/") if p]
    if not path.startswith("/") or not parts:
        raise ValueError(f"bad path {path!r}")
    return parts


class CoordinationCore:
    """The znode tree as a **deterministic apply-log state machine**.

    Every mutation is a command dict (JSON-serializable) routed through
    :meth:`_submit`; the default submit applies locally, and the ensemble
    layer (``cluster/ensemble.py``) overrides it to append the command to
    a replicated WAL and apply it only after quorum commit. :meth:`apply`
    is deterministic — identical command sequences produce identical
    :meth:`state_snapshot` results on every replica (the Raft state-
    machine contract). Reads, heartbeats, watches, and event queues stay
    node-local (they are not state).

    Watches are one-shot, exactly like ZooKeeper's: registering happens as a
    side effect of a read (``exists``/``get_children``), firing consumes the
    registration (the reference re-arms by re-reading —
    ``ServiceRegistry.java:104``, ``LeaderElection.java:75``).
    """

    def __init__(self, session_timeout_s: float = 3.0) -> None:
        self.session_timeout_s = session_timeout_s
        self._root = _Znode()
        self._lock = threading.RLock()
        self._sessions: dict[int, _Session] = {}
        self._next_sid = 1
        # (path, kind) -> set of session ids; kind: "exists" | "children"
        self._watches: dict[tuple[str, str], set[int]] = {}
        # path -> (data object, its digest), for conditional reads
        self._digests: dict[str, tuple[bytes, str]] = {}
        self._closed = False
        # mutation route: standalone applies directly; the ensemble
        # replaces this with quorum-replicated append-then-apply
        self._submit: Callable[[dict], object] = self.apply
        # session-expiry clock gate: only the ensemble LEADER may expire
        # (followers apply the leader's expire_session log entries)
        self.expiry_enabled: Callable[[], bool] = lambda: True
        self._reaper = threading.Thread(target=self._reap_loop, daemon=True,
                                        name="coord-reaper")
        self._reaper.start()

    # ---- the deterministic state machine ----

    def apply(self, cmd: dict) -> object:
        """Apply one committed command. Deterministic: same state + same
        command -> same new state and same result/exception on every
        replica. Watch/event side effects are local-only."""
        op = cmd["op"]
        with self._lock:
            if op == "create":
                return self._apply_create(
                    cmd["sid"], cmd["path"],
                    bytes.fromhex(cmd.get("data", "")),
                    cmd.get("mode", PERSISTENT))
            if op == "delete":
                self._delete_locked(cmd["path"])
                return None
            if op == "set_data":
                self._resolve(_split(cmd["path"])).data = \
                    bytes.fromhex(cmd.get("data", ""))
                # ZooKeeper semantics: a data watch set via exists()
                # fires NodeDataChanged on setData — the placement
                # follower view (cluster/placement.py) rides this.
                # Local-only side effect, like the create/delete fires
                # above: events are not replicated state.
                self._fire(cmd["path"], "exists", NODE_DATA_CHANGED)
                return None
            if op == "new_session":
                sid = self._next_sid
                self._next_sid += 1
                self._sessions[sid] = _Session(sid)
                return sid
            if op in ("close_session", "expire_session"):
                self._expire_locked(cmd["sid"],
                                    reason=cmd.get("reason", op))
                return None
            if op == "noop":        # leader-tenure marker (Raft §8)
                return None
            raise ValueError(f"unknown command {op!r}")

    def state_snapshot(self) -> dict:
        """Serialize the replicated state (tree + sessions + counters) —
        the WAL snapshot payload and the differential-test fingerprint.
        Local-only state (watches, queues, last_seen) is excluded."""
        def ser(node: _Znode) -> dict:
            return {"d": node.data.hex(), "o": node.ephemeral_owner,
                    "s": node.seq,
                    "c": {k: ser(v) for k, v in sorted(node.children.items())}}
        with self._lock:
            return {"next_sid": self._next_sid,
                    "tree": ser(self._root),
                    "sessions": {str(sid): sorted(s.ephemerals)
                                 for sid, s in self._sessions.items()}}

    def restore_state(self, state: dict) -> None:
        """Replace all replicated state (boot recovery / snapshot
        install). Restored sessions get a fresh liveness grace so
        reconnecting clients keep their ephemerals."""
        def de(obj: dict) -> _Znode:
            n = _Znode(bytes.fromhex(obj["d"]), obj["o"])
            n.seq = obj["s"]
            n.children = {k: de(v) for k, v in obj["c"].items()}
            return n
        with self._lock:
            self._root = de(state["tree"])
            self._next_sid = state["next_sid"]
            self._sessions = {}
            for sid_s, eph in state["sessions"].items():
                s = _Session(int(sid_s))
                s.ephemerals = set(eph)
                self._sessions[int(sid_s)] = s
            self._watches.clear()

    def touch_all_sessions(self) -> None:
        """Reset every session's liveness clock — called when an
        ensemble member becomes leader (or a restarted coordinator
        boots) so sessions get a full timeout to re-reach the new
        expiry clock before being declared dead."""
        with self._lock:
            now = time.monotonic()
            for s in self._sessions.values():
                s.last_seen = now

    # ---- sessions ----

    def new_session(self) -> int:
        return self._submit({"op": "new_session"})

    def heartbeat(self, sid: int) -> bool:
        """Refresh liveness; False if the session is gone (client must
        treat this like an expired ZooKeeper session). Not logged —
        liveness lives on the expiry-clock owner, not in the state."""
        global_injector.check(f"coord.heartbeat.{sid}")
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return False
            s.last_seen = time.monotonic()
            return True

    def close_session(self, sid: int) -> None:
        self._submit({"op": "close_session", "sid": sid,
                      "reason": "closed"})

    def expire_session(self, sid: int) -> None:
        """Force-expire (fault injection: simulates a node partition)."""
        self._submit({"op": "expire_session", "sid": sid,
                      "reason": "forced"})

    def _expire_locked(self, sid: int, reason: str) -> None:
        s = self._sessions.pop(sid, None)
        if s is None:
            return
        s.expired = True
        for path in sorted(s.ephemerals, reverse=True):
            try:
                self._delete_locked(path)
            except NoNodeError:
                pass
        for key in list(self._watches):
            self._watches[key].discard(sid)
            if not self._watches[key]:
                del self._watches[key]
        with s.cond:
            s.queue.append(Event(SESSION_EXPIRED, ""))
            s.cond.notify_all()
        log.info("session expired", sid=sid, reason=reason)

    def _reap_loop(self) -> None:
        while not self._closed:
            time.sleep(min(0.1, self.session_timeout_s / 4))
            if not self.expiry_enabled():
                continue     # ensemble follower: leader owns the clock
            now = time.monotonic()
            with self._lock:
                dead = [sid for sid, s in self._sessions.items()
                        if now - s.last_seen > self.session_timeout_s]
            for sid in dead:
                # expiry is a logged command: in ensemble mode it reaches
                # every replica through the WAL (quorum first), exactly
                # like ZooKeeper's leader-driven session expiry
                try:
                    self._submit({"op": "expire_session", "sid": sid,
                                  "reason": "timeout"})
                except Exception as e:
                    log.warning("session expiry submit failed", sid=sid,
                                err=repr(e))

    def close(self) -> None:
        self._closed = True
        with self._lock:
            for sid in list(self._sessions):
                self._expire_locked(sid, reason="shutdown")

    # ---- tree ops ----

    def _resolve(self, parts: list[str]) -> _Znode:
        node = self._root
        for p in parts:
            node = node.children.get(p)
            if node is None:
                raise NoNodeError("/" + "/".join(parts))
        return node

    def create(self, sid: int, path: str, data: bytes = b"",
               mode: str = PERSISTENT) -> str:
        return self._submit({"op": "create", "sid": sid, "path": path,
                             "data": data.hex(), "mode": mode})

    def _apply_create(self, sid: int, path: str, data: bytes,
                      mode: str) -> str:
        parts = _split(path)
        parent = self._resolve(parts[:-1])
        name = parts[-1]
        if mode == EPHEMERAL_SEQUENTIAL:
            name = f"{name}{parent.seq:010d}"
            parent.seq += 1
        if name in parent.children:
            raise NodeExistsError(path)
        owner = sid if mode in (EPHEMERAL, EPHEMERAL_SEQUENTIAL) else None
        parent.children[name] = _Znode(data, owner)
        full = "/" + "/".join(parts[:-1] + [name])
        if owner is not None:
            s = self._sessions.get(sid)
            if s is None:
                del parent.children[name]
                raise NoNodeError(f"session {sid} gone")
            s.ephemerals.add(full)
        parent_path = "/" + "/".join(parts[:-1]) if parts[:-1] else "/"
        self._fire(full, "exists", NODE_CREATED)
        self._fire(parent_path, "children", CHILDREN_CHANGED)
        return full

    def delete(self, sid: int, path: str) -> None:
        self._submit({"op": "delete", "path": path})

    def _delete_locked(self, path: str) -> None:
        parts = _split(path)
        parent = self._resolve(parts[:-1])
        node = parent.children.pop(parts[-1], None)
        if node is None:
            raise NoNodeError(path)
        if node.ephemeral_owner is not None:
            s = self._sessions.get(node.ephemeral_owner)
            if s is not None:
                s.ephemerals.discard(path)
        parent_path = "/" + "/".join(parts[:-1]) if parts[:-1] else "/"
        self._fire(path, "exists", NODE_DELETED)
        self._fire(parent_path, "children", CHILDREN_CHANGED)

    def exists(self, sid: int, path: str, watch: bool = False) -> bool:
        with self._lock:
            try:
                self._resolve(_split(path))
                found = True
            except NoNodeError:
                found = False
            if watch:
                self._watches.setdefault((path, "exists"), set()).add(sid)
            return found

    def get_data(self, sid: int, path: str) -> bytes:
        with self._lock:
            return self._resolve(_split(path)).data

    def get_data_if_changed(self, sid: int, path: str,
                            digest: str) -> bytes | None:
        """``get_data``, or None when the data still has ``digest``. The
        digest is computed once per stored value (a set_data stores a new
        bytes object), outside the lock."""
        data = self.get_data(sid, path)
        got = self._digests.get(path)
        if got is None or got[0] is not data:
            got = (data, data_digest(data))
            self._digests[path] = got
        return None if got[1] == digest else data

    def set_data(self, sid: int, path: str, data: bytes) -> None:
        self._submit({"op": "set_data", "path": path, "data": data.hex()})

    def get_children(self, sid: int, path: str,
                     watch: bool = False) -> list[str]:
        with self._lock:
            if path == "/":
                node = self._root
            else:
                node = self._resolve(_split(path))
            if watch:
                self._watches.setdefault((path, "children"), set()).add(sid)
            return sorted(node.children)

    # ---- watches ----

    def _fire(self, path: str, kind: str, ev_type: str) -> None:
        sids = self._watches.pop((path, kind), None)
        if not sids:
            return
        ev = Event(ev_type, path)
        for sid in sids:
            s = self._sessions.get(sid)
            if s is None:
                continue
            with s.cond:
                s.queue.append(ev)
                s.cond.notify_all()

    def poll_events(self, sid: int, timeout_s: float) -> list[Event]:
        with self._lock:
            s = self._sessions.get(sid)
        if s is None:
            return [Event(SESSION_EXPIRED, "")]
        with s.cond:
            if not s.queue:
                s.cond.wait(timeout_s)
            evs = list(s.queue)
            s.queue.clear()
            return evs


# --------------------------------------------------------------------------
# Client API (shared by in-process and HTTP transports)
# --------------------------------------------------------------------------

Watcher = Callable[[Event], None]


class _BaseCoordination:
    """Watch registration + dispatch common to both transports.

    A single dispatch thread delivers events to Python callbacks, mirroring
    ZooKeeper's single event thread (so callbacks never race each other —
    the property ``ServiceRegistry.updateAddresses``'s ``synchronized``
    defends against is preserved by construction).
    """

    def __init__(self) -> None:
        self._wlock = threading.Lock()
        # (path, kind) -> list of watchers; one-shot, popped on fire
        self._watchers: dict[tuple[str, str], list[Watcher]] = {}
        self._session_watchers: list[Watcher] = []
        self._closed = threading.Event()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="coord-dispatch")

    def start(self) -> None:
        self._dispatcher.start()

    # transport hooks -----------------------------------------------------
    def _poll(self, timeout_s: float) -> list[Event]:
        raise NotImplementedError

    # watch plumbing ------------------------------------------------------
    def _arm(self, path: str, kind: str, watcher: Watcher | None) -> None:
        if watcher is None:
            return
        with self._wlock:
            self._watchers.setdefault((path, kind), []).append(watcher)

    def on_session_event(self, watcher: Watcher) -> None:
        """Persistent (not one-shot) session-state callback — the role of
        the reference's ``Application.process`` watcher
        (``app/Application.java:49-66``)."""
        with self._wlock:
            self._session_watchers.append(watcher)

    # long-poll failure backoff: exponential with jitter, reset by any
    # successful poll — a down coordination server is retried at a
    # decaying rate instead of a fixed 10 Hz hammer
    _POLL_BACKOFF = RetryPolicy(base_delay_s=0.1, max_delay_s=2.0,
                                name="coord_poll")

    def _dispatch_loop(self) -> None:
        poll_failures = 0
        while not self._closed.is_set():
            try:
                events = self._poll(timeout_s=1.0)
                poll_failures = 0
            except Exception:
                if self._closed.is_set():
                    return
                poll_failures += 1
                global_metrics.inc("coord_poll_failures")
                time.sleep(self._POLL_BACKOFF.backoff_delay(
                    min(poll_failures, 5)))
                continue
            for ev in events:
                if ev.type == SESSION_EXPIRED:
                    # the session is gone: deliver the expiry exactly once,
                    # then terminate — further polling would spin forever on
                    # the instant "no such session" response
                    self._closed.set()
                    with self._wlock:
                        targets = list(self._session_watchers)
                    for w in targets:
                        self._safe_call(w, ev)
                    return
                kind = ("children" if ev.type == CHILDREN_CHANGED
                        else "exists")
                with self._wlock:
                    targets = self._watchers.pop((ev.path, kind), [])
                for w in targets:
                    self._safe_call(w, ev)

    @staticmethod
    def _safe_call(w: Watcher, ev: Event) -> None:
        try:
            w(ev)
        except Exception as e:  # a watcher must never kill the dispatcher
            log.warning("watcher raised", event=ev.type, path=ev.path,
                        err=repr(e))

    # public API ----------------------------------------------------------
    def create(self, path: str, data: bytes = b"",
               mode: str = PERSISTENT) -> str:
        raise NotImplementedError

    def ensure(self, path: str, data: bytes = b"") -> None:
        """Create-if-absent for persistent namespace nodes
        (``LeaderElection.initializeElectionNode``,
        ``ServiceRegistry.createServiceRegistryZnode``)."""
        try:
            self.create(path, data, PERSISTENT)
        except NodeExistsError:
            pass

    def close(self) -> None:
        self._closed.set()


class LocalCoordination(_BaseCoordination):
    """A session on an in-process :class:`CoordinationCore`.

    Used by tests (the embedded fake the reference never had, SURVEY.md §4)
    and by single-process multi-node runs where all nodes share one core.
    """

    def __init__(self, core: CoordinationCore,
                 heartbeat_interval_s: float | None = None) -> None:
        super().__init__()
        self.core = core
        self.sid = core.new_session()
        interval = (heartbeat_interval_s if heartbeat_interval_s is not None
                    else core.session_timeout_s / 4)
        self._hb = threading.Thread(target=self._hb_loop, args=(interval,),
                                    daemon=True, name="coord-heartbeat")
        self._hb.start()
        self.start()

    def _hb_loop(self, interval: float) -> None:
        # heartbeats ARE the liveness signal: a transiently failing send
        # is retried quickly (bounded, well inside the session timeout)
        # instead of waiting a whole interval and eating into the
        # failure detector's budget
        policy = RetryPolicy(max_attempts=3,
                             base_delay_s=min(0.05, interval / 4),
                             max_delay_s=interval / 2,
                             classify=lambda e: True,
                             name="coord_heartbeat")
        while not self._closed.is_set():
            time.sleep(interval)

            def send() -> bool:
                global_injector.check("coord.heartbeat_send")
                return self.core.heartbeat(self.sid)

            try:
                if not policy.call(send):
                    return   # session is gone; expiry event follows
            except Exception:
                pass   # retries exhausted: try again next interval

    def _poll(self, timeout_s: float) -> list[Event]:
        global_injector.check("coord.long_poll")
        return self.core.poll_events(self.sid, timeout_s)

    def create(self, path, data=b"", mode=PERSISTENT):
        return self.core.create(self.sid, path, data, mode)

    def delete(self, path):
        self.core.delete(self.sid, path)

    def exists(self, path, watcher: Watcher | None = None) -> bool:
        self._arm(path, "exists", watcher)
        return self.core.exists(self.sid, path, watch=watcher is not None)

    def get_data(self, path) -> bytes:
        return self.core.get_data(self.sid, path)

    def get_data_if_changed(self, path, digest: str) -> bytes | None:
        return self.core.get_data_if_changed(self.sid, path, digest)

    def set_data(self, path, data: bytes) -> None:
        self.core.set_data(self.sid, path, data)

    def get_children(self, path, watcher: Watcher | None = None) -> list[str]:
        self._arm(path, "children", watcher)
        return self.core.get_children(self.sid, path,
                                      watch=watcher is not None)

    def close(self) -> None:
        super().close()
        try:
            self.core.close_session(self.sid)
        except Exception:
            pass


# --------------------------------------------------------------------------
# HTTP transport
# --------------------------------------------------------------------------

class _CoordHandler(BaseHTTPRequestHandler):
    core: CoordinationCore  # set by server factory
    ensemble = None         # EnsembleNode when durable/replicated
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # route to structured logger
        pass

    def _reply(self, obj: dict, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        # coordination plane speaks the same versioned wire as the data
        # plane so the protocol witness can assert the stamp on every
        # exchange (cluster/protover.py; the plane itself negotiates
        # nothing — /rpc is an internal seam with one client, this repo)
        self.send_header(PROTO_HEADER, str(PROTO_VERSION))
        self.end_headers()
        self.wfile.write(body)

    def _gate_leader(self) -> bool:
        """Client-facing ops are served by the ensemble leader only
        (linearizable reads + the leader-owned session/watch state);
        followers answer 421 with the leader hint so the client's
        multi-address failover can redirect."""
        ens = self.ensemble
        if ens is None or ens.is_leader():
            return True
        self._reply({"error": "not_leader", "leader": ens.leader_address()},
                    421)
        return False

    def do_GET(self) -> None:
        u = urlparse(self.path)
        if u.path == "/events":
            if not self._gate_leader():
                return
            q = parse_qs(u.query)
            sid = int(q["session"][0])
            timeout = float(q.get("timeout", ["25"])[0])
            evs = self.core.poll_events(sid, timeout)
            self._reply({"events": [[e.type, e.path] for e in evs]})
        elif u.path == "/ensemble/status":
            if self.ensemble is None:
                self._reply({"error": "no ensemble"}, 404)
            else:
                self._reply(self.ensemble.status())
        else:
            self._reply({"error": "not found"}, 404)

    def do_POST(self) -> None:
        n = int(self.headers.get("Content-Length", "0"))
        req = json.loads(self.rfile.read(n) or b"{}")
        u = urlparse(self.path)
        if u.path.startswith("/ensemble/"):
            self._ensemble_rpc(u.path, req)
            return
        if u.path != "/rpc":
            # the wire contract: client ops ride POST /rpc only. The
            # dispatch used to fall through to the op switch on ANY
            # path (graftcheck protocol endpoint-drift finding: /rpc
            # was called-but-never-served) — an unknown path must be
            # a loud 404, not a silently-served alias. The body is
            # already read above, so the keep-alive stream stays in
            # sync across the rejection.
            self._reply({"error": "not found"}, 404)
            return
        op = req.get("op")
        sid = req.get("session", 0)
        if not self._gate_leader():
            return
        try:
            if op == "new_session":
                self._reply({"session": self.core.new_session(),
                             "timeout_s": self.core.session_timeout_s})
            elif op == "heartbeat":
                self._reply({"ok": self.core.heartbeat(sid)})
            elif op == "close_session":
                self.core.close_session(sid)
                self._reply({"ok": True})
            elif op == "create":
                full = self.core.create(sid, req["path"],
                                        bytes.fromhex(req.get("data", "")),
                                        req.get("mode", PERSISTENT))
                self._reply({"path": full})
            elif op == "delete":
                self.core.delete(sid, req["path"])
                self._reply({"ok": True})
            elif op == "exists":
                self._reply({"exists": self.core.exists(
                    sid, req["path"], watch=req.get("watch", False))})
            elif op == "get_data" and "unless" in req:
                data = self.core.get_data_if_changed(sid, req["path"],
                                                     req["unless"])
                self._reply({"unchanged": True} if data is None
                            else {"data": data.hex()})
            elif op == "get_data":
                self._reply(
                    {"data": self.core.get_data(sid, req["path"]).hex()})
            elif op == "set_data":
                self.core.set_data(sid, req["path"],
                                   bytes.fromhex(req.get("data", "")))
                self._reply({"ok": True})
            elif op == "get_children":
                self._reply({"children": self.core.get_children(
                    sid, req["path"], watch=req.get("watch", False))})
            else:
                self._reply({"error": f"bad op {op!r}"}, 400)
        except NodeExistsError as e:
            self._reply({"error": "node_exists", "path": str(e)}, 409)
        except NoNodeError as e:
            self._reply({"error": "no_node", "path": str(e)}, 404)
        except NotLeaderError as e:
            self._reply({"error": "not_leader", "leader": e.leader}, 421)
        except CoordinationUnavailable as e:
            self._reply({"error": "unavailable", "detail": str(e)}, 503)

    def _ensemble_rpc(self, path: str, req: dict) -> None:
        ens = self.ensemble
        if ens is None:
            self._reply({"error": "no ensemble"}, 404)
            return
        if path == "/ensemble/vote":
            self._reply(ens.handle_vote(req))
        elif path == "/ensemble/append":
            self._reply(ens.handle_append(req))
        elif path == "/ensemble/snapshot":
            self._reply(ens.handle_install_snapshot(req))
        else:
            self._reply({"error": "not found"}, 404)


class CoordinationServer:
    """Serve a :class:`CoordinationCore` over HTTP (the ZooKeeper-server
    role at ``zookeeper.connection``, ``application.properties:2``).

    Three durability modes:

    - ``data_dir=None`` (default): in-memory standalone — the original
      substrate; state dies with the process (tests, dev).
    - ``data_dir`` set, no ``peers``: durable standalone — every write
      goes through a fsynced WAL; a crashed-and-restarted coordinator
      reconstructs the full znode tree + session table.
    - ``data_dir`` + ``peers``: replicated ensemble member (Raft-style,
      ``cluster/ensemble.py``) — a majority quorum commits every write
      before it is acknowledged; the ensemble survives the loss of any
      minority of members with zero lost acknowledged writes.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 session_timeout_s: float = 3.0,
                 data_dir: str | None = None, node_id: str = "",
                 peers: dict[str, str] | None = None,
                 election_timeout_s: float = 1.0,
                 heartbeat_interval_s: float = 0.25,
                 commit_timeout_s: float = 5.0,
                 snapshot_every: int = 512,
                 wal_fsync: bool = True) -> None:
        if peers and not data_dir:
            # never run a quorum whose hard state (term/voted_for/log)
            # evaporates on restart — that can double-vote and lose
            # acknowledged writes; refuse loudly instead of degrading
            # to a silent single in-memory coordinator
            raise ValueError("peers requires data_dir: ensemble hard "
                             "state must be durable")
        if peers and (node_id or "n0") not in peers:
            # the map must include THIS member: a node replicating to
            # its own address would depose itself on every election and
            # the quorum size would count phantom members
            raise ValueError(f"node_id {node_id or 'n0'!r} missing from "
                             f"peers map {sorted(peers)}")
        self.core = CoordinationCore(session_timeout_s)
        handler = type("Handler", (_CoordHandler,), {"core": self.core})
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self.httpd.daemon_threads = True
        self.address = f"{host}:{self.httpd.server_address[1]}"
        self.ensemble = None
        if data_dir:
            from tfidf_tpu_torch.cluster.ensemble import EnsembleNode
            nid = node_id or "n0"
            all_peers = dict(peers or {})
            my_address = all_peers.pop(nid, self.address)
            self.ensemble = EnsembleNode(
                core=self.core, data_dir=data_dir, node_id=nid,
                peers=all_peers, my_address=my_address,
                election_timeout_s=election_timeout_s,
                heartbeat_interval_s=heartbeat_interval_s,
                commit_timeout_s=commit_timeout_s,
                snapshot_every=snapshot_every, wal_fsync=wal_fsync)
            handler.ensemble = self.ensemble
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="coord-server")

    def start(self) -> "CoordinationServer":
        self._thread.start()
        if self.ensemble is not None:
            self.ensemble.start()
        log.info("coordination server up", address=self.address,
                 durable=self.ensemble is not None)
        return self

    def close(self) -> None:
        if self.ensemble is not None:
            self.ensemble.close()
        self.core.close()
        self.httpd.shutdown()
        self.httpd.server_close()

    def kill(self) -> None:
        """Crash simulation: stop serving WITHOUT graceful session
        expiry or any flush beyond what appends already fsynced —
        recovery must come exclusively from the WAL + snapshot."""
        if self.ensemble is not None:
            self.ensemble.kill()
        self.core._closed = True      # stop the reaper; no expiry events
        self.httpd.shutdown()
        self.httpd.server_close()


class CoordinationClient(_BaseCoordination):
    """HTTP client session — the ``ZooKeeper`` client-bean analog
    (``config/ZookeeperConfig.java:15-21``).

    ``address`` may be a comma-separated member list (the ZooKeeper
    connect-string shape, ``"c0:2181,c1:2181,c2:2181"``). Every RPC
    fails over across members: connection failures rotate to the next
    address; a follower's 421 ``not_leader`` reply redirects straight to
    the leader hint. After a failover lands on a NEW server, all
    outstanding one-shot watches are re-armed there and compared against
    their last-read state — a change that happened during the failover
    window is delivered as a synthesized event, so watch semantics
    survive ensemble-leader loss (ZooKeeper's ``setWatches`` reconnect
    dance)."""

    def __init__(self, address: str,
                 heartbeat_interval_s: float | None = None,
                 timeout_s: float = 5.0,
                 failover_deadline_s: float = 10.0,
                 origin: str = "") -> None:
        super().__init__()
        self.addresses = [a.strip() for a in address.split(",") if a.strip()]
        assert self.addresses, "at least one coordinator address required"
        self.timeout_s = timeout_s
        # how long one logical op keeps rotating/redirecting before
        # giving up — must comfortably span an ensemble leader election
        self.failover_deadline_s = failover_deadline_s
        # this client's endpoint identity for the nemesis shim
        # (cluster/nemesis.py); SearchNode stamps its own URL here
        self.origin = origin
        # jittered, per-instance reconnect backoff for the rotate/
        # retry sleeps in _rpc and _poll: after a healed partition
        # every client would otherwise re-attempt on the same fixed
        # 20 Hz beat — a synchronized thundering herd on the freshly
        # recovered coordinator. Per-instance rng -> decorrelated
        # phases; exponential growth caps the per-client retry rate
        # while the outage lasts. (The heartbeat loop's RetryPolicy
        # below is jittered the same way by default.)
        self._reconnect = RetryPolicy(base_delay_s=0.05, max_delay_s=0.8,
                                      name="coord_reconnect")
        self._addr_lock = threading.Lock()
        self._addr_i = 0
        self._last_good: str | None = None
        # any connection-level failure since the last success: the next
        # success re-arms watches even on the SAME address (a durable
        # standalone coordinator restarts on its old host:port, and
        # restore_state wiped its server-side watch table)
        self._conn_failed = False
        # (path, kind) -> last-read value for failover re-arm comparison
        self._armed_state: dict[tuple[str, str], object] = {}
        self._synthetic: deque[Event] = deque()
        self._rearm_lock = threading.Lock()
        r = self._rpc({"op": "new_session"})
        self.sid = r["session"]
        interval = (heartbeat_interval_s if heartbeat_interval_s is not None
                    else float(r["timeout_s"]) / 4)
        self._hb = threading.Thread(target=self._hb_loop, args=(interval,),
                                    daemon=True, name="coord-heartbeat")
        self._hb.start()
        self.start()

    # ---- address failover ----

    def _current(self) -> str:
        with self._addr_lock:
            return self.addresses[self._addr_i % len(self.addresses)]

    def _advance(self) -> None:
        with self._addr_lock:
            self._addr_i = (self._addr_i + 1) % len(self.addresses)
        global_metrics.inc("coord_addr_rotations")

    def _redirect(self, leader: str | None) -> None:
        if not leader:
            self._advance()
            return
        with self._addr_lock:
            if leader not in self.addresses:
                self.addresses.append(leader)
            self._addr_i = self.addresses.index(leader)

    def _note_success(self, base: str, rearm_ok: bool = True) -> None:
        prev, self._last_good = self._last_good, base
        failed, self._conn_failed = self._conn_failed, False
        moved = prev is not None and prev != base
        if moved:
            global_metrics.inc("coord_failovers")
            log.info("failed over", frm=prev, to=base)
        if (moved or (failed and prev is not None)) and rearm_ok:
            # new server OR possible same-address restart: either way
            # the server-side watch table may no longer have our watches
            self._rearm_watches()

    # Mutations are NOT retried after an ambiguous failure (the request
    # may have been delivered and committed — re-sending an
    # EPHEMERAL_SEQUENTIAL create would mint a second znode and wedge
    # the election on an orphan candidate). Only provably-undelivered
    # failures (connection refused) and pre-execution rejections
    # (421 not_leader) are safe to retry for these ops.
    _MUTATING_OPS = frozenset(
        {"create", "delete", "set_data", "close_session"})

    def _reconnect_sleep(self, attempt: int) -> None:
        """One jittered backoff sleep before re-rotating (see
        ``_reconnect`` in ``__init__``). Routed through the policy's
        injectable ``_sleep`` so tests can record the chosen delays."""
        global_metrics.inc("coord_reconnect_backoffs")
        self._reconnect._sleep(
            self._reconnect.backoff_delay(min(max(attempt, 1), 5)))

    @staticmethod
    def _definitely_undelivered(e: Exception) -> bool:
        if isinstance(e, ConnectionRefusedError):
            return True
        return (isinstance(e, urllib.error.URLError)
                and isinstance(getattr(e, "reason", None),
                               ConnectionRefusedError))

    def _rpc(self, req: dict, _rearm: bool = True) -> dict:
        req.setdefault("session", getattr(self, "sid", 0))
        body = json.dumps(req).encode()
        mutating = req.get("op") in self._MUTATING_OPS
        deadline = time.monotonic() + self.failover_deadline_s
        last_exc: Exception = CoordinationUnavailable("no address tried")
        tries = 0
        while tries == 0 or time.monotonic() < deadline:
            tries += 1
            base = self._current()
            h = {"Content-Type": "application/json"}
            h.update(proto_headers())
            h = global_nemesis.filter_headers(self.origin, base, h)
            r = urllib.request.Request(f"http://{base}/rpc", data=body,
                                       headers=h)
            try:
                global_nemesis.check_send(self.origin, base)
                with urllib.request.urlopen(
                        r, timeout=self.timeout_s) as resp:
                    payload = json.loads(global_nemesis.filter_reply(
                        self.origin, base, resp.read()))
                self._note_success(base, _rearm)
                return payload
            except urllib.error.HTTPError as e:
                payload = json.loads(e.read() or b"{}")
                err = payload.get("error")
                if err == "node_exists":
                    self._note_success(base, _rearm)
                    raise NodeExistsError(payload.get("path", ""))
                if err == "no_node":
                    self._note_success(base, _rearm)
                    raise NoNodeError(payload.get("path", ""))
                if err == "not_leader":
                    # rejected before execution: always safe to retry
                    last_exc = e
                    self._redirect(payload.get("leader"))
                    if payload.get("leader"):
                        time.sleep(0.02)
                    else:
                        # no hint = mid-election: jittered wait so a
                        # whole cluster of clients doesn't re-poll the
                        # forming ensemble in lock-step
                        self._reconnect_sleep(tries)
                    continue
                if err == "unavailable" or e.code >= 500:
                    if err == "unavailable" and mutating:
                        # commit timeout: the entry may still commit
                        # later — surface the ambiguity, don't re-send
                        raise CoordinationUnavailable(
                            payload.get("detail", "no quorum"))
                    last_exc = e
                    self._advance()
                    self._reconnect_sleep(tries)
                    continue
                raise
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError) as e:
                self._conn_failed = True
                if mutating and not self._definitely_undelivered(e):
                    raise
                last_exc = e
                self._advance()
                self._reconnect_sleep(tries)
                continue
        raise last_exc

    # ---- watch re-arm after failover ----

    def _rearm_watches(self) -> None:
        """Re-register every outstanding one-shot watch on the new
        server; if the watched state changed while we were failing
        over, deliver the missed transition as a synthesized event
        (one-shot semantics preserved: changed -> fire once; unchanged
        -> stays armed server-side)."""
        if not self._rearm_lock.acquire(blocking=False):
            return      # another thread is already re-arming
        try:
            with self._wlock:
                armed = dict(self._armed_state)
            for (path, kind), last in armed.items():
                try:
                    if kind == "exists":
                        cur: object = bool(self._rpc(
                            {"op": "exists", "path": path, "watch": True},
                            _rearm=False)["exists"])
                        ev = (Event(NODE_CREATED if cur else NODE_DELETED,
                                    path) if cur != last else None)
                    else:
                        cur = list(self._rpc(
                            {"op": "get_children", "path": path,
                             "watch": True}, _rearm=False)["children"])
                        ev = (Event(CHILDREN_CHANGED, path)
                              if cur != last else None)
                    with self._wlock:
                        if ev is not None:
                            self._armed_state.pop((path, kind), None)
                            self._synthetic.append(ev)
                        else:
                            self._armed_state[(path, kind)] = cur
                except Exception as e:
                    # leave the armed entry and re-flag the failure so
                    # the next successful op retries the re-arm — a
                    # one-shot giving up here would lose the watch
                    self._conn_failed = True
                    log.warning("watch re-arm failed", path=path,
                                kind=kind, err=repr(e))
            global_metrics.inc("coord_watch_rearms")
        finally:
            self._rearm_lock.release()

    def _hb_loop(self, interval: float) -> None:
        # same discipline as LocalCoordination: retry a failed heartbeat
        # send quickly (bounded backoff) rather than burning a full
        # interval of the session-timeout budget per transient blip
        policy = RetryPolicy(max_attempts=3,
                             base_delay_s=min(0.05, interval / 4),
                             max_delay_s=interval / 2,
                             classify=lambda e: True,
                             name="coord_heartbeat")
        while not self._closed.is_set():
            time.sleep(interval)

            def send() -> bool:
                global_injector.check("coord.heartbeat_send")
                return bool(self._rpc({"op": "heartbeat"}).get("ok"))

            try:
                if not policy.call(send):
                    return   # session is gone; expiry event follows
            except Exception:
                pass  # retries exhausted: keep trying next interval

    def _poll(self, timeout_s: float) -> list[Event]:
        global_injector.check("coord.long_poll")
        with self._wlock:
            if self._synthetic:
                evs = list(self._synthetic)
                self._synthetic.clear()
                return evs
        deadline = time.monotonic() + self.failover_deadline_s
        last_exc: Exception = CoordinationUnavailable("no address tried")
        payload = None
        tries = 0
        while tries == 0 or time.monotonic() < deadline:
            if self._closed.is_set():
                raise CoordinationUnavailable("client closed")
            tries += 1
            base = self._current()
            url = (f"http://{base}/events?session={self.sid}"
                   f"&timeout={timeout_s}")
            poll_req = urllib.request.Request(
                url, headers=global_nemesis.filter_headers(
                    self.origin, base, proto_headers()))
            try:
                global_nemesis.check_send(self.origin, base)
                with urllib.request.urlopen(
                        poll_req, timeout=timeout_s + 5) as resp:
                    payload = json.loads(global_nemesis.filter_reply(
                        self.origin, base, resp.read()))
                self._note_success(base)
                break
            except urllib.error.HTTPError as e:
                body = json.loads(e.read() or b"{}")
                if body.get("error") == "not_leader":
                    last_exc = e
                    self._redirect(body.get("leader"))
                    if body.get("leader"):
                        time.sleep(0.02)
                    else:
                        self._reconnect_sleep(tries)
                    continue
                last_exc = e
                self._advance()
                self._reconnect_sleep(tries)
            except (urllib.error.URLError, ConnectionError, OSError,
                    TimeoutError) as e:
                self._conn_failed = True
                last_exc = e
                self._advance()
                self._reconnect_sleep(tries)
        if payload is None:
            raise last_exc
        evs = [Event(t, p) for t, p in payload["events"]]
        with self._wlock:
            for ev in evs:      # a fired watch is no longer armed
                kind = ("children" if ev.type == CHILDREN_CHANGED
                        else "exists")
                self._armed_state.pop((ev.path, kind), None)
        return evs

    def create(self, path, data=b"", mode=PERSISTENT):
        return self._rpc({"op": "create", "path": path, "data": data.hex(),
                          "mode": mode})["path"]

    def delete(self, path):
        self._rpc({"op": "delete", "path": path})

    def exists(self, path, watcher: Watcher | None = None) -> bool:
        self._arm(path, "exists", watcher)
        got = bool(self._rpc({"op": "exists", "path": path,
                              "watch": watcher is not None})["exists"])
        if watcher is not None:
            with self._wlock:
                self._armed_state[(path, "exists")] = got
        return got

    def get_data(self, path) -> bytes:
        return bytes.fromhex(self._rpc({"op": "get_data",
                                        "path": path})["data"])

    def get_data_if_changed(self, path, digest: str) -> bytes | None:
        """``get_data``, or None when the data still has ``digest``: an
        unchanged znode costs a small reply, not its whole value. A
        server that does not know the ``unless`` key sends the data."""
        r = self._rpc({"op": "get_data", "path": path, "unless": digest})
        return None if r.get("unchanged") else bytes.fromhex(r["data"])

    def set_data(self, path, data: bytes) -> None:
        self._rpc({"op": "set_data", "path": path, "data": data.hex()})

    def get_children(self, path, watcher: Watcher | None = None) -> list[str]:
        self._arm(path, "children", watcher)
        kids = self._rpc({"op": "get_children", "path": path,
                          "watch": watcher is not None})["children"]
        if watcher is not None:
            with self._wlock:
                self._armed_state[(path, "children")] = list(kids)
        return kids

    def close(self) -> None:
        super().close()
        try:
            # best-effort goodbye: don't spend the full failover budget
            # on a coordinator that is already gone
            self.failover_deadline_s = min(self.failover_deadline_s, 1.0)
            self._rpc({"op": "close_session"})
        except Exception:
            pass
