"""Leader election — the reference's predecessor-watch algorithm.

Re-implements ``leader/LeaderElection.java:14-114`` on the framework's own
coordination substrate: each candidate creates an ephemeral-sequential znode
under ``/election`` (``:49-55``); the smallest sequence number is the
leader; every other candidate watches only its immediate predecessor (no
herd effect, ``:57-86``); a ``NodeDeleted`` event triggers re-election
(``:100-113``). Role transitions fire an :class:`OnElectionCallback`
(``leader/OnElectionCallback.java:3-8``).
"""

from __future__ import annotations

import threading
from typing import Protocol

from tfidf_tpu_torch.cluster.coordination import (NODE_DELETED, EPHEMERAL_SEQUENTIAL,
                                                  CoordinationClient, Event,
                                                  LocalCoordination, NoNodeError)
from tfidf_tpu_torch.utils.logging import get_logger

log = get_logger("cluster.election")

ELECTION_NAMESPACE = "/election"
CANDIDATE_PREFIX = "c_"


class OnElectionCallback(Protocol):
    """Two-method role-transition interface
    (``leader/OnElectionCallback.java:3-8``)."""

    def on_elected_to_be_leader(self) -> None: ...
    def on_worker(self) -> None: ...


class LeaderElection:
    def __init__(self, coord: "LocalCoordination | CoordinationClient",
                 callback: OnElectionCallback) -> None:
        self.coord = coord
        self.callback = callback
        self.znode: str | None = None       # full path of my candidate node
        self._lock = threading.Lock()       # serializes re-elections

    # ``LeaderElection.initializeElectionNode`` (:30-47)
    def initialize(self) -> None:
        self.coord.ensure(ELECTION_NAMESPACE)

    # ``volunteerForLeadership`` (:49-55)
    def volunteer_for_leadership(self) -> None:
        self.initialize()
        self.znode = self.coord.create(
            f"{ELECTION_NAMESPACE}/{CANDIDATE_PREFIX}",
            mode=EPHEMERAL_SEQUENTIAL)
        log.info("volunteered", znode=self.znode)

    @property
    def _my_name(self) -> str:
        assert self.znode is not None, "volunteer_for_leadership first"
        return self.znode.rsplit("/", 1)[1]

    def epoch(self) -> int | None:
        """Monotonic leadership epoch: this candidate's own sequence
        number, parsed from the ephemeral-sequential znode name. The
        leader is the SMALLEST live candidate and the parent's counter
        only grows, so every successive leader's epoch strictly
        increases across failovers, resignations, and rejoins — the
        fencing token the mutating data plane stamps as
        ``X-Leader-Epoch`` (cluster/fencing.py). None before
        volunteering (or after resigning)."""
        if self.znode is None:
            return None
        suffix = self._my_name[len(CANDIDATE_PREFIX):]
        return int(suffix) if suffix.isdigit() else None

    # ``reelectLeader`` (:57-86): loop until we are leader or hold a watch
    # on a live predecessor (the predecessor may vanish between the listing
    # and the watch registration — same retry loop as the reference).
    def reelect_leader(self) -> None:
        with self._lock:
            while True:
                children = self.coord.get_children(ELECTION_NAMESPACE)
                me = self._my_name
                if me not in children:   # our session lapsed: not a member
                    log.warning("own candidate znode gone", znode=self.znode)
                    return
                if children[0] == me:
                    log.info("elected leader", znode=self.znode)
                    self.callback.on_elected_to_be_leader()
                    return
                pred = children[children.index(me) - 1]
                pred_path = f"{ELECTION_NAMESPACE}/{pred}"
                if self.coord.exists(pred_path, watcher=self._on_pred_event):
                    log.info("watching predecessor", me=me, predecessor=pred)
                    self.callback.on_worker()
                    return
                # predecessor died in the window: retry

    # ``process(WatchedEvent)`` (:100-113)
    def _on_pred_event(self, ev: Event) -> None:
        if ev.type == NODE_DELETED:
            self.reelect_leader()

    # ``isLeader`` (:88-97) — recomputed from the live children, not cached
    def is_leader(self) -> bool:
        if self.znode is None:
            return False
        try:
            children = self.coord.get_children(ELECTION_NAMESPACE)
        except NoNodeError:
            return False
        return bool(children) and children[0] == self._my_name

    def resign(self) -> None:
        """Delete own candidate node (used by graceful shutdown and fault
        injection; the reference only ever resigns by dying)."""
        if self.znode is not None:
            try:
                self.coord.delete(self.znode)
            except NoNodeError:
                pass
            self.znode = None
