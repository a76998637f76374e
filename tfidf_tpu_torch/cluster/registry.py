"""Service registry — discovery via the coordination substrate.

Re-implements ``registry/ServiceRegistry.java:16-123``: workers register an
ephemeral-sequential znode under ``/service_registry`` whose data payload is
the worker's base URL (``:54-64``); any node can subscribe to membership
changes — the address cache is refreshed and the one-shot watch re-armed on
every change (``:91-122``); the leader unregisters itself so it never serves
a shard (``:76-86``, ``OnElectionAction.java:30``).

The elected leader additionally publishes its own address at the ephemeral
``/leader_info`` node (``OnElectionAction.java:45-54``) so external clients
can find the coordinator.
"""

from __future__ import annotations

import threading

from tfidf_tpu_torch.cluster.coordination import (EPHEMERAL, EPHEMERAL_SEQUENTIAL,
                                                  CoordinationClient, Event,
                                                  LocalCoordination,
                                                  NodeExistsError, NoNodeError)
from tfidf_tpu_torch.utils.logging import get_logger

log = get_logger("cluster.registry")

REGISTRY_NAMESPACE = "/service_registry"
WORKER_PREFIX = "n_"
LEADER_INFO = "/leader_info"


class ServiceRegistry:
    def __init__(self, coord: "LocalCoordination | CoordinationClient",
                 on_change=None) -> None:
        """``on_change(old_addrs, new_addrs)`` fires after every
        membership-cache refresh that changed the set — the leader's
        shard-recovery hook (framework addition; the reference's cache
        refresh is silent, ``ServiceRegistry.java:91-111``). Called on
        the watch-dispatch thread: implementations must not block."""
        self.coord = coord
        self._znode: str | None = None
        self._addresses: tuple[str, ...] | None = None
        self._on_membership = on_change
        self._lock = threading.Lock()
        # refresh ordering WITHOUT holding _lock across coordination
        # RPCs (graftcheck lockgraph finding): a refresh takes a ticket
        # under the lock, reads the registry unlocked, and installs
        # only if no later-ticketed refresh already did — the scatter
        # hot path (get_all_service_addresses on every search) can
        # never block behind a refresh riding the coordination
        # client's failover deadline. Start-order tickets are an
        # approximation of read order: a later-STARTED refresh whose
        # read raced ahead of an earlier one's can briefly install a
        # pre-change view — but every membership change also fires the
        # armed one-shot watch, whose refresh starts after the change
        # and outranks both, so the cache converges within one watch
        # round-trip (the old whole-method lock bought total ordering
        # at the cost of RPCs under the read-path lock)
        self._refresh_ticket = 0
        self._installed_ticket = 0
        # serializes hook delivery and anchors each notification's "old"
        # to the previously NOTIFIED state — two concurrent refreshes
        # must not deliver transitions out of order (a stale A->B after
        # B->C would tell the leader a live worker was lost)
        self._notify_lock = threading.Lock()
        self._last_notified: tuple[str, ...] | None = None
        self.coord.ensure(REGISTRY_NAMESPACE)   # (:35-51)

    # ``registerToCluster`` (:54-64)
    def register_to_cluster(self, address: str) -> None:
        if self._znode is not None and self.coord.exists(self._znode):
            return   # already registered (same guard as :56-59)
        self._znode = self.coord.create(
            f"{REGISTRY_NAMESPACE}/{WORKER_PREFIX}", address.encode(),
            mode=EPHEMERAL_SEQUENTIAL)
        log.info("registered to cluster", znode=self._znode, address=address)

    # ``registerForUpdates`` (:66-74)
    def register_for_updates(self) -> None:
        self._update_addresses()

    # ``unregisterFromCluster`` (:76-86)
    def unregister_from_cluster(self) -> None:
        if self._znode is not None:
            try:
                self.coord.delete(self._znode)
            except NoNodeError:
                pass
            log.info("unregistered from cluster", znode=self._znode)
            self._znode = None

    # ``getAllServiceAddresses`` (:87-89): cached, lazily initialized
    def get_all_service_addresses(self) -> list[str]:
        with self._lock:
            cached = self._addresses
        if cached is None:
            self._update_addresses()
            with self._lock:
                cached = self._addresses or ()
        return list(cached)

    # ``updateAddresses`` (:91-111): re-read children + data, swap cache,
    # re-arm the one-shot watch by passing the watcher again. The
    # coordination reads run OUTSIDE ``_lock`` — only the ticket draw
    # and the install are locked (see __init__).
    def _update_addresses(self) -> None:
        with self._lock:
            self._refresh_ticket += 1
            ticket = self._refresh_ticket
        names = self.coord.get_children(REGISTRY_NAMESPACE,
                                        watcher=self._on_change)
        addrs = []
        for name in names:
            try:
                data = self.coord.get_data(
                    f"{REGISTRY_NAMESPACE}/{name}")
            except NoNodeError:
                continue   # vanished between listing and read (:99-103)
            addrs.append(data.decode())
        with self._lock:
            if ticket < self._installed_ticket:
                return   # a later-ticketed refresh already installed
            self._installed_ticket = ticket
            first = self._addresses is None
            self._addresses = tuple(addrs)
        log.info("cluster addresses updated", addresses=addrs)
        if self._on_membership is None:
            return
        with self._notify_lock:
            with self._lock:
                cur = self._addresses
            old = self._last_notified
            self._last_notified = cur
            if first and old is None:
                return   # initial population is not a transition
            if old is not None and set(old) != set(cur):
                # outside self._lock: the hook may consult the registry
                self._on_membership(old, cur)

    # ``process(WatchedEvent)`` (:113-122). The one-shot watch was consumed
    # when this fired, so a failed refresh MUST be retried — otherwise the
    # membership cache freezes forever on a transient coordination hiccup.
    # Retries never sleep on the shared watch-dispatch thread: a slow
    # refresh here would delay every other client event, including the
    # election NodeDeleted that failover latency depends on.
    def _on_change(self, ev: Event) -> None:
        try:
            self._update_addresses()
        except Exception as e:
            log.warning("membership refresh failed, retrying", err=repr(e))
            self._schedule_retry(0.1)

    def _schedule_retry(self, delay: float) -> None:
        t = threading.Timer(delay, self._retry, args=(delay,))
        t.daemon = True
        t.start()

    def _retry(self, delay: float) -> None:
        try:
            self._update_addresses()
        except Exception as e:
            log.warning("membership refresh failed, retrying", err=repr(e))
            self._schedule_retry(min(delay * 2, 5.0))


def publish_leader_info(coord, address: str) -> None:
    """Publish the ephemeral ``/leader_info`` znode
    (``OnElectionAction.java:45-54``).

    Unlike the reference's create-or-setData, a leftover node from the
    previous leader is deleted and re-created so the znode is owned by the
    NEW leader's session — setData would leave it tied to the old session,
    and the address would vanish when that session finally expires."""
    while True:
        try:
            coord.create(LEADER_INFO, address.encode(), mode=EPHEMERAL)
            break
        except NodeExistsError:
            try:
                coord.delete(LEADER_INFO)
            except NoNodeError:
                pass
    log.info("published leader info", address=address)


def read_leader_info(coord) -> str | None:
    try:
        return coord.get_data(LEADER_INFO).decode()
    except NoNodeError:
        return None
