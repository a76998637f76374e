"""Fault injection.

The reference tolerates faults (ZooKeeper ephemeral-node liveness, partial
scatter-gather, ``Leader.java:67-69``) but has no way to *inject* them
(SURVEY.md §5.3: "Fault injection: none"). This module adds that capability:
named fault points are sprinkled through the control plane (worker RPC,
heartbeat, checkpoint write) and a test/chaos harness can arm them to raise,
delay, or drop with a given probability.

Every fault point in the tree is declared in :data:`KNOWN_FAULT_POINTS`
(``tfidf_tpu_torch faults list`` prints it) so chaos configs can be validated
against the code instead of silently going stale; a tier-1 test greps the
sources and fails if a ``check()`` site is missing from the registry.
Arming a name ending in ``*`` matches any point with that prefix (e.g.
``coord.heartbeat.*`` covers the per-session server-side heartbeat
points) — fires are counted under the wildcard rule's name.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass

from tfidf_tpu_torch.utils.tracing import span_event

# Registry of every fault point compiled into the tree: name -> where it
# fires. Dynamic per-instance points are declared with a ``*`` suffix.
KNOWN_FAULT_POINTS: dict[str, str] = {
    "leader.worker_rpc": "leader scatter RPC to one worker "
                         "(per-query and batched paths)",
    "leader.size_poll": "leader polling one worker's /worker/index-size",
    "leader.reconcile_rpc": "leader's /worker/delete rejoin-reconcile RPC",
    "leader.sweep": "one reconciliation-sweep pass on the leader",
    "leader.replica_rpc": "leader re-issuing an orphaned ownership slice "
                          "to a surviving replica (failover scatter read)",
    "leader.hedge": "leader dispatching a hedged duplicate read for a "
                    "laggard worker's ownership slice",
    "leader.repair": "one anti-entropy replication-repair pass on the "
                     "leader (restore R / trim over-replication)",
    "leader.placement_persist": "leader persisting the placement map to "
                                "the coordination substrate",
    "leader.rebalance_copy": "rebalancer about to copy a migrating doc "
                             "range to its targets (pre-copy crash "
                             "window: ownership has not moved)",
    "leader.rebalance_flip": "rebalancer about to atomically flip "
                             "ownership of a copied range (pre-flip "
                             "crash window: the copy legs are plain "
                             "over-replication)",
    "leader.rebalance_reconcile": "rebalancer about to trigger the "
                                  "reconcile deletes after a durable "
                                  "flip (failure retried by the sweep)",
    "leader.admission": "front-door admission decision for one "
                        "/leader/* request (arm to chaos-test the "
                        "shed path itself)",
    "leader.autopilot": "one SLO-autopilot control pass on the leader "
                        "(arm to chaos-test the sweep loop's tolerance "
                        "of a failing controller)",
    "worker.process": "worker handling /worker/process[-batch]",
    "worker.upload": "worker handling /worker/upload[-batch]",
    "worker.fence": "worker checking a mutating RPC's X-Leader-Epoch "
                    "against its durable fence (arm to chaos-test the "
                    "fence path itself)",
    "router.view_refresh": "a placement follower view (router / "
                           "any-node read plane) about to re-arm its "
                           "watch and re-read the placement znode",
    "router.write_proxy": "a router (or non-leader node) about to "
                          "forward a front-door mutation to the "
                          "elected leader",
    "coord.heartbeat.*": "coordination server receiving a session "
                         "heartbeat (suffix: session id)",
    "coord.heartbeat_send": "coordination client sending a heartbeat",
    "coord.long_poll": "coordination client's event long-poll",
    "resilience.backoff": "retry policy about to sleep a backoff delay",
    "resilience.breaker_trip": "circuit breaker transitioning to open "
                               "(observe-only: armed raise is swallowed)",
    "resilience.breaker_probe": "circuit breaker admitting a half-open "
                                "probe (observe-only)",
    "checkpoint.pre_publish": "checkpoint written but not yet published "
                              "(crash window)",
    "storage.write": "durable-IO seam about to write a file's bytes "
                     "(utils/storage.py; torn-write / ENOSPC window)",
    "storage.fsync": "durable-IO seam about to fsync a file or "
                     "directory (the fsync-EIO window)",
    "storage.read": "durable-IO seam reading a durable file back "
                    "(the bit-rot window — damage here is silent "
                    "unless a checksum catches it)",
    "storage.rename": "durable-IO seam about to atomically publish "
                      "via rename (crash-before/after-rename window)",
    "wal.append": "coordination WAL about to frame+write an entry batch "
                  "(failure = write not acknowledged)",
    "wal.fsync": "coordination WAL about to fsync appended entries",
    "wal.snapshot": "coordination snapshot about to be written "
                    "(pre-atomic-rename crash window)",
    "device.score_ell": "ELL scoring dispatch seam (ops/ell.py "
                        "score_ell_batch) — the device nemesis' primary "
                        "injection point",
    "device.score_segments": "segmented scoring dispatch seam "
                             "(ops/ell.py score_segments_batch; hot "
                             "pass, cold walk, and parity oracle)",
    "device.score_coo": "COO scoring dispatch seam "
                        "(ops/scoring.py score_coo_batch)",
    "device.dense": "dense-plane dispatch seam (ops/dense.py "
                    "dense_scores / packed_dense_topk)",
    "device.upload": "tiering upload ring about to move one cold "
                     "segment host->HBM (engine/tiering.py)",
    "ensemble.vote": "ensemble member handling a RequestVote RPC",
    "ensemble.replicate_append.*": "ensemble leader about to send "
                                   "AppendEntries/InstallSnapshot to one "
                                   "peer (suffix: peer node id)",
}


class FaultInjected(RuntimeError):
    pass


@dataclass
class _Rule:
    action: str            # "raise" | "delay" | "callable"
    probability: float = 1.0
    delay_s: float = 0.0
    remaining: int | None = None   # fire at most N times; None = unlimited
    fn: object = None


class FaultInjector:
    def __init__(self, seed: int | None = None) -> None:
        self._rules: dict[str, _Rule] = {}
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self.fired: dict[str, int] = {}

    def arm(self, point: str, action: str = "raise", probability: float = 1.0,
            delay_s: float = 0.0, times: int | None = None,
            fn=None) -> None:
        with self._lock:
            self._rules[point] = _Rule(action, probability, delay_s, times, fn)

    def disarm(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._rules.clear()
            else:
                self._rules.pop(point, None)

    def _match(self, point: str) -> tuple[str, _Rule] | None:
        """Exact rule first, then any armed ``prefix*`` wildcard."""
        rule = self._rules.get(point)
        if rule is not None:
            return point, rule
        for key, r in self._rules.items():
            if key.endswith("*") and point.startswith(key[:-1]):
                return key, r
        return None

    def check(self, point: str) -> None:
        with self._lock:
            hit = self._match(point)
            if hit is None:
                return
            key, rule = hit
            if rule.remaining is not None:
                if rule.remaining <= 0:
                    return
            if self._rng.random() > rule.probability:
                return
            if rule.remaining is not None:
                rule.remaining -= 1
            # fires are counted under the RULE's name so wildcard chaos
            # configs can assert totals without enumerating instances
            self.fired[key] = self.fired.get(key, 0) + 1
            action, delay_s, fn = rule.action, rule.delay_s, rule.fn
        # every fault fire is visible in traces BY CONSTRUCTION: the one
        # emission here covers all fault_point()/check() sites (enforced
        # by the graftcheck registry-drift pass), so a chaos run's trace
        # shows exactly where the injected failure entered the request
        span_event("fault_injected", point=point, rule=key,
                   action=action)
        if action == "delay":
            time.sleep(delay_s)
        elif action == "callable" and fn is not None:
            fn()
        elif action == "raise":
            raise FaultInjected(f"fault injected at {point!r}")


# Process-wide injector used by library fault points; tests arm/disarm it.
global_injector = FaultInjector()


def fault_point(name: str) -> None:
    """Call at a named site; no-op unless a test armed this point."""
    global_injector.check(name)
