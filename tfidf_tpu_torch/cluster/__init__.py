"""Cluster control plane.

The replacement for the reference's coordination stack (SURVEY.md §1,
layers L0-L3). A copy of the JAX package's ``cluster/`` with the import
prefix rewritten (held by ``tests/test_torch_cluster_copy.py``): a node of
either package serves beside the other's, and this one builds its engine
on a torch device (:class:`~tfidf_tpu_torch.cluster.node.SearchNode`).

- :mod:`coordination` — the L0 substrate: a small coordination service with
  ZooKeeper's znode semantics (persistent / ephemeral / ephemeral-sequential
  nodes, data payloads, one-shot watches, session-timeout liveness),
  embeddable in-process or served over HTTP to many node processes.
  Replaces the external ZooKeeper server (``config/ZookeeperConfig.java``).
- :mod:`election` — L1 leader election with the reference's exact
  predecessor-watch algorithm (``leader/LeaderElection.java``).
- :mod:`registry` — L1 service discovery (``registry/ServiceRegistry.java``).
- :mod:`node` — L2+L3: the symmetric node binary. Every node serves the
  worker data-plane API; the elected leader additionally serves the
  coordinator API (``leader/Leader.java``, ``worker/Worker.java``,
  ``controller/Controllers.java``).
- :mod:`resilience` — the failure discipline shared by every
  leader->worker RPC path: bounded retry with backoff + jitter,
  per-worker circuit breakers (closed/open/half-open), and the
  hedged-read laggard detector.
- :mod:`placement` — R-way document placement: the replica map with
  per-leg upload bookkeeping, per-query ownership assignment (exactly
  one live replica scores each document), and durable persistence of
  the map through the coordination substrate so leader failover keeps
  exact ownership.
- :mod:`router` — the scale-out query plane: the scatter read plane
  (owner-merge / failover / hedge spine) extracted from the node so it
  runs against a follower view of the placement znode, and the
  stateless :class:`~tfidf_tpu_torch.cluster.router.QueryRouter` tier built
  on it (any-node reads; all mutations stay on the elected leader).
- :mod:`wal` — L0 durability: CRC-framed write-ahead log, atomic
  snapshots of the znode tree + session table, and log compaction, so a
  crashed coordinator restarts with its full state.
- :mod:`ensemble` — L0 replication: Raft-style terms/votes/quorum-commit
  over the WAL, turning the substrate into a 3-replica ensemble that
  survives the loss of any single member with zero lost acknowledged
  writes (the role ZooKeeper's ensemble plays for the reference).
"""

from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                  CoordinationServer,
                                                  CoordinationClient,
                                                  LocalCoordination, Event)
from tfidf_tpu_torch.cluster.election import LeaderElection, OnElectionCallback
from tfidf_tpu_torch.cluster.registry import ServiceRegistry
from tfidf_tpu_torch.cluster.resilience import (BreakerBoard, CircuitBreaker,
                                                CircuitOpenError, RetryPolicy)
from tfidf_tpu_torch.cluster.node import SearchNode
from tfidf_tpu_torch.cluster.placement import PlacementFollower, PlacementMap
from tfidf_tpu_torch.cluster.router import QueryRouter
from tfidf_tpu_torch.cluster.wal import DurableStore
from tfidf_tpu_torch.cluster.ensemble import EnsembleNode

__all__ = [
    "CoordinationCore", "CoordinationServer", "CoordinationClient",
    "LocalCoordination", "Event", "LeaderElection", "OnElectionCallback",
    "ServiceRegistry", "SearchNode", "PlacementMap", "PlacementFollower",
    "QueryRouter", "RetryPolicy", "CircuitBreaker",
    "CircuitOpenError", "BreakerBoard", "DurableStore", "EnsembleNode",
]
