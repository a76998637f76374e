"""Leadership fencing — monotonic epochs on the mutating data plane.

The split-brain the crash-only chaos suites cannot reach: a
deposed-but-alive leader, partitioned from the coordinator but not from
the workers, can still land ``/worker/upload``, ``/worker/delete``, and
rebalance copy legs on shards — writes the NEW leader's placement map
will never reflect (the lost-doc / double-count class the reference
only mitigates via ZooKeeper session expiry, PAPER.md §1). The fix is
the classic fencing-token discipline (Gray & Cheriton leases; HBase /
Kafka controller epochs):

- the election's ephemeral-sequential znode IS a monotonic epoch: each
  volunteer mints a strictly larger sequence number, and the leader is
  the smallest live candidate — so every successive leader's own
  sequence number strictly grows (``LeaderElection.epoch``);
- every leader→worker *mutating* RPC carries ``X-Leader-Epoch``;
- workers track the highest epoch ever seen (durably — this module)
  and answer any LOWER epoch with the distinct fence status
  ``403`` + ``X-Fence-Rejected: 1``;
- a leader that sees a fence rejection steps down immediately
  (``SearchNode._fence_step_down``) instead of retrying: the epoch it
  holds can never become valid again.

Reads are deliberately NOT fenced: a stale leader serving a possibly
stale search is an availability choice the degraded-marker machinery
already reports honestly; fencing exists to stop *state divergence*.

Durability: the highest seen epoch persists to a sidecar file under the
worker's index dir and is reloaded at construction, so a worker that
reboots mid-partition cannot be captured by the deposed leader
(fsync-before-accept — the 200 for an epoch-advancing write implies the
advance is already on disk, mirroring the WAL's fsync-before-ack
contract)."""

from __future__ import annotations

import os
import threading

from tfidf_tpu_torch.utils.storage import atomic_write_json, read_json
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.fencing")

# the wire contract (cluster/node.py handlers + leader RPC helpers)
FENCE_HEADER = "X-Leader-Epoch"
FENCE_REJECTED_HEADER = "X-Fence-Rejected"
FENCE_EPOCH_HEADER = "X-Fence-Epoch"
FENCE_STATUS = 403


class FenceGuard:
    """Worker-side fence state: the highest leader epoch ever observed,
    durable across restarts.

    ``observe(epoch)`` returns True (accept: ``epoch`` is >= the
    highest seen; an advance is persisted BEFORE the call returns) or
    False (stale: the caller must answer the fence status). A guard
    that has never seen an epoch accepts anything — external /
    reference clients carry no epoch header at all and are never
    fenced."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._lock = threading.Lock()
        self._epoch = -1                      # -1 = never saw an epoch
        try:
            # the checksummed read (utils/storage.py) matters here more
            # than anywhere: a flipped digit in the epoch is VALID JSON
            # with a lower value — silently accepting it would let a
            # deposed leader capture this worker after a reboot. A CRC
            # mismatch lands in the loud-permissive branch below
            # instead, exactly like a torn file.
            self._epoch = int(read_json(self._path)["epoch"])
        except FileNotFoundError:
            pass
        except Exception as e:
            # unreadable fence state: start permissive (equivalent to a
            # brand-new worker) but say so — silent strictness could
            # wedge a healthy cluster on one corrupt byte
            global_metrics.inc("fence_state_unreadable")
            log.warning("fence state unreadable; starting fresh",
                        path=path, err=repr(e))

    def current(self) -> int:
        with self._lock:
            return self._epoch

    def observe(self, epoch: int) -> bool:
        """Admit-or-reject one stamped mutating RPC (see class doc)."""
        err = None
        with self._lock:
            if epoch < self._epoch:
                return False
            if epoch > self._epoch:
                self._epoch = epoch
                try:
                    # durability-before-accept, deliberately under the
                    # lock: a concurrent lower-epoch advance must never
                    # overwrite a higher one on disk (reviewed
                    # fsync-under-lock — graftcheck allowlist)
                    self._persist_locked()
                except Exception as e:
                    err = repr(e)
        if err is not None:
            global_metrics.inc("fence_persist_failures")
            log.warning("fence epoch persist failed (accepting anyway: "
                        "a reboot may forget this epoch)", err=err)
        return True

    def _persist_locked(self) -> None:
        d = os.path.dirname(self._path)
        if d:
            os.makedirs(d, exist_ok=True)
        # checksummed atomic publish through the durable-IO seam:
        # temp + CRC envelope + fsync file + rename + fsync dir — a
        # torn write can never be mistaken for a lower (or higher)
        # epoch on reload (reviewed fsync-under-lock — graftcheck
        # allowlist)
        atomic_write_json(self._path, {"epoch": self._epoch})
