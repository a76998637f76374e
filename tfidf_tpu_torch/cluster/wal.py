"""Durable storage for the coordination substrate: WAL + snapshots.

The reference gets durability for free from ZooKeeper — every accepted
write lands in ZooKeeper's transaction log and fuzzy snapshots before it
is acknowledged (``ZookeeperConfig.java:15-21`` just points at the
ensemble). The framework's substrate (``cluster/coordination.py``) was a
single in-memory process until now; this module supplies the missing
persistence layer, following the ZooKeeper/Raft design split:

- :class:`DurableStore` — one directory holding

  * ``wal.log``      — CRC-framed append-only log of state-machine
    commands (``{"i": index, "t": term, "c": cmd}`` JSON payloads).
    Recovery replays frames and *truncates at the first corrupt or
    short frame* — a torn tail from a crash mid-append loses only the
    unacknowledged suffix, never the committed prefix.
  * ``snapshot.json`` — atomically-replaced full snapshot of the znode
    tree + session table at some applied index (log compaction point).
  * ``meta.json``     — Raft hard state (``term``, ``voted_for``),
    fsynced before any vote or append response leaves the node.

Frame format (little-endian): ``<II`` = (payload length, CRC32 of
payload) followed by the JSON payload. fsync policy: ``fsync=True``
(default) syncs every append batch before it is acknowledged — the
Raft/ZooKeeper contract; ``fsync=False`` trades the tail-loss window for
throughput (tests, ephemeral deployments).

Fault points: ``wal.append``, ``wal.fsync``, ``wal.snapshot`` (see
``utils/faults.KNOWN_FAULT_POINTS``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any

from tfidf_tpu_torch.utils.storage import (atomic_write_bytes,
                                           atomic_write_json, read_json)
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("cluster.wal")

_FRAME = struct.Struct("<II")   # (payload_len, crc32)

WAL_FILE = "wal.log"
SNAPSHOT_FILE = "snapshot.json"
META_FILE = "meta.json"


def encode_frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def decode_frames(blob: bytes) -> tuple[list[bytes], int]:
    """Decode consecutive frames; returns (payloads, clean_prefix_len).

    Stops at the first short or CRC-mismatched frame — everything after
    a torn write is unacknowledged by construction (append fsyncs before
    ack) and is discarded on recovery.
    """
    out: list[bytes] = []
    off = 0
    n = len(blob)
    while off + _FRAME.size <= n:
        length, crc = _FRAME.unpack_from(blob, off)
        start = off + _FRAME.size
        end = start + length
        if end > n:
            break                      # torn tail
        payload = blob[start:end]
        if zlib.crc32(payload) != crc:
            break                      # corrupt frame
        out.append(payload)
        off = end
    return out, off


class DurableStore:
    """WAL + snapshot + hard-state files under one ``data_dir``."""

    def __init__(self, data_dir: str, fsync: bool = True) -> None:
        self.dir = data_dir
        self.fsync = fsync
        os.makedirs(data_dir, exist_ok=True)
        self._wal_path = os.path.join(data_dir, WAL_FILE)
        self._snap_path = os.path.join(data_dir, SNAPSHOT_FILE)
        self._meta_path = os.path.join(data_dir, META_FILE)
        self._fh = open(self._wal_path, "ab")

    # ---- recovery ----

    def load(self) -> tuple[dict, dict | None, list[dict]]:
        """Returns ``(meta, snapshot_or_None, entries)``.

        ``meta``     — ``{"term": int, "voted_for": str|None}``
        ``snapshot`` — ``{"last_index", "last_term", "state"}``
        ``entries``  — WAL entries ``{"i", "t", "c"}`` in index order;
        entries at or below the snapshot's ``last_index`` are dropped,
        and the file is truncated at the first corrupt frame.
        """
        meta = {"term": 0, "voted_for": None}
        if os.path.exists(self._meta_path):
            try:
                # checksummed read (utils/storage.py): bit rot in the
                # hard state is detected, not parsed — a flipped digit
                # in `term` is valid JSON that re-votes in a past term.
                # StorageCorruption is a ValueError: caught below.
                meta.update(read_json(self._meta_path))
            except (ValueError, OSError) as e:
                log.warning("raft meta unreadable; starting at term 0",
                            err=repr(e))
        snapshot: dict | None = None
        if os.path.exists(self._snap_path):
            try:
                snapshot = read_json(self._snap_path)
                if not {"last_index", "last_term",
                        "state"} <= set(snapshot):
                    raise ValueError("snapshot missing fields")
            except (ValueError, OSError) as e:
                log.warning("snapshot unreadable; replaying full WAL",
                            err=repr(e))
                snapshot = None
        with open(self._wal_path, "rb") as f:
            blob = f.read()
        payloads, clean = decode_frames(blob)
        if clean < len(blob):
            global_metrics.inc("wal_truncated_bytes", len(blob) - clean)
            log.warning("WAL tail truncated on recovery",
                        dropped_bytes=len(blob) - clean)
            self._fh.close()
            with open(self._wal_path, "r+b") as f:
                f.truncate(clean)
                os.fsync(f.fileno())
            self._fh = open(self._wal_path, "ab")
        base = snapshot["last_index"] if snapshot else 0
        entries: list[dict] = []
        expect = None
        for p in payloads:
            try:
                e = json.loads(p)
            except ValueError:
                break
            if e["i"] <= base:
                continue
            if expect is not None and e["i"] != expect:
                log.warning("WAL index gap; dropping suffix",
                            expected=expect, got=e["i"])
                break
            entries.append(e)
            expect = e["i"] + 1
        global_metrics.inc("wal_recovered_entries", len(entries))
        return meta, snapshot, entries

    # ---- appends ----

    def append(self, entries: list[dict]) -> None:
        """Frame + write + (policy) fsync a batch of entries. Raises on
        any I/O or injected fault — the caller must NOT acknowledge, and
        the file is rewound to its pre-append length so the failed
        frame cannot survive on disk (a leftover frame would reuse its
        index on the next append and recovery's index-continuity check
        would then truncate ACKED history after the duplicate)."""
        global_injector.check("wal.append")
        buf = b"".join(
            encode_frame(json.dumps(e, separators=(",", ":")).encode())
            for e in entries)
        # O_APPEND offset semantics make tell() unreliable pre-write
        start = os.fstat(self._fh.fileno()).st_size
        try:
            self._fh.write(buf)
            self._fh.flush()
            if self.fsync:
                global_injector.check("wal.fsync")
                os.fsync(self._fh.fileno())
                global_metrics.inc("wal_fsyncs")
        except Exception:
            try:
                self._fh.truncate(start)
                self._fh.flush()
                os.fsync(self._fh.fileno())
            except OSError:
                # disk refuses even the rewind: reopen so the next
                # append sees the true end-of-file
                self._fh.close()
                with open(self._wal_path, "r+b") as f:
                    f.truncate(start)
                self._fh = open(self._wal_path, "ab")
            raise
        global_metrics.inc("wal_appends", len(entries))

    # ---- rewrite paths (truncation + compaction) ----

    def rewrite(self, entries: list[dict]) -> None:
        """Atomically replace the WAL with exactly ``entries`` (conflict
        truncation after a leader change; compaction after snapshot) —
        temp + fsync + rename through the durable-IO seam."""
        buf = b"".join(
            encode_frame(json.dumps(e, separators=(",", ":")).encode())
            for e in entries)
        self._fh.close()
        try:
            atomic_write_bytes(self._wal_path, buf, fsync=True)
        finally:
            # reopen even when the seam write fails (ENOSPC, armed
            # nemesis): the atomic publish left the old log intact, and
            # a permanently-closed handle would crash every later
            # append with a non-OSError nothing upstream classifies
            self._fh = open(self._wal_path, "ab")
        global_metrics.inc("wal_rewrites")

    def write_snapshot(self, state: dict, last_index: int,
                       last_term: int) -> None:
        """Atomically persist a snapshot at ``last_index`` (the slow
        half: full-state JSON + fsync; callers may run it outside
        their locks — it touches only the snapshot file). Checksummed
        through the durable-IO seam, so the frame-checksummed WAL is no
        longer the only coordination file that can PROVE its bytes."""
        global_injector.check("wal.snapshot")
        atomic_write_json(
            self._snap_path,
            {"last_index": last_index, "last_term": last_term,
             "state": state})
        global_metrics.inc("wal_snapshots")

    def save_snapshot(self, state: dict, last_index: int, last_term: int,
                      remaining: list[dict]) -> None:
        """Snapshot at ``last_index`` and compact the WAL down to
        ``remaining`` (entries above the snapshot) in one step."""
        self.write_snapshot(state, last_index, last_term)
        self.rewrite(remaining)
        log.info("snapshot saved", last_index=last_index,
                 wal_entries=len(remaining))

    # ---- Raft hard state ----

    def set_meta(self, term: int, voted_for: str | None) -> None:
        """Persist (term, voted_for) BEFORE any vote/append response —
        a node must never vote twice in a term across a restart."""
        atomic_write_json(
            self._meta_path, {"term": term, "voted_for": voted_for})

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


