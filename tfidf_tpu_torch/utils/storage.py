"""Durable-IO seam + scriptable disk nemesis.

The reference's durability unit is the disk: Lucene commits checksummed
segment files and publishes them atomically on every upload
(``Worker.java:138``, PAPER.md §7). Until this module, the framework's
durable surfaces each rolled their own write path — ``save_checkpoint``
wrote straight into the final version dir, the fence sidecar and the
``placed_docs`` store were plain ``open``+``os.replace``, and nothing
outside the coordination WAL carried a checksum — so a torn write, a
flipped bit, or a disk that lies on ``fsync`` could silently change
search results after a restart.

This is the one seam every durable byte now goes through:

- :func:`write_bytes` / :func:`savez` / :func:`read_bytes` /
  :func:`fsync_path` / :func:`fsync_dir` / :func:`replace` — the
  primitive ops, each instrumented with a ``storage.*`` fault point
  (``utils.faults``) AND consulted against the :class:`StorageNemesis`
  rule table, so chaos tests script per-path disk faults without
  monkeypatching a single call site (the disk twin of
  ``cluster/nemesis.py``'s network shim);
- :func:`atomic_write_bytes` / :func:`atomic_write_json` — temp file →
  write → fsync file → atomic rename → fsync dir, the only publish
  discipline a crash cannot tear; the JSON form wraps the payload in a
  CRC32 envelope (legacy un-checksummed files are still readable) so
  bit rot is *detected* instead of silently parsed — a flipped digit
  in a fence epoch parses fine and fences wrong;
- :func:`write_manifest` / :func:`verify_manifest` — a per-directory
  CRC32+size manifest covering every file of a checkpoint version, the
  load-time integrity gate behind checkpoint fallback/quarantine;
- :func:`publish_dir` — build-dir → fsync every file → fsync dir →
  atomic rename into the final versioned name → fsync parent: a
  version directory either exists complete or not at all;
- :class:`GroupCommitter` — cross-thread group commit of fsyncs: the
  fsync-before-ack upload contract without one fsync syscall convoy
  per concurrent request (concurrent commits coalesce into shared
  flush rounds, the coalescer discipline applied to durability);
- :class:`CrcLedger` — name → CRC32 record for a store of raw
  documents (the leader's ``placed_docs``), the reference the
  integrity scrub verifies replicas against;
- :class:`RequestLog` — the durable traffic-capture log (admitted
  ``/leader/start`` queries + arrival offsets + lanes), CRC-framed
  per line so a torn tail truncates cleanly; ``bench.py --replay``
  replays it as production-shaped load.

Nemesis rules are scriptable in-process (``global_storage.arm(...)``)
and via the ``TFIDF_STORAGE_NEMESIS`` env var (a JSON rule list) so
subprocess chaos clusters (``make chaos-powerloss``) boot with the disk
already hostile. Injected faults are real ``OSError`` s with real
``errno`` s (:class:`DiskFault`), so every existing classifier treats
them exactly like the hardware failure they model.
"""

from __future__ import annotations

import errno
import fnmatch
import json
import os
import random
import threading
import time
import zlib

from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event

log = get_logger("utils.storage")

MANIFEST_NAME = "MANIFEST.json"

# the distinct wire status for a full disk (satellite contract: an
# ENOSPC on upload/checkpoint is an ENVIRONMENT condition — classified
# non-retryable, never a worker fault, never a breaker trip)
STORAGE_FULL_STATUS = 507

# nemesis fault kinds
TORN_WRITE = "torn_write"          # partial bytes land, then EIO
ENOSPC = "enospc"                  # the disk is full
FSYNC_EIO = "fsync_eio"            # fsync reports EIO (fsyncgate)
BITROT = "bitrot"                  # read-back returns flipped bytes
CRASH_BEFORE_RENAME = "crash_before_rename"   # die before the publish
CRASH_AFTER_RENAME = "crash_after_rename"     # die after it

_KINDS = (TORN_WRITE, ENOSPC, FSYNC_EIO, BITROT,
          CRASH_BEFORE_RENAME, CRASH_AFTER_RENAME)

# op → kinds that fire there
_OP_KINDS = {
    "write": (TORN_WRITE, ENOSPC),
    "fsync": (FSYNC_EIO,),
    "read": (BITROT,),
    "rename": (CRASH_BEFORE_RENAME, CRASH_AFTER_RENAME),
}


class StorageCorruption(ValueError):
    """A durable file failed its integrity check (CRC/size/manifest).
    A ``ValueError`` subclass on purpose: every existing
    unreadable-state handler (``wal.load``, ``FenceGuard.__init__``)
    already catches ``ValueError`` and falls back loudly."""


class DiskFault(OSError):
    """An injected disk fault. A real ``OSError`` with a real
    ``errno`` — callers classify it exactly like the hardware failure
    it models (EIO, ENOSPC)."""


class _SRule:
    __slots__ = ("rid", "kind", "glob", "probability", "remaining",
                 "keep_bytes")

    def __init__(self, rid: int, kind: str, glob: str,
                 probability: float, times: int | None,
                 keep_bytes: int) -> None:
        self.rid = rid
        self.kind = kind
        self.glob = glob
        self.probability = probability
        self.remaining = times
        self.keep_bytes = keep_bytes


class StorageNemesis:
    """The scripted disk-fault plan (rule-driven like
    ``cluster.nemesis.NemesisNet``). Rules match ``(op, path)``: the
    op is the seam primitive (write / fsync / read / rename — implied
    by the rule's fault kind) and the path matches an ``fnmatch`` glob
    against the absolute path, so one plan can target exactly
    ``*/docs.npz`` or a whole node's index dir."""

    def __init__(self, seed: int = 0) -> None:
        self._lock = threading.Lock()
        self._rules: tuple[_SRule, ...] = ()
        self._next_id = 1
        self._rng = random.Random(seed)
        self.fired: dict[str, int] = {}

    def arm(self, kind: str, path_glob: str = "*",
            probability: float = 1.0, times: int | None = None,
            keep_bytes: int = 0) -> int:
        if kind not in _KINDS:
            raise ValueError(f"unknown storage fault kind {kind!r} "
                             f"(choose from {_KINDS})")
        with self._lock:
            rid = self._next_id
            self._next_id += 1
            self._rules = self._rules + (_SRule(
                rid, kind, path_glob, probability, times, keep_bytes),)
        log.info("storage nemesis rule armed", kind=kind, glob=path_glob,
                 rule=rid)
        return rid

    def remove(self, rid: int) -> None:
        with self._lock:
            self._rules = tuple(r for r in self._rules if r.rid != rid)

    def heal(self) -> None:
        with self._lock:
            n = len(self._rules)
            self._rules = ()
        if n:
            log.info("storage nemesis healed", rules_cleared=n)

    def active(self) -> bool:
        return bool(self._rules)

    def load_env(self, raw: str | None = None) -> int:
        """Arm rules from a JSON list (the ``TFIDF_STORAGE_NEMESIS``
        env var): ``[{"kind": "torn_write", "glob": "*docs*",
        "probability": 0.1, "times": 3, "keep_bytes": 8}, ...]``.
        Returns the number of rules armed."""
        raw = os.environ.get("TFIDF_STORAGE_NEMESIS") \
            if raw is None else raw
        if not raw:
            return 0
        rules = json.loads(raw)
        for r in rules:
            self.arm(r["kind"], r.get("glob", "*"),
                     probability=float(r.get("probability", 1.0)),
                     times=r.get("times"),
                     keep_bytes=int(r.get("keep_bytes", 0)))
        return len(rules)

    def match(self, op: str, path: str) -> _SRule | None:
        """One firing rule for this (op, path), or None. Decrements
        bounded rules and counts the fire (visible in traces like every
        ``FaultInjector`` fire — the chaos run's audit trail)."""
        rules = self._rules
        if not rules:
            return None
        kinds = _OP_KINDS[op]
        ap = os.path.abspath(path)
        with self._lock:
            for r in rules:
                if r.kind not in kinds:
                    continue
                if not fnmatch.fnmatch(ap, r.glob):
                    continue
                if r.remaining is not None and r.remaining <= 0:
                    continue
                if r.probability < 1.0 \
                        and self._rng.random() > r.probability:
                    continue
                if r.remaining is not None:
                    r.remaining -= 1
                self.fired[r.kind] = self.fired.get(r.kind, 0) + 1
                span_event("storage_fault_injected", kind=r.kind,
                           path=os.path.basename(ap))
                global_metrics.inc("storage_faults_injected")
                return r
        return None


# Process-wide nemesis used by the seam primitives; tests script it,
# subprocess chaos clusters arm it from TFIDF_STORAGE_NEMESIS at import.
global_storage = StorageNemesis()
if os.environ.get("TFIDF_STORAGE_NEMESIS"):
    global_storage.load_env()


def _enospc_seen(e: BaseException) -> None:
    """Count every observed disk-full, real or injected — the
    ``storage_enospc`` counter the 507 wire contract is audited by."""
    if isinstance(e, OSError) and e.errno == errno.ENOSPC:
        global_metrics.inc("storage_enospc")


def is_enospc(e: BaseException) -> bool:
    return isinstance(e, OSError) and e.errno == errno.ENOSPC


# ---------------------------------------------------------------------------
# seam primitives
# ---------------------------------------------------------------------------

def write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` (no atomicity — callers write into a
    temp name or a build dir and publish via :func:`replace` /
    :func:`publish_dir`). The torn-write / ENOSPC injection site."""
    global_injector.check("storage.write")
    rule = global_storage.match("write", path)
    if rule is not None and rule.kind == ENOSPC:
        e = DiskFault(errno.ENOSPC, "injected: no space left on device",
                      path)
        _enospc_seen(e)
        raise e
    try:
        with open(path, "wb") as f:
            if rule is not None:   # TORN_WRITE: partial bytes then EIO
                f.write(data[:max(0, rule.keep_bytes)])
                f.flush()
                raise DiskFault(errno.EIO, "injected: torn write", path)
            f.write(data)
    except OSError as e:
        _enospc_seen(e)
        raise


def savez(path: str, **arrays) -> None:
    """``np.savez`` through the seam (the checkpoint array files).
    Torn-write rules truncate the finished archive to ``keep_bytes``
    before raising — exactly the half-written .npz a crash leaves."""
    import numpy as np
    global_injector.check("storage.write")
    rule = global_storage.match("write", path)
    if rule is not None and rule.kind == ENOSPC:
        e = DiskFault(errno.ENOSPC, "injected: no space left on device",
                      path)
        _enospc_seen(e)
        raise e
    try:
        # via an open handle: np.savez APPENDS ".npz" to a bare path,
        # which would silently rename temp files out from under callers
        with open(path, "wb") as fh:
            np.savez(fh, **arrays)
    except OSError as e:
        _enospc_seen(e)
        raise
    if rule is not None:   # TORN_WRITE
        with open(path, "r+b") as f:
            f.truncate(max(0, rule.keep_bytes))
        raise DiskFault(errno.EIO, "injected: torn write", path)


def read_bytes(path: str) -> bytes:
    """Read a durable file through the seam — the bit-rot injection
    site: a matching rule returns silently damaged bytes, which only a
    checksum (manifest / JSON envelope) can catch."""
    global_injector.check("storage.read")
    with open(path, "rb") as f:
        data = f.read()
    rule = global_storage.match("read", path)
    if rule is not None and data:   # BITROT: flip a deterministic byte
        i = rule.keep_bytes % len(data)
        data = data[:i] + bytes([data[i] ^ 0x5A]) + data[i + 1:]
    return data


def read_memmap(path: str, dtype, shape: tuple):
    """Map a durable array file read-only through the seam — the cold
    postings tier (``engine/tiering.py``): the OS page cache IS the
    host-RAM tier, so a fault-in touches only the pages the device
    upload actually streams. Integrity is the caller's manifest gate
    (``verify_manifest`` BEFORE mapping — its ``file_crc`` pass is a
    read-seam site, so armed bit rot is detected there); a rule that
    matches here anyway degrades the map to a damaged in-memory copy,
    keeping the chaos contract (injected rot is observable, never
    silently bypassed) even for callers that skip the gate."""
    import numpy as np
    global_injector.check("storage.read")
    mm = np.memmap(path, dtype=dtype, mode="r", shape=shape)
    rule = global_storage.match("read", path)
    if rule is not None and mm.size:
        buf = np.array(mm)          # materialize, then flip one byte
        flat = buf.view(np.uint8).reshape(-1)
        flat[rule.keep_bytes % flat.shape[0]] ^= 0x5A
        return buf
    return mm


def fsync_path(path: str) -> None:
    """fsync one file's data. The fsync-EIO injection site."""
    global_injector.check("storage.fsync")
    if global_storage.match("fsync", path) is not None:
        raise DiskFault(errno.EIO, "injected: fsync failed", path)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    global_metrics.inc("storage_fsyncs")


def fsync_dir(path: str) -> None:
    """fsync a directory so a rename into it survives power loss."""
    global_injector.check("storage.fsync")
    if global_storage.match("fsync", path) is not None:
        raise DiskFault(errno.EIO, "injected: fsync failed", path)
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return   # platform without directory fds
    try:
        os.fsync(fd)
    except OSError:
        pass     # some filesystems refuse dir fsync; rename is best-effort
    finally:
        os.close(fd)
    global_metrics.inc("storage_fsyncs")


def replace(src: str, dst: str) -> None:
    """Atomic rename through the seam — the crash-before/after-rename
    injection window of every publish."""
    global_injector.check("storage.rename")
    rule = global_storage.match("rename", dst)
    if rule is not None and rule.kind == CRASH_BEFORE_RENAME:
        raise DiskFault(errno.EIO, "injected: crash before rename", dst)
    try:
        os.replace(src, dst)
    except OSError as e:
        _enospc_seen(e)
        raise
    if rule is not None:   # CRASH_AFTER_RENAME
        raise DiskFault(errno.EIO, "injected: crash after rename", dst)


# ---------------------------------------------------------------------------
# atomic publish
# ---------------------------------------------------------------------------

def atomic_write_bytes(path: str, data: bytes, fsync: bool = True,
                       dirsync: bool = True) -> None:
    """The crash-consistent single-file publish: unique temp → write →
    fsync file → atomic rename → fsync dir. At every instant ``path``
    holds either the old complete content or the new complete content;
    with ``fsync`` the new content survives power loss once this
    returns."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        write_bytes(tmp, data)
        if fsync:
            fsync_path(tmp)
        replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    if fsync and dirsync:
        fsync_dir(d)


def _envelope(obj) -> bytes:
    body = json.dumps(obj, separators=(",", ":"), sort_keys=True)
    return json.dumps({"crc": zlib.crc32(body.encode("utf-8")),
                       "payload": obj},
                      separators=(",", ":"), sort_keys=True).encode()


def atomic_write_json(path: str, obj, fsync: bool = True) -> None:
    """Atomic, *checksummed* JSON publish: the payload is wrapped in a
    CRC32 envelope so bit rot is detected at read time instead of being
    silently parsed (a flipped digit in an epoch or an offset is valid
    JSON with wrong meaning)."""
    atomic_write_bytes(path, _envelope(obj), fsync=fsync)


def read_json(path: str):
    """Read a JSON file written by :func:`atomic_write_json`, verifying
    its CRC envelope (:class:`StorageCorruption` on mismatch). Legacy
    files without an envelope are returned as-is — pre-seam sidecars
    stay readable across the upgrade."""
    raw = read_bytes(path)
    obj = json.loads(raw.decode("utf-8"))
    if isinstance(obj, dict) and set(obj) == {"crc", "payload"}:
        body = json.dumps(obj["payload"], separators=(",", ":"),
                          sort_keys=True)
        if zlib.crc32(body.encode("utf-8")) != obj["crc"]:
            global_metrics.inc("storage_corruptions_detected")
            raise StorageCorruption(f"CRC mismatch in {path}")
        return obj["payload"]
    return obj


# ---------------------------------------------------------------------------
# directory manifests + versioned publish
# ---------------------------------------------------------------------------

def write_manifest(dirpath: str, fsync: bool = True) -> dict:
    """Write ``MANIFEST.json`` covering every regular file in
    ``dirpath`` (CRC32 + size each). The manifest itself is a
    checksummed atomic JSON file; together with :func:`publish_dir`
    this makes a version directory self-verifying."""
    files: dict[str, dict] = {}
    for name in sorted(os.listdir(dirpath)):
        full = os.path.join(dirpath, name)
        if name == MANIFEST_NAME or not os.path.isfile(full):
            continue
        files[name] = {"crc": file_crc(full),
                       "size": os.path.getsize(full)}
    manifest = {"files": files}
    atomic_write_json(os.path.join(dirpath, MANIFEST_NAME), manifest,
                      fsync=fsync)
    return manifest


def verify_manifest(dirpath: str) -> list[str]:
    """Integrity-check a version directory against its manifest.
    Returns a list of human-readable problems — empty means intact.
    A missing or unreadable manifest is itself a problem: an
    unverifiable checkpoint must never be silently trusted."""
    mpath = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(mpath):
        return [f"manifest missing: {mpath}"]
    try:
        manifest = read_json(mpath)
    except (ValueError, OSError) as e:
        return [f"manifest unreadable: {e!r}"]
    files = manifest.get("files")
    if not isinstance(files, dict):
        return ["manifest malformed: no files map"]
    problems: list[str] = []
    for name, want in sorted(files.items()):
        full = os.path.join(dirpath, name)
        if not os.path.isfile(full):
            problems.append(f"{name}: missing")
            continue
        size = os.path.getsize(full)
        if size != want.get("size"):
            problems.append(f"{name}: size {size} != "
                            f"{want.get('size')} (truncated?)")
        elif file_crc(full) != want.get("crc"):
            problems.append(f"{name}: CRC mismatch (bit rot?)")
    if problems:
        global_metrics.inc("storage_corruptions_detected")
    return problems


def publish_dir(build_dir: str, final_dir: str) -> None:
    """Atomically publish a fully-built directory under its final
    versioned name: fsync every file, fsync the build dir, rename, and
    fsync the parent. A crash anywhere leaves either no ``final_dir``
    at all or a complete one — the newest version can never be the
    torn one."""
    for name in sorted(os.listdir(build_dir)):
        full = os.path.join(build_dir, name)
        if os.path.isfile(full):
            fsync_path(full)
    fsync_dir(build_dir)
    if os.path.exists(final_dir):
        import shutil
        shutil.rmtree(final_dir)   # stale remnant of a failed publish
    replace(build_dir, final_dir)
    fsync_dir(os.path.dirname(os.path.abspath(final_dir)) or ".")


def file_crc(path: str) -> int:
    """Incremental CRC32 of a file's current bytes, chunked so a
    GB-scale checkpoint array never materializes in memory (zlib.crc32
    is streaming). Still a read-seam site: an armed bit-rot rule flips
    a byte in the stream exactly as on real hardware, where the
    scrubber reads the same rotting platter."""
    global_injector.check("storage.read")
    rule = global_storage.match("read", path)
    crc = 0
    first = True
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            if rule is not None and first:
                i = rule.keep_bytes % len(chunk)
                chunk = chunk[:i] + bytes([chunk[i] ^ 0x5A]) \
                    + chunk[i + 1:]
            first = False
            crc = zlib.crc32(chunk, crc)
    return crc


# ---------------------------------------------------------------------------
# group commit
# ---------------------------------------------------------------------------

class GroupCommitter:
    """Cross-thread group commit of fsyncs — the fsync-before-ack
    upload contract without one fsync convoy per request.

    ``sync(paths)`` blocks until every path in ``paths`` has been
    fsynced by SOME flush round that started after the call. Concurrent
    callers coalesce: the first becomes the flusher and drains the
    queue (deduplicating paths — N uploads into one directory cost one
    dir fsync per round, not N); later arrivals wait on their round's
    event. The discipline is the WAL's fsync-before-ack applied to raw
    document bytes, batched the way the query coalescer batches
    scoring."""

    # fan-out width for one flush round: os.fsync releases the GIL and
    # the kernel can retire journal flushes for independent files
    # concurrently, so a wide round is bounded by the slowest flush,
    # not the sum
    _FANOUT = 8

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._pending: list[tuple[list[str], threading.Event,
                                  list[BaseException]]] = []
        self._flushing = False
        self._pool = None   # lazy: most processes never group-commit

    def sync(self, paths: list[str]) -> None:
        if not self.enabled or not paths:
            return
        ev = threading.Event()
        errs: list[BaseException] = []
        with self._lock:
            self._pending.append((list(paths), ev, errs))
            if self._flushing:
                flusher = False
            else:
                self._flushing = True
                flusher = True
        if flusher:
            self._flush_rounds()
        # bounded-slice wait + takeover (graftcheck indefinite-wait
        # audit): if the current flusher thread dies abnormally before
        # draining this entry, the waiter becomes the flusher itself —
        # a commit can be slow (the disk), never wedged forever
        while not ev.wait(timeout=0.5):
            takeover = False
            with self._lock:
                if not self._flushing and not ev.is_set():
                    self._flushing = True
                    takeover = True
            if takeover:
                self._flush_rounds()
        if errs:
            raise errs[0]

    def _flush_rounds(self) -> None:
        try:
            self._flush_rounds_inner()
        except BaseException:
            # an abnormal escape (per-path errors are already caught)
            # must not leave _flushing latched — waiters take over
            with self._lock:
                self._flushing = False
            raise

    def _flush_rounds_inner(self) -> None:
        while True:
            with self._lock:
                batch = self._pending
                self._pending = []
                if not batch:
                    self._flushing = False
                    return
            try:
                self._flush_one_round(batch)
            except BaseException as e:
                # a popped batch's waiters are unreachable by the
                # takeover loop (they left _pending) — fail them loudly
                # before re-raising, or their sync() calls spin forever
                err = e if isinstance(e, Exception) \
                    else RuntimeError(f"group commit died: {e!r}")
                for _paths, ev, errs in batch:
                    if not ev.is_set():
                        errs.append(err)
                        ev.set()
                raise

    def _flush_one_round(self, batch) -> None:
        unique: dict[str, BaseException | None] = {}
        for paths, _ev, _errs in batch:
            for p in paths:
                unique.setdefault(p, None)

        def flush_one(p: str) -> None:
            try:
                if os.path.isdir(p):
                    fsync_dir(p)
                else:
                    fsync_path(p)
            except Exception as e:   # noqa: BLE001 — per-path verdict
                _enospc_seen(e)
                unique[p] = e

        if len(unique) > 1:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor
                self._pool = ThreadPoolExecutor(
                    max_workers=self._FANOUT,
                    thread_name_prefix="group-commit")
            list(self._pool.map(flush_one, unique))
        else:
            for p in unique:
                flush_one(p)
        global_metrics.inc("storage_group_commits")
        global_metrics.inc("storage_group_commit_items", len(batch))
        for paths, ev, errs in batch:
            for p in paths:
                e = unique.get(p)
                if e is not None:
                    errs.append(e)
            ev.set()


# Process-wide committer shared by every engine/node in the process —
# exactly the sharing that makes group commit pay: concurrent upload
# handler threads (even across in-process test nodes) coalesce.
global_committer = GroupCommitter()


# ---------------------------------------------------------------------------
# CRC ledger (integrity-scrub reference)
# ---------------------------------------------------------------------------

class CrcLedger:
    """name → CRC32 of a raw-document store, persisted as a checksummed
    atomic JSON file. The integrity scrub verifies the store's current
    bytes against this record — without an independent record, bit rot
    in a stored document is undetectable (the bytes are their own only
    witness). Flushes are debounced by the caller (the sweep loop);
    entries recorded after the last flush are simply unverifiable until
    the next one, which the scrub skips rather than guesses about."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._lock = threading.Lock()
        self._dirty = False
        self._map: dict[str, int] = {}
        try:
            if os.path.exists(path):
                got = read_json(path)
                if isinstance(got, dict):
                    self._map = {str(k): int(v) for k, v in got.items()}
        except (ValueError, OSError) as e:
            # an unreadable ledger means nothing can be verified until
            # re-recorded — loud, never fatal (the store itself is fine)
            log.warning("crc ledger unreadable; starting empty",
                        path=path, err=repr(e))

    def record(self, name: str, crc: int) -> None:
        with self._lock:
            self._map[name] = crc
            self._dirty = True

    def forget(self, name: str) -> None:
        with self._lock:
            if self._map.pop(name, None) is not None:
                self._dirty = True

    def get(self, name: str) -> int | None:
        with self._lock:
            return self._map.get(name)

    def names(self) -> list[str]:
        with self._lock:
            return list(self._map)

    def flush(self, fsync: bool = True) -> bool:
        with self._lock:
            if not self._dirty:
                return False
            snapshot = dict(self._map)
            self._dirty = False
        try:
            atomic_write_json(self._path, snapshot, fsync=fsync)
        except OSError as e:
            with self._lock:
                self._dirty = True   # retry at the next flush
            log.warning("crc ledger flush failed", err=repr(e))
            return False
        return True


# ---------------------------------------------------------------------------
# traffic capture — the replayable request log
# ---------------------------------------------------------------------------

class RequestLog:
    """Durable, replayable capture of front-door search traffic: one
    record per ADMITTED ``/leader/start`` request — query text, arrival
    offset (monotonic seconds since the log opened), admission lane,
    and client id — so perf claims can replay production-shaped
    traffic instead of synthetic zipf (``bench.py --replay``).

    Framing is the WAL's discipline applied to capture: each record is
    one ``<crc32-hex> <compact-json>\\n`` line over an append handle
    held by this class (the capture log IS the seam for its own
    CRC-framed lines, the ``cluster/wal.py`` precedent — pinned in the
    graftcheck storageseam allowlist), and :meth:`read` stops at the
    first frame whose CRC fails, so a torn tail (or injected bit rot —
    reads go through :func:`read_bytes`) truncates cleanly instead of
    replaying a damaged query. Appends are buffered with a periodic
    flush; :meth:`flush`/:meth:`close` drive the buffered tail through
    the same fsync fault point the rest of the seam uses. Capture is an
    observability artifact, not acked state — flush-on-close is the
    durability contract, not fsync-before-ack."""

    _FLUSH_EVERY = 256

    def __init__(self, path: str, max_entries: int = 100000) -> None:
        self._path = path
        self._lock = threading.Lock()
        self._max = max(0, int(max_entries))
        self._count = 0
        self._t0 = time.monotonic()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "ab")

    @property
    def path(self) -> str:
        return self._path

    def record(self, query: str, lane: str, client: str = "") -> bool:
        """Append one admitted request; False once the entry bound is
        reached (bounded like the trace ring) or the log is closed."""
        line = json.dumps(
            {"t": round(time.monotonic() - self._t0, 6),
             "query": query, "lane": lane, "client": client},
            separators=(",", ":")).encode("utf-8")
        framed = b"%08x %s\n" % (zlib.crc32(line) & 0xFFFFFFFF, line)
        with self._lock:
            if self._f is None or self._count >= self._max:
                return False
            self._count += 1
            try:
                self._f.write(framed)
                if self._count % self._FLUSH_EVERY == 0:
                    self._f.flush()
            except OSError as e:
                _enospc_seen(e)
                log.warning("request-log append failed", err=repr(e))
                return False
        global_metrics.inc("capture_records")
        return True

    def flush(self, fsync: bool = True) -> None:
        """Drive the buffered tail to disk (the fsync-EIO fault point,
        like every seam fsync)."""
        with self._lock:
            if self._f is None:
                return
            self._f.flush()
            if fsync:
                global_injector.check("storage.fsync")
                if global_storage.match("fsync", self._path) is not None:
                    raise DiskFault(errno.EIO, "injected: fsync failed",
                                    self._path)
                os.fsync(self._f.fileno())
                global_metrics.inc("storage_fsyncs")

    def close(self) -> None:
        try:
            self.flush(fsync=True)
        except OSError as e:
            log.warning("request-log flush-on-close failed", err=repr(e))
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    @staticmethod
    def read(path: str) -> list[dict]:
        """Decode a captured log: every intact record in arrival order,
        truncated cleanly at the first frame whose CRC fails (torn
        tail / bit rot — reads go through the seam, so the disk
        nemesis can damage them and this contract is testable)."""
        out: list[dict] = []
        for line in read_bytes(path).splitlines():
            if not line.strip():
                continue
            try:
                crc_hex, payload = line.split(b" ", 1)
                if int(crc_hex, 16) != (zlib.crc32(payload) & 0xFFFFFFFF):
                    break
                out.append(json.loads(payload.decode("utf-8")))
            except ValueError:
                break
        return out
