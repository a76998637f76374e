"""Tiered postings: device-resident hot set, host/disk cold tier.

The counterpart of ``tfidf_tpu/engine/tiering.py``. Without tiering every
segment's blocked-ELL tensors live on the device forever. With it:

* **hot** — segments whose device tensors are resident, scored exactly as
  untiered (``ops/ell.score_segments_batch``), admitted and evicted LRU
  under a byte budget (steered by ``cluster/autopilot
  .TierBudgetController`` when the autopilot runs);
* **cold** — segments whose device tensors are dropped; their postings
  live in per-segment manifested ``.v<N>`` spill directories (build dir →
  fsync → atomic rename → MANIFEST.json), mmap-ed back through
  :func:`tfidf_tpu_torch.utils.storage.read_memmap`, so the host page
  cache IS the cold tier. Fault-in verifies the manifest first; a corrupt
  cold file is **quarantined** and re-spilled from the retained host
  postings (``Segment.host_docs``), so disk rot costs one extra layout
  pass, never a wrong result.

Cold segments come back through an **upload ring**: one upload worker
thread with a CUDA stream of its own, fed ``ring_depth`` segments ahead of
the scorer (``prefetch``). Each upload is staged from the mmap into pinned
memory, copied ``non_blocking`` on the ring's stream
(:func:`tfidf_tpu_torch.device.upload`), and closed by an event that the
segment's view carries (``SegmentView.ready``): the scoring stream waits
on that event on the device, not the host, so segment i+1's copy runs
behind segment i's scoring. The ring's tensors are marked as used by the
scoring stream, so an eviction while a search still reads them never
hands their memory to the next upload. On the CPU the ring makes plain
copies. The time the scorer blocks on a pending upload is the
``tier_ring_stall`` histogram.

Most cold segments are never faulted at all: the searcher consults each
segment's block-max bound (``ops/blockmax.py``) against the running top-k
threshold and skips segments that provably cannot contribute.

Budget accounting is SOFT: an in-flight search holds references to the
views it is scoring, so an eviction frees device memory only once those
searches drain — correctness never depends on the budget, only peak
memory does. The dense embedding column reports its device bytes as
``reserved`` (:meth:`TierManager.set_reserved`, wired by
``Engine.commit``).
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tfidf_tpu_torch.device import upload, zeros_on
from tfidf_tpu_torch.utils import storage
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("engine.tiering")

_META_NAME = "meta.json"


@dataclass
class ColdFiles:
    """One segment's published spill directory (manifested ``.v<N>``)."""
    dir: str
    meta: dict
    version: int


@dataclass
class ColdHandle:
    """A snapshot's reference to one cold segment.

    The live mask is a COPY taken under the write lock at commit time:
    tombstones after publish mutate ``Segment.live`` in place, and a
    search against this snapshot must keep seeing the commit-time mask."""
    seg: object              # engine.segments.Segment
    seg_index: int           # position in snapshot.segments
    base: int                # gid base offset (sum of earlier doc_caps)
    live_mask: np.ndarray    # f32 [doc_cap], captured at commit
    live_version: int
    bounds: object           # ops.blockmax.SegmentBounds
    view: object | None = field(default=None, repr=False)
    view_epoch: int = -1


class TierManager:
    """Residency policy + cold store + upload ring for one index.

    Locking: ``_lock`` guards residency state, LRU order, and byte
    accounting. Uploads run on the single ring worker; ``fault_in`` waits
    on the worker's future OUTSIDE the lock, so a slow disk never wedges
    concurrent searches of hot segments.
    """

    def __init__(self, cold_dir: str, budget_bytes: int,
                 *, ring_depth: int = 2, skip_margin: float = 1e-4,
                 autopilot_budget: bool = False) -> None:
        self.cold_dir = cold_dir
        self.budget_bytes = max(0, int(budget_bytes))
        self.ring_depth = max(1, int(ring_depth))
        self.skip_margin = float(skip_margin)
        # kill switch for the block-max cut (oracle/bench control: with
        # skipping off every cold segment is faulted and scored)
        self.skip_enabled = True
        self.autopilot_budget = autopilot_budget
        self._index = None            # bound SegmentedIndex
        self._stream = None           # the ring's CUDA stream (lazy)
        self._lock = threading.Lock()
        self._pool = None             # lazy single upload worker
        self._inflight: dict[int, object] = {}   # id(seg) -> Future
        self._seq = itertools.count(1)
        self._uids = itertools.count(1)
        self._resident: dict[int, object] = {}   # id(seg) -> seg (LRU)
        self.hot_bytes = 0
        self.reserved_bytes = 0
        self.hot_hits = 0
        self.cold_faults = 0
        self.skipped = 0
        self.considered = 0
        self.spills = 0
        self.evictions = 0
        self.quarantines = 0
        self.repairs = 0
        self.ring_stall_s = 0.0

    # ---- binding ----

    def bind(self, index) -> None:
        """Attach to the owning SegmentedIndex (layout, model, device)."""
        self._index = index

    def _worker(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="tier-upload")
        return self._pool

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    # ---- residency accounting ----

    def admit(self, seg) -> None:
        """Account a freshly-built (device-resident) segment and evict LRU
        segments if the budget is now exceeded. Called under the index
        write lock at commit/splice; takes only the tier lock."""
        with self._lock:
            if seg.tier_uid == 0:
                seg.tier_uid = next(self._uids)
            if seg.resident and id(seg) not in self._resident:
                self._resident[id(seg)] = seg
                self.hot_bytes += seg.device_bytes
            seg.tier_seq = next(self._seq)
            self._rebalance_locked(protect=seg)
            self._publish_gauges_locked()

    def discard(self, seg) -> None:
        """A segment left the index (merge splice): drop accounting and
        its spill files. Old snapshots may still hold handles to it —
        their fault-ins take the re-spill path, which works from the
        retained host postings."""
        with self._lock:
            if self._resident.pop(id(seg), None) is not None:
                self.hot_bytes -= seg.device_bytes
            files, seg.cold = seg.cold, None
            self._publish_gauges_locked()
        if files is not None:
            import shutil
            shutil.rmtree(files.dir, ignore_errors=True)

    def rebalance(self) -> None:
        with self._lock:
            self._rebalance_locked()
            self._publish_gauges_locked()

    def set_budget(self, budget_bytes: int) -> None:
        with self._lock:
            self.budget_bytes = max(0, int(budget_bytes))
            self._rebalance_locked()
            self._publish_gauges_locked()

    def set_reserved(self, reserved_bytes: int) -> None:
        """Bytes pinned on the device by OTHER planes (the dense embedding
        column) — carved out of the hot budget."""
        with self._lock:
            self.reserved_bytes = max(0, int(reserved_bytes))
            self._rebalance_locked()
            self._publish_gauges_locked()

    def touch_hot(self, segs) -> None:
        """A chunk scored these resident segments (the hot fast path)."""
        n = 0
        with self._lock:
            for seg in segs:
                seg.tier_seq = next(self._seq)
                n += 1
            self.hot_hits += n
        if n:
            global_metrics.inc("tier_hot_hits", n)

    def note_skips(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.skipped += n
        global_metrics.inc("tier_segments_skipped", n)

    def note_considered(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.considered += n

    def _rebalance_locked(self, protect=None) -> None:
        """Evict LRU resident segments until hot + reserved fits the
        budget. ``protect`` (the segment just admitted/faulted) is never
        evicted. Budget 0 means NO steady-state hot set."""
        evicted = 0
        while self.hot_bytes + self.reserved_bytes > self.budget_bytes:
            victim = None
            for seg in sorted(self._resident.values(),
                              key=lambda s: s.tier_seq):
                if seg is protect:
                    continue
                victim = seg
                break
            if victim is None:
                break
            self._evict_locked(victim)
            evicted += 1
        if evicted:
            log.info("tier rebalance evicted segments", evicted=evicted,
                     hot_bytes=self.hot_bytes,
                     budget_bytes=self.budget_bytes)

    def _evict_locked(self, seg) -> None:
        self._spill(seg)   # durable copy must exist before tensors drop
        self._resident.pop(id(seg), None)
        self.hot_bytes -= seg.device_bytes
        seg.tfs = None
        seg.terms = None
        seg.dls = None
        seg.norms0 = None
        seg.res_tf = None
        seg.res_term = None
        seg.res_doc = None
        seg.doc_len_d = None
        seg.res_plan = None
        seg.ready = None
        seg.view_cache = None     # holds device refs: must die with them
        seg.resident = False
        seg.res_epoch += 1        # invalidates every ColdHandle view
        self.evictions += 1
        global_metrics.inc("tier_evictions")

    def _publish_gauges_locked(self) -> None:
        global_metrics.set_gauge("tier_hot_segments",
                                 len(self._resident))
        n_seg = (len(self._index._segments)
                 if self._index is not None else 0)
        global_metrics.set_gauge(
            "tier_cold_segments", max(0, n_seg - len(self._resident)))
        global_metrics.set_gauge("tier_hot_bytes", self.hot_bytes)
        global_metrics.set_gauge("tier_budget_bytes", self.budget_bytes)
        global_metrics.set_gauge("tier_reserved_bytes",
                                 self.reserved_bytes)

    # ---- cold store (spill / verify / repair) ----

    def _seg_dir(self, seg, version: int) -> str:
        return os.path.join(self.cold_dir,
                            f"seg{seg.tier_uid:08d}.v{version}")

    def _spill(self, seg) -> ColdFiles:
        """Write the segment's postings layout as a manifested spill dir
        (idempotent: postings are immutable after build, so one spill per
        segment lifetime — re-spill only on quarantine)."""
        if seg.cold is not None:
            return seg.cold
        if seg.tier_uid == 0:
            seg.tier_uid = next(self._uids)
        version = 1
        t0 = time.perf_counter()
        # deterministic re-layout of the retained host postings: host_docs
        # is stored width-sorted, so _layout_host reproduces the exact
        # block structure the device tensors were built from
        ell, _df, _raw, _dl, doc_cap, _nnz = self._index._layout_host(
            seg.host_docs, len(seg.df))
        if doc_cap != seg.doc_cap or \
                tuple(b.tf.shape[0] for b in ell.blocks) \
                != tuple(seg.block_caps):
            raise RuntimeError("tier spill: layout drift vs built segment")
        final = self._seg_dir(seg, version)
        build = f"{final}.build.{os.getpid()}"
        os.makedirs(build, exist_ok=True)
        blocks_meta = []
        for j, blk in enumerate(ell.blocks):
            storage.write_bytes(os.path.join(build, f"b{j}_tf.bin"),
                                np.ascontiguousarray(blk.tf).tobytes())
            storage.write_bytes(os.path.join(build, f"b{j}_term.bin"),
                                np.ascontiguousarray(blk.term).tobytes())
            blocks_meta.append({"rows_cap": int(blk.tf.shape[0]),
                                "width": int(blk.tf.shape[1]),
                                "n_rows": int(blk.n_rows)})
        res_cap = 0
        if ell.res_nnz:
            res_cap = int(ell.res_tf.shape[0])
            storage.write_bytes(os.path.join(build, "res_tf.bin"),
                                np.ascontiguousarray(ell.res_tf).tobytes())
            storage.write_bytes(os.path.join(build, "res_term.bin"),
                                np.ascontiguousarray(
                                    ell.res_term).tobytes())
            storage.write_bytes(os.path.join(build, "res_doc.bin"),
                                np.ascontiguousarray(
                                    ell.res_doc).tobytes())
        meta = {"doc_cap": int(seg.doc_cap), "blocks": blocks_meta,
                "res_nnz": int(ell.res_nnz), "res_cap": res_cap,
                "version": version}
        storage.atomic_write_json(os.path.join(build, _META_NAME), meta,
                                  fsync=False)
        storage.write_manifest(build, fsync=False)
        storage.publish_dir(build, final)
        seg.cold = ColdFiles(dir=final, meta=meta, version=version)
        self.spills += 1
        global_metrics.inc("tier_spills")
        global_metrics.observe("tier_spill", time.perf_counter() - t0)
        return seg.cold

    def _respill(self, seg) -> ColdFiles:
        """Quarantine + repair: the published spill failed its manifest
        check. Move it aside, rebuild from the retained host postings,
        publish under the next ``.v<N>``."""
        bad = seg.cold
        seg.cold = None
        version = (bad.version + 1) if bad is not None else 1
        if bad is not None and os.path.exists(bad.dir):
            try:
                storage.replace(bad.dir, bad.dir + ".quarantine")
            except OSError:
                pass
        self.quarantines += 1
        global_metrics.inc("tier_quarantines")
        files = self._spill(seg)
        # _spill starts at v1; force the bumped version dir name so the
        # quarantined dir and the repaired one never collide
        if files.version != version:
            newdir = self._seg_dir(seg, version)
            storage.replace(files.dir, newdir)
            files = ColdFiles(dir=newdir, meta=files.meta,
                              version=version)
            seg.cold = files
        self.repairs += 1
        global_metrics.inc("tier_repairs")
        log.warning("cold segment quarantined and re-spilled",
                    segment=seg.tier_uid, version=version)
        return files

    # ---- fault-in (upload ring) ----

    def _ring_stream(self, dev: torch.device):
        if dev.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        return self._stream

    def _build_device(self, seg) -> dict:
        """Runs on the ring worker: verify the spill's manifest (repair if
        rotten), mmap the arrays and upload them on the ring's stream.
        Returns the tensor bundle with the event that closes the uploads;
        installation happens under the tier lock in :meth:`fault_in`."""
        from tfidf_tpu_torch.engine.index import RES_CHUNK
        from tfidf_tpu_torch.ops.scoring import segment_plan
        from tfidf_tpu_torch.utils.device_nemesis import device_guard

        # the upload-ring nemesis seam: an injected fault here models a
        # host->device transfer failing; it surfaces to the searcher as
        # the ring future's exception, i.e. a compute fault mid-query
        device_guard("upload")
        files = seg.cold if seg.cold is not None else self._spill(seg)
        problems = storage.verify_manifest(files.dir)
        if problems:
            log.warning("cold segment failed integrity check",
                        segment=seg.tier_uid, problems=problems[:3])
            files = self._respill(seg)
            problems = storage.verify_manifest(files.dir)
            if problems:
                raise storage.StorageCorruption(
                    f"cold segment {seg.tier_uid} unrepairable: "
                    f"{problems[:3]}")
        dev = self._index.device
        stream = self._ring_stream(dev)
        meta = files.meta
        n = seg.n_docs
        doc_len = np.zeros(seg.doc_cap, np.float32)
        if n:
            doc_len[:n] = self._index.model.transform_doc_len(
                np.asarray(seg.raw_len, np.float32))
        tfs, terms, dls, norms0 = [], [], [], []
        row0 = 0
        for j, bm in enumerate(meta["blocks"]):
            shape = (bm["rows_cap"], bm["width"])
            tf = storage.read_memmap(
                os.path.join(files.dir, f"b{j}_tf.bin"),
                np.float32, shape)
            term = storage.read_memmap(
                os.path.join(files.dir, f"b{j}_term.bin"),
                np.int32, shape)
            nr = bm["n_rows"]
            dl_blk = np.zeros(bm["rows_cap"], np.float32)
            dl_blk[:nr] = doc_len[row0:row0 + nr]
            tfs.append(upload(tf, dev, stream))
            terms.append(upload(term, dev, stream))
            dls.append(upload(dl_blk, dev, stream))
            norms0.append(zeros_on(bm["rows_cap"], dev, stream))
            row0 += nr
        out = {"tfs": tuple(tfs), "terms": tuple(terms),
               "dls": tuple(dls), "norms0": tuple(norms0),
               "res_tf": None, "res_term": None, "res_doc": None,
               "doc_len_d": None, "res_plan": None, "ready": None}
        if meta["res_nnz"]:
            cap = (meta["res_cap"],)
            res_doc = storage.read_memmap(
                os.path.join(files.dir, "res_doc.bin"), np.int32, cap)
            out["res_tf"] = upload(storage.read_memmap(
                os.path.join(files.dir, "res_tf.bin"), np.float32, cap),
                dev, stream)
            out["res_term"] = upload(storage.read_memmap(
                os.path.join(files.dir, "res_term.bin"), np.int32, cap),
                dev, stream)
            out["res_doc"] = upload(res_doc, dev, stream)
            out["doc_len_d"] = upload(doc_len, dev, stream)
            out["res_plan"] = segment_plan(
                np.asarray(res_doc), meta["res_nnz"],
                min(RES_CHUNK, meta["res_cap"]), dev)
        if stream is not None:
            out["ready"] = torch.cuda.Event()
            out["ready"].record(stream)
        return out

    def prefetch(self, seg) -> None:
        """Ring prefetch: start the upload for a segment the searcher
        expects to need soon. No-op if resident or already in flight."""
        with self._lock:
            if seg.resident or id(seg) in self._inflight:
                return
            self._inflight[id(seg)] = self._worker().submit(
                self._build_device, seg)

    def fault_in(self, seg) -> None:
        """Make ``seg`` resident, blocking until its upload is ENQUEUED
        (the device-side wait is the view's ``ready`` event). The blocked
        time is the ring stall — zero when prefetch already finished."""
        with self._lock:
            if seg.resident:
                seg.tier_seq = next(self._seq)
                self.hot_hits += 1
                global_metrics.inc("tier_hot_hits")
                return
            fut = self._inflight.get(id(seg))
            if fut is None:
                fut = self._worker().submit(self._build_device, seg)
                self._inflight[id(seg)] = fut
        t0 = time.perf_counter()
        try:
            arrays = fut.result()
        finally:
            with self._lock:
                self._inflight.pop(id(seg), None)
        stall = time.perf_counter() - t0
        with self._lock:
            self.ring_stall_s += stall
            if not seg.resident:
                seg.tfs = arrays["tfs"]
                seg.terms = arrays["terms"]
                seg.dls = arrays["dls"]
                seg.norms0 = arrays["norms0"]
                seg.res_tf = arrays["res_tf"]
                seg.res_term = arrays["res_term"]
                seg.res_doc = arrays["res_doc"]
                seg.doc_len_d = arrays["doc_len_d"]
                seg.res_plan = arrays["res_plan"]
                seg.ready = arrays["ready"]
                seg.resident = True
                self._resident[id(seg)] = seg
                self.hot_bytes += seg.device_bytes
                seg.tier_seq = next(self._seq)
                self.cold_faults += 1
                global_metrics.inc("tier_cold_faults")
                self._rebalance_locked(protect=seg)
                self._publish_gauges_locked()
            else:
                seg.tier_seq = next(self._seq)
                self.hot_hits += 1
                global_metrics.inc("tier_hot_hits")
        global_metrics.observe("tier_ring_stall", stall)

    def handle_view(self, handle: ColdHandle):
        """Scoring view for a cold handle: fault the segment in and bind
        the snapshot's CAPTURED live mask (snapshot isolation — the
        segment's own mask may have moved since commit)."""
        from tfidf_tpu_torch.ops.ell import SegmentView

        for _ in range(64):
            self.fault_in(handle.seg)
            with self._lock:
                seg = handle.seg
                if not seg.resident:
                    continue   # raced an eviction: fault again
                if handle.view is not None \
                        and handle.view_epoch == seg.res_epoch:
                    return handle.view
                refs = (seg.tfs, seg.terms, seg.dls, seg.norms0,
                        seg.block_rows, seg.res_tf, seg.res_term,
                        seg.res_doc, seg.doc_len_d, seg.res_plan,
                        seg.ready, seg.res_epoch)
            tfs, terms, dls, norms0, block_rows, res_tf, res_term, \
                res_doc, doc_len_d, res_plan, ready, epoch = refs
            res = None
            if res_tf is not None:
                res = (res_tf, res_term, res_doc, doc_len_d, None,
                       res_plan)
            view = SegmentView(
                tfs=tfs, terms=terms, dls=dls, norms=norms0,
                block_live=block_rows,
                live_mask=upload(handle.live_mask, self._index.device),
                res=res, ready=ready)
            with self._lock:
                handle.view = view
                handle.view_epoch = epoch
            return view
        raise RuntimeError("tier fault-in livelock (eviction storm)")

    def all_views(self, snap) -> tuple:
        """Views for EVERY segment of a snapshot in segment order — the
        unbounded-search / parity-oracle path (faults in the whole cold
        tier; budget overshoots until the next rebalance)."""
        by_index = {i: view for i, _base, view in snap.hot}
        for handle in snap.cold:
            by_index[handle.seg_index] = self.handle_view(handle)
        return tuple(by_index[i] for i in range(len(snap.segments)))

    # ---- observability ----

    def stats(self) -> dict:
        with self._lock:
            n_seg = (len(self._index._segments)
                     if self._index is not None else 0)
            consults = self.hot_hits + self.cold_faults + self.skipped
            return {
                "enabled": True,
                "hot_segments": len(self._resident),
                "cold_segments": max(0, n_seg - len(self._resident)),
                "hot_bytes": int(self.hot_bytes),
                "budget_bytes": int(self.budget_bytes),
                "reserved_bytes": int(self.reserved_bytes),
                "hot_hits": int(self.hot_hits),
                "cold_faults": int(self.cold_faults),
                "segments_skipped": int(self.skipped),
                "skip_rate": (self.skipped / consults
                              if consults else 0.0),
                "hit_rate": ((self.hot_hits
                              / (self.hot_hits + self.cold_faults))
                             if (self.hot_hits + self.cold_faults)
                             else 1.0),
                "spills": int(self.spills),
                "evictions": int(self.evictions),
                "quarantines": int(self.quarantines),
                "repairs": int(self.repairs),
                "ring_stall_s": float(self.ring_stall_s),
            }
