"""Streaming segment index — Lucene's segment model, on a torch device.

The counterpart of ``tfidf_tpu/engine/segments.py``. The rebuild-style
:class:`~tfidf_tpu_torch.engine.index.ShardIndex` re-lays-out the whole
corpus on every commit — O(corpus) per commit for streaming ingest
(BASELINE config 4, MS MARCO passages). Here:

* a **Segment** is an immutable blocked-ELL slice of the corpus built once
  from the docs added since the previous commit — commit cost is O(new);
  documents wider than ``ell_width_cap`` spill their extra postings into a
  per-segment COO residual;
* **deletes/upserts** tombstone the old doc in its segment without touching
  its postings (Lucene's deleted-docs bitmap); a tombstoned doc still
  counts in df until merge. The device live mask is owned by the published
  *snapshot*, not the shared Segment, so searches against an old snapshot
  never observe later deletes;
* **merging** is tiered (Lucene TieredMergePolicy shape): when the segment
  count exceeds ``max_segments``, the SMALLEST similar-sized segments merge
  into one. Small merges run inline on commit; merges above
  ``sync_merge_nnz`` run on background threads and splice in under the
  write lock (deletes/upserts that raced the merge are re-applied at swap
  time);
* queries score EVERY segment with the **current** global statistics (df
  summed over segments, doc count, avgdl) — weights are computed per query
  batch (:func:`tfidf_tpu_torch.ops.ell.score_segment_ell`). For
  ``tfidf_cosine`` the per-document norms depend on the moving global df,
  so they are recomputed at commit from the retained host postings.

Device seams (the JAX package's ``jnp.asarray`` uploads): a commit and an
inline merge upload on the current stream; a background merge uploads on
a CUDA stream of its own (:func:`tfidf_tpu_torch.device.upload`) and
records an event after its last upload, which the merged segment carries
into every view (``SegmentView.ready``) and scoring waits on. Nothing
writes into a tensor a published snapshot holds: live masks, cosine norms
and the df are new tensors each commit (the df through the out-of-place
:class:`~tfidf_tpu_torch.ops.dfdelta.DfDeltaApplier`).

Global doc ids are (segment base + local id); the searcher maps ids back
to names via each segment's name table.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tfidf_tpu_torch.device import resolve_device, upload, zeros_on
from tfidf_tpu_torch.engine.index import (RES_CHUNK, DocEntry,
                                          check_sorted_unique_ids,
                                          entries_from_packed)
from tfidf_tpu_torch.models.base import ScoringModel
from tfidf_tpu_torch.ops.blockmax import bounds_from_entries
from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.dfdelta import DfDeltaApplier
from tfidf_tpu_torch.ops.ell import SegmentView, build_ell_from_coo
from tfidf_tpu_torch.ops.scoring import segment_plan
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("engine.segments")


@dataclass
class Segment:
    """Immutable device-resident postings for one commit's new docs."""
    tfs: tuple            # tuple of f32 [rows_cap_i, width_i]
    terms: tuple          # tuple of i32 [rows_cap_i, width_i]
    dls: tuple            # tuple of f32 [rows_cap_i] (model-transformed)
    norms0: tuple         # tuple of f32 [rows_cap_i] zeros (non-cosine)
    block_rows: tuple     # host n_rows per block
    block_caps: tuple     # host rows_cap per block
    doc_cap: int
    names: list[str]      # local id -> name
    df: np.ndarray        # f32 [vocab_cap_at_build] — segment's df (host)
    raw_len: np.ndarray   # f32 [n_docs] — analyzed lengths (host)
    host_docs: list[DocEntry]   # source postings (compaction + checkpoint)
    # COO residual for rows wider than ell_width_cap (None: no spill)
    res_tf: torch.Tensor | None
    res_term: torch.Tensor | None
    res_doc: torch.Tensor | None
    doc_len_d: torch.Tensor | None  # f32 [doc_cap] transformed (residual)
    res_plan: list | None = None    # the residual's segment_plan (host)
    # event recorded after a side-stream upload (None: current stream)
    ready: object = None
    nnz_total: int = 0    # host postings entries (merge-tier sizing)
    live: np.ndarray = field(default=None)  # bool [n_docs] host mirror
    # sparse mirror of ``df``: the O(segment nnz) currency of the
    # incremental global-stats path
    df_ids: np.ndarray = field(default=None)     # i64 [n_distinct]
    df_counts: np.ndarray = field(default=None)  # f32 [n_distinct]
    # bumped on every tombstone: keys the per-segment view cache so an
    # untouched segment's view (and its device live mask) is reused
    live_version: int = 0
    view_cache: tuple | None = None   # (live_version, SegmentView)
    # ---- tiering (engine/tiering.py) — inert without a TierManager ----
    bounds: object | None = None  # blockmax.SegmentBounds (skip proofs)
    cold: object | None = None    # tiering.ColdFiles once spilled
    resident: bool = True         # device tensors present
    device_bytes: int = 0         # device footprint when resident
    res_epoch: int = 0            # bumped on evict: invalidates views
    tier_uid: int = 0             # spill-dir naming
    tier_seq: int = 0             # LRU clock

    @property
    def n_docs(self) -> int:
        return len(self.names)

    def sparse_df(self) -> tuple[np.ndarray, np.ndarray]:
        """(nonzero term ids, counts) — computed once per segment
        build/restore and cached."""
        if self.df_ids is None:
            ids = np.nonzero(self.df)[0].astype(np.int64)
            self.df_ids = ids
            self.df_counts = self.df[ids].astype(np.float32)
        return self.df_ids, self.df_counts


class _PaddedNameResolver:
    """gid -> name over the concatenated padded segment spaces — the ONE
    implementation of padded-id resolution (``name_of`` delegates here
    too, so search-hit assembly cannot drift from it)."""

    __slots__ = ("_segments", "_bases")

    def __init__(self, segments: list[Segment]) -> None:
        self._segments = segments
        bases = [0]
        for seg in segments:
            bases.append(bases[-1] + seg.doc_cap)
        self._bases = bases

    def __len__(self) -> int:
        return self._bases[-1]

    def __getitem__(self, gid: int):
        # IndexError past the padded space keeps the sequence protocol
        # intact (iteration must terminate); in-range pad slots are None
        if gid < 0 or gid >= self._bases[-1]:
            raise IndexError(gid)
        i = bisect.bisect_right(self._bases, gid) - 1
        seg = self._segments[i]
        local = gid - self._bases[i]
        return seg.names[local] if local < seg.n_docs else None


@dataclass
class SegmentedSnapshot:
    """What queries score against: the committed segment list + stats.

    ``views`` are the scoring-ready tensors. Per-commit state (live masks,
    cosine norms) is IMMUTABLE once built: the version-keyed
    ``view_cache`` on a Segment only ever reuses a view whose mask is
    bit-identical, so an in-flight search against an older snapshot keeps
    its own masks, and nothing may mutate a mask in place.
    """
    segments: list[Segment]
    views: tuple          # tuple of SegmentView, aligned with segments
    df: torch.Tensor      # f32 [vocab_cap] — summed over segments
    n_docs: torch.Tensor  # f32 0-d — total docs incl. tombstones
    avgdl: torch.Tensor   # f32 0-d
    num_docs: int         # total doc caps (top-k masking)
    version: int = 0
    nnz: int = 0
    # ---- tiering: when ``tier`` is set, ``views`` is EMPTY and the
    # segment set is partitioned into ``hot`` (seg_index, gid base,
    # SegmentView) triples and ``cold`` ColdHandles ----
    hot: tuple = ()
    cold: tuple = ()
    tier: object | None = None
    # host mirrors of n_docs/avgdl: the tiered dispatch's bounds are host
    # arithmetic and must not read the device scalars
    n_docs_f: float | None = None
    avgdl_f: float | None = None

    def __post_init__(self) -> None:
        if self.n_docs_f is None:
            self.n_docs_f = float(self.n_docs)
        if self.avgdl_f is None:
            self.avgdl_f = float(self.avgdl)

    @property
    def num_names(self) -> int:
        return sum(seg.n_docs for seg in self.segments)

    @property
    def doc_names(self) -> list[str]:
        cached = getattr(self, "_doc_names", None)
        if cached is None:
            cached = []
            for seg in self.segments:
                cached.extend(seg.names)
            object.__setattr__(self, "_doc_names", cached)
        return cached

    @property
    def padded_names(self):
        """Name lookup in the concatenated padded doc-id space (None at pad
        slots): a lazy bisecting resolver, not a materialized list."""
        cached = getattr(self, "_padded_names", None)
        if cached is None:
            cached = _PaddedNameResolver(self.segments)
            object.__setattr__(self, "_padded_names", cached)
        return cached

    @property
    def bases(self) -> list[int]:
        bases, acc = [], 0
        for seg in self.segments:
            bases.append(acc)
            acc += seg.doc_cap
        return bases

    def name_of(self, gid: int) -> str | None:
        try:
            return self.padded_names[gid]
        except IndexError:
            return None

    @property
    def df_host(self) -> np.ndarray:
        """Host copy of the global df (bound evaluation reads a handful of
        entries per query batch; fetched once, cached)."""
        cached = getattr(self, "_df_host", None)
        if cached is None:
            cached = self.df.cpu().numpy()
            object.__setattr__(self, "_df_host", cached)
        return cached


def _stored_rows(data, i: int, raw_len: np.ndarray):
    """``row -> (term ids, tfs, length)`` read back from segment ``i`` of a
    ``segstate.npz`` payload: the row's entries of its ELL block (pads have
    tf 0) followed by its residual entries — the postings the stored
    layout was built from, in their order.

    A tombstoned row has no entry in docs.npz. The JAX package restores it
    with empty postings, which no longer reproduce the stored layout: its
    tier then cannot spill such a segment (``_layout_host`` refuses rows
    out of width order). Restoring the row's own postings keeps the host
    replica faithful — spills, re-exports and merges see the segment as
    it was built."""
    nb = int(data[f"s{i}_nb"])
    starts = np.cumsum([0] + [int(data[f"s{i}_b{j}_rows"])
                              for j in range(nb)])
    res_nnz = int(data[f"s{i}_res_nnz"])
    res_doc = data[f"s{i}_res_doc"][:res_nnz] if res_nnz else None

    def row(local: int):
        j = int(np.searchsorted(starts, local, side="right")) - 1
        tf = data[f"s{i}_b{j}_tf"][local - starts[j]]
        keep = tf != 0
        ids = [data[f"s{i}_b{j}_term"][local - starts[j]][keep]]
        tfs = [tf[keep]]
        if res_doc is not None:
            sel = res_doc == local
            ids.append(data[f"s{i}_res_term"][:res_nnz][sel])
            tfs.append(data[f"s{i}_res_tf"][:res_nnz][sel])
        return (np.concatenate(ids).astype(np.int32),
                np.concatenate(tfs).astype(np.float32),
                float(raw_len[local]))
    return row


class SegmentedIndex:
    """Streaming shard index with the same write API as ShardIndex."""

    def __init__(self, model: ScoringModel,
                 min_nnz_cap: int = 1 << 16,     # unused; API compat
                 min_doc_cap: int = 1024,
                 layout: str = "ell",            # segments are always ELL
                 ell_width_cap: int = 256,
                 max_segments: int = 8,
                 sync_merge_nnz: int = 1 << 20,
                 merge_upload_pace: float = 1.0,
                 merge_workers: int = 2,
                 incremental_stats: bool = True,
                 tier=None,
                 device=None) -> None:
        self.model = model
        self.device = resolve_device(device)
        # tiered residency (engine/tiering.py): None = everything stays
        # device-resident
        if tier is not None and model.needs_norms:
            # cosine norms depend on the moving global df: no sound
            # block-max bound and no df-independent cold layout exists
            raise ValueError("tiering is not supported for cosine models")
        self.tier = tier
        if tier is not None:
            tier.bind(self)
        self.min_doc_cap = min_doc_cap
        self.ell_width_cap = ell_width_cap
        self.max_segments = max_segments
        # merges whose combined postings exceed this run on a background
        # thread instead of the commit critical path
        self.sync_merge_nnz = sync_merge_nnz
        self.merge_workers = max(1, merge_workers)
        # background merges pace their uploads: each block's transfer is
        # awaited before the next is enqueued, and while a COMMIT runs the
        # merge also sleeps pace * (that block's upload time), so the
        # commit's small uploads get real gaps. Idle merges pay no sleep.
        # 0 disables pacing entirely.
        self.merge_upload_pace = merge_upload_pace
        self._merge_stream = (torch.cuda.Stream(self.device)
                              if self.device.type == "cuda" else None)
        self._commit_active = False   # racy hint read by the merge thread
        self._write_lock = threading.Lock()
        self._pending: list[DocEntry] = []
        self._segments: list[Segment] = []
        # name -> (Segment | None for pending, local idx); object refs, so
        # background merges can splice the segment list without rewriting
        # every entry
        self._where: dict[str, tuple[Segment | None, int]] = {}
        self._gen = 1
        self._committed_gen = 0
        self._version = 0
        self.snapshot: SegmentedSnapshot | None = None
        # up to ``merge_workers`` background merges over DISJOINT source
        # sets; their sources are excluded from selection
        self._merge_pool = None
        self._merge_jobs: dict[int, list[Segment]] = {}   # id(fut) -> srcs
        self._merge_futs: dict[int, object] = {}          # id(fut) -> fut
        # incremental live totals (moved only on mutation)
        self._nnz_live_stat = 0
        self._bytes_live_stat = 0
        # incremental GLOBAL stats (df/N/avgdl), maintained as deltas on
        # segment append/splice; totals INCLUDE tombstones until merge
        # (Lucene docFreq/docCount semantics). False = the full recompute
        # every commit (a control path, never the default).
        self.incremental_stats = incremental_stats
        self._df_total = np.zeros(0, np.float64)   # tombstone-inclusive
        self._count_total = 0
        self._len_total = 0.0
        self._live_total = 0
        self._df_delta = DfDeltaApplier()
        self._df_device = None        # committed [vocab_cap] device df
        # witness: commits that paid the full O(segments x vocab) stat
        # recompute (first commit / vocab growth / control path)
        self.df_full_recomputes = 0

    # ---- write path ----

    def add_document(self, name: str, id_counts: dict[int, int],
                     length: float | None = None) -> None:
        if id_counts:
            items = sorted(id_counts.items())
            ids = np.fromiter((t for t, _ in items), np.int32, len(items))
            tfs = np.fromiter((f for _, f in items), np.float32,
                              len(items))
        else:
            ids = np.empty(0, np.int32)
            tfs = np.empty(0, np.float32)
        self.add_document_arrays(name, ids, tfs, length)

    def add_document_arrays(self, name: str, ids: np.ndarray,
                            tfs: np.ndarray,
                            length: float | None = None) -> None:
        tfs = np.asarray(tfs, np.float32)
        ids = np.asarray(ids, np.int32)
        check_sorted_unique_ids(name, ids)
        entry = DocEntry(
            name=name, term_ids=ids, tfs=tfs,
            length=float(length if length is not None else tfs.sum()))
        with self._write_lock:
            self._tombstone_locked(name)
            self._where[name] = (None, len(self._pending))
            self._pending.append(entry)
            self._nnz_live_stat += entry.term_ids.shape[0]
            self._bytes_live_stat += (entry.term_ids.nbytes
                                      + entry.tfs.nbytes)
            self._gen += 1
        global_metrics.inc("docs_indexed")

    def delete_document(self, name: str) -> bool:
        with self._write_lock:
            ok = self._tombstone_locked(name)
            if ok:
                self._where.pop(name, None)
                self._gen += 1
            return ok

    def _tombstone_locked(self, name: str) -> bool:
        loc = self._where.get(name)
        if loc is None:
            return False
        seg, local = loc
        if seg is None:
            entry = self._pending[local]
            entry.live = False
        else:
            entry = seg.host_docs[local]
            seg.live[local] = False
            seg.live_version += 1
            # only the host mirror moves here; device masks are built per
            # published snapshot at the next commit
        self._nnz_live_stat -= entry.term_ids.shape[0]
        self._bytes_live_stat -= entry.term_ids.nbytes + entry.tfs.nbytes
        if seg is not None:
            # a committed tombstone leaves df/N/avgdl alone (the doc keeps
            # counting until its segment merges) but the live gauge moves
            self._live_total -= 1
        return True

    # ---- stats ----

    def _stats_add_segment_locked(self, seg: Segment) -> None:
        ids, counts = seg.sparse_df()
        if ids.shape[0]:
            hi = int(ids[-1]) + 1          # nonzero() ids are sorted
            if hi > self._df_total.shape[0]:
                grown = np.zeros(max(hi, 2 * self._df_total.shape[0]),
                                 np.float64)
                grown[:self._df_total.shape[0]] = self._df_total
                self._df_total = grown
            self._df_total[ids] += counts  # ids unique: plain fancy add
            self._df_delta.record(ids, counts)
        self._count_total += seg.n_docs
        self._len_total += float(seg.raw_len.sum())
        self._live_total += int(seg.live.sum())

    def _stats_remove_segment_locked(self, seg: Segment) -> None:
        ids, counts = seg.sparse_df()
        if ids.shape[0]:
            self._df_total[ids] -= counts
            self._df_delta.record(ids, -counts)
        self._count_total -= seg.n_docs
        self._len_total -= float(seg.raw_len.sum())
        self._live_total -= int(seg.live.sum())

    def live_names(self) -> list[str]:
        with self._write_lock:
            return list(self._where)

    @property
    def num_live_docs(self) -> int:
        return len(self._where)

    @property
    def nnz_live(self) -> int:
        return int(self._nnz_live_stat)

    def size_bytes(self) -> int:
        return int(self._bytes_live_stat)

    def _nnz_live_scratch(self) -> int:
        """Full recompute (test oracle for the incremental counter)."""
        n = sum(d.term_ids.shape[0] for d in self._pending if d.live)
        for seg in self._segments:
            n += sum(d.term_ids.shape[0]
                     for d, alive in zip(seg.host_docs, seg.live) if alive)
        return int(n)

    def _stats_scratch_locked(self, vocab_cap: int):
        """Full recompute of the global stats (df summed over every
        segment, tombstone-inclusive doc count and length sum, live
        count) — the resync belt and the test oracle for the incremental
        accumulators."""
        df = np.zeros(vocab_cap, np.float32)
        total_count = 0
        total_len = 0.0
        live_count = 0
        for seg in self._segments:
            v = min(len(seg.df), vocab_cap)
            df[:v] += seg.df[:v]
            total_count += seg.n_docs
            total_len += float(seg.raw_len.sum())
            live_count += int(seg.live.sum())
        return df, total_count, total_len, live_count

    def _bytes_live_scratch(self) -> int:
        """Full recompute (test oracle for the incremental counter)."""
        n = sum(d.term_ids.nbytes + d.tfs.nbytes
                for d in self._pending if d.live)
        for seg in self._segments:
            n += sum(d.term_ids.nbytes + d.tfs.nbytes
                     for d, alive in zip(seg.host_docs, seg.live) if alive)
        return int(n)

    def live_entries(self) -> list[DocEntry]:
        with self._write_lock:
            return self._live_entries_locked()

    def _live_entries_locked(self) -> list[DocEntry]:
        out = []
        for seg in self._segments:
            out.extend(d for d, alive in zip(seg.host_docs, seg.live)
                       if alive)
        out.extend(d for d in self._pending if d.live)
        return out

    def live_entries_and_gen(self) -> tuple[list[DocEntry], int]:
        """Entries plus the generation they were read at, atomically —
        the checkpoint-save consistency token."""
        with self._write_lock:
            return self._live_entries_locked(), self._gen

    # ---- checkpoint restore surfaces ----

    def bulk_load_packed(self, names: list[str], offsets: np.ndarray,
                         term_ids: np.ndarray, tfs: np.ndarray,
                         lengths: np.ndarray) -> None:
        """Generic checkpoint-restore path: register the whole packed doc
        table as pending (per-doc numpy views); the next commit builds ONE
        segment from it."""
        entries, (offsets, term_ids, tfs, lengths) = \
            entries_from_packed(names, offsets, term_ids, tfs, lengths)
        n = len(names)
        with self._write_lock:
            if self._pending or self._segments:
                raise ValueError("bulk_load_packed requires an empty index")
            self._where = {e.name: (None, i)
                           for i, e in enumerate(entries)}
            if len(self._where) != n:
                self._where = {}
                raise ValueError("bulk_load_packed: duplicate names")
            self._pending = entries
            self._nnz_live_stat = int(offsets[-1])
            self._bytes_live_stat = int(term_ids.nbytes + tfs.nbytes)
            self._gen += 1
        global_metrics.inc("docs_indexed", n)

    def export_full_state(self) -> tuple[dict, int] | None:
        """Segment-level fast-restore payload (the JAX package's
        ``segstate.npz`` keys): every segment's blocked-ELL layout REBUILT
        ON HOST from the retained postings (no device fetch), df, raw
        lengths, live mask, name table, and the mapping of live rows into
        the ``live_entries()`` order that docs.npz stores. Returns
        ``(arrays, gen)`` or None when pending docs exist (commit first).

        Each segment's rows are re-sorted by length descending (the
        blocked-ELL builder requires it) and EVERY per-row table is stored
        in that same permuted order. Tombstoned rows export their retained
        postings (a restore reads them back, :func:`_stored_rows`); a row
        a JAX-package restore left empty re-exports empty, which is
        scoring-equivalent (masked, df kept)."""
        with self._write_lock:
            if self._pending:
                return None
            segs = list(self._segments)
            # live masks mutate in place on delete/upsert: copy them under
            # the lock (the gen recheck below catches later mutations)
            seg_live = [np.asarray(s.live, bool).copy() for s in segs]
            gen = self._gen
        out: dict[str, np.ndarray] = {
            "format": np.int64(1), "nseg": np.int64(len(segs))}
        base = 0
        for i, seg in enumerate(segs):
            order = np.argsort([-d.term_ids.shape[0]
                                for d in seg.host_docs], kind="stable")
            docs = [seg.host_docs[k] for k in order]
            live = seg_live[i][order]
            names = [seg.names[k] for k in order]
            raw_len = np.asarray(seg.raw_len, np.float32)[order]
            ell, _df, _raw, _dl, doc_cap, _nnz = self._layout_host(
                docs, len(seg.df))
            if doc_cap != seg.doc_cap:
                return None   # capacity drift; fall back to slow path
            out[f"s{i}_nb"] = np.int64(len(ell.blocks))
            for j, blk in enumerate(ell.blocks):
                out[f"s{i}_b{j}_tf"] = blk.tf
                out[f"s{i}_b{j}_term"] = blk.term
                out[f"s{i}_b{j}_rows"] = np.int64(blk.n_rows)
            out[f"s{i}_res_nnz"] = np.int64(ell.res_nnz)
            if ell.res_nnz:
                out[f"s{i}_res_tf"] = ell.res_tf
                out[f"s{i}_res_term"] = ell.res_term
                out[f"s{i}_res_doc"] = ell.res_doc
            out[f"s{i}_df"] = seg.df
            out[f"s{i}_raw_len"] = raw_len
            out[f"s{i}_live"] = live
            out[f"s{i}_names"] = np.asarray(names)
            out[f"s{i}_doc_cap"] = np.int64(seg.doc_cap)
            out[f"s{i}_nnz"] = np.int64(seg.nnz_total)
            # live rows -> position in the live_entries() global order,
            # which iterates host_docs in STORED order
            stored_rank = np.full(seg.n_docs, -1, np.int64)
            k = 0
            for local, alive in enumerate(seg_live[i]):
                if alive:
                    stored_rank[local] = base + k
                    k += 1
            out[f"s{i}_gid"] = stored_rank[order]
            base += k
        with self._write_lock:
            if self._gen != gen:
                # a delete/upsert/merge-splice landed while the payload
                # was built
                return None
        return out, gen

    def install_full_state(self, data, entries: list[DocEntry]) -> None:
        """Rebuild the segment list from an :meth:`export_full_state`
        payload plus the live entries (docs.npz order). Device work is
        pure uploads of the stored layout — no O(corpus) host re-layout.
        The caller publishes the snapshot with a normal ``commit()``."""
        # an npz member is read (and inflated) anew at every access: read
        # each one once
        data = {k: data[k] for k in getattr(data, "files", data)}
        if int(data["format"]) != 1:
            raise ValueError("unknown segment-state format")
        nseg = int(data["nseg"])
        dev = self.device
        segs: list[Segment] = []
        where: dict[str, tuple[Segment, int]] = {}
        for i in range(nseg):
            names = [str(x) for x in data[f"s{i}_names"]]
            live = np.asarray(data[f"s{i}_live"], bool).copy()
            gid = data[f"s{i}_gid"]
            n = len(names)
            raw_len = np.asarray(data[f"s{i}_raw_len"], np.float32)
            dead = _stored_rows(data, i, raw_len)
            host_docs: list[DocEntry] = []
            for local in range(n):
                g = int(gid[local])
                if g >= 0:
                    e = entries[g]
                    if e.name != names[local]:
                        raise ValueError("segment-state/doc-table skew")
                    host_docs.append(e)
                else:
                    ids, tfs, length = dead(local)
                    host_docs.append(DocEntry(
                        name=names[local], term_ids=ids, tfs=tfs,
                        length=length, live=False))
            doc_cap = int(data[f"s{i}_doc_cap"])
            doc_len = np.zeros(doc_cap, np.float32)
            doc_len[:n] = self.model.transform_doc_len(raw_len)
            tfs_d, terms_d, dls_d, norms0, rows, caps = \
                [], [], [], [], [], []
            row0 = 0
            dbytes = 0
            for j in range(int(data[f"s{i}_nb"])):
                tf = data[f"s{i}_b{j}_tf"]
                term = data[f"s{i}_b{j}_term"]
                nr = int(data[f"s{i}_b{j}_rows"])
                cap = tf.shape[0]
                dl = np.zeros(cap, np.float32)
                dl[:nr] = doc_len[row0:row0 + nr]
                tfs_d.append(upload(tf, dev))
                terms_d.append(upload(term, dev))
                dls_d.append(upload(dl, dev))
                norms0.append(zeros_on(cap, dev))
                rows.append(nr)
                caps.append(cap)
                row0 += nr
                dbytes += tf.nbytes + term.nbytes + 8 * cap
            res_tf = res_term = res_doc = doc_len_d = res_plan = None
            res_nnz = int(data[f"s{i}_res_nnz"])
            if res_nnz:
                r_tf = data[f"s{i}_res_tf"]
                r_term = data[f"s{i}_res_term"]
                r_doc = data[f"s{i}_res_doc"]
                res_tf, res_term, res_doc, doc_len_d = (
                    upload(r_tf, dev), upload(r_term, dev),
                    upload(r_doc, dev), upload(doc_len, dev))
                res_plan = segment_plan(r_doc, res_nnz,
                                        min(RES_CHUNK, len(r_tf)), dev)
                dbytes += (r_tf.nbytes + r_term.nbytes + r_doc.nbytes
                           + doc_len.nbytes)
            seg = Segment(
                tfs=tuple(tfs_d), terms=tuple(terms_d),
                dls=tuple(dls_d), norms0=tuple(norms0),
                block_rows=tuple(rows), block_caps=tuple(caps),
                doc_cap=doc_cap, names=names,
                df=np.asarray(data[f"s{i}_df"], np.float32),
                raw_len=raw_len, host_docs=host_docs,
                res_tf=res_tf, res_term=res_term, res_doc=res_doc,
                doc_len_d=doc_len_d, res_plan=res_plan,
                nnz_total=int(data[f"s{i}_nnz"]), live=live,
                device_bytes=int(dbytes))
            if self.tier is not None:
                # dead placeholders restore with empty postings: the bound
                # covers a superset — sound either way
                min_dl = float(doc_len[:n].min()) if n else 0.0
                seg.bounds = bounds_from_entries(host_docs, len(seg.df),
                                                 min_dl)
            segs.append(seg)
            for local, alive in enumerate(live):
                if alive:
                    where[names[local]] = (seg, local)
        nnz = sum(int(e.term_ids.shape[0]) for e in entries)
        nbytes = sum(e.term_ids.nbytes + e.tfs.nbytes for e in entries)
        with self._write_lock:
            if self._pending or self._segments:
                raise ValueError(
                    "install_full_state requires an empty index")
            self._segments = segs
            self._where = dict(where)
            self._nnz_live_stat = nnz
            self._bytes_live_stat = nbytes
            self._gen += 1
            if self.tier is not None:
                # restored segments arrive fully resident — register each
                # with the tier so the budget rebalance can spill them
                for seg in segs:
                    self.tier.admit(seg)
        global_metrics.inc("docs_indexed", len(entries))

    # ---- commit ----

    def _layout_host(self, entries: list[DocEntry], vocab_cap: int):
        """Host-side ELL layout of ``entries`` IN ORDER (no sorting —
        callers sort; checkpoint export and the tier's spill rely on order
        preservation). Returns ``(ell, df, raw_len, doc_len, doc_cap,
        nnz)``."""
        n = len(entries)
        sizes = np.fromiter((d.term_ids.shape[0] for d in entries),
                            np.int64, n)
        nnz = int(sizes.sum())
        nnz_cap = next_capacity(max(nnz, 1), 1 << 10)
        doc_cap = next_capacity(max(n, 1), self.min_doc_cap)
        tf = np.zeros(nnz_cap, np.float32)
        term = np.zeros(nnz_cap, np.int32)
        doc = np.full(nnz_cap, doc_cap - 1, np.int32)
        if nnz:
            tf[:nnz] = np.concatenate([d.tfs for d in entries])
            term[:nnz] = np.concatenate([d.term_ids for d in entries])
            doc[:nnz] = np.repeat(np.arange(n, dtype=np.int32), sizes)
        df = (np.bincount(term[:nnz], minlength=vocab_cap)[:vocab_cap]
              .astype(np.float32) if nnz
              else np.zeros(vocab_cap, np.float32))
        raw_len = np.fromiter((d.length for d in entries), np.float32, n)
        doc_len = np.zeros(doc_cap, np.float32)
        doc_len[:n] = self.model.transform_doc_len(raw_len)
        coo = CooShard(tf=tf, term=term, doc=doc, doc_len=doc_len, df=df,
                       nnz=nnz, num_docs=n)
        ell = build_ell_from_coo(coo, width_cap=self.ell_width_cap,
                                 min_rows=min(256, self.min_doc_cap))
        return ell, df, raw_len, doc_len, doc_cap, nnz

    def _build_segment(self, entries: list[DocEntry],
                       vocab_cap: int, paced: bool = False) -> Segment:
        """Lay out ``entries`` (sorted by width here) and upload them.
        ``paced`` (background merges): the uploads go to the merge stream;
        each block's transfer is awaited, and while a commit runs the
        merge sleeps a multiple of that upload's time, leaving the
        commit's uploads gaps; an event recorded after the last upload
        becomes the segment's ``ready``."""
        order = np.argsort([-d.term_ids.shape[0] for d in entries],
                           kind="stable")
        entries = [entries[i] for i in order]
        n = len(entries)
        ell, df, raw_len, doc_len, doc_cap, nnz = self._layout_host(
            entries, vocab_cap)
        # streaming segments keep raw tf on the device (weights are
        # computed per query batch with current stats)
        dev = self.device
        stream = self._merge_stream if paced else None
        pace = self.merge_upload_pace if paced else 0.0

        def paced_wait(u0: float) -> None:
            if pace > 0:
                if stream is not None:
                    stream.synchronize()
                if self._commit_active:   # yield only under contention
                    time.sleep(pace * (time.perf_counter() - u0))

        tfs_d, terms_d, dls_d, norms0, rows, caps = [], [], [], [], [], []
        for blk in ell.blocks:
            rows_cap = blk.tf.shape[0]
            dl_blk = np.zeros(rows_cap, np.float32)
            dl_blk[:blk.n_rows] = doc_len[blk.row0:blk.row0 + blk.n_rows]
            u0 = time.perf_counter()
            tfs_d.append(upload(blk.tf, dev, stream))
            terms_d.append(upload(blk.term, dev, stream))
            dls_d.append(upload(dl_blk, dev, stream))
            paced_wait(u0)
            norms0.append(zeros_on(rows_cap, dev, stream))
            rows.append(blk.n_rows)
            caps.append(rows_cap)
        res_tf = res_term = res_doc = doc_len_d = res_plan = None
        if ell.res_nnz:
            # over-wide docs: extra postings spill into a per-segment COO
            # residual, scored by the segment-sum path with the same
            # current-stats weights
            u0 = time.perf_counter()
            res_tf = upload(ell.res_tf, dev, stream)
            res_term = upload(ell.res_term, dev, stream)
            res_doc = upload(ell.res_doc, dev, stream)
            doc_len_d = upload(doc_len, dev, stream)
            res_plan = segment_plan(ell.res_doc, ell.res_nnz,
                                    min(RES_CHUNK, len(ell.res_tf)), dev)
            paced_wait(u0)
        ready = None
        if stream is not None:
            ready = torch.cuda.Event()
            ready.record(stream)
        dbytes = sum(b.tf.nbytes + b.term.nbytes + 8 * b.tf.shape[0]
                     for b in ell.blocks)      # + dl/norms0 f32 per row
        if ell.res_nnz:
            dbytes += (ell.res_tf.nbytes + ell.res_term.nbytes
                       + ell.res_doc.nbytes + doc_len.nbytes)
        seg = Segment(
            tfs=tuple(tfs_d), terms=tuple(terms_d), dls=tuple(dls_d),
            norms0=tuple(norms0),
            block_rows=tuple(rows), block_caps=tuple(caps),
            doc_cap=doc_cap, names=[d.name for d in entries],
            df=df, raw_len=raw_len, host_docs=entries,
            res_tf=res_tf, res_term=res_term, res_doc=res_doc,
            doc_len_d=doc_len_d, res_plan=res_plan, ready=ready,
            nnz_total=nnz, live=np.ones(n, bool), device_bytes=int(dbytes))
        if self.tier is not None:
            min_dl = float(doc_len[:n].min()) if n else 0.0
            seg.bounds = bounds_from_entries(entries, vocab_cap, min_dl)
        seg.sparse_df()   # populate off the write lock (splice holds it)
        return seg

    def _cosine_norms_real(self, seg: Segment, df_total: np.ndarray,
                           n_total: float) -> np.ndarray:
        """Per-local-doc L2 norms of the TF-IDF vectors under the CURRENT
        global df — recomputed every commit (host pass over the retained
        postings; only the cosine model pays this)."""
        norms = np.zeros(seg.doc_cap, np.float32)
        for local, d in enumerate(seg.host_docs):
            if d.term_ids.shape[0]:
                dft = df_total[d.term_ids]
                w = d.tfs * (np.log((1.0 + n_total) / (1.0 + dft)) + 1.0)
                norms[local] = np.sqrt(float((w * w).sum()))
        return norms

    def _make_view(self, seg: Segment, df_total: np.ndarray,
                   n_total: float) -> SegmentView:
        # untouched segments reuse their cached view (mask included);
        # cosine views depend on the moving global df, so only the cosine
        # model skips the cache
        if not self.model.needs_norms and seg.view_cache is not None \
                and seg.view_cache[0] == seg.live_version:
            return seg.view_cache[1]
        dev = self.device
        mask = np.zeros(seg.doc_cap, np.float32)
        mask[:seg.n_docs] = seg.live.astype(np.float32)
        if self.model.needs_norms:
            norms_real = self._cosine_norms_real(seg, df_total, n_total)
            norms_blocks, row0 = [], 0
            for n_rows, cap in zip(seg.block_rows, seg.block_caps):
                blk = np.zeros(cap, np.float32)
                blk[:n_rows] = norms_real[row0:row0 + n_rows]
                norms_blocks.append(upload(blk, dev))
                row0 += n_rows
            norms = tuple(norms_blocks)
            res_norms = (upload(norms_real, dev)
                         if seg.res_tf is not None else None)
        else:
            norms = seg.norms0
            res_norms = None
        res = None
        if seg.res_tf is not None:
            res = (seg.res_tf, seg.res_term, seg.res_doc, seg.doc_len_d,
                   res_norms, seg.res_plan)
        view = SegmentView(
            tfs=seg.tfs, terms=seg.terms, dls=seg.dls, norms=norms,
            block_live=seg.block_rows, live_mask=upload(mask, dev),
            res=res, ready=seg.ready)
        if not self.model.needs_norms:
            seg.view_cache = (seg.live_version, view)
        return view

    def commit(self, vocab_cap: int) -> SegmentedSnapshot:
        with self._write_lock:
            gen0 = self._gen
            if (self._committed_gen == gen0 and self.snapshot is not None
                    and self.snapshot.df.shape[0] == vocab_cap):
                return self.snapshot
            # which commits overlapped a background merge, and where their
            # time went — the evidence behind the bounded-commit claim
            merge_inflight = bool(self._merge_futs)
            self._commit_active = True   # merge uploads start yielding
            try:
                b0 = time.perf_counter()
                pending = [d for d in self._pending if d.live]
                # build FIRST; index state is swapped only after the build
                # succeeds, so a failed build loses nothing
                new_seg = (self._build_segment(pending, vocab_cap)
                           if pending else None)
                build_s = time.perf_counter() - b0
                self._pending = []
                if new_seg is not None:
                    for local, d in enumerate(new_seg.host_docs):
                        self._where[d.name] = (new_seg, local)
                    self._segments.append(new_seg)
                    self._stats_add_segment_locked(new_seg)
                    if self.tier is not None:
                        # account BEFORE the merge policy (which may merge
                        # the fresh segment away); over budget this evicts
                        # LRU segments, which publish as cold handles below
                        self.tier.admit(new_seg)
                if len(self._segments) > self.max_segments:
                    self._merge_policy_locked(vocab_cap)
                segments = list(self._segments)

                # Global stats over the CURRENT segment set, tombstones
                # included until compaction (Lucene's docFreq and docCount
                # move together). Steady state reads the incrementally
                # maintained totals and advances the device df by ONE
                # sparse add; only the first commit, vocab growth and the
                # control path pay the full recompute + dense upload —
                # counted by the df_full_recomputes witness.
                if (self.incremental_stats
                        and self._df_device is not None
                        and self._df_device.shape[0] == vocab_cap):
                    df_dev = self._df_delta.apply(self._df_device)
                    total_count = self._count_total
                    total_len = self._len_total
                    live_count = self._live_total
                    df_host = None
                else:
                    df_host, total_count, total_len, live_count = \
                        self._stats_scratch_locked(vocab_cap)
                    self.df_full_recomputes += 1
                    # resync the accumulators from the per-segment dfs
                    self._df_total = df_host.astype(np.float64)
                    self._count_total = total_count
                    self._len_total = total_len
                    self._live_total = live_count
                    self._df_delta.clear()
                    df_dev = upload(df_host.copy(), self.device)
                self._df_device = df_dev
                if self.model.needs_norms and df_host is None:
                    # cosine norms read the CURRENT dense df host-side
                    df_host = np.zeros(vocab_cap, np.float32)
                    v = min(self._df_total.shape[0], vocab_cap)
                    df_host[:v] = self._df_total[:v]
                v0 = time.perf_counter()
                if self.tier is None:
                    views = tuple(self._make_view(seg, df_host,
                                                  float(total_count))
                                  for seg in segments)
                    hot: tuple = ()
                    cold: tuple = ()
                else:
                    from tfidf_tpu_torch.engine.tiering import ColdHandle
                    views = ()
                    hot_l, cold_l, base = [], [], 0
                    for i, seg in enumerate(segments):
                        if seg.resident:
                            hot_l.append((i, base, self._make_view(
                                seg, df_host, float(total_count))))
                        else:
                            # capture the live mask NOW (tombstones mutate
                            # seg.live in place after publish)
                            mask = np.zeros(seg.doc_cap, np.float32)
                            mask[:seg.n_docs] = \
                                seg.live.astype(np.float32)
                            cold_l.append(ColdHandle(
                                seg=seg, seg_index=i, base=base,
                                live_mask=mask,
                                live_version=seg.live_version,
                                bounds=seg.bounds))
                        base += seg.doc_cap
                    hot = tuple(hot_l)
                    cold = tuple(cold_l)
                view_s = time.perf_counter() - v0
                self._version += 1
                avgdl = total_len / total_count if total_count else 1.0
                snap = SegmentedSnapshot(
                    segments=segments,
                    views=views,
                    df=df_dev,
                    n_docs=upload(np.float32(total_count), self.device),
                    avgdl=upload(np.float32(avgdl), self.device),
                    num_docs=int(sum(s.doc_cap for s in segments)),
                    version=self._version,
                    nnz=self.nnz_live,
                    hot=hot, cold=cold, tier=self.tier,
                    n_docs_f=float(total_count),
                    avgdl_f=float(avgdl))
                self.snapshot = snap
                # only as clean as the generation it was built from, and
                # only once it is actually published
                self._committed_gen = gen0
            finally:
                self._commit_active = False
        global_metrics.set_gauge("index_segments", len(segments))
        global_metrics.set_gauge("index_docs", live_count)
        global_metrics.observe(
            "commit_build_merge_inflight" if merge_inflight
            else "commit_build_alone", build_s)
        global_metrics.observe("commit_views", view_s)
        log.info("committed segment snapshot", version=self._version,
                 segments=len(segments), docs=live_count,
                 build_ms=round(build_s * 1e3, 1),
                 view_ms=round(view_s * 1e3, 1),
                 merge_inflight=merge_inflight)
        return snap

    # ---- tiered merging (Lucene TieredMergePolicy shape) ----

    def _merge_policy_locked(self, vocab_cap: int) -> None:
        """Pick the SMALLEST similar-sized segments and merge just enough
        of them to get back under ``max_segments``; big segments are not
        rewritten. Small merges run inline; big ones go to the background
        threads, during which the segment count may exceed the cap."""
        while len(self._segments) > self.max_segments:
            busy = {i for srcs in self._merge_jobs.values()
                    for i in map(id, srcs)}
            avail = [s for s in self._segments if id(s) not in busy]
            need = len(self._segments) - self.max_segments + 1
            if len(avail) < max(need, 2):
                return                      # background merges catch up
            by_size = sorted(avail, key=lambda s: s.nnz_total)
            merge_set = by_size[:max(need, 2)]
            # extend only across the SAME size tier: the next candidate
            # must be within 8x of the largest segment already merging
            total = sum(s.nnz_total for s in merge_set)
            tier_cap = 8 * max(merge_set[-1].nnz_total, 1)  # FIXED bound
            for s in by_size[len(merge_set):]:
                if s.nnz_total <= tier_cap:
                    merge_set.append(s)
                    total += s.nnz_total
                else:
                    break
            if total > self.sync_merge_nnz:
                if len(self._merge_futs) < self.merge_workers:
                    self._start_background_merge_locked(merge_set,
                                                        vocab_cap)
                    continue   # a second disjoint tier may start too
                # an over-threshold merge NEVER runs on the commit path;
                # with every merge slot busy the segment count floats
                # above the cap until one splices
                return
            self._merge_inline_locked(merge_set, vocab_cap)

    def _merge_entries(self, sources: list[Segment]) -> list[DocEntry]:
        return [d for seg in sources
                for d, alive in zip(seg.host_docs, seg.live) if alive]

    def _splice_locked(self, sources: list[Segment],
                       merged: Segment | None) -> None:
        """Replace ``sources`` with ``merged`` (at the first source's
        position), re-pointing ``_where`` for documents STILL owned by a
        source — a doc deleted or upserted away since the merge began is
        tombstoned in the merged copy instead."""
        src = set(map(id, sources))
        pos = min(i for i, s in enumerate(self._segments)
                  if id(s) in src)
        self._segments = (
            self._segments[:pos]
            + ([merged] if merged is not None else [])
            + [s for s in self._segments[pos:] if id(s) not in src])
        if merged is not None:
            for local, d in enumerate(merged.host_docs):
                loc = self._where.get(d.name)
                if loc is not None and loc[0] is not None \
                        and id(loc[0]) in src:
                    self._where[d.name] = (merged, local)
                else:
                    merged.live[local] = False
                    merged.live_version += 1
        # global stats move by the splice's exact deltas (merge reclaims
        # tombstones from df/N/avgdl)
        for s in sources:
            self._stats_remove_segment_locked(s)
        if merged is not None:
            self._stats_add_segment_locked(merged)
        if self.tier is not None:
            for s in sources:
                self.tier.discard(s)
            if merged is not None:
                self.tier.admit(merged)
        global_metrics.inc("compactions")

    def _merge_inline_locked(self, sources: list[Segment],
                             vocab_cap: int) -> None:
        entries = self._merge_entries(sources)
        merged = self._build_segment(entries, vocab_cap) if entries \
            else None
        self._splice_locked(sources, merged)
        global_metrics.inc("merges_inline")
        log.info("merged segments", merged=len(sources),
                 docs=len(entries), mode="inline")

    def _start_background_merge_locked(self, sources: list[Segment],
                                       vocab_cap: int) -> None:
        from concurrent.futures import ThreadPoolExecutor
        if self._merge_pool is None:
            self._merge_pool = ThreadPoolExecutor(
                max_workers=self.merge_workers,
                thread_name_prefix="segment-merge")
        entries = self._merge_entries(sources)
        key_box: list[int] = []

        def run():
            try:
                # the heavy host+device build happens WITHOUT the lock;
                # sources stay queryable the whole time
                m0 = time.perf_counter()
                merged = (self._build_segment(entries, vocab_cap,
                                              paced=True)
                          if entries else None)
                global_metrics.observe("merge_build",
                                       time.perf_counter() - m0)
                with self._write_lock:
                    self._splice_locked(sources, merged)
                    self._merge_jobs.pop(key_box[0], None)
                    self._merge_futs.pop(key_box[0], None)
                    self._gen += 1      # next commit publishes the swap
                global_metrics.inc("merges_background")
                log.info("merged segments", merged=len(sources),
                         docs=len(entries), mode="background")
            except Exception as e:      # keep serving on failure
                with self._write_lock:
                    self._merge_jobs.pop(key_box[0], None)
                    self._merge_futs.pop(key_box[0], None)
                log.warning("background merge failed", err=repr(e))

        fut = self._merge_pool.submit(run)
        key_box.append(id(fut))
        self._merge_jobs[id(fut)] = sources
        self._merge_futs[id(fut)] = fut

    @property
    def _merge_future(self):
        """Any in-flight background merge future (for callers that poll
        ``_merge_future is None``)."""
        with self._write_lock:
            return next(iter(self._merge_futs.values()), None)

    def wait_for_merges(self, timeout: float | None = None) -> None:
        """Block until every in-flight background merge has spliced.
        ``timeout`` bounds the WHOLE wait (one shared deadline)."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            with self._write_lock:
                fut = next(iter(self._merge_futs.values()), None)
            if fut is None:
                return
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            fut.result(timeout=remaining)
