"""MeshIndex / MeshSearcher — the mesh-sharded SERVING path.

The counterpart of ``tfidf_tpu/parallel/mesh_index.py``, with the JAX
package's lifecycle unchanged: a live index whose committed state is
:class:`ShardedArrays` on a ``("docs", "terms")`` mesh of ranks, with the
write API of :class:`~tfidf_tpu_torch.engine.index.ShardIndex` so the
Engine surface (ingest, upload, checkpoint, cluster node) works on top of
it. One node hosting a MeshIndex takes the place of the reference's
worker pool (``Leader.java:39-92``): per-row scoring, global IDF summed
over the mesh, the terms-axis score sum and the gathered top-k are the
collectives of :mod:`tfidf_tpu_torch.parallel.collectives`.

Lifecycle (the mesh analog of Lucene's segment/commit model,
``Worker.java:88,138``):

* **commit** publishes an immutable :class:`MeshSnapshot`. New documents
  append on the devices (``make_sharded_ingest`` — a copy of each block
  with the batch written at the shard cursors); placement is least-loaded-shard by live
  postings bytes, the ``index-size`` balancing policy of
  ``Leader.java:168-189`` applied at mesh scale.
* **deletes/upserts** tombstone via the snapshot's live mask (Lucene's
  deleted-docs bitmap); postings stay, df/avgdl keep counting them until
  the next re-shard, like Lucene until merge.
* **growth**: when the vocabulary outgrows ``vocab_cap`` or a capacity
  bucket overflows, the index re-shards — a full rebuild from the retained
  host postings onto the same mesh with wider buckets (capacities are
  power-of-two bucketed with headroom, so this is rare and amortized).
* **recovery**: host postings are the source of truth; the device state is
  always reconstructible (recovery-by-rebuild, ``Worker.java:77-88``).

Thread safety: single-writer lock over mutations + commit; searches are
lock-free against a published snapshot. Snapshots stay valid across later
commits because appends only extend per-shard doc lists, rebuilds swap
in fresh list objects, and every device update is out of place — an old
snapshot keeps references to the lists and tensors it was built from.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from tfidf_tpu_torch.engine.index import DocEntry
from tfidf_tpu_torch.models.base import ScoringModel
from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.parallel.mesh import make_mesh
from tfidf_tpu_torch.parallel.sharded import (ShardedArrays, build_ingest_batch,
                                        build_sharded_arrays,
                                        make_sharded_ingest,
                                        make_sharded_scores,
                                        make_sharded_search, with_live_mask)
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("parallel.mesh_index")


@dataclass
class MeshSnapshot:
    """Immutable published state: device arrays + the name mapping."""
    arrays: ShardedArrays
    shard_docs: list      # list[list[DocEntry]] — append-only per shard
    version: int
    nnz: int
    total_live: int

    def name_of(self, gid: int) -> str | None:
        """Global id (docs_shard * doc_cap + local) -> document name."""
        doc_cap = self.arrays.doc_cap
        sd = self.shard_docs[gid // doc_cap]
        local = gid % doc_cap
        return sd[local].name if local < len(sd) else None


class MeshIndex:
    """Mesh-resident shard index with the ShardIndex write API."""

    def __init__(self, model: ScoringModel,
                 mesh=None,
                 min_doc_cap: int = 1024,
                 min_chunk_cap: int = 1 << 14) -> None:
        self.model = model
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.home
        self.D = self.mesh.shape["docs"]
        self.T = self.mesh.shape["terms"]
        self.min_doc_cap = min_doc_cap
        self.min_chunk_cap = min_chunk_cap
        self._write_lock = threading.Lock()
        # committed docs per shard in local-id order (tombstones included —
        # a slot is never reused until a re-shard)
        self._shard_docs: list[list[DocEntry]] = [[] for _ in range(self.D)]
        self._placed: dict[str, tuple[int, int]] = {}
        self._pending: dict[str, DocEntry] = {}   # upsert: latest wins
        self._mask_dirty = False
        self._gen = 1
        self._committed_gen = 0
        self._version = 0
        self.snapshot: MeshSnapshot | None = None
        self._ingest_fn = None
        # observable lifecycle counters (tests + /api/metrics)
        self.rebuilds = 0
        self.appends = 0

    # ---- write path (ShardIndex-compatible) ----

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
        from tfidf_tpu_torch.engine.index import check_sorted_unique_ids
        tfs = np.asarray(tfs, np.float32)
        ids = np.asarray(ids, np.int32)
        check_sorted_unique_ids(name, ids)
        entry = DocEntry(
            name=name, term_ids=ids, tfs=tfs,
            length=float(length if length is not None else tfs.sum()))
        with self._write_lock:
            placed = self._placed.pop(name, None)
            if placed is not None:   # upsert: tombstone the committed copy
                s, local = placed
                self._shard_docs[s][local].live = False
                self._mask_dirty = True
            self._pending[name] = entry
            self._gen += 1
        global_metrics.inc("docs_indexed")

    def bulk_load_packed(self, names, offsets, term_ids, tfs,
                         lengths) -> None:
        """Checkpoint-restore fast path: register the packed doc table
        as pending upserts in one pass (per-doc numpy VIEWS, no
        per-document ingest work); the next commit builds the sharded
        arrays in ONE vectorized rebuild. Placement is re-derived
        (round-robin) — scoring is placement-invariant because df/IDF
        are globalized by psum; only parity mode's per-shard statistics
        can differ from the pre-checkpoint placement."""
        from tfidf_tpu_torch.engine.index import entries_from_packed
        entries, (offsets, term_ids, tfs, lengths) = \
            entries_from_packed(names, offsets, term_ids, tfs, lengths)
        with self._write_lock:
            if self._pending or self._placed or any(self._shard_docs):
                raise ValueError(
                    "bulk_load_packed requires an empty index")
            self._pending = {e.name: e for e in entries}
            if len(self._pending) != len(entries):
                self._pending = {}
                raise ValueError("bulk_load_packed: duplicate names")
            self._bulk_load_stats(term_ids, lengths)
            self._gen += 1
        global_metrics.inc("docs_indexed", len(entries))

    def _bulk_load_stats(self, term_ids, lengths) -> None:
        """Hook for subclasses with incremental stat accumulators
        (caller holds the write lock)."""

    def delete_document(self, name: str) -> bool:
        with self._write_lock:
            if self._pending.pop(name, None) is not None:
                self._gen += 1
                return True
            placed = self._placed.pop(name, None)
            if placed is None:
                return False
            s, local = placed
            self._shard_docs[s][local].live = False
            self._mask_dirty = True
            self._gen += 1
            return True

    # ---- stats ----

    @property
    def num_live_docs(self) -> int:
        return len(self._placed) + len(self._pending)

    @property
    def nnz_live(self) -> int:
        n = sum(d.term_ids.shape[0] for d in self._pending.values())
        for sd in self._shard_docs:
            n += sum(d.term_ids.shape[0] for d in sd if d.live)
        return int(n)

    def size_bytes(self) -> int:
        n = sum(d.term_ids.nbytes + d.tfs.nbytes
                for d in self._pending.values())
        for sd in self._shard_docs:
            n += sum(d.term_ids.nbytes + d.tfs.nbytes
                     for d in sd if d.live)
        return int(n)

    def live_entries(self) -> list[DocEntry]:
        with self._write_lock:
            out = []
            for sd in self._shard_docs:
                out.extend(d for d in sd if d.live)
            out.extend(self._pending.values())
            return out


    # ---- commit ----

    def commit(self, vocab_cap: int) -> MeshSnapshot:
        with self._write_lock:
            gen0 = self._gen
            if (self._committed_gen == gen0 and self.snapshot is not None
                    and self.snapshot.arrays.vocab_cap >= vocab_cap):
                return self.snapshot
            pending = list(self._pending.values())
            arrays = self.snapshot.arrays if self.snapshot else None
            if arrays is None or vocab_cap > arrays.vocab_cap:
                arrays = self._rebuild_locked(pending, vocab_cap)
            elif pending:
                try:
                    arrays = self._append_locked(arrays, pending)
                except ValueError as e:
                    # a capacity bucket overflowed: re-shard with wider
                    # buckets (the analog of Lucene growing a new segment
                    # generation; amortized by power-of-two headroom)
                    log.info("capacity overflow; re-sharding",
                             reason=str(e).split(";")[0])
                    arrays = self._rebuild_locked(pending, vocab_cap)
            if self._mask_dirty:
                arrays = with_live_mask(self.mesh, arrays,
                                        self._host_mask(arrays.doc_cap))
                self._mask_dirty = False
            self._pending = {}
            self._version += 1
            snap = MeshSnapshot(
                arrays=arrays, shard_docs=self._shard_docs,
                version=self._version, nnz=self.nnz_live,
                total_live=len(self._placed))
            self.snapshot = snap
            self._committed_gen = gen0
        global_metrics.set_gauge("index_docs", snap.total_live)
        global_metrics.set_gauge("index_nnz", snap.nnz)
        global_metrics.set_gauge("mesh_rebuilds", self.rebuilds)
        log.info("committed mesh snapshot", version=snap.version,
                 docs=snap.total_live, nnz=snap.nnz,
                 mesh=dict(self.mesh.shape))
        return snap

    def _host_mask(self, doc_cap: int) -> np.ndarray:
        mask = np.zeros((self.D, doc_cap), np.float32)
        for s, sd in enumerate(self._shard_docs):
            for local, d in enumerate(sd):
                if d.live:
                    mask[s, local] = 1.0
        return mask

    def _entries_to_coo(self, entries: list[DocEntry], vocab_cap: int
                        ) -> tuple[CooShard, np.ndarray]:
        """Concatenation-order COO (NOT length-sorted — placement is
        ``i % D``, so order IS the layout; cf. ``shard_documents``).
        Returns (coo with model-transformed lengths, raw lengths)."""
        n = len(entries)
        sizes = np.fromiter((d.term_ids.shape[0] for d in entries),
                            np.int64, n)
        nnz = int(sizes.sum())
        tf = np.zeros(max(nnz, 1), np.float32)
        term = np.zeros(max(nnz, 1), np.int32)
        doc = np.zeros(max(nnz, 1), np.int32)
        if nnz:
            tf[:nnz] = np.concatenate([d.tfs for d in entries])
            term[:nnz] = np.concatenate([d.term_ids for d in entries])
            doc[:nnz] = np.repeat(np.arange(n, dtype=np.int32), sizes)
        df = (np.bincount(term[:nnz], minlength=vocab_cap)[:vocab_cap]
              .astype(np.float32) if nnz
              else np.zeros(vocab_cap, np.float32))
        raw_len = np.fromiter((d.length for d in entries), np.float32, n)
        doc_len = self.model.transform_doc_len(raw_len).astype(np.float32)
        return CooShard(tf=tf[:nnz], term=term[:nnz], doc=doc[:nnz],
                        doc_len=doc_len, df=df, nnz=nnz,
                        num_docs=n), raw_len

    def _rebuild_locked(self, pending: list[DocEntry],
                        vocab_cap: int) -> ShardedArrays:
        """Full re-shard from host postings: drops tombstones, re-tightens
        df, widens capacity buckets — the compaction/merge analog."""
        entries = []
        for sd in self._shard_docs:
            entries.extend(d for d in sd if d.live)
        entries.extend(pending)
        coo, raw_len = self._entries_to_coo(entries, vocab_cap)
        arrays = build_sharded_arrays(
            coo, self.mesh, min_chunk_cap=self.min_chunk_cap,
            min_doc_cap=self.min_doc_cap, raw_doc_len=raw_len)
        # fresh list objects: snapshots taken before this rebuild keep the
        # old lists (and the old arrays), staying internally consistent
        self._shard_docs = [[] for _ in range(self.D)]
        self._placed = {}
        for i, e in enumerate(entries):
            e.live = True
            s = i % self.D
            self._placed[e.name] = (s, len(self._shard_docs[s]))
            self._shard_docs[s].append(e)
        self._mask_dirty = False
        self.rebuilds += 1
        global_metrics.inc("mesh_reshards")
        return arrays

    def _append_locked(self, arrays: ShardedArrays,
                       pending: list[DocEntry]) -> ShardedArrays:
        """On-device append of the pending batch (O(batch), no rebuild).

        Placement: least-loaded shard by live postings bytes — the
        ``GET /worker/index-size`` balancing policy (``Leader.java:168-
        189``) applied per document at mesh scale.
        """
        loads = [sum(d.term_ids.nbytes + d.tfs.nbytes
                     for d in sd if d.live) for sd in self._shard_docs]
        slots = [len(sd) for sd in self._shard_docs]
        per_entries: list[list[DocEntry]] = [[] for _ in range(self.D)]
        for e in pending:
            s = int(np.argmin(loads))
            per_entries[s].append(e)
            loads[s] += e.term_ids.nbytes + e.tfs.nbytes
            slots[s] += 1
            if slots[s] > arrays.doc_cap:
                raise ValueError("docs-shard over doc capacity; re-shard")
        per_docs = [[dict(zip(e.term_ids.tolist(),
                              e.tfs.astype(np.float64).tolist()))
                     for e in es] for es in per_entries]
        per_lens = [
            list(self.model.transform_doc_len(
                np.asarray([e.length for e in es], np.float32))
                .astype(np.float32)) if es else []
            for es in per_entries]
        per_raw = [[e.length for e in es] for es in per_entries]
        max_entries = max((sum(e.term_ids.shape[0] for e in es)
                           for es in per_entries), default=0)
        C = next_capacity(max(-(-max_entries // self.T), 1), 64)
        batch = build_ingest_batch(self.mesh, arrays, per_docs, per_lens, C,
                                   raw_lengths_per_shard=per_raw)
        if self._ingest_fn is None:
            self._ingest_fn = make_sharded_ingest(self.mesh)
        arrays = self._ingest_fn(arrays, *batch)
        for s, es in enumerate(per_entries):
            for e in es:
                self._placed[e.name] = (s, len(self._shard_docs[s]))
                self._shard_docs[s].append(e)
        self.appends += 1
        global_metrics.inc("mesh_appends")
        return arrays


from tfidf_tpu_torch.engine.searcher import QueryVectorizerMixin


class MeshSearcher(QueryVectorizerMixin):
    """Query execution against MeshSnapshots — the distributed forward
    pass; queries are vectorized onto the mesh's home device. Mirrors :class:`~tfidf_tpu_torch.engine.searcher.Searcher`'s interface
    so Engine/cluster code is layout-agnostic. Subclasses (the ELL mesh
    layout) override only the hooks — :meth:`_dispatch_chunk`,
    :meth:`_finish_chunk`, :meth:`_search_unbounded`,
    :meth:`_on_snapshot` — the chunking and hit-assembly loop lives in
    one place."""

    def __init__(self, index: MeshIndex, analyzer, vocab,
                 model: ScoringModel,
                 *, query_batch: int = 32, max_query_terms: int = 32,
                 top_k: int = 10, result_order: str = "score",
                 global_idf: bool = True,
                 kernel_a_build: str = "v4",
                 pipeline_depth: int = 2,
                 pipeline_mode: str = "auto") -> None:
        self.index = index
        self.device = index.mesh.home
        self.analyzer = analyzer
        self.vocab = vocab
        self.model = model
        self.query_batch = query_batch
        self.max_query_terms = max_query_terms
        self.top_k = top_k
        self.result_order = result_order
        self.pipeline_depth = max(1, pipeline_depth)
        # "auto" | "executor" | "inline" — see QueryVectorizerMixin
        self.pipeline_mode = pipeline_mode
        # A-build variant for the fused kernel (ELL layout only; the
        # COO scatter step never touches it). Validated at
        # construction so a config typo fails before any query.
        from tfidf_tpu_torch.ops.ell import check_a_build
        self.kernel_a_build = check_a_build(kernel_a_build)
        # global_idf=False reproduces the reference's per-worker statistics
        # (each Lucene shard scores against local df/N, Worker.java:222-241)
        self.global_idf = global_idf
        self._search_fns: dict[int, object] = {}
        self._scores_fn = None

    def _batch_cap(self, n: int) -> int:
        return min(self.query_batch, next_capacity(max(n, 1), 1))

    def _model_kwargs(self) -> dict:
        kw = dict(self.model.score_kwargs())
        kw.pop("model", None)
        return kw

    def _get_search_fn(self, k: int):
        fn = self._search_fns.get(k)
        if fn is None:
            fn = make_sharded_search(
                self.index.mesh, k=k,
                model=self.model.score_kwargs()["model"],
                global_idf=self.global_idf, packed=True,
                **self._model_kwargs())
            self._search_fns[k] = fn
        return fn

    def _get_scores_fn(self):
        if self._scores_fn is None:
            self._scores_fn = make_sharded_scores(
                self.index.mesh,
                model=self.model.score_kwargs()["model"],
                global_idf=self.global_idf, **self._model_kwargs())
        return self._scores_fn

    def search(self, queries: list[str], k: int | None = None,
               *, unbounded: bool = False):
        """Chunks are pipelined ``pipeline_depth`` deep, as in
        :meth:`tfidf_tpu_torch.engine.searcher.Searcher.search`: later
        chunks' steps are dispatched before earlier chunks' packed top-k
        buffers are fetched."""
        snap = self.index.snapshot
        self._on_snapshot(snap)
        if snap is None or snap.total_live == 0 or not queries:
            return [[] for _ in queries]
        if unbounded:
            return self._search_unbounded(snap, queries, k)
        k = self.top_k if k is None else k
        cap = self._batch_cap(len(queries))

        def dispatch(chunk):
            qb, _widest = self._vectorize(chunk,
                                          self._batch_cap(len(chunk)))
            return (chunk,) + self._dispatch_chunk(snap, qb, k)

        from tfidf_tpu_torch.ops.topk import fetch_packed

        out = self._run_pipelined(
            (queries[lo:lo + cap]
             for lo in range(0, len(queries), cap)),
            dispatch,
            lambda chunk, packed, kk: (chunk, fetch_packed(packed), kk),
            lambda chunk, arr, kk: self._finish_chunk(snap, chunk, arr,
                                                      kk))
        global_metrics.inc("queries_served", len(queries))
        return out

    def _on_snapshot(self, snap) -> None:
        """Layout hook: called with the snapshot each search (lets
        subclasses drop per-snapshot caches when the version moves)."""

    def _dispatch_chunk(self, snap, qb, k: int):
        """Layout hook: launch one chunk's packed top-k (not fetched)."""
        kk = min(k, snap.arrays.doc_cap)
        return self._get_search_fn(kk)(snap.arrays, qb), kk

    def _finish_chunk(self, snap, chunk, packed, kk: int):
        # packed already crossed device->host in the fetch stage; this
        # runs on the caller's thread (views + hit assembly only)
        from tfidf_tpu_torch.ops.topk import unpack_topk
        vals, gids = unpack_topk(packed)
        return self._assemble_hits(snap, chunk, vals, gids, kk)

    def _search_unbounded(self, snap, queries, k):
        """Layout hook: the reference's unbounded (parity) results."""
        out = []
        cap = self._batch_cap(len(queries))
        for lo in range(0, len(queries), cap):
            chunk = queries[lo:lo + cap]
            qb, _widest = self._vectorize(chunk,
                                          self._batch_cap(len(chunk)))
            vals, gids, kk = self._rank_all(snap, qb)
            out.extend(self._assemble_hits(snap, chunk, vals, gids, kk))
        global_metrics.inc("queries_served", len(queries))
        return out

    def _assemble_hits(self, snap, chunk, vals, gids, kk):
        from tfidf_tpu_torch.engine.searcher import SearchHit
        results = []
        for i in range(len(chunk)):
            hits = []
            for v, g in zip(vals[i, :kk], gids[i, :kk]):
                if not (np.isfinite(v) and v > 0.0):
                    continue
                name = snap.name_of(int(g))
                if name is not None:
                    hits.append(SearchHit(name, float(v)))
            if self.result_order == "name":
                hits.sort(key=lambda h: h.name)
            results.append(hits)
        return results

    def _rank_all(self, snap: MeshSnapshot, qb):
        """Parity mode: full per-shard score matrices ranked on the host
        (the reference's unbounded Integer.MAX_VALUE results,
        ``Worker.java:230``). O(corpus) per query by definition."""
        scores = self._get_scores_fn()(snap.arrays, qb).cpu().numpy()
        D, B, doc_cap = scores.shape
        flat = scores.transpose(1, 0, 2).reshape(B, D * doc_cap)
        order = np.argsort(-flat, axis=1, kind="stable")
        vals = np.take_along_axis(flat, order, axis=1)
        return vals, order.astype(np.int64), D * doc_cap
