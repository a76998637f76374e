"""MeshEllIndex / MeshEllSearcher — ELL-base + COO-delta mesh serving.

The counterpart of ``tfidf_tpu/parallel/mesh_ell_index.py``, lifecycle
unchanged. The fast mesh layout (:mod:`tfidf_tpu_torch.parallel.mesh_ell`):
committed documents live in a blocked-ELL base scored by the hand-written
ELL kernel on every rank; appends land in a COO delta (the plain :class:`ShardedArrays` machinery)
and are folded into the base at the next re-shard — Lucene's
segments-then-merge shape at mesh scale. Global statistics (df, N,
avgdl) are recomputed over the LIVE corpus at every commit and pushed
replicated to the mesh, and base impacts are refreshed from them
on the devices, so scores always reflect current stats (the streaming-segment
contract) and — unlike the COO path, which keeps tombstones in df until
a re-shard — match the single-device rebuild engine exactly.

Not supported here (Engine falls back to the COO mesh layout):
``tfidf_cosine`` (norms per doc per commit) and Lucene local-stats
parity / unbounded results (parity is a correctness mode; it keeps the
scatter path).
"""

from __future__ import annotations

import numpy as np
import torch

from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.dfdelta import DfDeltaApplier
from tfidf_tpu_torch.parallel.mesh_ell import (MeshEllArrays,
                                               build_mesh_ell,
                                               make_impact_refresh,
                                               make_mesh_ell_search,
                                               with_ell_live)
from tfidf_tpu_torch.parallel.mesh_index import MeshIndex, MeshSearcher
from tfidf_tpu_torch.parallel.sharded import (ShardedArrays,
                                              build_sharded_arrays,
                                              live_host, with_live_mask)
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("parallel.mesh_ell_index")


class MeshEllSnapshot:
    """Published state: ELL base + COO delta + current global stats."""

    def __init__(self, *, base: MeshEllArrays, delta: ShardedArrays,
                 perms, base_counts, shard_docs, df_g, n_docs, avgdl,
                 version, nnz, total_live) -> None:
        self.base = base
        self.delta = delta
        self.perms = perms                 # per shard: ell_row -> ins id
        self.base_counts = base_counts     # docs in base per shard
        self.shard_docs = shard_docs
        self.df_g = df_g                   # f32 [vocab_cap] on mesh.home
        self.n_docs = n_docs               # f32 0-d (LIVE count)
        self.avgdl = avgdl
        self.version = version
        self.nnz = nnz
        self.total_live = total_live

    @property
    def stride(self) -> int:
        return self.base.doc_cap + self.delta.doc_cap

    def name_of(self, gid: int) -> str | None:
        s, local = divmod(gid, self.stride)
        if s >= len(self.shard_docs):
            return None
        sd = self.shard_docs[s]
        if local < self.base.doc_cap:      # ELL row -> permuted ins id
            perm = self.perms[s]
            if local >= perm.shape[0]:
                return None
            return sd[int(perm[local])].name
        delta_local = local - self.base.doc_cap
        ins = self.base_counts[s] + delta_local
        return sd[ins].name if ins < len(sd) else None


class MeshEllIndex(MeshIndex):
    """MeshIndex whose committed base is blocked ELL (the fast layout)."""

    def __init__(self, model, mesh=None, min_doc_cap: int = 1024,
                 min_chunk_cap: int = 1 << 14,
                 ell_width_cap: int = 256,
                 delta_rebuild_frac: float = 0.5,
                 incremental_stats: bool = True) -> None:
        super().__init__(model, mesh=mesh, min_doc_cap=min_doc_cap,
                         min_chunk_cap=min_chunk_cap)
        self.ell_width_cap = ell_width_cap
        # fold the delta into the base when it exceeds this fraction of
        # the corpus (the merge policy)
        self.delta_rebuild_frac = delta_rebuild_frac
        # False = the pre-incremental control path: every commit
        # recomputes df/N/avgdl from the live host postings (O(corpus
        # nnz)) and re-uploads the dense df — a control lever, never
        # the default
        self.incremental_stats = incremental_stats
        self._base: MeshEllArrays | None = None
        self._perms: list[np.ndarray] = []
        self._base_counts: list[int] = []
        self._refresh_fn = None
        # incremental live-corpus stats, maintained on every mutation so
        # commit is O(batch) host-side (full recompute only on rebuild)
        self._df_live = np.zeros(0, np.float64)
        self._n_live_stat = 0
        self._len_sum_stat = 0.0
        # journal of df changes since the last commit, O(1) per
        # mutation — the commit applies them as ONE sparse on-device
        # scatter into the replicated df instead of re-uploading the
        # whole [vocab_cap] array (2MB at 500k terms, the dominant
        # steady-commit cost)
        self._df_delta = DfDeltaApplier()
        # witness: commits that paid the O(corpus nnz) host stat
        # recompute (rebuild resync / vocab growth / the control path).
        # Steady-state append/delete commits must leave it untouched —
        # the tests pin that.
        self.df_full_recomputes = 0
        # append traffic observed (attempted, not just succeeded —
        # a first burst bigger than the floor delta overflows BEFORE
        # any append succeeds): gates `_empty_delta`'s threshold
        # sizing so read-mostly indexes never reserve delta memory
        self._append_attempts = 0

    # ---- incremental stats bookkeeping ----

    def _stat_add(self, entry) -> None:
        ids = entry.term_ids
        if ids.shape[0]:
            hi = int(ids.max()) + 1
            if hi > self._df_live.shape[0]:
                grown = np.zeros(max(hi, 2 * self._df_live.shape[0]),
                                 np.float64)
                grown[:self._df_live.shape[0]] = self._df_live
                self._df_live = grown
            np.add.at(self._df_live, ids, 1.0)
            self._df_delta.record(ids, 1.0)
        self._n_live_stat += 1
        self._len_sum_stat += entry.length

    def _stat_remove(self, entry) -> None:
        ids = entry.term_ids
        if ids.shape[0]:
            np.add.at(self._df_live, ids, -1.0)
            self._df_delta.record(ids, -1.0)
        self._n_live_stat -= 1
        self._len_sum_stat -= entry.length

    def add_document_arrays(self, name, ids, tfs, length=None):
        from tfidf_tpu_torch.engine.index import (DocEntry,
                                            check_sorted_unique_ids)
        tfs = np.asarray(tfs, np.float32)
        ids = np.asarray(ids, np.int32)
        check_sorted_unique_ids(name, ids)
        entry = DocEntry(
            name=name, term_ids=ids, tfs=tfs,
            length=float(length if length is not None else tfs.sum()))
        with self._write_lock:
            old = self._pending.get(name)
            if old is not None:
                self._stat_remove(old)       # replaced in place
            else:
                placed = self._placed.pop(name, None)
                if placed is not None:       # upsert: tombstone old copy
                    s, local = placed
                    self._shard_docs[s][local].live = False
                    self._stat_remove(self._shard_docs[s][local])
                    self._mask_dirty = True
            self._pending[name] = entry
            self._stat_add(entry)
            self._gen += 1
        global_metrics.inc("docs_indexed")

    def _bulk_load_stats(self, term_ids, lengths) -> None:
        # vectorized resync: one bincount instead of a per-doc
        # _stat_add loop (the very loop bulk_load_packed removes). The
        # first commit takes the rebuild path (no base yet) and
        # re-syncs from the authoritative postings regardless; the
        # single journal entry keeps the invariant for safety.
        ids = term_ids.astype(np.int64)
        hi = int(ids.max()) + 1 if ids.size else 1
        self._df_live = np.bincount(ids, minlength=hi).astype(np.float64)
        self._n_live_stat = int(lengths.shape[0])
        self._len_sum_stat = float(np.asarray(lengths,
                                              np.float64).sum())
        self._df_delta.clear()
        self._df_delta.record(term_ids, 1.0)

    def delete_document(self, name: str) -> bool:
        with self._write_lock:
            entry = self._pending.pop(name, None)
            if entry is not None:
                self._stat_remove(entry)
                self._gen += 1
                return True
            placed = self._placed.pop(name, None)
            if placed is None:
                return False
            s, local = placed
            self._shard_docs[s][local].live = False
            self._stat_remove(self._shard_docs[s][local])
            self._mask_dirty = True
            self._gen += 1
            return True

    # ---- commit ----

    def commit(self, vocab_cap: int):
        with self._write_lock:
            gen0 = self._gen
            if (self._committed_gen == gen0 and self.snapshot is not None
                    and self.snapshot.df_g.shape[0] >= vocab_cap):
                return self.snapshot
            pending = list(self._pending.values())
            delta = self.snapshot.delta if self.snapshot else None
            need_rebuild = (
                self._base is None
                or vocab_cap > self.snapshot.df_g.shape[0]
                or self._delta_too_big(pending))
            if need_rebuild:
                self._rebuild_ell_locked(pending, vocab_cap)
                delta = self._empty_delta(vocab_cap)
            elif pending:
                try:
                    delta = self._append_locked(delta, pending)
                except ValueError as e:
                    log.info("delta overflow; folding into ELL base",
                             reason=str(e).split(";")[0])
                    self._rebuild_ell_locked(pending, vocab_cap)
                    delta = self._empty_delta(vocab_cap)
            self._pending = {}

            # live-corpus global stats (appends and deletes both move
            # them; the base impacts are refreshed below so IDF never
            # goes stale). After a rebuild the replicated df is uploaded
            # whole; otherwise the journaled changes land as one sparse
            # on-device scatter (O(touched terms), not O(vocab)).
            if not self.incremental_stats:
                # control path: full O(corpus nnz) recompute + dense
                # re-upload every commit
                df_host, n_live, len_sum = self._live_stats_scratch(
                    vocab_cap, include_pending=False)
                self.df_full_recomputes += 1
                df_g = torch.from_numpy(df_host).to(self.mesh.home)
                self._df_delta.clear()
            elif need_rebuild or self.snapshot is None:
                df_host, n_live, len_sum = self._live_stats(vocab_cap)
                df_g = torch.from_numpy(df_host).to(self.mesh.home)
                self._df_delta.clear()
            else:
                df_g = self._df_delta.apply(self.snapshot.df_g)
                n_live = self._n_live_stat
                len_sum = self._len_sum_stat
            home = self.mesh.home
            n_docs = torch.tensor(np.float32(n_live), device=home)
            avgdl = torch.tensor(
                np.float32(len_sum / n_live if n_live else 1.0),
                device=home)
            if self._refresh_fn is None:
                kw = self.model.score_kwargs()
                self._refresh_fn = make_impact_refresh(
                    self.mesh, model=kw["model"], k1=kw.get("k1", 1.2),
                    b=kw.get("b", 0.75))
            base = self._refresh_fn(self._base, df_g, n_docs, avgdl)
            # liveness only changes on delete/upsert (appends never touch
            # it, rebuilds drop tombstones and build a fresh all-live
            # mask) — rebuilding the masks every commit would be an
            # O(corpus) host loop on the serving path
            if self._mask_dirty:
                base = with_ell_live(self.mesh, base,
                                     self._ell_mask(base))
                delta = with_live_mask(self.mesh, delta,
                                       self._delta_mask(delta.doc_cap))
                self._mask_dirty = False
            self._base = base
            self._version += 1
            snap = MeshEllSnapshot(
                base=base, delta=delta, perms=self._perms,
                base_counts=list(self._base_counts),
                shard_docs=self._shard_docs,
                df_g=df_g, n_docs=n_docs, avgdl=avgdl,
                version=self._version, nnz=self.nnz_live,
                total_live=len(self._placed))
            self.snapshot = snap
            self._committed_gen = gen0
        global_metrics.set_gauge("index_docs", snap.total_live)
        global_metrics.set_gauge("index_nnz", snap.nnz)
        log.info("committed mesh-ell snapshot", version=snap.version,
                 docs=snap.total_live, nnz=snap.nnz,
                 mesh=dict(self.mesh.shape))
        return snap

    def _delta_too_big(self, pending) -> bool:
        base_docs = sum(self._base_counts)
        delta_docs = (len(self._placed) + len(pending)) - base_docs
        return (base_docs == 0
                or delta_docs > self.delta_rebuild_frac * base_docs)

    def _live_stats(self, vocab_cap: int):
        """O(vocab) snapshot of the incrementally-maintained live stats
        (df counts are integers, so the float64 accumulators are exact;
        rebuilds resync from scratch as a belt)."""
        df = np.zeros(vocab_cap, np.float32)
        n = min(self._df_live.shape[0], vocab_cap)
        df[:n] = self._df_live[:n]
        return df, self._n_live_stat, self._len_sum_stat

    def _live_stats_scratch(self, vocab_cap: int,
                            include_pending: bool = True):
        """Full recompute over live postings (rebuild resync + tests).
        ``include_pending=False`` when pending was already merged into
        the shard lists (mid-rebuild)."""
        ids = []
        n = 0
        len_sum = 0.0
        for sd in self._shard_docs:
            for d in sd:
                if d.live:
                    ids.append(d.term_ids)
                    n += 1
                    len_sum += d.length
        if include_pending:
            for d in self._pending.values():
                ids.append(d.term_ids)
                n += 1
                len_sum += d.length
        if ids:
            allids = np.concatenate(ids)
            df = np.bincount(allids, minlength=vocab_cap)[:vocab_cap]
            df = df.astype(np.float32)
        else:
            df = np.zeros(vocab_cap, np.float32)
        return df, n, len_sum

    def _rebuild_ell_locked(self, pending, vocab_cap: int) -> None:
        """Fold everything (base + delta + pending) into a fresh ELL
        base with round-robin placement; drops tombstones."""
        entries = []
        for sd in self._shard_docs:
            entries.extend(d for d in sd if d.live)
        entries.extend(pending)
        per_shard = [[] for _ in range(self.D)]
        shard_docs = [[] for _ in range(self.D)]
        placed = {}
        for i, e in enumerate(entries):
            e.live = True
            s = i % self.D
            placed[e.name] = (s, len(shard_docs[s]))
            shard_docs[s].append(e)
            per_shard[s].append(e)
        # build FIRST; install the new placement only once the device
        # build succeeded — a failed build (OOM) must not leave _placed
        # pointing into arrays that were never installed
        base, perms = build_mesh_ell(
            per_shard, self.mesh, self.model.transform_doc_len,
            width_cap=self.ell_width_cap,
            min_rows=min(256, self.min_doc_cap))
        self._shard_docs = shard_docs
        self._placed = placed
        self._base = base
        self._perms = perms
        self._base_counts = [len(p) for p in per_shard]
        self._mask_dirty = False
        # resync the incremental stats from the authoritative postings
        # (pending was just merged into the shard lists above) — the
        # one O(corpus nnz) pass steady commits never take (witness)
        self.df_full_recomputes += 1
        df, n, len_sum = self._live_stats_scratch(
            max(vocab_cap, self._df_live.shape[0], 1),
            include_pending=False)
        self._df_live = df.astype(np.float64)
        self._n_live_stat = n
        self._len_sum_stat = len_sum
        self.rebuilds += 1
        global_metrics.inc("mesh_reshards")

    def _empty_delta(self, vocab_cap: int) -> ShardedArrays:
        """Fresh COO delta. For an index that has OBSERVED appends, it
        is sized to cover the MERGE POLICY's fold threshold
        (delta_rebuild_frac x the base corpus): a delta floored at 256
        docs/shard whatever the corpus size would overflow its capacity
        — an unplanned O(corpus) rebuild — every ~256 docs/shard, long
        before the planned fold. Threshold sizing means the planned
        `_delta_too_big` fold is what ends a delta's life, and every
        commit in between is an O(batch) device append + sparse df
        scatter. Memory cost: the delta's COO arrays scale with delta_rebuild_frac x
        corpus nnz (~12B/entry across the terms axis) — so a
        READ-MOSTLY index (appends == 0 so far: bulk-load-and-serve)
        keeps the small floor delta and reserves nothing; the first
        append burst pays ONE amortized overflow rebuild to promote to
        threshold sizing."""
        min_doc = min(256, self.min_doc_cap)
        min_chunk = self.min_chunk_cap
        if self._append_attempts:
            base_docs = sum(self._base_counts)
            per_shard_docs = -(-int(base_docs * self.delta_rebuild_frac)
                               // max(self.D, 1))
            per_slice_nnz = -(-int(self.nnz_live
                                   * self.delta_rebuild_frac)
                              // max(self.D * self.T, 1))
            min_doc = max(min_doc,
                          next_capacity(per_shard_docs + 1, min_doc))
            min_chunk = max(min_chunk,
                            next_capacity(max(per_slice_nnz, 1),
                                          1 << 10))
        coo = CooShard(
            tf=np.zeros(0, np.float32), term=np.zeros(0, np.int32),
            doc=np.zeros(0, np.int32),
            doc_len=np.zeros(0, np.float32),
            df=np.zeros(vocab_cap, np.float32), nnz=0, num_docs=0)
        return build_sharded_arrays(
            coo, self.mesh, min_chunk_cap=min_chunk,
            min_doc_cap=min_doc)

    def _append_locked(self, delta: ShardedArrays,
                       pending) -> ShardedArrays:
        """Append into the COO delta. Placement slots continue after the
        base: insertion-local id = base_count + delta slot."""
        self._append_attempts += 1
        # reuse the parent's machinery; it reads/updates _shard_docs and
        # _placed with insertion-local ids, and build_ingest_batch's
        # local ids continue from delta.n_live — these agree because
        # delta slot = insertion id - base_count (appends only)
        loads = [sum(d.term_ids.nbytes + d.tfs.nbytes
                     for d in sd if d.live) for sd in self._shard_docs]
        slots = [len(sd) - bc for sd, bc in
                 zip(self._shard_docs, self._base_counts)]
        per_entries = [[] for _ in range(self.D)]
        for e in pending:
            s = int(np.argmin(loads))
            per_entries[s].append(e)
            loads[s] += e.term_ids.nbytes + e.tfs.nbytes
            slots[s] += 1
            if slots[s] > delta.doc_cap:
                raise ValueError("delta over doc capacity; re-shard")
        from tfidf_tpu_torch.parallel.sharded import (build_ingest_batch,
                                                make_sharded_ingest)
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
        batch = build_ingest_batch(self.mesh, delta, per_docs, per_lens,
                                   C, raw_lengths_per_shard=per_raw)
        if self._ingest_fn is None:
            make = make_sharded_ingest
            self._ingest_fn = make(self.mesh)
        delta = self._ingest_fn(delta, *batch)
        for s, es in enumerate(per_entries):
            for e in es:
                self._placed[e.name] = (s, len(self._shard_docs[s]))
                self._shard_docs[s].append(e)
        self.appends += 1
        global_metrics.inc("mesh_appends")
        return delta

    # ---- masks ----

    def _ell_mask(self, base: MeshEllArrays) -> np.ndarray:
        mask = np.zeros((self.D, base.doc_cap), np.float32)
        for s, (perm, bc) in enumerate(zip(self._perms,
                                           self._base_counts)):
            if not bc:
                continue
            live = np.fromiter((d.live for d in self._shard_docs[s][:bc]),
                               np.float32, bc)
            mask[s, :perm.shape[0]] = live[perm]
        return mask

    def _delta_mask(self, doc_cap: int) -> np.ndarray:
        mask = np.zeros((self.D, doc_cap), np.float32)
        for s, bc in enumerate(self._base_counts):
            sd = self._shard_docs[s]
            n = len(sd) - bc
            if n:
                mask[s, :n] = np.fromiter((d.live for d in sd[bc:]),
                                          np.float32, n)
        return mask



class MeshEllSearcher(MeshSearcher):
    """MeshSearcher over the ELL base + delta snapshot."""

    # Hard cap on corpus size for the unbounded parity fallback: the
    # fallback rebuilds a full duplicate COO MeshIndex (host loop over
    # every live doc + a device commit) and roughly doubles device memory
    # residency while cached. That is fine as a correctness tool at
    # test scale, but a stray ``unbounded=True`` against a large
    # serving engine must fail fast instead of stalling the node for
    # minutes. Raise the attribute explicitly on a searcher instance to
    # opt in to a bigger parity replay.
    unbounded_parity_max_docs: int = 200_000

    def _get_search_fn(self, k: int):
        fn = self._search_fns.get(k)
        if fn is None:
            fn = make_mesh_ell_search(
                self.index.mesh, k=k,
                model=self.model.score_kwargs()["model"],
                a_build=self.kernel_a_build,
                packed=True, **self._model_kwargs())
            self._search_fns[k] = fn
        return fn

    def _on_snapshot(self, snap) -> None:
        # the parity-fallback cache pins a full device-resident COO copy
        # of the corpus; release it as soon as the snapshot advances
        # instead of holding stale memory until the next unbounded call
        cached = getattr(self, "_unbounded_cache", None)
        if cached is not None and (snap is None
                                   or cached[0] != snap.version):
            self._unbounded_cache = None

    def _dispatch_chunk(self, snap, qb, k: int):
        kk = min(k, snap.stride)
        return self._get_search_fn(kk)(
            snap.base, snap.delta, snap.df_g, snap.n_docs,
            snap.avgdl, qb), kk

    def _search_unbounded(self, snap, queries, k):
        # the ELL base cannot rank every matching document (its row
        # space is permuted and lives behind top-k); serve parity
        # requests by scoring the same live postings through a COO mesh
        # engine instead of erroring
        return self._search_unbounded_coo(snap, queries, k)

    def _search_unbounded_coo(self, snap, queries, k):
        """Per-call parity fallback: replay the
        COMMITTED snapshot's postings into a COO mesh index and rank
        every match there. Slow by design — parity mode is a correctness
        tool, not the serving path — but a per-request ``unbounded=True``
        must not 500. The document set comes from the snapshot's own
        device live masks (not the mutable index state), so unbounded
        and bounded answers on the same searcher agree even with
        uncommitted writes in flight. The throwaway searcher is cached
        by snapshot version — parity harnesses issuing many unbounded
        calls against one snapshot pay the O(corpus) replay once."""
        from tfidf_tpu_torch.parallel.mesh_index import MeshIndex, MeshSearcher

        cached = getattr(self, "_unbounded_cache", None)
        if cached is not None and cached[0] == snap.version:
            return cached[1].search(queries, k=k, unbounded=True)
        total_live = int(float(snap.n_docs))
        if total_live > self.unbounded_parity_max_docs:
            raise ValueError(
                f"unbounded=True parity fallback refused: snapshot holds "
                f"{total_live} live docs > cap "
                f"{self.unbounded_parity_max_docs}. The fallback rebuilds "
                f"a duplicate COO index (O(corpus) host replay + ~2x device "
                f"memory); "
                f"it is a parity/testing tool, not a serving path. Set "
                f"searcher.unbounded_parity_max_docs explicitly to opt in.")
        T = self.index.T
        base_live = np.stack([x.cpu().numpy()        # [D, doc_cap_ell]
                              for x in snap.base.live[::T]])
        delta_live = live_host(snap.delta)           # [D, doc_cap_delta]
        delta_n = snap.delta.n_live                  # [D]
        entries = []  # snapshot-live docs, reconstructed from the masks
        for s, sd in enumerate(snap.shard_docs):
            perm, bc = snap.perms[s], snap.base_counts[s]
            for ell_row in range(perm.shape[0]):
                if base_live[s, ell_row] > 0:
                    entries.append(sd[int(perm[ell_row])])
            for slot in range(int(delta_n[s])):
                if delta_live[s, slot] > 0:
                    entries.append(sd[bc + slot])
        idx = MeshIndex(self.index.model, mesh=self.index.mesh,
                        min_doc_cap=self.index.min_doc_cap,
                        min_chunk_cap=self.index.min_chunk_cap)
        for e in entries:
            idx.add_document_arrays(e.name, e.term_ids, e.tfs, e.length)
        idx.commit(max(self.vocab.capacity(), 1))
        searcher = MeshSearcher(
            idx, self.analyzer, self.vocab, self.model,
            query_batch=self.query_batch,
            max_query_terms=self.max_query_terms,
            top_k=self.top_k, result_order=self.result_order)
        self._unbounded_cache = (snap.version, searcher)
        return searcher.search(queries, k=k, unbounded=True)
