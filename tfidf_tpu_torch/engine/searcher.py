"""Query execution against a committed snapshot, on a torch device.

The counterpart of ``tfidf_tpu/engine/searcher.py``: analyze + pad a
query batch on the host, score it on the device, take the exact top-k
there, and fetch one packed buffer per chunk. Local ELL and COO snapshots,
and the streaming segments' snapshots: untiered ones score every segment
in one pass; tiered ones score the hot set, then walk the cold segments
in bound order, skipping those that provably cannot reach the top-k
(:meth:`Searcher._dispatch_tiered`). Only documents with a positive score
are returned; unknown query terms are dropped.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np

from tfidf_tpu_torch.engine.index import ShardIndex, Snapshot
from tfidf_tpu_torch.engine.pipeline import PipelineExecutor
from tfidf_tpu_torch.engine.segments import SegmentedSnapshot
from tfidf_tpu_torch.engine.vocab import Vocabulary
from tfidf_tpu_torch.models.base import ScoringModel
from tfidf_tpu_torch.ops.analyzer import Analyzer
from tfidf_tpu_torch.ops.blockmax import query_upper_bounds, skip_mask
from tfidf_tpu_torch.ops.csr import next_capacity
from tfidf_tpu_torch.ops.ell import (check_a_build, score_ell_batch,
                                     score_segments_batch)
from tfidf_tpu_torch.ops.scoring import (QueryBatch, make_query_batch,
                                         score_coo_batch)
from tfidf_tpu_torch.ops.topk import (fetch_packed, full_ranking,
                                      packed_topk, packed_topk_chunked,
                                      unpack_topk)
from tfidf_tpu_torch.utils.device_nemesis import DevicePoisonedOutput
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import trace_phase


class SearchHit(NamedTuple):
    name: str
    score: float


# guards lazy per-searcher PipelineExecutor construction
_pipe_init_lock = threading.Lock()


def vectorize_queries(queries: list[str], analyzer: Analyzer,
                      vocab: Vocabulary, model: ScoringModel,
                      *, batch_cap: int, max_terms: int,
                      min_slots: int = 256,
                      device=None) -> tuple[QueryBatch, int]:
    """Analyze + pad a query batch to [batch_cap, max_terms] and dedup
    its terms into a compact slot space (:class:`QueryBatch` on
    ``device``). Returns ``(batch, max distinct terms in any one
    query)``. Queries with more than ``max_terms`` distinct terms keep
    the highest-weight terms."""
    assert len(queries) <= batch_cap
    q_terms = np.zeros((batch_cap, max_terms), np.int32)
    q_weights = np.zeros((batch_cap, max_terms), np.float32)
    widest = 1
    for i, q in enumerate(queries):
        counts = vocab.map_counts(analyzer.counts(q), add=False)
        weights = model.query_weights(counts)
        items = sorted(weights.items(), key=lambda kv: (-kv[1], kv[0]))
        items = items[:max_terms]
        widest = max(widest, len(items))
        for j, (tid, w) in enumerate(items):
            q_terms[i, j] = tid
            q_weights[i, j] = w
    return make_query_batch(q_terms, q_weights, min_slots=min_slots,
                            device=device), widest


class QueryVectorizerMixin:
    """The unique-term capacity high-water policy (``min_slots`` floored
    at the largest u_cap seen, so the block shapes stay stable across
    batches) and the ONE implementation of depth-N chunk pipelining.
    Hosts provide analyzer/vocab/model/max_query_terms/device."""

    _u_floor = 256
    _pipe: PipelineExecutor | None = None
    pipeline_mode = "auto"

    def _vectorize(self, queries, cap):
        qb, widest = vectorize_queries(
            queries, self.analyzer, self.vocab, self.model,
            batch_cap=cap, max_terms=self.max_query_terms,
            min_slots=self._u_floor, device=self.device)
        self._u_floor = max(self._u_floor, qb.uniq.shape[0])
        return qb, widest

    def _pipeline(self) -> PipelineExecutor:
        """The searcher's shared dispatch/fetch executor (lazy)."""
        pipe = self._pipe
        if pipe is None:
            with _pipe_init_lock:
                pipe = self._pipe
                if pipe is None:
                    pipe = self._pipe = PipelineExecutor(
                        depth=max(1, getattr(self, "pipeline_depth",
                                             1)),
                        name="search")
        return pipe

    def _use_executor(self) -> bool:
        """Resolve ``pipeline_mode``: "auto" keeps the CPU inline (a
        fetch is a memory view there and thread hand-offs cost more than
        they hide) and uses the executor on a CUDA device, where the
        fetch waits for the device."""
        mode = getattr(self, "pipeline_mode", "auto")
        if mode == "executor":
            return True
        if mode == "inline":
            return False
        return self.device.type != "cpu"

    def _run_pipelined(self, chunks, dispatch, fetch, assemble) -> list:
        """Run chunks with up to ``pipeline_depth`` overlapped fetches:
        ``dispatch(chunk) -> state`` launches device work,
        ``fetch(*state) -> fetched`` is the single d2h transfer,
        ``assemble(*fetched) -> hits`` runs on the caller's thread."""
        if not self._use_executor():
            return self._run_inline(chunks, dispatch, fetch, assemble)
        pipe = self._pipeline()
        futures = [pipe.submit(lambda c=chunk: dispatch(c), fetch)
                   for chunk in chunks]
        out: list = []
        try:
            for fut in futures:
                out.extend(assemble(*fut.result()))
        except BaseException:
            for fut in futures:
                fut.cancel()
            raise
        return out

    def _run_inline(self, chunks, dispatch, fetch, assemble) -> list:
        """Single-thread dispatch-then-drain over the same three
        stages."""
        from collections import deque

        depth = max(1, getattr(self, "pipeline_depth", 1))
        pending: deque = deque()
        out: list = []
        for chunk in chunks:
            pending.append(dispatch(chunk))
            if len(pending) > depth:
                out.extend(assemble(*fetch(*pending.popleft())))
        while pending:
            out.extend(assemble(*fetch(*pending.popleft())))
        return out


class Searcher(QueryVectorizerMixin):
    def __init__(self, index: ShardIndex, analyzer: Analyzer,
                 vocab: Vocabulary, model: ScoringModel,
                 *, query_batch: int = 32, max_query_terms: int = 32,
                 top_k: int = 10, result_order: str = "score",
                 use_pallas: bool = False,
                 kernel_a_build: str = "v4",
                 pipeline_depth: int = 2,
                 pipeline_mode: str = "auto") -> None:
        self.index = index
        self.device = index.device
        self.analyzer = analyzer
        self.vocab = vocab
        self.model = model
        self.query_batch = query_batch
        self.max_query_terms = max_query_terms
        self.top_k = top_k
        # "name" reproduces the reference's alphabetical result ordering
        self.result_order = result_order
        # True: blocks inside the kernel envelope take the CUDA kernel
        # (on a CPU device its plain version)
        self.use_pallas = use_pallas
        self.kernel_a_build = check_a_build(kernel_a_build)
        self.pipeline_depth = max(1, pipeline_depth)
        self.pipeline_mode = pipeline_mode

    def _batch_cap(self, n: int) -> int:
        return min(self.query_batch, next_capacity(max(n, 1), 1))

    def _chunks(self, queries: list[str]):
        cap = self._batch_cap(len(queries))
        return (queries[lo:lo + cap] for lo in range(0, len(queries), cap))

    def search(self, queries: list[str], k: int | None = None,
               *, unbounded: bool = False) -> list[list[SearchHit]]:
        """Score queries against the current snapshot. ``unbounded=True``
        returns every matching document (parity mode) via a full
        ranking; exact top-k is the fast path, pipelined
        ``pipeline_depth`` chunks deep."""
        snap = self.index.snapshot
        if snap is None or not snap.num_names or not queries:
            return [[] for _ in queries]
        k = self.top_k if k is None else k
        if unbounded:
            out = []
            for chunk in self._chunks(queries):
                out.extend(self._search_unbounded(snap, chunk))
        else:
            out = self._run_pipelined(
                self._chunks(queries),
                lambda chunk: (chunk,) + self._dispatch_chunk(snap, chunk,
                                                              k),
                lambda chunk, packed, kk: (chunk, fetch_packed(packed),
                                           kk),
                lambda chunk, arr, kk: self._finish_chunk(snap, chunk, arr,
                                                          kk))
        global_metrics.inc("queries_served", len(queries))
        return out

    def search_arrays(self, queries: list[str], k: int | None = None):
        """Pipelined exact top-k returning the raw result arrays —
        ``(vals [N, kk] f32, ids [N, kk] i32, kk, names)``; ``ids`` index
        ``names``, and entries whose value is non-finite or <= 0 are
        dead."""
        snap = self.index.snapshot
        k = self.top_k if k is None else k
        if snap is None or not snap.num_names or not queries:
            n = len(queries)
            return (np.zeros((n, 0), np.float32),
                    np.zeros((n, 0), np.int32), 0, [])
        kk = min(k, snap.num_names)
        parts = self._run_pipelined(
            self._chunks(queries),
            lambda chunk: (chunk,) + self._dispatch_chunk(snap, chunk, k),
            lambda chunk, packed, kk_: (chunk, fetch_packed(packed), kk_),
            lambda chunk, arr, kk_: [self._checked_unpack(chunk, arr)])
        vals = np.concatenate([p[0] for p in parts], axis=0)
        ids = np.concatenate([p[1] for p in parts], axis=0)
        global_metrics.inc("queries_served", len(queries))
        return vals, ids, kk, self._names(snap)

    @staticmethod
    def _names(snap):
        """What result ids index: a segmented snapshot's ids live in the
        concatenated padded segment space (None at pad slots)."""
        return (snap.padded_names if isinstance(snap, SegmentedSnapshot)
                else snap.doc_names)

    def _score_chunk(self, snap: Snapshot, queries: list[str]):
        cap = self._batch_cap(len(queries))
        with trace_phase("vectorize"):
            qb, _widest = self._vectorize(queries, cap)
        with trace_phase("score"):
            if isinstance(snap, SegmentedSnapshot):
                # tiered snapshots publish no eager views; materialize
                # them all (faulting in the whole cold tier) — this IS
                # the untiered computation, used by the unbounded path
                # and the tier_bypass parity oracle
                views = (snap.views if snap.tier is None
                         else snap.tier.all_views(snap))
                scores = score_segments_batch(
                    views, snap.df, qb, snap.n_docs, snap.avgdl,
                    **self.model.score_kwargs())
            elif snap.is_ell:
                scores = score_ell_batch(
                    snap.ell_impacts, snap.ell_terms, snap.ell_impacts_t,
                    snap.ell_terms_t, snap.ell_live,
                    snap.res_tf, snap.res_term, snap.res_doc,
                    snap.doc_len, snap.df, qb,
                    snap.n_docs, snap.avgdl, snap.doc_norms,
                    use_pallas=self.use_pallas,
                    a_build=self.kernel_a_build,
                    res_plan=snap.res_plan,
                    **self.model.score_kwargs())
            else:
                scores = score_coo_batch(
                    snap.tf, snap.term, snap.doc, snap.doc_len, snap.df,
                    qb, snap.n_docs, snap.avgdl, snap.doc_norms,
                    plan=snap.coo_plan, **self.model.score_kwargs())
        return scores

    # oracle switch: True forces tiered snapshots through the untiered
    # scoring path (every segment faulted in + scored) — the parity
    # baseline the skipping path is held to
    tier_bypass = False

    def _dispatch_chunk(self, snap: Snapshot, queries: list[str],
                        k: int):
        """Launch one chunk's device work; returns (packed, kk) with the
        packed top-k still on the device (a tiered chunk's is a host
        array already)."""
        if isinstance(snap, SegmentedSnapshot) and snap.tier is not None \
                and not self.tier_bypass:
            return self._dispatch_tiered(snap, queries, k)
        scores = self._score_chunk(snap, queries)
        with trace_phase("topk"):
            kk = min(k, snap.num_names)
            return packed_topk_chunked(scores, snap.num_docs, k=kk), kk

    def _dispatch_tiered(self, snap: SegmentedSnapshot,
                         queries: list[str], k: int):
        """Tiered top-k: score the HOT segments in one pass, then walk the
        COLD segments in descending bound order, skipping every segment
        whose block-max upper bound proves it cannot beat the current
        kk-th positive candidate and faulting in the rest through the
        upload ring (the next candidates prefetched, so their uploads run
        behind this segment's scoring).

        Exactness: a segment scored alone gives the bits of its slice of
        the full batch (``score_segments_impl``); (hot top-kk ∪ each
        scored cold segment's top-kk) ⊇ the global top-kk over live
        positive docs; skipped segments are provably below the kk-th
        positive candidate (STRICT comparison — an equal score could still
        displace on the (-score, gid) tie-break, so equality faults in).
        The host merge reproduces the top-k order: descending score,
        ascending gid on ties. Returns a HOST array in the packed
        ``[B, 2·kk]`` wire layout (``fetch_packed`` passes it through)."""
        tier = snap.tier
        B = len(queries)
        cap = self._batch_cap(B)
        kk = min(k, snap.num_names)
        skw = self.model.score_kwargs()
        with trace_phase("vectorize"):
            qb, _widest = self._vectorize(queries, cap)
        handles = list(snap.cold)
        if handles:
            # per-query f64 term weights in the batch's compact slot
            # space (the host mirror of _compile_queries' qc_ext; column
            # u_cap collects the pad writes and is dropped). Read before
            # the hot pass is queued: the copy then waits only for the
            # batch's own upload.
            U = qb.n_uniq
            u_cap = qb.uniq.shape[0]
            slots = qb.slots.cpu().numpy()
            qc = np.zeros((cap, u_cap + 1), np.float64)
            rows = np.repeat(np.arange(cap), slots.shape[1])
            np.add.at(qc, (rows, slots.reshape(-1)),
                      qb.weights.cpu().numpy().astype(np.float64)
                      .reshape(-1))
            qc = qc[:B, :U]   # REAL query rows only: a padded row's
            # qc is all-zero -> bound exactly 0 -> always skippable

        # ---- hot pass: one scoring pass over the resident set ----
        cand_vals = np.zeros((B, 0), np.float64)
        cand_gids = np.zeros((B, 0), np.int64)

        def add_candidates(vals, gids):
            nonlocal cand_vals, cand_gids
            cand_vals = np.concatenate(
                [cand_vals, vals.astype(np.float64)], axis=1)
            cand_gids = np.concatenate(
                [cand_gids, gids.astype(np.int64)], axis=1)

        if snap.hot:
            with trace_phase("score_hot"):
                hot_views = tuple(v for _i, _b, v in snap.hot)
                hot_caps = [int(v.live_mask.shape[0]) for v in hot_views]
                hot_total = int(sum(hot_caps))
                scores = score_segments_batch(
                    hot_views, snap.df, qb, snap.n_docs, snap.avgdl,
                    **skw)
                packed = packed_topk_chunked(scores, hot_total,
                                             k=min(kk, hot_total))
                del scores
                hvals, hids = unpack_topk(packed)
            # concat-local index -> global gid (hot segments need not be
            # contiguous in the snapshot's gid space)
            offs = np.cumsum([0] + hot_caps)
            hbase = np.asarray([b for _i, b, _v in snap.hot], np.int64)
            seg_of = np.searchsorted(offs, hids[:B], side="right") - 1
            gids = hbase[seg_of] + (hids[:B] - offs[seg_of])
            add_candidates(hvals[:B], gids)
            tier.touch_hot([snap.segments[i] for i, _b, _v in snap.hot])

        def thresholds() -> np.ndarray:
            """Per query: the kk-th largest strictly-positive candidate
            (-inf when fewer than kk positives exist — only positive
            scores fill the result quota)."""
            pos = np.where(cand_vals > 0.0, cand_vals, -np.inf)
            if pos.shape[1] < kk:
                return np.full(B, -np.inf)
            return -np.partition(-pos, kk - 1, axis=1)[:, kk - 1]

        # ---- block-max bounds for every cold segment ----
        ub_of = {}
        if handles:
            uniq_terms = qb.uniq_host[:U].astype(np.int64)
            df_u = snap.df_host[uniq_terms].astype(np.float64)
            for h in handles:
                ub_of[id(h)] = query_upper_bounds(
                    h.bounds, uniq_terms, qc, df_u, snap.n_docs_f,
                    snap.avgdl_f, margin=tier.skip_margin,
                    **{kw: skw[kw] for kw in ("model", "k1", "b")
                       if kw in skw})
            # visit the likeliest contributors first: thresholds only
            # rise, so a high-bound-first walk maximizes later skips
            handles.sort(key=lambda h: -float(ub_of[id(h)].max())
                         if ub_of[id(h)].shape[0] else 0.0)
        tier.note_considered(len(handles))

        # ---- cold walk: skip by bound, else fault in + score ----
        skipped = 0
        for pos_i, h in enumerate(handles):
            thresh = thresholds()
            if tier.skip_enabled \
                    and skip_mask(ub_of[id(h)], thresh).all():
                skipped += 1
                continue
            # queue THIS segment's upload first, then prefetch the
            # upcoming survivors ring_depth deep — the single-worker ring
            # keeps submission order, so the wait below blocks on this
            # segment only while the next uploads stream behind it
            tier.prefetch(h.seg)
            for nh in handles[pos_i + 1:pos_i + 1 + tier.ring_depth]:
                if not tier.skip_enabled \
                        or not skip_mask(ub_of[id(nh)], thresh).all():
                    tier.prefetch(nh.seg)
            view = tier.handle_view(h)
            with trace_phase("score_cold"):
                seg_scores = score_segments_batch(
                    (view,), snap.df, qb, snap.n_docs, snap.avgdl, **skw)
                cap_i = int(view.live_mask.shape[0])
                packed = packed_topk(seg_scores, cap_i, k=min(kk, cap_i))
                del seg_scores
                svals, sids = unpack_topk(packed)
            add_candidates(svals[:B], sids[:B].astype(np.int64) + h.base)
        tier.note_skips(skipped)

        # ---- host merge into the packed wire layout ----
        with trace_phase("topk"):
            C = cand_vals.shape[1]
            if C < kk:   # fewer candidate lanes than the quota: pad
                pad = kk - C
                cand_vals = np.concatenate(
                    [cand_vals, np.full((B, pad), -np.inf)], axis=1)
                cand_gids = np.concatenate(
                    [cand_gids, np.zeros((B, pad), np.int64)], axis=1)
            order = np.lexsort((cand_gids, -cand_vals), axis=-1)[:, :kk]
            rsel = np.arange(B)[:, None]
            top_v = np.ascontiguousarray(
                cand_vals[rsel, order].astype(np.float32))
            top_g = cand_gids[rsel, order].astype(np.int32)
            arr = np.zeros((B, 2 * kk), np.int32)
            arr[:, :kk] = top_v.view(np.int32)
            arr[:, kk:] = top_g
        return arr, kk

    def _finish_chunk(self, snap: Snapshot, queries: list[str],
                      packed, kk: int) -> list[list[SearchHit]]:
        vals, ids = unpack_topk(packed)
        return self._assemble(snap, queries, vals, ids, kk)

    def _search_unbounded(self, snap: Snapshot,
                          queries: list[str]) -> list[list[SearchHit]]:
        scores = self._score_chunk(snap, queries)
        with trace_phase("rank_all"):
            # segmented doc ids interleave padding, so rank the whole
            # padded space (pads score 0 and are filtered out)
            rank_n = (scores.shape[-1]
                      if isinstance(snap, SegmentedSnapshot)
                      else snap.num_names)
            vals, ids = full_ranking(scores, rank_n)
            vals = vals.cpu().numpy()
            ids = ids.cpu().numpy()
        return self._assemble(snap, queries, vals, ids, rank_n)

    def _checked_unpack(self, chunk: list[str], arr):
        vals, ids = unpack_topk(arr[:len(chunk)])
        self._poison_check(chunk, vals)
        return vals, ids

    @staticmethod
    def _poison_check(queries: list[str], vals) -> None:
        """A fetched result row holding NaN is never legitimate (scores
        are finite by construction): the device produced garbage for
        those queries, named in the raised fault."""
        rows = np.isnan(vals[:len(queries)]).any(axis=tuple(
            range(1, vals.ndim)))
        if rows.any():
            raise DevicePoisonedOutput(tuple(
                q for q, bad in zip(queries, rows) if bad))

    def _assemble(self, snap: Snapshot, queries: list[str], vals, ids,
                  kk: int) -> list[list[SearchHit]]:
        self._poison_check(queries, vals)
        names = self._names(snap)
        results: list[list[SearchHit]] = []
        for i in range(len(queries)):
            hits = [SearchHit(names[int(d)], float(v))
                    for v, d in zip(vals[i, :kk], ids[i, :kk])
                    if np.isfinite(v) and v > 0.0]
            if self.result_order == "name":
                hits.sort(key=lambda h: h.name)
            results.append(hits)
        return results
