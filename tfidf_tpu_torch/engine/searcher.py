"""Query execution against a committed snapshot, on a torch device.

The counterpart of ``tfidf_tpu/engine/searcher.py`` for the local ELL and
COO snapshots: analyze + pad a query batch on the host, score it on the
device, take the exact top-k there, and fetch one packed buffer per
chunk. Only documents with a positive score are returned; unknown query
terms are dropped. Segmented and tiered snapshots are not ported yet.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np

from tfidf_tpu_torch.engine.index import ShardIndex, Snapshot
from tfidf_tpu_torch.engine.pipeline import PipelineExecutor
from tfidf_tpu_torch.engine.vocab import Vocabulary
from tfidf_tpu_torch.models.base import ScoringModel
from tfidf_tpu_torch.ops.analyzer import Analyzer
from tfidf_tpu_torch.ops.csr import next_capacity
from tfidf_tpu_torch.ops.ell import check_a_build, score_ell_batch
from tfidf_tpu_torch.ops.scoring import (QueryBatch, make_query_batch,
                                         score_coo_batch)
from tfidf_tpu_torch.ops.topk import (fetch_packed, full_ranking,
                                      packed_topk_chunked, unpack_topk)
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
        return vals, ids, kk, snap.doc_names

    def _score_chunk(self, snap: Snapshot, queries: list[str]):
        cap = self._batch_cap(len(queries))
        with trace_phase("vectorize"):
            qb, _widest = self._vectorize(queries, cap)
        with trace_phase("score"):
            if snap.is_ell:
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

    def _dispatch_chunk(self, snap: Snapshot, queries: list[str],
                        k: int):
        """Launch one chunk's device work; returns (packed, kk) with the
        packed top-k still on the device."""
        scores = self._score_chunk(snap, queries)
        with trace_phase("topk"):
            kk = min(k, snap.num_names)
            return packed_topk_chunked(scores, snap.num_docs, k=kk), kk

    def _finish_chunk(self, snap: Snapshot, queries: list[str],
                      packed, kk: int) -> list[list[SearchHit]]:
        vals, ids = unpack_topk(packed)
        return self._assemble(snap, queries, vals, ids, kk)

    def _search_unbounded(self, snap: Snapshot,
                          queries: list[str]) -> list[list[SearchHit]]:
        scores = self._score_chunk(snap, queries)
        with trace_phase("rank_all"):
            vals, ids = full_ranking(scores, snap.num_names)
            vals = vals.cpu().numpy()
            ids = ids.cpu().numpy()
        return self._assemble(snap, queries, vals, ids, snap.num_names)

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
        names = snap.doc_names
        results: list[list[SearchHit]] = []
        for i in range(len(queries)):
            hits = [SearchHit(names[int(d)], float(v))
                    for v, d in zip(vals[i, :kk], ids[i, :kk])
                    if np.isfinite(v) and v > 0.0]
            if self.result_order == "name":
                hits.sort(key=lambda h: h.name)
            results.append(hits)
        return results
