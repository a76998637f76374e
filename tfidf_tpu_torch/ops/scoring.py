"""Batched query scoring over a COO shard, in PyTorch.

The counterpart of ``tfidf_tpu/ops/scoring.py``:

1. The query batch (padded ``[B, T]`` term ids + weights) is compiled into
   a compact lookup: ``slot_of`` maps vocabulary id -> slot, ``qc_ext``
   holds each query's weight for each slot's term (never a dense
   ``[B, vocab]`` matrix).
2. COO entries are scored in fixed-size chunks: per-entry model weights
   (BM25/TF-IDF), a gather through ``slot_of``, and a segment sum into
   per-document scores.

The segment sum is a deterministic segmented reduction
(``torch.segment_reduce`` over the runs of the sorted ``doc`` array), not
``index_add_``: on CUDA the latter adds with float atomics whose order
changes from run to run. The run boundaries are host data, computed once
(:func:`segment_plan`) when the snapshot is built, so serving needs no
device-to-host sync.

Padding is inert: pad entries have tf=0 and score nothing, so the plan
covers only the live ``nnz`` entries; pad query slots carry weight 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tfidf_tpu_torch.device import resolve_device
from tfidf_tpu_torch.ops.csr import next_capacity
from tfidf_tpu_torch.utils.device_nemesis import device_guard, poison_scores


class QueryBatch(NamedTuple):
    """A scoring-ready query batch with a deduplicated slot space.

    ``uniq`` is the batch's term dictionary (power-of-two bucketed,
    zero-padded); ``slots[b, t]`` indexes a query entry's term in it, or
    ``len(uniq)`` (the inert zero column) for padding. ``n_uniq`` and
    ``uniq_host`` stay on the host: every size decision is made there.
    """

    uniq: torch.Tensor      # i32 [U_cap] — unique term ids, zero-padded
    n_uniq: int             # live entries of `uniq`
    slots: torch.Tensor     # i32 [B, T] — index into uniq, U_cap for pads
    weights: torch.Tensor   # f32 [B, T] — query-side weights, 0 for pads
    uniq_host: np.ndarray   # i64 [n_uniq] — sorted live ids (host copy)


def make_query_batch(q_terms: np.ndarray, q_weights: np.ndarray,
                     *, min_slots: int = 256,
                     device=None) -> QueryBatch:
    """Host-side dedup of a padded [B, T] query batch into a QueryBatch
    on ``device`` (None = cuda)."""
    dev = resolve_device(device)
    valid = q_weights > 0
    uniq = (np.unique(q_terms[valid]).astype(np.int64) if valid.any()
            else np.zeros(0, np.int64))
    n = len(uniq)
    u_cap = next_capacity(max(n, 1), min_slots)
    uniq_pad = np.zeros(u_cap, np.int32)
    uniq_pad[:n] = uniq
    slots = np.full(q_terms.shape, u_cap, np.int32)
    if n:
        slots[valid] = np.searchsorted(
            uniq, q_terms[valid]).astype(np.int32)
    return QueryBatch(
        uniq=torch.from_numpy(uniq_pad).to(dev), n_uniq=n,
        slots=torch.from_numpy(slots).to(dev),
        weights=torch.from_numpy(
            np.ascontiguousarray(q_weights, np.float32)).to(dev),
        uniq_host=uniq)


def lucene_idf(df: torch.Tensor, n_docs: torch.Tensor) -> torch.Tensor:
    """Lucene 9 BM25Similarity idf: ln(1 + (N - df + 0.5) / (df + 0.5))."""
    return torch.log1p((n_docs - df + 0.5) / (df + 0.5))


def smooth_idf(df: torch.Tensor, n_docs: torch.Tensor) -> torch.Tensor:
    """Smoothed TF-IDF idf (log((1+N)/(1+df)) + 1): finite for df=0."""
    return torch.log((1.0 + n_docs) / (1.0 + df)) + 1.0


def bm25_weights(tf: torch.Tensor, df_t: torch.Tensor, dl: torch.Tensor,
                 n_docs: torch.Tensor, avgdl: torch.Tensor,
                 k1: float = 1.2, b: float = 0.75) -> torch.Tensor:
    """Per-(doc,term) BM25 impact, Lucene 9 form:
    ``idf(t) * tf / (tf + k1 * (1 - b + b * dl/avgdl))``.

    ``n_docs`` / ``avgdl`` are 0-d tensors on the scoring device, as in
    the JAX snapshot: a Python-float divisor would take PyTorch's
    multiply-by-reciprocal scalar path on CUDA and drift by an ulp."""
    idf = lucene_idf(df_t, n_docs)
    norm = k1 * (1.0 - b + b * dl / torch.clamp(avgdl, min=1e-9))
    denom = tf + norm
    return idf * tf / torch.where(denom > 0, denom, torch.ones_like(denom))


def tfidf_weights(tf: torch.Tensor, df_t: torch.Tensor,
                  n_docs: torch.Tensor) -> torch.Tensor:
    """Raw TF-IDF impact: tf * smooth_idf. Zero for padded entries."""
    return tf * smooth_idf(df_t, n_docs)


def _compile_queries(q: QueryBatch, vocab_cap: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Build (slot_of [vocab_cap] i32, qc_ext [B, U_cap+1] f32).

    ``slot_of[v]`` is v's slot in the batch's term dictionary, or U_cap
    (the zero column) when no query has v. Pad entries of ``uniq`` are
    DROPPED — never written to slot 0 — so a real term id equal to the pad
    value is never clobbered; ids at or past ``vocab_cap`` (terms the
    snapshot's vocabulary bucket cannot hold) are dropped too, as the
    JAX scatter's ``mode="drop"`` does. In the ``qc_ext`` add only pad
    slots collide, and they carry weight 0, so the add is exact in any
    order.
    """
    u_cap = q.uniq.shape[0]
    B = q.slots.shape[0]
    dev = q.slots.device
    m = int(np.searchsorted(q.uniq_host[:q.n_uniq], vocab_cap))
    slot_of = torch.full((vocab_cap,), u_cap, dtype=torch.int32,
                         device=dev)
    slot_of[q.uniq[:m].long()] = torch.arange(m, dtype=torch.int32,
                                              device=dev)
    rows = torch.arange(B, device=dev)[:, None].expand(q.slots.shape)
    qc_ext = torch.zeros((B, u_cap + 1), dtype=torch.float32, device=dev)
    qc_ext.index_put_((rows.reshape(-1), q.slots.reshape(-1).long()),
                      q.weights.reshape(-1), accumulate=True)
    return slot_of, qc_ext


class Segment(NamedTuple):
    """One chunk of a sorted-``doc`` entry array, cut into runs of equal
    doc id: entries ``[lo, hi)``, run ``lengths`` and each run's ``docs``
    (distinct, ascending) — device tensors."""
    lo: int
    hi: int
    lengths: torch.Tensor   # i64 [n_runs]
    docs: torch.Tensor      # i64 [n_runs]


def segment_plan(doc: np.ndarray, nnz: int, chunk: int,
                 device) -> list[Segment]:
    """Host-side run decomposition of ``doc[:nnz]`` (non-decreasing) in
    chunks of ``chunk`` entries starting at 0 — the JAX scan's chunk
    boundaries, so each chunk's segment sum is added into the scores in
    the same order as there."""
    doc = np.asarray(doc)[:nnz]
    plan = []
    for lo in range(0, nnz, chunk):
        hi = min(lo + chunk, nnz)
        d = doc[lo:hi]
        starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]])
        lengths = np.diff(np.r_[starts, hi - lo])
        plan.append(Segment(
            lo, hi, torch.from_numpy(lengths.astype(np.int64)).to(device),
            torch.from_numpy(d[starts].astype(np.int64)).to(device)))
    return plan


def segment_sum_into(scores: torch.Tensor, contrib: torch.Tensor,
                     seg: Segment) -> None:
    """``scores[:, d] += sum of contrib's entries of run d`` for every run
    of ``seg`` — a fixed-order segmented reduction (deterministic on every
    device), then an add at distinct columns."""
    B = contrib.shape[0]
    sums = torch.segment_reduce(
        contrib, "sum", lengths=seg.lengths.expand(B, -1), axis=1)
    scores[:, seg.docs] += sums


def _entry_weights_coo(model, tf_c, df_t, dl_c, norm_c, n_docs, avgdl,
                       k1, b):
    if model == "bm25":
        return bm25_weights(tf_c, df_t, dl_c, n_docs, avgdl, k1=k1, b=b)
    if model == "tfidf":
        return tfidf_weights(tf_c, df_t, n_docs)
    if model == "tfidf_cosine":
        w = tfidf_weights(tf_c, df_t, n_docs)
        return w / torch.where(norm_c > 0, norm_c, torch.ones_like(norm_c))
    raise ValueError(f"unknown model {model!r}")


def score_coo_compiled(tf: torch.Tensor,      # f32 [nnz_cap]
                       term: torch.Tensor,    # i32 [nnz_cap]
                       doc: torch.Tensor,     # i32 [nnz_cap], row-sorted
                       doc_len: torch.Tensor,   # f32 [doc_cap]
                       df: torch.Tensor,        # f32 [vocab_cap]
                       slot_of: torch.Tensor,   # i32 [vocab_cap]
                       qc_ext: torch.Tensor,    # f32 [B, U_cap+1]
                       n_docs: torch.Tensor,    # f32 0-d
                       avgdl: torch.Tensor,     # f32 0-d
                       doc_norms: torch.Tensor | None = None,
                       *,
                       model: str = "bm25",
                       k1: float = 1.2,
                       b: float = 0.75,
                       chunk: int = 1 << 17,
                       plan: list[Segment] | None = None) -> torch.Tensor:
    """COO scoring against an already-compiled query batch.

    ``plan`` is the snapshot's precomputed :func:`segment_plan`; without
    one it is derived from ``doc`` here (a host copy — fine for direct
    callers, kept off the serving path)."""
    nnz_cap = tf.shape[0]
    doc_cap = doc_len.shape[0]
    chunk = min(chunk, nnz_cap)
    assert nnz_cap % chunk == 0, (nnz_cap, chunk)
    B = qc_ext.shape[0]
    if plan is None:
        d = doc.cpu().numpy()
        # trailing pad entries (tf=0 at doc_cap-1) score nothing
        live = np.flatnonzero(tf.cpu().numpy() != 0)
        nnz = int(live[-1]) + 1 if live.size else 0
        plan = segment_plan(d, nnz, chunk, tf.device)
    scores = torch.zeros((B, doc_cap), dtype=torch.float32,
                         device=qc_ext.device)
    for seg, w in segment_weights(tf, term, doc, doc_len, df, n_docs,
                                  avgdl, doc_norms, plan, model=model,
                                  k1=k1, b=b):
        q = qc_ext[:, slot_of[term[seg.lo:seg.hi].long()].long()]  # [B, C]
        segment_sum_into(scores, q * w[None, :], seg)
    return scores


def segment_weights(tf, term, doc, doc_len, df, n_docs, avgdl, doc_norms,
                    plan: list[Segment], *, model: str, k1: float,
                    b: float):
    """Per-entry model weights, one plan segment at a time: yields
    ``(segment, w [hi - lo])``. The weights depend on no query, so the
    host fallback (``engine/compute_health.py``) fetches exactly these
    tensors, computed by the same ops on the same slices, once per
    snapshot."""
    for seg in plan:
        term_c = term[seg.lo:seg.hi].long()
        doc_c = doc[seg.lo:seg.hi].long()
        norm_c = doc_norms[doc_c] if doc_norms is not None else None
        yield seg, _entry_weights_coo(model, tf[seg.lo:seg.hi], df[term_c],
                                      doc_len[doc_c], norm_c, n_docs,
                                      avgdl, k1, b)


def score_coo_impl(tf, term, doc, doc_len, df, q: QueryBatch, n_docs,
                   avgdl, doc_norms=None, *, model: str = "bm25",
                   k1: float = 1.2, b: float = 0.75,
                   chunk: int = 1 << 17,
                   plan: list[Segment] | None = None) -> torch.Tensor:
    """Score every document in the shard against every query:
    ``scores [B, doc_cap]`` (padded docs score 0; masked in top-k)."""
    slot_of, qc_ext = _compile_queries(q, df.shape[0])
    return score_coo_compiled(tf, term, doc, doc_len, df, slot_of, qc_ext,
                              n_docs, avgdl, doc_norms, model=model,
                              k1=k1, b=b, chunk=chunk, plan=plan)


def score_coo_batch(tf, term, doc, doc_len, df, q: QueryBatch, n_docs,
                    avgdl, doc_norms=None, **kw) -> torch.Tensor:
    """The COO dispatch seam (``device.score_coo``): :func:`score_coo_impl`
    behind the device nemesis guard — injected compute faults surface
    here, and a fired poison rule NaNs its target rows on the device
    (see :mod:`tfidf_tpu_torch.utils.device_nemesis`)."""
    rule = device_guard("score_coo", batch=int(q.slots.shape[0]),
                        uniq=int(q.uniq.shape[0]))
    scores = score_coo_impl(tf, term, doc, doc_len, df, q, n_docs, avgdl,
                            doc_norms, **kw)
    if rule is not None:
        scores = poison_scores(scores, q.weights, rule.min_uniq)
    return scores


def cosine_norms(tf: torch.Tensor, term: torch.Tensor, doc: torch.Tensor,
                 df: torch.Tensor, n_docs: torch.Tensor, doc_cap: int,
                 plan: list[Segment]) -> torch.Tensor:
    """Per-document L2 norm of the TF-IDF vector (for tfidf_cosine),
    recomputed at commit because it depends on the global df. ``plan``
    is a one-chunk :func:`segment_plan` over the live entries."""
    out = torch.zeros((1, doc_cap), dtype=torch.float32, device=tf.device)
    for seg in plan:
        w = tfidf_weights(tf[seg.lo:seg.hi],
                          df[term[seg.lo:seg.hi].long()], n_docs)
        segment_sum_into(out, (w * w)[None, :], seg)
    return torch.sqrt(out[0])
