"""Per-segment max-score upper bounds — the block-max/WAND cut.

Lucene's scale story is segment economics plus skip lists; the skip
list's modern form is the block-max bound (MAXSCORE/WAND): a precomputed
per-block maximum impact that lets a top-k search prove "this block
cannot contain a result" without reading it. Here the block is a whole
segment (the tiering unit, ``engine/tiering.py``): at commit/merge time
each segment records, per term, the maximum tf it holds plus its minimum
(transformed) document length — the df-independent ingredients of an
upper bound — and at query time a host-side f64 mirror of the device
scoring formulas (:mod:`tfidf_tpu_torch.ops.scoring`) turns them into a bound
per (query, segment) under the CURRENT global statistics.

Soundness argument, per model:

* ``bm25`` (Lucene 9 form, no (k1+1) numerator):
  ``w(t,d) = idf(t) * tf / (tf + k1*(1 - b + b*dl/avgdl))``.
  For fixed ``c = k1*(1-b+b*dl/avgdl) > 0``, ``tf/(tf+c)`` is increasing
  in ``tf``; ``c`` is non-decreasing in ``dl`` (``b >= 0``), so
  ``tf_max`` and ``min_dl`` jointly bound the fraction from above. If
  the minimum norm is not strictly positive (``b > 1`` configs), the
  fraction is unbounded and the segment is declared unskippable.
* ``tfidf``: ``w(t,d) = tf * smooth_idf(t)`` is monotonic in tf.
* ``tfidf_cosine``: per-doc norms depend on the moving global df, so no
  cheap sound bound exists — callers never tier/skip under cosine (the
  engine refuses to attach a tier manager for it).

A document that lacks term t contributes exactly 0 for t, so each
term's contribution to the bound is clamped at 0 — this also covers
negative-idf corners (heavily-deleted terms where tombstone-inclusive
df pushes idf down) for every sign combination of query weight and idf.

The bound is computed in f64 from the HOST postings (which include the
COO residual spill — ``bounds_from_entries`` walks the raw entries, not
the ELL blocks) and inflated by a small relative margin so f32 device
rounding can never push a true score above it. Deletes only remove
docs, so a bound computed at build time stays valid for every later
live mask.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SegmentBounds:
    """df-independent block-max summary of one segment's postings."""

    term_ids: np.ndarray   # i64 [n_distinct], sorted ascending
    tf_max: np.ndarray     # f32 [n_distinct], aligned with term_ids
    min_dl: float          # min transformed doc length (0.0 if empty)

    @property
    def n_terms(self) -> int:
        return int(self.term_ids.shape[0])


def bounds_from_entries(entries, vocab_cap: int,
                        min_dl: float) -> SegmentBounds:
    """Build :class:`SegmentBounds` from a segment's host postings.

    ``entries`` is the segment's ``host_docs`` (DocEntry list) — the
    same superset the device arrays were laid out from, INCLUDING any
    residual-spill postings and any rows later tombstoned (a bound over
    a superset of the live docs is still an upper bound)."""
    if not entries:
        return SegmentBounds(term_ids=np.empty(0, np.int64),
                             tf_max=np.empty(0, np.float32),
                             min_dl=float(min_dl))
    term = np.concatenate([d.term_ids for d in entries]) \
        if any(d.term_ids.shape[0] for d in entries) \
        else np.empty(0, np.int32)
    if term.shape[0] == 0:
        return SegmentBounds(term_ids=np.empty(0, np.int64),
                             tf_max=np.empty(0, np.float32),
                             min_dl=float(min_dl))
    tf = np.concatenate([d.tfs for d in entries]).astype(np.float32)
    hi = max(int(term.max()) + 1, vocab_cap)
    tfmax = np.zeros(hi, np.float32)
    np.maximum.at(tfmax, term.astype(np.int64), tf)
    ids = np.nonzero(tfmax > 0)[0].astype(np.int64)
    return SegmentBounds(term_ids=ids, tf_max=tfmax[ids],
                         min_dl=float(min_dl))


def query_upper_bounds(bounds: SegmentBounds,
                       uniq_terms: np.ndarray,    # i64 [U] sorted unique
                       qc: np.ndarray,            # f64 [B, U] query weights
                       df_u: np.ndarray,          # f64 [U] global df at uniq
                       n_docs: float, avgdl: float,
                       *, model: str, k1: float = 1.2, b: float = 0.75,
                       margin: float = 1e-4) -> np.ndarray:
    """f64 [B]: per-query upper bound on any live doc's score in the
    segment, under the current (df, N, avgdl). Exceeding-by-rounding is
    covered by the multiplicative ``margin``; a bound of exactly 0 means
    the segment shares no term with the query (provably score 0)."""
    B = qc.shape[0]
    out = np.zeros(B, np.float64)
    U = uniq_terms.shape[0]
    if U == 0 or bounds.n_terms == 0:
        return out
    pos = np.searchsorted(bounds.term_ids, uniq_terms)
    pos_c = np.minimum(pos, bounds.n_terms - 1)
    m = bounds.term_ids[pos_c] == uniq_terms
    if not m.any():
        return out
    tfm = bounds.tf_max[pos_c[m]].astype(np.float64)
    dfm = df_u[m]
    if model == "bm25":
        idf = np.log1p((n_docs - dfm + 0.5) / (dfm + 0.5))
        norm_min = k1 * (1.0 - b + b * bounds.min_dl
                         / max(avgdl, 1e-9))
        if norm_min <= 0.0:
            # tf/(tf+norm) is unbounded as norm -> -tf; declare the
            # segment unskippable rather than guess (b > 1 configs)
            return np.full(B, np.inf)
        ew = idf * tfm / (tfm + norm_min)
    elif model == "tfidf":
        ew = (np.log((1.0 + n_docs) / (1.0 + dfm)) + 1.0) * tfm
    else:
        # no sound bound for this model: never skip
        return np.full(B, np.inf)
    # clamp per-term contributions at 0 (a doc without the term scores
    # 0 for it) — sound for every sign of query weight x idf
    contrib = np.clip(qc[:, m] * ew[None, :], 0.0, None)
    ub = contrib.sum(axis=1)
    return np.where(ub > 0.0, ub * (1.0 + margin) + 1e-12, 0.0)


def skip_mask(ub: np.ndarray,          # f64 [B] segment upper bounds
              thresholds: np.ndarray   # f64 [B] current kk-th candidate
              ) -> np.ndarray:
    """True where the segment provably cannot change query b's top-k.

    ``thresholds[b]`` must be the kk-th largest STRICTLY POSITIVE
    candidate score for query b, or ``-inf`` when fewer than kk
    positive candidates exist (only positive scores fill the result
    quota — the contract the assembler enforces). The comparison is
    STRICT: a cold doc scoring exactly the threshold could displace a
    higher-gid candidate under the (-score, gid) tie-break, so equality
    must fault the segment in."""
    return (ub <= 0.0) | (ub < thresholds)
