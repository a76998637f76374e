"""Scoring model interface.

The reference hard-codes one model: whatever Lucene's default similarity is
(BM25 since Lucene 6 — so the "TF-IDF" system actually scores BM25,
``Worker.java:222-241``, SURVEY.md §2 "Scoring helper"). Here the model is a
first-class, swappable family: BM25 (Lucene-parity option included) and
TF-IDF variants share one device scoring kernel
(:func:`tfidf_tpu_torch.ops.scoring.score_coo_batch`) parameterized by the model.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ScoringModel:
    """Base: maps config onto kernel parameters and host-side transforms."""

    kind: str = "base"

    @property
    def needs_norms(self) -> bool:
        """Whether the kernel needs per-doc L2 norms (cosine models)."""
        return False

    def score_kwargs(self) -> dict:
        """Static kwargs for ``score_coo_batch`` (selects the weight fn)."""
        return {"model": self.kind}

    def transform_doc_len(self, doc_len: np.ndarray) -> np.ndarray:
        """Hook for norm-encoding document lengths (Lucene parity)."""
        return doc_len

    def query_weights(self, term_counts: dict[int, int]) -> dict[int, float]:
        """Per-term query-side weight. Default: term multiplicity, matching
        the reference's QueryParser output (duplicate terms become duplicate
        TermQuery clauses whose scores add, ``Worker.java:226-230``)."""
        return {t: float(c) for t, c in term_counts.items()}


def get_model(name: str, *, k1: float = 1.2, b: float = 0.75,
              lucene_parity: bool = False) -> ScoringModel:
    from tfidf_tpu_torch.models.bm25 import BM25Model
    from tfidf_tpu_torch.models.tfidf import TfidfCosineModel, TfidfModel

    if name == "bm25":
        return BM25Model(k1=k1, b=b, lucene_parity=lucene_parity)
    if name == "tfidf":
        return TfidfModel()
    if name == "tfidf_cosine":
        return TfidfCosineModel()
    raise ValueError(f"unknown scoring model {name!r}")
