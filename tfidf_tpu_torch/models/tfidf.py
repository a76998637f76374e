"""TF-IDF scoring models — the family the reference is named after.

``tfidf``: raw dot product of tf·idf document weights with query term
multiplicities (smoothed idf, finite everywhere). ``tfidf_cosine``:
additionally L2-normalizes each document's tf·idf vector (the "cosine
ranking" named in the north star, BASELINE.json) — norms are
recomputed at commit time because they depend on global document frequency.
"""

from __future__ import annotations

from dataclasses import dataclass

from tfidf_tpu_torch.models.base import ScoringModel


@dataclass(frozen=True)
class TfidfModel(ScoringModel):
    kind: str = "tfidf"


@dataclass(frozen=True)
class TfidfCosineModel(ScoringModel):
    kind: str = "tfidf_cosine"

    @property
    def needs_norms(self) -> bool:
        return True
