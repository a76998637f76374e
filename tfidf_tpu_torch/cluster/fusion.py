"""Rank fusion for the hybrid query plan — pure, dependency-free math.

Both algorithms operate on the two per-stage GLOBAL top-k lists the
scatter owner-merge produces (each doc is owned by exactly one worker,
so per-stage merges are exact; fusing exact lists is itself exact and
matches a single-node oracle bit-for-bit).  Everything here is plain
python on <= 2k tuples per query — no arrays, no device — so the same
functions ARE the reference the tier-1 fusion-algebra oracle checks
against (tests/test_hybrid.py re-derives them independently).

Determinism contract shared with the whole query plane: ranking order
is ``(-score, name)`` — ties break alphabetically, everywhere.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

FUSION_METHODS = ("rrf", "wsum")


def rank_list(merged: Mapping[str, float], k: int
              ) -> List[Tuple[str, float]]:
    """Top-k of a name->score map in the plane's canonical order."""
    return sorted(merged.items(), key=lambda kv: (-kv[1], kv[0]))[:k]


def fuse_rrf(sparse: Sequence[Tuple[str, float]],
             dense: Sequence[Tuple[str, float]],
             *, rrf_k: float = 60.0, w_sparse: float = 0.5,
             w_dense: float = 0.5) -> Dict[str, float]:
    """Reciprocal-rank fusion: score = sum_stage w / (rrf_k + rank),
    ranks 1-based within each stage's top-k list. Rank-only — immune to
    the stages' incomparable score scales (BM25 vs cosine)."""
    fused: Dict[str, float] = {}
    for weight, ranked in ((w_sparse, sparse), (w_dense, dense)):
        for rank, (name, _score) in enumerate(ranked, start=1):
            fused[name] = fused.get(name, 0.0) + weight / (rrf_k + rank)
    return fused


def _minmax(ranked: Sequence[Tuple[str, float]]) -> Dict[str, float]:
    if not ranked:
        return {}
    scores = [s for _, s in ranked]
    lo, hi = min(scores), max(scores)
    if hi <= lo:
        # all tied at the top of their stage: full credit, not 0/0
        return {n: 1.0 for n, _ in ranked}
    span = hi - lo
    return {n: (s - lo) / span for n, s in ranked}


def fuse_weighted(sparse: Sequence[Tuple[str, float]],
                  dense: Sequence[Tuple[str, float]],
                  *, w_sparse: float = 0.5, w_dense: float = 0.5
                  ) -> Dict[str, float]:
    """Weighted sum of min-max-normalized stage scores (normalized over
    each stage's own top-k list); a doc absent from a stage contributes
    0 from it."""
    ns, nd = _minmax(sparse), _minmax(dense)
    fused: Dict[str, float] = {}
    for name in set(ns) | set(nd):
        fused[name] = (w_sparse * ns.get(name, 0.0)
                       + w_dense * nd.get(name, 0.0))
    return fused


def fuse(sparse_merged: Mapping[str, float],
         dense_merged: Mapping[str, float], *, method: str, k: int,
         rrf_k: float = 60.0, w_sparse: float = 0.5,
         w_dense: float = 0.5) -> Dict[str, float]:
    """Fuse the two per-stage merged score maps into one name->score
    map (the caller re-ranks it with the plane's usual ordering)."""
    sparse_ranked = rank_list(sparse_merged, k)
    dense_ranked = rank_list(dense_merged, k)
    if method == "rrf":
        return fuse_rrf(sparse_ranked, dense_ranked, rrf_k=rrf_k,
                        w_sparse=w_sparse, w_dense=w_dense)
    if method == "wsum":
        return fuse_weighted(sparse_ranked, dense_ranked,
                             w_sparse=w_sparse, w_dense=w_dense)
    raise ValueError(
        f"unknown fusion method {method!r}; known: {FUSION_METHODS}")
