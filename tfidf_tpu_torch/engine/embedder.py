"""Deterministic document/query embedders for the dense scoring plane.

A copy of ``tfidf_tpu/engine/embedder.py`` (numpy and blake2b on the host,
no torch), so the port's vectors are the JAX package's to the bit for the
same token counts. The port keeps its own copy because importing anything
of ``tfidf_tpu`` loads jax.

Per-document vectors must be

1. **replica-identical** — two workers holding copies of the same doc
   must embed it to the SAME vector, or failover slices would return
   different dense scores than the owner they replace. That rules out
   anything keyed on vocab ids: each worker grows its vocabulary in local
   insertion order, so the same token can map to different ids on
   different replicas. The hash embedder therefore hashes the token
   *string* (blake2b — stable across processes, platforms and
   PYTHONHASHSEED), and so does a node of either package.
2. **hermetic** — no model weights are downloaded. Feature hashing
   (Weinberger et al., "hash kernels") gives a real random projection of
   the tf vector with zero learned parameters.
3. **pluggable** — learned encoders drop in behind the same two-method
   contract (:meth:`Embedder.embed_counts` for documents,
   :meth:`Embedder.embed_query` for queries), chosen by the
   ``embedding_model`` Config field via :func:`get_embedder`.

Vectors are L2-normalized at embed time so the matmul in ``ops/dense.py``
scores cosine similarity as a plain dot product.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Mapping

import numpy as np


class Embedder:
    """Contract every embedder implements.

    ``embed_counts`` maps a token->weight bag (the analyzer's tf counts)
    to an L2-normalized f32 vector of ``self.dim``; an empty bag embeds
    to the zero vector (scores 0 against everything, never NaN).
    """

    name = "base"

    def __init__(self, dim: int):
        if dim < 1:
            raise ValueError(f"embedding dim must be >= 1, got {dim}")
        self.dim = int(dim)

    def embed_counts(self, counts: Mapping[str, float]) -> np.ndarray:
        raise NotImplementedError

    def embed_query(self, counts: Mapping[str, float]) -> np.ndarray:
        """Query-side embedding. The hash embedder is symmetric; learned
        bi-encoders may override with a separate query tower."""
        return self.embed_counts(counts)

    def signature(self) -> dict:
        """Stamped into checkpoint meta — a column embedded under a
        different signature must be rebuilt, not silently reused."""
        return {"model": self.name, "dim": self.dim}


class HashEmbedder(Embedder):
    """Signed feature hashing: token -> (position, sign) via blake2b.

    Each token contributes ``sign * tf`` at ``digest % dim``; the result
    is L2-normalized. E[<h(a), h(b)>] equals the cosine of the tf
    vectors, so ranking quality degrades gracefully with dim while
    staying fully deterministic. The token->(pos, sign) map is cached
    per instance — hashing is the hot path at ingest.
    """

    name = "hash"

    def __init__(self, dim: int):
        super().__init__(dim)
        self._slot: Dict[str, tuple] = {}

    def _token_slot(self, token: str) -> tuple:
        slot = self._slot.get(token)
        if slot is None:
            d = hashlib.blake2b(token.encode("utf-8"),
                                digest_size=8).digest()
            h = int.from_bytes(d, "big")
            # low bits pick the bucket, the top bit picks the sign —
            # independent enough at digest_size=8 (64 bits vs dim<=2^16)
            slot = (h % self.dim, 1.0 if h >> 63 else -1.0)
            self._slot[token] = slot
        return slot

    def embed_counts(self, counts: Mapping[str, float]) -> np.ndarray:
        vec = np.zeros(self.dim, dtype=np.float32)
        for token, tf in counts.items():
            pos, sign = self._token_slot(token)
            vec[pos] += sign * float(tf)
        norm = math.sqrt(float(np.dot(vec, vec)))
        if norm > 0.0:
            vec /= norm
        return vec


_REGISTRY: Dict[str, Callable[[int], Embedder]] = {
    HashEmbedder.name: HashEmbedder,
}


def register_embedder(name: str,
                      factory: Callable[[int], Embedder]) -> None:
    """Plug in a real encoder under a Config-selectable name. Last
    registration wins (tests swap in stubs)."""
    _REGISTRY[name] = factory


def get_embedder(name: str, dim: int) -> Embedder:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown embedding model {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None
    emb = factory(dim)
    if emb.dim != dim:
        raise ValueError(
            f"embedder {name!r} built dim {emb.dim}, requested {dim}")
    return emb
