"""Per-document embedding column — the dense plane's ``ShardIndex``, on a
torch device.

The counterpart of ``tfidf_tpu/engine/dense.py``. Host side: a name ->
L2-normalized f32 vector map, mutated under the engine's write lock by the
same upsert/delete calls that feed the sparse postings. Device side: a
committed snapshot — rows compacted in **sorted-name order**
(deterministic, so the top-k's lower-row tie-break IS the leader's
``(-score, name)`` tie-break and replicas are identical), doc capacity
padded to a power-of-two bucket.

``dim`` is padded to a multiple of 8 floats, so every row starts on a
32-byte sector; the JAX package pads to 128 for the TPU's matrix unit,
which at the default dim of 64 would double the product's work and the
column's bytes here. Zero pad columns add nothing to a dot product.

``export_arrays`` / ``install_arrays`` are the checkpoint payload
(``embeddings.npz``) and the carry-across from the JAX package: a JAX
column's ``export_arrays()`` installed here and committed serves the same
top-k.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch

from tfidf_tpu_torch.device import resolve_device
from tfidf_tpu_torch.engine.embedder import Embedder
from tfidf_tpu_torch.ops.csr import next_capacity
from tfidf_tpu_torch.ops.dense import packed_dense_topk
from tfidf_tpu_torch.ops.topk import unpack_topk

_ALIGN = 8       # floats: a row starts on a 32-byte sector


def _pad_dim(dim: int) -> int:
    return -(-dim // _ALIGN) * _ALIGN


class EmbeddingColumn:
    """Not thread-safe by itself — the engine serializes mutations under
    its write lock, exactly like the sparse index. ``device``: None runs
    on CUDA and raises without it (:func:`resolve_device`)."""

    def __init__(self, embedder: Embedder, *, min_doc_capacity: int = 64,
                 chunk: int = 1 << 14, device=None):
        self.embedder = embedder
        self.dim = embedder.dim
        self.device = resolve_device(device)
        self._chunk = int(chunk)
        self._min_cap = int(min_doc_capacity)
        self._vecs: Dict[str, np.ndarray] = {}     # host truth
        # committed device snapshot
        self._names: List[str] = []                # sorted, row i <-> name
        self._slot: Dict[str, int] = {}            # committed name -> row
        self._emb_dev: torch.Tensor | None = None  # f32 [doc_cap, dim_pad]
        self._doc_cap = 0
        self._dirty = False

    # -- mutation (engine write lock held) --------------------------------

    def upsert(self, name: str, counts: Mapping[str, float]) -> None:
        self._vecs[name] = self.embedder.embed_counts(counts)
        self._dirty = True

    def delete(self, name: str) -> bool:
        if self._vecs.pop(name, None) is None:
            return False
        self._dirty = True
        return True

    def commit(self) -> None:
        """Compact live rows (sorted by name) into a fresh device
        snapshot. O(docs) host work per commit — same order as the sparse
        snapshot rebuild it rides along with."""
        if not self._dirty and self._emb_dev is not None:
            return
        self._names = sorted(self._vecs)
        self._slot = {n: i for i, n in enumerate(self._names)}
        n = len(self._names)
        cap = next_capacity(max(n, 1), self._min_cap)
        host = np.zeros((cap, _pad_dim(self.dim)), dtype=np.float32)
        if n:
            host[:n, :self.dim] = np.stack(
                [self._vecs[name] for name in self._names])
        self._emb_dev = torch.from_numpy(host).to(self.device)
        self._doc_cap = cap
        self._dirty = False

    # -- search (committed snapshot) --------------------------------------

    def _embed_queries(self, queries_counts: Sequence[Mapping[str, float]]
                       ) -> np.ndarray:
        """f32 ``[next_capacity(B, 8), dim_pad]``: the batch is padded to
        a power-of-two bucket with zero rows, as the JAX package pads it
        (and a matmul's bits may depend on the batch's shape)."""
        b_cap = next_capacity(len(queries_counts), 8)
        q = np.zeros((b_cap, _pad_dim(self.dim)), dtype=np.float32)
        for i, counts in enumerate(queries_counts):
            q[i, :self.dim] = self.embedder.embed_query(counts)
        return q

    def search_batch(self, queries_counts: Sequence[Mapping[str, float]],
                     k: int) -> List[List[tuple]]:
        """Exact dense top-k per query: ``[(name, score), ...]`` sorted
        by (-score, name). Empty column -> empty lists; a row's hits stop
        at its first non-finite value (padding, or poisoned output)."""
        if self._dirty or self._emb_dev is None:
            self.commit()
        n_live = len(self._names)
        if not queries_counts:
            return []
        if n_live == 0:
            return [[] for _ in queries_counts]
        q = torch.from_numpy(self._embed_queries(queries_counts)).to(
            self.device)
        kk = min(int(k), self._doc_cap)
        vals, ids = unpack_topk(packed_dense_topk(
            q, self._emb_dev, n_live, k=kk, chunk=self._chunk))
        out: List[List[tuple]] = []
        for row in range(len(queries_counts)):
            hits = []
            for v, i in zip(vals[row], ids[row]):
                if not np.isfinite(v):
                    break            # ran out of live docs
                hits.append((self._names[int(i)], float(v)))
            out.append(hits)
        return out

    def search_names(self, queries_counts: Sequence[Mapping[str, float]],
                     names: Sequence[str]) -> List[Dict[str, float]]:
        """Failover-slice path: exact scores for a specific name set
        (names this column doesn't hold are simply absent). Host-side
        per-pair dots, as in the JAX package — a (query, doc) cosine
        depends only on the two vectors, so replicas agree regardless of
        what else they hold."""
        if self._dirty or self._emb_dev is None:
            self.commit()
        wanted = [n for n in names if n in self._slot]
        out: List[Dict[str, float]] = []
        if not wanted:
            return [{} for _ in queries_counts]
        rows = np.stack([np.asarray(
            self._vecs[n], dtype=np.float32) for n in wanted])
        for counts in queries_counts:
            q = self.embedder.embed_query(counts).astype(np.float32)
            scores = rows @ q
            out.append({n: float(s) for n, s in zip(wanted, scores)})
        return out

    # -- checkpoint seam ---------------------------------------------------

    def export_arrays(self) -> tuple:
        """(rows f32 [n, dim], names) — live host vectors in sorted-name
        order; the ``embeddings.npz`` checkpoint payload."""
        names = sorted(self._vecs)
        if names:
            rows = np.stack([self._vecs[n] for n in names]).astype(
                np.float32)
        else:
            rows = np.zeros((0, self.dim), dtype=np.float32)
        return rows, names

    def install_arrays(self, rows: np.ndarray,
                       names: Sequence[str]) -> None:
        """Replace the host truth with ``rows[i]`` for ``names[i]``
        (f32 views of ``rows``); takes effect at the next commit."""
        if rows.shape[0] != len(names) or (
                len(names) and rows.shape[1] != self.dim):
            raise ValueError(
                f"embedding column shape {rows.shape} does not match "
                f"{len(names)} names x dim {self.dim}")
        rows = np.asarray(rows, dtype=np.float32)
        self._vecs = {str(n): rows[i] for i, n in enumerate(names)}
        self._dirty = True

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        host = len(self._vecs) * self.dim * 4
        dev = (int(self._emb_dev.numel()) * 4
               if self._emb_dev is not None else 0)
        return {"model": self.embedder.name, "dim": self.dim,
                "docs": len(self._vecs), "bytes": host + dev,
                "host_bytes": host, "device_bytes": dev}
