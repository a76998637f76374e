"""Padded COO shard (host numpy) — the numpy parts of
``tfidf_tpu/ops/csr.py``: :class:`CooShard` and :func:`next_capacity`.

A shard is a set of fixed-capacity arrays in coordinate format, row-sorted
(so it is simultaneously an expanded CSR):

    tf[nnz_cap]       f32  raw term frequency of (doc, term)
    term[nnz_cap]     i32  term id (column / vocabulary axis)
    doc[nnz_cap]      i32  local document id (row axis), non-decreasing
    doc_len[doc_cap]  f32  analyzed token count per document (BM25 norm)
    df[vocab_cap]     f32  per-shard document frequency per term

Capacities come from power-of-two buckets, as in the JAX package, so the
port's block shapes (and the kernel launches over them) match it exactly.
Padding is inert: padded ``tf`` is 0 and padded ``doc`` is ``doc_cap - 1``,
keeping ``doc`` non-decreasing for the sorted segment sums.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def next_capacity(n: int, minimum: int) -> int:
    """Power-of-two capacity bucket."""
    cap = max(int(minimum), 1)
    while cap < n:
        cap <<= 1
    return cap


@dataclass
class CooShard:
    """Host-side (numpy) padded COO shard."""

    tf: np.ndarray        # f32 [nnz_cap]
    term: np.ndarray      # i32 [nnz_cap]
    doc: np.ndarray       # i32 [nnz_cap]
    doc_len: np.ndarray   # f32 [doc_cap]
    df: np.ndarray        # f32 [vocab_cap]
    nnz: int
    num_docs: int

    @property
    def nnz_cap(self) -> int:
        return self.tf.shape[0]

    @property
    def doc_cap(self) -> int:
        return self.doc_len.shape[0]

    @property
    def vocab_cap(self) -> int:
        return self.df.shape[0]

    def size_bytes(self) -> int:
        return int(self.tf.nbytes + self.term.nbytes + self.doc.nbytes
                   + self.doc_len.nbytes + self.df.nbytes)
