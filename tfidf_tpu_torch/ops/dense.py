"""Blocked brute-force dense top-k, in PyTorch.

The counterpart of ``tfidf_tpu/ops/dense.py``, which holds no Pallas
kernel: there each doc chunk is one f32 matmul at ``Precision.HIGHEST``
under ``jax.jit``, followed by a masked ``lax.top_k`` and an exact merge.
Here the product is ``torch.matmul`` in f32 (TF32 is off:
:func:`tfidf_tpu_torch.device.set_full_f32`), the selection is the port's
int64-keyed top-k (``ops/topk.py``: descending score, ties toward the
lower row on every device, ``-inf`` and negative cosines in order), and
the per-chunk winners merge with ``merge_topk``.

Exactness: brute force, no ANN. Padded doc rows score ``-inf`` before the
selection (a zero row would outrank genuinely negative cosines), and the
tail chunk's start is clamped to ``doc_cap - c`` with the rows it re-reads
(``idx < off``) masked, so no doc can win twice.

Bit contract. :func:`dense_scores` builds the full score matrix from the
very products :func:`packed_dense_topk` selects from (the same chunk
bounds, each product the same ``[B, dim] x [c, dim]^T`` call), so within
one column the chunked top-k equals the top-k of ``dense_scores`` to the
bit on any device: the selection is exact and the inputs are the same
bits. Across chunk sizes or batch sizes the product's bits are whatever
the matmul library gives for that shape; on the CPU they do not depend on
the doc-axis length, and on the card ``chip_smoke.py`` counts and records
what differs.
"""

from __future__ import annotations

import torch

from tfidf_tpu_torch.ops.topk import _keyed_topk, merge_topk, pack_topk
from tfidf_tpu_torch.utils.device_nemesis import device_guard


def chunk_rows(doc_cap: int, chunk: int, k: int = 1) -> int:
    """Rows per doc chunk: at least ``k`` (a chunk's top-k needs k
    candidates; the caller clamps k <= doc_cap), at most ``doc_cap``."""
    return min(max(int(chunk), int(k)), doc_cap)


def chunk_bounds(doc_cap: int, c: int) -> list[tuple[int, int]]:
    """``(off, start)`` of every chunk: ``off`` is the first row the chunk
    owns, ``start = min(off, doc_cap - c)`` the first row it reads, so the
    tail chunk is full-width and re-reads rows its predecessor owns."""
    n = -(-doc_cap // c)
    return [(off, min(off, doc_cap - c)) for off in range(0, n * c, c)]


def chunk_product(queries: torch.Tensor, emb: torch.Tensor, start: int,
                  c: int) -> torch.Tensor:
    """f32 ``[B, c]`` cosines of the batch against rows ``start:start+c``
    (rows are L2-normalized at embed time, so the dot IS the cosine)."""
    return torch.matmul(queries, emb[start:start + c].T)


def select_chunk(part: torch.Tensor, start: int, off: int, num_docs: int,
                 k: int) -> tuple:
    """Top-k of one chunk's product over the rows it owns that are live;
    returns ``(vals, global row ids)``."""
    idx = torch.arange(start, start + part.shape[1], device=part.device)
    masked = part.masked_fill((idx < off) | (idx >= num_docs),
                              float("-inf"))
    return _keyed_topk(masked, idx, k)


def dense_scores(queries: torch.Tensor,   # f32 [B, dim]
                 emb: torch.Tensor,       # f32 [doc_cap, dim]
                 num_docs: int, *, chunk: int = 1 << 14) -> torch.Tensor:
    """The dense-oracle dispatch seam (``device.dense``): the full
    ``[B, doc_cap]`` cosine matrix, padded docs at ``-inf``. Assembled
    from the products of ``packed_dense_topk(..., chunk=chunk)`` (each
    chunk's owned rows), so its top-k is the served top-k to the bit. An
    oracle path: at 1M docs and B=512 the matrix alone is 2 GiB. A fired
    poison rule NaNs the whole output (batch-wide, as in the JAX
    package)."""
    rule = device_guard("dense", batch=int(queries.shape[0]))
    doc_cap = emb.shape[0]
    c = chunk_rows(doc_cap, chunk)
    parts = [chunk_product(queries, emb, start, c)[:, off - start:]
             for off, start in chunk_bounds(doc_cap, c)]
    scores = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    scores = scores.masked_fill(
        torch.arange(doc_cap, device=emb.device) >= num_docs,
        float("-inf"))
    if rule is not None:
        scores = torch.full_like(scores, float("nan"))
    return scores


def packed_dense_topk(queries: torch.Tensor,   # f32 [B, dim]
                      emb: torch.Tensor,       # f32 [doc_cap, dim]
                      num_docs: int, *, k: int,
                      chunk: int = 1 << 14) -> torch.Tensor:
    """The dense serving dispatch seam (``device.dense``): the exact
    top-k, packed for the wire (``ops/topk.pack_topk``: f32 score bits in
    i32 lanes beside the ids), with temporaries of O(B * chunk).

    A fired poison rule puts NaN into every packed value lane AFTER the
    selection, as the JAX package does: a NaN's key would sort above
    ``+inf`` if it were selected on."""
    rule = device_guard("dense", batch=int(queries.shape[0]))
    doc_cap = emb.shape[0]
    c = chunk_rows(doc_cap, chunk, k)
    vals, ids = [], []
    for off, start in chunk_bounds(doc_cap, c):
        v, i = select_chunk(chunk_product(queries, emb, start, c), start,
                            off, num_docs, k)
        vals.append(v)
        ids.append(i)
    if len(vals) == 1:
        packed = pack_topk(vals[0], ids[0])
    else:
        packed = pack_topk(*merge_topk(torch.stack(vals), torch.stack(ids)))
    if rule is not None:
        nan_bits = torch.full((packed.shape[0], k), float("nan"),
                              device=packed.device).view(torch.int32)
        packed = torch.cat([nan_bits, packed[:, k:]], dim=1)
    return packed
