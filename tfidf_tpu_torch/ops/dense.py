"""Blocked brute-force dense top-k, in PyTorch.

The counterpart of ``tfidf_tpu/ops/dense.py``, which holds no Pallas
kernel: there each doc chunk is one f32 matmul at ``Precision.HIGHEST``
under ``jax.jit``, followed by a masked ``lax.top_k`` and an exact merge.
Here the product is :func:`dense_product` in f32 (TF32 is off:
:func:`tfidf_tpu_torch.device.set_full_f32`), the selection is the port's
int64-keyed top-k (``ops/topk.py``: descending score, ties toward the
lower row on every device, ``-inf`` and negative cosines in order), and
the per-chunk winners merge with ``merge_topk``.

Exactness: brute force, no ANN. Padded doc rows score ``-inf`` before the
selection (a zero row would outrank genuinely negative cosines), and the
tail chunk's start is clamped to ``doc_cap - c`` with the rows it re-reads
(``idx < off``) masked, so no doc can win twice.

Bit contract. Every product goes through :func:`dense_product`. On the
CPU it is a fixed-order reduction: each (query, row) cosine is the f32
fused multiply-add chain over ``dim`` in index order (``torch.addcmul``,
one elementwise op per dim, rows in sub-chunks of at most
``CPU_TILE`` accumulator elements), so its bits depend on the two
vectors alone: not on the row's position, on how many rows share the
product (chunk, shard, ``wanted`` set) or on the batch size. The chain is
the order the CPU BLAS's full-size GEMM kernel takes, so on a full tile
it also equals ``torch.matmul``'s bits; a BLAS tail block (a few rows)
reduces in another order, which is why the CPU does not call it. On the
card the product is ``torch.matmul`` (cuBLAS). :func:`dense_scores`
builds the full score matrix from the very products
:func:`packed_dense_topk` selects from (the same chunk bounds), so within
one column the chunked top-k equals the top-k of ``dense_scores`` to the
bit on any device; across chunk or batch sizes the card's bits are
cuBLAS's for that shape, and ``chip_smoke.py`` gates that identical rows
at any position score identical bits there and records what else
differs.
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


CPU_TILE = 1 << 16   # f32 accumulator elements (256 KiB) per CPU sub-chunk


def dense_product(queries: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """f32 ``[B, R]`` dots of every query ``[B, dim]`` with every row
    ``[R, dim]``. The card: one ``torch.matmul``. The CPU: per sub-chunk
    of rows, an accumulator ``[B, sub]`` (at most ``CPU_TILE`` elements)
    takes one fused multiply-add per dim in index order, so each element's
    bits are a function of its two vectors only (module docstring)."""
    if queries.device.type != "cpu":
        return torch.matmul(queries, rows.T)
    b, dim = queries.shape
    out = torch.empty((b, rows.shape[0]), dtype=torch.float32)
    sub = max(1, CPU_TILE // max(b, 1))
    for s in range(0, rows.shape[0], sub):
        part = rows[s:s + sub].T.contiguous()           # [dim, sub]
        acc = torch.zeros((b, part.shape[1]), dtype=torch.float32)
        for d in range(dim):
            acc.addcmul_(queries[:, d:d + 1], part[d:d + 1])
        out[:, s:s + sub] = acc
    return out


def chunk_product(queries: torch.Tensor, emb: torch.Tensor, start: int,
                  c: int) -> torch.Tensor:
    """f32 ``[B, c]`` cosines of the batch against rows ``start:start+c``
    (rows are L2-normalized at embed time, so the dot IS the cosine)."""
    return dense_product(queries, emb[start:start + c])


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
