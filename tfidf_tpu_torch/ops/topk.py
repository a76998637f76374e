"""Exact top-k, top-k merge and the packed wire layout, in PyTorch.

The counterpart of ``tfidf_tpu/ops/topk.py``. The reference breaks ties
toward the lower document id (``lax.top_k`` semantics). ``torch.topk``
promises no tie order on CUDA, so every selection here runs on a unique
int64 key instead of the raw scores: the f32 score mapped to an
order-preserving int32 in the high word, and ``0xFFFFFFFF - id`` in the
low word. Keys are distinct, so ``torch.topk`` over them has exactly one
answer — descending score, ascending id on ties — on every device.
"""

from __future__ import annotations

import numpy as np
import torch

_LOW32 = 0xFFFFFFFF


def _order_key(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """int64 key ordering by (score desc, id asc) under ``topk``."""
    bits = vals.contiguous().view(torch.int32).to(torch.int64)
    # IEEE f32 -> order-preserving signed int: flip the magnitude bits of
    # negatives so more-negative floats map to smaller integers
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (ordered << 32) | (_LOW32 - ids.to(torch.int64))


def _keyed_topk(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """Top-k of ``vals`` along the last axis with the (-score, id) order;
    returns ``(vals, ids)`` of the winners."""
    _, pos = torch.topk(_order_key(vals, ids), k, dim=-1)
    return (torch.gather(vals, -1, pos),
            torch.gather(ids.expand_as(vals), -1, pos).to(torch.int32))


def exact_topk(scores: torch.Tensor, num_docs: int, *, k: int):
    """Top-k over live documents only; padded rows are masked to -inf.
    Ties break toward the lower document id."""
    doc_cap = scores.shape[-1]
    idx = torch.arange(doc_cap, device=scores.device)
    masked = torch.where(idx < num_docs, scores,
                         torch.full_like(scores, float("-inf")))
    return _keyed_topk(masked, idx, k)


def merge_topk(vals: torch.Tensor,   # f32 [..., n_parts, B, k]
               ids: torch.Tensor):   # i32 [..., n_parts, B, k]
    """Merge per-part top-k lists into a global top-k (same k). Exact:
    the global top-k is contained in the union of the parts' top-ks."""
    n_parts, B, k = vals.shape[-3:]
    flat_vals = torch.movedim(vals, -3, -2).reshape(*vals.shape[:-3], B,
                                                   n_parts * k)
    flat_ids = torch.movedim(ids, -3, -2).reshape(*ids.shape[:-3], B,
                                                 n_parts * k)
    return _keyed_topk(flat_vals, flat_ids, k)


def pack_topk(vals: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Pack values + ids into ONE i32 ``[..., 2k]`` tensor — the
    single-transfer wire layout :func:`unpack_topk` inverts. The packed
    dtype is INTEGER and the float bits are put into it, never ids into
    f32: an id below 2^23 viewed as f32 is a denormal, and denormals get
    flushed somewhere between device and host."""
    return torch.cat([vals.contiguous().view(torch.int32),
                      ids.to(torch.int32)], dim=-1)


def packed_topk(scores: torch.Tensor, num_docs: int, *, k: int
                ) -> torch.Tensor:
    """Top-k with values and ids packed into one i32 ``[B, 2k]``."""
    vals, idx = exact_topk(scores, num_docs, k=k)
    return pack_topk(vals, idx)


def fetch_packed(packed) -> np.ndarray:
    """The serving pipeline's FETCH stage: one device->host copy of the
    packed ``[..., 2k]`` top-k buffer, nothing else (on CUDA it is also
    where the host waits for the chunk's kernels)."""
    if isinstance(packed, np.ndarray):
        return packed
    return packed.cpu().numpy()


def unpack_topk(packed) -> tuple:
    """Host-side inverse of :func:`pack_topk` (numpy views)."""
    arr = fetch_packed(packed)
    k = arr.shape[-1] // 2
    vals = np.ascontiguousarray(arr[..., :k]).view(np.float32)
    ids = arr[..., k:]
    return vals, ids


def packed_topk_chunked(scores: torch.Tensor, num_docs: int, *, k: int,
                        chunk: int = 1 << 17) -> torch.Tensor:
    """:func:`packed_topk` with the doc axis taken in chunks (bounds the
    selection temporaries at O(B * chunk)) and per-chunk winners merged.

    The last chunk's start is clamped to ``doc_cap - c`` so every slice is
    full-width; columns the clamp makes overlap the previous chunk
    (``idx < off``) are masked out, so no doc can win twice."""
    B, doc_cap = scores.shape
    c = min(chunk, doc_cap)
    n = -(-doc_cap // c)
    if n == 1:
        return packed_topk(scores, num_docs, k=k)
    vals, ids = [], []
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    for off in range(0, n * c, c):
        start = min(off, doc_cap - c)
        x = scores[:, start:start + c]
        idx = torch.arange(start, start + c, device=scores.device)
        masked = torch.where((idx >= off) & (idx < num_docs), x, neg_inf)
        v, i = _keyed_topk(masked, idx, k)
        vals.append(v)
        ids.append(i)
    top_vals, top_ids = merge_topk(torch.stack(vals), torch.stack(ids))
    return pack_topk(top_vals, top_ids)


def full_ranking(scores: torch.Tensor, num_docs: int):
    """All live documents sorted by descending score, ties in id order —
    the parity-mode analog of the reference's unbounded result set."""
    s = scores[..., :num_docs]
    vals, order = torch.sort(s, dim=-1, descending=True, stable=True)
    return vals, order.to(torch.int32)
