"""Mesh-sharded dense top-k: the embedding column over the ``docs`` axis.

The counterpart of ``tfidf_tpu/parallel/mesh_dense.py``. The embedding
rows are sharded over the ``docs`` rows (each row owns a disjoint,
contiguous range of rows; ``base`` carries each row's global offset, the
role of the owner map), every docs row scores its rows with one f32
matrix product (``torch.matmul``, TF32 off as ``device.set_full_f32``
sets it: the JAX step's ``Precision.HIGHEST``) and takes its top-k with
the port's keyed selection (ties toward the lower row, as ``lax.top_k``),
and one k-sized ``all_gather`` + exact merge gives the global list. Exact
by the same argument as the sparse gather: the global top-k is contained
in the union of per-row top-ks. The ranks of a row hold the same rows
(``P("docs", None)``), so each row scores once, on its first rank.
"""

from __future__ import annotations

import numpy as np
import torch

from tfidf_tpu_torch.ops.topk import _keyed_topk, merge_topk, pack_topk
from tfidf_tpu_torch.parallel.mesh import Mesh


def shard_dense_column(mesh: Mesh, rows_per_shard: list,
                       dim_pad: int) -> tuple:
    """Place per-row embedding rows onto the ``docs`` axis.

    Every row is padded to the widest row's count; ``num_live`` masks the
    padding and ``base`` maps local row ids back to global ids in the
    concatenated (row-major) order — the order the caller's name table
    uses. Returns ``(emb, num_live, base)``: ``emb`` one f32 ``[cap,
    dim_pad]`` tensor per docs row (None for another process's rows),
    ``num_live`` and ``base`` i32 ``[D]`` on the host."""
    n_shards = mesh.D
    if len(rows_per_shard) != n_shards:
        raise ValueError(f"{len(rows_per_shard)} shards for a "
                         f"{n_shards}-wide docs axis")
    cap = max(1, max(r.shape[0] for r in rows_per_shard))
    live = np.zeros(n_shards, dtype=np.int32)
    base = np.zeros(n_shards, dtype=np.int32)
    emb = [None] * n_shards
    off = 0
    for s, rows in enumerate(rows_per_shard):
        n = rows.shape[0]
        live[s] = n
        base[s] = off
        off += n
        if s in mesh.local_rows:
            e = torch.zeros((cap, dim_pad), dtype=torch.float32,
                            device=mesh.devices[s, 0])
            e[:n, :rows.shape[1]] = torch.from_numpy(
                np.ascontiguousarray(rows, np.float32)).to(e.device)
            emb[s] = e
    return emb, live, base


def make_mesh_dense_search(mesh: Mesh, *, k: int):
    """The sharded search: ``search(queries [B, dim_pad], emb, num_live,
    base)`` (queries a host array or a tensor; the rest from
    :func:`shard_dense_column`) -> packed global top-k ``[B, 2k]`` on
    ``mesh.home`` (``ops/topk.pack_topk`` layout, ids in concatenated
    row-major order)."""

    def search(queries, emb, num_live, base):
        q = torch.as_tensor(np.asarray(queries, np.float32)) \
            if not isinstance(queries, torch.Tensor) else queries
        vals, gids = {}, {}
        for d in mesh.local_rows:
            e = emb[d]
            cap = e.shape[0]
            scores = torch.matmul(q.to(e.device), e.T)        # [B, cap]
            idx = torch.arange(cap, device=e.device)
            masked = scores.masked_fill(idx >= int(num_live[d]),
                                        float("-inf"))
            v, ids = _keyed_topk(masked, idx, min(k, cap))
            vals[d] = v
            gids[d] = ids + int(base[d])
        top_vals, top_ids = merge_topk(mesh.comm.all_gather(mesh, vals),
                                       mesh.comm.all_gather(mesh, gids))
        return pack_topk(top_vals, top_ids)

    return search
