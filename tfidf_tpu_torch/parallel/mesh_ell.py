"""Blocked-ELL base layout for the mesh — the distributed fast path, and
the second call site of the hand-written ELL kernel.

The counterpart of ``tfidf_tpu/parallel/mesh_ell.py``, with its layout
unchanged:

* per docs row, live documents are laid out as blocked ELL with a FIXED
  set of width buckets (``ELL_WIDTHS``, 256 down to 8) whose row
  capacities are padded to the max across rows, so every rank holds the
  same shapes;
* the ``terms`` axis splits each block's WIDTH columns into ``T``
  contiguous ranges (``P("docs", None, "terms")``): rank ``(d, t)`` holds
  columns ``[t*W/T, (t+1)*W/T)`` of row ``d``'s block, ``W/T`` wide (4 at
  ``T = 2`` for the 8-wide bucket, 1 at ``T = 8``), and partial scores are
  summed over the row's ranks;
* per-entry IMPACTS are recomputed at every commit from the current
  global statistics (:func:`make_impact_refresh`); appends between
  re-shards land in the COO delta (``ShardedArrays``);
* every block inside the kernel envelope (``_pallas_eligible``) goes
  through :func:`~tfidf_tpu_torch.ops.ell.score_block_kernel` on its
  rank's width-major ``[W/T, rows_cap]`` slice — on a CUDA tensor the
  kernel (``csrc/ell_score.cu``) or an error, on a CPU tensor its plain
  version — the rest through the plain ``_score_block``. Entry ``w`` of a
  rank's slice goes to lane ``w % 8`` of that slice's own column order,
  as in the JAX step, so a rank's block scores match the JAX package's
  bit for bit given the same impacts.

Each rank's tensors are stored width-major (the kernel's layout); the
plain path reads them through a transposed view. The live row count of
every block (``block_live``) stays on the host, so a search needs no
device read to size its work.

The ELL row order per row is width-sorted, i.e. a PERMUTATION of the
row's insertion-local ids; ``perm[d]`` maps ELL row -> insertion-local id
so the searcher can translate top-k ids back to names.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from tfidf_tpu_torch.ops.csr import next_capacity
from tfidf_tpu_torch.ops.ell import (_pallas_eligible, _score_block,
                                     score_block_kernel)
from tfidf_tpu_torch.ops.scoring import (QueryBatch, _compile_queries,
                                         bm25_weights, score_coo_compiled,
                                         segment_plan, tfidf_weights)
from tfidf_tpu_torch.ops.topk import exact_topk, merge_topk, pack_topk
from tfidf_tpu_torch.parallel.mesh import Mesh
from tfidf_tpu_torch.parallel.sharded import ShardedArrays, _rank_queries
from tfidf_tpu_torch.utils.metrics import global_metrics

# fixed width buckets so every row shares one block structure; every
# width is a multiple of 8 so the terms axis (up to 8-way) splits the
# width columns evenly
ELL_WIDTHS = (256, 192, 128, 96, 64, 48, 32, 24, 16, 8)

# entries per residual scoring chunk (the JAX step's)
RES_CHUNK = 1 << 10


@dataclass
class MeshEllArrays:
    """The ELL base on the mesh. Per-rank lists are indexed ``d * T + t``
    (None for ranks another process drives); each holds one tensor per
    width bucket b, width-major ``[W_b / T, rows_cap_b]``."""

    tf: list             # per rank: tuple of f32 [W_b/T, rows_cap_b]
    term: list           # per rank: tuple of i32 [W_b/T, rows_cap_b]
    impact: list         # per rank: tuple of f32 [W_b/T, rows_cap_b]
    dl: list             # per rank: tuple of f32 [rows_cap_b]
    block_live: np.ndarray  # i32 [D, n_buckets] live rows per block (host)
    live: list           # per rank f32 [doc_cap] in ELL row space
    # residual COO (over-wide docs), split over terms like the delta
    res_tf: list         # per rank f32 [res_chunk]
    res_term: list       # per rank i32 [res_chunk]
    res_doc: list        # per rank i32 [res_chunk] (ELL row ids)
    res_dl: list         # per rank f32 [doc_cap] (model-transformed)
    res_plan: list       # per rank: the residual's segment plan
    doc_cap: int

    @property
    def n_buckets(self) -> int:
        return self.block_live.shape[1]


def _buckets(k: np.ndarray, widths: list[int]) -> np.ndarray:
    """Each row length's bucket: the smallest with width >= k; over-wide
    rows use bucket 0 and spill the excess into the residual."""
    asc = np.asarray(widths[::-1], np.int64)
    idx = np.searchsorted(asc, k, side="left")
    return np.where(idx >= asc.shape[0], 0, len(widths) - 1 - idx)


def build_mesh_ell(entries_per_shard: list[list],   # list[DocEntry]/row
                   mesh: Mesh,
                   transform_len,                   # model.transform_doc_len
                   *,
                   width_cap: int = 256,
                   min_rows: int = 256,
                   min_res_cap: int = 1 << 10
                   ) -> tuple[MeshEllArrays, list[np.ndarray]]:
    """Host-side build: per-row blocked ELL with uniform buckets — the JAX
    package's layout (the same stable sort, buckets, ``perm`` and
    residual split), vectorized over each row's documents.

    Returns ``(arrays, perm)`` where ``perm[d][ell_row] = insertion-local
    id`` in row d. Impacts are left zero — call
    :func:`make_impact_refresh` next."""
    D, T = mesh.D, mesh.T
    widths = [w for w in ELL_WIDTHS if w <= width_cap]
    assert T <= min(widths), "terms axis cannot exceed the narrowest bucket"
    nb = len(widths)

    per_shard = []
    rows_need = np.zeros((D, nb), np.int64)
    res_need = np.zeros(D, np.int64)
    for d in range(D):
        entries = entries_per_shard[d]
        k = np.fromiter((e.term_ids.shape[0] for e in entries), np.int64,
                        len(entries))
        order = np.argsort(-k, kind="stable")
        ks = k[order]
        bucket = _buckets(ks, widths)
        rows_need[d] = np.bincount(bucket, minlength=nb)
        res_need[d] = int(np.maximum(
            ks - np.asarray(widths, np.int64)[bucket], 0).sum())
        per_shard.append((entries, order, ks, bucket))
    doc_cap = next_capacity(
        max(max((len(e) for e in entries_per_shard), default=1), 1),
        min_rows)
    rows_cap = [next_capacity(int(rows_need[:, b].max()) or 1, min_rows)
                for b in range(nb)]
    res_cap = next_capacity(int(res_need.max()) or 1, min_res_cap)
    res_chunk = -(-res_cap // T)

    g_tf = [np.zeros((D, rows_cap[b], widths[b]), np.float32)
            for b in range(nb)]
    g_term = [np.zeros((D, rows_cap[b], widths[b]), np.int32)
              for b in range(nb)]
    g_dl = [np.zeros((D, rows_cap[b]), np.float32) for b in range(nb)]
    g_bl = rows_need.astype(np.int32)
    g_live = np.zeros((D, doc_cap), np.float32)
    g_res_tf = np.zeros((D, T, res_chunk), np.float32)
    g_res_term = np.zeros((D, T, res_chunk), np.int32)
    g_res_doc = np.full((D, T, res_chunk), doc_cap - 1, np.int32)
    g_res_dl = np.zeros((D, doc_cap), np.float32)
    perms = []
    for d in range(D):
        entries, order, ks, bucket = per_shard[d]
        perms.append(order.astype(np.int64))
        n = ks.shape[0]
        if not n:
            continue
        srt = [entries[i] for i in order]
        raw = np.asarray([e.length for e in srt], np.float32)
        kdl = transform_len(raw).astype(np.float32)
        ids = np.concatenate([e.term_ids for e in srt])
        tfs = np.concatenate([e.tfs for e in srt])
        row = np.repeat(np.arange(n, dtype=np.int64), ks)   # ELL row
        ends = np.cumsum(ks)
        pos = np.arange(ids.shape[0], dtype=np.int64) - (ends - ks)[row]
        # rows are width-sorted, so a bucket's rows — and their entries —
        # are contiguous: block b holds rows [r0, r1), entries [e0, e1)
        r1s = np.cumsum(rows_need[d])
        spill = np.zeros(ids.shape[0], bool)
        for b in range(nb):
            r0, r1 = int(r1s[b] - rows_need[d, b]), int(r1s[b])
            if r0 == r1:
                continue
            e0, e1 = int(ends[r0] - ks[r0]), int(ends[r1 - 1])
            pp = pos[e0:e1]
            keep = pp < widths[b]     # only the widest bucket can spill
            flat = ((row[e0:e1] - r0) * widths[b] + pp)[keep]
            g_tf[b][d].reshape(-1)[flat] = tfs[e0:e1][keep]
            g_term[b][d].reshape(-1)[flat] = ids[e0:e1][keep]
            g_dl[b][d, :r1 - r0] = kdl[r0:r1]
            spill[e0:e1] = ~keep
        g_live[d, :n] = 1.0
        g_res_dl[d, :n] = kdl
        res_rows, res_terms, res_tfs = row[spill], ids[spill], tfs[spill]
        n_res = res_rows.shape[0]
        step = -(-n_res // T) if n_res else 0
        for t in range(T):
            lo, hi = min(t * step, n_res), min((t + 1) * step, n_res)
            if hi > lo:
                g_res_tf[d, t, :hi - lo] = res_tfs[lo:hi]
                g_res_term[d, t, :hi - lo] = res_terms[lo:hi]
                g_res_doc[d, t, :hi - lo] = res_rows[lo:hi]

    # the base's device footprint, on the gauge the JAX package publishes
    # (tf counts twice: the impact plane is a same-shape f32 copy)
    dev_bytes = (sum(a.nbytes for a in g_tf) * 2
                 + sum(a.nbytes for a in g_term)
                 + sum(a.nbytes for a in g_dl)
                 + g_bl.nbytes + g_live.nbytes + g_res_tf.nbytes
                 + g_res_term.nbytes + g_res_doc.nbytes
                 + g_res_dl.nbytes)
    global_metrics.set_gauge("mesh_ell_device_bytes", float(dev_bytes))
    return place_mesh_ell(mesh, g_tf, g_term, g_dl, g_bl, g_live, g_res_tf,
                          g_res_term, g_res_doc, g_res_dl), perms


def _width_slices(mesh: Mesh, g: list) -> list:
    """Per local rank, each bucket's ``[D, rows_cap, W]`` host array's
    slice ``[d, :, t*W/T:(t+1)*W/T]``, width-major and contiguous on the
    rank's device: each row's block goes up once per device, and the
    slicing and transposing run there."""
    T = mesh.T
    out = [None] * mesh.size
    for d in mesh.local_rows:
        up = {}
        for t in range(T):
            dev = mesh.devices[d, t]
            if dev not in up:
                up[dev] = [torch.from_numpy(a[d]).to(dev) for a in g]
            out[d * T + t] = tuple(
                x[:, t * (x.shape[1] // T):(t + 1) * (x.shape[1] // T)]
                .T.contiguous() for x in up[dev])
    return out


def place_mesh_ell(mesh: Mesh, g_tf, g_term, g_dl, g_bl, g_live, g_res_tf,
                   g_res_term, g_res_doc, g_res_dl) -> MeshEllArrays:
    """The host layout of :func:`build_mesh_ell` (the JAX package's global
    arrays) on the mesh: each rank's slices on its device, impacts zero."""
    T = mesh.T
    dl = [None] * mesh.size
    for d in mesh.local_rows:
        per_dev = {}
        for t in range(T):
            dev = mesh.devices[d, t]
            if dev not in per_dev:
                per_dev[dev] = tuple(torch.from_numpy(a[d].copy()).to(dev)
                                     for a in g_dl)
            dl[d * T + t] = per_dev[dev]
    tf = _width_slices(mesh, g_tf)
    chunk = min(RES_CHUNK, g_res_tf.shape[-1])
    res_plan = [None] * mesh.size
    for d, t in mesh.local:
        res_plan[d * T + t] = segment_plan(
            g_res_doc[d, t], int(np.count_nonzero(g_res_tf[d, t])), chunk,
            mesh.devices[d, t])
    return MeshEllArrays(
        tf=tf, term=_width_slices(mesh, g_term),
        impact=[None if x is None else tuple(torch.zeros_like(a) for a in x)
                for x in tf],
        dl=dl, block_live=np.asarray(g_bl, np.int32),
        live=mesh.put_rows(g_live),
        res_tf=mesh.put_blocks(g_res_tf),
        res_term=mesh.put_blocks(g_res_term),
        res_doc=mesh.put_blocks(g_res_doc),
        res_dl=mesh.put_rows(g_res_dl),
        res_plan=res_plan,
        doc_cap=int(g_live.shape[1]))


def make_impact_refresh(mesh: Mesh, *, model: str = "bm25",
                        k1: float = 1.2, b: float = 0.75):
    """Commit-time impact recompute from CURRENT global stats:
    ``refresh(arrays, df_g [vocab], n, avgdl) -> MeshEllArrays`` with new
    impact tensors (``df_g``, ``n``, ``avgdl``: tensors on
    ``mesh.home``). Each rank re-derives its impacts from its raw tf, so
    appends (which move df/N/avgdl) never leave stale IDF in the base."""
    if model not in ("bm25", "tfidf"):
        raise ValueError(f"mesh ELL does not support {model!r}")

    def refresh(arrays: MeshEllArrays, df_g, n_docs, avgdl):
        dfs, ns, avs = (mesh.replicate(df_g), mesh.replicate(n_docs),
                        mesh.replicate(avgdl))
        impact = [None] * mesh.size
        for d, t in mesh.local:
            r = d * mesh.T + t
            dev = mesh.devices[d, t]
            out = []
            for tf, term, dl in zip(arrays.tf[r], arrays.term[r],
                                    arrays.dl[r]):
                df_t = dfs[dev][term.long()]
                if model == "bm25":
                    out.append(bm25_weights(tf, df_t, dl[None, :], ns[dev],
                                            avs[dev], k1=k1, b=b))
                else:
                    out.append(tfidf_weights(tf, df_t, ns[dev]))
            impact[r] = tuple(out)
        return dataclasses.replace(arrays, impact=impact)

    return refresh


def _score_rank_ell(imps_t, terms_t, block_live, doc_cap: int, slot_of,
                    qc_t, u_cap: int, *, use_pallas: bool, a_build: str,
                    doc_chunk: int = 2048) -> torch.Tensor:
    """One rank's ELL base ``[B, doc_cap]``: block b's live rows written
    straight into columns ``[row0_b, row0_b + live_b)`` (row0_b: the live
    rows of the buckets before it), the columns past the last live row 0
    — the JAX package's ``_rearrange_to_real``, bit for bit."""
    B = qc_t.shape[1]
    scores = torch.empty((B, doc_cap), dtype=torch.float32,
                         device=qc_t.device)
    row0 = 0
    for imp_t, term_t, live in zip(imps_t, terms_t, block_live.tolist()):
        if not live:              # an empty bucket holds no column
            continue
        if use_pallas and _pallas_eligible(imp_t.shape[1], B, u_cap,
                                           a_build):
            score_block_kernel(imp_t, term_t, slot_of, qc_t, live,
                               a_build=a_build, out=scores, row0=row0)
        else:
            scores[:, row0:row0 + live] = _score_block(
                imp_t.T, term_t.T, slot_of, qc_t, doc_chunk)[:, :live]
        row0 += live
    scores[:, row0:] = 0.0
    return scores


def _no_stage(_name: str):
    return contextlib.nullcontext()


def make_mesh_ell_search(mesh: Mesh,
                         delta_chunk: int = 1 << 17,
                         *,
                         k: int,
                         model: str = "bm25",
                         k1: float = 1.2,
                         b: float = 0.75,
                         use_pallas: bool = True,
                         a_build: str = "v4",
                         packed: bool = False):
    """Distributed search over ELL base + COO delta.

    ``search(base, delta, df_g, n, avgdl, q, stage=None) -> (top_vals
    [B,k], gids [B,k])`` on ``mesh.home`` (``packed``: one i32
    ``[B, 2k]``). ``gids`` encode ``row * (doc_cap_ell + doc_cap_delta) +
    local``, where local < doc_cap_ell is an ELL row and local >=
    doc_cap_ell a delta slot. Global stats arrive precomputed (the index
    refreshes them at commit), so the step sums no df.

    The step: every rank compiles the batch (``_compile_queries``, once
    per device), scores its ELL blocks (the kernel on every eligible
    block) and its residual and delta slices; the base and delta scores
    are summed over ``terms``; each docs row masks its tombstones, takes
    its exact top-k and maps it to global ids; the rows' top-k are
    gathered over ``docs`` and merged. ``stage(name)`` (a context-manager
    factory) wraps each stage — ``compile``, ``ell``, ``coo``, ``psum``,
    ``topk``, ``all_gather``, ``merge`` — for a caller that times them."""

    def search(base: MeshEllArrays, delta: ShardedArrays, df_g, n_docs,
               avgdl, q: QueryBatch, stage=_no_stage):
        comm, T = mesh.comm, mesh.T
        doc_cap_ell, doc_cap_delta = base.doc_cap, delta.doc_cap
        vocab_cap = df_g.shape[0]
        u_cap = q.uniq.shape[0]
        with stage("compile"):
            qs = _rank_queries(mesh, q)
            dfs, ns, avs = (mesh.replicate(df_g), mesh.replicate(n_docs),
                            mesh.replicate(avgdl))
            compiled = {}
            for dev, qd in qs.items():
                slot_of, qc_ext = _compile_queries(qd, vocab_cap)
                compiled[dev] = (slot_of, qc_ext, qc_ext.T.contiguous())
        ell, dlt = {}, {}
        with stage("ell"):
            for d, t in mesh.local:
                r = d * T + t
                slot_of, _, qc_t = compiled[mesh.devices[d, t]]
                ell[(d, t)] = _score_rank_ell(
                    base.impact[r], base.term[r], base.block_live[d],
                    doc_cap_ell, slot_of, qc_t, u_cap,
                    use_pallas=use_pallas, a_build=a_build)
        with stage("coo"):
            dchunk = min(delta_chunk, delta.chunk_cap)
            for d, t in mesh.local:
                r = d * T + t
                dev = mesh.devices[d, t]
                slot_of, qc_ext, _ = compiled[dev]
                ell[(d, t)] += score_coo_compiled(
                    base.res_tf[r], base.res_term[r], base.res_doc[r],
                    base.res_dl[r], dfs[dev], slot_of, qc_ext, ns[dev],
                    avs[dev], None, model=model, k1=k1, b=b,
                    chunk=min(RES_CHUNK, base.res_tf[r].shape[0]),
                    plan=base.res_plan[r])
                dlt[(d, t)] = score_coo_compiled(
                    delta.tf[r], delta.term[r], delta.doc[r],
                    delta.doc_len[r], dfs[dev], slot_of, qc_ext, ns[dev],
                    avs[dev], None, model=model, k1=k1, b=b, chunk=dchunk,
                    plan=delta.plan(mesh, d, t, dchunk))
        with stage("psum"):
            ell = comm.psum(mesh, ell, "terms", rows_only=True)
            dlt = comm.psum(mesh, dlt, "terms", rows_only=True)
        vals, gids = {}, {}
        with stage("topk"):
            for d in mesh.local_rows:
                scores = torch.cat(
                    [ell[d] * base.live[d * T][None, :],
                     dlt[d] * delta.live[d * T][None, :]], dim=1)
                # the ELL space is permuted, so liveness is per position:
                # dead positions score 0 and the prefix covers them all
                v, ids = exact_topk(scores,
                                    doc_cap_ell + int(delta.n_live[d]), k=k)
                vals[d] = v
                gids[d] = (mesh.axis_index((d, 0), "docs")
                           * (doc_cap_ell + doc_cap_delta) + ids)
        del ell, dlt
        with stage("all_gather"):
            all_vals = comm.all_gather(mesh, vals)
            all_ids = comm.all_gather(mesh, gids)
        with stage("merge"):
            top_vals, top_ids = merge_topk(all_vals, all_ids)
            if packed:
                return pack_topk(top_vals, top_ids)
        return top_vals, top_ids

    return search


def with_ell_live(mesh: Mesh, arrays: MeshEllArrays,
                  live_host: np.ndarray) -> MeshEllArrays:
    """Tombstone update in ELL row space (new tensors, host-rebuilt like
    the delta's ``with_live_mask``)."""
    return dataclasses.replace(
        arrays, live=mesh.put_rows(live_host.astype(np.float32)))
