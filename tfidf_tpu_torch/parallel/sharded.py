"""Sharded COO scoring over the mesh — the distributed forward step.

The counterpart of ``tfidf_tpu/parallel/sharded.py``. There one
``shard_map`` program scores every device's COO block, ``psum``s the
document frequencies and the partial scores, and merges the per-shard
top-k after an ``all_gather``; here the same step is per-rank torch work
staged around :mod:`~tfidf_tpu_torch.parallel.collectives`:

    per-rank   df (local)           -> psum over both axes (global IDF)
    per-rank   partial scores       -> psum over terms
    per-row    tombstone mask, exact top-k, global ids -> all_gather docs
    home       merge_topk

Host-side layout (:func:`build_sharded_arrays`) is the JAX package's:
documents dealt round-robin into ``D`` docs shards, each shard's COO split
into ``T`` contiguous chunks along nnz. Every process builds the same
host layout and keeps only its own ranks' slices on its devices; the
append cursors (``n_live``, ``nnz_used``), the length sums and the ``doc``
column (whose runs plan the segment sums) stay on the host.

Mutations are out of place (:func:`make_sharded_ingest`,
:func:`with_live_mask` return new arrays), as JAX arrays are immutable: a
snapshot a searcher holds never changes under it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.scoring import (QueryBatch, _compile_queries,
                                         cosine_norms, score_coo_compiled,
                                         segment_plan)
from tfidf_tpu_torch.ops.topk import exact_topk, merge_topk, pack_topk
from tfidf_tpu_torch.parallel.mesh import Mesh


@dataclass
class ShardedArrays:
    """The corpus on the mesh. Per-rank lists are indexed ``d * T + t``
    (None for ranks another process drives); D = docs rows, T = terms."""

    tf: list             # f32 [chunk_cap] per rank
    term: list           # i32 [chunk_cap] per rank
    doc: list            # i32 [chunk_cap] per rank
    doc_len: list        # f32 [doc_cap] per rank (its row's)
    df: list             # f32 [vocab_cap] per rank (partial df)
    live: list           # f32 [doc_cap] per rank — 1=live, 0=tombstone/pad
    n_live: np.ndarray   # i32 [D] occupied doc slots (append cursor)
    nnz_used: np.ndarray  # i32 [D, T] entries in use per block
    # sum of RAW (pre-norm-quantization) lengths per row: avgdl comes from
    # exact lengths even when doc_len holds quantized values (parity mode)
    len_sum: np.ndarray  # f32 [D]
    doc_host: np.ndarray  # i32 [D, T, chunk_cap] the `doc` column
    doc_cap: int
    vocab_cap: int
    _plans: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def chunk_cap(self) -> int:
        return self.doc_host.shape[-1]

    def plan(self, mesh: Mesh, d: int, t: int, chunk: int):
        """Segment plan of rank ``(d, t)``'s used entries in chunks of
        ``chunk`` (cached: the arrays never change)."""
        key = (d, t, chunk)
        if key not in self._plans:
            self._plans[key] = segment_plan(
                self.doc_host[d, t], int(self.nnz_used[d, t]), chunk,
                mesh.devices[d, t])
        return self._plans[key]


def _split_ranges(k: int, t_parts: int) -> list[tuple[int, int]]:
    """Contiguous ceil-split of k entries over t_parts terms blocks — the
    single source of truth for the entry partition."""
    step = -(-k // t_parts) if k else 0
    return [(min(t * step, k), min((t + 1) * step, k))
            for t in range(t_parts)]


def shard_documents(n_docs: int, n_shards: int) -> np.ndarray:
    """Round-robin placement: doc i -> shard i % D."""
    return np.arange(n_docs, dtype=np.int64) % n_shards


def _place(mesh: Mesh, g_tf, g_term, g_doc, g_len, g_df, g_live, counts,
           g_used, g_len_sum, doc_cap, vocab_cap) -> ShardedArrays:
    return ShardedArrays(
        tf=mesh.put_blocks(g_tf), term=mesh.put_blocks(g_term),
        doc=mesh.put_blocks(g_doc), doc_len=mesh.put_rows(g_len),
        df=mesh.put_blocks(g_df), live=mesh.put_rows(g_live),
        n_live=np.asarray(counts, np.int32),
        nnz_used=np.asarray(g_used, np.int32),
        len_sum=np.asarray(g_len_sum, np.float32),
        doc_host=np.asarray(g_doc, np.int32),
        doc_cap=int(doc_cap), vocab_cap=int(vocab_cap))


def build_sharded_arrays(shard: CooShard,
                         mesh: Mesh,
                         min_chunk_cap: int = 1 << 14,
                         min_doc_cap: int = 1024,
                         headroom: float = 0.25,
                         raw_doc_len: np.ndarray | None = None
                         ) -> ShardedArrays:
    """Partition one host COO shard across a (docs, terms) mesh — the JAX
    package's layout, capacities and padding, array for array.

    ``raw_doc_len`` (defaults to ``shard.doc_len``): exact
    pre-quantization lengths for the per-row avgdl sums."""
    D, T = mesh.D, mesh.T
    nnz, n_docs = shard.nnz, shard.num_docs
    tf = np.asarray(shard.tf)[:nnz]
    term = np.asarray(shard.term)[:nnz]
    doc = np.asarray(shard.doc)[:nnz].astype(np.int64)
    doc_len_src = np.asarray(shard.doc_len)
    vocab_cap = shard.vocab_cap

    assign = shard_documents(n_docs, D)
    local_id = np.zeros(n_docs, np.int64)
    counts = np.zeros(D, np.int64)
    for s in range(D):
        mask = assign == s
        local_id[mask] = np.arange(mask.sum())
        counts[s] = mask.sum()
    grow = 1.0 + max(headroom, 0.0)
    doc_cap = next_capacity(
        int(max(int(counts.max()) if D else 1, 1) * grow) + 1, min_doc_cap)

    entry_shard = assign[doc]
    chunk_caps = []
    per_shard = []
    for s in range(D):
        m = entry_shard == s
        k = int(m.sum())
        per_shard.append((tf[m], term[m], local_id[doc[m]].astype(np.int32)))
        chunk_caps.append(-(-k // T))
    chunk_cap = next_capacity(
        int(max(max(chunk_caps, default=1), 1) * grow) + 1, min_chunk_cap)

    g_tf = np.zeros((D, T, chunk_cap), np.float32)
    g_term = np.zeros((D, T, chunk_cap), np.int32)
    # sorted-padding: free entries point at the last row (zero contribution)
    g_doc = np.full((D, T, chunk_cap), doc_cap - 1, np.int32)
    g_len = np.zeros((D, doc_cap), np.float32)
    g_df = np.zeros((D, T, vocab_cap), np.float32)
    g_used = np.zeros((D, T), np.int32)
    for s in range(D):
        stf, sterm, sdoc = per_shard[s]
        for t, (lo, hi) in enumerate(_split_ranges(stf.shape[0], T)):
            n = hi - lo
            g_used[s, t] = n
            if n > 0:
                g_tf[s, t, :n] = stf[lo:hi]
                g_term[s, t, :n] = sterm[lo:hi]
                g_doc[s, t, :n] = sdoc[lo:hi]
                # COO entries are unique (doc, term) pairs: counting
                # entries is exactly df
                np.add.at(g_df[s, t], sterm[lo:hi], 1.0)
        g_len[s, :int(counts[s])] = doc_len_src[:n_docs][assign == s]

    g_live = (np.arange(doc_cap)[None, :]
              < counts[:, None]).astype(np.float32)
    raw = (np.asarray(raw_doc_len) if raw_doc_len is not None
           else doc_len_src)[:n_docs]
    g_len_sum = np.zeros(D, np.float32)
    for s in range(D):
        g_len_sum[s] = float(raw[assign == s].sum())
    return _place(mesh, g_tf, g_term, g_doc, g_len, g_df, g_live, counts,
                  g_used, g_len_sum, doc_cap, vocab_cap)


def global_stats(arrays: ShardedArrays) -> tuple[float, float]:
    """(N, avgdl) over the whole mesh from the stored lengths — host
    scalars (every row must be local)."""
    D = arrays.n_live.shape[0]
    T = len(arrays.doc_len) // D
    n = float(arrays.n_live.sum())
    total = float(sum(float(x.sum()) for x in arrays.doc_len[::T]))
    return n, total / max(n, 1.0)


def _step_stats(arrays: ShardedArrays) -> tuple:
    """The search step's global (N, avgdl): N and the RAW length sums
    summed over the docs rows in f32, in docs order, as the JAX step's
    ``psum`` over ``docs`` computes them (host values: the cursors and
    length sums live on the host)."""
    n = np.float32(0.0)
    total = np.float32(0.0)
    for c, x in zip(arrays.n_live, arrays.len_sum):
        n = np.float32(n + np.float32(c))
        total = np.float32(total + x)
    return n, np.float32(total / max(n, np.float32(1.0)))


def _scalar(x, dev) -> torch.Tensor:
    return torch.tensor(np.float32(x), dtype=torch.float32, device=dev)


def _rank_queries(mesh: Mesh, q: QueryBatch) -> dict:
    """The query batch on every distinct local device."""
    return {dev: (q if q.slots.device == dev else QueryBatch(
        q.uniq.to(dev), q.n_uniq, q.slots.to(dev), q.weights.to(dev),
        q.uniq_host)) for dev in mesh.local_devices()}


def _stats(mesh: Mesh, arrays: ShardedArrays, global_idf: bool):
    """Per-rank (df, N, avgdl): global (df summed over both axes, N and
    length sums over docs) or each row's own (parity mode)."""
    comm = mesh.comm
    parts = {(d, t): arrays.df[d * mesh.T + t] for d, t in mesh.local}
    if global_idf:
        df = comm.psum(mesh, parts, ("docs", "terms"))
        n, avgdl = _step_stats(arrays)
        stat = {d: (n, avgdl) for d in mesh.local_rows}
    else:
        df = comm.psum(mesh, parts, "terms")
        stat = {}
        for d in mesh.local_rows:
            n = np.float32(arrays.n_live[d])
            stat[d] = (n, np.float32(arrays.len_sum[d]
                                     / max(n, np.float32(1.0))))
    out = {}
    for d, t in mesh.local:
        dev = mesh.devices[d, t]
        n, avgdl = stat[d]
        out[(d, t)] = (df[(d, t)], _scalar(n, dev), _scalar(avgdl, dev))
    return out


def _sharded_scores(mesh: Mesh, arrays: ShardedArrays, q: QueryBatch, *,
                    model: str, k1: float, b: float, global_idf: bool,
                    chunk: int) -> dict:
    """``{d: [B, doc_cap]}`` row scores (terms summed, tombstones 0)."""
    comm = mesh.comm
    stats = _stats(mesh, arrays, global_idf)
    qs = _rank_queries(mesh, q)
    T = mesh.T
    chunk = min(chunk, arrays.chunk_cap)
    norms = None
    if model == "tfidf_cosine":
        # norms depend on the (global) df: per-entry squared weights
        # summed per rank, then over the terms axis
        sq = {}
        for d, t in mesh.local:
            r = d * T + t
            df, n, _ = stats[(d, t)]
            one = arrays.plan(mesh, d, t, max(int(arrays.nnz_used[d, t]),
                                              1))
            sq[(d, t)] = cosine_norms(arrays.tf[r], arrays.term[r],
                                      arrays.doc[r], df, n,
                                      arrays.doc_cap, one) ** 2
        norms = {k: torch.sqrt(v) for k, v in
                 comm.psum(mesh, sq, "terms").items()}
    partial = {}
    for d, t in mesh.local:
        r = d * T + t
        df, n, avgdl = stats[(d, t)]
        slot_of, qc_ext = _compile_queries(qs[mesh.devices[d, t]],
                                           arrays.vocab_cap)
        partial[(d, t)] = score_coo_compiled(
            arrays.tf[r], arrays.term[r], arrays.doc[r], arrays.doc_len[r],
            df, slot_of, qc_ext, n, avgdl,
            None if norms is None else norms[(d, t)], model=model, k1=k1,
            b=b, chunk=chunk, plan=arrays.plan(mesh, d, t, chunk))
    rows = comm.psum(mesh, partial, "terms", rows_only=True)
    return {d: s * arrays.live[d * T][None, :] for d, s in rows.items()}


def make_sharded_search(mesh: Mesh,
                        *,
                        k: int,
                        model: str = "bm25",
                        k1: float = 1.2,
                        b: float = 0.75,
                        global_idf: bool = True,
                        chunk: int = 1 << 17,
                        packed: bool = False):
    """The distributed search step for a fixed mesh/model.

    ``search(arrays, q) -> (top_vals [B, k], top_global_ids [B, k])`` on
    ``mesh.home`` (``packed``: one i32 ``[B, 2k]``). Global ids encode
    (docs row, local id) as ``row * doc_cap + id``. ``global_idf=False``
    scores each row against its own statistics, as each Java worker does
    (parity mode)."""

    def search(arrays: ShardedArrays, q: QueryBatch):
        rows = _sharded_scores(mesh, arrays, q, model=model, k1=k1, b=b,
                               global_idf=global_idf, chunk=chunk)
        vals, gids = {}, {}
        for d, scores in rows.items():
            v, ids = exact_topk(scores, int(arrays.n_live[d]), k=k)
            vals[d] = v
            gids[d] = mesh.axis_index((d, 0), "docs") * arrays.doc_cap + ids
        top_vals, top_ids = merge_topk(mesh.comm.all_gather(mesh, vals),
                                       mesh.comm.all_gather(mesh, gids))
        if packed:
            return pack_topk(top_vals, top_ids)
        return top_vals, top_ids

    return search


def make_sharded_scores(mesh: Mesh,
                        *,
                        model: str = "bm25",
                        k1: float = 1.2,
                        b: float = 0.75,
                        global_idf: bool = True,
                        chunk: int = 1 << 17):
    """Full per-row score matrices — the parity-mode (unbounded) path:
    ``scores(arrays, q) -> [D, B, doc_cap]`` on ``mesh.home``; the host
    ranks them. O(corpus) per query by definition."""

    def scores(arrays: ShardedArrays, q: QueryBatch):
        rows = _sharded_scores(mesh, arrays, q, model=model, k1=k1, b=b,
                               global_idf=global_idf, chunk=chunk)
        return mesh.comm.all_gather(mesh, rows)

    return scores


def build_ingest_batch(mesh: Mesh,
                       arrays: ShardedArrays,
                       new_docs_per_shard: list[list[dict[int, int]]],
                       lengths_per_shard: list[list[float]],
                       batch_chunk_cap: int,
                       raw_lengths_per_shard: list[list[float]] | None
                       = None):
    """Vectorize new documents into an ingest batch (host arrays):
    ``(new_tf [D,T,C], new_term, new_doc, new_count [D,T], new_len
    [D,L], new_docs [D], new_len_sum [D])``.

    ``new_docs_per_shard[d]`` holds the new docs placed on row d; they get
    local ids continuing after the row's live count, and their entries
    split over the terms axis as the initial build splits them. Raises
    where a block's free tail cannot hold the batch window."""
    D, T = mesh.D, mesh.T
    C = batch_chunk_cap
    doc_cap = arrays.doc_cap
    chunk_cap = arrays.chunk_cap
    used_now = arrays.nnz_used
    if int(used_now.max()) + C > chunk_cap:
        raise ValueError(
            f"ingest batch (cap {C}) does not fit free tail "
            f"(used max {int(used_now.max())} of {chunk_cap}); "
            "compact/re-shard with a larger nnz capacity first")
    n_live_before = [int(x) for x in arrays.n_live]
    max_new = max((len(d) for d in new_docs_per_shard), default=0)
    L = next_capacity(max(max_new, 1), 8)
    if max(n_live_before) + L > doc_cap:
        L = next_capacity(max(max_new, 1), 1)
    if max(n_live_before) + L > doc_cap:
        raise ValueError("docs-shard over doc capacity; re-shard")
    new_tf = np.zeros((D, T, C), np.float32)
    new_term = np.zeros((D, T, C), np.int32)
    new_doc = np.full((D, T, C), doc_cap - 1, np.int32)   # sorted-padding
    new_count = np.zeros((D, T), np.int32)
    new_len = np.zeros((D, L), np.float32)
    new_docs = np.zeros(D, np.int32)
    raws = (raw_lengths_per_shard if raw_lengths_per_shard is not None
            else lengths_per_shard)
    new_len_sum = np.asarray([float(sum(r)) for r in raws], np.float32)
    for d in range(D):
        docs = new_docs_per_shard[d]
        lens = lengths_per_shard[d]
        tfs, terms, rows = [], [], []
        for i, counts in enumerate(docs):
            local = n_live_before[d] + i
            new_len[d, i] = lens[i]
            for t, f in sorted(counts.items()):
                if not 0 <= t < arrays.vocab_cap:
                    raise ValueError(
                        f"term id {t} outside vocab capacity "
                        f"{arrays.vocab_cap}; grow the vocabulary and "
                        "rebuild the sharded arrays first")
                terms.append(t)
                tfs.append(float(f))
                rows.append(local)
        new_docs[d] = len(docs)
        for t, (lo, hi) in enumerate(_split_ranges(len(tfs), T)):
            n = hi - lo
            if n > C:
                raise ValueError("ingest batch over chunk capacity")
            if n:
                new_tf[d, t, :n] = tfs[lo:hi]
                new_term[d, t, :n] = terms[lo:hi]
                new_doc[d, t, :n] = rows[lo:hi]
            new_count[d, t] = n
    return (new_tf, new_term, new_doc, new_count, new_len, new_docs,
            new_len_sum)


def make_sharded_ingest(mesh: Mesh):
    """The distributed ingest step — index growth on the devices, out of
    place. Each rank's block gets the batch's entries written at its
    append cursor (a copy of the block, the window written: the previous
    arrays stay as they were); df gains the new entries; the new lengths
    land at the row's live cursor and those slots turn live.

    ``ingest(arrays, *build_ingest_batch(...)) -> ShardedArrays``."""

    def ingest(arrays: ShardedArrays, new_tf, new_term, new_doc, new_count,
               new_len, new_docs, new_len_sum) -> ShardedArrays:
        T = mesh.T
        C, L = new_tf.shape[-1], new_len.shape[-1]
        tf, term, doc, df = (list(arrays.tf), list(arrays.term),
                             list(arrays.doc), list(arrays.df))
        doc_len, live = list(arrays.doc_len), list(arrays.live)
        for d, t in mesh.local:
            r = d * T + t
            dev = mesh.devices[d, t]
            used = int(arrays.nnz_used[d, t])
            for cols, new in ((tf, new_tf), (term, new_term),
                              (doc, new_doc)):
                x = cols[r].clone()
                x[used:used + C] = torch.from_numpy(new[d, t]).to(dev)
                cols[r] = x
            # pads (tf 0) land on term 0 with weight 0, as in the JAX
            # segment_sum over the whole window
            hit = torch.from_numpy((new_tf[d, t] > 0).astype(np.float32))
            df[r] = arrays.df[r].index_add(
                0, torch.from_numpy(new_term[d, t].astype(np.int64)).to(dev),
                hit.to(dev))
        for d in mesh.local_rows:
            n0, n_new = int(arrays.n_live[d]), int(new_docs[d])
            per_dev = {}
            for t in range(T):
                r, dev = d * T + t, mesh.devices[d, t]
                if dev not in per_dev:
                    dl = arrays.doc_len[r].clone()
                    dl[n0:n0 + L] = torch.from_numpy(new_len[d]).to(dev)
                    lv = arrays.live[r].clone()
                    lv[n0:n0 + n_new] = 1.0
                    per_dev[dev] = (dl, lv)
                doc_len[r], live[r] = per_dev[dev]
        doc_host = arrays.doc_host.copy()
        for d in range(mesh.D):
            for t in range(T):
                used = int(arrays.nnz_used[d, t])
                doc_host[d, t, used:used + C] = new_doc[d, t]
        return ShardedArrays(
            tf=tf, term=term, doc=doc, doc_len=doc_len, df=df, live=live,
            n_live=(arrays.n_live + new_docs).astype(np.int32),
            nnz_used=(arrays.nnz_used + new_count).astype(np.int32),
            len_sum=(arrays.len_sum + new_len_sum).astype(np.float32),
            doc_host=doc_host, doc_cap=arrays.doc_cap,
            vocab_cap=arrays.vocab_cap)

    return ingest


def with_live_mask(mesh: Mesh, arrays: ShardedArrays,
                   live_host: np.ndarray) -> ShardedArrays:
    """Replace the tombstone mask from a host [D, doc_cap] f32 array (new
    tensors; the postings are untouched)."""
    return dataclasses.replace(
        arrays, live=mesh.put_rows(live_host.astype(np.float32)),
        _plans=arrays._plans)


def live_host(arrays: ShardedArrays) -> np.ndarray:
    """The tombstone mask ``[D, doc_cap]`` on the host (every row must
    be local)."""
    T = len(arrays.live) // arrays.n_live.shape[0]
    return np.stack([x.cpu().numpy() for x in arrays.live[::T]])


# ---- ShardedArrays checkpoint, in the JAX package's npz format ----

_CKPT_FIELDS = ("tf", "term", "doc", "doc_len", "df", "n_live",
                "nnz_used", "live", "len_sum")


def save_sharded_arrays(arrays: ShardedArrays, path: str) -> None:
    """Write the full mesh state to one ``.npz`` (atomic via rename), in
    the keys and layout the JAX package writes: a file either package
    saved restores in the other. Every rank must be local."""
    from tfidf_tpu_torch.utils import storage
    if any(x is None for x in arrays.tf):
        raise ValueError("save_sharded_arrays: ranks of other processes "
                         "are not on this host")
    D = arrays.n_live.shape[0]
    T = len(arrays.tf) // D

    def blocks(xs):
        return np.stack([np.stack([xs[d * T + t].cpu().numpy()
                                   for t in range(T)]) for d in range(D)])

    def rows(xs):
        return np.stack([xs[d * T].cpu().numpy() for d in range(D)])

    data = {"tf": blocks(arrays.tf), "term": blocks(arrays.term),
            "doc": blocks(arrays.doc), "doc_len": rows(arrays.doc_len),
            "df": blocks(arrays.df), "n_live": arrays.n_live,
            "nnz_used": arrays.nnz_used, "live": rows(arrays.live),
            "len_sum": arrays.len_sum,
            "meta": np.asarray([arrays.doc_cap, arrays.vocab_cap],
                               np.int64)}
    tmp = path + ".part"
    storage.savez(tmp, **data)
    storage.replace(tmp, path)


def load_sharded_arrays(path: str, mesh: Mesh) -> ShardedArrays:
    """Restore a :func:`save_sharded_arrays` checkpoint (of either
    package) onto ``mesh``, which must have the (docs, terms) shape it was
    taken with."""
    data = np.load(path)
    D, T = data["tf"].shape[:2]
    if (mesh.D, mesh.T) != (D, T):
        raise ValueError(
            f"checkpoint was taken on a ({D}, {T}) mesh; restoring onto "
            f"{mesh.shape} requires a rebuild from documents")
    doc_cap, vocab_cap = (int(x) for x in data["meta"])
    return _place(mesh, data["tf"], data["term"], data["doc"],
                  data["doc_len"], data["df"], data["live"],
                  data["n_live"], data["nnz_used"], data["len_sum"],
                  doc_cap, vocab_cap)
