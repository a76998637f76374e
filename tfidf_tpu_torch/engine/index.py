"""ShardIndex — one worker's index with commit/snapshot semantics, on a
torch device.

The counterpart of ``tfidf_tpu/engine/index.py``:

* ``add_document`` is an idempotent upsert keyed on document name;
* ``commit()`` publishes an immutable :class:`Snapshot` of device tensors;
  searches always run against the last committed snapshot;
* per-document postings stay host-side as numpy (term ids, tfs), the
  source of truth every snapshot is rebuilt from.

Two layouts: blocked ELL (the default fast path — precomputed impact
blocks, scored by the hand-written kernel) and COO. The ELL snapshot also
holds a width-major copy of every block (``[W, rows_cap]``, the kernel's
coalesced layout), built once here so no query batch transposes, and the
host-built gather map into the real doc-id space.

``export_snapshot_arrays`` / ``install_snapshot_arrays`` use the JAX
package's npz keys, so an index built by either package serves from the
other.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from tfidf_tpu_torch.device import resolve_device
from tfidf_tpu_torch.models.base import ScoringModel
from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.ell import (build_ell_from_coo, cosine_norms_host,
                                     ell_impacts)
from tfidf_tpu_torch.ops.scoring import Segment, cosine_norms, segment_plan
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("engine.index")

# entries per residual / COO scoring chunk (the JAX scorers' defaults)
RES_CHUNK = 1 << 10
COO_CHUNK = 1 << 17


@dataclass
class DocEntry:
    name: str
    term_ids: np.ndarray   # i32 [k], sorted
    tfs: np.ndarray        # f32 [k]
    length: float          # analyzed token count (pre-quantization)
    live: bool = True


def check_sorted_unique_ids(name: str, ids: np.ndarray) -> None:
    """Term ids must be strictly ascending (sorted AND distinct): the ELL
    layout stores one posting per distinct term, and the kernel's v4 pair
    step relies on it."""
    if ids.shape[0] > 1 and not (np.diff(ids) > 0).all():
        raise ValueError(
            f"add_document_arrays({name!r}): term ids must be strictly "
            "ascending (sorted, distinct) — merge duplicate ids into "
            "one entry with the summed tf")


def entries_from_packed(names: list[str], offsets: np.ndarray,
                        term_ids: np.ndarray, tfs: np.ndarray,
                        lengths: np.ndarray):
    """Doc-table construction from packed CSR-style arrays with per-doc
    numpy VIEWS. Returns ``(entries, (offsets, term_ids, tfs, lengths))``
    with the dtype-coerced arrays the entries view."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    term_ids = np.ascontiguousarray(term_ids, np.int32)
    tfs = np.ascontiguousarray(tfs, np.float32)
    lengths = np.ascontiguousarray(lengths, np.float32)
    lo = offsets[:-1].tolist()
    hi = offsets[1:].tolist()
    lens = lengths.tolist()
    entries = [DocEntry(name=names[i], term_ids=term_ids[lo[i]:hi[i]],
                        tfs=tfs[lo[i]:hi[i]], length=lens[i])
               for i in range(len(names))]
    return entries, (offsets, term_ids, tfs, lengths)


@dataclass
class Snapshot:
    """Immutable device-resident index state — what queries score against.

    COO layout: ``tf``/``term``/``doc`` tensors. ELL layout: the block
    tuples + COO residual; the COO fields stay None. Scalars the host
    needs to size work (``num_docs``, block live counts) are Python ints;
    ``n_docs``/``avgdl`` are 0-d device tensors like the JAX snapshot's.
    """

    tf: torch.Tensor | None    # f32 [nnz_cap] (None in ELL layout)
    term: torch.Tensor | None  # i32 [nnz_cap]
    doc: torch.Tensor | None   # i32 [nnz_cap]
    doc_len: torch.Tensor      # f32 [doc_cap] (model-transformed)
    df: torch.Tensor           # f32 [vocab_cap]
    doc_norms: torch.Tensor    # f32 [doc_cap] (zeros unless cosine)
    n_docs: torch.Tensor       # f32 0-d
    avgdl: torch.Tensor        # f32 0-d
    num_docs: int              # live rows (top-k masking)
    doc_names: list[str] = field(default_factory=list)
    version: int = 0
    nnz: int = 0
    # COO scoring plan (COO layout only): runs of equal doc per chunk
    coo_plan: list[Segment] | None = None
    # blocked ELL: impacts + term rows per block, row-major (npz layout)
    ell_impacts: tuple = ()       # f32 [rows_cap_i, width_i]
    ell_terms: tuple = ()         # i32 [rows_cap_i, width_i]
    # the kernel's width-major copies [width_i, rows_cap_i]
    ell_impacts_t: tuple = ()
    ell_terms_t: tuple = ()
    ell_live: tuple = ()          # int live rows per block
    res_tf: torch.Tensor | None = None      # f32 [res_cap] (None: no spill)
    res_term: torch.Tensor | None = None    # i32 [res_cap]
    res_doc: torch.Tensor | None = None     # i32 [res_cap]
    res_plan: list[Segment] | None = None

    @property
    def is_ell(self) -> bool:
        return bool(self.ell_impacts) or self.tf is None

    @property
    def num_names(self) -> int:
        return len(self.doc_names)

    def size_bytes(self) -> int:
        arrays = [self.tf, self.term, self.doc, self.doc_len, self.df,
                  self.res_tf, self.res_term, self.res_doc,
                  *self.ell_impacts, *self.ell_terms]
        return int(sum(a.numel() * a.element_size()
                       for a in arrays if a is not None))


def _t(x, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(x, dtype=dtype)
    if not arr.flags.writeable:   # e.g. arrays loaded from an npz
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _ell_fields(impacts, terms, live, res, device) -> dict:
    """Snapshot fields of the ELL layout from per-block device tensors:
    adds the kernel's width-major copies and the residual's segment plan
    (both built once, here)."""
    kw: dict = dict(
        ell_impacts=tuple(impacts), ell_terms=tuple(terms),
        ell_impacts_t=tuple(i.T.contiguous() for i in impacts),
        ell_terms_t=tuple(t.T.contiguous() for t in terms),
        ell_live=tuple(int(n) for n in live))
    if res is not None:
        res_tf, res_term, res_doc = res
        res_nnz = int(np.count_nonzero(res_tf))
        kw.update(res_tf=_t(res_tf, device, np.float32),
                  res_term=_t(res_term, device, np.int32),
                  res_doc=_t(res_doc, device, np.int32),
                  res_plan=segment_plan(
                      res_doc, res_nnz, min(RES_CHUNK, len(res_tf)),
                      device))
    return kw


class ShardIndex:
    def __init__(self, model: ScoringModel,
                 min_nnz_cap: int = 1 << 16,
                 min_doc_cap: int = 1024,
                 layout: str = "ell",
                 ell_width_cap: int = 256,
                 device=None) -> None:
        self.model = model
        self.min_nnz_cap = min_nnz_cap
        self.min_doc_cap = min_doc_cap
        self.layout = layout          # "ell" | "coo"
        self.ell_width_cap = ell_width_cap
        self.device = resolve_device(device)
        self._docs: list[DocEntry] = []
        self._by_name: dict[str, int] = {}
        # packed postings from a bulk load: while no mutation has landed
        # since, to_coo() builds the COO with pure vectorized numpy
        self._packed: tuple | None = None
        self._packed_gen = -1
        self._write_lock = threading.Lock()   # single-writer
        # generation counter: commit() compares generations, so a write
        # that lands while a snapshot is being built is never lost
        self._gen = 1
        self._committed_gen = 0
        self.snapshot: Snapshot | None = None
        self._version = 0

    # ---- write path ----

    def add_document(self, name: str, id_counts: dict[int, int],
                     length: float | None = None) -> None:
        """Upsert by name. ``id_counts`` is the analyzed, vocab-mapped TF
        map."""
        if id_counts:
            items = sorted(id_counts.items())
            ids = np.fromiter((t for t, _ in items), np.int32, len(items))
            tfs = np.fromiter((f for _, f in items), np.float32,
                              len(items))
        else:
            ids = np.empty(0, np.int32)
            tfs = np.empty(0, np.float32)
        self.add_document_arrays(name, ids, tfs, length)

    def add_document_arrays(self, name: str, ids: np.ndarray,
                            tfs: np.ndarray,
                            length: float | None = None) -> None:
        """Upsert from pre-sorted id/tf arrays."""
        ids = np.asarray(ids, np.int32)
        check_sorted_unique_ids(name, ids)
        entry = DocEntry(
            name=name, term_ids=ids,
            tfs=np.asarray(tfs, np.float32),
            length=float(length if length is not None else tfs.sum()))
        with self._write_lock:
            old = self._by_name.get(name)
            if old is not None:
                self._docs[old].live = False
            self._by_name[name] = len(self._docs)
            self._docs.append(entry)
            self._gen += 1
        global_metrics.inc("docs_indexed")

    def bulk_load_packed(self, names: list[str], offsets: np.ndarray,
                         term_ids: np.ndarray, tfs: np.ndarray,
                         lengths: np.ndarray) -> None:
        """Build the doc table directly from packed CSR-style arrays
        (``offsets[n+1]``, ``term_ids[nnz]``, ``tfs[nnz]``,
        ``lengths[n]``) with per-doc numpy views. Only valid on an empty
        index."""
        entries, (offsets, term_ids, tfs, lengths) = \
            entries_from_packed(names, offsets, term_ids, tfs, lengths)
        n = len(names)
        with self._write_lock:
            if self._docs:
                raise ValueError("bulk_load_packed requires an empty index")
            self._docs = entries
            self._by_name = dict(zip(names, range(n)))
            if len(self._by_name) != n:
                self._docs, self._by_name = [], {}
                raise ValueError("bulk_load_packed: duplicate names")
            self._gen += 1
            self._packed = (offsets, term_ids, tfs, lengths, list(names))
            self._packed_gen = self._gen
        global_metrics.inc("docs_indexed", n)

    def delete_document(self, name: str) -> bool:
        with self._write_lock:
            idx = self._by_name.pop(name, None)
            if idx is None or not self._docs[idx].live:
                return False
            self._docs[idx].live = False
            self._gen += 1
            return True

    # ---- stats ----

    def live_names(self) -> list[str]:
        return [d.name for d in self._docs if d.live]

    @property
    def num_live_docs(self) -> int:
        return len(self._by_name)

    def size_bytes(self) -> int:
        """Load metric: live postings content (not padded capacity)."""
        return int(sum(d.term_ids.nbytes + d.tfs.nbytes
                       for d in self._docs if d.live))

    # ---- iteration (for checkpointing) ----

    def live_entries(self) -> list[DocEntry]:
        with self._write_lock:
            return [d for d in self._docs if d.live]

    def live_entries_and_gen(self) -> tuple[list[DocEntry], int]:
        """Entries plus the generation they were read at, atomically —
        the token a checkpoint save uses to prove that the doc table and
        the exported snapshot describe the same corpus."""
        with self._write_lock:
            return [d for d in self._docs if d.live], self._gen

    # ---- commit (publish an immutable snapshot) ----

    def _to_coo_packed(self, vocab_cap: int) -> tuple[CooShard, list[str],
                                                      np.ndarray]:
        """Vectorized COO build from bulk-loaded packed arrays (caller
        holds the write lock), same width-sorted layout as the general
        path."""
        offsets, all_ids, all_tfs, lengths, names = self._packed
        n_live = len(names)
        widths = offsets[1:] - offsets[:-1]
        order = np.argsort(-widths, kind="stable")
        w = widths[order]
        nnz = int(w.sum())
        nnz_cap = next_capacity(max(nnz, 1), self.min_nnz_cap)
        doc_cap = next_capacity(max(n_live, 1), self.min_doc_cap)
        tf = np.zeros(nnz_cap, np.float32)
        term = np.zeros(nnz_cap, np.int32)
        doc = np.full(nnz_cap, doc_cap - 1, np.int32)
        if nnz:
            out_off = np.zeros(n_live, np.int64)
            np.cumsum(w[:-1], out=out_off[1:])
            idx = (np.arange(nnz, dtype=np.int64)
                   - np.repeat(out_off, w)
                   + np.repeat(offsets[:-1][order], w))
            tf[:nnz] = all_tfs[idx]
            term[:nnz] = all_ids[idx]
            doc[:nnz] = np.repeat(np.arange(n_live, dtype=np.int32), w)
        df = (np.bincount(term[:nnz], minlength=vocab_cap)[:vocab_cap]
              .astype(np.float32) if nnz else np.zeros(vocab_cap,
                                                       np.float32))
        names_sorted = [names[i] for i in order]
        raw_len = lengths[order] if n_live else np.zeros(0, np.float32)
        doc_len = np.zeros(doc_cap, np.float32)
        doc_len[:n_live] = raw_len
        coo = CooShard(tf=tf, term=term, doc=doc, doc_len=doc_len, df=df,
                       nnz=nnz, num_docs=n_live)
        return coo, names_sorted, raw_len

    def to_coo(self, vocab_cap: int) -> tuple[CooShard, list[str],
                                              np.ndarray]:
        """Rebuild a host COO from live docs. Returns (coo, names,
        raw_len); rows sorted by distinct-term count DESC (stable)."""
        with self._write_lock:
            if self._packed is not None and self._gen == self._packed_gen:
                return self._to_coo_packed(vocab_cap)
            self._packed = None   # mutated since the bulk load: drop it
            live = [d for d in self._docs if d.live]
        n_live = len(live)
        sizes0 = np.fromiter((d.term_ids.shape[0] for d in live),
                             np.int64, n_live)
        order = np.argsort(-sizes0, kind="stable")
        live = [live[i] for i in order]
        names = [d.name for d in live]
        sizes = sizes0[order]
        nnz = int(sizes.sum()) if n_live else 0
        nnz_cap = next_capacity(max(nnz, 1), self.min_nnz_cap)
        doc_cap = next_capacity(max(n_live, 1), self.min_doc_cap)
        tf = np.zeros(nnz_cap, np.float32)
        term = np.zeros(nnz_cap, np.int32)
        doc = np.full(nnz_cap, doc_cap - 1, np.int32)
        if nnz:
            tf[:nnz] = np.concatenate([d.tfs for d in live])
            term[:nnz] = np.concatenate([d.term_ids for d in live])
            doc[:nnz] = np.repeat(np.arange(n_live, dtype=np.int32), sizes)
        df = (np.bincount(term[:nnz], minlength=vocab_cap)[:vocab_cap]
              .astype(np.float32) if nnz else np.zeros(vocab_cap,
                                                       np.float32))
        raw_len = (np.fromiter((d.length for d in live), np.float32,
                               n_live)
                   if n_live else np.zeros(0, np.float32))
        doc_len = np.zeros(doc_cap, np.float32)
        doc_len[:n_live] = raw_len
        coo = CooShard(tf=tf, term=term, doc=doc, doc_len=doc_len, df=df,
                       nnz=nnz, num_docs=n_live)
        return coo, names, raw_len

    def commit(self, vocab_cap: int) -> Snapshot:
        """Build + publish the device snapshot (Lucene ``commit()``
        analog)."""
        gen0 = self._gen
        if self._committed_gen == gen0 and self.snapshot is not None \
                and self.snapshot.df.shape[0] == vocab_cap:
            return self.snapshot
        coo, names, raw_len = self.to_coo(vocab_cap)
        self._version += 1
        n_live = len(names)
        dev = self.device
        kernel_len = self.model.transform_doc_len(
            coo.doc_len[:n_live].astype(np.float32))
        doc_len_host = np.zeros(coo.doc_cap, np.float32)
        doc_len_host[:n_live] = kernel_len

        df = _t(coo.df, dev, np.float32)
        n_docs = _t(np.float32(n_live), dev)
        # avgdl from exact lengths (Lucene: sumTotalTermFreq / docCount)
        total = float(raw_len[:n_live].sum())
        avgdl = _t(np.float32(total / n_live if n_live else 1.0), dev)

        if self.layout == "ell":
            if self.model.needs_norms:
                norms_host = cosine_norms_host(coo, float(n_live))
            else:
                norms_host = np.zeros(coo.doc_cap, np.float32)
            norms = _t(norms_host, dev)
            ell = build_ell_from_coo(
                coo, width_cap=self.ell_width_cap,
                min_rows=min(256, self.min_doc_cap))
            impacts, terms, live = [], [], []
            kw = self.model.score_kwargs()
            for blk in ell.blocks:
                rows_cap = blk.tf.shape[0]
                dl_blk = np.zeros(rows_cap, np.float32)
                dl_blk[:blk.n_rows] = doc_len_host[
                    blk.row0:blk.row0 + blk.n_rows]
                nrm_blk = np.zeros(rows_cap, np.float32)
                nrm_blk[:blk.n_rows] = norms_host[
                    blk.row0:blk.row0 + blk.n_rows]
                term_d = _t(blk.term, dev)
                impacts.append(ell_impacts(
                    _t(blk.tf, dev), term_d, _t(dl_blk, dev), df, n_docs,
                    avgdl, _t(nrm_blk, dev), **kw))
                terms.append(term_d)
                live.append(blk.n_rows)
            tf = term = doc = None
            res = ((ell.res_tf, ell.res_term, ell.res_doc)
                   if ell.res_nnz else None)
            layout_kw = _ell_fields(impacts, terms, live, res, dev)
        else:
            tf = _t(coo.tf, dev)
            term = _t(coo.term, dev)
            doc = _t(coo.doc, dev)
            if self.model.needs_norms:
                norms = cosine_norms(tf, term, doc, df, n_docs, coo.doc_cap,
                                     segment_plan(coo.doc, coo.nnz,
                                                  max(coo.nnz, 1), dev))
            else:
                norms = torch.zeros(coo.doc_cap, dtype=torch.float32,
                                    device=dev)
            layout_kw = dict(coo_plan=segment_plan(
                coo.doc, coo.nnz, min(COO_CHUNK, coo.nnz_cap), dev))
        snap = Snapshot(
            tf=tf, term=term, doc=doc,
            doc_len=_t(doc_len_host, dev),
            df=df, doc_norms=norms,
            n_docs=n_docs, avgdl=avgdl,
            num_docs=n_live,
            doc_names=names, version=self._version, nnz=coo.nnz,
            **layout_kw,
        )
        self.snapshot = snap
        self._committed_gen = gen0
        global_metrics.set_gauge("index_nnz", coo.nnz)
        global_metrics.set_gauge("index_docs", n_live)
        global_metrics.set_gauge("index_size_bytes", snap.size_bytes())
        log.info("committed snapshot", version=self._version,
                 docs=n_live, nnz=coo.nnz)
        return snap

    # ---- snapshot array export/install (same npz keys as tfidf_tpu) ----

    def export_snapshot_arrays(self) -> tuple[dict, list[str], int] | None:
        """The committed snapshot as host numpy arrays under the JAX
        package's npz keys, or None when there is no clean committed
        snapshot. Returns ``(arrays, snapshot_doc_names, gen)``."""
        with self._write_lock:
            snap = self.snapshot
            if snap is None or self._committed_gen != self._gen:
                return None
            gen = self._gen

        def h(t):
            return t.cpu().numpy()

        out: dict[str, np.ndarray] = {
            "doc_len": h(snap.doc_len),
            "df": h(snap.df),
            "doc_norms": h(snap.doc_norms),
            "n_docs": np.float32(h(snap.n_docs)),
            "avgdl": np.float32(h(snap.avgdl)),
            "num_docs": np.int32(snap.num_docs),
            "nnz": np.int64(snap.nnz),
            "version": np.int64(snap.version),
        }
        if snap.is_ell:
            out["n_blocks"] = np.int64(len(snap.ell_impacts))
            for i, (imp, term) in enumerate(zip(snap.ell_impacts,
                                                snap.ell_terms)):
                out[f"ell_imp_{i}"] = h(imp)
                out[f"ell_term_{i}"] = h(term)
            out["ell_live"] = np.asarray(snap.ell_live, np.int32)
            if snap.res_tf is not None:
                out["res_tf"] = h(snap.res_tf)
                out["res_term"] = h(snap.res_term)
                out["res_doc"] = h(snap.res_doc)
        else:
            out["coo_tf"] = h(snap.tf)
            out["coo_term"] = h(snap.term)
            out["coo_doc"] = h(snap.doc)
        return out, list(snap.doc_names), gen

    def install_snapshot_arrays(self, data, doc_names: list[str]) -> None:
        """Publish a snapshot rebuilt from exported arrays — this
        package's or the JAX package's ``export_snapshot_arrays()`` (same
        keys). The caller guarantees the scoring config matches the one
        the arrays were built under; the doc table is not touched."""
        dev = self.device
        doc_len = _t(data["doc_len"], dev, np.float32)
        tf = term = doc = None
        if "n_blocks" in data:
            nb = int(data["n_blocks"])
            res = ((data["res_tf"], data["res_term"], data["res_doc"])
                   if "res_tf" in data else None)
            layout_kw = _ell_fields(
                [_t(data[f"ell_imp_{i}"], dev, np.float32)
                 for i in range(nb)],
                [_t(data[f"ell_term_{i}"], dev, np.int32)
                 for i in range(nb)],
                np.asarray(data["ell_live"]).tolist(), res, dev)
        else:
            coo_doc = np.asarray(data["coo_doc"], np.int32)
            tf = _t(data["coo_tf"], dev, np.float32)
            term = _t(data["coo_term"], dev, np.int32)
            doc = _t(coo_doc, dev)
            nnz = int(data["nnz"])
            layout_kw = dict(coo_plan=segment_plan(
                coo_doc, nnz, min(COO_CHUNK, coo_doc.shape[0]), dev))
        with self._write_lock:
            self._version = int(data["version"])
            snap = Snapshot(
                tf=tf, term=term, doc=doc,
                doc_len=doc_len,
                df=_t(data["df"], dev, np.float32),
                doc_norms=_t(data["doc_norms"], dev, np.float32),
                n_docs=_t(np.float32(data["n_docs"]), dev),
                avgdl=_t(np.float32(data["avgdl"]), dev),
                num_docs=int(data["num_docs"]),
                doc_names=list(doc_names), version=self._version,
                nnz=int(data["nnz"]),
                **layout_kw,
            )
            self.snapshot = snap
            self._committed_gen = self._gen
        global_metrics.set_gauge("index_nnz", snap.nnz)
        global_metrics.set_gauge("index_docs", len(doc_names))
        global_metrics.set_gauge("index_size_bytes", snap.size_bytes())
        log.info("installed snapshot arrays", docs=len(doc_names),
                 nnz=snap.nnz, version=self._version)
