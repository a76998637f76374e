"""Engine — the per-node facade tying analyzer, vocab, index and searcher,
on a torch device.

The counterpart of ``tfidf_tpu/engine/engine.py`` in local mode: ingest
bytes -> text -> tokens -> vocab ids -> shard index; commit; search;
checkpoint (``engine/checkpoint.py``); rebuild. ``index_mode="rebuild"``
re-lays-out the corpus each commit (:class:`ShardIndex`);
``index_mode="segments"`` streams commits into immutable segments with
tombstones and tiered merges (:class:`SegmentedIndex`), and with
``tier_enabled`` keeps a hot set of segments on the card under a byte
budget and the rest in manifested spill files (:class:`TierManager`).
With the dense plane on (``embedding_enabled``, the Config default)
every document also feeds an
:class:`~tfidf_tpu_torch.engine.dense.EmbeddingColumn` and takes the
Python analyzer, so one tokenize feeds both planes; with it off, ASCII
documents take the native C++ tokenizer (:mod:`tfidf_tpu_torch.native`)
and others the result-identical Python analyzer. Raw documents on disk
are the source of truth: ``ingest_bytes`` / ``stage_bytes`` +
``publish_staged`` write them durably through
:mod:`tfidf_tpu_torch.utils.storage`, and ``build_from_directory``
rebuilds the index from them.

Every search routes through the compute guard (:meth:`Engine._run_compute`):
device faults are classified, advance the :class:`ComputeHealth` machine
and run the OOM batch-backoff ladder. Only faults the device nemesis
injected (:class:`DeviceFault`) degrade to the bit-exact host mirror
(:class:`HostFallbackScorer`, when ``compute_fallback`` is on); a real
CUDA error or OOM re-raises, so a kernel that fails is never hidden
behind the host. Poison is never absorbed. The dense plane is never
host-served: its faults advance health, ladder down on OOM and re-raise;
nor is a segmented snapshot (no bit-exact host mirror of its
current-stats weights): its device faults re-raise as in the JAX engine.

``engine_mode="mesh"`` serves from a ``docs x terms`` mesh of ranks
(:mod:`tfidf_tpu_torch.parallel`): the blocked-ELL base with a COO delta
(:class:`MeshEllIndex`, the kernel on every rank's blocks), or the COO
layout (:class:`MeshIndex`) for cosine, Lucene-parity statistics,
unbounded results and a ``terms`` axis wider than 8. As in the JAX
package, a mesh engine has no dense plane, no host fallback and no
listing (``document_names`` and ``search_batch_arrays`` return None).
"""

from __future__ import annotations

import itertools
import os
import threading
import traceback

from tfidf_tpu_torch.engine.compute_health import (ComputeHealth,
                                                   FallbackUnsupported,
                                                   HostFallbackScorer)
from tfidf_tpu_torch.engine.dense import EmbeddingColumn
from tfidf_tpu_torch.engine.embedder import get_embedder
from tfidf_tpu_torch.engine.index import ShardIndex
from tfidf_tpu_torch.engine.searcher import Searcher, SearchHit
from tfidf_tpu_torch.engine.segments import SegmentedIndex
from tfidf_tpu_torch.engine.vocab import NativeVocabulary, Vocabulary
from tfidf_tpu_torch.models.base import get_model
from tfidf_tpu_torch.ops.analyzer import (Analyzer, UnsupportedMediaType,
                                          extract_text)
from tfidf_tpu_torch.utils import storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import DeviceFault
from tfidf_tpu_torch.utils.logging import Stopwatch, get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import trace_phase

log = get_logger("engine")

# staged-upload temp-name uniquifier (see Engine.stage_bytes)
_STAGE_SEQ = itertools.count()


def _release_frames(e: BaseException) -> None:
    """Free the device tensors a failed attempt's frames still hold (its
    scores) before the OOM ladder retries. The traceback is a reference
    cycle — its pipeline frame holds the future that holds the exception
    — so without this they would live until the cyclic collector runs."""
    traceback.clear_frames(e.__traceback__)


class Engine:
    def __init__(self, config: Config | None = None, device=None,
                 mesh=None) -> None:
        """``device``: None runs on CUDA and raises when CUDA is absent;
        ``"cpu"`` runs every kernel's plain PyTorch version.

        ``mesh`` (``engine_mode="mesh"`` only): a built
        :class:`~tfidf_tpu_torch.parallel.mesh.Mesh` to serve on; without
        one the engine builds ``Config.mesh_shape`` over every visible
        CUDA device (``device`` None or ``cuda``), or over ``device``
        named once per rank."""
        self.config = config or Config()
        c = self.config
        # single-writer mutation guard; RLock because ingest_bytes ->
        # ingest_text nests
        self._write_lock = threading.RLock()
        self.dense = None    # set below when embedding_enabled
        self.tier = None     # set below for tiered segments mode only
        self.compute = ComputeHealth(
            degraded_after=c.compute_degraded_after,
            sick_after=c.compute_sick_after,
            probe_interval_s=c.compute_probe_interval_s)
        self._fallback: HostFallbackScorer | None = None
        self._fallback_tls = threading.local()
        # whether the last fault noted was injected: only then may a sick
        # device be skipped for the fallback
        self._fault_injected = False
        self.analyzer = Analyzer(
            lowercase=c.lowercase,
            stopwords=frozenset(c.stopwords),
            max_token_length=c.max_token_length)
        self.model = get_model(c.model, k1=c.bm25_k1, b=c.bm25_b,
                               lucene_parity=c.lucene_parity)
        # native C++ ingest fast path (tokenize+count+id-map in one call);
        # non-ASCII documents and environments without a compiler take
        # the pure-Python chain with identical results
        self.native = None
        if c.native_ingest:
            from tfidf_tpu_torch import native as native_mod
            if native_mod.available():
                self.native = native_mod.NativeEngine(
                    lowercase=c.lowercase, stopwords=tuple(c.stopwords),
                    max_token_length=c.max_token_length)
        if self.native is not None:
            self.vocab = NativeVocabulary(
                self.native, min_capacity=c.min_vocab_capacity)
        else:
            self.vocab = Vocabulary(min_capacity=c.min_vocab_capacity)
        if c.engine_mode == "mesh":
            self._init_mesh(mesh, device)
            return
        if c.index_mode == "segments":
            # tiered postings: a hot set on the device + an mmap-backed
            # cold tier with block-max skipping. Loud on a cosine model —
            # no sound per-segment upper bound exists there
            if c.tier_enabled:
                from tfidf_tpu_torch.engine.tiering import TierManager
                cold = c.tier_cold_dir or os.path.join(
                    c.index_path, "cold")
                self.tier = TierManager(
                    cold, int(c.tier_hot_budget_mb) << 20,
                    ring_depth=c.tier_ring_depth,
                    skip_margin=c.tier_skip_margin)
            self.index = SegmentedIndex(
                self.model,
                min_doc_cap=c.min_doc_capacity,
                ell_width_cap=c.ell_width_cap,
                max_segments=c.max_segments,
                sync_merge_nnz=c.sync_merge_nnz,
                merge_upload_pace=c.merge_upload_pace,
                merge_workers=c.merge_workers,
                incremental_stats=c.df_incremental,
                tier=self.tier,
                device=device)
        else:
            self.index = ShardIndex(
                self.model,
                min_nnz_cap=c.min_nnz_capacity,
                min_doc_cap=c.min_doc_capacity,
                layout=c.scoring_layout,
                ell_width_cap=c.ell_width_cap,
                device=device)
        self.device = self.index.device
        self.searcher = Searcher(
            self.index, self.analyzer, self.vocab, self.model,
            query_batch=c.query_batch, max_query_terms=c.max_query_terms,
            top_k=c.top_k, result_order=c.result_order,
            use_pallas=c.use_pallas,
            kernel_a_build=c.kernel_a_build,
            pipeline_depth=c.search_pipeline_depth,
            pipeline_mode=c.search_pipeline_mode)
        if c.compute_fallback:
            self._fallback = HostFallbackScorer(self.searcher)
        # the dense plane: a per-doc embedding column beside the sparse
        # postings, mutated by the same ingest/delete calls under the same
        # write lock and committed by the same commit()
        if c.embedding_enabled:
            self.dense = EmbeddingColumn(
                get_embedder(c.embedding_model, c.embedding_dim),
                min_doc_capacity=c.min_doc_capacity,
                chunk=c.embedding_chunk, device=self.device)

    def _init_mesh(self, mesh, device) -> None:
        """The mesh branch of the JAX engine, unchanged: the ELL base
        unless the model needs norms, parity statistics or unbounded
        results are asked for, or ``terms`` is wider than 8 (the
        narrowest bucket); the COO layout otherwise. No dense column."""
        from tfidf_tpu_torch.parallel.mesh import engine_mesh
        from tfidf_tpu_torch.parallel.mesh_index import (MeshIndex,
                                                         MeshSearcher)
        c = self.config
        if mesh is None:
            mesh = engine_mesh(c.mesh_shape, device)
        d_x_t = mesh.D * mesh.T
        min_chunk = max(1 << 10, c.min_nnz_capacity // max(1, d_x_t))
        want_ell = (c.mesh_layout == "ell"
                    and not self.model.needs_norms
                    and not c.lucene_parity
                    and not c.unbounded_results
                    and mesh.T <= 8)
        kw = dict(query_batch=c.query_batch,
                  max_query_terms=c.max_query_terms, top_k=c.top_k,
                  result_order=c.result_order,
                  pipeline_depth=c.search_pipeline_depth,
                  pipeline_mode=c.search_pipeline_mode)
        if want_ell:
            from tfidf_tpu_torch.parallel.mesh_ell_index import (
                MeshEllIndex, MeshEllSearcher)
            self.index = MeshEllIndex(
                self.model, mesh=mesh, min_doc_cap=c.min_doc_capacity,
                min_chunk_cap=min_chunk, ell_width_cap=c.ell_width_cap,
                incremental_stats=c.df_incremental)
            self.searcher = MeshEllSearcher(
                self.index, self.analyzer, self.vocab, self.model,
                kernel_a_build=c.kernel_a_build, **kw)
        else:
            self.index = MeshIndex(self.model, mesh=mesh,
                                   min_doc_cap=c.min_doc_capacity,
                                   min_chunk_cap=min_chunk)
            # parity mode scores each row against its own statistics, as
            # every Java worker does (Worker.java:222-241)
            self.searcher = MeshSearcher(
                self.index, self.analyzer, self.vocab, self.model,
                global_idf=not c.lucene_parity, **kw)
        self.device = mesh.home

    # ---- ingest ----

    def ingest_text(self, name: str, text: str) -> None:
        with self._write_lock, trace_phase("analyze"):
            if self.native is not None and self.dense is None:
                res = self.native.analyze(text, add=True)
                if res is not None:
                    # the native tokenizer takes ASCII documents; others
                    # fall through to the (identical) Python analyzer
                    global_metrics.inc("ingest_native_fast_path")
                    ids, tfs, length = res
                    self.index.add_document_arrays(name, ids, tfs, length)
                    return
            # the embedder hashes token STRINGS (vocab ids are per-worker
            # insertion order and would break replica-identical dense
            # scores), so with the dense plane on every document takes
            # this path and its counts feed both planes
            global_metrics.inc("ingest_python_fallback")
            counts = self.analyzer.counts(text)
            length = float(sum(counts.values()))
            id_counts = self.vocab.map_counts(counts, add=True)
            self.index.add_document(name, id_counts, length=length)
            if self.dense is not None:
                self.dense.upsert(name, counts)

    def ingest_bytes(self, name: str, data: bytes,
                     save_to_disk: bool = False) -> None:
        """Full upload path: optional durable write of the raw document,
        then extract + index.

        fsync-before-ack (``config.storage_fsync``): the raw bytes are
        fsynced — group-committed across concurrent upload threads
        (``storage.global_committer``) — BEFORE the rename that publishes
        them, and the parent directory is fsynced before this returns.
        The write lock spans the publish rename AND the indexing, so
        concurrent same-name uploads leave disk and index agreeing on one
        writer's content; the temp write and its fsync run outside it
        (each writer owns a unique temp name)."""
        # extract before any disk work: an UnsupportedMediaType must
        # refuse without leaving bytes on disk
        text = extract_text(data)
        if not save_to_disk:
            self.ingest_text(name, text)
            return
        path = self._safe_doc_path(name)
        d = os.path.dirname(path)
        os.makedirs(d, exist_ok=True)
        # unique temp per writer: concurrent uploads of the SAME name
        # sharing one ".part" path would race on the rename
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.part"
        durable = self.config.storage_fsync
        try:
            storage.write_bytes(tmp, data)
            if durable:
                storage.global_committer.sync([tmp])
            with self._write_lock:
                storage.replace(tmp, path)
                self.ingest_text(name, text)
        finally:
            if os.path.exists(tmp):
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        if durable:
            storage.global_committer.sync([d])

    def stage_bytes(self, name: str, data: bytes) -> tuple[str, str, str]:
        """First half of the batched durable upload: extract + write the
        raw bytes to a unique temp, NO fsync, NO indexing yet. Returns
        ``(tmp, final_path, text)`` for :meth:`publish_staged`. The batch
        handler stages every document, group-fsyncs ALL the temps in one
        committer round, then publishes — two fsync rounds per batch."""
        text = extract_text(data)
        path = self._safe_doc_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # globally unique temp: a batch may hold the same name twice
        tmp = f"{path}.{os.getpid()}.{next(_STAGE_SEQ)}.part"
        storage.write_bytes(tmp, data)
        return tmp, path, text

    def publish_staged(self, name: str, tmp: str, path: str,
                       text: str) -> None:
        """Second half: publish rename + index under the write lock. The
        caller has already fsynced ``tmp``: renaming an unflushed temp
        over previously acknowledged bytes could tear them."""
        with self._write_lock:
            storage.replace(tmp, path)
            self.ingest_text(name, text)

    def discard_staged(self, tmp: str) -> None:
        try:
            if os.path.exists(tmp):
                os.unlink(tmp)
        except OSError:
            pass

    def delete(self, name: str) -> bool:
        with self._write_lock:
            ok = self.index.delete_document(name)
            if self.dense is not None:
                self.dense.delete(name)
            return ok

    def document_names(self) -> list[str] | None:
        """Names of all live indexed documents, or None when the index
        layout cannot list them (mesh layouts)."""
        fn = getattr(self.index, "live_names", None)
        return fn() if fn is not None else None

    def remove_document(self, rel: str) -> bool:
        """Delete a document from BOTH the index and the durable docs
        dir, so a restart's re-walk does not resurrect it."""
        with self._write_lock:
            ok = self.index.delete_document(rel)
            if self.dense is not None:
                self.dense.delete(rel)
            try:
                path = self._safe_doc_path(rel)
                if os.path.isfile(path):
                    os.unlink(path)
            except PermissionError:
                pass   # traversal-unsafe name cannot exist on disk
            return ok

    def commit(self) -> None:
        with self._write_lock, trace_phase("commit"), Stopwatch() as sw:
            self.index.commit(self.vocab.capacity())
            if self.dense is not None:
                self.dense.commit()
                if self.tier is not None:
                    # the dense column is a carve-out of the same device
                    # memory the hot sparse set competes for
                    self.tier.set_reserved(
                        int(self.dense.stats()["device_bytes"]))
            self.prime_fallback()
        log.info("commit", ms=sw.ms, docs=self.index.num_live_docs)

    def prime_fallback(self) -> None:
        """Fetch the host mirror of the committed snapshot now
        (``compute_fallback`` only), so a fallback never touches the
        device."""
        if self._fallback is not None:
            self._fallback.prime()

    def build_from_directory(self, docs_path: str | None = None,
                             newer_than: float | None = None) -> int:
        """Recovery-by-rebuild: walk the documents dir, upsert every
        regular file keyed by its relative path, then commit. Idempotent.
        ``newer_than`` (unix mtime) skips older files."""
        root = docs_path or self.config.documents_path
        n = 0
        if os.path.isdir(root):
            for dirpath, _dirnames, filenames in sorted(os.walk(root)):
                for fn in sorted(filenames):
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, root)
                    if newer_than is not None:
                        try:
                            if os.path.getmtime(full) < newer_than:
                                continue
                        except OSError:
                            continue
                    try:
                        with open(full, "rb") as f:
                            self.ingest_text(rel, extract_text(f.read()))
                        n += 1
                    except UnsupportedMediaType as e:
                        log.warning("skipping unsupported file",
                                    path=full, err=str(e))
                    except OSError as e:
                        log.warning("skipping unreadable file",
                                    path=full, err=str(e))
        self.commit()
        log.info("rebuilt index from documents dir", root=root, docs=n)
        return n

    # ---- search: every entry point runs through the compute guard ----

    def _serve_fallback(self, queries, fallback_fn):
        """Run the host mirror; returns ``(served, result)`` — ``served``
        False means the mirror does not support the active snapshot."""
        try:
            out = fallback_fn(queries)
        except FallbackUnsupported:
            return False, None
        global_metrics.inc("compute_fallback_served", max(1, len(queries)))
        self._fallback_tls.flag = True
        return True, out

    def pop_fallback_served(self) -> bool:
        """True iff a fallback answer was served on THIS thread since the
        last pop — the worker handler's X-Compute-Degraded stamp."""
        served = getattr(self._fallback_tls, "flag", False)
        self._fallback_tls.flag = False
        return served

    def _note_fault(self, e: BaseException, kind: str) -> None:
        self.compute.note_fault(kind)
        self._fault_injected = isinstance(e, DeviceFault)

    def _oom_ladder(self, queries, device_fn):
        """Alloc-OOM batch backoff: retry the WHOLE query list in
        sub-batches of B/2, B/4, ... down to ``oom_backoff_min_batch``.
        Returns the partial results, or None when the floor is reached
        with OOM still firing. Non-OOM faults mid-ladder re-raise."""
        from tfidf_tpu_torch.cluster.resilience import classify_compute_fault
        bsz = len(queries) // 2
        floor = max(1, int(self.config.oom_backoff_min_batch))
        while bsz >= floor:
            global_metrics.inc("compute_oom_backoff")
            log.warning("device OOM: retrying at smaller batch",
                        batch=bsz, queries=len(queries))
            try:
                return [device_fn(queries[lo:lo + bsz])
                        for lo in range(0, len(queries), bsz)]
            except Exception as e:
                kind = classify_compute_fault(e)
                if kind != "oom":
                    raise
                _release_frames(e)
                self._note_fault(e, kind)
                bsz //= 2
        return None

    def _run_compute(self, queries, device_fn, fallback_fn, merge):
        """The compute-plane guard every search path shares.

        ``device_fn(qs)`` scores a query sub-list on the device;
        ``fallback_fn(qs)`` is the host mirror; ``merge`` joins partial
        results from the OOM ladder. Device faults classify, advance
        health and ladder down on OOM. An injected fault
        (:class:`DeviceFault`) then degrades to the fallback, and while
        injected faults keep the device sick it is skipped for the
        fallback (one probe per interval still tries it); any other fault
        re-raises, carrying its class as ``compute_fault``, the attribute
        every classifier reads first."""
        from tfidf_tpu_torch.cluster.resilience import classify_compute_fault
        fb = fallback_fn if self._fallback is not None else None
        if queries and fb is not None and self._fault_injected \
                and not self.compute.should_try_device():
            served, out = self._serve_fallback(queries, fb)
            if served:
                return out
        try:
            out = merge([device_fn(queries)])
            if queries:
                self.compute.note_success()
            return out
        except Exception as e:
            kind = classify_compute_fault(e)
            if kind is None:
                raise
            if getattr(e, "compute_fault", None) is None:
                e.compute_fault = kind
            if kind == "poison":
                # a query/data problem, not a sick device: never absorbed,
                # never advances health
                global_metrics.inc("compute_poison_outputs")
                raise
            self._note_fault(e, kind)
            if kind == "oom" and len(queries) > 1:
                _release_frames(e)
                parts = self._oom_ladder(queries, device_fn)
                if parts is not None:
                    self.compute.note_success()
                    return merge(parts)
            if fb is not None and isinstance(e, DeviceFault):
                served, out = self._serve_fallback(queries, fb)
                if served:
                    return out
            raise

    def compute_stats(self) -> dict:
        """ComputeHealth summary for /api/health and `status`."""
        d = self.compute.snapshot()
        d["fallback_available"] = self._fallback is not None
        return d

    def search(self, query: str, k: int | None = None,
               unbounded: bool = False) -> list[SearchHit]:
        return self.search_batch([query], k=k, unbounded=unbounded)[0]

    def search_batch(self, queries: list[str], k: int | None = None,
                     unbounded: bool = False) -> list[list[SearchHit]]:
        return self._run_compute(
            queries,
            lambda qs: self.searcher.search(qs, k=k, unbounded=unbounded),
            lambda qs: self._fallback.search(qs, k=k, unbounded=unbounded),
            merge=lambda parts: [hits for p in parts for hits in p])

    @staticmethod
    def _merge_arrays(parts):
        """Join OOM-ladder partials from the arrays path: vals/ids
        concatenate on the query axis; kk and names are batch-invariant
        (same snapshot, same k)."""
        if len(parts) == 1:
            return parts[0]
        import numpy as np
        vals = np.concatenate([p[0] for p in parts], axis=0)
        ids = np.concatenate([p[1] for p in parts], axis=0)
        return vals, ids, parts[0][2], parts[0][3]

    def search_batch_arrays(self, queries: list[str],
                            k: int | None = None):
        """Exact top-k as raw result arrays ``(vals, ids, kk, names)``
        (see ``Searcher.search_arrays``), through the compute guard; None
        when the searcher has no arrays path (mesh layouts) and the
        caller must assemble hits through :meth:`search_batch`."""
        arrays = getattr(self.searcher, "search_arrays", None)
        if arrays is None:
            return None
        return self._run_compute(
            queries,
            lambda qs: arrays(qs, k=k),
            lambda qs: self._fallback.search_arrays(qs, k=k),
            merge=self._merge_arrays)

    # ---- the dense plane ----

    def _dense_plane(self):
        if self.dense is None:
            raise RuntimeError(
                "dense plane disabled (embedding_enabled=False)")
        return self.dense

    def search_dense_batch(self, queries: list[str],
                           k: int | None = None) -> list[list[tuple]]:
        """Exact dense top-k per query as ``[(name, score), ...]``
        (cosine, sorted by (-score, name)). Loud when the dense plane is
        off — a silent sparse fallback would fake hybrid results.
        Health-guarded but never host-served (no fallback): a fault
        classifies, advances health, ladders down on OOM, and re-raises
        to the router's failover."""
        dense = self._dense_plane()
        kk = int(k) if k is not None else self.config.top_k

        return self._run_compute(
            queries,
            lambda qs: dense.search_batch(
                [self.analyzer.counts(q) for q in qs], kk),
            None, merge=lambda parts: [r for p in parts for r in p])

    def search_dense_names(self, queries: list[str],
                           names: list[str]) -> list[dict]:
        """Failover-slice dense scores: name->score per query for the
        names this engine holds (absent names are simply missing)."""
        dense = self._dense_plane()
        return self._run_compute(
            queries,
            lambda qs: dense.search_names(
                [self.analyzer.counts(q) for q in qs], names),
            None, merge=lambda parts: [r for p in parts for r in p])

    def dense_stats(self) -> dict | None:
        """Embedding-column summary for /api/health and `status` — None
        when the dense plane is off."""
        return self.dense.stats() if self.dense is not None else None

    def tier_stats(self) -> dict:
        """Tier residency/skip summary for /api/health and `status` —
        ``{"enabled": False}`` when tiering is off."""
        if self.tier is None:
            return {"enabled": False}
        return self.tier.stats()

    # ---- files ----

    def _safe_doc_path(self, rel: str) -> str:
        """Resolve under documents_path with the reference's traversal
        check (normalize + startsWith(base))."""
        base = os.path.abspath(self.config.documents_path)
        target = os.path.abspath(os.path.join(base, rel))
        if not (target == base or target.startswith(base + os.sep)):
            raise PermissionError(f"path escapes documents dir: {rel!r}")
        return target

    def open_document(self, rel: str) -> bytes | None:
        path = self._safe_doc_path(rel)
        if not os.path.isfile(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def open_document_stream(self, rel: str):
        """(file object, size) for chunked transfer, or None."""
        path = self._safe_doc_path(rel)
        if not os.path.isfile(path):
            return None
        return open(path, "rb"), os.path.getsize(path)

    # ---- load metric ----

    def index_size_bytes(self) -> int:
        return self.index.size_bytes()
