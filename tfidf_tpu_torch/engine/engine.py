"""Engine — the per-node facade tying analyzer, vocab, index and searcher,
on a torch device.

The counterpart of ``tfidf_tpu/engine/engine.py`` in local rebuild mode:
ingest text -> tokens -> vocab ids -> shard index; commit; search. Searches
call the searcher directly: there is no compute-health guard and no host
fallback scorer here, so a failing device surfaces as an error instead of
being hidden behind slower host answers.

Not ported yet — each raises ``NotImplementedError`` naming what is
missing: ``engine_mode="mesh"``, ``index_mode="segments"``, the dense
plane (``embedding_enabled=True``, the Config default: pass False), and
the durable upload path (``ingest_bytes`` / ``stage_bytes`` /
``publish_staged``, which need the storage seam).
"""

from __future__ import annotations

import os
import threading

from tfidf_tpu_torch.engine.index import ShardIndex
from tfidf_tpu_torch.engine.searcher import Searcher, SearchHit
from tfidf_tpu_torch.engine.vocab import Vocabulary
from tfidf_tpu_torch.models.base import get_model
from tfidf_tpu_torch.ops.analyzer import (Analyzer, UnsupportedMediaType,
                                          extract_text)
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.logging import Stopwatch, get_logger
from tfidf_tpu_torch.utils.tracing import trace_phase

log = get_logger("engine")


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"tfidf_tpu_torch: {what} is not ported yet (a later slice of the "
        "PyTorch/CUDA port); use the tfidf_tpu package for it")


class Engine:
    def __init__(self, config: Config | None = None, device=None) -> None:
        """``device``: None runs on CUDA and raises when CUDA is absent;
        ``"cpu"`` runs every kernel's plain PyTorch version."""
        self.config = config or Config()
        c = self.config
        if c.engine_mode != "local":
            raise _later(f"engine_mode={c.engine_mode!r}")
        if c.index_mode != "rebuild":
            raise _later(f"index_mode={c.index_mode!r}")
        if c.embedding_enabled:
            raise _later("the dense plane (embedding_enabled=True; pass "
                         "embedding_enabled=False)")
        self._write_lock = threading.RLock()
        self.analyzer = Analyzer(
            lowercase=c.lowercase,
            stopwords=frozenset(c.stopwords),
            max_token_length=c.max_token_length)
        self.model = get_model(c.model, k1=c.bm25_k1, b=c.bm25_b,
                               lucene_parity=c.lucene_parity)
        # the Python analyzer chain; the JAX package's native tokenizer
        # is result-identical to it and is not ported yet
        self.vocab = Vocabulary(min_capacity=c.min_vocab_capacity)
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

    # ---- ingest ----

    def ingest_text(self, name: str, text: str) -> None:
        with self._write_lock, trace_phase("analyze"):
            counts = self.analyzer.counts(text)
            length = float(sum(counts.values()))
            id_counts = self.vocab.map_counts(counts, add=True)
            self.index.add_document(name, id_counts, length=length)

    def ingest_bytes(self, name: str, data: bytes,
                     save_to_disk: bool = False) -> None:
        raise _later("ingest_bytes (the durable upload path)")

    def stage_bytes(self, name: str, data: bytes):
        raise _later("stage_bytes (the durable upload path)")

    def publish_staged(self, name: str, tmp: str, path: str,
                       text: str) -> None:
        raise _later("publish_staged (the durable upload path)")

    def delete(self, name: str) -> bool:
        with self._write_lock:
            return self.index.delete_document(name)

    def document_names(self) -> list[str]:
        return self.index.live_names()

    def commit(self) -> None:
        with self._write_lock, trace_phase("commit"), Stopwatch() as sw:
            self.index.commit(self.vocab.capacity())
        log.info("commit", ms=sw.ms, docs=self.index.num_live_docs)

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

    # ---- search ----

    def search(self, query: str, k: int | None = None,
               unbounded: bool = False) -> list[SearchHit]:
        return self.search_batch([query], k=k, unbounded=unbounded)[0]

    def search_batch(self, queries: list[str], k: int | None = None,
                     unbounded: bool = False) -> list[list[SearchHit]]:
        return self.searcher.search(queries, k=k, unbounded=unbounded)

    def search_batch_arrays(self, queries: list[str],
                            k: int | None = None):
        """Exact top-k as raw result arrays ``(vals, ids, kk, names)``
        (see ``Searcher.search_arrays``)."""
        return self.searcher.search_arrays(queries, k=k)
