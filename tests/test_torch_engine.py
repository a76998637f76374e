"""The torch port's engine held against the JAX engine on the CPU.

Both engines ingest the same documents (the ``tests/test_engine.py``
corpus, or a Zipf corpus made from a seed with numpy) and answer the same
queries. Tolerances, with their reasons:

* top-10 ids identical, scores within rel 1e-6 — each package computes
  its own impacts, and log1p / division may differ by an ulp;
* bitwise scores — when the port serves the JAX package's exported
  snapshot arrays, the impacts are the same bits and both sides add in
  the same pinned order. (The JAX side runs its XLA reduce path here:
  its Pallas kernel contracts in another order and is compared with the
  port's kernel in ``tests/test_torch_kernel.py``.)
"""

import os

import numpy as np
import pytest
import torch

from tests.test_engine import CORPUS
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.ops import ell as t_ell
from tfidf_tpu_torch.utils.config import Config

SMALL = dict(min_nnz_capacity=64, min_doc_capacity=8,
             min_vocab_capacity=32, embedding_enabled=False)
QUERIES = ["fast food", "cat", "night cars fast", "cheap cat food",
           "zebra", "the"]


def _pair(**kw):
    cfg = dict(SMALL, **kw)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    te = Engine(Config(**cfg), device="cpu")
    return je, te


def _zipf_texts(seed, n_docs=300, vocab=400, avg_len=30):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.poisson(avg_len, n_docs), 3, None)
    return {f"d{i}": " ".join(f"t{w}" for w in
                              rng.zipf(1.25, size=n) % vocab)
            for i, n in enumerate(lengths)}


def _zipf_queries(seed, n=40, vocab=400):
    rng = np.random.default_rng(seed)
    return [" ".join(f"t{w}" for w in
                     rng.zipf(1.25, size=int(rng.integers(1, 5))) % vocab)
            for _ in range(n)]


def _ingest(engines, docs):
    for e in engines:
        for name, text in docs.items():
            e.ingest_text(name, text)
        e.commit()


def _assert_same_hits(got, want, rtol=1e-6):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [h.name for h in g] == [h.name for h in w]
        np.testing.assert_allclose([h.score for h in g],
                                   [h.score for h in w], rtol=rtol)


@pytest.mark.parametrize("kw", [
    dict(),                                       # ELL (default layout)
    dict(scoring_layout="coo"),
    dict(ell_width_cap=8),                        # residual path
    dict(model="tfidf"),
    dict(model="tfidf_cosine"),
    dict(lucene_parity=True),
    dict(result_order="name"),
], ids=["ell", "coo", "residual", "tfidf", "cosine", "parity", "byname"])
def test_corpus_matches_jax_engine(kw):
    je, te = _pair(**kw)
    _ingest([je, te], CORPUS)
    _assert_same_hits(te.search_batch(QUERIES, k=10),
                      je.search_batch(QUERIES, k=10))
    hits = te.search("fast food", k=5)
    if kw.get("result_order") != "name":
        assert hits[0].name == "file1.txt"
    assert "file2.txt" not in [h.name for h in hits]


@pytest.mark.parametrize("kw", [
    dict(min_doc_capacity=256, query_batch=16),   # blocks in the envelope
    dict(scoring_layout="coo", query_batch=16),
    dict(ell_width_cap=16, min_doc_capacity=256),  # wide docs spill
], ids=["ell", "coo", "residual"])
def test_zipf_corpus_matches_jax_engine(kw):
    je, te = _pair(**kw)
    _ingest([je, te], _zipf_texts(1))
    queries = _zipf_queries(2)
    _assert_same_hits(te.search_batch(queries, k=10),
                      je.search_batch(queries, k=10))
    snap = te.index.snapshot
    if kw.get("ell_width_cap") == 16:
        assert snap.res_tf is not None
    if snap.is_ell and kw.get("min_doc_capacity") == 256:
        assert all(t_ell._pallas_eligible(i.shape[0], 16, 256)
                   for i in snap.ell_impacts)


def test_search_batch_arrays_and_unbounded():
    je, te = _pair(min_doc_capacity=256, query_batch=8)
    _ingest([je, te], _zipf_texts(3, n_docs=120))
    queries = _zipf_queries(4, n=20)
    tv, ti, tk, tn = te.search_batch_arrays(queries, k=10)
    jv, ji, jk, jn = je.search_batch_arrays(queries, k=10)
    assert tk == jk and tv.shape == jv.shape == (20, 10)
    for r in range(20):
        live = np.isfinite(jv[r]) & (jv[r] > 0)
        assert [tn[i] for i in ti[r][live]] == [jn[i] for i in ji[r][live]]
        np.testing.assert_allclose(tv[r][live], jv[r][live], rtol=1e-6)
    _assert_same_hits(te.search_batch(queries[:5], unbounded=True),
                      je.search_batch(queries[:5], unbounded=True))


def test_delete_and_upsert_match_jax_engine():
    je, te = _pair()
    _ingest([je, te], CORPUS)
    for e in (je, te):
        assert e.delete("file1.txt")
        e.ingest_text("file3.txt", "fast food everywhere")
        e.commit()
    _assert_same_hits(te.search_batch(QUERIES), je.search_batch(QUERIES))
    assert sorted(te.document_names()) == sorted(je.document_names())


def test_use_pallas_on_cpu_runs_plain_version_without_launches():
    """On a CPU device the kernel wrapper takes its plain version: the
    results equal the use_pallas=False path and no launch is counted."""
    docs = _zipf_texts(5, n_docs=200)
    queries = _zipf_queries(6, n=16)
    cfg = dict(SMALL, min_doc_capacity=256, query_batch=16)
    on = Engine(Config(**cfg), device="cpu")
    off = Engine(Config(**dict(cfg, use_pallas=False)), device="cpu")
    _ingest([on, off], docs)
    t_ell.reset_launches()
    a = on.search_batch_arrays(queries)
    b = off.search_batch_arrays(queries)
    assert t_ell.launches == {"v3": 0, "v4": 0}
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_engine_without_cuda_raises(monkeypatch):
    """No device named and no CUDA: the port refuses instead of dropping
    to the CPU quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(Config(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(Config(**SMALL), device="cuda")


@pytest.mark.parametrize("kw,what", [
    (dict(engine_mode="mesh"), "engine_mode"),
    (dict(index_mode="segments"), "index_mode"),
    (dict(embedding_enabled=True), "dense plane"),
])
def test_unported_modes_raise(kw, what):
    with pytest.raises(NotImplementedError, match=what):
        Engine(Config(**dict(SMALL, **kw)), device="cpu")
    e = Engine(Config(**SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="durable upload"):
        e.ingest_bytes("a.txt", b"fast food")


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_jax_snapshot_serves_from_port_bitwise(layout):
    """The carry-across: the JAX engine's ``export_snapshot_arrays()``,
    installed in the port beside a copy of its vocabulary, serves the
    same top-10 on the CPU — with bitwise-equal scores in the ELL layout,
    whose impacts are precomputed at commit and travel with the arrays.
    The COO layout computes its weights per query (log1p, division), so
    there the scores agree within rel 1e-6."""
    rtol = 0 if layout == "ell" else 1e-6
    cfg = dict(SMALL, min_doc_capacity=256, query_batch=16,
               scoring_layout=layout)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    _ingest([je], _zipf_texts(7))
    arrays, names, _gen = je.index.export_snapshot_arrays()
    te = Engine(Config(**cfg), device="cpu")
    te.vocab.extend(je.vocab.all_terms())
    te.index.install_snapshot_arrays(arrays, names)
    queries = _zipf_queries(8)
    _assert_same_hits(te.search_batch(queries, k=10),
                      je.search_batch(queries, k=10), rtol=rtol)
    tv, ti, _, _ = te.search_batch_arrays(queries)
    jv, ji, _, _ = je.search_batch_arrays(queries)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=rtol, atol=0)
    # and the port's own export round-trips through its install
    out, names2, _ = te.index.export_snapshot_arrays()
    assert set(out) == set(arrays) and names2 == names
    for key in arrays:
        np.testing.assert_array_equal(out[key], arrays[key])


def test_build_from_directory_matches_jax_engine(tmp_path):
    """Recovery-by-rebuild: both engines walk the same documents dir
    (an unsupported binary is skipped) and serve the same hits."""
    docs = tmp_path / "docs"
    (docs / "sub").mkdir(parents=True)
    for name, text in CORPUS.items():
        (docs / "sub" / name).write_text(text)
    (docs / "blob.bin").write_bytes(b"\x00\x01\x02binary\xff" * 10)
    je, te = _pair(documents_path=str(docs))
    assert te.build_from_directory() == je.build_from_directory() == 5
    _assert_same_hits(te.search_batch(QUERIES), je.search_batch(QUERIES))
    assert te.search("fast food")[0].name == os.path.join("sub",
                                                         "file1.txt")
