"""The port's dense plane held against the JAX package on the CPU.

The same inputs (token bags and corpora made from a seed with numpy) go
through ``tfidf_tpu``'s embedder, column and engine and through their
counterparts in ``tfidf_tpu_torch``. Tolerances, with their reasons:

* embeddings: bitwise. Both packages run the same numpy code on the host
  (blake2b slots, f32 accumulation, ``np.dot`` norm, in-place f32 divide);
* dense top-k across the packages: names identical, scores within rel
  1e-6 of the JAX package's and of a numpy f64 brute-force oracle. The
  products differ: XLA pads ``dim`` to 128 and the port to a multiple of
  8, and each library blocks its f32 sums its own way. Measured on these
  inputs: at most 1 ulp apart;
* chunked against one-shot within the port: bitwise. ``dense_scores`` is
  built from the served path's own per-chunk products, and on the CPU
  torch's f32 matmul gives the same bits whatever the doc-axis length, so
  columns with ``chunk=32`` and ``chunk=1<<14`` serve the same packed
  bits too. (The JAX package's own test of this fails on this tree: XLA's
  CPU matmul bits change with the doc-axis shape.)
* ``search_dense_names`` across the packages: equal floats; both take the
  same host numpy dots over the same vectors.
"""

import numpy as np
import pytest
import torch

from tests.test_hybrid import _numpy_oracle as _oracle
from tests.test_torch_engine import SMALL, _zipf_queries, _zipf_texts
from tfidf_tpu.engine.dense import EmbeddingColumn as JaxColumn
from tfidf_tpu.engine.embedder import HashEmbedder as JaxHashEmbedder
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.ops.analyzer import Analyzer as JaxAnalyzer
from tfidf_tpu.utils import device_nemesis as jax_nemesis
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu.utils.textgen import RealisticCorpus, harvest_lexicon
from tfidf_tpu_torch.engine.dense import EmbeddingColumn
from tfidf_tpu_torch.engine.embedder import (HashEmbedder, get_embedder,
                                             register_embedder)
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.ops.dense import (chunk_rows, dense_scores,
                                       packed_dense_topk)
from tfidf_tpu_torch.ops.topk import exact_topk, pack_topk
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import (DeviceTransientError,
                                                  global_device_nemesis)
from tfidf_tpu_torch.utils.metrics import global_metrics

DENSE = dict(SMALL, embedding_enabled=True)


@pytest.fixture(autouse=True)
def _clean_nemeses():
    global_device_nemesis.clear()
    jax_nemesis.global_device_nemesis.clear()
    yield
    global_device_nemesis.clear()
    jax_nemesis.global_device_nemesis.clear()


def _ulps(a, b) -> int:
    """Largest distance in f32 ulps between two equal-shape arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max(initial=0))


# ---------------------------------------------------------------------------
# the embedder: bitwise equal to the JAX package's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lexicon():
    return harvest_lexicon(max_words=3000)[0]


@pytest.mark.parametrize("dim", [1, 7, 64, 130, 257])
def test_embedder_bitwise_equal_on_realistic_text(lexicon, dim):
    rng = np.random.default_rng(dim)
    gen = RealisticCorpus(rng, lexicon)
    analyzer = JaxAnalyzer()
    mine, ref = HashEmbedder(dim), JaxHashEmbedder(dim)
    for _ in range(60):
        counts = analyzer.counts(gen.make_text(80))
        a, b = mine.embed_counts(counts), ref.embed_counts(counts)
        assert a.dtype == b.dtype == np.float32 and a.shape == (dim,)
        assert a.tobytes() == b.tobytes()
        assert mine.embed_query(counts).tobytes() == a.tobytes()
    assert mine.signature() == ref.signature() == {"model": "hash",
                                                   "dim": dim}


@pytest.mark.parametrize("counts", [
    {},                                          # empty bag: zero vector
    {"solo": 1.0},
    {"solo": 1e6},                               # one large weight
    {"café": 2.0, "naïve": 1.0, "日本": 3.0},     # non-ASCII tokens
    {f"t{i}": float(i % 5 + 1) for i in range(500)},   # many collisions
    {"a": 0.5, "b": 0.25, "c": 1e-8, "d": 3.0},  # fractional weights
])
@pytest.mark.parametrize("dim", [3, 64, 100])
def test_embedder_edge_bags_bitwise(counts, dim):
    a = HashEmbedder(dim).embed_counts(counts)
    b = JaxHashEmbedder(dim).embed_counts(counts)
    assert a.tobytes() == b.tobytes()
    if not counts:
        assert not a.any()
    else:
        assert abs(float(np.dot(a.astype(np.float64), a)) - 1.0) < 1e-5


def test_embedder_registry():
    assert isinstance(get_embedder("hash", 16), HashEmbedder)
    with pytest.raises(ValueError, match="unknown embedding model"):
        get_embedder("nope", 16)
    with pytest.raises(ValueError, match="dim must be >= 1"):
        HashEmbedder(0)

    class Stub(HashEmbedder):
        name = "stub"
    register_embedder("stub", lambda d: Stub(d + 1))
    with pytest.raises(ValueError, match="built dim 9, requested 8"):
        get_embedder("stub", 8)


# ---------------------------------------------------------------------------
# the column against the JAX column and an f64 oracle, every shape edge
# ---------------------------------------------------------------------------

def _bag(i):
    return {f"tok{i}": 1.0, f"shared{i % 4}": 2.0, "common": 0.5}


def _columns(num_docs, dim, chunk=1 << 14, min_cap=8, bag=_bag):
    mine = EmbeddingColumn(HashEmbedder(dim), min_doc_capacity=min_cap,
                           chunk=chunk, device="cpu")
    ref = JaxColumn(JaxHashEmbedder(dim), min_doc_capacity=min_cap,
                    chunk=chunk)
    for col in (mine, ref):
        for i in range(num_docs):
            col.upsert(f"d{i:04d}", bag(i))
        col.commit()
    return mine, ref


QUERY_BAGS = [{"common": 1.0, "tok3": 2.0}, {"shared1": 1.0},
              {"neg7": 1.0, "tok5": 1.0}, {}, {"zzz": 3.0, "common": 1.0}]


@pytest.mark.parametrize("num_docs,dim,k,chunk", [
    (1, 41, 5, 1 << 14),      # one live doc, dim not a multiple of 8
    (7, 64, 3, 1 << 14),      # k < docs
    (12, 96, 32, 1 << 14),    # k above the live docs
    (200, 130, 10, 64),       # chunked scan, clamped tail
    (300, 128, 7, 4),         # chunk < k: clamped to k rows
    (0, 64, 5, 1 << 14),      # zero live docs
])
def test_column_matches_jax_column_and_oracle(num_docs, dim, k, chunk):
    mine, ref = _columns(num_docs, dim, chunk=chunk)
    got = mine.search_batch(QUERY_BAGS, k)
    want = ref.search_batch(QUERY_BAGS, k)
    assert len(got) == len(QUERY_BAGS)
    worst = 0
    for qi, counts in enumerate(QUERY_BAGS):
        oracle = _oracle(mine, counts, k)
        assert [n for n, _ in got[qi]] == [n for n, _ in want[qi]] \
            == [n for n, _ in oracle], (qi, got[qi], want[qi])
        g = np.array([s for _, s in got[qi]], np.float32)
        w = np.array([s for _, s in want[qi]], np.float32)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g, [s for _, s in oracle], rtol=1e-6,
                                   atol=1e-7)
        worst = max(worst, _ulps(g, w))
    assert worst <= 1
    if num_docs == 0:
        assert got == [[] for _ in QUERY_BAGS]


def test_negative_cosines_rank_below_zero_and_above_padding():
    mine, ref = _columns(30, 32)
    rows = np.stack([mine._vecs[n] for n in sorted(mine._vecs)])
    token = next(t for t in (f"neg{i}" for i in range(500))
                 if (rows @ mine.embedder.embed_counts({t: 1.0})).min()
                 < -1e-3)
    got = mine.search_batch([{token: 1.0}], 40)[0]
    want = ref.search_batch([{token: 1.0}], 40)[0]
    assert len(got) == 30                       # padding never listed
    assert any(s < 0 for _, s in got)
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=1e-6, atol=1e-7)


def test_delete_then_commit_drops_doc():
    mine, ref = _columns(10, 64)
    for col in (mine, ref):
        assert col.delete("d0003") and not col.delete("d0003")
        col.commit()
    got = mine.search_batch([{"common": 1.0}], 10)[0]
    assert [n for n, _ in got] == [n for n, _ in
                                   ref.search_batch([{"common": 1.0}],
                                                    10)[0]]
    assert "d0003" not in dict(got) and len(got) == 9
    assert mine.stats()["docs"] == ref.stats()["docs"] == 9


def test_ties_break_toward_the_lower_name():
    """Duplicated vectors tie exactly; the lower row (sorted name) wins,
    across chunk boundaries and the clamped tail as well."""
    def bag(i):
        return {"alpha": 1.0, f"grp{i % 3}": 2.0}
    for chunk in (1 << 14, 8, 5):
        mine, ref = _columns(40, 24, chunk=chunk, bag=bag)
        q = [{"grp1": 1.0}, {"alpha": 1.0}]
        got = mine.search_batch(q, 12)
        want = ref.search_batch(q, 12)
        for qi in range(2):
            assert [n for n, _ in got[qi]] == [n for n, _ in want[qi]]
            assert got[qi] == sorted(got[qi], key=lambda h: (-h[1], h[0]))
        # query 0: every doc of group 1 ties at the top, in name order
        top = [n for n, s in got[0] if s == got[0][0][1]]
        assert top == sorted(f"d{i:04d}" for i in range(40)
                             if i % 3 == 1)[:12]


# ---------------------------------------------------------------------------
# the bit contract: chunked == one-shot, within a column and across chunks
# ---------------------------------------------------------------------------

def _emb_batch(col, bags):
    return (torch.from_numpy(col._embed_queries(bags)), col._emb_dev,
            len(col._names))


@pytest.mark.parametrize("chunk", [4, 32, 100, 256, 1 << 14])
def test_chunked_equals_oneshot_bitwise(chunk):
    mine, _ = _columns(257, 64, chunk=chunk, min_cap=8)
    bags = [{"common": 1.0, "tok17": 3.0}] + QUERY_BAGS
    q, emb, n = _emb_batch(mine, bags)
    k = 11
    # within one column: the served top-k == the top-k of the full
    # score matrix built from the same chunk products
    packed = packed_dense_topk(q, emb, n, k=k, chunk=chunk)
    full = dense_scores(q, emb, n, chunk=chunk_rows(emb.shape[0], chunk, k))
    assert torch.equal(packed, pack_topk(*exact_topk(full, n, k=k)))
    # across chunk sizes (CPU): the same score bits and packed output
    one = dense_scores(q, emb, n, chunk=1 << 20)
    assert torch.equal(full.view(torch.int32), one.view(torch.int32))
    assert torch.equal(packed, packed_dense_topk(q, emb, n, k=k,
                                                 chunk=1 << 20))
    assert torch.equal(one[:, :n], torch.matmul(q, emb[:n].T))
    assert bool((one[:, n:] == float("-inf")).all())


def test_columns_with_chunk_32_and_16384_serve_the_same_bits():
    """The invariant the JAX package's own chunked-equals-one-shot test
    asks for, through the whole column."""
    small, _ = _columns(257, 64, chunk=32)
    large, _ = _columns(257, 64, chunk=1 << 14)
    q = [{"common": 1.0, "tok17": 3.0}] + QUERY_BAGS
    a, b = small.search_batch(q, 11), large.search_batch(q, 11)
    assert a == b
    for x, y in zip(a, b):
        assert np.array([s for _, s in x], np.float32).tobytes() \
            == np.array([s for _, s in y], np.float32).tobytes()


def test_matmul_runs_full_f32():
    """TF32 is off for the dense product (the JAX package multiplies at
    Precision.HIGHEST)."""
    EmbeddingColumn(HashEmbedder(8), device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


# ---------------------------------------------------------------------------
# the carry-across: a JAX column's export serves from the port
# ---------------------------------------------------------------------------

def test_install_arrays_from_jax_export_serves_the_same_topk():
    _, ref = _columns(150, 64, chunk=32)
    for n in ("d0007", "d0100"):
        ref.delete(n)
    ref.commit()
    rows, names = ref.export_arrays()
    mine = EmbeddingColumn(HashEmbedder(64), min_doc_capacity=8, chunk=32,
                           device="cpu")
    mine.install_arrays(rows, names)
    mine.commit()
    assert mine.export_arrays()[0].tobytes() == rows.tobytes()
    assert mine.export_arrays()[1] == names
    got = mine.search_batch(QUERY_BAGS, 9)
    want = ref.search_batch(QUERY_BAGS, 9)
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=1e-6, atol=1e-7)
    # and the same bits as the port's own column of the same documents
    own, _ = _columns(150, 64, chunk=32)
    for n in ("d0007", "d0100"):
        own.delete(n)
    assert own.search_batch(QUERY_BAGS, 9) == got
    with pytest.raises(ValueError, match="does not match"):
        mine.install_arrays(rows[:, :10], names)


# ---------------------------------------------------------------------------
# the engine: the default Config's dense plane
# ---------------------------------------------------------------------------

def _engine_pair(docs, **kw):
    cfg = dict(DENSE, **kw)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    te = Engine(Config(**cfg), device="cpu")
    for e in (je, te):
        for name, text in docs.items():
            e.ingest_text(name, text)
        e.commit()
    return je, te


def test_engine_dense_topk_matches_jax_engine():
    docs = _zipf_texts(41, n_docs=260)
    queries = _zipf_queries(42, n=24) + ["", "t1 t1 t1"]
    je, te = _engine_pair(docs, embedding_chunk=64)
    got = te.search_dense_batch(queries, k=10)
    want = je.search_dense_batch(queries, k=10)
    assert len(got) == len(queries)
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=1e-6, atol=1e-7)
    assert got[0] and all(len(g) == 10 for g in got)
    names = sorted(docs)[::7] + ["missing.txt"]
    assert te.search_dense_names(queries, names) \
        == je.search_dense_names(queries, names)
    assert te.dense_stats()["docs"] == je.dense_stats()["docs"] == 260
    # the sparse plane keeps answering as before
    assert [[h.name for h in hs] for hs in te.search_batch(queries[:4])] \
        == [[h.name for h in hs] for hs in je.search_batch(queries[:4])]


def test_dense_plane_takes_the_python_analyzer_and_mutations():
    """With the plane on, every document takes the Python analyzer (the
    embedder hashes token strings), and delete / remove_document reach
    the column."""
    python0 = global_metrics.get("ingest_python_fallback")
    native0 = global_metrics.get("ingest_native_fast_path")
    je, te = _engine_pair(_zipf_texts(43, n_docs=40))
    assert global_metrics.get("ingest_native_fast_path") == native0
    assert global_metrics.get("ingest_python_fallback") == python0 + 40
    for e in (je, te):
        assert e.delete("d3") and e.remove_document("d5")
        e.commit()
    got = te.search_dense_batch(["t1 t2", "t3"], k=50)
    for g, w in zip(got, je.search_dense_batch(["t1 t2", "t3"], k=50)):
        assert [n for n, _ in g] == [n for n, _ in w]
        assert "d3" not in dict(g) and "d5" not in dict(g)
    assert te.dense_stats()["docs"] == 38


def test_disabled_plane_is_loud():
    te = Engine(Config(**SMALL), device="cpu")
    assert te.dense is None and te.dense_stats() is None
    for call in (lambda: te.search_dense_batch(["x"]),
                 lambda: te.search_dense_names(["x"], ["a"])):
        with pytest.raises(RuntimeError, match="dense plane disabled"):
            call()


# ---------------------------------------------------------------------------
# the compute guard on the dense seam: never host-served
# ---------------------------------------------------------------------------

def _fault_pair():
    return _engine_pair(_zipf_texts(44, n_docs=120), query_batch=8,
                        compute_sick_after=2,
                        compute_probe_interval_s=3600.0,
                        oom_backoff_min_batch=2)


def test_dense_transient_reraises_advances_health_and_heals():
    je, te = _fault_pair()
    qs = _zipf_queries(45, n=8)
    want = te.search_dense_batch(qs)
    served0 = global_metrics.get("compute_fallback_served")
    global_device_nemesis.script("dense:transient")
    jax_nemesis.global_device_nemesis.script("dense:transient")
    for i in range(2):
        with pytest.raises(DeviceTransientError):
            te.search_dense_batch(qs)
        with pytest.raises(jax_nemesis.DeviceTransientError):
            je.search_dense_batch(qs)
        assert te.compute.state == je.compute.state
    # sick, and still the device is tried: there is no dense fallback
    with pytest.raises(DeviceTransientError):
        te.search_dense_batch(qs[:3])
    st = te.compute_stats()
    assert st["state"] == "sick" and st["total_faults"] == 3
    assert not te.pop_fallback_served()
    assert global_metrics.get("compute_fallback_served") == served0
    global_device_nemesis.clear()
    assert te.search_dense_batch(qs) == want      # the next try heals
    assert te.compute.state == "healthy"


def test_dense_oom_ladder_merges_to_the_unsplit_batch():
    je, te = _fault_pair()
    qs = _zipf_queries(46, n=8)
    want = te.search_dense_batch(qs)
    steps = global_metrics.get("compute_oom_backoff")
    global_device_nemesis.script("dense:oom::count=1")
    assert te.search_dense_batch(qs) == want
    assert global_metrics.get("compute_oom_backoff") == steps + 1
    assert te.compute.state == "healthy" and not te.pop_fallback_served()
    # a persistent OOM reaches the floor and re-raises
    global_device_nemesis.script("dense:oom")
    with pytest.raises(Exception, match="dense"):
        te.search_dense_batch(qs)
    assert te.compute_stats()["faults_by_kind"]["oom"] >= 3


def test_dense_poison_gives_the_jax_packages_answer():
    """A fired ``dense:poison`` rule NaNs the packed values after the
    selection; the column stops each row at its first non-finite value,
    so both packages answer with empty hit lists and health unchanged."""
    je, te = _fault_pair()
    qs = _zipf_queries(47, n=5)
    global_device_nemesis.script("dense:poison")
    jax_nemesis.global_device_nemesis.script("dense:poison")
    got = te.search_dense_batch(qs)
    assert got == je.search_dense_batch(qs) == [[] for _ in qs]
    assert te.compute_stats()["total_faults"] == 0
    # the oracle seam: the whole score matrix is NaN
    q = torch.zeros((8, 64))
    s = dense_scores(q, te.dense._emb_dev, len(te.dense._names))
    assert s.shape == (8, te.dense._doc_cap) and bool(torch.isnan(s).all())
