"""The torch port's ops held against the JAX package on the CPU.

Inputs are made from a seed with numpy and go through both packages.
Tolerances, each with its reason:

* bitwise — query compilation, top-k packing, the ELL build, and the
  plain ELL block scorer given identical impacts and weights (both add in
  the same pinned lane order, one rounded f32 op at a time);
* rel 1e-6 — anything through log1p / log / division (BM25 and TF-IDF
  weights), where XLA's and PyTorch's CPU math may differ by an ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tfidf_tpu.ops import csr as j_csr
from tfidf_tpu.ops import ell as j_ell
from tfidf_tpu.ops import scoring as j_scoring
from tfidf_tpu.ops import topk as j_topk
from tfidf_tpu_torch.ops import csr as t_csr
from tfidf_tpu_torch.ops import ell as t_ell
from tfidf_tpu_torch.ops import scoring as t_scoring
from tfidf_tpu_torch.ops import topk as t_topk

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def _queries(rng, B, T, vocab, *, with_zero=False):
    """Padded [B, T] query terms/weights, distinct terms per query."""
    q_terms = np.zeros((B, T), np.int32)
    q_weights = np.zeros((B, T), np.float32)
    for i in range(B):
        k = int(rng.integers(1, T + 1))
        ids = rng.choice(vocab, size=k, replace=False)
        if with_zero and i % 2 == 0:
            ids[0] = 0
        q_terms[i, :k] = ids
        q_weights[i, :k] = rng.integers(1, 4, size=k)
    return q_terms, q_weights


def _both_batches(q_terms, q_weights, min_slots=256):
    jq = j_scoring.make_query_batch(q_terms, q_weights, min_slots=min_slots)
    tq = t_scoring.make_query_batch(q_terms, q_weights,
                                    min_slots=min_slots, device=CPU)
    return jq, tq


def _jax_compiled(jq, vocab_cap):
    q = j_scoring.QueryBatch(*(jnp.asarray(x) for x in jq))
    slot_of, qc_ext = j_scoring._compile_queries(q, vocab_cap)
    return np.asarray(slot_of), np.asarray(qc_ext)


def _coo(rng, n_docs, vocab, avg_len, vocab_cap, min_doc_cap=64):
    docs = []
    for _ in range(n_docs):
        n = int(rng.integers(1, 2 * avg_len))
        ids = rng.zipf(1.3, size=n) % vocab
        u, c = np.unique(ids, return_counts=True)
        docs.append(dict(zip(u.tolist(), c.tolist())))
    # rows sorted by distinct count desc, as ShardIndex.to_coo lays out
    docs.sort(key=len, reverse=True)
    return j_csr.build_coo(docs, vocab_cap, min_nnz_cap=1 << 10,
                           min_doc_cap=min_doc_cap)


# ---- query compilation ------------------------------------------------

@pytest.mark.parametrize("with_zero", [False, True])
def test_compile_queries_bitwise(with_zero):
    """slot_of and qc_ext equal the JAX ones exactly — including the
    pad-drop case, where a real term id 0 shares its value with the pad
    entries of ``uniq`` and must keep its own slot."""
    rng = np.random.default_rng(3)
    vocab = 1000
    q_terms, q_weights = _queries(rng, 16, 4, vocab, with_zero=with_zero)
    jq, tq = _both_batches(q_terms, q_weights)
    slot_j, qc_j = _jax_compiled(jq, vocab)
    slot_t, qc_t = t_scoring._compile_queries(tq, vocab)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    np.testing.assert_array_equal(qc_t.numpy(), qc_j)
    if with_zero:
        assert slot_t[0].item() == 0   # id 0 is uniq[0], slot 0
        assert qc_t[0, 0].item() > 0


def test_compile_queries_drops_ids_past_vocab_cap():
    """A query id at or past the snapshot's vocab bucket is dropped (the
    JAX scatter's mode="drop"), not an index error."""
    q_terms = np.asarray([[3, 40]], np.int32)
    q_weights = np.asarray([[1.0, 2.0]], np.float32)
    jq, tq = _both_batches(q_terms, q_weights)
    slot_j, qc_j = _jax_compiled(jq, 32)
    slot_t, qc_t = t_scoring._compile_queries(tq, 32)
    np.testing.assert_array_equal(slot_t.numpy(), slot_j)
    np.testing.assert_array_equal(qc_t.numpy(), qc_j)


# ---- COO scoring ------------------------------------------------------

@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_score_coo_impl_matches_jax(model):
    """rel 1e-6: model weights go through log1p/log and division."""
    rng = np.random.default_rng(7)
    vocab_cap = 512
    coo = _coo(rng, 120, 400, 12, vocab_cap)
    n_docs, avgdl = np.float32(coo.num_docs), np.float32(
        coo.doc_len[:coo.num_docs].mean())
    q_terms, q_weights = _queries(rng, 8, 3, 400)
    jq, tq = _both_batches(q_terms, q_weights)
    norms = None
    if model == "tfidf_cosine":
        norms = np.asarray(j_scoring.cosine_norms(
            jnp.asarray(coo.tf), jnp.asarray(coo.term),
            jnp.asarray(coo.doc), jnp.asarray(coo.df),
            jnp.float32(n_docs), coo.doc_cap))
        plan = t_scoring.segment_plan(coo.doc, coo.nnz, coo.nnz, CPU)
        t_norms = t_scoring.cosine_norms(
            _t(coo.tf), _t(coo.term), _t(coo.doc), _t(coo.df),
            torch.tensor(n_docs), coo.doc_cap, plan)
        np.testing.assert_allclose(t_norms.numpy(), norms, rtol=1e-6)
    ref = np.asarray(j_scoring.score_coo_impl(
        jnp.asarray(coo.tf), jnp.asarray(coo.term), jnp.asarray(coo.doc),
        jnp.asarray(coo.doc_len), jnp.asarray(coo.df),
        j_scoring.QueryBatch(*(jnp.asarray(x) for x in jq)),
        jnp.float32(n_docs), jnp.float32(avgdl),
        None if norms is None else jnp.asarray(norms), model=model,
        chunk=256))
    got = t_scoring.score_coo_impl(
        _t(coo.tf), _t(coo.term), _t(coo.doc), _t(coo.doc_len),
        _t(coo.df), tq, torch.tensor(n_docs), torch.tensor(avgdl),
        None if norms is None else _t(norms), model=model,
        chunk=256).numpy()
    assert np.count_nonzero(ref) > 0
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


# ---- top-k ------------------------------------------------------------

@pytest.mark.parametrize("case", [
    dict(B=4, doc_cap=1000, num_docs=950, k=10, chunk=128),   # clamped tail
    dict(B=4, doc_cap=1024, num_docs=1024, k=7, chunk=256),
    dict(B=3, doc_cap=300, num_docs=5, k=10, chunk=64),       # k > live
    dict(B=2, doc_cap=100, num_docs=100, k=10, chunk=1 << 17),  # one chunk
])
def test_packed_topk_chunked_tie_heavy_bitwise(case):
    """Scores drawn from 4 values, so almost every rank is a tie: the
    packed result (values AND the tie order of ids) equals the JAX one
    to the bit."""
    rng = np.random.default_rng(11)
    s = rng.integers(0, 4, size=(case["B"], case["doc_cap"])).astype(
        np.float32) * 0.5
    ref = np.asarray(j_topk.packed_topk_chunked(
        jnp.asarray(s), jnp.int32(case["num_docs"]), k=case["k"],
        chunk=case["chunk"]))
    got = t_topk.packed_topk_chunked(
        _t(s), case["num_docs"], k=case["k"], chunk=case["chunk"]).numpy()
    np.testing.assert_array_equal(got, ref)
    vals, ids = t_topk.unpack_topk(got)
    assert vals.dtype == np.float32 and ids.dtype == np.int32


def test_packed_topk_ids_past_2_pow_23_round_trip():
    """Ids >= 2^23 (denormals if they were ever put into f32 lanes)
    survive the packed wire, with the clamped tail chunk in play."""
    doc_cap = (1 << 23) + 3000
    s = np.zeros((2, doc_cap), np.float32)
    hot = np.asarray([(1 << 23) + 5, (1 << 23) + 2999, 17, (1 << 23)])
    s[0, hot] = [3.0, 2.0, 1.0, 2.0]
    s[1, hot[:2]] = [1.0, 1.0]
    ref = np.asarray(j_topk.packed_topk_chunked(
        jnp.asarray(s), jnp.int32(doc_cap), k=4, chunk=1 << 21))
    got = t_topk.packed_topk_chunked(_t(s), doc_cap, k=4,
                                     chunk=1 << 21).numpy()
    np.testing.assert_array_equal(got, ref)
    vals, ids = t_topk.unpack_topk(got)
    assert ids[0].tolist() == [(1 << 23) + 5, 1 << 23, (1 << 23) + 2999,
                               17]
    assert vals[0].tolist() == [3.0, 2.0, 2.0, 1.0]


def test_full_ranking_matches_jax():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 5, size=(3, 200)).astype(np.float32)
    jv, ji = j_topk.full_ranking(jnp.asarray(s), 150)
    tv, ti = t_topk.full_ranking(_t(s), 150)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---- blocked ELL ------------------------------------------------------

@pytest.mark.parametrize("width_cap", [256, 16])
def test_build_ell_from_coo_identical(width_cap):
    rng = np.random.default_rng(13)
    coo = _coo(rng, 300, 2000, 20, 2048)
    j = j_ell.build_ell_from_coo(coo, width_cap=width_cap, min_rows=64)
    t = t_ell.build_ell_from_coo(
        t_csr.CooShard(coo.tf, coo.term, coo.doc, coo.doc_len, coo.df,
                       coo.nnz, coo.num_docs),
        width_cap=width_cap, min_rows=64)
    assert len(t.blocks) == len(j.blocks) > 1
    for a, b in zip(t.blocks, j.blocks):
        assert (a.row0, a.n_rows, a.width) == (b.row0, b.n_rows, b.width)
        np.testing.assert_array_equal(a.tf, b.tf)
        np.testing.assert_array_equal(a.term, b.term)
    assert t.res_nnz == j.res_nnz
    for name in ("res_tf", "res_term", "res_doc"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    if width_cap == 16:
        assert t.res_nnz > 0


@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_ell_impacts_matches_jax(model):
    """rel 1e-6: log1p and division may differ by an ulp."""
    rng = np.random.default_rng(17)
    rows, width, vocab_cap = 64, 24, 300
    tf = rng.integers(0, 5, size=(rows, width)).astype(np.float32)
    term = rng.integers(0, vocab_cap, size=(rows, width)).astype(np.int32)
    dl = rng.uniform(1, 80, size=rows).astype(np.float32)
    df = rng.integers(1, 40, size=vocab_cap).astype(np.float32)
    norms = rng.uniform(0.5, 3, size=rows).astype(np.float32)
    n_docs, avgdl = np.float32(50), np.float32(33.5)
    ref = np.asarray(j_ell.ell_impacts(
        jnp.asarray(tf), jnp.asarray(term), jnp.asarray(dl),
        jnp.asarray(df), jnp.float32(n_docs), jnp.float32(avgdl),
        jnp.asarray(norms), model=model))
    got = t_ell.ell_impacts(_t(tf), _t(term), _t(dl), _t(df),
                            torch.tensor(n_docs), torch.tensor(avgdl),
                            _t(norms), model=model).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("rows_cap,width,B", [(64, 8, 4), (96, 33, 16),
                                              (256, 128, 32)])
def test_plain_score_block_bitwise_vs_jax(rows_cap, width, B):
    """The port's plain ``_score_block`` equals the JAX ``_score_block``
    to the bit, given identical impacts and query weights (same pinned
    lane order, no contraction on either side)."""
    rng = np.random.default_rng(rows_cap + width)
    vocab = 5000
    imp = rng.random((rows_cap, width), dtype=np.float32)
    term = rng.integers(0, vocab, size=(rows_cap, width)).astype(np.int32)
    q_terms, q_weights = _queries(rng, B, 4, vocab)
    q_terms[:, 0] = term[rng.integers(0, rows_cap, size=B), 0]
    jq, tq = _both_batches(q_terms, q_weights)
    slot_j, qc_j = _jax_compiled(jq, vocab)
    ref = np.asarray(j_ell._score_block(
        jnp.asarray(imp), jnp.asarray(term), jnp.asarray(slot_j),
        jnp.asarray(qc_j).T, 2048))
    slot_t, qc_t = t_scoring._compile_queries(tq, vocab)
    got = t_ell._score_block(_t(imp), _t(term), slot_t,
                             qc_t.T.contiguous(), 2048).numpy()
    assert np.count_nonzero(ref) > 0
    np.testing.assert_array_equal(got, ref)


def test_real_index_matches_jax_rearrange():
    """The host-built gather map reproduces the JAX device rearrange."""
    rng = np.random.default_rng(19)
    caps, live, doc_cap, B = [256, 512, 256], [200, 300, 17], 1024, 3
    parts = [rng.random((B, c), dtype=np.float32) for c in caps]
    ref = np.asarray(j_ell._rearrange_to_real(
        [jnp.asarray(p) for p in parts], caps,
        jnp.asarray(np.asarray(live, np.int32)), doc_cap, B))
    idx = torch.from_numpy(t_ell.real_index(caps, live, doc_cap))
    got = t_ell._rearrange_to_real([_t(p) for p in parts], idx, B,
                                   CPU).numpy()
    np.testing.assert_array_equal(got, ref)


def test_kernel_wrapper_routes_cpu_to_plain_and_validates():
    """On a CPU tensor the wrapper runs the plain version and counts no
    launch; an unknown variant fails loudly."""
    rng = np.random.default_rng(23)
    imp = rng.random((16, 256), dtype=np.float32)
    term = rng.integers(0, 100, size=(16, 256)).astype(np.int32)
    slot_of = torch.full((100,), 256, dtype=torch.int32)
    slot_of[term[0, :5]] = torch.arange(5, dtype=torch.int32)
    qc_t = torch.zeros((257, 8))
    qc_t[:5] = torch.rand(5, 8)
    before = dict(t_ell.launches)
    out = t_ell.score_block_kernel(_t(imp), _t(term), slot_of, qc_t, 200,
                                   a_build="v4")
    assert t_ell.launches == before
    ref = t_ell._score_block(_t(imp).T, _t(term).T, slot_of, qc_t, 2048)
    ref[:, 200:] = 0
    assert torch.equal(out, ref)
    assert out[:, 200:].abs().sum() == 0
    with pytest.raises(ValueError, match="kernel_a_build"):
        t_ell.score_block_kernel(_t(imp), _t(term), slot_of, qc_t, 200,
                                 a_build="v9")


def test_eligibility_envelope_matches_jax():
    for rows_cap in (128, 256, 768, 4096, 4097):
        for B in (64, 2048, 4096):
            for u_cap in (256, 512, 640):
                for a in ("v3", "v4"):
                    assert (t_ell._pallas_eligible(rows_cap, B, u_cap, a)
                            == j_ell._pallas_eligible(rows_cap, B, u_cap,
                                                      a))
    assert t_ell.ELL_WIDTH_LADDER == j_ell.ELL_WIDTH_LADDER
