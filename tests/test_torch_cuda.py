"""Tests of the port that need the card (marker ``cuda``).

The CUDA kernel has no interpret mode, and the top-k's tie rule matters
where ``torch.topk`` gives no tie order, so these skip, with the reason,
where ``torch.cuda.is_available()`` is false. On the GPU machine:

    python -m pytest tests/test_torch_cuda.py -m cuda

The decision is made inside the fixture, never at import time.
"""

import numpy as np
import pytest
import torch

from tfidf_tpu_torch.ops import ell as E
from tfidf_tpu_torch.ops import scoring as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: these run the ELL kernel and the "
                    "top-k on CUDA tensors")
    return torch.device("cuda")


def _block(rng, rows_cap, width, B, vocab=50_000, hot=0):
    """Random block with distinct term ids per row; with ``hot`` > 0 the
    first ``hot`` positions of every row hold the same few term ids and
    most queries ask for them (the hot-slot case)."""
    term = (rng.integers(0, vocab // width, size=(rows_cap, width))
            * width + np.arange(width)).astype(np.int32)
    term[:, :hot] = np.arange(hot)
    imp = rng.random((rows_cap, width), dtype=np.float32)
    q_terms = np.zeros((B, 4), np.int32)
    q_weights = np.zeros((B, 4), np.float32)
    for i in range(B):
        ids = [term[rng.integers(rows_cap), 0],
               term[rng.integers(rows_cap), 1]]
        if hot and i % 8:
            ids += rng.choice(hot, size=2, replace=False).tolist()
        ids = np.unique(ids)
        q_terms[i, :len(ids)] = ids
        q_weights[i, :len(ids)] = 1.0 + rng.random(len(ids),
                                                   dtype=np.float32)
    return imp, term, q_terms, q_weights, vocab


def _inputs(cuda, rng, rows_cap, width, B, *, u_req=256, hot=0):
    imp, term, qt, qw, vocab = _block(rng, rows_cap, width, B, hot=hot)
    qb = S.make_query_batch(qt, qw, min_slots=u_req, device=cuda)
    slot_of, qc_ext = S._compile_queries(qb, vocab)
    qc_t = qc_ext.T.contiguous()
    imp_t = torch.from_numpy(np.ascontiguousarray(imp.T)).to(cuda)
    term_t = torch.from_numpy(np.ascontiguousarray(term.T)).to(cuda)
    return imp_t, term_t, slot_of, qc_t


@pytest.mark.parametrize("B", [1, 3, 64, 512, 2048])
def test_kernel_bitwise_equal_to_plain_on_card(cuda, B):
    """Exact: the kernel adds in the plain version's pinned lane order
    without FMA contraction."""
    rng = np.random.default_rng(B)
    imp_t, term_t, slot_of, qc_t = _inputs(cuda, rng, 768, 33, B)
    E.reset_launches()
    outs = [E.score_block_kernel(imp_t, term_t, slot_of, qc_t, 700,
                                 a_build=a,
                                 out=torch.full((B, 768), -7.0, device=cuda))
            for a in ("v3", "v4")]
    assert E.launches == {"v3": 1, "v4": 1}
    plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, 700)
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out[:, :700], plain[:, :700])
        assert (out[:, 700:] == -7.0).all()
    assert int((plain > 0).sum()) > 0


@pytest.mark.parametrize("case", [
    dict(rows_cap=1024, width=8, n_rows=1000, B=64),
    dict(rows_cap=512, width=256, n_rows=500, B=64),
    dict(rows_cap=2048, width=64, n_rows=2000, B=512, hot=6),
    # the largest U_cap staged in shared memory (query tile 1), and one
    # past it, whose weights the kernel reads through L2
    dict(rows_cap=512, width=16, n_rows=300, B=64, u_req=16384,
         staged=True),
    dict(rows_cap=512, width=16, n_rows=300, B=2048, u_req=32768,
         staged=False),
], ids=["width8", "width256", "hot_slots", "max_u_cap", "u_cap_past_staging"])
def test_kernel_writes_real_doc_slice_bitwise_on_card(cuda, case):
    """Exact, into a larger tensor at an unaligned row0: the block's live
    rows equal the plain version's, v3 == v4, and every column outside
    the slice keeps its sentinel."""
    case = dict(case)
    n_rows = case.pop("n_rows")
    staged = case.pop("staged", True)
    rng = np.random.default_rng(case["width"])
    imp_t, term_t, slot_of, qc_t = _inputs(cuda, rng, **case)
    B, row0 = case["B"], 37
    assert E.kernel_plan(qc_t.shape[0], B, case["width"])["staged"] == staged
    plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, n_rows)
    for a in E.A_BUILD_VARIANTS:
        out = torch.full((B, row0 + n_rows + 50), -7.0, device=cuda)
        E.score_block_kernel(imp_t, term_t, slot_of, qc_t, n_rows,
                             a_build=a, out=out, row0=row0)
        torch.cuda.synchronize()
        assert torch.equal(out[:, row0:row0 + n_rows], plain[:, :n_rows])
        assert (out[:, :row0] == -7.0).all()
        assert (out[:, row0 + n_rows:] == -7.0).all()
    assert int((plain > 0).sum()) > 0


@pytest.mark.parametrize("a_build", E.A_BUILD_VARIANTS)
def test_score_ell_impl_real_doc_scores_bitwise_on_card(cuda, a_build):
    """Exact: three blocks (two inside the kernel envelope at odd row
    offsets, one plain) written straight into ``[B, doc_cap]`` equal the
    plain blocks concatenated and gathered by ``_rearrange_to_real``, and
    the tail past the live rows is 0."""
    rng = np.random.default_rng(41)
    caps, live, widths, B = (512, 128, 256), (509, 100, 201), (24, 8, 48), 64
    doc_cap = sum(live) + 77
    imps, terms = [], []
    for cap, n, w in zip(caps, live, widths):
        imp, term, _, _, vocab = _block(rng, cap, w, 1)
        imp[n:] = 0.0
        term[n:] = 0
        imps.append(torch.from_numpy(imp).to(cuda))
        terms.append(torch.from_numpy(term).to(cuda))
    q_terms = np.stack([terms[i % 3][rng.integers(live[i % 3]),
                                     :4].cpu().numpy() for i in range(B)])
    qb = S.make_query_batch(q_terms, np.ones((B, 4), np.float32),
                            device=cuda)
    got = E.score_ell_impl(
        tuple(imps), tuple(terms), tuple(i.T.contiguous() for i in imps),
        tuple(t.T.contiguous() for t in terms), live, doc_cap, qb, vocab,
        use_pallas=True, a_build=a_build)
    slot_of, qc_ext = S._compile_queries(qb, vocab)
    qc_t = qc_ext.T.contiguous()
    index = torch.from_numpy(E.real_index(caps, live, doc_cap)).to(cuda)
    ref = E._rearrange_to_real(
        [E._score_block(i, t, slot_of, qc_t, 2048)
         for i, t in zip(imps, terms)], index, B, cuda)
    torch.cuda.synchronize()
    assert [E._pallas_eligible(c, B, 256) for c in caps] == [True, False,
                                                            True]
    assert torch.equal(got, ref)
    assert int((ref > 0).sum()) > 0 and not ref[:, sum(live):].any()


def test_searcher_serves_u_cap_past_staging_on_card(cuda):
    """A 2048-query batch of 16 distinct terms each compiles to U_cap
    32768, past the kernel's shared-memory staging: ``Searcher`` serves it
    through the kernel (weights read through L2) with results equal to the
    plain path's, bit for bit, and so does a later small batch on the same
    searcher, whose U_cap floor is now 32768."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    rng = np.random.default_rng(7)
    docs = {f"d{i}": " ".join(f"w{t}" for t in rng.integers(
                0, 40_000, size=int(rng.integers(20, 100))))
            for i in range(2000)}
    words = sorted({w for text in docs.values() for w in text.split()})
    queries = [" ".join(rng.choice(words, 16, replace=False))
               for _ in range(2048)]
    cfg = dict(min_nnz_capacity=64, min_doc_capacity=256,
               min_vocab_capacity=32, embedding_enabled=False,
               query_batch=2048)
    on = Engine(Config(**cfg, use_pallas=True))
    off = Engine(Config(**cfg, use_pallas=False))
    for e in (on, off):
        for name, text in docs.items():
            e.ingest_text(name, text)
        e.commit()
    snap = on.index.snapshot
    eligible = sum(E._pallas_eligible(i.shape[0], 2048, 32768)
                   for i in snap.ell_impacts)
    assert eligible > 0
    for batch in (queries, queries[:64]):
        E.reset_launches()
        got = on.search_batch_arrays(batch)
        assert on.searcher._u_floor == 32768
        assert E.launches["v4"] == eligible
        want = off.search_batch_arrays(batch)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert (got[0] > 0).any()
    assert not E.kernel_plan(32769, 2048, 64)["staged"]


def test_kernel_wrapper_rejects_bad_inputs(cuda):
    imp_t = torch.rand(8, 256, device=cuda)
    term_t = torch.zeros(8, 256, dtype=torch.int32, device=cuda)
    slot_of = torch.zeros(100, dtype=torch.int32, device=cuda)
    qc_t = torch.zeros(257, 4, device=cuda)
    out = torch.zeros(4, 64, device=cuda)
    with pytest.raises(ValueError, match="term_t"):
        E.score_block_kernel(imp_t, term_t.long(), slot_of, qc_t, 10,
                             out=out)
    with pytest.raises(ValueError, match="contiguous"):
        E.score_block_kernel(imp_t.T.contiguous().T, term_t, slot_of,
                             qc_t, 10, out=out)
    with pytest.raises(ValueError, match="cpu"):
        E.score_block_kernel(imp_t, term_t, slot_of.cpu(), qc_t, 10,
                             out=out)
    with pytest.raises(ValueError, match="outside"):
        E.score_block_kernel(imp_t, term_t, slot_of, qc_t, 10, out=out,
                             row0=60)
    with pytest.raises(ValueError, match="out on cpu"):
        E.score_block_kernel(imp_t, term_t, slot_of, qc_t, 10,
                             out=out.cpu())
    with pytest.raises(TypeError, match="out"):
        E.score_block_kernel(imp_t, term_t, slot_of, qc_t, 10)


def _ref_topk(s, num_docs, k):
    """numpy top-k with the reference's tie rule (score desc, id asc)."""
    s = s[:num_docs]
    order = np.lexsort((np.arange(s.shape[0]), -s))[:k]
    return s[order], order.astype(np.int32)


@pytest.mark.parametrize("doc_cap,chunk,num_docs", [
    (300_007, 1 << 17, 300_000),           # clamped tail over chunk 2
    ((1 << 23) + 3001, 1 << 21, (1 << 23) + 3000),   # ids past 2^23
])
def test_packed_topk_chunked_tie_rule_on_card(cuda, doc_cap, chunk,
                                              num_docs):
    """Exact: on tie-heavy scores the card's top-k equals a numpy
    lexsort, ids and value bits, so equal scores rank by ascending id."""
    from tfidf_tpu_torch.ops import topk as T
    rng = np.random.default_rng(doc_cap)
    s = rng.integers(0, 3, size=(4, doc_cap)).astype(np.float32) * 0.5
    for r in range(4):
        s[r, rng.integers(doc_cap - chunk, doc_cap, 12)] = 2.0
    vals, ids = T.unpack_topk(T.packed_topk_chunked(
        torch.from_numpy(s).to(cuda), num_docs, k=10, chunk=chunk))
    for r in range(4):
        want_v, want_i = _ref_topk(s[r], num_docs, 10)
        np.testing.assert_array_equal(ids[r], want_i)
        np.testing.assert_array_equal(vals[r].view(np.int32),
                                      want_v.view(np.int32))


def _card_engine(cuda, tmp_path=None, **kw):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    rng = np.random.default_rng(11)
    cfg = dict(min_nnz_capacity=64, min_doc_capacity=256,
               min_vocab_capacity=32, embedding_enabled=False,
               query_batch=64, use_pallas=True)
    if tmp_path is not None:
        cfg["documents_path"] = str(tmp_path / "docs")
    e = Engine(Config(**dict(cfg, **kw)))
    for i in range(3000):
        e.ingest_text(f"d{i}", " ".join(
            f"w{t}" for t in rng.zipf(1.2, int(rng.integers(5, 120)))
            % 5000))
    e.commit()
    queries = [" ".join(f"w{t}" for t in rng.zipf(1.2, int(
        rng.integers(1, 5))) % 5000) for _ in range(200)]
    return e, queries


def test_checkpoint_round_trip_on_card(cuda, tmp_path):
    """Exact: save on the card, restore into a fresh engine on the card
    through the snapshot.npz fast path; the same hits to the bit through
    the kernel."""
    from tfidf_tpu_torch.engine.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from tfidf_tpu_torch.utils.metrics import global_metrics
    e, queries = _card_engine(cuda, tmp_path)
    want = e.search_batch(queries, k=10)
    save_checkpoint(e, str(tmp_path / "ckpt"))
    installs = global_metrics.get("checkpoint_snapshot_installs")
    r, meta = restore_checkpoint(str(tmp_path / "ckpt"), e.config)
    assert r.device.type == "cuda" and meta["num_docs"] == 3000
    assert global_metrics.get("checkpoint_snapshot_installs") \
        == installs + 1
    E.reset_launches()
    assert r.search_batch(queries, k=10) == want
    assert E.launches["v4"] > 0


@pytest.mark.parametrize("a_build,kw", [
    ("v4", {}), ("v3", {}), ("v4", {"ell_width_cap": 16}),
    ("v4", {"scoring_layout": "coo"})],
    ids=["v4", "v3", "v4_residual", "coo"])
def test_host_fallback_bitwise_equal_to_kernel_path(cuda, a_build, kw):
    """Exact: the numpy mirror (fetched at commit) returns the card's
    scores to the bit — the kernel's blocks for both variants, the COO
    residual and the COO layout's segmented sums."""
    e, queries = _card_engine(cuda, kernel_a_build=a_build, **kw)
    snap = e.index.snapshot
    assert (snap.res_tf is not None) == ("ell_width_cap" in kw)
    E.reset_launches()
    dv, di, dk, dn = e.searcher.search_arrays(queries, k=10)
    if snap.is_ell:
        assert E.launches[a_build] > 0
    hv, hi, hk, hn = e._fallback.search_arrays(queries, k=10)
    assert dk == hk and list(dn) == list(hn)
    assert dv.tobytes() == hv.tobytes()
    np.testing.assert_array_equal(di, hi)
    assert (dv > 0).any()
    assert e._fallback.search(queries[:20], unbounded=True) \
        == e.searcher.search(queries[:20], unbounded=True)


def _dense_pair(cuda, num_docs=3000, dim=64, chunk=1024):
    """The same embedding column on the card and on the CPU."""
    from tfidf_tpu_torch.engine.dense import EmbeddingColumn
    from tfidf_tpu_torch.engine.embedder import HashEmbedder
    rng = np.random.default_rng(num_docs)
    cols = [EmbeddingColumn(HashEmbedder(dim), min_doc_capacity=64,
                            chunk=chunk, device=d) for d in (cuda, "cpu")]
    for i in range(num_docs):
        bag = {f"w{t}": float(c) for t, c in zip(
            *np.unique(rng.zipf(1.3, 12) % 4000, return_counts=True))}
        for col in cols:
            col.upsert(f"d{i:05d}", bag)
    for col in cols:
        col.commit()
    queries = [{f"w{t}": 1.0 for t in rng.zipf(1.3, 3) % 4000}
               for _ in range(40)] + [{}]
    return cols, queries


def test_dense_column_on_card_matches_cpu(cuda):
    """cuBLAS against torch's CPU matmul: names identical except inside a
    near-tie group (f64 oracle scores within 1e-6, where an ulp of either
    library's f32 sum decides), scores within rel 1e-6. Within the
    card's column the served top-k equals the top-k of ``dense_scores``
    to the bit, and a second run gives the same bits."""
    from tfidf_tpu_torch.ops.dense import (chunk_rows, dense_scores,
                                           packed_dense_topk)
    from tfidf_tpu_torch.ops.topk import exact_topk, pack_topk
    (gpu, cpu), queries = _dense_pair(cuda)
    got = gpu.search_batch(queries, 10)
    assert got == gpu.search_batch(queries, 10)
    want = cpu.search_batch(queries, 10)
    rows = np.stack([cpu._vecs[n] for n in cpu._names]).astype(np.float64)
    slot = {n: i for i, n in enumerate(cpu._names)}
    for counts, g, w in zip(queries, got, want):
        s64 = rows @ cpu.embedder.embed_query(counts).astype(np.float64)
        for (gn, gs), (wn, ws) in zip(g, w):
            assert gs == pytest.approx(ws, rel=1e-6, abs=1e-7)
            if gn != wn:
                assert abs(s64[slot[gn]] - s64[slot[wn]]) <= 1e-6
        assert len(g) == len(w) == 10
    q = torch.from_numpy(gpu._embed_queries(queries)).to(cuda)
    n = len(gpu._names)
    packed = packed_dense_topk(q, gpu._emb_dev, n, k=10, chunk=1024)
    full = dense_scores(q, gpu._emb_dev, n,
                        chunk=chunk_rows(gpu._doc_cap, 1024, 10))
    torch.cuda.synchronize()
    assert torch.equal(packed, pack_topk(*exact_topk(full, n, k=10)))


def test_fleet_on_card_answers_as_on_cpu(cuda, tmp_path):
    """The port's own cluster plane in one process: a leader and two
    workers whose engines run on the card, against the same fleet on the
    CPU (each kernel's plain version). The same uploads and queries give
    the same doc sets in every mode, scores within rel 1e-5 (the two
    devices' f32 libms and matmuls may differ by an ulp), and no reply is
    degraded. Imports only the port: this file runs where jax is absent."""
    import json
    import time
    import urllib.request

    from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                      LocalCoordination)
    from tfidf_tpu_torch.cluster.node import SearchNode
    from tfidf_tpu_torch.utils.config import Config

    docs = [{"name": f"cu{i}.txt",
             "text": f"common token{i} word{i % 3} extra{i % 5} "
                     + "filler " * (i % 4)} for i in range(40)]
    queries = ["common", "token3 word0", "word1 extra2", "common token7"]
    modes = [{}, {"mode": "dense"}, {"mode": "hybrid", "fusion": "rrf"},
             {"mode": "hybrid", "fusion": "wsum"}]

    def post(url, body):
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60.0) as r:
            return json.loads(r.read()), dict(r.headers)

    def run(device):
        core = CoordinationCore(session_timeout_s=2.0)
        nodes = []
        try:
            for i in range(3):
                cfg = Config(
                    documents_path=str(tmp_path / device / f"n{i}" / "d"),
                    index_path=str(tmp_path / device / f"n{i}" / "i"),
                    port=0, top_k=16, result_cache_entries=0)
                nodes.append(SearchNode(cfg, coord=LocalCoordination(
                    core, 0.2), device=device).start())
            deadline = time.monotonic() + 20.0
            while (len(nodes[0].registry.get_all_service_addresses()) < 2
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            url = nodes[0].url
            post(url + "/leader/upload-batch", docs)
            out = {}
            for q in queries:
                for m in modes:
                    got, hdrs = post(url + "/leader/start",
                                     dict(m, query=q))
                    assert "X-Scatter-Degraded" not in hdrs
                    assert "X-Compute-Degraded" not in hdrs
                    out[(q, json.dumps(m))] = got
            return out
        finally:
            for n in nodes:
                n.stop()
            core.close()

    on_card, on_cpu = run("cuda"), run("cpu")
    for key, want in on_cpu.items():
        got = on_card[key]
        assert want and set(got) == set(want), key
        for name, s in want.items():
            assert got[name] == pytest.approx(s, rel=1e-5), (key, name)
