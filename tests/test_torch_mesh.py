"""The port's mesh layer held against the JAX package on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port runs in-process ranks on ``device="cpu"`` (the CPU named once per
rank). Same seeded inputs through both:

* ``parallel/mesh.py`` and the collectives: the shape rule, refusals, the
  fixed rank order of the in-process ``psum``;
* ``parallel/sharded.py`` (the flows of ``tests/test_sharded.py``): the
  COO step on meshes (8,1), (4,2), (2,4), (1,8), (2,2) with global and
  parity statistics, cosine, the on-device ingest; top-k ids identical to
  the JAX step's, scores within relative 1e-6 (not bitwise: PyTorch's and
  XLA's ``log1p`` differ by an ulp on some arguments, and XLA's CPU
  segment sum and psum orders are its own), and both against the numpy
  oracle;
* ``save_sharded_arrays`` files crossing packages both ways, bit for bit;
* ``parallel/mesh_dense.py`` (``TestMeshDense`` of ``tests/test_hybrid.py``):
  ids identical to the JAX step and to a numpy brute force, scores within
  relative 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from tests.oracle import bm25_scores, random_corpus, tfidf_scores
from tests.test_torch_dense import fma_chain
from tfidf_tpu.ops.csr import build_coo
from tfidf_tpu.ops.scoring import make_query_batch as jax_query_batch
from tfidf_tpu.ops.topk import unpack_topk as jax_unpack
from tfidf_tpu.parallel import mesh_dense as jax_dense
from tfidf_tpu.parallel import sharded as jax_sharded
from tfidf_tpu.parallel.mesh import default_mesh_shape as jax_default_shape
from tfidf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfidf_tpu_torch.ops.csr import CooShard
from tfidf_tpu_torch.ops.scoring import make_query_batch
from tfidf_tpu_torch.ops.topk import unpack_topk
from tfidf_tpu_torch.parallel import mesh_dense, sharded
from tfidf_tpu_torch.parallel.collectives import InProcess
from tfidf_tpu_torch.parallel.mesh import (default_mesh_shape, engine_mesh,
                                           make_mesh)

RTOL = 1e-6
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]


def cpu_mesh(shape):
    return make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4, 8, 16, 6])
def test_default_shape_is_the_reference_rule(n):
    assert default_mesh_shape(n) == jax_default_shape(n)


def test_make_mesh_shapes_and_refusals():
    m = cpu_mesh((4, 2))
    assert m.shape == {"docs": 4, "terms": 2} == dict(jax_mesh((4, 2)).shape)
    assert m.devices.size == 8 and m.local == [(d, t) for d in range(4)
                                                for t in range(2)]
    assert m.home == torch.device("cpu")
    assert isinstance(m.comm, InProcess)
    with pytest.raises(ValueError):
        make_mesh((3, 2), devices=["cpu"] * 8)
    assert make_mesh(devices=["cpu"] * 3).shape == {"docs": 3, "terms": 1}
    assert engine_mesh((2, 2), "cpu").shape == {"docs": 2, "terms": 2}
    assert engine_mesh((), "cpu").shape == {"docs": 1, "terms": 1}


def test_no_device_means_the_card():
    """Named no device, the mesh is built over the visible CUDA devices,
    and without CUDA that raises: nothing drops to the CPU quietly."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA mesh is built instead")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        engine_mesh((2, 1))


def test_psum_is_rank_ordered_and_all_gather_docs_ordered():
    """The in-process terms psum adds in t order, so the f32 result is
    ((r0 + r1) + r2) + r3 — here 1, where another order gives 0 or 2."""
    m = cpu_mesh((2, 4))
    vals = [1e8, 1.0, -1e8, 1.0]
    parts = {(d, t): torch.tensor([vals[t] * (d + 1)], dtype=torch.float32)
             for d in range(2) for t in range(4)}
    rows = m.comm.psum(m, parts, "terms", rows_only=True)
    assert rows[0].item() == 1.0 and rows[1].item() == 2.0
    every = m.comm.psum(m, parts, "terms")
    # one tensor per device: the ranks of a row share their sum
    assert all(every[(d, t)] is every[(d, 0)] and torch.equal(
        every[(d, t)], rows[d]) for d in range(2) for t in range(4))
    both = m.comm.psum(m, parts, ("docs", "terms"))
    assert all(v.item() == 3.0 for v in both.values())
    g = m.comm.all_gather(m, {d: torch.full((2,), float(d)) for d in
                              range(2)})
    assert g.tolist() == [[0.0, 0.0], [1.0, 1.0]]
    assert m.axis_index((1, 3), "docs") == 1
    assert m.axis_index((1, 3), "terms") == 3


# ---------------------------------------------------------------------------
# the COO step (tests/test_sharded.py's flows), both packages
# ---------------------------------------------------------------------------

def _corpus(rng, n_docs=50, vocab=40):
    docs, lengths = random_corpus(rng, n_docs=n_docs, vocab=vocab)
    s = build_coo(docs, 64, min_nnz_cap=256, min_doc_cap=16)
    s.doc_len[:n_docs] = lengths
    port = CooShard(tf=s.tf, term=s.term, doc=s.doc, doc_len=s.doc_len,
                    df=s.df, nnz=s.nnz, num_docs=s.num_docs)
    return docs, lengths, s, port


def _queries(qs, max_terms=8):
    qt = np.zeros((len(qs), max_terms), np.int32)
    qw = np.zeros((len(qs), max_terms), np.float32)
    for i, q in enumerate(qs):
        for j, (t, w) in enumerate(sorted(q.items())):
            qt[i, j] = t
            qw[i, j] = w
    return (jax_query_batch(qt, qw, min_slots=8),
            make_query_batch(qt, qw, min_slots=8, device="cpu"))


QUERIES = [{1: 1.0, 2: 2.0}, {7: 1.0}, {0: 1.0, 13: 3.0}, {1: 1.0, 3: 2.0}]


def _both(jax_out, port_out):
    """(JAX vals, ids), (port vals, ids) as numpy."""
    jv, ji = (np.asarray(x) for x in jax_out)
    return (jv, ji), (port_out[0].numpy(), port_out[1].numpy())


def assert_same_topk(jax_res, port_res, rtol=RTOL):
    (jv, ji), (tv, ti) = jax_res, port_res
    live = np.isfinite(jv) & (jv > 0)
    np.testing.assert_array_equal(np.isfinite(tv) & (tv > 0), live)
    np.testing.assert_array_equal(ti[live], ji[live])
    np.testing.assert_allclose(tv[live], jv[live], rtol=rtol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_sharded_search_matches_jax_and_oracle(rng, shape, model):
    docs, lengths, jshard, pshard = _corpus(rng)
    jarr = jax_sharded.build_sharded_arrays(jshard, jax_mesh(shape),
                                            min_chunk_cap=64)
    parr = sharded.build_sharded_arrays(pshard, cpu_mesh(shape),
                                        min_chunk_cap=64)
    jq, pq = _queries(QUERIES)
    kw = dict(k=10, model=model, chunk=64)
    got = _both(jax_sharded.make_sharded_search(jax_mesh(shape), **kw)(
        jarr, jq), sharded.make_sharded_search(cpu_mesh(shape), **kw)(
        parr, pq))
    assert_same_topk(*got)
    tv, ti = got[1]
    assign = sharded.shard_documents(len(docs), shape[0])
    local_of, counters = {}, [0] * shape[0]
    for g, s in enumerate(assign):
        local_of[(int(s), counters[s])] = g
        counters[s] += 1
    for i, q in enumerate(QUERIES):
        want = np.asarray(
            bm25_scores(docs, lengths, q) if model == "bm25"
            else tfidf_scores(docs, q, cosine=model == "tfidf_cosine"))
        for v, gid in zip(tv[i], ti[i]):
            if np.isfinite(v) and v > 0:
                g = local_of[divmod(int(gid), parr.doc_cap)]
                np.testing.assert_allclose(v, want[g], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_parity_mode_matches_jax(rng, shape):
    """global_idf=False: each docs row scores with its own df/N/avgdl, in
    both packages alike."""
    _docs, _lengths, jshard, pshard = _corpus(rng, n_docs=24)
    jarr = jax_sharded.build_sharded_arrays(jshard, jax_mesh(shape),
                                            min_chunk_cap=64)
    parr = sharded.build_sharded_arrays(pshard, cpu_mesh(shape),
                                        min_chunk_cap=64)
    jq, pq = _queries(QUERIES)
    kw = dict(k=24, model="bm25", global_idf=False, chunk=64)
    assert_same_topk(*_both(
        jax_sharded.make_sharded_search(jax_mesh(shape), **kw)(jarr, jq),
        sharded.make_sharded_search(cpu_mesh(shape), **kw)(parr, pq)))
    jsc = np.asarray(jax_sharded.make_sharded_scores(
        jax_mesh(shape), model="bm25", global_idf=False, chunk=64)(jarr, jq))
    psc = sharded.make_sharded_scores(
        cpu_mesh(shape), model="bm25", global_idf=False, chunk=64)(
        parr, pq).numpy()
    np.testing.assert_allclose(psc, jsc, rtol=RTOL, atol=0)


def test_global_stats_match_jax(rng):
    _docs, lengths, jshard, pshard = _corpus(rng)
    jarr = jax_sharded.build_sharded_arrays(jshard, jax_mesh((4, 2)),
                                            min_chunk_cap=64)
    parr = sharded.build_sharded_arrays(pshard, cpu_mesh((4, 2)),
                                        min_chunk_cap=64)
    jn, ja = jax_sharded.global_stats(jarr)
    n, avgdl = sharded.global_stats(parr)
    assert n == float(jn) == len(lengths)
    np.testing.assert_allclose(avgdl, float(ja), rtol=1e-6)


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_sharded_ingest_then_search_matches_jax(rng, shape):
    """The on-device append: the same batch through both packages' ingest
    steps, identical host arrays after it, and the search over the grown
    corpus held to the JAX step and the combined-corpus oracle. The
    appended arrays are new: the previous ones are unchanged."""
    docs, lengths, jshard, pshard = _corpus(rng, n_docs=20, vocab=30)
    D, T = shape
    jm, pm = jax_mesh(shape), cpu_mesh(shape)
    jarr = jax_sharded.build_sharded_arrays(jshard, jm, min_chunk_cap=256)
    parr = sharded.build_sharded_arrays(pshard, pm, min_chunk_cap=256)
    before = [x.clone() for x in parr.tf]
    new_docs, new_lengths = random_corpus(rng, n_docs=8, vocab=30)
    per_docs = [[] for _ in range(D)]
    per_lens = [[] for _ in range(D)]
    for i, (c, dl) in enumerate(zip(new_docs, new_lengths)):
        per_docs[i % D].append(c)
        per_lens[i % D].append(dl)
    jb = jax_sharded.build_ingest_batch(jm, jarr, per_docs, per_lens, 64)
    pb = sharded.build_ingest_batch(pm, parr, per_docs, per_lens, 64)
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(np.asarray(a), b)
    jarr2 = jax_sharded.make_sharded_ingest(jm)(jarr, *jb)
    parr2 = sharded.make_sharded_ingest(pm)(parr, *pb)
    assert all(torch.equal(a, b) for a, b in zip(before, parr.tf))
    for f in ("tf", "term", "doc", "df"):
        want = np.asarray(getattr(jarr2, f))
        got = np.stack([np.stack([getattr(parr2, f)[d * T + t].numpy()
                                  for t in range(T)]) for d in range(D)])
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(sharded.live_host(parr2),
                                  np.asarray(jarr2.live))
    np.testing.assert_array_equal(parr2.n_live, np.asarray(jarr2.n_live))
    np.testing.assert_array_equal(parr2.nnz_used,
                                  np.asarray(jarr2.nnz_used))
    q = [{1: 1.0, 3: 2.0}]
    jq, pq = _queries(q)
    kw = dict(k=15, model="bm25", chunk=64)
    got = _both(jax_sharded.make_sharded_search(jm, **kw)(jarr2, jq),
                sharded.make_sharded_search(pm, **kw)(parr2, pq))
    assert_same_topk(*got)
    want = np.asarray(bm25_scores(docs + new_docs, lengths + new_lengths,
                                  q[0]))
    n_pos = int((want > 0).sum())
    np.testing.assert_allclose(np.sort(got[1][0][0, :min(15, n_pos)]),
                               np.sort(want)[::-1][:min(15, n_pos)][::-1],
                               rtol=1e-4)
    assert int(parr2.n_live.sum()) == 28


def test_with_live_mask_is_out_of_place(rng):
    _docs, _lengths, _j, pshard = _corpus(rng, n_docs=12)
    m = cpu_mesh((2, 2))
    arr = sharded.build_sharded_arrays(pshard, m, min_chunk_cap=64)
    live0 = sharded.live_host(arr).copy()
    mask = live0.copy()
    mask[0, 1] = 0.0
    arr2 = sharded.with_live_mask(m, arr, mask)
    np.testing.assert_array_equal(sharded.live_host(arr), live0)
    np.testing.assert_array_equal(sharded.live_host(arr2), mask)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sharded_npz_crosses_packages(rng, tmp_path, direction):
    """``save_sharded_arrays`` writes the JAX package's npz: a file either
    package saved loads in the other, array for array, and serves the
    same top-k; another mesh shape is refused with the same error."""
    _docs, _lengths, jshard, pshard = _corpus(rng, n_docs=30)
    jm, pm = jax_mesh((4, 2)), cpu_mesh((4, 2))
    path = str(tmp_path / "arrays.npz")
    if direction == "jax_to_port":
        src = jax_sharded.build_sharded_arrays(jshard, jm, min_chunk_cap=64)
        jax_sharded.save_sharded_arrays(src, path)
        jarr, parr = src, sharded.load_sharded_arrays(path, pm)
    else:
        src = sharded.build_sharded_arrays(pshard, pm, min_chunk_cap=64)
        sharded.save_sharded_arrays(src, path)
        jarr, parr = jax_sharded.load_sharded_arrays(path, jm), src
    data = np.load(path)
    assert sorted(data.files) == sorted(
        jax_sharded._CKPT_FIELDS + ("meta",))
    for f in ("tf", "term", "doc", "df"):
        got = np.stack([np.stack([getattr(parr, f)[d * 2 + t].numpy()
                                  for t in range(2)]) for d in range(4)])
        np.testing.assert_array_equal(got, np.asarray(getattr(jarr, f)))
    np.testing.assert_array_equal(sharded.live_host(parr),
                                  np.asarray(jarr.live))
    np.testing.assert_array_equal(parr.len_sum, np.asarray(jarr.len_sum))
    jq, pq = _queries(QUERIES)
    assert_same_topk(*_both(
        jax_sharded.make_sharded_search(jm, k=10, chunk=64)(jarr, jq),
        sharded.make_sharded_search(pm, k=10, chunk=64)(parr, pq)))
    with pytest.raises(ValueError, match="rebuild"):
        sharded.load_sharded_arrays(path, cpu_mesh((2, 1)))
    with pytest.raises(ValueError, match="rebuild"):
        jax_sharded.load_sharded_arrays(path, jax_mesh((2, 1)))


# ---------------------------------------------------------------------------
# mesh dense (TestMeshDense of tests/test_hybrid.py), both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,cuts", [((4, 2), [0, 7, 14, 21, 22]),
                                        ((2, 1), [0, 11, 22])])
def test_mesh_dense_matches_jax_and_bruteforce(shape, cuts):
    rng = np.random.default_rng(7)
    dim, k = 72, 6
    rows = rng.standard_normal((22, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    rows[5] = rows[3]                      # an exact tie: lower row wins
    dim_pad = 128
    shards = [rows[cuts[i]:cuts[i + 1]] for i in range(shape[0])]
    q = np.zeros((3, dim_pad), np.float32)
    q[:, :dim] = rng.standard_normal((3, dim)).astype(np.float32)
    q[2, :dim] = rows[3]
    jm, pm = jax_mesh(shape), cpu_mesh(shape)
    jv, ji = jax_unpack(jax_dense.make_mesh_dense_search(jm, k=k)(
        q, *jax_dense.shard_dense_column(jm, shards, dim_pad)))
    tv, ti = unpack_topk(mesh_dense.make_mesh_dense_search(pm, k=k)(
        q, *mesh_dense.shard_dense_column(pm, shards, dim_pad)))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=RTOL)
    full = q[:, :dim].astype(np.float64) @ rows.T.astype(np.float64)
    for i in range(3):
        order = np.lexsort((np.arange(22), -full[i]))[:k]
        assert ti[i].tolist() == order.tolist(), i
        np.testing.assert_allclose(tv[i], full[i, order], rtol=1e-5)


@pytest.mark.parametrize("shape,cuts", [((4, 2), [0, 7, 14, 21, 22]),
                                        ((2, 1), [0, 11, 22])])
def test_mesh_dense_exact_tie_breaks_toward_the_lower_row(shape, cuts):
    """Copies of one row at several positions of short and long shards
    score the same bits (the fixed-order oracle's), so for queries near
    that row the copies fill the top-k in global row order, the lower
    row first, as ``lax.top_k`` breaks the tie."""
    rng = np.random.default_rng(7)
    dim, dim_pad = 72, 128
    rows = rng.standard_normal((22, dim)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    copies = [1, 3, 5, 6, 12, 18, 21]
    for r in copies[1:]:
        rows[r] = rows[copies[0]]
    shards = [rows[cuts[i]:cuts[i + 1]] for i in range(shape[0])]
    q = np.zeros((8, dim_pad), np.float32)
    q[:, :dim] = rows[1] + 0.02 * rng.standard_normal((8, dim)).astype(
        np.float32)
    pm = cpu_mesh(shape)
    tv, ti = unpack_topk(mesh_dense.make_mesh_dense_search(
        pm, k=len(copies))(
        q, *mesh_dense.shard_dense_column(pm, shards, dim_pad)))
    want = fma_chain(q[:, :dim], rows[1:2])[:, 0]
    assert [i for i in range(8) if ti[i].tolist() != copies] == []
    for i in range(8):
        assert np.asarray(tv[i], np.float32).tobytes() == \
            np.full(len(copies), want[i], np.float32).tobytes(), i


def test_mesh_dense_shard_count_mismatch_refused():
    with pytest.raises(ValueError, match="3 shards"):
        mesh_dense.shard_dense_column(
            cpu_mesh((4, 2)), [np.zeros((2, 8), np.float32)] * 3, 128)
