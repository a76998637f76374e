"""The port's mesh ELL layout held against the JAX package on the CPU.

Same seeded inputs through both packages (the JAX side on the virtual CPU
devices of ``tests/conftest.py``, the port on in-process CPU ranks):

* ``build_mesh_ell``: the host layout array for array — buckets,
  ``perm``, block live counts, the residual split — on meshes (8,1),
  (4,2), (2,4), (2,2); the port's vectorized build must equal the JAX
  per-document loop exactly;
* ``make_impact_refresh``: impacts within relative 1e-6, not bitwise
  (PyTorch's and XLA's ``log1p`` and ``log`` differ by an ulp on some
  arguments: two libms);
* per-rank ELL block scores BITWISE: each rank's ``[W/T, rows_cap]``
  slice through ``score_block_kernel`` (its plain version on the CPU) on
  the JAX package's own impacts equals the JAX ``_score_block`` on that
  rank's slice, at every terms width, 1 and 3 wide included;
* end to end against the port's own local engine: bitwise at ``terms =
  1``, within rel 1e-6 at ``terms = 2`` (the split restarts the lane
  order; the JAX step sums the same way). Against the JAX package end to
  end nothing is bitwise, because the impacts differ by an ulp;
* the engine flows of ``tests/test_mesh_ell.py`` with a port engine and a
  JAX engine in lockstep: top-k ids identical outside near-tie groups,
  scores within relative 1e-6, both equal to the local engine; the
  kernel path (blocks inside the kernel envelope) launching
  ``score_block_kernel`` once per eligible block, rank and chunk;
  checkpoints both ways; the default ``Config()`` (dense on) building a
  mesh engine with no column.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_segments import assert_same_hits
from tfidf_tpu.engine import checkpoint as jax_ckpt
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.engine.index import DocEntry as JaxDocEntry
from tfidf_tpu.ops import ell as jax_ell
from tfidf_tpu.ops import scoring as jax_scoring
from tfidf_tpu.parallel import mesh_ell as jax_mesh_ell
from tfidf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfidf_tpu.parallel.mesh_ell_index import MeshEllIndex as JaxMeshEll
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine import checkpoint as t_ckpt
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.engine.index import DocEntry
from tfidf_tpu_torch.models.base import get_model
from tfidf_tpu_torch.ops import ell as t_ell
from tfidf_tpu_torch.ops import scoring as t_scoring
from tfidf_tpu_torch.parallel import mesh_ell
from tfidf_tpu_torch.parallel.mesh import make_mesh
from tfidf_tpu_torch.parallel.mesh_ell_index import MeshEllIndex
from tfidf_tpu_torch.utils.config import Config

TEXTS = {
    "a.txt": "the quick brown fox jumps over the lazy dog",
    "b.txt": "a fast brown fox and a quick red fox",
    "c.txt": "lorem ipsum dolor sit amet",
    "d.txt": "the dog sleeps all day long",
    "e.txt": "red dogs chase brown foxes at dawn",
    "f.txt": "ipsum lorem amet dolor",
    "g.txt": "quick quick quick brown brown dog",
    "h.txt": "foxes and dogs and foxes again",
    "i.txt": "dawn chorus over the lazy meadow",
    "j.txt": "meadow fox naps in the red dawn",
}
QUERIES = ("fox", "brown dog", "lorem ipsum", "red dawn", "meadow")
SHAPES = [(8, 1), (4, 2), (2, 4), (2, 2)]


def cpu_mesh(shape):
    return make_mesh(shape, devices=["cpu"] * (shape[0] * shape[1]))


def jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


# ---------------------------------------------------------------------------
# the layout, the impacts and the per-rank blocks
# ---------------------------------------------------------------------------

def mesh_ell_host(arrays, mesh) -> dict:
    """The base as the JAX package's global host arrays (``tf``,
    ``term``, ``impact`` per bucket ``[D, rows_cap, W]``, ``dl``,
    ``block_live``, ``live``, the residual) — every rank must be local."""
    D, T = mesh.D, mesh.T

    def blocks(xs, b):
        return np.stack([np.concatenate(
            [xs[d * T + t][b].cpu().numpy().T for t in range(T)], axis=1)
            for d in range(D)])

    def rows(xs):
        return np.stack([xs[d * T].cpu().numpy() for d in range(D)])

    def slices(xs):
        return np.stack([np.stack([xs[d * T + t].cpu().numpy()
                                   for t in range(T)]) for d in range(D)])

    nb = arrays.n_buckets
    return {
        "tf": [blocks(arrays.tf, b) for b in range(nb)],
        "term": [blocks(arrays.term, b) for b in range(nb)],
        "impact": [blocks(arrays.impact, b) for b in range(nb)],
        "dl": [np.stack([arrays.dl[d * T][b].cpu().numpy()
                         for d in range(D)]) for b in range(nb)],
        "block_live": arrays.block_live, "live": rows(arrays.live),
        "res_tf": slices(arrays.res_tf), "res_term": slices(arrays.res_term),
        "res_doc": slices(arrays.res_doc), "res_dl": rows(arrays.res_dl)}


def _entries(seed, n_docs, D, wide=0):
    """Per-row DocEntry lists of both packages over the same arrays:
    random distinct sorted term ids, ``wide`` docs past the width cap."""
    rng = np.random.default_rng(seed)
    jax_rows, port_rows = [[] for _ in range(D)], [[] for _ in range(D)]
    for i in range(n_docs):
        k = int(rng.integers(0, 40)) if i >= wide else 300 + i
        ids = np.sort(rng.choice(2000, size=k, replace=False)).astype(
            np.int32)
        tfs = rng.integers(1, 5, size=k).astype(np.float32)
        length = float(tfs.sum() + rng.integers(0, 3))
        jax_rows[i % D].append(JaxDocEntry(f"d{i}", ids, tfs, length))
        port_rows[i % D].append(DocEntry(f"d{i}", ids, tfs, length))
    return jax_rows, port_rows


def _both_bases(shape, seed=0, n_docs=90, wide=3, width_cap=256,
                min_rows=8):
    jm, pm = jax_mesh(shape), cpu_mesh(shape)
    jrows, prows = _entries(seed, n_docs, shape[0], wide)
    model = get_model("bm25")
    jarr, jperm = jax_mesh_ell.build_mesh_ell(
        jrows, jm, model.transform_doc_len, width_cap=width_cap,
        min_rows=min_rows)
    parr, pperm = mesh_ell.build_mesh_ell(
        prows, pm, model.transform_doc_len, width_cap=width_cap,
        min_rows=min_rows)
    return (jm, jarr, jperm), (pm, parr, pperm)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("width_cap", [256, 16])
def test_build_layout_matches_jax(shape, width_cap):
    (_jm, jarr, jperm), (pm, parr, pperm) = _both_bases(
        shape, width_cap=width_cap)
    for a, b in zip(jperm, pperm):
        np.testing.assert_array_equal(a, b)
    host = mesh_ell_host(parr, pm)
    np.testing.assert_array_equal(host["block_live"],
                                  np.asarray(jarr.block_live))
    for b in range(jarr.n_buckets):
        for f in ("tf", "term", "dl"):
            np.testing.assert_array_equal(
                host[f][b], np.asarray(getattr(jarr, f)[b]), err_msg=f)
    for f in ("live", "res_tf", "res_term", "res_doc", "res_dl"):
        np.testing.assert_array_equal(host[f], np.asarray(getattr(jarr, f)),
                                      err_msg=f)
    assert parr.doc_cap == jarr.doc_cap
    if width_cap == 16:
        assert (np.asarray(jarr.res_tf) != 0).any()   # the residual is used


def _stats(seed=1):
    rng = np.random.default_rng(seed)
    df = rng.integers(1, 60, size=2000).astype(np.float32)
    return df, np.float32(90.0), np.float32(23.5)


@pytest.mark.parametrize("model", ["bm25", "tfidf"])
@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_impact_refresh_matches_jax(shape, model):
    (jm, jarr, _), (pm, parr, _) = _both_bases(shape)
    df, n, avgdl = _stats()
    jimp = jax_mesh_ell.make_impact_refresh(jm, model=model)(
        jarr, df, n, avgdl)
    pimp = mesh_ell.make_impact_refresh(pm, model=model)(
        parr, torch.from_numpy(df), torch.tensor(n), torch.tensor(avgdl))
    host = mesh_ell_host(pimp, pm)
    for b in range(jarr.n_buckets):
        np.testing.assert_allclose(host["impact"][b],
                                   np.asarray(jimp.impact[b]), rtol=1e-6)
    # the refresh is out of place: the input base keeps its zero impacts
    assert all(float(x.abs().max()) == 0.0 for r in parr.impact
               for x in r if x.numel())


_jax_score_block = jax.jit(jax_ell._score_block, static_argnums=4)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (1, 8)])
def test_rank_block_scores_bitwise(shape):
    """Every rank's width slice of every bucket, on the JAX package's own
    impacts, through ``score_block_kernel`` (CPU: its plain version) ==
    the JAX ``_score_block`` on the same slice, bit for bit — at the
    narrow widths the terms split makes (W/T = 1 at T = 8). Then a rank's
    real-doc scores (``_score_rank_ell``, the kernel path) equal the JAX
    step's per-block scores through ``_rearrange_to_real``."""
    D, T = shape
    (jm, jarr, _), _ = _both_bases(shape, min_rows=256, n_docs=60, wide=0)
    df, n, avgdl = _stats()
    jimp = jax_mesh_ell.make_impact_refresh(jm)(jarr, df, n, avgdl)
    rng = np.random.default_rng(5)
    B, vocab = 8, 2000
    qt = rng.integers(0, vocab, size=(B, 6)).astype(np.int32)
    qw = rng.random((B, 6)).astype(np.float32) + 0.5
    jq = jax_scoring.make_query_batch(qt, qw)
    pq = t_scoring.make_query_batch(qt, qw, device="cpu")
    j_slot, j_qc = jax_scoring._compile_queries(jq, vocab)
    p_slot, p_qc = t_scoring._compile_queries(pq, vocab)
    np.testing.assert_array_equal(p_qc.numpy(), np.asarray(j_qc))
    qc_t = p_qc.T.contiguous()
    bl = np.asarray(jarr.block_live)
    for d in range(D):
        for t in range(T):
            parts, imps_t, terms_t = [], [], []
            for b in range(jarr.n_buckets):
                imp = np.asarray(jimp.impact[b])[d]
                wt = imp.shape[1] // T
                imp = np.ascontiguousarray(imp[:, t * wt:(t + 1) * wt])
                term = np.ascontiguousarray(
                    np.asarray(jarr.term[b])[d][:, t * wt:(t + 1) * wt])
                want = np.asarray(_jax_score_block(
                    imp, term, j_slot, j_qc.T, 2048))
                imp_t = torch.from_numpy(np.ascontiguousarray(imp.T))
                term_t = torch.from_numpy(np.ascontiguousarray(term.T))
                out = torch.full((B, imp.shape[0]), -1.0)
                t_ell.score_block_kernel(imp_t, term_t, p_slot, qc_t,
                                         int(bl[d, b]), out=out)
                live = int(bl[d, b])
                np.testing.assert_array_equal(out[:, :live].numpy(),
                                              want[:, :live])
                parts.append(want)
                imps_t.append(imp_t)
                terms_t.append(term_t)
            ref = np.asarray(jax_ell._rearrange_to_real(
                parts, [p.shape[1] for p in parts], bl[d], jarr.doc_cap, B))
            got = mesh_ell._score_rank_ell(
                imps_t, terms_t, bl[d], jarr.doc_cap, p_slot, qc_t,
                pq.uniq.shape[0], use_pallas=True, a_build="v4")
            np.testing.assert_array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# the engine flows, both packages in lockstep
# ---------------------------------------------------------------------------

class MeshTwin:
    """A port mesh engine on CPU ranks, a JAX mesh engine of the same
    shape and (optionally) a local port engine, fed the same operations."""

    def __init__(self, tmp_path, sub, shape=(4, 2), layout="ell",
                 local=True, **kw):
        cfg = dict(min_doc_capacity=8, min_nnz_capacity=256,
                   min_vocab_capacity=64, query_batch=4, max_query_terms=8,
                   **kw)
        self.t = Engine(Config(documents_path=str(tmp_path / sub / "t"),
                               engine_mode="mesh", mesh_layout=layout,
                               **cfg), device="cpu", mesh=cpu_mesh(shape))
        self.j = JaxEngine(JaxConfig(
            documents_path=str(tmp_path / sub / "j"), engine_mode="mesh",
            mesh_layout=layout, **cfg), mesh=jax_mesh(shape))
        self.local = (Engine(Config(
            documents_path=str(tmp_path / sub / "l"),
            embedding_enabled=False, **cfg), device="cpu")
            if local else None)

    def engines(self):
        return [e for e in (self.t, self.j, self.local) if e is not None]

    def ingest(self, name, text):
        for e in self.engines():
            e.ingest_text(name, text)

    def delete(self, name):
        got = {e.delete(name) for e in self.engines()}
        assert len(got) == 1
        return got.pop()

    def commit(self):
        for e in self.engines():
            e.commit()

    def search(self, q, **kw):
        got = self.t.search(q, **kw)
        assert_same_hits(got, self.j.search(q, **kw))
        if self.local is not None:
            assert_same_hits(got, self.local.search(q, **kw))
        return got


def results(engine, queries=QUERIES, k=None):
    return [sorted(((h.name, round(h.score, 4)) for h in
                    engine.search(q, k=k)), key=lambda nv: (-nv[1], nv[0]))
            for q in queries]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", ["bm25", "tfidf"])
def test_ell_mesh_equals_jax_and_local(tmp_path, shape, model):
    w = MeshTwin(tmp_path, "eq", shape, model=model)
    assert isinstance(w.t.index, MeshEllIndex)
    assert isinstance(w.j.index, JaxMeshEll)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    for q in QUERIES:
        w.search(q)
    assert results(w.t) == results(w.j) == results(w.local)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("model", ["bm25", "tfidf"])
def test_terms1_mesh_bitwise_equals_local(shape, model):
    """Within the port, against its local engine on the same texts: with
    ``terms = 1`` every rank holds whole rows, entry ``w`` takes lane
    ``w % 8`` as in the local blocks (whatever the bucket's width, pads
    add +0.0) and the impacts come from the same f32 stats, so the mesh's
    scores equal the local engine's to the BIT; at ``terms = 2`` a row's
    second half starts again at lane 0 and the partial sums add after
    each rank's tree, so they agree within f32 rounding (rel 1e-6) — the
    order the JAX mesh step sums in too."""
    rng = np.random.default_rng(3)
    texts = {f"d{i}": " ".join(f"w{t}" for t in rng.zipf(
        1.2, int(rng.integers(5, 200))) % 3000) for i in range(300)}
    qs = [" ".join(f"w{t}" for t in rng.zipf(1.2, int(rng.integers(
        1, 5))) % 3000) for _ in range(40)]
    cfg = dict(min_doc_capacity=256, query_batch=32, model=model,
               embedding_enabled=False)
    m = Engine(Config(engine_mode="mesh", **cfg), device="cpu",
               mesh=cpu_mesh(shape))
    loc = Engine(Config(**cfg), device="cpu")
    for e in (m, loc):
        for name, text in texts.items():
            e.ingest_text(name, text)
        e.commit()
    for got, want in zip(m.search_batch(qs), loc.search_batch(qs)):
        gs = sorted(h.score for h in got)
        ws = sorted(h.score for h in want)
        if shape[1] == 1:
            assert gs == ws
            wmap = {h.name: h.score for h in want}
            assert all(wmap[h.name] == h.score for h in got
                       if h.name in wmap)
        else:
            np.testing.assert_allclose(gs, ws, rtol=1e-6)


@pytest.mark.parametrize("kw", [dict(model="tfidf_cosine"),
                                dict(lucene_parity=True),
                                dict(unbounded_results=True)])
def test_coo_layout_where_ell_cannot(tmp_path, kw):
    e = Engine(Config(documents_path=str(tmp_path / "f"),
                      engine_mode="mesh", **kw), device="cpu",
               mesh=cpu_mesh((2, 2)))
    j = JaxEngine(JaxConfig(documents_path=str(tmp_path / "g"),
                            engine_mode="mesh", **kw), mesh=jax_mesh((2, 2)))
    assert not isinstance(e.index, MeshEllIndex)
    assert type(e.index).__name__ == type(j.index).__name__ == "MeshIndex"


def test_wide_terms_axis_takes_coo():
    e = Engine(Config(engine_mode="mesh"), device="cpu",
               mesh=cpu_mesh((1, 16)))
    assert not isinstance(e.index, MeshEllIndex)


def test_delta_append_and_stats_refresh(tmp_path):
    """Appends go to the COO delta (no rebuild) and move the global df,
    so base impacts are refreshed: both packages and the local engine
    agree after every commit."""
    w = MeshTwin(tmp_path, "dd", (2, 2))
    items = list(TEXTS.items())
    for name, text in items[:8]:
        w.ingest(name, text)
    w.commit()
    s1 = {h.name: h.score for h in w.search("fox")}
    for name, text in items[8:]:
        w.ingest(name, text)
    w.commit()
    assert w.t.index.appends >= 1 and w.t.index.rebuilds == 1
    assert w.t.index.appends == w.j.index.appends
    snap = w.t.index.snapshot
    assert snap.total_live == len(items)
    assert int(snap.delta.n_live.sum()) == 2
    s2 = {h.name: h.score for h in w.search("fox")}
    assert abs(s1["a.txt"] - s2["a.txt"]) > 1e-6
    for q in QUERIES:
        w.search(q)


def test_delete_in_base_and_delta_then_upsert(tmp_path):
    w = MeshTwin(tmp_path, "del", (4, 2))
    items = list(TEXTS.items())
    for name, text in items[:8]:
        w.ingest(name, text)
    w.commit()
    for name, text in items[8:]:
        w.ingest(name, text)
    w.commit()
    snap0 = w.t.index.snapshot
    live0 = [x.clone() for x in snap0.base.live]
    assert w.delete("b.txt") and w.delete("j.txt")
    assert not w.delete("nope.txt")
    w.commit()
    # snapshot isolation: the published snapshot before the deletes is
    # unchanged (every device update is out of place)
    assert all(torch.equal(a, b) for a, b in zip(live0, snap0.base.live))
    names = [h.name for h in w.search("fox", k=10)]
    assert "b.txt" not in names and "j.txt" not in names
    w.ingest("a.txt", "replacement narwhal content")
    w.commit()
    assert [h.name for h in w.search("narwhal")] == ["a.txt"]
    assert "a.txt" not in [h.name for h in w.search("quick", k=10)]
    assert w.t.index.num_live_docs == w.j.index.num_live_docs == 8
    for q in QUERIES:
        w.search(q)


def test_delta_growth_folds_and_vocab_growth_reshards(tmp_path):
    w = MeshTwin(tmp_path, "fold", (2, 2))
    w.ingest("seed.txt", "alpha beta")
    w.commit()
    r0 = w.t.index.rebuilds
    for i in range(30):
        w.ingest(f"d{i}.txt", f"alpha token{i % 7}")
        w.commit()
    assert w.t.index.rebuilds > r0
    assert w.t.index.rebuilds == w.j.index.rebuilds
    assert len(w.search("token3", k=10)) == 4
    r1 = w.t.index.rebuilds
    for i in range(4):
        w.ingest(f"v{i}.txt", " ".join(f"neo{i}_{j}" for j in range(40)))
    w.commit()
    assert w.t.index.rebuilds > r1
    assert [h.name for h in w.search("neo2_7")] == ["v2.txt"]
    w.search("alpha", k=10)


def test_wide_doc_spills_to_residual(tmp_path):
    w = MeshTwin(tmp_path, "wide", (2, 2), ell_width_cap=16)
    w.ingest("wide.txt", " ".join(f"w{i:03d}" for i in range(100)))
    w.ingest("a.txt", "w001 w002 and more")
    w.commit()
    assert sum(p.hi - p.lo for r in w.t.index.snapshot.base.res_plan
               for p in r) > 0
    for q in ("w001", "w050 w099"):
        w.search(q)


def test_name_mapping_through_permutation(tmp_path):
    w = MeshTwin(tmp_path, "perm", (4, 2), local=False)
    rng = np.random.default_rng(3)
    for i in range(24):
        n = int(rng.integers(1, 30))
        w.ingest(f"p{i:02d}.txt", " ".join(f"u{i:02d}" for _ in range(n))
                 + f" mark{i:02d}")
    w.commit()
    for i in range(24):
        assert [h.name for h in w.search(f"mark{i:02d}")] == \
            [f"p{i:02d}.txt"], i


def test_unbounded_parity_fallback_and_guard(tmp_path):
    w = MeshTwin(tmp_path, "ug", (2, 2), local=False)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    w.t.searcher.unbounded_parity_max_docs = 5
    with pytest.raises(ValueError, match="parity fallback refused"):
        w.t.search("fox", unbounded=True)
    w.t.searcher.unbounded_parity_max_docs = 1_000
    got = w.t.search("fox", unbounded=True)
    assert_same_hits(got, w.j.search("fox", unbounded=True))


def test_incremental_stats_track_mutations(tmp_path):
    """Incremental df/N/avgdl equal a from-scratch recompute after adds,
    upserts (base/delta/pending) and deletes, and the device df equals
    the host truth — as in the JAX package, whose index is checked the
    same way beside it."""
    w = MeshTwin(tmp_path, "inc", (2, 2))

    def check():
        for e in (w.t, w.j):
            cap = e.vocab.capacity()
            inc = e.index._live_stats(cap)
            scr = e.index._live_stats_scratch(cap)
            assert inc[1] == scr[1]
            assert abs(inc[2] - scr[2]) < 1e-6
            np.testing.assert_array_equal(inc[0], scr[0])
        snap = w.t.index.snapshot
        if snap is not None and not w.t.index._df_delta.journal:
            dev = snap.df_g.numpy()
            np.testing.assert_array_equal(
                dev, w.t.index._live_stats(dev.shape[0])[0])
            np.testing.assert_array_equal(
                dev, np.asarray(w.j.index.snapshot.df_g))

    for name, text in list(TEXTS.items())[:6]:
        w.ingest(name, text)
    check()
    w.commit()
    check()
    for name, text in list(TEXTS.items())[6:]:
        w.ingest(name, text)
    w.commit()
    check()
    w.ingest("zz.txt", "pending upsert one")
    w.ingest("zz.txt", "pending upsert two rewritten")
    w.ingest("a.txt", "base upsert content")
    w.ingest("j.txt", "delta upsert content")
    check()
    w.commit()
    check()
    w.delete("b.txt")
    w.delete("zz.txt")
    w.commit()
    check()
    assert w.t.index.df_full_recomputes == w.j.index.df_full_recomputes
    for q in QUERIES:
        w.search(q)


def test_kernel_path_launches_per_eligible_block_rank_and_chunk(
        tmp_path, monkeypatch):
    """Row capacities of 256 put every bucket inside the kernel envelope:
    every non-empty block of every rank (an empty one has nothing to
    launch) goes to ``score_block_kernel``
    (on the CPU its plain version) on the rank's width slice, once per
    query chunk, and the top-k equals the JAX step's XLA path on the JAX
    engine's own snapshot, ids identical, scores within relative 1e-6."""
    calls = []
    real = mesh_ell.score_block_kernel

    def counting(imp_t, *a, **kw):
        calls.append(tuple(imp_t.shape))
        return real(imp_t, *a, **kw)

    monkeypatch.setattr(mesh_ell, "score_block_kernel", counting)
    shape = (2, 2)
    cfg = dict(min_doc_capacity=256, min_nnz_capacity=256,
               min_vocab_capacity=64, query_batch=4, max_query_terms=8)
    t = Engine(Config(engine_mode="mesh", **cfg), device="cpu",
               mesh=cpu_mesh(shape))
    j = JaxEngine(JaxConfig(engine_mode="mesh", **cfg),
                  mesh=jax_mesh(shape))
    for e in (t, j):
        for name, text in TEXTS.items():
            e.ingest_text(name, text)
        e.commit()
    qs = list(QUERIES) + ["dog dawn", "quick", "amet"]
    got = t.search_batch(qs)
    chunks = -(-len(qs) // 4)
    bl = t.index.snapshot.base.block_live
    want_calls = int((bl > 0).sum()) * shape[1] * chunks
    assert len(calls) == want_calls > 0
    # the narrowest bucket (8 wide) reaches the kernel 4 wide at T = 2
    assert all(s[1] == 256 for s in calls)
    assert (4, 256) in calls or bl[:, -1].sum() == 0
    jsnap = j.index.snapshot
    search = jax_mesh_ell.make_mesh_ell_search(
        j.index.mesh, k=10, use_pallas=False)
    for lo in range(0, len(qs), 4):
        chunk = qs[lo:lo + 4]
        qb, _ = j.searcher._vectorize(chunk, 4)
        vals, gids = (np.asarray(x) for x in search(
            jsnap.base, jsnap.delta, jsnap.df_g, jsnap.n_docs, jsnap.avgdl,
            qb))
        for i, hits in enumerate(got[lo:lo + 4]):
            want = [(jsnap.name_of(int(g)), float(v))
                    for v, g in zip(vals[i], gids[i]) if v > 0]
            assert [h.name for h in hits] == [n for n, _ in want]
            np.testing.assert_allclose([h.score for h in hits],
                                       [v for _, v in want], rtol=1e-6)


def test_default_config_builds_no_dense_column(tmp_path):
    """The port's ``Config()`` has the dense plane on; a mesh engine still
    builds no column (the JAX package's mesh layouts have none), and the
    dense entry points refuse loudly."""
    e = Engine(Config(documents_path=str(tmp_path / "d"),
                      engine_mode="mesh", min_doc_capacity=8,
                      min_nnz_capacity=256, min_vocab_capacity=64),
               device="cpu", mesh=cpu_mesh((2, 1)))
    assert e.config.embedding_enabled and e.dense is None
    assert e.dense_stats() is None
    for name, text in TEXTS.items():
        e.ingest_text(name, text)
    e.commit()
    assert [h.name for h in e.search("lorem ipsum")][:2] == ["c.txt",
                                                             "f.txt"] or \
        sorted(h.name for h in e.search("lorem ipsum")) == ["c.txt", "f.txt"]
    with pytest.raises(RuntimeError, match="dense plane disabled"):
        e.search_dense_batch(["fox"])
    assert e.document_names() is None
    assert e.search_batch_arrays(["fox"]) is None
    assert e.index_size_bytes() > 0


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_crosses_packages(tmp_path, direction):
    """A mesh engine's checkpoint is the shared doc table: a port mesh
    engine restores a JAX mesh engine's checkpoint and serves the same
    hits, and the other way round."""
    w = MeshTwin(tmp_path, "ck", (2, 2), local=False)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    w.delete("c.txt")
    w.commit()
    path = str(tmp_path / "ckpt")
    cfg = dict(engine_mode="mesh", min_doc_capacity=8,
               min_nnz_capacity=256, min_vocab_capacity=64, query_batch=4,
               max_query_terms=8, mesh_shape=(2, 2))
    if direction == "port_to_jax":
        t_ckpt.save_checkpoint(w.t, path)
        restored = jax_ckpt.load_checkpoint(path, JaxConfig(
            documents_path=str(tmp_path / "r"), **dict(
                cfg, mesh_shape=(8, 1))))
        src = w.t
    else:
        jax_ckpt.save_checkpoint(w.j, path)
        restored = t_ckpt.load_checkpoint(path, Config(
            documents_path=str(tmp_path / "r"), **cfg), device="cpu")
        assert isinstance(restored.index, MeshEllIndex)
        assert restored.index.mesh.shape == {"docs": 2, "terms": 2}
        src = w.j
    for q in QUERIES:
        assert_same_hits(restored.search(q), src.search(q))
    assert "c.txt" not in [h.name for h in restored.search("lorem ipsum")]
