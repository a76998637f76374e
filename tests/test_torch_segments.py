"""The port's streaming segments held against the JAX package on the CPU.

Three layers, each with the same inputs through both packages:

* the segment scorer — ``score_segments_impl`` of both packages on the
  same ``SegmentView`` data (several widths, a COO residual of over-wide
  docs, tombstones; ``bm25``, ``tfidf`` and ``tfidf_cosine``). Tolerance:
  scores within RELATIVE 1e-6, and top-10 ids identical outside near-tie
  groups (scores within relative 1e-6 of each other). Not bitwise: the
  JAX ``_score_block_tf`` sums over the width with XLA's ``.sum`` and the
  port with torch's, and PyTorch's and XLA's ``log1p`` differ by an ulp on
  some arguments. Within the port, one property is held to the BIT: a
  segment scored alone equals its slice of the batch (the tiered path's
  exactness rests on it);
* ``DfDeltaApplier`` — bit-equal to a recompute and to the JAX applier,
  its input df unchanged (the apply is out of place);
* the engine flows of ``tests/test_segments.py`` and the segments classes
  of ``tests/test_commit_stats.py``, each run through a port engine on the
  CPU and a JAX engine in lockstep: the same hits (ids identical outside
  near-tie groups, scores within relative 1e-6), and the port's own
  properties (rebuild equivalence, incremental stats bit-exact, snapshot
  isolation) checked as the reference's tests check them. Then
  ``segstate.npz`` checkpoints in both directions and the device
  nemesis's ``score_segments`` seam.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfidf_tpu.cluster.resilience import \
    classify_compute_fault as jax_classify
from tfidf_tpu.engine import checkpoint as jax_ckpt
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.ops import dfdelta as jax_dfdelta
from tfidf_tpu.ops import ell as jax_ell
from tfidf_tpu.ops import scoring as jax_scoring
from tfidf_tpu.utils import device_nemesis as jax_nemesis
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine import checkpoint as t_ckpt
from tfidf_tpu_torch.engine.compute_health import FallbackUnsupported
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.ops import ell as t_ell
from tfidf_tpu_torch.ops import scoring as t_scoring
from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.dfdelta import DfDeltaApplier
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import (DevicePoisonedOutput,
                                                  DeviceTransientError,
                                                  global_device_nemesis)

RTOL = 1e-6

TEXTS = {
    "a.txt": "the quick brown fox jumps over the lazy dog",
    "b.txt": "a fast brown fox and a quick red fox",
    "c.txt": "lorem ipsum dolor sit amet",
    "d.txt": "the dog sleeps all day long",
    "e.txt": "red dogs chase brown foxes at dawn",
    "f.txt": "ipsum lorem amet dolor",
}
QUERIES = ("fox", "brown dog", "lorem ipsum", "red")
WORDS = [f"w{i}" for i in range(48)]


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def assert_same_hits(got, want, rtol=RTOL):
    """Port hits against JAX hits: scores within ``rtol`` rank by rank;
    a different name at a rank only inside a near-tie group (the JAX side
    holds the port's name at a score within ``rtol`` of that rank's, or
    the rank sits in the tie group the top-k cut)."""
    assert len(got) == len(want), (got, want)
    gs = np.asarray([h.score for h in got])
    ws = np.asarray([h.score for h in want])
    np.testing.assert_allclose(gs, ws, rtol=rtol)
    wmap = {h.name: h.score for h in want}
    for g, w in zip(got, want):
        if g.name == w.name:
            continue
        other = wmap.get(g.name, ws[-1])
        assert abs(other - w.score) <= rtol * abs(w.score), (got, want)


class Twin:
    """A port engine on the CPU and a JAX engine fed the same operations
    in lockstep; ``search`` returns the port's hits after holding them to
    the JAX engine's."""

    def __init__(self, tmp_path, sub, mode="segments", **kw):
        cfg = dict(index_mode=mode, min_doc_capacity=8,
                   min_nnz_capacity=256, min_vocab_capacity=64,
                   query_batch=4, max_query_terms=8,
                   embedding_enabled=False, **kw)
        self.t = Engine(Config(documents_path=str(tmp_path / sub / "t"),
                               index_path=str(tmp_path / sub / "ti"),
                               **cfg), device="cpu")
        self.j = JaxEngine(JaxConfig(
            documents_path=str(tmp_path / sub / "j"),
            index_path=str(tmp_path / sub / "ji"), use_pallas=False,
            **cfg))

    def ingest(self, name, text):
        self.t.ingest_text(name, text)
        self.j.ingest_text(name, text)

    def delete(self, name):
        a, b = self.t.delete(name), self.j.delete(name)
        assert a == b
        return a

    def commit(self):
        self.t.commit()
        self.j.commit()

    def search(self, q, **kw):
        got, want = self.t.search(q, **kw), self.j.search(q, **kw)
        assert_same_hits(got, want)
        return got

    def search_batch(self, qs, **kw):
        got = self.t.search_batch(list(qs), **kw)
        want = self.j.search_batch(list(qs), **kw)
        for g, w in zip(got, want):
            assert_same_hits(g, w)
        return got

    def close(self):
        for e in (self.t, self.j):
            if e.tier is not None:
                e.tier.close()


def results(engine, queries=QUERIES):
    return [[(h.name, round(h.score, 5)) for h in engine.search(q)]
            for q in queries]


def rand_text(rng, n_lo=3, n_hi=12):
    n = int(rng.integers(n_lo, n_hi))
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


# ---------------------------------------------------------------------------
# the segment scorer
# ---------------------------------------------------------------------------

def _segment_arrays(rng, n_docs, vocab, width_cap, doc_cap_min, wide=0):
    """One segment's host arrays: docs sorted by distinct-term count,
    blocked ELL through the JAX package's (numpy) builder, a COO residual
    when ``wide`` docs exceed ``width_cap``."""
    widths = np.sort(np.concatenate([
        rng.integers(1, max(2, width_cap), n_docs - wide),
        rng.integers(width_cap + 5, 3 * width_cap, wide)]))[::-1]
    docs = [np.sort(rng.choice(vocab, size=int(w), replace=False))
            for w in widths]
    tfs = [rng.integers(1, 6, d.shape[0]).astype(np.float32) for d in docs]
    nnz = int(sum(d.shape[0] for d in docs))
    doc_cap = next_capacity(n_docs, doc_cap_min)
    nnz_cap = next_capacity(nnz, 1 << 10)
    tf = np.zeros(nnz_cap, np.float32)
    term = np.zeros(nnz_cap, np.int32)
    doc = np.full(nnz_cap, doc_cap - 1, np.int32)
    tf[:nnz] = np.concatenate(tfs)
    term[:nnz] = np.concatenate(docs)
    doc[:nnz] = np.repeat(np.arange(n_docs), [d.shape[0] for d in docs])
    doc_len = np.zeros(doc_cap, np.float32)
    doc_len[:n_docs] = [float(t.sum()) + rng.integers(0, 4) for t in tfs]
    coo = CooShard(tf=tf, term=term, doc=doc, doc_len=doc_len,
                   df=np.zeros(vocab, np.float32), nnz=nnz, num_docs=n_docs)
    ell = jax_ell.build_ell_from_coo(coo, width_cap=width_cap,
                                     min_rows=min(256, doc_cap_min))
    live = np.zeros(doc_cap, np.float32)
    live[:n_docs] = (rng.random(n_docs) > 0.2).astype(np.float32)
    return dict(ell=ell, doc_len=doc_len, live=live, docs=docs, tfs=tfs,
                n=n_docs, doc_cap=doc_cap)


def _norms(seg, df, n_total):
    norms = np.zeros(seg["doc_cap"], np.float32)
    for i, (d, t) in enumerate(zip(seg["docs"], seg["tfs"])):
        w = t * (np.log((1.0 + n_total) / (1.0 + df[d])) + 1.0)
        norms[i] = np.sqrt(float((w * w).sum()))
    return norms


def _views(segs, df, n_total, cosine):
    """The same segments as JAX and port ``SegmentView``s."""
    jv, tv = [], []
    for seg in segs:
        ell, doc_len = seg["ell"], seg["doc_len"]
        norms_real = (_norms(seg, df, n_total) if cosine
                      else np.zeros(seg["doc_cap"], np.float32))
        tfs, terms, dls, nrms, live = [], [], [], [], []
        for blk in ell.blocks:
            cap = blk.tf.shape[0]
            dl = np.zeros(cap, np.float32)
            dl[:blk.n_rows] = doc_len[blk.row0:blk.row0 + blk.n_rows]
            nb = np.zeros(cap, np.float32)
            nb[:blk.n_rows] = norms_real[blk.row0:blk.row0 + blk.n_rows]
            tfs.append(blk.tf)
            terms.append(blk.term)
            dls.append(dl)
            nrms.append(nb)
            live.append(blk.n_rows)
        jres = tres = None
        if ell.res_nnz:
            rn = norms_real if cosine else None
            jres = (jnp.asarray(ell.res_tf), jnp.asarray(ell.res_term),
                    jnp.asarray(ell.res_doc), jnp.asarray(doc_len),
                    None if rn is None else jnp.asarray(rn))
            tres = (torch.from_numpy(ell.res_tf),
                    torch.from_numpy(ell.res_term),
                    torch.from_numpy(ell.res_doc),
                    torch.from_numpy(doc_len),
                    None if rn is None else torch.from_numpy(rn),
                    t_scoring.segment_plan(ell.res_doc, ell.res_nnz,
                                           min(1 << 10, len(ell.res_tf)),
                                           "cpu"))
        jv.append(jax_ell.SegmentView(
            tfs=tuple(map(jnp.asarray, tfs)),
            terms=tuple(map(jnp.asarray, terms)),
            dls=tuple(map(jnp.asarray, dls)),
            norms=tuple(map(jnp.asarray, nrms)),
            block_live=jnp.asarray(np.asarray(live, np.int32)),
            live_mask=jnp.asarray(seg["live"]), res=jres))
        tv.append(t_ell.SegmentView(
            tfs=tuple(map(torch.from_numpy, tfs)),
            terms=tuple(map(torch.from_numpy, terms)),
            dls=tuple(map(torch.from_numpy, dls)),
            norms=tuple(map(torch.from_numpy, nrms)),
            block_live=tuple(live),
            live_mask=torch.from_numpy(seg["live"]), res=tres))
    return jv, tv


def _scorer_case(seed, model):
    rng = np.random.default_rng(seed)
    vocab = 300
    segs = [_segment_arrays(rng, 40, vocab, 32, 64, wide=3),
            _segment_arrays(rng, 300, vocab, 16, 64),
            _segment_arrays(rng, 7, vocab, 256, 8, wide=0)]
    df = np.zeros(vocab, np.float32)
    for s in segs:
        for d in s["docs"]:
            df[d] += 1
    df += rng.integers(0, 3, vocab)          # tombstoned docs still count
    n_total = float(sum(s["n"] for s in segs) + 5)
    avgdl = float(np.mean(np.concatenate(
        [s["doc_len"][:s["n"]] for s in segs])))
    B, T = 16, 6
    q_terms = rng.integers(0, vocab, (B, T)).astype(np.int32)
    q_weights = rng.integers(0, 3, (B, T)).astype(np.float32)
    q_terms[:, 0] = rng.choice(df.nonzero()[0], B)   # every row hits
    q_weights[:, 0] = 1.0
    jv, tv = _views(segs, df, n_total, model == "tfidf_cosine")
    kw = dict(model=model, k1=1.2, b=0.75)
    want = np.asarray(jax_ell.score_segments_impl(
        tuple(jv), jnp.asarray(df),
        jax_scoring.make_query_batch(q_terms, q_weights),
        jnp.float32(n_total), jnp.float32(avgdl), **kw))
    qb = t_scoring.make_query_batch(q_terms, q_weights, device="cpu")
    args = (torch.from_numpy(df), qb, torch.tensor(n_total,
                                                   dtype=torch.float32),
            torch.tensor(avgdl, dtype=torch.float32))
    return tv, args, kw, want


def _topk_ids(s, k=10):
    return [np.lexsort((np.arange(row.shape[0]), -row))[:k] for row in s]


@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
@pytest.mark.parametrize("seed", [0, 5])
def test_segment_scorer_matches_jax(model, seed):
    tv, args, kw, want = _scorer_case(seed, model)
    got = t_ell.score_segments_impl(tuple(tv), *args, **kw).numpy()
    assert got.shape == want.shape
    assert (want > 0).sum() > 100 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # tombstones and pad columns score exactly 0 in both
    assert ((got == 0) == (want == 0)).all()
    for g, w, gr, wr in zip(_topk_ids(got), _topk_ids(want), got, want):
        for a, c in zip(g, w):
            if a != c:   # a swap inside a near-tie group only
                assert abs(wr[a] - wr[c]) <= RTOL * abs(wr[c])


@pytest.mark.parametrize("model", ["bm25", "tfidf_cosine"])
def test_segment_alone_equals_its_slice_bitwise(model):
    tv, args, kw, _ = _scorer_case(3, model)
    full = t_ell.score_segments_impl(tuple(tv), *args, **kw)
    base = 0
    for v in tv:
        cap = v.live_mask.shape[0]
        alone = t_ell.score_segments_impl((v,), *args, **kw)
        assert torch.equal(alone, full[:, base:base + cap])
        base += cap
    # and through the seam, with other segments beside it
    pair = t_ell.score_segments_batch((tv[2], tv[0]), *args, **kw)
    cap2 = tv[2].live_mask.shape[0]
    assert torch.equal(pair[:, cap2:], full[:, :tv[0].live_mask.shape[0]])


def test_direct_writes_equal_rearrange_to_real():
    """``score_segment_ell`` writes each block's live rows straight into
    the real doc space; the JAX package concatenates the padded blocks and
    gathers (``_rearrange_to_real``). The two are bit-equal."""
    tv, (df, qb, n, avgdl), kw, _ = _scorer_case(7, "bm25")
    slot_of, qc_ext = t_scoring._compile_queries(qb, df.shape[0])
    qc_t = qc_ext.T.contiguous()
    for v in tv:
        parts = [t_ell._score_block_tf(tf, term, dl, df, slot_of, qc_t, n,
                                       avgdl, nrm, 2048, **kw)
                 for tf, term, dl, nrm in zip(v.tfs, v.terms, v.dls,
                                              v.norms)]
        index = torch.from_numpy(t_ell.real_index(
            [tf.shape[0] for tf in v.tfs], v.block_live,
            v.live_mask.shape[0]))
        ref = t_ell._rearrange_to_real(parts, index, qc_t.shape[1], "cpu")
        if v.res is not None:
            rt, rm, rd, rdl, rn, plan = v.res
            ref = ref + t_scoring.score_coo_compiled(
                rt, rm, rd, rdl, df, slot_of, qc_ext, n, avgdl, rn,
                chunk=min(1 << 10, rt.shape[0]), plan=plan, **kw)
        ref = ref * v.live_mask[None, :]
        got = t_ell.score_segment_ell(v, df, slot_of, qc_ext, qc_t, n,
                                      avgdl, **kw)
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# DfDeltaApplier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dfdelta_bit_equal_recompute_and_jax(seed):
    rng = np.random.default_rng(seed)
    vocab = 500
    base = rng.integers(0, 50, vocab).astype(np.float32)
    want = base.astype(np.float64)
    mine, theirs = DfDeltaApplier(), jax_dfdelta.DfDeltaApplier()
    for _ in range(int(rng.integers(5, 30))):
        ids = np.unique(rng.integers(0, vocab, rng.integers(0, 40)))
        if rng.random() < 0.5:
            delta = float(rng.choice([1.0, -1.0]))
            want[ids] += delta
        else:
            delta = rng.integers(1, 5, ids.shape[0]).astype(np.float32)
            if rng.random() < 0.5:
                delta = -delta
            want[ids] += delta
        # the journal also holds ids past the df (dropped in both)
        if rng.random() < 0.2:
            ids = np.append(ids, vocab + 3)
            if not np.isscalar(delta):
                delta = np.append(delta, 1.0).astype(np.float32)
        mine.record(ids, delta)
        theirs.record(ids, delta)
    df_in = torch.from_numpy(base.copy())
    before = df_in.clone()
    got = mine.apply(df_in)
    assert torch.equal(df_in, before), "apply wrote into its input"
    assert mine.journal == []
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(theirs.apply(jnp.asarray(base))))


def test_dfdelta_empty_and_netted_journal_return_the_input():
    a = DfDeltaApplier()
    df = torch.arange(8, dtype=torch.float32)
    assert a.apply(df) is df
    ids = np.array([1, 4])
    a.record(ids, 1.0)
    a.record(ids, -1.0)
    a.record(np.zeros(0, np.int64), 1.0)
    assert a.apply(df) is df


# ---------------------------------------------------------------------------
# engine flows (tests/test_segments.py), port and JAX in lockstep
# ---------------------------------------------------------------------------

class TestEquivalence:
    def test_incremental_equals_rebuild(self, tmp_path):
        seg = Twin(tmp_path, "seg")
        reb = Engine(Config(index_mode="rebuild", min_doc_capacity=8,
                            min_nnz_capacity=256, min_vocab_capacity=64,
                            query_batch=4, max_query_terms=8,
                            embedding_enabled=False), device="cpu")
        items = list(TEXTS.items())
        for i in range(0, len(items), 2):
            for name, text in items[i:i + 2]:
                seg.ingest(name, text)
            seg.commit()
        for name, text in items:
            reb.ingest_text(name, text)
        reb.commit()
        assert len(seg.t.index.snapshot.segments) == 3
        for q in QUERIES:
            seg.search(q)
        assert results(seg.t) == results(reb)

    def test_single_commit_equivalence(self, tmp_path):
        seg = Twin(tmp_path, "seg1")
        for name, text in TEXTS.items():
            seg.ingest(name, text)
        seg.commit()
        for q in QUERIES:
            seg.search(q)


class TestIncrementality:
    def test_old_segments_untouched(self, tmp_path):
        e = Twin(tmp_path, "inc")
        for name, text in list(TEXTS.items())[:4]:
            e.ingest(name, text)
        e.commit()
        first = e.t.index.snapshot.segments[0]
        e.ingest("g.txt", "entirely new content here")
        e.commit()
        segs = e.t.index.snapshot.segments
        assert len(segs) == 2 and segs[0] is first
        e.search("new content brown")

    def test_empty_commit_is_noop(self, tmp_path):
        e = Twin(tmp_path, "noop")
        e.ingest("a.txt", "alpha beta")
        e.commit()
        snap = e.t.index.snapshot
        e.commit()
        assert e.t.index.snapshot is snap


class TestMutation:
    def test_upsert_replaces(self, tmp_path):
        e = Twin(tmp_path, "up")
        e.ingest("a.txt", "original walrus content")
        e.commit()
        e.ingest("a.txt", "replacement narwhal content")
        e.commit()
        assert [h.name for h in e.search("narwhal")] == ["a.txt"]
        assert e.search("walrus") == []
        assert e.t.index.num_live_docs == 1

    def test_delete(self, tmp_path):
        e = Twin(tmp_path, "del")
        for name, text in list(TEXTS.items())[:3]:
            e.ingest(name, text)
        e.commit()
        assert e.delete("b.txt")
        assert not e.delete("b.txt")
        e.commit()
        assert [h.name for h in e.search("fox")] == ["a.txt"]
        assert e.t.index.num_live_docs == 2

    def test_delete_pending_doc(self, tmp_path):
        e = Twin(tmp_path, "delp")
        e.ingest("x.txt", "pending zebra")
        assert e.delete("x.txt")
        e.commit()
        assert e.search("zebra") == []


class TestCompaction:
    def test_compaction_bounds_segments(self, tmp_path):
        e = Twin(tmp_path, "comp", max_segments=2)
        for name, text in TEXTS.items():
            e.ingest(name, text)
            e.commit()   # one segment per doc
        assert len(e.t.index.snapshot.segments) <= 2
        for q in QUERIES:
            e.search(q)

    def test_compaction_reclaims_tombstones(self, tmp_path):
        e = Twin(tmp_path, "reclaim", max_segments=1)
        e.ingest("a.txt", "alpha beta gamma")
        e.commit()
        e.ingest("b.txt", "delta epsilon")
        e.delete("a.txt")
        e.commit()
        segs = e.t.index.snapshot.segments
        assert len(segs) == 1 and segs[0].names == ["b.txt"]
        assert e.search("alpha") == []
        assert [h.name for h in e.search("delta")] == ["b.txt"]


class TestTieredMerging:
    def test_big_segments_not_rewritten(self, tmp_path):
        e = Twin(tmp_path, "tier", max_segments=2)
        for i in range(40):
            e.ingest(f"big{i}.txt", f"common word{i} filler text")
        e.commit()
        big = e.t.index.snapshot.segments[0]
        for j in range(3):
            e.ingest(f"small{j}.txt", f"tiny doc number{j}")
            e.commit()
        segs = e.t.index.snapshot.segments
        assert len(segs) <= 2 and any(s is big for s in segs)
        assert [h.name for h in e.search("number2")] == ["small2.txt"]
        assert e.search("word7")[0].name == "big7.txt"
        e.search("common filler tiny")

    def test_background_merge_with_racing_delete(self, tmp_path):
        e = Twin(tmp_path, "bg", max_segments=1, sync_merge_nnz=1)
        e.ingest("a.txt", "alpha beta gamma")
        e.commit()
        e.ingest("b.txt", "delta alpha")
        e.commit()                               # schedules the merge
        e.delete("a.txt")                        # races it
        e.t.index.wait_for_merges(timeout=30)
        e.j.index.wait_for_merges(timeout=30)
        e.commit()
        assert len(e.t.index.snapshot.segments) == 1
        assert [h.name for h in e.search("alpha")] == ["b.txt"]
        assert e.search("gamma") == []
        for q in QUERIES + ("delta",):
            e.search(q)

    def test_background_merge_upsert_away(self, tmp_path):
        e = Twin(tmp_path, "bgu", max_segments=1, sync_merge_nnz=1)
        e.ingest("a.txt", "original unique stuff")
        e.commit()
        e.ingest("b.txt", "second doc here")
        e.commit()
        e.ingest("a.txt", "replacement totally different")
        e.t.index.wait_for_merges(timeout=30)
        e.j.index.wait_for_merges(timeout=30)
        e.commit()
        assert e.search("original") == []
        assert [h.name for h in e.search("replacement")] == ["a.txt"]
        assert [h.name for h in e.search("second")] == ["b.txt"]


class TestWideDocSpill:
    @staticmethod
    def _wide_text(n_terms: int) -> str:
        words = [f"term{i:04d}" for i in range(n_terms)]
        return " ".join(words) + " " + " ".join(words[:7])

    def test_wide_doc_matches_rebuild(self, tmp_path):
        seg = Twin(tmp_path, "wseg", ell_width_cap=16)
        reb = Engine(Config(min_doc_capacity=8, min_nnz_capacity=256,
                            min_vocab_capacity=64, query_batch=4,
                            max_query_terms=8, ell_width_cap=16,
                            embedding_enabled=False), device="cpu")
        wide = self._wide_text(1000)
        for name, text in TEXTS.items():
            seg.ingest(name, text)
            reb.ingest_text(name, text)
        seg.ingest("wide.txt", wide)
        reb.ingest_text("wide.txt", wide)
        seg.commit()
        reb.commit()
        assert seg.t.index.snapshot.segments[0].res_tf is not None
        qs = QUERIES + ("term0003 term0500 fox",)
        for q in qs:
            seg.search(q)
        assert results(seg.t, qs) == results(reb, qs)
        assert [h.name for h in seg.search("term0999")] == ["wide.txt"]

    def test_failed_or_wide_commit_loses_nothing(self, tmp_path):
        e = Twin(tmp_path, "wlose", ell_width_cap=16)
        e.ingest("wide.txt", self._wide_text(300))
        e.ingest("ok.txt", "plain small document")
        e.commit()
        assert e.t.index.num_live_docs == 2
        e.ingest("ok.txt", "updated small document")
        assert e.delete("wide.txt")
        e.commit()
        assert [h.name for h in e.search("updated")] == ["ok.txt"]
        assert e.search("term0299") == []

    def test_wide_doc_across_compaction(self, tmp_path):
        e = Twin(tmp_path, "wcomp", ell_width_cap=16, max_segments=1)
        e.ingest("wide.txt", self._wide_text(200))
        e.commit()
        e.ingest("x.txt", "xylophone")
        e.commit()   # compaction re-lays-out the wide doc
        assert [h.name for h in e.search("term0150")] == ["wide.txt"]
        assert [h.name for h in e.search("xylophone")] == ["x.txt"]


class TestCosineStreaming:
    def test_cosine_matches_rebuild(self, tmp_path):
        seg = Twin(tmp_path, "cseg", model="tfidf_cosine")
        reb = Engine(Config(model="tfidf_cosine", min_doc_capacity=8,
                            min_nnz_capacity=256, min_vocab_capacity=64,
                            query_batch=4, max_query_terms=8,
                            embedding_enabled=False), device="cpu")
        items = list(TEXTS.items())
        for i in range(0, len(items), 2):
            for name, text in items[i:i + 2]:
                seg.ingest(name, text)
            seg.commit()
        for name, text in items:
            reb.ingest_text(name, text)
        reb.commit()
        for q in QUERIES:
            seg.search(q)
        assert results(seg.t) == results(reb)

    def test_cosine_norms_refresh_after_growth(self, tmp_path):
        e = Twin(tmp_path, "cgrow", model="tfidf_cosine")
        e.ingest("a.txt", "shared unique")
        e.commit()
        s1 = {h.name: h.score for h in e.search("shared")}
        for i in range(4):
            e.ingest(f"x{i}.txt", "shared filler words here")
        e.commit()
        s2 = {h.name: h.score for h in e.search("shared")}
        assert abs(s1["a.txt"] - s2["a.txt"]) > 1e-6

    def test_cosine_wide_doc_spill(self, tmp_path):
        seg = Twin(tmp_path, "cwide", model="tfidf_cosine",
                   ell_width_cap=16)
        wide = " ".join(f"w{i:03d}" for i in range(100))
        seg.ingest("wide.txt", wide)
        seg.ingest("a.txt", "w001 w002 and more")
        seg.commit()
        for q in ("w001", "w050 w099"):
            seg.search(q)


class TestSnapshotIsolation:
    def test_published_snapshot_ignores_later_deletes(self, tmp_path):
        e = Twin(tmp_path, "iso")
        for name, text in list(TEXTS.items())[:3]:
            e.ingest(name, text)
        e.commit()
        snap1 = e.t.index.snapshot
        mask1 = snap1.views[0].live_mask.clone()
        e.delete("a.txt")
        e.commit()
        snap2 = e.t.index.snapshot
        assert torch.equal(snap1.views[0].live_mask, mask1)
        assert snap2.views[0].live_mask.sum() == mask1.sum() - 1
        e.search("fox")

    def test_published_snapshot_ignores_later_df_drift(self, tmp_path):
        """The incremental df apply is out of place: a later commit's df
        change never reaches the df an earlier snapshot holds, and that
        snapshot keeps answering with its own statistics."""
        e = Twin(tmp_path, "isodf")
        for name, text in list(TEXTS.items())[:3]:
            e.ingest(name, text)
        e.commit()
        snap1 = e.t.index.snapshot
        df1 = snap1.df.clone()
        before = e.t.searcher.search(["fox brown"])
        for name, text in list(TEXTS.items())[3:]:
            e.ingest(name, text)
        e.ingest("g.txt", "fox fox brown fox")
        e.commit()
        assert e.t.index.df_full_recomputes == 1   # the incremental path
        assert not torch.equal(e.t.index.snapshot.df, df1)
        assert torch.equal(snap1.df, df1)
        e.t.index.snapshot, now = snap1, e.t.index.snapshot
        assert e.t.searcher.search(["fox brown"]) == before
        e.t.index.snapshot = now
        e.search("fox brown")


# ---------------------------------------------------------------------------
# incremental stats (the segments classes of tests/test_commit_stats.py)
# ---------------------------------------------------------------------------

def assert_segment_stats_exact(twin):
    index = twin.t.index
    snap = index.snapshot
    vocab_cap = snap.df.shape[0]
    with index._write_lock:
        df_o, count_o, len_o, live_o = index._stats_scratch_locked(
            vocab_cap)
    np.testing.assert_array_equal(snap.df.numpy(), df_o)
    assert float(snap.n_docs) == float(count_o)
    assert float(snap.avgdl) == float(
        np.float32(len_o / count_o if count_o else 1.0))
    assert index._live_total == live_o
    # and the JAX engine's incrementally maintained df, bit for bit
    np.testing.assert_array_equal(snap.df.numpy(),
                                  np.asarray(twin.j.index.snapshot.df))
    assert index._nnz_live_scratch() == index.nnz_live
    assert index._bytes_live_scratch() == index.size_bytes()


class TestSegmentsWitness:
    def test_steady_commits_never_full_recompute(self, tmp_path):
        e = Twin(tmp_path, "w")
        rng = np.random.default_rng(0)
        for i in range(4):
            e.ingest(f"d{i}.txt", rand_text(rng))
        e.commit()
        assert e.t.index.df_full_recomputes == 1
        for round_ in range(5):
            e.ingest(f"n{round_}.txt", rand_text(rng))
            e.ingest("d0.txt", rand_text(rng))      # upsert
            e.commit()
            assert_segment_stats_exact(e)
        e.delete("d1.txt")
        e.commit()
        assert_segment_stats_exact(e)
        assert e.t.index.df_full_recomputes == 1
        e.search_batch(["w1 w2", "w7"], k=5)

    def test_vocab_growth_takes_the_resync(self, tmp_path):
        e = Twin(tmp_path, "vg")
        e.ingest("a.txt", "w0 w1 w2")
        e.commit()
        base = e.t.index.df_full_recomputes
        e.ingest("big.txt", " ".join(f"x{i}" for i in range(80)))
        e.commit()
        assert e.t.index.df_full_recomputes == base + 1
        assert_segment_stats_exact(e)
        e.search("x7 w1")

    def test_control_path_counts_every_commit(self, tmp_path):
        e = Twin(tmp_path, "ctl", df_incremental=False)
        rng = np.random.default_rng(1)
        for i in range(3):
            e.ingest(f"d{i}.txt", rand_text(rng))
            e.commit()
        assert e.t.index.df_full_recomputes == 3
        assert_segment_stats_exact(e)


class TestSegmentsRandomized:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_upsert_delete_merge_commit_parity(self, tmp_path, seed):
        e = Twin(tmp_path, f"rz{seed}", max_segments=2)
        rng = np.random.default_rng(seed)
        alive = set()
        for i in range(4):
            name = f"d{i}.txt"
            e.ingest(name, rand_text(rng))
            alive.add(name)
        e.commit()
        base = e.t.index.df_full_recomputes
        next_id = 4
        for _round in range(12):
            op = rng.integers(0, 3)
            if op == 0 or not alive:
                name = f"d{next_id}.txt"
                next_id += 1
                e.ingest(name, rand_text(rng))
                alive.add(name)
            elif op == 1:
                name = sorted(alive)[int(rng.integers(0, len(alive)))]
                e.ingest(name, rand_text(rng))
            else:
                name = sorted(alive)[int(rng.integers(0, len(alive)))]
                assert e.delete(name)
                alive.discard(name)
            e.commit()
            assert_segment_stats_exact(e)
            e.search_batch([WORDS[3] + " " + WORDS[11], WORDS[5]], k=5)
        assert e.t.index.df_full_recomputes == base
        assert e.t.index.snapshot.version >= 12
        assert len(e.t.index.snapshot.segments) <= 3

    def test_cosine_commits_still_exact(self, tmp_path):
        e = Twin(tmp_path, "cos", model="tfidf_cosine")
        rng = np.random.default_rng(3)
        for i in range(4):
            e.ingest(f"d{i}.txt", rand_text(rng))
        e.commit()
        e.ingest("d9.txt", rand_text(rng))
        e.commit()
        assert_segment_stats_exact(e)
        assert e.search(WORDS[5])


# ---------------------------------------------------------------------------
# segstate.npz checkpoints, both directions
# ---------------------------------------------------------------------------

def _streamed(tmp_path, sub, **kw):
    e = Twin(tmp_path, sub, max_segments=3, **kw)
    rng = np.random.default_rng(11)
    for r in range(4):
        for i in range(5):
            e.ingest(f"d{r}_{i}.txt", rand_text(rng))
        e.commit()
    e.delete("d1_2.txt")
    e.ingest("d0_0.txt", rand_text(rng))
    e.commit()
    return e


QS = ["w0 w1 w2", "w5", "w10 w11 w12 w13", "w40 w41", "w7 w7 w8",
      "w20 w30 w44"]


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_segstate_checkpoint_loads_in_the_other_package(tmp_path,
                                                        direction):
    e = _streamed(tmp_path, "src")
    ck = str(tmp_path / "ckpt")
    if direction == "port_to_jax":
        t_ckpt.save_checkpoint(e.t, ck)
    else:
        jax_ckpt.save_checkpoint(e.j, ck)
    import json
    import os
    with open(os.path.join(ck, "meta.json")) as f:
        assert json.load(f)["snapshot"]["kind"] == "segments"
    assert os.path.exists(os.path.join(ck, "segstate.npz"))
    tl = t_ckpt.load_checkpoint(ck, e.t.config, device="cpu")
    jl = jax_ckpt.load_checkpoint(ck, e.j.config)
    # the fast path rebuilt the saved segment list (no one-segment commit)
    assert (len(tl.index.snapshot.segments)
            == len(jl.index.snapshot.segments)
            == len(e.t.index.snapshot.segments))
    got = tl.search_batch(QS, k=5)
    for g, w, src in zip(got, jl.search_batch(QS, k=5),
                         e.t.search_batch(QS, k=5)):
        assert_same_hits(g, w)
        assert_same_hits(g, src)
    assert tl.index.df_full_recomputes == 1


def test_segments_checkpoint_into_rebuild_mode(tmp_path):
    """A segstate checkpoint restored under ``index_mode="rebuild"``
    takes the generic path (bulk load + commit), as in the JAX package."""
    e = _streamed(tmp_path, "src2")
    ck = str(tmp_path / "ckpt2")
    t_ckpt.save_checkpoint(e.t, ck)
    rb = t_ckpt.load_checkpoint(
        ck, e.t.config.replace(index_mode="rebuild"), device="cpu")
    jrb = jax_ckpt.load_checkpoint(
        ck, e.j.config.replace(index_mode="rebuild"))
    assert rb.index.snapshot.num_names == e.t.index.num_live_docs
    for g, w in zip(rb.search_batch(QS, k=5), jrb.search_batch(QS, k=5)):
        assert_same_hits(g, w)


# ---------------------------------------------------------------------------
# the device nemesis at the score_segments seam
# ---------------------------------------------------------------------------

@pytest.fixture
def armed():
    global_device_nemesis.clear()
    jax_nemesis.global_device_nemesis.clear()
    yield (global_device_nemesis, jax_nemesis.global_device_nemesis)
    global_device_nemesis.clear()
    jax_nemesis.global_device_nemesis.clear()


def test_score_segments_transient_reraises_like_jax(tmp_path, armed):
    """A segments-mode device fault has no host mirror to fall back to:
    both engines re-raise the injected fault, advance health the same
    way, and serve the same hits once the rule is gone."""
    e = Twin(tmp_path, "nem", compute_degraded_after=1,
             compute_sick_after=5)
    for name, text in TEXTS.items():
        e.ingest(name, text)
    e.commit()
    want = e.search_batch(list(QUERIES), k=3)
    for nem in armed:
        nem.script("score_segments:transient")
    excs = []
    for eng in (e.t, e.j):
        with pytest.raises(Exception) as ei:
            eng.search_batch(list(QUERIES), k=3)
        excs.append(ei.value)
        assert not eng.pop_fallback_served()
    assert isinstance(excs[0], DeviceTransientError)
    assert type(excs[0]).__name__ == type(excs[1]).__name__
    assert excs[0].compute_fault == jax_classify(excs[1]) == "transient"
    st_t, st_j = e.t.compute_stats(), e.j.compute_stats()
    for key in ("state", "faults_by_kind", "total_faults"):
        assert st_t[key] == st_j[key], key
    assert armed[0].snapshot()["rules"][0]["fired"] == 1
    with pytest.raises(FallbackUnsupported, match="no bit-exact host"):
        e.t._fallback.search(list(QUERIES))
    for nem in armed:
        nem.clear()
    got = e.search_batch(list(QUERIES), k=3)
    assert [[(h.name, h.score) for h in hs] for hs in got] == \
        [[(h.name, h.score) for h in hs] for hs in want]


def test_score_segments_poison_names_its_queries(tmp_path, armed):
    e = Twin(tmp_path, "poison")
    for name, text in TEXTS.items():
        e.ingest(name, text)
    e.commit()
    for nem in armed:
        nem.script("score_segments:poison:1.0:min_uniq=2")
    qs = ["fox", "brown dog", "red"]
    for eng in (e.t, e.j):
        with pytest.raises(Exception) as ei:
            eng.search_batch(qs, k=3)
        assert type(ei.value).__name__ == "DevicePoisonedOutput"
        assert ei.value.queries == ("brown dog",)
    with pytest.raises(DevicePoisonedOutput):
        e.t.search_batch_arrays(["brown dog"], k=3)
    assert e.t.compute_stats()["state"] == e.j.compute_stats()["state"]
