"""The port's tiered postings held to their invariant on the CPU.

The invariant is the JAX package's (``tests/test_tiering.py``): **a
skipped or cold segment can never change the top-k**. Every flow of that
file runs here on the port, and beside it the same operations through a
JAX engine:

* tiered == untiered oracle == ``tier_bypass``, EXACTLY (names and f32
  scores, bit for bit), in the port, across randomized upsert, delete,
  merge and commit rounds at budgets 0 and 512 MB; and the port's tiered
  hits equal the JAX tiered engine's (ids identical outside near-tie
  groups, scores within relative 1e-6 — each package computes its own
  weights, see ``tests/test_torch_segments.py``);
* skipping happens, a disjoint segment's bound is exactly 0, the global
  top-1 in an evicted segment is faulted in;
* the port's bounds dominate an f64 scratch recompute of the true best
  live score;
* residency accounting, the dense plane's reservation, the df witness, a
  checkpoint round trip that re-admits segments, cosine refusing tiering;
* bit rot on a cold spill is caught, quarantined and repaired with exact
  parity; an injected ``upload`` fault surfaces as in the JAX package and
  leaves the next clean batch unchanged.
"""

import numpy as np
import pytest

from tests.test_torch_segments import assert_same_hits
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils import device_nemesis as jax_nemesis
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine import checkpoint
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.ops.blockmax import query_upper_bounds
from tfidf_tpu_torch.utils import storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import (DeviceTransientError,
                                                  global_device_nemesis)
from tfidf_tpu_torch.utils.storage import global_storage

WORDS = [f"w{i}" for i in range(48)]
QUERIES = ["w0 w1 w2", "w5", "w10 w11 w12 w13", "w40 w41",
           "w7 w7 w7 w8", "w20 w30 w44", "w0", "w47 w46 w45"]


def _cfg(tmp_path, sub, tier, budget_mb, **kw):
    # the Config default's dense plane stays on, as in the reference's
    # tests: its set_reserved at commit is what rebalances a budget-0 tier
    # past the segment each admit protects
    return dict(documents_path=str(tmp_path / sub / "docs"),
                index_path=str(tmp_path / sub / "index"),
                engine_mode="local", index_mode="segments",
                tier_enabled=tier, tier_hot_budget_mb=budget_mb,
                min_doc_capacity=8, min_nnz_capacity=256,
                min_vocab_capacity=64, query_batch=4, max_query_terms=8,
                **kw)


def make_engine(tmp_path, sub, *, tier=False, budget_mb=0, **kw):
    return Engine(Config(**_cfg(tmp_path, sub, tier, budget_mb, **kw)),
                  device="cpu")


def make_jax(tmp_path, sub, *, tier=False, budget_mb=0, **kw):
    return JaxEngine(JaxConfig(**_cfg(tmp_path, sub + "_jax", tier,
                                      budget_mb, use_pallas=False, **kw)))


def close_tier(*engines):
    for eng in engines:
        if eng is not None and getattr(eng, "tier", None) is not None:
            eng.tier.close()


def rand_text(rng, n_lo=3, n_hi=12):
    n = int(rng.integers(n_lo, n_hi))
    return " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))


def exact(eng, queries=QUERIES, k=5):
    """(name, f32 score) lists — compared bit for bit."""
    return [[(h.name, h.score) for h in hits]
            for hits in eng.search_batch(queries, k=k)]


def held_to_jax(eng, jeng, queries=QUERIES, k=5):
    got = eng.search_batch(queries, k=k)
    for g, w in zip(got, jeng.search_batch(queries, k=k)):
        assert_same_hits(g, w)
    return [[(h.name, h.score) for h in hits] for hits in got]


class TestTieredParity:
    @pytest.mark.parametrize("seed,budget_mb", [(0, 0), (7, 0), (3, 512)])
    def test_randomized_upsert_delete_merge_commit(self, tmp_path, seed,
                                                   budget_mb):
        tiered = make_engine(tmp_path, "t", tier=True, budget_mb=budget_mb,
                             max_segments=2)
        oracle = make_engine(tmp_path, "o", max_segments=2)
        jt = make_jax(tmp_path, "t", tier=True, budget_mb=budget_mb,
                      max_segments=2)
        engines = (tiered, oracle, jt)
        try:
            rng = np.random.default_rng(seed)
            names = []
            for round_ in range(6):
                for j in range(int(rng.integers(2, 6))):
                    name = f"d{round_}_{j}.txt"
                    text = rand_text(rng)
                    for e in engines:
                        e.ingest_text(name, text)
                    names.append(name)
                if names and rng.random() < 0.7:       # upsert
                    victim = names[int(rng.integers(0, len(names)))]
                    text = rand_text(rng)
                    for e in engines:
                        e.ingest_text(victim, text)
                if len(names) > 4 and rng.random() < 0.5:   # delete
                    victim = names.pop(int(rng.integers(0, len(names))))
                    for e in engines:
                        e.delete(victim)
                for e in engines:
                    e.commit()
                got = held_to_jax(tiered, jt)
                want = exact(oracle)
                assert got == want, f"tiered != oracle at round {round_}"
                tiered.searcher.tier_bypass = True
                try:
                    assert exact(tiered) == want
                finally:
                    tiered.searcher.tier_bypass = False
                # the raw arrays too: live values and ids to the bit
                a = tiered.search_batch_arrays(QUERIES, k=5)
                b = oracle.search_batch_arrays(QUERIES, k=5)
                live = a[0] > 0
                assert (live == (b[0] > 0)).all()
                assert a[0].tobytes() == b[0].tobytes()
                assert ([a[3][i] for i in a[1][live]]
                        == [b[3][i] for i in b[1][live]])
                tiered.tier.rebalance()
                jt.tier.rebalance()
            st = tiered.tier_stats()
            assert st["enabled"]
            if budget_mb == 0:
                assert st["cold_faults"] > 0
                assert st["cold_segments"] > 0
        finally:
            close_tier(*engines)

    def test_skip_occurrence_and_zero_bound(self, tmp_path):
        eng = make_engine(tmp_path, "s", tier=True, budget_mb=0)
        jeng = make_jax(tmp_path, "s", tier=True, budget_mb=0)
        try:
            for e in (eng, jeng):
                for i in range(6):
                    e.ingest_text(f"a{i}.txt", f"w0 w1 w2 w{i % 4}")
                e.commit()
                for i in range(6):
                    e.ingest_text(f"b{i}.txt",
                                  f"w20 w21 w22 w{20 + i % 4}")
                e.commit()
            st0 = eng.tier_stats()
            hits = eng.search("w20 w21", k=3)
            assert_same_hits(hits, jeng.search("w20 w21", k=3))
            assert all(h.name.startswith("b") for h in hits)
            st1 = eng.tier_stats()
            assert st1["segments_skipped"] > st0["segments_skipped"]
            assert st1["cold_segments"] > 0 and st1["skip_rate"] > 0.0
            assert (st1["segments_skipped"] - st0["segments_skipped"]
                    == jeng.tier_stats()["segments_skipped"])
            # the disjoint segment's bound is exactly 0
            snap = eng.index.snapshot
            a_seg = [h for h in snap.cold
                     if h.seg.names[0].startswith("a")][0]
            uniq = np.asarray([eng.vocab.lookup("w20"),
                               eng.vocab.lookup("w21")], np.int64)
            ub = query_upper_bounds(
                a_seg.bounds, np.sort(uniq), np.ones((1, 2)),
                snap.df_host[np.sort(uniq)].astype(np.float64),
                snap.n_docs_f, snap.avgdl_f, model="bm25")
            assert ub.tolist() == [0.0]
        finally:
            close_tier(eng, jeng)

    def test_adversarial_cold_segment_holds_top1(self, tmp_path):
        eng = make_engine(tmp_path, "adv", tier=True, budget_mb=0)
        jeng = make_jax(tmp_path, "adv", tier=True, budget_mb=0)
        try:
            for e in (eng, jeng):
                e.ingest_text("needle.txt", "w9 " * 12 + "w1")
                e.commit()
                for i in range(6):
                    e.ingest_text(f"hay{i}.txt", f"w9 w2 w3 w{i % 5}")
                e.commit()
            st0 = eng.tier_stats()
            hits = eng.search("w9", k=3)
            assert_same_hits(hits, jeng.search("w9", k=3))
            assert hits[0].name == "needle.txt"
            assert eng.tier_stats()["cold_faults"] > st0["cold_faults"]
        finally:
            close_tier(eng, jeng)


class TestBoundSoundness:
    @pytest.mark.parametrize("model", ["bm25", "tfidf"])
    @pytest.mark.parametrize("seed", [0, 11])
    def test_bounds_dominate_scratch_recompute(self, tmp_path, model,
                                               seed):
        eng = make_engine(tmp_path, f"b{model}{seed}", tier=True,
                          budget_mb=0, max_segments=2, model=model)
        jeng = make_jax(tmp_path, f"b{model}{seed}", tier=True,
                        budget_mb=0, max_segments=2, model=model)
        try:
            rng = np.random.default_rng(seed)
            names = []
            for round_ in range(5):
                for j in range(int(rng.integers(3, 7))):
                    name, text = f"d{round_}_{j}.txt", rand_text(rng)
                    eng.ingest_text(name, text)
                    jeng.ingest_text(name, text)
                    names.append(name)
                if len(names) > 3:
                    victim = names.pop(int(rng.integers(0, len(names))))
                    eng.delete(victim)
                    jeng.delete(victim)
                eng.commit()
                jeng.commit()
            # the same segments carry the same block-max summaries
            for a, c in zip(eng.index._segments, jeng.index._segments,
                            strict=True):
                np.testing.assert_array_equal(a.bounds.term_ids,
                                              c.bounds.term_ids)
                np.testing.assert_array_equal(a.bounds.tf_max,
                                              c.bounds.tf_max)
                assert a.bounds.min_dl == c.bounds.min_dl
            held_to_jax(eng, jeng)
            snap = eng.index.snapshot
            n_docs = float(snap.n_docs)
            avgdl = float(snap.avgdl)
            df_host = snap.df_host
            k1, b = eng.config.bm25_k1, eng.config.bm25_b
            for _ in range(8):
                u = int(rng.integers(1, 6))
                uniq = np.sort(rng.choice(len(WORDS), size=u,
                                          replace=False)).astype(np.int64)
                qc = rng.integers(1, 4, size=(1, u)).astype(np.float64)
                df_u = df_host[uniq].astype(np.float64)
                for seg in eng.index._segments:
                    ub = query_upper_bounds(
                        seg.bounds, uniq, qc, df_u, n_docs, avgdl,
                        model=model, k1=k1, b=b, margin=0.0)
                    best = 0.0
                    for d, alive in zip(seg.host_docs, seg.live):
                        if not alive or d.term_ids.shape[0] == 0:
                            continue
                        pos = np.minimum(np.searchsorted(d.term_ids, uniq),
                                         d.term_ids.shape[0] - 1)
                        m = d.term_ids[pos] == uniq
                        if not m.any():
                            continue
                        tf = d.tfs[pos[m]].astype(np.float64)
                        dfm = df_u[m]
                        if model == "bm25":
                            dl = float(eng.model.transform_doc_len(
                                np.asarray([d.length], np.float32))[0])
                            idf = np.log1p((n_docs - dfm + 0.5)
                                           / (dfm + 0.5))
                            norm = k1 * (1.0 - b + b * dl
                                         / max(avgdl, 1e-9))
                            w = idf * tf / (tf + norm)
                        else:
                            w = (np.log((1.0 + n_docs) / (1.0 + dfm))
                                 + 1.0) * tf
                        best = max(best, float((qc[0, m] * w).sum()))
                    assert best <= float(ub[0]) + 1e-9, \
                        (f"bound {ub[0]} < true max {best}")
        finally:
            close_tier(eng, jeng)


class TestResidencyAccounting:
    def test_budget_zero_spills_everything(self, tmp_path):
        eng = make_engine(tmp_path, "z", tier=True, budget_mb=0)
        jeng = make_jax(tmp_path, "z", tier=True, budget_mb=0)
        try:
            rng = np.random.default_rng(2)
            for r in range(3):
                for i in range(4):
                    text = rand_text(rng)
                    eng.ingest_text(f"d{r}_{i}.txt", text)
                    jeng.ingest_text(f"d{r}_{i}.txt", text)
                eng.commit()
                jeng.commit()
            st = eng.tier_stats()
            jst = jeng.tier_stats()
            for key in ("hot_segments", "cold_segments", "spills",
                        "evictions"):
                assert st[key] == jst[key], key
            assert st["hot_segments"] == 0
            assert st["cold_segments"] == len(eng.index._segments)
            assert st["spills"] >= st["cold_segments"]
            assert st["hot_bytes"] == 0
            assert all(s.tfs is None and not s.resident
                       for s in eng.index._segments)
            held_to_jax(eng, jeng)      # every segment streams back
        finally:
            close_tier(eng, jeng)

    def test_big_budget_keeps_everything_hot(self, tmp_path):
        eng = make_engine(tmp_path, "h", tier=True, budget_mb=512)
        jeng = make_jax(tmp_path, "h", tier=True, budget_mb=512)
        try:
            rng = np.random.default_rng(3)
            for r in range(3):
                for i in range(4):
                    text = rand_text(rng)
                    eng.ingest_text(f"d{r}_{i}.txt", text)
                    jeng.ingest_text(f"d{r}_{i}.txt", text)
                eng.commit()
                jeng.commit()
            held_to_jax(eng, jeng)
            st = eng.tier_stats()
            assert st["cold_segments"] == 0
            assert st["hot_segments"] == len(eng.index._segments)
            assert st["cold_faults"] == 0 and st["hot_hits"] > 0
            assert 0 < st["hot_bytes"] <= st["budget_bytes"]
            assert st["hit_rate"] == 1.0
            # the port accounts the same device bytes as the JAX package
            assert st["hot_bytes"] == jeng.tier_stats()["hot_bytes"]
        finally:
            close_tier(eng, jeng)

    def test_dense_plane_reserved_bytes(self, tmp_path):
        eng = make_engine(tmp_path, "dr", tier=True, budget_mb=512)
        try:
            rng = np.random.default_rng(4)
            for i in range(6):
                eng.ingest_text(f"d{i}.txt", rand_text(rng))
            eng.commit()
            ds = eng.dense.stats()
            assert ds["device_bytes"] > 0 and ds["host_bytes"] > 0
            assert ds["bytes"] == ds["device_bytes"] + ds["host_bytes"]
            assert eng.tier_stats()["reserved_bytes"] == ds["device_bytes"]
            # a reservation over the budget spills the whole hot set
            eng.tier.set_reserved(eng.tier.budget_bytes + 1)
            assert eng.tier_stats()["hot_segments"] == 0
            assert eng.search_dense_batch(["w1 w2"], k=2)[0]
        finally:
            close_tier(eng)

    def test_df_witness_zero_under_tiering(self, tmp_path):
        eng = make_engine(tmp_path, "w", tier=True, budget_mb=0)
        jeng = make_jax(tmp_path, "w", tier=True, budget_mb=0)
        try:
            rng = np.random.default_rng(5)

            def both(fn):
                for e in (eng, jeng):
                    fn(e)
            for i in range(4):
                text = rand_text(rng)
                both(lambda e: e.ingest_text(f"d{i}.txt", text))
            both(lambda e: e.commit())
            assert eng.index.df_full_recomputes == 1
            for r in range(4):
                new, up = rand_text(rng), rand_text(rng)
                both(lambda e: e.ingest_text(f"n{r}.txt", new))
                both(lambda e: e.ingest_text("d0.txt", up))   # upsert
                both(lambda e: e.commit())
                held_to_jax(eng, jeng, QUERIES[:3])
            both(lambda e: e.delete("d1.txt"))
            both(lambda e: e.commit())
            assert eng.index.df_full_recomputes == 1
            held_to_jax(eng, jeng)
        finally:
            close_tier(eng, jeng)

    def test_checkpoint_roundtrip_readmits_segments(self, tmp_path):
        eng = make_engine(tmp_path, "ck", tier=True, budget_mb=0)
        eng2 = None
        try:
            rng = np.random.default_rng(6)
            for r in range(3):
                for i in range(3):
                    eng.ingest_text(f"d{r}_{i}.txt", rand_text(rng))
                eng.commit()
            want = exact(eng)
            ckdir = str(tmp_path / "ck" / "ckpt")
            checkpoint.save_checkpoint(eng, ckdir)
            eng2 = checkpoint.load_checkpoint(ckdir, config=eng.config,
                                              device="cpu")
            assert eng2.tier is not None
            st = eng2.tier_stats()
            assert (st["hot_segments"] + st["cold_segments"]
                    == len(eng2.index._segments) == 3)
            assert st["cold_segments"] == len(eng2.index._segments)
            assert exact(eng2) == want
            # the JAX package restores the same checkpoint tiered too
            from tfidf_tpu.engine import checkpoint as jax_ckpt
            jeng = jax_ckpt.load_checkpoint(ckdir, config=JaxConfig(
                **_cfg(tmp_path, "ck_jax", True, 0, use_pallas=False)))
            try:
                assert (jeng.tier_stats()["cold_segments"]
                        == st["cold_segments"])
                held_to_jax(eng2, jeng)
            finally:
                close_tier(jeng)
        finally:
            close_tier(eng, eng2)

    def test_restore_with_tombstones_spills_and_serves(self, tmp_path):
        """A checkpoint of segments holding tombstones restores into a
        tiered engine whose budget spills them: the tombstoned rows come
        back with their stored postings, so the spill's re-layout matches
        the uploaded blocks (the JAX package restores them empty and its
        spill of such a segment fails: a deviation of the port), and the
        tiered answers equal the source engine's to the bit."""
        src = make_engine(tmp_path, "src", max_segments=8)
        eng2 = None
        try:
            rng = np.random.default_rng(9)
            for r in range(3):
                for i in range(5):
                    src.ingest_text(f"d{r}_{i}.txt", rand_text(rng))
                src.commit()
            for name in ("d0_1.txt", "d1_3.txt", "d2_0.txt"):
                src.delete(name)
            src.ingest_text("d1_0.txt", rand_text(rng))      # upsert
            src.commit()
            want = exact(src)
            ckdir = str(tmp_path / "src" / "ckpt")
            checkpoint.save_checkpoint(src, ckdir)
            cfg = src.config.replace(
                tier_enabled=True, tier_hot_budget_mb=0,
                index_path=str(tmp_path / "tiered"))
            eng2 = checkpoint.load_checkpoint(ckdir, config=cfg,
                                              device="cpu")
            st = eng2.tier_stats()
            assert st["cold_segments"] == len(eng2.index._segments) == 4
            dead = [d for s in eng2.index._segments
                    for d, a in zip(s.host_docs, s.live) if not a]
            assert len(dead) == 4 and all(d.term_ids.size for d in dead)
            assert exact(eng2) == want
            eng2.searcher.tier_bypass = True
            assert exact(eng2) == want
        finally:
            close_tier(src, eng2)

    def test_cosine_refuses_tiering(self, tmp_path):
        with pytest.raises(ValueError, match="cosine"):
            make_engine(tmp_path, "cos", tier=True, budget_mb=0,
                        model="tfidf_cosine")


class TestColdTierFaults:
    def test_bitrot_on_cold_spill_quarantine_repair_parity(self,
                                                           tmp_path):
        tiered = make_engine(tmp_path, "rot_t", tier=True, budget_mb=0)
        oracle = make_engine(tmp_path, "rot_o")
        jeng = make_jax(tmp_path, "rot_t", tier=True, budget_mb=0)
        try:
            rng = np.random.default_rng(7)
            for r in range(3):
                for i in range(4):
                    name, text = f"d{r}_{i}.txt", rand_text(rng)
                    for e in (tiered, oracle, jeng):
                        e.ingest_text(name, text)
                for e in (tiered, oracle, jeng):
                    e.commit()
            st0 = tiered.tier_stats()
            assert st0["cold_segments"] == len(tiered.index._segments)
            global_storage.arm(storage.BITROT, "*b0_tf.bin",
                               keep_bytes=3, times=1)
            want = exact(oracle)
            assert exact(tiered) == want, "parity lost after bit rot"
            st1 = tiered.tier_stats()
            assert st1["quarantines"] >= 1 and st1["repairs"] >= 1
            tiered.tier.rebalance()
            assert held_to_jax(tiered, jeng) == want
            assert tiered.tier_stats()["quarantines"] == st1["quarantines"]
        finally:
            global_storage.heal()
            close_tier(tiered, oracle, jeng)

    def test_upload_fault_surfaces_as_in_jax(self, tmp_path):
        """An injected fault on the upload ring is a compute fault in the
        middle of a query: both engines raise it (a segmented snapshot has
        no host fallback), nothing is scored untiered in its place, and
        the next clean batch is unchanged."""
        eng = make_engine(tmp_path, "up", tier=True, budget_mb=0,
                          compute_degraded_after=1)
        jeng = make_jax(tmp_path, "up", tier=True, budget_mb=0,
                        compute_degraded_after=1)
        nemeses = (global_device_nemesis, jax_nemesis.global_device_nemesis)
        try:
            rng = np.random.default_rng(8)
            for r in range(3):
                for i in range(4):
                    text = rand_text(rng)
                    eng.ingest_text(f"d{r}_{i}.txt", text)
                    jeng.ingest_text(f"d{r}_{i}.txt", text)
                eng.commit()
                jeng.commit()
            want = held_to_jax(eng, jeng)
            eng.tier.rebalance()
            jeng.tier.rebalance()
            faults = eng.tier_stats()["cold_faults"]
            for nem in nemeses:
                nem.script("upload:transient:1.0:count=1")
            excs = []
            for e in (eng, jeng):
                with pytest.raises(Exception) as ei:
                    e.search_batch(QUERIES, k=5)
                excs.append(ei.value)
                assert not e.pop_fallback_served()
            assert isinstance(excs[0], DeviceTransientError)
            assert type(excs[0]).__name__ == type(excs[1]).__name__
            assert eng.compute_stats()["state"] == \
                jeng.compute_stats()["state"]
            assert nemeses[0].snapshot()["rules"][0]["fired"] == 1
            assert exact(eng) == want
            assert eng.tier_stats()["cold_faults"] > faults
        finally:
            for nem in nemeses:
                nem.clear()
            close_tier(eng, jeng)
