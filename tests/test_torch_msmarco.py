"""``probe_msmarco_torch.py`` (BASELINE config 4 at its named size, 8.8M
passages on the card) held against the JAX package on the CPU, at a small
shape: 6,000 passages, average length 55, a 5,000-term vocabulary, a
commit every 500, 512 queries, plain paths.

* the probe's corpus and queries are the root ``bench.py``'s draws for
  the same seed, in the same chunks, byte for byte, and its named shape
  is ``probe_msmarco.py``'s;
* the stream leg (``chip_smoke.stream_phase``: streaming, quiesce, 1%
  deletes and upserts, quiesce, the scipy oracle) answers as a JAX
  ``Engine(Config(index_mode="segments"))`` fed the same
  ``add_document_arrays`` loop, the same commits and the same mutations;
  the rebuild leg as the JAX default engine fed the same loop: top-10 ids
  identical (a different id only inside a near-tie group, scores within
  relative 1e-6 of each other) and scores within relative 1e-6 (f32
  rounding: the segment scorer's sum and ``log1p`` differ by an ulp
  between PyTorch and XLA);
* a planted wrong hit fails the probe's gate in either leg: it exits
  non-zero and writes no artifact; without a card it refuses to run.
"""

import ast
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils.config import Config as JaxConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
try:
    import probe_msmarco_torch as P
finally:
    sys.path.remove(ROOT)
cs = P.cs

SMALL = dict(n_docs=6_000, vocab=5_000, avg_len=55, commit_every=500,
             gen_chunk=2_500)
RTOL = 1e-6


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py as a module, imported by path; its import-time
    environment defaults (a JAX compile cache in the repo) are undone."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench_msmarco", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.environ.clear()
    os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def drawn():
    corpus, queries, _secs = P.make_corpus(0, SMALL)
    return corpus, queries


class _Event:
    """A CUDA event on the host clock."""

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class _Stream:
    def synchronize(self):
        pass


@pytest.fixture
def no_card(monkeypatch):
    """The probe's card calls (synchronize, memory counters, events) as
    no-ops on the host, so its legs run on ``device="cpu"``."""
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    # the legs' clean check counts fallback-served requests since the last
    # check: start from this process's count (other tests' engines share
    # the metrics registry; the probe runs in a process of its own)
    saved = cs._FALLBACK_SERVED[0]
    cs._FALLBACK_SERVED[0] = cs.metric("compute_fallback_served")
    yield
    cs._FALLBACK_SERVED[0] = saved


def assert_same_hits(got, want, rtol=RTOL):
    """Port hits against JAX hits query by query: scores within ``rtol``
    rank by rank, a different name at a rank only inside a near-tie group
    (the JAX side scores the port's name within ``rtol`` of that rank's,
    or the rank sits in the tie group the top-k cut). Returns the number
    of such swaps."""
    assert len(got) == len(want)
    swaps = 0
    for g, w in zip(got, want):
        assert len(g) == len(w), (g, w)
        gs = np.asarray([h.score for h in g])
        ws = np.asarray([h.score for h in w])
        np.testing.assert_allclose(gs, ws, rtol=rtol)
        wmap = {h.name: h.score for h in w}
        for a, b in zip(g, w):
            if a.name != b.name:
                other = wmap.get(a.name, ws[-1])
                assert abs(other - b.score) <= rtol * abs(b.score), (g, w)
                swaps += 1
    return swaps


def _jax_feed(engine, corpus, commit_every: int) -> None:
    """The probe's add_document_arrays loop on a JAX engine."""
    offsets, ids, tfs, lengths = corpus
    n = offsets.shape[0] - 1
    for i in range(n):
        lo, hi = offsets[i], offsets[i + 1]
        engine.index.add_document_arrays(f"d{i}", ids[lo:hi], tfs[lo:hi],
                                         float(lengths[i]))
        if commit_every and ((i + 1) % commit_every == 0 or i + 1 == n):
            engine.commit()


def _jax_engine(tmp_path, vocab: int, **cfg):
    engine = JaxEngine(JaxConfig(documents_path=str(tmp_path / "jd"),
                                 index_path=str(tmp_path / "ji"),
                                 embedding_enabled=False, **cfg))
    for i in range(vocab):
        engine.vocab.add(f"t{i}")
    return engine


# --------------------------------------------------------------------------
# the corpus: the root bench's draws, probe_msmarco.py's shape
# --------------------------------------------------------------------------

def test_corpus_is_the_root_bench_draw(jax_bench, drawn):
    corpus, queries = drawn
    rng = np.random.default_rng(0)
    parts = [jax_bench.make_doc_arrays(rng, min(2_500, 6_000 - lo), 5_000,
                                       55) for lo in range(0, 6_000, 2_500)]
    base = np.cumsum([0] + [int(p[0][-1]) for p in parts[:-1]])
    want = (np.concatenate([[0]] + [p[0][1:] + b
                                    for p, b in zip(parts, base)]),
            np.concatenate([p[1] for p in parts]),
            np.concatenate([p[2] for p in parts]),
            np.concatenate([p[3] for p in parts]))
    for got, exp in zip(corpus, want):
        assert got.dtype == exp.dtype and got.tobytes() == exp.tobytes()
    assert queries == jax_bench.make_queries(
        rng, 5_000, 512 * (cs.NS_BATCHES + 3))
    assert len(P.split_queries(queries)[1]) == 512 * cs.NS_BATCHES


def test_named_shape_is_probe_msmarco_s(jax_bench):
    """8.8M passages, average length 55, a commit every 50,000 and 1M-doc
    generation chunks as ``probe_msmarco.py`` (read, not imported: it
    imports the JAX package), over the bench's 500k vocabulary."""
    tree = ast.parse(open(os.path.join(ROOT, "probe_msmarco.py")).read())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name):
            v = node.value
            if isinstance(v, ast.Call) and v.args \
                    and isinstance(v.args[0], ast.Call):
                v = v.args[0].args[1]   # int(os.environ.get(k, default))
            try:
                consts[node.targets[0].id] = ast.literal_eval(v)
            except ValueError:
                pass
    assert (P.SHAPE["n_docs"], P.SHAPE["avg_len"], P.SHAPE["commit_every"],
            P.SHAPE["gen_chunk"], P.SHAPE["vocab"]) == (
        consts["N_DOCS"], consts["AVG_LEN"], consts["COMMIT_EVERY"],
        consts["GEN_CHUNK"], jax_bench.NS_VOCAB) == (
        8_800_000, 55, 50_000, 1_000_000, 500_000)


# --------------------------------------------------------------------------
# the legs against the JAX package
# --------------------------------------------------------------------------

def _jax_quiesce(je) -> None:
    for _ in range(32):
        je.index.wait_for_merges()
        je.commit()
        if len(je.index._segments) <= je.config.max_segments \
                and je.index._merge_future is None:
            break


def test_stream_leg_matches_jax_segments(no_card, drawn, tmp_path):
    corpus, queries = drawn
    res, ctx = P.stream_leg(corpus, queries, 0, SMALL, str(tmp_path / "w"),
                            device="cpu")
    served = P.split_queries(queries)[1][:512]
    assert res["oracle"]["queries"] == 512
    assert res["commits"] == 12 and res["deleted"] == 60
    je = _jax_engine(tmp_path, 5_000, index_mode="segments",
                     query_batch=cs.ST_BATCH)
    _jax_feed(je, corpus, 500)
    _jax_quiesce(je)              # the quiesce, as stream_phase does it
    for d in ctx["deleted"].tolist():
        assert je.delete(f"d{d}")
    f_off, f_ids, f_tfs, f_len = ctx["fresh"]
    for j, d in enumerate(ctx["upserted"].tolist()):
        je.index.add_document_arrays(f"d{d}", f_ids[f_off[j]:f_off[j + 1]],
                                     f_tfs[f_off[j]:f_off[j + 1]],
                                     float(f_len[j]))
    je.commit()
    _jax_quiesce(je)              # and again after the mutation
    port = ctx["engine"].index.snapshot
    assert len(je.index.snapshot.segments) == len(port.segments)
    assert je.index.snapshot.n_docs_f == port.n_docs_f
    want = je.search_batch(served, k=cs.TOP_K)
    swaps = assert_same_hits(ctx["hits"], want)
    assert swaps <= 0.01 * sum(len(h) for h in want)


def test_stream_phase_serves_the_state_it_leaves(no_card, drawn,
                                                 monkeypatch):
    """The merges that the mutation's commit starts are published before
    8a serves: with one segment allowed and every merge in the
    background, that commit always leaves a merge in flight, whose splice
    reclaims the tombstones from df, N and avgdl. The engine that 8a
    hands to 8b (which saves it and holds the restored copy's hits to
    8a's to the bit) must answer as 8a served, once every merge is in."""
    import functools
    import tfidf_tpu_torch.utils.config as config_mod
    monkeypatch.setattr(config_mod, "Config", functools.partial(
        config_mod.Config, max_segments=1, sync_merge_nnz=0))
    corpus, queries = drawn
    served = P.split_queries(queries)[1]
    _res, ctx = cs.stream_phase(
        {"corpus": cs.first_docs(corpus, 2_000), "queries": served}, 0,
        commit_every=SMALL["commit_every"], vocab=SMALL["vocab"],
        avg_len=SMALL["avg_len"], device="cpu")
    engine = ctx["engine"]
    assert engine.config.max_segments == 1
    engine.index.wait_for_merges()
    engine.commit()
    assert len(engine.index.snapshot.segments) == 1
    again = engine.search_batch(served[:cs.ST_QUERIES], k=cs.TOP_K)
    assert cs._hits_key(again) == cs._hits_key(ctx["hits"])


def test_rebuild_leg_matches_jax_default(no_card, drawn, tmp_path):
    corpus, queries = drawn
    res, ctx = P.rebuild_leg(corpus, queries, SMALL, device="cpu")
    assert res["oracle"]["queries"] == 512 and res["launches"] == {
        "v4": 0, "v3": 0}
    served = P.split_queries(queries)[1]
    je = _jax_engine(tmp_path, 5_000, query_batch=512)
    assert (je.config.index_mode, je.config.scoring_layout) == (
        "rebuild", "ell")
    _jax_feed(je, corpus, 0)
    je.commit()
    want = je.search_batch(served, k=cs.TOP_K)
    swaps = assert_same_hits(ctx["hits"], want)
    assert swaps <= 0.01 * sum(len(h) for h in want)


def test_held_blocks_are_the_widest_largest_and_shortest(no_card, drawn):
    """The rebuild leg's bounded bitwise check (``check_held_blocks``):
    the widest, the largest and the shortest eligible block of the
    batch, each held once (off the card the kernel's wrapper runs its
    plain version, so this holds the choice and the record)."""
    corpus, queries = drawn
    _res, ctx = P.rebuild_leg(corpus, queries, SMALL, device="cpu")
    engine = ctx["engine"]
    qb, _ = engine.searcher._vectorize(P.split_queries(queries)[3][:512],
                                       512)
    _snap, _slot_of, _qc_t, blocks = cs.kernel_operands(engine, qb)
    held = P.check_held_blocks(engine, qb)
    idx = [h["block"] for h in held]
    assert idx == sorted(set(idx)) and len(idx) >= min(2, len(blocks))
    widths = [b[0].shape[0] for b in blocks]
    assert max(widths) in [h["width"] for h in held]
    assert min(b[2] for b in blocks) in [h["live_rows"] for h in held]
    for h in held:
        imp_t, _t, n, _row0 = blocks[h["block"]]
        assert (h["width"], h["rows_cap"], h["live_rows"]) == (
            imp_t.shape[0], imp_t.shape[1], n)


# --------------------------------------------------------------------------
# the gates
# --------------------------------------------------------------------------

@pytest.fixture
def planted(monkeypatch):
    """Every fetched top-k has its first query's first and last ids
    swapped (values kept): a wrong hit at rank 1, consistent between
    ``search_batch`` and ``search_batch_arrays``."""
    from tfidf_tpu_torch.engine import searcher
    real = searcher.fetch_packed

    def fetch(packed):
        arr = np.array(real(packed))
        k = arr.shape[-1] // 2
        arr[0, k], arr[0, 2 * k - 1] = arr[0, 2 * k - 1], arr[0, k]
        return arr

    monkeypatch.setattr(searcher, "fetch_packed", fetch)


@pytest.mark.parametrize("leg", ["stream", "rebuild"])
def test_planted_wrong_hit_exits_nonzero_with_no_artifact(
        no_card, planted, tmp_path, leg):
    out = tmp_path / "out"
    with pytest.raises((SystemExit, AssertionError)) as err:
        P.main(["--leg", leg, "--out", str(out), "--work",
                str(tmp_path / "w")], device="cpu", shape=SMALL)
    if isinstance(err.value, SystemExit):
        assert err.value.code not in (0, None)
    assert "query 0" in str(err.value)
    assert not (out / "msmarco.json").exists()


def test_both_legs_write_the_record(no_card, tmp_path):
    out = tmp_path / "out"
    shape = dict(SMALL, n_docs=3_000)
    assert P.main(["--leg", "both", "--out", str(out), "--work",
                   str(tmp_path / "w")], device="cpu", shape=shape) == 0
    import json
    rec = json.loads((out / "msmarco.json").read_text())
    assert rec["corpus"]["docs"] == 3_000 and rec["shape"] == shape
    for leg in ("stream", "rebuild"):
        assert rec[leg]["oracle"]["queries"] == 512
    split = rec["stream"]["commit_ms_split"]
    assert split["alone"]["commits"] + split["merge_inflight"]["commits"] \
        == rec["stream"]["commits"] - 1
    assert not (tmp_path / "w").exists()


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is not reachable")
    r = subprocess.run([sys.executable, "probe_msmarco_torch.py", "--out",
                        str(tmp_path / "out")], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 2, r.stderr[-2000:]
    assert "CUDA is not available" in r.stderr
    assert not (tmp_path / "out").exists()
