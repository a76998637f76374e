"""The port's Engine as a worker: the durable upload path on the CPU, and a
mixed fleet in which the JAX package's ``SearchNode`` hosts it.

Tolerances, with their reasons:

* durable uploads: the port and the JAX engine ingest the same bytes and
  serve the same top-10 ids; scores within rel 1e-6 (each package
  computes its own impacts: log1p and division may differ by an ulp);
* the mixed fleet: with ``replication_factor=2`` over two workers every
  worker holds the whole corpus, so the owner-merged ``/leader/start``
  map equals the naive f64 BM25 of ``tests/oracle.py`` within rel 1e-5
  (f32 scoring), whichever worker owns a document;
* the JAX node's ``/admin/checkpoint`` of the port worker, loaded back by
  the port: the same hits to the bit (the snapshot arrays round-trip);
* the dense plane in the mixed fleet: ``mode=dense`` and ``mode=hybrid``
  replies equal the single-node JAX oracle of ``tests/test_hybrid.py``
  within rel 1e-5, before and after either worker's data plane dies; a
  staged failover slice answered by the port worker (its
  ``search_dense_names``) equals the JAX worker's: dense scores to the bit
  (both are host numpy dots over the same vectors), sparse within rel
  1e-6.
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.oracle import bm25_scores
from tests.test_hybrid import DOCS as HYBRID_DOCS
from tests.test_hybrid import QUERIES as HYBRID_QUERIES
from tests.test_hybrid import (_assert_parity, _hybrid_oracle,
                               _kill_data_plane, _post_search)
from tests.test_torch_engine import _assert_same_hits
from tfidf_tpu.cluster.coordination import (CoordinationCore,
                                            LocalCoordination)
from tfidf_tpu.cluster.node import SearchNode, http_post
from tfidf_tpu.cluster.wire import unpack_hit_lists
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.ops.analyzer import Analyzer as JaxAnalyzer
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine.checkpoint import load_checkpoint
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.ops.analyzer import UnsupportedMediaType
from tfidf_tpu_torch.utils import storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import global_device_nemesis
from tfidf_tpu_torch.utils.metrics import global_metrics

SMALL = dict(min_nnz_capacity=64, min_doc_capacity=8,
             min_vocab_capacity=32, embedding_enabled=False)
DOCS = {f"rp{i}.txt": f"common token{i} word{i % 3} extra{i % 5}"
        for i in range(12)}
QUERIES = ["common", "token3 word0", "word1 extra2", "common token7"]


def _engines(tmp_path, **kw):
    cfg = dict(SMALL, **kw)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False,
                                    documents_path=str(tmp_path / "j"))))
    te = Engine(Config(**dict(cfg, documents_path=str(tmp_path / "t"))),
                device="cpu")
    return je, te


def test_ingest_bytes_durable_matches_jax_engine(tmp_path):
    je, te = _engines(tmp_path)
    fsyncs = global_metrics.get("storage_group_commit_items")
    for e in (je, te):
        for name, text in DOCS.items():
            e.ingest_bytes(os.path.join("sub", name), text.encode(),
                           save_to_disk=True)
        e.ingest_bytes("latin.txt", "café common".encode("latin-1"),
                       save_to_disk=True)
        e.commit()
    # fsync-before-ack: one group-commit item for the temp file and one
    # for its directory, per upload
    assert global_metrics.get("storage_group_commit_items") \
        >= fsyncs + 2 * (len(DOCS) + 1)
    _assert_same_hits(te.search_batch(QUERIES), je.search_batch(QUERIES))
    assert te.open_document("latin.txt") == je.open_document("latin.txt")
    f, size = te.open_document_stream(os.path.join("sub", "rp3.txt"))
    with f:
        assert f.read() == DOCS["rp3.txt"].encode() and size == len(
            DOCS["rp3.txt"])
    assert te.open_document("missing.txt") is None
    assert sorted(te.document_names()) == sorted(je.document_names())
    assert te.index_size_bytes() == je.index_size_bytes()
    assert te.tier_stats() == je.tier_stats() == {"enabled": False}
    # the durable files rebuild the same index (in walk order, so the
    # term ids and each score's association may differ: rel 1e-6)
    te2 = Engine(te.config, device="cpu")
    assert te2.build_from_directory() == len(DOCS) + 1
    for a, b in zip(te2.search_batch(QUERIES, k=20),
                    te.search_batch(QUERIES, k=20)):
        assert dict(a).keys() == dict(b).keys()
        for name, score in a:
            assert score == pytest.approx(dict(b)[name], rel=1e-6)


def test_stage_publish_discard_and_remove(tmp_path):
    _je, te = _engines(tmp_path)
    staged = [(n, *te.stage_bytes(n, t.encode())) for n, t in DOCS.items()]
    assert not te.document_names()          # nothing indexed yet
    storage.global_committer.sync([s[1] for s in staged])
    for name, tmp, path, text in staged[:-1]:
        te.publish_staged(name, tmp, path, text)
    te.discard_staged(staged[-1][1])
    te.commit()
    assert len(te.document_names()) == len(DOCS) - 1
    assert not [n for n in os.listdir(te.config.documents_path)
                if n.endswith(".part")]
    assert te.remove_document("rp0.txt")
    assert not os.path.exists(os.path.join(te.config.documents_path,
                                           "rp0.txt"))
    te.commit()
    assert "rp0.txt" not in [h.name for h in te.search("common", k=20)]
    with pytest.raises(PermissionError):
        te.open_document("../../etc/passwd")
    with pytest.raises(UnsupportedMediaType):
        te.ingest_bytes("blob.bin", b"\x00\x01\x02binary\xff" * 10,
                        save_to_disk=True)
    assert not os.path.exists(os.path.join(te.config.documents_path,
                                           "blob.bin"))


def test_torn_upload_leaves_no_file_and_no_index_entry(tmp_path):
    _je, te = _engines(tmp_path)
    te.ingest_bytes("a.txt", b"old content", save_to_disk=True)
    storage.global_storage.arm(storage.TORN_WRITE, "*a.txt*",
                               keep_bytes=2)
    try:
        with pytest.raises(storage.DiskFault):
            te.ingest_bytes("a.txt", b"new content", save_to_disk=True)
    finally:
        storage.global_storage.heal()
    assert te.open_document("a.txt") == b"old content"
    te.commit()
    assert te.search("new") == [] and te.search("old")


# ---------------------------------------------------------------------------
# a mixed fleet: JAX leader, JAX worker, port worker
# ---------------------------------------------------------------------------

@pytest.fixture
def core():
    c = CoordinationCore(session_timeout_s=0.5)
    yield c
    c.close()


def _node_cfg(tmp_path, tag, embedding_enabled=False):
    return JaxConfig(documents_path=str(tmp_path / tag / "docs"),
                     index_path=str(tmp_path / tag / "index"), port=0,
                     min_doc_capacity=64, min_nnz_capacity=1 << 12,
                     min_vocab_capacity=1 << 10, query_batch=8,
                     max_query_terms=8, use_pallas=False, top_k=32,
                     replication_factor=2, result_cache_entries=0,
                     router_cache_entries=0,
                     embedding_enabled=embedding_enabled)


def _post(base, path, obj):
    req = urllib.request.Request(base + path, data=json.dumps(obj).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _oracle(query):
    """Naive f64 BM25 over the whole corpus (tests/oracle.py)."""
    a = JaxAnalyzer()
    ids: dict[str, int] = {}
    docs, lengths = [], []
    for text in DOCS.values():
        counts = a.counts(text)
        docs.append({ids.setdefault(t, len(ids)): c
                     for t, c in counts.items()})
        lengths.append(float(sum(counts.values())))
    q = {ids[t]: float(c) for t, c in a.counts(query).items() if t in ids}
    return {n: s for n, s in zip(DOCS, bm25_scores(docs, lengths, q))
            if s > 0}


def test_mixed_fleet_upload_search_checkpoint_degraded(core, tmp_path):
    leader = SearchNode(_node_cfg(tmp_path, "leader"),
                        coord=LocalCoordination(core, 0.1)).start()
    nodes = [leader]
    try:
        nodes.append(SearchNode(_node_cfg(tmp_path, "ref"),
                                coord=LocalCoordination(core, 0.1)).start())
        pcfg = _node_cfg(tmp_path, "port")
        port_engine = Engine(Config(
            documents_path=pcfg.documents_path,
            index_path=pcfg.index_path, min_doc_capacity=64,
            min_nnz_capacity=1 << 12, min_vocab_capacity=1 << 10,
            query_batch=8, max_query_terms=8, top_k=32,
            embedding_enabled=False, compute_sick_after=2,
            compute_probe_interval_s=3600.0), device="cpu")
        port = SearchNode(pcfg, coord=LocalCoordination(core, 0.1),
                          engine=port_engine).start()
        nodes.append(port)
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and len(
                leader.registry.get_all_service_addresses()) < 2:
            time.sleep(0.02)
        assert port.url in leader.registry.get_all_service_addresses()

        st, _, resp = _post(leader.url, "/leader/upload-batch",
                            [{"name": n, "text": t}
                             for n, t in DOCS.items()])
        assert st == 200 and sorted(resp["placed"].values()) == [12, 12]
        assert sorted(port_engine.document_names()) == sorted(DOCS)
        assert sorted(os.listdir(pcfg.documents_path)) == sorted(DOCS)

        served = global_metrics.get("queries_served")
        baseline = {}
        for q in QUERIES:
            st, hd, got = _post(leader.url, "/leader/start", {"query": q})
            assert st == 200 and "X-Compute-Degraded" not in hd
            want = _oracle(q)
            assert set(got) == set(want), q
            for name, score in want.items():
                assert got[name] == pytest.approx(score, rel=1e-5)
            baseline[q] = got
        # the port worker took part in the scatter
        assert global_metrics.get("queries_served") > served

        # the JAX node checkpoints the port engine; the port loads it
        ck = json.loads(http_post(port.url + "/admin/checkpoint", b"{}"))
        assert ck["docs"] == len(DOCS)
        restored = load_checkpoint(ck["dir"], port_engine.config,
                                   device="cpu")
        assert restored.search_batch(QUERIES) \
            == port_engine.search_batch(QUERIES)

        # the port's nemesis makes the port worker serve from its host
        # mirror: the reply is stamped degraded and equals the baseline
        global_device_nemesis.script("score_ell:transient")
        try:
            st, hd, got = _post(leader.url, "/leader/start",
                                {"query": "common"})
        finally:
            global_device_nemesis.clear()
        assert st == 200 and hd.get("X-Compute-Degraded") == "1"
        assert got == baseline["common"]
        assert port_engine.compute_stats()["total_faults"] >= 1
        port_engine.compute.note_success()
        st, hd, got = _post(leader.url, "/leader/start",
                            {"query": "common"})
        assert st == 200 and "X-Compute-Degraded" not in hd
        assert got == baseline["common"]
    finally:
        for n in reversed(nodes):
            try:
                n.stop()
            except Exception:
                pass
    assert np.isfinite(list(baseline["common"].values())).all()


def _port_engine(pcfg, **kw):
    return Engine(Config(
        documents_path=pcfg.documents_path, index_path=pcfg.index_path,
        min_doc_capacity=64, min_nnz_capacity=1 << 12,
        min_vocab_capacity=1 << 10, query_batch=8, max_query_terms=8,
        top_k=32, **kw), device="cpu")


def _fleet(core, tmp_path, **port_kw):
    """JAX leader, JAX worker, port worker (replication 2: each worker
    holds the whole corpus), all with the dense plane on."""
    nodes = [SearchNode(_node_cfg(tmp_path, tag, embedding_enabled=True),
                        coord=LocalCoordination(core, 0.1)).start()
             for tag in ("leader", "ref")]
    pcfg = _node_cfg(tmp_path, "port", embedding_enabled=True)
    port_engine = _port_engine(pcfg, **port_kw)
    nodes.append(SearchNode(pcfg, coord=LocalCoordination(core, 0.1),
                            engine=port_engine).start())
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and len(
            nodes[0].registry.get_all_service_addresses()) < 2:
        time.sleep(0.02)
    return nodes, port_engine


PLANS = (("dense", None), ("hybrid", "rrf"), ("hybrid", "wsum"))


@pytest.mark.parametrize("victim", ["port", "jax"])
def test_mixed_fleet_dense_and_hybrid_match_the_oracle(core, tmp_path,
                                                       victim):
    nodes, port_engine = _fleet(core, tmp_path)
    try:
        leader, ref, port = nodes
        assert port_engine.dense is not None
        st, _, resp = _post(leader.url, "/leader/upload-batch",
                            [{"name": n, "text": t}
                             for n, t in HYBRID_DOCS.items()])
        assert st == 200 and sorted(resp["placed"].values()) == [12, 12]
        assert port_engine.dense_stats()["docs"] == len(HYBRID_DOCS)
        want = {(m, f): _hybrid_oracle(tmp_path, f"oracle-{m}-{f}", m,
                                       f or "rrf")
                for m, f in PLANS}
        calls = {"batch": 0, "names": 0}
        for name in ("batch", "names"):
            fn = getattr(port_engine, f"search_dense_{name}")

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)
            setattr(port_engine, f"search_dense_{name}", counted)

        def check(ctx):
            for m, f in PLANS:
                for q in HYBRID_QUERIES:
                    got, hd = _post_search(leader, q, mode=m, method=f)
                    _assert_parity(got, want[(m, f)][q],
                                   ctx=f"{ctx}:{m}:{f}:{q}")
                    assert "X-Scatter-Degraded" not in hd
                    assert "X-Compute-Degraded" not in hd

        check("healthy")
        assert calls["batch"] > 0          # the port worker served dense

        # a staged failover slice on each worker: the port's
        # search_dense_names against the JAX engine's
        names = sorted(HYBRID_DOCS)[1::2]
        body = json.dumps({"queries": HYBRID_QUERIES, "names": names,
                           "mode": "hybrid"}).encode()
        n = len(HYBRID_QUERIES)
        got = unpack_hit_lists(http_post(port.url + "/worker/process-batch",
                                         body))
        exp = unpack_hit_lists(http_post(ref.url + "/worker/process-batch",
                                         body))
        assert len(got) == len(exp) == 2 * n and calls["names"] == 1
        assert got[n:] == exp[n:] and any(got[n:])
        for g, e in zip(got[:n], exp[:n]):
            assert [h[0] for h in g] == [h[0] for h in e]
            for (_, a), (_, b) in zip(g, e):
                assert a == pytest.approx(b, rel=1e-6)

        _kill_data_plane(port if victim == "port" else ref)
        before = dict(calls)
        for _ in range(2):
            check(f"{victim} killed")
        if victim == "jax":
            assert calls["batch"] + calls["names"] > sum(before.values())
    finally:
        for nd in reversed(nodes):
            try:
                nd.stop()
            except Exception:
                pass
