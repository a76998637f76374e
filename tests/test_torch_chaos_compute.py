"""The compute plane under chaos, against the port's own processes.

A port of ``tests/test_compute_chaos.py``'s cluster tests and its slow
chaos job, plus the helpers the other ``tests/test_torch_chaos_*.py`` jobs
share:

* ``TestClusterComputePlane`` (tier-1): the JAX file's in-process
  ``TestClusterComputePlane`` run step by step on a JAX cluster and on a
  cluster of port ``SearchNode``\\ s (``device="cpu"``), each step's
  status, stamps and quarantine verdict equal between the packages and
  every reply held to the JAX package's per-owner oracle (rel 1e-5);
* ``TestChaosReplyClassifier`` (tier-1): ``chip_smoke.classify_reply``,
  phase 13's verdict on each reply, on one seeded case per verdict, and
  its two refusals;
* ``TestFleetBarrier`` (tier-1): ``bench_modes._start_cluster``'s ready
  barrier holds through a worker whose first ``/worker/index-size`` poll
  fails, ``_hold_index_bytes`` refuses an upload the leader routed past a
  worker whose size poll it lost, and ``_spawn_routers`` starts a router
  again when its port was taken;
* ``TestChaosCompute`` (``slow``): the JAX job as ``python -m
  tfidf_tpu_torch`` processes, its environment values, schedule, client
  threads and assertions, the baseline first held to the JAX package's
  per-owner oracle.

Node processes run with a stub directory first on ``PYTHONPATH`` that
makes ``jax`` and ``tfidf_tpu`` unimportable (``chaos_env``); the
process plumbing is ``tfidf_tpu_torch.bench_modes``' (``_spawn``,
``_start_cluster``) and ``tfidf_tpu_torch.bench``'s (``_wait_until``,
``_kill_all``).
"""

import json
import os
import random
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_cluster import wait_until
from tests.test_compute_chaos import CORPUS, POISON_Q, _post_full
from tfidf_tpu.cluster.coordination import CoordinationCore as JaxCore
from tfidf_tpu.cluster.coordination import LocalCoordination as JaxLocal
from tfidf_tpu.cluster.node import SearchNode as JaxNode
from tfidf_tpu.cluster.quarantine import poison_fingerprint as jax_fp
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu.utils.device_nemesis import \
    global_device_nemesis as jax_nemesis
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _kill_all, _wait_until
from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  CoordinationCore,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.node import SearchNode, http_get, http_post
from tfidf_tpu_torch.cluster.placement import PLACEMENT_STATE
from tfidf_tpu_torch.cluster.quarantine import poison_fingerprint
from tfidf_tpu_torch.cluster.resilience import RpcStatusError, is_retryable
from tfidf_tpu_torch.engine.compute_health import HEALTHY
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import (DeviceTransientError,
                                                  global_device_nemesis)
from tfidf_tpu_torch.utils.faults import global_injector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KEYS = ("top_k", "min_doc_capacity", "min_nnz_capacity",
               "min_vocab_capacity", "query_batch", "max_query_terms",
               "use_pallas")


@pytest.fixture(autouse=True)
def _clean_nemeses():
    """Both packages' nemeses are process-global: clear them around each
    test, as the JAX file does for its own."""
    global_device_nemesis.clear()
    jax_nemesis.clear()
    yield
    global_device_nemesis.clear()
    jax_nemesis.clear()
    global_injector.disarm()


# ---------------------------------------------------------------------------
# helpers shared by the chaos jobs
# ---------------------------------------------------------------------------

def chaos_env(tmp, values: dict) -> dict:
    """The environment of a port node process: stub ``jax`` and
    ``tfidf_tpu`` packages that raise on import first on ``PYTHONPATH``,
    then the repository; the engine on the CPU, one host thread, no
    ``TFIDF_*`` inherited but the job's ``values``. Fails unless the
    stubs really block both packages."""
    stub = os.path.join(str(tmp), "blocked")
    for pkg in ("jax", "tfidf_tpu"):
        os.makedirs(os.path.join(stub, pkg), exist_ok=True)
        with open(os.path.join(stub, pkg, "__init__.py"), "w") as f:
            f.write(f"raise ImportError('{pkg} is blocked here')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TFIDF_")}
    env["PYTHONPATH"] = os.pathsep.join([stub, ROOT])
    env["OMP_NUM_THREADS"] = "1"
    env["TFIDF_DEVICE"] = "cpu"
    env.update(values)
    probe = subprocess.run(
        [sys.executable, "-c", "import importlib, sys\n"
         "for m in ('jax', 'tfidf_tpu'):\n"
         "    try:\n        importlib.import_module(m)\n"
         "    except ImportError:\n        continue\n"
         "    sys.exit(m + ' imported')\n"
         "import tfidf_tpu_torch.cli"], env=env, cwd=stub,
        capture_output=True, text=True, timeout=120)
    assert probe.returncode == 0, probe.stderr
    return env


def placement_of(coord_port: int) -> dict:
    """The leader's durable placement map (name -> replicas, owner
    first), read from the coordination service."""
    c = CoordinationClient(f"127.0.0.1:{coord_port}")
    try:
        return json.loads(c.get_data(PLACEMENT_STATE).decode())["replicas"]
    finally:
        c.close()


def owner_oracle(root, docs: dict, replicas: dict, queries, **cfg) -> dict:
    """The JAX package's single-node oracle, sharded as the fleet is: one
    JAX ``Engine`` a worker over the documents it holds, each document
    scored by its owner (its first replica) with that worker's
    statistics, merged by (-score, name) to ``top_k``. With R equal to
    the worker count this is the single-node oracle itself."""
    workers = sorted({w for ws in replicas.values() for w in ws})
    engines = {}
    for i, w in enumerate(workers):
        e = JaxEngine(JaxConfig(
            documents_path=str(root / f"oracle{i}" / "docs"),
            index_path=str(root / f"oracle{i}" / "index"), **cfg))
        for name, text in docs.items():
            if w in replicas.get(name, ()):
                e.ingest_text(name, text)
        e.commit()
        engines[w] = e
    k = cfg.get("top_k", JaxConfig().top_k)
    out = {}
    for q in queries:
        merged = {}
        for w, e in engines.items():
            for h in e.search(q, k=len(docs)):
                if replicas[h.name][0] == w:
                    merged[h.name] = float(h.score)
        out[q] = dict(sorted(merged.items(),
                             key=lambda t: (-t[1], t[0]))[:k])
    return out


def assert_parity(got: dict, want: dict, ctx=""):
    assert set(got) == set(want), (
        f"{ctx}: missing={set(want) - set(got)} "
        f"extra={set(got) - set(want)}")
    for n, s in want.items():
        assert got[n] == pytest.approx(s, rel=1e-5), (ctx, n, got[n], s)


# ---------------------------------------------------------------------------
# tier-1: the JAX file's in-process cluster tests, both packages
# ---------------------------------------------------------------------------

# the JAX file's compute_cluster fixture: leader + two workers, R=1
CLUSTER_CFG = dict(min_doc_capacity=64, min_nnz_capacity=1 << 12,
                   min_vocab_capacity=1 << 10, query_batch=8,
                   max_query_terms=8, use_pallas=False,
                   replication_factor=1, result_order="name",
                   result_cache_entries=0, router_cache_entries=0,
                   compute_sick_after=2, compute_probe_interval_s=3600.0,
                   poison_quarantine_after=2)


def _cluster(pkg: str, root):
    """Three nodes of ``pkg`` ("jax" or "port") in this process, the
    port's on the CPU; returns (nodes, their coordination core)."""
    core = (JaxCore if pkg == "jax" else CoordinationCore)(
        session_timeout_s=0.5)
    nodes = []
    for i in range(3):
        kw = dict(documents_path=str(root / f"{pkg}{i}" / "docs"),
                  index_path=str(root / f"{pkg}{i}" / "index"), port=0,
                  **CLUSTER_CFG)
        if pkg == "jax":
            n = JaxNode(JaxConfig(**kw), coord=JaxLocal(core, 0.1))
        else:
            n = SearchNode(Config(**kw), coord=LocalCoordination(core, 0.1),
                           device="cpu")
        nodes.append(n.start())
    assert wait_until(lambda: len(
        nodes[0].registry.get_all_service_addresses()) == 2, timeout=10.0)
    return nodes, core


def _stop(nodes, core):
    for n in nodes:
        try:
            n.stop()
        except Exception:
            pass
    core.close()


def _upload(leader, docs):
    http_post(leader.url + "/leader/upload-batch", json.dumps(
        [{"name": n, "text": t} for n, t in docs.items()]).encode())


def _send(leader, q):
    st, hd, body = _post_full(leader.url, "/leader/start",
                              json.dumps({"query": q}).encode())
    return st, hd, json.loads(body) if body else None


def _cluster_oracle(leader, root, docs, queries):
    with leader._placement_lock:
        replicas = {n: list(ws) for n, ws in leader._placement.items()}
    return owner_oracle(root, docs, replicas, queries, **{
        k: v for k, v in CLUSTER_CFG.items() if k in ENGINE_KEYS})


def _make_sick(pkg, worker):
    """Two compute faults on one worker (``compute_sick_after=2``): the
    JAX test injects them as state; the port's host mirror serves only
    faults the device nemesis injected, so the port's are injected
    faults."""
    for _ in range(2):
        if pkg == "jax":
            worker.engine.compute.note_fault("transient")
        else:
            worker.engine._note_fault(DeviceTransientError("score_ell"),
                                      "transient")


def _degraded_steps(pkg, root):
    """``test_degraded_worker_stamps_end_to_end``'s steps on ``pkg``:
    (per step: status, X-Compute-Degraded, reply), the oracle."""
    nodes, core = _cluster(pkg, root)
    try:
        leader, w1, _ = nodes
        _upload(leader, CORPUS)
        want = _cluster_oracle(leader, root / f"o-{pkg}", CORPUS,
                               ["fast"])["fast"]
        steps = [_send(leader, "fast")]
        _make_sick(pkg, w1)
        steps.append(_send(leader, "fast"))
        w1.engine.compute.note_success()
        steps.append(_send(leader, "fast"))
        return [(st, hd.get("X-Compute-Degraded"), got)
                for st, hd, got in steps], want
    finally:
        _stop(nodes, core)


def _poison_steps(pkg, root):
    """``test_poison_quarantine_front_door_422``'s steps on ``pkg``."""
    nodes, core = _cluster(pkg, root)
    nemesis = jax_nemesis if pkg == "jax" else global_device_nemesis
    fp_of = jax_fp if pkg == "jax" else poison_fingerprint
    try:
        leader, w1, w2 = nodes
        docs = {f"p{i}.txt": f"alpha beta tok{i}" for i in range(6)}
        _upload(leader, docs)
        want = _cluster_oracle(leader, root / f"o-{pkg}", docs,
                               [POISON_Q, "tok1"])
        fp = fp_of(POISON_Q, "sparse")
        nemesis.script("score_ell:poison:1.0:min_uniq=2")
        first = _send(leader, POISON_Q)
        snap = json.loads(http_get(leader.url + "/api/quarantine"))
        second = _send(leader, POISON_Q)
        innocent = _send(leader, "tok1")
        states = [w.engine.compute_stats()["state"] for w in (w1, w2)]
        nemesis.clear()
        cleared = json.loads(http_post(leader.url + "/api/quarantine",
                                       b"{}"))
        after = _send(leader, POISON_Q)
        return {"fp": fp, "first": first[0],
                "quarantined": [e["fingerprint"]
                                for e in snap["quarantined"]],
                "replicas": [len(e["replicas"])
                             for e in snap["quarantined"]],
                "second": (second[0], second[1].get("X-Poison-Quarantined"),
                           second[2]["fingerprint"],
                           second[2]["retry_after_s"] > 0),
                "innocent": (innocent[0],
                             innocent[1].get("X-Compute-Degraded"),
                             innocent[2]),
                "states": states, "cleared": cleared["cleared"],
                "after": (after[0], after[2])}, want
    finally:
        _stop(nodes, core)


class TestClusterComputePlane:
    def test_degraded_worker_stamps_end_to_end(self, tmp_path):
        ref, ref_want = _degraded_steps("jax", tmp_path)
        got, want = _degraded_steps("port", tmp_path)
        for steps, oracle in ((ref, ref_want), (got, want)):
            # the JAX test's assertions, step by step, on both packages
            (st0, d0, base), (st1, d1, sick), (st2, d2, healed) = steps
            assert st0 == 200 and d0 is None and base
            assert st1 == 200 and d1 == "1" and sick == base
            assert st2 == 200 and d2 is None and healed == base
            # and the baseline is the JAX package's per-owner oracle
            assert_parity(base, oracle, "fast")
        assert [s[:2] for s in got] == [s[:2] for s in ref]

    def test_poison_quarantine_front_door_422(self, tmp_path):
        ref, ref_want = _poison_steps("jax", tmp_path)
        got, want = _poison_steps("port", tmp_path)
        assert got["fp"] == ref["fp"]
        for r, oracle in ((ref, ref_want), (got, want)):
            assert r["quarantined"] == [r["fp"]] and r["replicas"] == [2]
            assert r["second"] == (422, r["fp"], r["fp"], True)
            st, stamp, body = r["innocent"]
            assert st == 200 and stamp is None
            assert_parity(body, oracle["tok1"], "tok1")
            assert r["states"] == [HEALTHY, HEALTHY]
            assert r["cleared"] == 1
            assert r["after"][0] == 200
            assert_parity(r["after"][1], oracle[POISON_Q], POISON_Q)
        assert got["first"] == ref["first"]
        assert not is_retryable(RpcStatusError("u", 422))


# ---------------------------------------------------------------------------
# tier-1: phase 13's reply classifier
# ---------------------------------------------------------------------------

def _chip_smoke():
    sys.path.insert(0, ROOT)
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def two_shards():
    """A seeded two-shard corpus, a query, the full oracle's top-k (the
    baseline a healthy fleet answers) and each shard's alone."""
    cs = _chip_smoke()
    from tfidf_tpu_torch.bench import make_doc_arrays, make_queries
    rng = np.random.default_rng(1311)
    vocab = 300
    corpus = make_doc_arrays(rng, 400, vocab, 20)
    mats = cs.sparse_mats(corpus, [{"lo": 0, "hi": 200},
                                   {"lo": 200, "hi": 400}], vocab)
    # a query whose top-k draws from both shards
    for q in make_queries(rng, vocab, 64):
        rows = cs.shard_scores(mats, q)
        tops = [cs.oracle_top(rows[i:i + 1]) for i in range(2)]
        full = cs.oracle_top(rows)
        if set(full) & set(tops[0]) and set(full) & set(tops[1]):
            break
    return cs, mats, q, full, tops


class TestChaosReplyClassifier:
    @pytest.mark.parametrize("case", ["exact", "compute_degraded",
                                      "degraded_compute",
                                      "degraded_scatter",
                                      "degraded_partial", "failed"])
    def test_one_seeded_case_per_verdict(self, two_shards, case):
        cs, mats, q, full, tops = two_shards
        partial = cs.shard_partial(mats, q, (0,))
        other = {n: s + 1.0 for n, s in full.items()}
        status, hdrs, got, check, want = {
            "exact": (200, {}, full, None, "exact"),
            "compute_degraded": (200, {"X-Compute-Degraded": "1"}, full,
                                 None, "compute_degraded"),
            "degraded_compute": (200, {"X-Compute-Degraded": "1"}, other,
                                 None, "degraded"),
            "degraded_scatter": (200, {"X-Scatter-Degraded": "x"}, other,
                                 None, "degraded"),
            "degraded_partial": (200, {"X-Scatter-Degraded": "x"}, tops[0],
                                 partial, "degraded"),
            "failed": (500, {}, None, partial, "failed"),
        }[case]
        assert cs.classify_reply(status, hdrs, got, full, check) == want

    def test_refuses_an_unmarked_non_parity_200(self, two_shards):
        cs, mats, q, full, tops = two_shards
        assert tops[0] != full
        with pytest.raises(SystemExit, match="unmarked"):
            cs.classify_reply(200, {}, tops[0], full)
        wrong = dict(full)
        wrong[next(iter(wrong))] *= 1.001
        with pytest.raises(SystemExit, match="unmarked"):
            cs.classify_reply(200, {}, wrong, full)

    def test_refuses_a_partial_that_is_not_the_live_shard(self,
                                                          two_shards):
        cs, mats, q, full, tops = two_shards
        partial = cs.shard_partial(mats, q, (0,))
        stamp = {"X-Scatter-Degraded": "attempted=2 responded=1"}
        # the dead shard's oracle, and the whole corpus's, are not an
        # honest partial of shard 0
        for wrong in (tops[1], full):
            with pytest.raises(SystemExit, match="live shards"):
                cs.classify_reply(200, stamp, wrong, full, partial)
        assert cs.classify_reply(200, stamp, tops[0], full,
                                 partial) == "degraded"


# ---------------------------------------------------------------------------
# tier-1: the fleet harness's ready barrier (bench_modes._start_cluster)
# ---------------------------------------------------------------------------

SMALL = {"TFIDF_MIN_DOC_CAPACITY": "64", "TFIDF_MIN_NNZ_CAPACITY": "4096",
         "TFIDF_MIN_VOCAB_CAPACITY": "1024", "TFIDF_QUERY_BATCH": "8",
         "TFIDF_MAX_QUERY_TERMS": "8", "TFIDF_EMBEDDING_ENABLED": "false"}
TEXTS = [f"common token{i} word{i % 3} extra{i % 5}" for i in range(16)]


class TestFleetBarrier:
    @pytest.mark.timeout(180)
    def test_barrier_holds_through_a_failed_first_poll(self, tmp_path,
                                                       monkeypatch):
        """A worker whose first ``/worker/index-size`` poll fails: the
        barrier polls it again and returns only once every worker has
        answered it and ``/api/health``; the upload then leaves index
        bytes on every worker."""
        env = chaos_env(tmp_path, SMALL)
        real, polls = bench_modes._http_get, []

        def flaky(url, timeout=10.0):
            if url.endswith("/worker/index-size"):
                polls.append(url)
                if polls.count(url) == 1 and url == polls[0]:
                    raise OSError("seeded: the first poll fails")
            return real(url, timeout)
        monkeypatch.setattr(bench_modes, "_http_get", flaky)
        procs: list = []
        try:
            _, ports, urls = bench_modes._start_cluster(
                procs, env, str(tmp_path), n_workers=2, timeout=120.0)
            seeded = polls[0]
            assert seeded in {u + "/worker/index-size" for u in urls[1:]}
            assert polls.count(seeded) >= 2
            assert {u + "/worker/index-size" for u in urls[1:]} \
                <= set(polls)
            from tfidf_tpu_torch.bench import _KeepAlive
            bench_modes._upload(_KeepAlive(), ("127.0.0.1", ports[0]),
                                TEXTS, len(TEXTS), urls[1:])
            assert all(bench_modes._hold_index_bytes(urls[1:]))
        finally:
            _kill_all(procs)

    @pytest.mark.timeout(180)
    def test_router_on_a_taken_port_starts_again(self, tmp_path,
                                                 monkeypatch):
        """``_spawn_routers``: the first port it draws is already bound
        by another process, that router exits with "address already in
        use" and is started again on a fresh port; its sibling, started
        with it, serves on its own."""
        import socket
        env = chaos_env(tmp_path, SMALL)
        tmp = str(tmp_path)
        procs: list = []
        taken = socket.socket()
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        real = bench_modes._free_port
        draws = [taken.getsockname()[1]]
        monkeypatch.setattr(bench_modes, "_free_port",
                            lambda: draws.pop(0) if draws else real())
        try:
            coord = real()
            bench_modes._spawn(procs, env, tmp, "coordinator",
                               ["coordinator", "--listen",
                                f"127.0.0.1:{coord}"])
            got = bench_modes._spawn_routers(procs, env, tmp,
                                             ["router_a", "router_b"], coord)
            assert taken.getsockname()[1] not in [port for _, port in got]
            assert [q.poll() is None for q in procs] == [True, False, True,
                                                         True]
            # router_a started again after router_b, on its own port
            assert [q for q, _ in got] == [procs[3], procs[2]]
            for _, port in got:
                assert json.loads(http_get(
                    f"http://127.0.0.1:{port}/api/health"))["ok"]
        finally:
            taken.close()
            _kill_all(procs)

    def test_fleet_ports_lie_below_the_ephemeral_range(self):
        """``chip_smoke.free_ports``: distinct ports, each free to bind,
        all below the range that ``bind(0)`` and outgoing connections draw
        from, so no other process's connection can take one before its
        node binds it; a port already bound is never drawn."""
        import socket
        cs = _chip_smoke()
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
        ports = cs.free_ports(5)
        assert len(set(ports)) == 5
        assert all(1024 <= p < low for p in ports)
        held = []
        try:
            for p in ports:
                s_ = socket.socket()
                s_.bind(("127.0.0.1", p))
                held.append(s_)
            again = cs.free_ports(5)
            assert not set(again) & set(ports)
        finally:
            for s_ in held:
                s_.close()

    def test_hold_index_bytes_refuses_an_upload_routed_past_a_worker(
            self, tmp_path):
        """The failure the barrier guards against, seeded in the leader:
        its first size poll of a worker fails during the one upload, every
        new name goes to the other worker, and the harness refuses to go
        on to a measured round."""
        core = CoordinationCore(session_timeout_s=0.5)
        nodes = []
        try:
            for i in range(3):
                cfg = Config(
                    documents_path=str(tmp_path / f"b{i}" / "docs"),
                    index_path=str(tmp_path / f"b{i}" / "index"), port=0,
                    replication_factor=1, embedding_enabled=False,
                    **{k: CLUSTER_CFG[k] for k in ENGINE_KEYS
                       if k in CLUSTER_CFG})
                nodes.append(SearchNode(cfg, coord=LocalCoordination(
                    core, 0.1), device="cpu").start())
            assert wait_until(lambda: len(
                nodes[0].registry.get_all_service_addresses()) == 2,
                timeout=10.0)
            workers = [n.url for n in nodes[1:]]
            global_injector.arm("leader.size_poll", times=1)
            _upload(nodes[0], {f"d{i}.txt": t for i, t in enumerate(TEXTS)})
            sizes = [int(http_get(w + "/worker/index-size"))
                     for w in workers]
            assert sorted(s > 0 for s in sizes) == [False, True], sizes
            with pytest.raises(AssertionError, match="no index bytes"):
                bench_modes._hold_index_bytes(workers, timeout=2.0)
        finally:
            _stop(nodes, core)


# ---------------------------------------------------------------------------
# the live chaos leg (slow): tests/test_compute_chaos.py's TestChaosCompute
# ---------------------------------------------------------------------------

PREMISE_ATTEMPTS = 40   # fleets tried for the poison premise (~5 s each)


@pytest.mark.slow
class TestChaosCompute:
    @pytest.mark.timeout(420)
    def test_oom_wedge_poison_quarantine_recovery(self, tmp_path):
        """The JAX job against port processes: zipfian-ish closed-loop
        load over a leader and three workers (R=2); mid-run one worker is
        OOM'd (every dispatch), another slow-wedged, and a poison query
        injected. Every 200 exact-parity-or-honestly-stamped, no acked
        write lost, the quarantine engaged on exactly two distinct
        replicas, and after the nemeses clear the fleet converges back to
        exact, unmarked device serving. Before any fault the baseline
        equals the JAX package's per-owner oracle."""
        env = chaos_env(tmp_path, {
            "TFIDF_REPLICATION_FACTOR": "2",
            "TFIDF_TOP_K": "32",
            "TFIDF_USE_PALLAS": "false",
            "TFIDF_SESSION_TIMEOUT_S": "2.0",
            "TFIDF_HEARTBEAT_INTERVAL_S": "0.3",
            "TFIDF_MIN_DOC_CAPACITY": "64",
            "TFIDF_MIN_NNZ_CAPACITY": "4096",
            "TFIDF_MIN_VOCAB_CAPACITY": "1024",
            "TFIDF_QUERY_BATCH": "8",
            "TFIDF_MAX_QUERY_TERMS": "8",
            "TFIDF_DEVICE_NEMESIS_API": "1",
            "TFIDF_COMPUTE_SICK_AFTER": "3",
            "TFIDF_COMPUTE_PROBE_INTERVAL_S": "0.5",
            "TFIDF_POISON_QUARANTINE_AFTER": "2",
            "TFIDF_OOM_BACKOFF_MIN_BATCH": "8",
            "TFIDF_RESULT_CACHE_ENTRIES": "0",
            "TFIDF_ROUTER_CACHE_ENTRIES": "0",
        })
        procs: list = []

        def wait_pred(pred, timeout=120.0, interval=0.2):
            _wait_until(pred, timeout, interval)
            return True

        try:
            # 24 acked writes; every doc carries "common" so one query
            # enumerates the full corpus (the zero-loss witness)
            docs = {f"ch{i}.txt":
                    f"common token{i} word{i % 3} extra{i % 5}"
                    for i in range(24)}
            poison_q = "word0 word1 word2 extra0 extra1 extra2"
            # the job's premise: the poison query has >= 6 positive-weight
            # terms on both poisoned workers (w1, w2). The batch's routing
            # (least-loaded by a per-batch text-length estimate, ties by
            # crc32 of name and worker URL) leaves a worker without a
            # whole word class in most draws of the ports, in the JAX
            # package's cluster as in the port's; then only one replica
            # can blame the poison and the quarantine cannot engage. So a
            # fleet whose placement breaks the premise is replaced, before
            # any fault, by one on fresh ports and dirs.
            for attempt in range(PREMISE_ATTEMPTS):
                coord, _, nurls = bench_modes._start_cluster(
                    procs, env, str(tmp_path / f"a{attempt}"), n_workers=3,
                    timeout=120.0)
                leader, workers = nurls[0], nurls[1:]
                resp = json.loads(http_post(
                    leader + "/leader/upload-batch",
                    json.dumps([{"name": n, "text": t}
                                for n, t in docs.items()]).encode()))
                assert sum(resp["placed"].values()) == 48   # 24 x R=2
                held = [{w for n in json.loads(http_get(
                    u + "/worker/names"))["names"]
                    for w in docs[n].split()} for u in workers[1:]]
                if all(set(poison_q.split()) <= h for h in held):
                    break
                _kill_all(procs)
                procs.clear()
            else:
                pytest.fail(f"no placement in {PREMISE_ATTEMPTS} fleets "
                            f"gave both poisoned workers every poison term")
            qpool = ["common"] + [f"token{i} word{i % 3}"
                                  for i in range(24)]
            baseline = {}
            for q in qpool + [poison_q]:
                st, hd, body = _post_full(
                    leader, "/leader/start",
                    json.dumps({"query": q}).encode())
                assert st == 200 and "X-Scatter-Degraded" not in hd, \
                    (q, st, hd)
                baseline[q] = json.loads(body)
            assert set(baseline["common"]) == set(docs)   # zero loss
            # before any fault: the JAX package's oracle, sharded as the
            # fleet's placement is
            want = owner_oracle(
                tmp_path / "oracle", docs, placement_of(coord),
                qpool + [poison_q], top_k=32, min_doc_capacity=64,
                min_nnz_capacity=4096, min_vocab_capacity=1024,
                query_batch=8, max_query_terms=8, use_pallas=False)
            for q in qpool + [poison_q]:
                assert_parity(baseline[q], want[q], q)

            outcomes = {"exact": 0, "compute_degraded": 0,
                        "degraded": 0, "failed": 0}
            olock = threading.Lock()
            errors: list[str] = []
            stop = threading.Event()

            def client(cid):
                rng = random.Random(cid)
                while not stop.is_set():
                    q = qpool[int(rng.random() ** 2 * len(qpool))]
                    try:
                        st, hd, body = _post_full(
                            leader, "/leader/start",
                            json.dumps({"query": q}).encode(),
                            timeout=30.0)
                    except Exception:
                        st, hd, body = None, {}, b""
                    if st != 200:
                        verdict = "failed"
                    elif json.loads(body) == baseline[q]:
                        verdict = ("compute_degraded"
                                   if "X-Compute-Degraded" in hd
                                   else "exact")
                    elif "X-Scatter-Degraded" in hd \
                            or "X-Compute-Degraded" in hd:
                        verdict = "degraded"   # honest partials only
                    else:
                        errors.append(
                            f"unmarked non-parity 200 for {q!r}")
                        return
                    with olock:
                        outcomes[verdict] += 1

            threads = [threading.Thread(target=client, args=(c,),
                                        daemon=True) for c in range(4)]
            for t in threads:
                t.start()
            time.sleep(2.0)

            # nemesis 1: every dispatch on w0 OOMs -> host mirror
            http_post(workers[0] + "/api/device-nemesis",
                      json.dumps({"script": "*:oom"}).encode())
            # nemesis 2: w1 is slow-wedged (200ms per dispatch)
            http_post(workers[1] + "/api/device-nemesis",
                      json.dumps(
                          {"script": "*:delay:1.0:delay_s=0.2"}).encode())
            wait_pred(lambda: json.loads(http_get(
                workers[0] + "/api/health"))["compute"]["state"]
                == "sick", timeout=60)
            time.sleep(3.0)

            # nemesis 3: a poison query on w1 and w2; w0 serves from the
            # host mirror (its device is already sick) and never poisons
            for w in (workers[1], workers[2]):
                http_post(w + "/api/device-nemesis", json.dumps(
                    {"script":
                     "score_ell:poison:1.0:min_uniq=6"}).encode())
            fp = poison_fingerprint(poison_q, "sparse")

            def quarantined():
                st, hd, _b = _post_full(
                    leader, "/leader/start",
                    json.dumps({"query": poison_q}).encode(),
                    timeout=30.0)
                return st == 422 \
                    and hd.get("X-Poison-Quarantined") == fp
            wait_pred(quarantined, timeout=60, interval=0.5)
            snap = json.loads(http_get(leader + "/api/quarantine"))
            (entry,) = [e for e in snap["quarantined"]
                        if e["fingerprint"] == fp]
            assert len(entry["replicas"]) == 2
            assert set(entry["replicas"]) <= {workers[1], workers[2]}

            time.sleep(3.0)
            stop.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors, errors[:3]
            assert outcomes["exact"] > 20, outcomes
            assert outcomes["compute_degraded"] > 0, outcomes

            # zero acked-write loss THROUGH the chaos
            st, hd, body = _post_full(
                leader, "/leader/start",
                json.dumps({"query": "common"}).encode(), timeout=30.0)
            assert st == 200 and set(json.loads(body)) == set(docs)

            # recovery: clear every nemesis + the quarantine
            for w in workers:
                http_post(w + "/api/device-nemesis",
                          json.dumps({"clear": True}).encode())
            json.loads(http_post(leader + "/api/quarantine", b"{}"))

            def recovered():
                st, hd, body = _post_full(
                    leader, "/leader/start",
                    json.dumps({"query": "common"}).encode(),
                    timeout=30.0)
                return (st == 200
                        and "X-Compute-Degraded" not in hd
                        and "X-Scatter-Degraded" not in hd
                        and json.loads(body) == baseline["common"])
            wait_pred(recovered, timeout=60, interval=0.5)
            st, _, body = _post_full(
                leader, "/leader/start",
                json.dumps({"query": poison_q}).encode(), timeout=30.0)
            assert st == 200 and json.loads(body) == baseline[poison_q]
        finally:
            _kill_all(procs)
