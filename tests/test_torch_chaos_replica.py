"""Real kill -9s at R=2, against port processes.

A port of ``tests/test_replication.py``'s slow ``TestChaosReplica``:

* ``test_kill9_worker_mid_workload_exact_parity``: a coordinator, a
  leader and two workers as ``python -m tfidf_tpu_torch`` processes on
  the CPU (``jax`` and ``tfidf_tpu`` unimportable in them), the job's
  environment values, churn thread, kill -9, revive on the same port and
  dirs, and assertions. Every reply, before, during and after the churn,
  is in exact merge parity (rel 1e-5, the JAX job's) with the JAX
  package's single-node oracle (``tests/test_replication.py``'s
  ``_oracle``): at R=2 over two workers every worker holds the corpus;
* ``test_sigkill_full_ensemble_then_serving_resumes``: three port
  coordinator processes in an ensemble, SIGKILLed together and restarted
  on their data dirs under port nodes in this process (``device="cpu"``):
  a serving cluster re-forms with the placement map intact, its replies
  the oracle's before the kill and complete after it.
"""

import json
import signal
import threading
import time

import pytest

from tests.test_cluster import wait_until
from tests.test_replication import (_CFG, DOCS, QUERIES, _assert_parity,
                                    _oracle, _search, _stop_all,
                                    _upload_docs)
from tests.test_torch_chaos_compute import chaos_env
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _free_port, _kill_all, _wait_until
from tfidf_tpu_torch.cluster.coordination import CoordinationClient
from tfidf_tpu_torch.cluster.node import SearchNode, http_get, http_post
from tfidf_tpu_torch.cluster.placement import PLACEMENT_STATE
from tfidf_tpu_torch.utils.config import Config


@pytest.mark.slow
class TestChaosReplica:
    @pytest.mark.timeout(300)
    def test_kill9_worker_mid_workload_exact_parity(self, tmp_path):
        """Under a concurrent search workload and membership churn (kill
        -9 a worker, then revive it), every in-flight and later search
        returns the complete result set in exact merge parity with the
        single-node oracle: no missing document, no double-counted
        score."""
        env = chaos_env(tmp_path, {
            "TFIDF_REPLICATION_FACTOR": "2",
            "TFIDF_TOP_K": "64",
            "TFIDF_SESSION_TIMEOUT_S": "1.0",
            "TFIDF_HEARTBEAT_INTERVAL_S": "0.2",
            "TFIDF_RECONCILE_SWEEP_INTERVAL_S": "0.5",
            "TFIDF_MIN_DOC_CAPACITY": "64",
            "TFIDF_MIN_NNZ_CAPACITY": "4096",
            "TFIDF_MIN_VOCAB_CAPACITY": "1024",
            "TFIDF_QUERY_BATCH": "8",
            "TFIDF_MAX_QUERY_TERMS": "8",
        })
        tmp = str(tmp_path)
        procs: list = []

        def wait_pred(pred, timeout=60.0, interval=0.2):
            _wait_until(pred, timeout, interval)
            return True

        try:
            coord, ports, urls = bench_modes._start_cluster(
                procs, env, tmp, n_workers=2, timeout=120.0)
            assert http_get(urls[0] + "/api/status") == b"I am the leader"

            batch = [{"name": n, "text": t} for n, t in DOCS.items()]
            http_post(urls[0] + "/leader/upload-batch",
                      json.dumps(batch).encode())
            want = _oracle(tmp_path, top_k=64)

            def parity_now():
                for q in QUERIES:
                    got = json.loads(http_post(
                        urls[0] + "/leader/start",
                        json.dumps({"query": q}).encode()))
                    _assert_parity(got, want[q], ctx=q)
                return True
            # the baseline before any fault, both workers serving
            wait_pred(parity_now, timeout=120, interval=1.0)

            failures = []
            stop_churn = threading.Event()

            def churn():
                while not stop_churn.is_set():
                    for q in QUERIES:
                        try:
                            got = json.loads(http_post(
                                urls[0] + "/leader/start",
                                json.dumps({"query": q}).encode(),
                                timeout=60.0))
                            _assert_parity(got, want[q], ctx=q)
                        except AssertionError as e:
                            failures.append(e)
                        except Exception as e:
                            failures.append(
                                AssertionError(f"transport: {e!r}"))

            t = threading.Thread(target=churn, daemon=True)
            t.start()
            time.sleep(1.0)
            # kill -9 one worker mid-workload (node1: the first worker)
            procs[2].send_signal(signal.SIGKILL)
            time.sleep(4.0)
            # revive it (same port, same dirs): rejoin churn
            bench_modes._spawn(procs, env, tmp, "node1b",
                               bench_modes._serve_args(1, ports[1], coord,
                                                       tmp))
            wait_pred(lambda: http_get(urls[1] + "/api/status",
                                       timeout=5.0), timeout=120)
            time.sleep(4.0)
            stop_churn.set()
            t.join(timeout=120)
            assert not failures, failures[:3]
            # and the post-churn steady state is still exact
            assert parity_now()
        finally:
            _kill_all(procs)

    @pytest.mark.timeout(300)
    def test_sigkill_full_ensemble_then_serving_resumes(self, tmp_path):
        """SIGKILL all three coordinator processes, restart them on the
        same data dirs, and a serving cluster re-forms with the placement
        map intact."""
        ports = [_free_port() for _ in range(3)]
        peers = ",".join(f"c{i}=127.0.0.1:{p}"
                         for i, p in enumerate(ports))
        connect = ",".join(f"127.0.0.1:{p}" for p in ports)
        # tests/test_coordination_durability.py's coordinator environment
        env = chaos_env(tmp_path, {
            "TFIDF_SESSION_TIMEOUT_S": "30.0",
            "TFIDF_ENSEMBLE_ELECTION_TIMEOUT_S": "0.4",
            "TFIDF_ENSEMBLE_HEARTBEAT_S": "0.1",
            "TFIDF_ENSEMBLE_COMMIT_TIMEOUT_S": "3.0"})

        def spawn_ensemble():
            return [bench_modes._spawn(
                [], env, str(tmp_path), f"c{i}",
                ["coordinator", "--listen", f"127.0.0.1:{p}",
                 "--data-dir", str(tmp_path / f"c{i}"),
                 "--node-id", f"c{i}", "--peers", peers])
                for i, p in enumerate(ports)]

        def wait_http(port):
            _wait_until(lambda: json.loads(http_get(
                f"http://127.0.0.1:{port}/ensemble/status",
                timeout=1.0)) is not None, 30.0, 0.1)

        procs = spawn_ensemble()
        nodes = []
        try:
            for p in ports:
                wait_http(p)

            def factory():
                return CoordinationClient(connect,
                                          heartbeat_interval_s=0.5,
                                          failover_deadline_s=30.0)
            for i in range(3):
                cfg = Config(
                    documents_path=str(
                        tmp_path / f"sg{i}" / "documents"),
                    index_path=str(tmp_path / f"sg{i}" / "index"),
                    port=0, **_CFG)
                nodes.append(SearchNode(cfg, coord_factory=factory,
                                        device="cpu").start())
            leader = nodes[0]
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 2,
                timeout=60.0)
            _upload_docs(leader)
            want = _oracle(tmp_path, top_k=_CFG["top_k"])
            for q in QUERIES:
                _assert_parity(_search(leader, q), want[q], ctx=q)

            def znode_state():
                try:
                    raw = leader.coord.get_data(PLACEMENT_STATE)
                except Exception:
                    return {}
                return json.loads(raw.decode()) if raw else {}
            assert wait_until(
                lambda: znode_state().get("replicas", {}).keys()
                >= DOCS.keys(), timeout=10.0)

            for p in procs:
                p.send_signal(signal.SIGKILL)
            for p in procs:
                p.wait(timeout=10)
            procs = spawn_ensemble()
            for p in ports:
                wait_http(p)
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 2,
                timeout=60.0)
            assert wait_until(
                lambda: set(_search(leader, "common")) == set(DOCS),
                timeout=60.0)
            assert znode_state()["replicas"].keys() >= DOCS.keys()
        finally:
            _stop_all(nodes)
            _kill_all(procs)
