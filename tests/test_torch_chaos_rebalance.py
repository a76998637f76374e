"""Rebalance crashes against the port: kill -9 at the migration's fault
points, and a hard leader kill mid-migration.

A port of ``tests/test_rebalance.py``'s slow ``TestChaosRebalance``:

* ``test_kill9_source_and_target_at_fault_points``: the leader runs in
  this process, a port ``SearchNode(cfg, ..., device="cpu")`` on a
  ``CoordinationClient`` of a ``python -m tfidf_tpu_torch coordinator``
  process; its fault points ``leader.rebalance_copy`` and
  ``leader.rebalance_flip`` (``tfidf_tpu_torch/cluster/rebalance.py``) are
  armed with kill -9 callables; the workers are port processes on the CPU
  (``jax`` and ``tfidf_tpu`` unimportable in them). Full replication (R=2
  over two workers): every reply of the churn thread is in exact merge
  parity (rel 1e-5) with the JAX package's single-node oracle;
* ``test_leader_hard_killed_mid_migration_resumes``: port nodes in this
  process; the new leader aborts the copying-phase record, restarts the
  drain it inherited and converges with zero lost documents; before the
  fault the leader's replies equal the JAX package's per-owner oracle.

The job's environment values, schedule, deadlines and assertions are the
JAX job's.
"""

import json
import os
import signal
import socket
import threading
import time

import pytest

from tests.test_cluster import wait_until
from tests.test_rebalance import _assert_complete
from tests.test_replication import (_CFG, DOCS, QUERIES, _assert_parity,
                                    _oracle, _search, _upload_docs)
from tests.test_torch_chaos_compute import (ENGINE_KEYS, assert_parity,
                                            chaos_env, owner_oracle)
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _free_port, _kill_all, _wait_until
from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  CoordinationCore,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.node import SearchNode, http_post
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import FaultInjected, global_injector


@pytest.fixture(autouse=True)
def _disarm():
    yield
    global_injector.disarm()


def _stop_all(nodes):
    for nd in nodes:
        try:
            nd.stop()
        except Exception:
            pass


@pytest.mark.slow
class TestChaosRebalance:
    @pytest.mark.timeout(420)
    def test_kill9_source_and_target_at_fault_points(self, tmp_path):
        """Real kill -9 of the migration SOURCE at
        ``leader.rebalance_copy`` and of the migration TARGET at
        ``leader.rebalance_flip``, mid-drain, under a concurrent search
        workload asserting exact single-node-oracle parity on every
        response."""
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
        coord_port = _free_port()
        procs: dict = {}

        def wait_pred(pred, timeout=60.0, interval=0.2):
            _wait_until(pred, timeout, interval)
            return True

        def spawn(tag, i, port):
            procs[tag] = bench_modes._spawn(
                list(), env, tmp, tag,
                bench_modes._serve_args(i, port, coord_port, tmp))

        leader = None
        try:
            procs["coord"] = bench_modes._spawn(
                list(), env, tmp, "coordinator",
                ["coordinator", "--listen", f"127.0.0.1:{coord_port}"])
            wait_pred(lambda: socket.create_connection(
                ("127.0.0.1", coord_port), timeout=1.0).close() or True,
                timeout=60.0)

            # IN-PROCESS port leader (first in: wins the election) so the
            # fault points can be armed with kill -9 callables
            cfg = Config(
                documents_path=str(tmp_path / "L" / "docs"),
                index_path=str(tmp_path / "L" / "index"), port=0,
                **{**_CFG, "replication_factor": 2, "top_k": 64,
                   "session_timeout_s": 1.0,
                   "reconcile_sweep_interval_s": 0.5,
                   "rebalance_sweep_ms": 10_000_000.0})

            def factory():
                return CoordinationClient(
                    f"127.0.0.1:{coord_port}",
                    heartbeat_interval_s=0.2)
            leader = SearchNode(cfg, coord_factory=factory,
                                device="cpu").start()
            assert wait_until(leader.is_leader, timeout=30.0)

            ports = [_free_port() for _ in range(4)]
            urls = [f"http://127.0.0.1:{p}" for p in ports]
            for i in range(2):
                spawn(f"w{i}", i, ports[i])
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 2,
                timeout=120.0)

            _upload_docs(leader)
            want = _oracle(tmp_path, top_k=64)

            def parity_now():
                for q in QUERIES:
                    got = json.loads(http_post(
                        leader.url + "/leader/start",
                        json.dumps({"query": q}).encode(),
                        timeout=60.0))
                    _assert_parity(got, want[q], ctx=q)
                return True
            wait_pred(parity_now, timeout=120.0, interval=1.0)

            failures = []
            stop_churn = threading.Event()

            def churn():
                while not stop_churn.is_set():
                    for q in QUERIES:
                        try:
                            got = json.loads(http_post(
                                leader.url + "/leader/start",
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

            # ---- scenario A: kill -9 the SOURCE at rebalance_copy ----
            spawn("w2", 2, ports[2])   # drain target
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 3,
                timeout=120.0)
            source_url = urls[0]
            global_injector.arm(
                "leader.rebalance_copy", action="callable", times=1,
                fn=lambda: os.kill(procs["w0"].pid, signal.SIGKILL))
            leader.rebalancer.start_drain(source_url)
            assert wait_until(lambda: source_url not in
                              leader.registry
                              .get_all_service_addresses(),
                              timeout=30.0)
            survivors = {urls[1], urls[2]}

            def restored():
                with leader._placement_lock:
                    return all(len(set(ws) & survivors) == 2
                               for ws in leader._placement.values())
            assert wait_until(restored, timeout=60.0)
            global_injector.disarm()

            # ---- scenario B: kill -9 the TARGET at rebalance_flip ----
            spawn("w3", 3, ports[3])
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 3,
                timeout=120.0)

            def kill_flip_target():
                recs = leader.placement.migration_snapshot()
                for rec in recs.values():
                    for ts in rec["targets"].values():
                        for turl in ts:
                            if turl == urls[3]:
                                os.kill(procs["w3"].pid,
                                        signal.SIGKILL)
                                return
            global_injector.arm("leader.rebalance_flip",
                                action="callable", times=1,
                                fn=kill_flip_target)
            leader.rebalancer.start_drain(urls[1])
            assert wait_until(lambda: urls[3] not in
                              leader.registry
                              .get_all_service_addresses(),
                              timeout=30.0)
            global_injector.disarm()
            leader.rebalancer.cancel_drain(urls[1])

            time.sleep(3.0)
            stop_churn.set()
            t.join(timeout=120)
            assert not failures, failures[:3]
            assert parity_now()
        finally:
            global_injector.disarm()
            if leader is not None:
                try:
                    leader.stop()
                except Exception:
                    pass
            _kill_all(procs.values())

    @pytest.mark.timeout(300)
    def test_leader_hard_killed_mid_migration_resumes(self, tmp_path):
        """Hard leader death at the flip fault point (coordination
        session expired + HTTP front door closed), with the mid-copy
        migration state durable: the new leader loads the znode, aborts
        the copying-phase record, restarts the drain it inherited, and
        converges with zero lost documents."""
        core = CoordinationCore(session_timeout_s=0.5)
        nodes = []
        for i in range(4):
            cfg = Config(
                documents_path=str(tmp_path / f"rb{i}" / "documents"),
                index_path=str(tmp_path / f"rb{i}" / "index"), port=0,
                **{**_CFG, "rebalance_sweep_ms": 10_000_000.0,
                   "replication_factor": 1})
            nodes.append(SearchNode(cfg, coord=LocalCoordination(core, 0.1),
                                    device="cpu").start())
        wait_until(lambda: len(
            nodes[0].registry.get_all_service_addresses()) == 3)
        leader = nodes[0]
        try:
            _upload_docs(leader)
            got = _search(leader, "common")
            _assert_complete(got, "pre")
            with leader._placement_lock:
                replicas = {n: list(ws)
                            for n, ws in leader._placement.items()}
            want = owner_oracle(tmp_path / "oracle", DOCS, replicas,
                                ["common"], **{k: v for k, v in
                                               _CFG.items()
                                               if k in ENGINE_KEYS})
            assert_parity(got, want["common"], "pre")
            drain_victim = nodes[2].url

            def hard_kill_leader():
                leader.placement.flush()
                leader.httpd.shutdown()
                leader.httpd.server_close()
                core.expire_session(leader.coord.sid)
                raise FaultInjected("leader killed at rebalance_flip")
            global_injector.arm("leader.rebalance_flip",
                                action="callable", times=1,
                                fn=hard_kill_leader)
            leader.rebalancer.start_drain(drain_victim)

            new_leader = nodes[1]
            assert wait_until(new_leader.is_leader, timeout=15.0)
            global_injector.disarm()
            assert wait_until(
                lambda: drain_victim in
                new_leader.placement.draining_snapshot(), timeout=15.0)
            assert wait_until(
                lambda: not new_leader.placement.migration_snapshot()
                or all(r["phase"] != "copying" for r in
                       new_leader.placement.migration_snapshot()
                       .values()), timeout=15.0)
            assert wait_until(
                lambda: not new_leader.placement.names_on(drain_victim)
                and not new_leader.placement.pending_moved().get(
                    drain_victim), timeout=60.0)

            def settled():
                return set(_search(new_leader, "common")) == set(DOCS)
            assert wait_until(settled, timeout=30.0)
        finally:
            _stop_all(nodes)
            core.close()
