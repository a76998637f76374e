"""A router and the node leader killed -9 mid-workload, against port
processes.

A port of ``tests/test_router.py``'s slow ``TestChaosRouter``: a
coordinator, three nodes and two stateless routers, each a ``python -m
tfidf_tpu_torch`` process on the CPU (``chaos_env``: ``jax`` and
``tfidf_tpu`` unimportable in them), the JAX job's environment (R=2, 1 s
sessions, a 64-entry router cache), its 24-document corpus and its 2x
closed-loop zipfian load from six client threads. Mid-workload one router
and the node leader are killed -9. Every 200 from a router either carries
``X-Scatter-Degraded`` or is in exact parity (rel 1e-5) with the JAX
package's single-node oracle (``tests/test_admission.py``'s ``_oracle``
and ``_assert_parity``); the surviving router keeps admitting exact
reads, and once the new leader settles it converges to exact, unmarked
parity.

Processes start through ``tfidf_tpu_torch.bench_modes._spawn`` (each in
its log directory) and ``_spawn_routers`` (both routers together, one
whose port was taken started again); ports come from
``tfidf_tpu_torch.bench.free_ports``.
"""

import json
import random
import signal
import socket
import threading
import time

import pytest

from tests.test_admission import _assert_parity, _oracle
from tests.test_router import _post_full
from tests.test_torch_chaos_compute import chaos_env
from tests.test_torch_chaos_partition import heal_port_faults
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _kill_all, free_ports
from tfidf_tpu_torch.cluster.node import http_get, http_post

_heal_port = pytest.fixture(autouse=True)(heal_port_faults)


@pytest.mark.slow
class TestChaosRouter:
    @pytest.mark.timeout(300)
    def test_router_and_leader_kill9_survivors_exact(self, tmp_path):
        """2x zipfian-ish closed-loop load through two stateless port
        routers; mid-workload a router AND the node leader are killed
        -9. The surviving router keeps serving — every 200 it returns is
        exact single-node-oracle parity or honestly degraded — and after
        the new leader settles, reads through it converge to exact
        parity with no marker."""
        env = chaos_env(tmp_path, {
            "TFIDF_REPLICATION_FACTOR": "2",
            "TFIDF_TOP_K": "32",
            "TFIDF_SESSION_TIMEOUT_S": "1.0",
            "TFIDF_HEARTBEAT_INTERVAL_S": "0.2",
            "TFIDF_RECONCILE_SWEEP_INTERVAL_S": "0.5",
            "TFIDF_MIN_DOC_CAPACITY": "64",
            "TFIDF_MIN_NNZ_CAPACITY": "4096",
            "TFIDF_MIN_VOCAB_CAPACITY": "1024",
            "TFIDF_QUERY_BATCH": "8",
            "TFIDF_MAX_QUERY_TERMS": "8",
            "TFIDF_ROUTER_REFRESH_MS": "200",
            "TFIDF_ROUTER_STALE_MS": "3000",
            "TFIDF_ROUTER_CACHE_ENTRIES": "64",
        })
        tmp = str(tmp_path)
        procs: list = []
        tagged = {}

        def spawn(tag, args):
            tagged[tag] = bench_modes._spawn(procs, env, tmp, tag, args)
            return tagged[tag]

        def wait_pred(pred, timeout=60.0, interval=0.2):
            deadline = time.monotonic() + timeout
            last = None
            while time.monotonic() < deadline:
                try:
                    if pred():
                        return True
                except Exception as e:
                    last = e
                time.sleep(interval)
            raise AssertionError(f"timed out; last={last!r}")

        stop_flag = threading.Event()
        threads = []
        coord_port, *nports = free_ports(4)
        try:
            spawn("coord", ["coordinator", "--listen",
                            f"127.0.0.1:{coord_port}"])
            wait_pred(lambda: socket.create_connection(
                ("127.0.0.1", coord_port), timeout=1.0).close() or True)
            nurls = [f"http://127.0.0.1:{p}" for p in nports]
            for i, p in enumerate(nports):
                spawn(f"n{i}", [
                    "serve", "--port", str(p), "--host", "127.0.0.1",
                    "--coordinator-address", f"127.0.0.1:{coord_port}",
                    "--documents-path", str(tmp_path / f"cr{i}/docs"),
                    "--index-path", str(tmp_path / f"cr{i}/idx")])
                wait_pred(lambda u=nurls[i]: http_get(
                    u + "/api/status", timeout=5.0), timeout=120)
            leader = nurls[0]
            wait_pred(lambda: len(json.loads(http_get(
                leader + "/api/services"))) == 2)
            _docs = {f"cr{i}.txt":
                     f"common token{i} word{i % 3} extra{i % 5}"
                     for i in range(24)}
            http_post(leader + "/leader/upload-batch", json.dumps(
                [{"name": n, "text": t}
                 for n, t in _docs.items()]).encode())

            routers = bench_modes._spawn_routers(procs, env, tmp,
                                                 ["r0", "r1"], coord_port)
            tagged.update({f"r{i}": p for i, (p, _) in enumerate(routers)})
            rurls = [f"http://127.0.0.1:{port}" for _, port in routers]
            for u in rurls:
                wait_pred(lambda u=u: json.loads(http_get(
                    u + "/api/router"))["placement"]["docs"]
                    == len(_docs), timeout=120)

            qpool = ["common"] + [f"token{i} word{i % 3}"
                                  for i in range(24)] + \
                    [f"extra{k} common" for k in range(5)]
            want = _oracle(tmp_path, docs=_docs, queries=qpool,
                           tag="cr_oracle")

            def check_200(base, q):
                """One read: 200 ⇒ exact parity OR degraded marker."""
                st, hd, body = _post_full(
                    base, "/leader/start",
                    json.dumps({"query": q}).encode(), timeout=30.0)
                if st != 200:
                    return None
                got = json.loads(body)
                if "X-Scatter-Degraded" in hd:
                    return "degraded"
                _assert_parity(got, want[q], ctx=f"{base} {q}")
                return "exact"

            # sanity: both routers exact pre-chaos
            for u in rurls:
                wait_pred(lambda u=u: check_200(u, "common") == "exact",
                          timeout=60)

            outcomes = {"exact": 0, "degraded": 0, "failed": 0}
            olock = threading.Lock()
            errors = []

            def client(cid):
                rng = random.Random(cid)
                i = 0
                while not stop_flag.is_set():
                    base = rurls[i % 2] if cid % 2 else rurls[1]
                    q = qpool[int(rng.random() ** 2 * len(qpool))]
                    i += 1
                    try:
                        verdict = check_200(base, q)
                    except AssertionError as e:
                        errors.append(str(e)[:300])
                        return
                    except Exception:
                        verdict = None   # killed router / transient
                    with olock:
                        outcomes[verdict or "failed"] = \
                            outcomes.get(verdict or "failed", 0) + 1

            threads = [threading.Thread(target=client, args=(c,),
                                        daemon=True) for c in range(6)]
            for t in threads:
                t.start()
            time.sleep(3.0)
            # kill -9 a router AND the leader mid-workload
            tagged["r0"].send_signal(signal.SIGKILL)
            tagged["n0"].send_signal(signal.SIGKILL)
            time.sleep(12.0)
            stop_flag.set()
            for t in threads:
                t.join(timeout=30)
            assert not errors, errors[:3]
            # the surviving router kept ADMITTING exact reads
            assert outcomes["exact"] > 20, outcomes

            # post-chaos: the survivor converges to exact, unmarked
            # parity (the dead worker-leader's docs survive on the
            # replica; a new leader re-publishes the placement map)
            def settled():
                return check_200(rurls[1], "common") == "exact"
            wait_pred(settled, timeout=120, interval=1.0)
        finally:
            stop_flag.set()
            for t in threads:
                t.join(timeout=30)
            _kill_all(procs)
