"""The autopilot under a 1x -> 2x load step with a worker kill -9,
against port processes.

A port of ``tests/test_autopilot.py``'s slow ``TestChaosAutopilot``: a
coordinator and three nodes, each a ``python -m tfidf_tpu_torch`` process
on the CPU (``chaos_env``: ``jax`` and ``tfidf_tpu`` unimportable in
them), with the JAX job's environment (R=2, 1 s sessions, scatter batch
2, starting watermarks 2 / 8, the autopilot on at a 500 ms cadence,
windows of 8, a 400 ms p99 SLO) and its twelve documents. A closed
zipfian loop runs at 1x (4 clients, 10 s), then at 2x (12 clients, 16 s)
with a worker killed -9 halfway. The JAX job's assertions are kept line
for line: at least one adjustment, at most three direction changes per
knob, every knob inside its clamps, the admitted interactive p99 within
max(4x the 1x p99, 2 s), and the kill switch restoring every knob to its
static value. Added: before the load and after the kill switch the
leader answers every query of the pool in exact parity (rel 1e-5) with
the JAX package's single-node ``_oracle`` (``tests/test_admission.py``).

Processes start through ``tfidf_tpu_torch.bench_modes._spawn``; ports
come from ``tfidf_tpu_torch.bench.free_ports``; every request goes
through the port's transport seams.
"""

import json
import os
import random
import signal
import socket
import threading
import time
import urllib.error

import pytest

from tests.test_admission import _assert_parity, _oracle
from tests.test_torch_chaos_compute import chaos_env
from tests.test_torch_chaos_partition import heal_port_faults
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import free_ports
from tfidf_tpu_torch.cluster.node import http_get, http_post

_heal_port = pytest.fixture(autouse=True)(heal_port_faults)


@pytest.mark.slow
class TestChaosAutopilot:
    @pytest.mark.timeout(300)
    def test_step_change_converges_without_oscillation(self, tmp_path):
        """``make chaos-autopilot``: a real 3-process cluster under the
        zipfian closed loop, load stepped 1x -> 2x with a worker
        ``kill -9`` mid-2x. The autopilot (enabled, fast cadence) must
        make adjustments, never flap (at most one direction change per
        knob beyond the genuine load step), keep admitted-interactive
        p99 bounded, and revert exactly to static config on the kill
        switch."""
        env = chaos_env(tmp_path, {
            "TFIDF_REPLICATION_FACTOR": "2",
            "TFIDF_TOP_K": "64",
            "TFIDF_SESSION_TIMEOUT_S": "1.0",
            "TFIDF_HEARTBEAT_INTERVAL_S": "0.2",
            "TFIDF_RECONCILE_SWEEP_INTERVAL_S": "0.25",
            "TFIDF_MIN_DOC_CAPACITY": "64",
            "TFIDF_MIN_NNZ_CAPACITY": "4096",
            "TFIDF_MIN_VOCAB_CAPACITY": "1024",
            "TFIDF_QUERY_BATCH": "4",
            "TFIDF_MAX_QUERY_TERMS": "8",
            # overload mechanics (as in chaos-overload): small scatter
            # batches leave a queue behind, LOW starting watermarks the
            # controller may rescale
            "TFIDF_SCATTER_BATCH": "2",
            "TFIDF_SCATTER_PIPELINE": "1",
            "TFIDF_ADMISSION_QUEUE_HIGH_WATER": "2",
            "TFIDF_ADMISSION_QUEUE_CRITICAL": "8",
            "TFIDF_RESULT_CACHE_ENTRIES": "256",
            # the autopilot under test: fast cadence, small windows
            "TFIDF_AUTOPILOT_ENABLED": "true",
            "TFIDF_AUTOPILOT_INTERVAL_MS": "500",
            "TFIDF_AUTOPILOT_MIN_WINDOW": "8",
            "TFIDF_AUTOPILOT_P99_SLO_MS": "400",
        })
        coord_port, *ports = free_ports(4)
        procs = {}
        plist: list = []

        def spawn(tag, args):
            procs[tag] = bench_modes._spawn(plist, env, str(tmp_path),
                                            tag, args)
            return procs[tag]

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

        docs = {f"ap{i}.txt": f"common token{i} word{i % 3} "
                              f"extra{i % 5}" for i in range(12)}
        try:
            spawn("coord", ["coordinator", "--listen",
                            f"127.0.0.1:{coord_port}"])
            wait_pred(lambda: socket.create_connection(
                ("127.0.0.1", coord_port), timeout=1.0).close()
                or True)
            urls = [f"http://127.0.0.1:{p}" for p in ports]
            for i, p in enumerate(ports):
                spawn(f"n{i}", [
                    "serve", "--port", str(p), "--host", "127.0.0.1",
                    "--coordinator-address",
                    f"127.0.0.1:{coord_port}",
                    "--documents-path",
                    str(tmp_path / f"ap{i}" / "docs"),
                    "--index-path",
                    str(tmp_path / f"ap{i}" / "index")])
                wait_pred(lambda u=urls[i]: http_get(
                    u + "/api/status", timeout=5.0), timeout=120)
            leader = urls[0]
            wait_pred(lambda: len(json.loads(http_get(
                leader + "/api/services"))) == 2)
            http_post(leader + "/leader/upload-batch",
                      json.dumps([{"name": n, "text": t}
                                  for n, t in docs.items()]).encode())
            wait_pred(lambda: json.loads(http_post(
                leader + "/leader/start",
                json.dumps({"query": "common"}).encode())),
                timeout=120, interval=1.0)

            qpool = [f"token{i} word{j}" for i in range(12)
                     for j in range(3)] + ["common"]
            # held to the JAX package: its single-node oracle over the
            # same docs at the fleet's top_k
            want = _oracle(tmp_path, docs=docs, queries=qpool, top_k=64,
                           tag="ap_oracle")

            def parity_now():
                for q in qpool:
                    got = json.loads(http_post(
                        leader + "/leader/start",
                        json.dumps({"query": q}).encode()))
                    _assert_parity(got, want[q], ctx=q)
                return True
            wait_pred(parity_now, timeout=120, interval=1.0)
            rng = random.Random(11)
            weights = [1.0 / (i + 1) ** 1.1 for i in range(len(qpool))]
            zipf = rng.choices(qpool, weights=weights, k=4000)
            nonce = [0]
            idx = [0]
            lock = threading.Lock()

            def run_phase(n_clients, seconds, mid_phase=None):
                lats, sheds, errors = [], [0], []
                stop_at = time.monotonic() + seconds

                def client(cid):
                    while time.monotonic() < stop_at:
                        with lock:
                            q = zipf[idx[0] % len(zipf)]
                            idx[0] += 1
                            if idx[0] % 5 < 2:
                                nonce[0] += 1
                                q = f"{q} zzuniq{nonce[0]}"
                        t0 = time.monotonic()
                        try:
                            http_post(
                                leader + "/leader/start",
                                json.dumps({"query": q}).encode(),
                                headers={"X-Client-Id": f"c{cid}"},
                                timeout=30.0)
                            with lock:
                                lats.append(time.monotonic() - t0)
                        except urllib.error.HTTPError as e:
                            if e.code == 429:
                                with lock:
                                    sheds[0] += 1
                                time.sleep(min(float(e.headers.get(
                                    "Retry-After", 0.05)), 0.5))
                            else:
                                errors.append(e)
                                return
                        except Exception as e:
                            errors.append(e)
                            return

                threads = [threading.Thread(target=client, args=(i,),
                                            daemon=True)
                           for i in range(n_clients)]
                for t in threads:
                    t.start()
                if mid_phase is not None:
                    time.sleep(seconds / 2)
                    mid_phase()
                for t in threads:
                    t.join(timeout=seconds + 60)
                assert not errors, errors[:3]
                lats.sort()
                return {"n": len(lats), "sheds": sheds[0],
                        "p99": lats[int(len(lats) * 0.99)]
                        if lats else 0.0}

            one_x = run_phase(4, 10.0)
            assert one_x["n"] > 0

            def kill_worker():
                victim = procs.pop("n2")
                os.kill(victim.pid, signal.SIGKILL)
                victim.wait(timeout=10)

            two_x = run_phase(12, 16.0, mid_phase=kill_worker)
            assert two_x["n"] > 0
            print(f"phases: 1x {one_x} 2x {two_x}", flush=True)
            # admitted-interactive p99 stays bounded through the step
            # change AND the kill (CI-generous 4x; the committed
            # BENCH_r06 artifact holds the quiet-hardware 1.5x bar)
            assert two_x["p99"] <= max(4.0 * one_x["p99"], 2.0), \
                (one_x, two_x)

            got = json.loads(http_get(
                leader + "/api/autopilot?recent=256"))
            snap = got["autopilot"]
            assert snap["enabled"] is True
            # the loop actually steered something under the step change
            total_adjust = sum(v["adjustments"]
                               for v in snap["knobs"].values())
            assert total_adjust >= 1, snap
            # convergence without oscillation: per knob, applied
            # adjustments may change direction only at genuine
            # load-state transitions — the 1x->2x step, the post-kill
            # settle, and (for the hedge) a park/unpark mode switch
            # at a saturation boundary. A/B/A/B flapping would rack
            # up far more than this bound.
            by_knob = {}
            for d in got["decisions"]:
                if d.get("applied") and d["reason"] == "adjusted":
                    by_knob.setdefault(d["knob"], []).append(
                        d["direction"])
            for knob, dirs in by_knob.items():
                flips = sum(1 for a, b in zip(dirs, dirs[1:])
                            if a != b)
                assert flips <= 3, (knob, dirs)
            # every knob inside its clamps
            for k, v in snap["knobs"].items():
                assert v["floor"] <= v["current"] <= v["ceiling"], (
                    k, v)
            # kill switch restores exact static config, live
            resp = json.loads(http_post(
                leader + "/api/autopilot",
                json.dumps({"enabled": False}).encode()))
            for k, v in resp["autopilot"]["knobs"].items():
                assert v["current"] == v["static"], (k, v)
            # and the cluster answers the oracle exactly after the storm
            wait_pred(parity_now, timeout=60, interval=1.0)
        finally:
            for p in procs.values():
                try:
                    p.kill()
                except Exception:
                    pass
            for p in procs.values():
                try:
                    p.wait(timeout=10)
                except Exception:
                    pass
