"""The fleet modes of the port's bench (``bench_modes``: overload,
routers, replay) as ``python -m tfidf_tpu_torch`` processes on the CPU.

Each mode runs once through its ``*_main`` at a tiny size (a few hundred
documents, phases of 1-2 s, one host thread a node, small capacities):
a coordinator, a leader and two workers with ``TFIDF_DEVICE=cpu``, and
the mode's routers and load generators. Its gates hold (the live
histogram against the clients' latencies, router == leader before any
phase, the capture replayed exactly), its artifact goes where it is sent,
and every process it started has exited. The functions' result keys are
the root ``bench.py``'s, read from its source, with the card's process
count (None off the card) and the host's cores added.
"""

import json
import os
import subprocess
import sys

import pytest

from test_torch_bench import RENAMES, _dict_keys, _return_keys
from tfidf_tpu_torch import bench_modes as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")
TINY = dict(n_docs=300, query_pool=64)


@pytest.fixture
def spawned(monkeypatch):
    """Node processes on one host thread with small capacities, at a
    lower priority; every process the mode starts is recorded with its
    argv and environment."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k, v in {"MIN_DOC_CAPACITY": 64, "MIN_NNZ_CAPACITY": 4096,
                 "MIN_VOCAB_CAPACITY": 1024}.items():
        monkeypatch.setenv(f"TFIDF_{k}", str(v))
    procs = []
    real = subprocess.Popen

    def popen(argv, *a, **k):
        if argv[0] != sys.executable:      # e.g. nvidia-smi, absent here
            return real(argv, *a, **k)
        # at a lower priority: a fleet's processes must not starve the
        # timing-sensitive tests other workers of the suite run meanwhile
        p = real(["nice", "-n", "10", *argv], *a, **k)
        procs.append((list(argv), k["env"], p))
        return p

    monkeypatch.setattr(subprocess, "Popen", popen)
    return procs


def _check_processes(procs, n_nodes: int) -> None:
    nodes = [env for argv, env, _ in procs
             if argv[1:4] == ["-m", "tfidf_tpu_torch", "serve"]]
    assert len(nodes) == n_nodes
    assert all(env["TFIDF_DEVICE"] == "cpu" for env in nodes)
    assert all(p.poll() is not None for _, _, p in procs)


@pytest.mark.timeout(300)
def test_overload_as_port_processes(tmp_path, monkeypatch, spawned, capsys):
    out = tmp_path / "OVERLOAD.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    M.overload_main(device="cpu", phase_s=1.5, warm_s=0.75,
                    **TINY)
    art = json.loads(out.read_text())
    _check_processes(spawned, 6)        # two fleets: static, autopilot
    for run in ("autopilot", "static_hand_tuned"):
        r = art["extra"][run]
        assert r["mode"] == run.split("_")[0]
        assert all(v["ok"] for v in r["live_histogram_check"].values())
        assert r["one_x"]["interactive"]["admitted"] > 0
        assert r["two_x"]["clients_interactive"] == 2 * M.OV_BASE_CLIENTS
        assert r["card_processes"] is None
        assert r["backend"].startswith("leader cpu, workers cpu + cpu")
    assert art["extra"]["autopilot"]["autopilot"]["enabled"] is True
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["detail_file"] == "OVERLOAD.json"
    assert art["kernel_builds_during_measurement"] == 0


@pytest.mark.timeout(300)
def test_routers_as_port_processes(tmp_path, monkeypatch, spawned):
    out = tmp_path / "BENCH_r07.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    M.routers_main(device="cpu", client_procs=2,
                   client_threads=2, warm_s=0.5, phase_s=1.5, **TINY)
    art = json.loads(out.read_text())
    r7 = art["extra"]
    assert set(r7["routers"]) == {"1", "2", "4"}
    assert r7["parity_checked"] is True
    assert all(p["admitted"] > 0 for p in r7["routers"].values())
    assert r7["host_cpus"] == os.cpu_count()
    clients = [argv for argv, _, _ in spawned if argv[1] == "-c"]
    assert len(clients) == 3 * 2 and all(
        argv[2] == M._R7_CLIENT_SRC for argv in clients)
    _check_processes(spawned, 3)
    assert art["kernel_builds_during_measurement"] == 0


@pytest.mark.timeout(300)
def test_replay_as_port_processes(tmp_path, monkeypatch, spawned):
    out = tmp_path / "BENCH_r10.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    M.replay_main(device="cpu", warm_s=0.75, capture_s=1.5,
                  **TINY)
    art = json.loads(out.read_text())
    fid = art["extra"]["fidelity"]
    assert fid["identical_admitted"] is True
    assert fid["captured_records"] == fid["replayed_admitted"] > 0
    assert fid["measured_replay_interactive"] > 0
    routers = [env for argv, env, _ in spawned if argv[3:4] == ["router"]]
    assert len(routers) == 2 and sum(
        "TFIDF_REPLAY_CAPTURE_PATH" in env for env in routers) == 1
    _check_processes(spawned, 3)


@pytest.mark.parametrize("func,kind,added", [
    ("bench_overload", "out", {"card_processes", "worker_kernel_launches"}),
    ("bench_routers", "return", {"card_processes", "host_cpus",
                                 "worker_kernel_launches"}),
    ("bench_replay", "result", {"card_processes", "device",
                                "worker_kernel_launches"})])
def test_fleet_result_keys_are_the_jax_bench_s(func, kind, added):
    def keys(path):
        return (_return_keys(path, func) if kind == "return"
                else _dict_keys(path, func, kind))
    want = {RENAMES.get(k, k) for k in keys(JAX_BENCH)}
    assert keys(M.__file__) == want | added
