"""The port's CLI, ``python -m tfidf_tpu_torch``, as a deployment runs it.

The fleet here is real processes with ``jax`` and ``tfidf_tpu`` made
unimportable (a stub directory first on ``PYTHONPATH`` shadows both): a
leader started with ``serve --embedded-coordinator --device cpu``, a worker
``serve --device cpu`` joining it, and a ``router``. The client commands
(``upload``, ``query``, ``status``) run in this process against it, with
CUDA's lazy initialisation made to raise: they speak HTTP and touch no
device. Their answers on ``demo/corpus`` equal the JAX CLI's against a
JAX fleet of the same shape in this process (sparse scores to the bit;
dense and hybrid within rel 1e-5, the embedding columns agreeing within an
ulp). ``ingest`` / ``search`` run locally on the CPU and answer as the JAX
CLI does (rel 1e-6). Without CUDA and without ``--device``, ``serve``
exits non-zero with the CUDA message.

Each process test has a pytest-timeout guard and its own deadlines; every
process started is stopped by SIGTERM and must exit 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from tests.test_cluster import wait_until
from tfidf_tpu.cli import main as jax_main
from tfidf_tpu.cluster.coordination import CoordinationCore as JaxCore
from tfidf_tpu.cluster.coordination import LocalCoordination as JaxLocal
from tfidf_tpu.cluster.node import SearchNode as JaxNode
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.cli import main as port_main
from tfidf_tpu_torch.tools.graftcheck import pytest_witness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "demo", "corpus")
# small capacities, the same for both packages (the processes read them
# from the environment, the in-process JAX fleet from its Config)
SMALL = {"min_doc_capacity": 64, "min_nnz_capacity": 4096,
         "min_vocab_capacity": 1024, "query_batch": 8,
         "max_query_terms": 8, "top_k": 10, "result_cache_entries": 0}
QUERIES = [["fast", "food"], ["kheder"], ["distributed", "search"]]
MODES = [[], ["--mode", "dense"], ["--mode", "hybrid", "--fusion", "rrf"],
         ["--mode", "hybrid", "--fusion", "wsum"]]
BOOT_S = 90.0


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _blocked_env(tmp):
    """PYTHONPATH with stub ``jax`` / ``tfidf_tpu`` packages that raise
    on import, then the repo; no TFIDF_DEVICE inherited. Under a session of
    the port's lockdep or protocol witness the stub also holds its child
    hook."""
    stub = tmp / "blocked"
    for pkg in ("jax", "tfidf_tpu"):
        (stub / pkg).mkdir(parents=True, exist_ok=True)
        (stub / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is blocked in this test')\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TFIDF_")}
    env["PYTHONPATH"] = os.pathsep.join([str(stub), ROOT])
    # under a witnessed session the children install its witnesses
    pytest_witness.write_child_hook(stub)
    # one host thread per node process: the suite runs beside others
    env["OMP_NUM_THREADS"] = "1"
    env.update({f"TFIDF_{k.upper()}": str(v) for k, v in SMALL.items()})
    return env


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _up(url):
    try:
        _get(url + "/api/health", timeout=1.0)
        return True
    except OSError:
        return False


def _stop(procs):
    """SIGTERM every process; each must exit 0 within its deadline."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=30))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=10)
            codes.append("killed")
    return codes


class PortTaken(Exception):
    """A node exited because its port was bound by another process of the
    box between ``_free_ports`` and the node's own bind."""


def _boot(procs, logs, url, log_path):
    """Wait until ``url`` answers; raise :class:`PortTaken` when the node
    died on a taken port (the caller picks new ports), fail otherwise."""
    if wait_until(lambda: _up(url) or procs[-1].poll() is not None,
                  timeout=BOOT_S) and _up(url):
        return
    text = log_path.read_text()
    if procs[-1].poll() is not None \
            and "address already in use" in text.lower():
        _stop(procs)
        for log in logs:
            log.close()
        raise PortTaken(text)
    raise AssertionError(text)


def _with_free_ports(start, attempts=3):
    """``start(attempt)`` with fresh ports until no node finds its port
    taken (other tests of the box bind ephemeral ports too)."""
    for attempt in range(attempts):
        try:
            return start(attempt)
        except PortTaken:
            if attempt == attempts - 1:
                raise


@pytest.fixture(scope="module")
def port_fleet(tmp_path_factory):
    """Leader (embedded coordinator), one worker and a router, each a
    ``python -m tfidf_tpu_torch`` process with jax blocked."""
    base = tmp_path_factory.mktemp("port_cli")
    env = _blocked_env(base)
    logs, procs = [], []

    def start(attempt):
        tmp = base / f"try{attempt}"
        tmp.mkdir()
        logs.clear()
        procs.clear()
        coord, lport, wport, rport = _free_ports(4)
        caddr = f"127.0.0.1:{coord}"

        def spawn(tag, *argv):
            log = open(tmp / f"{tag}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tfidf_tpu_torch", *argv], cwd=tmp,
                env=env, stdout=log, stderr=subprocess.STDOUT))

        def node(tag, port, *extra):
            spawn(tag, "serve", "--device", "cpu", "--host", "127.0.0.1",
                  "--port", str(port), "--coordinator-address", caddr,
                  "--documents-path", str(tmp / tag / "documents"),
                  "--index-path", str(tmp / tag / "index"), *extra)

        leader = f"http://127.0.0.1:{lport}"
        worker = f"http://127.0.0.1:{wport}"
        router = f"http://127.0.0.1:{rport}"
        node("leader", lport, "--embedded-coordinator")
        _boot(procs, logs, leader, tmp / "leader.log")
        node("worker", wport)
        _boot(procs, logs, worker, tmp / "worker.log")
        spawn("router", "router", "--coordinator", caddr,
              "--host", "127.0.0.1", "--port", str(rport))
        _boot(procs, logs, router, tmp / "router.log")
        assert wait_until(lambda: json.loads(
            _get(leader + "/api/services")) == [worker], timeout=BOOT_S)
        return {"leader": leader, "worker": worker, "router": router,
                "procs": procs, "tmp": tmp}

    try:
        yield _with_free_ports(start)
    finally:
        codes = _stop(procs)
        for log in logs:
            log.close()
        assert codes == [0] * len(procs), codes


@pytest.fixture(scope="module")
def jax_fleet(tmp_path_factory):
    """The JAX package's leader + worker of the same shape, in process."""
    tmp = tmp_path_factory.mktemp("jax_cli")
    core = JaxCore(session_timeout_s=2.0)
    nodes = []
    try:
        for i in range(2):
            nodes.append(JaxNode(JaxConfig(
                documents_path=str(tmp / f"n{i}" / "documents"),
                index_path=str(tmp / f"n{i}" / "index"), port=0, **SMALL),
                coord=JaxLocal(core, 0.2)).start())
        assert wait_until(lambda: len(
            nodes[0].registry.get_all_service_addresses()) == 1)
        yield nodes[0].url
    finally:
        for n in nodes:
            n.stop()
        core.close()


@pytest.fixture
def no_cuda_init(monkeypatch):
    """Any attempt to initialise CUDA in this process raises."""
    import torch

    def refuse(*_a, **_k):
        raise AssertionError("an HTTP-only command initialised CUDA")
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)


def _run(main, capsys, *argv):
    rc = main(list(argv))
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    return cap.out.strip()


@pytest.mark.timeout(180)
def test_upload_query_status_match_the_jax_cli(port_fleet, jax_fleet,
                                               capsys, no_cuda_init):
    pl = port_fleet["leader"]
    up = _run(port_main, capsys, "upload", CORPUS, "--leader", pl, "--batch")
    assert up == _run(jax_main, capsys, "upload", CORPUS, "--leader",
                      jax_fleet, "--batch")
    assert up.startswith(f"{len(os.listdir(CORPUS))} files uploaded")
    for q in QUERIES:
        for mode in MODES:
            got = json.loads(_run(port_main, capsys, "query", *q,
                                  "--leader", pl, *mode))
            want = json.loads(_run(jax_main, capsys, "query", *q,
                                   "--leader", jax_fleet, *mode))
            assert got and set(got) == set(want), (q, mode)
            if not mode:
                assert got == want, q
            for name, s in want.items():
                assert got[name] == pytest.approx(s, rel=1e-5), (q, mode)
    st = json.loads(_run(port_main, capsys, "status", "--leader", pl))
    jst = json.loads(_run(jax_main, capsys, "status", "--leader",
                          jax_fleet))
    assert st["status"] == jst["status"] == "I am the leader"
    assert st["services"] == [port_fleet["worker"]]
    assert st["degraded"] == {**jst["degraded"],
                              "last_scatter_workers_attempted": 1,
                              "last_scatter_workers_responded": 1}
    assert st["degraded"]["last_scatter_degraded"] is False


@pytest.mark.timeout(180)
def test_router_answers_as_the_leader(port_fleet, capsys, no_cuda_init):
    pl, pr = port_fleet["leader"], port_fleet["router"]
    _run(port_main, capsys, "upload", CORPUS, "--leader", pl, "--batch")
    for q in QUERIES:
        want = json.loads(_run(port_main, capsys, "query", *q,
                               "--leader", pl))

        def same():
            got = json.loads(_run(port_main, capsys, "query", *q,
                                  "--via-router", pr))
            return got == want
        assert wait_until(same, timeout=20.0, interval=0.25), q


@pytest.mark.timeout(120)
def test_serve_without_device_needs_cuda(tmp_path):
    env = _blocked_env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""        # no card, even on a GPU host
    r = subprocess.run(
        [sys.executable, "-m", "tfidf_tpu_torch", "serve",
         "--embedded-coordinator", "--port", "0",
         "--index-path", str(tmp_path / "idx")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=90)
    assert r.returncode == 2, r.stderr
    assert "CUDA is not available" in r.stderr
    assert "node up" not in r.stdout


@pytest.mark.timeout(120)
def test_bench_without_cuda_exits_with_the_cuda_message(tmp_path):
    """``bench`` has no CPU mode: without a card it exits non-zero with
    the CUDA message before it draws a corpus or starts a node, writes no
    artifact, and never reaches the blocked ``jax``."""
    env = _blocked_env(tmp_path)
    env["CUDA_VISIBLE_DEVICES"] = ""        # no card, even on a GPU host
    env["TFIDF_DEVICE"] = "cpu"             # not a way around the card
    env["BENCH_OUT"] = str(tmp_path / "BENCH_DETAIL.json")
    r = subprocess.run(
        [sys.executable, "-m", "tfidf_tpu_torch", "bench"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=90)
    assert r.returncode == 2, r.stderr
    assert "CUDA is not available" in r.stderr
    assert "blocked in this test" not in r.stderr
    assert r.stdout == ""
    assert not (tmp_path / "BENCH_DETAIL.json").exists()


@pytest.mark.timeout(120)
def test_ingest_and_search_match_the_jax_cli(tmp_path, capsys):
    ckpts = {}
    for tag, main, extra in (("port", port_main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
        docs = tmp_path / tag / "docs"
        ckpts[tag] = str(tmp_path / tag / "ckpt")
        out = _run(main, capsys, "ingest", CORPUS, "--documents-path",
                   str(docs), "--checkpoint", ckpts[tag], *extra)
        assert json.loads(out)["docs"] == len(os.listdir(CORPUS))
    for q in (" ".join(q) for q in QUERIES):
        got = json.loads(_run(port_main, capsys, "search", q,
                              "--checkpoint", ckpts["port"],
                              "--device", "cpu"))
        want = json.loads(_run(jax_main, capsys, "search", q,
                               "--checkpoint", ckpts["jax"]))
        assert [h["name"] for h in got["hits"]] == \
            [h["name"] for h in want["hits"]], q
        for g, w in zip(got["hits"], want["hits"]):
            assert g["score"] == pytest.approx(w["score"], rel=1e-6), q


@pytest.mark.timeout(120)
def test_distributed_serve_is_not_ported(tmp_path, capsys, monkeypatch):
    """``serve --distributed`` joins a process group before it builds a
    node (it is ported now; the name is kept): with no coordinator named
    anywhere it refuses at once, saying what is missing."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "TFIDF_DIST_COORDINATOR"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        port_main(["serve", "--distributed", "--device", "cpu",
                   "--index-path", str(tmp_path / "idx")])


@pytest.mark.timeout(180)
def test_distributed_mesh_worker_serves_in_a_fleet(tmp_path, jax_fleet,
                                                   capsys, no_cuda_init):
    """A worker started with ``serve --distributed --engine-mode mesh``
    (a process group of one over gloo; its engine a mesh of the group's
    ranks on the CPU) serves its shard in a fleet of port processes: its
    sparse answers through the leader equal the JAX fleet's to the bit,
    and it answers ``/worker/names`` with null (a mesh layout cannot
    list, as in the JAX package)."""
    env = _blocked_env(tmp_path)
    logs, procs = [], []

    def start(attempt):
        tmp = tmp_path / f"try{attempt}"
        tmp.mkdir()
        logs.clear()
        procs.clear()
        coord, lport, wport, gport = _free_ports(4)
        caddr = f"127.0.0.1:{coord}"

        def node(tag, port, *extra, **env_extra):
            log = open(tmp / f"{tag}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tfidf_tpu_torch", "serve",
                 "--device", "cpu", "--host", "127.0.0.1", "--port",
                 str(port), "--coordinator-address", caddr,
                 "--documents-path", str(tmp / tag / "documents"),
                 "--index-path", str(tmp / tag / "index"), *extra],
                cwd=tmp, env=dict(env, **env_extra), stdout=log,
                stderr=subprocess.STDOUT))

        leader = f"http://127.0.0.1:{lport}"
        worker = f"http://127.0.0.1:{wport}"
        node("leader", lport, "--embedded-coordinator")
        _boot(procs, logs, leader, tmp / "leader.log")
        node("worker", wport, "--distributed", "--engine-mode", "mesh",
             TFIDF_DIST_COORDINATOR=f"127.0.0.1:{gport}",
             TFIDF_DIST_NUM_PROCESSES="1", TFIDF_DIST_PROCESS_ID="0")
        _boot(procs, logs, worker, tmp / "worker.log")
        return leader, worker, tmp

    try:
        leader, worker, tmp = _with_free_ports(start)
        assert wait_until(lambda: json.loads(
            _get(leader + "/api/services")) == [worker], timeout=BOOT_S)
        _run(port_main, capsys, "upload", CORPUS, "--leader", leader,
             "--batch")
        _run(jax_main, capsys, "upload", CORPUS, "--leader", jax_fleet,
             "--batch")
        for q in QUERIES:
            got = json.loads(_run(port_main, capsys, "query", *q,
                                  "--leader", leader))
            want = json.loads(_run(jax_main, capsys, "query", *q,
                                   "--leader", jax_fleet))
            assert got and got == want, q
        assert json.loads(_get(worker + "/worker/names")) == {"names": None}
        assert "torch.distributed initialized" in \
            (tmp / "worker.log").read_text()
    finally:
        codes = _stop(procs)
        for log in logs:
            log.close()
    assert codes == [0] * len(procs), codes
