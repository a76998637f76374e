"""Fleets of the port's own cluster plane on the CPU, against the JAX
package's fleets.

Every node here is one package's ``SearchNode`` in this process; the port's
build their engines with ``device="cpu"`` (each kernel's plain PyTorch
version). The same documents go in through ``/leader/upload-batch`` and the
same queries out through ``/leader/start``. Tolerances, with their reasons:

* sparse: the port fleet's doc -> score map equals the JAX fleet's to the
  bit. Both fleets hold every document on both workers (R = 2 = worker
  count), the port's plain ELL path is bitwise equal to the JAX package's
  XLA path on the CPU, and the leaders merge the same floats;
* dense and ``hybrid`` with ``wsum``: the same key sets, scores within rel
  1e-5 (the embedding column of the two packages agrees within an ulp;
  the weighted sum normalises those scores);
* ``hybrid`` with ``rrf``: the same key sets, scores within rel 1e-5 (RRF
  scores are rank functions, equal when the ranks are);
* every mode also equals the single-node oracles of ``tests/test_hybrid.py``
  / ``tests/test_replication.py`` within rel 1e-5 (exact at R = worker
  count);
* a port leader over a JAX worker, through a real ``CoordinationServer``
  of either package: the oracle within rel 1e-5;
* failover at R = 2: after a port worker's data plane dies every reply
  equals the baseline within rel 1e-5 and none is degraded.
"""

import json
import time
import urllib.request

import pytest

from tests.test_cluster import wait_until
from tests.test_hybrid import DOCS, QUERIES, _hybrid_oracle
from tests.test_replication import _CFG, _mk_cluster, _oracle, _stop_all
from tfidf_tpu.cluster.coordination import CoordinationClient as JaxClient
from tfidf_tpu.cluster.coordination import CoordinationCore as JaxCore
from tfidf_tpu.cluster.coordination import CoordinationServer as JaxServer
from tfidf_tpu.cluster.node import SearchNode as JaxNode
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu.utils.metrics import global_metrics as jax_metrics
from tfidf_tpu_torch.cluster import fusion
from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  CoordinationCore,
                                                  CoordinationServer,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.node import SearchNode
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.metrics import global_metrics

MODES = [("sparse", None), ("dense", None), ("hybrid", "rrf"),
         ("hybrid", "wsum")]


def port_node(coord, root, i):
    """One port node on the CPU with the replication suite's knobs."""
    cfg = Config(documents_path=str(root / f"pn{i}" / "documents"),
                 index_path=str(root / f"pn{i}" / "index"), port=0, **_CFG)
    return SearchNode(cfg, coord=coord, device="cpu").start()


def port_fleet(core, root, n=3):
    nodes = [port_node(LocalCoordination(core, 0.1), root, i)
             for i in range(n)]
    assert wait_until(lambda: len(
        nodes[0].registry.get_all_service_addresses()) == n - 1)
    return nodes


def upload(leader, docs=DOCS):
    body = json.dumps([{"name": k, "text": v} for k, v in docs.items()])
    req = urllib.request.Request(leader.url + "/leader/upload-batch",
                                 data=body.encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        return json.loads(r.read())


def search(url, q, mode="sparse", method=None):
    """POST /leader/start -> (doc -> score map, reply headers)."""
    body = {"query": q}
    if mode != "sparse":
        body["mode"] = mode
    if method is not None:
        body["fusion"] = method
    req = urllib.request.Request(url + "/leader/start",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        return json.loads(r.read()), dict(r.headers)


def assert_close(got, want, ctx=""):
    assert set(got) == set(want), (
        f"{ctx}: missing={set(want) - set(got)} "
        f"extra={set(got) - set(want)}")
    for name, s in want.items():
        assert got[name] == pytest.approx(s, rel=1e-5), (ctx, name)


def oracles(root):
    """Single-node oracles over the whole corpus, per (mode, fusion)."""
    out = {("sparse", None): _oracle(root / "o-sparse", docs=DOCS,
                                     queries=QUERIES),
           ("dense", None): _hybrid_oracle(root, "o-dense", "dense", "rrf")}
    for method in fusion.FUSION_METHODS:
        out[("hybrid", method)] = _hybrid_oracle(root, f"o-{method}",
                                                 "hybrid", method)
    return out


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """A port-only fleet and a JAX-only fleet (leader + two workers
    each, R = 2), the same documents uploaded to both."""
    root = tmp_path_factory.mktemp("fleets")
    pcore = CoordinationCore(session_timeout_s=0.5)
    jcore = JaxCore(session_timeout_s=0.5)
    port = jax_fleet = []
    try:
        port = port_fleet(pcore, root / "port")
        jax_fleet = _mk_cluster(jcore, root / "jax", n=3)
        placed = upload(port[0]), upload(jax_fleet[0])
        yield port, jax_fleet, placed, oracles(root)
    finally:
        _stop_all(port)
        _stop_all(jax_fleet)
        pcore.close()
        jcore.close()


def test_uploads_place_alike(fleets):
    """Both leaders place every document on both workers (R = 2)."""
    (pp, jp) = fleets[2]
    assert sorted(pp["placed"].values()) == sorted(jp["placed"].values()) \
        == [len(DOCS)] * 2


@pytest.mark.parametrize("mode,method", MODES)
def test_port_fleet_answers_as_jax_fleet(fleets, mode, method):
    port, jax_fleet, _, want = fleets
    for q in QUERIES:
        got, hdrs = search(port[0].url, q, mode, method)
        ref, ref_hdrs = search(jax_fleet[0].url, q, mode, method)
        ctx = f"{mode}/{method}: {q}"
        assert hdrs.get("X-Search-Stages") == ref_hdrs.get(
            "X-Search-Stages"), ctx
        assert hdrs.get("X-Proto-Version") == ref_hdrs.get(
            "X-Proto-Version")
        assert "X-Scatter-Degraded" not in hdrs, ctx
        assert "X-Compute-Degraded" not in hdrs, ctx
        if mode == "sparse":
            assert got == ref, ctx          # bitwise (see module doc)
        else:
            assert_close(got, ref, ctx)
        assert_close(got, want[(mode, method)][q], ctx + " vs oracle")


def test_port_fleet_served_by_port_workers(fleets):
    """The port workers scored the batches (the port's own metrics
    registry counts them): the answers above came from port engines."""
    port = fleets[0]
    snap = json.loads(urllib.request.urlopen(
        port[1].url + "/api/metrics", timeout=10).read())
    assert snap.get("worker_batch_search_count", 0) > 0
    assert global_metrics.snapshot()["worker_batch_search_count"] > 0


@pytest.mark.parametrize("coord_pkg", ["jax", "port"])
def test_port_leader_over_jax_worker(tmp_path, coord_pkg):
    """A port leader, one JAX worker and one port worker over a real
    HTTP coordination service of either package: the packages speak the
    same wire (protover, the packed top-k arrays), and the replies equal
    the single-node oracles."""
    server_cls = JaxServer if coord_pkg == "jax" else CoordinationServer
    server = server_cls(host="127.0.0.1", port=0,
                        session_timeout_s=2.0).start()
    nodes = []
    try:
        kw = dict(_CFG)
        leader = SearchNode(
            Config(documents_path=str(tmp_path / "l" / "documents"),
                   index_path=str(tmp_path / "l" / "index"), port=0, **kw),
            coord=CoordinationClient(server.address,
                                     heartbeat_interval_s=0.2),
            device="cpu").start()
        nodes.append(leader)
        assert wait_until(leader.is_leader, timeout=10.0)
        nodes.append(JaxNode(
            JaxConfig(documents_path=str(tmp_path / "j" / "documents"),
                      index_path=str(tmp_path / "j" / "index"), port=0,
                      **kw),
            coord=JaxClient(server.address,
                            heartbeat_interval_s=0.2)).start())
        nodes.append(port_node(CoordinationClient(
            server.address, heartbeat_interval_s=0.2), tmp_path, 9))
        assert wait_until(lambda: len(
            leader.registry.get_all_service_addresses()) == 2,
            timeout=10.0)
        placed = upload(leader)["placed"]
        assert placed == {nodes[1].url: len(DOCS), nodes[2].url: len(DOCS)}
        batches = jax_metrics.snapshot().get("worker_batch_search_count", 0)
        want = oracles(tmp_path)
        for mode, method in MODES:
            for q in QUERIES:
                got, hdrs = search(leader.url, q, mode, method)
                assert "X-Scatter-Degraded" not in hdrs
                assert_close(got, want[(mode, method)][q],
                             f"{mode}/{method}: {q}")
        # the JAX worker served slices of these requests
        assert jax_metrics.snapshot()["worker_batch_search_count"] > batches
    finally:
        _stop_all(nodes)
        server.close()


def test_failover_at_r2_keeps_the_baseline(tmp_path):
    """A port of tests/test_replication.py's worker-death case: R = 2,
    one port worker's data plane dies (HTTP down, session alive), and
    every later reply equals the baseline with no degraded reply."""
    core = CoordinationCore(session_timeout_s=0.5)
    nodes = []
    try:
        nodes = port_fleet(core, tmp_path)
        leader = nodes[0]
        upload(leader)
        base = {(m, f, q): search(leader.url, q, m, f)[0]
                for m, f in MODES for q in QUERIES}
        victim = nodes[1]
        victim.httpd.shutdown()
        victim.httpd.server_close()
        cls = victim.httpd.RequestHandlerClass

        def dead(handler):
            raise ConnectionResetError("worker killed (test)")
        cls.do_POST = dead
        cls.do_GET = dead
        before = global_metrics.get("scatter_failovers")
        deadline = time.monotonic() + 30.0
        for _ in range(3):
            for (m, f, q), want in base.items():
                assert time.monotonic() < deadline
                got, hdrs = search(leader.url, q, m, f)
                assert "X-Scatter-Degraded" not in hdrs, (m, f, q)
                assert_close(got, want, f"{m}/{f}: {q}")
        assert (global_metrics.get("scatter_failovers") > before
                or global_metrics.get("scatter_last_circuit_open") > 0)
    finally:
        _stop_all(nodes)
        core.close()
