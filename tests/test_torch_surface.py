"""The port's operator and test-hook surface, held against the JAX
package: routes no other port test calls (readiness, the device-nemesis
API, cluster delete, the Prometheus alias, the ensemble status) and the
hooks and helpers the reference's own tests use (partition shapes, the
frozen placement view, length quantization, the analyzer factory,
latency quantiles, phase timings). Each runs on both packages with the
same inputs and must answer the same way."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from tests.test_cluster import wait_until


def _get(base, path, timeout=30.0):
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _post(base, path, data, timeout=30.0):
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _start_node(pkg, tmp_path):
    """A single leader node of ``pkg`` ("port" or "jax") with the device
    nemesis API on."""
    if pkg == "port":
        from tfidf_tpu_torch.cluster.coordination import (
            CoordinationCore, LocalCoordination)
        from tfidf_tpu_torch.cluster.node import SearchNode
        from tfidf_tpu_torch.utils.config import Config
        kw = {"device": "cpu"}
    else:
        from tfidf_tpu.cluster.coordination import (CoordinationCore,
                                                    LocalCoordination)
        from tfidf_tpu.cluster.node import SearchNode
        from tfidf_tpu.utils.config import Config
        kw = {}
    cfg = Config(documents_path=str(tmp_path / pkg / "docs"),
                 index_path=str(tmp_path / pkg / "index"), port=0,
                 min_doc_capacity=64, min_nnz_capacity=1 << 12,
                 min_vocab_capacity=1 << 10, query_batch=8,
                 max_query_terms=8, device_nemesis_api=True)
    core = CoordinationCore(session_timeout_s=1.0)
    node = SearchNode(cfg, coord=LocalCoordination(core, 0.1),
                      **kw).start()
    assert wait_until(lambda: node.is_leader(), timeout=10.0)
    return node, core


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("surface")
    started = {pkg: _start_node(pkg, tmp) for pkg in ("port", "jax")}
    yield {pkg: node for pkg, (node, _core) in started.items()}
    for node, core in started.values():
        node.stop()
        core.close()


def _both(nodes, fn):
    return fn(nodes["port"]), fn(nodes["jax"])


def test_ready_route(nodes):
    port, jax = _both(nodes, lambda n: _get(n.url, "/api/ready"))
    assert port[0] == jax[0] == 200
    assert json.loads(port[2]) == json.loads(jax[2])


def test_device_nemesis_route_arms_reports_and_clears(nodes):
    def drive(n):
        st1, _, armed = _post(n.url, "/api/device-nemesis",
                              b'{"script": "score_ell:transient::count=1"}')
        st2, _, snap = _get(n.url, "/api/device-nemesis")
        st3, _, cleared = _post(n.url, "/api/device-nemesis",
                                b'{"clear": true}')
        return ((st1, st2, st3), json.loads(armed)["armed"],
                json.loads(snap)["rules"][0]["site"],
                json.loads(cleared)["armed"])
    port, jax = _both(nodes, drive)
    assert port == jax == ((200, 200, 200), True, "score_ell", False)


def test_leader_delete_route(nodes):
    body = json.dumps({"names": ["absent.txt"]}).encode()
    port, jax = _both(nodes, lambda n: _post(n.url, "/leader/delete",
                                             body))
    assert port[0] == jax[0] == 200
    assert json.loads(port[2]) == json.loads(jax[2])


def test_prometheus_alias_route(nodes):
    """Both aliases answer in the Prometheus text format; every family the
    reference's idle leader exports, the port's exports too."""
    port, jax = _both(nodes, lambda n: _get(n.url, "/metrics"))
    assert port[0] == jax[0] == 200
    assert port[1].get("Content-Type") == jax[1].get("Content-Type")

    def families(text):
        return {line.split()[2] for line in text.decode().splitlines()
                if line.startswith("# TYPE ")}
    assert families(jax[2]) and families(jax[2]) <= families(port[2])


def test_ensemble_status_route(tmp_path):
    """A one-member ensemble of each package elects itself and reports
    the same status fields."""
    import socket

    from tfidf_tpu.cluster.coordination import \
        CoordinationServer as JaxServer
    from tfidf_tpu_torch.cluster.coordination import CoordinationServer

    got = []
    for name, cls in (("port", CoordinationServer), ("jax", JaxServer)):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        srv = cls(port=port, data_dir=str(tmp_path / name), node_id="n0",
                  peers={"n0": f"127.0.0.1:{port}"},
                  election_timeout_s=0.2, heartbeat_interval_s=0.05,
                  wal_fsync=False).start()
        try:
            base = f"http://127.0.0.1:{port}"
            assert wait_until(lambda: json.loads(_get(
                base, "/ensemble/status")[2]).get("role") == "leader",
                timeout=10.0)
            st, _, body = _get(base, "/ensemble/status")
            got.append((st, sorted(json.loads(body))))
        finally:
            srv.close()
    assert got[0] == got[1] and got[0][0] == 200


def test_nemesis_one_way_and_isolate_as_the_reference():
    from tfidf_tpu.cluster.nemesis import NemesisNet as JaxNet
    from tfidf_tpu.cluster.nemesis import \
        NemesisPartitioned as JaxPartitioned
    from tfidf_tpu_torch.cluster.nemesis import (NemesisNet,
                                                 NemesisPartitioned)

    links = [("h:1", "h:2"), ("h:2", "h:1"), ("h:1", "h:3"),
             ("h:3", "h:2"), ("h:1", "h:1"), ("h:3", "h:4")]

    def outcomes(net_cls, err):
        out = []
        for arm in (lambda n: n.one_way("h:1", "h:2"),
                    lambda n: n.isolate(["h:1", "h:2"])):
            net = net_cls()
            arm(net)
            row = []
            for src, dst in links:
                try:
                    net.check_send(src, dst)
                    row.append("flows")
                except err:
                    row.append("dropped")
            out.append(row)
        return out

    got = outcomes(NemesisNet, NemesisPartitioned)
    assert got == outcomes(JaxNet, JaxPartitioned)
    assert got[0][:2] == ["dropped", "flows"]
    assert got[1] == ["flows", "flows", "dropped", "dropped", "flows",
                      "flows"]


def test_frozen_placement_view_goes_stale_and_heals():
    from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                      LocalCoordination)
    from tfidf_tpu_torch.cluster.placement import (PlacementFollower,
                                                   PlacementMap)

    core = CoordinationCore(session_timeout_s=5.0)
    ca, cb = LocalCoordination(core, 0.1), LocalCoordination(core, 0.1)
    pm = PlacementMap(flush_ms=0.0, name="auth")
    pm.bind_store(lambda: ca)
    pm.set_persist_enabled(True)
    pm.epoch = 7
    with pm.lock:
        pm.route_locked("a", ["http://w1"], {"http://w1": 0}, None, 1)
    pm.leg_success("a", "http://w1")
    assert pm.flush()
    f = PlacementFollower(refresh_ms=30.0, stale_ms=200.0)
    f.bind_store(lambda: cb)
    f.start()
    try:
        assert not f.suspect()
        f.freeze()
        assert wait_until(lambda: f.suspect(), timeout=5.0)
        assert f.view_snapshot()["stale"]
        f.unfreeze()
        assert wait_until(lambda: not f.suspect(), timeout=5.0)
    finally:
        f.stop()
        ca.close()
        cb.close()
        core.close()


def test_quantize_length_as_the_reference():
    from tfidf_tpu.models.bm25 import quantize_length as jax_q
    from tfidf_tpu_torch.models.bm25 import quantize_length

    for n in list(range(0, 300)) + [1000, 4096, 65535, 1 << 20, 1 << 30]:
        assert quantize_length(n) == jax_q(n), n


def test_make_analyzer_as_the_reference():
    from tfidf_tpu.ops.analyzer import make_analyzer as jax_make
    from tfidf_tpu_torch.ops.analyzer import make_analyzer

    text = "The quick brown fox, the LAZY dog; a fox again"
    for kw in ({}, {"stopwords": ["the", "a"]}, {"lowercase": False},
               {"max_token_length": 3}):
        assert make_analyzer(**kw).counts(text) == \
            jax_make(**kw).counts(text), kw


def test_metrics_quantile_as_the_reference():
    from tfidf_tpu.utils.metrics import Metrics as JaxMetrics
    from tfidf_tpu_torch.utils.metrics import Metrics

    xs = np.random.default_rng(3).lognormal(-3.0, 1.0, 2000)
    ours, theirs = Metrics(), JaxMetrics()
    for x in xs:
        ours.observe("lat", float(x))
        theirs.observe("lat", float(x))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile("lat", q) == theirs.quantile("lat", q)
    assert ours.quantile("nothing", 0.5) is None


def test_phase_timings_reads_the_phase_histograms():
    from tfidf_tpu_torch.utils.metrics import global_metrics
    from tfidf_tpu_torch.utils.tracing import phase_timings, trace_phase

    with trace_phase("surface_probe"):
        pass
    got = phase_timings()
    assert got["phase_surface_probe_count"] >= 1
    assert all(k.startswith("phase_") for k in got)
    assert set(got) <= set(global_metrics.snapshot())
