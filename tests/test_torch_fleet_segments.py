"""A port fleet whose worker streams segments, against a JAX fleet whose
worker does the same, on the CPU.

Each fleet is a leader and one worker in this process, the worker in
``index_mode="segments"``. The same documents go in through
``/leader/upload`` in three rounds, each closed by searches (the worker
commits pending uploads before it searches, so each round is a segment of
its own), and the same queries go out through ``/leader/start``. The port
fleet's doc -> score map holds the JAX fleet's keys, with scores within
relative 1e-6: each package computes the segment weights with its own
``log1p`` and sum order (``tests/test_torch_segments.py``).
"""

import urllib.request

import pytest

from tests.test_cluster import wait_until
from tests.test_hybrid import DOCS, QUERIES
from tests.test_replication import _CFG, _stop_all
from tests.test_torch_fleet import search
from tfidf_tpu.cluster.coordination import CoordinationCore as JaxCore
from tfidf_tpu.cluster.coordination import LocalCoordination as JaxLocal
from tfidf_tpu.cluster.node import SearchNode as JaxNode
from tfidf_tpu.engine.segments import SegmentedIndex as JaxSegmentedIndex
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.node import SearchNode
from tfidf_tpu_torch.engine.segments import SegmentedIndex
from tfidf_tpu_torch.utils.config import Config

KW = dict(_CFG, index_mode="segments", embedding_enabled=False)


def _fleet(root, core, local, node_cls, cfg_cls, **dev):
    nodes = []
    for i in range(2):
        cfg = cfg_cls(documents_path=str(root / f"n{i}" / "documents"),
                      index_path=str(root / f"n{i}" / "index"), port=0,
                      **KW)
        nodes.append(node_cls(cfg, coord=local(core, 0.1), **dev).start())
    assert wait_until(lambda: len(
        nodes[0].registry.get_all_service_addresses()) == 1)
    return nodes


def _upload(leader, name, text):
    req = urllib.request.Request(
        leader.url + f"/leader/upload?name={name}", data=text.encode(),
        headers={"Content-Type": "text/plain"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        assert r.status == 200


def test_port_segments_worker_answers_as_jax_worker(tmp_path):
    pcore = CoordinationCore(session_timeout_s=0.5)
    jcore = JaxCore(session_timeout_s=0.5)
    port = jax_fleet = []
    try:
        port = _fleet(tmp_path / "port", pcore, LocalCoordination,
                      SearchNode, Config, device="cpu")
        jax_fleet = _fleet(tmp_path / "jax", jcore, JaxLocal, JaxNode,
                           JaxConfig)
        assert isinstance(port[1].engine.index, SegmentedIndex)
        assert isinstance(jax_fleet[1].engine.index, JaxSegmentedIndex)
        items = list(DOCS.items())
        for lo in range(0, len(items), 4):
            for name, text in items[lo:lo + 4]:
                _upload(port[0], name, text)
                _upload(jax_fleet[0], name, text)
            for q in QUERIES:
                got, hdrs = search(port[0].url, q)
                want, _ = search(jax_fleet[0].url, q)
                assert "X-Scatter-Degraded" not in hdrs, q
                assert "X-Compute-Degraded" not in hdrs, q
                assert set(got) == set(want) and got, q
                for name, s in want.items():
                    assert got[name] == pytest.approx(s, rel=1e-6), (q,
                                                                     name)
        segs = port[1].engine.index.snapshot.segments
        assert len(segs) == 3 == len(
            jax_fleet[1].engine.index.snapshot.segments)
        assert port[1].engine.index.num_live_docs == len(DOCS)
    finally:
        _stop_all(port)
        _stop_all(jax_fleet)
        pcore.close()
        jcore.close()
