"""Clean protocol case: a port leader and two port workers over a real
HTTP coordination service; uploads, searches and a delete drive the core
scatter/mutation rows."""

import json
import time
import urllib.request

CFG = dict(top_k=32, min_doc_capacity=64, min_nnz_capacity=1 << 12,
           min_vocab_capacity=1 << 10, query_batch=8, max_query_terms=8,
           rpc_max_attempts=1, result_cache_entries=0,
           embedding_enabled=False)


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30.0) as r:
        return json.loads(r.read())


def test_fleet_workload(tmp_path):
    from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                      CoordinationServer)
    from tfidf_tpu_torch.cluster.node import SearchNode
    from tfidf_tpu_torch.utils.config import Config
    srv = CoordinationServer(host="127.0.0.1", port=0,
                             session_timeout_s=2.0).start()
    nodes = []
    try:
        for i in range(3):
            nodes.append(SearchNode(
                Config(documents_path=str(tmp_path / f"n{i}" / "docs"),
                       index_path=str(tmp_path / f"n{i}" / "idx"), port=0,
                       **CFG),
                coord=CoordinationClient(srv.address,
                                         heartbeat_interval_s=0.2),
                device="cpu").start())
        leader = nodes[0]
        deadline = time.monotonic() + 10
        while not (leader.is_leader() and len(
                leader.registry.get_all_service_addresses()) == 2):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        post(leader.url + "/leader/upload-batch",
             [{"name": f"d{i}.txt", "text": f"common token{i} word{i % 3}"}
              for i in range(12)])
        for i in range(8):
            assert post(leader.url + "/leader/start",
                        {"query": f"common word{i % 3}"})
        post(leader.url + "/leader/delete", {"names": ["d0.txt"]})
        assert "d0.txt" not in post(leader.url + "/leader/start",
                                    {"query": "common"})
    finally:
        for nd in nodes:
            nd.stop()
        srv.close()
