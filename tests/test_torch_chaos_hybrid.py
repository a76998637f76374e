"""The owner killed mid-hybrid-scatter under zipfian load, on the port.

A port of ``tests/test_hybrid.py``'s slow ``TestHybridChaos``: a cluster
of port ``SearchNode``\\ s in this process (``device="cpu"``, the
replication suite's knobs, the dense plane on: ``embedding_enabled`` is
the Config default), hybrid (rrf) queries from four client threads over
a zipfian draw of the queries, and one worker's data plane killed
mid-flight. Every 200 either carries ``X-Scatter-Degraded`` or equals the
JAX package's single-node hybrid oracle (``_hybrid_oracle``, rel 1e-5);
before the kill every query's reply equals it, unstamped.
"""

import random
import threading
import urllib.error

import pytest

from tests.test_cluster import wait_until
from tests.test_hybrid import (DOCS, QUERIES, _assert_parity,
                               _hybrid_oracle, _kill_data_plane,
                               _post_search)
from tests.test_replication import _stop_all, _upload_docs
from tests.test_torch_fleet import port_fleet
from tfidf_tpu_torch.cluster.coordination import CoordinationCore


@pytest.fixture
def core():
    c = CoordinationCore(session_timeout_s=0.5)
    yield c
    c.close()


@pytest.mark.slow
class TestHybridChaos:
    @pytest.mark.timeout(180)
    def test_owner_killed_mid_scatter_under_zipfian_load(self, core,
                                                         tmp_path):
        """Hybrid queries under a zipfian query distribution while a
        worker's data plane dies mid-flight: every reply exact or
        honestly degraded, never silently partial."""
        nodes = port_fleet(core, tmp_path, n=3)
        try:
            leader = nodes[0]
            _upload_docs(leader, DOCS)
            want = _hybrid_oracle(tmp_path, "chaos", "hybrid", "rrf")
            for q in QUERIES:
                got, hdrs = _post_search(leader, q, mode="hybrid",
                                         method="rrf")
                assert "X-Scatter-Degraded" not in hdrs, q
                _assert_parity(got, want[q], ctx=q)
            rng = random.Random(17)
            weights = [1.0 / (i + 1) for i in range(len(QUERIES))]
            stop = threading.Event()
            bad: list = []
            done = [0]

            def client():
                while not stop.is_set():
                    q = rng.choices(QUERIES, weights=weights)[0]
                    try:
                        got, hdrs = _post_search(leader, q,
                                                 mode="hybrid",
                                                 method="rrf")
                    except urllib.error.URLError:
                        continue   # shed/refused is honest too
                    if "X-Scatter-Degraded" not in hdrs:
                        try:
                            _assert_parity(got, want[q], ctx=q)
                        except AssertionError as e:
                            bad.append(e)
                    done[0] += 1

            threads = [threading.Thread(target=client)
                       for _ in range(4)]
            for t in threads:
                t.start()
            try:
                wait_until(lambda: done[0] > 20, timeout=20.0)
                _kill_data_plane(nodes[1])   # mid-flight
                wait_until(lambda: done[0] > 120, timeout=30.0)
            finally:
                stop.set()
                for t in threads:
                    t.join(timeout=10.0)
            assert not bad, bad[0]
            assert done[0] > 120
        finally:
            _stop_all(nodes)
