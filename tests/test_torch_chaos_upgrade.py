"""The rolling upgrade under chaos, against port nodes in this process.

A port of ``tests/test_upgrade.py``'s slow ``TestChaosUpgrade``: a port
``CoordinationCore`` with 1 s sessions, three ``port_node``\\ s at R=3 on
``device="cpu"`` (node 2 the "new binary", ``proto_min_compat`` at the
port's ``PROTO_VERSION``), a ``port_router``, two zipfian readers and a
writer on disjoint tokens. The schedule: a version-skew window (the
port's ``global_nemesis.skew``), a partition with the port's
``global_storage`` ``fsync_eio`` riding along, then a rolling restart of
the workers, the router and the leader onto the raised floor. Every
assertion of the JAX job stays: membership parity after each step, proto
rejections and header masks rising while ``breaker_opened`` does not,
zero acked-write loss, final score-exact parity against the JAX
package's single-node ``_oracle`` over the resolved corpus, ``ok >=
100``, shed at most half, no proto rejection of a reader, and the
upgraded front door's refusal of the pre-versioning wire. Every counter
is read from the port's ``global_metrics``; every request of the job
goes through the port's transport seams.

The helpers are ``tests/test_torch_chaos_partition.py``'s, as the JAX job
imports ``tests/test_partition.py``'s and ``tests/test_router.py``'s.
"""

import json
import random
import threading
import time
import urllib.error

import pytest

from tests.test_cluster import wait_until
from tests.test_partition import DOCS, QUERIES, _oracle, _parity, _stop_all
from tests.test_torch_chaos_partition import (assert_port, heal_port_faults,
                                              port_node, port_router,
                                              search, upload_docs)
from tests.test_upgrade import _raw
from tfidf_tpu_torch.cluster.coordination import CoordinationCore
from tfidf_tpu_torch.cluster.nemesis import global_nemesis
from tfidf_tpu_torch.cluster.node import http_post
from tfidf_tpu_torch.cluster.protover import (PROTO_REJECTED_HEADER,
                                              PROTO_STATUS, PROTO_VERSION)
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.storage import global_storage

_heal_port = pytest.fixture(autouse=True)(heal_port_faults)


@pytest.mark.slow
class TestChaosUpgrade:
    @pytest.mark.timeout(420)
    def test_rolling_upgrade_zero_loss_exact_parity(self, tmp_path):
        """Workers -> router -> leader restart one at a time under live
        zipfian read load and a write stream, with a version-skew
        window, a partition, and a storage fault riding along. The port
        fleet must stay exact the whole way: zero acked-write loss,
        bounded shed, oracle parity after every step, and the skew
        window must surface as proto rejections — never as breaker
        trips."""
        core = CoordinationCore(session_timeout_s=1.0)
        kw = dict(replication_factor=3, rpc_max_attempts=2,
                  breaker_failure_threshold=3, breaker_reset_s=0.5)
        # a mixed fleet from the start: node 2 is the "new binary"
        # whose floor already requires the versioned wire
        nodes = [port_node(core, tmp_path, i, device="cpu",
                           proto_min_compat=(PROTO_VERSION if i == 2
                                             else 1), **kw)
                 for i in range(3)]
        router = port_router(core, **kw)
        assert_port(*nodes, router, core)
        front = {"url": router.url}
        stop_evt = threading.Event()
        lock = threading.Lock()
        acked = {}                       # name -> text, confirmed 200
        attempted = {}                   # name -> text, sent at all
        counts = {"ok": 0, "shed": 0, "proto": 0, "err": 0}
        threads = []
        try:
            wait_until(lambda: len(
                nodes[0].registry.get_all_service_addresses()) == 2,
                timeout=20)
            assert wait_until(lambda: any(nd.is_leader() for nd in nodes),
                              timeout=20)
            leader = next(nd for nd in nodes if nd.is_leader())
            # the oracle is over the STATIC corpus only — the write
            # stream uses disjoint tokens, so parity probes are
            # independent of writer progress
            r = upload_docs(front["url"], DOCS)
            assert r
            # mid-run probes check exact result MEMBERSHIP; score-exact
            # parity is checked at the end, with writes quiesced, against
            # an oracle over the resolved corpus
            want_names = {q: set(o)
                          for q, o in _oracle(tmp_path, DOCS,
                                              QUERIES).items()}

            def settled(q):
                try:
                    return set(search(front["url"], q)) == want_names[q]
                except Exception:
                    return False

            def assert_parity(step):
                for q in QUERIES:
                    assert wait_until(lambda: settled(q), timeout=30), \
                        f"exact results lost after {step}: {q!r}"

            tokens = ["common", "token1", "token3 word0", "word1",
                      "extra2", "common token7", "word2", "token5"]
            zipf_w = [1.0 / (i + 1) for i in range(len(tokens))]

            def reader(seed):
                rng = random.Random(seed)
                while not stop_evt.is_set():
                    q = rng.choices(tokens, weights=zipf_w)[0]
                    try:
                        http_post(front["url"] + "/leader/start",
                                  json.dumps({"query": q}).encode(),
                                  timeout=5.0)
                        k = "ok"
                    except urllib.error.HTTPError as e:
                        k = ("shed" if e.code == 429 else
                             "proto" if e.code == PROTO_STATUS else "err")
                    except Exception:
                        k = "err"
                    with lock:
                        counts[k] += 1
                    time.sleep(0.01)

            def writer():
                k = 0
                while not stop_evt.is_set() and k < 400:
                    name, text = f"up{k}.txt", f"shared uq{k}tok"
                    k += 1
                    with lock:
                        attempted[name] = text
                    try:
                        http_post(
                            front["url"] + "/leader/upload-batch",
                            json.dumps([{"name": name,
                                         "text": text}]).encode(),
                            timeout=8.0)
                        with lock:
                            acked[name] = text
                    except Exception:
                        pass    # ambiguous: never counted as acked
                    time.sleep(0.05)

            threads = [threading.Thread(target=reader, args=(s,),
                                        daemon=True) for s in (1, 2)]
            threads.append(threading.Thread(target=writer, daemon=True))
            for t in threads:
                t.start()
            time.sleep(2.0)
            assert_parity("warmup")

            # ---- mixed-version window: strip the stamp on every link
            # into the raised-floor node. Its 426s must never look like
            # worker faults, so no breaker may open.
            rej0 = global_metrics.get("proto_rejections")
            masks0 = global_metrics.get("nemesis_header_masks")
            opened0 = global_metrics.get("breaker_opened")
            global_nemesis.skew(dst=nodes[2].url)
            time.sleep(3.0)
            assert_parity("version-skew window")
            global_nemesis.heal()
            assert global_metrics.get("nemesis_header_masks") > masks0
            assert global_metrics.get("proto_rejections") > rej0
            assert global_metrics.get("breaker_opened") == opened0, \
                "a proto rejection tripped a breaker"

            # ---- the rest of the chaos rides along: a brief partition
            # around one replica plus a bounded storage fault under it
            global_storage.arm("fsync_eio",
                               str(tmp_path / "pt1") + "/*", times=2)
            global_nemesis.partition(
                [nodes[1].url],
                [nodes[0].url, nodes[2].url, router.url])
            time.sleep(2.0)
            global_nemesis.heal()
            global_storage.heal()
            assert_parity("partition + storage fault")

            # ---- rolling restart, workers first. Each replacement is
            # the upgraded binary: floor raised to the current wire.
            for i, nd in enumerate(list(nodes)):
                if nd.is_leader():
                    continue
                nd.stop()
                assert_parity(f"worker {i} down")
                nodes[i] = port_node(core, tmp_path, i, device="cpu",
                                     proto_min_compat=PROTO_VERSION, **kw)
                assert wait_until(lambda: len(
                    leader.registry.get_all_service_addresses()) == 2,
                    timeout=30)
                assert_parity(f"worker {i} upgraded")

            # ---- router next, surge style (start the upgraded one,
            # move traffic, retire the old) — the front door never goes
            # dark
            new_router = port_router(core, proto_min_compat=PROTO_VERSION,
                                     **kw)
            old_router, front["url"] = router, new_router.url
            router = new_router
            old_router.stop()
            assert_parity("router upgraded")

            # ---- leader last: stop it, let the survivors elect, then
            # bring back the upgraded binary
            li = nodes.index(leader)
            leader.stop()
            assert wait_until(
                lambda: any(nd.is_leader()
                            for j, nd in enumerate(nodes) if j != li),
                timeout=30)
            nodes[li] = port_node(core, tmp_path, li, device="cpu",
                                  proto_min_compat=PROTO_VERSION, **kw)
            leader = next(nd for nd in nodes if nd.is_leader())
            assert wait_until(lambda: len(
                leader.registry.get_all_service_addresses()) == 2,
                timeout=30)
            assert_parity("leader upgraded")
            assert_port(*nodes, router)

            # ---- quiesce the load and verify the end state
            stop_evt.set()
            for t in threads:
                t.join(timeout=15)

            assert_parity("final")
            # zero acked-write loss: every confirmed write answers by its
            # unique token through the upgraded front door. An AMBIGUOUS
            # write (no ack came back) is resolved by the same probe —
            # present or absent, either is legal, but the oracle corpus
            # must match whichever happened.
            resolved = dict(DOCS)
            missing = []
            for name, text in sorted(attempted.items()):
                tok = text.split()[1]

                def present():
                    try:
                        return name in search(front["url"], tok)
                    except Exception:
                        return False
                if name in acked:
                    if not wait_until(present, timeout=15):
                        missing.append((name, tok))
                    else:
                        resolved[name] = text
                elif present():
                    resolved[name] = text
            assert not missing, \
                f"acked writes lost across the upgrade: {missing[:5]}"

            # with writes quiesced and the corpus resolved, parity is
            # score-EXACT against a fresh single-node oracle
            final_want = _oracle(tmp_path / "final", resolved, QUERIES)

            def exact(q):
                try:
                    return _parity(search(front["url"], q),
                                   final_want[q])
                except Exception:
                    return False
            for q in QUERIES:
                assert wait_until(lambda: exact(q), timeout=60), \
                    f"exact score parity lost at the end: {q!r}"

            total = sum(counts.values())
            assert counts["ok"] >= 100, counts
            # bounded shed spike: the rolling restart may shed, but the
            # front door must keep serving
            assert counts["shed"] / max(1, total) <= 0.5, counts
            # readers stamp the current version — the fleet's raised
            # floors never reject them
            assert counts["proto"] == 0, counts

            # the upgrade is complete: the whole fleet (router included)
            # now refuses the pre-versioning wire ...
            with pytest.raises(urllib.error.HTTPError) as ei:
                _raw(front["url"] + "/leader/start",
                     data=json.dumps({"query": "common"}).encode(),
                     headers={"Content-Type": "application/json"})
            assert ei.value.code == PROTO_STATUS
            assert ei.value.headers.get(PROTO_REJECTED_HEADER) == "1"
            # ... while stamped traffic flows
            assert _parity(search(front["url"], "common"),
                           final_want["common"])
        finally:
            stop_evt.set()
            global_nemesis.heal()
            global_storage.heal()
            for t in threads:
                t.join(timeout=15)
            _stop_all(nodes)
            for rt in {router}:
                try:
                    rt.stop()
                except Exception:
                    pass
            core.close()
