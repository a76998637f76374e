"""Whole-cluster power loss under disk faults, against port processes.

A port of ``tests/test_storage.py``'s slow ``TestChaosPowerloss``: a
durable coordinator (``--data-dir``), a leader and two workers as
``python -m tfidf_tpu_torch`` processes on the CPU (``jax`` and
``tfidf_tpu`` unimportable in them) run an upload/search workload with the
disk nemesis armed through ``TFIDF_STORAGE_NEMESIS`` (torn writes on the
documents dirs, read by ``tfidf_tpu_torch/utils/storage.py``); mid-workload
every process is SIGKILLed at once, the coordinator with them, and
everything restarts on the same dirs and ports. The bar is the JAX job's:
zero acked-upload loss and exact parity (rel 1e-5) of every post-restart
search with the JAX package's single-node oracle (R=2 over two workers:
every worker holds the corpus). The disk nemesis is armed from the first
process on, so the baseline before any fault is the empty fleet's, held
to the JAX oracle of an empty corpus.
"""

import json
import os
import signal
import threading
import time
import urllib.request

import pytest

from tests.test_torch_chaos_compute import chaos_env
from tfidf_tpu.engine.engine import Engine
from tfidf_tpu.utils.config import Config
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _free_port, _kill_all, _wait_until


def _post(url, data, timeout=60.0):
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


@pytest.mark.slow
class TestChaosPowerloss:
    @pytest.mark.timeout(300)
    def test_sigkill_whole_cluster_zero_acked_loss(self, tmp_path):
        """A correlated restart of everything under a hostile disk:
        SIGKILL every process at once mid-upload, restart on the same
        dirs, and no acked upload is lost; every search equals the
        single-node oracle."""
        env = chaos_env(tmp_path, {
            "TFIDF_REPLICATION_FACTOR": "2",
            "TFIDF_TOP_K": "200",
            "TFIDF_SESSION_TIMEOUT_S": "1.0",
            "TFIDF_HEARTBEAT_INTERVAL_S": "0.2",
            "TFIDF_RECONCILE_SWEEP_INTERVAL_S": "0.5",
            "TFIDF_MIN_DOC_CAPACITY": "64",
            "TFIDF_MIN_NNZ_CAPACITY": "4096",
            "TFIDF_MIN_VOCAB_CAPACITY": "1024",
            "TFIDF_QUERY_BATCH": "8",
            "TFIDF_MAX_QUERY_TERMS": "8",
            # exercise the checkpoint restore path across the restart
            "TFIDF_CHECKPOINT_INTERVAL_S": "1.0",
            # the disk is hostile for the WHOLE run: occasional torn
            # writes on the raw document stores (an affected upload
            # fails un-acked; the contract is about what was ACKED)
            "TFIDF_STORAGE_NEMESIS": json.dumps([
                {"kind": "torn_write", "glob": "*documents*",
                 "probability": 0.04},
            ]),
        })
        tmp = str(tmp_path)
        coord_port = _free_port()
        coord_dir = str(tmp_path / "coord")
        ports = [_free_port() for _ in range(3)]
        procs: list = []

        def wait_pred(pred, timeout=120.0, interval=0.2):
            _wait_until(pred, timeout, interval)
            return True

        def boot_cluster():
            return bench_modes._start_cluster(
                procs, env, tmp, n_workers=2, coord=coord_port,
                ports=ports, coord_args=("--data-dir", coord_dir),
                timeout=120.0)[2]

        oracle_cfg = Config(
            documents_path=str(tmp_path / "oracle" / "docs"),
            index_path=str(tmp_path / "oracle" / "index"),
            top_k=200, min_doc_capacity=64,
            min_nnz_capacity=4096, min_vocab_capacity=1024,
            query_batch=8, max_query_terms=8)
        oracle = Engine(oracle_cfg)

        texts = {f"pl{i}.txt":
                 f"common uniq{i} word{i % 5} tail{i % 11}"
                 for i in range(120)}
        queries = ["common", "word1 uniq7", "tail3", "uniq42 common"]
        acked: set = set()
        ambiguous: set = set()
        try:
            urls = boot_cluster()
            # before any upload: the empty fleet answers as the oracle of
            # an empty corpus
            for q in queries:
                got = json.loads(_post(urls[0] + "/leader/start",
                                       json.dumps({"query": q}).encode()))
                assert got == {h.name: float(h.score)
                               for h in oracle.search(q, k=200)}, q
            names = sorted(texts)
            batches = [names[lo:lo + 10]
                       for lo in range(0, len(names), 10)]

            stop = threading.Event()

            def workload():
                for group in batches:
                    if stop.is_set():
                        ambiguous.update(group)
                        continue
                    body = json.dumps(
                        [{"name": n, "text": texts[n]}
                         for n in group]).encode()
                    try:
                        resp = json.loads(_post(
                            urls[0] + "/leader/upload-batch", body))
                        bad = set(resp.get("failed", ())) \
                            | {s["name"]
                               for s in resp.get("skipped", ())}
                        acked.update(n for n in group if n not in bad)
                        ambiguous.update(bad)
                    except Exception:
                        ambiguous.update(group)
                    try:
                        _post(urls[0] + "/leader/start",
                              json.dumps({"query": "common"}).encode(),
                              timeout=30.0)
                    except Exception:
                        pass

            t = threading.Thread(target=workload, daemon=True)
            t.start()
            time.sleep(4.0)   # well into the upload stream
            # ---- POWER LOSS: kill -9 EVERYTHING at once ----
            stop.set()
            for p in procs:
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
            for p in procs:
                p.wait(timeout=10)
            t.join(timeout=30)
            procs.clear()
            assert acked, "workload never acked anything before the kill"

            # ---- full restart on the same dirs ----
            urls = boot_cluster()
            pending = sorted(set(texts) - acked)
            deadline = time.monotonic() + 90
            while pending and time.monotonic() < deadline:
                body = json.dumps([{"name": n, "text": texts[n]}
                                   for n in pending[:20]]).encode()
                try:
                    resp = json.loads(_post(
                        urls[0] + "/leader/upload-batch", body))
                    bad = set(resp.get("failed", ())) | {
                        s["name"] for s in resp.get("skipped", ())}
                    done = [n for n in pending[:20] if n not in bad]
                    pending = [n for n in pending if n not in done]
                except Exception:
                    time.sleep(1.0)
            assert not pending, f"could not settle {len(pending)} docs"

            # ---- the bar: zero acked loss, exact oracle parity ----
            for n, txt in texts.items():
                oracle.ingest_text(n, txt)
            oracle.commit()

            def parity(q):
                want = {h.name: float(h.score)
                        for h in oracle.search(q, k=200)}
                got = {n: float(s) for n, s in json.loads(_post(
                    urls[0] + "/leader/start",
                    json.dumps({"query": q}).encode())).items()}
                assert set(got) == set(want), \
                    (q, set(want) - set(got), set(got) - set(want))
                for n, s in want.items():
                    assert got[n] == pytest.approx(s, rel=1e-5), \
                        (q, n, got[n], s)
                return True

            for q in queries:
                wait_pred(lambda q=q: parity(q), timeout=120,
                          interval=1.0)
            for i in range(120):
                n = f"pl{i}.txt"
                if n not in acked:
                    continue
                got = json.loads(_post(
                    urls[0] + "/leader/start",
                    json.dumps({"query": f"uniq{i}"}).encode()))
                assert n in got, f"ACKED {n} lost through power loss"
        finally:
            _kill_all(procs)
