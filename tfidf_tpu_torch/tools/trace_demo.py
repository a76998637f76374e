"""The tracing layer's demo on the port: start a three-node cluster in one
process, run a tiny workload (uploads and searches, with an owning
worker's data plane killed in the middle of the story so the trace has a
failover to show), and print the rendered trace tree of the last search.

    python -m tfidf_tpu_torch.tools.trace_demo [--device cpu|cuda]

The engines run on ``--device``: by default the CUDA card, and without
CUDA the demo exits with status 2 and the CUDA message; ``cpu`` runs
every kernel's plain PyTorch version. Nothing is written outside a
temporary directory.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
import urllib.request

UPLOADS = 10
ROUNDS = 6          # searches until one shows a ``scatter.slice`` failover


def run(device: str | None = None) -> dict:
    """Run the demo on ``device`` and return ``{"hits", "uploads",
    "trace_id", "spans", "tree"}`` for the last search."""
    from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                      LocalCoordination)
    from tfidf_tpu_torch.cluster.node import SearchNode, http_get, http_post
    from tfidf_tpu_torch.device import resolve_device
    from tfidf_tpu_torch.utils.config import Config
    from tfidf_tpu_torch.utils.tracing import render_trace_tree

    dev = resolve_device(device or "cuda")
    core = CoordinationCore(session_timeout_s=1.0)
    tmp = tempfile.mkdtemp(prefix="trace_demo_")
    cfg_kw = dict(top_k=32, min_doc_capacity=64,
                  min_nnz_capacity=1 << 12, min_vocab_capacity=1 << 10,
                  query_batch=8, max_query_terms=8, rpc_max_attempts=1,
                  result_cache_entries=0, trace_slow_query_ms=1.0)
    nodes = []
    try:
        for i in range(3):
            nodes.append(SearchNode(Config(
                documents_path=f"{tmp}/n{i}/docs",
                index_path=f"{tmp}/n{i}/idx", port=0, **cfg_kw),
                coord=LocalCoordination(core, 0.1), device=dev).start())
        leader = nodes[0]
        deadline = time.monotonic() + 10
        while (len(leader.registry.get_all_service_addresses()) != 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        docs = [{"name": f"d{i}.txt",
                 "text": f"common token{i} word{i % 3}"}
                for i in range(UPLOADS)]
        http_post(leader.url + "/leader/upload-batch",
                  json.dumps(docs).encode())
        http_post(leader.url + "/leader/start",
                  json.dumps({"query": "common"}).encode())

        # kill an OWNING worker's data plane (killing a non-owner
        # exercises no failover): the next search's trace shows the
        # failed scatter.worker span and the scatter.slice re-issue that
        # kept the results complete
        live = frozenset(leader.registry.get_all_service_addresses())
        owners = set(leader.placement.owner_assignment(
            live, frozenset()).owner.values())
        victim = next(nd for nd in nodes[1:] if nd.url in owners)
        victim.httpd.shutdown()
        victim.httpd.server_close()
        cls = victim.httpd.RequestHandlerClass
        cls.do_POST = cls.do_GET = (
            lambda h: (_ for _ in ()).throw(
                ConnectionResetError("worker killed (demo)")))

        tid = hits = spans = None
        for _ in range(ROUNDS):
            req = urllib.request.Request(
                leader.url + "/leader/start",
                data=json.dumps({"query": "common"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                tid = r.headers.get("X-Trace-Id")
                hits = len(json.loads(r.read()))
            time.sleep(0.2)   # let worker-side spans finish into the ring
            spans = json.loads(http_get(
                leader.url + f"/api/trace/{tid}"))["spans"]
            if any(s["name"] == "scatter.slice" for s in spans):
                break
        return {"hits": hits, "uploads": UPLOADS, "trace_id": tid,
                "spans": spans, "tree": render_trace_tree(spans)}
    finally:
        for nd in nodes:
            try:
                nd.stop()
            except Exception:
                pass
        core.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the engines' device (default: the CUDA card)")
    args = ap.parse_args(argv)
    try:
        res = run(args.device)
    except RuntimeError as e:
        if "CUDA is not available" not in str(e):
            raise
        print(str(e), file=sys.stderr)
        return 2
    tid = res["trace_id"]
    print(f"\nsearch returned {res['hits']} of {res['uploads']} hits "
          f"through a mid-request worker kill; trace {tid}:\n")
    print(res["tree"])
    print("\n(the same timeline is available as Perfetto JSON: "
          f"GET /api/trace/{tid}?format=chrome, or "
          "`python -m tfidf_tpu_torch trace <id> --leader ... --chrome "
          "out.json`)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
