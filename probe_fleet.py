"""Phase 7 of ``chip_smoke.py`` (the fleet, with phase 13's chaos on it)
alone, on one card.

Runs the fleet phase of this tree at the north star, and with
``--parent DIR`` also that of a second tree unpacked in DIR (for example
``git archive <commit> | tar -x -C build/parent``), in turns: parent,
change, change, parent. The corpus, its embedding and the two shard
checkpoints are made once, by this tree; each run starts from a fresh
copy of the shards. Each run's ``fleet_phase`` result goes to
``<--out>/<i>_<tree>/fleet.json`` with its processes' logs, one summary
line per run (``AB {...}``) to stdout and all of them to
``<--out>/summary.json``. A run that fails is recorded with its error and
the next one starts.

    python3 probe_fleet.py --parent build/parent --out chiprun_out/ab
"""
import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tfidf_tpu_torch import kernels  # noqa: E402
from tfidf_tpu_torch.engine.embedder import get_embedder  # noqa: E402

WINDOWS = ("leader_sparse", "leader_dense", "leader_hybrid_rrf",
           "router_sparse")


def load_parent(parent: str):
    """The parent tree's chip_smoke module, its kernels built: its fleet
    processes run the parent's package (``ROOT`` of that module)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_parent", os.path.join(parent, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    subprocess.run([sys.executable, "-c", "from tfidf_tpu_torch import "
                    "kernels; kernels.build_all()"], cwd=parent,
                   env=dict(os.environ, PYTHONPATH=parent), check=True)
    return mod


def summary_row(i: int, tree: str, res: dict, err, seconds: float) -> dict:
    row = {"run": i, "tree": tree, "ok": err is None, "seconds": seconds}
    if err is not None:
        row["error"] = err[:2000]
    for k in WINDOWS:
        if k in res:
            row[k] = {x: res[k].get(x) for x in (
                "qps", "p50_ms", "p99_ms", "scatter_items_per_batch",
                "view_age", "view_refreshes", "device")}
    if "upload" in res:
        row["upload"] = {x: res["upload"][x] for x in (
            "docs_per_s", "upload_to_all_read_s")}
    row["boot"] = res.get("worker_boot_to_serving_s")
    if "chaos" in res:
        row["chaos"] = {k: res["chaos"].get(k) for k in (
            "seconds", "baseline", "to_quarantine_s", "to_sick_s",
            "to_healed_s", "to_converged_s", "to_breaker_s", "outcomes",
            "kill", "launches_v4", "degraded_stamps")}
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked tree to run in turns "
                                     "with this one")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "probe_fleet"))
    ap.add_argument("--work", default=os.path.join(ROOT, "build",
                                                   "probe_fleet_work"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(cs.smi_query("--query-gpu=name,power.limit"), flush=True)
    t0 = time.perf_counter()
    kernels.build_all()
    runs = [("change", cs)]
    if args.parent:
        parent = load_parent(os.path.abspath(args.parent))
        runs = [("parent", parent), ("change", cs), ("change", cs),
                ("parent", parent)]
    print(f"build {time.perf_counter() - t0:.1f}s", flush=True)
    rng = np.random.default_rng(args.seed)
    corpus = cs.make_doc_arrays(rng, cs.NS_DOCS, cs.NS_VOCAB, cs.NS_AVG_LEN)
    rows = cs.embed_corpus(corpus, get_embedder("hash", 64), cs.NS_VOCAB)
    data = {"corpus": corpus, "rows": rows}
    base = os.path.join(args.work, "shards")
    work = os.path.join(args.work, "run")
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(base)
    shards0 = cs.fleet_shards(data, base)
    os.makedirs(args.out, exist_ok=True)
    summary = []
    try:
        for i, (tree, mod) in enumerate(runs):
            shutil.rmtree(work, ignore_errors=True)
            shutil.copytree(base, work)
            shards = [dict(sh, root=sh["root"].replace(base, work))
                      for sh in shards0]
            out = os.path.join(args.out, f"{i}_{tree}")
            os.makedirs(out, exist_ok=True)
            t0 = time.perf_counter()
            res, err = {}, None
            try:
                res = mod.fleet_phase(data, shards, args.seed, work, out)
            except (Exception, SystemExit) as e:
                err = str(e)
            row = summary_row(i, tree, res, err, time.perf_counter() - t0)
            with open(os.path.join(out, "fleet.json"), "w") as f:
                json.dump(res, f, indent=1, default=str)
            print("AB", json.dumps(row, default=str), flush=True)
            summary.append(row)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1, default=str)
    return 0 if all(r["ok"] for r in summary if r["tree"] == "change") else 1


if __name__ == "__main__":
    sys.exit(main())
