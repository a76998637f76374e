"""Sweep one rate of a streaming cell, once, on the card: the cell's set-up
once, then one window per rate, in order, uploads and refreshes running
in each. ``--rates`` sweeps the query rate with the uploads at the mix's
rate; ``--upload-rates`` sweeps the bulk client's requests a second with
the queries at the cell's rate. Prints one JSON line per rate: the
end-to-end metrics, how the bulk client kept its schedule, how late the
query generator ran, and the median query latency of the window's first
and last thirds (a backlog that grows shows as the last third's rising).

    python3 benchmark/sweep.py --workload msmarco_shard.stream --seed 5 \\
        --seconds 10 --rates 50,100,200,400
    python3 benchmark/sweep.py --workload msmarco_shard.stream --seed 5 \\
        --seconds 20 --upload-rates 2.5,5,10,20

The highest rate at which both streams hold is the knee; the cell runs
at four fifths of it (``query_rate`` in its workload file,
``upload_rate`` in its traffic mix).
"""

import argparse
import gc
import json
import os
import sys
import time

import run  # noqa: F401  (the caches and import paths of a run)
from harness import registry, stats  # noqa: E402
from harness.cell import make_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--rates")
    which.add_argument("--upload-rates")
    a = ap.parse_args(argv)
    cell = registry.load(a.workload)
    t0 = time.time()
    r = make_run(cell, a.seed, "cuda", a.seconds)
    gc.collect()
    print(json.dumps({"setup_s": time.time() - t0}), flush=True)
    query_rate = float(cell.workload["query_rate"])
    for rate in [float(x) for x in (a.rates or a.upload_rates).split(",")]:
        if a.rates:
            r.schedule(rate)
        else:
            r.tr["upload_rate"] = rate
            r.schedule(query_rate)
        t1 = time.time()
        r.window(a.seconds)
        ans = sorted(r.answers.values())
        third = max(1, len(ans) // 3)
        lat = [(done - due) * 1e3 for due, _s, done, _e in ans]
        print(json.dumps({
            "rate": rate, "upload_rate": r.tr["upload_rate"],
            "query_rate": rate if a.rates else query_rate,
            "queries": len(ans), "wall_s": time.time() - t1,
            **r.end_to_end(), "uploads": r.uploads(),
            "late_ms": r.lateness_ms(),
            "p50_first_third_ms": stats.median(lat[:third]),
            "p50_last_third_ms": stats.median(lat[-third:]),
            "failed": r.counts()[1]}), flush=True)
    r.batcher.stop()
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
