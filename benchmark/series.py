"""Run one cell several times, one process a run, and summarize.

    python3 benchmark/series.py --workload wiki1m.b512 --seeds 11,12,13 \\
        --seconds 10 [--trace 0] [--out runs/b512.jsonl]

Each run is ``benchmark/run.py`` in a fresh process, as the benchmark's
check runs it. Every result line goes to ``--out`` (JSON lines, with the
run's wall seconds and the end of its standard error), and a summary per
metric to standard output: the values, the median and the spread (the
distance between the quartiles over the median) with and without each
set's first run.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from harness import stats

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(v):
    return stats.spread(v) if len(v) > 1 else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    rows = []
    for seed in [int(s) for s in a.seeds.split(",")]:
        cmd = [sys.executable, os.path.join(HERE, "run.py"),
               "--workload", a.workload, "--seed", str(seed),
               "--seconds", str(a.seconds), "--trace", str(a.trace)]
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True)
        wall = time.time() - t0
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        try:
            res = json.loads(last)
        except json.JSONDecodeError:
            res = None
        row = {"seed": seed, "rc": p.returncode, "wall_s": wall,
               "result": res, "stderr_tail": p.stderr[-3000:]}
        rows.append(row)
        if a.out:
            os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
        brief = ({k: v["value"] for k, v in res["metrics"].items()}
                 if res else p.stderr[-1500:])
        print(f"seed {seed} rc {p.returncode} wall {wall:.1f}s correct "
              f"{res and res['correct']} {brief}", flush=True)
        if res:
            print("  compared", {k: v["value"] for k, v
                                 in res["compared"].items()},
                  "peak", res["device"]["memory_peak_bytes"], flush=True)
    ok = [r["result"] for r in rows if r["result"]]
    names = sorted({k for r in ok for k in r["metrics"]})
    for n in names:
        v = [r["metrics"][n]["value"] for r in ok if n in r["metrics"]]
        print(f"{n}: median {statistics.median(v)!r} spread {spread(v)!r} "
              f"spread-without-first {spread(v[1:])!r} values {v}")
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
