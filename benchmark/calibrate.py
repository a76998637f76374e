"""Readings that set the limits of ``correct``, on the card at a cell's
own size: for each seed, one set-up and one window as a run makes them,
then the check twice, once with the system's answers (the lower reading)
and once with the control in their place: the reference computed in
TF32 and summed in float32 (the upper reading). One JSON line per seed
and side.

    python3 benchmark/calibrate.py --workload wiki1m.b512 \\
        --seeds 1,2,3 --seconds 5
"""

import argparse
import gc
import json
import os
import sys

import run  # noqa: F401  (the caches and import paths of a run)
from harness import check, registry  # noqa: E402
from harness.cell import make_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    import torch
    cell = registry.load(a.workload)
    for seed in [int(s) for s in a.seeds.split(",")]:
        r = make_run(cell, seed, "cuda", a.seconds)
        gc.collect()
        r.window(a.seconds)
        if hasattr(r, "finish"):
            r.finish()
        r.release()
        gc.collect()
        torch.cuda.empty_cache()
        for side, precision in (("system", "f64"), ("control", "tf32")):
            v = check.Verdict(cell.workload["limits"])
            r.check(v, precision)
            print(json.dumps({"seed": seed, "side": side,
                              "correct": v.correct, "values": v.values}),
                  flush=True)
        del r
        gc.collect()
    return 0


if __name__ == "__main__":
    rc = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)
