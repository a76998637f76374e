"""The client process's stalls inside ``--overload``'s windows, with the
cyclic GC on and off, on one card.

``chip_smoke.py``'s phase 11 runs ``--overload``'s autopilot fleet at its
cut (``MODE_CUTS``), with closed-loop clients that are threads of its own
process, after ten phases have filled that process's heap; the fleet's
live-histogram gate holds the clients' p50/p99 against the router's. This
probe reads what the collector costs there: it builds phase 3's engine at
the north star and keeps it alive (the heap), reads the heap
(``chip_smoke.heap_stalls``), then runs the same fleet with the collector
on, then off, ``ROUNDS`` times, and records for each run every
window's collections and ticker lateness (``bench_modes.CLIENT_STALLS``)
beside the live-histogram cross-check: its client and router quantiles,
or the disagreement it raised (recorded, not a failure of the probe).
Prints the card's name and power limit first; the record goes to
``<--out>/stalls.json``.

    python3 probe_client_stalls.py --out chiprun_out/stalls
"""
import argparse
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tfidf_tpu_torch import bench_modes as BM  # noqa: E402

DISAGREE = "live histogram quantiles disagree"
ROUNDS = 2          # fleets with the collector on, then off, each


def overload_run(corpus, rng, sizes: dict, collector: bool) -> dict:
    """One autopilot fleet at ``sizes`` with the collector ``collector``:
    its windows' stalls and the cross-check's outcome."""
    n0 = len(BM.CLIENT_STALLS)
    if not collector:
        gc.disable()
    t0 = time.perf_counter()
    try:
        run = BM.bench_overload(rng, autopilot=True, corpus=corpus, **sizes)
        check = run["live_histogram_check"]
    except RuntimeError as e:
        if DISAGREE not in str(e):
            raise
        check = {"disagreed": str(e)}
    finally:
        gc.enable()
    rec = {"gc": collector, "seconds": time.perf_counter() - t0,
           "check": check, "windows": BM.CLIENT_STALLS[n0:]}
    cs.log(f"[stalls] gc {'on' if collector else 'off'}: {rec}")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=cs.SEED)
    ap.add_argument("--out", default=os.path.join("build", "stalls"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_client_stalls: CUDA is not available; this run needs "
              "one card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    from tfidf_tpu_torch import kernels
    kernels.build_all()
    # the heap: phase 3's engine and context, alive through every run
    heap = cs.main_path(args.seed, cs.draw_corpus(args.seed, cs.NS_DOCS))
    out = {"device": card, "heap": cs.heap_stalls(), "runs": []}
    cs.log(f"[stalls] heap with phase 3 alive: {out['heap']}")
    sizes = {k: v for k, v in cs.MODE_CUTS["overload"].items()
             if k != "static"}
    # overload_main's draws: one corpus for every run
    rng = np.random.default_rng(BM.SEED)
    corpus = (BM.make_texts(rng, sizes["n_docs"], BM.OV_VOCAB,
                            BM.OV_AVG_LEN),
              BM.make_queries(rng, BM.OV_VOCAB, BM.OV_QUERY_POOL))
    for _ in range(ROUNDS):
        for collector in (True, False):
            out["runs"].append(overload_run(corpus, rng, sizes, collector))
    del heap
    out["sizes"] = sizes
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "stalls.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    cs.log(f"[stalls] done in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
