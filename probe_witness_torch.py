"""Config 5's served q/s before and after the device witness, on one card.

``chip_smoke.py`` runs phase 12 (the device witness) on phase 3's engine
and phase 10 (the bench's configs, config 5 among them) later in the same
process. This probe asks whether an install and uninstall of the witness
leaves anything behind that slows config 5: in one process it runs
``tfidf_tpu_torch.bench.bench_5m_vocab`` (200,000 docs, a 5M-term
vocabulary, batch 512: phase 10's config 5, whose q/s is the host clock
around one ``search_batch`` of 1,024 queries) and times the same window
``--reps`` more times on that engine; then, with ``--witness``, installs
the witness, serves two batches and uninstalls it (without it, nothing);
then times the window ``--reps`` times again and runs ``bench_5m_vocab``
once more on a fresh engine, as phase 10 does after phase 12. Run it
with and without ``--witness`` to compare. Prints the card's name and
power limit first, one JSON line last; the record goes to
``<--out>/c5_<witness|control>.json``.

    python3 probe_witness_torch.py --witness --out build/witness_c5
    python3 probe_witness_torch.py --out build/witness_c5
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def timed_windows(engine, queries, reps: int) -> list:
    """q/s of ``reps`` more calls of config 5's timed window (one
    ``search_batch`` of the same queries, host clock)."""
    from tfidf_tpu_torch import bench as B
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.search_batch(queries, k=B.TOP_K)
        out.append(len(queries) / (time.perf_counter() - t0))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--witness", action="store_true",
                    help="install and uninstall the device witness between "
                         "the two halves (else the control: nothing)")
    ap.add_argument("--out", default=os.path.join("build", "witness_c5"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("probe_witness_torch: CUDA is not available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from tfidf_tpu_torch import bench as B
    from tfidf_tpu_torch import kernels
    from tfidf_tpu_torch.tools.graftcheck.device_witness import \
        DeviceWitness
    kernels.build_all()
    rng = np.random.default_rng(args.seed + 10)
    keep: dict = {}
    before = B.bench_5m_vocab(rng, keep=keep)
    engine, queries = keep["engine"], keep["queries"]
    steady_before = timed_windows(engine, queries, args.reps)
    middle = None
    if args.witness:
        w = DeviceWitness()
        w.install()
        try:
            for lo in (0, B.C5_BATCH):
                engine.search_batch(queries[lo:lo + B.C5_BATCH], k=B.TOP_K)
        finally:
            w.uninstall()
        w.check(min_observations=1)
        middle = {"observations": w.n_observations(),
                  "syncs": {" ".join(k): v for k, v in w.syncs.items()}}
    steady_after = timed_windows(engine, queries, args.reps)
    del engine, queries, keep
    torch.cuda.empty_cache()
    after = B.bench_5m_vocab(rng)
    res = {"device": smi, "witness": args.witness, "middle": middle,
           "fresh_qps_before": before["qps"],
           "fresh_qps_after": after["qps"],
           "steady_qps_before": steady_before,
           "steady_qps_after": steady_after,
           "steady_median_before": float(np.median(steady_before)),
           "steady_median_after": float(np.median(steady_after))}
    os.makedirs(args.out, exist_ok=True)
    name = "c5_witness.json" if args.witness else "c5_control.json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items()
                      if not k.startswith("steady_qps")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
