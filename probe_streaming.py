"""Phase 8 of ``chip_smoke.py`` (streaming segments and tiering) alone, on
one card.

Builds phase 3's corpus and queries from ``--seed`` (the 1M-doc north
star), then runs ``streaming_phases``: config 4's streaming build of the
corpus's first ``ST_DOCS`` (500,000) docs with a commit every 10,000
docs, the quiesce, 1% deletes and 1% upserts, 512 queries against the
scipy oracle over the live docs, the segment scorer beside its bound,
then the checkpoint restored tiered (tiered == bypass == untiered to the
bit) and one injected upload fault. Prints the card's name and power
limit first; the phase's record goes to ``<--out>/streaming.json``.

    python3 probe_streaming.py --out chiprun_out/streaming
"""
import argparse
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=cs.SEED)
    ap.add_argument("--out", default=os.path.join("build", "streaming"))
    ap.add_argument("--work", default=os.path.join("build",
                                                   "streaming_work"))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    # phase 3's draws: the corpus, then its queries, from one generator
    rng = np.random.default_rng(args.seed)
    corpus = cs.make_doc_arrays(rng, cs.NS_DOCS, cs.NS_VOCAB, cs.NS_AVG_LEN)
    queries = cs.make_queries(rng, cs.NS_VOCAB,
                              cs.NS_BATCH * (cs.NS_BATCHES + 3))
    served = queries[cs.NS_BATCH:(cs.NS_BATCHES + 1) * cs.NS_BATCH]
    cs.log(f"[probe] corpus and queries in {time.perf_counter() - t0:.1f}s")
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    try:
        res = cs.streaming_phases({"corpus": corpus, "queries": served},
                                  args.seed, args.work)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "streaming.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    cs.log(f"[probe] done in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
