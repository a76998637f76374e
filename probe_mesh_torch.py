"""Phase 9 of ``chip_smoke.py`` (the device mesh) alone, on one card.

Builds the ELL kernel, runs phase 2's cases at the mesh's narrow widths
(kernel == plain, bitwise), builds phase 3's corpus, queries and embedding
rows from ``--seed`` (the 1M-doc north star) and a local engine's hits on
the served queries (phase 3's, which 9a is held to), then runs
``mesh_phases``: the mesh-ELL engine on a (2, 2) mesh of ranks on the
card, config 2's parity mesh, the mesh dense column and a one-process
NCCL group. Prints the card's name and power limit first; the record goes
to ``<--out>/mesh.json``. This is the JAX package's ``probe_mesh.py``
counterpart for the port; that script stays the JAX package's.

    python3 probe_mesh_torch.py --out build/mesh
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

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=cs.SEED)
    ap.add_argument("--out", default=os.path.join("build", "mesh"))
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from tfidf_tpu_torch import kernels
    from tfidf_tpu_torch.engine.embedder import get_embedder
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    t0 = time.perf_counter()
    kernels.build_all()
    cs.log(f"[probe] kernels built in {time.perf_counter() - t0:.1f}s")
    cs.CASES = [c for c in cs.CASES if c["width"] in (1, 4, 12, 24, 96)]
    cases = cs.kernel_cases(args.seed)
    # phase 3's draws: the corpus, then its queries, from one generator
    rng = np.random.default_rng(args.seed)
    corpus = cs.make_doc_arrays(rng, cs.NS_DOCS, cs.NS_VOCAB, cs.NS_AVG_LEN)
    queries = cs.make_queries(rng, cs.NS_VOCAB,
                              cs.NS_BATCH * (cs.NS_BATCHES + 3))
    served = queries[cs.NS_BATCH:(cs.NS_BATCHES + 1) * cs.NS_BATCH]
    c = Config()
    rows = cs.embed_corpus(corpus, get_embedder(c.embedding_model,
                                                c.embedding_dim),
                           cs.NS_VOCAB)
    local = Engine(Config(query_batch=cs.NS_BATCH, embedding_enabled=False))
    local.vocab.extend(f"t{i}" for i in range(cs.NS_VOCAB))
    local.index.bulk_load_packed([f"d{i}" for i in range(cs.NS_DOCS)],
                                 *corpus)
    local.commit()
    hits = local.search_batch(served[:cs.MESH_QUERIES], k=cs.TOP_K)
    del local
    cs.log(f"[probe] corpus, rows and the local engine's hits in "
           f"{time.perf_counter() - t0:.1f}s")
    res = cs.mesh_phases({"corpus": corpus, "rows": rows, "queries": served,
                          "hits": hits}, args.seed)
    res["cases"] = cases
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "mesh.json"), "w") as f:
        json.dump(res, f, indent=1, default=str)
    cs.log(f"[probe] done in {time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
