"""BASELINE config 4 at its named size on one card: 8.8M MS MARCO-shaped
passages, streamed and rebuilt, each held to a scipy oracle.

The corpus is ``probe_msmarco.py``'s synthetic shape (no download):
8,800,000 passages, average length 55 (Poisson), a 500,000-term
vocabulary, Zipf 1.25, drawn by ``tfidf_tpu_torch.bench.make_doc_arrays``
from ``--seed`` in 1M-doc chunks of one generator, then the queries from
the same generator (2-4 terms each). Two legs, ``--leg stream|rebuild|
both``:

* ``stream``: ``chip_smoke.py``'s phase 8a at this shape
  (``index_mode="segments"``, batch 64, the dense plane off): every
  passage through ``add_document_arrays``, a commit every 50,000, the
  quiesce, 1% deletes and 1% upserts, the quiesce again. Gates: the committed df, N and
  avgdl equal a recompute over the segments; no deleted doc returned;
  512 queries over the full corpus held to the scipy oracle over the
  live docs with tombstone-inclusive statistics (top-10 ids identical
  outside near-tie groups of 1e-6, scores within rel 1e-5); the engine on
  the card. Records docs/s (corpus generation left out), the first
  commit, commit p50/p99/max with and without a merge in flight, the
  merges, the quiesce, device and host memory, served q/s with one
  batch's stage ms, the segment scorer on a 512-query batch beside its
  bound. ``--tier`` then restores the checkpoint tiered under the 512 MB
  default budget (``chip_smoke.tier_phase``: tiered == bypass ==
  untiered to the bit).
* ``rebuild``: the default ``Config()`` main path (``index_mode=
  "rebuild"``, ELL, kernel v4, top-10) at batch 512 with the dense plane
  off, over the same corpus bulk-loaded: commit seconds, served q/s with
  the launch count, one batch's stage ms, the kernel's ms a batch beside
  its bound, its plain version and ``torch.sparse.mm``; the widest, the
  largest and the shortest block held v4 == v3 == plain, bitwise (a
  whole batch's plain scores would not fit beside the real-doc scores);
  512 queries' top-10 held to the scipy oracle. With ``both`` the stream
  leg's engine is freed first.

Prints the card's name and power limit first and the host's memory
before each leg. Any failed gate exits non-zero and writes no artifact;
the record goes to ``<--out>/msmarco.json`` (never over
``MSMARCO_SCALE.json``, the JAX package's record). At the named size on
an NVIDIA H100 80GB HBM3 (700 W) host the corpus draw took ~128 s, the
stream leg with ``--tier`` 1,589 s and 38.9 GB of host memory (46.1 GB
with the tier), the rebuild leg 264 s: give a run of one leg a time
limit of 2,400 s or more.

    python3 probe_msmarco_torch.py --leg stream --out build/msmarco
"""
import argparse
import gc
import json
import os
import resource
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tfidf_tpu_torch.bench import make_doc_arrays, make_queries  # noqa: E402

ORACLE_QUERIES = cs.ST_QUERIES     # 512 queries held to the oracle a leg

# BASELINE.md config 4: the MS MARCO passage corpus, streamed
SHAPE = dict(
    n_docs=8_800_000,      # passages
    vocab=500_000,
    avg_len=55,            # MS MARCO passages average ~56 words
    commit_every=50_000,
    gen_chunk=1_000_000,   # docs drawn per make_doc_arrays call
)
# the rebuild leg serves at phase 3's batch (512), the stream leg at phase
# 8's (64); each holds 512 queries to the oracle


def make_corpus(seed: int, shape: dict) -> tuple:
    """(corpus, queries, seconds): the passages drawn in ``gen_chunk``
    chunks of one generator, then phase 3's ``NS_BATCH * (NS_BATCHES +
    3)`` queries from it (warm-up, served, arrays, breakdown)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    n, chunk = shape["n_docs"], shape["gen_chunk"]
    parts = [make_doc_arrays(rng, min(chunk, n - lo), shape["vocab"],
                             shape["avg_len"]) for lo in range(0, n, chunk)]
    corpus = cs._concat_corpora(*parts)
    del parts
    queries = make_queries(rng, shape["vocab"],
                           cs.NS_BATCH * (cs.NS_BATCHES + 3))
    return corpus, queries, time.perf_counter() - t0


def split_queries(queries) -> tuple:
    """(warm, served, arrays, extra) as phase 3 splits its draw."""
    b, nb = cs.NS_BATCH, cs.NS_BATCHES
    return (queries[:b], queries[b:(nb + 1) * b],
            queries[(nb + 1) * b:(nb + 2) * b], queries[(nb + 2) * b:])


def host_memory() -> dict:
    """This process's peak RSS and ``free -g`` of the host."""
    free = subprocess.run(["free", "-g"], capture_output=True, text=True)
    return {"peak_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
            "free_g": free.stdout.strip()}


def card_line(device) -> str:
    if device is not None:
        return f"{device} (no card)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def hold_oracle_count(oracle: dict, leg: str) -> None:
    if oracle["queries"] < ORACLE_QUERIES:
        raise SystemExit(f"{leg}: the oracle held {oracle['queries']} "
                         f"queries, fewer than {ORACLE_QUERIES}")


def stream_leg(corpus, queries, seed: int, shape: dict, work: str,
               tier: bool = False, device=None) -> tuple:
    """``chip_smoke.stream_phase`` at ``shape``; with ``tier`` the tiered
    restore after it. Returns (record, phase 8a's context)."""
    t0 = time.perf_counter()
    served = split_queries(queries)[1]
    res, ctx = cs.stream_phase(
        {"corpus": corpus, "queries": served}, seed,
        commit_every=shape["commit_every"], vocab=shape["vocab"],
        avg_len=shape["avg_len"], device=device)
    hold_oracle_count(res["oracle"], "stream")
    res["host"] = host_memory()
    if tier:
        res["tier"] = cs.tier_phase(ctx, served[:cs.ST_QUERIES], work)
    res["seconds"] = time.perf_counter() - t0
    cs.log(f"[stream] leg took {res['seconds']:.1f}s; host {res['host']}")
    return res, ctx


def held_blocks(blocks) -> list:
    """The eligible blocks held bitwise against the plain version: the
    widest, the largest (most ELL slots) and the one with the fewest live
    rows (a short block); the next shortest when those are one block."""
    by_rows = sorted(range(len(blocks)), key=lambda i: blocks[i][2])
    held = {max(range(len(blocks)), key=lambda i: blocks[i][0].shape[0]),
            max(range(len(blocks)), key=lambda i: blocks[i][0].numel()),
            *by_rows[:1]}
    if len(held) == 1 and len(by_rows) > 1:
        held.add(by_rows[1])
    return sorted(held)


def check_held_blocks(engine, qb) -> list:
    """Batch ``qb``'s :func:`held_blocks` one at a time through v3 and v4,
    each into its own ``[B, rows_cap]`` output, the live rows equal to the
    plain version's bit for bit (the whole batch's plain scores, which
    ``chip_smoke.check_rearrange`` holds, would not fit beside the
    real-doc scores at this size). Returns the blocks held."""
    from tfidf_tpu_torch.ops import ell as E
    _snap, slot_of, qc_t, blocks = cs.kernel_operands(engine, qb)
    held = []
    for i in held_blocks(blocks):
        imp_t, term_t, n, _row0 = blocks[i]
        plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, n)
        for a in E.A_BUILD_VARIANTS:
            got = E.score_block_kernel(imp_t, term_t, slot_of, qc_t, n,
                                       a_build=a,
                                       out=torch.zeros_like(plain))
            if not torch.equal(got[:, :n], plain[:, :n]):
                raise SystemExit(
                    f"held block {i} {tuple(imp_t.shape)} {a}: != plain "
                    f"(max|d| {float((got - plain).abs().max())})")
            del got
        del plain
        cs.log(f"[kernel] held block {i} (width {imp_t.shape[0]}, {n} live "
               f"rows): v3 == v4 == plain, bitwise")
        held.append({"block": i, "width": imp_t.shape[0],
                     "rows_cap": imp_t.shape[1], "live_rows": n})
    return held


def rebuild_leg(corpus, queries, shape: dict, device=None) -> tuple:
    """The default ``Config()`` main path over ``corpus`` at phase 3's
    batch (dense plane off), held to the scipy oracle; on the card also
    the kernel's times. Returns (record, {"engine", "hits"})."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.config import Config
    t_leg = time.perf_counter()
    B = cs.NS_BATCH
    warm, served, arrays_q, extra = split_queries(queries)
    offsets = corpus[0]
    n_docs = offsets.shape[0] - 1
    engine = Engine(Config(query_batch=B, embedding_enabled=False),
                    device=device)
    if engine.device.type != torch.device(device or "cuda").type:
        raise SystemExit(f"rebuild: engine on {engine.device}")
    cfg = engine.config
    if (cfg.index_mode, cfg.scoring_layout, cfg.use_pallas,
            cfg.kernel_a_build) != ("rebuild", "ell", True, "v4"):
        raise SystemExit(f"rebuild: not the default main path: {cfg}")
    engine.vocab.extend(f"t{i}" for i in range(shape["vocab"]))
    names = [f"d{i}" for i in range(n_docs)]
    t0 = time.perf_counter()
    engine.index.bulk_load_packed(names, *corpus)
    load_s = time.perf_counter() - t0
    cs.sync()
    t0 = time.perf_counter()
    engine.commit()
    cs.sync()
    commit_s = time.perf_counter() - t0
    snap = engine.index.snapshot
    mirror = engine._fallback.mirror_stats()
    shapes = [tuple(i.shape) for i in snap.ell_impacts]
    cs.log(f"[rebuild] bulk load {load_s:.1f}s, commit {commit_s:.1f}s (of "
           f"it the fallback mirror's fetch {mirror['build_s']:.2f}s), "
           f"doc_cap {snap.doc_len.shape[0]}, blocks {shapes}, residual "
           f"{snap.res_tf is not None}")

    engine.search_batch(warm, k=cs.TOP_K)        # first launches, u floor
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: counts to 0 just before, read just after ----
    E.reset_launches()
    hits, arrays, secs = cs.drive(engine, served, arrays_q)
    counts = dict(E.launches)
    chunks = cs.NS_BATCHES + 1
    want = len(cs.main_path_blocks(snap, B, 256)) * chunks
    on_card = engine.device.type == "cuda"
    if counts != {"v3": 0, "v4": want if on_card else 0} \
            or (on_card and want == 0):
        raise SystemExit(f"rebuild: launches {counts}, expected v4={want}")
    qps = (len(served) + len(arrays_q)) / secs
    mem = {"allocated_bytes": torch.cuda.memory_allocated(),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    cs.log(f"[rebuild] {len(served) + len(arrays_q)} queries at batch {B} "
           f"in {secs:.3f}s = {qps:.1f} q/s; launches {counts}; device "
           f"memory {mem}")
    vals = arrays[0]
    if vals.shape != (B, cs.TOP_K) or not np.isfinite(vals[vals > 0]).all():
        raise SystemExit(f"rebuild: search_batch_arrays returned "
                         f"{vals.shape}")
    t0 = time.perf_counter()
    oracle = cs.oracle_check(corpus, served[:ORACLE_QUERIES],
                             hits[:ORACLE_QUERIES], shape["vocab"],
                             snap.doc_names)
    oracle["seconds"] = time.perf_counter() - t0
    hold_oracle_count(oracle, "rebuild")
    cs.log(f"[rebuild] oracle top-{cs.TOP_K} OK: {oracle}")
    breakdown, qb, tied = cs.phase_breakdown(engine, extra)
    cs.log(f"[rebuild] per-phase ms (one batch, synchronized): {breakdown}")
    res = {"docs": n_docs, "nnz": int(snap.nnz), "batch": B,
           "doc_cap": int(snap.doc_len.shape[0]), "blocks": shapes,
           "bulk_load_s": load_s, "commit_s": commit_s,
           "fallback_mirror": mirror, "qps": qps,
           "launches": {"v4": counts["v4"], "v3": counts["v3"]},
           "expected_launches": want, "memory": mem, "oracle": oracle,
           "phase_ms": breakdown, "topk_tied_ranks": tied}
    if on_card:          # the kernel has no CPU mode to time
        torch.cuda.empty_cache()
        held = check_held_blocks(engine, qb)
        res["kernel"] = cs.main_path_kernel_times(engine, qb)
        res["kernel"]["held"] = held
        cs.log(f"[rebuild] per-batch kernel times: {res['kernel']}")
    cs.check_clean(engine, "rebuild leg")
    res["seconds"] = time.perf_counter() - t_leg
    cs.log(f"[rebuild] leg took {res['seconds']:.1f}s")
    return res, {"engine": engine, "hits": hits}


def main(argv=None, *, device=None, shape=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--leg", choices=("stream", "rebuild", "both"),
                    default="both")
    ap.add_argument("--seed", type=int, default=cs.SEED)
    ap.add_argument("--tier", action="store_true",
                    help="after the stream leg, restore it tiered")
    ap.add_argument("--out", default=os.path.join("build", "msmarco"))
    ap.add_argument("--work", default=os.path.join("build",
                                                   "msmarco_work"))
    args = ap.parse_args(argv)
    shape = dict(SHAPE if shape is None else shape)
    if device is None and not torch.cuda.is_available():
        print("probe_msmarco_torch: CUDA is not available; this run needs "
              "one card", file=sys.stderr)
        return 2
    card = card_line(device)
    print(card, flush=True)
    t_start = time.perf_counter()
    if device is None:
        from tfidf_tpu_torch import kernels
        kernels.build_all()
    corpus, queries, gen_s = make_corpus(args.seed, shape)
    out = {"device": card, "shape": shape, "seed": args.seed,
           "corpus": {"docs": int(corpus[0].shape[0] - 1),
                      "postings": int(corpus[1].shape[0]),
                      "generate_s": gen_s}}
    cs.log(f"[probe] corpus {out['corpus']} in {gen_s:.1f}s; host before "
           f"the legs: {host_memory()}")
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    try:
        if args.leg in ("stream", "both"):
            out["stream"], ctx = stream_leg(corpus, queries, args.seed,
                                            shape, args.work, args.tier,
                                            device)
            del ctx
            gc.collect()
            torch.cuda.empty_cache()
        if args.leg in ("rebuild", "both"):
            cs.log(f"[probe] host before the rebuild leg: {host_memory()}")
            out["rebuild"], _ctx = rebuild_leg(corpus, queries, shape,
                                               device)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)
    out["host"] = host_memory()
    out["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "msmarco.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)
    cs.log(f"[probe] done in {out['seconds']:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
