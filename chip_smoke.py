#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tfidf_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1000000] [--out DIR]

Needs one CUDA card; exits non-zero without one, and without the package
beside it. Phases (any failure fails the run):

1. device: the card's name and power limit; build every CUDA kernel from
   ``tfidf_tpu_torch/csrc`` (one nvcc per source, started together, while
   phase 3's corpus is drawn on the host);
2. kernels against their plain PyTorch versions on the card, over a case
   matrix made from ``--seed``: variants v3 == v4 == plain, bitwise, and
   identical top-10, each variant also writing into a wider tensor at an
   unaligned column offset that must change nothing outside the block's
   slice; then ``packed_topk_chunked`` on the card against a
   numpy lexsort on tie-heavy cases (clamped tail, signed scores, ids
   past 2^23): ids identical, values equal to the bit;
3. the main path at the north-star size (BASELINE config 3: 1M docs,
   500k vocab, Zipf 1.25, avg length 120, batch 512, top-10) with the
   default ``Config``'s dense plane on (dim 64, chunk 2^14): bulk load;
   the embedding column through its bulk path (``install_arrays`` of rows
   embedded here by a vectorized numpy copy of ``HashEmbedder``, held
   bitwise against ``embed_counts`` on 2,000 sampled docs, then
   ``commit``); commit; serve batches through ``Engine.search_batch`` and
   ``Engine.search_batch_arrays`` with the launch counts reset just
   before and read just after; top-10 against a scipy CSR oracle, with
   the returned order held to the tie rule (scores never rise, equal
   scores in ascending row order); q/s, commit time, device memory,
   per-phase ms, and one batch's top-k against a numpy lexsort of its own
   f32 scores; then the same for the v3 variant on its own; then, on
   that batch, each variant's real-doc scores against the plain blocks
   through the reference's concatenate-and-gather, bitwise, and the
   kernel, plain and library times over the main path's blocks;
3d. the dense plane at the north star: ``Engine.search_dense_batch`` at
   batch 512, top-10, over the 1M-doc column (a warm-up, then 4 batches):
   q/s, peak device memory, one batch's ms split (query embed, upload,
   chunk products, chunk selections, merge, fetch) beside the bound;
   256 queries' top-10 against a numpy f64 brute force; and, counted on 8
   queries, the served top-k against the one-shot top-k from the same
   chunk products (bitwise, required), against one full-column matmul and
   another chunk size, alone (B=8) against inside the 512 batch, and run
   twice (recorded; ids identical outside near-tie groups);
4. the text path: the five-document corpus through ``ingest_text`` with
   the default ``Config`` (dense plane on); sparse and dense hits against
   inline BM25 and cosine oracles;
5. the worker engine at the north star, on phase 3's engine: (a)
   ``save_checkpoint`` / ``restore_checkpoint`` (``embeddings.npz``
   included) into a fresh engine on the card through the
   ``snapshot.npz`` fast path (no commit), serving the same sparse and
   dense hits to the f32 bit with the expected launches; (b) the compute
   plane: 8-query batches on the kernel path, then under an armed
   ``score_ell:transient`` served by the host fallback bitwise equal
   (degraded, then sick, when the device is not even tried), healed by a
   probe, an injected OOM merged by the batch ladder, a poison rule naming
   exactly its queries, and a real ``torch.cuda.OutOfMemoryError`` (a
   2048-query batch under a capped allocator) through the ladder; then
   the dense seam: ``dense:transient`` re-raises and advances health (no
   fallback), a clean call heals it, ``dense:oom`` merges through the
   ladder, ``dense:poison`` answers with empty hit lists as the JAX
   package does;
6. the durable text path: 5,000 generated ASCII documents through
   ``stage_bytes`` -> group fsync -> ``publish_staged`` (native tokenizer
   for every one, dense plane off), then ``build_from_directory`` with
   the dense plane on in a fresh engine (the Python analyzer; every
   document embedded through the upsert path): identical sparse hits on
   64 queries, and their dense top-10 against a numpy f64 brute force;
7. the fleet, as a deployment runs it: phase 3's corpus split into two
   disjoint 500,000-doc shards, each bulk-loaded here and saved as a
   worker's checkpoint; then one ``python -m tfidf_tpu_torch`` process per
   node on the one card (a ``coordinator``, a ``serve`` leader, two
   ``serve`` workers restoring their shards at boot, a ``router``), the
   default ``Config`` with ``replication_factor=1``, coordination
   sessions of 30 s, no result caches and phase 13's compute-plane knobs
   (``FLEET_ENV``; those act only on an injected fault). From 64 client
   threads, one query a ``POST /leader/start``: 1,024 sparse, 512
   dense and 512 hybrid (rrf) queries through the leader, 512 sparse
   through the router; then 500 new documents through
   ``/leader/upload-batch``, each read back. Sparse replies against a
   scipy f64 oracle scoring each shard with its own statistics, dense
   against a numpy f64 brute force, hybrid against ``fusion.fuse`` of the
   two, router replies equal to the leader's; no reply degraded, every
   worker healthy with no fallback-served request, every worker's ELL
   kernel launched in each sparse and hybrid window (its
   ``ell_kernel_launches_v4`` counter, read before and after), every
   process alive until SIGTERM stops it with exit code 0. q/s and p50/p99
   per mode, queries per worker batch, per-layer window means from each
   node's ``/api/metrics``, boot-to-serving seconds, upload docs/s, the
   card's ``memory.used`` as each node comes up (nvidia-smi lists no
   per-process memory in a container; exactly four processes may hold a
   CUDA context: this one, the leader, the workers) and its
   ``utilization.gpu`` (10 Hz) over each window.
8. streaming segments and tiering at BASELINE config 4's shape (runs after
   phase 6, before the fleet; config 4's named size, 8.8M passages, is
   ``probe_msmarco_torch.py``'s): (a) the first 500,000 docs of phase 3's
   corpus (``ST_DOCS``; 1M until the probe) streamed through
   ``add_document_arrays`` into ``index_mode="segments"`` (the default
   ``max_segments``, ``merge_workers`` and ``sync_merge_nnz``, batch 64,
   the dense plane off, the 500k vocabulary registered first), a commit
   every 10,000 docs, a quiesce as ``bench.py`` does, then 1% of the docs
   deleted and another 1% upserted with new content, and a quiesce again
   (the merges that commit starts are published before serving, so 8a
   serves the state that 8b saves): docs/s, commit
   p50/p99/max (the first apart), merges inline and background, the share
   of commits with a merge in flight, device memory; the incremental df
   equal to a recompute over the segments; 512 of phase 3's queries
   through ``search_batch`` and ``search_batch_arrays``, their top-10 held
   to a scipy oracle over the live docs (tombstone-inclusive statistics);
   one batch's ms split; the segment scorer (torch ops) on a 512-query
   batch beside its bound and phase 3's kernel time; (b) the engine saved
   (``segstate.npz``) and restored into a tiered engine (the default 512
   MB budget, ring depth 2; the phase fails with no cold segment), the
   same queries tiered and through ``tier_bypass``: hits and values
   identical to the bit to each other and to 8a's; then one injected
   ``upload:transient``, which must surface, and a clean batch unchanged.
9. the mesh (after phase 8, before the fleet), the ELL kernel at its
   second call site: (a) phase 3's corpus and 1,024 of its queries on a
   mesh-ELL engine of four ranks on the one card (``make_mesh((2, 2),
   devices=["cuda:0"] * 4)``: both collectives and the ``W/2``-wide rank
   blocks are real), bulk load and commit, served at batch 512 with the
   launch counts reset just before and read just after (equal to the
   eligible non-empty blocks x ranks x chunks); top-10 held to the scipy
   oracle (ties in global-id order) and to phase 3's hits; then an append
   burst of 0.1% (it folds into the base: the delta is floor-sized until
   appends are seen), 1% appends + 1% deletes + 1% upserts committed into
   the delta, served again and held to the oracle over the live docs;
   bulk-load / host-build / commit s, device bytes, q/s, one batch's stage
   ms, every rank block through v3 and v4 == plain (bitwise) and the
   kernel / plain / ``torch.sparse.mm`` times per rank width beside the
   bound; (b) BASELINE config 2's shape (100k docs, 200k vocab, 2
   workers) as a ``lucene_parity`` mesh-COO engine on a (2, 1) mesh, held
   to a scipy oracle with per-row statistics and Lucene's length norm;
   (c) phase 3d's embedding column on two docs rows through
   ``make_mesh_dense_search``, held to the f64 brute force; (d) a
   one-process NCCL group (``initialize_multihost``, world size 1, four
   ranks): a small mesh-ELL engine's hits equal the in-process mesh's.
   Phase 2's cases include the mesh's rank widths 1, 4, 12, 24 and 96.
10. the bench (last, after the fleet): ``tfidf_tpu_torch.bench``'s own
   functions for the configs no earlier phase covers: config 1 (18k text
   docs, batch 4096: outside the kernel's envelope, so its launches come
   from the next two) and config 5 (200k docs over a 5M-term vocabulary)
   at the bench's sizes, the realistic text at 5,000 textgen docs (the
   bench's 100,000; the binary ones refused), with the ELL launches
   counted from 0 over the three; one config-5 batch through every
   eligible block, v3 and v4 == plain bitwise, with the kernel / plain /
   ``torch.sparse.mm`` / bound ms; then ``bench_cluster`` and
   ``bench_cluster_gpu`` as ``python -m tfidf_tpu_torch`` processes on
   the card at 2,000 docs (``BENCH_*`` sets each cut). The artifact goes
   through ``_emit_validated`` into ``--work`` and must re-parse with
   every ``parity_checked`` true and no kernel build inside a timed
   window.
11. the root ``bench.py``'s other modes (last): each of
   ``tfidf_tpu_torch.bench_modes``' mains (compute, kernel, hybrid, tier,
   overload, routers, replay) at a cut depth (``MODE_CUTS``), every gate
   asserted in the mode's own function and every artifact through
   ``_emit_validated`` into ``--work``; the fleet modes' serving nodes on
   the card and, by ``nvidia-smi``'s count, nothing else of theirs; the
   ELL launches counted over the modes (this process's and the fleet
   workers'); this process's heap read first (``heap_stalls``) and its
   stalls in each overload window recorded.
12. the device witness (right after phase 3d, on phase 3's engine: the
   1M-doc north star, ``Config()`` defaults, kernel v4, batch 512,
   top-10): ``tfidf_tpu_torch/tools/graftcheck/device_witness.py``
   installed, 2 warm-up batches, ``end_warmup()``, then 8
   ``search_batch`` batches and 2 ``search_batch_arrays`` chunks (half
   pipelined, half inline) and 2 dense batches on phase 3d's column. The
   phase fails on a kernel build after warmup, on a device->host sync the
   card reported (``torch.cuda.set_sync_debug_mode("warn")``) or a tensor
   transfer seen from Python at a site the static cone does not explain,
   on a reported sync with no port frame on its stack, on no observation
   at all, on no v4 launch in the window, or on a
   witnessed batch that differs by a bit from the same batch served
   without the witness. Prints one ``{"witness": ...}`` line: syncs per
   batch by site and direction (blocking host->device copies among them)
   and the window's seconds.

13. chaos on phase 7's fleet (after phase 7's gates, before its SIGTERM
   teardown): the compute chaos job of ``tests/test_compute_chaos.py``
   adapted to two workers, then a kill -9. ``CHAOS_CLIENTS`` closed-loop
   client threads draw from a zipfian pool of 256 north-star queries
   phase 7 did not send (``--seed``) and one poison query (the six terms
   with the most documents in both shards); every reply is classified
   (``classify_reply``: exact, compute_degraded, degraded, failed) against
   its baseline reply, and an unmarked 200 that is not in parity fails
   the phase. The per-shard scipy oracle now holds phase 7's uploads on
   the worker that took each. Legs: (1) every pool query exact and
   unstamped, held to the oracle; (2) ``score_ell:poison:1.0:min_uniq=6``
   on both workers: the quarantine engages on exactly both, the next send
   is a 422 with ``X-Poison-Quarantined``, innocent queries stay exact on
   the device with both workers healthy and launching v4, and clearing
   the nemesis and the quarantine admits the query with its baseline
   reply; (3) ``*:oom`` on worker0 and a 0.2 s delay on worker1: worker0
   goes sick and serves its share from the host mirror (at least one
   ``compute_degraded`` reply, exact), its v4 launches flat while sick;
   after ``{"clear": true}`` its probe heals it, replies converge to the
   baseline unstamped and its v4 launches rise; (4) worker1 killed with
   SIGKILL under the load: from then on every reply stamped
   ``X-Scatter-Degraded`` must be worker0's per-shard oracle alone (an
   honest partial), waiting on the leader's breaker or registry, then a
   ``CHAOS_KILL_S`` window. Recorded: outcomes per leg, seconds from
   arming to quarantine and to sick, from clearing to healed, from the
   kill to the first stamped reply, the degraded q/s, v4 launches per
   worker per leg, the card's ``memory.used`` before and after the kill.
   The teardown's exit-0 gate holds for every process but the killed one.

After every phase with nothing armed, each engine's compute health must
be healthy with no new fault and no fallback-served request.

Then one ``{"kernels": [...]}`` line (per kernel: launches on its path,
``launches_mesh`` on phase 9a's, ``launches_bench`` over phase 10's
in-process configs, ``launches_modes`` over phase 11's modes,
``launches_witness`` in phase 12's window, ``launches_chaos`` the fleet
workers' in phase 13, max abs
error against the plain version, kernel / plain / library ms per
main-path batch and the bound), and as the last line ``{"ok": true,
"device": {...}}``. The full record of the run goes to
``--out``/chip_smoke.json (default ``build/chip_smoke/``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# bench.py's corpus and query synthesis, as the port's bench draws it,
# and the port bench's fleet ports (below the kernel's ephemeral range)
from tfidf_tpu_torch.bench import free_ports, make_doc_arrays, make_queries

SEED = 0
TOP_K = 10
NS_DOCS = 1_000_000
NS_VOCAB = 500_000
NS_AVG_LEN = 120
NS_BATCH = 512
NS_BATCHES = 4                 # through search_batch, plus one arrays batch
TOPK_ROWS = 64                 # main-path rows whose top-k numpy re-checks
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# f32 instructions per second when every multiply and every add is its own
# instruction (the kernel keeps the reference's bits: no FMA): 132 SMs x
# 128 f32 lanes x 1.98 GHz. The data sheet's 67 TFLOP/s counts an FMA as
# two operations and is reached only by fused multiply-adds.
F32_UNFUSED_OPS_PER_S = 33.5e12
F32_FMA_FLOP_PER_S = 67e12     # only for the fused-rate bound in the record

# the five documents of tests/test_engine.py
CORPUS = {
    "file1.txt": "fast food is fast and cheap",
    "file2.txt": "the cat meowing at night causes trouble",
    "file3.txt": "fast cars go very fast on the road",
    "file4.txt": "cheap food for the cat",
    "file5.txt": "night driving in fast cars",
}

KERNELS = {   # variant -> the TPU kernel body it replaces
    "v4": "tfidf_tpu/ops/ell.py:297",
    "v3": "tfidf_tpu/ops/ell.py:262",
}
SOURCE = "tfidf_tpu_torch/csrc/ell_score.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warm):
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# phase 2 inputs: one ELL block + a query batch, from a seed
# --------------------------------------------------------------------------

def make_block(rng, *, rows_cap, width, n_rows, B, u_req, vocab,
               ragged=False, hot=0):
    """Random ELL block with DISTINCT term ids per row (position w draws
    from the class w mod width), pad rows zeroed like the real build,
    optional within-row trailing pads, and a query batch that hits it.
    With ``hot`` > 0 the first ``hot`` positions of every row hold the
    same term ids 0..hot-1 and most queries ask for two of them (many
    rows and queries on a few slots)."""
    from tfidf_tpu_torch.ops.scoring import make_query_batch
    slots = max(vocab // width, 1)
    base = rng.integers(0, slots, size=(rows_cap, width))
    base[:, :hot] = 0
    term = (base * width + np.arange(width)[None, :]).astype(np.int32)
    imp = rng.random((rows_cap, width), dtype=np.float32)
    if ragged:
        fill = rng.integers(1, width + 1, size=(rows_cap, 1))
        dead = np.arange(width)[None, :] >= fill
        term[dead] = 0
        imp[dead] = 0.0
    term[n_rows:] = 0
    imp[n_rows:] = 0.0
    q_terms = np.zeros((B, 8), np.int32)
    q_weights = np.zeros((B, 8), np.float32)
    for i in range(B):
        k = int(rng.integers(1, 5))
        ids = rng.choice(vocab, size=k, replace=False)
        # most queries take one or two terms from live rows, so most
        # rows and queries score non-zero
        for j in range(min(k, 1 + i % 2) if i % 4 != 3 else 0):
            ids[j] = term[rng.integers(0, max(n_rows, 1)),
                          rng.integers(0, width)]
        if hot and i % 8:
            ids = np.concatenate([ids, rng.choice(hot, 2, replace=False)])
        ids = np.unique(ids)
        k = ids.shape[0]
        q_terms[i, :k] = ids
        q_weights[i, :k] = 1.0 + rng.random(k, dtype=np.float32)
    qb = make_query_batch(q_terms, q_weights, min_slots=u_req,
                          device="cuda")
    return imp, term, qb


CASES = [
    # eligibility edges: the 256-row floor, a non-%512 row cap, 4096 rows
    dict(rows_cap=256, width=16, n_rows=200, B=64, u_req=256),
    dict(rows_cap=768, width=32, n_rows=700, B=64, u_req=256),
    dict(rows_cap=4096, width=64, n_rows=4000, B=512, u_req=1024),
    # odd width (v4 tail), within-row ragged pads
    dict(rows_cap=4096, width=33, n_rows=3000, B=256, u_req=256,
         ragged=True),
    # vocabularies on both sides of 2^15
    dict(rows_cap=768, width=32, n_rows=600, B=64, u_req=256,
         vocab=20_000),
    dict(rows_cap=768, width=31, n_rows=600, B=64, u_req=256,
         vocab=(1 << 15) + 1, ragged=True),
    # a batch that is not a multiple of the kernel's query tile, one
    # query, the envelope's largest batch
    dict(rows_cap=512, width=24, n_rows=500, B=3, u_req=256),
    dict(rows_cap=512, width=16, n_rows=500, B=1, u_req=256),
    dict(rows_cap=2048, width=32, n_rows=2000, B=2048, u_req=1024),
    # both ends of the width ladder
    dict(rows_cap=4096, width=8, n_rows=4000, B=64, u_req=256),
    dict(rows_cap=1024, width=256, n_rows=1000, B=64, u_req=256,
         ragged=True),
    # hot slots: every row holds the same six terms, most queries ask for
    # two of them
    dict(rows_cap=8192, width=64, n_rows=8000, B=512, u_req=512, hot=6),
    # the largest U_cap the kernel stages in shared memory (query tile
    # 1), and one past it at the envelope's largest batch (weights read
    # through L2); each case's plan must say which
    dict(rows_cap=2048, width=24, n_rows=1900, B=64, u_req=16384),
    dict(rows_cap=2048, width=24, n_rows=1900, B=2048, u_req=32768,
         staged=False),
    # north-star shapes: width 128 and 64 at B=512
    dict(rows_cap=131072, width=128, n_rows=98000, B=512, u_req=512),
    dict(rows_cap=262144, width=64, n_rows=250000, B=512, u_req=512),
    # the mesh's terms split (phase 9): one rank's slice of a bucket, W/T
    # wide (8/8, 8/2, 24/2, 48/2, 192/2), at padded row capacities
    dict(rows_cap=131072, width=1, n_rows=120000, B=512, u_req=512),
    dict(rows_cap=262144, width=4, n_rows=200000, B=512, u_req=512),
    dict(rows_cap=131072, width=12, n_rows=100000, B=512, u_req=512),
    dict(rows_cap=131072, width=24, n_rows=130000, B=512, u_req=512),
    dict(rows_cap=65536, width=96, n_rows=60000, B=512, u_req=512,
         ragged=True),
]


def block_work(imp_t, term_t, slot_of, qnnz, B, n_rows):
    """(bytes, f32 ops, dense f32 ops) of one block's share of a batch:
    its live rows' postings read once and their scores written once into
    the real-doc matrix; one multiply and one add per hit (a posting with
    a query term's slot and a non-zero impact) and query whose weight at
    that slot is not zero (``qnnz[slot]`` of them) — the work the function
    needs; and, beside it, one multiply and one add per hit and query of
    the batch, which is what the kernel issues. The batch's ``slot_of``
    and ``qc_t``, read once per batch, are the caller's."""
    W = imp_t.shape[0]
    s = slot_of[term_t[:, :n_rows].long()].long()
    hit = imp_t[:, :n_rows] != 0
    ops = 2 * int(torch.where(hit, qnnz[s], 0).sum())
    dense = 2 * B * int((hit & (s != qnnz.shape[0] - 1)).sum())
    return 8 * W * n_rows + 4 * B * n_rows, ops, dense


def library_operand(imp_t, term_t, slot_of, u1, n_rows):
    """The block as a CSR matrix A[d, slot] (built outside any timed
    window) so ``torch.sparse.mm(A, qc_t)`` computes the same scores."""
    W, rows_cap = imp_t.shape
    d = torch.arange(rows_cap, device=imp_t.device).expand(W, rows_cap)
    s = slot_of[term_t.long()].long()
    keep = (s != u1 - 1) & (d < n_rows)
    A = torch.sparse_coo_tensor(
        torch.stack([d[keep], s[keep]]), imp_t[keep],
        size=(rows_cap, u1)).coalesce()
    return A.to_sparse_csr()


def slice_write_ok(E, args, n_rows, plain, a, row0) -> bool:
    """One variant writing the block into a larger sentinel-filled tensor
    at column ``row0``: its live rows equal the plain version's bit for
    bit, and every column outside the slice keeps the sentinel."""
    B = plain.shape[0]
    big = torch.full((B, row0 + n_rows + 45), -7.0, device="cuda")
    E.score_block_kernel(*args, n_rows, a_build=a, out=big, row0=row0)
    sync()
    return (torch.equal(big[:, row0:row0 + n_rows], plain[:, :n_rows])
            and bool((big[:, :row0] == -7.0).all())
            and bool((big[:, row0 + n_rows:] == -7.0).all()))


def kernel_cases(seed: int) -> dict:
    """Phase 2: every case, both variants and the plain version on the
    same inputs, each variant twice: into its own ``[B, rows_cap]``
    output, and into a wider tensor at an odd column offset (not 16-byte
    aligned, as a block's row0 in the real-doc scores is). Bitwise
    equality is required; top-10 must match."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    rng = np.random.default_rng(seed)
    worst = 0.0
    rows = []
    for i, case in enumerate(CASES):
        case = dict(case, vocab=case.get("vocab", NS_VOCAB))
        staged = case.pop("staged", True)
        imp, term, qb = make_block(rng, **case)
        B, n_rows = case["B"], case["n_rows"]
        assert E._pallas_eligible(case["rows_cap"], B, qb.uniq.shape[0])
        slot_of, qc_ext = _compile_queries(qb, case["vocab"])
        qc_t = qc_ext.T.contiguous()
        imp_t = torch.from_numpy(np.ascontiguousarray(imp.T)).cuda()
        term_t = torch.from_numpy(np.ascontiguousarray(term.T)).cuda()
        args = (imp_t, term_t, slot_of, qc_t)
        outs = {a: E.score_block_kernel(
                    *args, n_rows, a_build=a,
                    out=torch.zeros((B, case["rows_cap"]), device="cuda"))
                for a in E.A_BUILD_VARIANTS}
        plain = E.score_block_plain(*args, n_rows)
        sync()
        v3_v4 = torch.equal(outs["v3"], outs["v4"])
        err = float((outs["v4"] - plain).abs().max())
        bitwise = v3_v4 and torch.equal(outs["v4"], plain)
        k = min(TOP_K, n_rows)
        top_same = torch.equal(
            torch.topk(outs["v4"][:, :n_rows], k).values,
            torch.topk(plain[:, :n_rows], k).values)
        del outs
        row0 = 37 + 2 * i
        sliced = all(slice_write_ok(E, args, n_rows, plain, a, row0)
                     for a in E.A_BUILD_VARIANTS)
        hits = int((plain > 0).sum())
        plan = E.kernel_plan(qc_t.shape[0], B, case["width"])
        if plan["staged"] != staged:
            raise SystemExit(f"kernel case {i}: plan {plan}, expected "
                             f"staged={staged}")
        rows.append(dict(case=i, **case, u_cap=qc_t.shape[0] - 1,
                         bitwise=bitwise, slice_write_at=row0,
                         slice_write_bitwise=sliced, max_abs_err=err,
                         top10_identical=top_same, nonzero_scores=hits,
                         plan=plan))
        log(f"[kernel] case {i} {case} U_cap {qc_t.shape[0] - 1}: v3==v4 "
            f"{v3_v4} bitwise {bitwise} slice@{row0} {sliced} max|d| "
            f"{err:.3e} top10 {top_same} nonzero {hits} plan {plan}")
        if not (bitwise and sliced and top_same and hits > 0):
            raise SystemExit(f"kernel case {i} disagrees with the plain "
                             f"version: {rows[-1]}")
        worst = max(worst, err)
        del plain
    return {"cases": rows, "max_abs_err": worst}


# --------------------------------------------------------------------------
# phase 2b: the top-k's tie rule on the card, against numpy
# --------------------------------------------------------------------------

def ref_topk(s: np.ndarray, num_docs: int, k: int):
    """numpy top-k of one score row with the reference's tie rule:
    descending score, ascending id among equal scores (a lexsort of every
    candidate at or above the k-th value, so no tie group is cut)."""
    s = s[:num_docs]
    kth = np.partition(s, s.shape[0] - k)[s.shape[0] - k]
    cand = np.flatnonzero(s >= kth)
    order = cand[np.lexsort((cand, -s[cand]))][:k]
    return s[order], order.astype(np.int32)


def check_topk(scores: np.ndarray, packed, num_docs: int, k: int,
               what: str) -> int:
    """Hold packed top-k rows to :func:`ref_topk`: ids identical and
    values equal to the bit. Returns the number of ranks whose score
    equals the next rank's (ties the rule had to order)."""
    from tfidf_tpu_torch.ops.topk import unpack_topk
    vals, ids = unpack_topk(packed)
    tied = 0
    for r in range(scores.shape[0]):
        want_v, want_i = ref_topk(scores[r], num_docs, k)
        if not (np.array_equal(ids[r], want_i)
                and np.array_equal(vals[r].view(np.int32),
                                   want_v.view(np.int32))):
            raise SystemExit(f"{what}: row {r} top-{k} {ids[r].tolist()} "
                             f"{vals[r].tolist()} != numpy "
                             f"{want_i.tolist()} {want_v.tolist()}")
        tied += int((want_v[1:] == want_v[:-1]).sum())
    return tied


def topk_case_scores(rng, name: str):
    """(scores, num_docs, k, chunk) of one tie-heavy top-k case."""
    if name == "tie_heavy_clamped_tail":
        # 3 chunks of 2^17 with the last one clamped back over the second;
        # hot tied values land anywhere, the overlap included
        doc_cap, chunk = 300_007, 1 << 17
        s = rng.integers(0, 3, size=(64, doc_cap)).astype(np.float32) * 0.5
        for r in range(64):
            hot = np.concatenate([rng.integers(0, doc_cap, 24),
                                  rng.integers(doc_cap - chunk, 2 * chunk, 8)])
            s[r, hot] = rng.integers(3, 6, hot.shape[0]) * 0.5
        return s, doc_cap - 7, 10, chunk
    if name == "signed_quantized":
        # normals rounded to 1/8: ties and negative scores (+0.0 only)
        s = np.round(rng.standard_normal((64, 200_000)) * 8) / 8 + 0.0
        return s.astype(np.float32), 199_990, 10, 1 << 16
    if name == "ids_past_2_pow_23":
        # ids >= 2^23 on the int32 wire, ties across the clamped tail
        doc_cap, chunk = (1 << 23) + 3001, 1 << 21
        s = np.zeros((4, doc_cap), np.float32)
        for r in range(4):
            hot = np.concatenate([rng.integers(1 << 23, doc_cap, 12),
                                  rng.integers(0, 1 << 23, 4)])
            s[r, hot] = rng.integers(1, 3, hot.shape[0]).astype(np.float32)
        return s, doc_cap - 1, 10, chunk
    raise ValueError(name)


TOPK_CASES = ("tie_heavy_clamped_tail", "signed_quantized",
              "ids_past_2_pow_23")


def topk_cases(seed: int) -> dict:
    """Phase 2b: ``packed_topk_chunked`` on the card against numpy, on
    cases built so that most ranks are exact f32 ties."""
    from tfidf_tpu_torch.ops.topk import fetch_packed, packed_topk_chunked
    rng = np.random.default_rng(seed + 1)
    out = {}
    for name in TOPK_CASES:
        s, num_docs, k, chunk = topk_case_scores(rng, name)
        packed = fetch_packed(packed_topk_chunked(
            torch.from_numpy(s).cuda(), num_docs, k=k, chunk=chunk))
        tied = check_topk(s, packed, num_docs, k, f"topk {name}")
        out[name] = {"shape": list(s.shape), "chunk": chunk,
                     "tied_ranks": tied}
        log(f"[topk] {name} {s.shape} chunk {chunk}: identical to numpy "
            f"lexsort, {tied} tied ranks")
        if tied == 0:
            raise SystemExit(f"topk {name}: the case made no ties")
    return out


# --------------------------------------------------------------------------
# phase 3: the main path at the north-star size
# --------------------------------------------------------------------------

def embed_corpus(corpus, embedder, vocab: int) -> np.ndarray:
    """f32 ``[n_docs, dim]`` rows of the synthetic corpus, the numpy
    vectorization of ``HashEmbedder.embed_counts`` over each doc's
    ``{f"t{id}": tf}``: the slot and sign of each ``t{i}`` from the
    embedder, one scatter-add over the COO, the same norm and f32 divide.
    The tfs are integer counts, so every per-slot sum and every sum of
    squares is an integer below 2^24, exact in any order and in f32 and
    f64 alike: the bits do not depend on the scatter's order."""
    offsets, ids, tfs, _ = corpus
    n_docs, dim = offsets.shape[0] - 1, embedder.dim
    slots = [embedder._token_slot(f"t{i}") for i in range(vocab)]
    pos = np.fromiter((p for p, _ in slots), np.int64, vocab)
    sign = np.fromiter((g for _, g in slots), np.float64, vocab)
    doc = np.repeat(np.arange(n_docs, dtype=np.int64), np.diff(offsets))
    acc = np.bincount(doc * dim + pos[ids], weights=sign[ids] * tfs,
                      minlength=n_docs * dim).reshape(n_docs, dim)
    sumsq = (acc * acc).sum(axis=1)
    if sumsq.max() >= 1 << 24:
        raise SystemExit("embed_corpus: sums past 2^24 are not exact")
    rows = acc.astype(np.float32)
    # embed_counts: math.sqrt of the f32 dot, then an in-place f32 divide
    # (numpy casts the Python float to f32 first)
    norm = np.sqrt(sumsq).astype(np.float32)
    live = norm > 0
    rows[live] /= norm[live, None]
    return rows


def check_embedding(rows, corpus, embedder, rng, n: int = 2000) -> int:
    """``rows`` against ``embed_counts`` on ``n`` sampled docs, bitwise."""
    offsets, ids, tfs, _ = corpus
    sample = rng.choice(offsets.shape[0] - 1, size=n, replace=False)
    for d in sample:
        lo, hi = offsets[d], offsets[d + 1]
        want = embedder.embed_counts(
            {f"t{t}": float(f) for t, f in zip(ids[lo:hi], tfs[lo:hi])})
        if want.tobytes() != rows[d].tobytes():
            raise SystemExit(f"embedding: doc {d} differs from "
                             f"embed_counts: {rows[d]} vs {want}")
    return n


def oracle_check(corpus, queries, hits, vocab: int, doc_names, *,
                 stats=None, names=None, impacts=None) -> dict:
    """Top-10 of the port against a scipy CSR oracle with independently
    computed f64 BM25 impacts. Equal scores rank by the engine's row order
    (``doc_names``, the commit layout), as the engine breaks ties. Ids
    must be identical, except inside a tie group — oracle scores within
    1e-6 relative — where the f32 sum (its association follows each
    row's term positions) decides the order; such swaps pass and are
    counted. Scores within 1e-5 relative.

    ``names`` names the corpus's docs (default ``d<row>``); a hit whose
    name is not among them (a deleted doc) fails. ``stats`` = (df [vocab],
    N, avgdl) are the collection statistics to score with (default: the
    corpus's own) — a streaming index counts tombstoned docs until their
    segment merges. ``impacts`` (f64 per posting) replaces those BM25
    impacts outright (a parity mesh's per-row statistics)."""
    import scipy.sparse as sp
    offsets, ids, tfs, lengths = corpus
    n_docs = offsets.shape[0] - 1
    row = np.repeat(np.arange(n_docs), np.diff(offsets))
    if impacts is not None:
        imp = impacts
    else:
        if stats is None:
            df = np.bincount(ids, minlength=vocab).astype(np.float64)
            n_stat, avgdl = n_docs, lengths.astype(np.float64).mean()
        else:
            df, n_stat, avgdl = stats
        k1, b = 1.2, 0.75
        idf = np.log1p((n_stat - df + 0.5) / (df + 0.5))
        imp = idf[ids] * tfs / (tfs + k1 * (1 - b + b * lengths[row]
                                            / avgdl))
    # by term: a query's scores are the sum of its terms' columns
    M = sp.csc_matrix((imp, (row, ids.astype(np.int64))),
                      shape=(n_docs, vocab))
    if names is None:
        row_of = np.empty(n_docs, np.int64)
        row_of[[int(n[1:]) for n in doc_names]] = np.arange(n_docs)
        index_of = lambda nm: int(nm[1:])      # noqa: E731
    else:
        pos = {nm: r for r, nm in enumerate(doc_names)}
        row_of = np.fromiter((pos[nm] for nm in names), np.int64, n_docs)
        index_of = dict(zip(names, range(n_docs))).__getitem__

    def one(i):
        terms, counts = np.unique([int(t[1:]) for t in queries[i].split()],
                                  return_counts=True)
        s = np.zeros(n_docs)
        for t, c in zip(terms.tolist(), counts.tolist()):
            col = slice(M.indptr[t], M.indptr[t + 1])
            s[M.indices[col]] += c * M.data[col]
        swaps = {"exact_f64_tie": 0, "near_tie": 0}
        _hold_query(i, s, hits[i], row_of, index_of, swaps)
        return swaps

    # numpy's array loops release the GIL: one thread per core
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        per_query = list(pool.map(one, range(len(hits))))
    swaps = {k: sum(sw[k] for sw in per_query)
             for k in ("exact_f64_tie", "near_tie")}
    ranks = sum(len(h) for h in hits)
    return {"queries": len(hits), "ranks": ranks,
            "ids_identical": ranks - sum(swaps.values()), "swaps": swaps}


def _hold_query(i, s, got, row_of, index_of, swaps) -> None:
    """One query's served top-k against its oracle scores ``s``: the
    (-score, row) order over the docs scoring at least the k-th largest
    score (the full sort's first k, without sorting every doc)."""
    cand = np.flatnonzero(s >= -np.partition(-s, TOP_K - 1)[TOP_K - 1]) \
        if s.shape[0] > TOP_K else np.arange(s.shape[0])
    order = cand[np.lexsort((row_of[cand], -s[cand]))][:TOP_K]
    order = order[s[order] > 0]
    try:
        got_ids = np.asarray([index_of(h.name) for h in got], np.int64)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"oracle: query {i} returned a doc outside the "
                         f"live corpus: {e}")
    got_sc = np.asarray([h.score for h in got])
    # the engine's own f32 order: scores never rise, and equal scores
    # come in ascending snapshot row order
    d = np.diff(got_sc)
    rows = row_of[got_ids]
    if (d > 0).any() or ((d == 0) & (np.diff(rows) <= 0)).any():
        raise SystemExit(f"oracle: query {i} breaks the tie rule: "
                         f"{list(zip(got_sc.tolist(), rows.tolist()))}")
    if got_ids.shape != order.shape:
        raise SystemExit(f"oracle: query {i} has {len(got_ids)} hits, "
                         f"oracle {len(order)}")
    np.testing.assert_allclose(got_sc, s[got_ids], rtol=1e-5,
                               err_msg=f"oracle: query {i} scores")
    np.testing.assert_allclose(got_sc, s[order], rtol=1e-5,
                               err_msg=f"oracle: query {i} top-k")
    for r in np.flatnonzero(got_ids != order):
        a, c = s[got_ids[r]], s[order[r]]
        if abs(a - c) > 1e-6 * max(abs(c), 1e-30):
            raise SystemExit(f"oracle: query {i} rank {r}: port "
                             f"doc {got_ids[r]} ({a}) vs oracle "
                             f"doc {order[r]} ({c})")
        swaps["exact_f64_tie" if a == c else "near_tie"] += 1


def drive(engine, queries, chunks_arrays) -> tuple:
    """The served run: one search_batch over ``queries`` (NS_BATCHES
    chunks on the main path) and one search_batch_arrays chunk. Returns
    (hits, arrays, seconds)."""
    sync()
    t0 = time.perf_counter()
    hits = engine.search_batch(queries, k=TOP_K)
    arrays = engine.search_batch_arrays(chunks_arrays, k=TOP_K)
    sync()
    return hits, arrays, time.perf_counter() - t0


def main_path_blocks(snap, B: int, u_cap: int) -> list:
    """(imp_t, term_t, live rows, row0) of every block inside the kernel
    envelope; row0 is the block's first column in the real-doc scores."""
    from tfidf_tpu_torch.ops.ell import _pallas_eligible
    blocks, row0 = [], 0
    for i, imp in enumerate(snap.ell_impacts):
        n = snap.ell_live[i]
        if _pallas_eligible(imp.shape[0], B, u_cap):
            blocks.append((snap.ell_impacts_t[i], snap.ell_terms_t[i], n,
                           row0))
        row0 += n
    return blocks


def launch_blocks(blocks, slot_of, qc_t, out, a_build: str) -> None:
    """Every block through the kernel, straight into ``out``."""
    from tfidf_tpu_torch.ops.ell import score_block_kernel
    for imp_t, term_t, n, row0 in blocks:
        score_block_kernel(imp_t, term_t, slot_of, qc_t, n, a_build=a_build,
                           out=out, row0=row0)


def phase_breakdown(engine, queries) -> tuple:
    """Per-phase ms of one batch, each phase closed by a synchronize,
    then its top-k checked against numpy on the first ``TOPK_ROWS``
    queries; returns (ms by phase, the batch's QueryBatch, tied ranks).
    The score phase is then split by running its parts on their own,
    each closed by a synchronize: ``score.compile`` (``_compile_queries``
    and the ``qc_t`` transpose), ``score.kernel`` (the eligible blocks'
    launches into one real-doc tensor) and ``score.rest`` (the score
    phase less those two: allocation, plain blocks, the zeroed tail, the
    residual)."""
    from tfidf_tpu_torch.ops.ell import score_ell_batch
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    from tfidf_tpu_torch.ops.topk import fetch_packed, packed_topk_chunked
    s = engine.searcher
    snap = engine.index.snapshot
    sync()
    t = [time.perf_counter()]
    qb, _ = s._vectorize(queries, NS_BATCH)
    sync()
    t.append(time.perf_counter())
    scores = score_ell_batch(
        snap.ell_impacts, snap.ell_terms, snap.ell_impacts_t,
        snap.ell_terms_t, snap.ell_live, snap.res_tf,
        snap.res_term, snap.res_doc, snap.doc_len, snap.df, qb,
        snap.n_docs, snap.avgdl, snap.doc_norms, use_pallas=True,
        a_build="v4", res_plan=snap.res_plan,
        **engine.model.score_kwargs())
    sync()
    t.append(time.perf_counter())
    packed = packed_topk_chunked(scores, snap.num_docs, k=TOP_K)
    sync()
    t.append(time.perf_counter())
    packed = fetch_packed(packed)
    t.append(time.perf_counter())
    names = ("vectorize", "score", "topk", "fetch")
    ms = {n: (t[i + 1] - t[i]) * 1e3 for i, n in enumerate(names)}
    # the served top-k of this batch's own f32 scores, held to numpy; the
    # scores go before the split allocates its own [B, doc_cap] tensor
    tied = check_topk(scores[:TOPK_ROWS].cpu().numpy(), packed[:TOPK_ROWS],
                      snap.num_docs, TOP_K, "main-path topk")
    log(f"[main] top-{TOP_K} of {TOPK_ROWS} served rows identical to numpy "
        f"lexsort over the engine's f32 scores, {tied} tied ranks")
    out = torch.empty(scores.shape, dtype=scores.dtype, device=scores.device)
    del scores
    sync()
    t0 = time.perf_counter()
    slot_of, qc_ext = _compile_queries(qb, snap.df.shape[0])
    qc_t = qc_ext.T.contiguous()
    sync()
    t1 = time.perf_counter()
    launch_blocks(main_path_blocks(snap, NS_BATCH, qc_t.shape[0] - 1),
                  slot_of, qc_t, out, "v4")
    sync()
    t2 = time.perf_counter()
    del out
    ms["score.compile"] = (t1 - t0) * 1e3
    ms["score.kernel"] = (t2 - t1) * 1e3
    ms["score.rest"] = ms["score"] - ms["score.compile"] - ms["score.kernel"]
    return ms, qb, tied


def vectorize_split(engine, queries) -> dict:
    """Host ms of one batch's vectorize, split into the analyzer and the
    vocabulary lookups as served (found ids cached), and the cost of one
    lookup per term through the native table's ``ctypes`` call against a
    dict of the same ids."""
    s = engine.searcher
    t0 = time.perf_counter()
    counts = [s.analyzer.counts(q) for q in queries]
    t1 = time.perf_counter()
    for c in counts:
        s.vocab.map_counts(c, add=False)
    t2 = time.perf_counter()
    terms = [t for c in counts for t in c]
    native = engine.native
    if native is None:
        raise SystemExit("main path: the native tokenizer did not build")
    t3 = time.perf_counter()
    found = [native.lookup(t, add=False) for t in terms]
    t4 = time.perf_counter()
    table = dict(zip(terms, found))
    t5 = time.perf_counter()
    for t in terms:
        table.get(t)
    t6 = time.perf_counter()
    return {"analyze_ms": (t1 - t0) * 1e3, "lookup_ms": (t2 - t1) * 1e3,
            "terms": len(terms),
            "native_lookup_us_per_term": (t4 - t3) / len(terms) * 1e6,
            "dict_lookup_us_per_term": (t6 - t5) / len(terms) * 1e6}


def kernel_operands(engine, qb) -> tuple:
    """(snapshot, slot_of, qc_t, the eligible blocks) of one batch ``qb``
    on the engine's committed snapshot."""
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    snap = engine.index.snapshot
    slot_of, qc_ext = _compile_queries(qb, snap.df.shape[0])
    qc_t = qc_ext.T.contiguous()
    return snap, slot_of, qc_t, main_path_blocks(snap, qc_t.shape[1],
                                                 qc_t.shape[0] - 1)


def check_rearrange(engine, qb) -> None:
    """For each variant, ``score_ell_impl``'s real-doc scores of batch
    ``qb`` equal the plain blocks concatenated and gathered by
    ``_rearrange_to_real`` (the reference's rearrange), bit for bit."""
    from tfidf_tpu_torch.ops import ell as E
    snap, slot_of, qc_t, blocks = kernel_operands(engine, qb)
    vocab_cap, doc_cap = snap.df.shape[0], snap.doc_len.shape[0]
    index = torch.from_numpy(E.real_index(
        [i.shape[0] for i in snap.ell_impacts], snap.ell_live,
        doc_cap)).cuda()
    ref = E._rearrange_to_real(
        [E.score_block_plain(it, tt, slot_of, qc_t, n) for it, tt, n in
         zip(snap.ell_impacts_t, snap.ell_terms_t, snap.ell_live)],
        index, qc_t.shape[1], qc_t.device)
    for a in E.A_BUILD_VARIANTS:
        got = E.score_ell_impl(snap.ell_impacts, snap.ell_terms,
                               snap.ell_impacts_t, snap.ell_terms_t,
                               snap.ell_live, doc_cap, qb, vocab_cap,
                               use_pallas=True, a_build=a)
        if not torch.equal(got, ref):
            bad = [(tuple(it.shape), r0) for it, _, n, r0 in blocks
                   if not torch.equal(got[:, r0:r0 + n], ref[:, r0:r0 + n])]
            raise SystemExit(f"main path {a}: real-doc scores != plain "
                             f"blocks through _rearrange_to_real (max|d| "
                             f"{float((got - ref).abs().max())}; blocks "
                             f"(shape, row0) that differ: {bad})")
        del got


def main_path_kernel_times(engine, qb) -> dict:
    """Per-batch device times over the main path's own blocks and batch:
    every eligible block through each variant, straight into one
    ``[B, doc_cap]`` real-doc tensor at its row offset; the plain version
    and one library call (torch.sparse.mm of the block as CSR); the
    bound. The variants are held to the plain version apart from this
    (:func:`check_rearrange`)."""
    from tfidf_tpu_torch.ops import ell as E
    snap, slot_of, qc_t, blocks = kernel_operands(engine, qb)
    doc_cap = snap.doc_len.shape[0]
    u1, B = qc_t.shape

    res = {"blocks": len(blocks), "u_cap": u1 - 1, "max_abs_err": 0.0,
           "plans": [E.kernel_plan(u1, B, it.shape[0])
                     for it, _, _, _ in blocks]}
    # the bound: live postings and scores per block, slot_of and qc_t
    # once per batch, the (hit, query) products whose weight is not zero;
    # the record keeps beside it the time of the products the kernel
    # issues (every query per hit) and the first slice's bound (fused
    # rate, padded [B, rows_cap] outputs, every query per hit)
    once = 4 * slot_of.numel() + 4 * u1 * B
    qnnz = (qc_t != 0).sum(1)
    res["bytes"], res["ops"], res["ops_dense"], padded = once, 0, 0, 0
    for it, tt, n, _ in blocks:
        nbytes, ops, dense = block_work(it, tt, slot_of, qnnz, B, n)
        res["bytes"] += nbytes
        res["ops"] += ops
        res["ops_dense"] += dense
        padded += (8 * it.shape[0] * n + once + 4 * B * it.shape[1])
    t_bytes = res["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = res["ops"] / F32_UNFUSED_OPS_PER_S * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    res["bound_bytes_ms"], res["bound_ops_ms"] = t_bytes, t_ops
    res["dense_ops_ms"] = res["ops_dense"] / F32_UNFUSED_OPS_PER_S * 1e3
    res["bound_fused_padded_ms"] = max(
        padded / HBM_BYTES_PER_S,
        res["ops_dense"] / F32_FMA_FLOP_PER_S) * 1e3

    out = torch.empty((B, doc_cap), dtype=torch.float32, device="cuda")
    for a in E.A_BUILD_VARIANTS:
        res[f"{a}_ms"] = cuda_ms(
            lambda a=a: launch_blocks(blocks, slot_of, qc_t, out, a), reps=5)
    # the same blocks and slots with the batch's first 32 / 128 queries:
    # the plan (query tile 32) is the same, so the difference from the
    # full batch is what each further tile of 32 queries costs, and what
    # is left at 32 queries is the per-batch part (postings walk,
    # compaction, the first tile)
    res["v4_ms_by_queries"] = {}
    for nq in (32, 128):
        part = qc_t[:, :nq].contiguous()
        res["v4_ms_by_queries"][nq] = cuda_ms(
            lambda: launch_blocks(blocks, slot_of, part, out[:nq], "v4"),
            reps=5)
    res["v4_ms_by_queries"][B] = res["v4_ms"]
    del out
    # one block's output alive at a time (a whole batch's would not fit
    # beside the postings at config 4's named size)
    def plain_all():
        for it, tt, n, _ in blocks:
            E.score_block_plain(it, tt, slot_of, qc_t, n)

    res["plain_ms"] = cuda_ms(plain_all, reps=2)
    mats = [library_operand(it, tt, slot_of, u1, n)
            for it, tt, n, _ in blocks]

    def library_all():
        for A in mats:
            torch.sparse.mm(A, qc_t)

    res["library_ms"] = cuda_ms(library_all, reps=5)
    del mats
    return res


def draw_corpus(seed: int, n_docs: int) -> tuple:
    """(the generator, phase 3's corpus drawn from it, seconds); the
    generator goes on to draw phase 3's queries."""
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    corpus = make_doc_arrays(rng, n_docs, NS_VOCAB, NS_AVG_LEN)
    return rng, corpus, time.perf_counter() - t0


def main_path(seed: int, drawn: tuple) -> dict:
    """Phase 3 over :func:`draw_corpus`'s draw (made while the kernels
    built)."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.config import Config
    rng, corpus, gen_s = drawn
    offsets, ids, tfs, lengths = corpus
    n_docs = offsets.shape[0] - 1
    log(f"[main] corpus {n_docs} docs nnz={ids.shape[0]} in {gen_s:.1f}s")
    # compute-plane knobs for phase 5: sick after 3 faults, no probe
    # until the phase shortens the interval, an OOM ladder down to 2; the
    # dense plane at the Config defaults
    engine = Engine(Config(query_batch=NS_BATCH, use_pallas=True,
                           kernel_a_build="v4", compute_sick_after=3,
                           compute_probe_interval_s=3600.0,
                           oom_backoff_min_batch=2))
    assert engine.device.type == "cuda" and engine.dense is not None
    engine.vocab.extend(f"t{i}" for i in range(NS_VOCAB))
    names = [f"d{i}" for i in range(n_docs)]
    t0 = time.perf_counter()
    engine.index.bulk_load_packed(names, offsets, ids, tfs, lengths)
    load_s = time.perf_counter() - t0
    # the embedding column through its bulk path
    dense = {}
    t0 = time.perf_counter()
    rows = embed_corpus(corpus, engine.dense.embedder, NS_VOCAB)
    dense["embed_s"] = time.perf_counter() - t0
    dense["embed_checked"] = check_embedding(
        rows, corpus, engine.dense.embedder, np.random.default_rng(seed + 3))
    t0 = time.perf_counter()
    engine.dense.install_arrays(rows, names)
    dense["install_s"] = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    engine.dense.commit()
    sync()
    dense["commit_s"] = time.perf_counter() - t0
    dense["stats"] = engine.dense.stats()
    log(f"[main] dense column: embedded {n_docs} docs in "
        f"{dense['embed_s']:.2f}s ({dense['embed_checked']} held bitwise "
        f"against embed_counts), install_arrays {dense['install_s']:.2f}s, "
        f"column commit {dense['commit_s']:.2f}s, {dense['stats']}")
    sync()
    t0 = time.perf_counter()
    engine.commit()
    sync()
    commit_s = time.perf_counter() - t0
    snap = engine.index.snapshot
    shapes = [tuple(i.shape) for i in snap.ell_impacts]
    mirror = engine._fallback.mirror_stats()
    log(f"[main] bulk load {load_s:.1f}s, commit {commit_s:.1f}s (of it "
        f"the fallback mirror's fetch {mirror['build_s']:.2f}s, "
        f"{mirror['host_bytes']} host bytes), blocks {shapes}, residual "
        f"{snap.res_tf is not None}")

    queries = make_queries(rng, NS_VOCAB, NS_BATCH * (NS_BATCHES + 3))
    warm = queries[:NS_BATCH]
    served = queries[NS_BATCH:(NS_BATCHES + 1) * NS_BATCH]
    arrays_q = queries[(NS_BATCHES + 1) * NS_BATCH:
                       (NS_BATCHES + 2) * NS_BATCH]
    extra = queries[(NS_BATCHES + 2) * NS_BATCH:]
    engine.search_batch(warm, k=TOP_K)           # first launches, u floor

    # ---- the main path: counts to 0 just before, read just after ----
    torch.cuda.reset_peak_memory_stats()
    E.reset_launches()
    hits, arrays, secs = drive(engine, served, arrays_q)
    counts = dict(E.launches)
    chunks = NS_BATCHES + 1
    # u_cap is a power of two >= 256 for every batch, so it never decides
    want = len(main_path_blocks(snap, NS_BATCH, 256)) * chunks
    qps = chunks * NS_BATCH / secs
    log(f"[main] v4 path: {chunks * NS_BATCH} queries in {secs:.3f}s = "
        f"{qps:.1f} q/s; launches {counts} (expect v4={want})")
    if counts["v4"] != want or counts["v3"] != 0 or want == 0:
        raise SystemExit(f"main path launches {counts}, expected v4={want}")
    mem = {"allocated_bytes": torch.cuda.memory_allocated(),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}

    vals, ids_a, kk, names = arrays
    if vals.shape != (NS_BATCH, TOP_K) or not np.isfinite(
            vals[vals > 0]).all():
        raise SystemExit(f"search_batch_arrays returned {vals.shape}")
    oracle = oracle_check(corpus, served[:256], hits[:256], NS_VOCAB,
                          snap.doc_names)
    log(f"[main] oracle top-{TOP_K} OK: {oracle}")

    # ---- the v3 variant's own path ----
    engine.searcher.kernel_a_build = "v3"
    E.reset_launches()
    hits_v3, _, secs_v3 = drive(engine, served, arrays_q)
    counts_v3 = dict(E.launches)
    engine.searcher.kernel_a_build = "v4"
    if counts_v3["v3"] != want or counts_v3["v4"] != 0:
        raise SystemExit(f"v3 path launches {counts_v3}, expected {want}")
    if hits_v3 != hits:
        raise SystemExit("v3 path results differ from v4")
    log(f"[main] v3 path: {chunks * NS_BATCH / secs_v3:.1f} q/s, "
        f"launches {counts_v3}, results identical to v4")

    breakdown, qb, tied = phase_breakdown(engine, extra)
    log(f"[main] per-phase ms (one batch, synchronized): {breakdown}")
    vsplit = vectorize_split(engine, extra)
    log(f"[main] vectorize split (host): {vsplit}")
    check_rearrange(engine, qb)
    ktimes = main_path_kernel_times(engine, qb)
    log(f"[main] per-batch kernel times: {ktimes}")
    check_clean(engine, "main path")
    res = {"docs": n_docs, "nnz": int(ids.shape[0]), "blocks": shapes,
           "bulk_load_s": load_s, "commit_s": commit_s,
           "dense_column": dense, "qps_v4": qps,
           "qps_v3": chunks * NS_BATCH / secs_v3,
           "launches": {"v4": counts["v4"], "v3": counts_v3["v3"]},
           "expected_launches": want, "memory": mem,
           "fallback_mirror": mirror,
           "phase_ms": breakdown, "vectorize_split": vsplit,
           "oracle": oracle,
           "topk_tied_ranks": tied, "kernel": ktimes}
    ctx = {"engine": engine, "served": served, "arrays_q": arrays_q,
           "hits": hits, "arrays": arrays, "want": want,
           "queries": queries, "rows": rows, "corpus": corpus}
    return res, ctx


# --------------------------------------------------------------------------
# phase 3d: the dense plane at the north star
# --------------------------------------------------------------------------

def dense_oracle(engine, queries, hits, rows, names, *, tie=None,
                 embedder=None) -> dict:
    """Dense top-10 of ``queries`` against a numpy f64 brute force over
    ``rows`` (f32 ``[n, dim]``, row i = ``names[i]``), ties in the
    column's row order (sorted names; ``tie``: another rank per row). The
    served order must keep the tie rule; ids identical except inside a
    group whose f64 scores are within 1e-6 (an ulp of the f32 product
    decides there), such swaps counted; scores within 1e-6 + 1e-5 |s| of
    the f64 score of the doc named. ``engine`` gives the analyzer (and,
    unless ``embedder`` is given, the column's embedder)."""
    if tie is None:
        slot = engine.dense._slot
        tie = np.fromiter((slot[n] for n in names), np.int64, len(names))
    pos = {n: i for i, n in enumerate(names)}
    rows64 = rows.astype(np.float64)
    emb = embedder if embedder is not None else engine.dense.embedder
    swaps, worst = 0, 0.0
    for lo in range(0, len(queries), 64):
        Q = np.stack([emb.embed_query(engine.analyzer.counts(q))
                      for q in queries[lo:lo + 64]]).astype(np.float64)
        S = rows64 @ Q.T
        for j, got in enumerate(hits[lo:lo + 64]):
            s = S[:, j]
            k = min(TOP_K, s.shape[0])
            kth = np.partition(s, s.shape[0] - k)[s.shape[0] - k]
            cand = np.flatnonzero(s >= kth)
            want = cand[np.lexsort((tie[cand], -s[cand]))][:k]
            got_i = np.array([pos[n] for n, _ in got])
            got_s = np.array([v for _, v in got])
            d = np.diff(got_s)
            if got_i.shape != want.shape or (d > 0).any() or (
                    (d == 0) & (np.diff(tie[got_i]) <= 0)).any():
                raise SystemExit(f"dense oracle: query {lo + j} breaks "
                                 f"the tie rule or the count: {got}")
            err = np.abs(got_s - s[got_i])
            if (err > 1e-6 + 1e-5 * np.abs(s[got_i])).any():
                raise SystemExit(f"dense oracle: query {lo + j} scores "
                                 f"{got_s} vs f64 {s[got_i]}")
            worst = max(worst, float(err.max()))
            for r in np.flatnonzero(got_i != want):
                if abs(s[got_i[r]] - s[want[r]]) > 1e-6:
                    raise SystemExit(f"dense oracle: query {lo + j} rank "
                                     f"{r}: {names[got_i[r]]} vs "
                                     f"{names[want[r]]}")
                swaps += 1
    ranks = sum(len(h) for h in hits)
    return {"queries": len(hits), "ranks": ranks,
            "ids_identical": ranks - swaps, "near_tie_swaps": swaps,
            "max_abs_err": worst}


def compare_packed(a, b, q64, host, what: str) -> dict:
    """Two packed top-k results of the same queries: value bits that
    differ, and ids that differ, each allowed only inside a near-tie
    group (f64 scores ``q64[row] . host[id]`` within 1e-6)."""
    from tfidf_tpu_torch.ops.topk import unpack_topk
    va, ia = unpack_topk(a)
    vb, ib = unpack_topk(b)
    swaps = 0
    for r, j in zip(*np.nonzero(ia != ib)):
        if abs(host[ia[r, j]] @ q64[r] - host[ib[r, j]] @ q64[r]) > 1e-6:
            raise SystemExit(f"dense bits {what}: row {r} rank {j} ids "
                             f"{ia[r, j]} vs {ib[r, j]} are no near tie")
        swaps += 1
    return {"values": int(va.size),
            "value_bits_differ": int((va.view(np.int32)
                                      != vb.view(np.int32)).sum()),
            "ids_differ_in_near_ties": swaps}


TIE_ROWS = 130_000              # the tie column: rows of phase 3d's column
TIE_CHUNK = 6_000              # its chunk: doc_cap 2^17 / 6,000 leaves a
#                                clamped tail chunk (starts at 125,072)
TIE_COPIES = (18_017, 44_999, 59_999, 60_000, 125_500, 126_000, 127_777,
              129_999)         # inside full chunks, either side of a chunk
#                                boundary, re-read by the clamped tail, and
#                                inside the tail's own rows (last live row)
TIE_QUERIES = 64


def dense_ties(engine, query: str) -> dict:
    """A column where one row is copied to ``TIE_COPIES`` (inside a full
    chunk, across a chunk boundary, inside the clamped tail chunk), served
    on the card. Required: the copies score identical bits for every
    query, equal across every copy in the full score matrix too, and the
    lower row wins each tie (the copies lead each top-k in row order).
    The column's own ``search_batch`` serves ``query``, whose embedding
    IS the copied row; ``TIE_QUERIES`` queries near that row go through the
    same ``packed_dense_topk`` call at the column's chunk."""
    from tfidf_tpu_torch.engine.dense import EmbeddingColumn
    from tfidf_tpu_torch.ops.dense import dense_scores, packed_dense_topk
    from tfidf_tpu_torch.ops.topk import fetch_packed, unpack_topk
    src = engine.dense
    counts = engine.analyzer.counts(query)
    target = src.embedder.embed_query(counts).astype(np.float32)
    rows = src._emb_dev[:TIE_ROWS, :src.dim].cpu().numpy()
    rows[list(TIE_COPIES)] = target
    col = EmbeddingColumn(src.embedder, chunk=TIE_CHUNK, device="cuda")
    col.install_arrays(rows, [f"t{i:07d}" for i in range(TIE_ROWS)])
    col.commit()
    copies = list(TIE_COPIES)
    served = col.search_batch([counts], TOP_K)[0]
    got = [int(n[1:]) for n, _ in served[:len(copies)]]
    bits = {np.float32(v).tobytes() for _, v in served[:len(copies)]}
    if got != copies or len(bits) != 1:
        raise SystemExit(f"dense ties: the served copies {served} are not "
                         f"{copies} at one score")
    rng = np.random.default_rng(SEED + 16)
    qh = np.zeros((TIE_QUERIES, col._emb_dev.shape[1]), np.float32)
    qh[:, :col.dim] = target + 0.02 * rng.standard_normal(
        (TIE_QUERIES, col.dim)).astype(np.float32)
    qh /= np.linalg.norm(qh, axis=1, keepdims=True)
    q = torch.from_numpy(qh).cuda()
    vals, ids = unpack_topk(fetch_packed(packed_dense_topk(
        q, col._emb_dev, TIE_ROWS, k=TOP_K, chunk=col._chunk)))
    lead = ids[:, :len(copies)]
    if (lead != np.array(copies)).any():
        bad = np.flatnonzero((lead != np.array(copies)).any(axis=1))
        raise SystemExit(f"dense ties: {len(bad)} of {TIE_QUERIES} queries "
                         f"do not rank the copies first in row order: "
                         f"{ids[bad[0]].tolist()}")
    lv = vals[:, :len(copies)].view(np.int32)
    if (lv != lv[:, :1]).any():
        raise SystemExit("dense ties: copies score different bits in the "
                         "served top-k")
    full = dense_scores(q, col._emb_dev, TIE_ROWS, chunk=col._chunk)
    cols = full[:, copies].view(torch.int32)
    differ = int((cols != cols[:, :1]).any(dim=1).sum())
    if differ:
        raise SystemExit(f"dense ties: {differ} of {TIE_QUERIES} rows of "
                         f"the full score matrix score the copies apart")
    del col, full
    return {"rows": TIE_ROWS, "chunk": TIE_CHUNK, "copies": copies,
            "queries": TIE_QUERIES + 1, "identical_bits": True,
            "lower_row_first": True}


def dense_bits(engine, batch) -> dict:
    """On the first 8 queries of ``batch``: the served top-k against the
    one-shot top-k from the same chunk products (bitwise, required),
    against one full-column matmul and against chunks of 2^12 rows; the
    8 queries alone (B=8) against inside the 512-query batch; the batch
    run twice (all recorded); the tie column (:func:`dense_ties`,
    required)."""
    from tfidf_tpu_torch.ops.dense import (chunk_rows, dense_scores,
                                           packed_dense_topk)
    from tfidf_tpu_torch.ops.topk import fetch_packed, packed_topk
    col = engine.dense
    n, emb = len(col._names), col._emb_dev
    host = emb[:n, :col.dim].cpu().numpy().astype(np.float64)

    def queries(qs):
        return torch.from_numpy(col._embed_queries(
            [engine.analyzer.counts(q) for q in qs])).cuda()

    def served(q, chunk=col._chunk):
        return fetch_packed(packed_dense_topk(q, emb, n, k=TOP_K,
                                              chunk=chunk))

    q8, q512 = queries(batch[:8]), queries(batch)
    q64 = q512[:, :col.dim].double().cpu().numpy()
    mine = served(q8)
    same = fetch_packed(packed_topk(dense_scores(
        q8, emb, n, chunk=chunk_rows(col._doc_cap, col._chunk, TOP_K)),
        n, k=TOP_K))
    if mine.tobytes() != same.tobytes():
        raise SystemExit("dense bits: the served top-k differs from the "
                         "one-shot top-k of the same chunk products")
    one = fetch_packed(packed_topk(torch.matmul(q8, emb.T), n, k=TOP_K))
    big = served(q512)
    return {"chunked_vs_oneshot_same_products": {"bitwise": True},
            "chunked_vs_full_matmul": compare_packed(
                mine, one, q64, host, "full matmul"),
            "chunk_2^14_vs_2^12": compare_packed(
                mine, served(q8, 1 << 12), q64, host, "chunk 2^12"),
            "b8_vs_inside_b512": compare_packed(
                mine, big[:8], q64, host, "B=8 vs B=512"),
            "b512_twice": compare_packed(
                big, served(q512), q64, host, "twice"),
            "ties": dense_ties(engine, batch[0])}


def dense_breakdown(engine, batch) -> dict:
    """ms of one 512-query batch split into its parts, each closed by a
    synchronize: query embed (host analyzer + embedder), upload, every
    chunk's product, every chunk's selection, the merge, the fetch; then
    the device time of the products alone and of one served top-k call
    (CUDA events), beside the bound."""
    from tfidf_tpu_torch.ops.dense import (chunk_bounds, chunk_product,
                                           chunk_rows, packed_dense_topk,
                                           select_chunk)
    from tfidf_tpu_torch.ops.topk import merge_topk, pack_topk, unpack_topk
    col = engine.dense
    n, emb = len(col._names), col._emb_dev
    c = chunk_rows(col._doc_cap, col._chunk, TOP_K)
    bounds = chunk_bounds(col._doc_cap, c)
    sync()
    t = [time.perf_counter()]
    qh = col._embed_queries([engine.analyzer.counts(q) for q in batch])
    t.append(time.perf_counter())
    q = torch.from_numpy(qh).cuda()
    sync()
    t.append(time.perf_counter())
    parts = [chunk_product(q, emb, start, c) for _, start in bounds]
    sync()
    t.append(time.perf_counter())
    sel = [select_chunk(p, start, off, n, TOP_K)
           for p, (off, start) in zip(parts, bounds)]
    sync()
    t.append(time.perf_counter())
    del parts
    packed = pack_topk(*merge_topk(torch.stack([v for v, _ in sel]),
                                   torch.stack([i for _, i in sel])))
    sync()
    t.append(time.perf_counter())
    unpack_topk(packed)
    t.append(time.perf_counter())
    names = ("embed", "upload", "products", "selections", "merge", "fetch")
    ms = {nm: (t[i + 1] - t[i]) * 1e3 for i, nm in enumerate(names)}
    B, dim = q.shape
    nbytes = 4 * n * col.dim + 4 * B * col.dim + 8 * B * TOP_K
    flops = 2 * B * n * col.dim
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FMA_FLOP_PER_S * 1e3
    return {"ms": ms, "chunks": len(bounds), "chunk_rows": c,
            "dim_pad": dim, "doc_cap": col._doc_cap,
            "products_event_ms": cuda_ms(
                lambda: [chunk_product(q, emb, start, c)
                         for _, start in bounds], reps=3),
            "served_topk_event_ms": cuda_ms(
                lambda: packed_dense_topk(q, emb, n, k=TOP_K,
                                          chunk=col._chunk), reps=3),
            "bytes": nbytes, "flops": flops,
            "flops_issued": 2 * B * col._doc_cap * dim,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops}


def device_busy(fn) -> dict:
    """Wall ms of ``fn`` under ``torch.profiler`` and the ms its device
    events (kernels, copies) cover: the device's busy and idle shares of
    that call. The profiler slows the host, so this is its own run, not
    the served one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    if not events:
        return {"wall_ms": wall_ms, "busy_ms": "not measured"}
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "device_events": len(events),
            "idle_share": max(0.0, 1.0 - busy_ms / wall_ms)}


def dense_phase(ctx, seed: int) -> dict:
    """Phase 3d: ``Engine.search_dense_batch`` over the 1M-doc column."""
    engine = ctx["engine"]
    rng = np.random.default_rng(seed + 4)
    queries = make_queries(rng, NS_VOCAB, NS_BATCH * (NS_BATCHES + 2))
    served = queries[NS_BATCH:(NS_BATCHES + 1) * NS_BATCH]
    engine.search_dense_batch(queries[:NS_BATCH], k=TOP_K)      # warm-up
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sync()
    t0 = time.perf_counter()
    hits = []
    for lo in range(0, len(served), NS_BATCH):
        hits += engine.search_dense_batch(served[lo:lo + NS_BATCH], k=TOP_K)
    sync()
    secs = time.perf_counter() - t0
    res = {"qps": len(served) / secs, "batch_ms": secs / NS_BATCHES * 1e3,
           "memory": {"allocated_bytes": base,
                      "peak_allocated_bytes":
                      torch.cuda.max_memory_allocated()}}
    log(f"[dense] {len(served)} queries in {secs:.3f}s = {res['qps']:.1f} "
        f"q/s ({res['batch_ms']:.2f} ms per {NS_BATCH}-query batch); memory "
        f"{res['memory']}")
    names = [f"d{i}" for i in range(ctx["rows"].shape[0])]
    res["oracle"] = dense_oracle(engine, served[:256], hits[:256],
                                 ctx["rows"], names)
    log(f"[dense] f64 oracle top-{TOP_K} OK: {res['oracle']}")
    res["breakdown"] = dense_breakdown(engine, queries[-NS_BATCH:])
    log(f"[dense] one batch, synchronized: {res['breakdown']}")
    res["bits"] = dense_bits(engine, served[:NS_BATCH])
    log(f"[dense] bit comparisons on 8 queries: {res['bits']}")
    res["profiled_batch"] = device_busy(
        lambda: engine.search_dense_batch(served[:NS_BATCH], k=TOP_K))
    log(f"[dense] one served batch under torch.profiler: "
        f"{res['profiled_batch']}")
    check_clean(engine, "dense plane")
    ctx["dense_queries"] = served[:NS_BATCH]
    ctx["dense_hits"] = hits[:NS_BATCH]
    return res


# --------------------------------------------------------------------------
# phase 12: the device witness on the served path, at the north star
# --------------------------------------------------------------------------

WITNESS_BATCHES = 8            # search_batch batches in the window
WITNESS_ARRAYS = 2             # search_batch_arrays chunks in the window
WITNESS_DENSE = 2              # dense batches on phase 3d's column
WITNESS_WARM = 2               # warm-up batches before end_warmup()


def witness_phase(ctx, seed: int) -> dict:
    """Phase 12: the device witness around phase 3's engine (the 1M-doc
    north star, ``Config()`` defaults, ELL kernel v4, batch 512, top-10):
    installed, two warm-up batches, ``end_warmup()``, then 8
    ``search_batch`` batches and 2 ``search_batch_arrays`` chunks (half
    through ``_run_pipelined``, half through ``_run_inline``) and 2 dense
    batches. Gates: no kernel build after warmup, every device->host sync
    the card reported (and every tensor transfer seen from Python) at a
    site the static cone explains, no reported sync outside the port, at
    least one observation, v4 launches in the window, and every witnessed
    batch's results equal to the bit to the same batch served without the
    witness."""
    from tfidf_tpu_torch import kernels
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.tools.graftcheck.device_witness import \
        DeviceWitness
    t_phase = time.perf_counter()
    engine = ctx["engine"]
    searcher = engine.searcher
    rng = np.random.default_rng(seed + 12)
    n_sparse = (WITNESS_WARM + WITNESS_BATCHES + WITNESS_ARRAYS) * NS_BATCH
    qs = make_queries(rng, NS_VOCAB, n_sparse)
    warm = qs[:WITNESS_WARM * NS_BATCH]
    batches = [qs[(WITNESS_WARM + i) * NS_BATCH:
                  (WITNESS_WARM + i + 1) * NS_BATCH]
               for i in range(WITNESS_BATCHES + WITNESS_ARRAYS)]
    dense_q = [ctx["dense_queries"]] * WITNESS_DENSE

    def serve(i, b):
        # the first half of each kind pipelined, the second inline
        if i < WITNESS_BATCHES:
            searcher.pipeline_mode = ("executor" if i < WITNESS_BATCHES // 2
                                      else "inline")
            return engine.search_batch(b, k=TOP_K)
        j = i - WITNESS_BATCHES
        searcher.pipeline_mode = ("executor" if j < WITNESS_ARRAYS // 2
                                  else "inline")
        vals, ids, kk, _names = engine.search_batch_arrays(b, k=TOP_K)
        return vals.tobytes(), ids.tobytes(), kk

    # the same batches without the witness: what they must answer
    want = [serve(i, b) for i, b in enumerate(batches)]
    want_dense = [engine.search_dense_batch(q, k=TOP_K) for q in dense_q]
    searcher.pipeline_mode = "auto"
    builds0 = kernels.build_count()

    w = DeviceWitness()
    w.install()
    try:
        for i in range(WITNESS_WARM):
            searcher.pipeline_mode = ("executor", "inline")[i % 2]
            engine.search_batch(warm[i * NS_BATCH:(i + 1) * NS_BATCH],
                                k=TOP_K)
        w.end_warmup()
        warm_obs, warm_syncs = dict(w.observed), dict(w.syncs)
        E.reset_launches()
        t0 = time.perf_counter()
        got = [serve(i, b) for i, b in enumerate(batches)]
        got_dense = [engine.search_dense_batch(q, k=TOP_K)
                     for q in dense_q]
        window_s = time.perf_counter() - t0
        launches = dict(E.launches)
    finally:
        w.uninstall()
        searcher.pipeline_mode = "auto"
    n = len(batches) + len(dense_q)

    def window(now: dict, before: dict) -> dict:
        """Per-batch counts in the window (warm-up counts subtracted)."""
        return {" ".join(k): (v - before.get(k, 0)) / n
                for k, v in sorted(now.items()) if v > before.get(k, 0)}
    syncs = window(w.syncs, warm_syncs)
    res = {"batches": {"search_batch": WITNESS_BATCHES,
                       "search_batch_arrays": WITNESS_ARRAYS,
                       "dense": WITNESS_DENSE, "batch": NS_BATCH},
           "window_s": window_s, "launches": launches,
           "builds_after_warmup": w.post_warmup_builds(),
           "builds_in_phase": kernels.build_count() - builds0,
           "observations": w.n_observations(),
           "unattributed_syncs": w.unattributed,
           "syncs_per_batch": syncs,
           "transfers_per_batch": window(w.observed, warm_obs),
           "h2d_blocking_per_batch": {k: v for k, v in syncs.items()
                                      if k.endswith(" h2d")},
           "warmup": {"syncs": {" ".join(k): v
                                for k, v in warm_syncs.items()},
                      "transfers": {" ".join(k): v
                                    for k, v in warm_obs.items()}},
           "explained_sites": sorted(".".join(x) for x in w.explained)}
    log(f"[witness] {w.report()}")
    w.check(max_post_warmup_builds=0, min_observations=n)
    if launches["v4"] <= 0 or launches["v3"] != 0:
        raise SystemExit(f"witness: launches in the window {launches}")
    if got != want or got_dense != want_dense:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise SystemExit(f"witness: witnessed batches {bad} (dense "
                         f"{got_dense != want_dense}) differ from the same "
                         f"batches served without the witness")
    res["results_bitwise_equal"] = True
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[witness] {n} batches in {window_s:.3f}s, launches {launches}, "
        f"every witnessed batch equal to the bit to the unwitnessed one; "
        f"phase 12 took {res['seconds']:.1f}s")
    check_clean(engine, "witness phase")
    return res


def text_path() -> dict:
    """Phase 4: the five-document corpus through ingest_text on the card
    with the default Config (dense plane on); the JAX tests' expectations
    plus inline BM25 and cosine oracles."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.config import Config
    with tempfile.TemporaryDirectory() as tmp:
        e = Engine(Config(documents_path=tmp, index_path=tmp))
        assert e.dense is not None and e.dense.device.type == "cuda"
        for name, text in CORPUS.items():
            e.ingest_text(name, text)
        e.commit()
        E.reset_launches()
        hits = e.search("fast food", k=5)
        launched = E.launches["v4"]
        dense_hits = e.search_dense_batch(["fast food"], k=5)[0]
        doc_names = sorted(CORPUS)
        rows = np.stack([e.dense.embedder.embed_counts(
            e.analyzer.counts(CORPUS[n])) for n in doc_names])
        dense = dense_oracle(e, ["fast food"], [dense_hits], rows,
                             doc_names)
        check_clean(e, "text path")
    names = [h.name for h in hits]
    assert names[0] == "file1.txt" and "file2.txt" not in names, names
    assert all(h.score > 0 for h in hits) and launched > 0, (hits,
                                                            launched)
    docs = {n: t.split() for n, t in CORPUS.items()}
    avgdl = sum(len(d) for d in docs.values()) / len(docs)
    want = {}
    for n, d in docs.items():
        s = 0.0
        for t in ("fast", "food"):
            tf = d.count(t)
            if tf:
                df = sum(t in x for x in docs.values())
                idf = np.log1p((len(docs) - df + 0.5) / (df + 0.5))
                s += idf * tf / (tf + 1.2 * (0.25 + 0.75 * len(d) / avgdl))
        if s > 0:
            want[n] = s
    assert set(names) == set(want), (names, want)
    for h in hits:
        assert abs(h.score - want[h.name]) <= 1e-5 * want[h.name], (h, want)
    log(f"[text] search('fast food') -> {[(h.name, round(h.score, 6)) for h in hits]}")
    log(f"[text] search_dense_batch(['fast food']) -> {dense_hits}; "
        f"f64 oracle {dense}")
    return {"hits": names, "launches": launched, "dense_hits": dense_hits,
            "dense_oracle": dense}


# --------------------------------------------------------------------------
# phases 5-6: the worker engine and the durable text path
# --------------------------------------------------------------------------

def metric(name: str) -> float:
    from tfidf_tpu_torch.utils.metrics import global_metrics
    return global_metrics.get(name)


_FALLBACK_SERVED = [0.0]   # compute_fallback_served after the last check


def check_clean(engine, what: str, faults: int = 0) -> None:
    """With nothing armed: the engine is healthy with ``faults`` faults
    in all, and no request was served by the fallback since the last
    check."""
    from tfidf_tpu_torch.utils.device_nemesis import global_device_nemesis
    st = engine.compute_stats()
    served = metric("compute_fallback_served")
    if (global_device_nemesis.armed or st["state"] != "healthy"
            or st["total_faults"] != faults
            or served != _FALLBACK_SERVED[0]):
        raise SystemExit(f"{what}: unarmed engine not clean: {st}, "
                         f"fallback served {served} (was "
                         f"{_FALLBACK_SERVED[0]})")
    log(f"[clean] {what}: healthy, {faults} faults, fallback served "
        f"{served:.0f}")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def checkpoint_phase(ctx, main_res, work: str) -> dict:
    """Phase 5a: save the 1M-doc engine, restore it into a fresh engine
    on the card (the snapshot.npz fast path, no commit), serve the same
    queries: hits identical (names and f32 bits), launches as expected."""
    from tfidf_tpu_torch.engine.checkpoint import (restore_checkpoint,
                                                   save_checkpoint)
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.metrics import global_metrics
    engine = ctx["engine"]
    ckpt = os.path.join(work, "ckpt")
    t0 = time.perf_counter()
    save_checkpoint(engine, ckpt)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(os.path.realpath(ckpt))
    emb_bytes = os.path.getsize(os.path.join(os.path.realpath(ckpt),
                                             "embeddings.npz"))
    installs = metric("checkpoint_snapshot_installs")
    reembeds = metric("checkpoint_dense_reembeds")
    sync()
    t0 = time.perf_counter()
    restored, meta = restore_checkpoint(ckpt, engine.config)
    sync()
    load_s = time.perf_counter() - t0
    snap = global_metrics.snapshot()
    load_parts = {k[len("phase_restore."):-len("_sum_ms")]: snap[k] / 1e3
                  for k in snap if k.startswith("phase_restore.")
                  and k.endswith("_sum_ms")}
    if metric("checkpoint_snapshot_installs") != installs + 1:
        raise SystemExit("checkpoint: the snapshot.npz fast path was not "
                         "taken (the restore committed)")
    if restored.device != engine.device:
        raise SystemExit(f"checkpoint: restored on {restored.device}")
    restored.search_batch(ctx["queries"][:NS_BATCH], k=TOP_K)   # warm
    E.reset_launches()
    hits, arrays, secs = drive(restored, ctx["served"], ctx["arrays_q"])
    counts = dict(E.launches)
    want = ctx["want"]
    if counts != {"v4": want, "v3": 0}:
        raise SystemExit(f"checkpoint: restored launches {counts}, "
                         f"expected v4={want}")
    if hits != ctx["hits"]:
        raise SystemExit("checkpoint: restored hits differ")
    for a, b in zip(arrays[:2], ctx["arrays"][:2]):
        if a.tobytes() != b.tobytes():
            raise SystemExit("checkpoint: restored arrays differ")
    # the embedding column: installed from embeddings.npz, not re-embedded
    if (metric("checkpoint_dense_reembeds") != reembeds
            or not torch.equal(restored.dense._emb_dev,
                               engine.dense._emb_dev)
            or restored.dense._names != engine.dense._names):
        raise SystemExit("checkpoint: the restored embedding column "
                         "differs or was re-embedded")
    if restored.search_dense_batch(ctx["dense_queries"],
                                   k=TOP_K) != ctx["dense_hits"]:
        raise SystemExit("checkpoint: restored dense hits differ")
    check_clean(restored, "restored engine")
    mirror = restored._fallback.mirror_stats()
    del restored
    torch.cuda.empty_cache()
    qps = (NS_BATCHES + 1) * NS_BATCH / secs
    log(f"[ckpt] save {save_s:.2f}s, restore {load_s:.2f}s (of it, s: "
        f"{ {k: round(v, 2) for k, v in load_parts.items()} }; commit of "
        f"the original {main_res['commit_s']:.2f}s), {nbytes} bytes on disk "
        f"({emb_bytes} of them embeddings.npz); restored engine: sparse "
        f"and dense hits identical to the bit, column equal on the card, "
        f"launches {counts}, {qps:.1f} q/s")
    check_clean(engine, "checkpoint phase")
    return {"save_s": save_s, "load_s": load_s, "load_parts_s": load_parts,
            "bytes": nbytes, "embeddings_bytes": emb_bytes,
            "commit_s": main_res["commit_s"], "launches": counts,
            "qps": qps, "meta_num_docs": meta["num_docs"],
            "restored_mirror": mirror}


def _same_arrays(a, b) -> bool:
    return (a[0].tobytes() == b[0].tobytes()
            and a[1].tobytes() == b[1].tobytes() and a[2:] == b[2:])


def compute_phase(ctx) -> dict:
    """Phase 5b: the compute plane on the 1M-doc engine (sick after 3
    faults, probe interval 1 h, OOM ladder floor 2)."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.device_nemesis import (DevicePoisonedOutput,
                                                      global_device_nemesis)
    nem = global_device_nemesis
    engine = ctx["engine"]
    snap = engine.index.snapshot
    nblk = len(main_path_blocks(snap, 8, 256))
    qs = ctx["queries"][-64:]
    batches = [qs[i:i + 8] for i in range(0, 32, 8)]
    out: dict = {"blocks_at_b8": nblk}

    # R: the kernel path
    E.reset_launches()
    R = [engine.search_batch(b, k=TOP_K) for b in batches]
    RA = engine.search_batch_arrays(batches[0], k=TOP_K)
    if E.launches["v4"] != nblk * (len(batches) + 1):
        raise SystemExit(f"compute: kernel path launches {E.launches}")
    if engine.pop_fallback_served():
        raise SystemExit("compute: R was served by the fallback")
    check_clean(engine, "compute phase, R")

    # a transient fault on every dispatch: fallback, degraded, sick
    nem.script("score_ell:transient")
    E.reset_launches()
    states, fb_ms = [], []
    for i in range(engine.compute.sick_after):
        t0 = time.perf_counter()
        got = engine.search_batch(batches[i % 4], k=TOP_K)
        fb_ms.append((time.perf_counter() - t0) * 1e3)
        if got != R[i % 4] or not engine.pop_fallback_served():
            raise SystemExit(f"compute: fault {i + 1}: the fallback's "
                             "hits differ from R or were not flagged")
        states.append(engine.compute.state)
    want = (["healthy"] * (engine.compute.degraded_after - 1)
            + ["degraded"] * (engine.compute.sick_after
                              - engine.compute.degraded_after)
            + ["sick"])
    if states != want:
        raise SystemExit(f"compute: states {states}, expected {want}")
    fired = nem.snapshot()["rules"][0]["fired"]
    probes = engine.compute_stats()["recovery_probes"]
    # sick: one batch of each entry point, and the device is not tried
    t0 = time.perf_counter()
    got = engine.search_batch(batches[3], k=TOP_K)
    fb_ms.append((time.perf_counter() - t0) * 1e3)
    if got != R[3] or not engine.pop_fallback_served():
        raise SystemExit("compute: sick fallback hits differ from R")
    t0 = time.perf_counter()
    got_a = engine.search_batch_arrays(batches[0], k=TOP_K)
    fb_ms.append((time.perf_counter() - t0) * 1e3)
    if not _same_arrays(got_a, RA) or not engine.pop_fallback_served():
        raise SystemExit("compute: sick fallback arrays differ from R")
    if (nem.snapshot()["rules"][0]["fired"] != fired
            or engine.compute_stats()["recovery_probes"] != probes
            or E.launches["v4"] != 0):
        raise SystemExit(f"compute: the device was tried while sick "
                         f"(launches {E.launches})")
    out["states"] = states
    out["fallback_ms_per_batch"] = fb_ms
    log(f"[compute] transient: states {states}, all {len(fb_ms)} batches "
        f"from the fallback bitwise equal to the kernel path, 0 launches "
        f"while armed; fallback ms per 8-query batch "
        f"{[round(x, 1) for x in fb_ms]}")

    # heal, shorten the probe interval, probe
    nem.clear()
    engine.compute.probe_interval_s = 0.0
    E.reset_launches()
    got = engine.search_batch(batches[0], k=TOP_K)
    st = engine.compute_stats()
    if (got != R[0] or engine.pop_fallback_served()
            or st["state"] != "healthy" or st["recovery_probes"] != probes + 1
            or E.launches["v4"] != nblk):
        raise SystemExit(f"compute: the probe did not heal: {st}, "
                         f"launches {E.launches}")
    engine.compute.probe_interval_s = 3600.0
    out["after_probe"] = st
    log(f"[compute] healed by one probe: {st['state']}, launches "
        f"{E.launches}")

    # one injected OOM: the ladder's halves merge to R
    steps = metric("compute_oom_backoff")
    nem.script("score_ell:oom::count=1")
    E.reset_launches()
    got = engine.search_batch(batches[1], k=TOP_K)
    nem.clear()
    if (got != R[1] or engine.pop_fallback_served()
            or engine.compute.state != "healthy"
            or metric("compute_oom_backoff") != steps + 1
            or E.launches["v4"] != 2 * nblk):
        raise SystemExit(f"compute: injected OOM ladder: launches "
                         f"{E.launches}, {engine.compute_stats()}")
    log(f"[compute] injected OOM: one ladder step, two halves of 4 merged "
        f"equal to R, launches {E.launches}")

    # poison: exactly the queries of >= 3 distinct terms are named
    bad = next((b for b in batches if 0 < sum(
        len(set(q.split())) >= 3 for q in b) < len(b)), batches[2])
    expect = tuple(q for q in bad if len(set(q.split())) >= 3)
    nem.script("score_ell:poison:1.0:min_uniq=3")
    state0 = engine.compute_stats()
    try:
        engine.search_batch(bad, k=TOP_K)
        named = None
    except DevicePoisonedOutput as e:
        named = e.queries
    nem.clear()
    st = engine.compute_stats()
    if (named != expect or engine.pop_fallback_served()
            or st["state"] != "healthy"
            or st["total_faults"] != state0["total_faults"]):
        raise SystemExit(f"compute: poison named {named}, expected "
                         f"{expect}; {st}")
    log(f"[compute] poison: named exactly {len(expect)} of {len(bad)} "
        f"queries, health unchanged")
    out["poisoned"] = len(expect)
    out["dense"] = dense_faults(engine, ctx["dense_queries"][:8])
    out["guard_ns_unarmed"] = guard_cost_ns()
    out["real_oom"] = real_oom(engine, ctx)
    out["mirror"] = engine._fallback.mirror_stats()
    out["faults"] = engine.compute_stats()
    _FALLBACK_SERVED[0] = metric("compute_fallback_served")
    E.reset_launches()
    if engine.search_batch(batches[2], k=TOP_K) != R[2] \
            or E.launches["v4"] != nblk:
        raise SystemExit("compute: unarmed batch after the phase differs")
    check_clean(engine, "compute phase", out["faults"]["total_faults"])
    return out


def dense_faults(engine, qs) -> dict:
    """The dense seam under the nemesis: ``dense:transient`` re-raises
    and advances health with no fallback (healthy, degraded, sick) and
    the next clean call heals it; one ``dense:oom`` merges through the
    ladder to the unsplit batch's ids; ``dense:poison`` answers with empty
    hit lists, health unchanged, as the JAX package's column does (it
    stops each row at its first non-finite value)."""
    from tfidf_tpu_torch.utils.device_nemesis import (DeviceTransientError,
                                                      global_device_nemesis)
    nem = global_device_nemesis
    want = engine.search_dense_batch(qs, k=TOP_K)
    served0 = metric("compute_fallback_served")
    faults0 = engine.compute_stats()["total_faults"]
    nem.script("dense:transient")
    states = []
    for i in range(engine.compute.sick_after):
        try:
            engine.search_dense_batch(qs, k=TOP_K)
            raise SystemExit("dense: an armed transient did not re-raise")
        except DeviceTransientError:
            states.append(engine.compute.state)
    nem.clear()
    expect = (["healthy"] * (engine.compute.degraded_after - 1)
              + ["degraded"] * (engine.compute.sick_after
                                - engine.compute.degraded_after)
              + ["sick"])
    if (states != expect or engine.pop_fallback_served()
            or metric("compute_fallback_served") != served0
            or engine.compute_stats()["total_faults"]
            != faults0 + len(states)):
        raise SystemExit(f"dense transient: states {states}, expected "
                         f"{expect}; {engine.compute_stats()}")
    if engine.search_dense_batch(qs, k=TOP_K) != want \
            or engine.compute.state != "healthy":
        raise SystemExit("dense: the clean call after the faults did not "
                         "heal or differs")
    steps = metric("compute_oom_backoff")
    nem.script("dense:oom::count=1")
    got = engine.search_dense_batch(qs, k=TOP_K)
    nem.clear()
    if ([[n for n, _ in h] for h in got] != [[n for n, _ in h]
                                             for h in want]
            or metric("compute_oom_backoff") != steps + 1
            or engine.compute.state != "healthy"):
        raise SystemExit(f"dense OOM ladder: {engine.compute_stats()}")
    faults = engine.compute_stats()["total_faults"]
    nem.script("dense:poison")
    poisoned = engine.search_dense_batch(qs, k=TOP_K)
    nem.clear()
    if (poisoned != [[] for _ in qs]
            or engine.compute_stats()["total_faults"] != faults
            or engine.pop_fallback_served()
            or metric("compute_fallback_served") != served0):
        raise SystemExit(f"dense poison: {poisoned[:2]}, "
                         f"{engine.compute_stats()}")
    res = {"transient_states": states, "oom_ladder_steps": 1,
           "oom_values_bitwise": got == want,
           "poison_answer": "empty hit lists"}
    log(f"[compute] dense: transient re-raised {len(states)}x ({states}), "
        f"no fallback, healed by the next call; OOM merged by the ladder "
        f"(ids equal, values bitwise {got == want}); poison -> empty hit "
        f"lists, health unchanged")
    return res


def guard_cost_ns() -> float:
    """Host ns of one unarmed ``device_guard`` call."""
    from tfidf_tpu_torch.utils.device_nemesis import device_guard
    n = 200_000
    t0 = time.perf_counter()
    for _ in range(n):
        device_guard("score_ell", batch=512, uniq=512)
    ns = (time.perf_counter() - t0) / n * 1e9
    log(f"[compute] unarmed guard: {ns:.1f} ns per batch")
    return ns


def real_oom(engine, ctx) -> dict:
    """A real ``torch.cuda.OutOfMemoryError``: a 2048-query batch (its
    scores alone are 8 GiB) with the allocator capped at what the engine
    holds plus 6 GiB. The ladder's halves must merge to the same queries
    served in 512-query chunks without the cap."""
    qs = ctx["queries"][:2048]
    want = engine.search_batch(qs, k=TOP_K)
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + (6 << 30)
    faults = engine.compute_stats()["faults_by_kind"].get("oom", 0)
    steps = metric("compute_oom_backoff")
    engine.searcher.query_batch = 2048
    torch.cuda.set_per_process_memory_fraction(min(1.0, cap / total))
    try:
        got = engine.search_batch(qs, k=TOP_K)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        engine.searcher.query_batch = NS_BATCH
    res = {"cap_bytes": cap,
           "oom_faults": engine.compute_stats()["faults_by_kind"].get(
               "oom", 0) - faults,
           "ladder_steps": metric("compute_oom_backoff") - steps,
           "fallback": engine.pop_fallback_served()}
    if res["oom_faults"] == 0:
        log(f"[compute] real OOM: not provoked under a {cap} byte cap "
            f"({res})")
        if got != want:
            raise SystemExit("real OOM run: hits differ")
        return res
    if got != want or res["fallback"]:
        raise SystemExit(f"real OOM: the ladder's merge differs or the "
                         f"fallback served: {res}")
    log(f"[compute] real torch.cuda.OutOfMemoryError at B=2048 under a "
        f"{cap} byte cap: {res['oom_faults']} OOM faults, "
        f"{res['ladder_steps']:.0f} ladder steps, merged hits identical")
    torch.cuda.empty_cache()
    return res


_SYLLABLES = ("ka", "lo", "mi", "re", "tu", "sa", "ne", "po", "vi", "da",
              "qu", "ze", "ba", "fi", "go", "hu", "ja", "we", "xi", "yo")


def make_texts(rng, n_docs: int, n_words: int = 30_000,
               avg_len: int = 100) -> list[str]:
    """ASCII documents of Zipf(1.1) words over a made-up vocabulary,
    with punctuation and capitals the analyzer has to handle."""
    lens = rng.integers(2, 5, n_words)
    parts = rng.integers(0, len(_SYLLABLES), (n_words, 4))
    words = np.array(["".join(_SYLLABLES[p] for p in row[:k])
                      for row, k in zip(parts, lens)])
    out = []
    for n in np.clip(rng.poisson(avg_len, n_docs), 5, None):
        w = words[(rng.zipf(1.1, n) - 1) % n_words].tolist()
        for i in range(0, n, 17):
            w[i] = w[i].capitalize()
        for i in range(0, n, 23):
            w[i] += ","
        out.append(" ".join(w) + ".")
    return out


DURABLE_DOCS = 5_000           # phase 6's documents (cut from 20,000 to
                               # make room for phase 10 in the run's time,
                               # then from 10,000 for phase 13)


def durable_phase(seed: int, work: str) -> dict:
    """Phase 6: the durable upload path with the native tokenizer, then
    a rebuild of the same documents dir through the Python analyzer."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.analyzer import extract_text
    from tfidf_tpu_torch.utils import storage
    from tfidf_tpu_torch.utils.config import Config
    rng = np.random.default_rng(seed + 6)
    n_docs = DURABLE_DOCS
    t0 = time.perf_counter()
    texts = make_texts(rng, n_docs)
    names = [f"doc{i:05d}.txt" for i in range(n_docs)]
    gen_s = time.perf_counter() - t0
    docs_dir = os.path.join(work, "documents")
    cfg = dict(documents_path=docs_dir, index_path=os.path.join(work, "ix"),
               embedding_enabled=False, storage_fsync=True, query_batch=64)
    e = Engine(Config(**cfg))
    if e.native is None:
        raise SystemExit("durable: the native tokenizer did not build")
    native0 = metric("ingest_native_fast_path")
    python0 = metric("ingest_python_fallback")
    data = [t.encode("ascii") for t in texts]
    # the text check and decode that staging runs first, timed alone
    t0 = time.perf_counter()
    for d in data:
        extract_text(d)
    extract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    staged = [(n, *e.stage_bytes(n, d)) for n, d in zip(names, data)]
    stage_s = time.perf_counter() - t0
    storage.global_committer.sync([s[1] for s in staged])
    sync_s = time.perf_counter() - t0 - stage_s
    t1 = time.perf_counter()
    for name, tmp, path, text in staged:
        e.publish_staged(name, tmp, path, text)
    publish_s = time.perf_counter() - t1
    storage.global_committer.sync(sorted({os.path.dirname(s[2])
                                          for s in staged}))
    ingest_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    e.commit()
    sync()
    commit_s = time.perf_counter() - t0
    native = metric("ingest_native_fast_path") - native0
    if native != n_docs or metric("ingest_python_fallback") != python0:
        raise SystemExit(f"durable: native path took {native} of {n_docs}")
    words = sorted({w for t in texts[:200] for w in
                    t.lower().replace(",", "").replace(".", "").split()})
    queries = [" ".join(rng.choice(words, int(rng.integers(2, 4)),
                                   replace=False)) for _ in range(64)]
    nblk = len(main_path_blocks(e.index.snapshot, 64, 256))
    E.reset_launches()
    hits = e.search_batch(queries, k=TOP_K)
    if E.launches["v4"] != nblk or nblk == 0:
        raise SystemExit(f"durable: launches {E.launches}, expected {nblk}")
    check_clean(e, "durable path")

    fresh = Engine(Config(**dict(cfg, native_ingest=False,
                                 embedding_enabled=True)))
    # the rebuild's share spent embedding: the column's upsert, timed
    embed_s = [0.0]
    upsert = fresh.dense.upsert

    def timed_upsert(name, counts):
        t = time.perf_counter()
        upsert(name, counts)
        embed_s[0] += time.perf_counter() - t
    fresh.dense.upsert = timed_upsert
    t0 = time.perf_counter()
    n = fresh.build_from_directory()
    rebuild_s = time.perf_counter() - t0
    del fresh.dense.upsert
    if n != n_docs or metric("ingest_python_fallback") - python0 != n_docs:
        raise SystemExit(f"durable: rebuild indexed {n} of {n_docs}")
    E.reset_launches()
    rebuilt = fresh.search_batch(queries, k=TOP_K)
    if E.launches["v4"] != nblk:
        raise SystemExit(f"durable: rebuild launches {E.launches}")
    if rebuilt != hits or not any(hits):
        raise SystemExit("durable: rebuilt hits differ from the durable "
                         "path's")
    col = fresh.dense
    if col.stats()["docs"] != n_docs:
        raise SystemExit(f"durable: {col.stats()} embedded")
    dense = dense_oracle(fresh, queries,
                         fresh.search_dense_batch(queries, k=TOP_K),
                         np.stack([col._vecs[nm] for nm in col._names]),
                         col._names)
    check_clean(fresh, "rebuilt engine")
    res = {"docs": n_docs, "generate_s": gen_s, "stage_s": stage_s,
           "extract_s": extract_s, "fsync_s": sync_s,
           "publish_s": publish_s, "ingest_s": ingest_s,
           "commit_s": commit_s,
           "durable_docs_per_s": n_docs / ingest_s,
           "rebuild_s": rebuild_s, "rebuild_docs_per_s": n_docs / rebuild_s,
           "rebuild_embed_s": embed_s[0],
           "native_docs": native, "ranks": sum(len(h) for h in hits),
           "launches_per_search": nblk, "rebuild_dense_oracle": dense}
    log(f"[durable] {n_docs} docs: stage {stage_s:.2f}s (extract_text "
        f"alone {extract_s:.2f}s), group fsync {sync_s:.2f}s, publish "
        f"(rename, native analyze, index) {publish_s:.2f}s, durable path {res['durable_docs_per_s']:.1f} "
        f"docs/s (commit {commit_s:.2f}s), all native; Python rebuild "
        f"{res['rebuild_docs_per_s']:.1f} docs/s with the dense plane on "
        f"(commit included; {embed_s[0]:.2f}s of {rebuild_s:.2f}s in the "
        f"column's upsert); {res['ranks']} ranks identical on 64 queries; "
        f"their dense top-{TOP_K} against the f64 oracle: {dense}")
    return res


# --------------------------------------------------------------------------
# phase 8: streaming segments and tiering at config 4's shape
# --------------------------------------------------------------------------

ST_DOCS = 500_000              # phase 3's first docs streamed (1M until
                               # the 8.8M-passage probe took config 4's
                               # scale, probe_msmarco_torch.py)
ST_COMMIT_EVERY = 10_000       # bench.py's config 4 shape: commit per 10k
ST_BATCH = 64                  # bench.py's config 4 query batch
ST_QUERIES = 512               # phase 3's queries served in phase 8
ST_MUTATE = 0.01               # share of docs deleted, and another upserted
# f32 operations the BM25 weight of one posting takes in
# ops/scoring.bm25_weights (idf: 5, norm: 4, tf + norm, idf * tf, divide)
BM25_WEIGHT_OPS = 12


def _gather_docs(corpus, rows: np.ndarray):
    """The postings of corpus docs ``rows`` as a corpus of their own."""
    offsets, ids, tfs, lengths = corpus
    lens = np.diff(offsets)[rows]
    starts = offsets[:-1][rows]
    pos = (np.arange(int(lens.sum()), dtype=np.int64)
           - np.repeat(np.cumsum(lens) - lens, lens)
           + np.repeat(starts, lens))
    return (np.concatenate([[0], np.cumsum(lens)]), ids[pos], tfs[pos],
            lengths[rows])


def _concat_corpora(*parts):
    """One corpus of ``parts`` in order (offsets shifted, one copy)."""
    base = np.cumsum([0] + [int(p[0][-1]) for p in parts[:-1]])
    return (np.concatenate([parts[0][0][:1]] + [p[0][1:] + b for p, b in
                                                zip(parts, base)]),
            *(np.concatenate([p[i] for p in parts]) for i in (1, 2, 3)))


def _segment_stats(segments, vocab: int):
    """Tombstone-inclusive df, N and avgdl recomputed in f64 from every
    segment's retained host postings (what the index must score with:
    a tombstoned doc counts until its segment merges). ``segments`` is a
    snapshot's list: a background merge may replace the index's own list
    after the commit, and the snapshot's stats are the ones served."""
    df = np.zeros(vocab, np.float64)
    n, total = 0, 0.0
    for seg in segments:
        t = np.concatenate([d.term_ids for d in seg.host_docs])
        df += np.bincount(t, minlength=vocab)[:vocab]
        n += seg.n_docs
        total += float(np.asarray(seg.raw_len, np.float64).sum())
    return df, float(n), total / n


def _hits_key(hits) -> list:
    return [[(h.name, h.score) for h in hs] for hs in hits]


def _arrays_live(arrays) -> list:
    """(name, value bits) of the live entries of search_batch_arrays."""
    vals, ids, _kk, names = arrays
    return [[(names[int(i)], v.tobytes()) for v, i in zip(vr, ir) if v > 0]
            for vr, ir in zip(vals, ids)]


def segment_scorer_times(engine, queries) -> dict:
    """The segment scorer (torch ops, no kernel) on one 512-query batch
    over the streaming snapshot: device ms (CUDA events), and its bound —
    bytes: each live posting's tf and term and each live row's length
    once, the batch's slot map, df and query weights once, the scores
    written once; operations: the BM25 weight of every live posting and a
    multiply and an add for each (posting, query) pair whose query weight
    is not zero."""
    from tfidf_tpu_torch.ops.ell import score_segments_impl
    s = engine.searcher
    snap = engine.index.snapshot
    qb, _ = s._vectorize(queries, len(queries))
    B = qb.slots.shape[0]
    kw = engine.model.score_kwargs()

    def run():
        return score_segments_impl(snap.views, snap.df, qb, snap.n_docs,
                                   snap.avgdl, **kw)

    ms = cuda_ms(run, reps=3)
    # per-term count of queries with a nonzero weight, on the host
    w = qb.weights.cpu().numpy()
    slots = qb.slots.cpu().numpy()
    qnnz_slot = np.zeros(qb.uniq.shape[0] + 1, np.int64)
    for row_s, row_w in zip(slots, w):
        qnnz_slot[np.unique(row_s[row_w > 0])] += 1
    qnnz = np.zeros(snap.df.shape[0], np.int64)
    qnnz[qb.uniq_host] = qnnz_slot[:qb.n_uniq]
    postings = rows = products = 0
    for seg in engine.index._segments:
        live = [d for d, a in zip(seg.host_docs, seg.live) if a]
        t = np.concatenate([d.term_ids for d in live])
        postings += t.shape[0]
        rows += len(live)
        products += int(qnnz[t].sum())
    n_out = int(snap.num_docs)
    nbytes = (8 * postings + 4 * rows + 4 * 2 * snap.df.shape[0]
              + 4 * (qb.uniq.shape[0] + 1) * B + 4 * B * n_out)
    ops = BM25_WEIGHT_OPS * postings + 2 * products + B * n_out
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_UNFUSED_OPS_PER_S * 1e3
    return {"ms": ms, "batch": B, "postings": postings,
            "products": products, "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "x_bound": ms / max(t_bytes, t_ops)}


def streaming_breakdown(engine, queries) -> dict:
    """Per-phase ms of one ``ST_BATCH`` batch through the untiered
    segmented path, each phase closed by a synchronize."""
    from tfidf_tpu_torch.ops.ell import score_segments_batch
    from tfidf_tpu_torch.ops.topk import fetch_packed, packed_topk_chunked
    s = engine.searcher
    snap = engine.index.snapshot
    sync()
    t = [time.perf_counter()]
    qb, _ = s._vectorize(queries, ST_BATCH)
    sync()
    t.append(time.perf_counter())
    scores = score_segments_batch(snap.views, snap.df, qb, snap.n_docs,
                                  snap.avgdl, **engine.model.score_kwargs())
    sync()
    t.append(time.perf_counter())
    packed = packed_topk_chunked(scores, snap.num_docs, k=TOP_K)
    sync()
    t.append(time.perf_counter())
    fetch_packed(packed)
    t.append(time.perf_counter())
    return {n: (t[i + 1] - t[i]) * 1e3 for i, n in
            enumerate(("vectorize", "score", "topk", "fetch"))}


def serve_segments(engine, queries) -> tuple:
    """``search_batch`` and ``search_batch_arrays`` over ``queries``, each
    closed by a synchronize: (hits, arrays, q/s of each)."""
    sync()
    t0 = time.perf_counter()
    hits = engine.search_batch(queries, k=TOP_K)
    sync()
    t1 = time.perf_counter()
    arrays = engine.search_batch_arrays(queries, k=TOP_K)
    sync()
    t2 = time.perf_counter()
    if _arrays_live(arrays) != [[(h.name, np.float32(h.score).tobytes())
                                 for h in hs] for hs in hits]:
        raise SystemExit("streaming: search_batch_arrays differs from "
                         "search_batch")
    return hits, arrays, {"search_batch": len(queries) / (t1 - t0),
                          "search_batch_arrays": len(queries) / (t2 - t1)}


def quiesce(engine) -> float:
    """Drain the background merges and publish them, until the segment
    count is back under ``max_segments`` with no merge in flight; the
    seconds it took."""
    index = engine.index
    q0 = time.perf_counter()
    for _ in range(32):
        index.wait_for_merges()
        engine.commit()
        if len(index._segments) <= engine.config.max_segments \
                and index._merge_future is None:
            break
    sync()
    return time.perf_counter() - q0


def stream_phase(data, seed: int, *, commit_every: int = ST_COMMIT_EVERY,
                 vocab: int = NS_VOCAB, avg_len: int = NS_AVG_LEN,
                 device=None) -> tuple:
    """Phase 8a: config 4's streaming build of ``data["corpus"]`` (drawn
    over ``vocab`` terms, ``avg_len`` long on average) into a
    segments-mode engine on the card (``device`` only for the tests), a
    commit every ``commit_every`` docs, a quiesce, 1% deletes and 1%
    upserts, a quiesce, then ``ST_QUERIES`` queries held to a scipy
    oracle over the live docs. ``probe_msmarco_torch.py`` runs it at
    config 4's named size."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    corpus = data["corpus"]
    offsets, ids, tfs, lengths = corpus
    n_docs = offsets.shape[0] - 1
    queries = data["queries"][:ST_QUERIES]
    engine = Engine(Config(index_mode="segments", query_batch=ST_BATCH,
                           embedding_enabled=False), device=device)
    if engine.device.type != torch.device(device or "cuda").type:
        raise SystemExit(f"streaming: engine on {engine.device}")
    index = engine.index
    t0 = time.perf_counter()
    engine.vocab.extend(f"t{i}" for i in range(vocab))
    vocab_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    merges0 = {k: metric(f"merges_{k}") for k in ("inline", "background")}
    stream = torch.cuda.current_stream()
    add = index.add_document_arrays
    off = offsets.tolist()
    lens = lengths.tolist()
    commit_ms, inflight = [], []
    t0 = time.perf_counter()
    for i in range(n_docs):
        add(f"d{i}", ids[off[i]:off[i + 1]], tfs[off[i]:off[i + 1]],
            lens[i])
        if (i + 1) % commit_every == 0 or i + 1 == n_docs:
            inflight.append(index._merge_future is not None)
            c0 = time.perf_counter()
            engine.commit()
            stream.synchronize()      # the commit's own device work only
            commit_ms.append((time.perf_counter() - c0) * 1e3)
    stream_s = time.perf_counter() - t0
    # quiesce as bench.py does: drain the background merges (untimed in
    # the sustained rate — they ran off the write path)
    quiesce_s = quiesce(engine)
    segs_quiesced = len(index.snapshot.segments)
    # tombstone 1% of the docs and upsert another 1% with new content
    rng = np.random.default_rng(seed + 8)
    n_mut = int(n_docs * ST_MUTATE)
    picked = rng.choice(n_docs, size=2 * n_mut, replace=False)
    deleted, upserted = np.sort(picked[:n_mut]), np.sort(picked[n_mut:])
    fresh = make_doc_arrays(rng, n_mut, vocab, avg_len)
    m0 = time.perf_counter()
    for d in deleted.tolist():
        if not engine.delete(f"d{d}"):
            raise SystemExit(f"streaming: delete of d{d} found nothing")
    f_off = fresh[0].tolist()
    for j, d in enumerate(upserted.tolist()):
        add(f"d{d}", fresh[1][f_off[j]:f_off[j + 1]],
            fresh[2][f_off[j]:f_off[j + 1]], float(fresh[3][j]))
    c0 = time.perf_counter()
    engine.commit()
    stream.synchronize()
    mutate_commit_ms = (time.perf_counter() - c0) * 1e3
    mutate_s = time.perf_counter() - m0
    # publish the merges that commit started before serving: a splice
    # reclaims tombstones from df, N and avgdl, so queries served across
    # one would see two states, and phase 8b restores the spliced one
    mutate_quiesce_s = quiesce(engine)
    snap = index.snapshot
    mem = {"allocated_bytes": torch.cuda.memory_allocated(),
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    keep = np.setdiff1d(np.arange(n_docs), picked)
    live = _concat_corpora(_gather_docs(corpus, keep), fresh)
    live_names = ([f"d{j}" for j in keep.tolist()]
                  + [f"d{j}" for j in upserted.tolist()])
    if index.num_live_docs != n_docs - n_mut:
        raise SystemExit(f"streaming: {index.num_live_docs} live docs, "
                         f"expected {n_docs - n_mut}")
    # the incremental device stats against a recompute from the segments
    stats = _segment_stats(snap.segments, snap.df.shape[0])
    # df and N are integer counts, equal exactly; avgdl within f32
    # rounding (each segment's length sum is an f32 sum, as in the JAX
    # package)
    df_err = float(np.abs(snap.df_host - stats[0]).max())
    if df_err or snap.n_docs_f != stats[1] \
            or abs(snap.avgdl_f - stats[2]) > 1e-6 * stats[2]:
        raise SystemExit(f"streaming: the committed stats differ from a "
                         f"recompute over the segments: max |d df| "
                         f"{df_err}, N {snap.n_docs_f} vs {stats[1]}, "
                         f"avgdl {snap.avgdl_f} vs {stats[2]}")
    cm = np.asarray(commit_ms[1:])
    # the steady commits split by whether a background merge was in
    # flight when each began
    split = {}
    for key, sel in (("merge_inflight", True), ("alone", False)):
        part = cm[np.asarray(inflight[1:], bool) == sel]
        split[key] = ({"commits": int(part.shape[0]),
                       "p50": float(np.percentile(part, 50)),
                       "p99": float(np.percentile(part, 99)),
                       "max": float(part.max())} if part.shape[0]
                      else {"commits": 0})
    res = {"docs": n_docs, "commits": len(commit_ms),
           "commit_every": commit_every,
           "vocab_register_s": vocab_s, "stream_s": stream_s,
           "docs_per_s": n_docs / stream_s,
           "first_commit_ms": commit_ms[0],
           "commit_ms_p50": float(np.percentile(cm, 50)),
           "commit_ms_p99": float(np.percentile(cm, 99)),
           "commit_ms_max": float(cm.max()),
           "merge_inflight_share": float(np.mean(inflight)),
           "commit_ms_split": split,
           "merges": {k: metric(f"merges_{k}") - merges0[k]
                      for k in merges0},
           "quiesce_s": quiesce_s, "segments_quiesced": segs_quiesced,
           "segments": len(snap.segments),
           "deleted": n_mut, "upserted": n_mut,
           "mutate_s": mutate_s, "mutate_commit_ms": mutate_commit_ms,
           "mutate_quiesce_s": mutate_quiesce_s,
           "memory": mem, "df_full_recomputes": index.df_full_recomputes}
    log(f"[stream] {n_docs} docs in {stream_s:.1f}s = "
        f"{res['docs_per_s']:.0f} docs/s sustained, {len(commit_ms)} "
        f"commits: first {commit_ms[0]:.0f} ms, then p50 "
        f"{res['commit_ms_p50']:.1f} p99 {res['commit_ms_p99']:.1f} max "
        f"{res['commit_ms_max']:.1f} ms; merge in flight at "
        f"{res['merge_inflight_share']:.0%} of commits ({split}); merges "
        f"{res['merges']}; quiesce {quiesce_s:.1f}s -> {segs_quiesced} "
        f"segments; {n_mut} deletes + {n_mut} upserts committed in "
        f"{mutate_commit_ms:.0f} ms, quiesced in {mutate_quiesce_s:.1f}s "
        f"-> {len(snap.segments)} segments; "
        f"device memory {mem}")

    engine.search_batch(queries[:ST_BATCH], k=TOP_K)          # warm
    hits, arrays, qps = serve_segments(engine, queries)
    dead = {f"d{d}" for d in deleted.tolist()}
    if any(h.name in dead for hs in hits for h in hs):
        raise SystemExit("streaming: a deleted doc was returned")
    # the engine's row order over its live rows (gid order), for ties
    rows = [nm for seg in snap.segments
            for nm, a in zip(seg.names, seg.live) if a]
    t0 = time.perf_counter()
    oracle = oracle_check(live, queries, hits, vocab, rows,
                          stats=stats, names=live_names)
    oracle["seconds"] = time.perf_counter() - t0
    up = {f"d{d}" for d in upserted.tolist()}
    res.update(qps=qps, oracle=oracle,
               upserted_hits=sum(h.name in up for hs in hits for h in hs),
               breakdown_ms=streaming_breakdown(engine, queries[:ST_BATCH]),
               scorer=segment_scorer_times(engine, queries))
    log(f"[stream] served {len(queries)} queries: {qps} q/s; oracle over "
        f"the live docs OK: {oracle}; {res['upserted_hits']} hits on "
        f"upserted docs (scored by their new content); one {ST_BATCH}-query "
        f"batch, ms: {res['breakdown_ms']}")
    log(f"[stream] segment scorer (torch ops, no kernel), one "
        f"{res['scorer']['batch']}-query batch: {res['scorer']['ms']:.2f} "
        f"ms against a {res['scorer']['bound_ms']:.3f} ms bound "
        f"({res['scorer']['bound_by']}), x{res['scorer']['x_bound']:.0f}")
    check_clean(engine, "streaming engine")
    return res, {"engine": engine, "hits": hits, "arrays": arrays,
                 "deleted": deleted, "upserted": upserted, "fresh": fresh}


def tier_phase(ctx8, queries, work: str) -> dict:
    """Phase 8b: save the streaming engine (``segstate.npz``), restore it
    into a tiered engine (the default 512 MB hot budget, ring depth 2),
    serve the same queries tiered and through ``tier_bypass``: hits and
    values identical to the bit, and to 8a's; then one injected upload
    fault, which must surface, and a clean batch after it unchanged."""
    from tfidf_tpu_torch.engine.checkpoint import (load_checkpoint,
                                                   save_checkpoint)
    from tfidf_tpu_torch.utils.device_nemesis import (DeviceTransientError,
                                                      global_device_nemesis)
    engine, hits, arrays = ctx8.pop("engine"), ctx8["hits"], ctx8["arrays"]
    ckpt = os.path.join(work, "stream_ckpt")
    t0 = time.perf_counter()
    save_checkpoint(engine, ckpt)
    save_s = time.perf_counter() - t0
    nbytes = dir_bytes(os.path.realpath(ckpt))
    cfg = engine.config.replace(tier_enabled=True,
                                index_path=os.path.join(work, "tier"))
    seg_bytes = sum(s.device_bytes for s in engine.index._segments)
    budget_note = None
    if seg_bytes <= cfg.tier_hot_budget_mb << 20:
        # the default budget would hold every segment at this size: use
        # half the segments' device bytes, so the cold path runs
        cfg = cfg.replace(tier_hot_budget_mb=(seg_bytes // 2) >> 20)
        budget_note = (f"the default budget holds all {seg_bytes} B; "
                       f"{cfg.tier_hot_budget_mb} MB used")
    del engine
    torch.cuda.empty_cache()
    sync()
    t0 = time.perf_counter()
    tiered = load_checkpoint(ckpt, cfg)
    sync()
    load_s = time.perf_counter() - t0
    tier = tiered.tier
    st0 = dict(tiered.tier_stats(), segment_bytes=seg_bytes)
    if st0["cold_segments"] == 0 or not tiered.index.snapshot.cold:
        raise SystemExit(f"tier: no segment is cold after the restore: "
                         f"{st0}")
    log(f"[tier] save {save_s:.2f}s ({nbytes} bytes, segstate.npz), "
        f"restore into the tiered engine {load_s:.2f}s: {st0}"
        + (f"; {budget_note}" if budget_note else ""))
    # no warm-up batch: the first one faults the cold segments in through
    # the ring (a fault-in the budget can hold keeps its segment hot)
    before = dict(tiered.tier_stats(), considered=tier.considered)
    t_hits, t_arrays, t_qps = serve_segments(tiered, queries)
    after = dict(tiered.tier_stats(), considered=tier.considered)
    tiered.searcher.tier_bypass = True
    b_hits, b_arrays, b_qps = serve_segments(tiered, queries)
    tiered.searcher.tier_bypass = False
    for what, got, got_a in (("tiered", t_hits, t_arrays),
                             ("bypass", b_hits, b_arrays)):
        if _hits_key(got) != _hits_key(hits):
            raise SystemExit(f"tier: {what} hits differ from the streaming "
                             "engine's")
        if _arrays_live(got_a) != _arrays_live(arrays) \
                or got_a[0].tobytes() != arrays[0].tobytes():
            raise SystemExit(f"tier: {what} arrays differ from the "
                             "streaming engine's")
    delta = {k: after[k] - before[k] for k in
             ("cold_faults", "segments_skipped", "hot_hits", "considered",
              "ring_stall_s")}
    if not delta["considered"] or not (delta["cold_faults"]
                                       + delta["segments_skipped"]):
        raise SystemExit(f"tier: the tiered run walked no cold segment: "
                         f"{delta}")
    log(f"[tier] tiered {t_qps} q/s, bypass {b_qps} q/s, hits and values "
        f"identical to the bit to each other and to the streaming "
        f"engine's; tiered run: {delta}; {after}")
    check_clean(tiered, "tiered engine")
    # one injected fault on the upload ring: empty the resident set, so
    # the next batch must fault a cold segment in
    budget = tier.budget_bytes
    tier.set_budget(0)
    tier.set_budget(budget)
    cold0 = tiered.tier_stats()["cold_faults"]
    global_device_nemesis.script("upload:transient:1.0:count=1")
    try:
        tiered.search_batch(queries[:ST_BATCH], k=TOP_K)
        raise SystemExit("tier: the armed upload fault did not surface")
    except DeviceTransientError as e:
        fault = repr(e)
    finally:
        fired = global_device_nemesis.snapshot()["rules"][0]["fired"]
        global_device_nemesis.clear()
    if fired != 1 or tiered.pop_fallback_served():
        raise SystemExit(f"tier: upload rule fired {fired} times")
    clean = tiered.search_batch(queries[:ST_BATCH], k=TOP_K)
    if _hits_key(clean) != _hits_key(hits[:ST_BATCH]):
        raise SystemExit("tier: the clean batch after the upload fault "
                         "differs")
    health = tiered.compute_stats()
    log(f"[tier] upload:transient surfaced as {fault} (no fallback for a "
        f"segmented snapshot, as in the JAX package); the next clean "
        f"batch unchanged; cold faults {cold0} -> "
        f"{tiered.tier_stats()['cold_faults']}; health {health['state']}")
    check_clean(tiered, "tiered engine after the upload fault", faults=1)
    tier.close()
    del tiered
    torch.cuda.empty_cache()
    return {"save_s": save_s, "bytes": nbytes, "load_s": load_s,
            "after_restore": st0, "budget_note": budget_note,
            "qps_tiered": t_qps, "qps_bypass": b_qps, "tiered_run": delta,
            "tier_stats": after, "upload_fault": fault}


def first_docs(corpus, n: int):
    """The corpus's first ``n`` docs (views, no copy)."""
    offsets, ids, tfs, lengths = corpus
    n = min(n, offsets.shape[0] - 1)
    end = int(offsets[n])
    return offsets[:n + 1], ids[:end], tfs[:end], lengths[:n]


def streaming_phases(data, seed: int, work: str) -> dict:
    """Phase 8: 8a streaming (the first ``ST_DOCS`` docs of the corpus),
    8b tiering; the phase's seconds."""
    t0 = time.perf_counter()
    res, ctx8 = stream_phase({"corpus": first_docs(data["corpus"], ST_DOCS),
                              "queries": data["queries"]}, seed)
    res["tier"] = tier_phase(ctx8, data["queries"][:ST_QUERIES], work)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[stream] phase 8 took {res['seconds']:.1f}s")
    return res


# --------------------------------------------------------------------------
# phase 9: the mesh — the ELL kernel at its second call site
# --------------------------------------------------------------------------

MESH_SHAPE = (2, 2)            # docs x terms ranks, all four on the one card
MESH_QUERIES = 1024            # phase 3's served queries through the mesh
MESH_WARM_APPEND = 0.001       # share of docs in the first append commit
MESH_MUTATE = 0.01             # share appended, deleted and upserted after
C2_DOCS = 100_000              # BASELINE config 2: "100k-doc subset,
C2_VOCAB = 200_000             # 200k vocab, 2 workers"
GROUP_DOCS = 20_000            # phase 9d's small corpus


def card_mesh(shape, dev: str = "cuda:0"):
    """A mesh of ``shape`` ranks, every one on ``dev``."""
    from tfidf_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))


def bulk_mesh_engine(mesh, corpus, vocab: int, **cfg):
    """A mesh engine on ``mesh`` bulk-loaded with ``corpus`` (docs
    ``d<i>``, vocabulary ``t<i>`` registered first) and committed.
    Returns (engine, bulk-load s, commit s)."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    engine = Engine(Config(engine_mode="mesh", query_batch=NS_BATCH, **cfg),
                    mesh=mesh)
    if engine.device.type != "cuda" or engine.dense is not None:
        raise SystemExit(f"mesh: engine on {engine.device}, dense "
                         f"{engine.dense}")
    offsets, ids, tfs, lengths = corpus
    engine.vocab.extend(f"t{i}" for i in range(vocab))
    t0 = time.perf_counter()
    engine.index.bulk_load_packed([f"d{i}" for i in range(
        offsets.shape[0] - 1)], offsets, ids, tfs, lengths)
    load_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    engine.commit()
    sync()
    return engine, load_s, time.perf_counter() - t0


def gid_order(snap) -> list:
    """The live docs' names in global-id order (the mesh's tie order:
    equal scores rank by lower global id)."""
    out = []
    for s, sd in enumerate(snap.shard_docs):
        base = [sd[int(i)] for i in snap.perms[s]]
        out += [e.name for e in base + sd[snap.base_counts[s]:] if e.live]
    return out


def hold_same(got_hits, want_hits, what: str) -> int:
    """Hits of one engine against another's on the same queries: scores
    within relative 1e-6 rank by rank, names identical except inside a
    near-tie group (the other engine scores the name within relative 1e-6
    of that rank's score). Returns the swaps."""
    swaps = 0
    for i, (got, want) in enumerate(zip(got_hits, want_hits)):
        if len(got) != len(want):
            raise SystemExit(f"{what}: query {i} has {len(got)} hits, "
                             f"{len(want)} expected")
        ws = {h.name: h.score for h in want}
        for g, w in zip(got, want):
            if abs(g.score - w.score) > 1e-6 * abs(w.score):
                raise SystemExit(f"{what}: query {i}: {g} vs {w}")
            if g.name != w.name:
                other = ws.get(g.name, want[-1].score)
                if abs(other - w.score) > 1e-6 * abs(w.score):
                    raise SystemExit(f"{what}: query {i}: {g} where "
                                     f"{w} is expected")
                swaps += 1
    return swaps


def mesh_blocks(snap, B: int, u_cap: int) -> list:
    """(imp_t, term_t, live rows, bucket) of every rank's non-empty block
    inside the kernel envelope — what the mesh path launches per batch."""
    from tfidf_tpu_torch.ops.ell import _pallas_eligible
    base, T = snap.base, len(snap.base.impact) // len(snap.shard_docs)
    out = []
    for r, (imps, terms) in enumerate(zip(base.impact, base.term)):
        for b, (it, tt) in enumerate(zip(imps, terms)):
            live = int(base.block_live[r // T, b])
            if live and _pallas_eligible(it.shape[1], B, u_cap):
                out.append((it, tt, live, b))
    return out


def mesh_kernel_times(engine, qb) -> dict:
    """The mesh path's kernel blocks (every rank's ``[W/2, rows_cap]``
    slices) on one batch: each through v4 and v3 against its plain
    version, bitwise; then per bucket width and in all, the v4 kernel,
    the plain version and ``torch.sparse.mm`` of the same blocks, beside
    the bound (each block's live postings read and scores written once,
    one multiply and one add per hit and query with a non-zero weight;
    ``slot_of`` and ``qc_t`` once per batch)."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    snap = engine.index.snapshot
    slot_of, qc_ext = _compile_queries(qb, snap.df_g.shape[0])
    qc_t = qc_ext.T.contiguous()
    u1, B = qc_t.shape
    blocks = mesh_blocks(snap, B, u1 - 1)
    worst = 0.0
    for it, tt, n, _b in blocks:
        plain = E.score_block_plain(it, tt, slot_of, qc_t, n)
        for a in E.A_BUILD_VARIANTS:
            out = E.score_block_kernel(it, tt, slot_of, qc_t, n, a_build=a,
                                       out=torch.zeros_like(plain))
            sync()
            if not torch.equal(out, plain):
                raise SystemExit(f"mesh block {tuple(it.shape)} {a}: kernel "
                                 f"!= plain (max|d| "
                                 f"{float((out - plain).abs().max())})")
        del plain, out
    qnnz = (qc_t != 0).sum(1)
    once = 4 * slot_of.numel() + 4 * u1 * B
    out = torch.empty((B, snap.base.doc_cap), device="cuda")
    res = {"blocks": len(blocks), "u_cap": u1 - 1, "max_abs_err": worst,
           "by_width": {}}
    groups = {}
    for blk in blocks:
        groups.setdefault(int(blk[0].shape[0]), []).append(blk)
    groups["all"] = blocks
    for key, grp in groups.items():
        nbytes = once if key == "all" else 0
        ops = 0
        for it, tt, n, _b in grp:
            bb, oo, _dense = block_work(it, tt, slot_of, qnnz, B, n)
            nbytes += bb
            ops += oo
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / F32_UNFUSED_OPS_PER_S * 1e3
        mats = [library_operand(it, tt, slot_of, u1, n)
                for it, tt, n, _b in grp]
        row = {"blocks": len(grp),
               "rows": sorted({int(it.shape[1]) for it, *_ in grp}),
               "v4_ms": cuda_ms(lambda: [E.score_block_kernel(
                   it, tt, slot_of, qc_t, n, a_build="v4", out=out)
                   for it, tt, n, _b in grp], reps=5),
               # the plain version takes seconds: one run a width after
               # its warm-up, and in all the widths' sum
               "plain_ms": (sum(r["plain_ms"] for r in
                                res["by_width"].values()) if key == "all"
                            else cuda_ms(lambda: [E.score_block_plain(
                                it, tt, slot_of, qc_t, n)
                                for it, tt, n, _b in grp], reps=1)),
               "library_ms": cuda_ms(lambda: [torch.sparse.mm(A, qc_t)
                                              for A in mats], reps=5),
               "bytes": nbytes, "ops": ops,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        del mats
        if key == "all":
            row["v3_ms"] = cuda_ms(lambda: [E.score_block_kernel(
                it, tt, slot_of, qc_t, n, a_build="v3", out=out)
                for it, tt, n, _b in grp], reps=5)
            res.update(row)
        else:
            res["by_width"][key] = row
    del out
    return res


def mesh_breakdown(engine, queries) -> dict:
    """Per-stage ms of one batch through the mesh-ELL step, each stage
    closed by a synchronize: vectorize (host), compile, the ELL blocks,
    the residual and the delta (``coo``), the terms psum, the per-row
    top-k, the docs all_gather, the merge, the fetch."""
    import contextlib
    from tfidf_tpu_torch.ops.topk import fetch_packed
    s = engine.searcher
    snap = engine.index.snapshot
    ms = {}

    @contextlib.contextmanager
    def stage(name):
        sync()
        t0 = time.perf_counter()
        yield
        sync()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    with stage("vectorize"):
        qb, _ = s._vectorize(queries, NS_BATCH)
    packed = s._get_search_fn(TOP_K)(snap.base, snap.delta, snap.df_g,
                                     snap.n_docs, snap.avgdl, qb,
                                     stage=stage)
    with stage("fetch"):
        fetch_packed(packed)
    ms["total"] = sum(ms.values())
    return ms, qb


def serve_mesh(engine, queries) -> tuple:
    """``search_batch`` over ``queries`` (batches of NS_BATCH) with the
    launch counts reset just before and read just after: (hits, q/s,
    launches)."""
    from tfidf_tpu_torch.ops import ell as E
    E.reset_launches()
    sync()
    t0 = time.perf_counter()
    hits = engine.search_batch(queries, k=TOP_K)
    sync()
    secs = time.perf_counter() - t0
    return hits, len(queries) / secs, dict(E.launches)


def expected_mesh_launches(snap, n_queries: int) -> int:
    """Eligible non-empty blocks x ranks x chunks (u_cap is a power of
    two >= 256 for every batch, so it never decides eligibility)."""
    return len(mesh_blocks(snap, NS_BATCH, 256)) * (-(-n_queries
                                                       // NS_BATCH))


def mesh_ell_phase(data, seed: int) -> dict:
    """Phase 9a: the mesh-ELL engine at the north star on four ranks of
    the one card: bulk load, commit, serve phase 3's queries, hold them to
    the scipy oracle and to phase 3's local engine; then an append burst,
    1% appends + 1% deletes + 1% upserts into the delta, serve again and
    hold the live docs to the oracle."""
    from tfidf_tpu_torch.parallel import mesh_ell as ME
    from tfidf_tpu_torch.parallel import mesh_ell_index as MI
    corpus = data["corpus"]
    n_docs = corpus[0].shape[0] - 1
    queries = data["queries"][:MESH_QUERIES]
    timing = {"build_s": 0.0, "place_s": 0.0}
    real_build, real_place = MI.build_mesh_ell, ME.place_mesh_ell

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            sync()
            timing[key] += time.perf_counter() - t0
            return out
        return run

    MI.build_mesh_ell = timed(real_build, "build_s")
    ME.place_mesh_ell = timed(real_place, "place_s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        engine, load_s, commit_s = bulk_mesh_engine(
            card_mesh(MESH_SHAPE), corpus, NS_VOCAB)
    finally:
        MI.build_mesh_ell, ME.place_mesh_ell = real_build, real_place
    index = engine.index
    if not isinstance(index, MI.MeshEllIndex):
        raise SystemExit(f"mesh: {type(index).__name__}, not MeshEllIndex")
    snap = index.snapshot
    host_build_s = timing["build_s"] - timing["place_s"]
    res = {"shape": list(MESH_SHAPE), "docs": n_docs,
           "bulk_load_s": load_s, "commit_s": commit_s,
           "host_build_s": host_build_s, "place_s": timing["place_s"],
           "device_bytes": metric("mesh_ell_device_bytes"),
           "block_live": snap.base.block_live.tolist(),
           "rows_cap": [int(x.shape[1]) for x in snap.base.impact[0]],
           "widths_per_rank": [int(x.shape[0])
                               for x in snap.base.impact[0]],
           "refresh_ms": cuda_ms(lambda: index._refresh_fn(
               snap.base, snap.df_g, snap.n_docs, snap.avgdl), reps=3)}
    log(f"[mesh] {n_docs} docs on a {MESH_SHAPE} mesh of one card: bulk "
        f"load {load_s:.1f}s, commit {commit_s:.1f}s (host build "
        f"{host_build_s:.1f}s, upload {timing['place_s']:.1f}s), impact "
        f"refresh {res['refresh_ms']:.1f} ms, base {res['device_bytes']:.0f}"
        f" bytes, rank widths {res['widths_per_rank']} rows "
        f"{res['rows_cap']}")

    engine.search_batch(queries[:NS_BATCH], k=TOP_K)        # warm
    hits, qps, launches = serve_mesh(engine, queries)
    want = expected_mesh_launches(snap, len(queries))
    if launches["v4"] != want or launches["v3"] != 0 or want == 0:
        raise SystemExit(f"mesh launches {launches}, expected v4={want}")
    res.update(qps=qps, launches=launches, expected_launches=want,
               memory={"allocated_bytes": torch.cuda.memory_allocated(),
                       "peak_allocated_bytes":
                       torch.cuda.max_memory_allocated()})
    log(f"[mesh] served {len(queries)} queries: {qps:.1f} q/s, launches "
        f"{launches} (= eligible blocks x ranks x chunks), memory "
        f"{res['memory']}")
    t0 = time.perf_counter()
    res["oracle"] = oracle_check(corpus, queries[:256], hits[:256],
                                 NS_VOCAB, gid_order(snap))
    res["oracle"]["seconds"] = time.perf_counter() - t0
    res["local_swaps"] = hold_same(hits, data["hits"][:len(queries)],
                                   "mesh vs local engine")
    log(f"[mesh] oracle top-{TOP_K} OK: {res['oracle']}; the local "
        f"engine's hits on {len(queries)} queries held (rel 1e-6), "
        f"{res['local_swaps']} near-tie swaps")
    res["breakdown_ms"], qb = mesh_breakdown(engine, queries[-NS_BATCH:])
    log(f"[mesh] one {NS_BATCH}-query batch, ms: {res['breakdown_ms']}")
    res["kernel"] = mesh_kernel_times(engine, qb)
    log(f"[mesh] kernel blocks: {res['kernel']}")

    # the append burst, then 1% appends + 1% deletes + 1% upserts
    rng = np.random.default_rng(seed + 9)
    n_warm, n_mut = int(n_docs * MESH_WARM_APPEND), int(n_docs * MESH_MUTATE)
    warm = make_doc_arrays(rng, n_warm, NS_VOCAB, NS_AVG_LEN)
    new = make_doc_arrays(rng, n_mut, NS_VOCAB, NS_AVG_LEN)
    up = make_doc_arrays(rng, n_mut, NS_VOCAB, NS_AVG_LEN)
    picked = rng.choice(n_docs, size=2 * n_mut, replace=False)
    deleted, upserted = np.sort(picked[:n_mut]), np.sort(picked[n_mut:])

    def add(arrays, names):
        off = arrays[0].tolist()
        for j, name in enumerate(names):
            index.add_document_arrays(name, arrays[1][off[j]:off[j + 1]],
                                      arrays[2][off[j]:off[j + 1]],
                                      float(arrays[3][j]))

    def commit() -> float:
        sync()
        t0 = time.perf_counter()
        engine.commit()
        sync()
        return (time.perf_counter() - t0) * 1e3

    r0, a0 = index.rebuilds, index.appends
    add(warm, [f"w{j}" for j in range(n_warm)])
    res["burst"] = {"docs": n_warm, "commit_ms": commit(),
                    "folded": index.rebuilds > r0,
                    "appended": index.appends > a0}
    r1, a1 = index.rebuilds, index.appends
    add(new, [f"n{j}" for j in range(n_mut)])
    for d in deleted.tolist():
        if not engine.delete(f"d{d}"):
            raise SystemExit(f"mesh: delete of d{d} found nothing")
    add(up, [f"d{d}" for d in upserted.tolist()])
    res["mutation"] = {"appended": n_mut, "deleted": n_mut,
                       "upserted": n_mut, "commit_ms": commit()}
    snap = index.snapshot
    in_delta = int(snap.delta.n_live.sum())
    if index.rebuilds != r1 or index.appends <= a1 or in_delta < 2 * n_mut:
        raise SystemExit(f"mesh: the mutation commit did not land in the "
                         f"delta (rebuilds {r1}->{index.rebuilds}, appends "
                         f"{a1}->{index.appends}, delta {in_delta} docs)")
    res["mutation"]["delta_docs"] = in_delta
    log(f"[mesh] append burst of {n_warm} docs committed in "
        f"{res['burst']['commit_ms']:.0f} ms (folded into the base: "
        f"{res['burst']['folded']}); {n_mut} appends + {n_mut} deletes + "
        f"{n_mut} upserts committed in {res['mutation']['commit_ms']:.0f} "
        f"ms, {in_delta} docs in the delta")
    # the first batch after the commit pays the delta's segment plans and
    # the wider score tensors' first allocation: timed on its own
    sync()
    t0 = time.perf_counter()
    engine.search_batch(queries[:NS_BATCH], k=TOP_K)
    sync()
    res["mutation"]["first_batch_ms"] = (time.perf_counter() - t0) * 1e3
    hits2, qps2, launches2 = serve_mesh(engine, queries)
    want2 = expected_mesh_launches(snap, len(queries))
    if launches2["v4"] != want2 or want2 == 0:
        raise SystemExit(f"mesh launches after the mutation {launches2}, "
                         f"expected v4={want2}")
    keep = np.setdiff1d(np.arange(n_docs), picked)
    live = _concat_corpora(_concat_corpora(_concat_corpora(
        _gather_docs(corpus, keep), warm), new), up)
    live_names = ([f"d{j}" for j in keep.tolist()]
                  + [f"w{j}" for j in range(n_warm)]
                  + [f"n{j}" for j in range(n_mut)]
                  + [f"d{d}" for d in upserted.tolist()])
    dead = {f"d{d}" for d in deleted.tolist()}
    if any(h.name in dead for hs in hits2 for h in hs):
        raise SystemExit("mesh: a deleted doc was returned")
    t0 = time.perf_counter()
    res["oracle_after"] = oracle_check(live, queries[:256], hits2[:256],
                                       NS_VOCAB, gid_order(snap),
                                       names=live_names)
    res["oracle_after"]["seconds"] = time.perf_counter() - t0
    fresh = {f"n{j}" for j in range(n_mut)} | {f"d{d}" for d in
                                                upserted.tolist()}
    res.update(qps_after=qps2, launches_after=launches2,
               expected_launches_after=want2,
               delta_hits=sum(h.name in fresh for hs in hits2 for h in hs))
    res["breakdown_ms_after"], _ = mesh_breakdown(engine,
                                                  queries[-NS_BATCH:])
    log(f"[mesh] after the mutation: first batch "
        f"{res['mutation']['first_batch_ms']:.0f} ms, then {qps2:.1f} q/s, "
        f"launches {launches2}; one batch, ms: {res['breakdown_ms_after']}")
    log(f"[mesh] after the mutation: {qps2:.1f} q/s, launches {launches2}; "
        f"oracle over the live docs OK: {res['oracle_after']}; "
        f"{res['delta_hits']} hits on delta docs")
    check_clean(engine, "mesh-ELL engine")
    return res


def lucene_norm_length(dl: np.ndarray) -> np.ndarray:
    """Lucene's 1-byte length norm round-trip (``SmallFloat.intToByte4``
    then ``byte4ToInt``): lengths below 24 stay exact; above, ``24 + v``
    keeps the 4 leading bits of ``v``."""
    v = np.maximum(dl.astype(np.int64) - 24, 0)
    shift = np.maximum(np.floor(np.log2(np.maximum(v, 1))).astype(
        np.int64) - 3, 0)
    return np.where(dl < 24, dl, 24 + ((v >> shift) << shift)).astype(
        np.float64)


def mesh_parity_phase(seed: int) -> dict:
    """Phase 9b: BASELINE config 2's shape (100k docs, 200k vocab, 2
    workers) as a ``lucene_parity`` mesh-COO engine on two ranks of the
    card: each docs row scores against its own statistics, as each Java
    worker does; held to a scipy oracle with per-row statistics and
    Lucene's length norm."""
    rng = np.random.default_rng(seed + 10)
    corpus = make_doc_arrays(rng, C2_DOCS, C2_VOCAB, NS_AVG_LEN)
    queries = make_queries(rng, C2_VOCAB, 2 * NS_BATCH)
    torch.cuda.reset_peak_memory_stats()
    engine, load_s, commit_s = bulk_mesh_engine(
        card_mesh((2, 1)), corpus, C2_VOCAB, lucene_parity=True)
    if type(engine.index).__name__ != "MeshIndex" \
            or engine.searcher.global_idf:
        raise SystemExit("mesh parity: not the per-row-statistics COO mesh")
    engine.search_batch(queries[:NS_BATCH], k=TOP_K)         # warm
    hits, qps, _launches = serve_mesh(engine, queries)
    # the oracle: doc i on row i % 2, each row's df, N and RAW avgdl, the
    # quantized length in the norm
    offsets, ids, tfs, lengths = corpus
    row = np.repeat(np.arange(C2_DOCS), np.diff(offsets))
    shard = row % 2
    k1, b = 1.2, 0.75
    imp = np.zeros(ids.shape[0])
    for s in range(2):
        m = shard == s
        mine = np.arange(s, C2_DOCS, 2)
        df = np.bincount(ids[m], minlength=C2_VOCAB).astype(np.float64)
        n = mine.shape[0]
        avgdl = lengths[mine].astype(np.float64).mean()
        idf = np.log1p((n - df + 0.5) / (df + 0.5))
        qdl = lucene_norm_length(lengths[row[m]])
        imp[m] = idf[ids[m]] * tfs[m] / (tfs[m] + k1 * (1 - b + b * qdl
                                                         / avgdl))
    gid_names = [f"d{i}" for s in range(2) for i in range(s, C2_DOCS, 2)]
    t0 = time.perf_counter()
    oracle = oracle_check(corpus, queries[:256], hits[:256], C2_VOCAB,
                          gid_names, impacts=imp)
    oracle["seconds"] = time.perf_counter() - t0
    res = {"shape": [2, 1], "docs": C2_DOCS, "vocab": C2_VOCAB,
           "bulk_load_s": load_s, "commit_s": commit_s, "qps": qps,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
           "oracle": oracle}
    log(f"[mesh] config 2 parity mesh (2 rows, per-row statistics): "
        f"{C2_DOCS} docs, commit {commit_s:.1f}s, {qps:.1f} q/s; oracle "
        f"with per-row statistics OK: {oracle}")
    check_clean(engine, "mesh parity engine")
    return res


def mesh_dense_phase(data) -> dict:
    """Phase 9c: phase 3d's 1M-doc embedding column on two docs rows of
    the card through ``shard_dense_column`` / ``make_mesh_dense_search``,
    512 of phase 3's queries held to the f64 brute force (phase 3d's
    rule; ties toward the lower doc)."""
    from types import SimpleNamespace

    from tfidf_tpu_torch.engine.dense import _pad_dim
    from tfidf_tpu_torch.engine.embedder import get_embedder
    from tfidf_tpu_torch.ops.analyzer import Analyzer
    from tfidf_tpu_torch.ops.topk import unpack_topk
    from tfidf_tpu_torch.parallel.mesh_dense import (make_mesh_dense_search,
                                                     shard_dense_column)
    from tfidf_tpu_torch.utils.config import Config
    c = Config()
    rows = data["rows"]
    n = rows.shape[0]
    embedder = get_embedder(c.embedding_model, c.embedding_dim)
    analyzer = Analyzer(lowercase=c.lowercase,
                        stopwords=frozenset(c.stopwords),
                        max_token_length=c.max_token_length)
    mesh = card_mesh((2, 1))
    dim_pad = _pad_dim(embedder.dim)
    t0 = time.perf_counter()
    column = shard_dense_column(mesh, [rows[:n // 2], rows[n // 2:]],
                                dim_pad)
    sync()
    place_s = time.perf_counter() - t0
    queries = data["queries"][:NS_BATCH]
    q = np.zeros((NS_BATCH, dim_pad), np.float32)
    for i, text in enumerate(queries):
        q[i, :embedder.dim] = embedder.embed_query(analyzer.counts(text))
    q = torch.from_numpy(q).cuda()
    search = make_mesh_dense_search(mesh, k=TOP_K)
    search(q, *column)                                    # warm
    sync()
    t0 = time.perf_counter()
    packed = search(q, *column)
    sync()
    batch_ms = (time.perf_counter() - t0) * 1e3
    vals, ids = unpack_topk(packed)
    names = [f"d{i}" for i in range(n)]
    hits = [[(names[int(d)], float(v)) for v, d in zip(vals[i], ids[i])]
            for i in range(NS_BATCH)]
    oracle = dense_oracle(SimpleNamespace(analyzer=analyzer), queries[:256],
                          hits[:256], rows, names,
                          tie=np.arange(n, dtype=np.int64),
                          embedder=embedder)
    res = {"rows": n, "place_s": place_s, "batch_ms": batch_ms,
           "qps": NS_BATCH / batch_ms * 1e3, "oracle": oracle}
    log(f"[mesh] dense column on 2 rows: {NS_BATCH}-query batch "
        f"{batch_ms:.2f} ms ({res['qps']:.1f} q/s); f64 oracle OK: "
        f"{oracle}")
    return res


def mesh_group_phase(seed: int) -> dict:
    """Phase 9d: a one-process NCCL group (world size 1) on the card: a
    mesh-ELL engine whose docs collectives go through NCCL answers a
    small corpus exactly as the in-process engine does."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.parallel import mesh as M
    from tfidf_tpu_torch.parallel.collectives import ProcessGroup
    rng = np.random.default_rng(seed + 11)
    corpus = make_doc_arrays(rng, GROUP_DOCS, 50_000, NS_AVG_LEN)
    queries = make_queries(rng, 50_000, NS_BATCH)
    cfg = dict(min_doc_capacity=256)
    inproc, _, _ = bulk_mesh_engine(card_mesh(MESH_SHAPE), corpus, 50_000,
                                    **cfg)
    want = inproc.search_batch(queries, k=TOP_K)
    port = free_ports(1)[0]
    t0 = time.perf_counter()
    M.initialize_multihost(f"127.0.0.1:{port}", 1, 0,
                           local_devices=["cuda:0"] * 4)
    init_s = time.perf_counter() - t0
    try:
        mesh = M.make_mesh(MESH_SHAPE)
        if not isinstance(mesh.comm, ProcessGroup):
            raise SystemExit("mesh group: the mesh is not on the group")
        engine, _, _ = bulk_mesh_engine(mesh, corpus, 50_000, **cfg)
        E.reset_launches()
        got = engine.search_batch(queries, k=TOP_K)
        launches = dict(E.launches)
    finally:
        M.shutdown_multihost()
    if got != want:
        raise SystemExit("mesh group: the NCCL mesh's hits differ from the "
                         "in-process mesh's")
    if launches["v4"] == 0:
        raise SystemExit("mesh group: no kernel launch")
    res = {"docs": GROUP_DOCS, "init_s": init_s, "launches": launches,
           "hits_identical": True}
    log(f"[mesh] NCCL group of one process (4 ranks): init {init_s:.2f}s, "
        f"hits identical to the in-process mesh on {len(queries)} queries,"
        f" launches {launches}")
    return res


def mesh_phases(data, seed: int) -> dict:
    """Phase 9: 9a the mesh-ELL north star, 9b config 2's parity mesh,
    9c the mesh dense column, 9d a one-process NCCL group."""
    t0 = time.perf_counter()
    res = {"ell": mesh_ell_phase(data, seed)}
    torch.cuda.empty_cache()
    res["parity"] = mesh_parity_phase(seed)
    torch.cuda.empty_cache()
    res["dense"] = mesh_dense_phase(data)
    torch.cuda.empty_cache()
    res["group"] = mesh_group_phase(seed)
    torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    log(f"[mesh] phase 9 took {res['seconds']:.1f}s")
    return res


# --------------------------------------------------------------------------
# phase 7: the fleet — the port's CLI, one process per node, on the card
# --------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
SMI = "nvidia-smi"
FLEET_DEVICE = "cuda"      # every serve process's --device
FLEET_CLIENTS = 64         # concurrent client threads, one query a POST
# the windows and the uploads were 4,096 / 2,048 queries and 2,000 docs
# until the mesh phase joined the run, then 2,048 / 1,024 and 1,000 until
# the bench phase did, then 1,024 / 512 and 500 until the run neared the
# time limit on a slower host: cut each time to keep every phase inside
# the run's time limit (reading uploads back runs at ~10-15 q/s)
FLEET_SPARSE = 512         # sparse queries through the leader
FLEET_STAGED = 256         # dense, hybrid (rrf), router queries, and the
                           # replies of each mode held to the oracles
FLEET_UPLOADS = 100        # new documents through /leader/upload-batch
FLEET_UPLOAD_CHUNK = 500   # documents per upload-batch request (the CLI's)
FLEET_BOOT_S = 300.0       # deadline for the fleet to serve the corpus
# the deployment: the default Config with the reference's single-copy
# placement (each document on one worker), and coordination sessions of
# 30 s, not 3 s. The placement map of 1M names is one znode (~39 MB, ~78 MB
# as hex in JSON) that the leader rewrites after each change and every
# follower (the router, each worker) reads whole, on its data watch and on
# a 1 s backstop. At the 3 s default a coordinator serving that traffic at
# the north star stalls past the timeout and every node's session expires
# (ROADMAP queue C).
# Phase 13's knobs are the compute chaos job's: they act only once a fault
# is injected, and with no result cache every chaos verdict comes from a
# live scatter (a nemesis does not change the generation a cache keys on).
FLEET_ENV = {"TFIDF_REPLICATION_FACTOR": "1",
             "TFIDF_SESSION_TIMEOUT_S": "30",
             "TFIDF_RESULT_CACHE_ENTRIES": "0",
             "TFIDF_ROUTER_CACHE_ENTRIES": "0",
             "TFIDF_DEVICE_NEMESIS_API": "1",
             "TFIDF_COMPUTE_SICK_AFTER": "3",
             "TFIDF_COMPUTE_PROBE_INTERVAL_S": "0.5",
             "TFIDF_POISON_QUARANTINE_AFTER": "2",
             "TFIDF_OOM_BACKOFF_MIN_BATCH": "8"}
# per-window means of these timings (ms) are read from /api/metrics
FLEET_TIMINGS = {"leader": ("leader_search", "scatter_linger",
                            "scatter_batch_total", "scatter_rpc",
                            "scatter_decode", "scatter_merge"),
                 "router": ("leader_search", "router_scatter_linger",
                            "router_scatter_batch_total", "scatter_rpc",
                            "scatter_merge"),
                 "worker": ("worker_batch_search", "worker_batch_pack")}


def fleet_shards(data, work: str) -> list:
    """Split the phase-3 corpus into two disjoint halves; bulk-load each
    into a fresh engine on the card (the dense column from phase 3's rows
    through its bulk path), commit it and save it as that worker's
    checkpoint, then free the card."""
    from tfidf_tpu_torch.engine.checkpoint import save_checkpoint
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    offsets, ids, tfs, lengths = data["corpus"]
    n = offsets.shape[0] - 1
    bounds = (0, n // 2, n)
    shards = []
    for i in range(2):
        lo, hi = bounds[i], bounds[i + 1]
        a, b = offsets[lo], offsets[hi]
        names = [f"d{j}" for j in range(lo, hi)]
        root = os.path.join(work, "fleet", f"worker{i}")
        ckpt = os.path.join(root, "index", "checkpoint")
        t0 = time.perf_counter()
        e = Engine(Config(), device=FLEET_DEVICE)
        e.vocab.extend(f"t{t}" for t in range(NS_VOCAB))
        e.index.bulk_load_packed(names, offsets[lo:hi + 1] - a, ids[a:b],
                                 tfs[a:b], lengths[lo:hi])
        e.dense.install_arrays(data["rows"][lo:hi], names)
        e.dense.commit()
        e.commit()
        sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_checkpoint(e, ckpt)
        save_s = time.perf_counter() - t0
        if e.index.num_live_docs != hi - lo:
            raise SystemExit(f"fleet: shard {i} holds "
                             f"{e.index.num_live_docs} docs")
        del e
        torch.cuda.empty_cache()
        shards.append({"lo": lo, "hi": hi, "root": root,
                       "build_s": build_s, "save_s": save_s,
                       "bytes": dir_bytes(os.path.realpath(ckpt))})
        log(f"[fleet] shard {i}: d{lo}..d{hi - 1} bulk-loaded and "
            f"committed in {build_s:.2f}s, checkpoint saved in "
            f"{save_s:.2f}s ({shards[-1]['bytes']} bytes)")
    return shards


def http_json(url: str, body=None, timeout: float = 120.0):
    """GET (``body`` None) or POST JSON; returns (decoded reply, headers).
    A non-2xx reply raises."""
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read()), r.headers


class Fleet:
    """The processes of one fleet: spawn, watch, stop."""

    def __init__(self, logs: str) -> None:
        self.logs = logs
        self.procs: dict = {}
        self.killed: set = set()
        self.env = dict(os.environ, PYTHONPATH=ROOT, **FLEET_ENV)
        self.env.pop("TFIDF_DEVICE", None)

    def spawn(self, tag: str, *argv: str) -> None:
        f = open(os.path.join(self.logs, f"{tag}.log"), "w")
        p = subprocess.Popen([sys.executable, "-m", "tfidf_tpu_torch",
                              *argv], cwd=ROOT, env=self.env, stdout=f,
                             stderr=subprocess.STDOUT)
        self.procs[tag] = (p, f, time.perf_counter())

    def tail(self, tag: str, n: int = 30) -> str:
        with open(os.path.join(self.logs, f"{tag}.log")) as f:
            return "".join(f.readlines()[-n:])

    def boot_split(self, tag: str) -> dict:
        """The ``boot split`` line a serve node printed once it was up."""
        with open(os.path.join(self.logs, f"{tag}.log")) as f:
            for line in f:
                if line.startswith("boot split "):
                    return json.loads(line[len("boot split "):])
        raise SystemExit(f"fleet: {tag} printed no boot split:\n"
                         f"{self.tail(tag)}")

    def check_alive(self) -> None:
        for tag, (p, _, _) in self.procs.items():
            if tag not in self.killed and p.poll() is not None:
                raise SystemExit(f"fleet: {tag} exited with {p.returncode}"
                                 f":\n{self.tail(tag)}")

    def wait(self, what: str, pred, timeout: float = FLEET_BOOT_S):
        deadline = time.monotonic() + timeout
        while True:
            self.check_alive()
            try:
                got = pred()
            except OSError:
                got = None
            if got:
                return got
            if time.monotonic() > deadline:
                raise SystemExit(f"fleet: timed out waiting for {what}")
            time.sleep(0.2)

    def kill(self, tag: str) -> None:
        """SIGKILL one process (a kill -9 mid-load) and reap it."""
        p = self.procs[tag][0]
        self.killed.add(tag)
        p.kill()
        p.wait(timeout=60)

    def stop(self) -> dict:
        """SIGTERM every process (workers and router first, the leader,
        then the coordinator); returns each exit code."""
        import signal
        codes = {}
        for tag in sorted(self.procs, key=lambda t: (
                t == "coordinator", t == "leader")):
            p, f, _ = self.procs[tag]
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
            try:
                codes[tag] = p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
                codes[tag] = "killed"
            f.close()
        return codes


def fleet_traffic(url: str, queries, mode: str = "sparse",
                  fusion=None) -> tuple:
    """``queries`` through ``url``/leader/start from FLEET_CLIENTS
    threads, one query a POST. Returns (replies, stats); a reply stamped
    degraded fails the phase."""
    from concurrent.futures import ThreadPoolExecutor

    def one(q):
        body = {"query": q}
        if mode != "sparse":
            body["mode"] = mode
        if fusion is not None:
            body["fusion"] = fusion
        t0 = time.perf_counter()
        out, hdrs = http_json(url + "/leader/start", body)
        dt = time.perf_counter() - t0
        for h in ("X-Compute-Degraded", "X-Scatter-Degraded"):
            if hdrs.get(h):
                raise SystemExit(f"fleet: {mode} reply to {q!r} stamped "
                                 f"{h}: {hdrs.get(h)}")
        return out, dt, hdrs.get("X-Search-Stages")

    with ThreadPoolExecutor(FLEET_CLIENTS) as pool:
        t0 = time.perf_counter()
        res = list(pool.map(one, queries))
        wall = time.perf_counter() - t0
    lat = np.array([r[1] for r in res]) * 1e3
    stages = {r[2] for r in res}
    return [r[0] for r in res], {
        "queries": len(queries), "wall_s": wall,
        "qps": len(queries) / wall, "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()), "stages": sorted(map(str, stages))}


class ViewAges:
    """The age (s since last confirmed current) of each follower's
    placement view, sampled every 250 ms while the block runs. A view
    older than ``router_stale_ms`` (5 s) stamps the router's replies
    ``stale_view``."""

    def __init__(self, urls: dict) -> None:
        self.urls = urls
        self.ages = {t: [] for t in urls}

    def __enter__(self):
        import threading
        self.stop = threading.Event()

        def poll():
            while not self.stop.wait(0.25):
                for t, u in self.urls.items():
                    try:
                        age = http_json(u + "/api/router", timeout=30)[0][
                            "placement"].get("age_s")
                    except OSError:
                        continue
                    if age is not None:
                        self.ages[t].append(age)
        self.thread = threading.Thread(target=poll, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=60)
        self.result = {t: {"samples": len(a),
                           "max_s": max(a) if a else "not measured"}
                       for t, a in self.ages.items()}
        return False


class GpuSampler:
    """``utilization.gpu`` sampled every 100 ms while the block runs: the
    percent of each sample period in which a kernel was executing, a
    coarse device-busy share of the window."""

    def __enter__(self):
        self.p = subprocess.Popen(
            [SMI, "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.p.terminate()
        out, _ = self.p.communicate(timeout=30)
        vals = [int(v) for v in out.split() if v.strip().isdigit()]
        self.result = ({"samples": len(vals),
                        "mean_util_pct": float(np.mean(vals)),
                        "busy_share": float(np.mean(vals)) / 100.0,
                        "idle_share": 1.0 - float(np.mean(vals)) / 100.0}
                       if vals else {"samples": 0,
                                     "busy_share": "not measured"})
        return False


def smi_query(*args: str) -> str:
    return subprocess.run([SMI, *args, "--format=csv,noheader,nounits"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def card_memory_mib() -> float:
    return float(smi_query("--query-gpu=memory.used"))


def hold(got: dict, cand, score_of, score_tol, tie_tol, what: str) -> int:
    """One reply (name -> f32 score, in the plane's (-score, name) order)
    against its oracle: ``cand`` holds (name, f64 score) for every doc
    that can reach the top-k, ``score_of`` gives any doc's f64 score.
    Ids identical rank by rank except inside a near-tie group (scores
    within ``tie_tol``), each reply score within ``score_tol`` of its
    doc's f64 score. Returns the near-tie swaps."""
    want = sorted(cand, key=lambda t: (-t[1], t[0]))[:TOP_K]
    items = list(got.items())
    if len(items) != len(want):
        raise SystemExit(f"fleet {what}: {len(items)} hits, oracle "
                         f"{len(want)}: {items} vs {want}")
    order = sorted(items, key=lambda t: (-t[1], t[0]))
    if order != items:
        raise SystemExit(f"fleet {what}: reply not in (-score, name) "
                         f"order: {items}")
    swaps = 0
    for (gn, gs), (wn, ws) in zip(items, want):
        s = score_of(gn)
        if abs(gs - s) > score_tol(s):
            raise SystemExit(f"fleet {what}: {gn} scored {gs}, oracle {s}")
        if gn != wn:
            if abs(s - ws) > tie_tol(ws):
                raise SystemExit(f"fleet {what}: {gn} ({s}) where the "
                                 f"oracle ranks {wn} ({ws})")
            swaps += 1
    return swaps


def _top_candidates(s: np.ndarray, base: int, positive: bool,
                    name_of=None) -> list:
    """(name, score) of every doc at or above the k-th largest score
    (above zero too, when ``positive``); doc ``i`` is ``name_of(i)``, by
    default ``d<base + i>``."""
    k = min(TOP_K, s.shape[0])
    kth = np.partition(s, s.shape[0] - k)[s.shape[0] - k]
    idx = np.flatnonzero(s >= kth)
    if positive:
        idx = idx[s[idx] > 0]
    name_of = name_of or (lambda i: f"d{base + i}")
    return [(name_of(i), float(s[i])) for i in idx]


def sparse_mats(corpus, shards, vocab: int = NS_VOCAB) -> list:
    """Each shard's postings as a scipy CSR matrix of term frequencies by
    term (``[vocab, docs]``) with its docs' lengths: the oracle scores a
    shard with that shard's own df, N and average length, which is what
    its worker computes. ``[{"lo", "parts": [(tf by term, lengths)],
    "extra": names of docs after the bulk-loaded ones}, ...]``."""
    import scipy.sparse as sp
    offsets, ids, tfs, lengths = corpus
    mats = []
    for sh in shards:
        lo, hi = sh["lo"], sh["hi"]
        a, z = offsets[lo], offsets[hi]
        n = hi - lo
        # each doc's ids are distinct: transpose the doc-major CSR
        by_term = sp.csr_matrix((tfs[a:z].astype(np.float64), ids[a:z],
                                 offsets[lo:hi + 1] - a),
                                shape=(n, vocab)).T.tocsr()
        mats.append({"lo": lo, "parts": [
            (by_term, lengths[lo:hi].astype(np.float64))], "extra": []})
    return mats


def with_uploads(mats, docs, held, vocab: int = NS_VOCAB) -> list:
    """``mats`` with the uploaded ``docs`` (``{"name", "text"}``, words
    ``t<id>`` and one ``fresh<i>`` outside the vocabulary) each shard's
    worker holds (``held``: one set of names a shard) after its docs."""
    import scipy.sparse as sp
    out = []
    for m, names in zip(mats, held):
        mine = [d for d in docs if d["name"] in names]
        cols, rows, vals, lens = [], [], [], []
        for j, d in enumerate(mine):
            words = d["text"].split()
            t, c = np.unique([int(w[1:]) for w in words
                              if w.startswith("t")], return_counts=True)
            rows.append(t)
            cols.append(np.full(t.shape[0], j))
            vals.append(c.astype(np.float64))
            lens.append(len(words))
        parts = list(m["parts"])
        if mine:
            parts.append((sp.csr_matrix(
                (np.concatenate(vals), (np.concatenate(rows),
                                        np.concatenate(cols))),
                shape=(vocab, len(mine))), np.array(lens, np.float64)))
        out.append({"lo": m["lo"], "parts": parts,
                    "extra": m["extra"] + [d["name"] for d in mine]})
    return out


def shard_scores(mats, query: str) -> list:
    """``[(shard, f64 BM25 scores of its docs), ...]`` for one query: per
    term, idf from the shard's df and N, each posting's tf normalised by
    the shard's average length, times the term's count in the query."""
    k1, b = 1.2, 0.75
    terms, counts = np.unique([int(t[1:]) for t in query.split()],
                              return_counts=True)
    rows = []
    for m in mats:
        lens = [ln for _, ln in m["parts"]]
        n = sum(ln.shape[0] for ln in lens)
        avgdl = sum(ln.sum() for ln in lens) / n
        s_ = [np.zeros(ln.shape[0]) for ln in lens]
        for t, c in zip(terms, counts):
            df = sum(M.indptr[t + 1] - M.indptr[t] for M, _ in m["parts"])
            idf = np.log1p((n - df + 0.5) / (df + 0.5))
            for (M, ln), sp_ in zip(m["parts"], s_):
                a, z = M.indptr[t], M.indptr[t + 1]
                d, tf = M.indices[a:z], M.data[a:z]
                sp_[d] += c * (idf * tf / (tf + k1 * (1 - b + b * ln[d]
                                                      / avgdl)))
        rows.append((m, np.concatenate(s_)))
    return rows


def _shard_candidates(rows) -> list:
    cand = []
    for m, s_ in rows:
        nb = s_.shape[0] - len(m["extra"])

        def name_of(i, m=m, nb=nb):
            return f"d{m['lo'] + i}" if i < nb else m["extra"][i - nb]
        cand += _top_candidates(s_, 0, True, name_of)
    return cand


def oracle_top(rows) -> dict:
    """The top-k map (name -> f64 score, in (-score, name) order) of the
    merge of ``rows`` (``shard_scores`` of some shards)."""
    return dict(sorted(_shard_candidates(rows),
                       key=lambda t: (-t[1], t[0]))[:TOP_K])


def hold_shards(got: dict, rows, what: str) -> tuple:
    """One sparse reply against the merge of ``rows`` (``shard_scores``
    of the shards that answered). Returns (near-tie swaps, the oracle's
    top-k map)."""
    cand = _shard_candidates(rows)
    score = {nm: s_[s_.shape[0] - len(m["extra"]) + j]
             for m, s_ in rows for j, nm in enumerate(m["extra"])}

    def score_of(name):
        if name in score:
            return float(score[name])
        d = int(name[1:]) if name[:1] == "d" and name[1:].isdigit() else -1
        for m, s_ in rows:
            if 0 <= d - m["lo"] < s_.shape[0] - len(m["extra"]):
                return float(s_[d - m["lo"]])
        raise SystemExit(f"fleet {what}: {name} is on no shard that "
                         f"answered")

    return (hold(got, cand, score_of, lambda v: 1e-5 * abs(v),
                 lambda v: 1e-6 * abs(v), what),
            dict(sorted(cand, key=lambda t: (-t[1], t[0]))[:TOP_K]))


def fleet_sparse_oracle(corpus, shards, queries, replies,
                        mats=None) -> tuple:
    """Sparse replies against an f64 oracle that scores each shard with
    its own statistics (``sparse_mats``) and merges by (-score, name).
    Returns (stats, per-query swaps, the oracle's top-k maps)."""
    mats = mats or sparse_mats(corpus, shards)

    def one(i):
        return hold_shards(replies[i], shard_scores(mats, queries[i]),
                           f"sparse q{i}")

    # numpy's array loops release the GIL: one thread per core
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        res = list(pool.map(one, range(len(queries))))
    swaps, tops = [r[0] for r in res], [r[1] for r in res]
    ranks = sum(len(r) for r in replies)
    return ({"queries": len(replies), "ranks": ranks,
             "ids_identical": ranks - sum(swaps),
             "near_tie_swaps": sum(swaps)}, swaps, tops)


def fleet_dense_oracle(rows, queries, replies) -> tuple:
    """Dense replies against a numpy f64 brute force over both shards'
    rows (phase 3d's tolerances; ties by name, the plane's merge order).
    Returns (stats, per-query swaps, the oracle's top-k maps)."""
    from tfidf_tpu_torch.engine.embedder import get_embedder
    from tfidf_tpu_torch.ops.analyzer import Analyzer
    from tfidf_tpu_torch.utils.config import Config
    c = Config()
    an = Analyzer(lowercase=c.lowercase, stopwords=frozenset(c.stopwords),
                  max_token_length=c.max_token_length)
    emb = get_embedder(c.embedding_model, c.embedding_dim)
    rows64 = rows.astype(np.float64)
    Q = np.stack([emb.embed_query(an.counts(q))
                  for q in queries]).astype(np.float64)

    def one(i):
        s = rows64 @ Q[i]
        cand = _top_candidates(s, 0, positive=False)
        sw = hold(replies[i], cand, lambda name: float(s[int(name[1:])]),
                  lambda v: 1e-6 + 1e-5 * abs(v), lambda v: 1e-6,
                  f"dense q{i}")
        err = max((abs(v - s[int(n[1:])]) for n, v in replies[i].items()),
                  default=0.0)
        return sw, dict(sorted(cand, key=lambda t: (-t[1], t[0]))
                        [:TOP_K]), float(err)

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        res = list(pool.map(one, range(len(queries))))
    swaps = [r[0] for r in res]
    ranks = sum(len(r) for r in replies)
    return ({"queries": len(replies), "ranks": ranks,
             "ids_identical": ranks - sum(swaps),
             "near_tie_swaps": sum(swaps),
             "max_abs_err": max(r[2] for r in res)},
            swaps, [r[1] for r in res])


def fleet_hybrid_check(hybrid, sparse, dense, s_top, d_top, s_swaps,
                       d_swaps) -> dict:
    """Each hybrid (rrf) reply is ``fusion.fuse`` of the two oracles'
    top-k; a query whose stage replies hold a near-tie swap is held to
    the fusion of its served stage replies instead (the tie's order is
    the f32 sum's, not the oracle's), and every reply equals that fusion
    exactly."""
    from tfidf_tpu_torch.cluster.fusion import fuse
    from tfidf_tpu_torch.utils.config import Config
    c = Config()

    def fused(sm, dm):
        f = fuse(sm, dm, method="rrf", k=c.top_k, rrf_k=c.fusion_rrf_k,
                 w_sparse=c.fusion_weight_sparse,
                 w_dense=c.fusion_weight_dense)
        return dict(sorted(f.items(), key=lambda t: (-t[1], t[0]))
                    [:c.top_k])

    oracle_equal = tie_held = 0
    for i, got in enumerate(hybrid):
        if got != fused(sparse[i], dense[i]):
            raise SystemExit(f"fleet hybrid q{i}: reply is not the fusion "
                             f"of its stage replies: {got}")
        if s_swaps[i] or d_swaps[i]:
            tie_held += 1
            continue
        want = fused(s_top[i], d_top[i])
        if list(got) != list(want) or any(
                abs(got[n] - want[n]) > 1e-12 for n in want):
            raise SystemExit(f"fleet hybrid q{i}: {got} vs the fusion of "
                             f"the oracles {want}")
        oracle_equal += 1
    return {"queries": len(hybrid), "equal_to_fused_oracles": oracle_equal,
            "held_to_fused_stages_near_tie": tie_held}


# --------------------------------------------------------------------------
# phase 13: the compute chaos job on phase 7's fleet, and a kill -9
# --------------------------------------------------------------------------

CHAOS_POOL = 128           # north-star queries phase 7 did not send
CHAOS_CLIENTS = 8          # closed-loop client threads over the pool
CHAOS_POISON_UNIQ = 6      # the poison rule's min_uniq (distinct terms)
CHAOS_PROBES = 32          # innocent queries sent while the poison is held
# the two windows were 15 s and 10 s until a run on a slow machine took
# 1,216 s in all: cut to keep the run inside its time limit
CHAOS_SICK_S = 8.0         # the window with worker0 sick and worker1 wedged
CHAOS_KILL_S = 5.0         # the window after worker1's kill -9
CHAOS_WAIT_S = 120.0       # deadline of every wait in the phase
VERDICTS = ("exact", "compute_degraded", "degraded", "failed")


def classify_reply(status, hdrs, got, want, partial=None) -> str:
    """One reply's verdict, as the compute chaos job
    (``tests/test_compute_chaos.py``) classifies it: ``failed`` (no 200),
    ``exact`` / ``compute_degraded`` (the baseline reply, the latter
    stamped ``X-Compute-Degraded``), ``degraded`` (stamped, not the
    baseline). With ``partial`` (the oracle of the shards still alive) a
    reply stamped ``X-Scatter-Degraded`` must pass it: an honest partial,
    not a wrong one. An unmarked 200 that is not the baseline fails."""
    if status != 200:
        return "failed"
    scatter = bool(hdrs.get("X-Scatter-Degraded"))
    if scatter and partial is not None:
        if not partial(got):
            raise SystemExit(f"chaos: a reply stamped X-Scatter-Degraded "
                             f"({hdrs.get('X-Scatter-Degraded')}) is not "
                             f"the live shards' oracle: {got}")
        return "degraded"
    if got == want:
        return "compute_degraded" if hdrs.get("X-Compute-Degraded") \
            else "exact"
    if scatter or hdrs.get("X-Compute-Degraded"):
        return "degraded"
    raise SystemExit(f"chaos: an unmarked 200 is not in parity: {got} vs "
                     f"the baseline {want}")


def shard_partial(mats, query: str, live: tuple):
    """The check of a partial reply to ``query``: it must be the oracle
    of the shards ``live`` (indices into ``mats``) alone."""
    def check(got) -> bool:
        rows = [shard_scores([mats[i]], query)[0] for i in live]
        try:
            hold_shards(got, rows, f"partial of shards {live}")
        except SystemExit:
            return False
        return True
    return check


def poison_terms(mats, n: int = CHAOS_POISON_UNIQ) -> str:
    """A query of the ``n`` terms with the most documents in every shard:
    each has a positive weight on both workers, so a ``min_uniq=n`` poison
    rule NaNs its row there and no 2-4-term pool query's."""
    df = np.min([np.diff(m["parts"][0][0].indptr) for m in mats], axis=0)
    top = np.argsort(-df, kind="stable")[:n]
    return " ".join(f"t{t}" for t in sorted(top.tolist()))


def http_post_full(url: str, body, timeout: float = 120.0) -> tuple:
    """POST JSON; (status, headers, decoded body or None), any status."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            got = json.loads(raw)
        except ValueError:
            got = None
        return e.code, dict(e.headers), got


class ChaosLoad:
    """CHAOS_CLIENTS closed-loop clients, each drawing a query of the pool
    as the compute chaos job does (``pool[int(r ** 2 * len(pool))]``) and
    classifying its reply (``classify_reply``) under the current ``leg``.
    After :meth:`killed`, a reply stamped ``X-Scatter-Degraded`` must be
    the oracle of worker0's shard alone."""

    def __init__(self, url: str, pool, baseline, mats, seed: int) -> None:
        import threading
        self.url, self.pool, self.baseline = url, pool, baseline
        self.mats, self.seed = mats, seed
        self.leg = "poison"
        self.counts: dict = {}
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.errors: list = []
        self.kill_t = None
        self.first_stamped_s = None
        self.degraded: dict = {}      # leg -> the first few stamps
        self.threads = [threading.Thread(target=self.client, args=(c,),
                                         daemon=True)
                        for c in range(CHAOS_CLIENTS)]

    def start(self) -> "ChaosLoad":
        for t in self.threads:
            t.start()
        return self

    def killed(self) -> None:
        """From now on (called just before the kill) a stamped reply is
        held to worker0's shard alone."""
        self.kill_t = time.perf_counter()

    def client(self, cid: int) -> None:
        import random
        rng = random.Random(self.seed * 1000 + cid)
        while not self.stop.is_set():
            q = self.pool[int(rng.random() ** 2 * len(self.pool))]
            leg = self.leg
            try:
                st, hd, got = http_post_full(self.url + "/leader/start",
                                             {"query": q})
            except OSError:
                st, hd, got = None, {}, None
            # a reply that lands after the kill is held to worker0's
            # shard alone, whenever its request was sent
            kill_t = self.kill_t
            partial = None if kill_t is None else \
                shard_partial(self.mats, q, (0,))
            try:
                v = classify_reply(st, hd, got, self.baseline[q], partial)
            except SystemExit as e:
                self.errors.append(f"{leg}: {q!r}: {e}")
                return
            with self.lock:
                c = self.counts.setdefault(leg, dict.fromkeys(VERDICTS, 0))
                c[v] += 1
                if v == "degraded" and len(self.degraded.setdefault(
                        leg, [])) < 3:
                    self.degraded[leg].append({
                        h: hd.get(h) for h in ("X-Compute-Degraded",
                                               "X-Scatter-Degraded")})
                if (kill_t is not None and self.first_stamped_s is None
                        and hd.get("X-Scatter-Degraded")):
                    self.first_stamped_s = time.perf_counter() - kill_t

    def outcomes(self, leg: str) -> dict:
        with self.lock:
            return dict(self.counts.get(leg, dict.fromkeys(VERDICTS, 0)))

    def join(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(timeout=CHAOS_WAIT_S)


def chaos_phase(fleet, url: dict, mats, seed: int, sent, docs) -> dict:
    """Phase 13 on phase 7's fleet (after its gates, before its SIGTERM
    teardown): the compute chaos job adapted to two workers, then a kill
    -9 of worker1 mid-load. ``mats`` is phase 7's per-shard oracle,
    ``sent`` the queries phase 7 sent, ``docs`` the documents it
    uploaded (each worker's share joins its shard's oracle)."""
    from tfidf_tpu_torch.cluster.quarantine import poison_fingerprint
    t_phase = time.perf_counter()
    leader = url["leader"]
    workers = ("worker0", "worker1")

    def metrics(tag):
        return http_json(url[tag] + "/api/metrics")[0]

    def v4():
        return {w: int(metrics(w).get("ell_kernel_launches_v4", 0))
                for w in workers}

    def compute(tag):
        return http_json(url[tag] + "/api/health")[0]["compute"]

    def nemesis(tag, body):
        http_json(url[tag] + "/api/device-nemesis", body)

    def send(q):
        return http_post_full(leader + "/leader/start", {"query": q})

    def wait(what, pred):
        t0 = time.perf_counter()
        fleet.wait(what, pred, timeout=CHAOS_WAIT_S)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    held = [set(http_json(url[w] + "/worker/names")[0]["names"])
            for w in workers]
    mats = with_uploads(mats, docs, held)
    oracle_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 13)
    seen, pool = set(sent), []
    while len(pool) < CHAOS_POOL:
        for q in make_queries(rng, NS_VOCAB, CHAOS_POOL):
            if q not in seen and len(pool) < CHAOS_POOL:
                seen.add(q)
                pool.append(q)
    poison = poison_terms(mats)
    pool.append(poison)
    fp = poison_fingerprint(poison, "sparse")
    for w in workers:
        if not compute(w).get("fallback_available"):
            raise SystemExit(f"chaos: {w} has no host mirror: {compute(w)}")
    res = {"oracle_uploads_s": oracle_s,
           "config": {"pool": len(pool), "poison": poison,
                      "clients": CHAOS_CLIENTS, "sick_window_s":
                      CHAOS_SICK_S, "kill_window_s": CHAOS_KILL_S},
           "launches_v4": {}}

    # ---- leg 1: the baseline, every pool query exact and unstamped ----
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    launches = start = v4()
    with ThreadPoolExecutor(CHAOS_CLIENTS) as ex:
        replies = list(ex.map(send, pool))
    for q, (st, hd, got) in zip(pool, replies):
        stamps = [h for h in ("X-Compute-Degraded", "X-Scatter-Degraded")
                  if hd.get(h)]
        if st != 200 or stamps or not got:
            raise SystemExit(f"chaos baseline: {q!r} -> {st} {stamps} {got}")
    baseline = {q: r[2] for q, r in zip(pool, replies)}

    def held(i):
        return hold_shards(baseline[pool[i]], shard_scores(mats, pool[i]),
                           f"chaos baseline q{i}")[0]
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        swaps = list(ex.map(held, range(len(pool))))
    after = v4()
    res["launches_v4"]["baseline"] = {w: after[w] - launches[w]
                                      for w in workers}
    res["baseline"] = {"queries": len(pool), "near_tie_swaps": sum(swaps),
                       "seconds": time.perf_counter() - t0}
    log(f"[chaos] baseline: {len(pool)} queries exact and unstamped, held "
        f"to the per-shard oracle ({sum(swaps)} near-tie swaps) in "
        f"{res['baseline']['seconds']:.1f}s; v4 launches "
        f"{res['launches_v4']['baseline']}")

    load = ChaosLoad(leader, pool, baseline, mats, seed).start()
    try:
        # ---- leg 2: a poison query quarantined on exactly two replicas
        launches = v4()
        for w in workers:
            nemesis(w, {"script": "score_ell:poison:1.0:min_uniq="
                                  f"{CHAOS_POISON_UNIQ}"})
        res["to_quarantine_s"] = wait("the poison quarantine", lambda: (
            lambda r: r[0] == 422
            and r[1].get("X-Poison-Quarantined") == fp)(send(poison)))
        snap = http_json(leader + "/api/quarantine")[0]
        (entry,) = [e for e in snap["quarantined"]
                    if e["fingerprint"] == fp]
        if sorted(entry["replicas"]) != sorted(url[w] for w in workers):
            raise SystemExit(f"chaos: quarantined on {entry['replicas']}, "
                             f"not on exactly both workers")
        st, hd, got = send(poison)
        if st != 422 or hd.get("X-Poison-Quarantined") != fp \
                or got.get("fingerprint") != fp:
            raise SystemExit(f"chaos: the next poison send got {st} {got}")
        probes = pool[:CHAOS_PROBES]
        with ThreadPoolExecutor(CHAOS_CLIENTS) as ex:
            for q, (st, hd, got) in zip(probes, ex.map(send, probes)):
                if classify_reply(st, hd, got, baseline[q]) != "exact" \
                        or hd.get("X-Compute-Degraded"):
                    raise SystemExit(f"chaos: innocent {q!r} under the "
                                     f"poison rule -> {st} {hd}")
        states = {w: compute(w)["state"] for w in workers}
        if set(states.values()) != {"healthy"}:
            raise SystemExit(f"chaos: compute states under poison {states}")
        for w in workers:
            nemesis(w, {"clear": True})
        cleared = http_json(leader + "/api/quarantine", {})[0]
        st, hd, got = send(poison)
        if cleared.get("cleared") != 1 or st != 200 \
                or got != baseline[poison]:
            raise SystemExit(f"chaos: after clearing {cleared}, the poison "
                             f"query -> {st} {got}")
        after = v4()
        res["launches_v4"]["poison"] = {w: after[w] - launches[w]
                                        for w in workers}
        if not all(res["launches_v4"]["poison"].values()):
            raise SystemExit(f"chaos: a worker launched no kernel under the "
                             f"poison rule: {res['launches_v4']['poison']}")
        res["poison"] = {"replicas": len(entry["replicas"]),
                         "outcomes": load.outcomes("poison")}
        log(f"[chaos] poison: quarantined on both workers "
            f"{res['to_quarantine_s']:.2f}s after arming, then 422; "
            f"{len(probes)} innocent queries exact on the device, both "
            f"healthy; cleared, admitted with its baseline reply; "
            f"outcomes {res['poison']['outcomes']}, v4 launches "
            f"{res['launches_v4']['poison']}")

        # ---- leg 3: worker0 sick (host mirror), worker1 wedged ----
        load.leg = "sick"
        launches = v4()
        nemesis("worker0", {"script": "*:oom"})
        nemesis("worker1", {"script": "*:delay:1.0:delay_s=0.2"})
        res["to_sick_s"] = wait("worker0 sick", lambda: compute(
            "worker0")["state"] == "sick")
        at_sick = v4()
        time.sleep(CHAOS_SICK_S)
        sick_end = v4()
        res["sick"] = {"outcomes": load.outcomes("sick"),
                       "fallback_served": metrics("worker0").get(
                           "compute_fallback_served", 0)}
        load.leg = "healing"
        t_clear = time.perf_counter()
        for w in workers:
            nemesis(w, {"clear": True})
        fleet.wait("worker0 healed", lambda: compute(
            "worker0")["state"] == "healthy", timeout=CHAOS_WAIT_S)
        res["to_healed_s"] = time.perf_counter() - t_clear

        def recovered():
            st, hd, got = send(pool[0])
            return (st == 200 and not hd.get("X-Compute-Degraded")
                    and not hd.get("X-Scatter-Degraded")
                    and got == baseline[pool[0]])
        fleet.wait("unstamped baseline replies", recovered,
                   timeout=CHAOS_WAIT_S)
        res["to_converged_s"] = time.perf_counter() - t_clear
        healed = wait("worker0's kernel launches rising", lambda:
                      v4()["worker0"] > sick_end["worker0"])
        after = v4()
        res["launches_v4"]["sick"] = {
            "worker0_while_sick": sick_end["worker0"] - at_sick["worker0"],
            "worker1_while_wedged": sick_end["worker1"] - at_sick["worker1"],
            "worker0_before_sick": at_sick["worker0"] - launches["worker0"],
            "worker0_after_healing": after["worker0"] - sick_end["worker0"]}
        c = res["sick"]["outcomes"]
        if c["compute_degraded"] < 1:
            raise SystemExit(f"chaos: no compute_degraded reply while "
                             f"worker0 was sick: {c}")
        if res["launches_v4"]["sick"]["worker0_while_sick"]:
            raise SystemExit(f"chaos: worker0 launched the kernel while "
                             f"sick: {res['launches_v4']['sick']}")
        log(f"[chaos] sick: worker0 sick {res['to_sick_s']:.2f}s after "
            f"arming; {CHAOS_SICK_S:.0f}s window outcomes {c} "
            f"({c['compute_degraded'] / CHAOS_SICK_S:.2f} compute-degraded "
            f"q/s), fallback served {res['sick']['fallback_served']}; "
            f"healed {res['to_healed_s']:.2f}s after clearing, unstamped "
            f"baseline replies at {res['to_converged_s']:.2f}s, v4 rising "
            f"{healed:.2f}s later; v4 launches {res['launches_v4']['sick']}")

        # ---- leg 4: kill -9 worker1 mid-load ----
        load.leg = "kill"
        launches = v4()
        mem_before = card_memory_mib()
        load.killed()
        fleet.kill("worker1")
        fleet.wait("the first stamped reply after the kill",
                   lambda: load.first_stamped_s is not None,
                   timeout=CHAOS_WAIT_S)

        def worker1_out():
            m = metrics("leader")
            return (m.get("breaker_open_workers", 0) >= 1
                    or url["worker1"] not in http_json(
                        leader + "/api/services")[0])
        res["to_breaker_s"] = wait("the leader's breaker or registry "
                                   "dropping worker1", worker1_out)
        before = load.outcomes("kill")
        time.sleep(CHAOS_KILL_S)
        window = {k: v - before[k] for k, v in load.outcomes(
            "kill").items()}
        mem_after = card_memory_mib()
        end_w0 = int(metrics("worker0").get("ell_kernel_launches_v4", 0))
    finally:
        load.join()
    if load.errors:
        raise SystemExit(f"chaos: {load.errors[:3]}")
    res["outcomes"] = {leg: load.outcomes(leg) for leg in
                       ("poison", "sick", "healing", "kill")}
    res["degraded_stamps"] = load.degraded
    res["kill"] = {"window_outcomes": window,
                   "degraded_qps": (sum(window.values())
                                    - window["failed"]) / CHAOS_KILL_S,
                   "to_first_stamped_s": load.first_stamped_s,
                   "card_memory_used_mib": {"before": mem_before,
                                            "after": mem_after}}
    res["launches_v4"]["kill"] = {"worker0": end_w0 - launches["worker0"]}
    if not res["launches_v4"]["kill"]["worker0"]:
        raise SystemExit(f"chaos: worker0 launched no kernel after the "
                         f"kill: {res['kill']}, {res['launches_v4']}")
    res["launches"] = {"v4": end_w0 - start["worker0"] + launches["worker1"]
                       - start["worker1"], "v3": 0}
    log(f"[chaos] kill -9 worker1: first X-Scatter-Degraded reply "
        f"{load.first_stamped_s:.2f}s after, breaker or registry "
        f"{res['to_breaker_s']:.2f}s; {CHAOS_KILL_S:.0f}s window "
        f"{window}: {res['kill']['degraded_qps']:.2f} q/s, every stamped "
        f"reply worker0's per-shard oracle; memory.used {mem_before} -> "
        f"{mem_after} MiB; worker0 v4 launches "
        f"{res['launches_v4']['kill']['worker0']}; outcomes by leg "
        f"{res['outcomes']}; the first degraded stamps by leg "
        f"{load.degraded}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


def fleet_phase(data, shards, seed: int, work: str, out_dir: str) -> dict:
    """Phase 7: coordinator, leader, two workers and a router as
    ``python -m tfidf_tpu_torch`` processes on the one card; the workers
    restore their shards at boot; traffic from FLEET_CLIENTS threads.
    The processes' logs are copied to ``out_dir``/fleet_logs, pass or
    fail."""
    root = os.path.join(work, "fleet")
    fleet = Fleet(root)
    cport, lport, w0, w1, rport = free_ports(5)
    caddr = f"127.0.0.1:{cport}"
    url = {t: f"http://127.0.0.1:{p}" for t, p in
           (("leader", lport), ("worker0", w0), ("worker1", w1),
            ("router", rport))}
    n_docs = data["corpus"][0].shape[0] - 1
    res = {"config": {"env": FLEET_ENV, "clients": FLEET_CLIENTS,
                      "docs": n_docs, "shards": [sh["hi"] - sh["lo"]
                                                 for sh in shards]},
           "shards": shards}

    def serve(tag, port):
        d = os.path.join(root, tag)
        # documents_path does not exist at boot: a bulk-loaded shard has
        # no raw files, and restore-at-boot drops every checkpointed doc
        # without one when the directory exists
        fleet.spawn(tag, "serve", "--device", FLEET_DEVICE,
                    "--host", "127.0.0.1", "--port", str(port),
                    "--coordinator-address", caddr,
                    "--documents-path", os.path.join(d, "documents"),
                    "--index-path", os.path.join(d, "index"))

    def metrics(tag):
        return http_json(url[tag] + "/api/metrics")[0]

    def text(u):
        import urllib.request
        with urllib.request.urlopen(u, timeout=30) as r:
            return r.read().decode()

    try:
        # the card's memory.used as the fleet comes up: nvidia-smi lists
        # no per-process memory in a container (every compute process as
        # pid 1 with the card's total), so each step's growth is the
        # process it started
        mem = {"before": card_memory_mib()}
        t_boot = time.perf_counter()
        fleet.spawn("coordinator", "coordinator", "--listen", caddr)
        serve("leader", lport)
        fleet.wait("the leader's election", lambda: text(
            url["leader"] + "/api/status") == "I am the leader")
        res["leader_up_s"] = time.perf_counter() - t_boot
        mem["leader_up"] = card_memory_mib()
        for i, tag in enumerate(("worker0", "worker1")):
            if os.path.exists(os.path.join(root, tag, "documents")):
                raise SystemExit(f"fleet: {tag}'s documents dir exists")
            serve(tag, (w0, w1)[i])
        boot = {}
        for tag in ("worker0", "worker1"):
            fleet.wait(f"{tag} serving", lambda tag=tag: http_json(
                url[tag] + "/api/health")[0]["ok"])
            boot[tag] = time.perf_counter() - fleet.procs[tag][2]
        res["worker_boot_to_serving_s"] = boot
        mem["workers_up"] = card_memory_mib()
        fleet.wait("two workers registered", lambda: len(http_json(
            url["leader"] + "/api/services")[0]) == 2)
        for i, tag in enumerate(("worker0", "worker1")):
            emb = http_json(url[tag] + "/api/health")[0]["embedding"]
            want = shards[i]["hi"] - shards[i]["lo"]
            if emb["docs"] != want:
                raise SystemExit(f"fleet: {tag} restored {emb} "
                                 f"(expected {want} docs)")
        fleet.wait("the leader adopting every restored doc", lambda:
                   metrics("leader").get("residue_orphans_adopted", 0)
                   >= n_docs)
        res["fleet_serving_s"] = time.perf_counter() - t_boot
        fleet.spawn("router", "router", "--coordinator", caddr,
                    "--host", "127.0.0.1", "--port", str(rport))
        fleet.wait("the router serving", lambda: http_json(
            url["router"] + "/api/health")[0]["ok"])

        # every follower view (router, workers) holds the whole map
        # before the timed windows: a view load parses the ~39 MB znode
        def views():
            got = {t: http_json(url[t] + "/api/router")[0]["placement"]
                   .get("docs") for t in ("router", "worker0", "worker1")}
            return got if all(v == n_docs for v in got.values()) else None
        fleet.wait("every placement view", views)
        res["views_synced_s"] = time.perf_counter() - t_boot
        mem["router_up"] = card_memory_mib()
        log(f"[fleet] leader elected {res['leader_up_s']:.1f}s after the "
            f"coordinator started; workers restored and serving in "
            f"{ {k: round(v, 2) for k, v in boot.items()} }s; leader "
            f"adopted {n_docs} docs at {res['fleet_serving_s']:.1f}s, "
            f"every placement view loaded at {res['views_synced_s']:.1f}s")

        # each serve node's boot split (tfidf_tpu_torch/boot.py), a line
        # of its own per boot
        res["boot_split"] = {}
        for tag in ("leader", "worker0", "worker1"):
            res["boot_split"][tag] = fleet.boot_split(tag)
            log(f"[boot] {tag} {json.dumps(res['boot_split'][tag])}")

        rng = np.random.default_rng(seed + 7)
        queries = make_queries(rng, NS_VOCAB, FLEET_SPARSE)
        staged = queries[:FLEET_STAGED]
        http_json(url["leader"] + "/leader/start", {"query": staged[0]})

        def window(name, target, qs, mode="sparse", fusion=None):
            before = {t: metrics(t) for t in
                      ("leader", "worker0", "worker1")}
            if target == "router":
                before["router"] = metrics("router")
            with GpuSampler() as g, ViewAges({
                    t: url[t] for t in ("router", "worker0",
                                        "worker1")}) as ages:
                replies, st = fleet_traffic(url[target], qs, mode, fusion)
            after = {t: metrics(t) for t in before}

            def delta(t, key):
                return after[t].get(key, 0) - before[t].get(key, 0)

            def window_ms(t, name):
                n = delta(t, f"{name}_count")
                return delta(t, f"{name}_sum_ms") / n if n else None
            st["timings_ms"] = {
                t: {nm: window_ms(t, nm) for nm in FLEET_TIMINGS[
                    "worker" if t.startswith("worker") else t]}
                for t in after}
            st["device"] = g.result
            st["view_age"] = ages.result
            st["view_refreshes"] = {
                t: delta(t, "router_view_refreshes") for t in after
                if t != "leader"}
            co = "router_scatter" if target == "router" else "scatter"
            st["scatter_items_per_batch"] = (
                delta(target, co + "_items")
                / max(delta(target, co + "_batches"), 1))
            st["scatter_batches"] = delta(target, co + "_batches")
            st["result_cache_hits"] = delta(target, "cache_hits")
            st["workers"] = {w: {
                "batches": delta(w, "worker_batch_search_count"),
                "query_items": delta(w, "query_items"),
                "query_batches": delta(w, "query_batches"),
                "ell_launches_v4": delta(w, "ell_kernel_launches_v4")}
                for w in ("worker0", "worker1")}
            if mode != "dense" and not all(
                    v["ell_launches_v4"] > 0 for v in st["workers"].values()):
                raise SystemExit(f"fleet {name}: a worker launched no ELL "
                                 f"kernel: {st['workers']}")
            log(f"[fleet] {name}: {st['queries']} queries, "
                f"{st['qps']:.1f} q/s, p50 {st['p50_ms']:.2f} ms, p99 "
                f"{st['p99_ms']:.2f} ms, {st['scatter_items_per_batch']:.1f} "
                f"queries per worker batch, device {g.result}, placement "
                f"view ages {ages.result}, workers "
                f"{st['workers']}, cache hits {st['result_cache_hits']}, "
                f"window mean ms {st['timings_ms']}")
            res[name] = st
            return replies

        sparse = window("leader_sparse", "leader", queries)
        dense = window("leader_dense", "leader", staged, "dense")
        hybrid = window("leader_hybrid_rrf", "leader", staged, "hybrid",
                        "rrf")
        routed = window("router_sparse", "router", staged)
        if routed != sparse[:FLEET_STAGED]:
            bad = sum(a != b for a, b in zip(routed, sparse))
            raise SystemExit(f"fleet: {bad} router replies differ from "
                             f"the leader's")

        t0 = time.perf_counter()
        mats = sparse_mats(data["corpus"], shards)
        res["sparse_oracle"], s_swaps, s_top = fleet_sparse_oracle(
            data["corpus"], shards, staged, sparse[:FLEET_STAGED], mats)
        res["dense_oracle"], d_swaps, d_top = fleet_dense_oracle(
            data["rows"], staged, dense)
        res["hybrid_oracle"] = fleet_hybrid_check(
            hybrid, sparse, dense, s_top, d_top, s_swaps, d_swaps)
        res["oracle_s"] = time.perf_counter() - t0
        log(f"[fleet] oracles ({res['oracle_s']:.1f}s): sparse "
            f"{res['sparse_oracle']}; dense {res['dense_oracle']}; hybrid "
            f"{res['hybrid_oracle']}; router == leader on "
            f"{len(routed)} queries")

        # writes: new documents through the leader, then read them back
        vocab_words = rng.zipf(1.25, size=(FLEET_UPLOADS, 60)) % NS_VOCAB
        docs = [{"name": f"new{i}.txt",
                 "text": f"fresh{i} " + " ".join(f"t{w}"
                                                 for w in vocab_words[i])}
                for i in range(FLEET_UPLOADS)]
        t0 = time.perf_counter()
        placed = {}
        for lo in range(0, FLEET_UPLOADS, FLEET_UPLOAD_CHUNK):
            out, _ = http_json(url["leader"] + "/leader/upload-batch",
                               docs[lo:lo + FLEET_UPLOAD_CHUNK])
            if out.get("errors") or out.get("skipped"):
                raise SystemExit(f"fleet: upload-batch {out}")
            for w, n in out["placed"].items():
                placed[w] = placed.get(w, 0) + n
        up_s = time.perf_counter() - t0
        if sum(placed.values()) != FLEET_UPLOADS:
            raise SystemExit(f"fleet: placed {placed}")
        found, st = fleet_traffic(url["leader"],
                                  [f"fresh{i}" for i in range(FLEET_UPLOADS)])
        ryw_s = time.perf_counter() - t0
        for i, r in enumerate(found):
            if list(r)[:1] != [f"new{i}.txt"]:
                raise SystemExit(f"fleet: fresh{i} found {r}")
        res["upload"] = {"docs": FLEET_UPLOADS, "seconds": up_s,
                         "docs_per_s": FLEET_UPLOADS / up_s,
                         "placed": sorted(placed.values()),
                         "upload_to_all_read_s": ryw_s,
                         "read_back": st}
        log(f"[fleet] upload-batch: {FLEET_UPLOADS} docs in {up_s:.2f}s = "
            f"{FLEET_UPLOADS / up_s:.1f} docs/s, placed {placed}; all "
            f"{FLEET_UPLOADS} read back through the leader "
            f"{ryw_s:.2f}s after the first upload ({st['qps']:.1f} q/s, "
            f"p99 {st['p99_ms']:.1f} ms)")

        for tag in ("worker0", "worker1"):
            cs = http_json(url[tag] + "/api/health")[0]["compute"]
            served = metrics(tag).get("compute_fallback_served", 0)
            if cs["state"] != "healthy" or cs["total_faults"] or served:
                raise SystemExit(f"fleet: {tag} compute {cs}, fallback "
                                 f"served {served}")
        with open(os.path.join(root, "coordinator.log")) as f:
            expired = f.read().count("reason=timeout")
        if expired:
            raise SystemExit(f"fleet: {expired} coordination sessions "
                             f"expired during the phase")
        mem["after_traffic"] = card_memory_mib()
        # the CUDA processes: this one, the leader and the two workers;
        # the coordinator and the router must not have touched the card
        apps = smi_query("--query-compute-apps=pid,used_memory")
        mem["compute_apps"] = len(apps.splitlines())
        res["card_memory_used_mib"] = mem
        if mem["compute_apps"] != 4:
            raise SystemExit(f"fleet: {mem['compute_apps']} processes on "
                             f"the card, expected 4:\n{apps}")
        fleet.check_alive()
        log(f"[fleet] every process alive; the card's memory.used (MiB) "
            f"{mem}; workers healthy, no fault, no fallback-served "
            f"request")
        # ---- phase 13: chaos on this fleet, before its teardown ----
        res["chaos"] = chaos_phase(fleet, url, mats, seed, queries, docs)
        res["chaos"]["card"] = smi_query("--query-gpu=name,power.limit")
        log(f"[chaos] phase 13 took {res['chaos']['seconds']:.1f}s on "
            f"{res['chaos']['card']} W")
    finally:
        codes = fleet.stop()
        logs = os.path.join(out_dir, "fleet_logs")
        os.makedirs(logs, exist_ok=True)
        for tag in fleet.procs:
            shutil.copy(os.path.join(root, f"{tag}.log"), logs)
    res["exit_codes"] = codes
    # every process exits 0 on SIGTERM but the one phase 13 killed
    if any(c != (-9 if t in fleet.killed else 0) for t, c in codes.items()):
        raise SystemExit(f"fleet: exit codes {codes}")
    log(f"[fleet] stopped by SIGTERM: {codes}")
    return res


# --------------------------------------------------------------------------
# phase 10: the bench's configs that no earlier phase covers
# --------------------------------------------------------------------------

BENCH_C1_CPU_BATCH = 64        # config 1's CPU baselines' batch (the
                               # bench's 512: its numpy loop took 42 s)
BENCH_RT_DOCS = 5_000          # the realistic text's corpus (the bench's
                               # 100,000: 124 s of the phase; 10,000 until
                               # phase 13 joined the run)
BENCH_CLUSTER_DOCS = 2_000     # both cluster configs' corpus (the bench's
                               # 100,000; phase 7 has the fleet at 1M docs)
BENCH_CLUSTER_SHARE = 1_900    # bench_cluster_gpu's first upload (95%)
BENCH_CLUSTER_QUERIES = 256    # queries a sweep point and a warm round
BENCH_CLUSTER_SWEEP = (512, 256)   # client sweep (the bench's 1024/768/512)


def _parity_flags(obj) -> list:
    """Every ``parity_checked`` value in a nested result."""
    if isinstance(obj, dict):
        return ([v for k, v in obj.items() if k == "parity_checked"]
                + [f for v in obj.values() for f in _parity_flags(v)])
    if isinstance(obj, list):
        return [f for v in obj for f in _parity_flags(v)]
    return []


def bench_phase(seed: int, work: str) -> dict:
    """Phase 10: ``tfidf_tpu_torch.bench``'s own functions on the card for
    the configs no earlier phase covers: config 1 and config 5 at the
    bench's sizes, the realistic text, ``bench_cluster`` and
    ``bench_cluster_gpu`` at a cut depth. The ELL launches are counted
    from 0 over the three in-process configs; then one config-5 batch
    through every eligible block, v3 and v4 == plain bitwise, with the
    kernel / plain / ``torch.sparse.mm`` / bound ms. The artifact goes
    through ``_emit_validated`` into ``work`` and must re-parse with every
    ``parity_checked`` true and no kernel build in a timed window."""
    import contextlib
    import io

    from tfidf_tpu_torch import bench as B
    from tfidf_tpu_torch.ops import ell as E
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 10)
    res, wall = {}, {}

    def run(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        wall[name] = time.perf_counter() - t0
        log(f"[bench] {name}: {wall[name]:.1f}s {out}")
        return out

    keep = {}
    E.reset_launches()
    c1 = run("config1_18k_fulltext", B.bench_config1, rng,
             cpu_batch=BENCH_C1_CPU_BATCH)
    c5 = run("config5_5m_vocab", B.bench_5m_vocab, rng, keep=keep)
    rt = run("realistic_text", B.bench_realistic, rng,
             n_docs=BENCH_RT_DOCS)
    launches = dict(E.launches)
    log(f"[bench] ELL launches over configs 1, 5 and the realistic text: "
        f"{launches}")
    if launches["v4"] == 0 or launches["v3"] != 0:
        raise SystemExit(f"bench: launches {launches}")
    # config 5's shape: the kernel's first run over a 5M-term vocabulary
    engine = keep.pop("engine")
    qb, _ = engine.searcher._vectorize(keep["queries"][:B.C5_BATCH],
                                       B.C5_BATCH)
    check_rearrange(engine, qb)
    res["c5_kernel"] = main_path_kernel_times(engine, qb)
    res["c5_kernel"]["vocab_cap"] = int(engine.index.snapshot.df.shape[0])
    log(f"[bench] config 5 batch, v3 == v4 == plain bitwise over "
        f"{res['c5_kernel']['blocks']} blocks: {res['c5_kernel']}")
    del engine, qb, keep
    torch.cuda.empty_cache()
    c2 = run("config2_cluster", B.bench_cluster, rng,
             n_docs=BENCH_CLUSTER_DOCS, n_queries=BENCH_CLUSTER_QUERIES)
    c2g = run("config2_gpu_worker", B.bench_cluster_gpu, rng,
              n_docs=BENCH_CLUSTER_DOCS, gpu_share=BENCH_CLUSTER_SHARE,
              n_queries=BENCH_CLUSTER_QUERIES, sweep=BENCH_CLUSTER_SWEEP,
              clients=BENCH_CLUSTER_SWEEP[0])

    result = {
        "metric": "config1_18k_fulltext_qps", "value": round(c1["qps"], 2),
        "unit": "queries/sec",
        "vs_baseline": round(c1["qps"] / c1["best_cpu_qps"], 2),
        "extra": {"config1_18k_fulltext": c1, "config5_5m_vocab": c5,
                  "realistic_text": rt, "config2_cluster": c2,
                  "config2_gpu_worker": c2g, "top_k": B.TOP_K},
        "device": B.card_info(), "lexicon": B.lexicon_info(),
        "wall_s": wall}
    path = os.path.join(work, "BENCH_DETAIL.json")
    os.environ["BENCH_OUT"] = path
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            B._emit_validated(result, {"config1_qps": c1["qps"],
                                       "c5_vocab_qps": c5["qps"],
                                       "realistic_qps": rt["qps"],
                                       "cluster_qps": c2["qps"],
                                       "c2g_qps": c2g["qps"]})
    finally:
        del os.environ["BENCH_OUT"]
    log(f"[bench] headline: {out.getvalue().strip()}")
    with open(path) as f:
        art = json.load(f)
    flags = _parity_flags(art)
    builds = art["kernel_builds_during_measurement"]
    if len(flags) != 2 or not all(f is True for f in flags) or builds:
        raise SystemExit(f"bench artifact: parity_checked {flags}, kernel "
                         f"builds in timed windows {builds}")
    res.update(artifact=art, launches=launches, headline=out.getvalue(),
               seconds=time.perf_counter() - t_phase)
    log(f"[bench] phase 10 took {res['seconds']:.1f}s")
    return res


# --------------------------------------------------------------------------
# phase 11: the root bench.py's other modes
# --------------------------------------------------------------------------

# each mode's main at a cut depth (the bench's sizes in comments); every
# gate of the mode holds inside its own function
MODE_CUTS = {
    "compute": dict(n_docs=5_000),             # 50,000
    "kernel": dict(seg_sweep=(4_000, 8_000, 16_000),   # 12.5k-50k docs,
                   mesh_sweep=(4_000, 8_000, 16_000),  # 500-doc batches,
                   batch_docs=300, commits=4),         # 8 commits
    "hybrid": dict(n_docs=2_000),              # 20,000
    "tier": dict(n_docs=120_000, phase_docs=5_000,     # 30M docs in 1M
                 budget_mb=1),                          # phases, 256 MB
    # each fleet mode boots a fleet of its own (~35-45 s): the overload's
    # autopilot fleet alone and the routers at 1 and 2, 500 docs (the
    # static fleet, 4 routers and 1,000 docs until the run passed its
    # time limit)
    "overload": dict(n_docs=500, phase_s=1.0, warm_s=0.5,     # 20,000,
                     static=False),                            # 12 s / 6 s
    "routers": dict(n_docs=500, warm_s=0.5, phase_s=1.0,      # 4,000, 5 s
                    counts=(1, 2)),                           # / 10 s, 1-4
    "replay": dict(n_docs=500, warm_s=0.5, capture_s=1.0),    # 8,000, 5 s
                                                               # / 12 s
}
MODE_ARTIFACTS = {"compute": "BENCH_r13.json", "kernel": "BENCH_r09.json",
                  "hybrid": "BENCH_r11.json", "tier": "BENCH_r12.json",
                  "overload": "OVERLOAD.json", "routers": "BENCH_r07.json",
                  "replay": "BENCH_r10.json"}


def _fleet_runs(mode: str, art: dict) -> list:
    """The fleet results of a fleet mode's artifact."""
    if mode == "overload":
        return [r for r in (art["extra"]["autopilot"],
                            art["extra"]["static_hand_tuned"]) if r]
    return [art["extra"]]


def heap_stalls() -> dict:
    """This process's cyclic-GC heap: the objects it tracks and the ms of
    two full collections in a row (the first also frees what earlier
    phases left in cycles; the second is what a full collection costs
    inside a window)."""
    import gc
    tracked = len(gc.get_objects())
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        gc.collect()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"tracked_objects": tracked, "full_collection_ms": ms}


def modes_phase(work: str, device=None, cuts: dict = MODE_CUTS) -> dict:
    """Phase 11: each of the root ``bench.py``'s other modes through its
    own ``tfidf_tpu_torch.bench_modes`` main at a cut depth, on the card;
    every gate asserted in the mode's function, every artifact through
    ``_emit_validated`` into ``work``, re-read: no kernel build inside a
    timed window, the kernel's variants bitwise the plain version, the
    fleet modes' card held by their serving nodes only (this process
    besides). The ELL launches are counted over the modes that launch the
    kernel: in this process (kernel, hybrid and the sweeps' engines) and
    in the fleet modes' workers (their ``/api/metrics``)."""
    import contextlib
    import gc
    import io

    from tfidf_tpu_torch import bench_modes as BM
    from tfidf_tpu_torch.ops import ell as E
    t_phase = time.perf_counter()
    res = {"wall_s": {}, "headline": {}, "heap": heap_stalls()}
    log(f"[modes] this process's heap before the modes: {res['heap']}")
    E.reset_launches()
    workers = 0
    for mode, kw in cuts.items():
        path = os.path.join(work, MODE_ARTIFACTS[mode])
        out = io.StringIO()
        t0 = time.perf_counter()
        # at this cut a tier phase ingests in a fraction of a second, so
        # one full collection of this process's heap (gigabytes of earlier
        # phases' objects) inside the last phase would read as ingest
        # decay: the cyclic collector is off while the tier mode runs
        if mode == "tier":
            gc.disable()
        os.environ["BENCH_OUT"] = path
        stalls0 = len(BM.CLIENT_STALLS)
        try:
            with contextlib.redirect_stdout(out):
                BM.MAINS[mode](device=device, **kw)
        finally:
            gc.enable()
            del os.environ["BENCH_OUT"]
        res["wall_s"][mode] = time.perf_counter() - t0
        if mode == "overload":
            res["overload_client_stalls"] = BM.CLIENT_STALLS[stalls0:]
        with open(path) as f:
            art = json.load(f)
        res[mode] = art
        res["headline"][mode] = out.getvalue().strip()
        if art["kernel_builds_during_measurement"]:
            raise SystemExit(f"modes: {mode}: kernel builds inside timed "
                             f"windows {art}")
        if mode == "kernel":
            for case in art["extra"]["kernel_scoring"]["cases"]:
                if not (case["v3_v4_bitwise_equal"]
                        and case["v4_plain_bitwise_equal"]):
                    raise SystemExit(f"modes: kernel case {case}")
        if mode in ("overload", "routers", "replay"):
            # each worker's launches were asserted in the mode; the card
            # count is None only off the card
            for run in _fleet_runs(mode, art):
                if device is None and run["card_processes"] is None:
                    raise SystemExit(f"modes: {mode}: no card process "
                                     f"count")
                workers += sum(run["worker_kernel_launches"])
        log(f"[modes] {mode}: {res['wall_s'][mode]:.1f}s "
            f"{res['headline'][mode]}")
    res["launches"] = {"v3": E.launches["v3"],
                       "v4": E.launches["v4"] + workers}
    res["launches_workers"] = workers
    res["max_abs_err"] = max(
        c["max_abs_delta_vs_plain"]
        for c in res["kernel"]["extra"]["kernel_scoring"]["cases"])
    log(f"[modes] ELL launches over the modes: {res['launches']} (of them "
        f"the fleet workers' v4 {workers})")
    if device is None and min(res["launches"].values()) == 0:
        raise SystemExit(f"modes: launches {res['launches']}")
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[modes] phase 11 took {res['seconds']:.1f}s")
    return res


def share_bytecode(work: str) -> subprocess.Popen:
    """One bytecode cache, under ``work``, for every process the run
    starts from here on (the fleets of phases 7, 10 and 11). The card's
    image sets ``PYTHONDONTWRITEBYTECODE`` and ships no ``__pycache__``,
    so each ``python -m tfidf_tpu_torch`` process compiled torch from
    source: ``import torch`` took 6.3-7.0 s there, 4.5-5.4 s reading a
    cache (``probe_import_torch.py``), of a node's 8-17 s boot (the boot
    split, phase 7). A child started now imports what a node imports and
    writes the cache while phases 5-9 run; the caller waits for it before
    the fleet."""
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(
        os.path.abspath(work), "pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    return subprocess.Popen(
        [sys.executable, "-c", "import tfidf_tpu_torch.cli, "
         "tfidf_tpu_torch.cluster.node, tfidf_tpu_torch.cluster.router, "
         "tfidf_tpu_torch.bench_modes"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--docs", type=int, default=NS_DOCS,
                    help="corpus size (cut only if the time limit forces)")
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"))
    ap.add_argument("--work", default=os.path.join("build",
                                                   "chip_smoke_work"),
                    help="scratch dir for the checkpoint and documents "
                         "(removed at the end)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs one card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    from tfidf_tpu_torch import kernels

    # ---- phase 1: device + build ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")
    if args.docs != NS_DOCS:
        log(f"[device] CORPUS CUT: --docs {args.docs} (north star is "
            f"{NS_DOCS})")
    phase_s = {}
    t_mark = [t_start]

    def done(name: str) -> None:
        """Close phase ``name``: its wall seconds since the last close."""
        now = time.perf_counter()
        phase_s[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"[phase] {name} {phase_s[name]:.1f}s")

    t0 = time.perf_counter()
    # phase 3's corpus is drawn on the host while nvcc builds the kernels
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(kernels.build_all)
        drawn = draw_corpus(args.seed, args.docs)
        info = building.result()
    log(f"[build] {time.perf_counter() - t0:.2f}s: " + "; ".join(
        f"{n}: {v['seconds']:.2f}s" for n, v in info.items()))
    for n, v in info.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {n}: {line.strip()}")

    done("1")
    # ---- phase 2: kernels against their plain versions ----
    cases = kernel_cases(args.seed)
    topk = topk_cases(args.seed)
    done("2")
    # ---- phase 3: the main path ----
    main_res, ctx = main_path(args.seed, drawn)
    del drawn
    done("3")
    # ---- phase 3d: the dense plane ----
    dense = dense_phase(ctx, args.seed)
    done("3d")
    # ---- phase 12: the device witness, on phase 3's engine ----
    witness = witness_phase(ctx, args.seed)
    done("12")
    print(json.dumps({"witness": {
        k: witness[k] for k in ("window_s", "batches", "launches",
                                "builds_after_warmup", "observations",
                                "syncs_per_batch", "transfers_per_batch",
                                "h2d_blocking_per_batch")}}), flush=True)
    # ---- phase 4: the text path ----
    text = text_path()
    done("4")
    # ---- phases 5-6: the worker engine, the durable text path ----
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    warm = share_bytecode(args.work)
    try:
        worker = {"checkpoint": checkpoint_phase(ctx, main_res, args.work)}
        worker["compute"] = compute_phase(ctx)
        done("5")
        # the fleet's two shard checkpoints, from phase 3's corpus
        data = {"corpus": ctx["corpus"], "rows": ctx["rows"],
                "queries": ctx["served"], "hits": ctx["hits"]}
        del ctx
        torch.cuda.empty_cache()
        shards = fleet_shards(data, args.work)
        done("7 shards")
        durable = durable_phase(args.seed, args.work)
        torch.cuda.empty_cache()
        done("6")
        # ---- phase 8: streaming segments and tiering ----
        streaming = streaming_phases(data, args.seed, args.work)
        streaming["scorer"]["ell_v4_ms_main_path"] = \
            main_res["kernel"]["v4_ms"]
        log(f"[stream] the segment scorer's {streaming['scorer']['ms']:.2f}"
            f" ms against the ELL kernel's {main_res['kernel']['v4_ms']:.2f}"
            f" ms on the same corpus (phase 3, precomputed impacts)")
        torch.cuda.empty_cache()
        done("8")
        # ---- phase 9: the mesh ----
        mesh = mesh_phases(data, args.seed)
        done("9")
        # ---- phase 7: the fleet, one process per node ----
        if warm.wait(timeout=600) != 0:
            raise SystemExit(f"bytecode warm-up exited {warm.returncode}")
        fleet = fleet_phase(data, shards, args.seed, args.work, args.out)
        del data, shards
        torch.cuda.empty_cache()
        done("7+13")
        # ---- phase 10: the bench's configs ----
        bench = bench_phase(args.seed, args.work)
        torch.cuda.empty_cache()
        done("10")
        # ---- phase 11: the bench's other modes ----
        modes = modes_phase(args.work)
        done("11")
    finally:
        if warm.poll() is None:
            warm.kill()
            warm.wait()
        shutil.rmtree(args.work, ignore_errors=True)
    print(json.dumps({"phase_s": phase_s}), flush=True)

    kt = main_res["kernel"]
    line = {"kernels": [
        {"name": f"ell_score_{a}", "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[a], "launches": main_res["launches"][a],
         "launches_mesh": mesh["ell"]["launches"][a],
         "launches_bench": bench["launches"][a],
         "launches_modes": modes["launches"][a],
         "launches_witness": witness["launches"][a],
         "launches_chaos": fleet["chaos"]["launches"][a],
         "max_abs_err": max(cases["max_abs_err"], kt["max_abs_err"],
                            mesh["ell"]["kernel"]["max_abs_err"],
                            bench["c5_kernel"]["max_abs_err"],
                            modes["max_abs_err"]),
         "bitwise": True,   # every case and block was held to equality
         "ms": kt[f"{a}_ms"], "kernel_ms": kt[f"{a}_ms"],
         "plain_ms": kt["plain_ms"],
         "bound_ms": kt["bound_ms"], "bound_by": kt["bound_by"],
         "library_ms": kt["library_ms"]}
        for a in ("v4", "v3")]}
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi, "kind": kind, "cases": cases,
                   "topk": topk,
                   "main": main_res, "dense": dense, "text": text,
                   "worker": worker,
                   "durable": durable, "streaming": streaming,
                   "mesh": mesh, "fleet": fleet, "bench": bench,
                   "modes": modes, "witness": witness,
                   "build": {n: v["seconds"] for n, v in info.items()},
                   "phase_s": phase_s,
                   "seconds": time.perf_counter() - t_start}, f, indent=1,
                  default=str)
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
