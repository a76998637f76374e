#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tfidf_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1000000] [--out DIR]

Needs one CUDA card; exits non-zero without one, and without the package
beside it. Phases (any failure fails the run):

1. device: the card's name and power limit; build every CUDA kernel from
   ``tfidf_tpu_torch/csrc`` (one nvcc per source, started together);
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
6. the durable text path: 20,000 generated ASCII documents through
   ``stage_bytes`` -> group fsync -> ``publish_staged`` (native tokenizer
   for every one, dense plane off), then ``build_from_directory`` with
   the dense plane on in a fresh engine (the Python analyzer; every
   document embedded through the upsert path): identical sparse hits on
   64 queries, and their dense top-10 against a numpy f64 brute force.

After every phase with nothing armed, each engine's compute health must
be healthy with no new fault and no fallback-served request.

Then one ``{"kernels": [...]}`` line (per kernel: launches on its path,
max abs error against the plain version, kernel / plain / library ms per
main-path batch and the bound), and as the last line
``{"ok": true, "device": {...}}``. The full record of the run goes to
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

def make_doc_arrays(rng, n_docs: int, vocab: int, avg_len: int):
    """Zipf(1.25) corpus as per-doc sorted (ids, tfs) slices: (offsets
    [n+1], ids [nnz], tfs [nnz], lengths [n]) — the synthesis of
    bench.py's north-star config, with one combined sort key."""
    lengths = np.clip(rng.poisson(avg_len, n_docs), 5, None).astype(np.int64)
    total = int(lengths.sum())
    terms = (rng.zipf(1.25, size=total) % vocab).astype(np.int64)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lengths)
    key = doc_of * vocab + terms
    key.sort()
    first = np.ones(total, bool)
    first[1:] = key[1:] != key[:-1]
    idx = np.flatnonzero(first)
    counts = np.diff(np.append(idx, total))
    ud, ut = key[idx] // vocab, key[idx] % vocab
    offsets = np.searchsorted(ud, np.arange(n_docs + 1))
    return (offsets, ut.astype(np.int32), counts.astype(np.float32),
            lengths.astype(np.float32))


def make_queries(rng, vocab: int, n: int) -> list[str]:
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        ids = rng.zipf(1.25, size=k) % vocab
        out.append(" ".join(f"t{w}" for w in ids))
    return out


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


def oracle_check(corpus, queries, hits, vocab: int, doc_names) -> dict:
    """Top-10 of the port against a scipy CSR oracle with independently
    computed f64 BM25 impacts. Equal scores rank by the engine's row order
    (``doc_names``, the commit layout), as the engine breaks ties. Ids
    must be identical, except inside a tie group — oracle scores within
    1e-6 relative — where the f32 sum (its association follows each
    row's term positions) decides the order; such swaps pass and are
    counted. Scores within 1e-5 relative."""
    import scipy.sparse as sp
    offsets, ids, tfs, lengths = corpus
    n_docs = offsets.shape[0] - 1
    row = np.repeat(np.arange(n_docs), np.diff(offsets))
    df = np.bincount(ids, minlength=vocab).astype(np.float64)
    avgdl = lengths.astype(np.float64).mean()
    k1, b = 1.2, 0.75
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
    imp = idf[ids] * tfs / (tfs + k1 * (1 - b + b * lengths[row] / avgdl))
    M = sp.csr_matrix((imp, (row, ids.astype(np.int64))),
                      shape=(n_docs, vocab))
    qrows, qcols, qvals = [], [], []
    for i, q in enumerate(queries):
        terms, counts = np.unique([int(t[1:]) for t in q.split()],
                                  return_counts=True)
        qrows += [i] * len(terms)
        qcols += terms.tolist()
        qvals += counts.astype(np.float64).tolist()
    Q = sp.csr_matrix((qvals, (qrows, qcols)), shape=(len(queries), vocab))
    S = (Q @ M.T).toarray()
    row_of = np.empty(n_docs, np.int64)
    row_of[[int(n[1:]) for n in doc_names]] = np.arange(n_docs)
    swaps = {"exact_f64_tie": 0, "near_tie": 0}
    for i, got in enumerate(hits):
        s = S[i]
        order = np.lexsort((row_of, -s))[:TOP_K]
        order = order[s[order] > 0]
        got_ids = np.asarray([int(h.name[1:]) for h in got])
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
                                 f"d{got_ids[r]} ({a}) vs oracle "
                                 f"d{order[r]} ({c})")
            swaps["exact_f64_tie" if a == c else "near_tie"] += 1
    ranks = sum(len(h) for h in hits)
    return {"queries": len(hits), "ranks": ranks,
            "ids_identical": ranks - sum(swaps.values()), "swaps": swaps}


def drive(engine, queries, chunks_arrays) -> tuple:
    """The served run: one search_batch over NS_BATCHES chunks and one
    search_batch_arrays chunk. Returns (hits, arrays, seconds)."""
    sync()
    t0 = time.perf_counter()
    hits = engine.search_batch(queries[:NS_BATCHES * NS_BATCH], k=TOP_K)
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

    out = torch.empty_like(scores)
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
    # the served top-k of this batch's own f32 scores, held to numpy
    tied = check_topk(scores[:TOPK_ROWS].cpu().numpy(), packed[:TOPK_ROWS],
                      snap.num_docs, TOP_K, "main-path topk")
    log(f"[main] top-{TOP_K} of {TOPK_ROWS} served rows identical to numpy "
        f"lexsort over the engine's f32 scores, {tied} tied ranks")
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


def main_path_kernel_times(engine, qb) -> dict:
    """Per-batch device times over the main path's own blocks and batch:
    every eligible block through each variant, straight into one
    ``[B, doc_cap]`` real-doc tensor at its row offset; the plain version
    and one library call (torch.sparse.mm of the block as CSR); the
    bound. Checks first, for each variant, that ``score_ell_impl``'s
    real-doc scores equal the plain blocks concatenated and gathered by
    ``_rearrange_to_real`` (the reference's rearrange), bit for bit."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    snap = engine.index.snapshot
    vocab_cap, doc_cap = snap.df.shape[0], snap.doc_len.shape[0]
    slot_of, qc_ext = _compile_queries(qb, vocab_cap)
    qc_t = qc_ext.T.contiguous()
    u1, B = qc_t.shape
    blocks = main_path_blocks(snap, B, u1 - 1)

    index = torch.from_numpy(E.real_index(
        [i.shape[0] for i in snap.ell_impacts], snap.ell_live,
        doc_cap)).cuda()
    ref = E._rearrange_to_real(
        [E.score_block_plain(it, tt, slot_of, qc_t, n) for it, tt, n in
         zip(snap.ell_impacts_t, snap.ell_terms_t, snap.ell_live)],
        index, B, qc_t.device)
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
    del ref, index

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
    res["plain_ms"] = cuda_ms(
        lambda: [E.score_block_plain(it, tt, slot_of, qc_t, n)
                 for it, tt, n, _ in blocks], reps=2)
    mats = [library_operand(it, tt, slot_of, u1, n)
            for it, tt, n, _ in blocks]
    res["library_ms"] = cuda_ms(
        lambda: [torch.sparse.mm(A, qc_t) for A in mats], reps=5)
    del mats
    return res


def main_path(seed: int, n_docs: int) -> dict:
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.config import Config
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    corpus = make_doc_arrays(rng, n_docs, NS_VOCAB, NS_AVG_LEN)
    offsets, ids, tfs, lengths = corpus
    log(f"[main] corpus {n_docs} docs nnz={ids.shape[0]} in "
        f"{time.perf_counter() - t0:.1f}s")
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
           "queries": queries, "rows": rows}
    return res, ctx


# --------------------------------------------------------------------------
# phase 3d: the dense plane at the north star
# --------------------------------------------------------------------------

def dense_oracle(engine, queries, hits, rows, names) -> dict:
    """Dense top-10 of ``queries`` against a numpy f64 brute force over
    ``rows`` (f32 ``[n, dim]``, row i = ``names[i]``), ties in the
    column's row order (sorted names). The served order must keep the tie
    rule; ids identical except inside a group whose f64 scores are within
    1e-6 (an ulp of the f32 product decides there), such swaps counted;
    scores within 1e-6 + 1e-5 |s| of the f64 score of the doc named."""
    slot = engine.dense._slot
    tie = np.fromiter((slot[n] for n in names), np.int64, len(names))
    pos = {n: i for i, n in enumerate(names)}
    rows64 = rows.astype(np.float64)
    emb = engine.dense.embedder
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


def dense_bits(engine, batch) -> dict:
    """On the first 8 queries of ``batch``: the served top-k against the
    one-shot top-k from the same chunk products (bitwise, required),
    against one full-column matmul and against chunks of 2^12 rows; the
    8 queries alone (B=8) against inside the 512-query batch; the batch
    run twice (all recorded)."""
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
                big, served(q512), q64, host, "twice")}


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


def durable_phase(seed: int, work: str) -> dict:
    """Phase 6: the durable upload path with the native tokenizer, then
    a rebuild of the same documents dir through the Python analyzer."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.analyzer import extract_text
    from tfidf_tpu_torch.utils import storage
    from tfidf_tpu_torch.utils.config import Config
    rng = np.random.default_rng(seed + 6)
    n_docs = 20_000
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
    t0 = time.perf_counter()
    info = kernels.build_all()
    log(f"[build] {time.perf_counter() - t0:.2f}s: " + "; ".join(
        f"{n}: {v['seconds']:.2f}s" for n, v in info.items()))
    for n, v in info.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {n}: {line.strip()}")

    # ---- phase 2: kernels against their plain versions ----
    cases = kernel_cases(args.seed)
    topk = topk_cases(args.seed)
    # ---- phase 3: the main path ----
    main_res, ctx = main_path(args.seed, args.docs)
    # ---- phase 3d: the dense plane ----
    dense = dense_phase(ctx, args.seed)
    # ---- phase 4: the text path ----
    text = text_path()
    # ---- phases 5-6: the worker engine, the durable text path ----
    shutil.rmtree(args.work, ignore_errors=True)
    os.makedirs(args.work)
    try:
        worker = {"checkpoint": checkpoint_phase(ctx, main_res, args.work)}
        worker["compute"] = compute_phase(ctx)
        del ctx
        durable = durable_phase(args.seed, args.work)
    finally:
        shutil.rmtree(args.work, ignore_errors=True)

    kt = main_res["kernel"]
    line = {"kernels": [
        {"name": f"ell_score_{a}", "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[a], "launches": main_res["launches"][a],
         "max_abs_err": max(cases["max_abs_err"], kt["max_abs_err"]),
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
                   "durable": durable,
                   "build": {n: v["seconds"] for n, v in info.items()},
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
