#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``tfidf_tpu_torch``).

    python3 chip_smoke.py [--seed 0] [--docs 1000000] [--out DIR]

Needs one CUDA card; exits non-zero without one, and without the package
beside it. Phases (any failure fails the run):

1. device: the card's name and power limit; build every CUDA kernel from
   ``tfidf_tpu_torch/csrc`` (one nvcc per source, started together);
2. kernels against their plain PyTorch versions on the card, over a case
   matrix made from ``--seed``: variants v3 == v4 == plain, bitwise, and
   identical top-10; then ``packed_topk_chunked`` on the card against a
   numpy lexsort on tie-heavy cases (clamped tail, signed scores, ids
   past 2^23): ids identical, values equal to the bit;
3. the main path at the north-star size (BASELINE config 3: 1M docs,
   500k vocab, Zipf 1.25, avg length 120, batch 512, top-10): bulk load,
   commit, serve batches through ``Engine.search_batch`` and
   ``Engine.search_batch_arrays`` with the launch counts reset just
   before and read just after; top-10 against a scipy CSR oracle, with
   the returned order held to the tie rule (scores never rise, equal
   scores in ascending row order); q/s, commit time, device memory,
   per-phase ms, and one batch's top-k against a numpy lexsort of its own
   f32 scores; then the same for the v3 variant on its own;
4. the text path: the five-document corpus through ``ingest_text``.

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
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores

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
               ragged=False):
    """Random ELL block with DISTINCT term ids per row (position w draws
    from the class w mod width), pad rows zeroed like the real build,
    optional within-row trailing pads, and a query batch that hits it."""
    from tfidf_tpu_torch.ops.scoring import make_query_batch
    slots = max(vocab // width, 1)
    base = rng.integers(0, slots, size=(rows_cap, width))
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
        for j in range(min(k, 1 + i % 2) if i % 4 else 0):
            ids[j] = term[rng.integers(0, max(n_rows, 1)),
                          rng.integers(0, width)]
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
    # a batch that is not a multiple of the kernel's query tile
    dict(rows_cap=512, width=24, n_rows=500, B=3, u_req=256),
    # north-star shapes: width 128 and 64 at B=512
    dict(rows_cap=131072, width=128, n_rows=98000, B=512, u_req=512),
    dict(rows_cap=262144, width=64, n_rows=250000, B=512, u_req=512),
]


def block_work(imp_t, term_t, slot_of, qc_t, n_rows):
    """(bytes, f32 ops) one block launch needs for these inputs: live
    postings read once, slot_of and qc_t read once, scores written once;
    two ops (multiply, add) per query per posting that hits a query
    term."""
    W, rows_cap = imp_t.shape
    u1, B = qc_t.shape
    live_terms = term_t[:, :n_rows].long()
    hits = int((slot_of[live_terms] != u1 - 1).sum())
    nbytes = (8 * W * n_rows + 4 * slot_of.numel() + 4 * u1 * B
              + 4 * B * rows_cap)
    return nbytes, 2 * B * hits


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


def kernel_cases(seed: int) -> dict:
    """Phase 2: every case, both variants and the plain version on the
    same inputs. Bitwise equality is required; top-10 must match."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    rng = np.random.default_rng(seed)
    worst = 0.0
    rows = []
    for i, case in enumerate(CASES):
        vocab = case.get("vocab", NS_VOCAB)
        imp, term, qb = make_block(rng, **dict(case, vocab=vocab))
        B, n_rows = case["B"], case["n_rows"]
        assert E._pallas_eligible(case["rows_cap"], B, qb.uniq.shape[0])
        slot_of, qc_ext = _compile_queries(qb, vocab)
        qc_t = qc_ext.T.contiguous()
        imp_t = torch.from_numpy(np.ascontiguousarray(imp.T)).cuda()
        term_t = torch.from_numpy(np.ascontiguousarray(term.T)).cuda()
        outs = {a: E.score_block_kernel(imp_t, term_t, slot_of, qc_t,
                                        n_rows, a_build=a)
                for a in E.A_BUILD_VARIANTS}
        plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, n_rows)
        sync()
        v3_v4 = torch.equal(outs["v3"], outs["v4"])
        err = float((outs["v4"] - plain).abs().max())
        bitwise = v3_v4 and torch.equal(outs["v4"], plain)
        k = min(TOP_K, n_rows)
        top_same = torch.equal(
            torch.topk(outs["v4"][:, :n_rows], k).values,
            torch.topk(plain[:, :n_rows], k).values)
        hits = int((outs["v4"] > 0).sum())
        rows.append(dict(case=i, **case, bitwise=bitwise,
                         max_abs_err=err, top10_identical=top_same,
                         nonzero_scores=hits))
        log(f"[kernel] case {i} {case}: v3==v4 {v3_v4} bitwise {bitwise} "
            f"max|d| {err:.3e} top10 {top_same} nonzero {hits}")
        if not (bitwise and top_same and hits > 0):
            raise SystemExit(f"kernel case {i} disagrees with the plain "
                             f"version: {rows[-1]}")
        worst = max(worst, err)
        del outs, plain
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


def eligible_blocks(snap, B: int) -> int:
    from tfidf_tpu_torch.ops.ell import _pallas_eligible
    # u_cap is a power of two >= 256 for every batch, so it never decides
    return sum(_pallas_eligible(i.shape[0], B, 256) for i in snap.ell_impacts)


def drive(engine, queries, chunks_arrays) -> tuple:
    """The served run: one search_batch over NS_BATCHES chunks and one
    search_batch_arrays chunk. Returns (hits, arrays, seconds)."""
    sync()
    t0 = time.perf_counter()
    hits = engine.search_batch(queries[:NS_BATCHES * NS_BATCH], k=TOP_K)
    arrays = engine.search_batch_arrays(chunks_arrays, k=TOP_K)
    sync()
    return hits, arrays, time.perf_counter() - t0


def phase_breakdown(engine, queries) -> tuple:
    """Per-phase ms of one batch, each phase closed by a synchronize,
    then its top-k checked against numpy on the first ``TOPK_ROWS``
    queries; returns (ms by phase, the batch's QueryBatch, tied ranks)."""
    from tfidf_tpu_torch.ops.ell import score_ell_batch
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
        snap.ell_terms_t, snap.ell_live, snap.ell_index, snap.res_tf,
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
    # the served top-k of this batch's own f32 scores, held to numpy
    tied = check_topk(scores[:TOPK_ROWS].cpu().numpy(), packed[:TOPK_ROWS],
                      snap.num_docs, TOP_K, "main-path topk")
    log(f"[main] top-{TOP_K} of {TOPK_ROWS} served rows identical to numpy "
        f"lexsort over the engine's f32 scores, {tied} tied ranks")
    return ms, qb, tied


def main_path_kernel_times(engine, qb) -> dict:
    """Per-batch device times over the main path's own blocks and batch:
    every eligible block through each variant, the plain version and one
    library call (torch.sparse.mm of the block as CSR), plus the bound.
    Checks kernel == plain bitwise on every block."""
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.ops.scoring import _compile_queries
    snap = engine.index.snapshot
    slot_of, qc_ext = _compile_queries(qb, snap.df.shape[0])
    qc_t = qc_ext.T.contiguous()
    u1, B = qc_t.shape
    blocks = [(snap.ell_impacts_t[i], snap.ell_terms_t[i], snap.ell_live[i])
              for i, imp in enumerate(snap.ell_impacts)
              if E._pallas_eligible(imp.shape[0], B, u1 - 1)]
    res = {"blocks": len(blocks), "bytes": 0, "ops": 0, "max_abs_err": 0.0}
    for imp_t, term_t, n in blocks:
        nbytes, ops = block_work(imp_t, term_t, slot_of, qc_t, n)
        res["bytes"] += nbytes
        res["ops"] += ops
        plain = E.score_block_plain(imp_t, term_t, slot_of, qc_t, n)
        for a in E.A_BUILD_VARIANTS:
            out = E.score_block_kernel(imp_t, term_t, slot_of, qc_t, n,
                                       a_build=a)
            if not torch.equal(out, plain):
                err = float((out - plain).abs().max())
                raise SystemExit(f"main-path block {tuple(imp_t.shape)} "
                                 f"{a}: kernel != plain (max|d| {err})")
            del out
        del plain

    def all_blocks(fn):
        return lambda: [fn(*blk) for blk in blocks]

    for a in E.A_BUILD_VARIANTS:
        res[f"{a}_ms"] = cuda_ms(all_blocks(
            lambda it, tt, n, a=a: E.score_block_kernel(
                it, tt, slot_of, qc_t, n, a_build=a)), reps=5)
    res["plain_ms"] = cuda_ms(all_blocks(
        lambda it, tt, n: E.score_block_plain(it, tt, slot_of, qc_t, n)),
        reps=2)
    mats = [library_operand(it, tt, slot_of, u1, n) for it, tt, n in blocks]
    res["library_ms"] = cuda_ms(
        lambda: [torch.sparse.mm(A, qc_t) for A in mats], reps=5)
    del mats
    t_bytes = res["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = res["ops"] / F32_FLOP_PER_S * 1e3
    res["bound_ms"] = max(t_bytes, t_ops)
    res["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
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
    engine = Engine(Config(query_batch=NS_BATCH, embedding_enabled=False,
                           use_pallas=True, kernel_a_build="v4"))
    assert engine.device.type == "cuda"
    engine.vocab.extend(f"t{i}" for i in range(NS_VOCAB))
    t0 = time.perf_counter()
    engine.index.bulk_load_packed([f"d{i}" for i in range(n_docs)],
                                  offsets, ids, tfs, lengths)
    load_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    engine.commit()
    sync()
    commit_s = time.perf_counter() - t0
    snap = engine.index.snapshot
    shapes = [tuple(i.shape) for i in snap.ell_impacts]
    log(f"[main] bulk load {load_s:.1f}s, commit {commit_s:.1f}s, "
        f"blocks {shapes}, residual {snap.res_tf is not None}")

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
    want = eligible_blocks(snap, NS_BATCH) * chunks
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
    ktimes = main_path_kernel_times(engine, qb)
    log(f"[main] per-batch kernel times: {ktimes}")
    return {"docs": n_docs, "nnz": int(ids.shape[0]), "blocks": shapes,
            "bulk_load_s": load_s, "commit_s": commit_s, "qps_v4": qps,
            "qps_v3": chunks * NS_BATCH / secs_v3,
            "launches": {"v4": counts["v4"], "v3": counts_v3["v3"]},
            "expected_launches": want, "memory": mem,
            "phase_ms": breakdown, "oracle": oracle,
            "topk_tied_ranks": tied, "kernel": ktimes}


def text_path() -> dict:
    """Phase 4: the five-document corpus through ingest_text on the card;
    the JAX tests' expectations plus an inline BM25 oracle."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.ops import ell as E
    from tfidf_tpu_torch.utils.config import Config
    with tempfile.TemporaryDirectory() as tmp:
        e = Engine(Config(documents_path=tmp, index_path=tmp,
                          embedding_enabled=False))
        for name, text in CORPUS.items():
            e.ingest_text(name, text)
        e.commit()
        E.reset_launches()
        hits = e.search("fast food", k=5)
        launched = E.launches["v4"]
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
    return {"hits": names, "launches": launched}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--docs", type=int, default=NS_DOCS,
                    help="corpus size (cut only if the time limit forces)")
    ap.add_argument("--out", default=os.path.join("build", "chip_smoke"))
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
    main_res = main_path(args.seed, args.docs)
    # ---- phase 4: the text path ----
    text = text_path()

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
                   "main": main_res, "text": text,
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
