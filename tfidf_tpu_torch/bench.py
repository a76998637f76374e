"""Benchmark: the BASELINE.md configs on the CUDA card.

    python -m tfidf_tpu_torch bench        # or: python -m tfidf_tpu_torch.bench
    python -m tfidf_tpu_torch bench --<mode>    # the seven other modes

The port of the repository's root ``bench.py`` ``main()`` and everything
it reaches, with the same function names, constants, corpora and gates:

* **config 3 (primary, north star)**: 1M docs / 500k vocab, batched
  top-10 over a Zipfian corpus synthesized as sorted (term id, tf) arrays
  and ingested through ``add_document_arrays``;
* **config 1**: 18k docs / 60k vocab through the full text pipeline;
* **config 4 (shape)**: streaming ingest in ``index_mode="segments"``,
  a commit every 10k docs, then a quiesce;
* **mesh**: ``engine_mode="mesh"`` on the default mesh (every visible
  card on the docs axis; one card here);
* **config 5**: 200k docs over a 5M-term vocabulary;
* **realistic text**: 100k documents from a real-English lexicon
  (``utils/textgen.py``) through the extractors and the analyzer, with
  the binary payloads refused (415);
* **config 2**: a coordinator, a leader and two workers as
  ``python -m tfidf_tpu_torch`` processes, 100k docs uploaded over HTTP;
* **config 2 on the card**: the phased realistic upload, the client
  sweep, direct ``/worker/process`` and the leader-vs-direct parity gate.

Every node process runs on the card (the CLI's default). The CPU
baselines are scipy CSR and torch sparse CSR on the host, as in the JAX
bench. Every oracle gate is asserted before the artifact is written: a
failed gate exits non-zero and writes nothing.

Emission is artifact-first: the full result is written to ``BENCH_OUT``
(default ``build/bench/BENCH_DETAIL.json`` beside the package), fsynced
and re-read; stdout then gets one compact line with ``metric``,
``value``, ``unit``, ``vs_baseline``, ``detail_file`` and ``headline``.
Human-readable detail goes to stderr.

Each config function takes its sizes and ``device`` as keyword arguments
(the module constants, and the card, by default); ``main()`` passes
nothing. ``device="cpu"`` runs every kernel's plain PyTorch version.

The root ``bench.py``'s other modes (``--overload``, ``--replay``,
``--routers``, ``--kernel``, ``--hybrid``, ``--tier``, ``--compute``) are
in ``tfidf_tpu_torch/bench_modes.py``; :func:`run` dispatches to them.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = 0
TOP_K = 10

# config 3 — the north star
NS_DOCS = 1_000_000
NS_VOCAB = 500_000
NS_AVG_LEN = 120
NS_BATCH = 512
NS_BATCHES = 4
NS_CPU_BATCH = 32
NS_CPU_BATCHES = 2

# config 1 — full text pipeline
C1_DOCS = 18_000
C1_VOCAB = 60_000
C1_AVG_LEN = 150
C1_BATCH = 4096     # chunk size; chunks pipeline inside one call
C1_BATCHES = 8

# config 4 shape — streaming segments
ST_DOCS = 1_000_000
ST_COMMIT_EVERY = 10_000
ST_AVG_LEN = 100

# mesh serving path (engine_mode="mesh")
MESH_DOCS = 50_000
MESH_BATCH = 512
MESH_BATCHES = 2


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# --------------------------------------------------------------------------
# kernel-build accounting over timed windows: every artifact stamps
# `kernel_builds_during_measurement`, the nvcc builds that landed inside a
# timed window (warm-up excluded: it runs before the window opens). The
# port compiles nothing else at first use (no torch.compile), so a build
# inside a steady-state serving window means the warm-up no longer reaches
# the served kernels, and the bench fails instead of publishing a number
# with a compile in it.
# --------------------------------------------------------------------------

_WINDOW_BUILDS = {"n": 0}


class _measured_window:
    def __init__(self, what: str, steady_state: bool = False) -> None:
        self.what = what
        self.steady_state = steady_state

    def __enter__(self) -> "_measured_window":
        from tfidf_tpu_torch import kernels
        self._count = kernels.build_count
        self._before = self._count()
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is not None:
            return
        delta = self._count() - self._before
        _WINDOW_BUILDS["n"] += delta
        if delta:
            log(f"[build] {delta} kernel build(s) inside timed window "
                f"{self.what!r}")
        if self.steady_state and delta:
            print(f"BENCH SELF-VALIDATION FAILED: {delta} kernel "
                  f"build(s) inside steady-state serving window "
                  f"{self.what!r}: the warm-up no longer reaches the "
                  f"served kernels", file=sys.stderr)
            sys.exit(1)


# --------------------------------------------------------------------------
# corpus synthesis (the same draws from the same rng as bench.py)
# --------------------------------------------------------------------------

def make_doc_arrays(rng, n_docs: int, vocab: int, avg_len: int):
    """Vectorized Zipfian corpus as per-doc sorted (ids, tfs) slices.

    Returns (offsets [n+1], ids [nnz], tfs [nnz], lengths [n]) where doc i
    owns ids[offsets[i]:offsets[i+1]] sorted ascending — the
    ``add_document_arrays`` contract. One combined (doc, term) sort key
    gives the same arrays as a lexsort of the two."""
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


def make_texts(rng, n_docs: int, vocab: int, avg_len: int) -> list[str]:
    """Raw-text corpus (exercises the full analyzer/vocab ingest)."""
    zipf = rng.zipf(1.25, size=n_docs * avg_len) % vocab
    lengths = np.clip(rng.poisson(avg_len, n_docs), 10, None)
    lengths = (lengths * (zipf.shape[0] / lengths.sum())).astype(np.int64)
    texts = []
    pos = 0
    for n in lengths:
        ids = zipf[pos:pos + n]
        pos += n
        texts.append(" ".join(f"t{w}" for w in ids))
    return texts


def make_queries(rng, vocab: int, n: int) -> list[str]:
    out = []
    for _ in range(n):
        k = int(rng.integers(2, 5))
        ids = rng.zipf(1.25, size=k) % vocab
        out.append(" ".join(f"t{w}" for w in ids))
    return out


def _engine(device, **cfg):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config
    return Engine(Config(**cfg), device=device)


# --------------------------------------------------------------------------
# config 3: north star — 1M docs / 500k vocab
# --------------------------------------------------------------------------

def bench_north_star(rng, corpus=None, *, n_docs: int = NS_DOCS,
                     vocab: int = NS_VOCAB, avg_len: int = NS_AVG_LEN,
                     batch: int = NS_BATCH, batches: int = NS_BATCHES,
                     cpu_batch: int = NS_CPU_BATCH,
                     cpu_batches: int = NS_CPU_BATCHES,
                     device=None) -> dict:
    t0 = time.perf_counter()
    offsets, ids, tfs, lengths = corpus if corpus is not None else \
        make_doc_arrays(rng, n_docs, vocab, avg_len)
    nnz = ids.shape[0]
    log(f"[ns] corpus: {n_docs} docs, nnz={nnz}, "
        f"gen {time.perf_counter()-t0:.1f}s")

    engine = _engine(device, query_batch=batch)
    t0 = time.perf_counter()
    for i in range(vocab):
        engine.vocab.add(f"t{i}")
    log(f"[ns] vocab registered in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    add = engine.index.add_document_arrays
    for i in range(n_docs):
        lo, hi = offsets[i], offsets[i + 1]
        add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
    ingest_s = time.perf_counter() - t0
    log(f"[ns] indexed {n_docs} docs in {ingest_s:.1f}s "
        f"({n_docs/ingest_s:.0f} docs/s, direct arrays)")

    t0 = time.perf_counter()
    engine.commit()
    commit_s = time.perf_counter() - t0
    log(f"[ns] commit (COO->blocked ELL->device): {commit_s:.1f}s")

    queries = make_queries(rng, vocab, batch * (batches + 2))
    # warmup: 2 distinct batches (first launches + the u_cap floor)
    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_batch(queries[batch:2 * batch], k=TOP_K)
    # ONE call over `batches` chunks: the searcher pipelines chunk i+1's
    # device work under chunk i's fetch + hit assembly
    timed = queries[2 * batch:(batches + 2) * batch]
    with _measured_window("ns-serving", steady_state=True):
        t0 = time.perf_counter()
        engine.search_batch(timed, k=TOP_K)
        qps = len(timed) / (time.perf_counter() - t0)
    log(f"[ns] {len(timed)} queries -> {qps:.1f} q/s "
        f"(batch={batch}, pipelined)")

    parity_checked = oracle_topk_parity(engine, offsets, ids, tfs,
                                        lengths, queries[:256], vocab)

    cpu = cpu_baselines(offsets, ids, tfs, lengths, queries, vocab,
                        n_batches=cpu_batches, batch=cpu_batch,
                        numpy_loop=False)
    return {"qps": qps, "ingest_dps": n_docs / ingest_s,
            "commit_s": commit_s, "nnz": int(nnz),
            "parity_checked": parity_checked, **cpu}


def oracle_topk_parity(engine, offsets, ids, tfs, lengths, queries,
                       vocab_size: int) -> bool:
    """Top-10 parity of the device path vs a scipy-CSR oracle on the
    SAME corpus: a wrong-but-fast kernel must fail the bench loudly, not
    set a record. Compares score-sets per query (modulo tie order) at
    f32-friendly tolerance."""
    import scipy.sparse as sp

    n_docs = offsets.shape[0] - 1
    row, impact = _impacts(offsets, ids, tfs, lengths)
    M = sp.csr_matrix((impact, (row, ids.astype(np.int64))),
                      shape=(n_docs, vocab_size))
    qmat = _parse_queries(queries, vocab_size)
    scores = np.asarray((M @ sp.csr_matrix(qmat.T)).todense()).T
    got = engine.search_batch(queries, k=TOP_K)
    for i, hits in enumerate(got):
        want = np.sort(scores[i])[::-1][:TOP_K]
        want = want[want > 0]
        have = np.asarray([h.score for h in hits], np.float32)
        assert have.shape[0] == want.shape[0], \
            (i, have.shape, want.shape)
        # rtol covers f32-vs-f64 arithmetic drift (~3e-4 uniform);
        # real bugs (wrong df, wrong doc ids) are orders of magnitude
        np.testing.assert_allclose(have, want, rtol=2e-3, atol=1e-4,
                                   err_msg=f"query {i} top-k mismatch")
        # the returned documents must score what the oracle says they
        # score: re-derive each hit's oracle score by name
        for h in hits:
            d = int(h.name[1:])
            np.testing.assert_allclose(
                h.score, scores[i, d], rtol=2e-3, atol=1e-4,
                err_msg=f"query {i} doc {h.name}")
    log(f"[ns] oracle top-{TOP_K} parity OK on {len(queries)} queries "
        f"at {n_docs} docs")
    return True


# --------------------------------------------------------------------------
# CPU baselines: scipy CSR + torch sparse CSR (strongest wins)
# --------------------------------------------------------------------------

def _impacts(offsets, ids, tfs, lengths):
    """Precomputed per-entry BM25 impacts (generous to the baseline: the
    device side recomputes query weighting per batch)."""
    n_docs = offsets.shape[0] - 1
    counts = np.diff(offsets)
    row = np.repeat(np.arange(n_docs, dtype=np.int32), counts)
    df = np.bincount(ids, minlength=int(ids.max()) + 1).astype(np.float32)
    avgdl = lengths.mean()
    k1, b = 1.2, 0.75
    idf = np.log1p((n_docs - df + 0.5) / (df + 0.5))
    denom = tfs + k1 * (1 - b + b * lengths[row] / avgdl)
    return row, (idf[ids] * tfs / denom).astype(np.float32)


def _parse_queries(queries, vocab_size):
    """Query batch as a dense [B, V] matrix (term multiplicity weights)."""
    B = len(queries)
    qmat = np.zeros((B, vocab_size), np.float32)
    for i, q in enumerate(queries):
        for tok in q.split():
            tid = int(tok[1:])
            if 0 <= tid < vocab_size:
                qmat[i, tid] += 1.0
    return qmat


def cpu_baselines(offsets, ids, tfs, lengths, queries, vocab_size,
                  *, n_batches: int, batch: int,
                  numpy_loop: bool) -> dict:
    import scipy.sparse as sp

    n_docs = offsets.shape[0] - 1
    row, impact = _impacts(offsets, ids, tfs, lengths)
    M = sp.csr_matrix((impact, (row, ids.astype(np.int64))),
                      shape=(n_docs, vocab_size))
    out: dict = {}

    def timed(name, run):
        run(queries[:batch])   # warm
        t0 = time.perf_counter()
        total = 0
        for b in range(1, n_batches + 1):
            chunk = queries[b * batch:(b + 1) * batch]
            run(chunk)
            total += len(chunk)
        qps = total / (time.perf_counter() - t0)
        log(f"[cpu] {name}: {qps:.2f} q/s (batch={batch})")
        out[name] = qps

    def scipy_run(qs):
        qmat = _parse_queries(qs, vocab_size)
        scores = M @ qmat.T                      # [n_docs, B] dense
        k = min(TOP_K, n_docs - 1)
        return np.argpartition(-scores, k, axis=0)[:k]

    timed("scipy_csr_qps", scipy_run)

    try:
        import torch
        Mt = torch.sparse_csr_tensor(
            torch.from_numpy(M.indptr.astype(np.int64)),
            torch.from_numpy(M.indices.astype(np.int64)),
            torch.from_numpy(M.data),
            size=M.shape)

        def torch_run(qs):
            qmat = torch.from_numpy(_parse_queries(qs, vocab_size))
            scores = torch.matmul(Mt, qmat.T)
            return torch.topk(scores, min(TOP_K, n_docs - 1), dim=0)

        timed("torch_csr_qps", torch_run)
    except Exception as e:   # torch sparse availability varies
        log(f"[cpu] torch baseline skipped: {e!r}")

    if numpy_loop:
        def numpy_run(qs):
            qmat = _parse_queries(qs, vocab_size)
            contrib = impact[None, :] * qmat[:, ids]     # [B, nnz]
            scores = np.zeros((len(qs), n_docs), np.float32)
            for i in range(len(qs)):
                np.add.at(scores[i], row, contrib[i])
            return np.argpartition(-scores, TOP_K, axis=1)[:, :TOP_K]

        timed("numpy_loop_qps", numpy_run)

    out["best_cpu_qps"] = max(v for k, v in out.items() if k.endswith("qps"))
    return out


# --------------------------------------------------------------------------
# config 1: full text pipeline at 18k docs
# --------------------------------------------------------------------------

def bench_config1(rng, *, n_docs: int = C1_DOCS, vocab: int = C1_VOCAB,
                  avg_len: int = C1_AVG_LEN, batch: int = C1_BATCH,
                  batches: int = C1_BATCHES, cpu_batch: int = 512,
                  device=None) -> dict:
    t0 = time.perf_counter()
    texts = make_texts(rng, n_docs, vocab, avg_len)
    queries = make_queries(rng, vocab, batch * (batches + 2))
    log(f"[c1] corpus+queries in {time.perf_counter()-t0:.1f}s")

    engine = _engine(device, query_batch=batch)
    # pass 1 (untimed) fills the capacity buckets
    for i, text in enumerate(texts):
        engine.ingest_text(f"doc{i}", text)
    engine.commit()
    # pass 2 (timed): steady-state re-ingest (idempotent upserts) + commit
    t0 = time.perf_counter()
    for i, text in enumerate(texts):
        engine.ingest_text(f"doc{i}", text)
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.commit()
    commit_s = time.perf_counter() - t0
    log(f"[c1] text-indexed {n_docs} docs in {ingest_s:.2f}s "
        f"({n_docs/ingest_s:.0f} docs/s), warm commit {commit_s:.2f}s")

    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_batch(queries[batch:2 * batch], k=TOP_K)
    timed = queries[2 * batch:(batches + 2) * batch]
    with _measured_window("c1-serving", steady_state=True):
        t0 = time.perf_counter()
        engine.search_batch(timed, k=TOP_K)
        qps = len(timed) / (time.perf_counter() - t0)
    log(f"[c1] {len(timed)} queries -> {qps:.1f} q/s "
        f"(batch={batch}, pipelined)")

    # rebuild the same corpus as arrays for the CPU baselines
    entries = engine.index.live_entries()
    offsets = np.zeros(len(entries) + 1, np.int64)
    for i, d in enumerate(entries):
        offsets[i + 1] = offsets[i] + d.term_ids.shape[0]
    ids = np.concatenate([d.term_ids for d in entries])
    tfs = np.concatenate([d.tfs for d in entries])
    lengths = np.asarray([d.length for d in entries], np.float32)
    # queries reference t<id> names; map through the engine's vocab so the
    # baseline sees the same ids
    remap = {}
    for tid in range(len(engine.vocab)):
        term = engine.vocab.term(tid)
        if term.startswith("t") and term[1:].isdigit():
            remap[term] = tid
    q_mapped = [" ".join(f"t{remap[tok]}" for tok in q.split()
                         if tok in remap) for q in queries]
    cpu = cpu_baselines(offsets, ids, tfs, lengths, q_mapped,
                        len(engine.vocab) + 1,
                        n_batches=2, batch=cpu_batch, numpy_loop=True)
    return {"qps": qps, "text_ingest_dps": n_docs / ingest_s,
            "warm_commit_s": commit_s, **cpu}


# --------------------------------------------------------------------------
# config 4 shape: streaming segments
# --------------------------------------------------------------------------

def bench_streaming(rng, corpus=None, *, n_docs: int = ST_DOCS,
                    vocab: int = NS_VOCAB, avg_len: int = ST_AVG_LEN,
                    commit_every: int = ST_COMMIT_EVERY,
                    device=None) -> dict:
    offsets, ids, tfs, lengths = corpus if corpus is not None else \
        make_doc_arrays(rng, n_docs, vocab, avg_len)
    n_docs = offsets.shape[0] - 1
    engine = _engine(device, index_mode="segments", query_batch=64)
    t0 = time.perf_counter()
    for i in range(vocab):
        engine.vocab.add(f"t{i}")
    log(f"[st] vocab in {time.perf_counter()-t0:.1f}s")

    t0 = time.perf_counter()
    add = engine.index.add_document_arrays
    commit_ms = []
    for i in range(n_docs):
        lo, hi = offsets[i], offsets[i + 1]
        add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
        if (i + 1) % commit_every == 0:
            c0 = time.perf_counter()
            engine.commit()
            commit_ms.append((time.perf_counter() - c0) * 1e3)
    total_s = time.perf_counter() - t0
    # quiesce: drain the background merge backlog (untimed — it ran off
    # the write path; the sustained rate above is what streaming sees)
    q0 = time.perf_counter()
    for _ in range(32):
        engine.index.wait_for_merges()
        engine.commit()
        if len(engine.index._segments) <= engine.config.max_segments \
                and engine.index._merge_future is None:
            break
    quiesce_s = time.perf_counter() - q0
    cm = np.asarray(commit_ms)
    p50, p99, mx = (float(np.percentile(cm, 50)),
                    float(np.percentile(cm, 99)), float(cm.max()))
    log(f"[st] streamed {n_docs} docs in {total_s:.1f}s "
        f"({n_docs/total_s:.0f} docs/s sustained, {len(commit_ms)} "
        f"commits: p50 {p50:.0f}ms p99 {p99:.0f}ms max {mx:.0f}ms)")
    hits = engine.search("t17 t4242")
    assert hits, "streaming index must answer queries"
    return {"streaming_dps": round(n_docs / total_s, 1),
            "n_docs": n_docs,
            "commit_ms_p50": round(p50, 1),
            "commit_ms_p99": round(p99, 1),
            "commit_ms_max": round(mx, 1),
            "quiesce_s": round(quiesce_s, 1),
            "segments": len(engine.index.snapshot.segments)}


def bench_mesh(rng, *, n_docs: int = MESH_DOCS, vocab: int = NS_VOCAB,
               avg_len: int = ST_AVG_LEN, batch: int = MESH_BATCH,
               batches: int = MESH_BATCHES, device=None) -> dict:
    """The distributed serving path (the mesh index and searcher) on the
    card(s), the step a mesh node serves. Reports the cold commit (host
    ELL build + upload, one-time) apart from the steady-state commit
    (append a batch into the COO delta + refresh impacts)."""
    offsets, ids, tfs, lengths = make_doc_arrays(
        rng, n_docs + 200, vocab, avg_len)
    engine = _engine(device, engine_mode="mesh", query_batch=batch)
    for i in range(vocab):
        engine.vocab.add(f"t{i}")
    add = engine.index.add_document_arrays
    for i in range(n_docs):
        lo, hi = offsets[i], offsets[i + 1]
        add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
    t0 = time.perf_counter()
    engine.commit()
    commit_cold_s = time.perf_counter() - t0
    # steady state: append 100 docs into the delta, commit (the first one
    # pays the delta's first layout; the second is the real cost)
    for j in range(2):
        for i in range(n_docs + 100 * j, n_docs + 100 * (j + 1)):
            lo, hi = offsets[i], offsets[i + 1]
            add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
        t0 = time.perf_counter()
        engine.commit()
        commit_steady_s = time.perf_counter() - t0
    queries = make_queries(rng, vocab, batch * (batches + 2))
    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_batch(queries[batch:2 * batch], k=TOP_K)
    timed = queries[2 * batch:(batches + 2) * batch]
    with _measured_window("mesh-serving", steady_state=True):
        t0 = time.perf_counter()
        engine.search_batch(timed, k=TOP_K)
        qps = len(timed) / (time.perf_counter() - t0)
    devices = len(engine.index.mesh.local_devices())
    log(f"[mesh] {n_docs} docs on {devices} device(s) "
        f"({engine.index.mesh.shape}): {qps:.0f} q/s, commit cold "
        f"{commit_cold_s:.1f}s / steady {commit_steady_s*1e3:.0f}ms")
    # the distributed path gets its own oracle gate; the oracle corpus is
    # the committed state (base + both appended delta batches)
    n_all = n_docs + 200
    parity = oracle_topk_parity(
        engine, offsets[:n_all + 1], ids[:offsets[n_all]],
        tfs[:offsets[n_all]], lengths[:n_all], queries[:64], vocab)
    return {"qps": round(qps, 1), "commit_cold_s": round(commit_cold_s, 1),
            "commit_steady_ms": round(commit_steady_s * 1e3, 1),
            "parity_checked": parity,
            "devices": devices, "n_docs": n_docs}


# --------------------------------------------------------------------------
# shared cluster-bench plumbing (configs 2 and 2 on the card)
# --------------------------------------------------------------------------

# ports free_ports has handed out in this process: a port drawn for one
# node is not drawn again for another before the first binds it
_DRAWN: set[int] = set()


def free_ports(n: int) -> list[int]:
    """``n`` distinct ports free on 127.0.0.1, below the kernel's
    ephemeral range, none handed out before in this process. A port that
    ``bind(0)`` hands out lies in that range, where another process's
    outgoing connection can take it as its source port before the node it
    was drawn for binds it (a fleet's worker exited so, "address already
    in use", while the leader and the other worker booted); below the
    range only a bind takes a port."""
    import random
    import socket
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except OSError:
        low = 32768                 # Linux's default range starts here
    candidates = [p for p in range(max(1024, low - 10_000), low)
                  if p not in _DRAWN]
    random.shuffle(candidates)
    ports = []
    for port in candidates:
        with socket.socket() as s_:
            try:
                s_.bind(("127.0.0.1", port))
            except OSError:
                continue
        ports.append(port)
        if len(ports) == n:
            _DRAWN.update(ports)
            return ports
    raise RuntimeError(f"no {n} free ports below the ephemeral range "
                       f"({low})")


def _free_port() -> int:
    return free_ports(1)[0]


def _http_get(url: str, timeout: float = 10.0) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.read()


def _wait_until(pred, timeout: float = 240.0,
                interval: float = 0.3) -> None:
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            if pred():
                return
        except Exception as e:
            last = e
        time.sleep(interval)
    raise AssertionError(f"timeout; last={last!r}")


class _KeepAlive:
    """One persistent HTTP connection per (thread, port); one retry on a
    dropped keep-alive connection."""

    def __init__(self) -> None:
        import threading
        self._tls = threading.local()

    def post(self, hostport: tuple[str, int], path: str, data: bytes,
             timeout: float = 600.0) -> bytes:
        return self.post_full(hostport, path, data, timeout=timeout)[2]

    def post_full(self, hostport: tuple[str, int], path: str,
                  data: bytes, timeout: float = 600.0,
                  headers: dict | None = None
                  ) -> tuple[int, dict, bytes]:
        """(status, response headers, body): the overload modes see 429
        sheds and their Retry-After, not just bytes."""
        import http.client
        import socket
        key = f"conn_{hostport[1]}"
        last: Exception | None = None
        for _ in range(2):
            c = getattr(self._tls, key, None)
            try:
                if c is None:
                    c = http.client.HTTPConnection(*hostport,
                                                   timeout=timeout)
                    # connect inside the try: a transient refusal must
                    # take the retry path, not escape as a bare OSError
                    c.connect()
                    c.sock.setsockopt(socket.IPPROTO_TCP,
                                      socket.TCP_NODELAY, 1)
                    setattr(self._tls, key, c)
                h = {"Content-Type": "application/octet-stream"}
                h.update(headers or {})
                c.request("POST", path, body=data, headers=h)
                r = c.getresponse()
                body = r.read()
                hdrs = dict(r.getheaders())
                if r.status == 429 and r.will_close:
                    # the shed path closes the connection: drop ours too
                    c.close()
                    setattr(self._tls, key, None)
                return r.status, hdrs, body
            except Exception as e:
                last = e
                c.close()
                setattr(self._tls, key, None)
        raise RuntimeError(f"post {path} failed") from last


def _kill_all(procs) -> None:
    for p in procs:
        try:
            p.kill()
        except Exception:
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except Exception:
            pass


def _node_env(device) -> tuple[dict, str]:
    """The environment of a ``python -m tfidf_tpu_torch`` node: the
    package importable, and the engine on ``device`` (None: the CLI's
    default, the card). Returns (env, the device name recorded)."""
    env = dict(os.environ)
    env.pop("TFIDF_DEVICE", None)
    if device is not None:
        env["TFIDF_DEVICE"] = str(device)
    path = env.get("PYTHONPATH", "")
    if ROOT not in path.split(os.pathsep):
        env["PYTHONPATH"] = os.pathsep.join(p for p in (path, ROOT) if p)
    return env, "cuda" if device is None else str(device)


def _worker_launches(urls: list[str], node_dev: str) -> list[int]:
    """Each worker's ELL kernel launches so far (its ``/api/metrics``);
    on the card every worker must have launched the kernel, or its
    scoring did not run there."""
    out = []
    for url in urls:
        m = json.loads(_http_get(url + "/api/metrics"))
        out.append(int(m.get("ell_kernel_launches_v4", 0)
                       + m.get("ell_kernel_launches_v3", 0)))
    if node_dev.startswith("cuda") and not all(out):
        # the bytes each worker's index holds: 0 = no document placed there
        sizes = [int(_http_get(u + "/worker/index-size")) for u in urls]
        raise AssertionError(f"a worker on {node_dev} launched no ELL "
                             f"kernel: {out}; index bytes {sizes}")
    return out


# --------------------------------------------------------------------------
# config 2: 2-worker cluster, real HTTP scatter-gather
# --------------------------------------------------------------------------

C2_DOCS = 100_000
C2_VOCAB = 200_000
C2_AVG_LEN = 80
C2_QUERIES = 192
C2_CLIENTS = 8


def bench_cluster(rng, *, n_docs: int = C2_DOCS, vocab: int = C2_VOCAB,
                  avg_len: int = C2_AVG_LEN, n_queries: int = C2_QUERIES,
                  clients: int = C2_CLIENTS, device=None) -> dict:
    """End-to-end cluster data plane: a from-scratch coordination service
    + 3 node processes (leader + 2 workers) over real HTTP, measuring
    bulk upload throughput and /leader/start QPS — the reference's own
    serving shape (Leader.java:39-92). Every node runs its engine on
    ``device`` (the card by default)."""
    import concurrent.futures
    import json as _json
    import socket
    import subprocess
    import tempfile

    t0 = time.perf_counter()
    texts = make_texts(rng, n_docs, vocab, avg_len)
    queries = make_queries(rng, vocab, 2 * n_queries)
    log(f"[c2] corpus in {time.perf_counter()-t0:.0f}s")

    env, node_dev = _node_env(device)
    procs = []
    tmp = tempfile.mkdtemp(prefix="bench_c2_")

    def spawn(args):
        p = subprocess.Popen(
            [sys.executable, "-m", "tfidf_tpu_torch", *args], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        procs.append(p)
        return p

    client = _KeepAlive()
    try:
        coord = _free_port()
        spawn(["coordinator", "--listen", f"127.0.0.1:{coord}"])
        _wait_until(lambda: socket.create_connection(
            ("127.0.0.1", coord), timeout=1).close() or True)
        ports = [_free_port() for _ in range(3)]
        urls = [f"http://127.0.0.1:{p}" for p in ports]

        def serve(i):
            spawn(["serve", "--port", str(ports[i]), "--host", "127.0.0.1",
                   "--coordinator-address", f"127.0.0.1:{coord}",
                   "--documents-path", f"{tmp}/n{i}/docs",
                   "--index-path", f"{tmp}/n{i}/index"])

        # the leader first (it wins the election), then both workers
        # together
        serve(0)
        _wait_until(lambda: _http_get(urls[0] + "/api/status")
                    == b"I am the leader")
        serve(1)
        serve(2)
        for u in urls[1:]:
            _wait_until(lambda u=u: _http_get(u + "/api/status"))
        leader = urls[0]
        leader_hp = ("127.0.0.1", ports[0])
        _wait_until(lambda: len(_json.loads(
            _http_get(leader + "/api/services"))) == 2)

        groups = [[{"name": f"d{i}.txt", "text": texts[i]}
                   for i in range(lo, min(lo + 500, n_docs))]
                  for lo in range(0, n_docs, 500)]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            list(ex.map(
                lambda g: client.post(leader_hp, "/leader/upload-batch",
                                      _json.dumps(g).encode()),
                groups))
        upload_s = time.perf_counter() - t0
        log(f"[c2] uploaded {n_docs} docs via HTTP (batched) in "
            f"{upload_s:.0f}s ({n_docs/upload_s:.0f} docs/s)")

        def start(q):
            return client.post(leader_hp, "/leader/start", q.encode())

        # two warm rounds: the first pays each worker's first commit and
        # first launches for every micro-batch the arrival pattern makes
        for r in range(2):
            with concurrent.futures.ThreadPoolExecutor(clients) as ex:
                list(ex.map(start, queries[:n_queries]))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            list(ex.map(start, queries[n_queries:2 * n_queries]))
        qps = n_queries / (time.perf_counter() - t0)
        lat0 = time.perf_counter()
        start(queries[0])
        lat_ms = (time.perf_counter() - lat0) * 1e3
        launches = _worker_launches(urls[1:], node_dev)
        log(f"[c2] /leader/start: {qps:.1f} q/s with {clients} "
            f"clients, single-query latency {lat_ms:.0f}ms; workers' "
            f"ELL kernel launches {launches}")
        return {"qps": round(qps, 1), "upload_dps": round(
                    n_docs / upload_s, 1),
                "latency_ms": round(lat_ms, 1), "n_docs": n_docs,
                "workers": 2,
                "backend": (f"leader {node_dev}, workers {node_dev} + "
                            f"{node_dev} (ELL kernel launches "
                            f"{launches[0]} + {launches[1]})")}
    finally:
        _kill_all(procs)


# --------------------------------------------------------------------------
# realistic-text pipeline at 100k docs
# --------------------------------------------------------------------------

RT_DOCS = 100_000
RT_AVG_LEN = 80
RT_BATCH = 1024
RT_BATCHES = 4
RT_PARITY_QUERIES = 64


def bench_realistic(rng, *, n_docs: int = RT_DOCS,
                    avg_len: int = RT_AVG_LEN, batch: int = RT_BATCH,
                    batches: int = RT_BATCHES,
                    parity_queries: int = RT_PARITY_QUERIES,
                    device=None) -> dict:
    """The FULL text pipeline on realistic bytes: extract (HTML /
    charset fallback / binary 415) -> tokenize -> index -> search, at
    100k documents built from a real-English lexicon with punctuation,
    contractions, numbers, and a charset/format mix
    (``tfidf_tpu_torch/utils/textgen.py``). Oracle top-10 parity is
    computed from the engine's own analyzer output (live_entries), so it
    validates scoring + indexing given the analysis the documents
    actually got."""
    from tfidf_tpu_torch.ops.analyzer import UnsupportedMediaType
    from tfidf_tpu_torch.utils.metrics import global_metrics
    from tfidf_tpu_torch.utils.textgen import (RealisticCorpus,
                                               harvest_lexicon)

    t0 = time.perf_counter()
    words, _ = harvest_lexicon()
    gen = RealisticCorpus(rng, words)
    payloads = [gen.make_payload(avg_len) for _ in range(n_docs)]
    kinds = {}
    for _p, k in payloads:
        kinds[k] = kinds.get(k, 0) + 1
    log(f"[rt] {n_docs} realistic docs ({kinds}) from a "
        f"{len(words)}-word lexicon in {time.perf_counter()-t0:.0f}s")

    engine = _engine(device, query_batch=batch)
    m0 = global_metrics.snapshot()
    rejected = 0
    t0 = time.perf_counter()
    for i, (data, _k) in enumerate(payloads):
        try:
            engine.ingest_bytes(f"d{i}.txt", data)
        except UnsupportedMediaType:
            rejected += 1
    ingest_s = time.perf_counter() - t0
    assert rejected == kinds.get("binary", 0), \
        (rejected, kinds.get("binary", 0))
    m1 = global_metrics.snapshot()
    native = (m1.get("ingest_native_fast_path", 0)
              - m0.get("ingest_native_fast_path", 0))
    pyfall = (m1.get("ingest_python_fallback", 0)
              - m0.get("ingest_python_fallback", 0))
    hit_rate = native / max(native + pyfall, 1)
    t0 = time.perf_counter()
    engine.commit()
    commit_s = time.perf_counter() - t0
    log(f"[rt] ingested {n_docs - rejected} docs in {ingest_s:.1f}s "
        f"({(n_docs - rejected)/ingest_s:.0f} docs/s), {rejected} "
        f"binary 415s, native fast path {hit_rate:.1%}, "
        f"commit {commit_s:.1f}s")

    def make_query() -> str:
        k = int(rng.integers(2, 5))
        idx = rng.choice(len(words), size=k, p=gen.p)
        toks = [words[i] for i in idx]
        if rng.random() < 0.3:   # exercise query-side lowercasing
            toks[0] = toks[0].capitalize()
        return " ".join(toks)

    queries = [make_query() for _ in range(batch * (batches + 2))]
    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_batch(queries[batch:2 * batch], k=TOP_K)
    timed = queries[2 * batch:(batches + 2) * batch]
    with _measured_window("rt-serving", steady_state=True):
        t0 = time.perf_counter()
        engine.search_batch(timed, k=TOP_K)
        qps = len(timed) / (time.perf_counter() - t0)
    log(f"[rt] {len(timed)} queries -> {qps:.1f} q/s (batch={batch})")

    # oracle parity from the engine's own analyzer output, through the
    # SAME impact math every other config's oracle uses (_impacts)
    import scipy.sparse as sp
    entries = engine.index.live_entries()
    vocab_n = len(engine.vocab) + 1
    name_row = {e.name: i for i, e in enumerate(entries)}
    offsets = np.zeros(len(entries) + 1, np.int64)
    for i, e in enumerate(entries):
        offsets[i + 1] = offsets[i] + e.term_ids.shape[0]
    ids = np.concatenate([e.term_ids for e in entries])
    tfs = np.concatenate([e.tfs for e in entries])
    lengths = np.asarray([e.length for e in entries], np.float32)
    row_all, impact = _impacts(offsets, ids, tfs, lengths)
    M = sp.csr_matrix((impact, (row_all, ids.astype(np.int64))),
                      shape=(len(entries), vocab_n))
    pq = queries[:parity_queries]
    got = engine.search_batch(pq, k=TOP_K)
    analyzer, vocab = engine.analyzer, engine.vocab
    for qi, (q, hits) in enumerate(zip(pq, got)):
        qv = np.zeros(vocab_n, np.float64)
        for tid, n in vocab.map_counts(analyzer.counts(q),
                                       add=False).items():
            qv[tid] += n
        scores = np.asarray(M @ qv).ravel()
        want = np.sort(scores)[::-1][:TOP_K]
        want = want[want > 0]
        have = np.asarray([h.score for h in hits], np.float32)
        assert have.shape[0] == want.shape[0], (qi, q, have, want)
        np.testing.assert_allclose(have, want, rtol=2e-3, atol=1e-4,
                                   err_msg=f"[rt] query {qi} {q!r}")
        for h in hits:
            np.testing.assert_allclose(
                h.score, scores[name_row[h.name]], rtol=2e-3, atol=1e-4,
                err_msg=f"[rt] query {qi} {q!r} doc {h.name}")
    log(f"[rt] oracle top-{TOP_K} parity OK on {len(pq)} queries")
    return {"qps": round(qps, 1),
            "ingest_dps": round((n_docs - rejected) / ingest_s, 1),
            "commit_s": round(commit_s, 1), "n_docs": n_docs,
            "binary_rejected_415": rejected,
            "kinds": kinds,
            "native_fast_path_rate": round(hit_rate, 4),
            "lexicon_words": len(words),
            "parity_checked": True}


# --------------------------------------------------------------------------
# config 2 on the card: the cluster data plane with card-backed workers
# --------------------------------------------------------------------------

C2T_DOCS = 100_000
C2T_GPU_SHARE = 95_000
C2T_AVG_LEN = 80
C2T_CLIENTS = 1024         # max sweep point; warmup uses this count
C2T_SWEEP = (1024, 768, 512)  # in-run client sweep (host speed varies
                              # between runs; only an in-run sweep
                              # isolates the concurrency knob)
C2T_QUERIES = 8192
C2T_QUERY_BATCH = 512      # worker-side engine chunk == scatter batch
C2T_SCATTER_BATCH = 1024   # leader-side group: 2 worker chunks
C2T_LINGER_MS = 5.0
C2T_PARITY_QUERIES = 32


def _delta_timing(m0: dict, m1: dict, name: str) -> float:
    """Windowed mean (ms) of a Metrics timing between two snapshots."""
    n = m1.get(f"{name}_count", 0) - m0.get(f"{name}_count", 0)
    s = m1.get(f"{name}_sum_ms", 0.0) - m0.get(f"{name}_sum_ms", 0.0)
    return round(s / n, 3) if n else 0.0


def bench_cluster_gpu(rng, *, n_docs: int = C2T_DOCS,
                      gpu_share: int = C2T_GPU_SHARE,
                      avg_len: int = C2T_AVG_LEN,
                      n_queries: int = C2T_QUERIES,
                      sweep: tuple = C2T_SWEEP,
                      clients: int = C2T_CLIENTS,
                      parity_queries: int = C2T_PARITY_QUERIES,
                      device=None) -> dict:
    """The distributed HTTP serving path against card-backed engines —
    the reference's only serving shape (``Leader.java:39-92``) with the
    card doing the scoring, driven with REALISTIC text: the textgen
    corpus (plain/HTML/latin-1 + a binary fraction that must 415). The
    topology: a leader (scatter-gather) + worker0 (~95% of the corpus) +
    worker1 (the tail), every node's engine on ``device`` (the card by
    default). The phased upload (worker0 alone first, then worker1 joins
    and takes the remainder via least-loaded placement) both skews the
    corpus onto worker0 and exercises elastic join.

    Serving runs the batched scatter: concurrent /leader/start queries
    coalesce into one packed-binary RPC per worker. The config reports a
    per-stage breakdown (linger/RPC/decode/merge at the leader,
    search/pack at worker0) from windowed /api/metrics deltas, and a
    parity gate: /leader/start must equal the sum-merged union of direct
    per-worker /worker/process results for every parity query."""
    import concurrent.futures
    import json as _json
    import socket
    import subprocess
    import tempfile

    from tfidf_tpu_torch.cluster.wire import unpack_hit_lists
    from tfidf_tpu_torch.utils.textgen import (RealisticCorpus,
                                               harvest_lexicon)

    client = _KeepAlive()
    post = client.post

    t0 = time.perf_counter()
    words, _ = harvest_lexicon()
    gen = RealisticCorpus(rng, words)
    payloads = [gen.make_payload(avg_len) for _ in range(n_docs)]
    kinds: dict[str, int] = {}
    for _p, k in payloads:
        kinds[k] = kinds.get(k, 0) + 1

    def make_query() -> str:
        k = int(rng.integers(2, 5))
        idx = rng.choice(len(words), size=k, p=gen.p)
        return " ".join(words[i] for i in idx)

    queries = [make_query()
               for _ in range((2 + len(sweep)) * n_queries)]
    log(f"[c2g] {n_docs} realistic docs ({kinds}) in "
        f"{time.perf_counter()-t0:.0f}s")

    env, node_dev = _node_env(device)
    env["TFIDF_QUERY_BATCH"] = str(C2T_QUERY_BATCH)
    env["TFIDF_BATCH_LINGER_MS"] = str(C2T_LINGER_MS)
    env["TFIDF_SCATTER_BATCH"] = str(C2T_SCATTER_BATCH)
    env["TFIDF_SCATTER_PIPELINE"] = "2"
    env["TFIDF_FANOUT_WORKERS"] = "32"
    # adaptive linger range: an idle pipeline ships groups at ~0.5ms; a
    # saturated one stretches toward 2x the fixed linger so groups arrive
    # fuller while the wait hides under in-flight batches
    env["TFIDF_BATCH_LINGER_MIN_MS"] = "0.5"
    env["TFIDF_BATCH_LINGER_MAX_MS"] = str(2 * C2T_LINGER_MS)
    env["TFIDF_SCATTER_LINGER_MIN_MS"] = "0.5"
    env["TFIDF_SCATTER_LINGER_MAX_MS"] = str(2 * C2T_LINGER_MS)
    # one copy of each document, and no live migration, as each of the
    # reference's workers owns its files: the phased upload skews the
    # corpus onto worker0, and the parity gate's sum over the workers'
    # direct results counts each document once, against statistics that
    # hold still. At the Config defaults the documents uploaded after
    # worker1 joins live on both workers (2 copies), and the rebalancer
    # moves worker0's documents to worker1 while the gate runs, so the
    # sum counts copies twice and each worker's statistics drift.
    env["TFIDF_REPLICATION_FACTOR"] = "1"
    env["TFIDF_REBALANCE_ENABLED"] = "false"

    procs = []
    tmp = tempfile.mkdtemp(prefix="bench_c2g_")
    log(f"[c2g] node logs under {tmp}/node*.log")

    def spawn(args):
        errf = open(f"{tmp}/node{len(procs)}.log", "wb")
        p = subprocess.Popen([sys.executable, "-m", "tfidf_tpu_torch",
                              *args], env=env, stdout=subprocess.DEVNULL,
                             stderr=errf)
        procs.append(p)
        return p

    try:
        coord = _free_port()
        spawn(["coordinator", "--listen", f"127.0.0.1:{coord}"])
        _wait_until(lambda: socket.create_connection(
            ("127.0.0.1", coord), timeout=1).close() or True)
        ports = [_free_port() for _ in range(3)]
        urls = [f"http://127.0.0.1:{p}" for p in ports]

        def node_args(i):
            return ["serve", "--port", str(ports[i]), "--host",
                    "127.0.0.1", "--coordinator-address",
                    f"127.0.0.1:{coord}",
                    "--documents-path", f"{tmp}/n{i}/docs",
                    "--index-path", f"{tmp}/n{i}/index"]

        spawn(node_args(0))   # leader first: wins the election
        _wait_until(lambda: _http_get(urls[0] + "/api/status")
                    == b"I am the leader")
        spawn(node_args(1))   # worker0
        _wait_until(lambda: _json.loads(_http_get(urls[0] + "/api/services"))
                    == [urls[1]])

        leader_hp = ("127.0.0.1", ports[0])
        rejected = 0

        def upload_range(lo: int, hi: int) -> int:
            """Upload docs [lo, hi): UTF-8 text in bulk batches, the
            rest (latin-1/binary) through the per-file endpoint, like a
            mixed real-world client. Returns the 415 count."""
            batch: list[dict] = []
            singles: list[tuple[str, bytes]] = []
            for i in range(lo, hi):
                data, kind = payloads[i]
                name = f"d{i}.txt"
                if kind != "binary":
                    try:
                        batch.append({"name": name,
                                      "text": data.decode("utf-8")})
                        continue
                    except UnicodeDecodeError:
                        pass
                singles.append((name, data))
            groups = [batch[g:g + 500] for g in range(0, len(batch), 500)]
            with concurrent.futures.ThreadPoolExecutor(8) as ex:
                list(ex.map(lambda g: post(
                    leader_hp, "/leader/upload-batch",
                    _json.dumps(g).encode()), groups))
                n415 = sum(ex.map(
                    lambda nd: int(b"unsupported media type" in post(
                        leader_hp, f"/leader/upload?name={nd[0]}",
                        nd[1])), singles))
            return n415

        t0 = time.perf_counter()
        rejected += upload_range(0, gpu_share)
        up1_s = time.perf_counter() - t0
        log(f"[c2g] {gpu_share} docs -> worker0 in {up1_s:.0f}s "
            f"({gpu_share/up1_s:.0f} docs/s), {rejected} binary 415s")

        spawn(node_args(2))   # worker1 joins late
        _wait_until(lambda: len(_json.loads(
            _http_get(urls[0] + "/api/services"))) == 2)
        rejected += upload_range(gpu_share, n_docs)
        assert rejected == kinds.get("binary", 0), \
            (rejected, kinds.get("binary", 0))

        # force each worker's commit + first launches directly: the
        # leader's scatter RPC timeout is 10s, a cold commit is not
        for i in (1, 2):
            t0 = time.perf_counter()
            post(("127.0.0.1", ports[i]), "/worker/process",
                 _json.dumps({"query": queries[0]}).encode(),
                 timeout=900.0)
            log(f"[c2g] worker {i-1} cold commit: "
                f"{time.perf_counter()-t0:.0f}s")
        # warm the FULL scatter batch on each worker before the client
        # storm: a failure here is visible in the node logs instead of
        # silently degrading every coalesced batch to []
        for i in (1, 2):
            t0 = time.perf_counter()
            raw = post(("127.0.0.1", ports[i]), "/worker/process-batch",
                       _json.dumps({"queries": queries[:C2T_SCATTER_BATCH],
                                    "k": TOP_K}).encode(), timeout=900.0)
            got = unpack_hit_lists(raw)
            assert sum(bool(x) for x in got) > 0, \
                f"worker {i-1} full-bucket batch returned all-empty"
            log(f"[c2g] worker {i-1} batch-{C2T_SCATTER_BATCH} warm: "
                f"{time.perf_counter()-t0:.0f}s")

        def start(q):
            return post(leader_hp, "/leader/start", q.encode())

        for r in range(2):   # warm: every batch shape of the arrivals
            with concurrent.futures.ThreadPoolExecutor(clients) as ex:
                list(ex.map(start,
                            queries[r*n_queries:(r+1)*n_queries]))

        def snap_metrics():
            return (_json.loads(_http_get(urls[0] + "/api/metrics")),
                    _json.loads(_http_get(urls[1] + "/api/metrics")))

        # per-stage breakdown of one served query: leader
        # linger/RPC/decode/merge from the leader process, batch
        # search/pack from worker0, windowed per sweep point
        def window_breakdown(ml0, mw0, ml1, mw1):
            n_sb = (ml1.get("scatter_batches", 0)
                    - ml0.get("scatter_batches", 0))
            n_si = (ml1.get("scatter_items", 0)
                    - ml0.get("scatter_items", 0))
            return {
                "mean_scatter_batch": round(n_si / max(n_sb, 1), 1),
                "leader_linger_ms": _delta_timing(ml0, ml1,
                                                  "scatter_linger"),
                "leader_rpc_ms": _delta_timing(ml0, ml1, "scatter_rpc"),
                "leader_decode_ms": _delta_timing(ml0, ml1,
                                                  "scatter_decode"),
                "leader_merge_ms": _delta_timing(ml0, ml1,
                                                 "scatter_merge"),
                "worker_search_ms": _delta_timing(mw0, mw1,
                                                  "worker_batch_search"),
                "worker_pack_ms": _delta_timing(mw0, mw1,
                                                "worker_batch_pack"),
            }

        windows = []
        qoff = 2 * n_queries
        for nclients in sweep:
            ml0, mw0 = snap_metrics()
            t0 = time.perf_counter()
            with concurrent.futures.ThreadPoolExecutor(nclients) as ex:
                res = list(ex.map(start,
                                  queries[qoff:qoff + n_queries]))
            w_qps = n_queries / (time.perf_counter() - t0)
            ml1, mw1 = snap_metrics()
            assert sum(bool(_json.loads(r)) for r in res[:64]) >= 32, \
                "mostly-empty results"
            w = {"clients": nclients, "qps": round(w_qps, 1),
                 "breakdown": window_breakdown(ml0, mw0, ml1, mw1)}
            windows.append(w)
            log(f"[c2g] window {w}")
            qoff += n_queries
        best = max(windows, key=lambda w: w["qps"])
        qps = best["qps"]
        breakdown = best["breakdown"]

        lat = []
        for q in queries[:32]:
            t0 = time.perf_counter()
            start(q)
            lat.append((time.perf_counter() - t0) * 1e3)

        # parity gate: the batched scatter path must equal the sum-merged
        # union of the per-query reference shape, worker by worker
        for q in queries[:parity_queries]:
            merged: dict[str, float] = {}
            for i in (1, 2):
                hits = _json.loads(post(("127.0.0.1", ports[i]),
                                        "/worker/process",
                                        _json.dumps({"query": q}).encode()))
                for h in hits:
                    nm = h["document"]["name"]
                    merged[nm] = merged.get(nm, 0.0) + float(h["score"])
            want = dict(sorted(merged.items(),
                               key=lambda kv: (-kv[1], kv[0]))[:TOP_K])
            have = _json.loads(start(q))
            assert list(have) == list(want), (q, have, want)
            for nm in want:
                np.testing.assert_allclose(have[nm], want[nm], rtol=1e-5,
                                           err_msg=f"{q!r} {nm}")
        log(f"[c2g] leader-vs-direct merge parity OK on "
            f"{parity_queries} queries")

        # isolate the leader layer: same load straight at worker0
        # through the reference-shaped per-query endpoint
        w0_hp = ("127.0.0.1", ports[1])

        def direct(q):
            return post(w0_hp, "/worker/process", q.encode())

        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            list(ex.map(direct, queries[:n_queries]))
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(clients) as ex:
            list(ex.map(direct, queries[n_queries:2 * n_queries]))
        direct_qps = n_queries / (time.perf_counter() - t0)
        launches = _worker_launches(urls[1:], node_dev)

        lat_ms = float(np.median(lat))
        log(f"[c2g] /leader/start best: {qps:.1f} q/s "
            f"({best['clients']} clients, mean scatter batch "
            f"{breakdown['mean_scatter_batch']}); direct per-query "
            f"worker {direct_qps:.1f} q/s; lone-query {lat_ms:.0f}ms; "
            f"workers' ELL kernel launches {launches}")
        return {"qps": qps,
                "sweep": windows,
                "direct_worker_qps": round(direct_qps, 1),
                "latency_ms": round(lat_ms, 1),
                "upload_dps_gpu": round(gpu_share / up1_s, 1),
                "n_docs": n_docs, "gpu_share": gpu_share,
                "clients": best["clients"],
                "kinds": kinds, "binary_rejected_415": rejected,
                "breakdown": breakdown,
                "parity_checked": True,
                "workers": 2,
                "backend": (f"leader {node_dev}, workers {node_dev} + "
                            f"{node_dev} (ELL kernel launches "
                            f"{launches[0]} + {launches[1]}), realistic "
                            f"text")}
    finally:
        _kill_all(procs)


# --------------------------------------------------------------------------
# config 5: 5M-term vocabulary stress
# --------------------------------------------------------------------------

C5_DOCS = 200_000
C5_VOCAB = 5_000_000
C5_AVG_LEN = 120
C5_BATCH = 512


def bench_5m_vocab(rng, *, n_docs: int = C5_DOCS, vocab: int = C5_VOCAB,
                   avg_len: int = C5_AVG_LEN, batch: int = C5_BATCH,
                   device=None, keep: dict | None = None) -> dict:
    """Extreme-sparsity stress: a bigram/trigram-sized vocabulary (5M
    terms). Exercises df at 20MB, the [vocab]-sized slot_of scatter in
    the query compile, and the ELL build under a vocabulary 10x larger
    than the north star's. ``keep``, when given, receives the engine and
    the timed queries (a caller that inspects the served state)."""
    t0 = time.perf_counter()
    offsets, ids, tfs, lengths = make_doc_arrays(
        rng, n_docs, vocab, avg_len)
    log(f"[c5] corpus: {n_docs} docs, {vocab} vocab, "
        f"nnz={ids.shape[0]}, gen {time.perf_counter()-t0:.0f}s")
    engine = _engine(device, query_batch=batch)
    t0 = time.perf_counter()
    # register the full 5M-term space (the n-gram dictionary); ids map
    # 1:1 so add_document_arrays can take the corpus ids directly
    for i in range(vocab):
        engine.vocab.add(f"t{i}")
    vocab_s = time.perf_counter() - t0
    add = engine.index.add_document_arrays
    t0 = time.perf_counter()
    for i in range(n_docs):
        lo, hi = offsets[i], offsets[i + 1]
        add(f"d{i}", ids[lo:hi], tfs[lo:hi], float(lengths[i]))
    ingest_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.commit()
    commit_s = time.perf_counter() - t0
    queries = make_queries(rng, vocab, 4 * batch)
    engine.search_batch(queries[:batch], k=TOP_K)
    engine.search_batch(queries[batch:2 * batch], k=TOP_K)
    timed = queries[2 * batch:4 * batch]
    with _measured_window("c5-serving", steady_state=True):
        t0 = time.perf_counter()
        hits = engine.search_batch(timed, k=TOP_K)
        qps = len(timed) / (time.perf_counter() - t0)
    assert any(hits), "5M-vocab index must answer queries"
    log(f"[c5] vocab {vocab_s:.0f}s, ingest {n_docs/ingest_s:.0f} "
        f"docs/s, commit {commit_s:.1f}s, {qps:.0f} q/s")
    if keep is not None:
        keep.update(engine=engine, queries=timed)
    return {"qps": round(qps, 1), "vocab_register_s": round(vocab_s, 1),
            "ingest_dps": round(n_docs / ingest_s, 1),
            "commit_s": round(commit_s, 1), "n_docs": n_docs,
            "vocab": vocab}


# --------------------------------------------------------------------------
# emission
# --------------------------------------------------------------------------

def _validated_json(obj: dict, what: str) -> str:
    """Serialize + re-parse + key-check; exit 1 LOUDLY on any problem
    instead of leaving a broken artifact behind."""
    line = json.dumps(obj)
    try:
        back = json.loads(line)
    except ValueError as e:
        print(f"BENCH SELF-VALIDATION FAILED: {what} does not re-parse: "
              f"{e}", file=sys.stderr)
        sys.exit(1)
    for key in ("metric", "value", "unit", "vs_baseline"):
        if key not in back:
            print(f"BENCH SELF-VALIDATION FAILED: {what} missing key "
                  f"{key!r}", file=sys.stderr)
            sys.exit(1)
    if not isinstance(back["value"], (int, float)):
        print(f"BENCH SELF-VALIDATION FAILED: {what} 'value' is not "
              "numeric", file=sys.stderr)
        sys.exit(1)
    return line


def _emit_validated(result: dict, headline: dict | None = None, *,
                    name: str = "BENCH_DETAIL.json") -> None:
    """Artifact-first emission: the FULL result JSON is written to the
    artifact file FIRST — ``BENCH_OUT`` when set, else
    ``build/bench/<name>`` beside the package — fsynced,
    re-read and re-parsed; only then does stdout get a COMPACT headline
    line (the required metric keys plus every per-config headline
    number). A cut stdout tail can lose detail only from a durable file,
    never the parseable summary.

    Every artifact carries ``kernel_builds_during_measurement``: the nvcc
    builds that landed inside timed ``_measured_window`` blocks (warm-up
    excluded). Steady-state serving windows already fail on a nonzero
    count before reaching here; the stamp makes the property auditable
    from the artifact alone."""
    result.setdefault("kernel_builds_during_measurement",
                      _WINDOW_BUILDS["n"])
    full_line = _validated_json(result, "full result")
    out_path = os.environ.get("BENCH_OUT") or os.path.join(
        ROOT, "build", "bench", name)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(full_line + "\n")
        f.flush()
        os.fsync(f.fileno())
    try:
        with open(out_path, encoding="utf-8") as f:
            if json.loads(f.read()) != json.loads(full_line):
                raise ValueError("file round-trip mismatch")
    except (ValueError, OSError) as e:
        print(f"BENCH SELF-VALIDATION FAILED: re-reading {out_path!r}: "
              f"{e}", file=sys.stderr)
        sys.exit(1)
    print(f"bench artifact validated: {out_path}", file=sys.stderr)
    summary = {k: result[k]
               for k in ("metric", "value", "unit", "vs_baseline")}
    summary["detail_file"] = os.path.basename(out_path)
    if headline:
        summary["headline"] = headline
    print(_validated_json(summary, "headline"))
    sys.stdout.flush()


def card_info() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    import subprocess
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"nvidia_smi": None, "error": repr(e)}
    name, _, limit = line.rpartition(", ")
    return {"nvidia_smi": line, "name": name, "power_limit": limit}


def lexicon_info() -> dict:
    """Size and digest of the harvested lexicon: it is read from files on
    the machine, so two machines may draw different realistic corpora."""
    import hashlib

    from tfidf_tpu_torch.utils.textgen import harvest_lexicon
    words, _ = harvest_lexicon()
    return {"words": len(words), "sha256": hashlib.sha256(
        "\n".join(words).encode()).hexdigest()}


def _release() -> None:
    """Drop the last config's engine from the card before the next."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def main() -> None:
    from tfidf_tpu_torch.device import resolve_device
    resolve_device(None)   # the card, or the CUDA message: no CPU numbers
    t_all = time.perf_counter()
    wall: dict[str, float] = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[name] = round(time.perf_counter() - t0, 1)
        log(f"[bench] {name} took {wall[name]}s")
        _release()
        return out

    rng = np.random.default_rng(SEED)
    # the configs in the JAX bench's order, so each draws the same corpus
    # from the one rng stream
    c2g = run("config2_gpu_worker", bench_cluster_gpu, rng)
    # the 1M-doc corpus is shared by the north-star and streaming configs
    t0 = time.perf_counter()
    corpus_1m = make_doc_arrays(rng, NS_DOCS, NS_VOCAB, NS_AVG_LEN)
    wall["corpus_1m"] = round(time.perf_counter() - t0, 1)
    ns = run("north_star", bench_north_star, rng, corpus_1m)
    c1 = run("config1_18k_fulltext", bench_config1, rng)
    st = run("streaming_segments_1m", bench_streaming, rng, corpus_1m)
    del corpus_1m
    mesh = run("mesh_serving_50k", bench_mesh, rng)
    c5 = run("config5_5m_vocab", bench_5m_vocab, rng)
    rt = run("realistic_text_100k", bench_realistic, rng)
    c2 = run("config2_cluster_100k_2workers", bench_cluster, rng)
    wall["total"] = round(time.perf_counter() - t_all, 1)

    result = {
        "metric": "bm25_batched_query_qps_1m_docs_500k_vocab",
        "value": round(ns["qps"], 2),
        "unit": "queries/sec",
        # denominator: the STRONGEST CPU implementation at the same
        # 1M-doc config (scipy/torch sparse CSR over precomputed impacts)
        "vs_baseline": round(ns["qps"] / ns["best_cpu_qps"], 2),
        "extra": {
            "north_star": {
                "qps": round(ns["qps"], 2),
                "batch": NS_BATCH,
                "ingest_docs_per_sec": round(ns["ingest_dps"], 1),
                "commit_s": round(ns["commit_s"], 2),
                "nnz": ns["nnz"],
                "parity_checked": ns["parity_checked"],
                "scipy_csr_qps": round(ns.get("scipy_csr_qps", 0), 3),
                "torch_csr_qps": round(ns.get("torch_csr_qps", 0), 3),
            },
            "config1_18k_fulltext": {
                "qps": round(c1["qps"], 2),
                "batch": C1_BATCH,
                "text_ingest_docs_per_sec": round(c1["text_ingest_dps"], 1),
                "warm_commit_s": round(c1["warm_commit_s"], 2),
                "scipy_csr_qps": round(c1.get("scipy_csr_qps", 0), 2),
                "torch_csr_qps": round(c1.get("torch_csr_qps", 0), 2),
                "numpy_loop_qps": round(c1.get("numpy_loop_qps", 0), 2),
                "vs_best_cpu": round(c1["qps"] / c1["best_cpu_qps"], 2),
            },
            "streaming_segments_1m": st,
            "mesh_serving_50k": mesh,
            "config5_5m_vocab": c5,
            "realistic_text_100k": rt,
            "config2_cluster_100k_2workers": c2,
            "config2_gpu_worker": c2g,
            "top_k": TOP_K,
        },
        "device": card_info(),
        "lexicon": lexicon_info(),
        "wall_s": wall,
    }
    # every per-config flagship number rides the compact stdout line
    headline = {
        "north_star_qps": round(ns["qps"], 1),
        "config1_qps": round(c1["qps"], 1),
        "streaming_dps": st["streaming_dps"],
        "mesh_qps": mesh["qps"],
        "c5_vocab_qps": c5["qps"],
        "realistic_qps": rt["qps"],
        "cluster_qps": c2["qps"],
        "c2g_qps": c2g["qps"],
        "c2g_direct_worker_qps": c2g["direct_worker_qps"],
    }
    _emit_validated(result, headline)


def run(argv: list[str]) -> None:
    """``main()``, or the mode named by a ``--<mode>`` flag (the root
    ``bench.py``'s dispatch): ``tfidf_tpu_torch/bench_modes.py``."""
    from tfidf_tpu_torch import bench_modes
    for mode in bench_modes.MODES:
        if f"--{mode}" in argv:
            bench_modes.MAINS[mode]()
            return
    main()


if __name__ == "__main__":
    run(sys.argv[1:])
