"""Mesh churn past toy scale on the port: ``probe_mesh_churn.py``'s loop
over the port's mesh engine.

A mesh of in-process ranks runs 25,000 base documents and 8 rounds of
1,500 new documents, 600 re-uploads and 900 deletes, with top-10 parity
against a scipy oracle after every commit, for both mesh layouts:

* ``ell``: the global statistics (df, N, avgdl) are recomputed over the
  LIVE corpus at each commit, so the oracle is BM25 over the live shadow
  corpus;
* ``coo``: df/N/avgdl count tombstones until the next re-shard, so the
  oracle's statistics cover every entry placed since the last re-shard
  (found through the ``rebuilds`` counter), its scores live docs only.

    python3 probe_mesh_churn_torch.py --device cpu --mesh 8x1
    python3 probe_mesh_churn_torch.py --mesh 2x2        # on the card

The corpus is ``tfidf_tpu_torch.bench.make_doc_arrays`` (the same draws as
the root ``bench.py``). On the card every rank shares the one device, the
kernel library is built first, and the run fails unless the ELL layout
launched the v4 kernel. The record, ``<--out>/mesh_churn.json``, is
written only when every parity check held.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 42
V = 15_000
BASE_DOCS = 25_000
AVG_LEN = 40
ROUNDS = 8
NEW_PER_ROUND = 1500
REUP_PER_ROUND = 600
DEL_PER_ROUND = 900
QUERIES_PER_CHECK = 48
TOP_K = 10
K1, B = 1.2, 0.75


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def random_doc(rng):
    n = int(rng.integers(8, 2 * AVG_LEN))
    terms = (rng.zipf(1.25, size=n) % V).astype(np.int64)
    ids, tfs = np.unique(terms, return_counts=True)
    return ids.astype(np.int32), tfs.astype(np.float32), float(n)


def make_query(rng) -> str:
    k = int(rng.integers(2, 5))
    ids = rng.zipf(1.25, size=k) % V
    return " ".join(f"t{w}" for w in ids)


def oracle_check(hits_per_query, committed: dict, dead: list, queries, *,
                 live_stats: bool) -> None:
    """Exact top-10 parity of ``hits_per_query`` (the engine's answers to
    ``queries``) against a scipy-CSR BM25 oracle.

    ``committed``: name -> (ids, tfs, length) of the device-live docs.
    ``dead``: [(ids, length)] tombstoned since the last re-shard — they
    join the statistics when ``live_stats`` is False (the COO layout)."""
    names = sorted(committed)
    n_live = len(names)
    stats_lengths = [committed[n][2] for n in names]
    df = np.zeros(V + 1, np.float64)
    for n in names:
        df[committed[n][0]] += 1.0
    if not live_stats:
        for ids, length in dead:
            df[ids] += 1.0
            stats_lengths.append(length)
    N = float(n_live + (0 if live_stats else len(dead)))
    avgdl = float(np.mean(stats_lengths)) if stats_lengths else 1.0
    idf = np.log1p((N - df + 0.5) / (df + 0.5))

    row_parts, col_parts, val_parts = [], [], []
    for i, n in enumerate(names):
        ids, tfs, length = committed[n]
        denom = tfs + K1 * (1 - B + B * length / avgdl)
        row_parts.append(np.full(ids.shape[0], i, np.int64))
        col_parts.append(ids.astype(np.int64))
        val_parts.append(idf[ids] * tfs / denom)
    M = sp.csr_matrix(
        (np.concatenate(val_parts), (np.concatenate(row_parts),
                                     np.concatenate(col_parts))),
        shape=(n_live, V + 1))
    name_row = {n: i for i, n in enumerate(names)}

    for qi, (q, hits) in enumerate(zip(queries, hits_per_query)):
        qv = np.zeros(V + 1, np.float32)
        for tok in q.split():
            qv[int(tok[1:])] += 1.0
        scores = np.asarray(M @ qv).ravel()
        want = np.sort(scores)[::-1][:TOP_K]
        want = want[want > 0]
        have = np.asarray([h.score for h in hits], np.float32)
        hit_names = [h.name for h in hits]
        assert len(set(hit_names)) == len(hit_names), \
            f"duplicate hits: {hit_names}"
        assert all(n in committed for n in hit_names), \
            f"dead/unknown doc returned: {hit_names}"
        assert have.shape[0] == want.shape[0], \
            (qi, q, have.shape, want.shape)
        np.testing.assert_allclose(have, want, rtol=2e-3, atol=1e-4,
                                   err_msg=f"query {qi} {q!r} top-k")
        for h in hits:   # each returned doc scores what the oracle says
            np.testing.assert_allclose(
                h.score, scores[name_row[h.name]], rtol=2e-3, atol=1e-4,
                err_msg=f"query {qi} {q!r} doc {h.name}")


def port_engine(layout: str, device: str, shape: tuple[int, int]):
    """A port mesh engine of ``shape`` ranks, every one on ``device``."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.parallel.mesh import make_mesh
    from tfidf_tpu_torch.utils.config import Config
    mesh = make_mesh(shape, devices=[device] * (shape[0] * shape[1]))
    return Engine(Config(engine_mode="mesh", mesh_layout=layout,
                         query_batch=QUERIES_PER_CHECK, max_query_terms=8),
                  mesh=mesh, device=device)


def run_layout(engine, layout: str, *, base_docs: int = BASE_DOCS,
               rounds: int = ROUNDS, new_per_round: int = NEW_PER_ROUND,
               reup_per_round: int = REUP_PER_ROUND,
               del_per_round: int = DEL_PER_ROUND, mirror=None,
               on_commit=None) -> dict:
    """The churn loop on ``engine`` (fresh, its vocabulary empty).

    ``mirror``, when given, is another engine fed the same operations in
    the same order; after every commit and its oracle check
    ``on_commit(engine, mirror, queries, hits)`` is called with the
    engine's answers to that check's queries."""
    rng = np.random.default_rng(SEED)
    live_stats = layout == "ell"
    engines = [engine] + ([mirror] if mirror is not None else [])

    for e in engines:
        for i in range(V):
            assert e.vocab.add(f"t{i}") == i, \
                "vocab ids must mirror corpus term ids"

    committed: dict[str, tuple] = {}   # device-live version per name
    dead: list[tuple] = []             # tombstoned since last re-shard
    pending: dict[str, tuple | None] = {}
    last_rebuilds = -1
    commit_ms: list[float] = []

    def apply_pending_and_commit():
        nonlocal last_rebuilds
        t0 = time.perf_counter()
        engine.commit()
        commit_ms.append((time.perf_counter() - t0) * 1e3)
        if mirror is not None:
            mirror.commit()
        for name, doc in pending.items():
            if name in committed:
                old = committed.pop(name)
                dead.append((old[0], old[2]))
            if doc is not None:
                committed[name] = doc
        pending.clear()
        rb = engine.index.rebuilds
        if rb != last_rebuilds:
            dead.clear()   # a re-shard drops tombstones from the stats
            last_rebuilds = rb

    def check(queries):
        hits = engine.search_batch(queries, k=TOP_K)
        oracle_check(hits, committed, dead, queries, live_stats=live_stats)
        if on_commit is not None:
            on_commit(engine, mirror, queries, hits)

    t0 = time.perf_counter()
    from tfidf_tpu_torch.bench import make_doc_arrays
    offsets, ids, tfs, lengths = make_doc_arrays(rng, base_docs, V, AVG_LEN)
    for i in range(base_docs):
        lo, hi = offsets[i], offsets[i + 1]
        for e in engines:
            e.index.add_document_arrays(f"d{i:06d}", ids[lo:hi], tfs[lo:hi],
                                        float(lengths[i]))
        pending[f"d{i:06d}"] = (ids[lo:hi].astype(np.int32), tfs[lo:hi],
                                float(lengths[i]))
    last_rebuilds = engine.index.rebuilds
    apply_pending_and_commit()
    base_commit_s = time.perf_counter() - t0
    log(f"[{layout}] base: {base_docs} docs committed in "
        f"{base_commit_s:.1f}s (rebuilds={engine.index.rebuilds})")

    check([make_query(rng) for _ in range(QUERIES_PER_CHECK)])
    log(f"[{layout}] base parity OK ({QUERIES_PER_CHECK} queries, "
        f"top-{TOP_K})")

    next_id = base_docs
    commits = checks = 1
    round_s: list[float] = []
    for rnd in range(rounds):
        t0 = time.perf_counter()
        ops = []
        for _ in range(new_per_round):
            ops.append(("up", f"d{next_id:06d}"))
            next_id += 1
        live_names = sorted(set(committed) | {
            n for n, d in pending.items() if d is not None})
        for n in rng.choice(live_names, size=reup_per_round, replace=False):
            ops.append(("up", str(n)))
        for n in rng.choice(live_names, size=del_per_round, replace=False):
            ops.append(("del", str(n)))
        rng.shuffle(ops)
        for op, name in ops:
            if op == "up":
                dids, dtfs, dlen = random_doc(rng)
                for e in engines:
                    e.index.add_document_arrays(name, dids, dtfs, dlen)
                pending[name] = (dids, dtfs, dlen)
            else:
                existed = {e.delete(name) for e in engines}
                assert existed == {name in committed or
                                   pending.get(name) is not None}, name
                pending[name] = None
        apply_pending_and_commit()
        round_s.append(time.perf_counter() - t0)
        check([make_query(rng) for _ in range(QUERIES_PER_CHECK)])
        commits += 1
        checks += 1
        log(f"[{layout}] round {rnd}: {len(ops)} ops, churn+commit "
            f"{round_s[-1]:.1f}s (commit {commit_ms[-1]:.1f} ms), "
            f"live={len(committed)}, dead={len(dead)}, "
            f"rebuilds={engine.index.rebuilds}, parity OK")

    return {"layout": layout, "base_docs": base_docs, "final_live_docs": len(committed),
            "rounds": rounds, "commits": commits,
            "ops_per_round": new_per_round + reup_per_round + del_per_round,
            "queries_per_check": QUERIES_PER_CHECK, "parity_checks": checks,
            "top_k": TOP_K, "rebuilds": int(engine.index.rebuilds),
            "appends": int(engine.index.appends),
            "base_commit_s": base_commit_s, "commit_ms": commit_ms,
            "round_s": round_s, "parity_checked": True}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="the ranks' device (default: the CUDA card)")
    ap.add_argument("--mesh", default="8x1",
                    help="the mesh's shape, DOCSxTERMS (default 8x1)")
    ap.add_argument("--out", default=os.path.join("build", "mesh_churn"))
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.mesh.lower().split("x"))
    import torch
    from tfidf_tpu_torch.device import resolve_device
    from tfidf_tpu_torch.ops import ell
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    card = None
    if dev.type == "cuda":
        from tfidf_tpu_torch import kernels
        dev = torch.device("cuda", dev.index or 0)
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
        print(card, flush=True)
        t0 = time.perf_counter()
        kernels.build_all()
        log(f"[probe] kernels built in {time.perf_counter() - t0:.1f}s")
    t_all = time.perf_counter()
    out = {"device": str(dev), "card": card, "mesh": list(shape),
           "numpy": np.__version__, "layouts": {}}
    for layout in ("ell", "coo"):
        ell.reset_launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = run_layout(port_engine(layout, str(dev), shape), layout)
        res["wall_s"] = time.perf_counter() - t0
        res["launches"] = dict(ell.launches)
        if dev.type == "cuda":
            res["device_peak_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        out["layouts"][layout] = res
    out["wall_s"] = time.perf_counter() - t_all
    if dev.type == "cuda" and not out["layouts"]["ell"]["launches"]["v4"]:
        raise SystemExit("mesh churn: the ELL layout launched no v4 kernel")
    out["parity_checked"] = all(
        v["parity_checked"] for v in out["layouts"].values())
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "mesh_churn.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: {kk: v[kk] for kk in (
        "final_live_docs", "commits", "parity_checks", "rebuilds",
        "appends", "wall_s", "launches")} for k, v in
        out["layouts"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
