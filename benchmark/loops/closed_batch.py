"""Closed-loop batch traffic: a corpus bulk-loaded into one engine, and
``callers`` threads that each send one ``Engine.search_batch`` of
``batch`` queries, wait for it, and send the next, as a worker's batch
pipeline does under a leader's coalesced scatter.

Traffic parameters (``traffic/<mix>.json``): ``callers``, ``batch``,
``terms_min`` and ``terms_max`` (a query's number of Zipf terms, uniform),
``pool_batches`` (distinct batches drawn from the seed; the callers take
them in turn), ``k``. Configuration (``configs/<config>.json``): the
corpus (``docs``, ``vocab``, ``zipf_a``, ``mean_len``, ``min_len``) and
the engine's ``Config`` settings (``engine``).
"""

from __future__ import annotations

import itertools
import threading
import time

import numpy as np

from harness import corpus, stats
from harness.check import gaps
from harness.trace import quiet
from reference import bm25


class Run:
    def __init__(self, cell, seed: int, device: str, seconds: float,
                 overrides: dict | None = None) -> None:
        import torch

        from tfidf_tpu_torch.engine.engine import Engine
        from tfidf_tpu_torch.utils.config import Config

        cfg = dict(cell.config, **(overrides or {}).get("config", {}))
        tr = dict(cell.traffic, **(overrides or {}).get("traffic", {}))
        self.cell, self.cfg, self.tr, self.seed = cell, cfg, tr, seed
        self.device = device
        self.B, self.k = int(tr["batch"]), int(tr["k"])
        vocab = int(cfg["vocab"])
        g = corpus.generator(seed, device)
        self.corpus = corpus.doc_arrays(
            g, int(cfg["docs"]), vocab, cfg["mean_len"], int(cfg["min_len"]),
            cfg["zipf_a"], device)
        n_q = int(tr["pool_batches"]) * self.B
        self.q_off, self.q_ids = corpus.query_terms(
            g, n_q, vocab, int(tr["terms_min"]), int(tr["terms_max"]),
            cfg["zipf_a"], device)
        del g
        tokens = corpus.Tokens(vocab)
        texts = tokens.texts(self.q_off, self.q_ids)
        self.batches = [texts[i:i + self.B] for i in range(0, n_q, self.B)]
        offsets, ids, tfs, lengths = self.corpus
        self.prog_ids, self.present = corpus.remap_present(ids, vocab)
        self.names = [f"d{i}" for i in range(offsets.shape[0] - 1)]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.engine = Engine(Config(**cfg["engine"]),
                             device=None if device == "cuda" else device)
        self.engine.vocab.extend(tokens.table[self.present].tolist())
        self.engine.index.bulk_load_packed(self.names, offsets,
                                           self.prog_ids, tfs, lengths)
        self.engine.commit()
        self._warm()

    def _warm(self) -> None:
        """The widest batch first, so the searcher's slot space is the
        largest this traffic needs; then every caller's thread once."""
        widest = max(range(len(self.batches)), key=lambda p: len(
            np.unique(self.q_ids[self.q_off[p * self.B]:
                                 self.q_off[(p + 1) * self.B]])))
        self.engine.search_batch(self.batches[widest], k=self.k)
        th = [threading.Thread(target=self.engine.search_batch,
                               args=(self.batches[p],), kwargs={"k": self.k})
              for p in range(min(len(self.batches),
                                 int(self.tr["callers"])))]
        for t in th:
            t.start()
        for t in th:
            t.join()
        self._sync()

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()

    # ---- the measured window ----

    def window(self, seconds: float, span=quiet) -> None:
        from tfidf_tpu_torch.utils.metrics import global_metrics
        self.seconds = float(seconds)
        self.counters0 = global_metrics.snapshot()
        counter = itertools.count()
        calls, kept = [], {}
        lock = threading.Lock()
        P = len(self.batches)
        self.start = time.perf_counter()
        self.end = self.start + self.seconds

        def caller() -> None:
            while True:
                t0 = time.perf_counter()
                if t0 >= self.end:
                    return
                with lock:
                    i = next(counter)
                p = i % P
                err = None
                with span("bench.search"):
                    try:
                        hits = self.engine.search_batch(self.batches[p],
                                                        k=self.k)
                    except Exception as e:   # counted as failed queries
                        err, hits = repr(e), None
                t1 = time.perf_counter()
                rows = np.random.default_rng([self.seed, i]).choice(
                    self.B, 2, replace=False).tolist()
                with lock:
                    calls.append((i, p, t0, t1, err))
                    if hits is not None:
                        for r in rows:
                            kept[(i, r)] = (p, hits[r])

        threads = [threading.Thread(target=caller, name=f"bench-caller{c}")
                   for c in range(int(self.tr["callers"]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._sync()
        self.calls, self.kept = calls, kept
        self.counters1 = global_metrics.snapshot()

    def end_to_end(self) -> dict:
        done = sum(self.B for _i, _p, _t0, t1, err in self.calls
                   if err is None and t1 <= self.end)
        return {"qps": stats.rate(done, self.seconds)}

    def counts(self) -> tuple[int, int]:
        attempted = self.B * len(self.calls)
        failed = self.B * sum(1 for c in self.calls if c[4] is not None)
        return attempted, failed

    def context(self) -> dict:
        """What the per-layer readers take: the pool of batches (each a
        list of its queries' distinct term ids, in the engine's id space)
        and which of them the window ran (``runs``), the corpus df in that
        space, the launch shapes of the ELL kernel's blocks with each
        block's df, and the program's counters at the window's ends."""
        import torch
        rank = np.full(int(self.cfg["vocab"]), -1, np.int64)
        rank[self.present] = np.arange(self.present.shape[0])
        pool = []
        for p in range(len(self.batches)):
            qs = []
            for q in range(p * self.B, (p + 1) * self.B):
                t = rank[self.q_ids[self.q_off[q]:self.q_off[q + 1]]]
                qs.append(np.unique(t[t >= 0]))
            pool.append(qs)
        snap = self.engine.index.snapshot
        blocks, df_blocks = [], []
        for imp_t, term_t, n in zip(snap.ell_impacts_t, snap.ell_terms_t,
                                    snap.ell_live):
            W, rows_cap = imp_t.shape
            hit = imp_t[:, :n] != 0
            df_blocks.append(torch.bincount(
                term_t[:, :n][hit].long(),
                minlength=snap.df.shape[0]).cpu().numpy())
            blocks.append({"width": int(W), "rows_cap": int(rows_cap),
                           "rows": int(n)})
        return {
            "pool": pool,
            "runs": [p for _i, p, _a, _b, err in self.calls if err is None],
            "batch": self.B, "k": self.k,
            "df": np.bincount(self.prog_ids,
                              minlength=self.present.shape[0]),
            "ell": {"blocks": blocks, "df": df_blocks,
                    "vocab_cap": int(snap.df.shape[0]),
                    "u_cap": int(getattr(self.engine.searcher, "_u_floor",
                                         0))},
            "counters": (self.counters0, self.counters1),
        }

    def release(self) -> None:
        self.engine = None

    # ---- correctness ----

    def sample(self, n: int) -> list:
        keys = sorted(self.kept)
        rng = np.random.default_rng([self.seed, 7])
        pick = rng.choice(len(keys), min(n, len(keys)), replace=False)
        return [keys[i] for i in sorted(pick.tolist())]

    def reference(self):
        offsets, ids, tfs, lengths = self.corpus
        rows = bm25.Rows(offsets, ids, tfs, lengths)
        vocab = bm25.Vocabulary(int(self.cfg["vocab"]))
        rows.freeze(len(vocab))
        return rows, vocab, bm25.Stats(rows.df(), len(rows), rows.total_len())

    def check(self, verdict, precision: str = "f64") -> None:
        """Hold a sample of the window's answers to the reference; with
        ``precision`` "tf32" the reference in TF32 stands in for the
        system (the control)."""
        import os
        from concurrent.futures import ThreadPoolExecutor
        rows, vocab, st = self.reference()
        st.norm(rows)
        keys = self.sample(int(self.cell.workload["check"]))
        n_docs = len(self.names)

        def judge(key):
            p, hits = self.kept[key]
            terms, w = bm25.query_terms(vocab, self.batches[p][key[1]])
            acc = bm25.scores(rows, st, terms, w, None)
            ref_top = [(self.names[j], v)
                       for j, v in zip(*bm25.top_k(acc, self.k))]
            if precision == "tf32":
                got = [(self.names[j], v) for j, v in zip(*bm25.top_k(
                    bm25.scores(rows, st, terms, w, None, "tf32"), self.k))]
            else:
                got = [(h.name, float(h.score)) for h in hits]

            def ref_score(name: str) -> float:
                i = int(name[1:]) if name[:1] == "d" and name[1:].isdigit() \
                    else -1
                return float(acc[i]) if 0 <= i < n_docs else 0.0
            return gaps(got, ref_top, ref_score)

        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            judged = list(pool.map(judge, keys))
        verdict.set("failed_answers", self.counts()[1])
        verdict.set("score_gap", max((g[0] for g in judged), default=0.0))
        verdict.set("doc_gap", max((g[1] for g in judged), default=0.0))
