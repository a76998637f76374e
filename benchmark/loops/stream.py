"""Streaming traffic: a shard bulk-loaded as one segment, then, in the
window, three clients at once, as a Rally-style track drives a search
engine that takes updates:

* one bulk client sends upload requests of ``request`` operations each,
  due ``upload_rate`` times a second on a fixed schedule (one at a time;
  a request that runs long makes the next late, and its visibility is
  timed from its due time): text passages through ``Engine.ingest_text``,
  each operation with probability ``delete_share`` an ``Engine.delete``
  of a live passage and with ``upsert_share`` new text for one;
* a refresh thread calls ``Engine.commit()`` every ``refresh_s`` seconds
  (the configuration's refresh interval);
* independent users send single queries on a Poisson schedule at the
  cell's fixed ``query_rate`` into a ``QueryBatcher`` built as a worker
  node builds it from ``Config``; each is timed from its due time.

Every operation and commit is logged in order under one lock, so which
operations a commit holds is known exactly. Each committed snapshot's
segment name lists are kept (references only) so that the check can
tell which deleted or replaced rows a snapshot still counts in its
statistics: the one piece of the system's state the reference follows
(a tombstoned passage counts in df, N and avgdl until its segment
merges). Deletes and upserts touch each passage at most once, and only
passages of the bulk-loaded shard.
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

        from tfidf_tpu_torch.cluster.batcher import QueryBatcher
        from tfidf_tpu_torch.cluster.router import _linger_bounds
        from tfidf_tpu_torch.engine.engine import Engine
        from tfidf_tpu_torch.utils.config import Config

        ov = overrides or {}
        cfg = dict(cell.config, **ov.get("config", {}))
        tr = dict(cell.traffic, **ov.get("traffic", {}))
        wl = dict(cell.workload, **ov.get("workload", {}))
        self.cell, self.cfg, self.tr, self.wl = cell, cfg, tr, wl
        self.seed, self.device, self.seconds = seed, device, float(seconds)
        self.k = int(tr["k"])
        V = int(cfg["vocab"])
        g = corpus.generator(seed, device)
        self.bulk = corpus.doc_arrays(g, int(cfg["docs"]), V,
                                      cfg["mean_len"], int(cfg["min_len"]),
                                      cfg["zipf_a"], device)
        n_bulk = self.bulk[0].shape[0] - 1
        self.n_bulk = n_bulk
        # the upload pool: passages' text, taken in turn by the bulk client
        self.req = int(tr["request"])
        p_off, p_ids = corpus.token_seqs(
            g, int(tr["pool_requests"]) * self.req, V, cfg["mean_len"],
            int(cfg["min_len"]), cfg["zipf_a"], device)
        tokens = corpus.Tokens(V)
        self.pool = tokens.texts(p_off, p_ids)
        self.pool_ids = (p_off, p_ids)
        # the passages that deletes and upserts touch, once each, in order
        self.touch = torch.randperm(n_bulk, generator=g,
                                    device=device).cpu().numpy()
        self.tokens = tokens
        self.schedule(float(wl["query_rate"]), g)
        del g
        offsets, ids, tfs, lengths = self.bulk
        prog_ids, present = corpus.remap_present(ids, V)
        self.names = [f"p{i}" for i in range(n_bulk)]
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        c = Config(**cfg["engine"])
        self.engine = Engine(c, device=None if device == "cuda" else device)
        self.engine.vocab.extend(tokens.table[present].tolist())
        self.engine.index.bulk_load_packed(self.names, offsets, prog_ids,
                                           tfs, lengths)
        del prog_ids
        self.batcher = QueryBatcher(
            self.engine, max_batch=c.query_batch,
            linger_s=c.batch_linger_ms / 1e3, pipeline=c.batch_pipeline,
            **_linger_bounds(c.batch_linger_min_ms, c.batch_linger_max_ms))
        self.max_batch = c.query_batch
        self.H = threading.Lock()
        self.ops = []          # (kind, name, pool index or -1)
        # (start, published, ops held, version, name lists, synchronized)
        self.commits = []
        self.upload_errors = []
        self._fresh = itertools.count()
        self._touched = 0
        self._commit()
        self._warm()

    def schedule(self, rate: float, g=None) -> None:
        """The window's queries: Poisson arrivals at ``rate`` a second,
        each a uniform ``terms_min``..``terms_max`` Zipf terms, and the
        sample of them the check holds to the reference."""
        import torch
        if g is None:
            g = corpus.generator(self.seed + 1, self.device)
        tr, cfg = self.tr, self.cfg
        n_max = int(rate * self.seconds * 1.5) + 64
        gaps_s = -torch.log(1.0 - torch.rand(
            n_max, generator=g, device=self.device,
            dtype=torch.float64)) / rate
        due = torch.cumsum(gaps_s, 0).cpu().numpy()
        self.due = due[due < self.seconds]
        q_off, q_ids = corpus.query_terms(
            g, self.due.shape[0], int(cfg["vocab"]), int(tr["terms_min"]),
            int(tr["terms_max"]), cfg["zipf_a"], self.device)
        self.queries = self.tokens.texts(q_off, q_ids)
        rng = np.random.default_rng([self.seed, 11])
        self.sampled = set(rng.choice(
            len(self.queries), min(int(self.wl["check"]), len(self.queries)),
            replace=False).tolist())

    # ---- the system's calls ----

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch
            torch.cuda.current_stream().synchronize()

    def _commit(self, span=quiet) -> None:
        """One refresh: the operations logged before it are the ones it
        holds; what it publishes is searchable when ``commit()`` returns
        (``c1``); its clock closes at a synchronize of the stream
        (``c2``)."""
        with span("bench.commit"):
            with self.H:
                c0 = time.perf_counter()
                n = len(self.ops)
                self.engine.commit()
                c1 = time.perf_counter()
                snap = self.engine.index.snapshot
            self._sync()
            c2 = time.perf_counter()
        self.commits.append((c0, c1, n, snap.version,
                             [s.names for s in snap.segments], c2))

    def _request(self, r: int, span=quiet) -> tuple:
        """One upload request; returns (passages ingested, failures)."""
        # each operation is a delete or an upsert with its share's
        # probability, else a new passage
        u = np.random.default_rng([self.seed, 13, r + 1]).random(self.req)
        d_share = float(self.tr["delete_share"])
        kind = np.where(u < d_share, 1, np.where(
            u < d_share + float(self.tr["upsert_share"]), 2, 0))
        ingested, failed = 0, 0
        with span("bench.upload"):
            for k in kind.tolist():
                if k == 0:
                    j = next(self._fresh)
                    op = ("add", f"w{j}", j % len(self.pool))
                else:
                    if self._touched >= self.n_bulk:
                        raise RuntimeError("every bulk passage touched")
                    name = self.names[self.touch[self._touched]]
                    self._touched += 1
                    op = (("delete", name, -1) if k == 1 else
                          ("upsert", name,
                           next(self._fresh) % len(self.pool)))
                try:
                    with self.H:
                        if op[0] == "delete":
                            if not self.engine.delete(op[1]):
                                raise KeyError(f"delete of {op[1]} "
                                               f"found nothing")
                        else:
                            self.engine.ingest_text(op[1],
                                                    self.pool[op[2]])
                        self.ops.append(op)
                except Exception as e:     # counted as a failed operation
                    failed += 1
                    self.upload_errors.append(repr(e))
                    continue
                ingested += op[0] != "delete"
        return ingested, failed

    def _warm(self) -> None:
        """One upload request and a commit (the ingest path, a segment
        build, the merge threads' pool), then one search of every batch
        shape the batcher can form, and a few through the batcher."""
        self._request(-1)
        self._commit()
        n = 1
        while n <= self.max_batch:
            self.engine.search_batch(self.queries[:n] or ["t1"], k=self.k)
            n *= 2
        th = [threading.Thread(target=self.batcher.search, args=(q,),
                               kwargs={"k": self.k})
              for q in self.queries[:64]]
        for t in th:
            t.start()
        for t in th:
            t.join()
        self._sync()

    # ---- the measured window ----

    def window(self, seconds: float, span=quiet) -> None:
        from tfidf_tpu_torch.utils.metrics import global_metrics
        assert float(seconds) == self.seconds
        self.counters0 = global_metrics.snapshot()
        self.start = time.perf_counter()
        self.end = self.start + self.seconds
        self.requests = []     # (due, start, end, ingested, failed)
        self.answers = {}      # query -> (due, sent, done, err)
        self.kept = {}         # sampled query -> (hits, v_before, v_after)
        stop_refresh = threading.Event()
        idx = itertools.count()
        qlock = threading.Lock()
        refresh_s = float(self.cfg["refresh_s"])

        interval = 1.0 / float(self.tr["upload_rate"])

        def uploader() -> None:
            for r in itertools.count():
                due = self.start + r * interval
                if due >= self.end:
                    return
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                t0 = time.perf_counter()
                ing, bad = self._request(r, span)
                self.requests.append((due, t0, time.perf_counter(), ing,
                                      bad))

        def refresher() -> None:
            i = 1
            while not stop_refresh.is_set():
                delay = self.start + i * refresh_s - time.perf_counter()
                if delay > 0 and stop_refresh.wait(delay):
                    return
                self._commit(span)
                i += 1

        def querier() -> None:
            while True:
                with qlock:
                    j = next(idx)
                if j >= len(self.queries):
                    return
                due = self.start + self.due[j]
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                sent = time.perf_counter()
                v0 = self.engine.index.snapshot.version
                err, hits = None, None
                with span("bench.query"):
                    try:
                        hits = self.batcher.search(self.queries[j],
                                                   k=self.k)
                    except Exception as e:   # counted as failed
                        err = repr(e)
                done = time.perf_counter()
                v1 = self.engine.index.snapshot.version
                self.answers[j] = (due, sent, done, err)
                if j in self.sampled and hits is not None:
                    self.kept[j] = (list(hits), v0, v1)

        up = threading.Thread(target=uploader, name="bench-upload")
        rf = threading.Thread(target=refresher, name="bench-refresh")
        qs = [threading.Thread(target=querier, name=f"bench-query{i}")
              for i in range(int(self.tr["query_threads"]))]
        for t in [up, rf] + qs:
            t.start()
        for t in [up] + qs:
            t.join()
        # every request of the window becomes searchable at the first
        # refresh that starts after it returned: keep refreshing until one
        # has (its end is the request's visibility)
        last = max((r[2] for r in self.requests), default=0.0)
        while not any(c0 >= last for c0, *_ in self.commits):
            time.sleep(0.01)
        stop_refresh.set()
        rf.join()
        self._sync()
        self.counters1 = global_metrics.snapshot()

    def finish(self) -> None:
        """After the window: let the merges settle, refresh once more,
        and read back through the batcher a sample of what was uploaded,
        replaced and deleted (each by its rarest terms)."""
        self.engine.index.wait_for_merges()
        self._commit()
        rng = np.random.default_rng([self.seed, 17])
        want = int(self.wl["read_back"])
        groups = {"add": [], "upsert": [], "delete": []}
        for o, (kind, name, c) in enumerate(self.ops):
            groups[kind].append(o)
        picks = []
        for kind, os_ in groups.items():
            if os_:
                picks += rng.choice(os_, min(want, len(os_)),
                                    replace=False).tolist()
        df = np.bincount(self.bulk[1], minlength=int(self.cfg["vocab"]))
        p_off, p_ids = self.pool_ids
        texts = []
        for o in sorted(picks):
            kind, name, c = self.ops[o]
            if kind == "delete":
                i = int(name[1:])
                ids = self.bulk[1][self.bulk[0][i]:self.bulk[0][i + 1]]
            else:
                ids = np.unique(p_ids[p_off[c]:p_off[c + 1]])
            rare = ids[np.argsort(df[ids], kind="stable")[:4]]
            texts.append(" ".join(f"t{t}" for t in rare.tolist()))
        out = [None] * len(texts)

        def ask(i: int) -> None:
            v0 = self.engine.index.snapshot.version
            try:
                out[i] = (self.batcher.search(texts[i], k=self.k), v0,
                          self.engine.index.snapshot.version, None)
            except Exception as e:
                out[i] = (None, v0, v0, repr(e))

        th = [threading.Thread(target=ask, args=(i,))
              for i in range(len(texts))]
        for t in th:
            t.start()
        for t in th:
            t.join()
        self.read_back = list(zip(texts, out))
        self.batcher.stop()

    # ---- metrics ----

    def _visible_at(self, t_end: float) -> float | None:
        return next((c1 for c0, c1, *_ in self.commits if c0 >= t_end),
                    None)

    def end_to_end(self) -> dict:
        lat = [(done - due) * 1e3 for due, _s, done, err
               in self.answers.values()]
        vis = [(self._visible_at(e) - due) * 1e3
               for due, _s, e, _i, _f in self.requests]
        return {"query_p95_ms": stats.percentile(lat, 95),
                "visible_p95_ms": stats.percentile(vis, 95)}

    def uploads(self) -> dict:
        """How the bulk client kept its schedule: passages made searchable
        by the window's end over its seconds, against the rate offered,
        and how late its requests started (a sweep's reading: on a fixed
        schedule the first only repeats the offer until uploads fall
        behind)."""
        searchable = sum(i for _d, _s, e, i, _f in self.requests
                         if self._visible_at(e) <= self.end)
        late = [(s - due) * 1e3 for due, s, *_ in self.requests]
        return {"docs_s": stats.rate(searchable, self.seconds),
                "offered_docs_s": float(self.tr["upload_rate"]) * self.req
                * (1 - float(self.tr["delete_share"])),
                "late_p95_ms": stats.percentile(late, 95),
                "late_last_ms": late[-1] if late else 0.0,
                "request_p50_ms": stats.median(
                    [(e - s) * 1e3 for _d, s, e, _i, _f in self.requests])}

    def lateness_ms(self) -> dict:
        late = [(sent - due) * 1e3 for due, sent, _d, _e
                in self.answers.values()]
        return {"p95": stats.percentile(late, 95), "max": max(late)}

    def counts(self) -> tuple[int, int]:
        """(queries and upload requests sent, those that failed)."""
        q_failed = sum(1 for a in self.answers.values() if a[3] is not None)
        r_failed = sum(1 for r in self.requests if r[4])
        return (len(self.queries) + len(self.requests), q_failed + r_failed)

    def context(self) -> dict:
        win = [c for c in self.commits if self.start <= c[0] < self.end]
        return {
            "counters": (self.counters0, self.counters1),
            "clocks": {
                "commit_ms": [(c[5] - c[0]) * 1e3 for c in win],
                "request_ms": [(e - s) * 1e3 for _d, s, e, _i, _f
                               in self.requests]},
        }

    def release(self) -> None:
        self.engine = self.batcher = None

    # ---- correctness ----

    def _reference(self):
        """The reference's rows: the bulk shard, then one row per
        uploaded text, in the order of the log."""
        offsets, ids, tfs, lengths = self.bulk
        rows = bm25.Rows(offsets, ids, tfs, lengths)
        vocab = bm25.Vocabulary(int(self.cfg["vocab"]))
        content, row_of = {}, []
        for kind, _name, c in self.ops:
            if kind == "delete":
                row_of.append(-1)
                continue
            if c not in content:
                content[c] = vocab.counts(self.pool[c], add=True)
            row_of.append(rows.append(*content[c]))
        rows.freeze(len(vocab))
        return rows, vocab, np.asarray(row_of, np.int64)

    def check(self, verdict, precision: str = "f64") -> None:
        """Every number compared, from the log, the kept answers and the
        reference. With ``precision`` "tf32" the reference in TF32 stands
        in for the system's answers (the control)."""
        from concurrent.futures import ThreadPoolExecutor
        import os

        rows, vocab, row_of = self._reference()
        ops, nb = self.ops, self.n_bulk
        touched_at = {}             # bulk name -> (op index, kind)
        added = {}                  # name -> (op index, row) of its text
        for o, (kind, name, _c) in enumerate(ops):
            if kind != "add" and name.startswith("p"):
                touched_at[name] = (o, kind)
            if kind != "delete":
                added[name] = (o, int(row_of[o]))
        name_of_row = {r: nm for nm, (_o, r) in added.items()}
        # window rows are appended in log order: the first n operations
        # hold rows nb .. nb + m[n] - 1
        m = np.concatenate([[0], np.cumsum(row_of >= 0)])
        bulk_df = rows.df_range(0, nb)
        bulk_len = float(rows.lengths[:nb].sum())

        # the first commit to publish each version fixes what it holds; a
        # later commit that publishes it again after more acknowledged
        # operations left them out
        first, stale = {}, 0
        for _c0, _c1, n, v, lists, _c2 in self.commits:
            if v not in first:
                first[v] = (n, lists)
            elif first[v][0] != n:
                stale += 1
        verdict.set("stale_commits", stale)

        list_counts = {}

        def counts_in(lst):
            if id(lst) not in list_counts:
                cnt = {}
                for nm in lst:
                    if nm in touched_at:
                        cnt[nm] = cnt.get(nm, 0) + 1
                list_counts[id(lst)] = (len(lst), cnt)
            return list_counts[id(lst)]

        # what to judge: (ops held, segment lists, query, answer, key)
        tasks = []
        for j in sorted(self.kept):
            hits, v0, v1 = self.kept[j]
            for v in first:
                if v0 <= v <= v1:
                    tasks.append((first[v][0], first[v][1],
                                  self.queries[j], hits, ("q", j)))
        failed_reads = 0
        for i, (text, (hits, _v0, v1, err)) in enumerate(self.read_back):
            if err is not None:
                failed_reads += 1
                continue
            # after the last refresh every acknowledged operation counts
            tasks.append((len(ops), first.get(v1, (0, []))[1], text, hits,
                          ("r", i)))
        tasks.sort(key=lambda t: t[0])

        states, faults = {}, 0
        df_at = [0, np.zeros_like(bulk_df), 0.0]   # running window df

        def window_stats(n):
            hi = int(m[n])
            if hi < df_at[0]:
                df_at[:] = [0, np.zeros_like(bulk_df), 0.0]
            df_at[1] = df_at[1] + rows.df_range(nb + df_at[0], nb + hi)
            df_at[2] += float(rows.lengths[nb + df_at[0]:nb + hi].sum())
            df_at[0] = hi
            return df_at[1], df_at[2], hi

        for n, lists, *_ in tasks:
            key = (n, tuple(map(id, lists)))
            if key in states:
                continue
            total, cnt = 0, {}
            for lst in lists:
                ln, c = counts_in(lst)
                total += ln
                for nm, x in c.items():
                    cnt[nm] = cnt.get(nm, 0) + x
            live = np.zeros(len(rows), bool)
            w_df, w_len, hi = window_stats(n)
            live[:nb + hi] = True
            purged, bad = [], False
            for nm, (o, kind) in touched_at.items():
                x = cnt.get(nm, 0)
                if o >= n:
                    bad |= x != 1
                    continue
                i = int(nm[1:])
                live[i] = False
                retained = x - (kind == "upsert")
                bad |= retained not in (0, 1)
                if retained == 0:
                    purged.append(i)
            counted = nb - len(purged) + hi
            bad |= counted != total
            faults += bad
            purged = np.asarray(purged, np.int64)
            df = bulk_df + w_df - (rows.df(purged) if purged.size else 0.0)
            tl = bulk_len + w_len - rows.total_len(purged)
            st = bm25.Stats(df, counted, tl)
            st.norm(rows)
            states[key] = (st, live, n)

        def name(r):
            return self.names[r] if r < nb else name_of_row[r]

        def judge(task):
            n, lists, text, hits, tag = task
            st, live, _n = states[(n, tuple(map(id, lists)))]
            terms, w = bm25.query_terms(vocab, text)
            acc = bm25.scores(rows, st, terms, w, live)
            ref_top = [(name(r), v) for r, v in zip(*bm25.top_k(acc,
                                                                self.k))]
            if precision == "tf32":
                got = [(name(r), v) for r, v in zip(*bm25.top_k(
                    bm25.scores(rows, st, terms, w, live, "tf32"), self.k))]
            else:
                got = [(h.name, float(h.score)) for h in hits]

            def ref_score(nm):
                o, r = added.get(nm, (None, None))
                if o is not None and o < n:
                    return float(acc[r])
                i = int(nm[1:]) if nm[:1] == "p" and nm[1:].isdigit() \
                    else -1
                return float(acc[i]) if 0 <= i < nb else 0.0
            return tag, gaps(got, ref_top, ref_score)

        with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
            judged = list(pool.map(judge, tasks))
        best = {}
        for tag, g in judged:
            if tag not in best or sum(g) < sum(best[tag]):
                best[tag] = g
        verdict.set("score_gap", max((g[0] for g in best.values()),
                                     default=0.0))
        verdict.set("doc_gap", max((g[1] for g in best.values()),
                                   default=0.0))
        # a kept answer that no recorded snapshot can have served
        faults += sum(1 for j in self.kept if ("q", j) not in best)
        verdict.set("row_faults", faults)
        q_failed = sum(1 for a in self.answers.values() if a[3] is not None)
        verdict.set("failed_answers", q_failed + failed_reads)
        verdict.set("failed_uploads", len(self.upload_errors))
