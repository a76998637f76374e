"""Compute-plane health + host-fallback degraded scoring.

The counterpart of ``tfidf_tpu/engine/compute_health.py``. Two pieces the
engine composes around every dispatch:

* :class:`ComputeHealth` — a per-worker state machine over the device's
  observed behaviour: ``healthy -> degraded -> sick`` on consecutive
  classified compute faults (:func:`tfidf_tpu_torch.cluster.resilience.
  classify_compute_fault`), back to healthy on any success. Sick means
  "stop hammering the device": while injected faults made it sick, the
  engine serves from the host fallback and re-probes the device once per
  ``probe_interval_s``. Poison never advances the machine: a poisoned
  output is a query-shaped problem.

* :class:`HostFallbackScorer` — exact scoring on the host CPU for a
  fault the device nemesis injected (the dispatch just failed, or the
  device is sick). A real CUDA error or OOM is never served from here:
  the engine re-raises it. Its replies are the device
  path's to the bit, not an approximation: numpy mirrors of the port's
  scoring (``ops/ell.py``, ``ops/scoring.py``) in the same addition order.

  - ELL blocks: the strided 8-lane accumulation and halving tree of
    ``_lane_sum_w`` (:func:`_lane_reduce`), which the CUDA kernel also
    keeps, over the snapshot's own impacts.
  - COO entries (the COO layout and the ELL residual): the per-entry
    model weights depend on no query, so they are computed once per
    snapshot ON THE DEVICE by the same torch ops on the same slices the
    device scorer runs (``ops.scoring.segment_weights``) and fetched.
    They are never recomputed in numpy: numpy's ``log1p``/``log`` may
    differ from the device's by an ulp. Each run of one document in a
    chunk is summed sequentially from 0, as ``torch.segment_reduce``
    does, then added into the scores.

  The mirror is fetched eagerly, once per committed snapshot
  (:meth:`HostFallbackScorer.prime`, called by ``Engine.commit``), not on
  the first fallback, so a fallback never touches the device (its queries
  are vectorized on the host) and the fetch's cost falls on the commit,
  not on a degraded request.

Scope: the plain :class:`~tfidf_tpu_torch.engine.index.Snapshot` layouts
(blocked ELL + residual, and COO) under the local engine; any other
snapshot raises :class:`FallbackUnsupported`.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from tfidf_tpu_torch.engine.index import Snapshot
from tfidf_tpu_torch.ops.scoring import segment_weights
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics

log = get_logger("engine.compute_health")


# ---------------------------------------------------------------------------
# health state machine
# ---------------------------------------------------------------------------

HEALTHY = "healthy"
DEGRADED = "degraded"
SICK = "sick"


class ComputeHealth:
    """Consecutive-fault escalation with timed recovery probes.

    ``note_fault(kind)`` advances healthy -> degraded (after
    ``degraded_after`` consecutive faults) -> sick (after
    ``sick_after``); ``note_success()`` resets to healthy from any
    state. While sick, :meth:`should_try_device` returns False except
    for ONE probe per ``probe_interval_s`` since the last fault or probe
    (the interval is read at each call, so an operator may shorten it
    while sick); the probe runs the real device path, its success heals
    the machine, its failure re-arms the timer.
    """

    def __init__(self, *, degraded_after: int = 2, sick_after: int = 5,
                 probe_interval_s: float = 5.0, clock=time.monotonic
                 ) -> None:
        self.degraded_after = max(1, int(degraded_after))
        self.sick_after = max(self.degraded_after, int(sick_after))
        self.probe_interval_s = float(probe_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._consecutive = 0
        self._total = 0
        self._by_kind: dict[str, int] = {}
        self._probe_from = 0.0   # last fault or probe while sick
        self._probes = 0

    @property
    def state(self) -> str:
        return self._state

    @property
    def consecutive_faults(self) -> int:
        return self._consecutive

    def note_fault(self, kind: str) -> None:
        if kind == "poison":
            return
        with self._lock:
            self._consecutive += 1
            self._total += 1
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
            if self._consecutive >= self.sick_after:
                if self._state != SICK:
                    log.warning("compute plane SICK: serving from host "
                                "fallback where available",
                                consecutive=self._consecutive, kind=kind)
                self._state = SICK
                self._probe_from = self._clock()
            elif self._consecutive >= self.degraded_after:
                self._state = DEGRADED

    def note_success(self) -> None:
        with self._lock:
            if self._state == SICK:
                log.info("compute plane recovered: device probe "
                         "succeeded", faults_survived=self._total)
            self._consecutive = 0
            self._state = HEALTHY

    def should_try_device(self) -> bool:
        """False only while sick and between probes. Claims (and
        thereby rations) the probe slot: at most one caller per
        interval gets True while sick."""
        with self._lock:
            if self._state != SICK:
                return True
            now = self._clock()
            if now - self._probe_from < self.probe_interval_s:
                return False
            self._probe_from = now
            self._probes += 1
            return True

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_faults": self._consecutive,
                "total_faults": self._total,
                "faults_by_kind": dict(self._by_kind),
                "recovery_probes": self._probes,
            }


class FallbackUnsupported(RuntimeError):
    """The host mirror cannot serve this snapshot bit-exactly. The
    engine re-raises the ORIGINAL device fault instead of inventing
    approximate results."""


# ---------------------------------------------------------------------------
# host kernels (bit-exact mirrors of the port's device scoring)
# ---------------------------------------------------------------------------

def _fetch_host(tensors) -> list:
    """The fallback's one bulk device-to-host stage, once per snapshot."""
    return [t.cpu().numpy() for t in tensors]


_LANES = 8   # lane width of ops.ell._lane_sum_w


def _lane_reduce(x: np.ndarray) -> np.ndarray:
    """Sum f32 ``x [N, W]`` over W via strided 8-lane accumulation +
    halving-tree horizontal sum — the order of ``ops.ell._lane_sum_w``."""
    n, w = x.shape
    pad = (-w) % _LANES
    if pad:
        x = np.concatenate([x, np.zeros((n, pad), np.float32)], axis=1)
    lanes = np.zeros((n, _LANES), np.float32)
    for i in range(x.shape[1] // _LANES):
        lanes = lanes + x[:, i * _LANES:(i + 1) * _LANES]
    v = _LANES
    while v > 1:
        v //= 2
        lanes = lanes[:, :v] + lanes[:, v:2 * v]
    return lanes[:, 0]


def _compile_queries_host(qb, vocab_cap: int):
    """Host mirror of ``ops.scoring._compile_queries`` on a host-side
    QueryBatch: ``slot_of`` drops ids at or past ``vocab_cap`` as the
    device does; ``qc_ext``'s only colliding adds are pad slots of
    weight 0, so the add is exact in any order."""
    u_cap = int(qb.uniq.shape[0])
    uniq = np.asarray(qb.uniq_host[:qb.n_uniq])
    m = int(np.searchsorted(uniq, vocab_cap))
    slots = qb.slots.numpy()
    weights = qb.weights.numpy()
    B = slots.shape[0]
    slot_of = np.full(vocab_cap, u_cap, np.int32)
    slot_of[uniq[:m]] = np.arange(m, dtype=np.int32)
    qc_ext = np.zeros((B, u_cap + 1), np.float32)
    np.add.at(qc_ext, (np.repeat(np.arange(B), slots.shape[1]),
                       slots.reshape(-1)), weights.reshape(-1))
    return slot_of, qc_ext


_ROW_CHUNK = 4096   # bounds the [rows, W, B] temporary


def _score_block_host(imp: np.ndarray, term: np.ndarray,
                      slot_of: np.ndarray,
                      qc_ext: np.ndarray) -> np.ndarray:
    """One ELL block's rows: gather + lane-reduced contraction,
    ``[B, rows]``."""
    B = qc_ext.shape[0]
    rows, w = imp.shape
    qc_t = np.ascontiguousarray(qc_ext.T)               # [U+1, B]
    out = np.empty((B, rows), np.float32)
    for lo in range(0, rows, _ROW_CHUNK):
        imp_c = imp[lo:lo + _ROW_CHUNK]
        term_c = term[lo:lo + _ROW_CHUNK]
        qg = qc_t[slot_of[term_c]]                      # [r, W, B]
        x = qg * imp_c[:, :, None]
        r = x.shape[0]
        out[:, lo:lo + r] = _lane_reduce(
            x.transpose(0, 2, 1).reshape(r * B, w)).reshape(r, B).T
    return out


def _score_coo_host(w: np.ndarray, term: np.ndarray, runs: list,
                    slot_of: np.ndarray, qc_ext: np.ndarray,
                    doc_cap: int) -> np.ndarray:
    """Mirror of ``score_coo_compiled`` over prefetched entry weights:
    per chunk, each run of one document summed sequentially from 0
    (``np.add.at`` applies in index order, as ``segment_reduce`` adds),
    then added into that document's scores."""
    B = qc_ext.shape[0]
    scores = np.zeros((B, doc_cap), np.float32)
    rows = np.arange(B)[:, None]
    for lo, hi, lengths, docs in runs:
        contrib = qc_ext[:, slot_of[term[lo:hi]]] * w[lo:hi][None, :]
        run_of = np.repeat(np.arange(lengths.shape[0]), lengths)
        sums = np.zeros((B, lengths.shape[0]), np.float32)
        np.add.at(sums, (rows, run_of[None, :]), contrib)
        scores[:, docs] += sums
    return scores


def _host_topk(scores: np.ndarray, num_docs: int,
               kk: int) -> tuple[np.ndarray, np.ndarray]:
    """Mirror of ``ops.topk.exact_topk``: pads masked to -inf, stable
    descending sort (ties -> lower doc id)."""
    doc_cap = scores.shape[1]
    masked = np.where(np.arange(doc_cap)[None, :] < num_docs, scores,
                      np.float32(-np.inf)).astype(np.float32)
    order = np.argsort(-masked, axis=1, kind="stable")[:, :kk]
    vals = np.take_along_axis(masked, order, axis=1)
    return vals, order.astype(np.int32)


def _host_full_ranking(scores: np.ndarray,
                       rank_n: int) -> tuple[np.ndarray, np.ndarray]:
    """Mirror of ``ops.topk.full_ranking`` (stable descending sort)."""
    s = scores[:, :rank_n]
    order = np.argsort(-s, axis=-1, kind="stable")
    return np.take_along_axis(s, order, axis=-1), order.astype(np.int32)


# ---------------------------------------------------------------------------
# snapshot mirror + scorer
# ---------------------------------------------------------------------------

def _coo_mirror(snap: Snapshot, tf, term, doc, plan, skw: dict):
    """``(w, term, runs)`` of one COO entry array: the weights and the
    plan's runs of equal doc, fetched from the device."""
    if not plan:
        return np.zeros(0, np.float32), np.zeros(0, np.int32), []
    import torch
    w = torch.cat([w for _seg, w in segment_weights(
        tf, term, doc, snap.doc_len, snap.df, snap.n_docs, snap.avgdl,
        snap.doc_norms, plan, model=skw["model"],
        k1=float(skw.get("k1", 1.2)), b=float(skw.get("b", 0.75)))])
    w, term_h = _fetch_host([w, term[:plan[-1].hi]])
    fetched = _fetch_host([t for seg in plan
                           for t in (seg.lengths, seg.docs)])
    runs = [(seg.lo, seg.hi, fetched[2 * i], fetched[2 * i + 1])
            for i, seg in enumerate(plan)]
    return w, term_h, runs


class _SnapshotMirror:
    """Host-resident copy of one committed Snapshot, ready to score."""

    __slots__ = ("snap", "kind", "imps", "terms", "live", "res", "coo",
                 "vocab_cap", "doc_cap", "num_docs", "nbytes", "build_s")

    def __init__(self, snap: Snapshot, skw: dict) -> None:
        t0 = time.perf_counter()
        self.snap = snap
        self.vocab_cap = int(snap.df.shape[0])
        self.doc_cap = int(snap.doc_len.shape[0])
        self.num_docs = snap.num_docs
        self.res = self.coo = None
        if snap.is_ell:
            self.kind = "ell"
            # only each block's live rows: the rows past them score 0
            self.live = tuple(int(n) for n in snap.ell_live)
            nb = len(snap.ell_impacts)
            fetched = _fetch_host(
                [i[:n] for i, n in zip(snap.ell_impacts, self.live)]
                + [t[:n] for t, n in zip(snap.ell_terms, self.live)])
            self.imps, self.terms = fetched[:nb], fetched[nb:]
            if snap.res_tf is not None:
                self.res = _coo_mirror(snap, snap.res_tf, snap.res_term,
                                       snap.res_doc, snap.res_plan, skw)
        else:
            self.kind = "coo"
            self.imps = self.terms = self.live = ()
            self.coo = _coo_mirror(snap, snap.tf, snap.term, snap.doc,
                                   snap.coo_plan, skw)
        arrays = [*self.imps, *self.terms]
        for part in (self.res, self.coo):
            if part is not None:
                arrays += [part[0], part[1]] + [
                    a for r in part[2] for a in r[2:]]
        self.nbytes = int(sum(a.nbytes for a in arrays))
        self.build_s = time.perf_counter() - t0

    def scores(self, qb) -> np.ndarray:
        """``[B, doc_cap]`` f32 — bit-equal to the device scorer."""
        slot_of, qc_ext = _compile_queries_host(qb, self.vocab_cap)
        if self.kind == "coo":
            w, term, runs = self.coo
            return _score_coo_host(w, term, runs, slot_of, qc_ext,
                                   self.doc_cap)
        scores = np.empty((qc_ext.shape[0], self.doc_cap), np.float32)
        row0 = 0
        for imp, term, live in zip(self.imps, self.terms, self.live):
            scores[:, row0:row0 + live] = _score_block_host(
                imp, term, slot_of, qc_ext)
            row0 += live
        scores[:, row0:] = 0.0
        if self.res is not None:
            w, term, runs = self.res
            scores = scores + _score_coo_host(w, term, runs, slot_of,
                                              qc_ext, self.doc_cap)
        return scores


class HostFallbackScorer:
    """Exact host-CPU serving for a sick device — mirrors the local
    :class:`~tfidf_tpu_torch.engine.searcher.Searcher`'s query pipeline
    (same chunking, same vectorizer, same assembly) with numpy kernels
    bit-equal to the device path. No pipelining: a degraded reply is
    slower and says so on the wire (``X-Compute-Degraded``)."""

    def __init__(self, searcher) -> None:
        self.searcher = searcher
        self._lock = threading.Lock()
        self._mirror: _SnapshotMirror | None = None

    def _mirror_for(self, snap) -> _SnapshotMirror:
        if not isinstance(snap, Snapshot):
            raise FallbackUnsupported(
                f"no host mirror for snapshot type "
                f"{type(snap).__name__}")
        with self._lock:
            m = self._mirror
            if m is None or m.snap is not snap:
                m = _SnapshotMirror(snap,
                                    self.searcher.model.score_kwargs())
                self._mirror = m
                global_metrics.inc("compute_fallback_mirror_builds")
                log.info("fallback mirror built", kind=m.kind,
                         host_bytes=m.nbytes, seconds=round(m.build_s, 3))
            return m

    def prime(self) -> None:
        """Fetch the mirror of the committed snapshot now (commit time),
        so a later fallback needs nothing from the device."""
        snap = self.searcher.index.snapshot
        if snap is not None and snap.num_names:
            self._mirror_for(snap)

    def mirror_stats(self) -> dict:
        """Host bytes and build seconds of the current mirror."""
        m = self._mirror
        if m is None:
            return {"built": False}
        return {"built": True, "kind": m.kind, "host_bytes": m.nbytes,
                "build_s": m.build_s}

    def _vectorize(self, queries: list[str], cap: int):
        """The searcher's vectorizer, on the host (never the device)."""
        from tfidf_tpu_torch.engine.searcher import vectorize_queries
        s = self.searcher
        qb, _w = vectorize_queries(
            queries, s.analyzer, s.vocab, s.model, batch_cap=cap,
            max_terms=s.max_query_terms, min_slots=s._u_floor,
            device="cpu")
        return qb

    def search(self, queries: list[str], k: int | None = None,
               *, unbounded: bool = False) -> list[list]:
        s = self.searcher
        snap = s.index.snapshot
        if snap is None or not snap.num_names or not queries:
            return [[] for _ in queries]
        m = self._mirror_for(snap)
        k = s.top_k if k is None else k
        cap = s._batch_cap(len(queries))
        out: list[list] = []
        for lo in range(0, len(queries), cap):
            chunk = queries[lo:lo + cap]
            scores = m.scores(self._vectorize(chunk, cap))
            if unbounded:
                rank_n = snap.num_names
                vals, ids = _host_full_ranking(scores, rank_n)
                out.extend(s._assemble(snap, chunk, vals, ids, rank_n))
            else:
                kk = min(k, snap.num_names)
                vals, ids = _host_topk(scores, m.num_docs, kk)
                out.extend(s._assemble(snap, chunk, vals, ids, kk))
        global_metrics.inc("queries_served", len(queries))
        return out

    def search_arrays(self, queries: list[str], k: int | None = None):
        s = self.searcher
        snap = s.index.snapshot
        k = s.top_k if k is None else k
        if snap is None or not snap.num_names or not queries:
            n = len(queries)
            return (np.zeros((n, 0), np.float32),
                    np.zeros((n, 0), np.int32), 0, [])
        m = self._mirror_for(snap)
        kk = min(k, snap.num_names)
        cap = s._batch_cap(len(queries))
        all_vals, all_ids = [], []
        for lo in range(0, len(queries), cap):
            chunk = queries[lo:lo + cap]
            vals, ids = _host_topk(m.scores(self._vectorize(chunk, cap)),
                                   m.num_docs, kk)
            all_vals.append(vals[:len(chunk)])
            all_ids.append(ids[:len(chunk)])
        global_metrics.inc("queries_served", len(queries))
        return (np.concatenate(all_vals, axis=0),
                np.concatenate(all_ids, axis=0), kk, snap.doc_names)
