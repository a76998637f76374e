"""Blocked-ELL postings layout and scoring, in PyTorch, plus the wrapper of
the hand-written CUDA block scorer.

The counterpart of the local parts of ``tfidf_tpu/ops/ell.py``. Postings
are laid out as dense ``[rows, width]`` blocks — one padded row of
(term id, impact) pairs per document, documents sorted by distinct-term
count and packed into width buckets from ``ELL_WIDTH_LADDER`` — so
scoring is gathers plus a reduction:

    scores[b, d] = sum_w  qc[b, slot_of[term[d, w]]] * impact[d, w]

Entries beyond the widest bucket spill into a small COO residual scored by
:mod:`tfidf_tpu_torch.ops.scoring`; the partial score tensors add.

Every block inside the kernel envelope (:func:`_pallas_eligible`, the same
envelope as the JAX package, so the same blocks take the kernel in both)
goes through :func:`score_block_kernel`: on a CUDA tensor it launches
``csrc/ell_score.cu`` (or raises), on a CPU tensor it runs the plain
version :func:`score_block_plain`. Both add in the pinned order of
:func:`_lane_sum_w`, so the kernel is bit-identical to the plain path, and
the plain path on the CPU is bit-identical to the JAX ``_score_block``
given the same impacts. Each block's live rows are written straight into
their column slice of the batch's ``[B, doc_cap]`` scores
(:func:`score_ell_impl`).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from tfidf_tpu_torch.ops.csr import CooShard, next_capacity
from tfidf_tpu_torch.ops.scoring import (QueryBatch, Segment,
                                         _compile_queries, bm25_weights,
                                         score_coo_compiled, tfidf_weights)
from tfidf_tpu_torch.utils.device_nemesis import device_guard, poison_scores
from tfidf_tpu_torch.utils.metrics import global_metrics


@dataclass
class EllBlock:
    tf: np.ndarray     # f32 [rows_cap, width]
    term: np.ndarray   # i32 [rows_cap, width] (pad id 0, pad tf 0)
    row0: int          # first shard doc row this block covers
    n_rows: int        # live rows (rows_cap - n_rows are padding)
    width: int


@dataclass
class EllShard:
    """Host-side blocked-ELL build product."""
    blocks: list[EllBlock]
    # residual COO for entries beyond width_cap per doc (often empty)
    res_tf: np.ndarray    # f32 [res_cap]
    res_term: np.ndarray  # i32 [res_cap]
    res_doc: np.ndarray   # i32 [res_cap], non-decreasing
    res_nnz: int


# Width ladder (1.5x steps between powers of two) — identical to the JAX
# package's, so both packages build the same block shapes.
ELL_WIDTH_LADDER = (8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256)


def build_ell_from_coo(coo: CooShard,
                       *,
                       width_cap: int = 256,
                       min_width: int = 8,
                       min_rows: int = 256,
                       min_res_cap: int = 1 << 10) -> EllShard:
    """Vectorized COO -> blocked ELL + residual (host side, commit time).

    Requires the COO invariants from ``ShardIndex.to_coo``: entries grouped
    by doc in increasing row order, rows sorted by distinct-term count
    descending, padding pointing at ``doc_cap - 1`` with tf=0.
    """
    nnz, n_live = coo.nnz, coo.num_docs
    doc_ids = coo.doc[:nnz]
    bounds = np.searchsorted(doc_ids, np.arange(n_live + 1))
    row_len = np.diff(bounds)
    assert (np.diff(row_len) <= 0).all(), \
        "blocked ELL requires rows sorted by length descending"
    pos = np.arange(nnz, dtype=np.int64) - bounds[:-1][doc_ids]

    # bucket width per row from the ladder; the EFFECTIVE cap is the top
    # rung actually built, so spill and blocks partition every entry
    ladder = np.asarray(
        [w for w in ELL_WIDTH_LADDER if min_width <= w <= width_cap]
        or [min(max(min_width, 8), width_cap)], np.int64)
    eff_cap = int(ladder[-1])
    if n_live:
        idx = np.clip(np.searchsorted(ladder, np.minimum(row_len,
                                                         eff_cap)),
                      0, ladder.shape[0] - 1)
        widths = ladder[idx]
    else:
        widths = np.zeros(0, np.int64)
    blocks: list[EllBlock] = []
    row0 = 0
    while row0 < n_live:
        w = int(widths[row0])
        hi = int(np.searchsorted(-widths, -w, side="right"))
        n_rows = hi - row0
        rows_cap = next_capacity(n_rows, min_rows)
        tf = np.zeros((rows_cap, w), np.float32)
        term = np.zeros((rows_cap, w), np.int32)
        sel = (doc_ids >= row0) & (doc_ids < hi) & (pos < w)
        tf[doc_ids[sel] - row0, pos[sel]] = coo.tf[:nnz][sel]
        term[doc_ids[sel] - row0, pos[sel]] = coo.term[:nnz][sel]
        blocks.append(EllBlock(tf=tf, term=term, row0=row0,
                               n_rows=n_rows, width=w))
        row0 = hi

    spill = pos >= eff_cap
    res_nnz = int(spill.sum())
    res_cap = next_capacity(max(res_nnz, 1), min_res_cap)
    res_tf = np.zeros(res_cap, np.float32)
    res_term = np.zeros(res_cap, np.int32)
    # pad rows point at doc_cap-1: keeps res_doc non-decreasing
    res_doc = np.full(res_cap, coo.doc_len.shape[0] - 1, np.int32)
    if res_nnz:
        res_tf[:res_nnz] = coo.tf[:nnz][spill]
        res_term[:res_nnz] = coo.term[:nnz][spill]
        res_doc[:res_nnz] = doc_ids[spill]
    return EllShard(blocks=blocks, res_tf=res_tf, res_term=res_term,
                    res_doc=res_doc, res_nnz=res_nnz)


def _entry_weights(model: str, tf, df_t, dl_col, n_docs, avgdl,
                   norms_col, k1: float, b: float):
    """Per-entry model weights for a [rows, width] block."""
    if model == "bm25":
        return bm25_weights(tf, df_t, dl_col, n_docs, avgdl, k1=k1, b=b)
    if model == "tfidf":
        return tfidf_weights(tf, df_t, n_docs)
    if model == "tfidf_cosine":
        w = tfidf_weights(tf, df_t, n_docs)
        return w / torch.where(norms_col > 0, norms_col,
                               torch.ones_like(norms_col))
    raise ValueError(f"unknown model {model!r}")


def ell_impacts(tf: torch.Tensor,        # f32 [rows, width]
                term: torch.Tensor,      # i32 [rows, width]
                doc_len: torch.Tensor,   # f32 [rows] (this block's rows)
                df: torch.Tensor,        # f32 [vocab_cap]
                n_docs: torch.Tensor, avgdl: torch.Tensor,
                doc_norms: torch.Tensor | None = None,
                *, model: str = "bm25", k1: float = 1.2,
                b: float = 0.75) -> torch.Tensor:
    """Per-entry impact weights [rows, width], precomputed once per
    commit; the query path is then pure gather + reduce."""
    norms_col = None if doc_norms is None else doc_norms[:, None]
    return _entry_weights(model, tf, df[term.long()], doc_len[:, None],
                          n_docs, avgdl, norms_col, k1, b)


# --------------------------------------------------------------------------
# The kernel envelope and variants (same contract as the JAX package)
# --------------------------------------------------------------------------

_PL_TD = 512          # the JAX kernel's doc tile; defines the envelope
_PL_MAX_B = 2048      # largest batch the JAX kernel takes
A_BUILD_VARIANTS = ("v3", "v4")
_A_BUILD_STEP = {"v3": 1, "v4": 2}   # width entries per kernel step


def check_a_build(a_build: str) -> str:
    """The ONE validator for the kernel_a_build knob: an unknown variant
    fails loudly everywhere rather than quietly routing every block to
    the plain path."""
    if a_build not in A_BUILD_VARIANTS:
        raise ValueError(
            f"kernel_a_build={a_build!r}: expected one of "
            f"{A_BUILD_VARIANTS}")
    return a_build


def _pallas_eligible(rows_cap: int, B: int, u_cap: int,
                     a_build: str = "v3") -> bool:
    """Big blocks only — the JAX package's envelope, unchanged, so the
    same blocks take the kernel in both packages and a variant flip never
    changes WHICH blocks ride it."""
    check_a_build(a_build)
    return (rows_cap % (_PL_TD // 2) == 0 and rows_cap >= _PL_TD // 2
            and B <= _PL_MAX_B and u_cap % 256 == 0)


# --------------------------------------------------------------------------
# The plain path: gathers + an explicit-order lane reduction
# --------------------------------------------------------------------------

def _pick_chunk(rows_cap: int, width: int, B: int, doc_chunk: int) -> int:
    """Row chunk bounding the [Dc, W, B] gathered intermediate to ~32MB,
    shrunk to a divisor of rows_cap."""
    budget = max(64, (1 << 23) // max(1, width * B))
    chunk = min(doc_chunk, rows_cap, budget)
    while rows_cap % chunk:
        chunk -= 1
    return chunk


_RED_LANES = 8   # lane width of the explicit ELL reduction order


def _lane_sum_w(x: torch.Tensor) -> torch.Tensor:
    """Sum f32 ``x [Dc, W, B]`` over W in the PINNED order of the JAX
    package's ``_lane_sum_w``: strided 8-lane accumulation (lane j takes
    w = j, j+8, ...), then a halving tree. Every add is a separate
    rounded f32 op (PyTorch's eager ops never contract a multiply into an
    add), so the bits match the JAX path and the CUDA kernel."""
    dc, w, b = x.shape
    pad = (-w) % _RED_LANES
    if pad:
        x = torch.cat([x, x.new_zeros((dc, pad, b))], dim=1)
    lanes = x.new_zeros((dc, _RED_LANES, b))
    for i in range(x.shape[1] // _RED_LANES):
        lanes = lanes + x[:, i * _RED_LANES:(i + 1) * _RED_LANES]
    v = _RED_LANES
    while v > 1:
        v //= 2
        lanes = lanes[:, :v] + lanes[:, v:2 * v]
    return lanes[:, 0]                                 # [Dc, B]


def _score_block(impact: torch.Tensor, term: torch.Tensor,
                 slot_of: torch.Tensor, qc_t: torch.Tensor,
                 doc_chunk: int) -> torch.Tensor:
    """One ELL block (row-major ``[rows_cap, W]``): gathers + reduction,
    chunked over rows. Returns ``[B, rows_cap]``."""
    rows_cap, width = impact.shape
    B = qc_t.shape[1]
    chunk = _pick_chunk(rows_cap, width, B, doc_chunk)
    out = torch.empty((B, rows_cap), dtype=torch.float32,
                      device=qc_t.device)
    for lo in range(0, rows_cap, chunk):
        imp_c = impact[lo:lo + chunk]                   # [Dc, W]
        term_c = term[lo:lo + chunk]
        qg = qc_t[slot_of[term_c.long()].long()]        # [Dc, W, B]
        out[:, lo:lo + chunk] = _lane_sum_w(qg * imp_c[:, :, None]).T
    return out


def score_block_plain(imp_t: torch.Tensor, term_t: torch.Tensor,
                      slot_of: torch.Tensor, qc_t: torch.Tensor,
                      n_rows: int, doc_chunk: int = 2048) -> torch.Tensor:
    """The kernel's plain version, on the kernel's own inputs (width-major
    ``[W, rows_cap]``): :func:`_score_block`, with rows ``>= n_rows``
    scored 0 as the kernel's dead-row skip does."""
    out = _score_block(imp_t.T, term_t.T, slot_of, qc_t, doc_chunk)
    out[:, n_rows:] = 0.0
    return out


def _lib():
    """The library of ``csrc/ell_score.cu`` (built at first use), with the
    ctypes signatures of its two C entry points."""
    from tfidf_tpu_torch import kernels
    lib = kernels.load("ell_score")
    if lib.ell_score_launch.argtypes is None:
        lib.ell_score_launch.restype = ctypes.c_int
        lib.ell_score_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
            + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.ell_score_plan.restype = ctypes.c_int
        lib.ell_score_plan.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def kernel_plan(u1: int, B: int, width: int) -> dict:
    """The launch plan ``csrc/ell_score.cu`` picks for ``u1 = U_cap + 1``
    weight rows, ``B`` queries and block width ``width``: query tile, rows
    per CTA, shared memory, hit capacity, and whether the weights are
    staged in shared memory or read through L2 (needs the card: it reads
    the device's shared-memory limit)."""
    out = (ctypes.c_int * 5)()
    err = _lib().ell_score_plan(u1, B, width, out)
    if err != 0:
        raise ValueError(f"ell_score kernel takes no plan for U1={u1} "
                         f"B={B} W={width} (CUDA error {err})")
    plan = dict(zip(("query_tile", "rows_per_cta", "smem_bytes",
                     "hits_cap"), list(out)[:4]))
    plan["staged"] = bool(out[4])
    return plan


# launches of the CUDA kernel per variant; only the CUDA branch of
# score_block_kernel adds to these. The process's metrics registry counts
# the same launches (``ell_kernel_launches_<variant>``), so a serving
# node's ``/api/metrics`` shows how many its kernel took.
launches = {"v3": 0, "v4": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_out(out: torch.Tensor, dev, B: int, row0: int,
               n_rows: int) -> None:
    """The output the kernel takes: a row-major f32 ``[B, N]`` tensor (or
    a column slice of one) on the inputs' device, with the block's live
    rows ``[row0, row0 + n_rows)`` inside it."""
    if out.device != dev:
        raise ValueError(f"score_block_kernel: out on {out.device}, "
                         f"expected {dev}")
    if out.dtype != torch.float32 or out.dim() != 2:
        raise ValueError(f"score_block_kernel: out must be 2-d "
                         f"torch.float32, got {out.dim()}-d {out.dtype}")
    if out.shape[0] != B:
        raise ValueError(f"score_block_kernel: out has {out.shape[0]} "
                         f"rows, the batch {B}")
    if out.stride(1) != 1 or out.stride(0) < max(out.shape[1], 1):
        raise ValueError(f"score_block_kernel: out strides {out.stride()}"
                         " are not row-major with unit column stride")
    if row0 < 0 or row0 + n_rows > out.shape[1]:
        raise ValueError(f"score_block_kernel: rows [{row0}, "
                         f"{row0 + n_rows}) outside out's "
                         f"{out.shape[1]} columns")


def score_block_kernel(imp_t: torch.Tensor,     # f32 [W, rows_cap]
                       term_t: torch.Tensor,    # i32 [W, rows_cap]
                       slot_of: torch.Tensor,   # i32 [vocab_cap]
                       qc_t: torch.Tensor,      # f32 [U_cap+1, B]
                       n_rows: int,
                       *, out: torch.Tensor,    # f32 [B, N]
                       row0: int = 0,
                       a_build: str = "v4") -> torch.Tensor:
    """One ELL block's scores through the hand-written kernel
    (``csrc/ell_score.cu``), which replaces the Pallas kernel
    ``tfidf_tpu/ops/ell.py:score_block_pallas``.

    The block's live rows go straight to ``out[:, row0:row0 + n_rows]``
    (``out`` is e.g. the batch's real-doc scores); nothing else of ``out``
    is touched, and ``out`` is returned.

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version. There is no fallback between the two."""
    check_a_build(a_build)
    dev = imp_t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"score_block_kernel: unsupported device {dev}")
    for name, t, dtype, ndim in (("imp_t", imp_t, torch.float32, 2),
                                 ("term_t", term_t, torch.int32, 2),
                                 ("slot_of", slot_of, torch.int32, 1),
                                 ("qc_t", qc_t, torch.float32, 2)):
        if t.device != dev:
            raise ValueError(f"score_block_kernel: {name} on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"score_block_kernel: {name} must be "
                             f"{ndim}-d {dtype}, got {t.dim()}-d {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"score_block_kernel: {name} must be "
                             "contiguous")
    width, rows_cap = imp_t.shape
    u1, B = qc_t.shape
    if term_t.shape != imp_t.shape:
        raise ValueError(f"score_block_kernel: term_t {tuple(term_t.shape)}"
                         f" != imp_t {tuple(imp_t.shape)}")
    if not 0 <= n_rows <= rows_cap:
        raise ValueError(f"score_block_kernel: n_rows={n_rows} outside "
                         f"[0, {rows_cap}]")
    if min(width, rows_cap, B, u1) < 1 or max(rows_cap * width,
                                              u1 * B) >= 1 << 31:
        raise ValueError(f"score_block_kernel: unsupported shape W={width}"
                         f" rows_cap={rows_cap} U1={u1} B={B}")
    _check_out(out, dev, B, row0, n_rows)
    if dev.type == "cpu":
        out[:, row0:row0 + n_rows] = score_block_plain(
            imp_t, term_t, slot_of, qc_t, n_rows)[:, :n_rows]
        return out
    if n_rows == 0:
        return out
    from tfidf_tpu_torch.kernels import KernelLaunchError
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ell_score_launch(
            imp_t.data_ptr(), term_t.data_ptr(), slot_of.data_ptr(),
            qc_t.data_ptr(), out.data_ptr() + 4 * row0, out.stride(0),
            rows_cap, width, n_rows, slot_of.shape[0], u1, B,
            _A_BUILD_STEP[a_build], stream)
    if err != 0:
        raise KernelLaunchError(f"ell_score launch returned CUDA error "
                                f"{err}")
    launches[a_build] += 1
    global_metrics.inc(f"ell_kernel_launches_{a_build}")
    return out


# --------------------------------------------------------------------------
# Whole-snapshot ELL scoring
# --------------------------------------------------------------------------

def real_index(block_caps, block_live, doc_cap: int) -> np.ndarray:
    """Host-side gather map padded-row space -> real doc id space: real
    doc d lives in block i at padded index pad0_i + (d - row0_i); dead
    real rows map to the explicit zero column P = sum(block_caps). With
    :func:`_rearrange_to_real` it is the plain reference of the direct
    writes in :func:`score_ell_impl` (the tests hold one to the other)."""
    P = int(sum(block_caps))
    out = np.full(doc_cap, P, np.int64)
    row0 = pad0 = 0
    for cap, live in zip(block_caps, block_live):
        out[row0:row0 + live] = np.arange(pad0, pad0 + live)
        row0 += live
        pad0 += cap
    return out


def _rearrange_to_real(parts, index: torch.Tensor, B: int,
                       device) -> torch.Tensor:
    """Concatenate per-block padded scores and gather them into the real
    doc-id space ``[B, doc_cap]`` through ``index`` (:func:`real_index`):
    the JAX package's rearrange, kept as the reference."""
    if not parts:
        return torch.zeros((B, index.shape[0]), dtype=torch.float32,
                           device=device)
    padded = torch.cat(parts + [torch.zeros((B, 1), dtype=torch.float32,
                                            device=device)], dim=1)
    return padded[:, index]


def score_ell_impl(impacts,            # tuple of f32 [rows_cap_i, width_i]
                   terms,              # tuple of i32 [rows_cap_i, width_i]
                   impacts_t,          # tuple of f32 [width_i, rows_cap_i]
                   terms_t,            # tuple of i32 [width_i, rows_cap_i]
                   block_live,         # tuple of int — live rows per block
                   doc_cap: int,
                   q: QueryBatch,
                   vocab_cap: int,
                   *, doc_chunk: int = 2048,
                   use_pallas: bool = False,
                   a_build: str = "v3") -> torch.Tensor:
    """Scoring over all blocks: ``scores [B, doc_cap]``.

    Block i holds the snapshot rows ``[row0_i, row0_i + live_i)``, with
    ``row0_i`` the live rows of the blocks before it, so each block's live
    scores go straight into that column slice of one ``[B, doc_cap]``
    tensor, and the columns past the last live row are set to 0: the
    result equals the JAX package's concatenate-and-gather
    (:func:`_rearrange_to_real`) bit for bit, without the padded
    ``[B, rows_cap]`` intermediates. ``use_pallas`` routes every block
    inside the kernel envelope through :func:`score_block_kernel` on the
    width-major ``impacts_t``/``terms_t`` the snapshot builds once at
    commit; the rest take the plain path and are copied into their
    slice."""
    B = q.slots.shape[0]
    slot_of, qc_ext = _compile_queries(q, vocab_cap)
    qc_t = qc_ext.T.contiguous()                      # [U_cap+1, B]
    u_cap = q.uniq.shape[0]
    scores = torch.empty((B, doc_cap), dtype=torch.float32,
                         device=q.slots.device)
    row0 = 0
    for i, (imp, term) in enumerate(zip(impacts, terms)):
        live = int(block_live[i])
        if use_pallas and _pallas_eligible(imp.shape[0], B, u_cap,
                                           a_build):
            score_block_kernel(impacts_t[i], terms_t[i], slot_of, qc_t,
                               live, a_build=a_build, out=scores,
                               row0=row0)
        else:
            scores[:, row0:row0 + live] = _score_block(
                imp, term, slot_of, qc_t, doc_chunk)[:, :live]
        row0 += live
    scores[:, row0:] = 0.0
    return scores


def score_ell_with_residual(impacts, terms, impacts_t, terms_t,
                            block_live,
                            res_tf, res_term, res_doc,  # COO residual
                            doc_len, df, q: QueryBatch,
                            n_docs, avgdl, doc_norms=None,
                            *, model: str = "bm25", k1: float = 1.2,
                            b: float = 0.75, doc_chunk: int = 2048,
                            res_chunk: int = 1 << 10,
                            use_pallas: bool = False,
                            a_build: str = "v3",
                            res_plan: list[Segment] | None = None
                            ) -> torch.Tensor:
    """Full shard scores: blocked ELL + COO residual (overlong docs).
    The ELL arguments are the snapshot's (``Snapshot.ell_*``). Pass
    ``res_tf=None`` when nothing spilled."""
    doc_cap = doc_len.shape[0]
    vocab_cap = df.shape[0]
    scores = score_ell_impl(impacts, terms, impacts_t, terms_t,
                            block_live, doc_cap, q, vocab_cap,
                            doc_chunk=doc_chunk, use_pallas=use_pallas,
                            a_build=a_build)
    if res_tf is not None:
        slot_of, qc_ext = _compile_queries(q, vocab_cap)
        scores += score_coo_compiled(
            res_tf, res_term, res_doc, doc_len, df, slot_of, qc_ext,
            n_docs, avgdl, doc_norms, model=model, k1=k1, b=b,
            chunk=min(res_chunk, res_tf.shape[0]), plan=res_plan)
    return scores


def score_ell_batch(impacts, terms, impacts_t, terms_t, block_live,
                    res_tf, res_term, res_doc, doc_len, df, q: QueryBatch,
                    n_docs, avgdl, doc_norms=None, **kw) -> torch.Tensor:
    """The ELL dispatch seam: :func:`score_ell_with_residual` behind the
    device nemesis guard (``device.score_ell``). Unarmed, the guard is two
    emptiness checks per batch; armed, injected OOM / compile / transient
    / sick faults surface here, and a fired poison rule's NaN rows enter
    the scores on the device (detection happens at the fetch seam)."""
    rule = device_guard("score_ell", batch=int(q.slots.shape[0]),
                        uniq=int(q.uniq.shape[0]))
    scores = score_ell_with_residual(
        impacts, terms, impacts_t, terms_t, block_live, res_tf, res_term,
        res_doc, doc_len, df, q, n_docs, avgdl, doc_norms, **kw)
    if rule is not None:
        scores = poison_scores(scores, q.weights, rule.min_uniq)
    return scores


# --------------------------------------------------------------------------
# Streaming segments: weights from the CURRENT global stats, per query
# --------------------------------------------------------------------------

def _score_block_tf(tf: torch.Tensor, term: torch.Tensor, dl: torch.Tensor,
                    df: torch.Tensor, slot_of: torch.Tensor,
                    qc_t: torch.Tensor, n_docs, avgdl, norms: torch.Tensor,
                    doc_chunk: int, *, model: str, k1: float, b: float,
                    n_rows: int | None = None,
                    out: torch.Tensor | None = None,
                    row0: int = 0) -> torch.Tensor:
    """One segment block (row-major ``[rows_cap, W]`` raw tf) scored with
    weights computed per chunk from the current df/N/avgdl — the
    streaming path, where precomputed impacts would go stale as the
    corpus grows (``tfidf_tpu/ops/ell.py:_score_block_tf``).

    Rows ``[0, n_rows)`` (default: all) go to ``out[:, row0:row0 +
    n_rows]`` (default: a new ``[B, rows_cap]``). Every chunk has the
    full shape ``_pick_chunk`` gives, so a row's bits depend only on the
    block's shape and the batch, never on the other segments. The sum
    over W is torch's, not a pinned order: the JAX function's is XLA's
    ``.sum(axis=1)``, so the two agree within f32 rounding, not bitwise."""
    rows_cap, width = tf.shape
    B = qc_t.shape[1]
    if out is None:
        out = torch.empty((B, rows_cap), dtype=torch.float32,
                          device=qc_t.device)
    n_rows = rows_cap if n_rows is None else n_rows
    chunk = _pick_chunk(rows_cap, width, B, doc_chunk)
    for lo in range(0, n_rows, chunk):
        m = min(chunk, n_rows - lo)
        term_c = term[lo:lo + chunk].long()             # [Dc, W]
        w = _entry_weights(model, tf[lo:lo + chunk], df[term_c],
                           dl[lo:lo + chunk, None], n_docs, avgdl,
                           norms[lo:lo + chunk, None], k1, b)
        qg = qc_t[slot_of[term_c].long()]               # [Dc, W, B]
        s = (qg * w[:, :, None]).sum(dim=1)             # [Dc, B]
        out[:, row0 + lo:row0 + lo + m] = s[:m].T
    return out


class SegmentView(NamedTuple):
    """Scoring-ready tensors of one streaming segment.

    Built at commit time (``SegmentedIndex.commit``); the snapshot — not
    the shared Segment object — owns the per-commit pieces
    (``live_mask``, cosine ``norms``), so an already-published snapshot
    never observes later deletes or df drift. ``ready`` is the CUDA event
    recorded after the segment's uploads on a side stream (a background
    merge, the tier's upload ring), or None: scoring makes its stream
    wait on it first.
    """
    tfs: tuple            # f32 [rows_cap_i, width_i] blocks (raw tf)
    terms: tuple          # i32 [rows_cap_i, width_i]
    dls: tuple            # f32 [rows_cap_i] (model-transformed lengths)
    norms: tuple          # f32 [rows_cap_i] (zeros unless cosine)
    block_live: tuple     # int live rows per block (host)
    live_mask: torch.Tensor   # f32 [doc_cap] — 1=live, tombstones 0
    # COO residual for rows wider than the ELL width cap (None: no spill):
    # (res_tf, res_term, res_doc, res_dl [doc_cap], res_norms [doc_cap]
    #  or None, res_plan — its segment_plan, or None to derive it)
    res: tuple | None
    ready: object = None


def score_segment_ell(view: SegmentView, df, slot_of, qc_ext, qc_t,
                      n_docs, avgdl, *, model: str = "bm25",
                      k1: float = 1.2, b: float = 0.75,
                      doc_chunk: int = 2048,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """One streaming segment: its blocks scored with current stats, each
    block's live rows written straight into their columns of the
    segment's real doc space (the columns past the last live row set to
    0 — the JAX package's ``_rearrange_to_real``, bit for bit), plus the
    COO residual of over-wide docs, tombstones zeroed. Returns ``[B,
    doc_cap]`` (``out``, when given: a column slice of the batch's
    scores). ``slot_of``/``qc_ext``/``qc_t`` come from the caller's
    single per-batch ``_compile_queries``."""
    doc_cap = view.live_mask.shape[0]
    B = qc_t.shape[1]
    if view.ready is not None:
        torch.cuda.current_stream(qc_t.device).wait_event(view.ready)
    if out is None:
        out = torch.empty((B, doc_cap), dtype=torch.float32,
                          device=qc_t.device)
    row0 = 0
    for tf, term, dl, nrm, live in zip(view.tfs, view.terms, view.dls,
                                       view.norms, view.block_live):
        _score_block_tf(tf, term, dl, df, slot_of, qc_t, n_docs, avgdl,
                        nrm, doc_chunk, model=model, k1=k1, b=b,
                        n_rows=live, out=out, row0=row0)
        row0 += live
    out[:, row0:] = 0.0
    if view.res is not None:
        # docs with more distinct terms than the width cap spill here —
        # the chunked segment-sum path with the same current-stats weights
        res_tf, res_term, res_doc, res_dl, res_norms, res_plan = view.res
        out += score_coo_compiled(
            res_tf, res_term, res_doc, res_dl, df, slot_of, qc_ext,
            n_docs, avgdl, res_norms, model=model, k1=k1, b=b,
            chunk=min(1 << 10, res_tf.shape[0]), plan=res_plan)
    out.mul_(view.live_mask[None, :])
    return out


def score_segments_impl(views, df, q: QueryBatch, n_docs, avgdl,
                        *, model: str = "bm25", k1: float = 1.2,
                        b: float = 0.75,
                        doc_chunk: int = 2048) -> torch.Tensor:
    """All streaming segments scored into one ``[B, sum(doc_cap)]``
    tensor: one ``_compile_queries`` a batch, then each segment into its
    own column slice. No segment's computation depends on another's or on
    the total width, so scoring a segment alone gives the bits of its
    slice here — the tiered dispatch's exactness rests on that."""
    B = q.slots.shape[0]
    dev = q.slots.device
    total = sum(int(v.live_mask.shape[0]) for v in views)
    scores = torch.empty((B, total), dtype=torch.float32, device=dev)
    if not views:
        return scores
    slot_of, qc_ext = _compile_queries(q, df.shape[0])
    qc_t = qc_ext.T.contiguous()                      # [U_cap+1, B]
    base = 0
    for v in views:
        cap = int(v.live_mask.shape[0])
        score_segment_ell(v, df, slot_of, qc_ext, qc_t, n_docs, avgdl,
                          model=model, k1=k1, b=b, doc_chunk=doc_chunk,
                          out=scores[:, base:base + cap])
        base += cap
    return scores


def score_segments_batch(views, df, q: QueryBatch, n_docs, avgdl,
                         **kw) -> torch.Tensor:
    """The segmented dispatch seam (``device.score_segments``): the hot
    pass, the cold walk and the tier-bypass oracle all dispatch through
    here — see :func:`score_ell_batch` for the guard contract."""
    rule = device_guard("score_segments", batch=int(q.slots.shape[0]),
                        uniq=int(q.uniq.shape[0]))
    scores = score_segments_impl(views, df, q, n_docs, avgdl, **kw)
    if rule is not None:
        scores = poison_scores(scores, q.weights, rule.min_uniq)
    return scores


def cosine_norms_host(coo: CooShard, n_docs: float) -> np.ndarray:
    """Host-side per-doc L2 norms of the TF-IDF vectors (for the ELL
    layout, which never ships the COO to the device)."""
    nnz = coo.nnz
    doc_cap = coo.doc_len.shape[0]
    df_t = coo.df[coo.term[:nnz]]
    w = coo.tf[:nnz] * (np.log((1.0 + n_docs) / (1.0 + df_t)) + 1.0)
    sq = np.bincount(coo.doc[:nnz], weights=w * w, minlength=doc_cap)
    return np.sqrt(sq[:doc_cap]).astype(np.float32)
