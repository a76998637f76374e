"""Compact binary wire format for batched scatter-gather results.

The reference moves one query per HTTP request and serializes every hit as
a JSON object (``{"document":{"name":..},"score":..}`` — the Jackson wire
shape of ``DocumentScoreInfo``, ``Leader.java:54-77``). At cluster QPS in
the thousands that per-hit JSON encode/decode is the dominant Python cost
on both sides of the wire, so the batched worker RPC
(``POST /worker/process-batch``) answers in this packed layout instead:

    u32 magic       format tag/version (``MAGIC``)
    u32 n_queries
    u32 counts[n_queries]     hits per query, in request order
    u32 total                 sum(counts)  (redundant; integrity check)
    f32 scores[total]
    u32 name_lens[total]
    u8  names[...]            concatenated UTF-8 names

Scores and lengths decode on the receiving side as two ``np.frombuffer``
views — no per-hit float parsing — and names slice out of one blob. The
per-query JSON path (``/worker/process``) keeps the reference-compatible
shape; this format is internal to the leader<->worker scatter.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = 0x54504231   # "TPB1"

_HEADER = struct.Struct("<II")
_U32 = struct.Struct("<I")


def pack_hit_lists(results) -> bytes:
    """Serialize ``list[list[SearchHit | (name, score)]]``."""
    counts = np.fromiter((len(r) for r in results), np.uint32,
                         count=len(results))
    total = int(counts.sum())
    scores = np.empty(total, np.float32)
    lens = np.empty(total, np.uint32)
    names: list[bytes] = []
    i = 0
    for r in results:
        for name, score in r:
            b = name.encode("utf-8")
            names.append(b)
            lens[i] = len(b)
            scores[i] = score
            i += 1
    return b"".join((_HEADER.pack(MAGIC, len(results)), counts.tobytes(),
                     _U32.pack(total), scores.tobytes(), lens.tobytes(),
                     b"".join(names)))


def pack_topk_arrays(vals, ids, names) -> bytes:
    """Serialize raw top-k result arrays straight into the wire layout —
    the serving fast path (``Searcher.search_arrays`` ->
    ``/worker/process-batch`` reply) that skips building per-hit
    ``SearchHit`` objects entirely.

    ``vals [N, k] f32`` / ``ids [N, k] i32`` are one exact top-k per
    query in score-descending column order; ``ids`` index ``names``.
    Entries with a non-finite or <= 0 value are dead (padding / no
    match) and are dropped, exactly as the hit-assembly path drops
    them, so the produced bytes are identical to
    ``pack_hit_lists(assembled_hits)`` for score-ordered results (the
    parity gate in ``tests/test_pipeline.py`` holds this).
    """
    vals = np.asarray(vals, np.float32)
    ids = np.asarray(ids)
    live = np.isfinite(vals) & (vals > 0.0)
    counts = live.sum(axis=1, dtype=np.uint32)
    # boolean-mask flattening is row-major: query order preserved,
    # within-query order stays score-descending (the top-k column order)
    scores = np.ascontiguousarray(vals[live])
    name_blobs = [names[d].encode("utf-8") for d in ids[live].tolist()]
    total = len(name_blobs)
    lens = np.fromiter(map(len, name_blobs), np.uint32, count=total)
    return b"".join((_HEADER.pack(MAGIC, vals.shape[0]),
                     counts.tobytes(), _U32.pack(total),
                     scores.tobytes(), lens.tobytes(),
                     b"".join(name_blobs)))


def unpack_hit_lists(data: bytes) -> list[list[tuple[str, float]]]:
    """Decode :func:`pack_hit_lists` output into per-query
    ``[(name, score), ...]`` lists (request order)."""
    # the wire contract is ValueError on ANY malformed buffer; without
    # the up-front length checks a truncated reply surfaces as
    # struct.error from unpack_from instead
    if len(data) < _HEADER.size:
        raise ValueError(
            f"wire buffer too short for header: {len(data)} bytes")
    magic, n = _HEADER.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"bad wire magic {magic:#x}")
    off = _HEADER.size
    if len(data) < off + 4 * n + _U32.size:
        raise ValueError("wire buffer too short for counts")
    counts = np.frombuffer(data, np.uint32, count=n, offset=off)
    off += 4 * n
    (total,) = _U32.unpack_from(data, off)
    off += _U32.size
    if int(counts.sum()) != total:
        raise ValueError("wire counts do not sum to total")
    scores = np.frombuffer(data, np.float32, count=total, offset=off)
    off += 4 * total
    lens = np.frombuffer(data, np.uint32, count=total, offset=off)
    off += 4 * total
    ends = np.cumsum(lens) + off
    starts = ends - lens
    if total and int(ends[-1]) != len(data):
        raise ValueError("wire name blob length mismatch")
    out: list[list[tuple[str, float]]] = []
    i = 0
    for c in counts:
        hits = [(data[starts[j]:ends[j]].decode("utf-8"),
                 float(scores[j])) for j in range(i, i + int(c))]
        out.append(hits)
        i += int(c)
    return out
