"""Durable checkpoint of a shard index (postings + vocabulary).

The counterpart of ``tfidf_tpu/engine/checkpoint.py``, in the same
on-disk format (``FORMAT_VERSION`` 1, the same files, npz keys and
``score_signature``), so a checkpoint saved by either package loads in the
other. ``Engine.build_from_directory`` always works; a checkpoint restores
the exact index state much faster than re-analyzing the corpus.

Format: ``<path>`` is a symlink to a versioned sibling ``<path>.v<N>``
containing:
    vocab.txt     one term per line, line number = id
    docs.npz      offsets[n+1], term_ids[nnz], tfs[nnz], lengths[n]
    names.json    document names, aligned with offsets
    snapshot.npz  the committed snapshot's arrays (fast restore)
    segstate.npz  the segment state instead (``index_mode="segments"``)
    embeddings.npz  the dense plane's rows + their index into names.json
    meta.json     model kind, counts, format version, embedder signature
    MANIFEST.json CRC32 + size of every file above (utils/storage.py)

Crash consistency: every file is built in a temp sibling
``<path>.build.*``, covered by a checksummed manifest, fsynced, and the
whole directory is atomically renamed into its ``.v<N>`` name; publish is
then one atomic ``os.replace`` of the symlink. Older versions are pruned
after a successful publish, keeping ``config.storage_keep_versions``.
:func:`restore_checkpoint` verifies the manifest before trusting a
version and falls back to the newest INTACT one, quarantining the corrupt
directory.

The embedding column restores from ``embeddings.npz`` when the stored
embedder signature (model, dim) matches the running config; otherwise
every document is re-embedded from ``vocab.txt`` and the term table.

A streaming index saves its segments (``segstate.npz``: each segment's
blocked-ELL layout rebuilt on the host from the retained postings, its df,
lengths, live mask and names) and restores them by pure uploads, with no
re-layout and no commit of the whole corpus into one segment; a tiered
engine re-admits every restored segment to its tier, whose budget then
spills what does not fit.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np

from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.engine.index import entries_from_packed
from tfidf_tpu_torch.utils import storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import fault_point
from tfidf_tpu_torch.utils.logging import get_logger
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.tracing import span_event, trace_phase

log = get_logger("engine.checkpoint")

FORMAT_VERSION = 1


def _score_signature(engine: Engine) -> list:
    """Everything the precomputed snapshot arrays depend on: restoring
    them under a different scoring config would silently serve wrong
    scores, so load falls back to a full commit on any mismatch."""
    c = engine.config
    return [engine.model.kind, c.bm25_k1, c.bm25_b, c.lucene_parity,
            c.scoring_layout, c.ell_width_cap]


def save_checkpoint(engine: Engine, directory: str) -> None:
    if hasattr(engine.index, "live_entries_and_gen"):
        entries, entries_gen = engine.index.live_entries_and_gen()
    else:   # mesh layouts
        entries, entries_gen = engine.index.live_entries(), None
    n = len(entries)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum([d.term_ids.shape[0] for d in entries], out=offsets[1:])
    nnz = int(offsets[-1])
    if n:
        term_ids = np.concatenate([d.term_ids for d in entries]).astype(
            np.int32, copy=False)
        tfs = np.concatenate([d.tfs for d in entries]).astype(
            np.float32, copy=False)
    else:
        term_ids = np.zeros(0, np.int32)
        tfs = np.zeros(0, np.float32)
    lengths = np.fromiter((d.length for d in entries), np.float32, n)

    base = directory.rstrip("/")
    parent = os.path.dirname(os.path.abspath(base)) or "."
    os.makedirs(parent, exist_ok=True)
    prefix = os.path.basename(base) + ".v"
    existing = sorted(int(d[len(prefix):]) for d in os.listdir(parent)
                      if d.startswith(prefix)
                      and d[len(prefix):].isdigit())
    version = (existing[-1] + 1) if existing else 1
    vdir = f"{base}.v{version}"
    if os.path.exists(vdir):
        shutil.rmtree(vdir)
    # build in a temp sibling: the version NAME only ever appears via one
    # atomic rename of a complete, manifested, fsynced directory
    for d in os.listdir(parent):
        if d.startswith(os.path.basename(base) + ".build."):
            shutil.rmtree(os.path.join(parent, d), ignore_errors=True)
    build = f"{base}.build.{os.getpid()}"
    os.makedirs(build)
    engine.vocab.save(os.path.join(build, "vocab.txt"))
    storage.savez(os.path.join(build, "docs.npz"),
                  offsets=offsets, term_ids=term_ids, tfs=tfs,
                  lengths=lengths)
    storage.write_bytes(os.path.join(build, "names.json"),
                        json.dumps([d.name for d in entries]).encode())
    # the embedding column rides the same build dir, so the manifest and
    # publish_dir cover it; rows are stored with an index into names.json
    emb_meta = None
    if engine.dense is not None:
        rows, dnames = engine.dense.export_arrays()
        pos = {d.name: i for i, d in enumerate(entries)}
        if all(nm in pos for nm in dnames):
            storage.savez(
                os.path.join(build, "embeddings.npz"), rows=rows,
                name_idx=np.fromiter((pos[nm] for nm in dnames),
                                     np.int64, len(dnames)))
            emb_meta = engine.dense.embedder.signature()
    # fast-restore payload: the committed snapshot's arrays, so load
    # skips the O(corpus) host COO/ELL re-layout. The snapshot's doc
    # order is its own (width-sorted); it is stored as a permutation
    # into names.json
    snap_meta = None
    exported = (engine.index.export_snapshot_arrays()
                if engine.config.checkpoint_snapshot_arrays
                and hasattr(engine.index, "export_snapshot_arrays")
                else None)
    if exported is not None:
        arrays, snap_names, snap_gen = exported
        pos = {d.name: i for i, d in enumerate(entries)}
        # the gen token proves the doc table and the exported snapshot
        # describe the SAME corpus (a re-ingest + commit between the two
        # reads would pass a name-set check with diverged contents)
        if (snap_gen == entries_gen and len(snap_names) == n
                and all(nm in pos for nm in snap_names)):
            arrays["name_order"] = np.fromiter(
                (pos[nm] for nm in snap_names), np.int64, n)
            storage.savez(os.path.join(build, "snapshot.npz"), **arrays)
            snap_meta = {"score_signature": _score_signature(engine),
                         "kind": "shard"}
    # the segment-level payload of a streaming index, under the same
    # gen-token consistency rule
    full = (engine.index.export_full_state()
            if engine.config.checkpoint_snapshot_arrays
            and hasattr(engine.index, "export_full_state") else None)
    if full is not None:
        arrays, full_gen = full
        if full_gen == entries_gen:
            storage.savez(os.path.join(build, "segstate.npz"), **arrays)
            snap_meta = {"score_signature": _score_signature(engine),
                         "kind": "segments"}
    storage.write_bytes(os.path.join(build, "meta.json"), json.dumps({
        "format_version": FORMAT_VERSION,
        "model": engine.model.kind,
        "num_docs": n,
        "nnz": nnz,
        "vocab_size": len(engine.vocab),
        "snapshot": snap_meta,
        "embedding": emb_meta,
        "tier": engine.tier_stats(),
        # wall-clock save time: a boot re-walk re-ingests only files
        # modified after this
        "created_at": time.time(),
    }).encode())
    # seal + publish the version dir: manifest, fsync everything,
    # atomic rename build -> .v<N> (crash => complete-or-absent)
    storage.write_manifest(build, fsync=False)   # publish_dir fsyncs all
    storage.publish_dir(build, vdir)
    fault_point("checkpoint.pre_publish")   # crash window for fault tests
    # atomic publish: swing the symlink in one os.replace
    link_tmp = f"{base}.lnk.tmp"
    if os.path.lexists(link_tmp):
        os.remove(link_tmp)
    os.symlink(os.path.basename(vdir), link_tmp)
    if os.path.isdir(base) and not os.path.islink(base):
        # migrate a pre-symlink-format checkpoint out of the way first
        storage.replace(base, f"{base}.v0")
        existing.insert(0, 0)
    storage.replace(link_tmp, base)
    storage.fsync_dir(parent)
    # prune superseded versions only after a successful publish
    keep = max(1, engine.config.storage_keep_versions)
    prune = existing[:-(keep - 1)] if keep > 1 else existing
    for v in prune:
        shutil.rmtree(f"{base}.v{v}", ignore_errors=True)
    log.info("checkpoint saved", dir=directory, docs=n, nnz=nnz,
             version=version)


def _restore_dense(engine: Engine, directory: str, meta: dict,
                   names: list, docs) -> None:
    """Repopulate the embedding column. Fast path: install the stored
    rows when the checkpoint's embedding signature matches the running
    config. Otherwise (no ``embeddings.npz``, a signature change)
    re-embed every document from the checkpoint's own term table —
    ``vocab.txt`` line ``i`` IS term id ``i``, so ``term_ids``/``tfs``
    rebuild exactly the token->tf counts the embedder consumed at
    ingest. Either way the column is rebuilt, never silently stale.
    ``docs`` is the loaded ``docs.npz``, read only to re-embed."""
    if engine.dense is None:
        return
    emb_path = os.path.join(directory, "embeddings.npz")
    if (meta.get("embedding") == engine.dense.embedder.signature()
            and os.path.exists(emb_path)):
        data = np.load(emb_path)
        engine.dense.install_arrays(
            data["rows"], [names[i] for i in data["name_idx"]])
        engine.dense.commit()
        return
    global_metrics.inc("checkpoint_dense_reembeds")
    with open(os.path.join(directory, "vocab.txt"), encoding="utf-8") as f:
        terms = f.read().splitlines()
    offsets, term_ids, tfs = docs["offsets"], docs["term_ids"], docs["tfs"]
    lo_list = offsets[:-1].tolist()
    hi_list = offsets[1:].tolist()
    for i, name in enumerate(names):
        ids = term_ids[lo_list[i]:hi_list[i]]
        weights = tfs[lo_list[i]:hi_list[i]]
        engine.dense.upsert(
            name, {terms[int(t)]: float(w) for t, w in zip(ids, weights)})
    engine.dense.commit()


def load_checkpoint(directory: str, config: Config | None = None,
                    verify: bool = True, device=None) -> Engine:
    """Load one checkpoint version (``directory`` may be the published
    symlink) into a new Engine on ``device`` (None: the card). ``verify``
    gates the manifest integrity check — a torn or bit-rotted file raises
    :class:`~tfidf_tpu_torch.utils.storage.StorageCorruption`; use
    :func:`restore_checkpoint` for the fallback-aware boot path.
    ``config=None`` means ``Config()`` (the dense plane on)."""
    if verify:
        with trace_phase("restore.verify"):
            problems = storage.verify_manifest(directory)
        if problems:
            raise storage.StorageCorruption(
                f"checkpoint {directory} failed integrity check: "
                + "; ".join(problems))
    with open(os.path.join(directory, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    if meta["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint format {meta['format_version']}")
    config = config or Config()
    if meta["model"] != config.model:
        config = config.replace(model=meta["model"])
    snap_meta = meta.get("snapshot") or {}
    engine = Engine(config, device=device)
    # populate the engine's OWN vocabulary (possibly native-backed) so
    # later ingests through either path see the restored terms
    with trace_phase("restore.vocab"):
        engine.vocab.load_into(os.path.join(directory, "vocab.txt"))
    with trace_phase("restore.docs"):
        data = np.load(os.path.join(directory, "docs.npz"))
        with open(os.path.join(directory, "names.json"),
                  encoding="utf-8") as f:
            names = json.load(f)
    # segment-level fast path (streaming mode): rebuild the committed
    # segment list from segstate.npz — device work is pure uploads
    seg_path = os.path.join(directory, "segstate.npz")
    if (snap_meta.get("kind") == "segments" and os.path.exists(seg_path)
            and hasattr(engine.index, "install_full_state")
            and snap_meta.get("score_signature")
            == _score_signature(engine)):
        with trace_phase("restore.install"):
            entries, _arrays = entries_from_packed(
                names, data["offsets"], data["term_ids"], data["tfs"],
                data["lengths"])
            engine.index.install_full_state(np.load(seg_path), entries)
            engine.commit()
        with trace_phase("restore.dense"):
            _restore_dense(engine, directory, meta, names, data)
        log.info("checkpoint loaded", dir=directory, docs=len(names),
                 fast_snapshot="segments")
        return engine
    with trace_phase("restore.docs"):
        engine.index.bulk_load_packed(names, data["offsets"],
                                      data["term_ids"], data["tfs"],
                                      data["lengths"])
    # fast path: re-upload the checkpointed snapshot arrays instead of
    # re-running the O(corpus) host layout — only when the scoring config
    # matches what the arrays were built under and the vocab capacity
    # agrees with the stored df
    snap_path = os.path.join(directory, "snapshot.npz")
    installed = False
    if (snap_meta.get("kind") == "shard" and os.path.exists(snap_path)
            and hasattr(engine.index, "install_snapshot_arrays")
            and snap_meta.get("score_signature")
            == _score_signature(engine)):
        snap = np.load(snap_path)
        if int(snap["df"].shape[0]) == engine.vocab.capacity():
            with trace_phase("restore.install"):
                snap_names = [names[i] for i in snap["name_order"]]
                engine.index.install_snapshot_arrays(snap, snap_names)
            with trace_phase("restore.mirror"):
                engine.prime_fallback()
            installed = True
            global_metrics.inc("checkpoint_snapshot_installs")
    if not installed:
        engine.commit()
    with trace_phase("restore.dense"):
        _restore_dense(engine, directory, meta, names, data)
    log.info("checkpoint loaded", dir=directory, docs=len(names),
             fast_snapshot=installed)
    return engine


def checkpoint_versions(base: str) -> list[str]:
    """Candidate version dirs for ``base``, newest-first: the published
    symlink target leads, then the remaining ``.v<N>`` siblings by
    descending version."""
    base = base.rstrip("/")
    parent = os.path.dirname(os.path.abspath(base)) or "."
    prefix = os.path.basename(base) + ".v"
    out: list[str] = []
    if os.path.islink(base):
        target = os.path.join(parent, os.readlink(base))
        if os.path.isdir(target):
            out.append(target)
    elif os.path.isdir(base):
        out.append(base)   # pre-symlink-format checkpoint
    if os.path.isdir(parent):
        versions = sorted(
            (int(d[len(prefix):]) for d in os.listdir(parent)
             if d.startswith(prefix) and d[len(prefix):].isdigit()),
            reverse=True)
        for v in versions:
            vdir = os.path.join(parent, f"{os.path.basename(base)}.v{v}")
            if vdir not in out:
                out.append(vdir)
    return out


def quarantine_version(vdir: str) -> str:
    """Move a corrupt version dir aside (never delete it) so boot,
    fallback and pruning stop seeing it. Returns the quarantine path."""
    qdir = f"{vdir}.quarantine"
    n = 1
    while os.path.exists(qdir):
        qdir = f"{vdir}.quarantine.{n}"
        n += 1
    os.rename(vdir, qdir)
    global_metrics.inc("checkpoint_quarantined")
    log.warning("checkpoint version quarantined", dir=vdir, moved_to=qdir)
    return qdir


def restore_checkpoint(base: str, config: Config | None = None,
                       device=None) -> tuple[Engine, dict]:
    """Fallback-aware restore: verify and load the newest INTACT
    checkpoint version of ``base``, quarantining every corrupt one on the
    way. Returns ``(engine, meta)``; raises
    :class:`~tfidf_tpu_torch.utils.storage.StorageCorruption` when no
    intact version exists (the caller falls back to the full re-walk)."""
    candidates = checkpoint_versions(base)
    if not candidates:
        raise FileNotFoundError(f"no checkpoint versions under {base}")
    legacy: list[str] = []
    for vdir in candidates:
        with trace_phase("restore.verify"):
            problems = storage.verify_manifest(vdir)
        if problems:
            if all("manifest missing" in p for p in problems):
                # a pre-manifest checkpoint: unverifiable, not evidence
                # of corruption — a last-resort candidate
                legacy.append(vdir)
                continue
            global_metrics.inc("checkpoint_fallbacks")
            span_event("checkpoint_fallback", dir=os.path.basename(vdir),
                       problems=len(problems))
            log.warning("checkpoint version corrupt; falling back",
                        dir=vdir, problems=problems[:3])
            quarantine_version(vdir)
            continue
        try:
            with open(os.path.join(vdir, "meta.json"),
                      encoding="utf-8") as f:
                meta = json.load(f)
            return load_checkpoint(vdir, config, verify=False,
                                   device=device), meta
        except storage.StorageCorruption:
            quarantine_version(vdir)
            continue
    for vdir in legacy:
        try:
            with open(os.path.join(vdir, "meta.json"),
                      encoding="utf-8") as f:
                meta = json.load(f)
            global_metrics.inc("checkpoint_legacy_loads")
            log.warning("loading pre-manifest (unverifiable) legacy "
                        "checkpoint; the next save writes a manifested "
                        "version", dir=vdir)
            return load_checkpoint(vdir, config, verify=False,
                                   device=device), meta
        except (OSError, ValueError):
            continue
    raise storage.StorageCorruption(
        f"no intact checkpoint version under {base} "
        f"({len(candidates)} candidate(s) quarantined, corrupt, or "
        f"unloadable)")
