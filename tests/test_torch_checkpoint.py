"""The port's checkpoints and durable-IO seam, held against the JAX package
on the CPU.

Checkpoints move between the packages in both directions (same files,
npz keys and score signature). Tolerances, with their reasons:

* port -> port and JAX -> port -> JAX round trips: top-10 identical and
  scores equal to the bit. A restore reinstalls the saved snapshot
  arrays (precomputed impacts), so the restored engine scores the very
  same bits in the same pinned order;
* JAX -> port, ELL: the port serves the JAX snapshot's impacts, added in
  the same lane order as the JAX XLA path, so the bits are equal. COO:
  the per-entry weights are computed per query by each package (log1p,
  division), which may differ by an ulp: ids identical, scores within
  rel 1e-6;
* the embedding column (``embeddings.npz``): its rows travel between the
  packages to the bit; within the port a restored column serves the same
  dense hits to the bit, and across the packages the dense scores agree
  within rel 1e-6 (the two matmuls pad and block their f32 sums
  differently).

The storage seam's crash-ordering cases of ``tests/test_storage.py`` run
over both seam modules.
"""

import errno
import os
import threading

import numpy as np
import pytest

from tests.test_torch_engine import SMALL, _zipf_queries, _zipf_texts
from tfidf_tpu.engine.checkpoint import load_checkpoint as jax_load
from tfidf_tpu.engine.checkpoint import save_checkpoint as jax_save
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils import storage as jax_storage
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine import checkpoint as ck
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.utils import storage as t_storage
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import FaultInjected, global_injector
from tfidf_tpu_torch.utils.metrics import global_metrics

CFG = dict(SMALL, min_doc_capacity=256, query_batch=16)
QUERIES = _zipf_queries(11)


def _hits(e, queries=QUERIES):
    return [[(h.name, h.score) for h in hs]
            for hs in e.search_batch(queries, k=10)]


def _arrays(e, queries=QUERIES):
    vals, ids, kk, names = e.search_batch_arrays(queries, k=10)
    return vals.tobytes(), [names[i] for i in np.asarray(ids).ravel()], kk


def _port(tmp_path, docs, **kw):
    e = Engine(Config(**dict(CFG, documents_path=str(tmp_path / "docs"),
                             **kw)), device="cpu")
    for name, text in docs.items():
        e.ingest_text(name, text)
    e.commit()
    return e


@pytest.mark.parametrize("kw", [dict(), dict(scoring_layout="coo"),
                                dict(ell_width_cap=16),
                                dict(model="tfidf_cosine")],
                         ids=["ell", "coo", "residual", "cosine"])
def test_port_round_trip_fast_path_bitwise(tmp_path, kw):
    e = _port(tmp_path, _zipf_texts(21), **kw)
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    installs = global_metrics.get("checkpoint_snapshot_installs")
    e2 = ck.load_checkpoint(ckpt, e.config, device="cpu")
    # the snapshot.npz fast path: installed, no commit
    assert global_metrics.get("checkpoint_snapshot_installs") \
        == installs + 1
    assert e2.index.snapshot.version == e.index.snapshot.version
    assert _hits(e2) == _hits(e)
    assert _arrays(e2) == _arrays(e)
    assert sorted(e2.document_names()) == sorted(e.document_names())
    # the restored engine keeps ingesting through its own vocabulary
    e2.ingest_text("late.txt", "t1 t2 zebra")
    e2.commit()
    assert e2.search("zebra")[0].name == "late.txt"


def test_signature_mismatch_recommits(tmp_path):
    e = _port(tmp_path, _zipf_texts(22))
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    installs = global_metrics.get("checkpoint_snapshot_installs")
    e2 = ck.load_checkpoint(ckpt, e.config.replace(bm25_k1=1.5),
                            device="cpu")
    assert global_metrics.get("checkpoint_snapshot_installs") == installs
    assert [h.name for h in e2.search("t1 t3", k=5)]


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_jax_checkpoint_loads_in_port_and_back(tmp_path, layout):
    """JAX -> port -> JAX: the port restores the JAX package's
    checkpoint through the fast path and serves its hits (bitwise in the
    ELL layout); the port's own save of that engine loads back into the
    JAX package, which then serves its original bits."""
    cfg = dict(CFG, scoring_layout=layout,
               documents_path=str(tmp_path / "docs"))
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    for name, text in _zipf_texts(23).items():
        je.ingest_text(name, text)
    je.commit()
    jdir = str(tmp_path / "jax_ckpt")
    jax_save(je, jdir)
    te = ck.load_checkpoint(jdir, Config(**cfg), device="cpu")
    want = [[(h.name, h.score) for h in hs]
            for hs in je.search_batch(QUERIES, k=10)]
    got = _hits(te)
    assert [[n for n, _ in hs] for hs in got] \
        == [[n for n, _ in hs] for hs in want]
    if layout == "ell":
        assert got == want
    else:
        np.testing.assert_allclose([s for hs in got for _, s in hs],
                                   [s for hs in want for _, s in hs],
                                   rtol=1e-6)
    tdir = str(tmp_path / "port_ckpt")
    ck.save_checkpoint(te, tdir)
    je2 = jax_load(tdir, JaxConfig(**dict(cfg, use_pallas=False)))
    assert [[(h.name, h.score) for h in hs]
            for hs in je2.search_batch(QUERIES, k=10)] == want
    assert je2.index.snapshot.version == je.index.snapshot.version


def test_port_checkpoint_loads_in_jax(tmp_path):
    """port -> JAX: the JAX package reinstalls the port's snapshot
    arrays and scores them in the same pinned order: equal bits."""
    te = _port(tmp_path, _zipf_texts(24))
    tdir = str(tmp_path / "ckpt")
    ck.save_checkpoint(te, tdir)
    je = jax_load(tdir, JaxConfig(**dict(CFG, use_pallas=False)))
    assert [[(h.name, h.score) for h in hs]
            for hs in je.search_batch(QUERIES, k=10)] == _hits(te)


def test_default_config_refuses_the_dense_plane(tmp_path):
    """``load_checkpoint`` without a config builds ``Config()``, whose
    dense plane is on: nothing is refused, the restored column equals the
    saved one to the bit and serves the same dense hits."""
    e = _port(tmp_path, _zipf_texts(25, n_docs=40), embedding_enabled=True)
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    reembeds = global_metrics.get("checkpoint_dense_reembeds")
    e2 = ck.load_checkpoint(ckpt, device="cpu")
    assert e2.config.embedding_enabled and e2.dense is not None
    assert global_metrics.get("checkpoint_dense_reembeds") == reembeds
    rows, names = e.dense.export_arrays()
    rows2, names2 = e2.dense.export_arrays()
    assert names2 == names and rows2.tobytes() == rows.tobytes()
    assert e2.search_dense_batch(QUERIES) == e.search_dense_batch(QUERIES)


def _dense_hits_close(got, want):
    for g, w in zip(got, want):
        assert [n for n, _ in g] == [n for n, _ in w]
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   rtol=1e-6, atol=1e-7)


def test_embeddings_cross_the_packages_both_ways(tmp_path):
    """JAX -> port -> JAX with ``embeddings.npz``: the rows travel to the
    bit (no re-embed on either side); the port serves the JAX column's
    top-k (scores within rel 1e-6: the two products differ in padding and
    blocking), and the JAX package reloads the port's save to the bit."""
    cfg = dict(CFG, embedding_enabled=True, embedding_chunk=64)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    for name, text in _zipf_texts(27, n_docs=150).items():
        je.ingest_text(name, text)
    je.commit()
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save(je, jdir)
    reembeds = global_metrics.get("checkpoint_dense_reembeds")
    te = ck.load_checkpoint(jdir, Config(**cfg), device="cpu")
    assert global_metrics.get("checkpoint_dense_reembeds") == reembeds
    rows, names = je.dense.export_arrays()
    assert te.dense.export_arrays()[0].tobytes() == rows.tobytes()
    assert te.dense.export_arrays()[1] == names
    want = je.search_dense_batch(QUERIES)
    _dense_hits_close(te.search_dense_batch(QUERIES), want)
    ck.save_checkpoint(te, tdir)
    assert os.path.exists(os.path.join(_current(tdir), "embeddings.npz"))
    je2 = jax_load(tdir, JaxConfig(**dict(cfg, use_pallas=False)))
    assert je2.dense.export_arrays()[0].tobytes() == rows.tobytes()
    assert je2.search_dense_batch(QUERIES) == want


def test_embedding_signature_change_reembeds(tmp_path):
    """A checkpoint embedded at dim 64, loaded at dim 32: every document
    is re-embedded from ``vocab.txt`` and the term table, to the same
    bits a fresh ingest at dim 32 gives."""
    docs = _zipf_texts(28, n_docs=80)
    e = _port(tmp_path, docs, embedding_enabled=True)
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    reembeds = global_metrics.get("checkpoint_dense_reembeds")
    e2 = ck.load_checkpoint(ckpt, e.config.replace(embedding_dim=32),
                            device="cpu")
    assert global_metrics.get("checkpoint_dense_reembeds") == reembeds + 1
    fresh = _port(tmp_path, docs, embedding_enabled=True, embedding_dim=32)
    assert e2.dense.export_arrays()[0].tobytes() \
        == fresh.dense.export_arrays()[0].tobytes()
    assert e2.search_dense_batch(QUERIES) == fresh.search_dense_batch(QUERIES)


def test_torn_embeddings_fall_back_to_the_intact_version(tmp_path):
    e = _port(tmp_path, _zipf_texts(29, n_docs=120), embedding_enabled=True)
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    want_v1 = e.search_dense_batch(QUERIES)
    e.ingest_text("extra.txt", "t1 t1 t2 fresh")
    e.commit()
    ck.save_checkpoint(e, ckpt)
    assert e.search_dense_batch(QUERIES) != want_v1
    p = os.path.join(_current(ckpt), "embeddings.npz")
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(t_storage.StorageCorruption):
        ck.load_checkpoint(ckpt, e.config, device="cpu")
    e2, meta = ck.restore_checkpoint(ckpt, e.config, device="cpu")
    assert meta["num_docs"] == 120 and meta["embedding"] == {
        "model": "hash", "dim": 64}
    assert e2.search_dense_batch(QUERIES) == want_v1
    assert any(".quarantine" in d for d in os.listdir(
        os.path.dirname(ckpt)))


@pytest.fixture
def two_versions(tmp_path):
    """v1 (the fallback state) and v2 (published, one extra doc)."""
    e = _port(tmp_path, _zipf_texts(26, n_docs=120))
    ckpt = str(tmp_path / "ckpt")
    ck.save_checkpoint(e, ckpt)
    want_v1 = _hits(e)
    e.ingest_text("extra.txt", "t1 t1 t2 fresh")
    e.commit()
    ck.save_checkpoint(e, ckpt)
    want_v2 = _hits(e)
    assert want_v1 != want_v2
    return e.config, ckpt, want_v1, want_v2


def _current(ckpt):
    return os.path.join(os.path.dirname(ckpt), os.readlink(ckpt))


@pytest.mark.parametrize("victim", ["docs.npz", "snapshot.npz",
                                    "vocab.txt"])
def test_torn_file_falls_back_and_quarantines(two_versions, victim):
    cfg, ckpt, want_v1, _ = two_versions
    p = os.path.join(_current(ckpt), victim)
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(t_storage.StorageCorruption):
        ck.load_checkpoint(ckpt, cfg, device="cpu")
    e2, meta = ck.restore_checkpoint(ckpt, cfg, device="cpu")
    assert _hits(e2) == want_v1 and meta["num_docs"] == 120
    assert any(".quarantine" in d for d in os.listdir(
        os.path.dirname(ckpt)))


def test_pre_publish_fault_keeps_the_old_checkpoint(two_versions):
    cfg, ckpt, _v1, want_v2 = two_versions
    e = ck.load_checkpoint(ckpt, cfg, device="cpu")
    e.ingest_text("newer.txt", "t5 t6 newer")
    e.commit()
    global_injector.arm("checkpoint.pre_publish", "raise")
    try:
        with pytest.raises(FaultInjected):
            ck.save_checkpoint(e, ckpt)
    finally:
        global_injector.disarm()
    # the published link still names the old, complete version
    assert _hits(ck.load_checkpoint(ckpt, cfg, device="cpu")) == want_v2
    versions = ck.checkpoint_versions(ckpt)
    assert len(versions) == 3 and versions[0] == _current(ckpt)


def test_restore_without_versions_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore_checkpoint(str(tmp_path / "none"), Config(**CFG),
                              device="cpu")


# ---------------------------------------------------------------------------
# the durable-IO seam: crash-ordering cases over both modules
# ---------------------------------------------------------------------------

SEAMS = pytest.mark.parametrize("st", [jax_storage, t_storage],
                                ids=["jax", "port"])


@SEAMS
def test_seam_torn_write_never_tears_published_file(tmp_path, st):
    p = str(tmp_path / "f.txt")
    st.atomic_write_bytes(p, b"committed content")
    st.global_storage.arm(st.TORN_WRITE, f"{p}*", keep_bytes=3)
    try:
        with pytest.raises(st.DiskFault):
            st.atomic_write_bytes(p, b"replacement that crashes")
    finally:
        st.global_storage.heal()
    assert st.read_bytes(p) == b"committed content"
    assert os.listdir(tmp_path) == ["f.txt"]


@SEAMS
def test_seam_fsync_eio_fails_before_publish(tmp_path, st):
    p = str(tmp_path / "f.txt")
    st.atomic_write_bytes(p, b"old")
    st.global_storage.arm(st.FSYNC_EIO, f"{p}*", times=1)
    try:
        with pytest.raises(st.DiskFault):
            st.atomic_write_bytes(p, b"new")
    finally:
        st.global_storage.heal()
    assert st.read_bytes(p) == b"old"


@SEAMS
def test_seam_crash_before_and_after_rename(tmp_path, st):
    p = str(tmp_path / "f.txt")
    st.atomic_write_bytes(p, b"old")
    st.global_storage.arm(st.CRASH_BEFORE_RENAME, p, times=1)
    with pytest.raises(st.DiskFault):
        st.atomic_write_bytes(p, b"new")
    assert st.read_bytes(p) == b"old"
    st.global_storage.heal()
    st.global_storage.arm(st.CRASH_AFTER_RENAME, p, times=1)
    with pytest.raises(st.DiskFault):
        st.atomic_write_bytes(p, b"new")
    st.global_storage.heal()
    assert st.read_bytes(p) == b"new"


@SEAMS
def test_seam_enospc_and_bitrot(tmp_path, st):
    p = str(tmp_path / "f.txt")
    st.global_storage.arm(st.ENOSPC, f"{p}*")
    try:
        with pytest.raises(OSError) as ei:
            st.atomic_write_bytes(p, b"x")
    finally:
        st.global_storage.heal()
    assert ei.value.errno == errno.ENOSPC
    j = str(tmp_path / "state.json")
    st.atomic_write_json(j, {"epoch": 173})
    assert st.read_json(j) == {"epoch": 173}
    st.global_storage.arm(st.BITROT, j, keep_bytes=30)
    try:
        with pytest.raises(st.StorageCorruption):
            st.read_json(j)
    finally:
        st.global_storage.heal()


@SEAMS
def test_seam_manifest_catches_flip_truncation_and_loss(tmp_path, st):
    d = str(tmp_path / "v1")
    os.makedirs(d)
    for name, data in (("a.bin", b"alpha" * 10), ("b.json", b'{"k": 1}')):
        st.write_bytes(os.path.join(d, name), data)
    st.write_manifest(d)
    assert st.verify_manifest(d) == []
    p = os.path.join(d, "b.json")
    raw = bytearray(open(p, "rb").read())
    raw[2] ^= 0x01
    open(p, "wb").write(bytes(raw))
    assert any("b.json" in x for x in st.verify_manifest(d))
    with open(os.path.join(d, "a.bin"), "r+b") as f:
        f.truncate(5)
    assert any("a.bin" in x for x in st.verify_manifest(d))
    os.unlink(os.path.join(d, st.MANIFEST_NAME))
    assert any("manifest missing" in x for x in st.verify_manifest(d))


@SEAMS
def test_seam_publish_dir_is_complete_or_absent(tmp_path, st):
    build = str(tmp_path / "build")
    os.makedirs(build)
    st.write_bytes(os.path.join(build, "x"), b"1")
    st.global_storage.arm(st.CRASH_BEFORE_RENAME, str(tmp_path / "v1"),
                          times=1)
    with pytest.raises(st.DiskFault):
        st.publish_dir(build, str(tmp_path / "v1"))
    assert not os.path.exists(tmp_path / "v1")
    st.global_storage.heal()
    st.publish_dir(build, str(tmp_path / "v1"))
    assert open(tmp_path / "v1" / "x", "rb").read() == b"1"


@SEAMS
def test_seam_group_commit_fault_reaches_only_its_caller(tmp_path, st):
    gc = st.GroupCommitter()
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    st.write_bytes(good, b"g")
    st.write_bytes(bad, b"b")
    st.global_storage.arm(st.FSYNC_EIO, bad)
    results = {}

    def run(tag, p):
        try:
            gc.sync([p, str(tmp_path)])
            results[tag] = "ok"
        except OSError:
            results[tag] = "err"

    ts = [threading.Thread(target=run, args=("good", good)),
          threading.Thread(target=run, args=("bad", bad))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    st.global_storage.heal()
    assert results == {"good": "ok", "bad": "err"}
