"""The port's COO mesh engine (``MeshIndex`` / ``MeshSearcher``) held
against the JAX package on the CPU: the flows of
``tests/test_mesh_engine.py`` with a port engine on in-process CPU ranks
and a JAX engine on the virtual CPU devices, in lockstep. Top-k ids
identical outside near-tie groups and scores within relative 1e-6 (not
bitwise: PyTorch's and XLA's ``log1p``/``log`` differ by an ulp on some
arguments, and the segment sums' orders differ), and equal to the local
engine where the reference's tests hold them to it (global statistics,
no tombstones in df). Then the checkpoint and ``save_sharded_arrays``
files of a mesh engine crossing the packages.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_mesh_ell import (QUERIES, TEXTS, MeshTwin, cpu_mesh,
                                      jax_mesh, results)
from tests.test_torch_segments import assert_same_hits
from tfidf_tpu.engine import checkpoint as jax_ckpt
from tfidf_tpu.parallel import sharded as jax_sharded
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.engine import checkpoint as t_ckpt
from tfidf_tpu_torch.parallel import sharded
from tfidf_tpu_torch.parallel.mesh_index import MeshIndex
from tfidf_tpu_torch.utils.config import Config

SHAPES = [(8, 1), (4, 2), (2, 4), (2, 2)]


def coo_twin(tmp_path, sub, shape=(4, 2), **kw):
    return MeshTwin(tmp_path, sub, shape, layout="coo", **kw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_mesh_equals_jax_and_local(tmp_path, shape, model):
    w = coo_twin(tmp_path, "m", shape, model=model)
    assert type(w.t.index) is MeshIndex
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    assert w.t.index.mesh.devices.size == shape[0] * shape[1]
    for q in QUERIES:
        w.search(q)
    assert results(w.t) == results(w.j) == results(w.local)


def test_unbounded_parity_equals_jax_and_local(tmp_path):
    w = coo_twin(tmp_path, "mu")
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    for q in QUERIES:
        w.search(q, unbounded=True)


@pytest.mark.parametrize("shape", [(4, 2), (2, 2)])
def test_lucene_parity_per_row_statistics(tmp_path, shape):
    """``lucene_parity``: each docs row scores against its own df/N/avgdl
    (as each Java worker does), in both packages alike."""
    w = coo_twin(tmp_path, "lp", shape, local=False, lucene_parity=True)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    assert not w.t.searcher.global_idf
    for q in QUERIES:
        w.search(q)


def test_incremental_append_equals_jax_and_local(tmp_path):
    w = coo_twin(tmp_path, "mi")
    items = list(TEXTS.items())
    for i in range(0, len(items), 3):
        for name, text in items[i:i + 3]:
            w.ingest(name, text)
        w.commit()
    assert w.t.index.appends >= 1
    assert w.t.index.appends == w.j.index.appends
    assert w.t.index.rebuilds == w.j.index.rebuilds
    for q in QUERIES:
        w.search(q)


def test_delete_upsert_and_snapshot_isolation(tmp_path):
    """Tombstones stay in df until a re-shard (as in the JAX package), so
    after deletes the port is held to the JAX engine only."""
    w = coo_twin(tmp_path, "del", local=False)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    snap1 = w.t.index.snapshot
    live1 = sharded.live_host(snap1.arrays).copy()
    assert w.delete("b.txt") and not w.delete("b.txt")
    w.commit()
    np.testing.assert_array_equal(sharded.live_host(snap1.arrays), live1)
    assert (sharded.live_host(w.t.index.snapshot.arrays).sum()
            == live1.sum() - 1)
    names = [h.name for h in w.search("fox", k=10)]
    assert "b.txt" not in names and "a.txt" in names
    w.ingest("a.txt", "replacement narwhal content")
    w.commit()
    assert [h.name for h in w.search("narwhal")] == ["a.txt"]
    assert "a.txt" not in [h.name for h in w.search("quick")]
    assert w.t.index.num_live_docs == len(TEXTS) - 1
    for q in QUERIES:
        w.search(q)


def test_vocab_growth_and_capacity_overflow_reshard(tmp_path):
    w = coo_twin(tmp_path, "vg", local=False)
    for name, text in list(TEXTS.items())[:4]:
        w.ingest(name, text)
    w.commit()
    cap0 = w.t.index.snapshot.arrays.vocab_cap
    r0 = w.t.index.rebuilds
    for i in range(4):
        w.ingest(f"v{i}.txt", " ".join(f"neo{i}_{j}" for j in range(40)))
    w.commit()
    assert w.t.vocab.capacity() > cap0
    assert w.t.index.snapshot.arrays.vocab_cap >= w.t.vocab.capacity()
    assert w.t.index.rebuilds > r0
    assert [h.name for h in w.search("neo2_7")] == ["v2.txt"]
    r1 = w.t.index.rebuilds
    for i in range(300):
        w.ingest(f"bulk{i:03d}.txt",
                 f"alpha beta token{i % 50} extra{i % 7}")
    w.commit()
    assert w.t.index.rebuilds > r1
    assert w.t.index.rebuilds == w.j.index.rebuilds
    assert len(w.search("token33", k=10)) == 6
    w.search("fox", k=10)


def test_tombstones_reclaimed_by_reshard(tmp_path):
    w = coo_twin(tmp_path, "rec")
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    w.delete("a.txt")
    w.commit()
    for e in (w.t, w.j):
        e.index._rebuild_locked([], e.vocab.capacity())
    assert all(d.live for sd in w.t.index._shard_docs for d in sd)
    assert w.t.index.num_live_docs == len(TEXTS) - 1


def test_mesh_layout_cannot_list(tmp_path):
    """As in the JAX package: no listing and no arrays path on a mesh
    layout (a node then takes its hit-list path)."""
    w = coo_twin(tmp_path, "nl", local=False)
    w.ingest("a.txt", "alpha")
    w.commit()
    assert w.t.document_names() is None is w.j.document_names()
    assert w.t.search_batch_arrays(["alpha"]) is None
    assert w.j.search_batch_arrays(["alpha"]) is None


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_engine_checkpoint_crosses_packages(tmp_path, direction):
    w = coo_twin(tmp_path, "ck", (2, 2), local=False)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    path = str(tmp_path / "ckpt")
    cfg = dict(engine_mode="mesh", mesh_layout="coo", min_doc_capacity=8,
               min_nnz_capacity=256, min_vocab_capacity=64, query_batch=4,
               max_query_terms=8)
    if direction == "port_to_jax":
        t_ckpt.save_checkpoint(w.t, path)
        restored = jax_ckpt.load_checkpoint(path, JaxConfig(
            documents_path=str(tmp_path / "r"), **cfg))
        src = w.t
    else:
        jax_ckpt.save_checkpoint(w.j, path)
        restored = t_ckpt.load_checkpoint(path, Config(
            documents_path=str(tmp_path / "r"), mesh_shape=(2, 2), **cfg),
            device="cpu")
        assert type(restored.index) is MeshIndex
        src = w.j
    for q in QUERIES:
        assert_same_hits(restored.search(q), src.search(q))


def test_engine_sharded_arrays_roundtrip_and_shape_refusal(tmp_path):
    """A mesh engine's committed arrays saved by the port restore into the
    port and into the JAX package, array for array, and serve; a mesh of
    another shape is refused with the "rebuild" error."""
    import dataclasses
    w = coo_twin(tmp_path, "ark", (4, 2), local=False)
    for name, text in TEXTS.items():
        w.ingest(name, text)
    w.commit()
    arrays = w.t.index.snapshot.arrays
    path = str(tmp_path / "arrays.npz")
    sharded.save_sharded_arrays(arrays, path)
    restored = sharded.load_sharded_arrays(path, w.t.index.mesh)
    for f in ("tf", "term", "doc", "doc_len", "df", "live"):
        assert all(torch.equal(a, b) for a, b in
                   zip(getattr(restored, f), getattr(arrays, f))), f
    for f in ("n_live", "nnz_used", "len_sum"):
        np.testing.assert_array_equal(getattr(restored, f),
                                      getattr(arrays, f))
    jarr = jax_sharded.load_sharded_arrays(path, w.j.index.mesh)
    np.testing.assert_array_equal(np.asarray(jarr.df),
                                  np.asarray(w.j.index.snapshot.arrays.df))
    w.t.index.snapshot = dataclasses.replace(w.t.index.snapshot,
                                             arrays=restored)
    assert sorted(h.name for h in w.t.search("lorem")) == ["c.txt", "f.txt"]
    with pytest.raises(ValueError, match="rebuild"):
        sharded.load_sharded_arrays(path, cpu_mesh((2, 1)))
    with pytest.raises(ValueError, match="rebuild"):
        jax_sharded.load_sharded_arrays(path, jax_mesh((2, 1)))
