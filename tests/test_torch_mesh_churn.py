"""The port's mesh churn probe (``probe_mesh_churn_torch.py``) at a cut,
with a JAX mesh engine on the same churn in lockstep.

The probe's own loop (its seed, corpus, upserts, re-uploads, deletes and
queries) drives a port mesh engine on 8 in-process CPU ranks and a JAX
mesh engine on the 8 virtual devices of ``tests/conftest.py``, both fed
every operation in the same order. After every commit: the probe's scipy
oracle holds the port's top-10 (live statistics for ELL, statistics with
tombstones until a re-shard for COO), the port's top-10 ids and scores
equal the JAX engine's (scores within relative 1e-6, a different id only
inside a near-tie group), and the port's ``rebuilds`` / ``appends`` equal
the JAX engine's.
"""

import importlib.util
import os

import jax
import pytest

from tests.test_torch_segments import assert_same_hits
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tfidf_tpu.utils.config import Config as JaxConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "probe_mesh_churn_torch", os.path.join(ROOT, "probe_mesh_churn_torch.py"))
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

# 2,000 base docs, 3 rounds, a quarter of each round's operations
CUT = dict(base_docs=2000, rounds=3, new_per_round=375, reup_per_round=150,
           del_per_round=225)


def jax_engine(layout):
    return JaxEngine(JaxConfig(
        engine_mode="mesh", mesh_layout=layout,
        query_batch=probe.QUERIES_PER_CHECK, max_query_terms=8),
        mesh=jax_make_mesh((8, 1), devices=jax.devices()[:8]))


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_churn_matches_jax_in_lockstep(layout):
    counts = []

    def on_commit(engine, mirror, queries, hits):
        counts.append((engine.index.rebuilds, engine.index.appends))
        assert counts[-1] == (mirror.index.rebuilds, mirror.index.appends)
        want = mirror.search_batch(queries, k=probe.TOP_K)
        assert len(hits) == len(want) == len(queries)
        for got, w in zip(hits, want):
            assert_same_hits(got, w)

    port, jx = probe.port_engine(layout, "cpu", (8, 1)), jax_engine(layout)
    res = probe.run_layout(port, layout, mirror=jx, on_commit=on_commit,
                           **CUT)
    assert res["commits"] == res["parity_checks"] == len(counts) == 4
    assert res["parity_checked"]
    # the cut reaches both commit paths: an append into the delta and a
    # re-shard past the base build
    assert counts[-1][1] >= 1 and counts[-1][0] >= 2, counts
    assert res["final_live_docs"] == port.index.num_live_docs \
        == jx.index.num_live_docs


def test_probe_refuses_a_card_it_does_not_have(tmp_path, capsys):
    """Without CUDA the default device is refused with the CUDA message
    (exit 2), and nothing is written."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert probe.main(["--out", str(tmp_path / "out")]) == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not (tmp_path / "out").exists()
