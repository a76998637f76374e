"""The port's compute-fault plane on the CPU: the device nemesis, the fault
classifier, ``ComputeHealth``, the engine's guard, and the host fallback
scorer.

The load-bearing gate is the fallback's parity: the port's
``HostFallbackScorer`` must return the port's device path to the BIT
(values and ids, so ties break the same), for the ELL layout with its COO
residual and for COO, under all three models, top-k and unbounded. It is
also bit-equal to the JAX package's ``HostFallbackScorer`` on the same
snapshot (the JAX engine's, installed in the port), except for BM25 on
the COO layout. There each package computes the per-entry weights at
query time with its own ``log1p`` (the idf), and PyTorch's and XLA's CPU
``log1p`` differ by one ulp on about a fifth of these inputs; the scores
then differ by at most 2 ulp, and the ids are identical. The ELL layout
scores impacts stored in the snapshot, and TF-IDF takes ``log``, where
the two agree: those are held to the byte.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_engine import SMALL, _zipf_queries, _zipf_texts
from tfidf_tpu.cluster.resilience import \
    classify_compute_fault as jax_classify
from tfidf_tpu.engine.compute_health import \
    HostFallbackScorer as JaxFallback
from tfidf_tpu.engine.engine import Engine as JaxEngine
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.cluster.resilience import classify_compute_fault
from tfidf_tpu_torch.engine.compute_health import (DEGRADED, HEALTHY, SICK,
                                                   ComputeHealth,
                                                   HostFallbackScorer)
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.kernels import KernelBuildError, KernelLaunchError
from tfidf_tpu_torch.ops import ell as E
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.device_nemesis import (DeviceCompileError,
                                                  DeviceNemesis,
                                                  DeviceOOMError,
                                                  DevicePoisonedOutput,
                                                  DeviceSickError,
                                                  DeviceTransientError,
                                                  global_device_nemesis,
                                                  poison_scores)
from tfidf_tpu_torch.utils.faults import FaultInjected, global_injector
from tfidf_tpu_torch.utils.metrics import global_metrics

QUERIES = _zipf_queries(31, n=24)


@pytest.fixture(autouse=True)
def _clean_nemesis():
    global_device_nemesis.clear()
    yield
    global_device_nemesis.clear()
    global_injector.disarm()


def _engine(docs=None, **kw):
    cfg = dict(dict(SMALL, min_doc_capacity=256, query_batch=8,
                    max_query_terms=8), **kw)
    e = Engine(Config(**cfg), device="cpu")
    for name, text in (docs or _zipf_texts(32, n_docs=260)).items():
        e.ingest_text(name, text)
    e.commit()
    return e


def _pairs(hits):
    return [[(h.name, h.score) for h in hs] for hs in hits]


# ---------------------------------------------------------------------------
# device nemesis
# ---------------------------------------------------------------------------

def test_nemesis_grammar_and_env_format():
    n = DeviceNemesis(
        env="score_ell:oom:1.0:min_batch=4,*:delay::delay_s=0.0")
    snap = n.snapshot()
    assert n.armed and not n.sick
    assert [r["kind"] for r in snap["rules"]] == ["oom", "delay"]
    assert snap["rules"][0]["min_batch"] == 4
    assert n.check("anything") is None
    assert n.check("score_ell", batch=2) is None      # under min_batch
    with pytest.raises(DeviceOOMError):
        n.check("score_ell", batch=4)
    for bad in ("score_ell", "score_ell:frobnicate",
                "score_ell:oom:1.0:wat=1"):
        with pytest.raises(ValueError):
            DeviceNemesis(env="").script(bad)


def test_nemesis_globs_counts_sick_and_remove():
    n = DeviceNemesis(env="")
    rid = n.add_rule("score_*", "transient", count=2)
    with pytest.raises(DeviceTransientError):
        n.check("score_ell")
    with pytest.raises(DeviceTransientError):
        n.check("score_coo")
    assert n.check("score_ell") is None
    assert n.snapshot()["rules"][0]["fired"] == 2
    assert n.remove_rule(rid) and not n.remove_rule(rid)
    n.script("score_coo:sick::count=1")
    with pytest.raises(DeviceSickError):
        n.check("score_coo")
    with pytest.raises(DeviceSickError):       # sticky: every seam
        n.check("score_ell")
    n.heal()
    assert n.check("score_ell") is None
    n.clear()
    assert not n.armed


def test_poison_scores_targets_rows_on_the_device_tensor():
    n = DeviceNemesis(env="score_ell:poison:1.0:min_uniq=2")
    rule = n.check("score_ell")
    assert rule is not None and rule.kind == "poison"
    scores = torch.ones((3, 4))
    weights = torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 0.0],
                            [1.0, 2.0, 3.0]])
    out = poison_scores(scores, weights, rule.min_uniq)
    assert torch.isnan(out[0]).all() and torch.isnan(out[2]).all()
    assert (out[1] == 1.0).all()
    assert torch.isnan(poison_scores(scores, weights, 0)).all()


def test_generic_injector_fires_at_the_device_seams():
    e = _engine()
    global_injector.arm("device.score_ell", "raise", times=1)
    with pytest.raises(FaultInjected):
        e.searcher.search(["t1"])
    assert e.searcher.search(["t1"])


# ---------------------------------------------------------------------------
# the classifier, under both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exc,kind", [
    (DeviceOOMError("x"), "oom"),
    (DeviceCompileError("x"), "compile"),
    (DeviceTransientError("x"), "transient"),
    (DeviceSickError("x"), "transient"),
    (DevicePoisonedOutput(("q",)), "poison"),
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.00 GiB"), "oom"),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
], ids=["oom", "compile", "transient", "sick", "poison", "torch_oom",
        "oom_message"])
def test_port_faults_classify_the_same_under_both(exc, kind):
    assert classify_compute_fault(exc) == kind
    assert jax_classify(exc) == kind


@pytest.mark.parametrize("exc,kind", [
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "transient"),
    (RuntimeError("CUDA error: unspecified launch failure"), "transient"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"),
     "transient"),
    (RuntimeError("something else went wrong"), None),
    (ValueError("nope"), None),
    (KernelBuildError("kernel build failed:\nell_score: nvcc exit 1\n"
                      "ell_score.cu(12): error: expected a ';'"), None),
    (KernelLaunchError("ell_score launch returned CUDA error 9"), None),
], ids=["illegal_address", "launch_failure", "ecc", "generic", "value",
        "kernel_build", "kernel_launch"])
def test_torch_runtime_errors(exc, kind):
    assert classify_compute_fault(exc) == kind
    if kind is None:
        assert jax_classify(exc) is None


def test_reraised_fault_carries_its_class_to_the_jax_classifier():
    """A CUDA runtime error the engine does not absorb (no fallback)
    leaves stamped with ``compute_fault``, so a JAX-package node hosting
    this engine classifies it as the engine did."""
    e = _engine(compute_fallback=False)

    def boom(*a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    e.searcher.search = boom
    with pytest.raises(RuntimeError) as ei:
        e.search_batch(["t1"])
    assert jax_classify(ei.value) == "transient"
    assert e.compute_stats()["faults_by_kind"] == {"transient": 1}


# ---------------------------------------------------------------------------
# ComputeHealth with a fake clock
# ---------------------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_health_escalation_reset_and_poison():
    h = ComputeHealth(degraded_after=2, sick_after=4)
    states = []
    for kind in ("transient", "oom", "poison", "transient", "transient"):
        h.note_fault(kind)
        states.append(h.state)
    assert states == [HEALTHY, DEGRADED, DEGRADED, DEGRADED, SICK]
    assert h.snapshot()["faults_by_kind"] == {"transient": 3, "oom": 1}
    h.note_success()
    assert h.state == HEALTHY and h.consecutive_faults == 0


def test_health_probe_pacing_and_shortened_interval():
    clk = FakeClock()
    h = ComputeHealth(degraded_after=1, sick_after=2,
                      probe_interval_s=5.0, clock=clk)
    h.note_fault("transient")
    h.note_fault("transient")
    assert h.state == SICK and not h.should_try_device()
    clk.t += 5.0
    assert h.should_try_device() and not h.should_try_device()
    h.note_fault("transient")             # the probe failed: re-armed
    clk.t += 4.0
    assert not h.should_try_device()
    # an operator shortens the interval while sick: it applies at once
    h.probe_interval_s = 1.0
    assert h.should_try_device()
    assert h.snapshot()["recovery_probes"] == 2
    h.note_success()
    assert h.state == HEALTHY and h.should_try_device()


# ---------------------------------------------------------------------------
# the fallback's bit parity
# ---------------------------------------------------------------------------

LAYOUTS = {"ell": dict(), "residual": dict(ell_width_cap=8),
           "coo": dict(scoring_layout="coo")}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_fallback_bitwise_equal_to_device_path(layout, model):
    e = _engine(model=model, **LAYOUTS[layout])
    snap = e.index.snapshot
    assert (snap.res_tf is not None) == (layout == "residual")
    fb = HostFallbackScorer(e.searcher)
    dv, di, dk, dn = e.searcher.search_arrays(QUERIES, k=10)
    hv, hi, hk, hn = fb.search_arrays(QUERIES, k=10)
    assert dk == hk and list(dn) == list(hn)
    assert dv.tobytes() == hv.tobytes()
    np.testing.assert_array_equal(di, hi)
    assert (dv > 0).any()
    for unbounded in (False, True):
        assert _pairs(fb.search(QUERIES[:8], k=6, unbounded=unbounded)) \
            == _pairs(e.searcher.search(QUERIES[:8], k=6,
                                        unbounded=unbounded))


def test_fallback_kernel_envelope_blocks_bitwise():
    """Blocks inside the kernel envelope (use_pallas, the plain version on
    the CPU) and outside it, one batch of 16: the same bits."""
    e = _engine(query_batch=16)
    assert any(E._pallas_eligible(i.shape[0], 16, 256)
               for i in e.index.snapshot.ell_impacts)
    dv, di, _, _ = e.searcher.search_arrays(QUERIES, k=10)
    hv, hi, _, _ = e._fallback.search_arrays(QUERIES, k=10)
    assert dv.tobytes() == hv.tobytes() and (di == hi).all()


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("model", ["bm25", "tfidf", "tfidf_cosine"])
def test_fallback_equal_to_jax_fallback_on_same_snapshot(layout, model):
    cfg = dict(SMALL, min_doc_capacity=256, query_batch=8, model=model,
               scoring_layout=layout)
    je = JaxEngine(JaxConfig(**dict(cfg, use_pallas=False)))
    for name, text in _zipf_texts(33, n_docs=200).items():
        je.ingest_text(name, text)
    je.commit()
    arrays, names, _gen = je.index.export_snapshot_arrays()
    te = Engine(Config(**cfg), device="cpu")
    te.vocab.extend(je.vocab.all_terms())
    te.index.install_snapshot_arrays(arrays, names)
    jv, ji, _, _ = JaxFallback(je.searcher).search_arrays(QUERIES, k=10)
    tv, ti, _, _ = HostFallbackScorer(te.searcher).search_arrays(QUERIES,
                                                                 k=10)
    np.testing.assert_array_equal(ti, ji)
    if layout == "coo" and model == "bm25":
        # the idf's log1p: one ulp apart between the packages on these
        # arguments, 2 ulp at most in the summed scores
        x = np.asarray(je.index.snapshot.df, np.float32)
        n = np.float32(je.index.snapshot.n_docs)
        arg = (n - x + np.float32(0.5)) / (x + np.float32(0.5))
        assert not np.array_equal(np.asarray(jnp.log1p(arg)),
                                  torch.log1p(torch.from_numpy(arg)).numpy())
        ulps = np.abs(tv.view(np.int32).astype(np.int64)
                      - jv.view(np.int32))
        assert ulps.max() <= 2 and (tv > 0).any()
    else:
        assert tv.tobytes() == jv.tobytes()


def test_mirror_is_fetched_at_commit_once_per_snapshot():
    before = global_metrics.get("compute_fallback_mirror_builds")
    e = _engine()
    assert global_metrics.get("compute_fallback_mirror_builds") \
        == before + 1
    assert e._fallback.mirror_stats()["host_bytes"] > 0
    e._fallback.search(["t1"])
    e.commit()                              # nothing changed: no rebuild
    assert global_metrics.get("compute_fallback_mirror_builds") \
        == before + 1
    e.ingest_text("new", "t1 t2 brand new")
    e.commit()
    assert global_metrics.get("compute_fallback_mirror_builds") \
        == before + 2


# ---------------------------------------------------------------------------
# the engine's compute guard
# ---------------------------------------------------------------------------

def test_fault_degrades_to_exact_fallback_then_sick():
    e = _engine(compute_sick_after=2, compute_probe_interval_s=3600.0)
    baseline = _pairs(e.search_batch(QUERIES, k=4))
    assert not e.pop_fallback_served()
    global_device_nemesis.script("score_ell:transient")
    served = global_metrics.get("compute_fallback_served")
    for _ in range(3):
        assert _pairs(e.search_batch(QUERIES, k=4)) == baseline
        assert e.pop_fallback_served()
    stats = e.compute_stats()
    assert stats["state"] == SICK and stats["fallback_available"]
    # sick: the device is not tried (the rule fired only twice)
    assert global_device_nemesis.snapshot()["rules"][0]["fired"] == 2
    assert global_metrics.get("compute_fallback_served") \
        == served + 3 * len(QUERIES)


def test_recovery_probe_heals():
    e = _engine(compute_degraded_after=1, compute_sick_after=1,
                compute_probe_interval_s=0.0)
    baseline = _pairs(e.search_batch(["t1 t2"], k=3))
    rid = global_device_nemesis.add_rule("score_ell", "transient")
    e.search_batch(["t1 t2"], k=3)
    assert e.compute_stats()["state"] == SICK and e.pop_fallback_served()
    global_device_nemesis.remove_rule(rid)
    assert _pairs(e.search_batch(["t1 t2"], k=3)) == baseline
    assert not e.pop_fallback_served()
    st = e.compute_stats()
    assert st["state"] == HEALTHY and st["recovery_probes"] >= 1


def test_oom_ladder_merges_smaller_batches():
    e = _engine(oom_backoff_min_batch=1)
    qs = QUERIES[:8]
    baseline = _pairs(e.search_batch(qs, k=4))
    arrays = e.search_batch_arrays(qs, k=4)
    steps = global_metrics.get("compute_oom_backoff")
    global_device_nemesis.script("score_ell:oom:1.0:min_batch=8")
    assert _pairs(e.search_batch(qs, k=4)) == baseline
    got = e.search_batch_arrays(qs, k=4)
    assert got[0].tobytes() == arrays[0].tobytes()
    assert (got[1] == arrays[1]).all() and got[2:] == arrays[2:]
    assert global_metrics.get("compute_oom_backoff") == steps + 2
    assert not e.pop_fallback_served()
    assert e.compute_stats()["state"] == HEALTHY


def test_oom_floor_degrades_to_fallback():
    e = _engine(oom_backoff_min_batch=8)
    qs = QUERIES[:8]
    baseline = _pairs(e.search_batch(qs, k=4))
    global_device_nemesis.script("score_ell:oom")
    assert _pairs(e.search_batch(qs, k=4)) == baseline
    assert e.pop_fallback_served()


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_poison_is_never_absorbed(layout):
    e = _engine(scoring_layout=layout)
    site = "score_ell" if layout == "ell" else "score_coo"
    global_device_nemesis.script(f"{site}:poison:1.0:min_uniq=3")
    bad = "t1 t2 t3 t4"
    with pytest.raises(DevicePoisonedOutput) as ei:
        e.search_batch(["t1", bad, "t2 t3"], k=4)
    assert ei.value.queries == (bad,)
    with pytest.raises(DevicePoisonedOutput):
        e.search_batch_arrays([bad], k=4)
    assert not e.pop_fallback_served()
    assert e.compute_stats()["state"] == HEALTHY
    assert e.search_batch(["t1"], k=4)[0]


@pytest.mark.parametrize("exc,kind", [
    (KernelLaunchError("ell_score launch returned CUDA error 9"), None),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "transient"),
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.00 GiB"), "oom"),
], ids=["kernel_launch", "illegal_address", "oom_at_the_floor"])
def test_real_faults_reraise_and_the_fallback_serves_none(exc, kind):
    """Only injected faults are served by the fallback, with it on. A real
    launch error re-raises without touching health; a real CUDA error or
    an OOM at the ladder's floor advances health and re-raises, and even
    sick from them the device is still tried."""
    e = _engine(compute_degraded_after=1, compute_sick_after=1,
                compute_probe_interval_s=3600.0, oom_backoff_min_batch=8)
    qs = QUERIES[:8]
    baseline = _pairs(e.search_batch(qs, k=4))
    device_search = e.searcher.search
    tries = []

    def fail(*a, **kw):
        tries.append(1)
        raise exc
    e.searcher.search = fail
    served = global_metrics.get("compute_fallback_served")
    for _ in range(2):
        with pytest.raises(type(exc)) as ei:
            e.search_batch(qs, k=4)
        assert ei.value is exc
    assert len(tries) == 2
    assert global_metrics.get("compute_fallback_served") == served
    assert not e.pop_fallback_served()
    st = e.compute_stats()
    if kind is None:
        assert st["state"] == HEALTHY and st["total_faults"] == 0
    else:
        assert st["state"] == SICK and st["faults_by_kind"] == {kind: 2}
        assert jax_classify(exc) == kind
    e.searcher.search = device_search
    assert _pairs(e.search_batch(qs, k=4)) == baseline
    assert not e.pop_fallback_served()
    assert e.compute_stats()["state"] == HEALTHY


def test_faults_surface_when_the_fallback_is_disabled():
    e = _engine(compute_fallback=False, scoring_layout="coo")
    global_device_nemesis.script("score_coo:transient")
    with pytest.raises(DeviceTransientError):
        e.search_batch(["t1"], k=3)
    assert e.compute_stats()["fallback_available"] is False
    assert e._fallback is None
