"""The tier mode (``bench_modes.bench_tier``) against the root
``bench.py``'s ``bench_tier``, at a tiny size on the CPU.

Both packages ingest the same time-drifting corpus (24 phases of 2,000
docs, a 1 MB hot budget) and run the same queries: every phase's tiered
top-k must equal the ``tier_bypass`` oracle's to the bit, and the four
gates must hold (device bytes past the budget, a cold-segment skip rate
above 0.5, one full df recompute, no ingest decay below half). The skip
decisions are the same in both packages, phase by phase. The JAX bench
compiles a program per phase here, so this file holds the one slow
comparison on its own.

At this size a phase ingests in tens of milliseconds, where a shared
host's scheduling moves single phases by 2x: the bench's host clock is
replaced (in both packages' modules) by one that advances a fixed step a
reading, so every timing is the same fixed value and the comparison is of
what the runs decide. The decay gate has its own test, on a clock that
slows down.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from tfidf_tpu_torch import bench_modes as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(n_docs=48_000, phase_docs=2_000, budget_mb=1)
# the card's memory and the corpus's exact device bytes, beside the
# budget: on the card it is the budget that makes the corpus cold
ADDED = {"card_memory_bytes", "corpus_device_bytes"}


class SteppedClock:
    """``time`` for a bench module: ``perf_counter`` advances ``step``
    seconds a reading, the step growing by ``growth`` each reading."""

    def __init__(self, step: float = 1e-3, growth: float = 0.0) -> None:
        self.now, self.step, self.growth = 0.0, step, growth

    def perf_counter(self) -> float:
        self.now += self.step
        self.step += self.growth
        return self.now

    monotonic = perf_counter


@pytest.fixture(scope="module")
def jax_bench():
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench_tier", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.environ.clear()
    os.environ.update(env)
    return mod


@pytest.mark.timeout(600)
def test_tier_matches_the_jax_bench(jax_bench, monkeypatch, tmp_path,
                                    capsys):
    out = tmp_path / "BENCH_r12.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    monkeypatch.setattr(M, "time", SteppedClock())
    monkeypatch.setattr(jax_bench, "time", SteppedClock())
    M.tier_main(device="cpu", **TINY)
    art = json.loads(out.read_text())
    got = art["extra"]
    for name, value in {"TI_DOCS": TINY["n_docs"],
                        "TI_PHASE": TINY["phase_docs"],
                        "TI_BUDGET_MB": TINY["budget_mb"]}.items():
        monkeypatch.setattr(jax_bench, name, value)
    want = jax_bench.bench_tier(np.random.default_rng(0))
    assert set(got) == set(want) | ADDED
    for key in ("docs", "phases", "vocab", "top_k", "budget_mb",
                "segments", "skip_rate", "skip_rate_per_phase",
                "df_full_recomputes", "parity_checked_phases"):
        assert got[key] == want[key], key
    assert got["backend"] == "cpu" and got["card_memory_bytes"] is None
    assert got["corpus_device_bytes"] > TINY["budget_mb"] << 20
    assert got["skip_rate"] > 0.5
    assert got["ingest_dps_last"] == got["ingest_dps_first"] == \
        want["ingest_dps_first"]
    assert art["kernel_builds_during_measurement"] == 0
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["detail_file"] == "BENCH_r12.json"
    assert head["headline"]["skip_rate"] == got["skip_rate"]


@pytest.mark.timeout(120)
def test_tiered_divergence_fails_the_gate(tmp_path, monkeypatch, capsys):
    """A tiered dispatch that answers differently from the bypass oracle
    stops the run at its first phase, with no artifact."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.engine.searcher import SearchHit
    real = Engine.search_batch

    def wrong(self, queries, k=None, unbounded=False):
        hits = real(self, queries, k=k, unbounded=unbounded)
        if self.searcher.tier_bypass:
            return hits
        return [[SearchHit(h.name, h.score * 1.01) for h in hs]
                for hs in hits]

    monkeypatch.setattr(Engine, "search_batch", wrong)
    out = tmp_path / "BENCH_r12.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    with pytest.raises(SystemExit) as e:
        M.tier_main(device="cpu", **TINY)
    assert e.value.code == 1
    assert "diverged from the untiered oracle at phase 0" in \
        capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("n_docs,budget_mb,growth,msg", [
    (8_000, 64, 0.0, "fits the hot budget"),
    (8_000, 1, 0.0, "skip rate"),
    (48_000, 1, 1e-4, "ingest dps decayed")])
def test_tier_gates_refuse(tmp_path, monkeypatch, capsys, n_docs, budget_mb,
                           growth, msg):
    """A corpus that fits its budget proves nothing about tiering, too few
    phases skip too little, and an ingest that slows below half its first
    phase's rate (a clock whose step grows) fails: each stops the run, no
    artifact."""
    out = tmp_path / "BENCH_r12.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    monkeypatch.setattr(M, "time", SteppedClock(growth=growth))
    with pytest.raises(SystemExit) as e:
        M.tier_main(device="cpu", n_docs=n_docs,
                    phase_docs=2_000, budget_mb=budget_mb)
    assert e.value.code == 1
    assert msg in capsys.readouterr().err
    assert not out.exists()
