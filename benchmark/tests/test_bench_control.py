"""The comparison that decides ``correct`` fails what it must: the
control (the reference in TF32 in the system's place) and the faults a
cell can have, planted under the timed path of an otherwise whole run on
the CPU at a test size. One chip, so no exchange between chips exists
to leave out."""

import gc

import pytest

from harness import check, registry
from harness.cell import make_run


def _run(workload, tiny, manifest, seed, patch=None, monkeypatch=None,
         precision="f64"):
    c = registry.load(workload, manifest=manifest)
    seconds = 1.5
    r = make_run(c, seed, "cpu", seconds, tiny)
    if patch is not None:
        patch(monkeypatch, r)
    r.window(seconds)
    if hasattr(r, "finish"):
        r.finish()
    r.release()
    gc.collect()
    v = check.Verdict(c.workload["limits"])
    r.check(v, precision)
    return v


CELLS = ["wiki1m.b512", "msmarco_shard.stream"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload, tiny, manifest):
    v = _run(workload, tiny, manifest, 31)
    assert v.correct, v.values
    ctl = _run(workload, tiny, manifest, 31, precision="tf32")
    assert not ctl.correct
    assert ctl.values["score_gap"] > v.limits["score_gap"]


def _half_batch(monkeypatch, r):
    from tfidf_tpu_torch.engine.engine import Engine
    real = Engine.search_batch

    def half(self, queries, k=None, unbounded=False):
        hits = real(self, queries, k=k, unbounded=unbounded)
        n = (len(hits) + 1) // 2
        return hits[:n] + [[] for _ in hits[n:]]
    monkeypatch.setattr(Engine, "search_batch", half)


def _altered_answer(monkeypatch, r):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.engine.searcher import SearchHit
    real = Engine.search_batch

    def altered(self, queries, k=None, unbounded=False):
        hits = real(self, queries, k=k, unbounded=unbounded)
        return [[SearchHit(h[0].name, h[0].score * 1.001)] + h[1:]
                if h else h for h in hits]
    monkeypatch.setattr(Engine, "search_batch", altered)


def _state_unchanged(monkeypatch, r):
    from tfidf_tpu_torch.engine.segments import SegmentedIndex

    def stale(self, vocab_cap):
        return self.snapshot
    monkeypatch.setattr(SegmentedIndex, "commit", stale)


@pytest.mark.parametrize("workload,fault", [
    ("wiki1m.b512", _half_batch), ("wiki1m.b512", _altered_answer),
    ("msmarco_shard.stream", _half_batch),
    ("msmarco_shard.stream", _altered_answer),
    ("msmarco_shard.stream", _state_unchanged)],
    ids=["b512-half", "b512-altered", "stream-half", "stream-altered",
         "stream-unchanged"])
def test_a_planted_fault_is_not_correct(workload, fault, tiny, manifest,
                                        monkeypatch):
    v = _run(workload, tiny, manifest, 37, fault, monkeypatch)
    assert not v.correct, v.values
