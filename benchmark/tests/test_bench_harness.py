"""The harness on the CPU: what a run loads, how cells are found, the
generators' determinism, the arithmetic of the metrics, and the
manifest against the benchmark's contract."""

import json
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from conftest import with_stream_cell
from harness import cell, corpus, registry, stats, trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def _manifest():
    with open(MANIFEST) as f:
        return json.load(f)


# ---- what a run loads ----

_LOADED = """
import sys, json
sys.path[:0] = [{bench!r}, {root!r}]
{body}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(body: str) -> set:
    code = _LOADED.format(bench=BENCH, root=ROOT, body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_nor_the_jax_package(tiny, manifest):
    body = f"""
from harness import cell, registry
for w in {[w["name"] for w in with_stream_cell()["workloads"]]!r}:
    c = registry.load(w, manifest={manifest!r})
    registry.load_loop(c.traffic["loop"])
import harness.cell as hc
rc = hc.run(["--workload", "wiki1m.b512", "--seed", "5", "--seconds",
             "0.5", "--trace", "1"], device="cpu", overrides={tiny!r})
assert rc == 0
rc = hc.run(["--workload", "msmarco_shard.stream", "--seed", "5",
             "--seconds", "1", "--trace", "1"], device="cpu",
            overrides={tiny!r}, manifest={manifest!r})
assert rc == 0
"""
    loaded = _top_level(body)
    assert "tfidf_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "tfidf_tpu"}


def test_the_reference_loads_nothing_of_the_system():
    loaded = _top_level("import reference.bm25")
    assert not loaded & {"jax", "jaxlib", "flax", "tfidf_tpu",
                         "tfidf_tpu_torch", "torch"}


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "tfidf_tpu_torch_x", types.ModuleType(
        "tfidf_tpu_torch_x"))
    assert "tfidf_tpu" not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tfidf_tpu.fake",
                        types.ModuleType("tfidf_tpu.fake"))
    assert "tfidf_tpu" in cell.forbidden_modules()


def test_a_run_without_a_card_exits_nonzero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    rc = cell.run(["--workload", "wiki1m.b512", "--seed", "1", "--seconds",
                   "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


# ---- cells found by name ----

def test_every_cell_of_the_manifest_has_its_files(manifest):
    m = with_stream_cell()
    for w in m["workloads"]:
        c = registry.load(w["name"], manifest=manifest)
        assert c.chips == w["chips"]
        assert callable(registry.load_loop(c.traffic["loop"], c.root).Run)
        assert set(c.readers) == {p["name"] for p in c.per_layer}
        assert c.end_to_end and c.per_layer


def test_an_added_workload_file_runs_without_editing_a_file(tmp_path, tiny,
                                                            capsys):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: (tmp_path / "benchmark" / p).read_bytes()
              for p in ("harness/cell.py", "loops/closed_batch.py",
                        "harness/registry.py")}
    m = _manifest()
    (tmp_path / "benchmark" / "traffic" / "b128.json").write_text(
        json.dumps(dict(json.loads((tmp_path / "benchmark" / "traffic" /
                                    "b512.json").read_text()),
                        batch=128, terms_min=3, terms_max=6)))
    (tmp_path / "benchmark" / "workloads" / "wiki1m.b128.json").write_text(
        (tmp_path / "benchmark" / "workloads" / "wiki1m.b512.json")
        .read_text())
    (tmp_path / "benchmark" / "metrics" / "calls.per_s.py").write_text(
        "def read(ctx):\n    return len(ctx['runs']) / ctx['seconds']\n")
    m["workloads"].append({"name": "wiki1m.b128", "config": "wiki1m",
                           "traffic": "b128", "chips": 1, "why": "test"})
    m["end_to_end"][0]["workloads"].append("wiki1m.b128")
    m["per_layer"].append({"name": "calls.per_s", "unit": "1/s",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "qps",
                           "workloads": ["wiki1m.b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    root = str(tmp_path / "benchmark")
    manifest = str(tmp_path / "BENCHMARK.json")
    tiny["traffic"].pop("batch")
    for tr in ("0", "1"):
        rc = cell.run(["--workload", "wiki1m.b128", "--seed", "9",
                       "--seconds", "0.5", "--trace", tr], device="cpu",
                      overrides=tiny, root=root, manifest=manifest)
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True
        assert list(line)[-1] == "compared"
        if tr == "0":
            assert set(line["metrics"]) == {"qps", "setup_s"}
        else:
            assert line["metrics"]["calls.per_s"]["value"] > 0
    for p, b in before.items():
        assert (tmp_path / "benchmark" / p).read_bytes() == b


# a traffic loop of its own: one caller at a time, and the calls it made
# counted in the context its metrics read
_ONE_CALLER = """
import os

from harness import registry

_closed = registry.load_loop(
    "closed_batch", os.path.dirname(os.path.dirname(__file__)))


class Run(_closed.Run):
    def __init__(self, cell, seed, device, seconds, overrides=None):
        super().__init__(cell, seed, device, seconds, overrides)
        self.tr = dict(self.tr, callers=1)

    def context(self):
        return dict(super().context(), loop_calls=len(self.calls))
"""


def test_an_added_loop_file_runs_without_editing_a_file(tmp_path, tiny,
                                                        capsys):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = tmp_path / "benchmark"
    (bench / "loops" / "one_caller.py").write_text(_ONE_CALLER)
    (bench / "traffic" / "one.json").write_text(json.dumps(dict(
        json.loads((bench / "traffic" / "b512.json").read_text()),
        loop="one_caller")))
    (bench / "workloads" / "wiki1m.one.json").write_text(
        (bench / "workloads" / "wiki1m.b512.json").read_text())
    (bench / "metrics" / "loop.calls.py").write_text(
        "def read(ctx):\n    return ctx.get('loop_calls')\n")
    m = _manifest()
    m["workloads"].append({"name": "wiki1m.one", "config": "wiki1m",
                           "traffic": "one", "chips": 1, "why": "test"})
    m["end_to_end"][0]["workloads"].append("wiki1m.one")
    m["per_layer"].append({"name": "loop.calls", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "test", "moves": "qps",
                           "workloads": ["wiki1m.one"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    root, manifest = str(bench), str(tmp_path / "BENCHMARK.json")
    c = registry.load("wiki1m.one", root, manifest)
    r = cell.make_run(c, 9, "cpu", 0.5, tiny)
    assert type(r).__module__ == "bench_loops_one_caller"
    assert r.tr["callers"] == 1
    r.release()
    for tr in ("0", "1"):
        rc = cell.run(["--workload", "wiki1m.one", "--seed", "9",
                       "--seconds", "0.5", "--trace", tr], device="cpu",
                      overrides=tiny, root=root, manifest=manifest)
        assert rc == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True
        if tr == "0":
            assert line["metrics"]["qps"]["value"] > 0
        else:
            assert line["metrics"]["loop.calls"]["value"] > 0
    for p, b in before.items():
        assert (tmp_path / p).read_bytes() == b


def test_an_unknown_loop_is_refused_by_name():
    with pytest.raises(FileNotFoundError):
        registry.load_loop("no_such_loop")


# ---- the generators ----

@pytest.mark.parametrize("draw", ["doc_arrays", "token_seqs",
                                  "query_terms"])
def test_each_generator_draws_the_same_data_for_the_same_seed(draw):
    args = {"doc_arrays": (500, 3000, 40.0, 5, 1.25),
            "token_seqs": (300, 3000, 30.0, 5, 1.25),
            "query_terms": (200, 3000, 2, 4, 1.25)}[draw]

    def once(seed):
        g = corpus.generator(seed, "cpu")
        return getattr(corpus, draw)(g, *args, "cpu")

    a, b, c = once(2 ** 33 + 7), once(2 ** 33 + 7), once(2 ** 33 + 8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(x.shape != z.shape or not np.array_equal(x, z)
               for x, z in zip(a, c))


def test_zipf_draw_has_numpys_distribution():
    n = 400_000
    ours = corpus.zipf(corpus.generator(3, "cpu"), n, 1.25, "cpu").numpy()
    ref = np.random.default_rng(3).zipf(1.25, n)
    assert ours.min() >= 1
    for k in (1, 2, 3, 10):
        assert abs((ours == k).mean() - (ref == k).mean()) < 4e-3
    assert abs(np.log(ours).mean() - np.log(ref).mean()) < 0.05


def test_doc_arrays_hold_each_docs_distinct_sorted_terms():
    off, ids, tfs, lens = corpus.doc_arrays(corpus.generator(1, "cpu"),
                                            200, 1000, 30.0, 5, 1.25, "cpu")
    assert off[0] == 0 and off[-1] == ids.shape[0]
    for i in range(200):
        row = ids[off[i]:off[i + 1]]
        assert (np.diff(row) > 0).all()
        assert tfs[off[i]:off[i + 1]].sum() == lens[i] >= 5


def test_texts_and_the_present_vocabulary():
    tok = corpus.Tokens(50)
    assert tok.texts(np.array([0, 2, 3]), np.array([4, 7, 4])) == \
        ["t4 t7", "t4"]
    ids, present = corpus.remap_present(np.array([3, 9, 3, 40]), 50)
    np.testing.assert_array_equal(present, [3, 9, 40])
    np.testing.assert_array_equal(ids, [0, 1, 0, 2])


# ---- the arithmetic ----

def test_rates_tails_and_spreads():
    assert stats.rate(600, 30.0) == 20.0
    v = list(range(1, 101))
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.median([3, 1, 2]) == 2
    assert stats.spread([10, 10, 10, 10]) == 0.0
    assert stats.spread([9, 10, 11, 10]) == pytest.approx(0.15)
    assert stats.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert stats.least_seconds(0, 33.5e12) == pytest.approx(1.0)


class _Ev:
    def __init__(self, name, s, t, act="kernel", dev="DeviceType.CUDA"):
        self._n, self._s, self._t, self._a, self._d = name, s, t, act, dev

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._s * 1e9)

    def end_ns(self):
        return int(self._t * 1e9)

    def activity_type(self):
        return self._a

    def device_type(self):
        return self._d


def test_idle_share_of_a_synthetic_timeline():
    ev = [_Ev("k1(a)", 100.0, 100.2), _Ev("k2(b)", 100.1, 100.3),
          _Ev("Memcpy HtoD (Pageable -> Device)", 100.5, 100.6,
              "gpu_memcpy"),
          _Ev("score", 100.0, 100.9, "gpu_user_annotation"),
          _Ev("aten::topk", 100.0, 100.1, "cpu_op", "DeviceType.CPU"),
          _Ev("k3(c)", 99.0, 100.05)]
    r = trace.Reduced(ev, 100.0, 101.0,
                      [(100.25, 100.55, "bench.search")])
    # k3 cut at the window's start; the annotation is not work
    assert r.busy_s == pytest.approx(0.4)
    assert r.window_s == pytest.approx(1.0)
    assert r.device_time(r"^k") == pytest.approx(0.45)
    gaps = r.top_gaps()
    assert gaps[0][0] == "no bench range"
    assert gaps[0][1] == pytest.approx(0.4)
    assert gaps[1] == ["bench.search", pytest.approx(0.2)]
    ctx = {"trace": r}
    idle = registry.load_reader("device.idle_pct.batch").read(ctx)
    assert idle == pytest.approx(60.0)


def test_both_rooflines_from_shapes_and_data():
    df = np.array([100.0, 10.0, 0.0, 1000.0])
    pool = [[np.array([0, 1]), np.array([3])], [np.array([1])]]
    tr = types.SimpleNamespace(busy_s=2.0,
                               device_time=lambda pattern: 1e-3)
    ctx = {"trace": tr, "pool": pool, "runs": [0, 0, 1], "batch": 2,
           "k": 10, "df": df,
           "counters": ({"ell_kernel_launches_v4": 4},
                        {"ell_kernel_launches_v4": 7}),
           "ell": {"blocks": [{"width": 8, "rows_cap": 512, "rows": 300},
                              {"width": 4, "rows_cap": 64, "rows": 60}],
                   "df": [df, np.ones(4)], "vocab_cap": 8, "u_cap": 256}}
    # search: batch 0 reads 1110 postings and writes 2 x 10 hits, 1110
    # multiply-adds; batch 1 reads 10 postings, 10 multiply-adds
    want = (2 * stats.least_seconds(8 * 1110 + 8 * 2 * 10, 1110)
            + stats.least_seconds(8 * 10 + 8 * 2 * 10, 10))
    got = registry.load_reader("search.roofline_pct").read(ctx)
    assert got == pytest.approx(100 * want / 2.0)
    # ELL: only the first block is in the kernel's envelope
    fixed = 8 * 8 * 300 + 4 * 2 * 300 + 4 * 8
    want = (2 * stats.least_seconds(fixed + 4 * 4 * 2, 1110)
            + stats.least_seconds(fixed + 4 * 2 * 2, 10))
    got = registry.load_reader("ell.roofline_pct").read(ctx)
    assert got == pytest.approx(100 * want / 1e-3)
    # a launch count that does not match the shapes reads nothing
    ctx["counters"] = ({}, {"ell_kernel_launches_v4": 4})
    assert registry.load_reader("ell.roofline_pct").read(ctx) is None


def test_counter_readers_take_window_deltas():
    c0 = {"query_items": 10, "query_batches": 5, "query_linger_count": 10,
          "query_linger_sum_ms": 20.0, "merges_inline": 1}
    c1 = {"query_items": 110, "query_batches": 25, "query_linger_count": 110,
          "query_linger_sum_ms": 520.0, "merges_inline": 2,
          "merges_background": 3}
    ctx = {"counters": (c0, c1),
           "clocks": {"commit_ms": [5.0, 1.0, 9.0], "request_ms": [2.0]}}
    read = {n: registry.load_reader(n).read(ctx) for n in (
        "batcher.items_per_batch", "batcher.linger_ms", "segments.merges",
        "segments.commit_ms", "ingest.request_ms")}
    assert read == {"batcher.items_per_batch": 5.0, "batcher.linger_ms": 5.0,
                    "segments.merges": 4.0, "segments.commit_ms": 5.0,
                    "ingest.request_ms": 2.0}


# ---- the manifest against the contract ----

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
_UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("m", [_manifest(), with_stream_cell()],
                         ids=["benchmark", "with-stream-cell"])
def test_the_manifest_keeps_to_the_contract(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51
    assert all(os.path.isdir(os.path.join(ROOT, p)) for p in m["paths"])
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _NAME.match(c["name"]) and len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == \
            c["source"]
        assert all(k in cfg for k in c["reduced"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert _NAME.match(w["name"]) and _NAME.match(w["traffic"])
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for x in m["end_to_end"] + m["per_layer"]:
        assert _NAME.match(x["name"]) and _UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert x["name"] not in names
        names.add(x["name"])
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
        assert x["source"] in ("host_clock", "device_trace")
    layers = {}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in x["workloads"]:
            moved = e2e[x["moves"]]
            assert "workloads" not in moved or w in moved["workloads"]
        layers.setdefault(x["layer"], []).append(x["name"])
    for w in m["workloads"]:
        assert any(registry.applies(x, w["name"]) for x in m["per_layer"])
        assert sum(registry.applies(x, w["name"])
                   for x in m["end_to_end"]) >= 2
    assert len(json.dumps(m)) < 64 * 1024
