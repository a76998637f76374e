"""The port's bench (``tfidf_tpu_torch/bench.py``) against the root
``bench.py`` of the JAX package.

The root ``bench.py`` is imported by path and only read: its corpus and
query generators must give the same bytes as the port's for a seed (the
same draws from the same rng, so ``python -m tfidf_tpu_torch bench`` and
``python bench.py`` build the same corpora for seed 0, and
``chip_smoke.py`` phase 3's corpus is the one it always was). Each
in-process config then runs at a tiny size on the CPU in both packages:
the port's passes its oracle gate where the JAX config has one, and its
result carries the JAX function's keys (the cluster configs' keys are
read from ``bench.py``'s source; only keys that named the TPU name the
card). A wrong engine is refused before any artifact is written, the
artifact round-trips, a kernel build inside a steady-state window fails
the run, and one tiny ``bench_cluster`` runs as ``python -m
tfidf_tpu_torch`` processes on the CPU.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tfidf_tpu_torch import bench as B
from tfidf_tpu_torch import kernels

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# keys that named the TPU in bench.py and name the card in the port
RENAMES = {"upload_dps_tpu": "upload_dps_gpu", "tpu_share": "gpu_share",
           "config2_tpu_worker": "config2_gpu_worker",
           "c2t_qps": "c2g_qps",
           "c2t_direct_worker_qps": "c2g_direct_worker_qps"}

# the tiny sizes of each in-process config: the port's keyword arguments
# and the JAX bench's module constants they stand for
TINY = {
    "north_star": (dict(n_docs=3000, vocab=5000, batch=64, batches=2,
                        cpu_batch=16, cpu_batches=2),
                   dict(NS_DOCS=3000, NS_VOCAB=5000, NS_BATCH=64,
                        NS_BATCHES=2, NS_CPU_BATCH=16, NS_CPU_BATCHES=2)),
    "config1": (dict(n_docs=500, vocab=3000, avg_len=40, batch=64,
                     batches=2),
                dict(C1_DOCS=500, C1_VOCAB=3000, C1_AVG_LEN=40,
                     C1_BATCH=64, C1_BATCHES=2)),
    "streaming": (dict(n_docs=3000, vocab=5000, avg_len=40,
                       commit_every=500),
                  dict(ST_DOCS=3000, NS_VOCAB=5000, ST_AVG_LEN=40,
                       ST_COMMIT_EVERY=500)),
    "mesh": (dict(n_docs=2000, vocab=5000, batch=64, batches=2),
             dict(MESH_DOCS=2000, NS_VOCAB=5000, MESH_BATCH=64,
                  MESH_BATCHES=2)),
    "5m_vocab": (dict(n_docs=2000, vocab=50_000, avg_len=40, batch=64),
                 dict(C5_DOCS=2000, C5_VOCAB=50_000, C5_AVG_LEN=40,
                      C5_BATCH=64)),
    "realistic": (dict(n_docs=1000, avg_len=40, batch=64, batches=2,
                       parity_queries=16),
                  dict(RT_DOCS=1000, RT_AVG_LEN=40, RT_BATCH=64,
                       RT_BATCHES=2, RT_PARITY_QUERIES=16)),
}
FUNCS = {"north_star": "bench_north_star", "config1": "bench_config1",
         "streaming": "bench_streaming", "mesh": "bench_mesh",
         "5m_vocab": "bench_5m_vocab", "realistic": "bench_realistic"}
# result values both packages must agree on for the same seed and sizes
SAME = {"north_star": ("nnz", "parity_checked"),
        "streaming": ("n_docs",),
        "mesh": ("n_docs", "parity_checked"),
        "5m_vocab": ("n_docs", "vocab"),
        "realistic": ("n_docs", "kinds", "binary_rejected_415",
                      "lexicon_words", "native_fast_path_rate",
                      "parity_checked")}


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py as a module, imported by path; its import-time
    environment defaults (a JAX compile cache in the repo) are undone."""
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    os.environ.clear()
    os.environ.update(env)
    return mod


@pytest.fixture(scope="module")
def lexicon():
    from tfidf_tpu_torch.utils.textgen import harvest_lexicon
    return harvest_lexicon(max_words=5000)


@pytest.fixture
def small_lexicon(monkeypatch, lexicon):
    """Both packages' ``harvest_lexicon`` return one small harvest (the
    bench calls it with its 30,000-word default)."""
    from tfidf_tpu.utils import textgen as jt
    from tfidf_tpu_torch.utils import textgen as pt
    for mod in (jt, pt):
        monkeypatch.setattr(mod, "harvest_lexicon",
                            lambda *a, **k: lexicon)
    return lexicon


# --------------------------------------------------------------------------
# the generators: byte-equal to bench.py's
# --------------------------------------------------------------------------

def _same_arrays(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and x.tobytes() == y.tobytes() for x, y in zip(a, b))


@pytest.mark.parametrize("n_docs,vocab,avg_len", [
    (20_000, 500_000, 120),     # chip_smoke phase 3's shape, cut
    (5_000, 5_000_000, 120),    # config 5's vocabulary
    (3_000, 5_000, 40)])
def test_doc_arrays_byte_equal(jax_bench, n_docs, vocab, avg_len):
    got = B.make_doc_arrays(np.random.default_rng(7), n_docs, vocab,
                            avg_len)
    want = jax_bench.make_doc_arrays(np.random.default_rng(7), n_docs,
                                     vocab, avg_len)
    assert _same_arrays(got, want)


def test_chip_smoke_draws_the_bench_corpus(jax_bench):
    """chip_smoke.py takes the port's generators: phase 3's corpus and
    queries are bench.py's, byte for byte, and the rng ends in the same
    state."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    assert cs.make_doc_arrays is B.make_doc_arrays
    assert cs.make_queries is B.make_queries
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    assert _same_arrays(cs.make_doc_arrays(r1, 20_000, cs.NS_VOCAB,
                                           cs.NS_AVG_LEN),
                        jax_bench.make_doc_arrays(r2, 20_000, cs.NS_VOCAB,
                                                  cs.NS_AVG_LEN))
    assert cs.make_queries(r1, cs.NS_VOCAB, 512) == \
        jax_bench.make_queries(r2, cs.NS_VOCAB, 512)
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


def test_texts_and_queries_byte_equal(jax_bench):
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    assert B.make_texts(r1, 400, 3000, 40) == \
        jax_bench.make_texts(r2, 400, 3000, 40)
    assert B.make_queries(r1, 200_000, 1000) == \
        jax_bench.make_queries(r2, 200_000, 1000)
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


# --------------------------------------------------------------------------
# the in-process configs: gates pass on the CPU, keys are the JAX ones
# --------------------------------------------------------------------------

@pytest.mark.timeout(240)
@pytest.mark.parametrize("config", sorted(TINY))
def test_config_matches_the_jax_bench(jax_bench, small_lexicon,
                                      monkeypatch, config):
    kw, consts = TINY[config]
    got = getattr(B, FUNCS[config])(np.random.default_rng(0),
                                    device="cpu", **kw)
    for name, value in consts.items():
        monkeypatch.setattr(jax_bench, name, value)
    want = getattr(jax_bench, FUNCS[config])(np.random.default_rng(0))
    assert set(got) == set(want)
    for key in SAME.get(config, ()):
        assert got[key] == want[key], key
    if "parity_checked" in want:
        assert got["parity_checked"] is True


def _own_nodes(fn):
    """The nodes of ``fn``'s body outside its nested functions."""
    todo = list(fn.body)
    while todo:
        node = todo.pop()
        yield node
        todo.extend(c for c in ast.iter_child_nodes(node)
                    if not isinstance(c, (ast.FunctionDef, ast.Lambda)))


def _return_keys(path, func):
    """The keys of the dict literal ``func`` returns in ``path``."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    rets = [n.value for n in _own_nodes(fn)
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    assert len(rets) == 1, func
    return {k.value for k in rets[0].keys}


def _dict_keys(path, func, name):
    """The literal keys of the dict assigned to ``name`` in ``func`` and
    of every dict literal nested in it."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    node = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets))
    return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)}


@pytest.mark.parametrize("jax_func,port_func", [
    ("bench_cluster", "bench_cluster"),
    ("bench_cluster_tpu", "bench_cluster_gpu")])
def test_cluster_result_keys_are_the_jax_bench_s(jax_func, port_func):
    want = {RENAMES.get(k, k)
            for k in _return_keys(os.path.join(ROOT, "bench.py"), jax_func)}
    assert _return_keys(B.__file__, port_func) == want


@pytest.mark.parametrize("name,added", [
    ("result", {"device", "lexicon", "wall_s"}), ("headline", set())])
def test_artifact_schema_is_the_jax_bench_s(name, added):
    want = {RENAMES.get(k, k)
            for k in _dict_keys(os.path.join(ROOT, "bench.py"), "main",
                                name)}
    assert _dict_keys(B.__file__, "main", name) == want | added


# --------------------------------------------------------------------------
# gates: a wrong engine is refused before any artifact exists
# --------------------------------------------------------------------------

_WRONG_ENGINE = r"""
import os, sys
import numpy as np
from tfidf_tpu_torch import bench as B
from tfidf_tpu_torch.engine.engine import Engine
from tfidf_tpu_torch.engine.searcher import SearchHit
real = Engine.search_batch
def perturbed(self, queries, k=None, unbounded=False):
    return [[SearchHit(h.name, h.score * 1.01) for h in hits]
            for hits in real(self, queries, k=k, unbounded=unbounded)]
Engine.search_batch = perturbed
ns = B.bench_north_star(np.random.default_rng(0), n_docs=2000, vocab=3000,
                        batch=32, batches=2, cpu_batch=16, device="cpu")
B._emit_validated({"metric": "m", "value": ns["qps"], "unit": "q/s",
                   "vs_baseline": 1.0})
"""


@pytest.mark.timeout(120)
def test_wrong_engine_exits_nonzero_with_no_artifact(tmp_path):
    out = tmp_path / "BENCH_DETAIL.json"
    env = dict(os.environ, BENCH_OUT=str(out), OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", _WRONG_ENGINE], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=110)
    assert r.returncode != 0
    assert "top-k mismatch" in r.stderr, r.stderr[-2000:]
    assert not out.exists()
    assert '"metric"' not in r.stdout


@pytest.mark.timeout(120)
@pytest.mark.parametrize("config", ["mesh", "realistic"])
def test_wrong_engine_fails_the_gate(small_lexicon, monkeypatch, config):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.engine.searcher import SearchHit
    real = Engine.search_batch

    def perturbed(self, queries, k=None, unbounded=False):
        return [[SearchHit(h.name, h.score * 1.01) for h in hits]
                for hits in real(self, queries, k=k, unbounded=unbounded)]

    monkeypatch.setattr(Engine, "search_batch", perturbed)
    with pytest.raises(AssertionError):
        getattr(B, FUNCS[config])(np.random.default_rng(0), device="cpu",
                                  **TINY[config][0])


# --------------------------------------------------------------------------
# emission and the measured window
# --------------------------------------------------------------------------

def test_emit_validated_round_trips(tmp_path, monkeypatch, capsys):
    out = tmp_path / "deep" / "BENCH_DETAIL.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    result = {"metric": "m", "value": 12.5, "unit": "q/s",
              "vs_baseline": 3.0, "extra": {"a": {"parity_checked": True}}}
    B._emit_validated(result, {"north_star_qps": 12.5})
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert head == {"metric": "m", "value": 12.5, "unit": "q/s",
                    "vs_baseline": 3.0, "detail_file": "BENCH_DETAIL.json",
                    "headline": {"north_star_qps": 12.5}}
    art = json.loads(out.read_text())
    assert art == result
    assert art["kernel_builds_during_measurement"] == 0


@pytest.mark.parametrize("bad", [
    {"value": 1.0, "unit": "q/s", "vs_baseline": 1.0},
    {"metric": "m", "unit": "q/s", "vs_baseline": 1.0},
    {"metric": "m", "value": 1.0, "vs_baseline": 1.0},
    {"metric": "m", "value": 1.0, "unit": "q/s"},
    {"metric": "m", "value": "fast", "unit": "q/s", "vs_baseline": 1.0}])
def test_emit_validated_exits_1_on_a_bad_result(tmp_path, monkeypatch,
                                                capsys, bad):
    out = tmp_path / "BENCH_DETAIL.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    with pytest.raises(SystemExit) as e:
        B._emit_validated(dict(bad))
    assert e.value.code == 1
    assert "SELF-VALIDATION FAILED" in capsys.readouterr().err
    assert not out.exists()


def test_default_artifact_lands_in_build(tmp_path, monkeypatch):
    monkeypatch.delenv("BENCH_OUT", raising=False)
    written = {}

    def fake_open(path, mode="r", **kw):
        written.setdefault("path", path)
        raise OSError("not written in this test")

    monkeypatch.setattr("builtins.open", fake_open)
    monkeypatch.setattr(B.os, "makedirs", lambda *a, **k: None)
    with pytest.raises(OSError):
        B._emit_validated({"metric": "m", "value": 1.0, "unit": "u",
                           "vs_baseline": 1.0})
    assert written["path"] == os.path.join(ROOT, "build", "bench",
                                           "BENCH_DETAIL.json")


@pytest.mark.parametrize("steady", [True, False])
def test_kernel_build_inside_a_window(monkeypatch, capsys, steady):
    """A kernel build inside a steady-state window exits 1; inside any
    other window it is counted into the artifact's stamp."""
    monkeypatch.setitem(B._WINDOW_BUILDS, "n", 0)
    monkeypatch.setattr(kernels, "_builds", [5])

    def run():
        with B._measured_window("w", steady_state=steady):
            kernels._builds[0] += 1

    if steady:
        with pytest.raises(SystemExit) as e:
            run()
        assert e.value.code == 1
        assert "kernel build(s) inside steady-state" in \
            capsys.readouterr().err
    else:
        run()
        assert B._WINDOW_BUILDS["n"] == 1
    with B._measured_window("quiet", steady_state=True):
        pass


# --------------------------------------------------------------------------
# config 2 as processes
# --------------------------------------------------------------------------

@pytest.mark.timeout(240)
def test_bench_cluster_as_port_processes(monkeypatch):
    """A coordinator, a leader and two workers as ``python -m
    tfidf_tpu_torch`` processes on the CPU (one host thread each, small
    capacities), 1,000 documents uploaded over HTTP, queries through the
    leader; every process is killed at the end."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    for k, v in {"MIN_DOC_CAPACITY": 64, "MIN_NNZ_CAPACITY": 4096,
                 "MIN_VOCAB_CAPACITY": 1024}.items():
        monkeypatch.setenv(f"TFIDF_{k}", str(v))
    spawned = []
    real = subprocess.Popen

    def popen(*a, **k):
        p = real(*a, **k)
        spawned.append((p, k["env"]))
        return p

    monkeypatch.setattr(subprocess, "Popen", popen)
    res = B.bench_cluster(np.random.default_rng(0), n_docs=1000,
                          vocab=3000, avg_len=30, n_queries=32, clients=4,
                          device="cpu")
    assert set(res) == _return_keys(B.__file__, "bench_cluster")
    assert res["qps"] > 0 and res["upload_dps"] > 0 and res["n_docs"] == 1000
    assert res["backend"].startswith("leader cpu, workers cpu + cpu")
    assert len(spawned) == 4
    for p, env in spawned:
        assert p.poll() is not None
        assert env["TFIDF_DEVICE"] == "cpu"
