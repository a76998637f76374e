"""The root ``bench.py``'s other modes in the port
(``tfidf_tpu_torch/bench_modes.py``) against the JAX bench.

The root ``bench.py`` (and ``kernel_parity.py``) are imported by path and
only read. The generators of every mode give the same bytes for a seed in
both packages, and every module constant is the JAX one. The in-process
modes (compute, kernel, hybrid) run at a tiny size on the CPU in both
packages: the port's gates hold, its results carry the JAX function's
keys (the added ones listed below; only keys that named the TPU or its
compiler name the card), and the values both must agree on agree. A
wrong engine is refused before any artifact is written; each mode's
artifact lands under ``build/bench/`` by its name; the CLI takes a mode
flag and refuses without CUDA. The JAX Pallas case runs through its XLA
``_score_block`` (the JAX package's own reference). The tier mode has
its own file (``test_torch_bench_tier.py``), the fleet modes theirs.
"""

import ast
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from test_torch_bench import RENAMES
from tfidf_tpu_torch import bench as B
from tfidf_tpu_torch import bench_modes as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH = os.path.join(ROOT, "bench.py")

# keys that named the TPU's compiler or its reference path
MODE_RENAMES = {**RENAMES, "mosaic_compiled": "nvcc_compiled",
                "max_abs_delta_vs_xla": "max_abs_delta_vs_plain",
                "xla_ms": "plain_ms"}
# keys the port adds, with the reason: the card beside every number, the
# kernel's bound and library time, the lexicon that MRR depends on
ADDED_CASE = {"v4_plain_bitwise_equal", "library_ms",
              "library_max_abs_delta", "bytes", "ops", "bound_ms",
              "bound_by", "v4_share_of_bound"}
ADDED = {"kernel_main": {"device"}, "compute_main": {"device"},
         "hybrid_main": {"device"}, "tier_main": {"device"},
         "bench_hybrid": {"lexicon"}}
# the kernel headline leads with the card's measured ratio and bound
# share; the TPU op-count model stays in the artifact's extra only
KERNEL_HEADLINE_ADDED = {"v3_over_v4", "v4_ms", "v4_share_of_bound",
                         "library_ms"}
KERNEL_HEADLINE_DROPPED = {"cost_model_v4_packed_ratio",
                           "cost_model_v4_ratio"}

CONST_PREFIXES = ("OV_", "R10_", "RT7_", "KB_", "HY_", "TI_", "CP_",
                  "_HIST_")


@pytest.fixture(scope="module")
def jax_bench():
    env = dict(os.environ)
    spec = importlib.util.spec_from_file_location("jax_root_bench_modes",
                                                  JAX_BENCH)
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
    from tfidf_tpu.utils import textgen as jt
    from tfidf_tpu_torch.utils import textgen as pt
    for mod in (jt, pt):
        monkeypatch.setattr(mod, "harvest_lexicon",
                            lambda *a, **k: lexicon)
    return lexicon


def _xla_pallas(imp, term, uniq, n_uniq, qc_ext, n_rows=None, *,
                a_build="v4", vocab_cap):
    """``score_block_pallas`` through the JAX package's XLA reference
    ``_score_block`` (the Pallas interpreter is too slow at the case's
    shape on the CPU)."""
    import jax.numpy as jnp

    from tfidf_tpu.ops.ell import _score_block
    u_cap = uniq.shape[0]
    lane = jnp.arange(u_cap, dtype=jnp.int32)
    idx = jnp.where(lane < n_uniq, uniq, vocab_cap)
    slot_of = jnp.full((vocab_cap,), u_cap, jnp.int32).at[idx].set(
        lane, mode="drop")
    return _score_block(imp, term, slot_of, qc_ext.T, 2048)


# --------------------------------------------------------------------------
# constants and generators: the JAX bench's
# --------------------------------------------------------------------------

def _jax_constants():
    tree = ast.parse(open(JAX_BENCH, encoding="utf-8").read())
    return sorted(t.id for n in tree.body if isinstance(n, ast.Assign)
                  for t in n.targets if isinstance(t, ast.Name)
                  and t.id.startswith(CONST_PREFIXES))


@pytest.mark.parametrize("name", _jax_constants())
def test_mode_constants_are_the_jax_bench_s(jax_bench, name):
    assert getattr(M, name) == getattr(jax_bench, name)


def test_router_client_program_is_the_jax_bench_s(jax_bench):
    assert M._R7_CLIENT_SRC == jax_bench._R7_CLIENT_SRC


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("pool,n,s", [(2048, 4096, 1.1), (512, 4096, 1.1),
                                      (1024, 300, 1.3)])
def test_zipf_indices_byte_equal(jax_bench, pool, n, s):
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    assert _same(M._zipf_indices(r1, pool, n, s),
                 jax_bench._zipf_indices(r2, pool, n, s))
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


@pytest.mark.parametrize("phase", [0, 3, 17])
def test_tier_generators_byte_equal(jax_bench, phase):
    r1, r2 = np.random.default_rng(phase), np.random.default_rng(phase)
    got = M._tier_phase_corpus(r1, phase, 3000)
    want = jax_bench._tier_phase_corpus(r2, phase, 3000)
    for g, w in zip(got, want):
        assert all(_same(x, y) for x, y in zip(g, w))
    assert M._tier_queries(r1, phase) == jax_bench._tier_queries(r2, phase)
    assert r1.integers(1 << 62) == r2.integers(1 << 62)


@pytest.mark.parametrize("kw", [
    dict(rows_cap=2048, width=64, n_rows=1900, B=256, n_terms=4,
         u_req=512, vocab=30_000),
    dict(rows_cap=512, width=12, n_rows=300, B=64, n_terms=4, u_req=256,
         vocab=200_000, ragged=True)])
def test_make_case_byte_equal(kw):
    """The port's copy of ``kernel_parity.make_case``: the same block and
    the same query batch for a seed."""
    import kernel_parity
    r1, r2 = np.random.default_rng(11), np.random.default_rng(11)
    imp, term, qb = M.make_case(r1, device="cpu", **kw)
    jimp, jterm, jqb = kernel_parity.make_case(r2, **kw)
    assert _same(imp, jimp) and _same(term, jterm)
    assert qb.n_uniq == int(jqb.n_uniq)
    for name in ("uniq", "slots", "weights"):
        assert _same(getattr(qb, name).numpy(),
                     np.asarray(getattr(jqb, name))), name


@pytest.mark.parametrize("mode,docs,vocab,avg_len,pool", [
    ("overload", "OV_DOCS", "OV_VOCAB", "OV_AVG_LEN", "OV_QUERY_POOL"),
    ("replay", "R10_DOCS", "R10_VOCAB", "R10_AVG_LEN", "R10_QUERY_POOL"),
    ("routers", "RT7_DOCS", "RT7_VOCAB", "RT7_AVG_LEN",
     "RT7_QUERY_POOL")])
def test_fleet_streams_byte_equal(jax_bench, mode, docs, vocab, avg_len,
                                  pool):
    """Each fleet mode's corpus and query pool for seed 0 (its first
    draws), and its clients' query sequences: the same in both
    packages."""
    c = {k: getattr(M, v) for k, v in (("docs", docs), ("vocab", vocab),
                                       ("avg_len", avg_len),
                                       ("pool", pool))}
    r1, r2 = np.random.default_rng(B.SEED), np.random.default_rng(B.SEED)
    assert B.make_texts(r1, c["docs"], c["vocab"], c["avg_len"]) == \
        jax_bench.make_texts(r2, c["docs"], c["vocab"], c["avg_len"])
    assert B.make_queries(r1, c["vocab"], c["pool"]) == \
        jax_bench.make_queries(r2, c["vocab"], c["pool"])
    assert r1.integers(1 << 62) == r2.integers(1 << 62)
    seeds = {"overload": [B.SEED + 1000 * m + cid for m in (1, 2)
                         for cid in range(16)],
             "replay": [B.SEED + 977 * cid + lane + meas
                        for cid in range(8) for lane in (0, 1)
                        for meas in (0, 100)],
             "routers": [B.SEED + 1000 * r + c for r in (1, 2, 4)
                         for c in range(12)]}[mode]
    for seed in seeds:
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert _same(M._zipf_indices(a, c["pool"], 4096),
                     jax_bench._zipf_indices(b, c["pool"], 4096))
        assert a.random() == b.random()


# --------------------------------------------------------------------------
# the in-process modes in both packages
# --------------------------------------------------------------------------

def _renamed(keys):
    return {MODE_RENAMES.get(k, k) for k in keys}


@pytest.mark.timeout(240)
def test_compute_matches_the_jax_bench(jax_bench, monkeypatch):
    got = M.bench_compute(np.random.default_rng(0), n_docs=2000,
                          vocab=3000, n_queries=64, device="cpu")
    for name, value in {"CP_DOCS": 2000, "CP_VOCAB": 3000,
                        "CP_QUERIES": 64}.items():
        monkeypatch.setattr(jax_bench, name, value)
    want = jax_bench.bench_compute(np.random.default_rng(0))
    assert set(got) == _renamed(want)
    for key in ("docs", "vocab", "queries", "query_batch", "k", "reps",
                "parity"):
        assert got[key] == want[key], key
    assert got["healthy_qps"] > 0 and got["degraded_qps"] > 0
    assert got["backend"] == "cpu"


@pytest.mark.timeout(240)
def test_kernel_scoring_matches_the_jax_bench(jax_bench, monkeypatch):
    """The reference's two cases: v3 == v4 == plain bitwise and the top-k
    identical in the port; the JAX bench's gates hold on the same cases
    (its Pallas path through the XLA reference)."""
    got = M.bench_kernel_scoring(np.random.default_rng(0), reps=1,
                                 device="cpu")
    from tfidf_tpu.ops import ell as jell
    monkeypatch.setattr(jell, "score_block_pallas", _xla_pallas)
    want = jax_bench.bench_kernel_scoring(np.random.default_rng(0))
    assert set(got) == _renamed(want)
    assert got["nvcc_compiled"] is False and got["backend"] == "cpu"
    assert len(got["cases"]) == len(want["cases"]) == 2
    for g, w in zip(got["cases"], want["cases"]):
        assert set(g) == _renamed(w) | ADDED_CASE
        for key in ("rows_cap", "width", "n_rows", "B", "n_terms", "u_req",
                    "vocab", "packed", "v3_v4_bitwise_equal",
                    "topk_identical"):
            assert g[key] == w[key], key
        assert g["max_abs_delta_vs_plain"] == 0.0
        assert g["v4_plain_bitwise_equal"] is True
        assert g["library_max_abs_delta"] < 1e-4
        assert g["bound_by"] in ("bytes", "operations")
        # the bound is the larger of the bytes' and the operations' times
        assert g["bound_ms"] == pytest.approx(1e3 * max(
            g["bytes"] / M.HBM_BYTES_PER_S,
            g["ops"] / M.F32_UNFUSED_OPS_PER_S), rel=1e-12)
        assert g["bytes"] > 8 * g["width"] * g["n_rows"]


KB_TINY = dict(vocab=3000, batch_docs=300, commits=2)
KB_TINY_CONSTS = dict(KB_VOCAB=3000, KB_BATCH_DOCS=300, KB_COMMITS=2)


@pytest.mark.timeout(240)
def test_segment_commits_match_the_jax_bench(jax_bench, monkeypatch):
    got = M.bench_segment_commits(np.random.default_rng(0),
                                  sweep=(2000, 4000, 8000), device="cpu",
                                  **KB_TINY)
    for name, value in {**KB_TINY_CONSTS,
                        "KB_SEG_SWEEP": (2000, 4000, 8000)}.items():
        monkeypatch.setattr(jax_bench, name, value)
    want = jax_bench.bench_segment_commits(np.random.default_rng(0))
    assert set(got) == set(want)
    for label in ("incremental", "control"):
        assert set(got[label]) == set(want[label])
        for n, rec in got[label].items():
            assert rec["witness_delta"] == want[label][n]["witness_delta"]
    assert got["df_parity_exact"] is True and got["search_ok"] is True


def _subscript_keys(path, func):
    """The literal keys ``func`` assigns as ``out["key"] = ...``."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == func)
    return {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript)
            and isinstance(t.value, ast.Name) and t.value.id == "out"
            and isinstance(t.slice, ast.Constant)}


@pytest.mark.timeout(240)
def test_mesh_commits_hold_their_gates():
    """The mesh sweep on the CPU (one rank): the witnesses at zero, two
    rebuilds, the incremental df equal to a recompute, the serving gate;
    its keys are those the JAX function sets (read from its source: its
    CPU mesh of 8 virtual devices needs a sweep too large to run here)."""
    got = M.bench_mesh_commits(np.random.default_rng(0),
                               sweep=(2000, 4000, 8000), device="cpu",
                               **KB_TINY)
    want = (_subscript_keys(JAX_BENCH, "bench_mesh_commits")
            | {"sweep_docs", "batch_docs", "commits", "incremental",
               "control"}) - {"_engine"}
    assert set(got) == want
    assert all(r["witness_delta"] == 0
               for r in got["incremental"].values())
    assert all(r["witness_delta"] > 0 for r in got["control"].values())
    assert got["df_parity_exact"] and got["search_ok"]


@pytest.mark.timeout(240)
def test_hybrid_matches_the_jax_bench(jax_bench, small_lexicon,
                                      monkeypatch):
    kw = dict(n_docs=1000, avg_len=40, batch=64, batches=2, rel_queries=60)
    got = M.bench_hybrid(np.random.default_rng(0), device="cpu", **kw)
    for name, value in {"HY_DOCS": 1000, "HY_AVG_LEN": 40, "HY_BATCH": 64,
                        "HY_BATCHES": 2, "HY_REL_QUERIES": 60}.items():
        monkeypatch.setattr(jax_bench, name, value)
    want = jax_bench.bench_hybrid(np.random.default_rng(0))
    assert set(got) == _renamed(want) | ADDED["bench_hybrid"]
    for key in ("docs", "batch", "top_k", "relevance_queries"):
        assert got[key] == want[key], key
    assert got["embedding"]["dim"] == want["embedding"]["dim"] == 256
    assert got["embedding"]["docs"] == want["embedding"]["docs"]
    # the same passages, queries and fusion: the same relevance
    assert got["relevance"] == want["relevance"]
    assert got["lexicon"]["words"] == len(small_lexicon[0])


# --------------------------------------------------------------------------
# artifacts: the JAX schema, build/bench/<name>, nothing on a failed gate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("main", ["kernel_main", "compute_main",
                                  "hybrid_main", "tier_main",
                                  "overload_main", "replay_main",
                                  "routers_main"])
def test_mode_artifact_schema_is_the_jax_bench_s(main):
    from test_torch_bench import _dict_keys
    added = ADDED.get(main, set()) | {"device"}
    for name in ("result", "headline"):
        want = _renamed(_dict_keys(JAX_BENCH, main, name)) if (
            main != "replay_main") else _renamed(
                _dict_keys(JAX_BENCH, "bench_replay", name))
        got = (_dict_keys(M.__file__, main, name) if main != "replay_main"
               else _dict_keys(M.__file__, "bench_replay", name))
        if name == "headline" and main == "kernel_main":
            want = want - KERNEL_HEADLINE_DROPPED | KERNEL_HEADLINE_ADDED
        extra = added if name == "result" else set()
        if main == "replay_main" and name == "result":
            extra = {"device", "card_processes", "worker_kernel_launches"}
        assert got == want | extra, (main, name)


def test_mode_artifact_lands_in_build_bench(tmp_path, monkeypatch,
                                            capsys):
    """No BENCH_OUT: the artifact is ``build/bench/<name>`` beside the
    package (never the repository's root), and it round-trips."""
    import json
    monkeypatch.delenv("BENCH_OUT", raising=False)
    monkeypatch.setattr(B, "ROOT", str(tmp_path))
    name = "BENCH_r13.json"
    M.compute_main(device="cpu", n_docs=1000, vocab=2000, n_queries=64)
    path = tmp_path / "build" / "bench" / name
    art = json.loads(path.read_text())
    assert art["kernel_builds_during_measurement"] == 0
    assert art["device"]["nvidia_smi"] is None or "name" in art["device"]
    head = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert head["detail_file"] == name
    assert list(tmp_path.iterdir()) == [tmp_path / "build"]


def test_wrong_kernel_fails_the_gate_with_no_artifact(tmp_path,
                                                      monkeypatch):
    from tfidf_tpu_torch.ops import ell as E
    real = E.score_block_kernel

    def wrong(*a, **k):
        out = real(*a, **k)
        out.mul_(1.0 + 1e-6)
        return out

    monkeypatch.setattr(E, "score_block_kernel", wrong)
    out = tmp_path / "BENCH_r09.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    with pytest.raises(RuntimeError, match="bitwise failed"):
        M.kernel_main(device="cpu", reps=1,
                      vocabs=(30_000,))
    assert not out.exists()


def test_wrong_fallback_fails_the_gate_with_no_artifact(tmp_path,
                                                        monkeypatch,
                                                        capsys):
    from tfidf_tpu_torch.engine.compute_health import HostFallbackScorer
    real = HostFallbackScorer.search_arrays

    def wrong(self, queries, k=None):
        vals, ids, kk, names = real(self, queries, k=k)
        return vals * np.float32(1.0 + 1e-6), ids, kk, names

    monkeypatch.setattr(HostFallbackScorer, "search_arrays", wrong)
    out = tmp_path / "BENCH_r13.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    with pytest.raises(SystemExit) as e:
        M.compute_main(device="cpu", n_docs=1000,
                       vocab=2000, n_queries=64)
    assert e.value.code == 1
    assert "not bit-identical" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("grow,ok", [(2.4, True), (2.6, False)])
def test_mesh_flat_ratio_gate(tmp_path, monkeypatch, capsys, grow, ok):
    """The run's flatness gate: the incremental mesh commit may grow less
    than 2.5x over the 4x corpus sweep; past it the run stops before the
    artifact (the sweeps stubbed: their own gates have their tests)."""
    case = {"v3_over_v4": 1.01, "v4_ms": 2.0, "v4_share_of_bound": 0.4,
            "library_ms": 2.2}
    sweep = {"incremental": {"2000": {"commit_ms_p50": 10.0},
                             "8000": {"commit_ms_p50": 10.0 * grow}},
             "control": {"2000": {"commit_ms_p50": 11.0},
                         "8000": {"commit_ms_p50": 40.0}}}
    monkeypatch.setattr(M, "bench_kernel_scoring",
                        lambda rng, **kw: {"cases": [case]})
    monkeypatch.setattr(M, "bench_segment_commits", lambda rng, **kw: sweep)
    monkeypatch.setattr(M, "bench_mesh_commits", lambda rng, **kw: sweep)
    out = tmp_path / "BENCH_r09.json"
    monkeypatch.setenv("BENCH_OUT", str(out))

    def run():
        M.kernel_main(device="cpu", seg_sweep=(2000, 8000),
                      mesh_sweep=(2000, 8000))

    if ok:
        run()
        assert out.exists()
        assert '"v3_over_v4": 1.01' in capsys.readouterr().out
    else:
        with pytest.raises(RuntimeError, match="grew"):
            run()
        assert not out.exists()


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", M.MODES)
def test_cli_takes_each_mode(mode):
    from tfidf_tpu_torch.cli import build_parser
    assert build_parser().parse_args(["bench", f"--{mode}"]).mode == mode
    assert build_parser().parse_args(["bench"]).mode is None
    assert set(M.MAINS) == set(M.MODES)


def test_cli_refuses_two_modes():
    from tfidf_tpu_torch.cli import build_parser
    with pytest.raises(SystemExit):
        build_parser().parse_args(["bench", "--tier", "--kernel"])


@pytest.mark.parametrize("mode", M.MODES)
def test_dispatch_runs_the_named_mode(monkeypatch, mode):
    ran = []
    for m in M.MODES:
        monkeypatch.setitem(M.MAINS, m, lambda m=m: ran.append(m))
    monkeypatch.setattr(B, "main", lambda: ran.append("main"))
    B.run(["--x", f"--{mode}"])
    B.run([])
    assert ran == [mode, "main"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("argv", [["-m", "tfidf_tpu_torch", "bench",
                                   "--overload"],
                                  ["-m", "tfidf_tpu_torch.bench", "--tier"]])
def test_without_cuda_a_mode_refuses(tmp_path, argv):
    """Both entry points refuse without a card (no CPU number), and write
    no artifact."""
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_OUT=str(tmp_path / "a"),
               TFIDF_DEVICE="cpu")
    r = subprocess.run([sys.executable, *argv], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=110)
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("mode", ["compute", "hybrid", "tier", "overload",
                                  "routers", "replay"])
def test_a_mode_function_refuses_without_a_named_device(mode):
    fn = {"compute": M.bench_compute, "hybrid": M.bench_hybrid,
          "tier": M.bench_tier, "overload": M.bench_overload,
          "routers": M.bench_routers, "replay": M.bench_replay}[mode]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fn(np.random.default_rng(0))


@pytest.mark.parametrize("static", [True, False])
def test_overload_static_run_is_optional(tmp_path, monkeypatch, capsys,
                                         static):
    """``overload_main(static=False)`` boots the autopilot fleet alone
    (``chip_smoke.py`` phase 11's cut): one ``bench_overload`` call, the
    artifact's static run None; the default runs static, then autopilot.
    Phase 11 reads the fleet runs the artifact holds."""
    import json
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    calls = []

    def fake(rng, autopilot=False, corpus=None, *, device=None, **sizes):
        calls.append(autopilot)
        side = {"interactive": {"p99_ms": 1.0, "shed_rate": 0.0, "qps": 9.0},
                "cache_hit_rate": 0.5}
        return {"one_x": side, "two_x": side, "p99_ratio_2x_vs_1x": 1.0,
                "mode": "autopilot" if autopilot else "static"}

    monkeypatch.setattr(M, "bench_overload", fake)
    out = tmp_path / "OVERLOAD.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    M.overload_main(device="cpu", static=static, n_docs=20, vocab=200,
                    query_pool=16)
    assert calls == ([False, True] if static else [True])
    art = json.loads(out.read_text())
    assert (art["extra"]["static_hand_tuned"] is None) is not static
    runs = cs._fleet_runs("overload", art)
    assert [r["mode"] for r in runs] == (["autopilot", "static"] if static
                                         else ["autopilot"])
    assert cs.MODE_CUTS["overload"]["static"] is False


def test_routers_headline_without_the_four_router_phase(tmp_path,
                                                        monkeypatch):
    """``chip_smoke.py`` phase 11 runs ``--routers`` at 1 and 2 routers
    (``counts=(1, 2)``): the headline's 4-router numbers are None."""
    import json
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    seen = {}

    def fake(rng, *, device=None, **sizes):
        seen.update(sizes)
        row = {"admitted_qps": 10.0, "p99_ms": 1.0, "cache_hit_rate": 0.5}
        return {"routers": {str(c): row for c in sizes["counts"]},
                "scaling_2r_vs_1r": 1.0, "scaling_4r_vs_1r": None}

    monkeypatch.setattr(M, "bench_routers", fake)
    out = tmp_path / "BENCH_r07.json"
    monkeypatch.setenv("BENCH_OUT", str(out))
    M.routers_main(device="cpu", **cs.MODE_CUTS["routers"])
    assert seen["counts"] == (1, 2)
    art = json.loads(out.read_text())
    assert art["extra"]["scaling_4r_vs_1r"] is None
    assert set(art["extra"]["routers"]) == {"1", "2"}


@pytest.mark.parametrize("collector", [True, False])
def test_client_stalls_records_collections_and_ticker(collector):
    """A client window appends one record to ``CLIENT_STALLS``: a full
    collection inside it counts as one generation-2 pause when the
    collector is on (``gc.collect`` runs even when it is off, so the
    record says which), and the ticker's lateness covers the window."""
    import gc
    import time
    n0 = len(M.CLIENT_STALLS)
    was = gc.isenabled()
    if not collector:
        gc.disable()
    try:
        with M._ClientStalls("w") as stalls:
            time.sleep(0.05)
            gc.collect()
            time.sleep(0.05)
    finally:
        if was:
            gc.enable()
    (rec,) = M.CLIENT_STALLS[n0:]
    assert rec["window"] == "w" and rec["gc_enabled"] is collector
    assert rec["gc_collections"]["gen2"] >= 1
    assert 0.0 < rec["gc_pause_ms_max"] <= rec["gc_pause_ms_sum"]
    assert rec["ticks"] >= 5
    assert 0.0 <= rec["tick_late_ms_p99"] <= rec["tick_late_ms_max"]
    assert stalls._on_gc not in gc.callbacks


def test_heap_stalls_reads_the_heap():
    """``chip_smoke.heap_stalls``: the tracked objects and two timed full
    collections, as phase 11 records them before the modes."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    heap = cs.heap_stalls()
    assert heap["tracked_objects"] > 1000
    assert len(heap["full_collection_ms"]) == 2
    assert all(ms > 0.0 for ms in heap["full_collection_ms"])


def test_stall_probe_records_each_run_and_restores_the_collector(
        monkeypatch):
    """``probe_client_stalls.overload_run``: a fleet's windows and its
    cross-check, with the collector as asked inside the run and enabled
    after it; the live-histogram disagreement is recorded as the run's
    outcome, and any other failure propagates."""
    import gc
    sys.path.insert(0, ROOT)
    try:
        import probe_client_stalls as P
    finally:
        sys.path.remove(ROOT)
    seen = []

    def fake(rng, autopilot=False, corpus=None, **sizes):
        seen.append((autopilot, gc.isenabled(), sizes))
        with M._ClientStalls("1x"):
            pass
        if sizes["n_docs"] == 1:
            raise RuntimeError("[ov] live histogram quantiles disagree "
                               "with the bench's measured distribution")
        if sizes["n_docs"] == 2:
            raise RuntimeError("[ov] phase 1x client failures")
        return {"live_histogram_check": {"p99": {"ok": True}}}

    monkeypatch.setattr(M, "bench_overload", fake)
    on = P.overload_run(None, None, {"n_docs": 0}, True)
    off = P.overload_run(None, None, {"n_docs": 1}, False)
    assert [s[:2] for s in seen] == [(True, True), (True, False)]
    assert gc.isenabled()
    assert on["check"] == {"p99": {"ok": True}} and on["gc"] is True
    assert "disagree" in off["check"]["disagreed"] and off["gc"] is False
    assert [w["window"] for w in on["windows"]] == ["1x"]
    assert off["windows"][0]["gc_enabled"] is False
    with pytest.raises(RuntimeError, match="client failures"):
        P.overload_run(None, None, {"n_docs": 2}, False)
    assert gc.isenabled()
