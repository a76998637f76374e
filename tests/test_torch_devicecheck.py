"""The port's device-hygiene pass and device witness
(``tfidf_tpu_torch/tools/graftcheck/devicecheck.py`` and
``device_witness.py``), in the style of the reference's
``tests/test_devicecheck.py``:

1. **seeded fixtures** (``tests/data/torch_graftcheck/dc_*``) — every
   torch sync form is caught inside the cone, the fetch stage is exempt,
   host values (``np.ndarray`` annotations, pinned or CPU allocations,
   metadata, identity tests) are clean, a missing cone root is a finding,
   kernel builds and loads stay in ``kernels.py``, compiled-callable and
   buffer caches are keyed by capacity class, and the in-place audit
   finds a dead tensor argument;
2. **extraction floors** — the 17 cone roots resolve, the cone is the
   serving path, the tensor annotations are read;
3. **the real tree** — no unpinned finding, the reference's reviewed
   transfer and donation pins carried over with their reasons;
4. **the CPU witness** — seeded transfers explained or not, a seeded
   post-warmup build, the vacuous-run floor, and a steady-state
   ``Engine`` search loop with zero builds and every transfer explained;
5. **the kernels' sources** hold no blocking CUDA call.
"""

from __future__ import annotations

import os
import re
import shutil
import stat
import sys
import types
import warnings

import numpy as np
import pytest
import torch

from tfidf_tpu_torch.tools.graftcheck import core as gc_core
from tfidf_tpu_torch.tools.graftcheck import devicecheck
from tfidf_tpu_torch.tools.graftcheck.core import SourceTree, load_allowlist
from tfidf_tpu_torch.tools.graftcheck.device_witness import DeviceWitness

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "data", "torch_graftcheck")


def _mini_tree(tmp_path, name: str) -> SourceTree:
    src = os.path.join(FIXTURES, name)
    pkg = tmp_path / gc_core.PACKAGE
    shutil.copytree(src, pkg)
    for dirpath, _dirs, _files in os.walk(pkg):
        init = os.path.join(dirpath, "__init__.py")
        if not os.path.exists(init):
            open(init, "w").close()
    return SourceTree(str(tmp_path))


def _keys(findings) -> set[str]:
    return {f.key for f in findings}


def _transfers(tree, roots) -> set[str]:
    dc = devicecheck._DeviceCheck(tree, cone_roots=tuple(roots))
    dc.check_transfers()
    return _keys(dc.findings)


# ---------------------------------------------------------------------------
# 1. seeded fixtures
# ---------------------------------------------------------------------------

# (method of srv.Sync, op of the key it must raise)
SYNC_FORMS = [
    ("item", "item"), ("tolist", "tolist"), ("cpu", "cpu"),
    ("numpy", "numpy"), ("to_cpu", "to_cpu"), ("to_cpu_kw", "to_cpu"),
    ("int_", "int"), ("float_", "float"), ("bool_", "bool"),
    ("truthiness_if", "truthiness"), ("truthiness_while", "truthiness"),
    ("truthiness_assert", "truthiness"), ("truthiness_and", "truthiness"),
    ("truthiness_not", "truthiness"), ("asarray", "asarray"),
    ("array", "asarray"), ("nonzero_fn", "nonzero"),
    ("nonzero_method", "nonzero"), ("argwhere", "nonzero"),
    ("where_one_arg", "nonzero"), ("unique", "unique"),
    ("unique_method", "unique"), ("masked_select", "masked_select"),
    ("mask_index", "mask_index"), ("mask_index_isfinite", "mask_index"),
    ("mask_store", "mask_index"), ("sync_device", "synchronize"),
    ("sync_event", "synchronize"), ("sync_stream", "synchronize"),
]


@pytest.fixture(scope="module")
def sync_keys(tmp_path_factory):
    tree = _mini_tree(tmp_path_factory.mktemp("syncs"), "dc_syncs")
    return _transfers(tree, [f"srv.Sync.{m}" for m, _ in SYNC_FORMS])


@pytest.mark.parametrize("method,op", SYNC_FORMS)
def test_every_sync_form_is_caught_in_the_cone(sync_keys, method, op):
    assert f"devicecheck:transfer:srv.Sync.{method}:{op}" in sync_keys, \
        sorted(sync_keys)


def test_each_sync_form_is_one_finding(sync_keys):
    """No form raises a second, spurious key (``.cpu().numpy()`` is one
    transfer, ``.max()`` is not a sync)."""
    assert len(sync_keys) == len(SYNC_FORMS), sorted(sync_keys)


def test_host_values_are_clean(tmp_path):
    tree = _mini_tree(tmp_path, "dc_clean")
    roots = [f"srv.Clean.{m}" for m in (
        "metadata", "identity", "host_values", "host_alloc",
        "two_arg_where", "python_scalars")]
    assert _transfers(tree, roots) == set()


def test_fetch_stage_is_exempt(tmp_path):
    tree = _mini_tree(tmp_path, "dc_clean")
    assert _transfers(tree, ["ops.topk.fetch_packed",
                             "ops.topk.unpack_topk"]) == set()


def test_annotated_tensor_attr_syncs_host_attr_does_not(tmp_path):
    tree = _mini_tree(tmp_path, "dc_attrs")
    keys = _transfers(tree, ["srv.Searcher.device_attr",
                             "srv.Searcher.optional_device_attr",
                             "srv.Searcher.host_attr"])
    assert keys == {
        "devicecheck:transfer:srv.Searcher.device_attr:float",
        "devicecheck:transfer:srv.Searcher.optional_device_attr:tolist"}


def test_missing_cone_root_is_a_finding(tmp_path):
    tree = _mini_tree(tmp_path, "dc_cone_missing")
    assert _transfers(tree, ["srv.Searcher._dispatch_chunk"]) == {
        "devicecheck:cone-root-missing:srv.Searcher._dispatch_chunk"}


def test_kernel_builds_and_loads_stay_in_kernels_py(tmp_path):
    tree = _mini_tree(tmp_path, "dc_build")
    dc = devicecheck._DeviceCheck(tree, cone_roots=(
        "srv.Searcher.seam", "srv.Searcher.rebuild", "srv.Searcher.raw"))
    keys = _keys(dc.check())
    # the memoized load is the seam: the cone stops there
    assert "kernels.load" in dc.cone()
    assert not any("ops.ell.launch:" in k for k in keys), keys
    assert "devicecheck:transfer:ops.ell.launch_rebuilding:build" in keys
    assert "devicecheck:transfer:ops.ell.launch_raw:build" in keys
    assert "devicecheck:kernel-seam:ops.ell.launch_raw:load" in keys
    assert not any(k.startswith("devicecheck:kernel-seam:kernels.")
                   for k in keys), keys


def test_cache_discipline(tmp_path):
    tree = _mini_tree(tmp_path, "dc_cache")
    dc = devicecheck._DeviceCheck(tree, cone_roots=())
    dc.check_cache_discipline()
    assert _keys(dc.findings) == {
        "devicecheck:compile-uncached:ops.apply.hot_path",
        "devicecheck:compile-unstable-key:ops.apply.Memo.get_fn_by_size",
        "devicecheck:buffer-unstable-key:ops.apply.Memo.buffer_by_docs"}
    kinds = {r.kind for r in dc.roots}
    assert kinds == {"compile"} and len(dc.roots) == 5


def test_inplace_audit(tmp_path):
    tree = _mini_tree(tmp_path, "dc_inplace")
    dc = devicecheck._DeviceCheck(tree, cone_roots=())
    dc.check_inplace()
    assert _keys(dc.findings) == {
        "devicecheck:inplace:index.Index.commit:apply",
        "devicecheck:inplace:index.Index.commit_rebind_same_line:apply"}


# ---------------------------------------------------------------------------
# 2. extraction floors
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_tree():
    return SourceTree(REPO_ROOT)


@pytest.fixture(scope="module")
def real_dc(real_tree):
    return devicecheck._DeviceCheck(real_tree)


def test_all_17_cone_roots_resolve(real_dc):
    # 17 roots of the reference's cone, and the host fallback's two
    # entry points (it serves while the device is sick)
    assert len(devicecheck.CONE_ROOTS) == 19
    for qual in devicecheck.CONE_ROOTS:
        assert real_dc._resolve_root(qual) is not None, qual


def test_cone_covers_the_serving_path(real_dc):
    cone = real_dc.cone()
    assert not [f.key for f in real_dc.findings
                if "cone-root-missing" in f.key]
    assert len(cone) >= 80, len(cone)
    for qual in ("engine.searcher.Searcher._dispatch_tiered",
                 "engine.tiering.TierManager._build_device",
                 "ops.topk.fetch_packed", "ops.ell.score_block_kernel",
                 "kernels.load"):
        assert qual in cone, qual
    assert "kernels.build_all" not in cone


def test_tensor_and_host_annotations_read(real_dc):
    dev, host = real_dc._device_attrs, real_dc._host_attrs
    assert "df" in dev["engine.index.Snapshot"]
    assert "n_docs" in dev["engine.index.Snapshot"]
    assert {"uniq", "slots", "weights"} <= dev["ops.scoring.QueryBatch"]
    assert {"uniq_host", "n_uniq"} <= host["ops.scoring.QueryBatch"]


def test_no_compile_creation_today(real_tree):
    assert devicecheck.compile_roots(real_tree) == []


# ---------------------------------------------------------------------------
# 3. the real tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_findings(real_tree):
    return devicecheck.analyze(real_tree)


def test_no_unpinned_findings(real_findings):
    allowlist = load_allowlist()
    new = [f for f in real_findings if f.key not in allowlist]
    assert not new, "\n".join(f.render() for f in new)


@pytest.mark.parametrize("site", ["engine.searcher.Searcher._dispatch_tiered",
                                  "engine.searcher.Searcher._search_unbounded",
                                  "engine.segments.SegmentedSnapshot.df_host"])
def test_reference_transfer_pins_carried_over(real_findings, site):
    """The reference's reviewed d2h sites stay visible as allowlisted
    findings, each with the reference's reason."""
    import json
    with open(os.path.join(REPO_ROOT, "tools", "graftcheck",
                           "allowlist.json"), encoding="utf-8") as f:
        reference = json.load(f)[f"devicecheck:transfer:{site}:asarray"]
    key = f"devicecheck:transfer:{site}:cpu"
    assert key in _keys(real_findings)
    assert load_allowlist()[key].startswith(reference)


@pytest.mark.parametrize("site", [
    "engine.segments.SegmentedIndex.commit:apply",
    "parallel.mesh_ell_index.MeshEllIndex.commit:apply"])
def test_reference_donation_rejections_carried_over(real_findings, site):
    key = f"devicecheck:inplace:{site}"
    assert key in _keys(real_findings)
    assert "aliasing" in load_allowlist()[key] or \
        "alias" in load_allowlist()[key]


def test_explained_sites(real_tree):
    sites = devicecheck.explained_transfer_sites(real_tree)
    assert devicecheck.FETCH_STAGE <= sites
    assert devicecheck.BULK_STAGES <= sites
    assert ("engine.searcher", "_dispatch_tiered") in sites
    assert ("engine.searcher", "_dispatch_chunk") not in sites


# ---------------------------------------------------------------------------
# 4. the CPU witness
# ---------------------------------------------------------------------------

def _fixture_module(name: str, source: str):
    """A throwaway tfidf_tpu_torch submodule the witness will watch."""
    mod = types.ModuleType(f"{gc_core.PACKAGE}.{name}")
    mod.__dict__.update(np=np, torch=torch)
    exec(compile(source, f"<{name}>", "exec"), mod.__dict__)
    sys.modules[mod.__name__] = mod
    return mod


_LEAKY = """
def leaky_dispatch(x):
    a = x.sum().item()
    b = x.tolist()
    c = np.asarray(x)
    d = float(x[0])
    e = bool(x.any())
    return a, b, c, d, e, x.cpu().numpy(), int(x[1])
"""


def test_witness_records_every_python_side_transfer():
    mod = _fixture_module("zz_dw_leaky", _LEAKY)
    try:
        w = DeviceWitness(explained=set(), cpu_tensors=True).install()
        try:
            mod.leaky_dispatch(torch.arange(4.0))
        finally:
            w.uninstall()
        ops = {op for (m, fn, op) in w.observed
               if (m, fn) == ("zz_dw_leaky", "leaky_dispatch")}
        assert ops == {"item", "tolist", "asarray", "float", "bool",
                       "cpu", "numpy", "int"}, w.report()
        with pytest.raises(AssertionError, match="did not explain"):
            w.check()
    finally:
        sys.modules.pop(mod.__name__, None)


def test_witness_explained_transfer_passes():
    mod = _fixture_module("zz_dw_fetch", """
def fetch_stage(x):
    return x.cpu().numpy()
""")
    try:
        w = DeviceWitness(explained={("zz_dw_fetch", "fetch_stage")},
                          cpu_tensors=True).install()
        try:
            mod.fetch_stage(torch.ones(4))
        finally:
            w.uninstall()
        w.check(min_observations=1)
    finally:
        sys.modules.pop(mod.__name__, None)


def test_witness_ignores_host_arrays_and_callers_outside_the_port():
    mod = _fixture_module("zz_dw_host", """
def host_only(x):
    return np.asarray(x).tolist()
""")
    try:
        w = DeviceWitness(explained=set(), cpu_tensors=True).install()
        try:
            mod.host_only(np.ones(4))
            torch.ones(3).sum().item()        # this test is no port frame
        finally:
            w.uninstall()
        assert not w.observed
        w.check()
    finally:
        sys.modules.pop(mod.__name__, None)


def test_witness_uninstall_restores_tensor_and_numpy():
    from tfidf_tpu_torch.ops import topk
    before = {a: torch.Tensor.__dict__.get(a) for a in (
        "item", "tolist", "cpu", "numpy", "__bool__", "__int__",
        "__float__")}
    w = DeviceWitness(explained=set(), cpu_tensors=True).install()
    assert torch.Tensor.__dict__.get("item") is not None
    assert topk.np is not np
    w.uninstall()
    assert {a: torch.Tensor.__dict__.get(a) for a in before} == before
    assert topk.np is np
    assert torch.ones(2).sum().item() == 2.0


def test_witness_vacuous_run_fails_floor():
    w = DeviceWitness(explained=set(), cpu_tensors=True).install()
    w.uninstall()
    with pytest.raises(AssertionError, match="vacuous"):
        w.check(min_observations=1)


_SYNC_WARNING = "tensor conversion called a synchronizing CUDA operation"


@pytest.fixture
def reported_syncs(monkeypatch):
    """The card's side of the witness on the CPU: CUDA reads as present,
    sync debug mode is a no-op, and ``torch.tensor`` / ``torch.as_tensor``
    each report one synchronizing operation, as the card's sync debug mode
    does for a blocking copy, then return a host tensor."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)

    def reporting(*a, **kw):
        warnings.warn(_SYNC_WARNING, UserWarning)
        return torch.zeros(1)
    for fn in ("tensor", "as_tensor"):
        monkeypatch.setattr(torch, fn, reporting)
    mod = _fixture_module("zz_dw_dir", """
def convert(fn, args, kw):
    return getattr(torch, fn)(*args, **kw)
""")
    yield mod
    sys.modules.pop(mod.__name__, None)


def _meta(*shape):
    """A tensor off the host that the CPU can hold: stands in for a CUDA
    tensor."""
    return torch.empty(*shape, device="meta")


@pytest.mark.parametrize("fn,args,kw,direction", [
    ("as_tensor", (np.ones(4, np.float32),), {}, "h2d"),
    ("tensor", ([1.0, 2.0],), {}, "h2d"),
    ("as_tensor", (), {"data": np.ones(2)}, "h2d"),
    ("as_tensor", (_meta(4),), {"device": "cpu"}, "d2h"),
    ("tensor", ([_meta(()), _meta(())],), {}, "d2h"),
    ("as_tensor", (), {"data": _meta(2), "device": "cpu"}, "d2h"),
], ids=["numpy", "floats", "data-kwarg", "device-to-cpu",
        "device-scalars", "device-data-kwarg"])
def test_witness_direction_follows_the_source(reported_syncs, fn, args, kw,
                                              direction):
    """A sync reported inside ``torch.tensor`` / ``torch.as_tensor`` is a
    host->device copy (reported, not gated) only when the data is on the
    host; data that holds a device tensor is read back, a gated d2h."""
    w = DeviceWitness(explained=set()).install()
    try:
        reported_syncs.convert(fn, args, kw)
    finally:
        w.uninstall()
    assert w.syncs == {("zz_dw_dir", "convert", direction): 1}, w.report()
    if direction == "h2d":
        w.check(min_observations=1)
    else:
        with pytest.raises(AssertionError, match="did not explain"):
            w.check()


def test_witness_fails_a_sync_outside_the_port(reported_syncs):
    """A card-reported sync with no port frame on its stack has no site
    that could explain it: the witness fails rather than only counting
    it."""
    w = DeviceWitness(explained=set()).install()
    try:
        torch.as_tensor(np.ones(2))              # this test is no port frame
    finally:
        w.uninstall()
    assert w.unattributed == 1 and not w.syncs, w.report()
    with pytest.raises(AssertionError, match="no tfidf_tpu_torch frame"):
        w.check()


def test_witness_detects_a_post_warmup_build(tmp_path, monkeypatch):
    """A kernel build inside the steady-state window fails the witness:
    ``kernels.build_all`` runs a stand-in ``nvcc`` (a script that writes
    its output file), which moves ``build_count()`` exactly as a real
    build does."""
    from tfidf_tpu_torch import kernels

    cuda_home = tmp_path / "cuda"
    (cuda_home / "bin").mkdir(parents=True)
    nvcc = cuda_home / "bin" / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(cuda_home))
    monkeypatch.setenv("TFIDF_TORCH_BUILD_DIR", str(tmp_path / "build"))
    w = DeviceWitness(explained=set(), cpu_tensors=True).install()
    try:
        kernels.build_all()                  # warmup: builds
        w.end_warmup()
        kernels.build_all()                  # up to date: no build
        w.check(max_post_warmup_builds=0)
        for lib in (tmp_path / "build").iterdir():
            lib.unlink()                     # stale library: rebuild
        kernels.build_all()
        with pytest.raises(AssertionError, match="post-warmup"):
            w.check(max_post_warmup_builds=0)
        assert w.post_warmup_builds() == 1
    finally:
        w.uninstall()


def _engine(tmp_path, **kw):
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.utils.config import Config

    cfg = Config(documents_path=str(tmp_path / "docs"),
                 index_path=str(tmp_path / "index"),
                 min_nnz_capacity=256, min_doc_capacity=64,
                 min_vocab_capacity=64, **kw)
    eng = Engine(cfg, device="cpu")
    rng = np.random.default_rng(7)
    vocab = [f"t{i}" for i in range(50)]
    for d in range(48):
        eng.ingest_text(f"doc{d}", " ".join(rng.choice(vocab, size=12)))
    eng.commit()

    def batch(seed):
        r = np.random.default_rng(seed)
        return [" ".join(r.choice(vocab, size=3, replace=False))
                for _ in range(8)]
    return eng, batch


@pytest.mark.parametrize("pipeline_mode", ["inline", "executor"])
def test_steady_state_serving_is_explained(tmp_path, pipeline_mode):
    """The claim the pass exists to guard, on the CPU: after two warmup
    batches a steady-state stream of search batches (both pipeline
    loops), result arrays and dense batches builds no kernel, and
    every transfer it makes is one the static cone explains; the run
    observed transfers (the floor)."""
    eng, batch = _engine(tmp_path, search_pipeline_mode=pipeline_mode)
    want = [eng.search_batch(batch(i), k=5) for i in range(2, 8)]
    w = DeviceWitness(cpu_tensors=True).install()
    try:
        eng.search_batch(batch(0), k=5)
        eng.search_batch(batch(1), k=5)
        w.end_warmup()
        got = [eng.search_batch(batch(i), k=5) for i in range(2, 8)]
        eng.search_batch_arrays(batch(9), k=5)
        eng.search_dense_batch(batch(10), k=5)
    finally:
        w.uninstall()
    assert got == want                       # the witness changes nothing
    w.check(max_post_warmup_builds=0, min_observations=8)
    sites = {(m, f) for m, f, _op in w.observed}
    assert sites <= devicecheck.FETCH_STAGE, w.report()


# ---------------------------------------------------------------------------
# 5. the kernels' sources
# ---------------------------------------------------------------------------

_BLOCKING = re.compile(
    r"\b(cudaMemcpy|cudaMemcpy2D|cudaMemset|cudaMalloc|cudaFree|"
    r"cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize|"
    r"cudaMallocHost|cudaHostAlloc|cudaFreeHost)\s*\(")


def test_kernel_sources_hold_no_blocking_cuda_call():
    """The kernel launch goes through ctypes, which sync debug mode
    cannot see: it stays asynchronous because the sources call no copy,
    allocation or synchronize, and the launch returns
    ``cudaGetLastError()``."""
    csrc = os.path.join(REPO_ROOT, "tfidf_tpu_torch", "csrc")
    sources = [f for f in os.listdir(csrc) if f.endswith(".cu")]
    assert sources
    for fn in sources:
        with open(os.path.join(csrc, fn), encoding="utf-8") as f:
            text = f.read()
        assert not _BLOCKING.findall(text), (fn, _BLOCKING.findall(text))
        assert "cudaGetLastError()" in text, fn


@pytest.fixture
def cuda():
    """The card, decided here and never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: sync debug mode reports only CUDA "
                    "synchronizations")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_reports_syncs_by_site_and_direction(cuda):
    mod = _fixture_module("zz_dw_card", """
def upload_and_read(x):
    dev = torch.from_numpy(x).to("cuda")
    return dev.sum().item()
""")
    try:
        w = DeviceWitness(explained=set()).install()
        try:
            mod.upload_and_read(np.ones(1024, np.float32))
        finally:
            w.uninstall()
        dirs = {d for (m, fn, d) in w.syncs if m == "zz_dw_card"}
        assert "d2h" in dirs, w.report()
        with pytest.raises(AssertionError, match="did not explain"):
            w.check()
    finally:
        sys.modules.pop(mod.__name__, None)
