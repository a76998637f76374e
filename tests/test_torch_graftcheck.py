"""The port's graftcheck (``tfidf_tpu_torch/tools/graftcheck``): its nine
static passes over ``tfidf_tpu_torch/`` and its lockdep and protocol
witnesses. (The device-hygiene pass and the device witness are held in
``tests/test_torch_devicecheck.py``.)

Layers, as in the reference's ``tests/test_graftcheck.py``:

1. **seeded fixtures** — each pass must catch a planted violation in a
   tiny package copied from ``tests/data/torch_graftcheck/`` (the
   fixtures live there so their endpoint literals never count as client
   calls of either package's protocol pass), and stay quiet on its clean
   counterpart;
2. **the real tree** — the port has no unpinned finding, every pin has a
   reason and still matches, every baseline key has a ROADMAP queue line,
   and the extraction floors hold;
3. **the copy** — the package-agnostic passes, run over the JAX tree,
   find exactly the keys ``tools/graftcheck`` finds there;
4. **the witnesses** — seeded inversions and exchanges are reported, and
   a real port coordinator and node yield orderings and exchanges that
   the static side explains.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import pytest

from tfidf_tpu_torch.tools.graftcheck import core as gc_core
from tfidf_tpu_torch.tools.graftcheck import (deadsymbols, jitpurity,
                                              lockgraph, protocol,
                                              registry_drift, resilience,
                                              storageseam, wallclock)
from tfidf_tpu_torch.tools.graftcheck.core import (SourceTree,
                                                   load_allowlist,
                                                   load_baseline,
                                                   run_analyzers, triage)
from tfidf_tpu_torch.tools.graftcheck.protocol_witness import \
    ProtocolWitness
from tfidf_tpu_torch.tools.graftcheck.witness import (LockdepWitness,
                                                      _InstrLock,
                                                      _InstrRLock)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO_ROOT, "tests", "data", "torch_graftcheck")


def _mini_tree(tmp_path, name: str, **swap) -> SourceTree:
    """A package ``tfidf_tpu_torch`` under ``tmp_path`` holding fixture
    ``name``'s files (``README.md`` goes to the root; ``_variants/`` is
    read by the tests, never copied). ``swap`` replaces a package file
    by a variant: ``{"cluster/resilience.py": "resilience_skewed.py"}``."""
    src = os.path.join(FIXTURES, name)
    pkg = tmp_path / gc_core.PACKAGE
    if pkg.exists():
        shutil.rmtree(pkg)
    pkg.mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    for dirpath, dirs, files in os.walk(src):
        dirs[:] = [d for d in dirs if not d.startswith("_")]
        for fn in files:
            rel = os.path.relpath(os.path.join(dirpath, fn), src)
            if rel == "README.md":
                shutil.copy(os.path.join(src, rel), tmp_path / rel)
                continue
            dst = pkg / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            if not (dst.parent / "__init__.py").exists():
                (dst.parent / "__init__.py").write_text("")
            shutil.copy(os.path.join(src, rel), dst)
    for rel, variant in swap.items():
        shutil.copy(os.path.join(src, "_variants", variant), pkg / rel)
    return SourceTree(str(tmp_path))


def _variant(name: str, variant: str) -> str:
    with open(os.path.join(FIXTURES, name, "_variants", variant),
              encoding="utf-8") as f:
        return f.read()


def _keys(findings) -> set[str]:
    return {f.key for f in findings}


# ---------------------------------------------------------------------------
# 1. seeded fixtures: each pass must catch its planted bug
# ---------------------------------------------------------------------------

class TestSeededLockgraph:
    def test_detects_lock_order_cycle(self, tmp_path):
        keys = _keys(lockgraph.analyze(_mini_tree(tmp_path, "lock_cycle")))
        assert any("cycle" in k for k in keys), keys

    def test_consistent_order_has_no_cycle(self, tmp_path):
        g = lockgraph.build(_mini_tree(tmp_path, "lock_order_ok"))
        assert not g.findings, g.findings
        assert ("good.A._l1", "good.A._l2") in g.edge_set()

    def test_detects_locked_rpc_not_unlocked_one(self, tmp_path):
        keys = _keys(lockgraph.analyze(_mini_tree(tmp_path, "locked_rpc")))
        assert any(k.startswith("lockgraph:blocking:bad.A._l:"
                                "bad.A.locked_rpc") for k in keys), keys
        assert not any("unlocked_rpc" in k for k in keys), keys

    def test_detects_transitive_blocking_and_edge(self, tmp_path):
        g = lockgraph.build(_mini_tree(tmp_path, "transitive_blocking"))
        assert any("locked_sync" in f.key and "sync" in f.key
                   for f in g.findings), g.findings
        assert ("bad.A._l", "bad.Store._mu") in g.edge_set()

    def test_detects_indefinite_wait_not_bounded_one(self, tmp_path):
        keys = _keys(lockgraph.analyze(
            _mini_tree(tmp_path, "indefinite_wait")))
        assert "lockgraph:indefinite-wait:bad.park:wait" in keys, keys
        assert not any("bounded" in k for k in keys), keys


class TestSeededCapturePurity:
    def test_compiled_function_that_takes_a_lock(self, tmp_path):
        found = jitpurity.analyze(_mini_tree(tmp_path, "capture_compile"))
        keys = _keys(found)
        assert "jitpurity:lock:bad.locked" in keys, keys
        assert "jitpurity:wall-clock:bad.helper" in keys, keys
        assert "jitpurity:mutable-global:bad.kernel" in keys, keys

    @pytest.mark.parametrize("qual,category", [
        ("bad.decorated", "wall-clock"),         # @torch.compile(mode=)
        ("bad.scripted", "wall-clock"),          # @torch.jit.script
        ("bad.traced", "metrics"),               # torch.jit.trace(fn, x)
        ("bad.<lambda@L", "wall-clock"),         # torch.compile(lambda)
        ("bad.graphed", "wall-clock"),           # make_graphed_callables
        ("bad.Runner.capture.<graph@L", "lock"),  # with torch.cuda.graph
        ("bad.Runner.capture_raw.<graph@L", "metrics"),  # capture_begin
    ])
    def test_every_capture_root_form(self, tmp_path, qual, category):
        keys = _keys(jitpurity.analyze(_mini_tree(tmp_path,
                                                  "capture_forms")))
        assert any(k.startswith(f"jitpurity:{category}:{qual}")
                   for k in keys), keys

    def test_pure_capture_is_clean(self, tmp_path):
        p = jitpurity._Purity(_mini_tree(tmp_path, "capture_clean"))
        labels = [label for _, _, label in p.roots()]
        assert len(labels) == 2, labels      # the compile and the graph
        assert not p.check()


class TestSeededRegistryAndSeams:
    def test_detects_unregistered_and_stale_fault_points(self, tmp_path):
        keys = _keys(registry_drift.check_fault_points(
            _mini_tree(tmp_path, "fault_points")))
        assert "registry_drift:faults:unregistered:rogue.point" in keys
        assert "registry_drift:faults:stale:ghost.point" in keys
        assert not any("known.point" in k for k in keys)

    def test_detects_storage_seam_violations(self, tmp_path):
        keys = _keys(storageseam.analyze(_mini_tree(tmp_path,
                                                    "storage_seam")))
        for op in ("open:wb", "savez", "replace"):
            assert f"storageseam:raw-io:engine.rogue.Saver.save:{op}" \
                in keys, keys
        assert not any("Saver.load" in k for k in keys)
        assert "storageseam:raw-io:utils.storage.write_bytes:open:wb" \
            in keys

    @pytest.mark.parametrize("qual,flagged", [
        ("cluster.rpc.naked", True),
        ("cluster.rpc.naked_failover.slice_rpc", True),
        ("cluster.rpc.wrapped", False),
        ("cluster.rpc.wrapped_lambda", False),
        ("cluster.rpc.kw_wrapped.rpc", False),
        ("cluster.rpc.scatter.rpc_one", False),
    ])
    def test_transport_through_worker_call(self, tmp_path, qual, flagged):
        quals = {f.key.split(":")[2]
                 for f in resilience.analyze(_mini_tree(tmp_path,
                                                        "transport"))}
        assert (qual in quals) == flagged, quals

    def test_detects_wallclock_misuse(self, tmp_path):
        keys = _keys(wallclock.analyze(_mini_tree(tmp_path, "wallclock")))
        assert "wallclock:mod.f:deadline-arithmetic" in keys
        assert "wallclock:mod.g:deadline-arithmetic" in keys
        assert "wallclock:mod.h:timestamp" in keys
        assert not any("mod.ok" in k for k in keys)

    def test_detects_dead_symbol(self, tmp_path):
        keys = _keys(deadsymbols.analyze(_mini_tree(tmp_path,
                                                    "dead_symbol"),
                                         str(tmp_path)))
        assert "deadsymbols:unreferenced:m.dead_helper" in keys
        assert "deadsymbols:unreferenced:m.C.dead_method" in keys
        assert not any("live_method" in k or ":m.used" in k for k in keys)


class TestSeededProtocol:
    def test_detects_endpoint_drift_both_ways(self, tmp_path):
        keys = _keys(protocol.check_endpoints(
            _mini_tree(tmp_path, "endpoint_drift")))
        assert "protocol:endpoint:unserved:/worker/phantom" in keys
        assert "protocol:endpoint:unserved:/worker/ghost" in keys
        assert not any(k.endswith("worker/served") for k in keys), keys

    def test_detects_uncalled_endpoint(self, tmp_path):
        keys = _keys(protocol.check_endpoints(_mini_tree(tmp_path,
                                                         "uncalled")))
        assert "protocol:endpoint:uncalled:/api/nobody-calls-me" in keys

    def test_detects_missing_fence_stamp(self, tmp_path):
        keys = _keys(protocol.check_fence_stamps(_mini_tree(tmp_path,
                                                            "fence")))
        assert ("protocol:header:unfenced-mutation:cluster.rpc.bad:"
                "/worker/delete") in keys
        assert ("protocol:header:unfenced-mutation:cluster.rpc."
                "bad_upload:/worker/upload") in keys
        assert not any(":cluster.rpc.good:" in k for k in keys), keys

    def test_detects_missing_deadline_stamp(self, tmp_path):
        keys = _keys(protocol.check_deadline_stamps(
            _mini_tree(tmp_path, "deadline")))
        assert ("protocol:header:undeadlined-scatter:"
                "cluster.rpc.undeadlined") in keys
        assert not any("cluster.rpc.ok" in k for k in keys), keys

    def test_detects_unstamped_429_and_bypass_send(self, tmp_path):
        tree = _mini_tree(tmp_path, "shed")
        shed = _keys(protocol.check_shed_headers(tree))
        assert ("protocol:header:shed-missing-retry-after:"
                "cluster.h.H.do_POST:429") in shed
        disc = _keys(protocol.check_send_discipline(tree))
        assert "protocol:header:bypass-send:cluster.h.H.naked" in disc
        assert not any("_send" in k and "bypass" in k for k in disc)

    def test_stamped_429_passes(self, tmp_path):
        assert not protocol.check_shed_headers(_mini_tree(tmp_path,
                                                          "shed_ok"))

    def test_detects_unclassified_status(self, tmp_path):
        keys = _keys(protocol.check_statuses(
            _mini_tree(tmp_path, "statuses"), str(tmp_path)))
        assert "protocol:status:unknown:507" in keys
        assert "protocol:status:transient-4xx:404" in keys
        assert "protocol:status:readme-stale:410" in keys
        assert not any(":200" in k for k in keys), keys

    def test_detects_fence_status_mismatch(self, tmp_path):
        keys = _keys(protocol.check_statuses(
            _mini_tree(tmp_path, "fence_mismatch"), str(tmp_path)))
        assert "protocol:status:fence-mismatch" in keys

    def test_detects_version_surface_drift(self, tmp_path):
        tree = _mini_tree(tmp_path, "version")
        readme = tmp_path / "README.md"
        readme.write_text(_variant("version", "readme_ok.md").replace(
            "{fp}", protocol.contract_fingerprint(tree)))
        assert not protocol.check_version_surface(tree, str(tmp_path))
        readme.write_text(_variant("version", "readme_bad.md"))
        keys = _keys(protocol.check_version_surface(tree, str(tmp_path)))
        assert "protocol:version:row-unversioned:/worker/x" in keys
        assert "protocol:version:row-future:/worker/y" in keys
        assert "protocol:version:declared-mismatch" in keys
        assert "protocol:version:fingerprint-drift" in keys
        skewed = _mini_tree(tmp_path, "version", **{
            "cluster/resilience.py": "resilience_skewed.py"})
        keys = _keys(protocol.check_version_surface(skewed,
                                                    str(tmp_path)))
        assert "protocol:version:proto-status-mismatch" in keys

    def test_detects_raw_transport_bypass(self, tmp_path):
        keys = _keys(protocol.check_seams(_mini_tree(tmp_path, "seams")))
        assert "protocol:seam:no-nemesis:cluster.t.naked" in keys
        assert "protocol:seam:no-trace:cluster.t.naked" in keys
        assert not any("cluster.t.seam" in k for k in keys), keys


# ---------------------------------------------------------------------------
# 2. the real tree: the committed pins are the whole story
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real_findings():
    return run_analyzers(REPO_ROOT)


@pytest.fixture(scope="module")
def real_tree():
    return SourceTree(REPO_ROOT)


@pytest.fixture(scope="module")
def static_graph(real_tree):
    return lockgraph.build(real_tree)


class TestRealTree:
    def test_tree_is_the_port_without_its_tools(self, real_tree):
        assert real_tree.package == "tfidf_tpu_torch"
        assert "engine.searcher" in real_tree.modules
        assert not any(m.startswith("tools") for m in real_tree.modules)
        assert all(mi.relpath.startswith("tfidf_tpu_torch/")
                   for mi in real_tree.modules.values())

    def test_no_new_findings(self, real_findings):
        """The tier-1 copy of the CLI gate: everything the nine passes
        surface on the port is pinned in allowlist.json/baseline.json."""
        new, _pinned, _stale = triage(real_findings, load_allowlist(),
                                      load_baseline())
        assert not new, "unpinned graftcheck findings:\n" + "\n".join(
            f.render() for f in new)

    def test_every_pin_has_a_reason_and_a_finding(self, real_findings):
        live = {f.key for f in real_findings}
        allow = load_allowlist()
        assert sorted(set(allow) - live) == [], "stale allowlist entries"
        short = [k for k, why in allow.items() if len(why.strip()) < 40]
        assert not short, f"allowlist entries without a reason: {short}"
        assert sorted(set(load_baseline()) - live) == [], "stale baseline"

    def test_baseline_keys_have_a_queue_line(self):
        with open(os.path.join(REPO_ROOT, "ROADMAP.md"),
                  encoding="utf-8") as f:
            roadmap = f.read()
        queue_b = roadmap.split("### Queue B")[1].split("### Queue C")[0]
        missing = [k for k in load_baseline() if k not in queue_b]
        assert not missing, f"baseline keys with no queue B line: {missing}"

    def test_lock_graph_acyclic(self, static_graph):
        assert not any("cycle" in f.key for f in static_graph.findings)

    def test_lock_graph_has_load_bearing_edges(self, static_graph):
        edges = static_graph.edge_set()
        assert len(edges) >= 20, len(edges)
        assert ("cluster.ensemble.EnsembleNode._lock",
                "cluster.coordination.CoordinationCore._lock") in edges
        assert ("cluster.coordination.CoordinationCore._lock",
                "cluster.coordination._Session.cond") in edges
        assert ("cluster.node.SearchNode._reconcile_serial",
                "cluster.placement.PlacementMap.lock") in edges

    def test_lock_sites_cover_known_locks(self, static_graph):
        names = set(static_graph.tree.lock_sites.values())
        assert len(names) >= 40, len(names)
        for name in ("cluster.ensemble.EnsembleNode._lock",
                     "engine.pipeline.PipelineExecutor._lock",
                     "engine.tiering.TierManager._lock",
                     "engine.segments.SegmentedIndex._write_lock"):
            assert name in names, name

    @pytest.mark.parametrize("what", ["pipeline", "batcher", "registry",
                                      "cli-waits", "bench-replay"])
    def test_repaired_findings_stay_repaired(self, static_graph, what):
        """Regressions the reference repaired (the pipeline's bounded
        waits, the batcher's timeouts, the registry's unlocked refresh)
        and the port's own repairs: the CLI's serve-until-signal waits
        in 1 s steps, so SIGTERM lands (a listed deviation), and the
        replay mode's round waits for its clients with a deadline (its
        clients stop at theirs; a hung one no longer wedges the bench)."""
        bad = {
            "pipeline": lambda f: f.file
            == "tfidf_tpu_torch/engine/pipeline.py",
            "batcher": lambda f: "cluster.batcher" in f.key
            and "indefinite-wait" in f.key,
            "registry": lambda f: f.key.startswith(
                "lockgraph:blocking:cluster.registry."),
            "cli-waits": lambda f: f.key.startswith(
                "lockgraph:indefinite-wait:cli.cmd_"),
            "bench-replay": lambda f: f.key.startswith(
                "lockgraph:indefinite-wait:bench_modes."),
        }[what]
        assert not [f for f in static_graph.findings if bad(f)]

    def test_no_capture_root_today(self, real_tree):
        """The port compiles, scripts, traces and graph-captures nothing
        today: the capture-purity pass found zero roots (its seeded
        fixtures above prove it would find one)."""
        assert jitpurity._Purity(real_tree).roots() == []

    def test_registry_drift_clean(self, real_tree):
        assert not registry_drift.check_fault_points(real_tree)
        assert not registry_drift.check_config(real_tree, REPO_ROOT)
        allow = load_allowlist()
        assert not [f for f in registry_drift.check_metrics(real_tree)
                    if f.key not in allow]

    def test_route_extraction_floor(self, real_tree):
        routes = protocol.served_routes(real_tree)
        exact = {r.path for r in routes if not r.prefix}
        assert len(exact) >= 25, sorted(exact)
        assert {"/leader/start", "/worker/process-batch",
                "/worker/upload", "/rpc", "/events"} <= exact
        assert "/api/trace/" in {r.path for r in routes if r.prefix}

    def test_header_site_floors(self, real_tree):
        assert len(protocol.mutating_rpc_sites(real_tree)) >= 6
        assert len(protocol.scatter_rpc_sites(real_tree)) >= 3

    def test_status_contract_is_the_reference_s(self, real_tree):
        """Wire-compatible: the port's contract, read from the shared
        README, names the reference's statuses."""
        c = protocol.build_contract(REPO_ROOT, real_tree)
        assert c.statuses == {200, 400, 403, 404, 409, 415, 421, 422,
                              426, 429, 500, 503, 504, 507}

    def test_callers_are_the_port_s(self):
        files = {os.path.basename(p)
                 for p in gc_core.caller_files(REPO_ROOT)}
        assert "chip_smoke.py" in files and "probe_fleet.py" in files
        assert "test_torch_fleet.py" in files
        assert "test_cluster.py" not in files and "bench.py" not in files


def test_pins_ship_as_package_data():
    import glob
    import tomllib
    with open(os.path.join(REPO_ROOT, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["tfidf_tpu_torch"]
    pkg = os.path.join(REPO_ROOT, "tfidf_tpu_torch")
    shipped = {os.path.relpath(p, pkg) for pat in patterns
               for p in glob.glob(os.path.join(pkg, pat))}
    assert {"tools/graftcheck/allowlist.json",
            "tools/graftcheck/baseline.json"} <= shipped


def test_cli_exits_zero_on_the_port():
    r = subprocess.run([sys.executable, "-m",
                        "tfidf_tpu_torch.tools.graftcheck", "--json"],
                       cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    rep = json.loads(r.stdout)
    assert rep["new"] == [] and rep["stale_baseline"] == []


def test_reference_graftcheck_still_exits_zero():
    """The port's test files and fixtures add no client call the
    reference's protocol pass would count as drift."""
    r = subprocess.run([sys.executable, "-m", "tools.graftcheck"],
                       cwd=REPO_ROOT, capture_output=True, text=True,
                       timeout=240)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]


# ---------------------------------------------------------------------------
# 3. the copy: package-agnostic passes agree with tools/graftcheck
# ---------------------------------------------------------------------------

# the keys of these kinds depend on who the callers are (the port's
# tests and scripts, not all of tests/ and tools/), so on the JAX tree
# the port's copy may find more of them, never fewer
_CALLER_KINDS = ("protocol:endpoint:uncalled:", "deadsymbols:unreferenced:")


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX tree as each copy reads it: (the reference's SourceTree,
    the port's SourceTree over package ``tfidf_tpu``)."""
    from tools.graftcheck import core as jax_core
    return (jax_core.SourceTree(REPO_ROOT),
            SourceTree(REPO_ROOT, package="tfidf_tpu"))


@pytest.mark.parametrize("name", ["lockgraph", "resilience", "wallclock",
                                  "storageseam", "registry_drift",
                                  "protocol", "deadsymbols"])
def test_copy_finds_the_reference_s_keys_on_the_jax_tree(jax_trees, name):
    import importlib

    ours = importlib.import_module(
        f"tfidf_tpu_torch.tools.graftcheck.{name}")
    theirs = importlib.import_module(f"tools.graftcheck.{name}")
    args = () if name in ("lockgraph", "resilience", "wallclock") \
        else (REPO_ROOT,)
    want = _keys(theirs.analyze(jax_trees[0], *args))
    got = _keys(ours.analyze(jax_trees[1], *args))
    assert want, name
    assert {k for k in got if not k.startswith(_CALLER_KINDS)} == \
        {k for k in want if not k.startswith(_CALLER_KINDS)}
    assert want <= got


# ---------------------------------------------------------------------------
# 4. the runtime lockdep witness
# ---------------------------------------------------------------------------

class TestLockdepWitness:
    def test_seeded_inversion_reported(self, static_graph):
        w = LockdepWitness(graph=static_graph)
        a = _InstrLock(w, "fixture.A")
        b = _InstrLock(w, "fixture.B")
        with a:
            with b:
                pass
        with b:
            with a:
                pass
        with pytest.raises(AssertionError, match="inversions"):
            w.check()

    def test_consistent_order_passes(self, static_graph):
        w = LockdepWitness(graph=static_graph)
        a = _InstrLock(w, "cluster.ensemble.EnsembleNode._lock")
        b = _InstrLock(w, "cluster.coordination.CoordinationCore._lock")
        for _ in range(2):
            with a:
                with b:
                    pass
        rep = w.check(min_multilock_edges=1)
        assert not rep["inversions"] and not rep["unexplained"]

    def test_edge_missing_from_static_graph_fails(self, static_graph):
        w = LockdepWitness(graph=static_graph)
        a = _InstrLock(w, "cluster.coordination.CoordinationCore._lock")
        b = _InstrLock(w, "cluster.ensemble.EnsembleNode._lock")
        with a:
            with b:
                pass
        with pytest.raises(AssertionError, match="missing from the"):
            w.check()

    def test_rlock_reentry_is_not_an_edge(self, static_graph):
        w = LockdepWitness(graph=static_graph)
        a = _InstrRLock(w, "fixture.R")
        with a:
            with a:
                pass
        assert not w.edges

    def test_real_coordinator_orderings(self, static_graph, tmp_path):
        """A durable port coordinator + registry workload: the witness
        observes real multi-lock orderings and the static graph explains
        every one (the port's locks are named by their creation sites in
        ``tfidf_tpu_torch/``)."""
        from tfidf_tpu_torch.cluster.coordination import (
            CoordinationClient, CoordinationServer)
        from tfidf_tpu_torch.cluster.registry import ServiceRegistry

        w = LockdepWitness(graph=static_graph)
        with w:
            srv = CoordinationServer(
                port=0, session_timeout_s=1.0,
                data_dir=str(tmp_path / "coord")).start()
            try:
                cli = CoordinationClient(srv.address)
                reg = ServiceRegistry(cli)
                reg.register_to_cluster("http://127.0.0.1:1")
                assert reg.get_all_service_addresses() \
                    == ["http://127.0.0.1:1"]
                cli.create("/w", b"1")
                cli.delete("/w")
                srv.core.expire_session(cli.sid)
                time.sleep(0.3)
                cli.close()
            finally:
                srv.close()
        w.check(min_multilock_edges=1)
        assert ("cluster.ensemble.EnsembleNode._lock",
                "cluster.coordination.CoordinationCore._lock") \
            in w.multi_lock_edges()


# ---------------------------------------------------------------------------
# 5. the runtime protocol witness
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wire_contract():
    return protocol.build_contract(REPO_ROOT)


with open(os.path.join(FIXTURES, "witness_cases.json"),
          encoding="utf-8") as _f:
    _WITNESS_CASES = json.load(_f)


@pytest.mark.parametrize("case", sorted(_WITNESS_CASES))
def test_protocol_witness_seeded(wire_contract, case):
    spec = _WITNESS_CASES[case]
    w = ProtocolWitness(contract=wire_contract)
    for plane, method, path, status, headers, traced in spec["observe"]:
        w.observe(plane, method, path, status, headers,
                  traced_request=traced)
    if spec["raises"] is None:
        w.check()
    else:
        with pytest.raises(AssertionError, match=spec["raises"]):
            w.check()


def test_protocol_witness_floors(wire_contract):
    w = ProtocolWitness(contract=wire_contract)
    with pytest.raises(AssertionError, match="not seeing"):
        w.check(min_exchanges=1)
    w.observe("front", "POST", "/leader/start", 200,
              ["X-Trace-Id", "X-Route-Generation", "X-Route-Epoch",
               "X-Proto-Version"])
    w.check(require_exercised={"/leader/start"})
    with pytest.raises(AssertionError, match="never exercised"):
        w.check(require_exercised={"/leader/start",
                                   "/worker/process-batch"})


def test_protocol_witness_on_a_real_port_node(tmp_path, wire_contract):
    """The witness observes a real port node's exchanges (worker upload,
    a front-door read, a leader-traced worker batch) and the static
    contract explains every one; the traced worker reply echoes the
    trace id."""
    from tests.test_cluster import wait_until
    from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                      LocalCoordination)
    from tfidf_tpu_torch.cluster.node import SearchNode
    from tfidf_tpu_torch.utils.config import Config

    cfg = Config(documents_path=str(tmp_path / "documents"),
                 index_path=str(tmp_path / "index"), port=0,
                 min_doc_capacity=64, min_nnz_capacity=1 << 12,
                 min_vocab_capacity=1 << 10, query_batch=4,
                 max_query_terms=8)
    core = CoordinationCore(session_timeout_s=1.0)
    w = ProtocolWitness(contract=wire_contract)
    with w:
        node = SearchNode(cfg, coord=LocalCoordination(core, 0.1),
                          device="cpu").start()
        try:
            wait_until(lambda: node.is_leader(), timeout=5.0)
            r = urllib.request.urlopen(urllib.request.Request(
                node.url + "/worker/upload?name=d.txt",
                data=b"shared token body",
                headers={"Content-Type": "application/octet-stream"}))
            assert r.status == 200
            r = urllib.request.urlopen(urllib.request.Request(
                node.url + "/leader/start", data=b"token",
                headers={"Content-Type": "text/plain"}))
            assert r.status == 200
            assert r.headers.get("X-Route-Generation") is not None
            req = urllib.request.Request(
                node.url + "/worker/process-batch",
                data=json.dumps({"queries": ["token"], "k": 3}).encode(),
                headers={"Content-Type": "application/json",
                         "X-Trace-Id": "deadbeefdeadbeef",
                         "X-Span-Id": "cafe0123"})
            r = urllib.request.urlopen(req)
            assert r.status == 200
            assert r.headers.get("X-Trace-Id") == "deadbeefdeadbeef"
        finally:
            node.stop()
            core.close()
    rep = w.check(require_exercised={"/leader/start",
                                     "/worker/process-batch"},
                  min_exchanges=3)
    assert any("/worker/process-batch" in k and "(traced)" in k
               for k in rep["exchanges"]), rep
