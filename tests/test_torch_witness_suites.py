"""The port's witness plugin (``tfidf_tpu_torch.tools.graftcheck.
pytest_witness``) and its runner, on seeded modules.

Each case is a pytest subprocess over one module of
``tests/data/torch_graftcheck/witness_suites/`` with the plugin loaded
and one witness's variable set, the way ``python -m
tfidf_tpu_torch.tools.graftcheck --witness lockdep|protocol|device`` runs
its suite lists. For each witness:

* a clean module of real port code passes and prints a report that is
  not vacuous (lockdep: a multi-lock ordering; protocol: at least 50
  exchanges over every ``CORE_EXERCISED`` row; device: a transfer at an
  explained site);
* a seeded bad case fails: an inversion, an exchange off the static wire
  contract, a transfer at an unexplained site;
* an empty selection fails as vacuous.

A child ``python`` started with the plugin's child hook reports into the
session, which merges it. Without any variable the plugin installs
nothing and writes no child hook. The witnesses' own repairs are held
here too: a closure inside a sanctioned stage is named by that stage, and
the host fallback is in the static cone.
"""

import glob
import os
import re
import subprocess
import sys

import pytest

from tfidf_tpu_torch.tools.graftcheck import pytest_witness as pw
from tfidf_tpu_torch.tools.graftcheck.protocol_witness import CORE_EXERCISED

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(ROOT, "tests", "data", "torch_graftcheck",
                     "witness_suites")
PLUGIN = "tfidf_tpu_torch.tools.graftcheck.pytest_witness"


def run_case(module, witness=None, *extra):
    """pytest over one seeded module with the plugin, under ``witness``
    (None: no variable set). Returns (exit code, output)."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("GRAFTCHECK_TORCH_")}
    env["PYTHONPATH"] = ROOT
    env["JAX_PLATFORMS"] = "cpu"
    if witness is not None:
        env[pw.ENV[witness]] = "1"
    r = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(CASES, module + ".py"),
         "-q", "-p", "no:cacheprovider", "--noconftest", "-p", "no:xdist",
         "-p", PLUGIN, *extra],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout + r.stderr


def count(pattern, out):
    m = re.search(pattern, out)
    assert m, out[-3000:]
    return int(m.group(1))


# (witness, clean module, bad module, what the bad case must report,
#  the report's count in a clean run, its floor)
WITNESSES = {
    "lockdep": ("lockdep_clean", "lockdep_inversion", "lock-order inversions",
                r"lockdep witness: (\d+) multi-lock ordering", 1),
    "protocol": ("protocol_clean", "protocol_unexplained",
                 r"exchange not explained by the static contract: "
                 r"GET /seeded/off-route -> 200",
                 r"protocol witness: (\d+) exchange", 50),
    "device": ("device_clean", "device_unexplained",
               r"transfer site\(s\) the static cone did not explain\S* "
               r".*engine\.seeded\.leak \[item\]",
               r"device witness: (\d+) tensor transfer", 1),
}


@pytest.mark.parametrize("witness", sorted(WITNESSES))
def test_clean_module_passes_with_a_report(witness):
    clean, _bad, _why, pattern, floor = WITNESSES[witness]
    rc, out = run_case(clean, witness)
    assert rc == 0, out[-3000:]
    assert count(pattern, out) >= floor
    if witness == "protocol":
        for path in sorted(CORE_EXERCISED):
            assert f" {path} -> 200" in out, (path, out[-3000:])


@pytest.mark.parametrize("witness", sorted(WITNESSES))
def test_seeded_bad_case_fails(witness):
    _clean, bad, why, _pattern, _floor = WITNESSES[witness]
    rc, out = run_case(bad, witness)
    assert rc != 0, out[-3000:]
    assert re.search(why, out), out[-3000:]
    # the seeded module's own test passed: the witness failed the run
    assert "1 passed, 1 error" in out, out[-3000:]


@pytest.mark.parametrize("witness", sorted(WITNESSES))
def test_empty_selection_fails_as_vacuous(witness):
    clean = WITNESSES[witness][0]
    rc, out = run_case(clean, witness, "-k", "no_test_is_named_so")
    assert rc == 1, out[-3000:]
    assert f"{witness} witness FAILED: vacuous run" in out


@pytest.mark.parametrize("witness", pw.CHILD_WITNESSES)
def test_child_reports_are_merged(witness):
    """The clean module runs in a child ``python`` started with the child
    hook first on its ``PYTHONPATH``; the session observes nothing itself
    and passes on the child's report alone."""
    pattern, floor = WITNESSES[witness][3:]
    rc, out = run_case("in_child", witness)
    assert rc == 0, out[-3000:]
    assert "1 child process(es) merged" in out, out[-3000:]
    assert count(pattern, out) >= floor


def test_plain_run_installs_nothing():
    rc, out = run_case("untouched")
    assert rc == 0, out[-3000:]
    assert "witness" not in out


def test_runner_names_each_suite_list():
    """The runner's lists name suites that exist, and leave out the ones
    that build their own witnesses."""
    lists = (pw.LOCKDEP_SUITES, pw.PROTOCOL_SUITES, pw.DEVICE_SUITES)
    for suites in lists:
        assert suites
        for path in suites:
            assert os.path.isfile(os.path.join(ROOT, path)), path
            assert not path.endswith(("test_torch_graftcheck.py",
                                      "test_torch_devicecheck.py"))


def test_the_chaos_suites_are_witnessed():
    """Every chaos file's unmarked tests run under the lock witness, and
    the partition file's under the protocol witness, as the JAX targets
    run their chaos files (the runner's ``-m "not slow"`` keeps the
    ``slow`` jobs out)."""
    chaos = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
        os.path.join(ROOT, "tests", "test_torch_chaos_*.py")))
    assert len(chaos) >= 12
    assert set(chaos) <= set(pw.LOCKDEP_SUITES)
    assert "tests/test_torch_chaos_partition.py" in pw.PROTOCOL_SUITES


def test_closure_in_a_sanctioned_stage_is_named_by_the_stage(tmp_path):
    """``ShardIndex.export_snapshot_arrays`` (a bulk stage) fetches through
    a local helper; the device witness names that transfer by the stage,
    the unit the static cone explains (a closure's own name is explained
    by nothing)."""
    from tfidf_tpu_torch.engine.engine import Engine
    from tfidf_tpu_torch.tools.graftcheck.device_witness import (
        DeviceWitness)
    from tfidf_tpu_torch.utils.config import Config
    e = Engine(Config(documents_path=str(tmp_path / "docs"),
                      min_doc_capacity=8, min_nnz_capacity=256,
                      min_vocab_capacity=64, embedding_enabled=False),
               device="cpu")
    e.ingest_text("a.txt", "alpha beta")
    e.commit()
    w = DeviceWitness(cpu_tensors=True)
    w.install()
    try:
        assert e.index.export_snapshot_arrays() is not None
    finally:
        w.uninstall()
    assert {(m, f) for m, f, _op in w.observed} == {
        ("engine.index", "export_snapshot_arrays")}
    w.check(min_observations=1)


def test_host_fallback_is_in_the_static_cone():
    """The host fallback serves while the device is sick: its entry
    points are cone roots, and its one host-tensor read is pinned."""
    from tfidf_tpu_torch.tools.graftcheck import devicecheck
    from tfidf_tpu_torch.tools.graftcheck.core import (SourceTree,
                                                       load_allowlist)
    for root in ("engine.compute_health.HostFallbackScorer.search",
                 "engine.compute_health.HostFallbackScorer.search_arrays"):
        assert root in devicecheck.CONE_ROOTS
    dc = devicecheck._DeviceCheck(SourceTree(ROOT))
    assert "engine.compute_health._compile_queries_host" in dc.cone()
    assert ("engine.compute_health", "_compile_queries_host") in \
        devicecheck.explained_transfer_sites(SourceTree(ROOT))
    assert "host" in load_allowlist()[
        "devicecheck:transfer:engine.compute_health._compile_queries_host"
        ":numpy"].lower()
