"""pytest plugin: the port's runtime witnesses over whole test suites.

Load it with ``-p tfidf_tpu_torch.tools.graftcheck.pytest_witness``. Each
witness is keyed on an environment variable of its own; a run without
them is untouched (raw ``threading``, raw numpy, unpatched handlers):

- ``GRAFTCHECK_TORCH_LOCKDEP=1`` runs the selected suite under the
  instrumented Lock (:mod:`.witness`): every lock the port constructs
  during the run is order-tracked, and at session end the observed
  orders must hold no inversion and nothing the static lock graph cannot
  explain, with at least one multi-lock ordering observed.
- ``GRAFTCHECK_TORCH_PROTOCOL=1`` instruments the port's handler classes
  (:mod:`.protocol_witness`): every HTTP exchange a port server answers
  must be explained by the static wire contract, the core
  scatter/mutation rows (``CORE_EXERCISED``) must have been exercised,
  and at least 50 exchanges observed.
- ``GRAFTCHECK_TORCH_DEVICE=1`` runs the suite under the device witness
  (:mod:`.device_witness`; without CUDA every tensor stands in for a
  device tensor): every observed transfer site must be explained by the
  static devicecheck cone, and at least ``GRAFTCHECK_TORCH_DEVICE_MIN``
  (default 1) transfers observed.

A witness sees only its own process. Children are covered where a suite
puts a stub directory first on their ``PYTHONPATH`` and calls
:func:`write_child_hook` on it: the ``sitecustomize.py`` it writes
installs the lockdep and protocol witnesses in each ``python`` child
(:func:`install_in_child`), which writes what it observed at exit into
the session's directory (``GRAFTCHECK_TORCH_CHILD_DIR``); the session
merges every child's report before its check. A child killed with
SIGKILL writes none. A run in which no test ran under a witness that was
asked for fails as vacuous.

``python -m tfidf_tpu_torch.tools.graftcheck --witness
lockdep|protocol|device`` runs pytest with this plugin over the suite
lists below (one process, no xdist: a session fixture on each worker
would split what is observed).
"""

from __future__ import annotations

import atexit
import glob
import importlib
import json
import os
import pkgutil
import shutil
import sys
import tempfile
import types

import pytest

# Suite choice: the suites that run the port's own threads in-process —
# the port fleets (registry, election, scatter, replication, the 1 s
# SIGTERM waits and the ``get_data_if_changed`` followers), the WAL and
# placement state, the segment merge threads on their own stream, the
# tier ring, the mesh ranks and the mixed JAX/port fleet — and the CLI's
# ``python -m tfidf_tpu_torch`` children (``serve`` with its embedded
# coordinator, ``router``), through the child hook. Left out:
# test_torch_graftcheck.py and test_torch_devicecheck.py build witnesses
# of their own (a nested lockdep install patches nothing: the modules
# already hold the outer proxy, so the inner witness would see no lock).
# Every test_torch_chaos_*.py file is in, as the JAX ``make lockdep``
# runs its chaos files: the runner passes ``-m "not slow"``, so their
# ``slow`` jobs (whose SIGKILLed children could leave no report) do not
# run, and their unmarked in-process tests do: the partition file's
# cases of the cluster plane's repairs, the coordinator's WAL recovery,
# the resilience file's re-placement confirm, the compute plane's
# harness. test_torch_state.py's coordinator-ensemble case stays in:
# unlike the Raft tests the JAX target leaves out for their 1 s election
# margins, it waits up to 10 s for its leader, and it passed
# instrumented.
LOCKDEP_SUITES = (
    "tests/test_torch_fleet.py", "tests/test_torch_fleet_segments.py",
    "tests/test_torch_state.py", "tests/test_torch_segments.py",
    "tests/test_torch_tiering.py", "tests/test_torch_mesh.py",
    "tests/test_torch_mesh_engine.py", "tests/test_torch_mesh_ell.py",
    "tests/test_torch_worker.py", "tests/test_torch_surface.py",
    "tests/test_torch_cli.py",
    "tests/test_torch_chaos_autopilot.py",
    "tests/test_torch_chaos_compute.py", "tests/test_torch_chaos_coord.py",
    "tests/test_torch_chaos_hybrid.py",
    "tests/test_torch_chaos_overload.py",
    "tests/test_torch_chaos_partition.py",
    "tests/test_torch_chaos_powerloss.py",
    "tests/test_torch_chaos_rebalance.py",
    "tests/test_torch_chaos_replica.py",
    "tests/test_torch_chaos_resilience.py",
    "tests/test_torch_chaos_router.py", "tests/test_torch_chaos_upgrade.py",
)

# Suite choice: the port fleets (leader scatter, uploads, deletes, R=2
# failover), the surface suite (every route only the JAX tests called:
# the front door, the router tier, the admin planes), the mixed fleet's
# port worker (sparse, dense and hybrid replies) and the CLI's children
# (leader, worker and router processes, through the child hook) together
# drive every CORE_EXERCISED row on port servers. The partition chaos
# file's unmarked cases drive the fence and nemesis wire surface (stale
# epochs refused, deletes and their fences, rejoins), as
# test_partition.py does in the JAX ``make protocol-witness``.
PROTOCOL_SUITES = (
    "tests/test_torch_fleet.py", "tests/test_torch_surface.py",
    "tests/test_torch_worker.py", "tests/test_torch_cli.py",
    "tests/test_torch_chaos_partition.py",
)

# Suite choice: the suites that drive the serving cone on port engines —
# the rebuild engine (searcher dispatch, pipeline dispatch/fetch), the
# streaming segments, the tier's upload ring, the dense plane and the
# compute plane's host mirror. CPU tensors stand in for device tensors.
# test_torch_devicecheck.py is left out: it installs device witnesses of
# its own, and only one may be installed at a time.
DEVICE_SUITES = (
    "tests/test_torch_engine.py", "tests/test_torch_segments.py",
    "tests/test_torch_tiering.py", "tests/test_torch_dense.py",
    "tests/test_torch_compute.py",
)

ENV = {"lockdep": "GRAFTCHECK_TORCH_LOCKDEP",
       "protocol": "GRAFTCHECK_TORCH_PROTOCOL",
       "device": "GRAFTCHECK_TORCH_DEVICE"}
DEVICE_MIN_ENV = "GRAFTCHECK_TORCH_DEVICE_MIN"

CHILD_DIR_ENV = "GRAFTCHECK_TORCH_CHILD_DIR"
# the witnesses a child process installs (the device suites spawn none)
CHILD_WITNESSES = ("lockdep", "protocol")
_CHILD_HOOK = ("from tfidf_tpu_torch.tools.graftcheck.pytest_witness "
               "import install_in_child\ninstall_in_child()\n")

# witness name -> the summary its session fixture wrote (or None when the
# fixture ran but the check raised)
_RAN: dict[str, str | None] = {}


def enabled(name: str) -> bool:
    return os.environ.get(ENV[name]) == "1"


def write_child_hook(stub_dir) -> bool:
    """Write the ``sitecustomize.py`` that installs the session's witnesses
    in every ``python`` child started with ``stub_dir`` first on its
    ``PYTHONPATH``; nothing without a child witness's variable set."""
    if not any(enabled(n) for n in CHILD_WITNESSES):
        return False
    with open(os.path.join(str(stub_dir), "sitecustomize.py"), "w",
              encoding="utf-8") as f:
        f.write(_CHILD_HOOK)
    return True


def install_in_child() -> None:
    """In a child process of a witnessed session: install the lockdep and
    protocol witnesses asked for, and write what they observed into the
    session's directory at exit. Lock names stay creation sites here
    (``path:line``) and protocol checks are the parent's: the child
    builds no static graph or contract, which keeps its boot fast."""
    out = os.environ.get(CHILD_DIR_ENV)
    which = [n for n in CHILD_WITNESSES if enabled(n)]
    if not out or not which:
        return
    import_port()
    stub = types.SimpleNamespace(tree=types.SimpleNamespace(lock_sites={}))
    ws = {}
    if "lockdep" in which:
        from tfidf_tpu_torch.tools.graftcheck.witness import LockdepWitness
        ws["lockdep"] = LockdepWitness(graph=stub).install()
    if "protocol" in which:
        from tfidf_tpu_torch.tools.graftcheck.protocol_witness import (
            ProtocolWitness)
        ws["protocol"] = ProtocolWitness(contract=stub).install()

    def report():
        rep = {"pid": os.getpid(), "argv": sys.argv}
        if "lockdep" in ws:
            w = ws["lockdep"]
            rep["lockdep"] = {
                "edges": [[a, b, n] for (a, b), n in w.edges.items()],
                "inversions": [list(e) for e in w.inversions]}
        if "protocol" in ws:
            rep["protocol"] = [
                [ex.plane, ex.method, ex.path, ex.status,
                 sorted(ex.headers), ex.traced_request, n]
                for ex, n in ws["protocol"].exchanges.items()]
        path = os.path.join(out, f"child-{os.getpid()}.json")
        try:
            with open(path + ".tmp", "w", encoding="utf-8") as f:
                json.dump(rep, f)
            os.replace(path + ".tmp", path)
        except OSError:
            pass    # the session ended first and took its directory

    atexit.register(report)


def _child_reports(name: str) -> list[dict]:
    out = os.environ.get(CHILD_DIR_ENV)
    reps = []
    for path in sorted(glob.glob(os.path.join(out or "", "child-*.json"))):
        with open(path, encoding="utf-8") as f:
            rep = json.load(f)
        if name in rep:
            reps.append(rep)
    return reps


def _merge_lockdep(w, reps) -> None:
    """Children's orderings into ``w``, their creation sites named by the
    session's static graph; an ordering whose reverse any process took
    is an inversion, as inside one process."""
    def named(site: str) -> str:
        rel, _, line = site.rpartition(":")
        if line.isdigit():
            return w.site_map.get((rel, int(line)), site)
        return site
    for rep in reps:
        for a, b, n in rep["lockdep"]["edges"]:
            e = (named(a), named(b))
            first = e not in w.edges
            w.edges[e] = w.edges.get(e, 0) + n
            if first and (e[1], e[0]) in w.edges:
                w.inversions.append(e)
        w.inversions.extend((named(a), named(b))
                            for a, b in rep["lockdep"]["inversions"])


def _merge_protocol(w, reps) -> None:
    for rep in reps:
        for plane, method, path, status, headers, traced, n in \
                rep["protocol"]:
            for _ in range(n):
                w.observe(plane, method, path, status, headers, traced)


@pytest.fixture(scope="session", autouse=True)
def _torch_child_dir():
    """The directory the children of a witnessed session report into."""
    if not any(enabled(n) for n in CHILD_WITNESSES):
        yield
        return
    d = tempfile.mkdtemp(prefix="graftcheck_children_")
    os.environ[CHILD_DIR_ENV] = d
    try:
        yield
    finally:
        shutil.rmtree(d, ignore_errors=True)
        os.environ.pop(CHILD_DIR_ENV, None)


def import_port() -> list[str]:
    """Import every module of the port (its tools excluded): the
    witnesses patch only modules that are already imported."""
    import tfidf_tpu_torch
    names = []
    for m in pkgutil.walk_packages(tfidf_tpu_torch.__path__,
                                   "tfidf_tpu_torch."):
        if m.name.startswith("tfidf_tpu_torch.tools"):
            continue
        importlib.import_module(m.name)
        names.append(m.name)
    return names


@pytest.fixture(scope="session", autouse=True)
def _torch_lockdep_witness(_torch_child_dir):
    if not enabled("lockdep"):
        yield
        return
    from tfidf_tpu_torch.tools.graftcheck.witness import LockdepWitness
    import_port()
    w = LockdepWitness()
    w.install()
    _RAN["lockdep"] = None
    try:
        yield
    finally:
        w.uninstall()
    reps = _child_reports("lockdep")
    _merge_lockdep(w, reps)
    # a witness that observed no multi-lock ordering is a broken witness
    # (proxy bypassed, install ordering drifted), not a clean run
    rep = w.check(min_multilock_edges=1)
    _RAN["lockdep"] = "\n".join(
        [f"lockdep witness: {len(rep['observed_edges'])} multi-lock "
         f"ordering(s) observed, {sum(w.edges.values())} acquisition(s) "
         f"under another lock, {len(reps)} child process(es) merged, 0 "
         f"inversions, all statically explained"]
        + [f"  {e} x{n}" for e, n in rep["observed_edges"].items()])


@pytest.fixture(scope="session", autouse=True)
def _torch_protocol_witness(_torch_child_dir):
    if not enabled("protocol"):
        yield
        return
    from tfidf_tpu_torch.tools.graftcheck.protocol_witness import (
        CORE_EXERCISED, ProtocolWitness)
    import_port()
    w = ProtocolWitness()
    w.install()
    _RAN["protocol"] = None
    try:
        yield
    finally:
        w.uninstall()
    reps = _child_reports("protocol")
    _merge_protocol(w, reps)
    rep = w.check(require_exercised=CORE_EXERCISED, min_exchanges=50)
    _RAN["protocol"] = "\n".join(
        [f"protocol witness: {sum(w.exchanges.values())} exchange(s) "
         f"across {len(rep['paths'])} endpoint(s) observed, "
         f"{len(reps)} child process(es) merged, all explained by the "
         f"static wire contract"]
        + [f"  {k} x{n}" for k, n in rep["exchanges"].items()])


@pytest.fixture(scope="session", autouse=True)
def _torch_device_witness():
    if not enabled("device"):
        yield
        return
    from tfidf_tpu_torch.tools.graftcheck.device_witness import (
        DeviceWitness)
    import_port()
    w = DeviceWitness()
    w.install()
    _RAN["device"] = None
    try:
        yield
    finally:
        w.uninstall()
    w.check(min_observations=int(os.environ.get(DEVICE_MIN_ENV, "1")))
    _RAN["device"] = (w.report()
                      + "\n  all transfer sites statically explained")


def pytest_sessionfinish(session, exitstatus):
    """A witness that was asked for and under which no test ran observed
    nothing: fail the run as vacuous (pytest's own "no tests ran" exit is
    not a witness verdict)."""
    if any(enabled(n) and n not in _RAN for n in ENV):
        session.exitstatus = pytest.ExitCode.TESTS_FAILED


def pytest_terminal_summary(terminalreporter):
    for name in ENV:
        if not enabled(name):
            continue
        if name not in _RAN:
            terminalreporter.write_line(
                f"{name} witness FAILED: vacuous run, no test ran under "
                f"it")
        elif _RAN[name] is not None:
            terminalreporter.write_line(_RAN[name])
