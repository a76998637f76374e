"""The jepsen partition schedule, against port nodes in this process.

A port of ``tests/test_partition.py``'s slow ``TestChaosPartition``: three
port ``CoordinationServer``\\ s in an ensemble (0.4 s elections,
``snapshot_every=128``), three port ``SearchNode``\\ s at R=3 on
``device="cpu"`` with ``CoordinationClient`` factories, and the port's
``global_nemesis``. Under a concurrent upsert/delete/search load the
nemesis (1) deposes the node leader by a control-plane cut, (2) splits the
ensemble, (3) one-way isolates a worker and (4) flaps the full mesh; after
the heal the job requires exact parity with the JAX package's single-node
``_oracle`` over the acked state, zero acked-write loss and zero
stale-epoch writes accepted. The JAX job's sizes, thread count, timings
and assertions are kept line for line.

Every request the job makes goes through the port's transport seams
(``tfidf_tpu_torch.cluster.node.http_post``), so the port's nemesis cuts
the job's own client as the JAX nemesis cuts the JAX job's; a fault armed
on the JAX package's singletons reaches no port node.

The module also holds what the other in-process port chaos jobs share
(``tests/test_torch_chaos_upgrade.py`` imports them): ``port_node``,
``port_cluster`` and ``port_router`` (the port counterparts of
``tests/test_partition.py``'s ``_node`` and ``_mk_cluster`` and of
``tests/test_router.py``'s ``_mk_router``), ``assert_port`` and
``heal_port_faults``, the body of each port chaos file's autouse fixture.
Its tier-1 tests hold that harness: the heal leaves the port's network
nemesis, storage nemesis and fault injector disarmed; the JAX nemesis
leaves a port link up where the port's cuts it; and ``port_node`` without
a device needs the card.

The JAX job fails on its own (ROADMAP queue C item 19): acked writes
lost, a node listed twice, acked deletes back. Each cause is repaired in
the port as a listed deviation (``tests/test_torch_cluster_copy.py``:
``LAST_REPLICA``, ``REJOIN_CLOSE``, ``DELETING``, ``DELETE_FENCE``,
``TOMBSTONE``, ``RESIDUE_AFTER_LOAD``), and each has a tier-1 case here
that drives the JAX package's code and the port's through the same
steps.
"""

import contextlib
import json
import threading
import time

import pytest
import torch

from tests.test_cluster import wait_until
from tests.test_partition import _CFG, _oracle, _parity, _stop_all
from tests.test_router import _CFG as ROUTER_CFG
from tests.test_router import _post_full
from tfidf_tpu.cluster import placement as jax_placement
from tfidf_tpu.cluster.nemesis import global_nemesis as jax_nemesis
from tfidf_tpu.utils.metrics import global_metrics as jax_metrics
from tfidf_tpu_torch.bench import free_ports
from tfidf_tpu_torch.cluster import placement as port_placement
from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  CoordinationCore,
                                                  CoordinationServer,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.nemesis import (NemesisPartitioned,
                                             global_nemesis)
from tfidf_tpu_torch.cluster.node import SearchNode, http_get, http_post
from tfidf_tpu_torch.cluster.router import QueryRouter
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.metrics import global_metrics
from tfidf_tpu_torch.utils.storage import global_storage


# ---------------------------------------------------------------------------
# the shared harness
# ---------------------------------------------------------------------------

def _clean_port_singletons():
    global_nemesis.heal()
    global_storage.heal()
    global_storage.fired.clear()
    global_injector.disarm()
    global_injector.fired.clear()
    global_metrics.reset()


def heal_port_faults():
    """Each port chaos file's autouse fixture (``pytest.fixture(
    autouse=True)(heal_port_faults)``): every test starts and ends with
    the port's network nemesis, storage nemesis and fault injector
    holding no rule and the port's metrics at zero, as
    ``tests/conftest.py`` keeps the JAX package's. A failed test so leaves
    nothing armed for the next file in the same worker, and a counter a
    job reads counts that job alone. The JAX package's singletons of the
    same names are other objects and never reach a port node."""
    _clean_port_singletons()
    yield
    _clean_port_singletons()


_heal_port = pytest.fixture(autouse=True)(heal_port_faults)


def port_node(core, root, i, device=None, **kw):
    """``tests/test_partition.py``'s ``_node`` as a port ``SearchNode``:
    its ``_CFG`` with ``kw`` over it, ``pt<i>`` dirs under ``root``, a
    ``LocalCoordination`` on ``core``. ``device`` is the engine's: None
    is the card, so a CPU run names ``"cpu"``."""
    cfg_kw = dict(_CFG)
    cfg_kw.update(kw)
    cfg = Config(
        documents_path=str(root / f"pt{i}" / "documents"),
        index_path=str(root / f"pt{i}" / "index"),
        port=0, **cfg_kw)
    return SearchNode(cfg, coord=LocalCoordination(core, 0.1),
                      device=device).start()


def port_cluster(core, root, n=3, device=None, **kw):
    """``tests/test_partition.py``'s ``_mk_cluster``: ``n`` port nodes,
    node 0 the leader once it lists the other ``n - 1``."""
    nodes = [port_node(core, root, i, device=device, **kw)
             for i in range(n)]
    wait_until(lambda: len(
        nodes[0].registry.get_all_service_addresses()) == n - 1)
    return nodes


def port_router(core, **kw):
    """``tests/test_router.py``'s ``_mk_router`` as a port
    ``QueryRouter`` (no engine, so no device): that file's ``_CFG``, the
    router cache off unless ``kw`` sets it."""
    cfg_kw = dict(ROUTER_CFG)
    cfg_kw.setdefault("router_cache_entries", 0)
    cfg_kw.update(kw)
    cfg = Config(port=0, **cfg_kw)
    return QueryRouter(cfg, coord=LocalCoordination(core, 0.1)).start()


def assert_port(*objs):
    """Every object is the port's, and so is its coordination client; a
    node's engine runs on the CPU."""
    for o in objs:
        for part in (o, getattr(o, "coord", None)):
            if part is not None:
                assert type(part).__module__.startswith(
                    "tfidf_tpu_torch."), type(part)
        if isinstance(o, SearchNode):
            assert o.engine.device.type == "cpu", o.engine.device


def search(url, q):
    """``/leader/start`` through the port's transport seam."""
    return json.loads(http_post(
        url + "/leader/start", json.dumps({"query": q}).encode()))


def upload_docs(url, docs):
    batch = [{"name": n, "text": t} for n, t in docs.items()]
    return json.loads(http_post(url + "/leader/upload-batch",
                                json.dumps(batch).encode()))


@pytest.fixture
def core():
    c = CoordinationCore(session_timeout_s=0.5)
    yield c
    c.close()


# ---------------------------------------------------------------------------
# tier-1: the harness
# ---------------------------------------------------------------------------

HDOCS = {f"hp{i}.txt": f"common token{i}" for i in range(6)}


class TestPortHarness:
    def test_heal_disarms_all_three_port_singletons(self, request):
        """The fixture's body, run around a test that arms the port's
        network nemesis, storage nemesis and injector and moves a port
        counter, leaves all three disarmed and the counter at zero; the
        fixture is autouse in this file."""
        assert "_heal_port" in request.fixturenames
        body = heal_port_faults()
        next(body)
        global_nemesis.partition(["127.0.0.1:1"], ["127.0.0.1:2"])
        global_storage.arm("fsync_eio", "/nowhere/*")
        global_injector.arm("chaos.harness", action="raise")
        global_metrics.inc("fence_rejections")
        assert global_nemesis.active() and global_storage.active()
        with pytest.raises(Exception):
            global_injector.check("chaos.harness")
        with pytest.raises(StopIteration):
            next(body)
        assert not global_nemesis.active()
        assert not global_storage.active()
        global_injector.check("chaos.harness")    # disarmed: no raise
        assert global_metrics.get("fence_rejections") == 0

    def test_jax_nemesis_leaves_a_port_link_up(self, core, tmp_path):
        """A partition armed on the JAX package's ``global_nemesis``
        between a port leader and its worker leaves the link up (exact,
        unmarked replies); the same partition armed on the port's cuts
        it."""
        nodes = port_cluster(core, tmp_path, n=2, device="cpu",
                             replication_factor=1)
        try:
            assert_port(*nodes)
            leader, worker = nodes
            upload_docs(leader.url, HDOCS)
            health = worker.url + "/api/health"
            body = json.dumps({"query": "common"}).encode()

            def reply():
                st, hd, raw = _post_full(leader.url, "/leader/start", body)
                return st, "X-Scatter-Degraded" in hd, \
                    set(json.loads(raw)) if st == 200 else None

            assert wait_until(lambda: reply() == (200, False, set(HDOCS)),
                              timeout=10.0)
            jax_nemesis.partition([leader.url], [worker.url])
            try:
                assert jax_nemesis.active()
                http_get(health, origin=leader.url)
                assert reply() == (200, False, set(HDOCS))
            finally:
                jax_nemesis.heal()
            global_nemesis.partition([leader.url], [worker.url])
            with pytest.raises(NemesisPartitioned):
                http_get(health, origin=leader.url)
            assert reply() != (200, False, set(HDOCS))
            global_nemesis.heal()
            assert wait_until(lambda: reply() == (200, False, set(HDOCS)),
                              timeout=10.0)
        finally:
            _stop_all(nodes)

    def test_port_node_without_a_device_needs_the_card(self, core,
                                                       tmp_path):
        """No CPU fallback: a port node whose device is not named is
        built on the card, and without CUDA that raises."""
        if torch.cuda.is_available():
            pytest.skip("without device= a node is built on the card, "
                        "which this host has")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_node(core, tmp_path, 0)


# ---------------------------------------------------------------------------
# tier-1: the schedule's faults, each in both packages (ROADMAP queue C)
# ---------------------------------------------------------------------------

def _pkg(pkg):
    """(CoordinationCore, LocalCoordination, SearchNode, Config, the
    placement module) of the JAX package ("jax") or the port."""
    if pkg == "jax":
        from tfidf_tpu.cluster import coordination, node
        from tfidf_tpu.utils.config import Config as JaxConfig
        return (coordination.CoordinationCore,
                coordination.LocalCoordination, node.SearchNode, JaxConfig,
                jax_placement)
    return (CoordinationCore, LocalCoordination, SearchNode, Config,
            port_placement)


def _x_on_a_and_b(pkg, flush_ms=-1.0):
    """A placement map of ``pkg`` with x.txt confirmed on workers A, B."""
    pm = _pkg(pkg)[4].PlacementMap(flush_ms=flush_ms, name="x")
    with pm.lock:
        pm.route_locked("x.txt", ["A", "B"], {"A": 0, "B": 0}, None, 2)
    pm.leg_success("x.txt", "A")
    pm.leg_success("x.txt", "B")
    return pm


@contextlib.contextmanager
def _pair(pkg, root, rejoin=False, **kw):
    """A leader and a worker of ``pkg`` in this process (the port's on
    the CPU) on one coordination core with 0.5 s sessions, each with its
    own session (``rejoin``: through a factory, so it rejoins after an
    expiry). Yields (core, leader, worker)."""
    Core, Local, Node, Cfg, _ = _pkg(pkg)
    core = Core(session_timeout_s=0.5)
    dev = {} if pkg == "jax" else {"device": "cpu"}
    nodes = []
    try:
        for i in range(2):
            cfg = Cfg(documents_path=str(root / f"two{i}" / "docs"),
                      index_path=str(root / f"two{i}" / "index"),
                      port=0, min_doc_capacity=64,
                      min_nnz_capacity=1 << 12, min_vocab_capacity=1 << 10,
                      query_batch=4, max_query_terms=8, **kw)
            coord = ({"coord_factory": lambda: Local(core, 0.1)} if rejoin
                     else {"coord": Local(core, 0.1)})
            nodes.append(Node(cfg, **coord, **dev).start())
        leader, worker = nodes
        assert wait_until(lambda: leader.registry
                          .get_all_service_addresses() == [worker.url])
        yield core, leader, worker
    finally:
        _stop_all(nodes)
        core.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_last_replica_loss_keeps_the_earlier_copy(pkg):
    """The schedule's acked-write loss, on one placement map: a name on
    workers A and B; A's session blips (its copy scheduled away, B keeps
    the name), then B's (the name loses its last replica and the re-place
    finds no worker). The port cancels A's pending delete, so A's copy,
    back in the registry, is adopted as an orphan. The JAX package keeps
    the delete pending: a rejoined A deletes its copy, and B's surviving
    copy reads as a ghost and is scheduled away too (``LAST_REPLICA``)."""
    pm = _x_on_a_and_b(pkg)
    assert pm.drop_worker("A") == (["x.txt"], [])
    assert pm.drop_worker("B") == ([], ["x.txt"])
    pending = {w: set(ns) for w, ns in pm.pending_moved().items()}
    got_a = pm.reconcile_residue("A", ["x.txt"], set())
    got_b = pm.reconcile_residue("B", ["x.txt"], set())
    if pkg == "port":
        assert pending == {}
        assert got_a == ([], ["x.txt"])     # A's copy adopted
        assert got_b == (["x.txt"], [])     # B's is the extra copy
        assert pm.holders_of("x.txt") == ("A",)
    else:
        assert pending == {"A": {"x.txt"}}
        assert got_a == ([], []) and got_b == (["x.txt"], [])
        assert pm.holders_of("x.txt") == ()


def test_delete_after_last_replica_loss_reaches_every_copy():
    """The other half of the repair above: a client delete of a name that
    lost its last replica, while no worker is live, still schedules the
    delete on both holders (the map remembers them), so neither copy is
    adopted back when its worker returns."""
    pm = _x_on_a_and_b("port")
    pm.drop_worker("A")
    pm.drop_worker("B")
    scheduled = pm.forget(["x.txt"], also=set())
    assert {w: sorted(ns) for w, ns in scheduled.items()} == {
        "A": ["x.txt"], "B": ["x.txt"]}
    assert pm.reconcile_residue("A", ["x.txt"], set()) == ([], [])
    assert pm.reconcile_residue("B", ["x.txt"], set()) == ([], [])
    assert pm.holders_of("x.txt") == ()
    pm.moved_resolved("A", {"x.txt"})
    pm.moved_resolved("B", {"x.txt"})
    assert pm.pending_moved() == {} and pm.forget(["x.txt"]) == {}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_load_during_a_delete_flush_keeps_the_name_deleted(pkg):
    """The schedule's resurrected delete, on one map: a client delete
    forgets a name whose durable flush is still on the wire (an ensemble
    split held it for seconds) while the residue pass finds the leader's
    own copy and this node, re-elected, loads the durable map. The port
    maps the name nowhere until the flush returns; the JAX package
    re-places the own copy and merges the name back, and the flush then
    writes it back (``DELETING``, ``TOMBSTONE``)."""
    Core, Local = _pkg(pkg)[:2]
    core = Core(session_timeout_s=30.0)
    coord = Local(core, 1.0)
    try:
        pm = _x_on_a_and_b(pkg, flush_ms=0.0)
        pm.bind_store(lambda: coord)
        pm.set_persist_enabled(True)
        assert pm.flush()
        assert set(pm.forget(["x.txt"])) == {"A", "B"}
        # the delete's flush not yet landed: the workers confirm their
        # deletes, the leader's own engine still holds a copy, a load runs
        pm.moved_resolved("A", {"x.txt"})
        pm.moved_resolved("B", {"x.txt"})
        own_engine = pm.unplaced_of(["x.txt"], set())
        pm.load()
        if pkg == "jax":
            assert own_engine == ["x.txt"]          # re-placed
            assert pm.holders_of("x.txt") == ("A", "B")
            return
        assert own_engine == []
        assert pm.holders_of("x.txt") == ()
        assert pm.reconcile_residue("A", ["x.txt"], set()) == (
            ["x.txt"], [])                          # a ghost, not adopted
        assert pm.flush()
        pm.delete_settled(["x.txt"])
        pm.load()
        assert pm.holders_of("x.txt") == ()
    finally:
        coord.close()
        core.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_copy_of_a_deleted_name_found_later_is_a_ghost(pkg):
    """The schedule's next resurrected delete, on one map: a delete lands
    on every live holder, and a copy turns up afterwards, in the engine
    of an ex-leader that was away (C). The port calls it a ghost to
    delete; the JAX package re-places it from the leader's own engine, or
    adopts it from a worker (``TOMBSTONE``)."""
    pm = _x_on_a_and_b(pkg)
    assert set(pm.forget(["x.txt"], also={"A", "B"})) == {"A", "B"}
    pm.moved_resolved("A", {"x.txt"})
    pm.moved_resolved("B", {"x.txt"})
    if pkg == "port":
        pm.delete_settled(["x.txt"])
    own_engine = pm.unplaced_of(["x.txt"], set())
    found = pm.reconcile_residue("C", ["x.txt"], set())
    if pkg == "jax":
        assert own_engine == ["x.txt"] and found == ([], ["x.txt"])
        return
    assert own_engine == [] and found == (["x.txt"], [])
    # a new upload of the name lifts the tombstone: its failed leg leaves
    # the name unmapped and pending nowhere, so an own copy is re-placed
    pm.moved_resolved("C", {"x.txt"})
    with pm.lock:
        pm.route_locked("x.txt", ["A"], {"A": 0}, None, 1)
    pm.leg_failure("x.txt", "A")
    assert pm.unplaced_of(["x.txt"], set()) == ["x.txt"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_residue_pass_waits_for_the_new_leaders_load(pkg, tmp_path):
    """A new leader's residue pass can run before its map is loaded: on
    the empty map every copy a worker holds reads as an orphan (in the
    schedule, a deleted name's leftover among them). The port's pass waits
    for the load; the JAX package's adopts them all
    (``RESIDUE_AFTER_LOAD``)."""
    with _pair(pkg, tmp_path, replication_factor=1,
               residue_sweep_ms=-1.0) as (_core, leader, _worker):
        upload_docs(leader.url, {"left.txt": "common left"})
        assert wait_until(lambda: leader.placement._persist_enabled)
        # the state of a just-promoted leader before its load
        leader.placement.reset_for_follower()
        leader.placement.set_persist_enabled(False)
        early = leader.run_residue_reconcile()
        if pkg == "jax":
            assert early == {"ghosts": 0, "orphans": 1}
            return
        assert early == {} and leader.placement.holders_of("left.txt") == ()
        leader.placement.set_persist_enabled(True)     # the load is done
        assert leader.run_residue_reconcile() == {"ghosts": 0, "orphans": 1}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_delete_is_not_acked_by_a_leader_deposed_during_its_flush(
        pkg, tmp_path):
    """The schedule's other resurrected delete, on two nodes: the
    leader's session expires while a client delete's durable flush is on
    the wire, so the worker is elected and may load the map before the
    flush lands. The port refuses the ack; the JAX package acks a delete
    its successor may never see (``DELETE_FENCE``)."""
    with _pair(pkg, tmp_path, replication_factor=1,
               placement_flush_ms=10.0) as (core, leader, worker):
        upload_docs(leader.url, {"gone.txt": "common gone"})
        flush = leader._delete_flush_ok

        def flush_then_deposed():
            ok = flush()
            core.expire_session(leader.coord.sid)
            assert wait_until(lambda: worker.is_leader(), timeout=10.0)
            return ok
        leader._delete_flush_ok = flush_then_deposed
        if pkg == "jax":
            leader.leader_delete(["gone.txt"])       # acked
        else:
            with pytest.raises(RuntimeError, match="leadership was lost"):
                leader.leader_delete(["gone.txt"])


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_failed_rejoin_attempt_leaves_no_second_registration(pkg, tmp_path):
    """The schedule's stuck convergence, on two nodes: a worker's session
    expires and its first rejoin attempt fails after its fresh session
    volunteered and registered. The port closes that attempt's session,
    so the next attempt leaves the worker listed once and two election
    candidates. The JAX package leaves the attempt's session open: its
    heartbeat keeps the second registration and the orphan candidate
    alive (``REJOIN_CLOSE``)."""
    with _pair(pkg, tmp_path, rejoin=True) as (core, leader, worker):
        on_worker = worker.on_worker
        failed = []

        def fail_first_rejoin():
            on_worker()
            if not failed:
                failed.append(True)
                raise RuntimeError("the first rejoin attempt fails")
        worker.on_worker = fail_first_rejoin
        metrics = jax_metrics if pkg == "jax" else global_metrics
        rejoins = metrics.get("session_rejoins")
        core.expire_session(worker.coord.sid)
        # the second attempt is through, then three session timeouts:
        # a closed attempt's ephemerals are gone by now
        assert wait_until(lambda: failed and metrics.get(
            "session_rejoins") > rejoins, timeout=10.0)
        time.sleep(1.5)

        def listed():
            return leader.registry.get_all_service_addresses()
        want = 1 if pkg == "port" else 2
        assert wait_until(lambda: listed() == [worker.url] * want,
                          timeout=10.0), listed()
        assert len(core.get_children(0, "/election")) == 1 + want


# ---------------------------------------------------------------------------
# the jepsen-style chaos schedule (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
class TestChaosPartition:
    @pytest.mark.timeout(420)
    def test_jepsen_schedule_converges_exactly(self, tmp_path):
        """Concurrent upsert/delete/search workload while the port's
        nemesis (1) deposes the node leader (control-plane cut), (2)
        splits the 3-member coordinator ensemble, (3) one-way isolates a
        worker, and (4) flaps the full mesh — then heals and asserts
        exact single-node-oracle parity, zero acked-write loss, zero
        stale-epoch writes accepted."""
        ports = free_ports(3)
        peers = {f"c{i}": f"127.0.0.1:{p}" for i, p in enumerate(ports)}
        servers = {}
        for i, p in enumerate(ports):
            servers[f"c{i}"] = CoordinationServer(
                host="127.0.0.1", port=p, session_timeout_s=1.0,
                data_dir=str(tmp_path / f"c{i}"), node_id=f"c{i}",
                peers=dict(peers), election_timeout_s=0.4,
                heartbeat_interval_s=0.1, commit_timeout_s=3.0,
                snapshot_every=128).start()
        connect = ",".join(peers.values())
        nodes = []
        threads = []
        stop_flag = threading.Event()
        lock = threading.Lock()
        acked: dict[str, str] = {}      # name -> text (200-acked state)
        ambiguous: set[str] = set()     # failed ops: either outcome ok
        deleted: set[str] = set()
        try:
            def factory():
                return CoordinationClient(connect,
                                          heartbeat_interval_s=0.2,
                                          failover_deadline_s=2.0)

            for i in range(3):
                cfg = Config(
                    documents_path=str(tmp_path / f"ch{i}" / "documents"),
                    index_path=str(tmp_path / f"ch{i}" / "index"),
                    port=0, session_timeout_s=1.0, **{
                        **_CFG, "replication_factor": 3,
                        "rpc_max_attempts": 2,
                        "residue_sweep_ms": 1000.0})
                nodes.append(SearchNode(cfg, coord=factory(),
                                        coord_factory=factory,
                                        device="cpu").start())
            assert_port(*nodes, *servers.values())
            assert wait_until(lambda: nodes[0].is_leader(), timeout=20)
            assert wait_until(lambda: len(
                nodes[0].registry.get_all_service_addresses()) == 2,
                timeout=20)

            def leader_url():
                for n in nodes:
                    if n._role == "leader":
                        return n.url
                return nodes[0].url

            # during schedule 1 a deposed-but-undemoted leader can still
            # ACK writes whose placement never reaches the durable map;
            # the workload quiesces its WRITES for that window (searches
            # keep running), as the JAX job does
            writes_ok = threading.Event()
            writes_ok.set()

            def workload(wid: int) -> None:
                k = 0
                while not stop_flag.is_set():
                    k += 1
                    name = f"w{wid}_{k}.txt"
                    # bucket tokens keep parity-query match sets well
                    # under top_k (the oracle comparison never cuts a tie)
                    text = (f"shared uniq{wid}x{k} cycle{k % 4} "
                            f"bucket{k % 29}")
                    try:
                        if not writes_ok.is_set():
                            search(leader_url(), "shared")
                            time.sleep(0.05)
                            continue
                        if k % 7 == 6:
                            # idempotent upsert of one of THIS thread's
                            # acked docs with its own text
                            with lock:
                                done = [(n, t) for n, t in acked.items()
                                        if n not in deleted
                                        and n.startswith(f"w{wid}_")]
                            if done:
                                n0, t0 = done[k % len(done)]
                                json.loads(http_post(
                                    leader_url() + "/leader/upload-batch",
                                    json.dumps([{"name": n0,
                                                 "text": t0}]).encode(),
                                    timeout=10.0))
                        elif k % 5 == 4:
                            with lock:
                                cands = [n for n in acked
                                         if n not in deleted
                                         and n.startswith(f"w{wid}_")]
                            if cands:
                                victim = cands[wid % len(cands)]
                                with lock:
                                    ambiguous.add(victim)
                                json.loads(http_post(
                                    leader_url() + "/leader/delete",
                                    json.dumps(
                                        {"names": [victim]}).encode(),
                                    timeout=10.0))
                                with lock:
                                    deleted.add(victim)
                                    ambiguous.discard(victim)
                        else:
                            with lock:
                                ambiguous.add(name)
                            r = json.loads(http_post(
                                leader_url() + "/leader/upload-batch",
                                json.dumps([{"name": name,
                                             "text": text}]).encode(),
                                timeout=10.0))
                            with lock:
                                if name not in r.get("failed", ()):
                                    acked[name] = text
                                ambiguous.discard(name)
                        search(leader_url(), "shared")
                    except Exception:
                        pass       # failed op: stays ambiguous
                    time.sleep(0.05)

            threads = [threading.Thread(target=workload, args=(i,),
                                        daemon=True) for i in range(3)]
            for t in threads:
                t.start()
            time.sleep(1.0)

            # ---- schedule 1: depose the node leader (control cut) ----
            writes_ok.clear()          # quiesce workload writes (the
            time.sleep(0.3)            # in-flight ones drain)
            old = next(n for n in nodes if n._role == "leader")
            coord_eps = list(peers.values())
            global_nemesis.partition([old.url], coord_eps)
            new = None

            def promoted():
                nonlocal new
                for n in nodes:
                    if n is not old and n._role == "leader":
                        new = n
                        return True
                return False

            assert wait_until(promoted, timeout=30)
            # fence the workers forward, then drive a write through the
            # DEPOSED leader: it must be rejected, never acked
            upload_docs(new.url, {"fencer.txt": "shared fencer"})
            with lock:
                acked["fencer.txt"] = "shared fencer"
            with pytest.raises(Exception):
                http_post(old.url + "/leader/upload?name=brain.txt",
                          b"splitbrain token", timeout=30.0)
            assert global_metrics.get("fence_rejections") >= 1
            global_nemesis.heal()
            assert wait_until(lambda: len(
                new.registry.get_all_service_addresses()) == 2,
                timeout=40)
            writes_ok.set()            # schedule 1 over: writes resume

            # ---- schedule 2: split the coordinator ensemble ----
            coord_leader = next(
                (nid for nid, s in servers.items()
                 if s.ensemble.is_leader()), None)
            if coord_leader is not None:
                others = [a for nid, a in peers.items()
                          if nid != coord_leader]
                global_nemesis.partition([peers[coord_leader]], others)
                time.sleep(3.0)     # a new coord leader forms; clients
                global_nemesis.heal()   # fail over through the string
                time.sleep(1.0)

            # ---- schedule 3: one-way isolate a worker ----
            cur = next(n for n in nodes if n._role == "leader")
            ws = cur.registry.get_all_service_addresses()
            if ws:
                global_nemesis.one_way(cur.url, ws[0])
                time.sleep(2.0)
                global_nemesis.heal()

            # ---- schedule 4: flap the full mesh ----
            everything = [n.url for n in nodes] + coord_eps
            for _ in range(3):
                global_nemesis.isolate(everything)
                time.sleep(0.3)
                global_nemesis.heal()
                time.sleep(0.3)

            stop_flag.set()
            for t in threads:
                t.join(timeout=15)

            # ---- converge, then verify ----
            def settled_leader():
                live = [n for n in nodes if n._role == "leader"]
                return live[0] if len(live) == 1 else None

            assert wait_until(
                lambda: settled_leader() is not None, timeout=60)
            fin = settled_leader()
            assert wait_until(lambda: len(
                fin.registry.get_all_service_addresses()) == 2,
                timeout=60)

            with lock:
                must_have = {n: t for n, t in acked.items()
                             if n not in deleted and n not in ambiguous}
                must_not = {n for n in deleted if n not in ambiguous}
                amb = set(ambiguous)

            # per-doc presence via each doc's unique token
            def uniq_token(name):
                if not name.startswith("w"):
                    return "fencer"          # the schedule-1 probe doc
                wid, k = name[1:-4].split("_")
                return f"uniq{wid}x{k}"

            def converged():
                try:
                    url = settled_leader().url
                    for n in must_have:
                        if n not in search(url, uniq_token(n)):
                            return False
                    for n in must_not:
                        if n in search(url, uniq_token(n)):
                            return False
                    return True
                except Exception:
                    return False

            def forensics():
                out = {"missing": [n for n in must_have
                                   if n not in search(
                                       fin.url, uniq_token(n))][:10],
                       "resurrected": {}}
                for n in must_not:
                    if n not in search(fin.url, uniq_token(n)):
                        continue
                    holders = []
                    for nd in nodes:
                        try:
                            hits = json.loads(http_post(
                                nd.url + "/worker/process",
                                uniq_token(n).encode()))
                            if any(h["document"]["name"] == n
                                   for h in hits):
                                holders.append(nd.url)
                        except Exception:
                            pass
                    out["resurrected"][n] = {
                        "engines": holders,
                        "map": fin.placement.holders_of(n),
                        "pending": {w: (n in ns) for w, ns in
                                    fin.placement.pending_moved()
                                    .items()}}
                return out

            assert wait_until(converged, timeout=120,
                              interval=0.5), forensics()
            # zero acked-write loss pinned above; zero stale writes:
            assert search(fin.url, "splitbrain") == {}

            # exact oracle parity over the discovered final doc set
            final_docs = dict(must_have)
            for name in amb:
                if name in deleted:
                    continue
                hit = search(fin.url, uniq_token(name))
                if name in hit:
                    wid, k = name[1:-4].split("_")
                    final_docs[name] = (
                        f"shared uniq{wid}x{k} cycle{int(k) % 4} "
                        f"bucket{int(k) % 29}")
            final_docs["fencer.txt"] = "shared fencer"
            queries = ["bucket1", "bucket7", "bucket3 bucket11",
                       "fencer"]
            want = _oracle(tmp_path, final_docs, queries)

            def parity():
                try:
                    url = settled_leader().url
                    return all(_parity(search(url, q), want[q])
                               for q in queries)
                except Exception:
                    return False

            def diffs():
                out = {}
                for q in queries:
                    got = search(fin.url, q)
                    w = want[q]
                    if _parity(got, w):
                        continue
                    out[q] = {
                        "sizes": (len(got), len(w)),
                        "extra": sorted(set(got) - set(w))[:6],
                        "missing": sorted(set(w) - set(got))[:6],
                        "score_mismatch": [
                            (k, got[k], w[k]) for k in got
                            if k in w and abs(got[k] - w[k]) >= 1e-4][:6]}
                return out

            assert wait_until(parity, timeout=120, interval=0.5), diffs()
        finally:
            stop_flag.set()
            global_nemesis.heal()
            for t in threads:
                t.join(timeout=15)
            _stop_all(nodes)
            for s in servers.values():
                try:
                    s.close()
                except Exception:
                    pass
