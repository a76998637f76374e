"""State carried across the packages: the system's counterpart of weights.

The cluster keeps no model; what a deployment carries across a restart or
an upgrade is the coordination service's durable WAL and snapshot files
(``cluster/wal.py``), the placement map persisted as a znode
(``cluster/placement.py``) and the workers' checkpoints (held both ways by
``tests/test_torch_checkpoint.py``). Here, on the CPU:

* a ``DurableStore`` directory, and a durable ``CoordinationServer``'s
  data directory, written by one package load in the other to the same
  entries, snapshot, meta and znode tree (exact);
* ``PlacementMap`` serialises the same map to the same bytes in both
  packages (exact);
* after a JAX leader that placed documents stops, a port node is elected
  and loads the placement znode the JAX leader wrote (the same replica
  tuples), and answers the JAX fleet's queries as the oracle does (rel
  1e-5, R = 2 over the worker that remains).
"""

import json

import pytest

from tests.test_cluster import wait_until
from tests.test_hybrid import DOCS, QUERIES
from tests.test_replication import _CFG, _oracle, _stop_all
from tests.test_torch_fleet import assert_close, port_node, search, upload
from tfidf_tpu.cluster import coordination as jax_coord
from tfidf_tpu.cluster import placement as jax_placement
from tfidf_tpu.cluster import wal as jax_wal
from tfidf_tpu.cluster.node import SearchNode as JaxNode
from tfidf_tpu.utils.config import Config as JaxConfig
from tfidf_tpu_torch.cluster import coordination as port_coord
from tfidf_tpu_torch.cluster import placement as port_placement
from tfidf_tpu_torch.cluster import wal as port_wal

PKGS = {"jax": (jax_wal, jax_coord, jax_placement),
        "port": (port_wal, port_coord, port_placement)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_durable_store_moves_between_packages(tmp_path, src, dst):
    wal_a, wal_b = PKGS[src][0], PKGS[dst][0]
    st = wal_a.DurableStore(str(tmp_path))
    entries = [{"i": i + 1, "t": 3, "c": {"op": "create", "n": i}}
               for i in range(9)]
    st.append(entries[:5])
    st.save_snapshot({"next_sid": 4, "tree": {"/a": "x"}, "sessions": {}},
                     5, 3, entries[5:])
    st.set_meta(3, "c1")
    st.close()
    want = wal_a.DurableStore(str(tmp_path)).load()
    got = wal_b.DurableStore(str(tmp_path)).load()
    assert got == want
    meta, snap, tail = got
    assert meta == {"term": 3, "voted_for": "c1"}
    assert snap["last_index"] == 5 and [e["i"] for e in tail] == [6, 7, 8, 9]


@pytest.mark.parametrize("src,dst", DIRECTIONS)
def test_coordinator_data_dir_moves_between_packages(tmp_path, src, dst):
    """A durable coordinator of one package stops; one of the other
    package recovers the same znode tree from its data directory."""
    coord_a, coord_b = PKGS[src][1], PKGS[dst][1]
    data = str(tmp_path / "coord")
    srv = coord_a.CoordinationServer(host="127.0.0.1", port=0,
                                     session_timeout_s=30.0, data_dir=data,
                                     snapshot_every=5).start()
    cli = coord_a.CoordinationClient(srv.address, heartbeat_interval_s=1.0)
    try:
        cli.create("/app", b"root")
        cli.create("/app/cfg", b"v1")
        cli.set_data("/app/cfg", b"v2")
        for i in range(8):
            cli.create(f"/app/item{i}", str(i).encode())
        cli.delete("/app/item3")
        want = srv.core.state_snapshot()
    finally:
        cli.close()
        srv.kill()
    srv2 = coord_b.CoordinationServer(host="127.0.0.1", port=0,
                                      session_timeout_s=30.0,
                                      data_dir=data).start()
    try:
        assert wait_until(lambda: srv2.ensemble.is_leader(), timeout=10.0)
        got = srv2.core.state_snapshot()
        assert got["tree"] == want["tree"]
        cli2 = coord_b.CoordinationClient(srv2.address,
                                          heartbeat_interval_s=1.0)
        try:
            assert cli2.get_data("/app/cfg") == b"v2"
            assert not cli2.exists("/app/item3")
        finally:
            cli2.close()
    finally:
        srv2.close()


def _fill(pm):
    live = {"http://a": 0, "http://b": 0, "http://c": 0}
    with pm.lock:
        for i in range(12):
            pm.route_locked(f"doc{i}", list(live), dict(live), None, 2)
        pm.route_locked("ghost", list(live), dict(live), None, 1)
    for i in range(12):
        for w in pm.holders_of(f"doc{i}"):
            pm.leg_success(f"doc{i}", w)
    pm.note_moved(["doc1", "doc2"], "http://dead")
    pm.epoch = 7


def test_placement_map_serialises_to_the_same_bytes():
    maps = [pkg[2].PlacementMap(flush_ms=0.0) for pkg in PKGS.values()]
    for pm in maps:
        _fill(pm)
    blobs = []
    for pm in maps:
        with pm.lock:
            blobs.append(pm._serialize_locked())
    assert blobs[0] == blobs[1]
    state = json.loads(blobs[0])
    assert "ghost" not in state["replicas"] and state["epoch"] == 7


@pytest.mark.parametrize("leader_pkg,server_pkg,follower_pkg", [
    ("port", "port", "port"), ("jax", "jax", "port"),
    ("port", "port", "jax"), ("jax", "port", "port")])
def test_follower_reads_placement_only_when_changed(leader_pkg, server_pkg,
                                                    follower_pkg):
    """A port placement follower re-reads the znode only when it changed:
    against a port coordination server an unchanged map comes back as
    ``unchanged``; a JAX server, which does not know the conditional
    read, sends the data, and a JAX follower over a port server reads as
    it always did. Every view equals the leader's map after each flush."""
    server = PKGS[server_pkg][1].CoordinationServer(
        host="127.0.0.1", port=0, session_timeout_s=5.0).start()
    clients = []
    try:
        def client(pkg):
            c = PKGS[pkg][1].CoordinationClient(server.address,
                                                heartbeat_interval_s=0.2)
            clients.append(c)
            return c

        wc, fc = client(leader_pkg), client(follower_pkg)
        replies = []
        rpc = fc._rpc

        def recording(req, *a, **kw):
            out = rpc(req, *a, **kw)
            if req.get("op") == "get_data":
                replies.append(sorted(out))
            return out
        fc._rpc = recording
        pm = PKGS[leader_pkg][2].PlacementMap(flush_ms=0.0, name="auth")
        pm.bind_store(lambda: wc)
        pm.set_persist_enabled(True)
        _fill(pm)
        assert pm.flush()
        f = PKGS[follower_pkg][2].PlacementFollower(refresh_ms=60_000.0,
                                                    stale_ms=0.0)
        f.bind_store(lambda: fc)
        for step in range(3):
            assert f.refresh() and f.refresh()
            assert f.version == step + 1
            with pm.lock:
                assert f.replicas == {n: tuple(w) for n, w in
                                      pm.replicas.items()
                                      if n in f.replicas}
            assert set(f.replicas) == {f"doc{i}" for i in range(12 + step)}
            with pm.lock:
                pm.route_locked(f"doc{12 + step}", ["http://a"],
                                {"http://a": 0}, None, 1)
            pm.leg_success(f"doc{12 + step}", "http://a")
            assert pm.flush()
        conditional = follower_pkg == "port" and server_pkg == "port"
        assert replies == [["data"], ["unchanged" if conditional
                                      else "data"]] * 3
    finally:
        for c in clients:
            c.close()
        server.close()


def test_port_leader_loads_jax_leaders_placement(tmp_path):
    """A JAX leader places the corpus on a port node and a JAX worker
    (R = 2) and stops; the port node is elected, loads the placement
    znode the JAX leader wrote, and serves the oracle's answers through
    the JAX worker."""
    server = jax_coord.CoordinationServer(host="127.0.0.1", port=0,
                                          session_timeout_s=2.0).start()
    nodes = []
    try:
        def client(pkg):
            return PKGS[pkg][1].CoordinationClient(
                server.address, heartbeat_interval_s=0.2)

        jleader = JaxNode(JaxConfig(
            documents_path=str(tmp_path / "jl" / "documents"),
            index_path=str(tmp_path / "jl" / "index"), port=0, **_CFG),
            coord=client("jax")).start()
        nodes.append(jleader)
        assert wait_until(jleader.is_leader, timeout=10.0)
        pnode = port_node(client("port"), tmp_path, 1)
        nodes.append(pnode)
        nodes.append(JaxNode(JaxConfig(
            documents_path=str(tmp_path / "jw" / "documents"),
            index_path=str(tmp_path / "jw" / "index"), port=0, **_CFG),
            coord=client("jax")).start())
        assert wait_until(lambda: len(
            jleader.registry.get_all_service_addresses()) == 2,
            timeout=10.0)
        # what the port node's map holds right after its election load
        # (later membership passes drop the new leader's own copies: a
        # leader is no worker)
        loaded = []
        pm = pnode.placement
        load = pm.load

        def recording_load():
            n = load()
            with pm.lock:
                loaded.append((n, dict(pm.replicas)))
            return n
        pm.load = recording_load
        upload(jleader)
        want_map = dict(jleader.placement.replicas)
        assert sorted(want_map) == sorted(DOCS)
        assert all(len(h) == 2 and pnode.url in h
                   for h in want_map.values())
        assert jleader.placement.flush()
        jleader.stop()
        nodes.remove(jleader)

        assert wait_until(pnode.is_leader, timeout=15.0)
        assert wait_until(lambda: loaded, timeout=10.0)
        n, got_map = loaded[0]
        assert n == len(DOCS) and got_map == want_map
        want = _oracle(tmp_path / "oracle", docs=DOCS, queries=QUERIES)
        assert wait_until(lambda: len(
            pnode.registry.get_all_service_addresses()) == 1, timeout=10.0)
        for q in QUERIES:
            got, hdrs = search(pnode.url, q)
            assert "X-Scatter-Degraded" not in hdrs, q
            assert_close(got, want[q], q)
    finally:
        _stop_all(nodes)
        server.close()
