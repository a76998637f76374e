"""The coordinator's SIGKILL chaos, against port coordinator processes.

A port of ``tests/test_coordination_durability.py``'s slow
``TestSigkillChaos``, its schedule, environment and assertions:

* ``test_sigkill_restart_differential``: one ``python -m tfidf_tpu_torch
  coordinator --data-dir`` process; the JAX module's ``_traffic`` through
  a port ``CoordinationClient``, mirrored on a JAX ``CoordinationCore``
  (the oracle); kill -9, a restart on the same data dir, the recovered
  tree read back through the surviving client equal to the oracle's, and
  the pre-kill session still owning ``/eph``;
* ``test_ensemble_sigkill_rolling_chaos``: three port coordinator
  processes with ``--peers``, each kill -9ed in turn (the leader among
  them) while a writer appends; every acknowledged write readable at the
  end, and each restarted member applies the ensemble's log up to the
  leader's commit index.

Tier-1, ``TestRestartedViewRead``: the port's own deviation on the path
a restarted coordinator serves (``VIEW_READ`` in
``tests/test_torch_cluster_copy.py``). An in-process port server
restarted on its data dir answers ``get_data_if_changed`` from the
recovered tree, and a placement follower that read the map before the
kill reads "unchanged" after it and the leader's next flush after that.

Coordinator processes run through ``chaos_env`` (``jax`` and
``tfidf_tpu`` unimportable in them) and ``bench_modes._spawn``; ports
come from ``tfidf_tpu_torch.bench.free_ports``.
"""

import json
import os
import signal
import urllib.request

import pytest

from tests.test_cluster import wait_until
from tests.test_coordination_durability import (_traffic, _wait_http,
                                                _wait_subprocess_leader)
from tests.test_torch_chaos_compute import chaos_env
from tests.test_torch_chaos_partition import heal_port_faults
from tfidf_tpu.cluster.coordination import CoordinationCore as JaxCore
from tfidf_tpu_torch import bench_modes
from tfidf_tpu_torch.bench import _kill_all, _wait_until, free_ports
from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                  CoordinationServer,
                                                  data_digest)
from tfidf_tpu_torch.cluster.placement import (PLACEMENT_STATE,
                                               PlacementFollower,
                                               PlacementMap)

_heal_port = pytest.fixture(autouse=True)(heal_port_faults)

# tests/test_coordination_durability.py's _spawn_coordinator environment
COORD_ENV = {"TFIDF_SESSION_TIMEOUT_S": "30",
             "TFIDF_ENSEMBLE_ELECTION_TIMEOUT_S": "0.4",
             "TFIDF_ENSEMBLE_HEARTBEAT_S": "0.1",
             "TFIDF_ENSEMBLE_COMMIT_TIMEOUT_S": "3.0"}


def spawn_coordinator(procs, env, tmp, tag, port, data_dir, node_id="",
                      peers=""):
    """The JAX module's ``_spawn_coordinator`` as a port process."""
    args = ["coordinator", "--listen", f"127.0.0.1:{port}",
            "--data-dir", data_dir]
    if node_id:
        args += ["--node-id", node_id]
    if peers:
        args += ["--peers", peers]
    return bench_modes._spawn(procs, env, str(tmp), tag, args)


def ensemble_status(port) -> dict:
    url = f"http://127.0.0.1:{port}/ensemble/status"
    with urllib.request.urlopen(url, timeout=1.0) as r:
        return json.loads(r.read())


# ---------------------------------------------------------------------------
# tier-1: the view read on a restarted server
# ---------------------------------------------------------------------------

def _fill(pm, names):
    with pm.lock:
        for n in names:
            pm.route_locked(n, ["http://a"], {"http://a": 0}, None, 1)
    for n in names:
        pm.leg_success(n, "http://a")


class TestRestartedViewRead:
    @pytest.mark.parametrize("snapshot_every", [512, 3],
                             ids=["wal-only", "snapshot-and-tail"])
    def test_view_read_after_wal_recovery(self, tmp_path, snapshot_every):
        """kill a durable port server (no flush), restart it on the same
        port and data dir: the digest of the pre-kill map reads
        "unchanged", any other digest reads the recovered data, and a
        follower's view survives the restart and takes the next flush."""
        port = free_ports(1)[0]
        data = str(tmp_path / "coord")

        def server():
            return CoordinationServer(
                host="127.0.0.1", port=port, session_timeout_s=30.0,
                data_dir=data, snapshot_every=snapshot_every).start()
        srv = server()
        clients = []
        try:
            wc = CoordinationClient(srv.address, heartbeat_interval_s=0.5)
            fc = CoordinationClient(srv.address, heartbeat_interval_s=0.5)
            clients += [wc, fc]
            replies = []
            rpc = fc._rpc

            def recording(req, *a, **kw):
                out = rpc(req, *a, **kw)
                if req.get("op") == "get_data":
                    replies.append(sorted(out))
                return out
            fc._rpc = recording
            pm = PlacementMap(flush_ms=0.0, name="auth")
            pm.bind_store(lambda: wc)
            pm.set_persist_enabled(True)
            _fill(pm, [f"doc{i}" for i in range(6)])
            assert pm.flush()
            before = wc.get_data(PLACEMENT_STATE)
            f = PlacementFollower(refresh_ms=60_000.0, stale_ms=0.0)
            f.bind_store(lambda: fc)
            assert f.refresh() and f.version == 1

            srv.kill()      # no graceful flush: recovery reads the disk
            srv = server()
            assert wait_until(lambda: srv.ensemble.is_leader(),
                              timeout=10.0)
            assert srv.core.get_data(0, PLACEMENT_STATE) == before
            assert wc.get_data_if_changed(PLACEMENT_STATE,
                                          data_digest(before)) is None
            assert wc.get_data_if_changed(
                PLACEMENT_STATE, data_digest(b"other")) == before
            assert f.refresh() and f.version == 1
            assert set(f.replicas) == {f"doc{i}" for i in range(6)}

            _fill(pm, ["doc6"])
            assert pm.flush()
            assert f.refresh() and f.version == 2
            assert set(f.replicas) == {f"doc{i}" for i in range(7)}
            assert replies == [["data"], ["unchanged"], ["data"]]
        finally:
            for c in clients:
                c.close()
            srv.close()


# ---------------------------------------------------------------------------
# the chaos jobs (slow)
# ---------------------------------------------------------------------------

@pytest.mark.slow
class TestSigkillChaos:
    @pytest.mark.timeout(300)
    def test_sigkill_restart_differential(self, tmp_path):
        """The crash-restart differential with a real SIGKILL: kill -9
        the port coordinator process mid-traffic, restart it on the same
        --data-dir, and the recovered tree equals the never-crashed JAX
        oracle core's."""
        env = chaos_env(tmp_path, COORD_ENV)
        port = free_ports(1)[0]
        data = str(tmp_path / "solo")
        procs = []
        try:
            proc = spawn_coordinator(procs, env, tmp_path, "solo", port,
                                     data)
            assert _wait_http(port)
            oracle = JaxCore(session_timeout_s=60.0)
            cli = CoordinationClient(f"127.0.0.1:{port}",
                                     heartbeat_interval_s=1.0)
            _traffic(cli, oracle)
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=10)
            spawn_coordinator(procs, env, tmp_path, "solo-restarted", port,
                              data)
            assert _wait_http(port)

            # read the whole tree back through the recovered server
            def tree(coord, path):
                kids = sorted(coord.get_children(path))
                base = "" if path == "/" else path
                return {k: (coord.get_data(f"{base}/{k}").hex(),
                            tree(coord, f"{base}/{k}")) for k in kids}
            got = tree(cli, "/")
            oracle_cli_sid = 0

            def otree(path):
                kids = sorted(oracle.get_children(oracle_cli_sid, path))
                base = "" if path == "/" else path
                return {k: (oracle.get_data(oracle_cli_sid,
                                            f"{base}/{k}").hex(),
                            otree(f"{base}/{k}")) for k in kids}
            assert got == otree("/")
            # sessions recovered too: the pre-kill session still owns
            # its ephemeral node
            assert cli.get_data("/eph") == b"mine"
            cli.close()
            oracle.close()
        finally:
            _kill_all(procs)

    @pytest.mark.timeout(300)
    def test_ensemble_sigkill_rolling_chaos(self, tmp_path):
        """Kill -9 each port ensemble member in turn (leader included)
        while a writer keeps appending; every acknowledged write must be
        readable at the end, and restarted members catch back up."""
        env = chaos_env(tmp_path, COORD_ENV)
        ports = free_ports(3)
        peers = ",".join(f"c{i}=127.0.0.1:{p}"
                         for i, p in enumerate(ports))
        dirs = {i: str(tmp_path / f"m{i}") for i in range(3)}
        procs = []
        members = {}
        try:
            for i, p in enumerate(ports):
                members[i] = spawn_coordinator(
                    procs, env, tmp_path, f"c{i}", p, dirs[i],
                    node_id=f"c{i}", peers=peers)
            for p in ports:
                assert _wait_http(p)
            assert _wait_subprocess_leader(ports)
            connect = ",".join(f"127.0.0.1:{p}" for p in ports)
            cli = CoordinationClient(connect, heartbeat_interval_s=1.0)
            acked = []

            def write_burst(tag, n=10):
                for k in range(n):
                    path = f"/chaos-{tag}-{k}"
                    cli.create(path, tag.encode())
                    acked.append(path)

            def caught_up(victim):
                """The restarted member applies the log up to the commit
                index the leader reports after its burst."""
                want = []

                def applied():
                    if not want:
                        want.append(next(
                            s["commit_index"]
                            for s in map(ensemble_status, ports)
                            if s["role"] == "leader"))
                    return ensemble_status(ports[victim])["applied"] \
                        >= want[0]
                _wait_until(applied, 60.0, 0.1)

            write_burst("warmup")
            for round_no in range(3):
                victim = round_no % 3
                os.kill(members[victim].pid, signal.SIGKILL)
                members[victim].wait(timeout=10)
                write_burst(f"r{round_no}")       # quorum of 2 serves
                members[victim] = spawn_coordinator(
                    procs, env, tmp_path, f"c{victim}-r{round_no}",
                    ports[victim], dirs[victim], node_id=f"c{victim}",
                    peers=peers)
                assert _wait_http(ports[victim])
                write_burst(f"r{round_no}b")
                caught_up(victim)
            for path in acked:
                assert cli.exists(path), f"lost acknowledged {path}"
            cli.close()
        finally:
            _kill_all(procs)
