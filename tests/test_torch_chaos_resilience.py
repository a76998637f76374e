"""Probabilistic faults across the plane, against port nodes in this
process.

A port of ``tests/test_resilience.py``'s slow ``TestChaos``, both tests: a
port ``CoordinationCore`` with 0.5 s sessions (that file's ``core``
fixture), three port ``SearchNode``\\ s on ``device="cpu"`` with that
file's ``_RESILIENCE_CFG`` (R=1, no result cache, one RPC attempt unless
the test sets two), its ``DOCS``, and faults armed on the port's
``global_injector`` at the port's own points: ``leader.worker_rpc``
(``cluster/router.py``), ``coord.heartbeat_send``
(``cluster/coordination.py``), ``leader.reconcile_rpc``
(``cluster/node.py``) and ``resilience.backoff``
(``cluster/resilience.py``). The JAX jobs' probabilities, query count,
timeouts, assertions and tolerances are kept line for line; every counter
is read from the port's ``global_metrics`` and ``global_injector``.

Held to the JAX package: the healthy ``full`` result of the first job is
compared with a JAX cluster's over the same ``DOCS`` and config (the same
names, scores within rel 1e-6, f32 rounding). Every request goes through
the port's transport seam (``tfidf_tpu_torch.cluster.node.http_post``).
"""

import json

import pytest

from tests.test_cluster import wait_until
from tests.test_resilience import _RESILIENCE_CFG, DOCS
from tests.test_resilience import _mk_cluster as jax_cluster
from tests.test_resilience import _search as jax_search
from tests.test_resilience import _upload_docs as jax_upload
from tests.test_resilience import _stop_all
from tests.test_torch_chaos_partition import (assert_port, heal_port_faults,
                                              search)
from tfidf_tpu.cluster.coordination import \
    CoordinationCore as JaxCoordinationCore
from tfidf_tpu_torch.cluster.coordination import (CoordinationCore,
                                                  LocalCoordination)
from tfidf_tpu_torch.cluster.node import SearchNode, http_post
from tfidf_tpu_torch.utils.config import Config
from tfidf_tpu_torch.utils.faults import global_injector
from tfidf_tpu_torch.utils.metrics import global_metrics

_heal_port = pytest.fixture(autouse=True)(heal_port_faults)


@pytest.fixture
def core():
    c = CoordinationCore(session_timeout_s=0.5)
    yield c
    c.close()


def _node(core, tmp_path, i, port=0, **kw):
    """``tests/test_resilience.py``'s ``_node`` as a port node on the
    CPU."""
    cfg_kw = dict(_RESILIENCE_CFG)
    cfg_kw.update(kw)
    cfg = Config(
        documents_path=str(tmp_path / f"rz{i}" / "documents"),
        index_path=str(tmp_path / f"rz{i}" / "index"),
        port=port, **cfg_kw)
    return SearchNode(cfg, coord=LocalCoordination(core, 0.1),
                      device="cpu").start()


def _mk_cluster(core, tmp_path, n=3, **kw):
    nodes = [_node(core, tmp_path, i, **kw) for i in range(n)]
    wait_until(lambda: len(
        nodes[0].registry.get_all_service_addresses()) == n - 1)
    assert_port(*nodes, core)
    return nodes


def _upload_docs(leader, docs=DOCS):
    batch = [{"name": n, "text": t} for n, t in docs.items()]
    http_post(leader.url + "/leader/upload-batch",
              json.dumps(batch).encode())


def _jax_full(tmp_path, q, **kw):
    """The JAX package's cluster over the same ``DOCS`` and config: its
    healthy answer to ``q``."""
    jcore = JaxCoordinationCore(session_timeout_s=0.5)
    nodes = jax_cluster(jcore, tmp_path / "jax", **kw)
    try:
        jax_upload(nodes[0])
        return jax_search(nodes[0], q)
    finally:
        _stop_all(nodes)
        jcore.close()


@pytest.mark.slow
class TestChaos:
    def test_chaos_scatter_heartbeats_and_reconciles(self, core,
                                                     tmp_path):
        """Acceptance: probabilistic faults on worker RPCs, heartbeats,
        and reconciles. The leader must (a) count every failed batch
        instead of merging empties, (b) keep merged scores single-copy
        at all times, (c) bound retries (injector fire counters) and
        recover to full, non-degraded results once the chaos stops."""
        nodes = _mk_cluster(core, tmp_path,
                            rpc_max_attempts=2, breaker_reset_s=0.3)
        leader = nodes[0]
        try:
            _upload_docs(leader)
            full = search(leader.url, "common")
            assert set(full) == set(DOCS)
            want = _jax_full(tmp_path, "common", rpc_max_attempts=2,
                             breaker_reset_s=0.3)
            assert set(full) == set(want)
            for n, s in full.items():
                assert s == pytest.approx(want[n], rel=1e-6)
            workers = leader.registry.get_all_service_addresses()

            global_injector.arm("leader.worker_rpc", action="raise",
                                probability=0.3)
            global_injector.arm("coord.heartbeat_send", action="raise",
                                probability=0.3)
            global_injector.arm("leader.reconcile_rpc", action="raise",
                                probability=0.5)
            global_injector.arm("resilience.backoff", action="delay",
                                delay_s=0.0)

            n_queries = 40
            for i in range(n_queries):
                res = search(leader.url, "common")
                # honesty: partial/empty results only ever co-occur with
                # counted failures or open breakers
                if set(res) != set(full):
                    assert (global_metrics.get("scatter_failures") > 0
                            or global_metrics.get(
                                "scatter_circuit_open") > 0)
                # single-copy invariant: no score ever EXCEEDS the
                # healthy value (double-count would inflate it)
                for n, s in res.items():
                    assert s <= full[n] * (1 + 1e-6)

            # bounded retries: each logical RPC fires the fault point at
            # most rpc_max_attempts times
            max_rpcs = n_queries * len(workers)
            fired = global_injector.fired.get("leader.worker_rpc", 0)
            assert fired <= max_rpcs * 2
            # every backoff sleep follows SOME injected failure (the
            # heartbeat retry loop shares the backoff fault point)
            backoffs = global_injector.fired.get("resilience.backoff", 0)
            all_failures = sum(
                global_injector.fired.get(p, 0)
                for p in ("leader.worker_rpc", "coord.heartbeat_send",
                          "leader.reconcile_rpc"))
            assert backoffs <= all_failures

            # chaos off: cluster converges to healthy, non-degraded
            global_injector.disarm()

            def healthy():
                res = search(leader.url, "common")
                return (set(res) == set(full)
                        and global_metrics.get("scatter_degraded") == 0)
            assert wait_until(healthy, timeout=10.0)
            for n, s in search(leader.url, "common").items():
                assert s == pytest.approx(full[n], rel=1e-6)
        finally:
            _stop_all(nodes)

    def test_chaos_rejoin_sweep_converges(self, core, tmp_path):
        """Worker death + rejoin under a flaky /worker/delete: the sweep
        must converge to single-copy despite 70%-lossy reconciles, and
        scores must never double-count at any observation point."""
        nodes = _mk_cluster(core, tmp_path)
        leader = nodes[0]
        try:
            _upload_docs(leader)
            victim = nodes[1]
            victim_port = victim.port
            victim.httpd.shutdown()
            victim.httpd.server_close()
            core.expire_session(victim.coord.sid)
            assert wait_until(
                lambda: set(search(leader.url, "common")) == set(DOCS)
                and {w for ws in leader._placement.values()
                     for w in ws} == {nodes[2].url}, timeout=10.0)
            want = search(leader.url, "common")

            global_injector.arm("leader.reconcile_rpc", action="raise",
                                probability=0.7)
            revived = _node(core, tmp_path, 1, port=victim_port)
            nodes.append(revived)
            assert_port(revived)

            def converged():
                scores = search(leader.url, "common")
                assert scores.keys() == want.keys()
                for n in want:   # never double-counted, converged or not
                    assert scores[n] == pytest.approx(want[n], rel=1e-6)
                with leader._placement_lock:
                    return not leader._moved.get(revived.url)
            assert wait_until(converged, timeout=20.0, interval=0.1)
            # a reconcile really completed (the fault is probabilistic,
            # so it may or may not have fired first — the deterministic
            # retry-through-failure path is pinned by TestReconcileSweep)
            assert global_metrics.get("reconciles_completed") >= 1
        finally:
            _stop_all(nodes)


# ---------------------------------------------------------------------------
# tier-1: the repair the rejoin job needed (MOVED_AT_CONFIRM)
# ---------------------------------------------------------------------------

def _confirm_snapshots(nodes, core, victim_index=1):
    """Expire a worker of a settled in-process cluster and record, at
    every placement confirm of its recovery, whether the leader's map
    already holds that name's pending delete on the dead worker. Returns
    the records once the recovery has noted every moved name."""
    leader, victim = nodes[0], nodes[victim_index]
    held = sum(victim.url in ws for ws in leader._placement.values())
    snaps = []
    placement = leader.placement
    confirm = placement.leg_success

    def spy(name, worker, *a, **kw):
        out = confirm(name, worker, *a, **kw)
        with placement.lock:
            snaps.append(name in placement.moved.get(victim.url, ()))
        return out
    placement.leg_success = spy
    victim.httpd.shutdown()
    victim.httpd.server_close()
    core.expire_session(victim.coord.sid)
    assert wait_until(lambda: len(
        placement.moved.get(victim.url, ())) == held, timeout=10.0)
    return snaps


class TestMovedAtConfirm:
    def test_jax_confirms_a_recovered_copy_before_its_pending_delete(
            self, tmp_path):
        """The reference: each re-placed copy of a dead worker's names is
        confirmed with no pending delete on the dead worker yet (noted
        after the batch returns): the window the rejoin job fell into."""
        jcore = JaxCoordinationCore(session_timeout_s=0.5)
        nodes = jax_cluster(jcore, tmp_path)
        try:
            jax_upload(nodes[0])
            snaps = _confirm_snapshots(nodes, jcore)
            assert snaps and not any(snaps)
        finally:
            _stop_all(nodes)
            jcore.close()

    def test_port_records_the_pending_delete_with_the_confirm(
            self, core, tmp_path):
        """The port: every confirm of the recovery already holds the
        name's pending delete on the dead worker, and the recovery's
        count of replaced names is unchanged."""
        nodes = _mk_cluster(core, tmp_path)
        try:
            _upload_docs(nodes[0])
            held = sum(nodes[1].url in ws
                       for ws in nodes[0]._placement.values())
            snaps = _confirm_snapshots(nodes, core)
            assert snaps and all(snaps)
            assert wait_until(lambda: global_metrics.get(
                "shard_docs_replaced") == held, timeout=10.0)
        finally:
            _stop_all(nodes)
