"""Clean lockdep case: a durable port coordinator and a registry
workload take the ensemble lock, then the core's lock (an ordering the
static lock graph explains)."""

import time


def test_coordinator_workload(tmp_path):
    from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                      CoordinationServer)
    from tfidf_tpu_torch.cluster.registry import ServiceRegistry
    srv = CoordinationServer(port=0, session_timeout_s=1.0,
                             data_dir=str(tmp_path / "coord")).start()
    try:
        cli = CoordinationClient(srv.address)
        reg = ServiceRegistry(cli)
        reg.register_to_cluster("http://127.0.0.1:1")
        assert reg.get_all_service_addresses() == ["http://127.0.0.1:1"]
        cli.create("/w", b"1")
        cli.delete("/w")
        srv.core.expire_session(cli.sid)
        time.sleep(0.3)
        cli.close()
    finally:
        srv.close()
