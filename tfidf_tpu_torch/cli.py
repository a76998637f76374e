"""Command-line interface — the single-binary deployment surface.

The reference ships one Spring Boot fat jar that every node runs
(``app/ZookeeperLeaderElectionApplication.java``; k8s Deployment in
``README.MD:49-108``). The equivalent here is ``python -m tfidf_tpu_torch``:

    serve        run a cluster node (worker + leader-candidate), optionally
                 with an embedded coordination service
    router       run a stateless query-plane router (scale-out reads;
                 mutations forward to the elected leader)
    coordinator  run only the coordination service (the "zookeeper" pod)
    ingest       build a local index from files/directories
    search       query a local index
    upload       client: send a document to a running cluster's leader
    query        client: search a running cluster
    status       client: node role + live membership + degraded summary
    drain        client: migrate a worker empty before decommission
    trace        client: fetch + render a distributed request trace
    autopilot    client: SLO-autopilot state, decision audit, kill switch
    faults       chaos tooling: list registered fault points
    bench        BASELINE's configs on the CUDA card (tfidf_tpu_torch.bench);
                 --overload/--replay/--routers/--kernel/--hybrid/--tier/
                 --compute run the root bench.py's other modes

Config resolution (lowest to highest): dataclass defaults, --config JSON
file, TFIDF_* environment variables, explicit flags — mirroring the
reference's application.properties + env override scheme (SURVEY.md §5.6).

The commands that hold an engine (``serve``, ``ingest``, ``search``) run
it on the device that ``--device`` names, else ``TFIDF_DEVICE``, else the
CUDA card; without CUDA and without a named device they exit with the
CUDA message (:func:`tfidf_tpu_torch.device.resolve_device`). ``bench``
always runs on the card and exits with the CUDA message without one. The
other commands speak HTTP or read files and touch no device.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import urllib.parse

from tfidf_tpu_torch.utils.config import Config, load_config
from tfidf_tpu_torch.utils.logging import get_logger

log = get_logger("cli")


def _device(args):
    """The engine's torch device: ``--device``, else ``TFIDF_DEVICE``,
    else the CUDA card. A device that cannot be had (no CUDA) is printed
    and exits with status 2 before any node state is built."""
    from tfidf_tpu_torch.device import resolve_device
    choice = args.device or os.environ.get("TFIDF_DEVICE") or None
    try:
        return resolve_device(choice)
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        raise SystemExit(2) from e


def _load_cfg(args, **overrides) -> Config:
    for name in ("host", "port", "documents_path", "index_path",
                 "coordinator_address", "model", "result_order",
                 "engine_mode"):
        v = getattr(args, name.replace("-", "_"), None)
        if v is not None:
            overrides[name] = v
    return load_config(getattr(args, "config", None), **overrides)


def cmd_serve(args) -> int:
    from tfidf_tpu_torch.cluster.coordination import (CoordinationClient,
                                                      CoordinationServer)
    from tfidf_tpu_torch.cluster.node import SearchNode

    cfg = _load_cfg(args)
    if args.distributed:
        cfg = cfg.replace(distributed=True)
    device = _device(args)
    if cfg.distributed:
        # the multi-process mesh: join the process group (NCCL on the
        # card, gloo with --device cpu) before the engine builds its mesh
        # over every process's devices
        from tfidf_tpu_torch.parallel.mesh import initialize_multihost
        initialize_multihost(
            coordinator_address=cfg.dist_coordinator or None,
            num_processes=cfg.dist_num_processes or None,
            process_id=(cfg.dist_process_id
                        if cfg.dist_process_id >= 0 else None),
            device=device)
    server = None
    if args.embedded_coordinator:
        if cfg.coord_peers and not cfg.coord_data_dir:
            print("TFIDF_COORD_PEERS requires TFIDF_COORD_DATA_DIR "
                  "(quorum state must be durable)", file=sys.stderr)
            return 2
        try:
            peers = parse_peers(cfg.coord_peers)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 2
        if peers:
            # ensemble member: bind THIS member's port from the peer
            # map (the connect string lists every member — its first
            # entry is usually someone else's address)
            if cfg.coord_node_id not in peers:
                print(f"TFIDF_COORD_NODE_ID {cfg.coord_node_id!r} "
                      "missing from TFIDF_COORD_PEERS map",
                      file=sys.stderr)
                return 2
            host = "0.0.0.0"
            port = peers[cfg.coord_node_id].rsplit(":", 1)[1]
        else:
            host, _, port = (
                cfg.coordinator_address.split(",")[0].strip()
                .partition(":"))
        server = CoordinationServer(
            host=host or "127.0.0.1", port=int(port or 0),
            session_timeout_s=cfg.session_timeout_s,
            data_dir=cfg.coord_data_dir or None,
            node_id=cfg.coord_node_id,
            peers=peers,
            election_timeout_s=cfg.ensemble_election_timeout_s,
            heartbeat_interval_s=cfg.ensemble_heartbeat_s,
            commit_timeout_s=cfg.ensemble_commit_timeout_s,
            snapshot_every=cfg.wal_snapshot_every,
            wal_fsync=cfg.wal_fsync).start()
        if not peers:
            # standalone: the node talks to its own embedded service;
            # ensemble members keep the full multi-member connect string
            cfg = cfg.replace(coordinator_address=server.address)
        log.info("embedded coordination service", address=server.address,
                 durable=bool(cfg.coord_data_dir))

    def factory():
        return CoordinationClient(
            cfg.coordinator_address,
            heartbeat_interval_s=cfg.heartbeat_interval_s)

    # restore-at-boot: a serving node with a checkpoint loads it and then
    # re-walks only documents written after the save (the reference
    # restores by re-walking everything, Worker.java:77-94)
    engine = None
    newer_than = None
    ckpt_dir = cfg.checkpoint_path or os.path.join(cfg.index_path,
                                                   "checkpoint")
    # fallback-aware restore: the manifest of every candidate version
    # is verified, corrupt ones are quarantined, and the newest INTACT
    # version wins — a torn or bit-rotted checkpoint costs a fallback
    # (or, at worst, the full re-walk below), never silently wrong
    # scores. Gated on checkpoint_versions, NOT isdir: a quarantine
    # leaves the published symlink dangling (isdir follows it to
    # False), and the intact .v<N-1> fallback must still be consulted.
    from tfidf_tpu_torch.engine.checkpoint import (checkpoint_versions,
                                                   restore_checkpoint)
    if checkpoint_versions(ckpt_dir):
        try:
            engine, meta = restore_checkpoint(ckpt_dir, cfg, device=device)
            created = meta.get("created_at")
            if created:
                newer_than = float(created) - 60.0   # clock-skew slack
            # reconcile deletions: the partial re-walk only UPSERTS, so
            # a document removed from the documents dir since the save
            # would otherwise be resurrected from the checkpoint forever
            # (the directory is the source of truth, Worker.java:77-94)
            if os.path.isdir(cfg.documents_path):
                removed = 0
                for e in list(engine.index.live_entries()):
                    if not os.path.isfile(
                            os.path.join(cfg.documents_path, e.name)):
                        engine.delete(e.name)
                        removed += 1
                if removed:
                    engine.commit()
                    log.info("dropped checkpointed docs missing from "
                             "documents dir", removed=removed)
            log.info("restored from checkpoint", dir=ckpt_dir,
                     docs=engine.index.num_live_docs)
        except Exception as e:
            log.warning("checkpoint restore failed; full rebuild",
                        err=repr(e))
            engine = None

    node = SearchNode(cfg, coord_factory=factory, engine=engine,
                      device=device).start(rebuild_newer_than=newer_than)
    print(f"node up at {node.url} "
          f"({'leader' if node.is_leader() else 'worker'}); "
          f"coordinator {cfg.coordinator_address}", flush=True)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    # the main thread parks, like Application.runApplication; a bounded
    # wait, because a signal that lands on another thread does not
    # interrupt a blocking one and its handler would never run
    while not stop.wait(1.0):
        pass
    node.stop()
    if server is not None:
        server.close()
    return 0


def cmd_router(args) -> int:
    """Run one stateless query-plane router (cluster/router.py): no
    engine, no shard, no election — a scatter read plane behind
    ``/leader/start`` + ``/leader/download`` that follows the durable
    placement znode and forwards every mutation to the elected leader.
    Kill it and nothing is lost; run N and the interactive front door
    scales ~N-fold (README "Scale-out query plane")."""
    from tfidf_tpu_torch.cluster.coordination import CoordinationClient
    from tfidf_tpu_torch.cluster.router import QueryRouter

    cfg = _load_cfg(args)
    if args.coordinator:
        cfg = cfg.replace(coordinator_address=args.coordinator)

    def factory():
        return CoordinationClient(
            cfg.coordinator_address,
            heartbeat_interval_s=cfg.heartbeat_interval_s)

    router = QueryRouter(cfg, coord_factory=factory).start()
    print(f"router up at {router.url}; "
          f"coordinator {cfg.coordinator_address}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.wait(1.0):   # see cmd_serve
        pass
    router.stop()
    return 0


def parse_peers(spec: str) -> dict[str, str]:
    """``"c0=host0:2181,c1=host1:2181"`` -> ``{"c0": "host0:2181", ...}``
    (the full ensemble member map, including this member)."""
    peers: dict[str, str] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        nid, sep, addr = part.partition("=")
        addr = addr.strip()
        host, psep, port = addr.rpartition(":")
        if (not sep or not nid.strip() or not host
                or not psep or not port.isdigit()):
            raise ValueError(f"bad peer spec {part!r} "
                             "(expected id=host:port)")
        peers[nid.strip()] = addr
    return peers


def cmd_coordinator(args) -> int:
    from tfidf_tpu_torch.cluster.coordination import CoordinationServer

    cfg = _load_cfg(args)
    data_dir = args.data_dir or cfg.coord_data_dir or None
    node_id = args.node_id or cfg.coord_node_id
    try:
        peers = parse_peers(args.peers or cfg.coord_peers)
    except ValueError as e:
        print(str(e), file=sys.stderr)
        return 2
    if peers and not data_dir:
        print("--peers requires --data-dir (quorum state must be durable)",
              file=sys.stderr)
        return 2
    if peers and node_id not in peers:
        print(f"--node-id {node_id!r} missing from --peers map",
              file=sys.stderr)
        return 2
    listen = args.listen
    if not listen and node_id in peers:
        # default to this member's advertised port from the peer map
        listen = "0.0.0.0:" + peers[node_id].rsplit(":", 1)[1]
    host, _, port = (listen or "0.0.0.0:2181").partition(":")
    server = CoordinationServer(
        host=host, port=int(port or 2181),
        session_timeout_s=cfg.session_timeout_s,
        data_dir=data_dir, node_id=node_id, peers=peers,
        election_timeout_s=cfg.ensemble_election_timeout_s,
        heartbeat_interval_s=cfg.ensemble_heartbeat_s,
        commit_timeout_s=cfg.ensemble_commit_timeout_s,
        snapshot_every=cfg.wal_snapshot_every,
        wal_fsync=cfg.wal_fsync).start()
    mode = ("ensemble member" if peers
            else "durable" if data_dir else "in-memory")
    print(f"coordination service at {server.address} ({mode})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.wait(1.0):   # see cmd_serve
        pass
    server.close()
    return 0


def cmd_ingest(args) -> int:
    from tfidf_tpu_torch.engine.checkpoint import save_checkpoint
    from tfidf_tpu_torch.engine.engine import Engine

    from tfidf_tpu_torch.ops.analyzer import UnsupportedMediaType

    cfg = _load_cfg(args)
    engine = Engine(cfg, device=_device(args))
    n = 0

    def ingest_one(name: str, data: bytes, save: bool) -> int:
        try:
            engine.ingest_bytes(name, data, save_to_disk=save)
            return 1
        except UnsupportedMediaType as e:
            # one stray binary must not abort a directory ingest
            print(f"skipping {name}: {e}", file=sys.stderr)
            return 0

    for path in args.paths:
        if os.path.isdir(path):
            # ingest files only; one commit at the end covers everything
            for dirpath, _dirnames, filenames in sorted(os.walk(path)):
                for fn in sorted(filenames):
                    full = os.path.join(dirpath, fn)
                    rel = os.path.relpath(full, path)
                    with open(full, "rb") as f:
                        n += ingest_one(rel, f.read(), False)
        else:
            with open(path, "rb") as f:
                n += ingest_one(os.path.basename(path), f.read(), True)
    engine.commit()
    if args.checkpoint:
        save_checkpoint(engine, args.checkpoint)
    print(json.dumps({"docs": n, "vocab": len(engine.vocab),
                      "nnz": engine.index.snapshot.nnz}))
    return 0


def cmd_search(args) -> int:
    from tfidf_tpu_torch.engine.checkpoint import load_checkpoint
    from tfidf_tpu_torch.engine.engine import Engine

    cfg = _load_cfg(args)
    device = _device(args)
    if args.checkpoint:
        engine = load_checkpoint(args.checkpoint, cfg, device=device)
    else:
        engine = Engine(cfg, device=device)
        engine.build_from_directory()
    for q in args.queries:
        hits = engine.search(q, k=args.k)
        print(json.dumps({"query": q,
                          "hits": [{"name": h.name, "score": h.score}
                                   for h in hits]}))
    return 0


def _leader_url(args) -> str:
    return args.leader.rstrip("/")


def _shed_aware_post(url: str, data: bytes,
                     content_type: str = "application/json",
                     who: str = "leader",
                     return_headers: bool = False):
    """POST to a front door honoring its admission layer: a 429 shed
    is retried only AFTER its ``Retry-After`` hint has elapsed (the
    default classifier + RetryPolicy floor — see resilience.py), and a
    request still shed after the bounded attempts exits with the shed
    message instead of a traceback. The CLI must model the polite
    client: hammering a saturated front door from the operator's own
    tooling would amplify the overload the shed is relieving.

    One protocol for both the ``--leader`` and ``--via-router`` paths
    (``who`` names the shedding side in the message);
    ``return_headers=True`` returns ``(reply headers, body)`` — the
    router path prints the route stamp / degraded markers from them."""
    import urllib.error
    import urllib.request

    from tfidf_tpu_torch.cluster.resilience import RetryPolicy, retry_after_of

    def once():
        req = urllib.request.Request(
            url, data=data, headers={"Content-Type": content_type})
        with urllib.request.urlopen(req, timeout=60.0) as r:
            return dict(r.headers), r.read()

    policy = RetryPolicy(max_attempts=3, base_delay_s=0.05, name="cli")
    try:
        hdrs, body = policy.call(once)
    except urllib.error.HTTPError as e:
        ra = retry_after_of(e)
        if ra is None:
            raise
        print(f"{who} is shedding load (429, reason="
              f"{e.headers.get('X-Shed-Reason', '?')}): retry after "
              f"{ra:.3f}s", file=sys.stderr)
        raise SystemExit(75)   # EX_TEMPFAIL: try again later
    return (hdrs, body) if return_headers else body


def cmd_upload(args) -> int:

    if getattr(args, "batch", False):
        from tfidf_tpu_torch.ops.analyzer import (UnsupportedMediaType,
                                                  extract_text)

        # bulk path: expand dirs (relative paths as names, same keying
        # as cmd_ingest — basenames would silently upsert same-named
        # files from different subdirectories over each other), extract
        # text CLIENT-side (the Tika contract: binaries are refused
        # here, not lossily decoded past the worker's 415 gate), ship
        # one /leader/upload-batch request per chunk of 500
        files: list[tuple[str, str]] = []     # (name, path)
        for path in args.files:
            if os.path.isdir(path):
                for dirpath, _d, fns in sorted(os.walk(path)):
                    files.extend(
                        (os.path.relpath(os.path.join(dirpath, fn),
                                         path), os.path.join(dirpath, fn))
                        for fn in sorted(fns))
            else:
                files.append((os.path.basename(path), path))
        total = 0
        failed = False
        for lo in range(0, len(files), 500):
            docs = []
            for name, p in files[lo:lo + 500]:
                with open(p, "rb") as f:
                    raw = f.read()
                try:
                    docs.append({"name": name,
                                 "text": extract_text(raw)})
                except UnsupportedMediaType as e:
                    print(f"skipped {name}: {e}", file=sys.stderr)
            if not docs:
                continue
            resp = json.loads(_shed_aware_post(
                _leader_url(args) + "/leader/upload-batch",
                json.dumps(docs).encode()))
            total += sum(resp.get("placed", {}).values())
            for s in resp.get("skipped", ()):
                print(f"skipped {s['name']}: {s['error']}",
                      file=sys.stderr)
            for w, err in resp.get("errors", {}).items():
                print(f"worker {w} failed: {err}", file=sys.stderr)
                failed = True
        print(f"{total} files uploaded and indexed")
        return 1 if failed else 0
    for path in args.files:
        with open(path, "rb") as f:
            data = f.read()
        name = urllib.parse.quote(os.path.basename(path))
        resp = _shed_aware_post(
            _leader_url(args) + f"/leader/upload?name={name}",
            data, content_type="application/octet-stream")
        print(resp.decode())
    return 0


def cmd_query(args) -> int:
    via = getattr(args, "via_router", None)
    if not via and not args.leader:
        print("query needs --leader URL or --via-router URL",
              file=sys.stderr)
        return 2
    payload = {"query": " ".join(args.query)}
    # hybrid plan (wire v3): mode/fusion are ADDITIVE fields — a plain
    # sparse query sends neither, staying byte-identical to a v2
    # request (README "Hybrid retrieval")
    mode = getattr(args, "mode", None)
    if mode and mode != "sparse":
        payload["mode"] = mode
        if getattr(args, "fusion", None):
            payload["fusion"] = args.fusion
    body = json.dumps(payload).encode()
    target = (via.rstrip("/") if via else _leader_url(args))
    # surface the read plane's honesty headers — which stages ran
    # (X-Search-Stages carries the fusion method + weights), which
    # placement world routed the request, and whether the results are
    # degraded/stale. Same polite-shed protocol on both paths: leaders
    # and routers each run an admission controller, so a 429 here is
    # expected.
    hdrs, out = _shed_aware_post(
        target + "/leader/start", body,
        who=("router" if via else "leader"), return_headers=True)
    for h in ("X-Search-Stages", "X-Route-Epoch", "X-Route-Generation",
              "X-Scatter-Degraded"):
        v = hdrs.get(h)
        if v:
            print(f"{h}: {v}", file=sys.stderr)
    print(out.decode())
    return 0


def cmd_status(args) -> int:
    from tfidf_tpu_torch.cluster.node import http_get

    url = _leader_url(args)
    metrics = json.loads(http_get(url + "/api/metrics"))
    out = {"status": http_get(url + "/api/status").decode(),
           "services": json.loads(http_get(url + "/api/services")),
           "metrics": metrics}
    # failure-semantics summary (README "Failure semantics"): was the
    # last scatter-gather fan-out degraded, and which workers' circuit
    # breakers are not closed right now
    degraded = {
        "last_scatter_degraded": bool(metrics.get("scatter_degraded", 0)),
        "last_scatter_workers_attempted":
            int(metrics.get("scatter_last_attempted", 0)),
        "last_scatter_workers_responded":
            int(metrics.get("scatter_last_responded", 0)),
        "circuit_open_workers":
            sorted(w for w, s in metrics.get("breaker_states", {}).items()
                   if s != "closed"),
    }
    out["degraded"] = degraded
    # replication summary (README "Replication & failover semantics"):
    # how often failed owners' slices failed over to surviving replicas,
    # whether any document currently has no live scorer, and what the
    # anti-entropy repair has moved
    out["replication"] = {
        "last_scatter_failovers":
            int(metrics.get("scatter_last_failovers", 0)),
        "last_scatter_dark_docs":
            int(metrics.get("scatter_last_dark", 0)),
        "failover_reads_total": int(metrics.get("scatter_failovers", 0)),
        "hedge_wins_total": int(metrics.get("scatter_hedge_wins", 0)),
        "repair_docs_replicated":
            int(metrics.get("repair_docs_replicated", 0)),
        "repair_docs_trimmed": int(metrics.get("repair_docs_trimmed", 0)),
    }
    # elastic-rebalance summary (README "Elastic rebalancing & drain"):
    # in-flight migrations/drains and the lifetime moved/failed totals
    out["rebalance"] = {
        "active_migrations": int(metrics.get("rebalance_active", 0)),
        "draining_workers":
            int(metrics.get("rebalance_draining_workers", 0)),
        "moved_docs_total": int(metrics.get("rebalance_moved_docs", 0)),
        "failures_total": int(metrics.get("rebalance_failures", 0)),
        "drains_started": int(metrics.get("rebalance_drains_started", 0)),
        "drains_completed":
            int(metrics.get("rebalance_drains_completed", 0)),
    }
    # overload summary (README "Overload & admission control"): is the
    # front door shedding, why, and is the result cache earning its keep
    hits = metrics.get("cache_hits", 0)
    misses = metrics.get("cache_misses", 0)
    # SLO-autopilot summary (README "SLO autopilot"): is the closed
    # loop steering, where each managed knob sits vs its static config
    # value, and how fresh the last decision is. Best-effort: a
    # pre-autopilot node simply has no block.
    try:
        ap = json.loads(http_get(url + "/api/autopilot?recent=0"))
        snap = ap.get("autopilot", {})
        out["autopilot"] = {
            "enabled": bool(snap.get("enabled")),
            "knobs": {
                k: {"current": v.get("current"),
                    "static": v.get("static"),
                    "adjustments": v.get("adjustments", 0)}
                for k, v in snap.get("knobs", {}).items()},
            "decisions_recorded": snap.get("decisions_recorded", 0),
            "last_decision_age_s": snap.get("last_decision_age_s"),
        }
    except Exception:
        pass
    # scale-out query plane summary (README "Scale-out query plane"):
    # the registered stateless routers, each one's placement
    # (epoch, generation) lag behind the leader's authoritative map,
    # staleness, and per-router cache hit rate. Best-effort: a
    # pre-router node simply has no block; an unreachable router is
    # listed as such rather than hiding the tier.
    try:
        router_urls = json.loads(http_get(url + "/api/routers"))
    except Exception:
        router_urls = []
    if router_urls:
        ref = {}
        try:
            leader_addr = (json.loads(http_get(url + "/api/leader"))
                           .get("leader")) or url
            ref = json.loads(http_get(
                str(leader_addr).rstrip("/") + "/api/router",
                timeout=3.0)).get("placement", {})
        except Exception:
            pass
        entries = []
        for r in router_urls:
            try:
                snap = json.loads(http_get(
                    str(r).rstrip("/") + "/api/router", timeout=3.0))
            except Exception:
                entries.append({"url": r, "reachable": False})
                continue
            pl = snap.get("placement", {})
            entry = {
                "url": r, "reachable": True,
                "placement_epoch": pl.get("epoch"),
                "placement_gen": pl.get("gen"),
                "view_age_s": pl.get("age_s"),
                "stale": bool(pl.get("stale")),
                "cache_hit_rate":
                    snap.get("cache", {}).get("hit_rate", 0.0),
                "writes_proxied": snap.get("writes_proxied", 0),
            }
            # lag vs the leader's authoritative map, in generations
            # and leadership epochs (None when either side is unknown)
            if (ref.get("gen") is not None
                    and pl.get("gen") is not None):
                entry["gen_lag"] = max(
                    0, int(ref["gen"]) - int(pl["gen"]))
            if (ref.get("epoch") is not None
                    and pl.get("epoch") is not None):
                entry["epoch_lag"] = max(
                    0, int(ref["epoch"]) - int(pl["epoch"]))
            entries.append(entry)
        out["routers"] = {"count": len(router_urls),
                          "routers": entries}
    # fleet wire-version summary (README "Versioning & upgrades"):
    # each member's declared proto version from /api/health. A member
    # whose health reply predates versioning speaks the implicit
    # version 1. A mixed-version fleet is normal MID-upgrade and a
    # finding at any other time — `status` flags it instead of hiding
    # it behind per-node queries.
    members = [("node", url)] + [("node", str(s))
                                 for s in out["services"]] \
        + [("router", str(r)) for r in router_urls]
    versions = []
    # embedding-column summary (README "Hybrid retrieval"): per-member
    # dense-plane footprint from the same /api/health sweep — model,
    # dims, docs embedded, bytes resident. A member with the dense
    # plane off (or predating it) simply has no row.
    columns = []
    # tiered-postings summary (README "Tiered storage & block-max
    # skipping"): per-member hot/cold segment counts, HBM bytes vs
    # budget, hit/skip rates from the same sweep. A member with
    # tiering off (or predating it) simply has no row.
    tiers = []
    # compute-plane health summary (README "Compute-plane failure
    # semantics"): per-member device state machine from the same
    # sweep. A member predating it simply has no row.
    compute = []
    for role, member in members:
        try:
            h = json.loads(http_get(
                member.rstrip("/") + "/api/health", timeout=3.0))
            versions.append({"url": member,
                             "role": h.get("role", role),
                             "proto_version":
                                 int(h.get("proto_version", 1)),
                             "reachable": True})
            emb = h.get("embedding")
            if emb:
                columns.append({"url": member,
                                "model": emb.get("model"),
                                "dim": emb.get("dim"),
                                "docs_embedded": int(emb.get("docs", 0)),
                                "bytes_resident":
                                    int(emb.get("bytes", 0))})
            tier = h.get("tier")
            if tier and tier.get("enabled"):
                tiers.append({
                    "url": member,
                    "hot_segments": int(tier.get("hot_segments", 0)),
                    "cold_segments": int(tier.get("cold_segments", 0)),
                    "hot_bytes": int(tier.get("hot_bytes", 0)),
                    "budget_bytes": int(tier.get("budget_bytes", 0)),
                    "hit_rate": tier.get("hit_rate", 0.0),
                    "skip_rate": tier.get("skip_rate", 0.0),
                    "ring_stall_s": tier.get("ring_stall_s", 0.0)})
            comp = h.get("compute")
            if comp:
                compute.append({
                    "url": member,
                    "state": comp.get("state"),
                    "consecutive_faults":
                        int(comp.get("consecutive_faults", 0)),
                    "total_faults": int(comp.get("total_faults", 0)),
                    "faults_by_kind": comp.get("faults_by_kind", {}),
                    "recovery_probes":
                        int(comp.get("recovery_probes", 0)),
                    "fallback_available":
                        bool(comp.get("fallback_available"))})
        except Exception:
            versions.append({"url": member, "role": role,
                             "proto_version": None,
                             "reachable": False})
    seen = sorted({v["proto_version"] for v in versions
                   if v["proto_version"] is not None})
    out["versions"] = {
        "members": versions,
        "proto_versions_seen": seen,
        "mixed_versions": len(seen) > 1,
    }
    out["embedding"] = {
        "enabled": bool(columns),
        "columns": columns,
        "docs_embedded_total":
            sum(c["docs_embedded"] for c in columns),
        "bytes_resident_total":
            sum(c["bytes_resident"] for c in columns),
    }
    out["tier"] = {
        "enabled": bool(tiers),
        "nodes": tiers,
        "hot_segments_total": sum(t["hot_segments"] for t in tiers),
        "cold_segments_total": sum(t["cold_segments"] for t in tiers),
        "hot_bytes_total": sum(t["hot_bytes"] for t in tiers),
    }
    out["compute"] = {
        "nodes": compute,
        "sick_nodes": sorted(c["url"] for c in compute
                             if c["state"] == "sick"),
        "degraded_nodes": sorted(c["url"] for c in compute
                                 if c["state"] == "degraded"),
        "fallback_served_total":
            int(metrics.get("compute_fallback_served", 0)),
        "poison_quarantined_total":
            int(metrics.get("poison_quarantined", 0)),
    }
    out["admission"] = {
        "admitted_total": int(metrics.get("admission_admitted", 0)),
        "shed_total": int(metrics.get("admission_shed_total", 0)),
        "shed_rate_limited":
            int(metrics.get("admission_shed_rate_limited", 0)),
        "shed_backpressure":
            int(metrics.get("admission_shed_backpressure", 0)),
        "last_queue_depth": metrics.get("admission_last_depth", 0),
        "cache_hits": int(hits),
        "cache_misses": int(misses),
        "cache_hit_rate": round(hits / (hits + misses), 3)
            if (hits + misses) else 0.0,
        "cache_entries": int(metrics.get("cache_entries", 0)),
    }
    print(json.dumps(out, indent=2))
    return 0


def cmd_drain(args) -> int:
    """Planned decommission: ask the leader to migrate a worker empty
    (live, crash-safe) so it can leave the cluster with zero loss."""
    import time as _time

    from tfidf_tpu_torch.cluster.node import http_get, http_post

    url = _leader_url(args)
    body = json.dumps({"worker": args.worker,
                       "cancel": bool(args.cancel)}).encode()
    resp = json.loads(http_post(url + "/api/drain", body))
    print(json.dumps(resp, indent=2))
    if args.cancel or not args.wait:
        return 0
    # poll until the worker holds nothing and its deletes landed; a
    # transient poll failure (leader restart, leadership change mid-
    # drain answering 409) is retried until the deadline — the wait
    # loop exists precisely to ride out such windows
    deadline = _time.monotonic() + args.wait_timeout
    last_err = None
    while _time.monotonic() < deadline:
        try:
            q = urllib.parse.quote(args.worker)
            st = json.loads(http_get(url + f"/api/drain?worker={q}"))
            if st.get("drained"):
                print(json.dumps(st, indent=2))
                return 0
        except Exception as e:
            last_err = e
        _time.sleep(1.0)
    print("drain did not complete in time"
          + (f" (last poll error: {last_err!r})" if last_err else ""),
          file=sys.stderr)
    return 1


def cmd_trace(args) -> int:
    """Fetch and render a distributed trace (``GET /api/trace``): by
    trace id (the ``X-Trace-Id`` reply header every /leader/* response
    carries, also stamped on slow-query log lines), or the most recent
    spans. Span rings are PER NODE — a real multi-process cluster keeps
    the leader-side spans on the leader and the worker-side
    continuations on each worker — so a by-id fetch fans out to every
    node in ``/api/services`` and merges (deduping by span id; a
    one-process test cluster shares one ring). ``--chrome FILE`` writes
    Chrome-trace/Perfetto JSON instead of the text timeline."""
    from tfidf_tpu_torch.cluster.node import http_get
    from tfidf_tpu_torch.utils.tracing import render_trace_tree, to_chrome_trace

    url = _leader_url(args)
    if args.trace_id:
        nodes = {url}
        try:
            nodes.update(str(u).rstrip("/") for u in json.loads(
                http_get(url + "/api/services")))
        except Exception as e:
            print(f"warning: could not list cluster nodes ({e!r}); "
                  "rendering this node's spans only", file=sys.stderr)
        try:
            # /api/services lists only WORKERS (the leader leaves the
            # pool on promotion) — but the leader's ring holds the
            # request/scatter/slice spans, so it must be queried even
            # when --leader actually points at a worker
            addr = json.loads(http_get(
                url + "/api/leader")).get("leader")
            if addr:
                nodes.add(str(addr).rstrip("/"))
        except Exception:
            pass   # pre-/api/leader node: the entry URL still counts
        unreachable: set[str] = set()

        def fetch(nu: str, tid: str) -> list[dict]:
            try:
                # short per-node budget: the tool's whole point is
                # tracing through failures, so a partitioned worker
                # must cost seconds, not the default urlopen timeout
                got = json.loads(http_get(
                    nu + "/api/trace/" + urllib.parse.quote(tid),
                    timeout=3.0))
            except Exception:
                unreachable.add(nu)   # a dead worker's spans died
                return []             # with it — render the rest
            return got.get("spans", [])

        # two waves: the request id first, then every trace id the
        # REQUEST's own spans link to (the coalescer boundary —
        # worker-side continuations live under the BATCH trace id, so
        # a worker's ring answers only the linked id, not the request
        # id). The final span set is FILTERED to those resolved ids:
        # batch spans link every request they absorbed, and the
        # servers' own one-hop expansion would otherwise pull
        # unrelated sibling requests into this timeline.
        from concurrent.futures import ThreadPoolExecutor
        ordered = sorted(nodes)
        with ThreadPoolExecutor(min(8, len(ordered))) as pool:
            wave1_by_node = dict(zip(ordered, pool.map(
                lambda nu: fetch(nu, args.trace_id), ordered)))
            wave1 = [s for lst in wave1_by_node.values() for s in lst]
            ids = {args.trace_id}
            for s in wave1:
                if s["trace_id"] == args.trace_id:
                    ids.update(t["trace_id"]
                               for t in s.get("links", []))
            collected = list(wave1)
            # this wave skips nodes that answered wave 1: their own
            # one-hop link expansion already covered the linked ids
            targets = [(nu, tid)
                       for tid in sorted(ids - {args.trace_id})
                       for nu in ordered
                       if not wave1_by_node.get(nu)
                       and nu not in unreachable]
            for got in pool.map(lambda t: fetch(*t), targets):
                collected.extend(got)
        if unreachable:
            print("warning: unreachable node(s) skipped: "
                  + ", ".join(sorted(unreachable)), file=sys.stderr)
        spans, seen = [], set()
        for s in collected:
            if s["trace_id"] in ids and s["span_id"] not in seen:
                seen.add(s["span_id"])
                spans.append(s)
        spans.sort(key=lambda s: s["start_s"])
    else:
        data = json.loads(http_get(
            url + f"/api/trace?recent={int(args.recent)}"))
        spans = data.get("spans", [])
    if args.chrome:
        with open(args.chrome, "w", encoding="utf-8") as f:
            json.dump(to_chrome_trace(spans), f)
        print(f"{len(spans)} span(s) -> {args.chrome} "
              "(load in chrome://tracing or ui.perfetto.dev)")
        return 0
    if not spans:
        print("(no spans"
              + (f" for trace {args.trace_id}" if args.trace_id else "")
              + " — is tracing sampled out, or the ring already "
                "recycled?)")
        return 1
    print(render_trace_tree(spans))
    return 0


def cmd_autopilot(args) -> int:
    """Inspect (and toggle) the SLO autopilot: ``GET /api/autopilot``
    rendered as a knob table plus the newest decision-audit records —
    which sensor inputs were read, what was decided, what was written.
    ``--enable`` / ``--disable`` flip the runtime kill switch
    (disabling reverts every managed knob to static config before the
    command returns). The loop runs on the LEADER, so the request is
    routed there via ``/api/leader`` when ``--leader`` actually points
    at a worker."""
    from tfidf_tpu_torch.cluster.node import http_get, http_post

    url = _leader_url(args)
    try:
        addr = json.loads(http_get(url + "/api/leader")).get("leader")
        if addr:
            url = str(addr).rstrip("/")
    except Exception:
        pass   # pre-/api/leader node: talk to the given URL
    if args.enable or args.disable:
        body = json.dumps({"enabled": bool(args.enable)}).encode()
        resp = json.loads(http_post(url + "/api/autopilot", body))
        snap = resp["autopilot"]
    else:
        resp = json.loads(http_get(
            url + f"/api/autopilot?recent={int(args.recent)}"))
        snap = resp["autopilot"]
    if args.json:
        print(json.dumps(resp, indent=2))
        return 0
    state = "ENABLED" if snap.get("enabled") else "disabled"
    print(f"autopilot {state} (node {url})")
    print(f"  interval {snap.get('interval_ms')}ms, "
          f"hysteresis {snap.get('hysteresis')}, "
          f"step {snap.get('step')}, confirm {snap.get('confirm')}, "
          f"p99 SLO {snap.get('p99_slo_ms')}ms")
    knobs = snap.get("knobs", {})
    if knobs:
        w = max(len(k) for k in knobs)
        print(f"  {'knob'.ljust(w)}  current   static    "
              f"[floor..ceiling]  dir  adjusts  last")
        for k, v in knobs.items():
            age = v.get("last_adjust_age_s")
            print(f"  {k.ljust(w)}  {v['current']:>8}  "
                  f"{v['static']:>8}  [{v['floor']:g}.."
                  f"{v['ceiling']:g}]  {v['last_direction']:>+2d}  "
                  f"{v['adjustments']:>7}  "
                  f"{(str(age) + 's ago') if age is not None else '-'}")
    decs = resp.get("decisions", [])
    if decs:
        print(f"  last {len(decs)} decision(s):")
        for d in decs:
            tail = (f" {d['current']} -> {d['new']}"
                    if d.get("applied") else f" (target {d['target']})")
            inp = ", ".join(f"{k}={v}"
                            for k, v in (d.get("inputs") or {}).items())
            print(f"    #{d['seq']} {d['knob']}: {d['reason']}{tail}"
                  + (f"  [{inp}]" if inp else ""))
    return 0


def cmd_faults(args) -> int:
    """``faults list``: print every fault point compiled into the tree
    (name + firing site) so chaos configs can be checked against the
    code instead of silently going stale."""
    from tfidf_tpu_torch.utils.faults import KNOWN_FAULT_POINTS

    if args.action == "list":
        try:
            for name in sorted(KNOWN_FAULT_POINTS):
                print(f"{name}\t{KNOWN_FAULT_POINTS[name]}")
        except BrokenPipeError:   # e.g. `faults list | head` — not an error
            import os
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0
    print(f"unknown faults action: {args.action}", file=sys.stderr)
    return 2


def cmd_quarantine(args) -> int:
    """``quarantine``: inspect (or ``--clear``) the poison-query
    quarantine on a node or router. The snapshot shows every tracked
    fingerprint with the distinct replicas that blamed it and how old
    the verdict is; ``--clear`` drops the table (operator override
    after a bad deploy is rolled back) and prints how many quarantined
    entries were released."""
    from tfidf_tpu_torch.cluster.node import http_get, http_post

    url = args.url.rstrip("/")
    if args.clear:
        resp = json.loads(http_post(url + "/api/quarantine", b"{}"))
        print(json.dumps(resp, indent=1))
        return 0
    snap = json.loads(http_get(url + "/api/quarantine"))
    print(json.dumps(snap, indent=1))
    return 0


def cmd_scrub(args) -> int:
    """``scrub``: storage-integrity verification. With ``--url`` it
    triggers one scrub pass on a RUNNING node (``POST /admin/scrub`` —
    the same pass the leader's sweep loop runs every
    ``storage_scrub_ms``); otherwise it verifies the local on-disk
    state offline: every checkpoint version's manifest and every
    placed-docs CRC against the ledger. Exit 1 on any corruption —
    the loud-refusal half of the storage contract."""
    from tfidf_tpu_torch.utils import storage as st

    if args.url:
        from tfidf_tpu_torch.cluster.node import http_post
        resp = json.loads(http_post(
            args.url.rstrip("/") + "/admin/scrub", b"{}"))
        print(json.dumps(resp, indent=1))
        return 1 if resp.get("unrepaired") \
            or resp.get("checkpoints_quarantined") else 0
    cfg = _load_cfg(args)
    ckpt_bad = 0
    from tfidf_tpu_torch.engine.checkpoint import checkpoint_versions
    ckpt = cfg.checkpoint_path or os.path.join(cfg.index_path,
                                               "checkpoint")
    for vdir in checkpoint_versions(ckpt):
        problems = st.verify_manifest(vdir)
        status = "OK" if not problems else "; ".join(problems)
        print(f"checkpoint {vdir}: {status}")
        ckpt_bad += bool(problems)
    ledger = st.CrcLedger(os.path.join(cfg.index_path,
                                       "placed_docs.crc.json"))
    store = os.path.join(cfg.index_path, "placed_docs")
    checked = store_bad = 0
    for name in sorted(ledger.names()):
        path = os.path.join(store, name)
        if not os.path.isfile(path):
            continue
        checked += 1
        if st.file_crc(path) != ledger.get(name):
            print(f"placed_docs {name}: CRC MISMATCH")
            store_bad += 1
    print(f"placed_docs: {checked} file(s) checked, "
          f"{store_bad} problem(s); checkpoints: {ckpt_bad} problem(s)")
    return 1 if ckpt_bad or store_bad else 0


def cmd_bench(args) -> int:
    # the port's own bench (tfidf_tpu_torch/bench.py): BASELINE's configs
    # on the card, each gated by its oracle; a --<mode> flag runs one of
    # the root bench.py's other modes (tfidf_tpu_torch/bench_modes.py)
    from tfidf_tpu_torch import bench
    from tfidf_tpu_torch.device import resolve_device
    try:
        resolve_device(None)   # the card; never a CPU number
    except RuntimeError as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.mode is None:
        bench.main()
    else:
        from tfidf_tpu_torch import bench_modes
        bench_modes.MAINS[args.mode]()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tfidf_tpu_torch",
        description="distributed full-text search framework "
                    "(PyTorch/CUDA)")
    p.add_argument("--config", help="JSON config file")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run a cluster node")
    s.add_argument("--host")
    s.add_argument("--port", type=int)
    s.add_argument("--documents-path")
    s.add_argument("--index-path")
    s.add_argument("--coordinator-address")
    s.add_argument("--model", choices=["bm25", "tfidf", "tfidf_cosine"])
    s.add_argument("--result-order", choices=["score", "name"])
    s.add_argument("--engine-mode", choices=["local", "mesh"],
                   help="mesh: serve from ShardedArrays on the device "
                        "mesh (distributed shard_map search)")
    s.add_argument("--embedded-coordinator", action="store_true",
                   help="also run the coordination service in-process")
    s.add_argument("--distributed", action="store_true",
                   help="multi-process mesh: join a torch.distributed "
                        "group (NCCL on the card, gloo on the CPU) before "
                        "building the mesh (see TFIDF_DIST_* env vars)")
    s.add_argument("--device",
                   help="torch device of the engine (cuda, cuda:N, cpu); "
                        "default TFIDF_DEVICE, else cuda")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("coordinator", help="run the coordination service")
    s.add_argument("--listen", help="host:port (default 0.0.0.0:2181, or "
                                    "this member's port from --peers)")
    s.add_argument("--data-dir",
                   help="durable state dir (WAL + snapshots); a restarted "
                        "coordinator recovers its full znode tree and "
                        "sessions from it")
    s.add_argument("--node-id", help="this ensemble member's id")
    s.add_argument("--peers",
                   help="full ensemble member map incl. self: "
                        "id0=host0:2181,id1=host1:2181,id2=host2:2181 "
                        "(majority quorum commits every write)")
    s.set_defaults(fn=cmd_coordinator)

    s = sub.add_parser("router",
                       help="run a stateless query-plane router")
    s.add_argument("--coordinator",
                   help="coordination connect string "
                        "(host:port[,host:port...]); defaults to "
                        "TFIDF_COORDINATOR_ADDRESS")
    s.add_argument("--host")
    s.add_argument("--port", type=int)
    s.set_defaults(fn=cmd_router)

    s = sub.add_parser("ingest", help="index files/dirs locally")
    s.add_argument("paths", nargs="+")
    s.add_argument("--documents-path")
    s.add_argument("--checkpoint", help="save a checkpoint here")
    s.add_argument("--model", choices=["bm25", "tfidf", "tfidf_cosine"])
    s.add_argument("--engine-mode", choices=["local", "mesh"])
    s.add_argument("--device",
                   help="torch device of the engine (cuda, cuda:N, cpu); "
                        "default TFIDF_DEVICE, else cuda")
    s.set_defaults(fn=cmd_ingest)

    s = sub.add_parser("search", help="query a local index")
    s.add_argument("queries", nargs="+")
    s.add_argument("-k", type=int, default=10)
    s.add_argument("--documents-path")
    s.add_argument("--checkpoint", help="load this checkpoint")
    s.add_argument("--model", choices=["bm25", "tfidf", "tfidf_cosine"])
    s.add_argument("--engine-mode", choices=["local", "mesh"])
    s.add_argument("--device",
                   help="torch device of the engine (cuda, cuda:N, cpu); "
                        "default TFIDF_DEVICE, else cuda")
    s.set_defaults(fn=cmd_search)

    s = sub.add_parser("upload", help="upload documents to a cluster")
    s.add_argument("files", nargs="+")
    s.add_argument("--leader", required=True, help="leader base URL")
    s.add_argument("--batch", action="store_true",
                   help="bulk-ingest text files (dirs expand; one "
                        "upload-batch request per 500 docs)")
    s.set_defaults(fn=cmd_upload)

    s = sub.add_parser("query", help="search a running cluster")
    s.add_argument("query", nargs="+")
    s.add_argument("--leader", help="leader base URL")
    s.add_argument("--via-router", metavar="URL",
                   help="route the read through a stateless router "
                        "(prints the X-Route-Epoch/Generation stamp "
                        "and any degraded marker to stderr)")
    s.add_argument("--mode", choices=["sparse", "dense", "hybrid"],
                   default="sparse",
                   help="retrieval plan: sparse TF-IDF (default), "
                        "dense embedding cosine, or hybrid fused "
                        "top-k (prints the stages ran + fusion "
                        "weights to stderr via X-Search-Stages)")
    s.add_argument("--fusion", choices=["rrf", "wsum"],
                   help="hybrid fusion method (default: the cluster's "
                        "fusion_method config)")
    s.set_defaults(fn=cmd_query)

    s = sub.add_parser("status", help="node role + membership + metrics")
    s.add_argument("--leader", required=True, help="any node's base URL")
    s.set_defaults(fn=cmd_status)

    s = sub.add_parser("drain",
                       help="migrate a worker empty before decommission")
    s.add_argument("worker", help="worker base URL to drain")
    s.add_argument("--leader", required=True, help="leader base URL")
    s.add_argument("--cancel", action="store_true",
                   help="cancel an in-progress drain")
    s.add_argument("--wait", action="store_true",
                   help="poll until the worker is fully drained")
    s.add_argument("--wait-timeout", type=float, default=300.0)
    s.set_defaults(fn=cmd_drain)

    s = sub.add_parser("trace",
                       help="fetch + render a distributed trace")
    s.add_argument("trace_id", nargs="?", default="",
                   help="trace id (X-Trace-Id reply header); omit for "
                        "the most recent spans")
    s.add_argument("--leader", required=True, help="any node's base URL")
    s.add_argument("--recent", type=int, default=100,
                   help="span count when no trace id is given")
    s.add_argument("--chrome", metavar="FILE",
                   help="write Chrome-trace/Perfetto JSON here instead "
                        "of the text timeline")
    s.set_defaults(fn=cmd_trace)

    s = sub.add_parser("autopilot",
                       help="inspect / toggle the SLO autopilot")
    s.add_argument("--leader", required=True, help="any node's base URL "
                                                   "(routed to the leader)")
    s.add_argument("--recent", type=int, default=10,
                   help="decision-audit records to show")
    toggle = s.add_mutually_exclusive_group()
    toggle.add_argument("--enable", action="store_true",
                        help="turn the control loop on")
    toggle.add_argument("--disable", action="store_true",
                        help="kill switch: off + revert every knob to "
                             "static config")
    s.add_argument("--json", action="store_true",
                   help="raw JSON instead of the rendered table")
    s.set_defaults(fn=cmd_autopilot)

    s = sub.add_parser("bench", help="run the benchmark on the CUDA card")
    g = s.add_mutually_exclusive_group()
    for mode in ("overload", "replay", "routers", "kernel", "hybrid",
                 "tier", "compute"):
        g.add_argument(f"--{mode}", dest="mode", action="store_const",
                       const=mode, help=f"the root bench.py's --{mode} "
                       "mode (tfidf_tpu_torch/bench_modes.py)")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("scrub",
                       help="storage-integrity verification: checkpoint "
                            "manifests + placed-docs CRC ledger")
    s.add_argument("--url",
                   help="trigger one scrub pass on a running node "
                        "(POST /admin/scrub) instead of offline "
                        "verification")
    s.add_argument("--index-path")
    s.add_argument("--documents-path")
    s.set_defaults(fn=cmd_scrub)

    s = sub.add_parser("quarantine",
                       help="inspect / clear the poison-query "
                            "quarantine on a node or router")
    s.add_argument("url", help="node or router base URL")
    s.add_argument("--clear", action="store_true",
                   help="drop the quarantine table (operator override)")
    s.set_defaults(fn=cmd_quarantine)

    s = sub.add_parser("faults",
                       help="chaos tooling: inspect fault points")
    s.add_argument("action", choices=["list"],
                   help="list: print all registered fault points")
    s.set_defaults(fn=cmd_faults)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
