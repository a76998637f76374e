"""The port's verbatim copies stay copies.

Most of the port's host layers are the JAX package's modules with the
import prefix ``tfidf_tpu`` rewritten to ``tfidf_tpu_torch``: the cluster
plane, the CLI, the utils, the models, the analyzer, the embedder and the
serving pipeline. Each case below holds one such module to its reference:
the reference source, prefix rewritten and the listed hunks applied, must
parse to the same code as the port's source. Comments and docstrings are
not compared (the port's copies may say what they are in their own
words); every statement, expression and name is.

A hunk is either a text replacement ``(reference text, port text,
reason)`` that must match the rewritten reference exactly once, or a set
of top-level names the port defines on its own (dropped from both sides
before the comparison, with the reason). A copy that drifts from the
reference, or a hunk that no longer applies, fails here on the CPU.
"""

import ast
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DEVICE_ARG = '''    s.add_argument("--device",
                   help="torch device of the engine (cuda, cuda:N, cpu); "
                        "default TFIDF_DEVICE, else cuda")
'''

CLI_DEVICE = "the CLI's device choice (--device / TFIDF_DEVICE, default cuda)"
CLI_BENCH = ("`bench` runs the port's own bench (tfidf_tpu_torch/bench.py) "
             "on the card, not the root bench.py; without CUDA it exits "
             "with the CUDA message")
CLI_BENCH_MODES = ("`bench --<mode>` runs one of the root bench.py's other "
                   "modes through the port's tfidf_tpu_torch/bench_modes.py "
                   "(the reference's subcommand takes no flag)")
_BENCH_MODES = '''    g = s.add_mutually_exclusive_group()
    for mode in ("overload", "replay", "routers", "kernel", "hybrid",
                 "tier", "compute"):
        g.add_argument(f"--{mode}", dest="mode", action="store_const",
                       const=mode, help=f"the root bench.py's --{mode} "
                       "mode (tfidf_tpu_torch/bench_modes.py)")
'''
CLI_SIGTERM = ("serve/router/coordinator park in bounded waits: a SIGTERM "
               "handled on another thread does not interrupt a blocking "
               "Event.wait, and the process never stopped (ROADMAP queue C)")
CLI_BOOT = ("`serve` times its boot (tfidf_tpu_torch/boot.py): the torch "
            "import, the CUDA context and the kernel library's first load "
            "happen as steps of their own, each timed, and the node prints "
            "one `boot split {...}` line once it is up")
CLI_MESH = ("multi-host (`distributed`): the process group's backend "
            "follows the CLI's device (NCCL on the card, gloo with --device "
            "cpu), so the device is resolved first and passed on")

VIEW_READ = ("a placement follower re-reads the placement znode only when "
             "it changed (get_data by digest): a full read of the ~39 MB "
             "map every second per follower starved the router of the "
             "1M-doc fleet and stamped its replies stale_view "
             "(ROADMAP queue C); a server without the `unless` key sends "
             "the data, so the wire stays the reference's")

LAST_REPLICA = ("a name that loses its last replica cancels every pending "
                "delete of it and the leader remembers its last holders: a "
                "copy scheduled away by an earlier death may be the only one "
                "left, and the reference deleted it on rejoin and called the "
                "other survivors ghosts, losing acked writes in the "
                "partition chaos job (ROADMAP queue C); a client delete of "
                "the name still reaches every remembered holder. The "
                "placement bytes keep their format")

REJOIN_CLOSE = ("a failed session-expiry rejoin attempt closes its own "
                "session (its expiry then starts no second rejoin): left "
                "open, its heartbeat kept the attempt's registry entry and "
                "election candidate alive beside the next attempt's, the "
                "node listed twice and an orphan candidate first in line, "
                "in the partition chaos job (ROADMAP queue C)")

DELETING = ("a load (this node re-elected) skips the names of a client "
            "delete whose durable flush has not returned: the reference "
            "merged them back from the not-yet-rewritten znode and the "
            "flush then wrote them back, resurrecting an acked delete in "
            "the partition chaos job (ROADMAP queue C)")
TOMBSTONE = ("the leader remembers the names client deletes removed in its "
             "tenure: a copy that shows up later (a worker away at the "
             "time, an ex-leader's engine) is a ghost, never an orphan to "
             "adopt or re-place; the reference adopted or re-placed such "
             "copies, resurrecting acked deletes in the partition chaos "
             "job (ROADMAP queue C); a new upload of the name, or a loaded "
             "map that holds it, lifts the tombstone")

DELETE_FENCE = ("a client delete is acknowledged only while its leader still "
                "leads after the durable flush: a deposed leader acked a "
                "delete whose flush landed after a successor had loaded the "
                "map, and the successor adopted the copies back (ROADMAP "
                "queue C)")

RESIDUE_AFTER_LOAD = ("the residue pass waits for the new leader's map load "
                      "(persistence enabled): the reference's ran on the "
                      "empty map first and adopted every copy it found, an "
                      "acked delete's leftovers included, in the partition "
                      "chaos job (ROADMAP queue C)")

MOVED_AT_CONFIRM = ("a re-placement of a dead worker's names records each "
                    "name's pending delete on that worker in the same "
                    "locked step that confirms its new copy (leg_success "
                    "moved_from): the reference confirmed the copies, "
                    "wrote the store, and only then noted the moves, so "
                    "a reader between the two saw the recovery done with "
                    "no delete pending, and the resilience rejoin chaos "
                    "job took that window for convergence (ROADMAP queue "
                    "C)")

# module (relative to the package) -> list of hunks
HUNKS = {
    "cluster/coordination.py": [
        ("import json\nimport threading\n",
         "import hashlib\nimport json\nimport threading\n", VIEW_READ),
        ({"data_digest"}, VIEW_READ),
        ("""        self._watches: dict[tuple[str, str], set[int]] = {}
        self._closed = False
""", """        self._watches: dict[tuple[str, str], set[int]] = {}
        self._digests: dict[str, tuple[bytes, str]] = {}
        self._closed = False
""", VIEW_READ),
        ("""    def get_data(self, sid: int, path: str) -> bytes:
        with self._lock:
            return self._resolve(_split(path)).data
""", """    def get_data(self, sid: int, path: str) -> bytes:
        with self._lock:
            return self._resolve(_split(path)).data

    def get_data_if_changed(self, sid: int, path: str,
                            digest: str) -> bytes | None:
        data = self.get_data(sid, path)
        got = self._digests.get(path)
        if got is None or got[0] is not data:
            got = (data, data_digest(data))
            self._digests[path] = got
        return None if got[1] == digest else data
""", VIEW_READ),
        ("""    def get_data(self, path) -> bytes:
        return self.core.get_data(self.sid, path)
""", """    def get_data(self, path) -> bytes:
        return self.core.get_data(self.sid, path)

    def get_data_if_changed(self, path, digest: str) -> bytes | None:
        return self.core.get_data_if_changed(self.sid, path, digest)
""", VIEW_READ),
        ("""            elif op == "get_data":
""", """            elif op == "get_data" and "unless" in req:
                data = self.core.get_data_if_changed(sid, req["path"],
                                                     req["unless"])
                self._reply({"unchanged": True} if data is None
                            else {"data": data.hex()})
            elif op == "get_data":
""", VIEW_READ),
        ("""    def get_data(self, path) -> bytes:
        return bytes.fromhex(self._rpc({"op": "get_data",
                                        "path": path})["data"])
""", """    def get_data(self, path) -> bytes:
        return bytes.fromhex(self._rpc({"op": "get_data",
                                        "path": path})["data"])

    def get_data_if_changed(self, path, digest: str) -> bytes | None:
        r = self._rpc({"op": "get_data", "path": path, "unless": digest})
        return None if r.get("unchanged") else bytes.fromhex(r["data"])
""", VIEW_READ),
    ],
    "cluster/placement.py": [
        ('    def leg_success(self, name: str, worker: str) -> None:\n        """One upload leg accepted by ``worker``: the placement of\n        ``name`` on it is confirmed (and becomes persistable AND\n        ownable — confirmation changes the owner-candidate set, so the\n        generation bumps)."""\n        with self.lock:',
         '    def leg_success(self, name: str, worker: str,\n                    moved_from: str | None = None) -> bool:\n        """One upload leg accepted by ``worker``: the placement of\n        ``name`` on it is confirmed (and becomes persistable AND\n        ownable — confirmation changes the owner-candidate set, so the\n        generation bumps). ``moved_from``: the leg re-places the name\n        away from that (dead) worker; its pending delete there is\n        recorded in the same step, under the same rule as\n        :meth:`note_moved`, so no reader sees the new copy without the\n        old one\'s pending delete. Returns whether it was recorded."""\n        noted = False\n        with self.lock:',
         MOVED_AT_CONFIRM),
        ('            if worker not in reps:\n                self.replicas[name] = reps + (worker,)\n                self.gen += 1\n            self._unmove_locked(worker, name)\n            self._mark_dirty_locked()\n\n    def reset_for_follower(self) -> None:',
         '            if worker not in reps:\n                self.replicas[name] = reps + (worker,)\n                self.gen += 1\n            self._unmove_locked(worker, name)\n            if moved_from is not None \\\n                    and moved_from not in self.replicas[name]:\n                moved = self.moved.setdefault(moved_from, set())\n                if name not in moved:\n                    moved.add(name)\n                    self.gen += 1\n                    noted = True\n            self._mark_dirty_locked()\n        return noted\n\n    def reset_for_follower(self) -> None:',
         MOVED_AT_CONFIRM),
        ("""        self._confirmed: dict[str, set[str]] = {}
        self._inflight""", """        self._confirmed: dict[str, set[str]] = {}
        self._dark: dict[str, set[str]] = {}
        self._inflight""", LAST_REPLICA),
        ("""            self._confirmed.clear()
            self.migrations.clear()
""", """            self._confirmed.clear()
            self._dark.clear()
            self.migrations.clear()
""", LAST_REPLICA),
        ("""                    del self.replicas[name]
                    self._confirmed.pop(name, None)
                    lost.append(name)
""", """                    del self.replicas[name]
                    self._confirmed.pop(name, None)
                    lost.append(name)
            for name in lost:
                dark = self._dark.setdefault(name, set())
                dark.add(worker)
                for w, ns in list(self.moved.items()):
                    if name in ns:
                        dark.add(w)
                        ns.discard(name)
                        if not ns:
                            del self.moved[w]
""", LAST_REPLICA),
        ("""                reps = self.replicas.pop(name, None)
                if reps is None and not also:
                    continue
                conf = self._confirmed.pop(name, set())
                targets = set(also)
""", """                reps = self.replicas.pop(name, None)
                dark = self._dark.pop(name, ())
                if reps is None and not also and not dark:
                    continue
                conf = self._confirmed.pop(name, set())
                targets = set(also) | set(dark)
""", LAST_REPLICA),
        ("""                    self._confirmed[name] = {worker}
                    orphans.append(name)
""", """                    self._confirmed[name] = {worker}
                    self._dark.pop(name, None)
                    orphans.append(name)
""", LAST_REPLICA),
        ("""        self._inflight: dict[tuple[str, str], int] = {}
""", """        self._deleting: set[str] = set()
        self._tombstones: set[str] = set()
        self._inflight: dict[tuple[str, str], int] = {}
""", DELETING),
        ("""        held = self.replicas.get(name)
        if held:
            live_held""", """        self._tombstones.discard(name)
        held = self.replicas.get(name)
        if held:
            live_held""", TOMBSTONE),
        ("""            self._dark.clear()
            self.migrations.clear()
""", """            self._dark.clear()
            self._tombstones.clear()
            self.migrations.clear()
""", TOMBSTONE),
        ("""        with self.lock:
            for name in names:
                reps = self.replicas.pop(name, None)
""", """        with self.lock:
            self._deleting.update(names)
            self._tombstones.update(names)
            for name in names:
                reps = self.replicas.pop(name, None)
""", DELETING),
        ("""            for name, ws in loaded.items():
                if name not in self.replicas:
""", """            for name, ws in loaded.items():
                if name in self._deleting:
                    continue
                self._tombstones.discard(name)
                if name not in self.replicas:
""", DELETING),
        ("""                pending_anywhere = any(name in ns
                                       for ns in self.moved.values())
""", """                pending_anywhere = name in self._tombstones or any(
                    name in ns for ns in self.moved.values())
""", TOMBSTONE),
        ("""                if name in self.replicas:
                    continue
                if any(name in ns for ns in self.moved.values()):
""", """                if name in self.replicas or name in self._tombstones:
                    continue
                if any(name in ns for ns in self.moved.values()):
""", TOMBSTONE),
        ("""    def add_replica(self, name: str, worker: str) -> bool:
""", """    def delete_settled(self, names) -> None:
        with self.lock:
            self._deleting.difference_update(names)

    def add_replica(self, name: str, worker: str) -> bool:
""", DELETING),
        ("""                                            NoNodeError)
""", """                                            NoNodeError,
                                            data_digest)
""", VIEW_READ),
        ("""        self._last_raw: bytes | None = None
""", """        self._last_raw: bytes | None = None
        self._last_digest: str | None = None
""", VIEW_READ),
        ("""        try:
            raw = coord.get_data(PLACEMENT_STATE)
        except NoNodeError:
            raw = None   # pre-first-flush cluster: an EMPTY view is
            #              current, not a failure
        self._last_ok = time.monotonic()
        global_metrics.inc("router_view_refreshes")
        if raw != self._last_raw:
            self._install(raw)
            self._last_raw = raw
""", """        try:
            if self._last_digest is None:
                raw = coord.get_data(PLACEMENT_STATE)
            else:
                raw = coord.get_data_if_changed(PLACEMENT_STATE,
                                                self._last_digest)
                if raw is None:
                    raw = self._last_raw
        except NoNodeError:
            raw = None
        self._last_ok = time.monotonic()
        global_metrics.inc("router_view_refreshes")
        if raw != self._last_raw:
            self._install(raw)
            self._last_raw = raw
            self._last_digest = None if raw is None else data_digest(raw)
""", VIEW_READ),
    ],
    "cluster/node.py": [
        ('    def _replace_batch(self, docs: list[dict], old_worker: str) -> int:\n        try:\n            resp = self.leader_upload_batch(docs)',
         '    def _replace_batch(self, docs: list[dict], old_worker: str) -> int:\n        try:\n            resp = self.leader_upload_batch(docs, moved_from=old_worker)',
         MOVED_AT_CONFIRM),
        ('        not_placed = {s["name"] for s in resp.get("skipped", ())}\n        not_placed.update(resp.get("failed", ()))\n        return self._note_moved(\n            [d["name"] for d in docs if d["name"] not in not_placed],\n            old_worker)',
         '        return resp["moved"]',
         MOVED_AT_CONFIRM),
        ('    def _leg_succeeded(self, name: str, worker: str,\n                       nbytes: int) -> None:',
         '    def _leg_succeeded(self, name: str, worker: str, nbytes: int,\n                       moved_from: str | None = None) -> bool:',
         MOVED_AT_CONFIRM),
        ('        self.bump_result_generation()\n        self.placement.leg_success(name, worker)\n        with self._placement_lock:\n            sizes = self._size_cache[1]\n            if worker in sizes:\n                sizes[worker] += nbytes\n',
         '        self.bump_result_generation()\n        noted = self.placement.leg_success(name, worker, moved_from)\n        with self._placement_lock:\n            sizes = self._size_cache[1]\n            if worker in sizes:\n                sizes[worker] += nbytes\n        return noted\n',
         MOVED_AT_CONFIRM),
        ('    def leader_upload_batch(self, docs: list[dict]) -> dict:',
         '    def leader_upload_batch(self, docs: list[dict],\n                            moved_from: str | None = None) -> dict:',
         MOVED_AT_CONFIRM),
        ('        confirmed_names: set[str] = set()\n        for fut, (w, group) in futs.items():',
         '        confirmed_names: set[str] = set()\n        moved = 0\n        for fut, (w, group) in futs.items():',
         MOVED_AT_CONFIRM),
        ('                self._leg_succeeded(name, w, len(d.get("text", "")))\n                confirmed_names.add(name)',
         '                moved += self._leg_succeeded(\n                    name, w, len(d.get("text", "")), moved_from)\n                confirmed_names.add(name)',
         MOVED_AT_CONFIRM),
        ('        out = {"placed": placed}\n        if skipped_by_name:\n            out["skipped"] = list(skipped_by_name.values())',
         '        out = {"placed": placed}\n        if moved_from is not None:\n            out["moved"] = moved\n        if skipped_by_name:\n            out["skipped"] = list(skipped_by_name.values())',
         MOVED_AT_CONFIRM),
        ("""        while not self._stopping:
            try:
                coord = self._coord_factory()
""", """        while not self._stopping:
            coord = None
            attempt = {"live": True}

            def on_expiry(ev, attempt=attempt) -> None:
                if attempt["live"]:
                    self._on_session_event(ev)
            try:
                coord = self._coord_factory()
""", REJOIN_CLOSE),
        ("""                self.election = LeaderElection(coord, callback=self)
                coord.on_session_event(self._on_session_event)
""", """                self.election = LeaderElection(coord, callback=self)
                coord.on_session_event(on_expiry)
""", REJOIN_CLOSE),
        ("""        if scheduled and not self._delete_flush_ok():
            raise RuntimeError(
                "delete not acknowledged: placement removal could not "
                "be made durable (the doc is gone from THIS leader's "
                "results, but a failover could resurrect it)")
""", """        try:
            if scheduled and not self._delete_flush_ok():
                raise RuntimeError(
                    "delete not acknowledged: placement removal could not "
                    "be made durable (the doc is gone from THIS leader's "
                    "results, but a failover could resurrect it)")
            if scheduled and not self.is_leader():
                raise RuntimeError(
                    "delete not acknowledged: leadership was lost while "
                    "the removal was made durable")
        finally:
            self.placement.delete_settled(names)
""", DELETING + "; " + DELETE_FENCE),
        ("""        live = set(self.registry.get_all_service_addresses())
        if not live:
            return {}
        protected = self.placement.migrating_names()
""", """        if not self.placement._persist_enabled:
            return {}
        live = set(self.registry.get_all_service_addresses())
        if not live:
            return {}
        protected = self.placement.migrating_names()
""", RESIDUE_AFTER_LOAD),
        ("""                log.warning("rejoin attempt failed", err=repr(e))
""", """                log.warning("rejoin attempt failed", err=repr(e))
                if coord is not None:
                    attempt["live"] = False
                    try:
                        coord.close()
                    except Exception:
                        pass
""", REJOIN_CLOSE),
        ("engine: Engine | None = None, coord_factory=None) -> None:",
         "engine: Engine | None = None, coord_factory=None,\n"
         "                 device=None) -> None:",
         "the device seam: a node that builds its own engine places it on "
         "`device` (None = the CUDA card)"),
        ("self.engine = engine or Engine(self.config)",
         "self.engine = engine or Engine(self.config, device=device)",
         "the device seam"),
    ],
    "cluster/resilience.py": [
        ({"_COMPUTE_OOM_MARKS", "_COMPUTE_COMPILE_MARKS",
          "_COMPUTE_TRANSIENT_MARKS", "classify_compute_fault"},
         "the merged classifier: the port's torch/CUDA classes replace the "
         "jaxlib type names and marks; kernel build and launch errors are "
         "never device faults (test_port_classifier below)"),
    ],
    "cli.py": [
        ({"_device", "cmd_bench", "_apply_platform_override"},
         "the port's device choice replaces the JAX platform override; "
         + CLI_BENCH),
        ("def cmd_serve(args) -> int:\n",
         "def cmd_serve(args) -> int:\n"
         "    from tfidf_tpu_torch.boot import BootClock\n"
         "    clock = BootClock()\n"
         "    clock.torch_import()\n", CLI_BOOT),
        ('''    if cfg.distributed:
        # multi-host mesh over DCN: must happen before any backend use so
        # jax.devices() spans the pod (auto-detected on TPU pods)
        from tfidf_tpu_torch.parallel.mesh import initialize_multihost
        initialize_multihost(
            coordinator_address=cfg.dist_coordinator or None,
            num_processes=cfg.dist_num_processes or None,
            process_id=(cfg.dist_process_id
                        if cfg.dist_process_id >= 0 else None))
''', '''    device = _device(args)
    clock.device(device, kernel=cfg.use_pallas)
    if cfg.distributed:
        from tfidf_tpu_torch.parallel.mesh import initialize_multihost
        initialize_multihost(
            coordinator_address=cfg.dist_coordinator or None,
            num_processes=cfg.dist_num_processes or None,
            process_id=(cfg.dist_process_id
                        if cfg.dist_process_id >= 0 else None),
            device=device)
''', CLI_MESH + "; " + CLI_DEVICE + "; " + CLI_BOOT),
        ("engine, meta = restore_checkpoint(ckpt_dir, cfg)",
         "engine, meta = restore_checkpoint(ckpt_dir, cfg, device=device)",
         "restore-at-boot onto the chosen device"),
        ('''          f"coordinator {cfg.coordinator_address}", flush=True)

    stop = threading.Event()
''', '''          f"coordinator {cfg.coordinator_address}", flush=True)
    print(clock.line(), flush=True)

    stop = threading.Event()
''', CLI_BOOT),
        ("node = SearchNode(cfg, coord_factory=factory, engine=engine).start(",
         "node = SearchNode(cfg, coord_factory=factory, engine=engine,\n"
         "                      device=device).start(",
         CLI_DEVICE),
        ('''    cfg = _load_cfg(args)
    engine = Engine(cfg)
''', '''    cfg = _load_cfg(args)
    engine = Engine(cfg, device=_device(args))
''', CLI_DEVICE),
        ('''    cfg = _load_cfg(args)
    if args.checkpoint:
        engine = load_checkpoint(args.checkpoint, cfg)
    else:
        engine = Engine(cfg)
''', '''    cfg = _load_cfg(args)
    device = _device(args)
    if args.checkpoint:
        engine = load_checkpoint(args.checkpoint, cfg, device=device)
    else:
        engine = Engine(cfg, device=device)
''', CLI_DEVICE),
        ('description="TPU-native distributed full-text search framework")',
         'description="distributed full-text search framework "\n'
         '                    "(PyTorch/CUDA)")',
         "the port's own description"),
        ('''                   help="multi-host: jax.distributed.initialize before "
                        "building the mesh (auto-detected on TPU pods; "
                        "see TFIDF_DIST_* / JAX_* env vars)")
''', '''                   help="multi-process mesh: join a torch.distributed "
                        "group (NCCL on the card, gloo on the CPU) before "
                        "building the mesh (see TFIDF_DIST_* env vars)")
''' + _DEVICE_ARG, CLI_MESH + "; " + CLI_DEVICE),
        ('''    s.add_argument("--engine-mode", choices=["local", "mesh"])
    s.set_defaults(fn=cmd_ingest)
''', '''    s.add_argument("--engine-mode", choices=["local", "mesh"])
''' + _DEVICE_ARG + '''    s.set_defaults(fn=cmd_ingest)
''', CLI_DEVICE),
        ('''    s.add_argument("--engine-mode", choices=["local", "mesh"])
    s.set_defaults(fn=cmd_search)
''', '''    s.add_argument("--engine-mode", choices=["local", "mesh"])
''' + _DEVICE_ARG + '''    s.set_defaults(fn=cmd_search)
''', CLI_DEVICE),
        ('s = sub.add_parser("bench", help="run the TPU benchmark")\n',
         's = sub.add_parser("bench", help="run the benchmark on the CUDA '
         'card")\n' + _BENCH_MODES, CLI_BENCH + "; " + CLI_BENCH_MODES),
        ("    _apply_platform_override()\n", "",
         "no JAX platform to pin; " + CLI_DEVICE),
        ("    stop.wait()   # the main thread parks",
         "    while not stop.wait(1.0):\n        pass\n    #", CLI_SIGTERM),
        ("    stop.wait()\n    router.stop()",
         "    while not stop.wait(1.0):\n        pass\n    router.stop()",
         CLI_SIGTERM),
        ("    stop.wait()\n    server.close()",
         "    while not stop.wait(1.0):\n        pass\n    server.close()",
         CLI_SIGTERM),
    ],
    "__main__.py": [
        ("sys.exit(main())",
         'if __name__ == "__main__":\n    sys.exit(main())',
         "importing the module must not run the CLI (the import-closure "
         "test walks every module of the package)"),
    ],
    "utils/tracing.py": [
        ('''try:  # jax is always present in this image, but keep host-only tools usable
    import jax.profiler as _jprof
except Exception:  # pragma: no cover
    _jprof = None
''', "from torch.profiler import record_function\n",
         "phase ranges are torch.profiler ranges, not JAX annotations"),
        ('''    ann = (_jprof.TraceAnnotation(name) if _jprof is not None
           else contextlib.nullcontext())
    with ann:
''', "    with record_function(name):\n",
         "phase ranges are torch.profiler ranges"),
    ],
}

# every verbatim copy of the port: the cluster plane and the CLI, the host
# layers of the earlier slices, and the streaming slice's block-max bounds
COPIES = sorted(
    ["cluster/" + n for n in (
        "__init__.py", "admission.py", "autopilot.py", "batcher.py",
        "coordination.py", "election.py", "ensemble.py", "fencing.py",
        "fusion.py", "nemesis.py", "node.py", "placement.py",
        "protover.py", "quarantine.py", "rebalance.py", "registry.py",
        "resilience.py", "router.py", "wal.py", "wire.py")]
    + ["cli.py", "__main__.py"]
    + ["utils/" + n for n in ("config.py", "faults.py", "logging.py",
                              "metrics.py", "storage.py", "textgen.py",
                              "tracing.py")]
    + ["models/base.py", "models/bm25.py", "models/tfidf.py",
       "ops/analyzer.py", "ops/blockmax.py", "engine/embedder.py",
       "engine/pipeline.py"])


def _read(*parts):
    with open(os.path.join(ROOT, *parts), encoding="utf-8") as f:
        return f.read()


def _code(src, own=frozenset()):
    """The module's code as an AST dump: docstrings dropped, and the
    top-level definitions named in ``own`` removed."""
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]

    def defines(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return node.name in own
        if isinstance(node, ast.Assign):
            return any(isinstance(t, ast.Name) and t.id in own
                       for t in node.targets)
        return False

    tree.body = [n for n in tree.body if not defines(n)]
    return ast.dump(tree)


def _expected(module):
    src = re.sub(r"\btfidf_tpu\b", "tfidf_tpu_torch",
                 _read("tfidf_tpu", module))
    own = set()
    for hunk in HUNKS.get(module, ()):
        if isinstance(hunk[0], set):
            own |= hunk[0]
            continue
        old, new, _reason = hunk
        assert src.count(old) == 1, (
            f"hunk of {module} no longer matches the reference "
            f"exactly once: {old[:60]!r}")
        src = src.replace(old, new)
    return src, own


@pytest.mark.parametrize("module", COPIES)
def test_copy_matches_reference(module):
    src, own = _expected(module)
    port = _read("tfidf_tpu_torch", module)
    assert _code(port, own) == _code(src, own), (
        f"tfidf_tpu_torch/{module} drifted from tfidf_tpu/{module}: "
        "copy the reference again, or list the deviation in HUNKS with "
        "its reason")


def test_every_hunk_has_a_reason():
    for module, hunks in HUNKS.items():
        assert module in COPIES, module
        for hunk in hunks:
            reason = hunk[-1]
            assert isinstance(reason, str) and len(reason) > 10, hunk


def _top_names(src):
    tree = ast.parse(src)
    names = {n.name for n in tree.body
             if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    return names | {t.id for n in tree.body if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Name)}


def test_own_definitions_exist():
    """Every name listed as the port's own is defined in the port or in
    the reference (a stale listing would hide a deleted definition)."""
    for module, hunks in HUNKS.items():
        defined = (_top_names(_read("tfidf_tpu_torch", module))
                   | _top_names(_read("tfidf_tpu", module)))
        for hunk in hunks:
            if isinstance(hunk[0], set):
                assert hunk[0] <= defined, (module, hunk[0] - defined)


def _kernel_errors():
    from tfidf_tpu_torch.kernels import KernelBuildError, KernelLaunchError
    return KernelBuildError("nvcc failed"), KernelLaunchError("refused")


@pytest.mark.parametrize("case", [
    "kernel_build", "kernel_launch", "torch_oom", "cuda_oom_message",
    "cuda_illegal_address", "generic_runtime", "jaxlib_name",
    "typed_nemesis", "stamped"])
def test_port_classifier(case):
    """The merged ``classify_compute_fault`` keeps the port's classes:
    kernel build and launch errors are never device faults (a fallback
    that absorbed them would hide the kernel), torch's OOM and CUDA
    runtime errors are, and a jaxlib type name means nothing here."""
    import torch

    from tfidf_tpu_torch.cluster.resilience import classify_compute_fault
    from tfidf_tpu_torch.utils.device_nemesis import DeviceOOMError
    build, launch = _kernel_errors()
    xla = type("XlaRuntimeError", (RuntimeError,), {})
    stamped = RuntimeError("x")
    stamped.compute_fault = "compile"
    cases = {
        "kernel_build": (build, None),
        "kernel_launch": (launch, None),
        "torch_oom": (torch.cuda.OutOfMemoryError("CUDA out of memory"),
                      "oom"),
        "cuda_oom_message": (RuntimeError("CUDA out of memory. Tried"),
                             "oom"),
        "cuda_illegal_address": (RuntimeError(
            "CUDA error: an illegal memory access was encountered"),
            "transient"),
        "generic_runtime": (RuntimeError("something else"), None),
        "jaxlib_name": (xla("INTERNAL: remote_compile failed"), None),
        "typed_nemesis": (DeviceOOMError("injected"), "oom"),
        "stamped": (stamped, "compile"),
    }
    exc, want = cases[case]
    assert classify_compute_fault(exc) == want
