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
CLI_BENCH = ("`bench` runs the TPU bench.py; the port's bench is ROADMAP "
             "queue A item 12")
CLI_SIGTERM = ("serve/router/coordinator park in bounded waits: a SIGTERM "
               "handled on another thread does not interrupt a blocking "
               "Event.wait, and the process never stopped (ROADMAP queue C)")
CLI_MESH = ("multi-host (`distributed`) is the mesh slice, ROADMAP item 7: "
            "it raises NotImplementedError")

VIEW_READ = ("a placement follower re-reads the placement znode only when "
             "it changed (get_data by digest): a full read of the ~39 MB "
             "map every second per follower starved the router of the "
             "1M-doc fleet and stamped its replies stale_view "
             "(ROADMAP queue C); a server without the `unless` key sends "
             "the data, so the wire stays the reference's")

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
        ('''        # multi-host mesh over DCN: must happen before any backend use so
        # jax.devices() spans the pod (auto-detected on TPU pods)
        from tfidf_tpu_torch.parallel.mesh import initialize_multihost
        initialize_multihost(
            coordinator_address=cfg.dist_coordinator or None,
            num_processes=cfg.dist_num_processes or None,
            process_id=(cfg.dist_process_id
                        if cfg.dist_process_id >= 0 else None))
''', '''        raise NotImplementedError(
            "tfidf_tpu_torch: distributed (multi-host mesh) serving is not "
            "ported yet (ROADMAP queue A item 11 / 'Still to port' item 7); "
            "use the tfidf_tpu package for it")
    device = _device(args)
''', CLI_MESH + "; " + CLI_DEVICE),
        ("engine, meta = restore_checkpoint(ckpt_dir, cfg)",
         "engine, meta = restore_checkpoint(ckpt_dir, cfg, device=device)",
         "restore-at-boot onto the chosen device"),
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
''', '''                   help="multi-host mesh serving (not ported yet: "
                        "raises NotImplementedError)")
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
        ('''    s = sub.add_parser("bench", help="run the TPU benchmark")
    s.set_defaults(fn=cmd_bench)
''', "", CLI_BENCH),
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

# every verbatim copy of the port; the cluster plane and the CLI are this
# slice's, the rest are the host layers of the earlier slices
COPIES = sorted(
    ["cluster/" + n for n in (
        "__init__.py", "admission.py", "autopilot.py", "batcher.py",
        "coordination.py", "election.py", "ensemble.py", "fencing.py",
        "fusion.py", "nemesis.py", "node.py", "placement.py",
        "protover.py", "quarantine.py", "rebalance.py", "registry.py",
        "resilience.py", "router.py", "wal.py", "wire.py")]
    + ["cli.py", "__main__.py"]
    + ["utils/" + n for n in ("config.py", "faults.py", "logging.py",
                              "metrics.py", "storage.py", "tracing.py")]
    + ["models/base.py", "models/bm25.py", "models/tfidf.py",
       "ops/analyzer.py", "engine/embedder.py", "engine/pipeline.py"])


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
