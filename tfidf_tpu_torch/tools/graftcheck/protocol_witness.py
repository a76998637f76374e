"""Runtime protocol witness — the dynamic half of the wire-contract
check (:mod:`.protocol`), same structure as the lockdep witness: the
static passes over-approximate what the handlers CAN answer; a runtime
trace alone sees only the exchanges that happened to run. Each side
validates the other:

- the witness instruments the package's handler classes while
  installed and records every actual exchange — (plane, method,
  endpoint, status, contract reply headers, whether the request
  carried a trace id) — with zero cost when not installed (nothing
  under ``tfidf_tpu_torch/`` imports this module; production handlers run
  unpatched);
- :meth:`ProtocolWitness.check` fails on any observed exchange the
  static contract cannot explain (an endpoint the route extraction
  missed, a status outside the reviewed set, a front-door 429/503
  without ``Retry-After``, a ``/leader/start`` 200 without its route
  stamp, a traced worker RPC whose reply lost ``X-Trace-Id``, any
  reply on either plane missing its ``X-Proto-Version`` wire-version
  stamp) — and,
  lockdep-style in the other direction, on statically-claimed contract
  surface the run never exercised (``require_exercised``).

Install patches ``send_response``/``send_header``/``end_headers`` on
the two handler family roots (``_HttpHandlerBase`` — the front door —
and ``_CoordHandler`` — the coordination plane); runtime-subclassed
handlers (``type("Handler", (_RouterHandler,), ...)``) inherit the
instrumented methods through the MRO, so every in-process server built
after OR before install is observed.
"""

from __future__ import annotations

import os
import re
import threading
from dataclasses import dataclass, field

from tfidf_tpu_torch.tools.graftcheck.protocol import (
    CONTRACT_HEADERS, WireContract, build_contract)

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))

# well-formed trace ids only (utils/tracing.py's _ID_RE grammar, same
# bounds): a malformed header never makes it into a span, so it owes
# no reply stamp
_ID_RE = re.compile(r"[0-9a-f]{8,64}")

# the core scatter/mutation spine an instrumented run must actually
# drive — a run that never exercised these proved nothing
CORE_EXERCISED = frozenset((
    "/leader/start",
    "/worker/process-batch",
    "/leader/upload-batch",
    "/worker/delete",
    "/rpc",
))

# endpoints whose replies must echo X-Trace-Id whenever the REQUEST
# carried a well-formed trace id (the leader->worker continuation)
_TRACED_WORKER_PATHS = frozenset(("/worker/process",
                                  "/worker/process-batch"))


@dataclass(frozen=True)
class Exchange:
    plane: str               # "front" | "coord"
    method: str
    path: str                # query-stripped
    status: int
    headers: frozenset      # reply headers ∩ CONTRACT_HEADERS
    traced_request: bool


@dataclass
class _Patched:
    cls: type
    saved: dict = field(default_factory=dict)   # name -> (had, orig)


class ProtocolWitness:
    """Record real HTTP exchanges and check them against the statically
    computed wire contract. Use as a context manager::

        with ProtocolWitness() as w:
            ... drive the cluster ...
        w.check(require_exercised=CORE_EXERCISED, min_exchanges=10)
    """

    def __init__(self, root: str = _REPO_ROOT,
                 contract: WireContract | None = None) -> None:
        self.contract = contract or build_contract(root)
        self._mu = threading.Lock()
        self.exchanges: dict[Exchange, int] = {}
        self._patched: list[_Patched] = []

    # ---- recording ----

    def observe(self, plane: str, method: str, path: str, status: int,
                reply_headers=(), traced_request: bool = False) -> None:
        """Record one exchange (the instrumented handlers call this;
        seeded tests may call it directly)."""
        ex = Exchange(plane, method, path.split("?")[0], int(status),
                      frozenset(h for h in reply_headers
                                if h in CONTRACT_HEADERS),
                      traced_request)
        with self._mu:
            self.exchanges[ex] = self.exchanges.get(ex, 0) + 1

    # ---- install / uninstall ----

    def install(self) -> "ProtocolWitness":
        import tfidf_tpu_torch.cluster.coordination as coord_mod
        import tfidf_tpu_torch.cluster.router as router_mod

        assert not self._patched
        self._patch(router_mod._HttpHandlerBase, "front")
        self._patch(coord_mod._CoordHandler, "coord")
        return self

    def _patch(self, cls: type, plane: str) -> None:
        witness = self
        rec = _Patched(cls)
        for name in ("send_response", "send_header", "end_headers"):
            rec.saved[name] = (name in cls.__dict__, getattr(cls, name))
        orig_sr = rec.saved["send_response"][1]
        orig_sh = rec.saved["send_header"][1]
        orig_eh = rec.saved["end_headers"][1]
        # per-WITNESS accumulator attribute: two concurrently-installed
        # witnesses (the session fixture plus a test's own) each layer
        # their wrappers and must each see every reply — a shared name
        # would let the inner wrapper pop the outer one's state
        pend = f"_pw_pending_{id(self):x}"

        def send_response(self, code, message=None):
            # per-response accumulator on the handler instance: status
            # now, header names as they stream out, flushed at
            # end_headers (one record per reply, keep-alive included)
            setattr(self, pend, {"status": code, "hdrs": set()})
            return orig_sr(self, code, message)

        def send_header(self, keyword, value):
            st = getattr(self, pend, None)
            if st is not None:
                st["hdrs"].add(keyword)
            return orig_sh(self, keyword, value)

        def end_headers(self):
            st = self.__dict__.pop(pend, None)
            if st is not None:
                req_trace = None
                headers = getattr(self, "headers", None)
                if headers is not None:
                    req_trace = headers.get("X-Trace-Id")
                witness.observe(
                    plane, getattr(self, "command", "?") or "?",
                    getattr(self, "path", "") or "", st["status"],
                    st["hdrs"],
                    bool(req_trace
                         and _ID_RE.fullmatch(req_trace.strip())))
            return orig_eh(self)

        cls.send_response = send_response
        cls.send_header = send_header
        cls.end_headers = end_headers
        self._patched.append(rec)

    def uninstall(self) -> None:
        for rec in self._patched:
            for name, (had, orig) in rec.saved.items():
                if had:
                    setattr(rec.cls, name, orig)
                else:
                    delattr(rec.cls, name)
        self._patched.clear()

    def __enter__(self) -> "ProtocolWitness":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ---- verdict ----

    def observed_paths(self) -> set[str]:
        return {ex.path for ex in self.exchanges}

    def report(self) -> dict:
        return {
            "exchanges": {
                f"{ex.plane} {ex.method} {ex.path} -> {ex.status} "
                f"[{','.join(sorted(ex.headers))}]"
                + (" (traced)" if ex.traced_request else ""): n
                for ex, n in sorted(self.exchanges.items(),
                                    key=lambda kv: (kv[0].path,
                                                    kv[0].status))},
            "paths": sorted(self.observed_paths()),
        }

    def problems(self, require_exercised=(),
                 min_exchanges: int = 0) -> list[str]:
        c = self.contract
        out: list[str] = []
        for ex, n in sorted(self.exchanges.items(),
                            key=lambda kv: (kv[0].path, kv[0].status)):
            where = f"{ex.method} {ex.path} -> {ex.status} (x{n})"
            if not c.explains(ex.path) and ex.status != 404:
                # 404 IS the contract's answer for an unknown path —
                # anything else served off-contract is a hole in the
                # static route extraction (or an undeclared endpoint)
                out.append(f"exchange not explained by the static "
                           f"contract: {where}")
                continue
            verbs = c.methods.get(ex.path)
            if verbs and ex.status != 404 and ex.method not in verbs:
                # a non-404 answer on a verb the dispatch chains never
                # route is an undeclared method alias
                out.append(f"method outside the route's dispatch "
                           f"chains ({'/'.join(sorted(verbs))}): "
                           f"{where}")
            if ex.status not in c.statuses:
                out.append(f"status outside the reviewed contract set: "
                           f"{where}")
            if ex.status != 404 and "X-Proto-Version" not in ex.headers:
                # every versioned-wire reply (both planes) names the
                # version it speaks (cluster/protover.py); 404s may
                # come from the http.server default error path, which
                # is outside the stamping seams
                out.append(f"reply without its wire-version stamp "
                           f"(X-Proto-Version): {where}")
            if ex.plane == "front" and ex.status in (429, 503) \
                    and "Retry-After" not in ex.headers:
                out.append(f"shed reply without Retry-After: {where}")
            if ex.path == "/leader/start" and ex.status == 200 \
                    and "X-Route-Generation" not in ex.headers:
                out.append(f"read reply without its route stamp "
                           f"(X-Route-Generation): {where}")
            if ex.path in _TRACED_WORKER_PATHS and ex.traced_request \
                    and "X-Trace-Id" not in ex.headers:
                out.append(f"traced worker RPC reply lost X-Trace-Id: "
                           f"{where}")
            if ex.path == "/leader/start" and ex.status == 422 \
                    and "X-Poison-Quarantined" not in ex.headers:
                # the quarantine verdict (wire v4): a 422 on the read
                # front door IS the poison refusal — a client must be
                # able to tell it from any future 422 by the header,
                # which also names the fingerprint to report
                out.append(f"quarantine 422 without its "
                           f"X-Poison-Quarantined stamp: {where}")
        missed = sorted(set(require_exercised) - self.observed_paths())
        if missed:
            out.append(f"statically-claimed contract surface never "
                       f"exercised by this run: {missed}")
        total = sum(self.exchanges.values())
        if total < min_exchanges:
            out.append(f"witness observed {total} exchange(s), expected "
                       f">= {min_exchanges} — instrumentation is not "
                       f"seeing the real workload")
        return out

    def check(self, require_exercised=(), min_exchanges: int = 0) -> dict:
        """Raise AssertionError on any contract violation (see module
        doc); returns the report when clean."""
        problems = self.problems(require_exercised, min_exchanges)
        if problems:
            raise AssertionError(
                "protocol witness failed:\n  " + "\n  ".join(problems)
                + f"\n  report: {self.report()}")
        return self.report()
