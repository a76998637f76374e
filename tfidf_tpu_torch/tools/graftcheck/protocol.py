"""Wire-contract analysis: the protocol the cluster speaks over HTTP.

The cluster grew an implicit wire contract — epoch fencing, deadline
propagation, trace propagation, shed ``Retry-After``, router route
stamps — spread across ~30 endpoints and dozens of ``X-*`` header sites
in ``node.py``/``router.py``/``coordination.py``. None of it was
machine-checked; a review once caught two silent breaches by hand.
This module makes the contract a build gate, four passes:

1. **endpoint drift** — every route literal dispatched in the
   ``do_GET``/``do_POST`` chains of the package's handler classes is
   cross-checked BOTH ways against every client-side path literal
   (leader RPC legs, ``proxy_write``, the CLI, bench, the tests): a
   path served but never called/tested, or called but never served,
   fails. The README "Wire contract" table is enforced two-directionally
   the same way the Config table is by registry_drift.
2. **header contract** — every mutating worker RPC site must stamp
   ``X-Leader-Epoch`` (``_epoch_headers``); every scatter RPC must
   propagate ``X-Deadline-Ms``; every reply in the front-door handler
   family must go through the ``X-Trace-Id``-stamping ``_send``/
   ``_stream`` (no naked ``send_response``); every 429/503 must carry
   ``Retry-After``; and the route-stamp / follower-merge guards that
   a review once caught by hand are pinned structurally (a cache
   hit must still carry its ``route_epoch``; ``_gather_merge`` must
   derive its sum-merge policy from the CAPTURED view's type).
3. **status-class drift** — every constant status a handler can answer
   is cross-checked against ``resilience.py``'s retryable/worker-fault
   classifier and the README table: a new 5xx outside the reviewed
   transient set, a 4xx that slipped into ``_TRANSIENT_STATUSES`` (it
   would be silently retried), or a fence-status disagreement between
   ``fencing.py`` and ``resilience.py`` fails the build.
4. **seam coverage** — every raw HTTP transport call in ``cluster/``
   must sit behind a seam that is BOTH nemesis-instrumented
   (``global_nemesis.check_send``) and trace-propagating
   (``propagation_headers``) — the "same shared seams" invariant that
   previously existed only as prose.
5. **version surface** — the wire contract is versioned
   (``cluster/protover.py``): every README wire-table row carries a
   version window (``since–`` or ``since–until``), the README declares
   the current wire version, and the whole machine-extracted surface
   (routes × methods × statuses × contract headers) is pinned as a
   ``contract fingerprint``. Changing ANY wire surface moves the
   fingerprint and fails this pass until the change is reviewed —
   re-pin the fingerprint, stamp the new/changed rows' windows, and
   bump ``PROTO_VERSION`` (or add a compat shim) to clear it. The
   proto-rejection status is also cross-checked against
   ``resilience._PROTO_STATUS`` exactly like the fence status.

Everything is pure AST (the package is parsed, never imported); the
runtime half is :mod:`.protocol_witness`, which records
real (endpoint, method, status, headers) exchanges while instrumented
suites run and validates them against the contract built here —
lockdep-style mutual validation.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
from dataclasses import dataclass, field

from tfidf_tpu_torch.tools.graftcheck.core import (
    ClassInfo, Finding, SourceTree, _dotted, caller_files)

# endpoint-ish literal grammar: the served namespaces. Deliberately
# tight so znode paths ("/leader_info", "/router_registry") and log
# text never register as endpoints.
_PATH_RE = re.compile(
    r"^/(api|worker|leader|admin|ensemble|rpc|events|metrics)(/|$|\?)")

# reply-header vocabulary the contract cares about (the witness filters
# observed reply headers down to these)
CONTRACT_HEADERS = frozenset({
    "X-Trace-Id", "X-Span-Id", "X-Route-Epoch", "X-Route-Generation",
    "X-Scatter-Degraded", "X-Deadline-Exceeded", "X-Fence-Rejected",
    "X-Fence-Epoch", "X-Shed-Reason", "Retry-After", "Connection",
    "X-Proto-Version", "X-Proto-Rejected", "X-Search-Stages",
    # compute-plane chaos headers (wire v4)
    "X-Compute-Degraded", "X-Compute-Fault", "X-Poison-Fingerprints",
    "X-Poison-Quarantined",
})

_MUTATING_WORKER_PREFIXES = ("/worker/upload", "/worker/delete")
_SCATTER_PREFIX = "/worker/process"


# ---------------------------------------------------------------------------
# shared extraction helpers
# ---------------------------------------------------------------------------

def _doc_expr_consts(tree_node: ast.AST) -> set[int]:
    """ids of Constant nodes that are bare Expr statements (docstrings,
    stray strings) — never endpoint literals."""
    out: set[int] = set()
    for node in ast.walk(tree_node):
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant):
            out.add(id(node.value))
    return out


def _path_literals(node: ast.AST, skip: set[int]):
    """(text, line) for every string constant under ``node`` that looks
    like an endpoint path (f-string literal parts included — ast.walk
    descends into JoinedStr values)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and id(sub) not in skip and _PATH_RE.match(sub.value):
            yield sub.value, getattr(sub, "lineno", 0)


def _norm_client(path: str) -> str:
    """Normalize a client-side path literal: strip the query part (an
    f-string like ``/leader/upload?name={n}`` contributes its literal
    prefix)."""
    return path.split("?")[0]


def _is_path_expr(node: ast.expr) -> bool:
    """``u.path`` / ``path`` — the handler dispatch variable."""
    return (isinstance(node, ast.Attribute) and node.attr == "path") or \
        (isinstance(node, ast.Name) and node.id == "path")


def _func_chains(mod: ast.Module) -> dict[ast.AST, list[ast.FunctionDef]]:
    """node -> enclosing chain of FunctionDefs (the resilience pass's
    qual convention: module + def-name chain, classes not included)."""
    chains: dict[ast.AST, list[ast.FunctionDef]] = {mod: []}

    def index(node: ast.AST, chain: list[ast.FunctionDef]) -> None:
        if isinstance(node, ast.FunctionDef):
            chain = chain + [node]
        for child in ast.iter_child_nodes(node):
            chains[child] = chain
            index(child, chain)

    index(mod, [])
    return chains


def _chain_qual(mi, chain: list[ast.FunctionDef]) -> str:
    return f"{mi.name}." + ".".join([f.name for f in chain]
                                    or ["<module>"])


def _module_int_consts(tree: SourceTree, modname: str) -> dict[str, int]:
    mi = tree.modules.get(modname)
    if mi is None:
        return {}
    out: dict[str, int] = {}
    for node in mi.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        value = getattr(node, "value", None)
        if isinstance(value, ast.Constant) and isinstance(value.value, int) \
                and not isinstance(value.value, bool):
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = value.value
    return out


def _resolve_int(tree: SourceTree, mi, node: ast.expr) -> int | None:
    """A constant int, or a Name resolving to a module-level int
    constant (locally or through a package import)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return node.value
    if not isinstance(node, ast.Name):
        return None
    local = _module_int_consts(tree, mi.name)
    if node.id in local:
        return local[node.id]
    target = mi.imports.get(node.id)
    if target and target.startswith(tree.package + "."):
        modname, _, name = target[len(tree.package) + 1:].rpartition(".")
        return _module_int_consts(tree, modname).get(name)
    return None


# ---------------------------------------------------------------------------
# handler-class discovery
# ---------------------------------------------------------------------------

def handler_classes(tree: SourceTree) -> dict[str, ClassInfo]:
    """Classes whose base chain reaches ``BaseHTTPRequestHandler``."""
    out: dict[str, ClassInfo] = {}

    def reaches(ci: ClassInfo, seen: set[str]) -> bool:
        if ci.qual in seen:
            return False
        seen.add(ci.qual)
        for b in ci.base_names:
            if (_dotted(b) or "").split(".")[-1] \
                    == "BaseHTTPRequestHandler":
                return True
        return any(reaches(b, seen) for b in ci.bases)

    for qual, ci in tree.all_classes().items():
        if reaches(ci, set()):
            out[qual] = ci
    return out


def _is_front_plane(ci: ClassInfo) -> bool:
    """Part of the ``_HttpHandlerBase`` family (the traced, admission-
    controlled front door) as opposed to the coordination plane."""
    if ci.qual.split(".")[-1] == "_HttpHandlerBase":
        return True
    return any(_is_front_plane(b) for b in ci.bases)


# ---------------------------------------------------------------------------
# 1. endpoint drift
# ---------------------------------------------------------------------------

@dataclass
class Route:
    path: str            # no trailing '*'; prefix routes set .prefix
    prefix: bool
    methods: set[str] = field(default_factory=set)
    cls: str = ""
    file: str = ""
    line: int = 0


def _class_route_sets(ci: ClassInfo) -> dict[str, list[str]]:
    """Class-level NAME = frozenset({...}) / (...) route collections
    (e.g. ``_PROXY_POSTS``), own class and bases."""
    out: dict[str, list[str]] = {}
    for b in ci.bases:
        out.update(_class_route_sets(b))
    for node in ci.node.body:
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if isinstance(value, ast.Call) and value.args and (
                _dotted(value.func) or "").split(".")[-1] in (
                "frozenset", "set", "tuple"):
            value = value.args[0]
        if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
            lits = [e.value for e in value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
            if lits:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = lits
    return out


def _helper_methods(handlers: dict[str, ClassInfo]) -> dict[str, set[str]]:
    """helper-method name -> the HTTP methods of the ``do_*`` dispatch
    chains that reference it (name-based, across the handler family)."""
    all_methods = {m for ci in handlers.values() for m in ci.methods}
    out: dict[str, set[str]] = {}
    for ci in handlers.values():
        for verb, m in (("GET", "do_GET"), ("POST", "do_POST")):
            fi = ci.methods.get(m)
            if fi is None:
                continue
            for node in ast.walk(fi.node):
                name = None
                if isinstance(node, ast.Attribute):
                    name = node.attr
                elif isinstance(node, ast.Name):
                    name = node.id
                if name in all_methods:
                    out.setdefault(name, set()).add(verb)
    return out


def served_routes(tree: SourceTree) -> list[Route]:
    """Every route literal dispatched in the handler classes'
    ``do_GET``/``do_POST`` chains (path compares, membership tests on
    class-level route sets, ``startswith`` prefixes)."""
    handlers = handler_classes(tree)
    helper_map = _helper_methods(handlers)
    routes: dict[tuple[str, bool], Route] = {}

    def add(path: str, prefix: bool, methods: set[str], ci: ClassInfo,
            file: str, line: int) -> None:
        if not _PATH_RE.match(path):
            return
        r = routes.setdefault((path, prefix),
                              Route(path, prefix, set(), ci.qual,
                                    file, line))
        r.methods |= methods

    for ci in handlers.values():
        mi = tree.modules[ci.module]
        csets = _class_route_sets(ci)
        for meth in ci.methods.values():
            if meth.node.name == "do_GET":
                methods = {"GET"}
            elif meth.node.name == "do_POST":
                methods = {"POST"}
            else:
                methods = helper_map.get(meth.node.name, set())
            for node in ast.walk(meth.node):
                if isinstance(node, ast.Compare) and len(node.ops) == 1:
                    left, right = node.left, node.comparators[0]
                    # NotEq/NotIn guards dispatch by EXCLUSION
                    # (`if u.path != "/rpc": 404`): the literal is
                    # still the served route
                    if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                        pair = None
                        if _is_path_expr(left):
                            pair = right
                        elif _is_path_expr(right):
                            pair = left
                        if isinstance(pair, ast.Constant) and isinstance(
                                pair.value, str):
                            add(pair.value, False, methods, ci,
                                mi.relpath, node.lineno)
                    elif isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                            and _is_path_expr(left):
                        lits: list[str] = []
                        if isinstance(right, (ast.Tuple, ast.Set,
                                              ast.List)):
                            lits = [e.value for e in right.elts
                                    if isinstance(e, ast.Constant)
                                    and isinstance(e.value, str)]
                        else:
                            name = (_dotted(right) or "").split(".")[-1]
                            lits = csets.get(name, [])
                        for lit in lits:
                            add(lit, False, methods, ci, mi.relpath,
                                node.lineno)
                elif isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr == "startswith" \
                        and _is_path_expr(node.func.value) \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str):
                    add(node.args[0].value, True, methods, ci,
                        mi.relpath, node.lineno)
    return list(routes.values())


# the port's test files that name endpoints without calling them
_NON_CLIENT_TESTS = ("test_torch_graftcheck.py", "test_torch_devicecheck.py")


def client_paths(tree: SourceTree,
                 root: str | None) -> dict[str, tuple[str, int]]:
    """Every client-side endpoint literal: package modules OUTSIDE the
    handler classes, plus the tests/bench/tools callers."""
    handlers = handler_classes(tree)
    out: dict[str, tuple[str, int]] = {}
    for mi in tree.modules.values():
        skip = _doc_expr_consts(mi.tree)
        for ci in (c for c in mi.classes.values()
                   if c.qual in handlers):
            for sub in ast.walk(ci.node):
                if isinstance(sub, ast.Constant):
                    skip.add(id(sub))
        for text, line in _path_literals(mi.tree, skip):
            out.setdefault(_norm_client(text), (mi.relpath, line))
    if root:
        for path in caller_files(root, _NON_CLIENT_TESTS):
            try:
                with open(path, encoding="utf-8") as f:
                    mod = ast.parse(f.read(), filename=path)
            except (OSError, SyntaxError):
                continue
            rel = os.path.relpath(path, root)
            skip = _doc_expr_consts(mod)
            for text, line in _path_literals(mod, skip):
                out.setdefault(_norm_client(text), (rel, line))
    return out


def _readme_wire_table(root: str) -> tuple[set[str], set[str], set[int],
                                           bool]:
    """(exact endpoints, prefix endpoints, statuses, table_present)
    parsed out of the README's ``## Wire contract`` table. Endpoints
    are every backticked ``/…`` token in a row; statuses come from the
    row's LAST cell."""
    path = os.path.join(root, "README.md")
    if not os.path.isfile(path):
        return set(), set(), set(), False
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## Wire contract$(.*?)(?=^## |\Z)", text,
                  re.M | re.S)
    if m is None:
        return set(), set(), set(), False
    exact: set[str] = set()
    prefixes: set[str] = set()
    statuses: set[int] = set()
    for line in m.group(1).splitlines():
        line = line.strip()
        if not line.startswith("|") or set(line) <= {"|", "-", " ", ":"}:
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if not cells:
            continue
        for ep in re.findall(r"`(/[^`]*)`", " ".join(cells[:-1])):
            if ep.endswith("*"):
                prefixes.add(ep[:-1])
            else:
                exact.add(ep)
        statuses.update(int(s) for s in
                        re.findall(r"\b[1-5]\d\d\b", cells[-1]))
    return exact, prefixes, statuses, True


def check_endpoints(tree: SourceTree,
                    root: str | None = None) -> list[Finding]:
    """Two-directional endpoint drift: served ↔ called."""
    routes = served_routes(tree)
    clients = client_paths(tree, root)
    out: list[Finding] = []
    if not routes:
        return [Finding(
            "protocol", "protocol:endpoint:extraction-empty",
            "no dispatched routes found in any handler class — the "
            "endpoint pass went stale", "", 0)]
    exact = {r.path for r in routes if not r.prefix}
    prefixes = [r.path for r in routes if r.prefix]

    def explained(c: str) -> bool:
        if c in exact or any(c.startswith(p) for p in prefixes):
            return True
        # a client literal ending in "/" is a PREFIX (an f-string or
        # concatenation supplies the leaf: "/api/trace/" + tid): it is
        # explained when some dispatched route lives under it
        return c.endswith("/") and any(
            r.startswith(c) for r in (exact | set(prefixes)))

    for c, (f, ln) in sorted(clients.items()):
        if not explained(c):
            out.append(Finding(
                "protocol", f"protocol:endpoint:unserved:{c}",
                f"client-side path {c!r} matches no dispatched route "
                f"in any handler (called but never served)", f, ln))
    for r in sorted(routes, key=lambda r: r.path):
        if r.prefix:
            hit = any(c.startswith(r.path) for c in clients)
        else:
            hit = r.path in clients
        if not hit:
            out.append(Finding(
                "protocol", f"protocol:endpoint:uncalled:{r.path}",
                f"route {r.path!r} ({'/'.join(sorted(r.methods)) or '?'}"
                f", {r.cls}) has no client/test call site (served but "
                f"never called)", r.file, r.line))
    return out


def check_wire_table(tree: SourceTree, root: str) -> list[Finding]:
    """README "Wire contract" table ↔ dispatched routes, both ways."""
    routes = served_routes(tree)
    if not routes:
        return []   # endpoint pass already reported extraction-empty
    doc_exact, doc_prefix, _statuses, present = _readme_wire_table(root)
    if not present:
        return [Finding(
            "protocol", "protocol:endpoint:wire-table-missing",
            "README has no '## Wire contract' table — the operator-"
            "facing endpoint reference is the other half of the "
            "endpoint-drift gate", "README.md", 1)]
    out: list[Finding] = []
    exact = {r.path for r in routes if not r.prefix}
    prefixes = {r.path for r in routes if r.prefix}
    for r in sorted(routes, key=lambda r: r.path):
        if r.prefix:
            ok = r.path in doc_prefix or any(
                e.startswith(r.path) for e in doc_exact)
        else:
            ok = r.path in doc_exact
        if not ok:
            out.append(Finding(
                "protocol",
                f"protocol:endpoint:readme-missing:{r.path}",
                f"route {r.path!r} is dispatched but absent from the "
                f"README wire-contract table", r.file, r.line))
    for ep in sorted(doc_exact):
        if ep not in exact and not any(ep.startswith(p)
                                       for p in prefixes):
            out.append(Finding(
                "protocol", f"protocol:endpoint:readme-stale:{ep}",
                f"README wire-contract row {ep!r} matches no "
                f"dispatched route — stale table entry", "README.md", 1))
    for ep in sorted(doc_prefix):
        if ep not in prefixes:
            out.append(Finding(
                "protocol", f"protocol:endpoint:readme-stale:{ep}*",
                f"README wire-contract prefix row {ep!r}* matches no "
                f"dispatched prefix route", "README.md", 1))
    return out


# ---------------------------------------------------------------------------
# 2. header contract
# ---------------------------------------------------------------------------

def _headers_kw(call: ast.Call) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == "headers":
            return kw.value
    return None


def _subtree_has_call(node: ast.AST, leaf: str) -> bool:
    return any(isinstance(sub, ast.Call)
               and (_dotted(sub.func) or "").split(".")[-1] == leaf
               for sub in ast.walk(node))


def _subtree_has_str(node: ast.AST, text: str) -> bool:
    return any(isinstance(sub, ast.Constant) and sub.value == text
               for sub in ast.walk(node))


def _transport_paths(call: ast.Call) -> list[str]:
    """Path-ish string literals among a transport call's POSITIONAL
    args (the URL/path argument, concatenations and f-strings
    included)."""
    out = []
    for a in call.args:
        for sub in ast.walk(a):
            if isinstance(sub, ast.Constant) and isinstance(
                    sub.value, str) and _PATH_RE.match(sub.value):
                out.append(sub.value)
    return out


def _rpc_sites(tree: SourceTree, scatter_only: bool):
    """(mi, call, qual, paths) for every transport call in ``cluster/``
    whose positional args carry an endpoint literal: ``http_post``/
    ``_scatter.post`` sites, split into the scatter path
    (``/worker/process*``) and everything else."""
    for mi in tree.modules.values():
        if not mi.name.startswith("cluster."):
            continue
        chains = _func_chains(mi.tree)
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func) or ""
            leaf = d.split(".")[-1]
            if leaf not in ("http_post", "post"):
                continue
            if leaf == "post" and "_scatter" not in d:
                continue
            paths = _transport_paths(node)
            # a /worker/process* site is a scatter site regardless of
            # which transport helper carries it — a fallback leg sent
            # through http_post owes the deadline stamp exactly like
            # the keep-alive _scatter.post path does
            is_scatter = any(p.startswith(_SCATTER_PREFIX)
                             for p in paths)
            if is_scatter != scatter_only:
                continue
            yield mi, node, _chain_qual(mi, chains.get(node, [])), paths


def mutating_rpc_sites(tree: SourceTree):
    """Every ``http_post``/``_scatter.post`` site in ``cluster/`` whose
    path is a mutating worker endpoint — the sites the fence pass
    audits (exposed so tests can pin that the pass still SEES them)."""
    return [(mi, node, qual,
             [p for p in paths
              if p.startswith(_MUTATING_WORKER_PREFIXES)])
            for mi, node, qual, paths in _rpc_sites(tree, False)
            if any(p.startswith(_MUTATING_WORKER_PREFIXES)
                   for p in paths)]


def scatter_rpc_sites(tree: SourceTree):
    """Every ``_scatter.post`` site to ``/worker/process*`` — the sites
    the deadline pass audits."""
    return list(_rpc_sites(tree, True))


def check_fence_stamps(tree: SourceTree) -> list[Finding]:
    """Every mutating worker RPC (``/worker/upload[-batch]``,
    ``/worker/delete``) in ``cluster/`` must stamp the leadership epoch
    (``headers=self._epoch_headers()`` or an explicit
    ``X-Leader-Epoch``) — an unstamped mutation is exactly the
    deposed-leader write the fence exists to reject."""
    out: list[Finding] = []
    for mi, node, qual, paths in mutating_rpc_sites(tree):
        hk = _headers_kw(node)
        stamped = hk is not None and (
            _subtree_has_call(hk, "_epoch_headers")
            or _subtree_has_str(hk, "X-Leader-Epoch")
            or any(isinstance(sub, ast.Name)
                   and sub.id == "FENCE_HEADER"
                   for sub in ast.walk(hk)))
        if not stamped:
            path = _norm_client(paths[0])
            out.append(Finding(
                "protocol",
                f"protocol:header:unfenced-mutation:{qual}:{path}",
                f"mutating worker RPC to {path!r} in {qual} does "
                f"not stamp X-Leader-Epoch (_epoch_headers) — a "
                f"deposed leader could land this write unfenced",
                mi.relpath, node.lineno))
    return out


def check_deadline_stamps(tree: SourceTree) -> list[Finding]:
    """Every scatter-path RPC (``_scatter.post`` to
    ``/worker/process*``) must propagate ``X-Deadline-Ms`` — a worker
    must never score for a caller whose budget is already spent."""
    out: list[Finding] = []
    for mi, node, qual, _paths in scatter_rpc_sites(tree):
        hk = _headers_kw(node)
        if hk is None or not _subtree_has_str(hk, "X-Deadline-Ms"):
            out.append(Finding(
                "protocol",
                f"protocol:header:undeadlined-scatter:{qual}",
                f"scatter RPC in {qual} does not propagate "
                f"X-Deadline-Ms — the worker cannot refuse work "
                f"whose budget is spent", mi.relpath, node.lineno))
    return out


def check_send_discipline(tree: SourceTree) -> list[Finding]:
    """Front-plane replies must flow through the ``X-Trace-Id``-
    stamping ``_send``/``_stream`` — a naked ``send_response`` in the
    ``_HttpHandlerBase`` family would break the documented 'any
    /leader/* reply's X-Trace-Id keys the trace' contract; and the
    stamping inside ``_send``/``_stream`` itself must survive
    refactors."""
    out: list[Finding] = []
    front = {q: ci for q, ci in handler_classes(tree).items()
             if _is_front_plane(ci)}
    for ci in front.values():
        mi = tree.modules[ci.module]
        for meth in ci.methods.values():
            if meth.node.name in ("_send", "_stream"):
                continue
            for node in ast.walk(meth.node):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute) \
                        and node.func.attr == "send_response" \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self":
                    out.append(Finding(
                        "protocol",
                        f"protocol:header:bypass-send:"
                        f"{ci.qual}.{meth.node.name}",
                        f"{ci.qual}.{meth.node.name} calls "
                        f"send_response directly — replies must go "
                        f"through the X-Trace-Id-stamping _send/"
                        f"_stream", mi.relpath, node.lineno))
        if ci.qual.split(".")[-1] == "_HttpHandlerBase":
            for name in ("_send", "_stream"):
                fi = ci.methods.get(name)
                if fi is None:
                    continue
                stamped = any(
                    (isinstance(sub, ast.Name)
                     and sub.id == "TRACE_HEADER")
                    or (isinstance(sub, ast.Constant)
                        and sub.value == "X-Trace-Id")
                    for sub in ast.walk(fi.node))
                if not stamped:
                    out.append(Finding(
                        "protocol",
                        f"protocol:header:send-not-trace-stamping:"
                        f"{name}",
                        f"{ci.qual}.{name} no longer stamps "
                        f"X-Trace-Id on in-span replies — the trace-"
                        f"correlation contract broke",
                        mi.relpath, fi.node.lineno))
    return out


_STATUS_ARG = {"_send": 0, "send_response": 0, "_json": 1, "_text": 1,
               "_reply": 1}
_STATUS_DEFAULT = {"_json": 200, "_text": 200, "_reply": 200}


def _status_sites(tree: SourceTree):
    """(status, call, headers_node, qual, ci, mi, line) for every reply
    emitted in a handler class with a resolvable constant status."""
    for ci in handler_classes(tree).values():
        mi = tree.modules[ci.module]
        for meth in ci.methods.values():
            for node in ast.walk(meth.node):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "self"
                        and node.func.attr in _STATUS_ARG):
                    continue
                name = node.func.attr
                arg = None
                for kw in node.keywords:
                    if kw.arg == "code":
                        arg = kw.value
                pos = _STATUS_ARG[name]
                if arg is None and len(node.args) > pos:
                    arg = node.args[pos]
                if arg is None:
                    status = _STATUS_DEFAULT.get(name)
                else:
                    status = _resolve_int(tree, mi, arg)
                if status is None:
                    continue   # dynamic relay — out of static scope
                yield (status, node, _headers_kw(node),
                       f"{ci.qual}.{meth.node.name}", ci, mi,
                       node.lineno)


def check_shed_headers(tree: SourceTree) -> list[Finding]:
    """Every front-plane 429/503 must carry ``Retry-After`` — a shed
    without a back-off hint is the hammering the shed exists to stop."""
    out: list[Finding] = []
    for status, _node, hk, qual, ci, mi, line in _status_sites(tree):
        if status not in (429, 503) or not _is_front_plane(ci):
            continue
        if hk is None or not _subtree_has_str(hk, "Retry-After"):
            out.append(Finding(
                "protocol",
                f"protocol:header:shed-missing-retry-after:"
                f"{qual}:{status}",
                f"{qual} answers {status} without a Retry-After "
                f"header — clients cannot back off honestly",
                mi.relpath, line))
    return out


def check_route_stamp_guards(tree: SourceTree) -> list[Finding]:
    """Review catches, pinned structurally: the shared search
    branch must stamp both route headers; the cache-hit health marker
    must still carry its route stamp; and ``_gather_merge`` must derive
    its sum-merge policy from the CAPTURED view's type (a mid-request
    promotion must never re-enable the replica-double-counting legacy
    sum)."""
    if "cluster.router" not in tree.modules:
        return []   # mini fixture trees — real-tree guards only
    out: list[Finding] = []
    mi = tree.modules["cluster.router"]

    def fn(name: str) -> ast.FunctionDef | None:
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.FunctionDef) and node.name == name:
                return node
        return None

    serve = fn("_serve_search")
    if serve is None or not (
            _subtree_has_str(serve, "X-Route-Epoch")
            and _subtree_has_str(serve, "X-Route-Generation")):
        out.append(Finding(
            "protocol", "protocol:header:route-stamp-missing:serve",
            "_serve_search no longer stamps X-Route-Epoch/"
            "X-Route-Generation — every read reply must name the "
            "placement world that produced it",
            mi.relpath, getattr(serve, "lineno", 1)))
    search = fn("leader_search_with_health")
    cached_ok = False
    if search is not None:
        for node in ast.walk(search):
            if isinstance(node, ast.Dict):
                keys = {k.value for k in node.keys
                        if isinstance(k, ast.Constant)}
                if "cached" in keys and {"route_epoch",
                                         "route_gen"} <= keys:
                    cached_ok = True
    if not cached_ok:
        out.append(Finding(
            "protocol", "protocol:header:route-stamp-missing:cache-hit",
            "the cache-hit health marker in leader_search_with_health "
            "lost its route_epoch/route_gen stamp — cache hits losing "
            "their route stamp regressed",
            mi.relpath, getattr(search, "lineno", 1)))
    gather = fn("_gather_merge")
    guard_ok = gather is not None and any(
        isinstance(node, ast.Call)
        and (_dotted(node.func) or "") == "isinstance"
        and len(node.args) == 2
        and (_dotted(node.args[1]) or "").split(".")[-1]
        == "PlacementFollower"
        for node in ast.walk(gather))
    if not guard_ok:
        out.append(Finding(
            "protocol", "protocol:guard:follower-sum-merge",
            "_gather_merge no longer derives the sum-merge policy from "
            "the captured view's type (isinstance(pmap, "
            "PlacementFollower)) — a mid-request promotion could "
            "re-enable the replica-double-counting legacy sum",
            mi.relpath, getattr(gather, "lineno", 1)))
    return out


def check_headers(tree: SourceTree) -> list[Finding]:
    return (check_fence_stamps(tree) + check_deadline_stamps(tree)
            + check_send_discipline(tree) + check_shed_headers(tree)
            + check_route_stamp_guards(tree))


# ---------------------------------------------------------------------------
# 3. status-class drift
# ---------------------------------------------------------------------------

def _frozenset_ints(mi, name: str) -> set[int] | None:
    for node in mi.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name
                for t in node.targets):
            value = node.value
            if isinstance(value, ast.Call) and value.args:
                value = value.args[0]
            if isinstance(value, (ast.Set, ast.Tuple, ast.List)):
                return {e.value for e in value.elts
                        if isinstance(e, ast.Constant)
                        and isinstance(e.value, int)}
    return None


def check_statuses(tree: SourceTree, root: str) -> list[Finding]:
    out: list[Finding] = []
    sites = list(_status_sites(tree))
    if not sites:
        return [Finding(
            "protocol", "protocol:status:extraction-empty",
            "no constant reply statuses found in any handler — the "
            "status pass went stale", "", 0)]
    # resilience classifier consistency
    res = tree.modules.get("cluster.resilience")
    if res is not None:
        transient = _frozenset_ints(res, "_TRANSIENT_STATUSES")
        if transient is None:
            out.append(Finding(
                "protocol", "protocol:status:extraction-empty",
                "_TRANSIENT_STATUSES not found in cluster/resilience.py"
                " — the classifier cross-check went stale",
                res.relpath, 1))
            transient = set()
        for s in sorted(transient):
            if s < 500:
                out.append(Finding(
                    "protocol", f"protocol:status:transient-4xx:{s}",
                    f"status {s} is in _TRANSIENT_STATUSES but is not "
                    f"a 5xx — the retry policy would silently retry an "
                    f"application rejection", res.relpath, 1))
        consts = _module_int_consts(tree, "cluster.resilience")
        fence_res = consts.get("_FENCE_STATUS")
        fence_def = _module_int_consts(
            tree, "cluster.fencing").get("FENCE_STATUS") \
            if "cluster.fencing" in tree.modules else fence_res
        if fence_res is not None and fence_def is not None \
                and fence_res != fence_def:
            out.append(Finding(
                "protocol", "protocol:status:fence-mismatch",
                f"fencing.FENCE_STATUS ({fence_def}) != "
                f"resilience._FENCE_STATUS ({fence_res}) — the fence "
                f"rejection would be misclassified", res.relpath, 1))
        shed = consts.get("_SHED_STATUS")
        if shed is not None and shed != 429:
            out.append(Finding(
                "protocol", "protocol:status:shed-mismatch",
                f"_SHED_STATUS is {shed}, the admission layer sheds "
                f"with 429 — Retry-After flooring would not engage",
                res.relpath, 1))
    # README table coupling, both directions
    _e, _p, doc_statuses, present = _readme_wire_table(root)
    if not present:
        return out   # check_wire_table already reports the missing table
    emitted: dict[int, tuple[str, str, int]] = {}
    for status, _n, _h, qual, _ci, mi, line in sites:
        emitted.setdefault(status, (qual, mi.relpath, line))
    for status, (qual, f, ln) in sorted(emitted.items()):
        if status not in doc_statuses:
            out.append(Finding(
                "protocol", f"protocol:status:unknown:{status}",
                f"status {status} (first seen in {qual}) is not in the "
                f"README wire-contract table — its retry/breaker "
                f"semantics are unreviewed", f, ln))
    for status in sorted(doc_statuses):
        if status not in emitted:
            out.append(Finding(
                "protocol", f"protocol:status:readme-stale:{status}",
                f"README wire-contract status {status} is emitted by "
                f"no handler — stale table entry", "README.md", 1))
    return out


# ---------------------------------------------------------------------------
# 4. seam coverage
# ---------------------------------------------------------------------------

def check_seams(tree: SourceTree) -> list[Finding]:
    """Every raw HTTP transport call in ``cluster/`` must live inside a
    seam that is nemesis-instrumented (``check_send``) AND trace-
    propagating (``propagation_headers``). The enclosing top-level
    function/method is the seam unit."""
    out: list[Finding] = []
    seen: set[str] = set()
    for mi in tree.modules.values():
        if not mi.name.startswith("cluster."):
            continue
        chains = _func_chains(mi.tree)
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            leaf = (_dotted(node.func) or "").split(".")[-1]
            if leaf not in ("urlopen", "HTTPConnection"):
                continue
            chain = chains.get(node, [])
            outer = chain[0] if chain else None
            qual = _chain_qual(mi, chain[:1])
            if qual in seen:
                continue
            seen.add(qual)
            scope = outer if outer is not None else mi.tree
            has_nem = _subtree_has_call(scope, "check_send")
            has_trace = _subtree_has_call(scope, "propagation_headers")
            line = getattr(outer, "lineno", node.lineno)
            if not has_nem:
                out.append(Finding(
                    "protocol", f"protocol:seam:no-nemesis:{qual}",
                    f"raw transport in {qual} bypasses the nemesis "
                    f"seam (no global_nemesis.check_send) — partitions "
                    f"cannot cut this link in chaos tests",
                    mi.relpath, line))
            if not has_trace:
                out.append(Finding(
                    "protocol", f"protocol:seam:no-trace:{qual}",
                    f"raw transport in {qual} does not propagate the "
                    f"trace context (no propagation_headers) — the "
                    f"request story breaks at this hop",
                    mi.relpath, line))
    return out


# ---------------------------------------------------------------------------
# 5. version surface
# ---------------------------------------------------------------------------

# a version-window cell: "1–" (since 1, still current) or "1–1"
# (retired at 1). MUST be a non-last cell — the statuses parser reads
# the row's last cell — and must never contain backticks or 3-digit
# numbers (they would register as endpoints/statuses).
_VERSION_WINDOW_RE = re.compile(r"^(\d+)\s*[–-]\s*(\d+)?$")
_README_VERSION_RE = re.compile(
    r"current wire version[^0-9]{0,40}(\d+)", re.I)
_README_FPRINT_RE = re.compile(
    r"contract fingerprint[^`]{0,40}`([0-9a-f]{12})`", re.I)


def contract_fingerprint(tree: SourceTree) -> str:
    """sha256[:12] over the machine-extracted wire surface: every
    dispatched route (path, prefix-ness, methods), every constant reply
    status, and the contract-header vocabulary. Any change to what the
    cluster serves or stamps moves this value — the README pin is the
    review gate."""
    lines = []
    for r in sorted(served_routes(tree),
                    key=lambda r: (r.path, r.prefix)):
        lines.append(f"{r.path}{'*' if r.prefix else ''} "
                     f"{','.join(sorted(r.methods))}")
    statuses = sorted({s for s, *_rest in _status_sites(tree)})
    lines.append("statuses " + ",".join(str(s) for s in statuses))
    lines.append("headers " + ",".join(sorted(CONTRACT_HEADERS)))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:12]


def _readme_row_windows(root: str):
    """(endpoints, (since, until_or_None) | None) for every data row of
    the README wire table that names at least one endpoint."""
    path = os.path.join(root, "README.md")
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"^## Wire contract$(.*?)(?=^## |\Z)", text,
                  re.M | re.S)
    if m is None:
        return []
    rows = []
    for line in m.group(1).splitlines():
        line = line.strip()
        if not line.startswith("|") or set(line) <= {"|", "-", " ", ":"}:
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        eps = re.findall(r"`(/[^`]*)`", " ".join(cells[:-1]))
        if not eps:
            continue
        window = None
        for c in cells[:-1]:
            wm = _VERSION_WINDOW_RE.match(c)
            if wm is not None:
                window = (int(wm.group(1)),
                          int(wm.group(2)) if wm.group(2) else None)
                break
        rows.append((eps, window))
    return rows


def check_version_surface(tree: SourceTree, root: str) -> list[Finding]:
    """The versioned-wire gate: PROTO_VERSION ↔ README declaration,
    per-row version windows, the pinned contract fingerprint, and the
    proto-status classifier cross-check. Returns nothing for trees
    without ``cluster/protover.py`` (mini fixtures opt in by including
    one)."""
    if "cluster.protover" not in tree.modules:
        return []   # mini fixture trees — real-tree gate only
    pv = tree.modules["cluster.protover"]
    consts = _module_int_consts(tree, "cluster.protover")
    proto_version = consts.get("PROTO_VERSION")
    if proto_version is None:
        return [Finding(
            "protocol", "protocol:version:extraction-empty",
            "PROTO_VERSION not found in cluster/protover.py — the "
            "version-surface pass went stale", pv.relpath, 1)]
    out: list[Finding] = []
    res = tree.modules.get("cluster.resilience")
    proto_status = consts.get("PROTO_STATUS")
    if res is not None and proto_status is not None:
        res_status = _module_int_consts(
            tree, "cluster.resilience").get("_PROTO_STATUS")
        if res_status is not None and res_status != proto_status:
            out.append(Finding(
                "protocol", "protocol:version:proto-status-mismatch",
                f"protover.PROTO_STATUS ({proto_status}) != "
                f"resilience._PROTO_STATUS ({res_status}) — the "
                f"version rejection would be misclassified (retried, "
                f"or charged to a worker's breaker)", res.relpath, 1))
    path = os.path.join(root, "README.md")
    if not os.path.isfile(path):
        return out   # check_wire_table reports the missing README
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = _README_VERSION_RE.search(text)
    if m is None:
        out.append(Finding(
            "protocol", "protocol:version:undeclared",
            "README does not declare the current wire version "
            "('current wire version: N') — operators cannot check a "
            "binary against the compat window", "README.md", 1))
    elif int(m.group(1)) != proto_version:
        out.append(Finding(
            "protocol", "protocol:version:declared-mismatch",
            f"README declares wire version {m.group(1)}, "
            f"cluster/protover.py says {proto_version} — the doc and "
            f"the code disagree on what the fleet speaks",
            "README.md", 1))
    fp = contract_fingerprint(tree)
    fm = _README_FPRINT_RE.search(text)
    if fm is None:
        out.append(Finding(
            "protocol", "protocol:version:fingerprint-unpinned",
            f"README pins no contract fingerprint — pin "
            f"`{fp}` so any wire-surface change fails the build "
            f"until reviewed", "README.md", 1))
    elif fm.group(1) != fp:
        out.append(Finding(
            "protocol", "protocol:version:fingerprint-drift",
            f"wire surface changed without a reviewed version bump: "
            f"code extracts fingerprint {fp}, README pins "
            f"{fm.group(1)} — stamp the changed rows' version "
            f"windows, bump PROTO_VERSION (or add a compat shim), "
            f"then re-pin", "README.md", 1))
    for eps, window in _readme_row_windows(root):
        key = eps[0]
        if window is None:
            out.append(Finding(
                "protocol", f"protocol:version:row-unversioned:{key}",
                f"README wire-table row {key!r} carries no version "
                f"window ('1–' / '2–' / '1–1') — every wire surface "
                f"must say when it entered (and left) the contract",
                "README.md", 1))
            continue
        since, until = window
        if since > proto_version:
            out.append(Finding(
                "protocol", f"protocol:version:row-future:{key}",
                f"README row {key!r} claims since-version {since} but "
                f"the code's PROTO_VERSION is {proto_version} — a row "
                f"cannot enter the contract in a version that does "
                f"not exist yet", "README.md", 1))
        if until is not None and until < since:
            out.append(Finding(
                "protocol", f"protocol:version:row-inverted:{key}",
                f"README row {key!r} has an inverted version window "
                f"{since}–{until}", "README.md", 1))
    return out


# ---------------------------------------------------------------------------
# contract for the runtime witness and the CLI
# ---------------------------------------------------------------------------

@dataclass
class WireContract:
    exact: set[str]
    prefixes: list[str]
    methods: dict[str, set[str]]          # path -> verbs (exact only)
    statuses: set[int]

    def explains(self, path: str) -> bool:
        return path in self.exact or any(path.startswith(p)
                                         for p in self.prefixes)


def build_contract(root: str,
                   tree: SourceTree | None = None) -> WireContract:
    tree = tree or SourceTree(root)
    routes = served_routes(tree)
    emitted = {status for status, *_rest in _status_sites(tree)}
    _e, _p, doc_statuses, _present = _readme_wire_table(root)
    return WireContract(
        exact={r.path for r in routes if not r.prefix},
        prefixes=[r.path for r in routes if r.prefix],
        methods={r.path: set(r.methods) for r in routes if not r.prefix},
        statuses=emitted | doc_statuses)


def analyze(tree: SourceTree, root: str) -> list[Finding]:
    return (check_endpoints(tree, root) + check_wire_table(tree, root)
            + check_headers(tree) + check_statuses(tree, root)
            + check_seams(tree) + check_version_surface(tree, root))
