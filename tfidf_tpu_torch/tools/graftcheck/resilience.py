"""Resilience-coverage analysis: no naked leader→worker RPCs.

Every leader→worker RPC must flow through
``ClusterResilience.worker_call`` (breaker + bounded retry) — a new raw
``urlopen`` / ``http_post`` / ``http_get`` / ``_ScatterClient.post`` /
``_post_json`` call in ``cluster/`` that is NOT wrapped is a finding.

A raw transport call counts as wrapped when it sits lexically inside a
closure handed to ``worker_call``: a ``lambda`` argument of a
``worker_call(...)`` call, or a nested ``def`` whose name appears as a
``worker_call`` argument (positional or keyword, directly or invoked
inside a ``worker_call`` lambda) in the same enclosing function.

The replication spine adds one indirection: ``_gather_merge(queries,
rpc_one, ...)`` receives the per-worker RPC closure and forwards it
into ``worker_call`` itself. The pass derives such **closure-forwarding
wrappers** structurally — a function is a wrapper when one of its own
PARAMETERS is invoked inside a ``worker_call`` closure — and then
treats closures passed to a known wrapper as wrapped too. A
replica-failover RPC that bypasses both (a naked transport call in a
closure nobody forwards to ``worker_call``) is still a finding.

Subsystems with their own failure discipline (the coordination client's
connect-string failover, Raft replication's term-checked resend loop,
heartbeats) are pinned in ``allowlist.json`` with reasons — new call
sites in them still surface here first.
"""

from __future__ import annotations

import ast

from tfidf_tpu_torch.tools.graftcheck.core import Finding, SourceTree, _dotted

_RAW_TRANSPORTS = {"urlopen", "http_post", "http_get", "http_get_stream",
                   "_post_json"}
_RAW_METHODS = {"post"}         # self._scatter.post
_WRAPPER = "worker_call"


def _transport_call(node: ast.Call) -> str | None:
    d = _dotted(node.func)
    if d is None:
        return None
    leaf = d.split(".")[-1]
    if leaf in _RAW_TRANSPORTS:
        return leaf
    if leaf in _RAW_METHODS and "_scatter" in d:
        return d
    return None


def _call_args(node: ast.Call):
    """Positional + keyword argument value nodes."""
    return list(node.args) + [kw.value for kw in node.keywords]


def _forwarding_wrappers(tree: SourceTree) -> set[str]:
    """Leaf names of functions that forward one of their own PARAMETERS
    into ``worker_call`` (directly, or invoked inside a ``worker_call``
    lambda) — e.g. ``_gather_merge(self, queries, rpc_one, ...)`` with
    ``worker_call(addr, lambda: rpc_one(...))`` in its body. Closures
    handed to these are breaker-gated by construction."""
    out: set[str] = set()
    for mi in tree.modules.values():
        if not mi.name.startswith("cluster."):
            continue
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.FunctionDef):
                continue
            params = {a.arg for a in node.args.args
                      + node.args.kwonlyargs}
            for call in ast.walk(node):
                if not isinstance(call, ast.Call):
                    continue
                d = _dotted(call.func) or ""
                if d.split(".")[-1] != _WRAPPER:
                    continue
                for a in _call_args(call):
                    if isinstance(a, ast.Name) and a.id in params:
                        out.add(node.name)
                    elif isinstance(a, ast.Lambda):
                        for c in ast.walk(a):
                            if isinstance(c, ast.Call) \
                                    and isinstance(c.func, ast.Name) \
                                    and c.func.id in params:
                                out.add(node.name)
    return out


def _wrapped_names(func: ast.AST, wrappers: frozenset[str]) -> set[str]:
    """Names of nested defs passed to worker_call (or to a known
    closure-forwarding wrapper) within ``func`` — positional or
    keyword, directly or invoked inside a worker_call lambda."""
    out: set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.split(".")[-1] not in ({_WRAPPER} | wrappers):
                continue
            for a in _call_args(node):
                if isinstance(a, ast.Name):
                    out.add(a.id)
                elif isinstance(a, ast.Lambda):
                    for c in ast.walk(a):
                        if isinstance(c, ast.Call) \
                                and isinstance(c.func, ast.Name):
                            out.add(c.func.id)
    return out


def _lambda_wrapped(module: ast.Module,
                    wrappers: frozenset[str]) -> set[ast.AST]:
    """All nodes inside lambdas that are worker_call (or known-wrapper)
    arguments."""
    covered: set[ast.AST] = set()
    for node in ast.walk(module):
        if isinstance(node, ast.Call):
            d = _dotted(node.func) or ""
            if d.split(".")[-1] in ({_WRAPPER} | wrappers):
                for a in _call_args(node):
                    if isinstance(a, ast.Lambda):
                        covered.update(ast.walk(a))
    return covered


def analyze(tree: SourceTree) -> list[Finding]:
    out: list[Finding] = []
    wrappers = frozenset(_forwarding_wrappers(tree))
    for mi in tree.modules.values():
        if not mi.name.startswith("cluster."):
            continue
        lambda_cov = _lambda_wrapped(mi.tree, wrappers)
        # map: every FunctionDef node -> its enclosing chain of defs
        chains: dict[ast.AST, list[ast.FunctionDef]] = {}

        def index(node: ast.AST, chain: list[ast.FunctionDef]) -> None:
            if isinstance(node, ast.FunctionDef):
                chain = chain + [node]
            for child in ast.iter_child_nodes(node):
                chains[child] = chain
                index(child, chain)

        chains[mi.tree] = []
        index(mi.tree, [])
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            transport = _transport_call(node)
            if transport is None:
                continue
            if node in lambda_cov:
                continue
            chain = chains.get(node, [])
            covered = False
            qual_parts = [f.name for f in chain]
            if chain:
                inner = chain[-1]
                for encl in chain[:-1]:
                    if inner.name in _wrapped_names(encl, wrappers):
                        covered = True
                        break
            if covered:
                continue
            qual = f"{mi.name}." + ".".join(qual_parts or ["<module>"])
            out.append(Finding(
                "resilience",
                f"resilience:unwrapped:{qual}:{transport}",
                f"raw transport call {transport!r} in {qual} does not "
                f"flow through ClusterResilience.worker_call "
                f"(no breaker, no bounded retry)",
                mi.relpath, node.lineno))
    return out
