"""Wall-clock misuse analysis: ``time.time()`` in deadline arithmetic.

Timeout/deadline arithmetic must use ``time.monotonic()`` — wall time
jumps (NTP steps, manual clock sets, VM suspends) turn a deadline
computed from ``time.time()`` into one that can expire instantly or
never. Under a network partition that is not a latency bug, it is a
correctness bug: a leader whose lease/deadline math runs on wall time
can believe itself alive across an arbitrary pause — exactly the
deposed-but-alive split-brain the fencing layer exists to stop
(cluster/fencing.py). This pass bans the pattern structurally.

Every ``time.time()`` call in the package is a finding:

- kind ``deadline-arithmetic`` — the value flows into arithmetic or a
  comparison (directly in the enclosing expression, or through a local
  name later used in one within the same function): fix it, this is
  timer math;
- kind ``timestamp`` — a bare wall-clock read: review it. A legitimate
  wall-clock use (e.g. a ``created_at`` compared against file mtimes,
  which ARE wall-clock) is pinned in ``allowlist.json`` with its
  reason; anything new surfaces here first.

Keys are line-number-free (``wallclock:<module>.<function>:<kind>``) so
the pins survive refactors, like every other analyzer's.
"""

from __future__ import annotations

import ast

from tfidf_tpu_torch.tools.graftcheck.core import Finding, SourceTree, _dotted

_ARITH = (ast.BinOp, ast.Compare, ast.AugAssign, ast.UnaryOp)


def _is_wallclock_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _dotted(node.func) in ("time.time", "time.time_ns"))


def _names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _analyze_scope(module: str, qual: str, scope: ast.AST,
                   relpath: str, out: list[Finding]) -> None:
    """One function (or module) body: classify each time.time() call.
    Nested defs are walked as their own scopes by the caller."""
    parents: dict[ast.AST, ast.AST] = {}
    stack = [scope]
    while stack:
        node = stack.pop()
        for ch in ast.iter_child_nodes(node):
            if ch is not scope and isinstance(
                    ch, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue          # nested defs are separate scopes
            parents[ch] = node
            stack.append(ch)
    # names used inside arithmetic/comparison anywhere in this scope
    # (the taint check below flags `x = time.time()` whose `x` appears
    # in any of them)
    arith_names: set[str] = set()
    for node in parents:
        if isinstance(node, _ARITH):
            arith_names |= _names_in(node)
    for node in parents:
        if not _is_wallclock_call(node):
            continue
        kind = "timestamp"
        p = parents.get(node)
        while p is not None:
            if isinstance(p, _ARITH):   # before the stmt break:
                kind = "deadline-arithmetic"   # AugAssign IS a stmt
                break
            if isinstance(p, ast.stmt):
                break
            p = parents.get(p)
        if kind == "timestamp":
            stmt = node
            while stmt is not None and not isinstance(stmt, ast.stmt):
                stmt = parents.get(stmt)
            if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id in arith_names
                    for t in stmt.targets):
                kind = "deadline-arithmetic"
        msg = ("time.time() in timeout/deadline arithmetic — wall "
               "time jumps; use time.monotonic()"
               if kind == "deadline-arithmetic" else
               "bare wall-clock read — review (allowlist with a "
               "reason if wall time is genuinely required)")
        out.append(Finding(
            "wallclock", f"wallclock:{qual}:{kind}",
            f"{msg} (in {qual})", relpath, node.lineno))


def _walk_defs(module: str, prefix: str, body, relpath: str,
               out: list[Finding]) -> None:
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{prefix}.{node.name}"
            _analyze_scope(module, qual, node, relpath, out)
            _walk_defs(module, qual, node.body, relpath, out)
        elif isinstance(node, ast.ClassDef):
            _walk_defs(module, f"{prefix}.{node.name}", node.body,
                       relpath, out)


def analyze(tree: SourceTree) -> list[Finding]:
    out: list[Finding] = []
    for mi in tree.modules.values():
        _analyze_scope(mi.name, f"{mi.name}.<module>", mi.tree,
                       mi.relpath, out)
        _walk_defs(mi.name, mi.name, mi.tree.body, mi.relpath, out)
    # one finding per (key): multiple calls in one function/kind pin as
    # a single reviewed unit
    seen: set[str] = set()
    uniq: list[Finding] = []
    for f in out:
        if f.key not in seen:
            seen.add(f.key)
            uniq.append(f)
    return uniq
