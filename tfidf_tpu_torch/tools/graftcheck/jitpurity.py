"""Capture-purity analysis: code that runs only when it is captured.

A function compiled by ``torch.compile``, scripted or traced by
``torch.jit``, or recorded into a CUDA graph runs its Python body once,
at capture time: afterwards the compiled artifact (or the graph replay)
runs without it, so a side effect in the body happens once and then
silently never again — the same hazard a ``jax.jit`` body has. This
pass finds the capture roots statically — ``@torch.compile`` (bare or
called with options), ``torch.compile(fn)``, ``torch.jit.script`` /
``torch.jit.trace`` in either form, the body of a
``with torch.cuda.graph(g):`` block, the statements between
``g.capture_begin()`` and ``g.capture_end()``, and the callables handed
to ``torch.cuda.make_graphed_callables`` — walks the call graph beneath
them, and flags:

- lock operations (``with <lock>:``, ``.acquire()``);
- metrics (``global_metrics`` / any resolvable ``Metrics`` method);
- fault points (``fault_point`` / ``global_injector.check``);
- wall-clock (``time.time``/``perf_counter``/``monotonic``/``sleep``);
- mutable module globals (``global`` statements, stores to
  module-level names or into module-level containers).

Tensor calls are fine; unresolvable calls are ignored. The port has no
capture root today: the real-tree tests state that the extraction
found zero, so a root that appears is analyzed from its first commit.
"""

from __future__ import annotations

import ast

from tfidf_tpu_torch.tools.graftcheck.core import (
    Finding, FuncInfo, ModuleInfo, SourceTree, _dotted)

_WALL_CLOCK = {"time", "perf_counter", "monotonic", "sleep",
               "process_time", "thread_time"}
# dotted name -> root kind
_COMPILERS = {"torch.compile": "compile", "torch.jit.script": "script",
              "torch.jit.trace": "trace"}
_GRAPHED = {"torch.cuda.make_graphed_callables"}
_GRAPH_CTX = {"torch.cuda.graph"}


def _compile_kind(node: ast.expr) -> str | None:
    """The root kind for ``torch.compile`` / ``torch.jit.script`` /
    ``torch.jit.trace``, called with options (``@torch.compile(mode=
    ...)``) or wrapped in ``functools.partial``; None otherwise."""
    dotted = _dotted(node)
    if dotted in _COMPILERS:
        return _COMPILERS[dotted]
    if isinstance(node, ast.Call):
        d = _dotted(node.func)
        if d in _COMPILERS and not node.args:
            return _COMPILERS[d]            # @torch.compile(mode=...)
        if d is not None and d.split(".")[-1] == "partial" and node.args:
            return _compile_kind(node.args[0])
    return None


def _synthetic(mi: ModuleInfo, scope: FuncInfo | None, body: list,
               label: str) -> FuncInfo:
    """A captured statement block wrapped as a function of its own, so
    the purity walk applies to it unchanged."""
    node = ast.FunctionDef(
        name=label, args=ast.arguments(posonlyargs=[], args=[],
                                       kwonlyargs=[], kw_defaults=[],
                                       defaults=[]),
        body=body, decorator_list=[], returns=None, type_params=[])
    node.lineno = body[0].lineno if body else 0
    qual = f"{scope.qual if scope else mi.name}.{label}"
    return FuncInfo(qual, mi.name, scope.cls if scope else None, node,
                    parent=scope)


def _graph_blocks(stmts: list):
    """(first lineno, captured statements) for every ``with
    torch.cuda.graph(...)`` body and ``capture_begin()`` ..
    ``capture_end()`` run in a statement list, nested lists included."""
    for stmt in stmts:
        if isinstance(stmt, ast.With) and any(
                isinstance(it.context_expr, ast.Call)
                and _dotted(it.context_expr.func) in _GRAPH_CTX
                for it in stmt.items):
            yield stmt.lineno, stmt.body
    begin = None
    for i, stmt in enumerate(stmts):
        call = stmt.value if isinstance(stmt, ast.Expr) else None
        leaf = (call.func.attr if isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute) else "")
        if leaf == "capture_begin":
            begin = i
        elif leaf == "capture_end" and begin is not None:
            if i > begin + 1:
                yield stmts[begin].lineno, stmts[begin + 1:i]
            begin = None
    for stmt in stmts:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        for field in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, field, None)
            if isinstance(sub, list) and sub and isinstance(sub[0],
                                                            ast.stmt):
                yield from _graph_blocks(sub)
        for h in getattr(stmt, "handlers", ()):
            yield from _graph_blocks(h.body)


class _Purity:
    def __init__(self, tree: SourceTree) -> None:
        self.tree = tree
        self.findings: list[Finding] = []
        self._seen: set[str] = set()
        # reuse lockgraph's resolution machinery
        from tfidf_tpu_torch.tools.graftcheck.lockgraph import LockGraph
        self._lg = LockGraph.__new__(LockGraph)
        self._lg.tree = tree
        self._lg.edges = []
        self._lg.findings = []
        self._lg._summaries = {}
        self._lg._in_progress = set()

    # ---- capture-root discovery ----

    def roots(self) -> list[tuple[ModuleInfo, FuncInfo, str]]:
        out: list[tuple[ModuleInfo, FuncInfo, str]] = []
        for mi in self.tree.modules.values():
            by_name = self._funcs_by_name(mi)
            for node in ast.walk(mi.tree):
                # decorators
                if isinstance(node, ast.FunctionDef):
                    for dec in node.decorator_list:
                        kind = _compile_kind(dec)
                        if kind is not None:
                            fi = by_name.get(node.name)
                            if fi is not None and fi.node is node:
                                out.append((mi, fi, f"@{kind} {fi.qual}"))
                # torch.compile(f) / torch.jit.trace(f, x) /
                # make_graphed_callables(f, x) call forms
                if isinstance(node, ast.Call) and node.args:
                    d = _dotted(node.func)
                    kind = _compile_kind(node.func) or (
                        "graphed" if d in _GRAPHED else None)
                    if kind is None:
                        continue
                    arg = node.args[0]
                    if isinstance(arg, ast.Name):
                        fi = by_name.get(arg.id)
                        if fi is not None:
                            out.append((mi, fi, f"{kind}({fi.qual})"))
                    elif isinstance(arg, ast.Lambda):
                        fi = FuncInfo(
                            f"{mi.name}.<lambda@L{arg.lineno}>",
                            mi.name, None, arg)
                        out.append((mi, fi, f"{kind}({fi.qual})"))
            # captured blocks: module scope and every function body
            scopes = [(None, mi.tree.body)] + [
                (fi, fi.node.body) for fi in self._all_funcs(mi)]
            for scope, body in scopes:
                for line, block in _graph_blocks(body):
                    fi = _synthetic(mi, scope, block, f"<graph@L{line}>")
                    out.append((mi, fi, f"graph({fi.qual})"))
        return out

    @staticmethod
    def _all_funcs(mi: ModuleInfo) -> list[FuncInfo]:
        out: list[FuncInfo] = []

        def rec(fi: FuncInfo) -> None:
            out.append(fi)
            for c in fi.nested.values():
                rec(c)
        for fi in mi.functions.values():
            rec(fi)
        for ci in mi.classes.values():
            for fi in ci.methods.values():
                rec(fi)
        return out

    def _funcs_by_name(self, mi: ModuleInfo) -> dict[str, FuncInfo]:
        """Every function in the module, nested included, by bare name
        (last definition wins — matches runtime rebinding)."""
        out: dict[str, FuncInfo] = {}

        def rec(fi: FuncInfo) -> None:
            out[fi.node.name] = fi
            for c in fi.nested.values():
                rec(c)
        for fi in mi.functions.values():
            rec(fi)
        for ci in mi.classes.values():
            for fi in ci.methods.values():
                for c in fi.nested.values():
                    rec(c)
        return out

    # ---- reachability + purity check ----

    def check(self) -> list[Finding]:
        for mi, fi, root in self.roots():
            self._check_func(mi, fi, root)
        return self.findings

    def _check_func(self, mi: ModuleInfo, fi: FuncInfo, root: str) -> None:
        if fi.qual in self._seen:
            return
        self._seen.add(fi.qual)
        locals_ = self._lg._local_types(mi, fi)
        body = fi.node.body
        if not isinstance(body, list):       # Lambda: body is an expr
            body = [ast.Expr(value=body)]
        module_names = mi.module_globals
        local_names = {a.arg for a in fi.node.args.args
                       + fi.node.args.kwonlyargs}
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Global):
                    self._flag(mi, fi, root, node, "mutable-global",
                               f"`global {', '.join(node.names)}`")
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        self._check_store(mi, fi, root, t, module_names,
                                          local_names)
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            local_names.add(t.id)
                if isinstance(node, ast.AugAssign):
                    self._check_store(mi, fi, root, node.target,
                                      module_names, local_names)
                if isinstance(node, ast.With):
                    for item in node.items:
                        lk = self._lg._lock_of_expr(mi, fi, locals_,
                                                    item.context_expr)
                        if lk is not None:
                            self._flag(mi, fi, root, node, "lock",
                                       f"acquires {lk}")
                if not isinstance(node, ast.Call):
                    continue
                self._check_call(mi, fi, root, node, locals_)

    def _check_store(self, mi, fi, root, target, module_names,
                     local_names) -> None:
        """Store to a module-level name or into a module-level
        container is a trace-time-only side effect."""
        # without a `global` declaration, a bare-name assignment is a
        # LOCAL — only mutation THROUGH a module-level name (subscript
        # or attribute store) reaches module state
        base = target
        sub = False
        while isinstance(base, (ast.Subscript, ast.Attribute)):
            sub = True
            base = base.value
        if not sub or not isinstance(base, ast.Name) \
                or base.id == "self":
            return
        if base.id in local_names:
            return
        if base.id in module_names:
            self._flag(mi, fi, root, target, "mutable-global",
                       f"writes into module-level `{base.id}`")

    def _check_call(self, mi: ModuleInfo, fi: FuncInfo, root: str,
                    node: ast.Call, locals_) -> None:
        d = _dotted(node.func) or ""
        head, leaf = (d.split(".")[0], d.split(".")[-1]) if d else ("", "")
        if head == "time" and leaf in _WALL_CLOCK:
            self._flag(mi, fi, root, node, "wall-clock", f"calls {d}")
            return
        if leaf in ("fault_point",) or (
                head in ("global_injector",) and leaf == "check"):
            self._flag(mi, fi, root, node, "fault-point", f"calls {d}")
            return
        if head == "global_metrics" or (
                head == "threading" and leaf in ("Lock", "RLock",
                                                 "Condition")):
            kind = ("metrics" if head == "global_metrics" else "lock")
            self._flag(mi, fi, root, node, kind, f"calls {d}")
            return
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "acquire":
            lk = self._lg._lock_of_expr(mi, fi, locals_, node.func.value)
            if lk is not None:
                self._flag(mi, fi, root, node, "lock", f"acquires {lk}")
                return
        # recurse into resolvable package callees
        for target in self._lg._resolve_call(mi, fi, locals_, node):
            tmod = self.tree.modules[target.module]
            if target.qual.startswith("utils.metrics.Metrics."):
                self._flag(mi, fi, root, node, "metrics",
                           f"calls {target.qual}")
                continue
            if target.qual.startswith("utils.faults."):
                self._flag(mi, fi, root, node, "fault-point",
                           f"calls {target.qual}")
                continue
            self._check_func(tmod, target, root)

    def _flag(self, mi: ModuleInfo, fi: FuncInfo, root: str,
              node: ast.AST, category: str, what: str) -> None:
        self.findings.append(Finding(
            "jitpurity",
            f"jitpurity:{category}:{fi.qual}",
            f"impure under capture (entry {root}): {fi.qual} {what} — "
            f"a captured body runs once, when it is compiled or "
            f"recorded, never per call",
            mi.relpath, getattr(node, "lineno", 0)))


def analyze(tree: SourceTree) -> list[Finding]:
    return _Purity(tree).check()
