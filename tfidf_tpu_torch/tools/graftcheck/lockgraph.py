"""Lock-order / blocking-while-locked / indefinite-wait analysis.

Walks every function in the package tracking which locks are held at
each statement (``with self._lock:`` scopes plus best-effort
``.acquire()``/``.release()`` regions), and derives:

- **edges** — ordered pairs (held lock → acquired lock), both from
  direct nested ``with`` blocks and transitively through resolvable
  calls (``self.core.apply`` under the ensemble lock contributes
  ``ensemble._lock → coordination core._lock``). A cycle in the edge
  graph is a potential deadlock and a finding.
- **blocking-while-locked** — a call that (transitively) reaches a
  blocking primitive while a lock is held: HTTP (``urlopen``,
  ``getresponse``), ``os.fsync``, ``time.sleep``, an indefinite
  ``.wait()``/``.result()``/``.join()``, or one of the
  ``KNOWN_BLOCKING`` package functions whose blocking the resolver
  cannot see through (injected sleeps, event waits). The few
  intentional cases (WAL fsync-before-ack, the reconcile serialization
  lock) are pinned in ``allowlist.json`` with reasons.
- **indefinite waits** — ``Event.wait()`` / ``Condition.wait()`` /
  ``Future.result()`` / ``Thread.join()`` with no timeout, anywhere: a
  hung peer must never be able to wedge a thread forever.

The computed graph (edges + lock creation sites) is also the contract
for the runtime lockdep witness (:mod:`.witness`): the witness names
each instrumented lock by its creation site and fails on any observed
ordering the static graph cannot explain — each side validates the
other.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from tfidf_tpu_torch.tools.graftcheck.core import (
    ClassInfo, Finding, FuncInfo, ModuleInfo, SourceTree, _dotted)

# dotted external calls that block (suffix match on the resolved path)
BLOCKING_EXTERNAL = {
    "time.sleep": "time.sleep",
    "os.fsync": "os.fsync",
    "urllib.request.urlopen": "HTTP urlopen",
}
# attribute-call method names that block regardless of receiver type
BLOCKING_METHOD_NAMES = {
    "getresponse": "HTTP round trip",
}
# package functions that block in ways the resolver cannot see through
# (injected sleep callables, event waits behind bounded-slice loops)
KNOWN_BLOCKING = {
    "cluster.resilience.RetryPolicy.call":
        "retry backoff sleeps + the wrapped RPC",
    "cluster.resilience.ClusterResilience.worker_call":
        "runs the RPC closure under retry + breaker",
    "cluster.batcher.Coalescer.submit":
        "blocks until the coalesced batch completes",
    "cluster.ensemble.EnsembleNode.submit":
        "waits up to commit_timeout_s for quorum",
}
# methods whose no-timeout call is an indefinite wait
_INDEFINITE_METHODS = {"wait", "result", "join"}


@dataclass
class Edge:
    outer: str
    inner: str
    file: str
    line: int
    via: str          # function where the acquisition happens


@dataclass
class _Summary:
    """What calling this function may do, independent of caller locks."""
    blocks: str | None = None            # reason chain, or None
    locks: dict[str, str] = field(default_factory=dict)  # name -> via


class LockGraph:
    def __init__(self, tree: SourceTree) -> None:
        self.tree = tree
        self.edges: list[Edge] = []
        self.findings: list[Finding] = []
        self._summaries: dict[str, _Summary] = {}
        self._in_progress: set[str] = set()
        self._run()

    # ------------------------------------------------------------------
    # public: reachability for the runtime witness
    # ------------------------------------------------------------------

    def edge_set(self) -> set[tuple[str, str]]:
        return {(e.outer, e.inner) for e in self.edges}

    def reachable(self, a: str, b: str) -> bool:
        """True if the static graph orders a before b (directly or via
        a path) — the witness accepts an observed (a, b) only then."""
        adj: dict[str, set[str]] = {}
        for e in self.edges:
            adj.setdefault(e.outer, set()).add(e.inner)
        seen, stack = set(), [a]
        while stack:
            n = stack.pop()
            if n == b:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(adj.get(n, ()))
        return False

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def _run(self) -> None:
        for fi in self.tree.iter_functions():
            mi = self.tree.modules[fi.module]
            self._walk_function(mi, fi)
        self._find_cycles()

    # ------------------------------------------------------------------
    # local var typing (per function)
    # ------------------------------------------------------------------

    def _local_types(self, mi: ModuleInfo, fi: FuncInfo
                     ) -> dict[str, set[str]]:
        """Best-effort types of local names: annotated params, direct
        constructions, ``self.attr`` copies, container-element reads."""
        out: dict[str, set[str]] = {}
        node = fi.node
        args = getattr(node, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                if a.annotation is not None:
                    ts = self.tree._ann_types(mi, a.annotation)
                    if ts:
                        out[a.arg] = set(ts)
        cls = fi.cls
        for stmt in ast.walk(node):
            if not isinstance(stmt, ast.Assign):
                continue
            names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if not names:
                continue
            v = stmt.value
            ts: set[str] = set()
            ts |= self.tree._value_types(mi, cls, v)
            # v = <call> with a resolvable target: use the target's
            # return annotation (b = self.board.breaker(w) -> b is a
            # CircuitBreaker)
            if isinstance(v, ast.Call):
                for tfi in self._resolve_call(mi, fi, out, v):
                    ret = getattr(tfi.node, "returns", None)
                    if ret is not None:
                        tmod = self.tree.modules[tfi.module]
                        ts |= self.tree._ann_types(tmod, ret)
            if cls is not None:
                # v = self.attr
                if isinstance(v, ast.Attribute) and isinstance(
                        v.value, ast.Name) and v.value.id == "self":
                    ts |= self._attr_types(cls, v.attr)
                # v = self.container.get(...) / .pop(...) / self.c[...]
                base = None
                if isinstance(v, ast.Call) and isinstance(
                        v.func, ast.Attribute) and v.func.attr in (
                            "get", "pop", "popleft", "setdefault"):
                    base = v.func.value
                elif isinstance(v, ast.Subscript):
                    base = v.value
                if isinstance(base, ast.Attribute) and isinstance(
                        base.value, ast.Name) and base.value.id == "self":
                    ts |= self._attr_elem_types(cls, base.attr)
            if ts:
                for n in names:
                    out.setdefault(n, set()).update(ts)
        return out

    def _subclasses_of(self, cls: ClassInfo) -> list[ClassInfo]:
        cache = getattr(self, "_subclass_map", None)
        if cache is None:
            cache = self._subclass_map = {}
            for ci in self.tree.all_classes().values():
                seen: list[ClassInfo] = list(ci.bases)
                while seen:
                    b = seen.pop()
                    cache.setdefault(b.qual, []).append(ci)
                    seen.extend(b.bases)
        return cache.get(cls.qual, [])

    @staticmethod
    def _attr_types(cls: ClassInfo, attr: str) -> set[str]:
        out = set(cls.attr_types.get(attr, ()))
        for b in cls.bases:
            out |= LockGraph._attr_types(b, attr)
        return out

    @staticmethod
    def _attr_elem_types(cls: ClassInfo, attr: str) -> set[str]:
        out = set(cls.attr_elem_types.get(attr, ()))
        for b in cls.bases:
            out |= LockGraph._attr_elem_types(b, attr)
        return out

    # ------------------------------------------------------------------
    # lock / call resolution
    # ------------------------------------------------------------------

    def _lock_of_expr(self, mi: ModuleInfo, fi: FuncInfo,
                      locals_: dict[str, set[str]],
                      expr: ast.expr) -> str | None:
        """Resolve a with-item / acquire receiver to a lock name."""
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and fi.cls is not None:
                    return fi.cls.lock_for_attr(expr.attr)
                for tq in locals_.get(base.id, ()):
                    ci = self.tree.all_classes().get(tq)
                    if ci is not None:
                        got = ci.lock_for_attr(expr.attr)
                        if got is not None:
                            return got
        elif isinstance(expr, ast.Name):
            return mi.module_locks.get(expr.id)
        return None

    def _resolve_call(self, mi: ModuleInfo, fi: FuncInfo,
                      locals_: dict[str, set[str]],
                      call: ast.Call) -> list[FuncInfo]:
        """Package functions a call may invoke (may-targets)."""
        func = call.func
        out: list[FuncInfo] = []
        if isinstance(func, ast.Name):
            # nested def in an enclosing function
            f: FuncInfo | None = fi
            while f is not None:
                if func.id in f.nested:
                    return [f.nested[func.id]]
                f = f.parent
            if func.id in mi.functions:
                return [mi.functions[func.id]]
            target = mi.imports.get(func.id)
            if target and target.startswith(self.tree.package + "."):
                modname, _, leaf = target[len(self.tree.package)
                                          + 1:].rpartition(".")
                other = self.tree.modules.get(modname)
                if other is not None:
                    if leaf in other.functions:
                        return [other.functions[leaf]]
                    if leaf in other.classes:
                        init = other.classes[leaf].method("__init__")
                        return [init] if init is not None else []
            return out
        if not isinstance(func, ast.Attribute):
            return out
        meth = func.attr
        base = func.value
        classes = self.tree.all_classes()
        type_quals: set[str] = set()
        if isinstance(base, ast.Name):
            if base.id == "self" and fi.cls is not None:
                m = fi.cls.method(meth)
                if m is not None:
                    # virtual dispatch: a base-class method calling
                    # self.meth() may land on any subclass override
                    # (Vocabulary.save -> NativeVocabulary.all_terms)
                    targets = [m]
                    for sub in self._subclasses_of(fi.cls):
                        sm = sub.methods.get(meth)
                        if sm is not None and sm is not m:
                            targets.append(sm)
                    return targets
                # stored-callable attr: self._on_membership(...) — the
                # constructor-binding pass mapped it to its targets
                return list(fi.cls.callables_for_attr(meth))
            type_quals |= locals_.get(base.id, set())
            # module-level singleton (global_metrics, global_injector)
            type_quals |= mi.singleton_types.get(base.id, set())
            imp = mi.imports.get(base.id)
            if imp and imp.startswith(self.tree.package + "."):
                modname, _, leaf = imp[len(self.tree.package)
                                       + 1:].rpartition(".")
                other = self.tree.modules.get(modname)
                if other is not None:
                    type_quals |= other.singleton_types.get(leaf, set())
                    if leaf in other.classes and meth:
                        m = other.classes[leaf].method(meth)
                        if m is not None:
                            return [m]
        elif isinstance(base, ast.Attribute) and isinstance(
                base.value, ast.Name):
            # x.attr.meth(): x is `self` or a typed local/param
            # (engine.index.export(...) inside checkpoint helpers)
            if base.value.id == "self" and fi.cls is not None:
                type_quals |= self._attr_types(fi.cls, base.attr)
            else:
                for oq in locals_.get(base.value.id, set()):
                    oci = classes.get(oq)
                    if oci is not None:
                        type_quals |= self._attr_types(oci, base.attr)
        for tq in type_quals:
            ci = classes.get(tq)
            if ci is not None:
                m = ci.method(meth)
                if m is not None:
                    out.append(m)
        return out

    @staticmethod
    def _blocking_primitive(mi: ModuleInfo, call: ast.Call) -> str | None:
        dotted = _dotted(call.func)
        if dotted is not None:
            head, leaf = dotted.split(".")[0], dotted.split(".")[-1]
            if leaf == "urlopen":
                return "HTTP urlopen"
            if leaf == "sleep" and head == "time":
                return "time.sleep"
            if leaf == "fsync" and head == "os":
                return "os.fsync"
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in BLOCKING_METHOD_NAMES:
            return BLOCKING_METHOD_NAMES[call.func.attr]
        return None

    @staticmethod
    def _indefinite_wait(call: ast.Call) -> str | None:
        """'.wait()' / '.result()' / '.join()' with no timeout."""
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in _INDEFINITE_METHODS \
                and not call.args and not call.keywords:
            return call.func.attr
        return None

    # ------------------------------------------------------------------
    # summaries (transitive may-block / may-acquire)
    # ------------------------------------------------------------------

    def _summary(self, fi: FuncInfo) -> _Summary:
        if fi.qual in self._summaries:
            return self._summaries[fi.qual]
        if fi.qual in self._in_progress:      # recursion: assume benign
            return _Summary()
        self._in_progress.add(fi.qual)
        mi = self.tree.modules[fi.module]
        s = _Summary()
        short = fi.qual
        if short in KNOWN_BLOCKING:
            s.blocks = KNOWN_BLOCKING[short]
        locals_ = self._local_types(mi, fi)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.With):
                for item in node.items:
                    lk = self._lock_of_expr(mi, fi, locals_,
                                            item.context_expr)
                    if lk is not None:
                        s.locks.setdefault(lk, fi.qual)
            elif isinstance(node, ast.Call):
                reason = self._blocking_primitive(mi, node)
                if reason is None and self._indefinite_wait(node):
                    reason = f"indefinite .{node.func.attr}()"
                if reason is not None and s.blocks is None:
                    s.blocks = f"{fi.qual}: {reason}"
                # lock via .acquire()
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "acquire":
                    lk = self._lock_of_expr(mi, fi, locals_,
                                            node.func.value)
                    if lk is not None:
                        s.locks.setdefault(lk, fi.qual)
                for target in self._resolve_call(mi, fi, locals_, node):
                    if target.qual == fi.qual:
                        continue
                    sub = self._summary(target)
                    if sub.blocks is not None and s.blocks is None:
                        s.blocks = f"{fi.qual} -> {sub.blocks}"
                    for lk, via in sub.locks.items():
                        s.locks.setdefault(lk, via)
        self._in_progress.discard(fi.qual)
        self._summaries[fi.qual] = s
        return s

    # ------------------------------------------------------------------
    # held-region walk
    # ------------------------------------------------------------------

    def _walk_function(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        locals_ = self._local_types(mi, fi)
        body = getattr(fi.node, "body", [])
        self._walk_block(mi, fi, locals_, body, [])

    def _walk_block(self, mi: ModuleInfo, fi: FuncInfo,
                    locals_: dict[str, set[str]],
                    stmts: list[ast.stmt], held: list[str]) -> None:
        held = list(held)
        for stmt in stmts:
            if isinstance(stmt, ast.FunctionDef):
                # a closure's body executes when CALLED, not where it is
                # defined — it gets its own walk via iter_functions
                continue
            if isinstance(stmt, ast.With):
                inner = list(held)
                for item in stmt.items:
                    # the context expression itself may block (e.g.
                    # `with urlopen(...) as r:`)
                    self._scan_stmt(mi, fi, locals_,
                                    ast.Expr(value=item.context_expr),
                                    inner)
                    lk = self._lock_of_expr(mi, fi, locals_,
                                            item.context_expr)
                    if lk is not None:
                        self._note_acquire(mi, fi, held=inner, lock=lk,
                                           node=item.context_expr)
                        inner.append(lk)
                self._walk_block(mi, fi, locals_, stmt.body, inner)
                continue
            # .acquire() / .release() regions within this block
            lk = self._acquire_release(mi, fi, locals_, stmt)
            if lk is not None:
                kind, name = lk
                if kind == "acquire" and name not in held:
                    self._note_acquire(mi, fi, held=held, lock=name,
                                       node=stmt)
                    held.append(name)
                elif kind == "release" and name in held:
                    held.remove(name)
                continue
            self._scan_stmt(mi, fi, locals_, stmt, held)
            for sub in self._sub_blocks(stmt):
                self._walk_block(mi, fi, locals_, sub, held)

    @staticmethod
    def _sub_blocks(stmt: ast.stmt) -> list[list[ast.stmt]]:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, attr, None)
            if blk:
                out.append(blk)
        for h in getattr(stmt, "handlers", []) or []:
            out.append(h.body)
        return out

    def _acquire_release(self, mi, fi, locals_, stmt
                         ) -> tuple[str, str] | None:
        call = None
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
        elif isinstance(stmt, ast.If) and isinstance(stmt.test, ast.Call):
            call = stmt.test   # `if not lock.acquire(False):` patterns
        elif isinstance(stmt, ast.If) and isinstance(
                stmt.test, ast.UnaryOp) and isinstance(
                    stmt.test.operand, ast.Call):
            call = stmt.test.operand
        if call is None or not isinstance(call.func, ast.Attribute):
            return None
        if call.func.attr not in ("acquire", "release"):
            return None
        lk = self._lock_of_expr(mi, fi, locals_, call.func.value)
        if lk is None:
            return None
        return call.func.attr, lk

    def _scan_stmt(self, mi: ModuleInfo, fi: FuncInfo,
                   locals_: dict[str, set[str]], stmt: ast.stmt,
                   held: list[str]) -> None:
        """Findings/edges from the calls in ONE statement (sub-blocks
        are walked separately to keep held-lock tracking scoped)."""
        skip: set[ast.AST] = set()
        for attr in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, attr, []) or []
            if isinstance(blk, list):        # Lambda.body is an expr
                for s in blk:
                    skip.update(ast.walk(s))
        for h in getattr(stmt, "handlers", []) or []:
            for s in h.body:
                skip.update(ast.walk(s))
        for node in ast.walk(stmt):
            # a nested def/lambda body runs when called, not here
            if isinstance(node, (ast.FunctionDef, ast.Lambda)):
                skip.update(ast.walk(node))
                skip.discard(node)
            if node in skip or not isinstance(node, ast.Call):
                continue
            wait = self._indefinite_wait(node)
            if wait is not None:
                self.findings.append(Finding(
                    "lockgraph",
                    f"lockgraph:indefinite-wait:{fi.qual}:{wait}",
                    f"indefinite .{wait}() (no timeout) in {fi.qual} — "
                    f"a hung peer can wedge this thread forever",
                    mi.relpath, node.lineno))
            if not held:
                continue
            reason = self._blocking_primitive(mi, node)
            if reason is None and wait is not None:
                reason = f"indefinite .{wait}()"
            if reason is not None:
                self._note_blocking(mi, fi, held, reason, node)
                continue
            for target in self._resolve_call(mi, fi, locals_, node):
                sub = self._summary(target)
                if sub.blocks is not None:
                    self._note_blocking(mi, fi, held, sub.blocks, node)
                for lk in sub.locks:
                    self._note_acquire(mi, fi, held=held, lock=lk,
                                       node=node, via=target.qual)

    def _note_acquire(self, mi: ModuleInfo, fi: FuncInfo, *,
                      held: list[str], lock: str, node: ast.AST,
                      via: str | None = None) -> None:
        for outer in held:
            if outer == lock:
                continue   # RLock / same-lock reentry, not an edge
            self.edges.append(Edge(outer, lock, mi.relpath,
                                   getattr(node, "lineno", 0),
                                   via or fi.qual))

    def _note_blocking(self, mi: ModuleInfo, fi: FuncInfo,
                       held: list[str], reason: str,
                       node: ast.AST) -> None:
        root = reason.split(" -> ")[-1].split(":")[0].strip()
        for lock in held:
            self.findings.append(Finding(
                "lockgraph",
                f"lockgraph:blocking:{lock}:{fi.qual}:{root}",
                f"blocking call while holding {lock} in {fi.qual}: "
                f"{reason}",
                mi.relpath, getattr(node, "lineno", 0)))

    # ------------------------------------------------------------------
    # cycles
    # ------------------------------------------------------------------

    def _find_cycles(self) -> None:
        adj: dict[str, set[str]] = {}
        for e in self.edges:
            adj.setdefault(e.outer, set()).add(e.inner)
        index: dict[str, int] = {}
        low: dict[str, int] = {}
        on_stack: set[str] = set()
        stack: list[str] = []
        counter = [0]
        sccs: list[list[str]] = []

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in adj.get(v, ()):
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1:
                    sccs.append(sorted(comp))

        for v in list(adj):
            if v not in index:
                strongconnect(v)
        for comp in sccs:
            key = "lockgraph:cycle:" + "<->".join(comp)
            sites = [e for e in self.edges
                     if e.outer in comp and e.inner in comp]
            where = "; ".join(
                f"{e.outer}->{e.inner} at {e.file}:{e.line}"
                for e in sites[:6])
            self.findings.append(Finding(
                "lockgraph", key,
                f"lock-order cycle (potential deadlock): "
                f"{' <-> '.join(comp)} [{where}]",
                sites[0].file if sites else "",
                sites[0].line if sites else 0))


def build(tree: SourceTree) -> LockGraph:
    return LockGraph(tree)


def analyze(tree: SourceTree) -> list[Finding]:
    return build(tree).findings
