"""Shared infrastructure for the graftcheck analyzers.

Everything here is pure-AST: the package under analysis is parsed, never
imported, so the suite runs in a bare interpreter (CI's graftcheck job
installs nothing) and cannot be perturbed by import-time side effects of
the code it checks.

The resolution model is deliberately modest — it resolves what this
codebase actually writes, not arbitrary Python:

- imports (``import m``, ``from m import n``) within the package;
- module-level functions and classes, methods with single inheritance
  inside the package;
- ``self.attr`` types inferred from ``__init__`` assignments: direct
  construction (``self.store = DurableStore(...)``), annotated
  parameters (``core: CoordinationCore`` + ``self.core = core``),
  ``a or B(...)`` fallbacks, and annotated containers
  (``self._sessions: dict[int, _Session]`` makes ``.get``/``.pop``/
  subscript results a ``_Session``);
- module-level singletons (``global_metrics = Metrics()``) so
  ``global_metrics.inc`` resolves to ``Metrics.inc``.

Unresolvable calls are ignored (may-miss, never crash): the analyzers
over-approximate where it is cheap (union types) and under-approximate
where resolution fails — the committed baseline pins the net result.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field

PACKAGE = "tfidf_tpu_torch"
_DATA_DIR = os.path.dirname(os.path.abspath(__file__))
ALLOWLIST_PATH = os.path.join(_DATA_DIR, "allowlist.json")
BASELINE_PATH = os.path.join(_DATA_DIR, "baseline.json")


@dataclass(frozen=True)
class Finding:
    analyzer: str
    key: str          # stable id (no line numbers) — what baselines pin
    message: str
    file: str = ""
    line: int = 0

    def render(self) -> str:
        loc = f"{self.file}:{self.line}: " if self.file else ""
        return f"[{self.analyzer}] {loc}{self.message}\n    key: {self.key}"


# ---------------------------------------------------------------------------
# symbol tables
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class FuncInfo:
    qual: str                  # "cluster.node.SearchNode.leader_upload"
    module: str                # "cluster.node"
    cls: "ClassInfo | None"
    node: ast.AST              # FunctionDef | AsyncFunctionDef | Lambda
    nested: dict[str, "FuncInfo"] = field(default_factory=dict)
    parent: "FuncInfo | None" = None


@dataclass(eq=False)
class ClassInfo:
    qual: str                  # "cluster.node.SearchNode"
    module: str
    node: ast.ClassDef
    base_names: list[ast.expr] = field(default_factory=list)
    bases: list["ClassInfo"] = field(default_factory=list)
    methods: dict[str, FuncInfo] = field(default_factory=dict)
    # attr -> candidate ClassInfo quals (union; may-types)
    attr_types: dict[str, set[str]] = field(default_factory=dict)
    # attr -> element-type quals for annotated containers
    attr_elem_types: dict[str, set[str]] = field(default_factory=dict)
    # attr -> lock name (locks created in methods; Condition aliases
    # point at the aliased lock's name)
    attr_locks: dict[str, str] = field(default_factory=dict)
    # attr assigned straight from an __init__ parameter: attr -> param
    attr_params: dict[str, str] = field(default_factory=dict)
    # constructor-callback binding: param -> what call sites pass for it
    # (("c", class_qual) instances / ("f", FuncInfo) callables)
    param_bindings: dict[str, set] = field(default_factory=dict)
    # derived: attr -> FuncInfos a stored-callable attr may dispatch to
    attr_callables: dict[str, set] = field(default_factory=dict)

    def method(self, name: str) -> FuncInfo | None:
        if name in self.methods:
            return self.methods[name]
        for b in self.bases:
            m = b.method(name)
            if m is not None:
                return m
        return None

    def lock_for_attr(self, name: str) -> str | None:
        if name in self.attr_locks:
            return self.attr_locks[name]
        for b in self.bases:
            got = b.lock_for_attr(name)
            if got is not None:
                return got
        return None

    def callables_for_attr(self, name: str) -> set:
        out = set(self.attr_callables.get(name, ()))
        for b in self.bases:
            out |= b.callables_for_attr(name)
        return out


@dataclass
class ModuleInfo:
    name: str                  # short name, e.g. "cluster.node"
    relpath: str               # "tfidf_tpu_torch/cluster/node.py"
    tree: ast.Module
    source: str
    imports: dict[str, str] = field(default_factory=dict)  # local -> dotted
    functions: dict[str, FuncInfo] = field(default_factory=dict)
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    # module-level NAME = threading.Lock() locks: local name -> lock name
    module_locks: dict[str, str] = field(default_factory=dict)
    # module-level NAME = SomeClass() singletons: local name -> class qual
    singleton_types: dict[str, set[str]] = field(default_factory=dict)
    module_globals: set[str] = field(default_factory=set)


_LOCK_FACTORIES = {"Lock", "RLock"}


def _dotted(node: ast.expr) -> str | None:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class SourceTree:
    """All modules of one package, parsed and cross-linked."""

    def __init__(self, root: str, package: str = PACKAGE) -> None:
        self.root = root
        self.package = package
        self.modules: dict[str, ModuleInfo] = {}
        # lock creation sites: (relpath, lineno) -> lock name — the
        # contract with the runtime witness (witness.py names each
        # instrumented lock by where threading.Lock() was called)
        self.lock_sites: dict[tuple[str, int], str] = {}
        self._load()
        self._link()

    # ---- loading ----

    def _load(self) -> None:
        pkg_dir = os.path.join(self.root, self.package)
        for dirpath, dirs, files in os.walk(pkg_dir):
            # the analyzers themselves are not part of the analyzed tree
            dirs[:] = [d for d in dirs if d != "__pycache__" and not (
                dirpath == pkg_dir and d == "tools")]
            for fn in sorted(files):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, self.root)
                with open(path, encoding="utf-8") as f:
                    src = f.read()
                modname = os.path.relpath(path, pkg_dir)[:-3]
                modname = modname.replace(os.sep, ".")
                if modname.endswith("__init__"):
                    modname = modname[: -len("__init__")].rstrip(".")
                mi = ModuleInfo(name=modname, relpath=rel,
                                tree=ast.parse(src, filename=rel),
                                source=src)
                self.modules[modname] = mi

    # ---- linking ----

    def _link(self) -> None:
        for mi in self.modules.values():
            self._collect_module(mi)
        for mi in self.modules.values():
            for ci in mi.classes.values():
                for b in ci.base_names:
                    base = self.resolve_class(mi, b)
                    if base is not None:
                        ci.bases.append(base)
        for mi in self.modules.values():
            for ci in mi.classes.values():
                self._collect_class_attrs(mi, ci)
            self._collect_singletons(mi)
        # constructor-callback binding (needs attr_types): resolve what
        # concrete instances/functions call sites pass for constructor
        # params, so stored-callable dispatch (`self._on_membership(…)`)
        # and protocol-typed attrs (`self.callback.on_worker()`) resolve
        # to their real targets — the witness exposed these as real
        # runtime lock orderings the resolver previously missed
        for mi in self.modules.values():
            for ci in mi.classes.values():
                self._collect_param_bindings(mi, ci)
        for mi in self.modules.values():
            for ci in mi.classes.values():
                for attr, param in ci.attr_params.items():
                    for kind, val in ci.param_bindings.get(param, ()):
                        if kind == "c":
                            ci.attr_types.setdefault(attr, set()).add(val)
                        else:
                            ci.attr_callables.setdefault(
                                attr, set()).add(val)

    def _collect_module(self, mi: ModuleInfo) -> None:
        # imports are collected from the WHOLE module, function bodies
        # included — deferred imports (`from ..checkpoint import
        # save_checkpoint` inside a method, `from tfidf_tpu_torch import
        # native as native_mod` in Engine.__init__) carry exactly the
        # cross-module lock edges the witness observes at runtime
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    mi.imports[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    mi.imports[a.asname or a.name] = \
                        f"{node.module}.{a.name}"
        for node in mi.tree.body:
            if isinstance(node, ast.FunctionDef):
                fi = FuncInfo(f"{mi.name}.{node.name}", mi.name, None, node)
                mi.functions[node.name] = fi
                self._collect_nested(mi, fi)
                mi.module_globals.add(node.name)
            elif isinstance(node, ast.ClassDef):
                ci = ClassInfo(f"{mi.name}.{node.name}", mi.name, node,
                               base_names=list(node.bases))
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        f = FuncInfo(f"{ci.qual}.{sub.name}", mi.name, ci,
                                     sub)
                        ci.methods[sub.name] = f
                        self._collect_nested(mi, f)
                mi.classes[node.name] = ci
                mi.module_globals.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    if isinstance(t, ast.Name):
                        mi.module_globals.add(t.id)
                value = node.value
                lockname = self._lock_factory(mi, value)
                if lockname is not None:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            name = f"{mi.name}.{t.id}"
                            mi.module_locks[t.id] = name
                            self.lock_sites[(mi.relpath,
                                             value.lineno)] = name

    def _collect_nested(self, mi: ModuleInfo, fi: FuncInfo) -> None:
        for stmt in getattr(fi.node, "body", []):
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.FunctionDef):
                    child = FuncInfo(f"{fi.qual}.<locals>.{sub.name}",
                                     mi.name, fi.cls, sub, parent=fi)
                    fi.nested.setdefault(sub.name, child)

    def _lock_factory(self, mi: ModuleInfo,
                      value: ast.expr | None) -> str | None:
        """'' for threading.Lock()/RLock(), 'cond' for Condition(),
        'cond:<attr>' for Condition(self.X); None otherwise."""
        if not isinstance(value, ast.Call):
            return None
        dotted = _dotted(value.func)
        if dotted is None:
            return None
        leaf = dotted.split(".")[-1]
        if dotted.startswith("threading."):
            pass
        elif "." not in dotted and mi.imports.get(
                dotted, "") == f"threading.{dotted}":
            pass
        else:
            return None
        if leaf in _LOCK_FACTORIES:
            return ""
        if leaf == "Condition":
            if value.args and isinstance(value.args[0], ast.Attribute) \
                    and isinstance(value.args[0].value, ast.Name) \
                    and value.args[0].value.id == "self":
                return f"cond:{value.args[0].attr}"
            if not value.args:
                return "cond"
        return None

    def _collect_class_attrs(self, mi: ModuleInfo, ci: ClassInfo) -> None:
        for meth in ci.methods.values():
            for stmt in ast.walk(meth.node):
                if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                    self._class_attr_assign(mi, ci, stmt)

    def _class_attr_assign(self, mi: ModuleInfo, ci: ClassInfo,
                           stmt: ast.Assign | ast.AnnAssign) -> None:
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        attrs = [t.attr for t in targets
                 if isinstance(t, ast.Attribute)
                 and isinstance(t.value, ast.Name) and t.value.id == "self"]
        if not attrs:
            return
        value = stmt.value
        kind = self._lock_factory(mi, value)
        if kind is not None:
            for attr in attrs:
                if kind.startswith("cond:"):
                    # Condition(self.X) shares X's underlying lock —
                    # same node in the graph, no new creation site
                    aliased = ci.attr_locks.get(kind[5:])
                    name = aliased or f"{ci.qual}.{attr}"
                    ci.attr_locks[attr] = name
                    if aliased is None:
                        self.lock_sites[(mi.relpath, value.lineno)] = name
                else:
                    name = f"{ci.qual}.{attr}"
                    ci.attr_locks[attr] = name
                    self.lock_sites[(mi.relpath, value.lineno)] = name
            return
        # annotated container: self._x: dict[int, T] = {}
        ann = stmt.annotation if isinstance(stmt, ast.AnnAssign) else None
        if ann is not None:
            for attr in attrs:
                elems = self._ann_container_elems(mi, ann)
                if elems:
                    ci.attr_elem_types.setdefault(attr, set()).update(elems)
                for t in self._ann_types(mi, ann):
                    ci.attr_types.setdefault(attr, set()).add(t)
        if value is not None:
            types = self._value_types(mi, ci, value)
            for attr in attrs:
                if types:
                    ci.attr_types.setdefault(attr, set()).update(types)
            # `self.x = some_param` (directly, or as an `a or B()`
            # operand): remember the param so constructor-callback
            # bindings can flow into the attr
            names = [value] if isinstance(value, ast.Name) else (
                [v for v in value.values if isinstance(v, ast.Name)]
                if isinstance(value, ast.BoolOp) else [])
            for n in names:
                for attr in attrs:
                    ci.attr_params.setdefault(attr, n.id)

    def _collect_param_bindings(self, mi: ModuleInfo,
                                enclosing: ClassInfo) -> None:
        """For every package-class construction inside ``enclosing``'s
        methods, record what each constructor param is bound to:
        ``callback=self`` binds the enclosing class, ``on_change=
        self._meth`` binds that method, a bare function name binds it."""
        for meth in enclosing.methods.values():
            for node in ast.walk(meth.node):
                if not isinstance(node, ast.Call):
                    continue
                target = self.resolve_class(mi, node.func)
                if target is None:
                    continue
                init = target.method("__init__")
                if init is None:
                    continue
                params = [a.arg for a in init.node.args.args[1:]]
                pairs: list[tuple[str, ast.expr]] = list(
                    zip(params, node.args))
                for kw in node.keywords:
                    if kw.arg is not None:
                        pairs.append((kw.arg, kw.value))
                for pname, arg in pairs:
                    binding = None
                    if isinstance(arg, ast.Name) and arg.id == "self":
                        binding = ("c", enclosing.qual)
                    elif isinstance(arg, ast.Attribute) and isinstance(
                            arg.value, ast.Name) and arg.value.id == "self":
                        m = enclosing.method(arg.attr)
                        if m is not None:
                            binding = ("f", m)
                        else:
                            # a typed instance attr handed over whole
                            # (NativeVocabulary(self.native, …))
                            for tq in enclosing.attr_types.get(
                                    arg.attr, ()):
                                target.param_bindings.setdefault(
                                    pname, set()).add(("c", tq))
                    elif isinstance(arg, ast.Name) \
                            and arg.id in mi.functions:
                        binding = ("f", mi.functions[arg.id])
                    if binding is not None:
                        target.param_bindings.setdefault(
                            pname, set()).add(binding)

    def _collect_singletons(self, mi: ModuleInfo) -> None:
        for node in mi.tree.body:
            if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call):
                types = self._value_types(mi, None, node.value)
                if types:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            mi.singleton_types.setdefault(
                                t.id, set()).update(types)

    # ---- type helpers ----

    def resolve_class(self, mi: ModuleInfo,
                      node: ast.expr) -> ClassInfo | None:
        dotted = _dotted(node)
        if dotted is None:
            return None
        return self.class_by_name(mi, dotted)

    def class_by_name(self, mi: ModuleInfo, dotted: str) -> ClassInfo | None:
        head = dotted.split(".")[0]
        if dotted in mi.classes:
            return mi.classes[dotted]
        target = mi.imports.get(head)
        if target is None:
            return None
        full = target + dotted[len(head):]
        if not full.startswith(self.package + "."):
            return None
        modname, _, clsname = full[len(self.package) + 1:].rpartition(".")
        other = self.modules.get(modname)
        if other is not None:
            return other.classes.get(clsname)
        return None

    def _ann_types(self, mi: ModuleInfo, ann: ast.expr) -> set[str]:
        """Class quals named by an annotation ('T', 'T | None',
        Optional[T] — containers excluded, see _ann_container_elems)."""
        out: set[str] = set()
        if isinstance(ann, ast.BinOp):      # T | None
            out |= self._ann_types(mi, ann.left)
            out |= self._ann_types(mi, ann.right)
            return out
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            try:
                return self._ann_types(
                    mi, ast.parse(ann.value, mode="eval").body)
            except SyntaxError:
                return out
        ci = self.resolve_class(mi, ann) if not isinstance(
            ann, ast.Subscript) else None
        if ci is not None:
            out.add(ci.qual)
        return out

    def _ann_container_elems(self, mi: ModuleInfo,
                             ann: ast.expr) -> set[str]:
        """Value-type quals for dict[K, V] / list[T] annotations."""
        if not isinstance(ann, ast.Subscript):
            return set()
        base = _dotted(ann.value) or ""
        sl = ann.slice
        if base.split(".")[-1] == "dict" and isinstance(sl, ast.Tuple) \
                and len(sl.elts) == 2:
            return self._ann_types(mi, sl.elts[1])
        if base.split(".")[-1] in ("list", "set", "deque"):
            return self._ann_types(mi, sl)
        return set()

    def _value_types(self, mi: ModuleInfo, ci: ClassInfo | None,
                     value: ast.expr) -> set[str]:
        """Candidate class quals a value expression may produce."""
        out: set[str] = set()
        if isinstance(value, ast.BoolOp):
            for v in value.values:
                out |= self._value_types(mi, ci, v)
            return out
        if isinstance(value, ast.IfExp):
            return (self._value_types(mi, ci, value.body)
                    | self._value_types(mi, ci, value.orelse))
        if isinstance(value, ast.Call):
            target = self.resolve_class(mi, value.func)
            if target is not None:
                out.add(target.qual)
            return out
        if isinstance(value, ast.Name) and ci is not None:
            # parameter with annotation in the enclosing __init__?
            init = ci.methods.get("__init__")
            if init is not None:
                for arg in (init.node.args.args
                            + init.node.args.kwonlyargs):
                    if arg.arg == value.id and arg.annotation is not None:
                        out |= self._ann_types(mi, arg.annotation)
        return out

    # ---- convenience ----

    def iter_functions(self):
        """Yield every FuncInfo in the tree (module funcs, methods, and
        their nested defs)."""
        def rec(fi: FuncInfo):
            yield fi
            for c in fi.nested.values():
                yield from rec(c)
        for mi in self.modules.values():
            for fi in mi.functions.values():
                yield from rec(fi)
            for c in mi.classes.values():
                for fi in c.methods.values():
                    yield from rec(fi)

    def all_classes(self) -> dict[str, ClassInfo]:
        out = {}
        for mi in self.modules.values():
            for ci in mi.classes.values():
                out[ci.qual] = ci
        return out


# ---------------------------------------------------------------------------
# baseline / allowlist
# ---------------------------------------------------------------------------

def caller_files(root: str, exclude: tuple = ()) -> list[str]:
    """Files outside the package whose code counts as the port's
    callers: the port's tests (``tests/test_torch_*.py``; the seeded
    fixtures under ``tests/data/`` are not callers), ``chip_smoke.py``
    and the probes that drive the port. ``exclude`` names test files
    that mention symbols or endpoints without calling them."""
    out: list[str] = []
    tests = os.path.join(root, "tests")
    if os.path.isdir(tests):
        out += [os.path.join(tests, fn) for fn in sorted(os.listdir(tests))
                if fn.startswith("test_torch_") and fn.endswith(".py")
                and fn not in exclude]
    if os.path.isdir(root):
        out += [os.path.join(root, fn) for fn in sorted(os.listdir(root))
                if fn == "chip_smoke.py" or fn.startswith("probe_")
                and fn.endswith(".py") and ("torch" in fn or fn in (
                    "probe_streaming.py", "probe_fleet.py"))]
    return out


def load_allowlist(path: str = ALLOWLIST_PATH) -> dict[str, str]:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_baseline(path: str = BASELINE_PATH) -> list[str]:
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def run_analyzers(root: str, analyzers: list[str] | None = None
                  ) -> list[Finding]:
    """Run the requested analyzers (default: all) over the package at
    ``root``; returns RAW findings (baseline/allowlist not applied)."""
    from tfidf_tpu_torch.tools.graftcheck import (deadsymbols, devicecheck,
                                                  jitpurity, lockgraph,
                                                  protocol, registry_drift,
                                                  resilience, storageseam,
                                                  wallclock)
    tree = SourceTree(root)
    passes = {
        "lockgraph": lockgraph.analyze,
        "jitpurity": jitpurity.analyze,
        "devicecheck": devicecheck.analyze,
        "registry_drift": lambda t: registry_drift.analyze(t, root),
        "resilience": resilience.analyze,
        "wallclock": wallclock.analyze,
        "protocol": lambda t: protocol.analyze(t, root),
        "deadsymbols": lambda t: deadsymbols.analyze(t, root),
        "storageseam": lambda t: storageseam.analyze(t, root),
    }
    out: list[Finding] = []
    for name, fn in passes.items():
        if analyzers is None or name in analyzers:
            out.extend(fn(tree))
    return out


def triage(findings: list[Finding], allowlist: dict[str, str],
           baseline: list[str]) -> tuple[list[Finding], list[Finding],
                                         list[str]]:
    """Split findings into (new, baselined, stale_baseline_keys)."""
    base = set(baseline)
    seen = {f.key for f in findings}
    new = [f for f in findings
           if f.key not in allowlist and f.key not in base]
    pinned = [f for f in findings
              if f.key in base and f.key not in allowlist]
    stale = sorted(k for k in base if k not in seen)
    return new, pinned, stale
