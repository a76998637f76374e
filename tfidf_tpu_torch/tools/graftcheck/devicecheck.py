"""Device hygiene analysis for the torch/CUDA port: cache and build
discipline, transfer hygiene, in-place audit.

The failure modes that dominate a CUDA serving path are silent work
moved into the hot loop (an ``nvcc`` build or a library load behind the
first query of a new shape, a per-corpus-size cache that mints a fresh
compiled callable or buffer for every size) and implicit host<->device
synchronization (``.item()`` / ``.cpu()`` / ``int()`` / truthiness on a
CUDA tensor, an op whose output shape depends on the data, a stream or
device synchronize) mid-dispatch, which stalls the pipeline the executor
exists to overlap. Three static passes guard them:

(a) **cache and build discipline**

    * kernel libraries are built and loaded only through
      ``kernels.py`` (``build_all``, the memoized ``load``, counted by
      ``build_count()``): a ``ctypes`` library load or an ``nvcc``
      subprocess anywhere else is a finding, and so is a ``build_all``
      call reached from the serving cone (the cone walk stops at
      ``kernels.load``, the memoized seam);
    * every ``torch.compile`` / ``torch.jit.script`` /
      ``torch.jit.trace`` creation found in the package (the jitpurity
      root finder, extended with creation scope) must be reached through
      an accepted seam — created at import time, memo-stored into a
      subscripted cache, an ``lru_cache``-decorated factory, created
      inside another capture root, or a factory returning it;
    * the key of such a cache, and of any cache of device buffers
      (``self._buf[key] = torch.empty(...)``), must be capacity-class:
      corpus-dependent values (``.shape``, ``len()``, ``n_docs`` /
      ``nnz`` / ... attrs) pass through ``next_capacity`` (or are bounded
      by ``min``/``max`` against a clean value) before keying it.

(b) **transfer hygiene** — inside the hot serving cone (searcher
    dispatch, pipeline dispatch/fetch stages, tiering upload ring, mesh
    scatter paths; closed under the package call graph), these are
    findings on a tensor-typed value: ``.item()``, ``.tolist()``,
    ``.cpu()``, ``.numpy()``, ``.to("cpu")``; ``int()`` / ``float()`` /
    ``bool()`` / truthiness; ``np.asarray`` / ``np.array``;
    ``torch.nonzero`` / ``.nonzero()`` / ``torch.unique`` /
    ``torch.masked_select`` and indexing with a boolean tensor (their
    output shape depends on the data, so CUDA copies a count back); and
    ``.synchronize()`` on the device, a stream or an event. Device-ness
    comes from ``torch.*`` results, calls to package functions that
    return tensors (``-> torch.Tensor``, or an ``ops`` function with no
    return annotation), methods on device values, and attributes
    annotated ``torch.Tensor``; host values stay clean — an attribute
    annotated ``np.ndarray`` is host, so its ``.tolist()`` is not a
    finding. ``.cpu()``, ``.numpy()`` and ``.to("cpu")`` exist only on
    tensors and count wherever the value is not known to be host. d2h is
    confined to the fetch stage by construction: ``ops.topk
    .fetch_packed`` / ``unpack_topk`` are the named exemption, and every
    OTHER d2h site must carry a reviewed allowlist reason —
    :func:`explained_transfer_sites` hands that same set to the runtime
    device witness, so an observation the static cone did not explain
    fails the instrumented run.

(c) **in-place audit** — a call into a package function that takes a
    tensor and returns one (both annotated ``torch.Tensor``), whose
    tensor argument is provably dead after the call (the same name or
    attr — or an enclosing attr — is rebound in the caller), is a
    finding-for-review: ``out=`` or an in-place update would save the
    allocation, but aliasing (published snapshots holding the old
    tensor) can make it unsound, so each site is reviewed and either
    fixed or pinned with the reason.

Like every graftcheck pass: pure stdlib AST, may-miss on unresolvable
calls, stable line-number-free keys (``devicecheck:<kind>:<qual>:<op>``),
committed allowlist carries one reviewed reason per intentional finding.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass

from tfidf_tpu_torch.tools.graftcheck.core import (
    Finding, FuncInfo, ModuleInfo, SourceTree, _dotted)
from tfidf_tpu_torch.tools.graftcheck.jitpurity import (_compile_kind,
                                                        _Purity)

# corpus-dependent attribute leaves: values that grow with the indexed
# corpus (doc counts, nnz, live totals) — capacity-class attrs
# (`_doc_cap`, `_chunk`, `_min_cap`) are deliberately NOT here
CORPUS_ATTRS = {
    "n_docs", "num_docs", "nnz", "num_names", "n_names", "n_live",
    "doc_count", "total_docs", "nnz_live", "live_total", "vocab_size",
}

# the capacity-class sanitizer: power-of-two bucketing caps the number
# of distinct cache keys at O(log corpus)
SANITIZERS = {"next_capacity"}

# the hot serving cone roots: searcher dispatch, pipeline dispatch/fetch
# stages, tiering upload ring, mesh scatter paths, and the host fallback
# that serves while the device is sick. A missing root whose
# module still exists is a finding — a rename must update this list, not
# silently shrink the cone. `df_host` is a root of its own because it is
# reached from the tiered dispatch via PROPERTY access, which call
# resolution cannot follow.
CONE_ROOTS = (
    "engine.searcher.Searcher._dispatch_chunk",
    "engine.searcher.Searcher._dispatch_tiered",
    "engine.searcher.Searcher._finish_chunk",
    "engine.searcher.Searcher._search_unbounded",
    "engine.segments.SegmentedSnapshot.df_host",
    "engine.searcher.QueryVectorizerMixin._run_pipelined",
    "engine.searcher.QueryVectorizerMixin._run_inline",
    "engine.pipeline.PipelineExecutor._dispatch_loop",
    "engine.pipeline.PipelineExecutor._fetch_loop",
    "engine.tiering.TierManager.prefetch",
    "engine.tiering.TierManager.fault_in",
    "engine.tiering.TierManager.handle_view",
    "engine.tiering.TierManager._build_device",
    "engine.dense.EmbeddingColumn.search_batch",
    "parallel.mesh_index.MeshSearcher._dispatch_chunk",
    "parallel.mesh_index.MeshSearcher._finish_chunk",
    "parallel.mesh_index.MeshSearcher._rank_all",
    "engine.compute_health.HostFallbackScorer.search",
    "engine.compute_health.HostFallbackScorer.search_arrays",
)

# d2h lives HERE by construction: the pipeline's named fetch stage and
# its host-side inverse. (module, function-leaf) pairs — the same naming
# the runtime witness derives from frames.
FETCH_STAGE = {("ops.topk", "fetch_packed"), ("ops.topk", "unpack_topk")}

# sanctioned bulk-transfer stages OUTSIDE the serving cone: checkpoint
# export fetches every device buffer to host by definition (that IS the
# operation), and runs off the serving path under the write lock; the
# host-fallback mirror build fetches the snapshot once per snapshot.
# Named here so the runtime witness can explain their transfers without
# dragging checkpoint code into the hot-cone analysis; a hot-path
# function must never be added to this set — put it in CONE_ROOTS and
# let the finding force a review instead.
BULK_STAGES = {
    ("engine.index", "export_snapshot_arrays"),
    ("engine.segments", "export_full_state"),
    ("engine.dense", "export_arrays"),
    ("engine.compute_health", "_fetch_host"),
}

# the one module allowed to build and load kernel libraries, and its
# memoized loader (the cone walk stops there: a loaded library is
# reused, a missing one is built once)
KERNEL_MODULE = "kernels"
CACHE_SEAMS = {"kernels.load"}

_SYNC_BUILTINS = {"float", "int", "bool"}
_NP_FETCHERS = {"asarray", "array", "ascontiguousarray"}
# methods that leave the device (flagged themselves, never taint
# carriers) or read host metadata without a transfer
_HOST_METHODS = {"item", "tolist", "cpu", "numpy", "size", "dim", "numel",
                 "nelement", "data_ptr", "element_size", "stride",
                 "is_contiguous", "get_device", "storage_offset",
                 "is_pinned", "synchronize", "record", "query"}
# attributes of a tensor that are host metadata, not tensors
_METADATA_ATTRS = {"shape", "dtype", "device", "is_cuda", "ndim", "layout",
                   "requires_grad", "is_sparse", "names", "itemsize",
                   "nbytes", "grad_fn"}
# torch.* functions returning host values
_HOST_TORCH = {"is_tensor", "is_floating_point", "numel", "device", "Size",
               "dtype", "no_grad", "inference_mode", "enable_grad",
               "get_default_dtype", "manual_seed", "set_grad_enabled",
               "is_grad_enabled", "from_numpy", "finfo", "iinfo",
               "Generator", "set_num_threads", "get_num_threads",
               "promote_types", "result_type", "is_nonzero"}
_TORCH_SUBMODULES = {"nn", "fft", "linalg", "special", "sparse"}
_ALLOCATORS = {"empty", "zeros", "ones", "full", "empty_strided"}
# ops whose output shape depends on the data: CUDA copies a count back
_DATA_SHAPED = {"nonzero": "nonzero", "argwhere": "nonzero",
                "unique": "unique", "unique_consecutive": "unique",
                "masked_select": "masked_select"}
_BOOL_TORCH = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "lt", "le", "gt", "ge", "isin"}
# d2h ops the fetch stage may perform
_FETCH_OPS = {"cpu", "to_cpu", "numpy", "asarray", "tolist"}

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _shallow(nodes, *, through_classes: bool = False):
    """Walk ``nodes`` and their descendants without descending into
    nested function/lambda scopes (and, by default, class bodies)."""
    stack = list(nodes)
    while stack:
        n = stack.pop()
        yield n
        for c in ast.iter_child_nodes(n):
            if isinstance(c, _SCOPES):
                continue
            if isinstance(c, ast.ClassDef) and not through_classes:
                continue
            stack.append(c)


def _body_of(fi: FuncInfo) -> list:
    body = fi.node.body
    if not isinstance(body, list):          # Lambda
        body = [ast.Expr(value=body)]
    return body


def _mentions_tensor(ann: ast.expr | None) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return "torch.Tensor" in text or text.split("|")[0].strip() in (
        "Tensor", "'Tensor'")


def _is_cpu_target(expr: ast.expr) -> bool:
    """``"cpu"``, ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return expr.value == "cpu"
    if isinstance(expr, ast.Call) and _dotted(expr.func) == "torch.device":
        return bool(expr.args) and _is_cpu_target(expr.args[0])
    return False


def _to_cpu(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    if call.args and _is_cpu_target(call.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu_target(kw.value)
               for kw in call.keywords)


def _host_alloc(call: ast.Call) -> bool:
    """``torch.empty(..., pin_memory=True)`` / ``device="cpu"``: a host
    tensor."""
    return any(kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True
               or kw.arg == "device" and _is_cpu_target(kw.value)
               for kw in call.keywords)


def _torch_device_call(d: str) -> bool:
    """True for a ``torch.*`` call that yields a tensor."""
    parts = d.split(".")
    if parts[0] != "torch" or len(parts) < 2:
        return False
    if len(parts) == 2:
        return parts[1] not in _HOST_TORCH and not parts[1][:1].isupper()
    return parts[1] in _TORCH_SUBMODULES


# ---------------------------------------------------------------------------
# compile-root discovery (the jitpurity finder, with scope)
# ---------------------------------------------------------------------------

@dataclass
class CompileRoot:
    mi: ModuleInfo
    fi: FuncInfo | None       # the compiled callable, when resolvable
    label: str
    kind: str                 # "compile" | "script" | "trace"
    call: ast.Call | None     # the compile call node
    scope: FuncInfo | None    # enclosing function (None = module scope)
    bound: str | None         # module-level name the entry is bound to
    lineno: int


def _all_funcs(mi: ModuleInfo) -> list[FuncInfo]:
    return _Purity._all_funcs(mi)


def compile_roots(tree: SourceTree) -> list[CompileRoot]:
    """Every ``torch.compile`` / ``torch.jit.script`` / ``torch.jit
    .trace`` creation in the package, with its creation scope and
    module-level binding."""
    purity = _Purity(tree)
    out: list[CompileRoot] = []
    for mi in tree.modules.values():
        by_name = purity._funcs_by_name(mi)
        scopes: list[tuple[FuncInfo | None, list]] = [
            (None, [s for s in mi.tree.body if not isinstance(s, _SCOPES)])]
        scopes += [(fi, _body_of(fi)) for fi in _all_funcs(mi)]
        for scope, body in scopes:
            for node in _shallow(body, through_classes=scope is None):
                if not (isinstance(node, ast.Call) and node.args):
                    continue
                kind = _compile_kind(node.func)
                if kind is None:
                    continue
                arg = node.args[0]
                fi = None
                if isinstance(arg, ast.Name):
                    fi = by_name.get(arg.id)
                    name = arg.id
                elif isinstance(arg, ast.Lambda):
                    fi = FuncInfo(f"{mi.name}.<lambda@L{arg.lineno}>",
                                  mi.name, None, arg)
                    name = fi.qual
                else:
                    name = _dotted(arg) or f"<expr@L{arg.lineno}>"
                bound = None
                if scope is None:
                    for stmt in mi.tree.body:
                        if isinstance(stmt, ast.Assign) \
                                and stmt.value is node:
                            for t in stmt.targets:
                                if isinstance(t, ast.Name):
                                    bound = t.id
                out.append(CompileRoot(mi, fi, f"{kind}({name})", kind,
                                       node, scope, bound, node.lineno))
        # decorator roots: scope = where the def itself lives
        for fi in _all_funcs(mi):
            for dec in fi.node.decorator_list:
                kind = _compile_kind(dec)
                if kind is None:
                    continue
                bound = (fi.node.name
                         if fi.parent is None and fi.cls is None else None)
                out.append(CompileRoot(
                    mi, fi, f"@{kind} {fi.qual}", kind,
                    dec if isinstance(dec, ast.Call) else None,
                    fi.parent, bound, fi.node.lineno))
    return out


# ---------------------------------------------------------------------------
# corpus-value taint (pass a) — wallclock-style name chaining
# ---------------------------------------------------------------------------

def _corpus_tainted(expr: ast.expr, tainted: set[str]) -> bool:
    """True if ``expr`` may carry a corpus-dependent value that has not
    passed through a capacity-class sanitizer."""
    if isinstance(expr, ast.Call):
        d = _dotted(expr.func) or ""
        leaf = d.split(".")[-1]
        if leaf in SANITIZERS:
            return False                    # bucketed: capacity-class
        if leaf in ("min", "max"):
            # bounded by any clean operand: at most O(bound) distinct
            # values, stabilizing once the corpus outgrows it
            args = list(expr.args)
            if args and any(not _corpus_tainted(a, tainted)
                            for a in args):
                return False
            return any(_corpus_tainted(a, tainted) for a in args)
        if leaf == "len":
            return True
        if leaf in ("int", "float", "abs", "round"):
            return any(_corpus_tainted(a, tainted) for a in expr.args)
        return False                        # unresolved call: may-miss
    if isinstance(expr, ast.Attribute):
        return expr.attr in CORPUS_ATTRS or expr.attr in (
            "shape", "size", "nbytes")
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    if isinstance(expr, ast.Subscript):
        return _corpus_tainted(expr.value, tainted) or \
            _corpus_tainted(expr.slice, tainted)
    if isinstance(expr, (ast.BinOp, ast.BoolOp, ast.UnaryOp, ast.IfExp,
                         ast.Tuple, ast.Compare)):
        return any(_corpus_tainted(c, tainted)
                   for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))
    return False


def _corpus_taint_map(fi: FuncInfo) -> set[str]:
    """Names in ``fi`` carrying unsanitized corpus-dependent values — a
    forward pass over the (shallow) assignments."""
    tainted: set[str] = set()
    stmts = [n for n in _shallow(_body_of(fi))
             if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
    stmts.sort(key=lambda n: n.lineno)
    for _ in range(2):                      # cheap fixpoint for loops
        for stmt in stmts:
            value = stmt.value
            if value is None:
                continue
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            hit = _corpus_tainted(value, tainted)
            for t in targets:
                names = ([t.id] if isinstance(t, ast.Name) else
                         [e.id for e in getattr(t, "elts", [])
                          if isinstance(e, ast.Name)])
                for n in names:
                    if hit:
                        tainted.add(n)
                    else:
                        tainted.discard(n)  # re-bound clean
    return tainted


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------

class _DeviceCheck:
    def __init__(self, tree: SourceTree,
                 cone_roots: tuple = CONE_ROOTS) -> None:
        self.tree = tree
        self.cone_roots = cone_roots
        self.findings: list[Finding] = []
        purity = _Purity(tree)
        self._lg = purity._lg
        self.roots = compile_roots(tree)
        self._root_fis = {id(r.fi) for r in self.roots
                          if r.fi is not None}
        self._device_attrs, self._host_attrs = self._collect_attr_kinds()

    # -- shared helpers ---------------------------------------------------

    def _flag(self, mi: ModuleInfo, key: str, msg: str,
              node: ast.AST) -> None:
        if any(f.key == key for f in self.findings):
            return
        self.findings.append(Finding(
            "devicecheck", key, msg, mi.relpath,
            getattr(node, "lineno", 0)))

    def _collect_attr_kinds(self) -> tuple[dict[str, set[str]],
                                           dict[str, set[str]]]:
        """class qual -> attrs annotated as tensors (dataclass /
        NamedTuple fields, ``self.x: torch.Tensor`` in a method), and
        -> attrs annotated as something else (``np.ndarray``, ``int``)."""
        dev: dict[str, set[str]] = {}
        host: dict[str, set[str]] = {}

        def note(ci, name, ann):
            into = dev if _mentions_tensor(ann) else host
            into.setdefault(ci.qual, set()).add(name)

        for mi in self.tree.modules.values():
            for ci in mi.classes.values():
                for stmt in ci.node.body:
                    if isinstance(stmt, ast.AnnAssign) and isinstance(
                            stmt.target, ast.Name):
                        note(ci, stmt.target.id, stmt.annotation)
                for meth in ci.methods.values():
                    for stmt in ast.walk(meth.node):
                        t = getattr(stmt, "target", None)
                        if isinstance(stmt, ast.AnnAssign) and isinstance(
                                t, ast.Attribute) and isinstance(
                                t.value, ast.Name) and t.value.id == "self":
                            note(ci, t.attr, stmt.annotation)
        return dev, host

    def _attr_classes(self, fi: FuncInfo, locals_, base: ast.expr
                      ) -> set[str]:
        if not isinstance(base, ast.Name):
            return set()
        classes = set(locals_.get(base.id, ()))
        if base.id == "self" and fi.cls is not None:
            classes.add(fi.cls.qual)
            for b in fi.cls.bases:
                classes.add(b.qual)
        return classes

    # -- device typing ----------------------------------------------------

    def _typing(self, mi: ModuleInfo, fi: FuncInfo):
        """(device, device_bool, host) predicates over expressions of
        ``fi``: may the value be a tensor / a boolean tensor / is it
        known to live on the host."""
        locals_ = self._lg._local_types(mi, fi)
        tainted: set[str] = set()
        bools: set[str] = set()
        hosts: set[str] = set()
        args = getattr(fi.node, "args", None)
        if args is not None:
            for a in list(args.args) + list(args.kwonlyargs):
                if _mentions_tensor(a.annotation):
                    tainted.add(a.arg)
                elif a.annotation is not None and "ndarray" in \
                        ast.unparse(a.annotation):
                    hosts.add(a.arg)

        def callees(call):
            return self._lg._resolve_call(mi, fi, locals_, call)

        def returns_device(call) -> list | None:
            """Per-position device-ness of a resolvable package call's
            result, from its return annotation (None: unresolved)."""
            for target in callees(call):
                ret = getattr(target.node, "returns", None)
                if ret is None:
                    if target.module.startswith("ops."):
                        return [True]
                    continue
                if isinstance(ret, ast.Subscript) and (_dotted(
                        ret.value) or "").split(".")[-1] in (
                            "tuple", "Tuple") and isinstance(
                            ret.slice, ast.Tuple):
                    return [_mentions_tensor(e) for e in ret.slice.elts]
                return [_mentions_tensor(ret)]
            return None

        def device(expr: ast.expr) -> bool:
            if isinstance(expr, ast.Call):
                d = _dotted(expr.func) or ""
                if _torch_device_call(d):
                    return not _host_alloc(expr)
                if isinstance(expr.func, ast.Attribute):
                    attr = expr.func.attr
                    if attr == "to" and not _to_cpu(expr):
                        return True
                    if attr == "cuda":
                        return True
                    if attr not in _HOST_METHODS and attr != "to" \
                            and device(expr.func.value):
                        return True
                got = returns_device(expr)
                return bool(got) and any(got)
            if isinstance(expr, ast.Attribute):
                # a tensor's tensor attributes (`.values`, `.T`) are
                # tensors, its metadata (`.shape`, `.dtype`) is not; a
                # field of an object is a tensor when annotated so
                if expr.attr not in _METADATA_ATTRS and device(expr.value):
                    return True
                return any(expr.attr in self._device_attrs.get(c, ())
                           for c in self._attr_classes(fi, locals_,
                                                       expr.value))
            if isinstance(expr, ast.Name):
                return expr.id in tainted
            if isinstance(expr, ast.Subscript):
                return device(expr.value)
            if isinstance(expr, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                    for op in expr.ops):
                return False                # identity/membership: host
            if isinstance(expr, (ast.BinOp, ast.UnaryOp, ast.IfExp,
                                 ast.Compare)):
                return any(device(c) for c in ast.iter_child_nodes(expr)
                           if isinstance(c, ast.expr))
            return False

        def device_bool(expr: ast.expr) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in bools
            if isinstance(expr, ast.Compare):
                return device(expr)
            if isinstance(expr, ast.UnaryOp) and isinstance(
                    expr.op, (ast.Invert, ast.Not)):
                return device_bool(expr.operand)
            if isinstance(expr, ast.BinOp) and isinstance(
                    expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
                return device_bool(expr.left) or device_bool(expr.right)
            if isinstance(expr, ast.Call):
                d = _dotted(expr.func) or ""
                if d.startswith("torch.") and d.split(".")[-1] in \
                        _BOOL_TORCH:
                    return True
                if isinstance(expr.func, ast.Attribute) and \
                        device(expr.func.value) and (
                            expr.func.attr in _BOOL_TORCH
                            or expr.func.attr == "bool"
                            or expr.func.attr == "to" and any(
                                _dotted(a) == "torch.bool"
                                for a in expr.args)):
                    return True
            return False

        def host(expr: ast.expr) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in hosts
            if isinstance(expr, ast.Attribute):
                classes = self._attr_classes(fi, locals_, expr.value)
                return bool(classes) and any(
                    expr.attr in self._host_attrs.get(c, ())
                    for c in classes) and not device(expr)
            if isinstance(expr, ast.Call):
                d = _dotted(expr.func) or ""
                return d.split(".")[0] in ("np", "numpy") or (
                    d.startswith("torch.") and _host_alloc(expr)) or \
                    d == "torch.from_numpy"
            return False

        stmts = [n for n in _shallow(_body_of(fi))
                 if isinstance(n, (ast.Assign, ast.AnnAssign))]
        stmts.sort(key=lambda n: n.lineno)
        for _ in range(2):
            for stmt in stmts:
                if stmt.value is None:
                    continue
                targets = (stmt.targets if isinstance(stmt, ast.Assign)
                           else [stmt.target])
                per_pos = (returns_device(stmt.value)
                           if isinstance(stmt.value, ast.Call) else None)
                hit = device(stmt.value)
                is_bool = device_bool(stmt.value)
                is_host = host(stmt.value)
                for t in targets:
                    if isinstance(t, ast.Name):
                        pairs = [(t.id, hit)]
                    elif isinstance(t, ast.Tuple):
                        names = [e.id if isinstance(e, ast.Name) else None
                                 for e in t.elts]
                        if per_pos is not None and len(per_pos) == len(
                                names):
                            pairs = list(zip(names, per_pos))
                        else:
                            pairs = [(n, hit) for n in names]
                    else:
                        continue
                    for n, dev in pairs:
                        if n is None:
                            continue
                        if dev:
                            tainted.add(n)
                        if is_bool:
                            bools.add(n)
                        if is_host:
                            hosts.add(n)
        return device, device_bool, host

    # -- pass a: cache and build discipline -------------------------------

    def check_cache_discipline(self) -> None:
        for r in self.roots:
            if r.scope is not None:
                self._check_scoped_root(r)
        self._check_buffer_caches()
        self._check_kernel_seam()

    def _check_scoped_root(self, r: CompileRoot) -> None:
        scope = r.scope
        body = _body_of(scope)
        # created inside another capture root: re-created only when the
        # outer one is
        if id(scope) in self._root_fis:
            return
        for dec in scope.node.decorator_list:
            d = _dotted(dec if not isinstance(dec, ast.Call)
                        else dec.func) or ""
            if d.split(".")[-1] in ("lru_cache", "cache"):
                return
        stmts = list(_shallow(body))
        created: set[str] = set()
        for n in stmts:
            if isinstance(n, ast.Assign) and n.value is r.call:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        created.add(t.id)
        for key_expr in self._memo_keys(stmts, lambda v: v is r.call or (
                isinstance(v, ast.Name) and v.id in created)):
            if _corpus_tainted(key_expr, _corpus_taint_map(scope)):
                self._flag(
                    r.mi, f"devicecheck:compile-unstable-key:{scope.qual}",
                    f"compiled-callable cache in {scope.qual} is keyed on "
                    f"a corpus-dependent value ({r.label}): every corpus "
                    f"size compiles afresh — key on next_capacity()-"
                    f"bucketed values only", key_expr)
            return                          # seam found
        for n in stmts:
            if not isinstance(n, ast.Return) or n.value is None:
                continue
            v = n.value
            if v is r.call or _compile_kind(getattr(v, "func", v)):
                return
            if isinstance(v, ast.Name):
                if v.id in created:
                    return
                nested = scope.nested.get(v.id)
                if nested is not None and id(nested) in self._root_fis:
                    return
        self._flag(
            r.mi, f"devicecheck:compile-uncached:{scope.qual}",
            f"{r.label} is created inside {scope.qual} without a memoized "
            f"cache seam (no subscripted store, lru_cache, factory return, "
            f"or enclosing capture root): every call compiles again",
            r.call if r.call is not None else scope.node)

    @staticmethod
    def _memo_keys(stmts, is_value):
        """Keys of ``container[key] = v`` / ``container.setdefault(key,
        v)`` stores whose value satisfies ``is_value``."""
        for n in stmts:
            if isinstance(n, ast.Assign) and is_value(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Subscript):
                        yield t.slice
            elif isinstance(n, ast.Call) and isinstance(
                    n.func, ast.Attribute) and n.func.attr == \
                    "setdefault" and len(n.args) == 2 and is_value(
                        n.args[1]):
                yield n.args[0]

    def _check_buffer_caches(self) -> None:
        """A cache of device buffers keyed by a corpus-dependent value
        allocates afresh for every corpus size."""
        def alloc(v):
            d = (_dotted(v.func) or "") if isinstance(v, ast.Call) else ""
            return d.startswith("torch.") and d.split(".")[-1] in \
                _ALLOCATORS

        for mi in self.tree.modules.values():
            for fi in _all_funcs(mi):
                stmts = list(_shallow(_body_of(fi)))
                for key_expr in self._memo_keys(stmts, alloc):
                    if _corpus_tainted(key_expr, _corpus_taint_map(fi)):
                        self._flag(
                            mi,
                            f"devicecheck:buffer-unstable-key:{fi.qual}",
                            f"device-buffer cache in {fi.qual} is keyed on "
                            f"a corpus-dependent value: every corpus size "
                            f"allocates afresh — key on next_capacity()-"
                            f"bucketed values only", key_expr)

    def _check_kernel_seam(self) -> None:
        """Kernel libraries are built and loaded only in kernels.py."""
        for mi in self.tree.modules.values():
            if mi.name == KERNEL_MODULE:
                continue
            for fi in _all_funcs(mi):
                for node in _shallow(_body_of(fi)):
                    if not isinstance(node, ast.Call):
                        continue
                    op = self._library_op(node)
                    if op is not None:
                        self._flag(
                            mi, f"devicecheck:kernel-seam:{fi.qual}:{op}",
                            f"{fi.qual} {op}s a native library outside "
                            f"kernels.py: builds there are counted by "
                            f"build_count() and loads memoized by load(); "
                            f"this one is neither", node)

    @staticmethod
    def _library_op(node: ast.Call) -> str | None:
        d = _dotted(node.func) or ""
        if d in ("ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
                 "cdll.LoadLibrary", "CDLL"):
            return "load"
        if d.split(".")[0] == "subprocess" and any(
                isinstance(c, ast.Constant) and isinstance(c.value, str)
                and "nvcc" in c.value for c in ast.walk(node)):
            return "build"
        return None

    # -- pass b: transfer hygiene -----------------------------------------

    def _resolve_root(self, qual: str) -> tuple[ModuleInfo,
                                                FuncInfo] | None:
        modname, _, leaf = qual.rpartition(".")
        while modname:
            mi = self.tree.modules.get(modname)
            if mi is not None:
                rest = qual[len(modname) + 1:].split(".")
                if len(rest) == 2 and rest[0] in mi.classes:
                    fi = mi.classes[rest[0]].methods.get(rest[1])
                elif len(rest) == 1:
                    fi = mi.functions.get(rest[0])
                else:
                    fi = None
                if fi is not None:
                    return mi, fi
                return None
            modname, _, _ = modname.rpartition(".")
        return None

    def _callees(self, mi: ModuleInfo, fi: FuncInfo, locals_,
                 call: ast.Call) -> list[FuncInfo]:
        """The lock graph's call resolution plus calls through an
        imported package module (``kernels.load(...)`` after ``from
        tfidf_tpu_torch import kernels``)."""
        out = self._lg._resolve_call(mi, fi, locals_, call)
        func = call.func
        if not out and isinstance(func, ast.Attribute) and isinstance(
                func.value, ast.Name):
            full = mi.imports.get(func.value.id, "")
            if full.startswith(self.tree.package + "."):
                other = self.tree.modules.get(
                    full[len(self.tree.package) + 1:])
                if other is not None and func.attr in other.functions:
                    out = [other.functions[func.attr]]
        return out

    def cone(self) -> dict[str, tuple[ModuleInfo, FuncInfo]]:
        """The hot serving cone: CONE_ROOTS closed under resolvable
        package calls, stopping at the memoized kernel loader."""
        out: dict[str, tuple[ModuleInfo, FuncInfo]] = {}
        work: list[tuple[ModuleInfo, FuncInfo]] = []
        for qual in self.cone_roots:
            got = self._resolve_root(qual)
            if got is None:
                parts = qual.split(".")
                # a missing root is only a drift finding when its module
                # still exists (mini-trees in tests don't carry the real
                # modules; a deleted module removes its cone legitimately)
                for i in range(len(parts) - 1, 0, -1):
                    mod = self.tree.modules.get(".".join(parts[:i]))
                    if mod is not None:
                        self._flag(
                            mod, f"devicecheck:cone-root-missing:{qual}",
                            f"hot-cone root {qual} no longer resolves — a "
                            f"rename must update devicecheck.CONE_ROOTS, "
                            f"not silently shrink the analyzed cone",
                            mod.tree)
                        break
                continue
            work.append(got)
        seen: set[str] = set()
        while work:
            mi, fi = work.pop()
            if fi.qual in seen:
                continue
            seen.add(fi.qual)
            out[fi.qual] = (mi, fi)
            if fi.qual in CACHE_SEAMS:
                continue
            locals_ = self._lg._local_types(mi, fi)
            for node in _shallow(_body_of(fi)):
                if not isinstance(node, ast.Call):
                    continue
                for target in self._callees(mi, fi, locals_, node):
                    work.append((self.tree.modules[target.module],
                                 target))
        return out

    def check_transfers(self) -> None:
        for qual, (mi, fi) in sorted(self.cone().items()):
            if qual in CACHE_SEAMS:
                continue
            device, device_bool, host = self._typing(mi, fi)
            locals_ = self._lg._local_types(mi, fi)
            in_fetch = (fi.module, qual.rsplit(".", 1)[-1]) in FETCH_STAGE

            def flag(node, op, what):
                if in_fetch and op in _FETCH_OPS:
                    return
                self._flag(
                    mi, f"devicecheck:transfer:{qual}:{op}",
                    f"implicit device sync in the hot serving cone: "
                    f"{qual} {what} — blocks the host until the device "
                    f"catches up (d2h belongs in the fetch stage, "
                    f"ops.topk.fetch_packed)", node)

            for node in _shallow(_body_of(fi)):
                if isinstance(node, ast.Call):
                    self._check_call(mi, fi, locals_, node, flag, device,
                                     device_bool, host)
                elif isinstance(node, (ast.If, ast.While, ast.Assert)) \
                        and device(node.test):
                    flag(node.test, "truthiness",
                         "branches on a tensor (implicit bool sync)")
                elif isinstance(node, ast.BoolOp) and any(
                        device(v) for v in node.values):
                    flag(node, "truthiness",
                         "takes the truth value of a tensor in and/or")
                elif isinstance(node, ast.UnaryOp) and isinstance(
                        node.op, ast.Not) and device(node.operand):
                    flag(node, "truthiness",
                         "negates a tensor with `not`")
                elif isinstance(node, ast.Subscript) and \
                        device_bool(node.slice):
                    flag(node, "mask_index",
                         "indexes with a boolean tensor (the result's "
                         "size is copied back to the host)")

    def _check_call(self, mi, fi, locals_, node, flag, device, device_bool,
                    host) -> None:
        d = _dotted(node.func) or ""
        head, leaf = d.split(".")[0], d.split(".")[-1]
        attr = node.func.attr if isinstance(node.func,
                                            ast.Attribute) else ""
        recv = node.func.value if attr else None
        if d in _SYNC_BUILTINS and node.args and device(node.args[0]):
            flag(node, d, f"calls {d}() on a tensor")
        elif head in ("np", "numpy") and leaf in _NP_FETCHERS and \
                node.args and device(node.args[0]):
            flag(node, "asarray", f"calls {d}() on a tensor")
        elif head == "torch" and leaf in _DATA_SHAPED and \
                d.count(".") == 1:
            flag(node, _DATA_SHAPED[leaf],
                 f"calls {d}() (output shape depends on the data)")
        elif d == "torch.where" and len(node.args) == 1:
            flag(node, "nonzero", "calls torch.where(cond) with one "
                 "argument (output shape depends on the data)")
        elif attr == "synchronize":
            flag(node, "synchronize", f"calls {d or attr}()")
        elif attr in ("item", "tolist") and device(recv):
            flag(node, attr, f"calls .{attr}() on a tensor")
        elif attr == "cpu" and not host(recv):
            flag(node, "cpu", "calls .cpu() on a tensor")
        elif attr == "numpy" and not host(recv) and not (
                isinstance(recv, ast.Call) and (
                    _to_cpu(recv) or isinstance(recv.func, ast.Attribute)
                    and recv.func.attr == "cpu")):
            flag(node, "numpy", "calls .numpy() on a tensor")
        elif _to_cpu(node) and not host(recv):
            flag(node, "to_cpu", "calls .to('cpu') on a tensor")
        elif attr in _DATA_SHAPED and device(recv):
            flag(node, _DATA_SHAPED[attr],
                 f"calls .{attr}() on a tensor (output shape depends on "
                 f"the data)")
        if self._library_op(node):
            flag(node, "build", f"builds or loads a kernel library "
                 f"({d}) outside the memoized kernels.load")
        for target in self._callees(mi, fi, locals_, node):
            if target.qual == f"{KERNEL_MODULE}.build_all":
                flag(node, "build", "calls kernels.build_all")

    # -- pass c: in-place audit -------------------------------------------

    def check_inplace(self) -> None:
        for mi in self.tree.modules.values():
            for fi in _all_funcs(mi):
                locals_ = self._lg._local_types(mi, fi)
                stmts = list(_shallow(_body_of(fi)))
                assigns = [n for n in stmts if isinstance(n, ast.Assign)]
                for node in stmts:
                    if not isinstance(node, ast.Call):
                        continue
                    for target in self._lg._resolve_call(mi, fi, locals_,
                                                         node):
                        if self._inplace_candidate(node, target,
                                                   assigns, mi, fi):
                            break

    def _inplace_candidate(self, node: ast.Call, target: FuncInfo,
                           assigns: list, mi: ModuleInfo,
                           fi: FuncInfo) -> bool:
        tnode = target.node
        if not _mentions_tensor(getattr(tnode, "returns", None)):
            return False
        params = list(tnode.args.args)
        if target.cls is not None and params and params[0].arg in (
                "self", "cls"):
            params = params[1:]
        by_name = {p.arg: p for p in params + list(tnode.args.kwonlyargs)}
        pairs = list(zip(params, node.args)) + [
            (by_name[kw.arg], kw.value) for kw in node.keywords
            if kw.arg in by_name]
        leaf = target.qual.rsplit(".", 1)[-1]
        for param, arg in pairs:
            if not _mentions_tensor(param.annotation):
                continue
            d = _dotted(arg)
            if d is None or d == "self":
                continue
            if self._dead_after(assigns, node, d):
                self._flag(
                    mi, f"devicecheck:inplace:{fi.qual}:{leaf}",
                    f"{fi.qual} passes `{d}` into `{leaf}` (tensor in, "
                    f"tensor out) and rebinds it afterwards — the input is "
                    f"dead after the call; an in-place update or out= "
                    f"would save the allocation (review: unsound if older "
                    f"snapshots alias it)", node)
                return True
        return False

    @staticmethod
    def _dead_after(assigns: list, call: ast.Call, d: str) -> bool:
        for stmt in assigns:
            if stmt.lineno < call.lineno or (
                    stmt.lineno == call.lineno and stmt.value is not call):
                continue
            for t in stmt.targets:
                td = _dotted(t)
                if td is None:
                    continue
                if td == d or d.startswith(td + "."):
                    return True
        return False

    # -- entry ------------------------------------------------------------

    def check(self) -> list[Finding]:
        self.check_cache_discipline()
        self.check_transfers()
        self.check_inplace()
        return self.findings


def explained_transfer_sites(tree: SourceTree,
                             allowlist: dict[str, str] | None = None
                             ) -> set[tuple[str, str]]:
    """(module, function-leaf) pairs where a d2h transfer is statically
    explained: the named fetch stage, the sanctioned bulk stages
    (checkpoint export, the host mirror), plus every transfer finding
    pinned with a reviewed reason in the committed allowlist. The runtime
    device witness fails on any observed transfer OUTSIDE this set — each
    side validating the other (the lockdep contract)."""
    if allowlist is None:
        from tfidf_tpu_torch.tools.graftcheck.core import load_allowlist
        allowlist = load_allowlist()
    dc = _DeviceCheck(tree)
    dc.check_transfers()
    out = set(FETCH_STAGE) | set(BULK_STAGES)
    for f in dc.findings:
        if not f.key.startswith("devicecheck:transfer:") \
                or f.key not in allowlist:
            continue
        parts = f.key.split(":")[2].split(".")
        # qual is "<module>.<Class>.<meth>" or "<module>.<func>" —
        # recover the module by longest-prefix match
        for i in range(len(parts) - 1, 0, -1):
            if ".".join(parts[:i]) in tree.modules:
                out.add((".".join(parts[:i]), parts[-1]))
                break
    return out


def analyze(tree: SourceTree) -> list[Finding]:
    return _DeviceCheck(tree).check()
