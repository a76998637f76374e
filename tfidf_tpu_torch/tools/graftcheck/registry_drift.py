"""Registry-drift enforcement: the single pass that keeps every
declared surface honest against the source.

Three sub-checks (generalizing a one-off anti-stale test):

1. **fault points** — every ``fault_point("…")`` /
   ``global_injector.check("…")`` call site must be covered by
   ``KNOWN_FAULT_POINTS`` (f-string sites by their static prefix +
   ``*``), AND every registry entry must match at least one call site
   (a removed point must leave the registry too).
2. **config** — every ``Config`` dataclass field must be mentioned in
   the README (the operator-facing contract), and ``load_config`` must
   still carry the generic ``TFIDF_<UPPER>`` env-override loop so every
   field stays overridable without per-field plumbing.
3. **metrics** — every metric name the code READS
   (``global_metrics.get("…")``, the CLI's snapshot lookups) must be
   EMITTED somewhere (``inc``/``observe``/``set_gauge``; f-string
   emissions match by pattern; ``observe`` names also cover their
   snapshot-derived ``_count``/``_mean_ms``/``_p50_ms``/… suffixes).
4. **fault-trace coupling** — ``FaultInjector.check`` must emit a
   trace span event on every FIRE (``span_event("fault_injected", …)``
   in utils/faults.py): because every ``fault_point()``/``check()``
   site routes through that one method, fault injection is visible in
   traces by construction — and this check fails if the emission is
   ever refactored away.

Everything is read via AST — ``KNOWN_FAULT_POINTS`` and the Config
fields are parsed out of their literals, never imported.
"""

from __future__ import annotations

import ast
import os
import re

from tfidf_tpu_torch.tools.graftcheck.core import Finding, SourceTree, _dotted

_TIMING_SUFFIXES = ("_count", "_mean_ms", "_min_ms", "_max_ms", "_sum_ms",
                    "_p50_ms", "_p95_ms", "_p99_ms")


# ---------------------------------------------------------------------------
# shared literal / f-string extraction
# ---------------------------------------------------------------------------

def _str_or_prefix(node: ast.expr) -> tuple[str, bool] | None:
    """(text, is_prefix) for a string literal or an f-string whose
    leading part is literal; None otherwise."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value, False
    if isinstance(node, ast.JoinedStr):
        if node.values and isinstance(node.values[0], ast.Constant) \
                and isinstance(node.values[0].value, str):
            return node.values[0].value, True
        return "", True
    return None


# ---------------------------------------------------------------------------
# 1. fault points
# ---------------------------------------------------------------------------

def _known_fault_points(tree: SourceTree) -> dict[str, int]:
    """Parse KNOWN_FAULT_POINTS keys (and the dict's line) from
    utils/faults.py without importing it."""
    mi = tree.modules["utils.faults"]
    for node in mi.tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "KNOWN_FAULT_POINTS" \
                    and isinstance(node.value, ast.Dict):
                return {k.value: k.lineno for k in node.value.keys
                        if isinstance(k, ast.Constant)}
    return {}


def _fault_sites(tree: SourceTree) -> dict[str, tuple[str, int]]:
    """point (literal, or prefix + '*') -> one (file, line) site."""
    out: dict[str, tuple[str, int]] = {}
    for mi in tree.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            d = _dotted(node.func) or ""
            leaf = d.split(".")[-1]
            # `_observe` is CircuitBreaker's swallow-the-raise forwarder
            # to global_injector.check — its literal-arg call sites are
            # fault points too (the old grep-based test missed them).
            # `device_guard` is the compute-plane injector's dispatch
            # seam (utils/device_nemesis.py): its sites register under
            # the `device.` namespace — one registry covers both
            # injectors, so chaos configs validate device rules too.
            if not (leaf in ("fault_point", "_observe", "device_guard")
                    or (leaf == "check"
                        and "injector" in d.split(".")[0])):
                continue
            got = _str_or_prefix(node.args[0])
            if got is None:
                continue
            text, is_prefix = got
            point = text.split("{")[0] + "*" if is_prefix else text
            if leaf == "device_guard":
                point = "device." + point
            out.setdefault(point, (mi.relpath, node.lineno))
    return out


def _covered(point: str, registry: dict[str, int]) -> bool:
    if point in registry:
        return True
    return any(k.endswith("*") and point.rstrip("*").startswith(k[:-1])
               for k in registry)


def check_fault_points(tree: SourceTree) -> list[Finding]:
    registry = _known_fault_points(tree)
    sites = _fault_sites(tree)
    out: list[Finding] = []
    if not registry or not sites:
        out.append(Finding(
            "registry_drift", "registry_drift:faults:extraction-empty",
            "fault-point extraction found nothing — the pass went stale",
            "tfidf_tpu_torch/utils/faults.py", 1))
        return out
    for point, (f, ln) in sorted(sites.items()):
        if not _covered(point, registry):
            out.append(Finding(
                "registry_drift",
                f"registry_drift:faults:unregistered:{point}",
                f"fault point {point!r} is not in KNOWN_FAULT_POINTS "
                f"(chaos configs validate against the registry)", f, ln))
    for point, ln in sorted(registry.items()):
        key = point.rstrip("*")
        hit = any(site == point
                  or (point.endswith("*")
                      and site.rstrip("*").startswith(key))
                  for site in sites)
        if not hit:
            out.append(Finding(
                "registry_drift",
                f"registry_drift:faults:stale:{point}",
                f"KNOWN_FAULT_POINTS entry {point!r} matches no "
                f"fault_point()/check() call site — stale registry entry",
                "tfidf_tpu_torch/utils/faults.py", ln))
    return out


# ---------------------------------------------------------------------------
# 2. config fields
# ---------------------------------------------------------------------------

def _config_fields(tree: SourceTree) -> dict[str, int]:
    ci = tree.modules["utils.config"].classes.get("Config")
    if ci is None:
        return {}
    return {n.target.id: n.lineno for n in ci.node.body
            if isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)}


def check_config(tree: SourceTree, root: str) -> list[Finding]:
    out: list[Finding] = []
    fields = _config_fields(tree)
    if not fields:
        out.append(Finding(
            "registry_drift", "registry_drift:config:extraction-empty",
            "no Config fields found — the pass went stale",
            "tfidf_tpu_torch/utils/config.py", 1))
        return out
    readme_path = os.path.join(root, "README.md")
    readme = ""
    if os.path.exists(readme_path):
        with open(readme_path, encoding="utf-8") as f:
            readme = f.read()
    for name, ln in sorted(fields.items()):
        if not re.search(rf"\b{re.escape(name)}\b", readme):
            out.append(Finding(
                "registry_drift",
                f"registry_drift:config:readme-missing:{name}",
                f"Config field {name!r} has no README mention (every "
                f"field is operator-facing via TFIDF_{name.upper()})",
                "tfidf_tpu_torch/utils/config.py", ln))
    # the generic env-override loop must survive refactors: without it,
    # fields silently stop being TFIDF_* overridable
    cfg_src = tree.modules["utils.config"].source
    if "_ENV_PREFIX + f_.name.upper()" not in cfg_src:
        out.append(Finding(
            "registry_drift", "registry_drift:config:env-loop-missing",
            "load_config no longer derives TFIDF_* overrides "
            "generically from dataclasses.fields(Config) — per-field "
            "env plumbing drifts; restore the generic loop",
            "tfidf_tpu_torch/utils/config.py", 1))
    return out


# ---------------------------------------------------------------------------
# 3. metrics
# ---------------------------------------------------------------------------

_EMIT_METHODS = {"inc", "observe", "set_gauge"}


def _metric_emissions(tree: SourceTree
                      ) -> tuple[set[str], list[str], set[str]]:
    """(literal names, prefix patterns from f-strings, observe names)."""
    literals: set[str] = set()
    prefixes: list[str] = []
    observed: set[str] = set()
    for mi in tree.modules.values():
        # local aliases: g = global_metrics.set_gauge; g("name", …)
        aliases: set[str] = set()
        for node in ast.walk(mi.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Attribute) \
                    and node.value.attr in _EMIT_METHODS:
                d = _dotted(node.value.value) or ""
                if "metrics" in d:
                    aliases.update(t.id for t in node.targets
                                   if isinstance(t, ast.Name))
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            is_emit = False
            method = ""
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _EMIT_METHODS:
                d = _dotted(node.func.value) or ""
                if "metrics" in d or d == "self":
                    is_emit = True
                    method = node.func.attr
            elif isinstance(node.func, ast.Name) \
                    and node.func.id in aliases:
                is_emit = True
            if not is_emit:
                continue
            got = _str_or_prefix(node.args[0])
            if got is None:
                continue
            text, is_prefix = got
            if is_prefix:
                prefixes.append(text)
            else:
                literals.add(text)
                if method == "observe":
                    observed.add(text)
    return literals, prefixes, observed


def _metric_reads(tree: SourceTree) -> dict[str, tuple[str, int]]:
    out: dict[str, tuple[str, int]] = {}
    for mi in tree.modules.values():
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"):
                continue
            d = _dotted(node.func.value) or ""
            # global_metrics.get(...) anywhere; `metrics.get(...)` on
            # the CLI's fetched /api/metrics snapshot
            if not (d == "global_metrics"
                    or (d == "metrics" and mi.name == "cli")):
                continue
            got = _str_or_prefix(node.args[0])
            if got is None or got[1]:
                continue
            out.setdefault(got[0], (mi.relpath, node.lineno))
    return out


def check_metrics(tree: SourceTree) -> list[Finding]:
    literals, prefixes, observed = _metric_emissions(tree)
    reads = _metric_reads(tree)
    out: list[Finding] = []
    if not literals:
        out.append(Finding(
            "registry_drift", "registry_drift:metrics:extraction-empty",
            "metric-emission extraction found nothing — pass went stale",
            "tfidf_tpu_torch/utils/metrics.py", 1))
        return out

    def emitted(name: str) -> bool:
        if name in literals:
            return True
        # snapshot-derived timing keys come from observe() names; an
        # f-string emission covers anything sharing its literal prefix
        for suf in _TIMING_SUFFIXES:
            if name.endswith(suf) and name[: -len(suf)] in (
                    literals | observed):
                return True
        return any(p and name.startswith(p) for p in prefixes)

    for name, (f, ln) in sorted(reads.items()):
        if not emitted(name):
            out.append(Finding(
                "registry_drift",
                f"registry_drift:metrics:never-emitted:{name}",
                f"metric {name!r} is read but never emitted by any "
                f"inc/observe/set_gauge in the tree", f, ln))
    return out


# ---------------------------------------------------------------------------
# 4. fault-point -> trace-event coupling
# ---------------------------------------------------------------------------

def check_fault_trace(tree: SourceTree) -> list[Finding]:
    """Every fault FIRE must land a span event. All fault_point()/
    check() call sites route through ``FaultInjector.check`` (the
    fault-points sub-check above keeps that registry honest), so one
    structural guarantee suffices: the check method's fire path must
    call ``span_event("fault_injected", …)``. A chaos run's trace then
    shows exactly where each injected failure entered the request —
    by construction, for every present and future fault point."""
    mi = tree.modules["utils.faults"]
    fn = next(
        (n for cls in ast.walk(mi.tree)
         if isinstance(cls, ast.ClassDef) and cls.name == "FaultInjector"
         for n in cls.body
         if isinstance(n, ast.FunctionDef) and n.name == "check"), None)
    if fn is None:
        return [Finding(
            "registry_drift", "registry_drift:faults:no-check-method",
            "FaultInjector.check not found — the fault-trace pass went "
            "stale", "tfidf_tpu_torch/utils/faults.py", 1)]
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call) and node.args
                and (_dotted(node.func) or "").split(".")[-1]
                == "span_event"
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "fault_injected"):
            return []
    return [Finding(
        "registry_drift", "registry_drift:faults:fire-not-traced",
        "FaultInjector.check no longer emits the 'fault_injected' span "
        "event on fire — fault injection must stay visible in traces "
        "by construction (every fault_point() site routes through "
        "this method)", mi.relpath, fn.lineno)]


def analyze(tree: SourceTree, root: str) -> list[Finding]:
    return (check_fault_points(tree) + check_config(tree, root)
            + check_metrics(tree) + check_fault_trace(tree))
