"""Dead-symbol sweep: unreferenced module-level functions and methods.

Moving code between modules strands dead code (helpers whose last
caller moved away). This pass walks the resolver's symbol table and
flags every module-level function and every method across
``tfidf_tpu_torch/`` whose NAME is never referenced anywhere else — the
package or its callers outside it (``core.caller_files``: the port's
tests, ``chip_smoke.py`` and the port's probes).

Matching is name-based on purpose: any ``Name`` id, ``Attribute`` attr,
``from m import name`` alias, or string literal equal to the symbol's
name counts as a reference (``getattr`` dynamics and argparse
``func=``-style dispatch stay covered). That over-approximates liveness
— a symbol flagged here really has zero textual references outside its
own definition. Intentional entry points (test hooks, embedding API)
are pinned in ``allowlist.json`` with reasons.
"""

from __future__ import annotations

import ast

from tfidf_tpu_torch.tools.graftcheck.core import (
    Finding, SourceTree, caller_files)

# names the stdlib (or a framework base class) calls for us — never
# referenced by name in this tree, alive by contract
_FRAMEWORK_NAMES = frozenset({
    "do_GET", "do_POST", "log_message", "handle", "setup", "finish",
    "handle_error", "service_actions",
})


def _collect_refs(mod: ast.AST, into: dict[str, int]) -> None:
    for node in ast.walk(mod):
        if isinstance(node, ast.Name):
            into[node.id] = into.get(node.id, 0) + 1
        elif isinstance(node, ast.Attribute):
            into[node.attr] = into.get(node.attr, 0) + 1
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                into[a.name] = into.get(a.name, 0) + 1
        elif isinstance(node, ast.Constant) and isinstance(node.value,
                                                          str):
            v = node.value
            if v.isidentifier():
                into[v] = into.get(v, 0) + 1


def analyze(tree: SourceTree, root: str) -> list[Finding]:
    refs: dict[str, int] = {}
    for mi in tree.modules.values():
        _collect_refs(mi.tree, refs)
    for path in caller_files(root):
        try:
            with open(path, encoding="utf-8") as f:
                _collect_refs(ast.parse(f.read(), filename=path), refs)
        except (OSError, SyntaxError):
            continue

    out: list[Finding] = []
    symbols = []
    for mi in tree.modules.values():
        for fi in mi.functions.values():
            symbols.append((fi, mi))
        for ci in mi.classes.values():
            for fi in ci.methods.values():
                symbols.append((fi, mi))
    for fi, mi in symbols:
        name = fi.node.name
        if name.startswith("__") or name in _FRAMEWORK_NAMES:
            continue
        # a FunctionDef contributes no Name/Attribute for its own name;
        # decorators, recursive calls, and same-named siblings all DO —
        # so zero references means the symbol is textually unreachable
        # (an overridden method shares its name with its siblings and
        # is judged by the shared name once, in every class)
        if refs.get(name, 0) == 0:
            out.append(Finding(
                "deadsymbols", f"deadsymbols:unreferenced:{fi.qual}",
                f"{fi.qual} is referenced nowhere (package, tests, "
                f"bench, tools) — dead code; delete it or allowlist "
                f"the intentional entry point with a reason",
                mi.relpath, fi.node.lineno))
    return out
