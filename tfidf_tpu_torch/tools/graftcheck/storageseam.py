"""Storage-seam coverage: every durable write goes through the seam.

The crash-consistency discipline is concentrated — temp file + CRC
manifest + fsync file + fsync dir + atomic rename — in one module,
``tfidf_tpu_torch/utils/storage.py``. The discipline only holds if it cannot
be bypassed: a new feature that writes durable state with a raw
``open(..., "w")``/``np.savez``/``os.replace`` reintroduces exactly the
torn-write and silent-bit-rot windows the seam exists to close, and the
disk nemesis cannot inject faults into a path it never sees.

This pass flags, anywhere in the package — ``utils/storage.py``
INCLUDED — :

- ``open(...)`` with a write/append/update mode literal,
- ``np.savez`` / ``np.savez_compressed`` (direct or via a handle),
- ``os.replace`` / ``os.rename``,
- ``np.memmap``: a raw mapping of durable state bypasses
  the read seam — the disk nemesis cannot flip its bytes and no
  manifest gate fronts it. The seam's ``read_memmap`` (which checks
  the injector and honors armed BITROT rules) is the pinned exception.

Reviewed exceptions are pinned in the shared allowlist with a
justification (the WAL's append-handle discipline — the WAL *is* the
seam for its own CRC-framed log; the native-build ``.so`` cache; the
CLI's operator-requested trace export). Anything new fails the build
until it is either migrated onto the seam or reviewed into the
allowlist — the same contract as every other graftcheck pass.

The seam module itself used to be blanket-skipped, which hid its own
primitives AND any new durable-write class that happened to live there
(the capture log was the near-miss) behind incidental
non-detection. It is now scanned like everything else: the seam's
atomic-write/rename primitives and the ``RequestLog`` capture-log
append handle are each pinned in the allowlist with their reviewed
discipline spelled out — runtime artifacts (trace exports, capture
logs) are EXPLICIT exceptions, never silent ones.
"""

from __future__ import annotations

import ast

from tfidf_tpu_torch.tools.graftcheck.core import Finding, SourceTree, _dotted

SEAM_MODULE = "utils.storage"

_RENAME_CALLS = {"os.replace", "os.rename"}
_SAVEZ_LEAVES = {"savez", "savez_compressed"}


def _write_mode(node: ast.Call) -> str | None:
    """The mode literal of an ``open()`` call if it writes, else None.
    Only literal modes are judged — a computed mode is unresolvable and
    this pass under-approximates rather than guesses."""
    if not (isinstance(node.func, ast.Name) and node.func.id == "open"):
        return None
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        if any(c in mode.value for c in "wa+x"):
            return mode.value
    return None


def _qual_of(chain: list[str]) -> str:
    return ".".join(chain) if chain else "<module>"


def analyze(tree: SourceTree, root: str = ".") -> list[Finding]:
    out: list[Finding] = []
    seen: set[str] = set()
    found_any = False
    for mi in tree.modules.values():
        if mi.name == SEAM_MODULE:
            found_any = True   # the seam exists; extraction is alive
        # enclosing def-chain names for stable keys (no line numbers)
        chains: dict[int, list[str]] = {}

        def index(node: ast.AST, chain: list[str]) -> None:
            name = getattr(node, "name", None)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and name:
                chain = chain + [name]
            for child in ast.iter_child_nodes(node):
                chains[id(child)] = chain
                index(child, chain)

        index(mi.tree, [])
        for node in ast.walk(mi.tree):
            if not isinstance(node, ast.Call):
                continue
            op = None
            dotted = _dotted(node.func) or ""
            leaf = dotted.split(".")[-1]
            mode = _write_mode(node)
            if mode is not None:
                op = f"open:{mode}"
            elif dotted in _RENAME_CALLS:
                op = leaf
            elif leaf in _SAVEZ_LEAVES and dotted.split(".")[0] in (
                    "np", "numpy"):
                op = leaf
            elif leaf == "memmap" and dotted.split(".")[0] in (
                    "np", "numpy"):
                op = leaf
            if op is None:
                continue
            qual = _qual_of(chains.get(id(node), []))
            key = f"storageseam:raw-io:{mi.name}.{qual}:{op}"
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "storageseam", key,
                f"raw durable-path IO ({op}) in {mi.name}.{qual} "
                f"bypasses the storage seam (utils/storage.py): the "
                f"disk nemesis cannot fault-inject it and the "
                f"crash-consistency discipline does not cover it — "
                f"migrate onto the seam or pin with a reviewed "
                f"allowlist justification",
                mi.relpath, node.lineno))
    if not found_any:
        out.append(Finding(
            "storageseam", "storageseam:extraction-empty",
            "utils/storage.py not found — the storage-seam pass went "
            "stale", "tfidf_tpu_torch/utils/storage.py", 1))
    return out
