"""Command-line entry point:
``python -m tfidf_tpu_torch.tools.graftcheck [options] [analyzer...]``.

Exit status 0 when every finding is pinned (allowlist/baseline), 1 when
any NEW finding exists — the CI contract: the committed pins hold the
reviewed state, and anything the analyzers newly surface fails the run.

Options:
    --only A[,B...]    analyzer subset (same as the positional list;
                       e.g. ``--only protocol`` for fast iteration on
                       the wire-contract passes)
    --json             machine-readable report on stdout
    --graph            also print the computed lock-order edges
    --write-baseline   rewrite baseline.json with the current findings
                       (minus allowlisted ones) — for intentional,
                       reviewed re-pins only
    --root DIR         repo root (default: cwd)
    --witness W        instead of the static passes, run pytest over the
                       suite list of the lockdep, protocol or device
                       witness (``pytest_witness``) under that witness
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from tfidf_tpu_torch.tools.graftcheck.core import (
    BASELINE_PATH, load_allowlist, load_baseline, run_analyzers, triage)

ANALYZERS = ("lockgraph", "jitpurity", "devicecheck", "registry_drift",
             "resilience", "wallclock", "protocol", "deadsymbols",
             "storageseam")


def run_witness(name: str, root: str) -> int:
    """pytest over ``name``'s suite list with the plugin and its variable
    set, in one process (no xdist); the exit status is pytest's."""
    from tfidf_tpu_torch.tools.graftcheck import pytest_witness as pw
    suites = {"lockdep": pw.LOCKDEP_SUITES, "protocol": pw.PROTOCOL_SUITES,
              "device": pw.DEVICE_SUITES}[name]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env[pw.ENV[name]] = "1"
    cmd = [sys.executable, "-m", "pytest", *suites, "-q", "-m", "not slow",
           "-p", "no:cacheprovider", "-p", "no:xdist",
           "-p", "tfidf_tpu_torch.tools.graftcheck.pytest_witness"]
    return subprocess.run(cmd, cwd=root, env=env).returncode


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="graftcheck")
    ap.add_argument("analyzers", nargs="*", choices=[*ANALYZERS, []],
                    help="subset to run (default: all)")
    ap.add_argument("--only", default="",
                    help="comma-separated analyzer subset (alias of "
                         "the positional list, e.g. --only protocol)")
    ap.add_argument("--root", default=".")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--graph", action="store_true")
    ap.add_argument("--write-baseline", action="store_true")
    ap.add_argument("--witness", choices=("lockdep", "protocol", "device"))
    args = ap.parse_args(argv)
    if args.witness:
        return run_witness(args.witness, args.root)

    only = [a for a in args.only.split(",") if a]
    bad = sorted(set(only) - set(ANALYZERS))
    if bad:
        ap.error(f"unknown analyzer(s) in --only: {bad} "
                 f"(choose from {', '.join(ANALYZERS)})")
    which = (list(args.analyzers) + only) or None
    findings = run_analyzers(args.root, which)
    allowlist = load_allowlist()
    baseline = load_baseline()
    new, pinned, stale = triage(findings, allowlist, baseline)

    if args.write_baseline:
        if which is not None:
            # a subset's findings are not the whole tree's: rewriting
            # the shared baseline from them would silently drop every
            # other analyzer's pins
            ap.error("--write-baseline requires the full analyzer set "
                     "(drop the subset/--only selection)")
        keys = sorted({f.key for f in findings} - set(allowlist))
        with open(BASELINE_PATH, "w", encoding="utf-8") as f:
            json.dump(keys, f, indent=1)
            f.write("\n")
        print(f"baseline rewritten: {len(keys)} pinned finding(s)")
        return 0

    if args.json:
        print(json.dumps({
            "new": [f.__dict__ for f in new],
            "baselined": [f.__dict__ for f in pinned],
            "stale_baseline": stale,
        }, indent=1))
        return 1 if new else 0

    if args.graph:
        from tfidf_tpu_torch.tools.graftcheck.core import SourceTree
        from tfidf_tpu_torch.tools.graftcheck.lockgraph import build
        g = build(SourceTree(args.root))
        for outer, inner in sorted(g.edge_set()):
            print(f"  {outer} -> {inner}")
        print(f"{len(g.edge_set())} lock-order edge(s), "
              f"{len(g.tree.lock_sites)} lock creation site(s)")

    for f in new:
        print("NEW " + f.render())
    if pinned:
        print(f"{len(pinned)} baselined finding(s) "
              f"(baseline.json pins them; fix and "
              f"re-run --write-baseline to shrink the pin set)")
    for k in stale:
        print(f"note: baseline entry no longer found (stale pin): {k}")
    ok = not new
    which_s = ",".join(which) if which else "all"
    print(f"graftcheck[{which_s}]: {len(findings)} finding(s) — "
          f"{len(new)} new, {len(pinned)} baselined, "
          f"{len(findings) - len(new) - len(pinned)} allowlisted"
          + ("" if ok else "  => FAIL"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
