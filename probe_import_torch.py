"""How long a fresh process takes to import torch, with and without a
shared bytecode cache.

A ``python -m tfidf_tpu_torch`` node spends most of its boot in
``import torch`` (the ``boot split`` line of ``tfidf_tpu_torch/boot.py``).
This probe starts fresh interpreters that only import torch: ``--runs``
with the environment as given, then ``--runs`` + 1 with
``PYTHONPYCACHEPREFIX`` at a new directory under ``--out`` and bytecode
writing on (the first writes the cache, the rest read it), then one
``-X importtime`` run over the warm cache, whose slowest modules it
prints. One JSON line on stdout; the cache is removed at the end.

    python3 probe_import_torch.py [--runs 2] [--out build/probe_import]
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

TIMED = ("import sys, time; t = time.perf_counter(); import torch; "
         "print(time.perf_counter() - t, sys.flags.dont_write_bytecode)")


def timed_import(env: dict) -> dict:
    out = subprocess.run([sys.executable, "-c", TIMED], env=env,
                         capture_output=True, text=True, check=True)
    secs, dont_write = out.stdout.split()
    return {"s": float(secs), "dont_write_bytecode": int(dont_write)}


def slowest_modules(env: dict, n: int = 8) -> list:
    """The ``n`` modules with the most import time of their own."""
    err = subprocess.run([sys.executable, "-X", "importtime", "-c",
                          "import torch"], env=env, capture_output=True,
                         text=True, check=True).stderr
    rows = []
    for line in err.splitlines():
        parts = line.split("|")
        if len(parts) == 3 and parts[0].split(":")[-1].strip().isdigit():
            rows.append((int(parts[0].split(":")[-1]), parts[2].strip()))
    return [{"module": m, "self_s": us / 1e6}
            for us, m in sorted(rows, reverse=True)[:n]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("build", "probe_import"))
    args = ap.parse_args()
    cache = os.path.abspath(os.path.join(args.out, "pycache"))
    shutil.rmtree(cache, ignore_errors=True)
    as_given = dict(os.environ)
    cached = dict(as_given, PYTHONPYCACHEPREFIX=cache)
    cached.pop("PYTHONDONTWRITEBYTECODE", None)
    try:
        res = {"as_given": [timed_import(as_given)
                            for _ in range(args.runs)],
               "cache_write": timed_import(cached),
               "cache_read": [timed_import(cached)
                              for _ in range(args.runs)],
               "slowest_with_cache": slowest_modules(cached)}
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
