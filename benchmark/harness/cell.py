"""One run of one cell: set-up, the measured window, the metrics, the check
of ``correct``, and the result as the last line of standard output."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from harness import check, registry, trace

# modules that must not be loaded in the process that prints the result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tfidf_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def process_start() -> float:
    """Wall-clock time at which this process started (from ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_run(cell, seed, device, seconds, overrides=None):
    """Set the cell up with the loop its traffic mix names."""
    loop = registry.load_loop(cell.traffic["loop"], cell.root)
    return loop.Run(cell, seed, device, seconds, overrides)


def _full_collections(out: list):
    """A ``gc`` callback that records each full collection's seconds."""
    t = [0.0]

    def cb(phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            out.append(time.perf_counter() - t[0])
    return cb


def per_layer(cell, ctx: dict) -> dict:
    out = {}
    for m in cell.per_layer:
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(argv=None, *, device: str | None = None, overrides=None,
        root: str | None = None, manifest: str | None = None) -> int:
    """Run the cell; ``device`` None requires CUDA cards (a CPU run is
    for the harness's own tests and reports no device numbers)."""
    args = parse(argv)
    t_proc = process_start()
    cell = registry.load(args.workload, root or registry.HERE, manifest)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    on_card = device == "cuda"
    r = make_run(cell, args.seed, device, args.seconds, overrides)
    # set-up ends on a settled heap: a full collection now, not one over
    # the set-up's millions of objects inside the window
    t0 = time.perf_counter()
    gc.collect()
    print(f"set-up's full collection {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    setup_s = time.time() - t_proc
    print(f"setup {setup_s:.1f} s", file=sys.stderr)
    pauses = []
    gc.callbacks.append(_full_collections(pauses))
    with trace.Window(bool(args.trace), on_card) as win:
        r.window(args.seconds, win.span)
        win.close()
    gc.callbacks.pop()
    print(f"full collections in the window: {len(pauses)}, "
          f"{sum(pauses):.2f} s", file=sys.stderr)
    if hasattr(r, "finish"):
        r.finish()
    e2e = r.end_to_end()
    e2e["setup_s"] = setup_s
    attempted, failed = r.counts()
    mem = torch.cuda.max_memory_allocated() if on_card else 0
    reduced = win.reduce()
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(mem)}
    line = {"correct": False, "attempted": attempted, "failed": failed}
    if args.trace:
        ctx = dict(r.context(), trace=reduced, seconds=args.seconds)
        line["metrics"] = per_layer(cell, ctx)
        device_info["busy_s"] = reduced.busy_s
        device_info["window_s"] = reduced.window_s
        line["breakdown"] = {"device_ops": reduced.top_ops(),
                             "idle_gaps": reduced.top_gaps()}
    else:
        line["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
    line["device"] = device_info
    if hasattr(r, "lateness_ms"):
        line["generator_late_ms"] = r.lateness_ms()
    # the reference runs once the program's state is freed
    r.release()
    del reduced, win
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = check.Verdict(cell.workload["limits"])
    t0 = time.perf_counter()
    r.check(verdict)
    print(f"reference check {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line["correct"] = verdict.correct
    line["compared"] = verdict.table()
    verdict.print_last()
    print(json.dumps(line), flush=True)
    return 0
