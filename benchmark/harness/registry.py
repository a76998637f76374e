"""Everything a cell needs, found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix. The
files are ``configs/<config>.json`` (the deployment's sizes, guarantees
and cuts), ``traffic/<mix>.json`` (the mix's parameters, and the
``loop`` that runs it), ``workloads/<cell>.json`` (the cell's own
settings: a fixed rate, the size of the check, the limits of ``correct``)
and ``metrics/<metric>.py`` (one per-layer metric's reader). A new cell,
mix, configuration or metric is a new file and an entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    root: str             # the folder the cell's files were found in
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list      # BENCHMARK.json metric entries of this cell
    per_layer: list
    readers: dict         # per-layer metric name -> module with read(ctx)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _module(kind: str, name: str, root: str):
    path = os.path.join(root, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, root: str = HERE):
    mod = _module("metrics", name, root)
    if not callable(getattr(mod, "read", None)):
        raise TypeError(f"{name}: metrics/{name}.py has no read(ctx)")
    return mod


def load_loop(name: str, root: str = HERE):
    """The module ``loops/<name>.py``: its ``Run(cell, seed, device,
    seconds, overrides)`` sets a cell up and drives its window."""
    mod = _module("loops", name, root)
    if not isinstance(getattr(mod, "Run", None), type):
        raise TypeError(f"{name}: loops/{name}.py has no class Run")
    return mod


def load(cell: str, root: str = HERE, manifest: str | None = None) -> Cell:
    bench = _json(manifest or os.path.join(os.path.dirname(root),
                                           "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    layer = [m for m in bench["per_layer"] if applies(m, cell)]
    return Cell(
        name=cell, root=root, chips=int(entry["chips"]),
        config=_json(os.path.join(root, "configs",
                                  f"{entry['config']}.json")),
        traffic=_json(os.path.join(root, "traffic",
                                   f"{entry['traffic']}.json")),
        workload=_json(os.path.join(root, "workloads", f"{cell}.json")),
        end_to_end=e2e, per_layer=layer,
        readers={m["name"]: load_reader(m["name"], root) for m in layer})
