"""The device mesh: a ``docs x terms`` grid of ranks, each on a torch
device.

The counterpart of ``tfidf_tpu/parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` over TPU devices and every step is one ``shard_map``
program; here a :class:`Mesh` names, for every rank ``(d, t)``, the torch
device its slices live on and the process that drives it, and every step
is plain per-rank tensor work staged around the collectives of
:mod:`tfidf_tpu_torch.parallel.collectives`:

* ``docs`` — data parallelism over the corpus: each docs row owns a
  disjoint set of documents. Collectives over it: the sum of document
  frequencies (global IDF) and the ``all_gather`` of per-row top-k.
* ``terms`` — one document's entries are split across the row's ranks
  and their partial scores summed.

A device may be named more than once: those ranks share the card (the
counterpart of the JAX tests' virtual CPU devices), and their collectives
are real reductions in a fixed rank order. Under
:func:`initialize_multihost` the mesh spans processes through
``torch.distributed``: each process drives the ranks of its own devices,
and a docs row never crosses a process (the ``terms`` sum stays inside
one process, the ``docs`` collectives cross them).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from tfidf_tpu_torch.device import resolve_device
from tfidf_tpu_torch.parallel.collectives import InProcess, ProcessGroup
from tfidf_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.mesh")

# the process group of initialize_multihost, once it ran
_group: ProcessGroup | None = None


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         *, device=None,
                         local_devices: list | None = None) -> bool:
    """Join this process to a multi-process mesh over
    ``torch.distributed``: NCCL when the process's devices are CUDA
    devices, gloo on the CPU.

    Arguments left out are read from ``MASTER_ADDR`` / ``MASTER_PORT``
    (the coordinator), ``WORLD_SIZE`` and ``RANK``. ``local_devices``
    names the devices this process drives (every process names as many);
    the default is ``device`` once (``"cpu"`` for gloo, ``cuda:N``), or
    every visible CUDA device when ``device`` is None or ``cuda``. After this returns, :func:`make_mesh`
    builds a mesh over every process's devices.

    Idempotent: returns True only when this call performed the
    initialization."""
    global _group
    if _group is not None:
        return False
    import torch.distributed as dist
    if coordinator_address is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT")
        if not (addr and port):
            raise ValueError("initialize_multihost: no coordinator address "
                             "(pass one, or set MASTER_ADDR/MASTER_PORT)")
        coordinator_address = f"{addr}:{port}"
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if local_devices is None:
        dev = resolve_device(device)    # raises without CUDA
        local_devices = ([dev] if dev.type != "cuda" or dev.index is not None
                         else [torch.device("cuda", i) for i in
                               range(torch.cuda.device_count())])
    local_devices = [resolve_device(d) for d in local_devices]
    kinds = {d.type for d in local_devices}
    if len(kinds) != 1:
        raise ValueError(f"initialize_multihost: mixed device types "
                         f"{sorted(kinds)}")
    backend = "nccl" if kinds == {"cuda"} else "gloo"
    home = local_devices[0]
    if backend == "nccl":
        torch.cuda.set_device(home)
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    # every process must drive as many ranks (rows split evenly)
    n = torch.tensor([len(local_devices)], dtype=torch.int64, device=home)
    got = [torch.zeros_like(n) for _ in range(num_processes)]
    dist.all_gather(got, n)
    counts = sorted({int(x) for x in got})
    if counts != [len(local_devices)]:
        dist.destroy_process_group()
        raise ValueError(f"initialize_multihost: processes drive "
                         f"different device counts {counts}")
    _group = ProcessGroup(process_id, num_processes, local_devices)
    log.info("torch.distributed initialized", backend=backend,
             process=process_id, processes=num_processes,
             devices=len(local_devices))
    return True


def shutdown_multihost() -> None:
    """Leave the process group of :func:`initialize_multihost` (a no-op
    when none was joined); meshes built later are in-process again."""
    global _group
    if _group is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
        _group = None


def default_mesh_shape(n_devices: int | None = None) -> tuple[int, int]:
    """(docs, terms) shape: favor the docs axis, keep terms a small power
    of 2 (the rule of the JAX package). Scoring traffic per query over
    ``terms`` is a [B, doc_cap] sum, while docs rows are independent, so
    docs-major is the default."""
    n = n_devices if n_devices is not None else len(_default_devices())
    terms = 1
    while n % 2 == 0 and n // 2 >= 4 and terms < 2:
        n //= 2
        terms *= 2
    return (n, terms)


def _default_devices() -> list:
    """Every device of the mesh when none are named: under
    :func:`initialize_multihost`, every process's devices; else every
    visible CUDA device (raises without CUDA)."""
    if _group is not None:
        return [d for _ in range(_group.world) for d in _group.local]
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A ``docs x terms`` grid of ranks.

    ``devices[d, t]`` is rank ``(d, t)``'s torch device (None for a rank
    another process drives), ``owners[d, t]`` its process. ``shape`` is
    ``{"docs": D, "terms": T}`` as on a JAX mesh. ``home`` is the device
    where this process's gathered results land (its first rank's)."""

    def __init__(self, devices: np.ndarray, owners: np.ndarray, comm,
                 axis_names: tuple[str, str] = ("docs", "terms")) -> None:
        self.devices = devices
        self.owners = owners
        self.comm = comm
        self.axis_names = tuple(axis_names)
        D, T = devices.shape
        self.D, self.T = D, T
        mine = owners == comm.process_index
        for d in range(D):
            if mine[d].any() and not mine[d].all():
                raise ValueError(f"docs row {d} spans processes: the terms "
                                 "axis must stay inside one process")
        self.local_rows = [d for d in range(D) if mine[d, 0]]
        if not self.local_rows:
            raise ValueError("mesh: this process drives no rank")
        self.local = [(d, t) for d in self.local_rows for t in range(T)]
        self.home = devices[self.local_rows[0], 0]
        comm.check(self)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.D, self.axis_names[1]: self.T}

    @property
    def size(self) -> int:
        return self.D * self.T

    def local_devices(self) -> list:
        """The distinct devices of this process's ranks, in rank order."""
        out = []
        for d, t in self.local:
            if self.devices[d, t] not in out:
                out.append(self.devices[d, t])
        return out

    def axis_index(self, rank: tuple[int, int], axis: str) -> int:
        """A rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
        return rank[self.axis_names.index(axis)]

    def put_rows(self, arr: np.ndarray) -> list:
        """A host ``[D, ...]`` array as one tensor per local rank (index
        ``d * T + t``; None elsewhere): row ``d`` on each of the row's
        devices, replicated over ``terms`` (``P("docs", None)``), one
        tensor per distinct device."""
        out = [None] * self.size
        for d in self.local_rows:
            per_dev = {}
            for t in range(self.T):
                dev = self.devices[d, t]
                if dev not in per_dev:
                    per_dev[dev] = _to(arr[d], dev)
                out[d * self.T + t] = per_dev[dev]
        return out

    def put_blocks(self, arr: np.ndarray) -> list:
        """A host ``[D, T, ...]`` array as one tensor per local rank
        (``P("docs", "terms", ...)``)."""
        out = [None] * self.size
        for d, t in self.local:
            out[d * self.T + t] = _to(arr[d, t], self.devices[d, t])
        return out

    def replicate(self, x: torch.Tensor) -> dict:
        """``x`` on every distinct local device (``P()``): device ->
        tensor; ``x`` itself where it already lives."""
        return {dev: x if x.device == dev else x.to(dev)
                for dev in self.local_devices()}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, home={self.home}, "
                f"processes={self.comm.world})")


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def make_mesh(shape: tuple[int, int] | None = None,
              axis_names: tuple[str, str] = ("docs", "terms"),
              devices: list | None = None) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major: rank ``(d, t)``
    takes ``devices[d * T + t]``). A device may repeat: those ranks share
    it. Default: every visible CUDA device, or under
    :func:`initialize_multihost` every process's.

    Under :func:`initialize_multihost`, ``devices`` names this process's
    own devices, and every process's list, in process order, makes the
    mesh's."""
    if _group is not None:
        local = (list(devices) if devices is not None else _group.local)
        devs = [d for _ in range(_group.world) for d in local]
        owners = [p for p in range(_group.world) for _ in local]
        comm = _group
    else:
        devs = (list(devices) if devices is not None
                else _default_devices())
        owners = [0] * len(devs)
        comm = InProcess()
    if shape is None or not shape:
        shape = (len(devs), 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != 2 or math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    arr = np.empty(len(devs), object)
    for i, (d, p) in enumerate(zip(devs, owners)):
        arr[i] = resolve_device(d) if p == comm.process_index else None
    return Mesh(arr.reshape(shape), np.asarray(owners).reshape(shape), comm,
                axis_names)


def engine_mesh(mesh_shape, device=None) -> Mesh:
    """The mesh an engine builds when none is given: ``mesh_shape`` (the
    config's; ``()`` = every device on the docs axis) over the visible
    CUDA devices when ``device`` is None or ``cuda`` without an index (as
    the JAX engine builds over ``jax.devices()``), else over ``device``
    named once per rank (``()`` = one rank)."""
    shape = tuple(mesh_shape) if mesh_shape else None
    if _group is not None:
        return make_mesh(shape)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(shape)
    return make_mesh(shape, devices=[dev] * (math.prod(shape)
                                             if shape else 1))
