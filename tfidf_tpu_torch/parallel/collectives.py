"""The mesh's collectives: ``psum`` over an axis or both, ``all_gather``
over ``docs``.

The JAX package calls ``jax.lax.psum`` / ``all_gather`` inside one
``shard_map`` body; here a step does its per-rank work, hands every
rank's tensor to one of these calls, and goes on with the result. Two
backends, one interface:

* :class:`InProcess` — this process drives every rank. Sums run in rank
  order (``((r0 + r1) + r2) + ...``), so they are deterministic whatever
  the devices; a tensor moves between devices only where two ranks sit
  on different cards.
* :class:`ProcessGroup` — ``torch.distributed`` (gloo on the CPU, NCCL on
  GPUs); each process drives the ranks of its own devices, whole docs
  rows. The ``terms`` sum stays inside the process (as the in-process
  one); a ``docs`` collective gathers every process's rows and sums them
  in docs order, so a process group gives the in-process bits.

``parts`` maps a local rank ``(d, t)`` to its tensor; ``rows`` maps a
local docs row ``d`` to one tensor (its first rank's).
"""

from __future__ import annotations

import torch


def _ordered_sum(xs: list, device) -> torch.Tensor:
    acc = xs[0] if xs[0].device == device else xs[0].to(device)
    for x in xs[1:]:
        acc = acc + x.to(device)
    return acc


class InProcess:
    """Every rank in this process."""

    process_index = 0
    world = 1

    def check(self, mesh) -> None:
        """Nothing to check: every rank is local."""

    def _gather_rows(self, mesh, rows: dict) -> list:
        return [rows[d] for d in range(mesh.D)]

    def _sum_terms(self, mesh, parts: dict) -> dict:
        """``{d: sum over t of parts[(d, t)]}`` on each row's first rank's
        device, in ``t`` order."""
        return {d: _ordered_sum([parts[(d, t)] for t in range(mesh.T)],
                                mesh.devices[d, 0])
                for d in mesh.local_rows}

    def psum(self, mesh, parts: dict, axis, *, rows_only: bool = False):
        """``jax.lax.psum`` of every local rank's tensor over ``axis``
        (``"terms"``, ``"docs"`` or both). Returns each rank's sum, one
        tensor per distinct device; ``rows_only`` returns ``{d: sum}`` on
        each row's first rank only (the ranks of a row hold the same sum
        after a ``terms`` reduction, so later per-row work runs once)."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        if "terms" in axes:
            rows = self._sum_terms(mesh, parts)
        else:
            if mesh.T != 1:
                raise ValueError("a docs-only psum needs terms=1")
            rows = {d: parts[(d, 0)] for d in mesh.local_rows}
        if "docs" in axes:
            total = _ordered_sum(self._gather_rows(mesh, rows), mesh.home)
            rows = {d: total for d in mesh.local_rows}
        if rows_only:
            return {d: (x if x.device == mesh.devices[d, 0]
                        else x.to(mesh.devices[d, 0]))
                    for d, x in rows.items()}
        out = {}
        for d, t in mesh.local:
            dev = mesh.devices[d, t]
            x = rows[d]
            out[(d, t)] = x if x.device == dev else x.to(dev)
        return out

    def all_gather(self, mesh, rows: dict) -> torch.Tensor:
        """``[D, ...]``: every docs row's tensor in docs order, on
        ``mesh.home``."""
        return torch.stack([x.to(mesh.home)
                            for x in self._gather_rows(mesh, rows)])


class ProcessGroup(InProcess):
    """Ranks spread over the processes of a ``torch.distributed`` group;
    this process drives ``local`` (its devices, the same count in every
    process)."""

    def __init__(self, process_index: int, world: int, local: list) -> None:
        self.process_index = process_index
        self.world = world
        self.local = list(local)

    def check(self, mesh) -> None:
        n = len(mesh.local_rows)
        want = list(range(self.process_index * n,
                          (self.process_index + 1) * n))
        if mesh.local_rows != want or n * self.world != mesh.D:
            raise ValueError(f"process {self.process_index}: docs rows "
                             f"{mesh.local_rows}, expected {want}")

    def _gather_rows(self, mesh, rows: dict) -> list:
        import torch.distributed as dist
        mine = torch.stack([rows[d].to(mesh.home)
                            for d in mesh.local_rows])
        got = [torch.empty_like(mine) for _ in range(self.world)]
        dist.all_gather(got, mine.contiguous())
        return [x for part in got for x in part]
