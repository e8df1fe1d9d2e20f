"""Client groups: one client per process, the exchange over ``torch.distributed``.

Counterpart of ``repro.launch.mesh``.  The reference lays its clients on
the "data" axis of a device mesh (``Mesh(devices.reshape(-1, 1), ("data",
"model"))``) and crosses them with ``all_gather`` and ``pmean`` inside
``shard_map``.  The port runs one client per process: the rank is the
client index, and a :class:`ClientGroup` carries the two collectives the
exchange needs.

  * :func:`make_host_group` is world 1 with no process group, the
    counterpart of ``make_host_mesh``: its collectives are the identity.
  * :func:`group_from_env` joins the process group that ``torchrun``
    describes (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): rank r on
    ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo with
    ``device="cpu"``.
  * :meth:`ClientGroup.connect` joins a group whose size, rank and store
    the caller gives (tests, and several ranks on one card over gloo).

The transport follows the device (NCCL on a card, gloo on the CPU) unless
the caller names one; it is never switched in silence.  NCCL refuses two
ranks on one card, so several ranks on one card take gloo, whose
``all_gather`` takes CUDA tensors: the compute stays on the card.

:meth:`ClientGroup.pmean` adds the gathered rows left to right in rank
order from row 0, then multiplies by the f32 reciprocal of the world
size: XLA's CPU ``psum`` over forced host devices adds in device order,
and ``jax.lax.pmean`` divides the sum by the axis size, a division that
XLA rewrites to that product under ``jit`` (the reference's train step
always is; at three clients the two differ).  An ``all_reduce`` would add
in its own order and could not be bit-equal to the reference.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.reduce import _reciprocal

TIMEOUT = datetime.timedelta(seconds=120)


@dataclasses.dataclass(eq=False)
class ClientGroup:
    """The clients of one run, seen from one of them.

    ``rank`` is this process's client index, ``world`` the number of
    clients, ``device`` where this client computes and ``backend`` the
    transport of the process group (``None``: world 1, no process
    group)."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None

    def __post_init__(self) -> None:
        if self.backend is None and (self.world, self.rank) != (1, 0):
            raise ValueError("a group without a process group has world 1 and rank 0; "
                             f"got rank {self.rank} of {self.world}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    @classmethod
    def connect(cls, *, rank: int, world: int, device=None,
                backend: Optional[str] = None,
                init_method: str = "env://") -> "ClientGroup":
        """Join a process group of ``world`` ranks as ``rank``.
        ``backend`` defaults to NCCL on a card and gloo on the CPU;
        ``init_method`` is a ``torch.distributed`` URL (``env://``,
        ``file://<path>``, ``tcp://host:port``).  Every collective waits
        at most ``TIMEOUT`` for the other ranks, so a rank that failed
        does not leave the others blocked for good."""
        import torch.distributed as dist

        device = resolve_device(device)
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("NCCL moves CUDA tensors only; the CPU takes gloo")
        if device.type == "cuda":
            if device.index is None:  # "cuda": the current card
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, timeout=TIMEOUT)
        return cls(rank=rank, world=world, device=device, backend=backend)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: ``(world, *t.shape)``.
        ``torch.uint32`` has few ops, so its words cross as an ``int32``
        view."""
        if self.backend is None:
            return t[None]
        import torch.distributed as dist

        words = t.dtype == torch.uint32
        src = (t.view(torch.int32) if words else t).contiguous()
        rows = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(rows, src)
        out = torch.stack(rows)
        return out.view(torch.uint32) if words else out

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """``jax.lax.pmean`` over the clients as XLA's CPU backend computes
        it under ``jit``: the rows added left to right in rank order from
        row 0, the sum times the f32 reciprocal of the world size.  World
        1 without a process group returns ``t``."""
        if self.backend is None:
            return t
        rows = self.all_gather_rows(t)
        acc = rows[0]
        for row in rows[1:]:
            acc = acc + row
        return acc * _reciprocal(self.world, acc.device)

    def close(self) -> None:
        """Leave the process group (no-op without one)."""
        if self.backend is None:
            return
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def make_host_group(device=None) -> ClientGroup:
    """One client, no process group: the one-card topology (the
    counterpart of ``make_host_mesh``)."""
    return ClientGroup(rank=0, world=1, device=resolve_device(device))


def launched_by_torchrun() -> bool:
    """True when ``torchrun`` started this process (it sets ``WORLD_SIZE``
    and ``LOCAL_RANK``)."""
    return "WORLD_SIZE" in os.environ and "LOCAL_RANK" in os.environ


def group_from_env(device: Optional[Union[str, torch.device]] = None) -> ClientGroup:
    """Join the process group ``torchrun`` describes: rank ``RANK`` of
    ``WORLD_SIZE``, on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over
    gloo when ``device`` is ``"cpu"``."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ["LOCAL_RANK"])
    if device is None or torch.device(device).type == "cuda":
        device = torch.device("cuda", local)
    return ClientGroup.connect(rank=rank, world=world, device=device)
