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

A layout is the reference's mesh as a dict of axis sizes:
:func:`production_layout` gives its two production meshes, (16, 16)
("data", "model") and (2, 16, 16) ("pod", "data", "model"), and
:func:`default_layout` the in-process one, ``(world, 1)``.  The client
axes of a layout map to the ranks (their product is the group's world,
:func:`check_clients`); every other axis is a shard axis, all of whose
shards a rank holds (``repro_torch.launch.dist``).

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

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.reduce import _reciprocal

TIMEOUT = datetime.timedelta(seconds=120)

SINGLE_POD = {"data": 16, "model": 16}  # 256 chips, one pod
MULTI_POD = {"pod": 2, "data": 16, "model": 16}  # 512 chips, two pods


def production_layout(*, multi_pod: bool = False) -> dict[str, int]:
    """The reference's production meshes (``repro.launch.mesh``) as axis
    sizes."""
    return dict(MULTI_POD if multi_pod else SINGLE_POD)


def default_layout(world: int) -> dict[str, int]:
    """The reference's in-process mesh: one "data" coordinate a device and
    a size-1 "model" axis, here one "data" coordinate a rank."""
    return {"data": int(world), "model": 1}


def axis_sizes(layout: dict) -> dict[str, int]:
    """Axis name → size of a layout, checked: every size a positive int."""
    sizes = {str(k): int(v) for k, v in layout.items()}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"layout {layout}: every axis needs a size of 1 or more")
    return sizes


def check_clients(layout: dict, client_axes: tuple, world: int) -> int:
    """The number of clients, the product of ``layout``'s ``client_axes``;
    ``ValueError`` unless it is ``world`` (one client a rank).  A layout
    whose clients are fewer than the ranks, every device a rank, would put
    a shard axis across ranks: that raises ``NotImplementedError`` (ROADMAP
    A12, part 3, item 7)."""
    n = 1
    for ax in client_axes:
        n *= layout[ax]
    if n == world:
        return n
    total = 1
    for size in layout.values():
        total *= size
    if world > n and world % n == 0 and total % world == 0:
        raise NotImplementedError(
            f"layout {layout} has {n} client(s) over {world} ranks: a shard axis across "
            "ranks (each rank one device's shard, true FSDP memory) comes with ROADMAP "
            "A12, part 3, item 7; here a rank holds a whole client")
    raise ValueError(f"layout {layout} has {n} client(s) on the axes {client_axes}, but the "
                     f"group has {world} rank(s): one client a rank")


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

    def pmean(self, t: torch.Tensor, grid: Optional[tuple] = None) -> torch.Tensor:
        """``jax.lax.pmean`` over the clients as XLA's CPU backend computes
        it under ``jit``: the rows added left to right in rank order from
        row 0, the sum times the f32 reciprocal of the world size.  World
        1 without a process group returns ``t``.

        ``grid`` gives the sizes of several client axes (ranks row-major
        over them, product ``world``): the reference then takes one
        ``pmean`` an axis, the first axis first, and so does this."""
        if self.backend is None:
            return t
        rows = self.all_gather_rows(t)
        grid = tuple(grid) if grid else (self.world,)
        rows = rows.reshape(grid + tuple(t.shape))
        for size in grid:  # the leading axis each time
            acc = rows[0]
            for row in rows[1:]:
                acc = acc + row
            rows = acc * _reciprocal(size, acc.device)
        return rows

    def gather_order(self, grid: Optional[tuple] = None) -> list:
        """The ranks in the order of the reference's gathered rows: one
        ``all_gather`` a client axis, the first axis first, stacks the
        last axis outermost (rank order for one axis)."""
        grid = tuple(grid) if grid else (self.world,)
        order = np.arange(self.world).reshape(grid).transpose(tuple(reversed(range(len(grid)))))
        return [int(r) for r in order.reshape(-1)]

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
