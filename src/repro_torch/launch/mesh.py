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
axes of a layout count the clients; every other axis is a shard axis.
:func:`check_clients` takes two worlds: one rank a client (the client
axes' product; a rank holds all of its client's shards), or one rank a
device (every axis' product; a rank holds one device's shard, FSDP).  In
the second, rank r takes its coordinates row-major over the layout's
axes in their order, as ``jax.make_mesh`` orders devices, and
:meth:`ClientGroup.device_ranks` gives its :class:`DeviceRanks`: the
sub-groups of the exchange (the ranks of the same device coordinate in
every client), of the client (to gather a leaf's blocks) and of the
client's "data" ranks (the gradient's mean).

The transport follows the device (NCCL on a card, gloo on the CPU) unless
the caller names one; it is never switched in silence.  NCCL refuses two
ranks on one card, so several ranks on one card take gloo, which
gathers CUDA tensors through host copies (a staging buffer a group, kept
for its life): the compute stays on the card.

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
import math
import os
from typing import Any, Optional, Union

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
    """The number of clients, the product of ``layout``'s ``client_axes``,
    when ``world`` is that number (one client a rank) or the product of
    every axis (one device a rank: the shard axes cross ranks);
    ``ValueError`` otherwise."""
    n = math.prod(layout[ax] for ax in client_axes)
    if world in (n, math.prod(layout.values())):
        return n
    raise ValueError(f"layout {layout} has {n} client(s) on the axes {client_axes} and "
                     f"{math.prod(layout.values())} device(s), but the group has {world} "
                     "rank(s): one client a rank, or one device a rank")


@dataclasses.dataclass(eq=False)
class DeviceRanks:
    """One rank of a world of one rank a device, and its sub-groups.

    ``client`` is its client index (row-major over the client axes),
    ``device`` its device index inside the client (row-major over the
    shard axes, the order of ``ShardedFlatParamSpace``'s devices) and
    ``devices`` the devices a client.  ``exchange`` holds the ranks of this
    device coordinate in every client, in client order (the exchange's
    ``all_gather_rows``, ``pmean`` and ``gather_order``); ``client_ranks``
    the client's ranks in device order (a leaf's blocks); ``data`` the client's
    ranks that share this rank's other shard coordinates, in "data" order
    (the gradient's mean; world 1 without a "data" shard axis).  Serving
    reads two more: ``model`` holds the ranks that differ from this one in
    the "model" coordinate alone, in "model" order (a cut cache's
    attention; the client's ranks in data mode), and ``batch`` the ranks of
    this "model" coordinate, row-major over ("pod", "data") (the rows of
    the batch); each is world 1 without its axes."""

    client: int
    device: int
    devices: int
    coords: dict
    exchange: "ClientGroup"
    client_ranks: "ClientGroup"
    data: "ClientGroup"
    data_devices: tuple  # the device index of each of ``data``'s ranks
    world_order: tuple  # the global ranks in (client, device) order
    model: "ClientGroup"
    batch: "ClientGroup"


@dataclasses.dataclass(eq=False)
class ClientGroup:
    """The clients of one run, seen from one of them.

    ``rank`` is this process's client index, ``world`` the number of
    clients, ``device`` where this client computes and ``backend`` the
    transport of the process group (``None``: world 1, no process
    group).  A sub-group (:meth:`device_ranks`) also holds its process
    group handle ``pg``; its ``rank`` and ``world`` are inside it."""

    rank: int
    world: int
    device: torch.device
    backend: Optional[str] = None
    pg: Any = None  # a sub-group's handle (None: the default group)
    members: tuple = ()  # a sub-group's global ranks, in its rank order
    timeout: datetime.timedelta = TIMEOUT  # the longest wait for the other ranks
    _host: Any = dataclasses.field(default=None, repr=False)  # gloo's staging buffer

    def __post_init__(self) -> None:
        if self.backend is None and (self.world, self.rank) != (1, 0):
            raise ValueError("a group without a process group has world 1 and rank 0; "
                             f"got rank {self.rank} of {self.world}")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} outside a world of {self.world}")

    @classmethod
    def connect(cls, *, rank: int, world: int, device=None,
                backend: Optional[str] = None, init_method: str = "env://",
                timeout: datetime.timedelta = TIMEOUT) -> "ClientGroup":
        """Join a process group of ``world`` ranks as ``rank``.
        ``backend`` defaults to NCCL on a card and gloo on the CPU;
        ``init_method`` is a ``torch.distributed`` URL (``env://``,
        ``file://<path>``, ``tcp://host:port``).  Joining and every
        collective, of the group and of its sub-groups, wait at most
        ``timeout`` (default ``TIMEOUT``) for the other ranks, so a rank
        that failed does not leave the others blocked for good."""
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
                                world_size=world, timeout=timeout)
        return cls(rank=rank, world=world, device=device, backend=backend, timeout=timeout)

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked in rank order: ``(world, *t.shape)``.
        ``torch.uint32`` has few ops, so its words cross as an ``int32``
        view."""
        if self.backend is None:
            return t[None]
        words = t.dtype == torch.uint32
        out = torch.stack(self.gather_list(t.view(torch.int32) if words else t))
        return out.view(torch.uint32) if words else out

    def gather_list(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` in rank order, a tensor each (no stacked
        copy); ``[t]`` without a process group.  Gloo takes a CUDA tensor
        through :meth:`_staged` host copies."""
        if self.backend is None:
            return [t]
        import torch.distributed as dist

        src = t.contiguous()
        if self.backend == "gloo" and src.is_cuda:
            send, recv = self._staged(src, self.world)
            dist.all_gather(list(recv.unbind(0)), send, group=self.pg)
            return list(recv.to(src.device).unbind(0))
        rows = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(rows, src, group=self.pg)
        return rows

    def exchange_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """All to all: ``rows`` ``(world, ...)`` sends row j to rank j;
        returns ``(world, ...)`` whose row i came from rank i (``rows``
        itself without a process group).  Gloo takes a CUDA tensor through
        :meth:`_staged` host copies."""
        if self.backend is None:
            return rows
        import torch.distributed as dist

        src = rows.contiguous()
        if self.backend == "gloo" and src.is_cuda:
            send, recv = self._staged(src, 1)
            dist.all_to_all_single(recv[0], send, group=self.pg)
            return recv[0].to(src.device)
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.pg)
        return out

    def _staged(self, src: torch.Tensor, n_out: int) -> tuple:
        """``(send, recv)``: host views of this group's staging buffer,
        ``send`` a copy of the CUDA tensor ``src`` and ``recv`` room for
        ``n_out`` of its shape, ``(n_out, *src.shape)``.  The buffer is
        pageable and kept (grown to the largest call), so its pages are
        touched once: gloo's own staging of a CUDA tensor takes pinned
        blocks that torch's host allocator keeps cached by size (several
        ranks gathering a model's leaves on one machine filled its host
        memory), and a fresh host tensor a call faults its pages in on
        every copy.  The views are good until the next call."""
        n = src.numel() * src.element_size()
        if self._host is None or self._host.numel() < n * (1 + n_out):
            self._host = None
            self._host = torch.empty(n * (1 + n_out), dtype=torch.uint8)
        buf = self._host[:n * (1 + n_out)].view(src.dtype)
        send = buf[:src.numel()].view(src.shape)
        send.copy_(src)
        return send, buf[src.numel():].view((n_out,) + tuple(src.shape))

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

    def device_ranks(self, layout: dict, client_axes: tuple) -> DeviceRanks:
        """This rank's :class:`DeviceRanks` in a world of one rank a device
        of ``layout`` (:func:`check_clients`).  Every rank makes every
        sub-group, in the same order (``torch.distributed.new_group``
        wants each of them made by all ranks), one process group for each
        distinct set of ranks; a sub-group of one rank is world 1 without
        a process group."""
        sizes = {str(k): int(v) for k, v in layout.items()}
        if self.world != math.prod(sizes.values()):
            raise ValueError(f"{self.world} ranks are not the {math.prod(sizes.values())} "
                             f"devices of {layout}")
        shard_axes = tuple(a for a in sizes if a not in client_axes)

        def index(coords: dict, axes: tuple) -> int:
            return int(np.ravel_multi_index(tuple(coords[a] for a in axes),
                                            tuple(sizes[a] for a in axes))) if axes else 0

        # row-major over the layout's axes in their order, jax.make_mesh's
        coords = [dict(zip(sizes, np.unravel_index(r, tuple(sizes.values()))))
                  for r in range(self.world)]
        client = [index(c, tuple(client_axes)) for c in coords]
        device = [index(c, shard_axes) for c in coords]
        n_clients, n_dev = max(client) + 1, max(device) + 1
        rank_of = {(client[r], device[r]): r for r in range(self.world)}
        data_key = [(client[r], tuple(coords[r][a] for a in shard_axes if a != "data"))
                    for r in range(self.world)]

        def alike(keep: tuple) -> list:
            """The ranks that share the coordinates of ``keep``, a group
            each, in rank order (row-major over the other axes)."""
            key = [tuple(coords[r][a] for a in keep) for r in range(self.world)]
            return [[r for r in range(self.world) if key[r] == k] for k in dict.fromkeys(key)]

        # exchange, client, "data", "model" and batch groups, in that order
        kinds = ([[rank_of[c, d] for c in range(n_clients)] for d in range(n_dev)],
                 [[rank_of[c, d] for d in range(n_dev)] for c in range(n_clients)],
                 [sorted((r for r in range(self.world) if data_key[r] == key),
                         key=lambda r: coords[r].get("data", 0))
                  for key in dict.fromkeys(data_key)],
                 alike(tuple(a for a in sizes if a != "model")),
                 alike(tuple(a for a in sizes if a not in ("pod", "data"))))
        made: dict = {}
        mine = []
        for groups in kinds:
            for ranks in groups:
                if tuple(ranks) not in made:
                    made[tuple(ranks)] = self._new_group(ranks)
                if self.rank in ranks:
                    mine.append((self._sub(ranks, made[tuple(ranks)]), ranks))
        return DeviceRanks(client=client[self.rank], device=device[self.rank], devices=n_dev,
                           coords=coords[self.rank], exchange=mine[0][0],
                           client_ranks=mine[1][0], data=mine[2][0],
                           data_devices=tuple(device[r] for r in mine[2][1]),
                           world_order=tuple(rank_of[c, d] for c in range(n_clients)
                                             for d in range(n_dev)),
                           model=mine[3][0], batch=mine[4][0])

    def _sub(self, ranks: list, pg) -> "ClientGroup":
        """This rank's view of the sub-group of ``ranks`` (global ranks, in
        the sub-group's order) whose process group is ``pg``."""
        return ClientGroup(rank=ranks.index(self.rank), world=len(ranks), device=self.device,
                           backend=self.backend if len(ranks) > 1 else None, pg=pg,
                           members=tuple(ranks), timeout=self.timeout)

    def _new_group(self, ranks: list):
        """A process group of ``ranks`` (None for one rank: no collective
        crosses it)."""
        if len(ranks) == 1:
            return None
        import torch.distributed as dist

        return dist.new_group(ranks, timeout=self.timeout, backend=self.backend)

    def close(self) -> None:
        """Leave the process group (no-op without one, and on a sub-group:
        the default group's owner leaves it)."""
        if self.backend is None or self.pg is not None:
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
