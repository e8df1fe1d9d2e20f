"""Rank-sharded parameters: one rank a device of its client.

The reference's pod mode (``repro.launch.dist``, "params FSDP-sharded
over 'data'") keeps one block of every leaf on each device of a pod,
takes the pod's gradient as a dense mean inside it and exchanges sparse
updates across pods only.  With one rank a device
(``repro_torch.launch.mesh.check_clients``) the port does the same: a
rank's state holds its device's blocks, and the model takes its leaves
through :func:`repro_torch.models.hints.params` at their point of use,
which in a rank-sharded step calls :meth:`RankShards.gather`:

  * the forward all-gathers a leaf's blocks over the client's ranks and
    puts the leaf together in the reference's block order (the inverse of
    ``repro_torch.launch.dist._device_blocks``: device d holds block
    ``dev_block[d]``, a block held by several devices is taken from the
    first);
  * the backward sends each of the client's "data" ranks its block of
    this rank's whole gradient (an all-to-all: gloo has no
    ``reduce_scatter``), adds the blocks it receives in rank order and
    multiplies by the f32 reciprocal of their number
    (``ClientGroup.pmean``'s arithmetic): this rank's block of the pod's
    mean gradient.

A leaf whole on every device of its client (spec ``()``, or cut over no
shard axis of size above 1) is not gathered: its gradient only takes the
mean.  :meth:`RankShards.data_mean` is the mean of a statistic of the
rank's rows over the "data" ranks, differentiable, for the MoE aux term,
and :meth:`RankShards.data_before` the counts of the lower "data" ranks,
for flat MoE dispatch over the pod's batch.

Serving (``repro_torch.launch.dist.make_dist_serve`` and
``make_dist_prefill``) uses the same gather forward only, under
``torch.no_grad``: each leaf is gathered whole at its use and dropped
after it, and the rows whose statistics the MoE shares are the batch's
ranks (``rows``).  :class:`CacheCut` is a decode step's cut of its caches
over the "model" ranks, behind :func:`repro_torch.models.hints.cache_cut`,
and :func:`cut_tree` cuts a tree to one device's blocks of its specs (the
caches by ``cache_specs``).
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.kernels.reduce import _reciprocal


class LeafBlocks(NamedTuple):
    """How a leaf is cut over its client's devices."""

    grid: tuple  # per-dim block counts of the whole leaf
    dev_block: tuple  # the grid-order block of each device of the client
    path: str = ""


def block_slices(shape, grid: Sequence[int], block: int) -> tuple:
    """The index of grid-order block ``block`` of a tensor of ``shape``
    cut into ``grid`` equal blocks a dim."""
    grid = tuple(grid) + (1,) * (len(shape) - len(tuple(grid)))
    coords = np.unravel_index(block, grid) if grid else ()
    return tuple(slice(int(c) * (d // g), (int(c) + 1) * (d // g))
                 for c, d, g in zip(coords, shape, grid))


def block_of(full: torch.Tensor, grid: Sequence[int], block: int) -> torch.Tensor:
    """Block ``block`` of ``full`` as a tensor of its own (a copy)."""
    return full[block_slices(tuple(full.shape), grid, block)].clone()


def spec_block(shape, spec: tuple, sizes: dict, coords: dict) -> tuple:
    """``(grid, block)``: the per-dim block counts of a tensor of ``shape``
    under ``spec`` (an entry a dim: an axis name, a tuple of them or None)
    on a layout of axis ``sizes``, and the grid-order block that the device
    at ``coords`` (axis name → coordinate) holds.  A dim's block index is
    the device's coordinate over that dim's axes, row-major."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    grid, block = [], 0
    for e in entries:
        g, i = 1, 0
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            g, i = g * sizes[a], i * sizes[a] + int(coords[a])
        grid.append(g)
        block = block * g + i
    return tuple(grid), block


def cut_tree(tree, specs, sizes: dict, coords: dict):
    """This device's block (a copy) of every leaf of ``tree`` under its spec
    in ``specs`` (a tree of spec tuples, such as
    ``repro_torch.launch.dist.cache_specs``'), :func:`block_of` with the
    grid the spec gives.  An axis given size 1 in ``sizes`` (coordinate 0)
    cuts nothing: a tree already holding this rank's rows passes its batch
    axes so."""
    flat, treedef = tree_flatten(tree)
    return treedef.unflatten([block_of(v, *spec_block(tuple(v.shape), spec, sizes, coords))
                              for v, spec in zip(flat, treedef.flatten_up_to(specs))])


def assemble(rows: Sequence[torch.Tensor], grid: Sequence[int], dev_block: Sequence[int]
             ) -> torch.Tensor:
    """The whole tensor from every device's block (``rows``, device order):
    each block copied into place from the first device holding it."""
    local = tuple(rows[0].shape)
    grid = tuple(grid) + (1,) * (len(local) - len(tuple(grid)))
    full = rows[0].new_empty(tuple(g * d for g, d in zip(grid, local)))
    for b in range(math.prod(grid)):
        full[block_slices(tuple(full.shape), grid, b)] = rows[list(dev_block).index(b)]
    return full


def _mean_rows(rows) -> torch.Tensor:
    """``ClientGroup.pmean``'s arithmetic on rows already in rank order:
    added left to right, times the f32 reciprocal of their number (one row:
    itself)."""
    acc = rows[0]
    for row in rows[1:]:
        acc = acc + row
    return acc if len(rows) == 1 else acc * _reciprocal(len(rows), acc.device)


class _Gather(torch.autograd.Function):
    """A rank's block → the whole leaf (forward); the whole leaf's gradient
    → this rank's block of its mean over the "data" ranks (backward)."""

    @staticmethod
    def forward(ctx, block, shards, grid, dev_block):
        ctx.shards, ctx.grid, ctx.dev_block = shards, grid, dev_block
        return assemble(shards.ranks.client_ranks.gather_list(block), grid, dev_block)

    @staticmethod
    def backward(ctx, grad):
        ranks = ctx.shards.ranks
        rows = torch.stack([grad[block_slices(tuple(grad.shape), ctx.grid, ctx.dev_block[d])]
                            for d in ranks.data_devices])
        # row i of the exchange: "data" rank i's gradient at this rank's block
        return _mean_rows(ranks.data.exchange_rows(rows)), None, None, None


class _MeanGrad(torch.autograd.Function):
    """A leaf whole on every device: the identity forward, the gradient's
    mean over the "data" ranks backward."""

    @staticmethod
    def forward(ctx, leaf, shards):
        ctx.shards = shards
        return leaf.view_as(leaf)

    @staticmethod
    def backward(ctx, grad):
        return _mean_rows(ctx.shards.ranks.data.gather_list(grad)), None


class _DataMean(torch.autograd.Function):
    """The mean over the "data" ranks, forward and backward (the backward's
    incoming gradients are the same on every rank, so their mean passes
    them on: the pod's loss counts the term once)."""

    @staticmethod
    def forward(ctx, t, shards):
        ctx.shards = shards
        return _mean_rows(shards.rows.gather_list(t))

    @staticmethod
    def backward(ctx, grad):
        return _mean_rows(ctx.shards.rows.gather_list(grad)), None


class RankShards:
    """The rank-sharded parameters of one step: ``leaves`` (this rank's
    blocks, the tensors the model is given, in tree order) and their
    :class:`LeafBlocks`, ``ranks`` the rank's
    :class:`~repro_torch.launch.mesh.DeviceRanks`, ``remat`` the config's
    (a gathered block is recomputed in the backward), ``rows`` the group
    whose ranks' rows make the batch that the MoE's statistics and slots
    cover (default the client's "data" ranks: the pod's batch)."""

    def __init__(self, ranks: Any, leaves: Sequence[torch.Tensor],
                 blocks: Sequence[LeafBlocks], remat: bool = False, rows: Any = None):
        self.ranks, self.remat = ranks, bool(remat)
        self.rows = ranks.data if rows is None else rows
        self._of = {id(v): b for v, b in zip(leaves, blocks)}
        self._leaves = list(leaves)
        self.seen: set = set()

    def gather(self, tree, index: Optional[int] = None):
        """:func:`repro_torch.models.hints.params` in a rank-sharded step:
        each leaf of ``tree`` (``index``: its slice of the leading dim,
        which no spec cuts) whole, its gradient this rank's block of the
        pod's mean."""
        def one(v):
            lb = self._of.get(id(v))
            if lb is None:
                raise ValueError("hints.params got a tensor that is not one of the step's "
                                 f"parameter leaves (shape {tuple(v.shape)})")
            self.seen.add(id(v))
            grid = lb.grid
            if index is not None:
                if grid and grid[0] != 1:
                    raise ValueError(f"{lb.path}: its leading dim is cut {grid}; a scanned "
                                     "stack's superblock dim never is")
                v, grid = v[index], grid[1:]
            if math.prod(grid) == 1:
                return _MeanGrad.apply(v, self) if self.ranks.data.world > 1 else v
            return _Gather.apply(v, self, grid, lb.dev_block)

        return tree_map(one, tree)

    def data_mean(self, t: torch.Tensor) -> torch.Tensor:
        return _DataMean.apply(t, self) if self.rows.world > 1 else t

    def data_before(self, counts: torch.Tensor) -> torch.Tensor:
        """``counts`` summed over the ``rows`` ranks before this one, in
        their order (the batch's row order)."""
        rows = self.rows.gather_list(counts)[:self.rows.rank]
        return sum(rows, torch.zeros_like(counts))

    def check_every_leaf_used(self, unread: tuple = ()) -> None:
        """Raise unless the forward took every leaf through :meth:`gather`
        (a leaf used as a block would be wrong in silence); leaves whose
        path starts with one of ``unread`` may go unused (a decode step
        reads no encoder: its memory is in the caches)."""
        missed = [self._of[id(v)].path for v in self._leaves
                  if id(v) not in self.seen and not self._of[id(v)].path.startswith(unread)]
        if missed:
            raise RuntimeError(f"the model used {missed[:3]}… without hints.params: in a "
                               "rank-sharded step each leaf must be gathered at its use")


def assemble_tree(ranks: Any, tree, blocks: Sequence[LeafBlocks]):
    """Every leaf of ``tree`` (this rank's blocks, tree order) whole,
    gathered over the client's ranks: a collective of the client's ranks,
    outside autograd."""
    flat, treedef = tree_flatten(tree)
    return treedef.unflatten([
        v if math.prod(lb.grid) == 1 else
        assemble(ranks.client_ranks.gather_list(v), lb.grid, lb.dev_block)
        for v, lb in zip(flat, blocks)])


class CacheCut:
    """A decode step's caches cut over the "model" ranks (``group``: the
    ranks of this rank's ("pod", "data") coordinate, in "model" order, its
    rank this rank's "model" coordinate), read through
    :func:`repro_torch.models.hints.cache_cut`.  A leaf's cut shows in its
    shape (fewer KV heads, cache slots, channels or RWKV heads than the
    whole); ``cross_seq`` says that the encoder memory's ``cross_k`` and
    ``cross_v``, which carry no slot positions, are cut over their
    sequence."""

    def __init__(self, group: Any, cross_seq: bool = False):
        self.group, self.cross_seq = group, bool(cross_seq)
        self.world, self.rank = group.world, group.rank

    def part(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's equal share of ``t`` along ``dim``."""
        n = t.shape[dim] // self.world
        return t.narrow(dim, self.rank * n, n)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` put together along ``dim``, in "model" order."""
        return torch.cat(self.group.gather_list(t), dim=dim)
