"""Activation-sharding hints of the launch layer.

Counterpart of ``repro.models.hints``.  The reference's launch layer
installs an ambient (mesh, batch axes, sequence axis, expert axis) context
around its jitted step, and the model calls :func:`act`,
:func:`expert_flat` and :func:`expert_grouped` on its activations: each
is a ``jax.lax.with_sharding_constraint`` that tells GSPMD how to lay the
activation out over the mesh.  PyTorch has no GSPMD, and the port never
cuts an activation across ranks, so those three hints are identities
here, and the model does not call them.  The layout (a dict of axis
sizes, the port's mesh) still decides :func:`expert_mode`.

These hints have readers:

  * :func:`lean_moe` (the launch option ``"lean_moe"``) makes the MoE
    layer combine in the activations' dtype and cap its capacity factor
    at 1.0 (``repro_torch.models.moe``), which changes the numbers;
  * :func:`params` is where the model takes its parameters: the
    embedding and the head, each superblock's slice of the scanned stack,
    each remainder block, the encoder and the final norms.  Inside a
    rank-sharded step (one rank a device, ``repro_torch.launch.shards``)
    it gathers the leaves from their blocks on the client's ranks, and
    :func:`remat` says whether to recompute a gathered block in the
    backward (``cfg.remat``, the reference's ``jax.checkpoint``);
  * :func:`data_mean` is the mean of a per-batch statistic over the
    client's "data" ranks in such a step (the MoE aux term's row means),
    as GSPMD computes it over the whole pod batch, and
    :func:`data_ranks` and :func:`data_before` let flat MoE dispatch size
    its capacity and number its slots over the pod's batch;
  * :func:`drawn` cuts parameters to this rank's blocks as the model's
    init draws them, inside :func:`cut_params` (a rank-sharded
    ``init_state``), so no rank holds the whole model;
  * :func:`cache_cut` is the cut of the decode caches over the "model"
    ranks in a rank-sharded decode step, inside :func:`sharded_caches`
    (``repro_torch.launch.dist.make_dist_serve``): attention, Mamba and
    RWKV6 read it to attend over this rank's heads or cache slots, or to
    step this rank's channels of a state, and to put the whole back
    together;
  * :func:`steps` and :func:`every_step` run a host loop over sequence
    positions (the Mamba and RWKV6 recurrences) or query chunks
    (attention): ``range(n)`` and the step outputs as they are, unless
    the dry run samples loops
    (:func:`sampled_loops`, ``repro_torch.launch.roofline.LoopSampler``),
    where two steps run and the second counts for all but the first.

Without a context every hint is the identity (or a no-op), :func:`remat`
and :func:`lean_moe` are False, :func:`data_ranks` is 1 and
:func:`cache_cut` is None.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

from repro_torch.core.tree import tree_map

_CTX: dict[str, Any] = {"mesh": None, "batch": None, "seq": None, "expert": None,
                        "seq_every": 1, "lean_moe": False, "shards": None, "cut": None,
                        "caches": None, "loops": None}


def lean_moe() -> bool:
    """True inside a context installed with ``lean_moe=True``: bf16 MoE
    combine and a capacity factor of at most 1.0."""
    return bool(_CTX["lean_moe"])


@contextlib.contextmanager
def activation_sharding(mesh, *, batch_axes=None, seq_axis: Optional[str] = "model",
                        expert_axis: Optional[str] = None, seq_every: int = 1,
                        lean_moe: bool = False):
    """Install the hints for the duration of a step.

    ``mesh`` is a layout, a dict of axis sizes (``{"data": 16, "model":
    16}``).  ``batch_axes``, ``seq_axis``, ``expert_axis`` and
    ``seq_every`` are the reference's (they place activations, which the
    port does not shard); ``lean_moe`` turns on the lean MoE combine."""
    old = dict(_CTX)
    _CTX.update(mesh=mesh, batch=batch_axes, seq=seq_axis, expert=expert_axis,
                seq_every=max(1, seq_every), lean_moe=lean_moe)
    try:
        yield
    finally:
        _CTX.update(old)


@contextlib.contextmanager
def sharded_params(shards):
    """Install a rank-sharded step's
    :class:`~repro_torch.launch.shards.RankShards` for :func:`params`,
    :func:`remat` and :func:`data_mean`, around its forward and
    backward."""
    old = _CTX["shards"]
    _CTX["shards"] = shards
    try:
        yield
    finally:
        _CTX["shards"] = old


def params(tree, index: Optional[int] = None):
    """The parameters ``tree`` at their point of use: with ``index``, each
    leaf's ``index``-th slice of its leading (scanned superblock) dim.
    Inside a rank-sharded step, the whole leaves gathered from their
    blocks on the client's ranks; their gradients come back as this
    rank's blocks of the pod's mean."""
    shards = _CTX["shards"]
    if shards is not None:
        return shards.gather(tree, index)
    if index is None:
        return tree
    return tree_map(lambda v: v[index], tree)


def remat() -> bool:
    """True inside a rank-sharded step whose config sets ``remat``: a
    gathered block is recomputed in the backward, so a rank holds one
    block's gathered weights at a time."""
    shards = _CTX["shards"]
    return shards is not None and shards.remat


def data_mean(t):
    """``t``, a statistic of this rank's rows, averaged over the client's
    "data" ranks inside a rank-sharded step (differentiable); the identity
    elsewhere."""
    shards = _CTX["shards"]
    return t if shards is None else shards.data_mean(t)


def data_ranks() -> int:
    """The client's "data" ranks inside a rank-sharded step (the pod's
    batch is this rank's rows that many times); 1 elsewhere."""
    shards = _CTX["shards"]
    return 1 if shards is None else shards.rows.world


def data_before(counts):
    """``counts`` (a count a class on this rank's rows) summed over the
    client's "data" ranks before this one, whose rows come first in the
    pod's batch, inside a rank-sharded step (a collective of those ranks);
    zeros elsewhere."""
    shards = _CTX["shards"]
    return counts.new_zeros(counts.shape) if shards is None else shards.data_before(counts)


@contextlib.contextmanager
def cut_params(cut):
    """Install ``cut(tree, path, scanned)``, which keeps this rank's blocks
    of the leaves of ``tree`` at ``path``, for :func:`drawn`, around a
    model's init."""
    old = _CTX["cut"]
    _CTX["cut"] = cut
    try:
        yield
    finally:
        _CTX["cut"] = old


@contextlib.contextmanager
def sharded_caches(cut):
    """Install a decode step's
    :class:`~repro_torch.launch.shards.CacheCut` (the caches' cut over
    the "model" ranks) for :func:`cache_cut`."""
    old = _CTX["caches"]
    _CTX["caches"] = cut
    try:
        yield
    finally:
        _CTX["caches"] = old


def cache_cut():
    """The installed :class:`~repro_torch.launch.shards.CacheCut`, or None
    (the caches are whole on this rank: the one-rank path)."""
    return _CTX["caches"]


def drawn(tree, path: str, scanned: bool = False):
    """Parameters just drawn, ``path`` their "a/b" place in the params'
    tree (``scanned``: one superblock of the scanned stack, without its
    leading dim): inside :func:`cut_params`, this rank's blocks of them, so
    the whole leaves are freed as they are drawn; the identity elsewhere."""
    cut = _CTX["cut"]
    return tree if cut is None else cut(tree, path, scanned)


def _fits(mesh: dict, axes, dim) -> bool:
    if not axes:
        return False
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= mesh.get(a, 1)
    return dim % total == 0


def act(x):
    """A ``(B, S, d)`` residual-stream activation between blocks: the
    identity."""
    return x


def expert_mode(n_experts: int) -> str:
    """``"ep"`` when the experts divide the expert axis (flat dispatch with
    expert parallelism), ``"group"`` otherwise or without a context."""
    mesh, ax = _CTX["mesh"], _CTX["expert"]
    if mesh is None or ax is None:
        return "group"
    return "ep" if _fits(mesh, ax, n_experts) else "group"


def expert_flat(x):
    """A flat-dispatch ``(E, C, d)`` buffer: the identity."""
    return x


def expert_grouped(x):
    """A grouped-dispatch ``(B, E, C, d)`` buffer: the identity."""
    return x


@contextlib.contextmanager
def sampled_loops(sampler):
    """Inside, :func:`steps` and :func:`every_step` go through ``sampler``
    (a ``repro_torch.launch.roofline.LoopSampler``)."""
    old = _CTX["loops"]
    _CTX["loops"] = sampler
    try:
        yield
    finally:
        _CTX["loops"] = old


def steps(n: int):
    """The positions of a host loop of ``n`` steps: ``range(n)``, or under
    :func:`sampled_loops` steps 0 and 1, the second standing for steps 1
    to n − 1."""
    sampler = _CTX["loops"]
    return range(n) if sampler is None or n <= 2 else sampler.steps(n)


def every_step(outs: list, n: int, *carries) -> list:
    """The loop's per-step outputs ``outs``, one a position: as they are,
    or under :func:`sampled_loops` the one step's output for each of the
    ``n`` (``carries``: the state it carries on, for the backward's
    count and the memory's)."""
    sampler = _CTX["loops"]
    return outs if sampler is None else sampler.every_step(outs, n, carries)
