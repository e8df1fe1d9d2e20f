"""The GSPMD backend's DSGD train step, one client per process.

Counterpart of ``repro.launch.dist`` (DESIGN.md §4).  The reference builds
its step on a device mesh, by default ``Mesh(devices.reshape(-1, 1),
("data", "model"))``, and runs the exchange inside ``shard_map``.  The
port runs one client per process: a
:class:`~repro_torch.launch.mesh.ClientGroup` gives the client index (its
rank) and the number of clients (its world), and every round's exchange
crosses the ranks over ``torch.distributed`` (NCCL on cards, gloo on the
CPU).  Each rank holds its client's state: the params (the same on every
rank), its row of the optimizer state and of the residual (a leading
client axis of 1).

The mesh is a layout, a dict of axis sizes (``mesh_shape``; default the
reference's ``(world, 1)``, ``{"data": world, "model": 1}``).  Its client
axes (:func:`client_topology`: "pod" and "data" in the data mode, "pod"
in pod mode, where the gradient is a dense mean inside the pod) count
the clients; every other axis is a shard axis.  Each leaf is cut into the
equal blocks its spec gives over the shard axes
(:func:`~repro_torch.models.model.make_param_specs`), and compression
runs per block, as the reference's per-device compression does: each
block takes its own k a row and μ, and Eq. 1 counts ``L · n_shards ·
(k_loc · b̄ + 32)`` bits a leaf.  The ranks are either

  * the clients (world = clients): a rank holds ALL of its client's
    shards, the whole model, and the flat engines keep one buffer a device
    of the client, ``(1, shards_per_client, n_pad)``; or
  * the devices (world = every axis' product, one rank a device): a rank
    holds its device's blocks of the params, the optimizer rows and the
    residual (``(1, 1, n_pad)`` flat), the model gathers each leaf at its
    use and the backward leaves each block the pod's mean gradient
    (:mod:`repro_torch.launch.shards`), and the exchange crosses the ranks
    of the same device coordinate in every client only
    (:class:`~repro_torch.launch.mesh.DeviceRanks`).  Each rank's rows are
    its "data" coordinate's share of its client's batch.

Each round is one ``train.step`` stage of the channel's telemetry clock
(:mod:`repro_torch.obs.stages`) with its forward, backward, optimizer,
exchange and apply stages in order; the disabled clock opens nothing.

The exchange is the §11 flat fast path (``fast=True``: the exact engine,
optionally with the device-packed Golomb wire, or the hist engine) or the
per-leaf exchange (``fast=False``, or a non-f32 ``residual_dtype``, as
the five pod-mode configs' bf16 residual).  A per-leaf policy maps each
leaf to one of the exchange's three modes (:func:`dist_leaf_mode`: SBC,
dense, skip); the hist engine takes all-SBC policies only (its flat space
raises ``ValueError`` otherwise, as the reference's does).  ``opts`` takes
the reference's launch options ``"lean_moe"`` (bf16 MoE combine, capacity
factor ≤ 1) and ``"seq_every2"``, installed through
:func:`repro_torch.models.hints.activation_sharding` around the step.
:func:`main` is the reference's launcher (``python -m
repro_torch.launch.dist``, the ``tiny`` preset by default).

Behaviour of the reference that the step reproduces as it is:

  * Adam is applied with ``step=0`` every round, so its bias correction
    always uses ``t = 1``;
  * the step uses ``cfg.base_lr`` (a RunSpec's ``lr`` is not read) and
    takes one local step per round (``delay`` is not read);
  * after the exchange, momentum (Adam's ``m``) is zeroed where the
    client's own ΔW* is non-zero;
  * the applied update is the mean's row of this client, which is client
    0's on every rank, and the loss metric is the mean over clients
    (``jnp.mean`` of the gathered losses, in XLA's order; one rank a
    device: each client's loss the mean over its "data" ranks first);
  * in pod mode a client's rank takes its pod's whole batch (one rank a
    device: its "data" share of it): the reference splits it over the
    pod's "data" devices, and GSPMD's gradient of the mean loss is the
    same mean.

The serve side is the reference's too (``repro.launch.dist``'s
``cache_specs``, ``make_dist_serve`` and ``make_dist_prefill``), with one
rank a device of the layout: a rank holds its device's blocks of the
params (``Model.param_specs``, gathered at their use and dropped after
it, forward only) and of the decode caches (:func:`cache_specs`), and its
("pod", "data") rows of the batch; a cut cache is attended over its
heads or its slots through :func:`repro_torch.models.hints.cache_cut`.
"""
from __future__ import annotations

import math
import warnings
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import GspmdLeaf, ShardedGspmdChannel
from repro_torch.core.codec import Codec, make_codec
from repro_torch.core.flat import ShardedFlatParamSpace
from repro_torch.core.policy import CompressionPolicy, path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.device import full_f32_math
from repro_torch.kernels.reduce import f32_mean_xla
from repro_torch.launch.mesh import (ClientGroup, axis_sizes, check_clients, default_layout,
                                     make_host_group)
from repro_torch.launch.shards import (CacheCut, LeafBlocks, RankShards, assemble,
                                       assemble_tree, block_of, cut_tree)
from repro_torch.models import hints
from repro_torch.models.model import Model, build_model, make_param_specs
from repro_torch.optim.optimizers import AdamState, get_optimizer, map_states

PyTree = Any  # a nested dict of tensors, as the reference's pytrees

OPTS = frozenset({"lean_moe", "seq_every2"})


def client_topology(cfg: ModelConfig, layout: dict) -> tuple[int, tuple[str, ...]]:
    """(n_clients, client axes) of ``layout`` (axis name → size): in pod
    mode one client a "pod" coordinate (one client without a "pod"
    axis), else one a ("pod", "data") coordinate."""
    sizes = axis_sizes(layout)
    if cfg.client_mode == "pod":
        return (sizes["pod"], ("pod",)) if "pod" in sizes else (1, ())
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return math.prod(sizes[a] for a in axes), axes


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _shards_of(spec: tuple, sizes: dict) -> int:
    """The distinct shards of a leaf under ``spec``."""
    return math.prod(sizes.get(ax, 1) for entry in spec for ax in _axes_of(entry))


def _shard_grid(shape, spec: tuple, sizes: dict) -> tuple[int, ...]:
    """Per-dim shard counts of a leaf under ``spec`` (GSPMD equal blocks)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return tuple(math.prod(sizes.get(a, 1) for a in _axes_of(e)) for e in entries)


def _local_shape(shape, spec: tuple, sizes: dict) -> tuple[int, ...]:
    """One shard's shape of a leaf under ``spec`` (GSPMD equal blocks)."""
    return tuple(d // g for d, g in zip(shape, _shard_grid(shape, spec, sizes)))


def _device_blocks(shape, spec: tuple, sizes: dict, shard_axes: tuple) -> tuple[int, ...]:
    """For each device of a client (row-major over ``shard_axes``), the
    grid-order block of the leaf it holds: a dim's block index is the
    device's coordinate over that dim's axes, row-major."""
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    grid = _shard_grid(shape, spec, sizes)
    out = []
    for coords in np.ndindex(*[sizes[a] for a in shard_axes]):
        at = dict(zip(shard_axes, coords))
        block = 0
        for e, g in zip(entries, grid):
            i = 0
            for ax in _axes_of(e):
                i = i * sizes[ax] + at.get(ax, 0)  # a client axis here has size 1
            block = block * g + i
        out.append(block)
    return tuple(out)


class DistTrainFns(NamedTuple):
    train_step: Callable  # (state, batch) -> (state, metrics)
    init_state: Callable  # generator -> state
    bits_per_client: float  # static Eq. 1 wire bits per round
    bits_dense: float
    flat_space: Any  # ShardedFlatParamSpace of the flat fast path, or None
    residual_to_tree: Optional[Callable]  # flat residual → the params' tree of (1,)+shape
    channel: Any  # the ShardedGspmdChannel driving the exchange
    params_to_tree: Callable = None  # state params → the whole params (a collective)
    client: int = 0  # this rank's client
    ranks: Any = None  # DeviceRanks with one rank a device, else None
    blocks: tuple = ()  # each leaf's LeafBlocks (its device → block map)
    eval_loss: Callable = None  # (state params, batch) -> the loss, no gradient (a collective)
    state_to_host: Callable = None  # state -> the global state on rank 0's host (a collective)


def dist_leaf_mode(codec: Codec) -> str:
    """The exchange mode of a leaf's codec: "sparse" (per-shard SBC, the
    (positions, μ) exchange), "dense" (the values' mean) or "skip" (no
    traffic).  Other codecs have no exchange on this backend, in the
    reference either."""
    if codec.skip:
        return "skip"
    if codec.selector.dense and codec.quantizer.name == "identity":
        return "dense"
    if codec.spec == "topk_signed|binarize|golomb":
        return "sparse"
    raise NotImplementedError(
        f"dist backend has no exchange kernel for codec {codec.spec!r}; "
        "supported: sbc (topk_signed|binarize|golomb), dense32, skip"
    )


def build_dist_train(
    cfg: ModelConfig,
    *,
    group: Optional[ClientGroup] = None,
    compressor: str = "sbc",
    sparsity: float = 0.001,
    policy: Optional[CompressionPolicy] = None,
    fast: Optional[bool] = None,
    flat_engine: str = "exact",
    measure: bool = False,
    device_pack: bool = False,
    model: Optional[Model] = None,
    device=None,
    mesh_shape: Optional[dict] = None,
    opts: frozenset = frozenset(),
) -> DistTrainFns:
    """Build this rank's DSGD train step for ``cfg``.

    ``group``: the :class:`~repro_torch.launch.mesh.ClientGroup` whose
    ranks are the clients (default: :func:`~repro_torch.launch.mesh.
    make_host_group` on ``device``, one client and no process group).

    ``mesh_shape``: the layout, axis name → size, such as
    ``production_layout()`` (``{"data": 16, "model": 16}``); default the
    reference's ``{"data": world, "model": 1}``.  ``group.world`` must be
    its client count (one rank a client, holding all of its client's
    shards) or its device count (one rank a device, holding that device's
    blocks; the model gathers each leaf at its use, ``remat`` recomputes a
    gathered block in the backward, and the exchange crosses the ranks of
    this device coordinate only); ``ValueError`` otherwise.  Each shard is
    compressed on its own.

    ``policy``: an optional per-leaf :class:`CompressionPolicy` (path-regex
    rules): each leaf takes its plan's exchange mode
    (:func:`dist_leaf_mode`) and rate (``plan.rate(sparsity, 0)``).
    Without one, ``compressor`` picks one codec for every leaf, as in the
    reference: ``"sbc"`` compresses every leaf with SBC at ``sparsity``,
    and any other name takes the ``dense`` codec under that name (this
    backend has no exchange for the baselines' codecs, so a baseline's
    round is the dense exchange and its bits are 32 a parameter).  Rates
    are fixed when the step is built, so a policy with per-round
    schedules raises, as the reference's does.

    ``fast``: True takes the §11 flat fast path with ``flat_engine``
    ("exact" or "hist"), False the per-leaf exchange, and None (the
    default, as in the reference) the policy's own flag: the per-leaf
    exchange for the default ``sbc`` policy.  A non-f32
    ``cfg.residual_dtype`` or leaf takes the per-leaf exchange either way.

    ``opts``: the reference's launch options, a subset of :data:`OPTS`:
    ``"lean_moe"`` (bf16 MoE combine, capacity factor ≤ 1) and
    ``"seq_every2"`` (the sequence hint on every second block, which
    places activations only and changes nothing here).

    State = ``{'params', 'opt', 'residual'}`` (one rank a device: this
    device's blocks; ``params_to_tree`` and ``residual_to_tree`` give the
    whole trees); the batch is this client's, with a leading client axis
    of 1 (one rank a device: the step takes its "data" share of the
    rows).  ``measure`` adds client 0's
    transmitted ΔW* to rank 0's metrics (``own_client0``) for wire
    metering; with ``device_pack`` too (exact engine) every rank's metrics
    also hold the packed bit counts of every (client, shard, row)
    (``packed_nbits``, gathered) and rank 0's hold client 0's packed word
    buffer (``packed_words_client0``).
    """
    if group is None:
        group = make_host_group(device)
    elif device is not None and torch.device(device) != group.device:
        raise ValueError(f"device {device} is not the group's {group.device}")
    if not set(opts) <= OPTS:
        raise ValueError(f"unknown launch options {sorted(set(opts) - OPTS)}; "
                         f"known {sorted(OPTS)}")
    device = group.device
    full_f32_math()
    model = model or build_model(cfg)
    sizes = axis_sizes(mesh_shape) if mesh_shape is not None else default_layout(group.world)
    n_clients, client_axes = client_topology(cfg, sizes)
    shard_axes = tuple(a for a in sizes if a not in client_axes)
    client_grid = tuple(sizes[a] for a in client_axes)
    n_dev = math.prod(sizes[a] for a in shard_axes)
    opt_kw = {} if cfg.local_opt == "sgd" else {"state_dtype": cfg.residual_dtype}
    opt = get_optimizer(cfg.local_opt, **opt_kw)

    if policy is None:
        default = "sbc" if compressor == "sbc" else "dense"
        policy = CompressionPolicy.single(make_codec(default), name=compressor)
    treedef, specs, leaves, blocks = _leaf_plan(cfg, model, sizes, client_axes, shard_axes,
                                                policy, sparsity)
    check_clients(sizes, client_axes, group.world)
    sharded = group.world != n_clients  # one rank a device
    ranks = group.device_ranks(sizes, client_axes) if sharded else None
    xgroup = ranks.exchange if sharded else group  # the ranks the exchange crosses
    want_fast = policy.fast if fast is None else bool(fast)
    space = None
    if (want_fast and cfg.residual_dtype == torch.float32
            and all(gl.dtype == torch.float32 for gl in leaves)):
        space = _flat_space(leaves, specs, blocks, sizes, client_axes, shard_axes, n_clients,
                            xgroup, ranks.device if sharded else None)
    channel = ShardedGspmdChannel(
        leaves=leaves, client_axes=client_axes, n_clients=n_clients,
        residual_dtype=cfg.residual_dtype, flat_space=space, flat_engine=flat_engine,
        device_pack=device_pack, group=xgroup, client_grid=client_grid, rank_blocks=sharded,
    )
    bits = channel.bits()

    def init_state(gen: torch.Generator) -> dict:
        if sharded:  # this rank's blocks, cut as the model draws them (hints.drawn)
            with hints.cut_params(_cut_as_drawn(blocks, ranks.device)):
                params = model.init(gen)
            for v, gl, lb in zip(tree_flatten(params)[0], leaves, blocks):
                want = tuple(d // g for d, g in zip(gl.global_shape, lb.grid))
                if tuple(v.shape) != want:
                    raise ValueError(f"{gl.path}: drawn as {tuple(v.shape)}, not its block "
                                     f"{want}: a sharded leaf passes hints.drawn in the init")
        else:
            params = model.init(gen)
        params = tree_map(lambda v: v.to(device), params)
        return {
            "params": params,
            "opt": map_states(lambda v: v[0][None].clone(), [opt.init(params)]),
            "residual": channel.init_state(params),
        }

    need_mask = cfg.local_opt != "sgd"  # momentum masking needs ΔW*_i
    need_own = need_mask or measure
    n_data = sizes["data"] if "data" in shard_axes else 1

    def rank_rows(v: torch.Tensor) -> torch.Tensor:
        """This rank's "data" share of its client's rows (one rank a
        device; the ranks along "model" take the same rows)."""
        if v.shape[0] % n_data:
            raise ValueError(f"a batch of {v.shape[0]} rows does not split over the "
                             f"{n_data} 'data' ranks of a client")
        n, d = v.shape[0] // n_data, ranks.coords["data"] if n_data > 1 else 0
        return v[d * n:(d + 1) * n]

    def step(state: dict, batch: dict) -> tuple:
        stages = channel.telemetry.stages  # build_run may swap in an enabled clock
        with stages.stage("train.step"):
            params = state["params"]
            leaves_p = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
            rows = tree_map(lambda v: v[0], batch)
            shards = RankShards(ranks, leaves_p, blocks, remat=cfg.remat) if sharded else None
            with hints.sharded_params(shards):
                with stages.stage("train.forward"):
                    loss = model.loss_fn(treedef.unflatten(leaves_p),
                                         tree_map(rank_rows, rows) if sharded else rows)
                    if sharded:
                        shards.check_every_leaf_used()
                with stages.stage("train.backward"):
                    grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves_p)))
            with torch.no_grad():
                with stages.stage("train.optimizer"):
                    p2, opt_state = opt.apply(map_states(lambda v: v[0][0], [state["opt"]]),
                                              grads, params, cfg.base_lr, 0)
                    deltas = tree_map(
                        lambda a, b: (a.to(torch.float32) - b.to(torch.float32))
                        .to(cfg.residual_dtype)[None], p2, params)
                with stages.stage("train.exchange"):
                    out = channel.round_exchange(state["residual"], deltas, need_own=need_own)
                mean_tree, new_residual, own_tree = out[:3]
                with stages.stage("train.apply"):
                    # every client reconstructs the identical mean
                    new_params = tree_map(
                        lambda p, m: (p.to(torch.float32) + m[0].to(torch.float32)).to(p.dtype),
                        params, mean_tree)
                    opt_state = map_states(lambda v: v[0][None], [opt_state])
                    if need_mask:
                        transmitted = tree_map(lambda o: (o != 0).to(torch.float32), own_tree)
                        opt_state = opt.mask(opt_state, transmitted)
                    loss = loss.detach().reshape(())
                    if sharded:  # the client's loss: the mean over its "data" ranks
                        loss = ranks.data.pmean(loss)
                    metrics = {"loss": f32_mean_xla(xgroup.all_gather_rows(loss))}
                if measure:
                    metrics.update(_metered(out, own_tree))
            return {"params": new_params, "opt": opt_state, "residual": new_residual}, metrics

    def _metered(out, own_tree) -> dict:
        """Rank 0's client-0 ΔW* (and packed words), whole; with
        ``device_pack`` every rank's ``packed_nbits`` of every (client,
        device, row).  Collectives: every rank calls this."""
        got = {}
        words = None
        if device_pack:
            words, nbits = out[3]
            if sharded:  # every device's row, in (client, device) order
                every = group.all_gather_rows(nbits[0, 0])
                got["packed_nbits"] = every[list(ranks.world_order)].reshape(
                    n_clients, n_dev, -1)
            else:
                got["packed_nbits"] = group.all_gather_rows(nbits[0])
        own0 = tree_map(lambda o: o[0], own_tree)
        if sharded and ranks.client == 0:  # client 0's blocks from its ranks
            own0 = assemble_tree(ranks, own0, blocks)
            if device_pack:
                words = ranks.client_ranks.all_gather_rows(words[0, 0])[None]
        if group.rank == 0:
            # client 0's transmitted ΔW* (and packed words), for wire metering
            got["own_client0"] = own0
            if device_pack:
                got["packed_words_client0"] = words[0]
        return got

    def hinted():
        return hints.activation_sharding(
            sizes, batch_axes=("data",) if cfg.client_mode == "pod" else None,
            seq_axis="model", expert_axis="data" if cfg.moe_dispatch == "flat_ep" else None,
            seq_every=2 if "seq_every2" in opts else 1, lean_moe="lean_moe" in opts)

    def train_step(state: dict, batch: dict) -> tuple:
        with hinted():
            return step(state, batch)

    def eval_loss(params: dict, batch: dict) -> torch.Tensor:
        """The mean loss of ``batch`` (no client axis) at ``params``, no
        gradient.  One rank a device: each rank takes its "data" share of
        the rows, the model gathers each leaf at its use, and the loss is
        the mean over the client's "data" ranks, as the step's; every
        rank calls it."""
        leaves_p = tree_flatten(params)[0]
        shards = RankShards(ranks, leaves_p, blocks) if sharded else None
        with torch.no_grad(), hinted(), hints.sharded_params(shards):
            loss = model.loss_fn(treedef.unflatten(leaves_p),
                                 tree_map(rank_rows, batch) if sharded else batch)
            loss = loss.reshape(())
            return ranks.data.pmean(loss) if sharded else loss

    def params_to_tree(params: dict) -> dict:
        """The whole params: gathered over the client's ranks with one rank
        a device (a collective), else ``params`` itself."""
        return assemble_tree(ranks, params, blocks) if sharded else params

    def whole(v: torch.Tensor, lb: LeafBlocks) -> torch.Tensor:
        """A leaf whole from this rank's block (one rank a device: a
        collective of the client's ranks)."""
        if not sharded or math.prod(lb.grid) == 1:
            return v
        return assemble(ranks.client_ranks.gather_list(v), lb.grid, lb.dev_block)

    def state_to_host(state: dict) -> Optional[dict]:
        """The global state as the reference's GSPMD backend holds it: the
        params whole, and every client's optimizer and residual rows in
        client order (a leading axis of C; the flat residual ``(C,
        shards_per_client, n_pad)``), as CPU tensors on rank 0 and None on
        every other rank.  A collective of every rank, one leaf at a time,
        so no second whole copy of the state stays on the card."""
        host = group.rank == 0

        def keep(v: torch.Tensor):
            return v.detach().cpu() if host else None

        def rows(tree):  # a tree of the params' structure, leaves (1,) + block
            return treedef.unflatten([keep(xgroup.all_gather_rows(whole(v[0], lb)))
                                      for v, lb in zip(treedef.flatten_up_to(tree), blocks)])

        params = treedef.unflatten([keep(whole(v, lb))
                                    for v, lb in zip(tree_flatten(state["params"])[0], blocks)])
        opt_state = state["opt"]  # Adam's (m, v), a momentum tree or SGD's ()
        if isinstance(opt_state, AdamState):
            opt_state = AdamState(rows(opt_state.m), rows(opt_state.v))
        elif opt_state != ():
            opt_state = rows(opt_state)
        res = state["residual"]
        if space is not None:
            flat = res[0]  # (shards on this rank, n_pad)
            if sharded:
                flat = torch.cat(ranks.client_ranks.gather_list(flat))
            residual = keep(xgroup.all_gather_rows(flat))
        else:
            residual = rows(res)
        return {"params": params, "opt": opt_state, "residual": residual} if host else None

    residual_to_tree = None
    if space is not None or sharded:
        def residual_to_tree(res) -> dict:
            """The residual as the per-leaf stacked tree the per-leaf path
            stores (views with one device a client, else copies), whole
            (gathered over the client's ranks with one rank a device)."""
            if space is not None:
                tree = treedef.unflatten(space.unflatten_local(res[0].reshape(space.local_shape)))
            else:
                tree = tree_map(lambda v: v[0], res)
            return tree_map(lambda b: b[None], params_to_tree(tree))

    return DistTrainFns(
        train_step=train_step, init_state=init_state,
        bits_per_client=bits.per_client, bits_dense=bits.dense,
        flat_space=space, residual_to_tree=residual_to_tree, channel=channel,
        params_to_tree=params_to_tree, client=ranks.client if sharded else group.rank,
        ranks=ranks, blocks=blocks, eval_loss=eval_loss, state_to_host=state_to_host,
    )


def make_dist_train(cfg: ModelConfig, *, group: Optional[ClientGroup] = None,
                    compressor: str = "sbc", sparsity: float = 0.001,
                    policy: Optional[CompressionPolicy] = None, model: Optional[Model] = None,
                    opts: frozenset = frozenset(), fast: Optional[bool] = None,
                    flat_engine: str = "exact", mesh_shape: Optional[dict] = None,
                    device=None) -> DistTrainFns:
    """Legacy name for :func:`build_dist_train`, kept as a shim: it warns
    with a ``DeprecationWarning`` and returns ``build_dist_train``'s
    result for the same arguments.  New code builds the backend through
    ``repro_torch.run.build_run(RunSpec(backend="gspmd", ...))`` or calls
    :func:`build_dist_train`.  ``group`` and ``mesh_shape`` stand for the
    reference's ``mesh``."""
    warnings.warn(
        "make_dist_train() is the legacy GSPMD surface; build it declaratively via "
        "repro_torch.run.build_run(RunSpec(backend='gspmd', ...)) or call "
        "repro_torch.launch.dist.build_dist_train() (the same step)",
        DeprecationWarning, stacklevel=2)
    return build_dist_train(cfg, group=group, compressor=compressor, sparsity=sparsity,
                            policy=policy, model=model, opts=opts, fast=fast,
                            flat_engine=flat_engine, mesh_shape=mesh_shape, device=device)


def _leaf_plan(cfg: ModelConfig, model: Model, sizes: dict, client_axes: tuple,
               shard_axes: tuple, policy: CompressionPolicy, sparsity: float) -> tuple:
    """``(treedef, specs, leaves, blocks)``: the params' tree, each leaf's
    spec, :class:`GspmdLeaf` and :class:`LeafBlocks` (its device → block
    map), in JAX's leaf order with its "a/b" paths; from the shapes drawn on
    the meta device, so nothing is allocated."""
    with torch.device("meta"):
        meta_params = model.init(torch.Generator())
    flat_p, treedef = tree_flatten_with_path(meta_params)
    specs = treedef.flatten_up_to(make_param_specs(
        meta_params, sizes, fsdp=cfg.fsdp,
        expert_parallel=cfg.moe_dispatch in ("flat_ep", "grouped")))
    keys = [path_str(path) for path, _ in flat_p]
    _refuse_client_axes(keys, specs, sizes, client_axes)
    plans = [policy.plan_for(k) for k in keys]
    scheduled = [pl.path for pl in plans if pl.schedule is not None]
    if scheduled:
        raise NotImplementedError(
            "the GSPMD backend fixes per-leaf sparsity rates when the step is "
            f"built; policy rules attach per-round schedules to {scheduled[:3]}…"
        )
    leaves = tuple(
        GspmdLeaf(path=k, global_shape=tuple(v.shape), dtype=v.dtype,
                  scanned="stack/scan" in k, mode=dist_leaf_mode(pl.codec),
                  rate=pl.rate(sparsity, 0), n_shards=_shards_of(spec, sizes),
                  shard_grid=_shard_grid(tuple(v.shape), spec, sizes))
        for k, (_, v), pl, spec in zip(keys, flat_p, plans, specs)
    )
    blocks = tuple(LeafBlocks(grid=gl.shard_grid, path=gl.path,
                              dev_block=_device_blocks(gl.global_shape, spec, sizes, shard_axes))
                   for gl, spec in zip(leaves, specs))
    return treedef, specs, leaves, blocks


def _refuse_client_axes(keys: list, specs: list, sizes: dict, client_axes: tuple) -> None:
    """``ValueError`` where a leaf's spec cuts it over a client axis of more
    than one coordinate: a leaf is whole on every client."""
    for k, spec in zip(keys, specs):
        used = {ax for entry in spec for ax in _axes_of(entry)
                if ax in client_axes and sizes[ax] > 1}
        if used:
            raise ValueError(f"{k}: its spec {spec} cuts the leaf over the client axes "
                             f"{sorted(used)}: a leaf is whole on every client")


def _cut_as_drawn(blocks, device: int) -> Callable:
    """The cut of :func:`repro_torch.models.hints.cut_params`: device
    ``device``'s blocks (:class:`LeafBlocks`, the params' leaves) of the
    leaves of a tree just drawn at ``at``."""
    by_path = {lb.path: lb for lb in blocks}

    def cut(tree, at: str, scanned: bool):
        flat, tdef = tree_flatten_with_path(tree)
        out = []
        for path, v in flat:
            lb = by_path["/".join(p for p in (at, path_str(path)) if p)]
            out.append(block_of(v, lb.grid[1:] if scanned else lb.grid, lb.dev_block[device]))
        return tdef.unflatten(out)

    return cut


def _flat_space(leaves, specs, blocks, sizes: dict, client_axes: tuple, shard_axes: tuple,
                n_clients: int, group, device: Optional[int]) -> ShardedFlatParamSpace:
    """The §11 flat space of a client's devices (``device`` None: all of
    them, one rank a client) or of device ``device`` alone (one rank a
    device)."""
    entries = []
    for gl, spec, lb in zip(leaves, specs, blocks):
        local = _local_shape(gl.global_shape, spec, sizes)
        entries.append(dict(
            path=gl.path, shape=local,
            rows=local[0] if gl.scanned and len(local) > 1 else 1,
            kind=gl.mode, rate=gl.rate, n_shards=gl.n_shards,
            global_size=int(torch.Size(gl.global_shape).numel()), grid=gl.shard_grid,
            dev_block=lb.dev_block if device is None else (lb.dev_block[device],)))
    return ShardedFlatParamSpace.build(
        entries, client_axes=client_axes, shard_axes=shard_axes, n_clients=n_clients,
        shards_per_client=math.prod(sizes[a] for a in shard_axes) if device is None else 1,
        group=group, client_grid=tuple(sizes[a] for a in client_axes),
    )


def device_flat_space(cfg: ModelConfig, mesh_shape: dict, *, sparsity: float = 0.001,
                      device: int = 0, model: Optional[Model] = None) -> ShardedFlatParamSpace:
    """The flat space that the rank of device ``device`` holds with one
    rank a device of ``mesh_shape`` (every leaf SBC at ``sparsity``), as a
    plan: shapes from the meta device and no process group, for one
    device's padded length and the Eq. 1 bits at any depth."""
    sizes = axis_sizes(mesh_shape)
    n_clients, client_axes = client_topology(cfg, sizes)
    shard_axes = tuple(a for a in sizes if a not in client_axes)
    policy = CompressionPolicy.single(make_codec("sbc"), name="sbc")
    _, specs, leaves, blocks = _leaf_plan(cfg, model or build_model(cfg), sizes, client_axes,
                                          shard_axes, policy, sparsity)
    return _flat_space(leaves, specs, blocks, sizes, client_axes, shard_axes, n_clients,
                       make_host_group("cpu"), device)


# --------------------------------------------------------------- serve side


def _lead_spec(axes: tuple):
    """A spec entry over ``axes``: None, the one axis, or the tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


def _batch_axes(sizes: dict) -> tuple:
    """``(("pod", "data") present in the layout, their devices)``."""
    axes = tuple(a for a in ("pod", "data") if a in sizes)
    return axes, math.prod(sizes[a] for a in axes)


def cache_specs(cfg: ModelConfig, layout: dict, caches) -> Any:
    """The decode caches' tree of specs on ``layout`` (axis name → size),
    the reference's rules (``repro.launch.dist.cache_specs``), an entry a
    dim (trailing ``None`` kept):

      * ``k``/``v``/``cross_k``/``cross_v`` ``(B, L, Hkv, hd)``: the batch
        over ("pod", "data") when it divides; the KV heads over "model"
        when they divide, else the cache's sequence (flash-decoding);
      * Mamba's ``h`` ``(B, di, N)``: the batch, then ``di`` over "model";
      * ``conv``/``tm_prev``/``cm_prev`` ``(B, w, ch)``: the batch, the
        channels (the last dim) over "model";
      * RWKV6's ``s`` ``(B, H, hs, hs)``: the batch, the heads over "model";
      * anything else (``pos``) replicated.

    A ``scan/`` leaf's leading superblock dim is never cut.  The leaves
    may live on the ``meta`` device: only shapes are read."""
    sizes = axis_sizes(layout)
    m = sizes.get("model", 1)
    b_axes, b_total = _batch_axes(sizes)
    b_spec = _lead_spec(b_axes)

    def spec_for(path: str, shape: tuple) -> tuple:
        off = 1 if path.startswith("scan/") else 0
        dims: list = [None] * len(shape)
        name = path.split("/")[-1]
        batch = name in ("k", "v", "cross_k", "cross_v", "h", "conv", "tm_prev", "cm_prev", "s")
        if batch and b_axes and shape[off] % b_total == 0:
            dims[off] = b_spec
        if name in ("k", "v", "cross_k", "cross_v"):
            if shape[off + 2] % m == 0:
                dims[off + 2] = "model"
            elif shape[off + 1] % m == 0:
                dims[off + 1] = "model"
        elif name in ("h", "s") and shape[off + 1] % m == 0:
            dims[off + 1] = "model"
        elif name in ("conv", "tm_prev", "cm_prev") and shape[-1] % m == 0:
            dims[-1] = "model"
        return tuple(dims)

    flat, treedef = tree_flatten_with_path(caches)
    return treedef.unflatten([spec_for(path_str(p), tuple(v.shape)) for p, v in flat])


class _RankParams(NamedTuple):
    """One rank a device of a serving layout: its sub-groups and its blocks
    of the params by ``Model.param_specs``."""

    sizes: dict
    ranks: Any  # DeviceRanks
    treedef: Any
    param_specs: Any  # the params' tree of specs
    blocks: tuple  # each leaf's LeafBlocks, tree order
    init_params: Callable
    params_from_tree: Callable
    rows: Callable  # a batch leaf → this rank's rows (whole where they do not divide)


def _rank_params(cfg: ModelConfig, model: Model, group: Optional[ClientGroup],
                 mesh_shape: Optional[dict], device) -> _RankParams:
    if group is None:
        group = make_host_group(device)
    elif device is not None and torch.device(device) != group.device:
        raise ValueError(f"device {device} is not the group's {group.device}")
    sizes = axis_sizes(mesh_shape) if mesh_shape is not None else default_layout(group.world)
    if group.world != math.prod(sizes.values()):
        raise ValueError(f"serving on {sizes} takes one rank a device, "
                         f"{math.prod(sizes.values())} ranks; the group has {group.world}")
    _, client_axes = client_topology(cfg, sizes)
    shard_axes = tuple(a for a in sizes if a not in client_axes)
    with torch.device("meta"):
        meta = model.init(torch.Generator())
    flat, treedef = tree_flatten_with_path(meta)
    specs = treedef.flatten_up_to(model.param_specs(meta, sizes))
    _refuse_client_axes([path_str(p) for p, _ in flat], specs, sizes, client_axes)
    blocks = tuple(LeafBlocks(grid=_shard_grid(tuple(v.shape), spec, sizes), path=path_str(p),
                              dev_block=_device_blocks(tuple(v.shape), spec, sizes, shard_axes))
                   for (p, v), spec in zip(flat, specs))
    ranks = group.device_ranks(sizes, client_axes)

    def init_params(gen: torch.Generator) -> dict:
        """This rank's blocks of the params drawn from ``gen`` (the whole
        model's draws, each leaf cut as it is drawn), on the group's
        device."""
        with hints.cut_params(_cut_as_drawn(blocks, ranks.device)):
            params = model.init(gen)
        return tree_map(lambda v: v.to(group.device), params)

    def params_from_tree(params: dict) -> dict:
        """This rank's blocks (copies) of the whole ``params``."""
        return treedef.unflatten([block_of(v, lb.grid, lb.dev_block[ranks.device])
                                  for v, lb in zip(treedef.flatten_up_to(params), blocks)])

    b_axes, b_total = _batch_axes(sizes)
    at = ranks.batch.rank  # the row-major ("pod", "data") coordinate

    def rows(v: torch.Tensor) -> torch.Tensor:
        if v.shape[0] % b_total:
            return v
        n = v.shape[0] // b_total
        return v[at * n:(at + 1) * n]

    return _RankParams(sizes=sizes, ranks=ranks, treedef=treedef,
                       param_specs=treedef.unflatten(specs), blocks=blocks,
                       init_params=init_params,
                       params_from_tree=params_from_tree, rows=rows)


def _serving(rp: _RankParams, params: dict, cut_rows: bool) -> RankShards:
    """A step's forward-only :class:`RankShards` on this rank's blocks
    ``params``; the MoE's statistics and slots cover the batch's ranks
    where the rows are cut (``cut_rows``), this rank's rows elsewhere."""
    rows = rp.ranks.batch if cut_rows else ClientGroup(rank=0, world=1,
                                                        device=rp.ranks.batch.device)
    return RankShards(rp.ranks, rp.treedef.flatten_up_to(params), rp.blocks, rows=rows)


class DistServeFns(NamedTuple):
    serve_step: Callable  # (params, tokens (B, 1), caches, pos) → (logits (B, 1, V) f32, caches)
    init_params: Callable  # generator → this rank's blocks of the params
    params_from_tree: Callable  # the whole params → this rank's blocks
    caches_from_tree: Callable  # the whole caches → this rank's blocks
    abstract_caches: Any  # the whole caches, on the meta device
    cache_specs: Any  # their specs (:func:`cache_specs`)
    param_specs: Any  # the params' (``Model.param_specs``)
    ranks: Any  # this rank's DeviceRanks
    rows: Callable  # a batch leaf → this rank's rows (whole where they do not divide)


def make_dist_serve(cfg: ModelConfig, *, group: Optional[ClientGroup] = None, batch: int,
                    seq_len: int, mesh_shape: Optional[dict] = None,
                    model: Optional[Model] = None, device=None) -> DistServeFns:
    """This rank's one-token decode step against ``seq_len``-deep caches of
    ``batch`` rows, with one rank a device of ``mesh_shape`` (the group's
    world must be its device count; ``ValueError`` otherwise; default
    ``{"data": world, "model": 1}``).

    Each rank holds its device's blocks of the params (``Model.
    param_specs``, gathered at their use over the client's ranks, as the
    train step's, and dropped after it) and of the caches
    (:func:`cache_specs`), and steps its ("pod", "data") share of the rows;
    a batch that does not divide over those axes is served whole on every
    rank.  ``serve_step`` takes the whole ``(B, 1)`` tokens and returns
    the whole ``(B, 1, V)`` f32 logits on every rank (the batch's rows
    gathered over the ranks of this "model" coordinate), so every rank
    picks the same next token, and this rank's blocks of the new caches.
    The reference's ``activation_sharding(mesh, batch_axes=None,
    seq_axis=None)`` is installed around the step."""
    model = model or build_model(cfg)
    rp = _rank_params(cfg, model, group, mesh_shape, device)
    with torch.device("meta"):
        abstract = model.init_caches(model.init(torch.Generator()), batch, seq_len)
    c_specs = cache_specs(cfg, rp.sizes, abstract)
    flat_c, c_def = tree_flatten_with_path(abstract)
    cross_seq = any(path_str(p).endswith("cross_k") and "model" in _axes_of(spec[-3])
                    for (p, _), spec in zip(flat_c, c_def.flatten_up_to(c_specs)))
    cut = CacheCut(rp.ranks.model, cross_seq) if rp.sizes.get("model", 1) > 1 else None
    whole_rows = batch % _batch_axes(rp.sizes)[1] != 0

    def serve_step(params: dict, tokens: torch.Tensor, caches, pos: int) -> tuple:
        shards = _serving(rp, params, not whole_rows)
        with torch.no_grad(), hints.activation_sharding(rp.sizes, batch_axes=None,
                                                        seq_axis=None):
            with hints.sharded_params(shards), hints.sharded_caches(cut):
                logits, new = model.decode_step(params, tokens if whole_rows else
                                                rp.rows(tokens), caches, pos)
            shards.check_every_leaf_used(unread=("encoder/",))
            if not whole_rows:
                logits = torch.cat(rp.ranks.batch.gather_list(logits), dim=0)
        return logits, new

    def caches_from_tree(caches):
        return cut_tree(caches, c_specs, rp.sizes, rp.ranks.coords)

    return DistServeFns(serve_step=serve_step, init_params=rp.init_params,
                        params_from_tree=rp.params_from_tree, caches_from_tree=caches_from_tree,
                        abstract_caches=abstract, cache_specs=c_specs,
                        param_specs=rp.param_specs, ranks=rp.ranks, rows=rp.rows)


class DistPrefillFns(NamedTuple):
    prefill: Callable  # (params, batch) → (this rank's hidden rows, its blocks of the caches)
    init_params: Callable
    params_from_tree: Callable
    param_specs: Any
    ranks: Any
    rows: Callable  # a batch leaf → this rank's rows (whole where they do not divide)


def make_dist_prefill(cfg: ModelConfig, *, group: Optional[ClientGroup] = None,
                      mesh_shape: Optional[dict] = None, model: Optional[Model] = None,
                      device=None) -> DistPrefillFns:
    """This rank's full-sequence prefill (the ``prefill_32k`` unit) with one
    rank a device of ``mesh_shape``, as :func:`make_dist_serve`.
    ``prefill`` takes the whole batch; every leaf (``tokens``, ``prefix``,
    ``enc_frames``, ``enc_tokens``) is cut on its leading dim over ("pod",
    "data") where it divides, as the reference's ``batch_shardings``.  It
    returns this rank's rows of the final hidden state and its blocks of
    the caches by :func:`cache_specs`: the cut :func:`make_dist_serve`
    takes at the same depth.  The ranks of one ("pod", "data") coordinate
    compute its rows whole, and each keeps its "model" blocks.  The
    reference's ``activation_sharding(mesh, batch_axes=("pod", "data"),
    seq_axis="model")`` is installed around it."""
    model = model or build_model(cfg)
    rp = _rank_params(cfg, model, group, mesh_shape, device)
    b_axes, _ = _batch_axes(rp.sizes)
    # the rows are this rank's already: the batch axes cut nothing more
    flat_sizes = {a: 1 if a in b_axes else n for a, n in rp.sizes.items()}
    flat_coords = {a: 0 if a in b_axes else c for a, c in rp.ranks.coords.items()}

    def prefill(params: dict, batch: dict) -> tuple:
        mine = tree_map(rp.rows, batch)
        cut_rows = mine["tokens"].shape[0] != batch["tokens"].shape[0]
        shards = _serving(rp, params, cut_rows)
        with torch.no_grad(), hints.activation_sharding(rp.sizes, batch_axes=b_axes,
                                                        seq_axis="model"):
            with hints.sharded_params(shards):
                hidden, caches = model.prefill(params, mine)
            shards.check_every_leaf_used(unread=("head/",))  # an untied head makes no hidden
            return hidden, cut_tree(caches, cache_specs(cfg, rp.sizes, caches), flat_sizes,
                                    flat_coords)

    return DistPrefillFns(prefill=prefill, init_params=rp.init_params,
                          params_from_tree=rp.params_from_tree, param_specs=rp.param_specs,
                          ranks=rp.ranks, rows=rp.rows)


# -------------------------------------------------------------- launcher


def build_parser():
    """Thin parser over the shared RunSpec surface, pinned to gspmd, with
    the reference's defaults (``tiny``, 10 rounds) and ``--device``."""
    import argparse

    from repro_torch.run.flags import add_run_flags

    ap = argparse.ArgumentParser(
        description="GSPMD DSGD launcher (one client per process, or one device of a pod-mode "
        "preset's client; start N of them with torchrun --nproc-per-node N)")
    add_run_flags(ap, backend="gspmd", preset="tiny", rounds=10, log_every=5)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the plain versions")
    return ap


def main(argv=None):
    """``python -m repro_torch.launch.dist``: the reference's output lines,
    printed by rank 0."""
    from repro_torch.run.build import build_run
    from repro_torch.run.flags import spec_from_args

    args = build_parser().parse_args(argv)
    spec = spec_from_args(args, backend="gspmd")
    run = build_run(spec, device=args.device)
    try:
        if run.group.rank != 0:
            run.run()
            return None
        print(f"gspmd: {run.n_clients} clients over {run.group.world} process(es)"
              + (" (one a device)" if run.fns.ranks is not None else "") + ", "
              f"p={spec.sparsity}, fast={spec.fast}, "
              f"bits/client/round={run.fns.bits_per_client:.3e} "
              f"(dense {run.fns.bits_dense:.3e}), device={run.device}")
        state, hist = run.run(log_every=args.log_every)
        print(f"loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}  "
              f"compression ×{hist['compression_rate']:.0f}")
        if spec.measure_wire:
            run.ledger.reconcile(rel=0.1)
            t = run.ledger.totals()
            print(f"wire: up {t['up_bytes']/1e3:.1f} kB (measured/analytic "
                  f"×{t['up_bits_measured']/max(t['up_bits_analytic'], 1):.3f})")
        if spec.telemetry:
            from repro_torch.obs import finish_run

            finish_run(run.telemetry, trace=args.trace, metrics_out=args.metrics_out,
                       meta={"backend": "gspmd", "preset": spec.preset,
                             "rounds": spec.rounds})
        if args.history:
            import json
            import os

            os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
            with open(args.history, "w") as f:
                json.dump(hist, f, default=float)
        return hist
    finally:
        run.group.close()


if __name__ == "__main__":
    main()
