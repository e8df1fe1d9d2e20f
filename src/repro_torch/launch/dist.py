"""The GSPMD backend's DSGD train step, on one card.

Counterpart of ``repro.launch.dist`` (DESIGN.md §4).  The reference builds
its step on a mesh; on one device that mesh is
``Mesh(devices.reshape(1, 1), ("data", "model"))``, which gives one client
on the "data" axis and a size-1 "model" axis.  The port carries exactly
that topology with the §11 flat fast path, the exact engine (optionally
with the device-packed Golomb wire) or the hist engine, and an f32
residual.  A per-leaf policy maps each leaf to one of the exchange's
three modes (:func:`dist_leaf_mode`: SBC, dense, skip); the hist engine
takes all-SBC policies only (its flat space raises ``ValueError``
otherwise, as the reference's does).  ``repro_torch.run.build_run``
refuses every other combination (more clients over ``torch.distributed``,
the per-leaf exchange, other codecs) with ``NotImplementedError`` naming
the ROADMAP item that brings it.

Behaviour of the reference that the step reproduces as it is:

  * Adam is applied with ``step=0`` every round, so its bias correction
    always uses ``t = 1``;
  * the step uses ``cfg.base_lr`` (a RunSpec's ``lr`` is not read) and
    takes one local step per round (``delay`` is not read);
  * after the exchange, momentum (Adam's ``m``) is zeroed where the
    client's own ΔW* is non-zero;
  * the applied update is client 0's row of the mean, and the loss metric
    is the mean over clients.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.channel import GspmdLeaf, ShardedGspmdChannel
from repro_torch.core.codec import Codec, make_codec
from repro_torch.core.flat import ShardedFlatParamSpace
from repro_torch.core.policy import CompressionPolicy, path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import get_optimizer, map_states


def client_topology(cfg: ModelConfig) -> tuple[int, tuple[str, ...]]:
    """(n_clients, client axes) of the one-device topology: a size-1
    "data" axis and a size-1 "model" axis."""
    if cfg.client_mode == "pod":
        return 1, ()  # the in-process topology has no "pod" axis
    return 1, ("data",)


class DistTrainFns(NamedTuple):
    train_step: Callable  # (state, batch) -> (state, metrics)
    init_state: Callable  # generator -> state
    bits_per_client: float  # static Eq. 1 wire bits per round
    bits_dense: float
    flat_space: Any  # ShardedFlatParamSpace of the flat fast path
    residual_to_tree: Callable  # flat residual → the params' tree of (1,)+shape
    channel: Any  # the ShardedGspmdChannel driving the exchange


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
    sparsity: float = 0.001,
    policy: Optional[CompressionPolicy] = None,
    flat_engine: str = "exact",
    measure: bool = False,
    device_pack: bool = False,
    model: Optional[Model] = None,
    device=None,
) -> DistTrainFns:
    """Build the DSGD train step for ``cfg`` on one device: the reference's
    ``fast=True`` route with ``flat_engine`` ("exact" or "hist").

    ``policy``: an optional per-leaf :class:`CompressionPolicy` (path-regex
    rules): each leaf takes its plan's exchange mode
    (:func:`dist_leaf_mode`) and rate (``plan.rate(sparsity, 0)``).
    Without one, every leaf is SBC-compressed at ``sparsity``.  Rates are
    fixed when the step is built, so a policy with per-round schedules
    raises, as the reference's does.

    State = ``{'params', 'opt', 'residual'}``; the batch has a leading
    client axis of size ``client_topology(cfg)[0]`` (1 here).  ``measure``
    adds client 0's transmitted ΔW* to the metrics (``own_client0``) for
    wire metering; with ``device_pack`` (exact engine) also the packed
    bit counts of every (client, shard, row) (``packed_nbits``) and client
    0's packed word buffer (``packed_words_client0``).
    """
    device = resolve_device(device)
    model = model or build_model(cfg)
    n_clients, client_axes = client_topology(cfg)
    opt = get_optimizer(cfg.local_opt)

    if policy is None:
        policy = CompressionPolicy.single(make_codec("sbc"), name="sbc")

    # leaf plan from the parameter shapes (every leaf replicated: one
    # shard), in JAX's leaf order with its "a/b" paths
    flat_p, treedef = tree_flatten_with_path(model.init(torch.Generator()))
    keys = [path_str(path) for path, _ in flat_p]
    shapes = {k: tuple(v.shape) for k, (_, v) in zip(keys, flat_p)}
    plans = [policy.plan_for(k) for k in keys]
    scheduled = [pl.path for pl in plans if pl.schedule is not None]
    if scheduled:
        raise NotImplementedError(
            "the GSPMD backend fixes per-leaf sparsity rates when the step is "
            f"built; policy rules attach per-round schedules to {scheduled[:3]}…"
        )
    leaves = tuple(
        GspmdLeaf(path=k, global_shape=shapes[k], dtype=torch.float32,
                  scanned="stack/scan" in k, mode=dist_leaf_mode(pl.codec),
                  rate=pl.rate(sparsity, 0), n_shards=1,
                  shard_grid=(1,) * len(shapes[k]))
        for k, pl in zip(keys, plans)
    )
    space = ShardedFlatParamSpace.build(
        [dict(path=gl.path, shape=gl.global_shape,
              rows=gl.global_shape[0] if gl.scanned and len(gl.global_shape) > 1 else 1,
              kind=gl.mode, rate=gl.rate, n_shards=gl.n_shards,
              global_size=int(torch.Size(gl.global_shape).numel()))
         for gl in leaves],
        client_axes=client_axes, shard_axes=("model",), n_clients=n_clients,
        shards_per_client=1,
    )
    channel = ShardedGspmdChannel(
        leaves=leaves, client_axes=client_axes, n_clients=n_clients,
        flat_space=space, flat_engine=flat_engine, device_pack=device_pack,
    )
    bits = channel.bits()

    def init_state(gen: torch.Generator) -> dict:
        params = tree_map(lambda v: v.to(device), model.init(gen))
        return {
            "params": params,
            "opt": map_states(lambda v: v[0].expand((n_clients,) + v[0].shape).clone(),
                               [opt.init(params)]),
            "residual": channel.init_state(params),
        }

    need_mask = cfg.local_opt != "sgd"  # momentum masking needs ΔW*_i
    need_own = need_mask or measure

    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        deltas, opt_states, losses = [], [], []
        for c in range(n_clients):
            leaves_c = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
            loss = model.loss_fn(treedef.unflatten(leaves_c),
                                 tree_map(lambda v: v[c], batch))
            grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves_c)))
            with torch.no_grad():
                p2, os2 = opt.apply(map_states(lambda v: v[0][c], [state["opt"]]),
                                    grads, params, cfg.base_lr, 0)
                deltas.append(tree_map(
                    lambda a, b: a.to(torch.float32) - b.to(torch.float32), p2, params))
            opt_states.append(os2)
            losses.append(loss.detach())

        with torch.no_grad():
            stacked = tree_map(lambda *xs: torch.stack(xs), *deltas)
            out = channel.round_exchange(state["residual"], stacked,
                                         need_own=need_own)
            mean_tree, new_residual, own_tree = out[:3]
            # every client reconstructs the identical mean; take client 0
            new_params = tree_map(
                lambda p, m: (p.to(torch.float32) + m[0].to(torch.float32)).to(p.dtype),
                params, mean_tree)
            opt_state = map_states(torch.stack, opt_states)
            if need_mask:
                transmitted = tree_map(lambda o: (o != 0).to(torch.float32), own_tree)
                opt_state = opt.mask(opt_state, transmitted)
            metrics = {"loss": torch.stack(losses).mean()}
            if measure:
                # client 0's transmitted ΔW*, for host-side wire metering
                metrics["own_client0"] = tree_map(lambda o: o[0], own_tree)
                if device_pack:
                    # exact per-(client, shard, row) packed wire bits +
                    # client 0's packed word buffer
                    words, nbits = out[3]
                    metrics["packed_nbits"] = nbits
                    metrics["packed_words_client0"] = words[0]
        return {"params": new_params, "opt": opt_state, "residual": new_residual}, metrics

    def residual_to_tree(flat_res: torch.Tensor) -> dict:
        """The flat residual as the per-leaf stacked tree the per-leaf
        path stores (views, no copy)."""
        return treedef.unflatten([b[None] for b in space.unflatten_local(flat_res[0, 0])])

    return DistTrainFns(
        train_step=train_step, init_state=init_state,
        bits_per_client=bits.per_client, bits_dense=bits.dense,
        flat_space=space, residual_to_tree=residual_to_tree, channel=channel,
    )
