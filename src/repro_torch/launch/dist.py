"""The GSPMD backend's DSGD train step, on one card.

Counterpart of ``repro.launch.dist`` (DESIGN.md §4).  The reference builds
its step on a mesh; on one device that mesh is
``Mesh(devices.reshape(1, 1), ("data", "model"))``, which gives one client
on the "data" axis and a size-1 "model" axis.  This slice ports exactly
that topology with the §11 flat fast path and the hist engine, where every
leaf is SBC-compressed and the residual is f32.  ``repro_torch.run.build_run``
refuses every other combination (more clients over ``torch.distributed``,
the per-leaf and exact exchanges, other codecs) with
``NotImplementedError`` naming the ROADMAP item that brings it.

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
from repro_torch.core.channel import GspmdLeaf, ShardedGspmdChannel, tree_keys
from repro_torch.core.flat import ShardedFlatParamSpace
from repro_torch.device import resolve_device
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import AdamState, get_optimizer


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
    residual_to_tree: Callable  # flat residual → {leaf: (1,)+shape}
    channel: Any  # the ShardedGspmdChannel driving the exchange


def _zip_states(fn, states):
    """Apply ``fn`` to the list of matching leaves of several optimizer
    states (Adam's ``(m, v)``, a momentum dict, or SGD's ``()``)."""
    s0 = states[0]
    if isinstance(s0, AdamState):
        return AdamState(_zip_states(fn, [s.m for s in states]),
                         _zip_states(fn, [s.v for s in states]))
    return {k: fn([s[k] for s in states]) for k in s0} if s0 else s0


def build_dist_train(
    cfg: ModelConfig,
    *,
    sparsity: float = 0.001,
    model: Optional[Model] = None,
    device=None,
) -> DistTrainFns:
    """Build the DSGD train step for ``cfg`` on one device: the reference's
    ``compressor='sbc', fast=True, flat_engine='hist'`` route.

    State = ``{'params', 'opt', 'residual'}``; the batch has a leading
    client axis of size ``client_topology(cfg)[0]`` (1 here).
    """
    device = resolve_device(device)
    model = model or build_model(cfg)
    n_clients, client_axes = client_topology(cfg)
    opt = get_optimizer(cfg.local_opt)

    # leaf plan from the parameter shapes (every leaf replicated: one shard)
    shapes = {k: tuple(v.shape) for k, v in model.init(torch.Generator()).items()}
    keys = tree_keys(shapes)
    leaves = tuple(
        GspmdLeaf(path=k, global_shape=shapes[k], dtype=torch.float32,
                  scanned="stack/scan" in k, mode="sparse", rate=float(sparsity),
                  n_shards=1, shard_grid=(1,) * len(shapes[k]))
        for k in keys
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
        flat_space=space,
    )
    bits = channel.bits()

    def init_state(gen: torch.Generator) -> dict:
        params = {k: v.to(device) for k, v in model.init(gen).items()}
        return {
            "params": params,
            "opt": _zip_states(lambda v: v[0].expand((n_clients,) + v[0].shape).clone(),
                               [opt.init(params)]),
            "residual": channel.init_state(params),
        }

    need_mask = cfg.local_opt != "sgd"  # momentum masking needs ΔW*_i

    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        deltas, opt_states, losses = [], [], []
        for c in range(n_clients):
            leaves_c = {k: p.detach().requires_grad_(True) for k, p in params.items()}
            loss = model.loss_fn(leaves_c, {k: v[c] for k, v in batch.items()})
            grads = dict(zip(keys, torch.autograd.grad(loss, [leaves_c[k] for k in keys])))
            with torch.no_grad():
                p2, os2 = opt.apply(_zip_states(lambda v: v[0][c], [state["opt"]]),
                                    grads, params, cfg.base_lr, 0)
                deltas.append({
                    k: p2[k].to(torch.float32) - params[k].to(torch.float32)
                    for k in keys
                })
            opt_states.append(os2)
            losses.append(loss.detach())

        with torch.no_grad():
            stacked = {k: torch.stack([d[k] for d in deltas]) for k in keys}
            mean_tree, new_residual, own_tree = channel.round_exchange(
                state["residual"], stacked, need_own=need_mask
            )
            # every client reconstructs the identical mean; take client 0
            new_params = {
                k: (params[k].to(torch.float32) + mean_tree[k][0].to(torch.float32)
                    ).to(params[k].dtype)
                for k in keys
            }
            opt_state = _zip_states(torch.stack, opt_states)
            if need_mask:
                transmitted = {k: (o != 0).to(torch.float32) for k, o in own_tree.items()}
                opt_state = opt.mask(opt_state, transmitted)
            metrics = {"loss": torch.stack(losses).mean()}
        return {"params": new_params, "opt": opt_state, "residual": new_residual}, metrics

    def residual_to_tree(flat_res: torch.Tensor) -> dict:
        """The flat residual as the per-leaf stacked dict the per-leaf
        path stores (views, no copy)."""
        return {k: b[None] for k, b in zip(keys, space.unflatten_local(flat_res[0, 0]))}

    return DistTrainFns(
        train_step=train_step, init_state=init_state,
        bits_per_client=bits.per_client, bits_dense=bits.dense,
        flat_space=space, residual_to_tree=residual_to_tree, channel=channel,
    )
