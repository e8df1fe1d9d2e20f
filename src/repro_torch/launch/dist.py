"""The GSPMD backend's DSGD train step, one client per process.

Counterpart of ``repro.launch.dist`` (DESIGN.md §4).  The reference builds
its step on a mesh ``Mesh(devices.reshape(-1, 1), ("data", "model"))``:
one client per device on the "data" axis and a size-1 "model" axis, the
exchange inside ``shard_map``.  The port runs one client per process: a
:class:`~repro_torch.launch.mesh.ClientGroup` gives the client index (its
rank) and the number of clients (its world), and every round's exchange
crosses the ranks over ``torch.distributed`` (NCCL on cards, gloo on the
CPU).  Each rank holds the reference's shard-local state: the params
(the same on every rank), its own row of the optimizer state and of the
residual (a leading client axis of 1).

The exchange is the §11 flat fast path (``fast=True``: the exact engine,
optionally with the device-packed Golomb wire, or the hist engine) or the
per-leaf exchange (``fast=False``, or a non-f32 ``residual_dtype``).  A
per-leaf policy maps each leaf to one of the exchange's three modes
(:func:`dist_leaf_mode`: SBC, dense, skip); the hist engine takes all-SBC
policies only (its flat space raises ``ValueError`` otherwise, as the
reference's does).  ``client_mode="pod"`` (granite-20b, command-r-35b,
mixtral, llama4, jamba) and a "model" axis larger than 1 come with ROADMAP
A12, part 3, item 6.
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
    (``jnp.mean`` of the gathered losses, in XLA's order).
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
from repro_torch.device import full_f32_math
from repro_torch.kernels.reduce import f32_mean_xla
from repro_torch.launch.mesh import ClientGroup, make_host_group
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import get_optimizer, map_states


def client_topology(cfg: ModelConfig, group: ClientGroup) -> tuple[int, tuple[str, ...]]:
    """(n_clients, client axes): one client per rank of ``group`` on the
    "data" axis."""
    if cfg.client_mode == "pod":
        raise NotImplementedError(
            "client_mode='pod' (one client per pod, dense all-reduce inside it) "
            "comes with ROADMAP A12, part 3, item 6 (the mode of the ≥20B decoders and "
            "of mixtral, llama4 and jamba)")
    return group.world, ("data",)


class DistTrainFns(NamedTuple):
    train_step: Callable  # (state, batch) -> (state, metrics)
    init_state: Callable  # generator -> state
    bits_per_client: float  # static Eq. 1 wire bits per round
    bits_dense: float
    flat_space: Any  # ShardedFlatParamSpace of the flat fast path, or None
    residual_to_tree: Optional[Callable]  # flat residual → the params' tree of (1,)+shape
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
) -> DistTrainFns:
    """Build this rank's DSGD train step for ``cfg``.

    ``group``: the :class:`~repro_torch.launch.mesh.ClientGroup` whose
    ranks are the clients (default: :func:`~repro_torch.launch.mesh.
    make_host_group` on ``device``, one client and no process group).

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
    ``cfg.residual_dtype`` takes the per-leaf exchange either way.

    State = ``{'params', 'opt', 'residual'}``; the batch is this client's,
    with a leading client axis of 1.  ``measure`` adds client 0's
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
    device = group.device
    full_f32_math()
    model = model or build_model(cfg)
    n_clients, client_axes = client_topology(cfg, group)
    opt_kw = {} if cfg.local_opt == "sgd" else {"state_dtype": cfg.residual_dtype}
    opt = get_optimizer(cfg.local_opt, **opt_kw)

    if policy is None:
        default = "sbc" if compressor == "sbc" else "dense"
        policy = CompressionPolicy.single(make_codec(default), name=compressor)

    # leaf plan from the parameter shapes (every leaf replicated: one
    # shard), in JAX's leaf order with its "a/b" paths; drawn on the meta
    # device, so nothing is allocated
    with torch.device("meta"):
        flat_p, treedef = tree_flatten_with_path(model.init(torch.Generator()))
    keys = [path_str(path) for path, _ in flat_p]
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
                  rate=pl.rate(sparsity, 0), n_shards=1,
                  shard_grid=(1,) * v.dim())
        for k, (_, v), pl in zip(keys, flat_p, plans)
    )
    want_fast = policy.fast if fast is None else bool(fast)
    space = None
    if (want_fast and cfg.residual_dtype == torch.float32
            and all(gl.dtype == torch.float32 for gl in leaves)):
        space = ShardedFlatParamSpace.build(
            [dict(path=gl.path, shape=gl.global_shape,
                  rows=gl.global_shape[0] if gl.scanned and len(gl.global_shape) > 1 else 1,
                  kind=gl.mode, rate=gl.rate, n_shards=gl.n_shards,
                  global_size=int(torch.Size(gl.global_shape).numel()))
             for gl in leaves],
            client_axes=client_axes, shard_axes=("model",), n_clients=n_clients,
            shards_per_client=1, group=group,
        )
    channel = ShardedGspmdChannel(
        leaves=leaves, client_axes=client_axes, n_clients=n_clients,
        residual_dtype=cfg.residual_dtype, flat_space=space, flat_engine=flat_engine,
        device_pack=device_pack, group=group,
    )
    bits = channel.bits()

    def init_state(gen: torch.Generator) -> dict:
        params = tree_map(lambda v: v.to(device), model.init(gen))
        return {
            "params": params,
            "opt": map_states(lambda v: v[0][None].clone(), [opt.init(params)]),
            "residual": channel.init_state(params),
        }

    need_mask = cfg.local_opt != "sgd"  # momentum masking needs ΔW*_i
    need_own = need_mask or measure

    def train_step(state: dict, batch: dict) -> tuple:
        params = state["params"]
        leaves_p = [p.detach().requires_grad_(True) for p in tree_flatten(params)[0]]
        loss = model.loss_fn(treedef.unflatten(leaves_p), tree_map(lambda v: v[0], batch))
        grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves_p)))
        with torch.no_grad():
            p2, opt_state = opt.apply(map_states(lambda v: v[0][0], [state["opt"]]),
                                      grads, params, cfg.base_lr, 0)
            deltas = tree_map(
                lambda a, b: (a.to(torch.float32) - b.to(torch.float32))
                .to(cfg.residual_dtype)[None], p2, params)
            out = channel.round_exchange(state["residual"], deltas, need_own=need_own)
            mean_tree, new_residual, own_tree = out[:3]
            # every client reconstructs the identical mean
            new_params = tree_map(
                lambda p, m: (p.to(torch.float32) + m[0].to(torch.float32)).to(p.dtype),
                params, mean_tree)
            opt_state = map_states(lambda v: v[0][None], [opt_state])
            if need_mask:
                transmitted = tree_map(lambda o: (o != 0).to(torch.float32), own_tree)
                opt_state = opt.mask(opt_state, transmitted)
            losses = group.all_gather_rows(loss.detach().reshape(()))
            metrics = {"loss": f32_mean_xla(losses)}
            if measure and device_pack:
                # exact per-(client, shard, row) packed wire bits of every
                # client (a collective: every rank takes part)
                words, nbits = out[3]
                metrics["packed_nbits"] = group.all_gather_rows(nbits[0])
            if measure and group.rank == 0:
                # client 0's transmitted ΔW* (and packed words), for wire metering
                metrics["own_client0"] = tree_map(lambda o: o[0], own_tree)
                if device_pack:
                    metrics["packed_words_client0"] = words[0]
        return {"params": new_params, "opt": opt_state, "residual": new_residual}, metrics

    residual_to_tree = None
    if space is not None:
        def residual_to_tree(flat_res: torch.Tensor) -> dict:
            """The flat residual as the per-leaf stacked tree the per-leaf
            path stores (views, no copy)."""
            return treedef.unflatten([b[None] for b in space.unflatten_local(flat_res[0, 0])])

    return DistTrainFns(
        train_step=train_step, init_state=init_state,
        bits_per_client=bits.per_client, bits_dense=bits.dense,
        flat_space=space, residual_to_tree=residual_to_tree, channel=channel,
    )


# -------------------------------------------------------------- launcher


def build_parser():
    """Thin parser over the shared RunSpec surface, pinned to gspmd, with
    the reference's defaults (``tiny``, 10 rounds) and ``--device``."""
    import argparse

    from repro_torch.run.flags import add_run_flags

    ap = argparse.ArgumentParser(
        description="GSPMD DSGD launcher (one client per process; start N of "
        "them with torchrun --nproc-per-node N)")
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
        print(f"gspmd: {run.n_clients} clients over {run.group.world} process(es), "
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
