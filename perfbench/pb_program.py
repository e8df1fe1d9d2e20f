"""The system under test: one client of ``repro_torch`` on the GSPMD
backend, built as a user builds it, with the harness's hooks on the
built objects' attributes.

This is the one module of the benchmark that imports the program.  It
builds ``build_dist_train(cfg, fast=True, flat_engine=<engine>,
sparsity=p)`` at world 1 (telemetry off) and a ``GspmdRun`` over it
with :class:`PoolTask`, the benchmark's own feed; copies the
benchmark's weights into the program's state; and reads back what the
comparison takes: the params, the residual and Adam's ``v`` as
``{path: tensor}``.  With ``hooks`` the model's ``loss_fn`` and the
channel's ``round_exchange`` call ``hooks.mark(name)`` at the
forward's return and around the exchange, and the exchange runs inside
a ``record_function`` range named ``pb.exchange``.  No program file is
changed.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs.base import ModelConfig, get_config  # noqa: E402
from repro_torch.core.policy import path_str  # noqa: E402
from repro_torch.core.tree import tree_flatten_with_path  # noqa: E402
from repro_torch.launch.dist import build_dist_train  # noqa: E402
from repro_torch.launch.mesh import make_host_group  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.run import GspmdRun, RunSpec  # noqa: E402

EXCHANGE_RANGE = "pb.exchange"


class PoolTask:
    """The feed: round r trains on ``pool[r % len(pool)]`` (each a dict of
    device tensors without the client axis)."""

    def __init__(self, pool: list):
        self.pool = pool

    def sample(self, round_idx: int, client: int = 0) -> dict:
        return self.pool[round_idx % len(self.pool)]


def port_config(cfg_file: dict) -> ModelConfig:
    """The port's config named by ``cfg_file["port_config"]`` with every
    key of ``cfg_file["model"]`` that the port's config has set as the
    file states it (dtypes by name)."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    changes = {k: (getattr(torch, v) if k.endswith("dtype") else v)
               for k, v in cfg_file["model"].items() if k in fields}
    return dataclasses.replace(get_config(cfg_file["port_config"]), **changes)


def _hooked_model(model, hooks):
    inner = model.loss_fn

    def loss_fn(params, batch):
        out = inner(params, batch)
        hooks.mark("forward_end")
        return out

    return model._replace(loss_fn=loss_fn)


def _hook_channel(channel, hooks) -> None:
    inner = channel.round_exchange

    def round_exchange(*args, **kwargs):
        hooks.mark("exchange_start")
        with torch.profiler.record_function(EXCHANGE_RANGE):
            out = inner(*args, **kwargs)
        hooks.mark("exchange_end")
        return out

    channel.round_exchange = round_exchange


def build(cfg_file: dict, pool: list, seed: int, device, hooks=None) -> GspmdRun:
    """The run of ``cfg_file`` on the feed ``pool``, one client on
    ``device``."""
    cfg = port_config(cfg_file)
    model = build_model(cfg)
    if hooks is not None:
        model = _hooked_model(model, hooks)
    run_cfg = cfg_file["run"]
    group = make_host_group(device)
    fns = build_dist_train(cfg, group=group, compressor="sbc", sparsity=run_cfg["sparsity"],
                           fast=True, flat_engine=run_cfg["engine"], model=model)
    if hooks is not None:
        _hook_channel(fns.channel, hooks)
    batch = pool[0]["tokens"].shape
    spec = RunSpec(preset=cfg_file["port_config"], backend="gspmd", fast=True,
                   flat_engine=run_cfg["engine"], sparsity=run_cfg["sparsity"],
                   batch=batch[0], seq_len=batch[1], seed=seed)
    return GspmdRun(spec=spec, cfg=cfg, model=model, task=PoolTask(pool), channel=fns.channel,
                    fns=fns, n_clients=fns.channel.n_clients, device=group.device, group=group)


def _by_path(tree, lead: bool = False) -> dict:
    flat, _ = tree_flatten_with_path(tree)
    return {path_str(p): (v[0] if lead else v) for p, v in flat}


def init_state(run: GspmdRun, weights: dict) -> dict:
    """The program's initial state with the benchmark's ``weights``
    (``{path: f32 tensor}``) copied into its params.  The program's own
    init draws on a generator on the run's device and is overwritten."""
    gen = torch.Generator(device=run.device)
    gen.manual_seed(0)
    state = run.init(gen)
    params = _by_path(state["params"])
    if sorted(params) != sorted(weights):
        raise ValueError(f"the program's leaves {sorted(params)} are not the benchmark's "
                         f"{sorted(weights)}")
    for path, leaf in params.items():
        if tuple(leaf.shape) != tuple(weights[path].shape):
            raise ValueError(f"{path}: the program's shape {tuple(leaf.shape)}, the "
                             f"benchmark's {tuple(weights[path].shape)}")
        leaf.copy_(weights[path])
    return state


def params_of(state: dict) -> dict:
    return _by_path(state["params"])


def residual_of(run: GspmdRun, state: dict) -> dict:
    """The flat residual cut into its leaves: ``{path: tensor}``."""
    space = run.fns.flat_space
    leaves = space.unflatten_local(state["residual"].reshape(-1))
    return {s.path: v for s, v in zip(space.segments, leaves)}


def adam_v_of(state: dict) -> dict:
    return _by_path(state["opt"].v, lead=True)
