"""``build_run(spec) -> Run``: a declarative spec drives the port.

Counterpart of ``repro.run.build``.  The port carries two backends:

  local   :class:`~repro_torch.train.trainer.DSGDTrainer` over a
          :class:`~repro_torch.core.channel.LocalVmapChannel` (the paper's
          Alg. 1 round, clients as a leading axis), with ``fast`` either
          way and ``measure_wire``:

              build_run(RunSpec(preset="lenet5", backend="local",
                                sparsity=0.01, measure_wire=True))

  gspmd   one card, either flat engine, the exact one optionally with the
          device-packed Golomb wire and its metering:

              build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                                flat_engine="exact", device_pack=True,
                                measure_wire=True, sparsity=0.01))

Both take per-leaf policy rules (``dense_pattern``, ``skip_pattern``),
built by :func:`policy_from_spec` as in the reference; the GSPMD hist
engine takes all-SBC policies only and raises ``ValueError`` at its first
step otherwise, as the reference does.  Every other combination raises
``NotImplementedError`` naming the ROADMAP item that brings it; none runs
a different path in silence.  The run is on the CUDA card unless
``device="cpu"`` is passed; without a card ``build_run`` raises
``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import torch

from repro_torch.core.api import Compressor, make_compressor
from repro_torch.core.policy import CompressionPolicy, PolicyRule
from repro_torch.device import resolve_device
from repro_torch.launch.dist import build_dist_train, client_topology
from repro_torch.models.model import build_model
from repro_torch.run.presets import PORTED_PRESETS, build_preset
from repro_torch.run.spec import RunSpec


def _check_slice(spec: RunSpec) -> None:
    """Refuse every spec field this port does not carry yet."""
    todo = []
    if spec.backend == "fed":
        todo.append("backend='fed' (ROADMAP A8)")
    if spec.preset not in PORTED_PRESETS:
        todo.append(f"preset {spec.preset!r} (ROADMAP A5/A12)")
    if spec.compressor != "sbc":
        todo.append(f"compressor {spec.compressor!r} (ROADMAP A12)")
    if spec.backend == "gspmd" and not spec.fast:
        todo.append("fast=False on gspmd, the per-leaf exchange (ROADMAP A9)")
    if spec.telemetry:
        todo.append("telemetry (ROADMAP A11)")
    if todo:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(todo) + ". This port carries "
            "preset='lenet5' on backend='local' (fast either way, measure_wire) "
            "and on backend='gspmd' with fast=True and flat_engine='hist' or "
            "'exact' (device_pack, measure_wire), with dense_pattern and "
            "skip_pattern on both."
        )


def policy_from_spec(spec: RunSpec) -> Union[Compressor, CompressionPolicy]:
    """The spec's compression policy: the compressor, path-regex rules and
    the fast flag, composed as the reference composes them (skip rules
    first, then dense fallbacks, then the compressor's own rules)."""
    comp = make_compressor(spec.compressor)
    rules: Tuple[PolicyRule, ...] = ()
    if spec.skip_pattern:
        rules += (PolicyRule(spec.skip_pattern, codec="skip"),)
    if spec.dense_pattern:
        rules += (PolicyRule(spec.dense_pattern, codec="dense32"),)
    if rules:
        return CompressionPolicy(
            default=comp.codec,
            rules=rules + comp.policy.rules,
            name=spec.compressor + "+rules",
            fast=spec.fast,
        )
    # fast=True opts in; False keeps the compressor's own flag
    if spec.fast and not comp.policy.fast:
        return Compressor.from_policy(
            comp.name, dataclasses.replace(comp.policy, fast=True)
        )
    return comp


def as_policy(thing: Union[Compressor, CompressionPolicy]) -> CompressionPolicy:
    return thing.policy if isinstance(thing, Compressor) else thing


def lr_schedule(base_lr: float) -> Callable[[int], float]:
    """``lr(iteration)``: the constant ``base_lr`` (a host float: the port's
    rounds run on the host)."""
    return lambda it: base_lr


# ------------------------------------------------------------ local backend


@dataclasses.dataclass(eq=False)
class LocalRun:
    """A built local backend: the init/step/evaluate/checkpoint/run surface
    over a :class:`~repro_torch.train.trainer.DSGDTrainer`."""

    spec: RunSpec
    cfg: Any
    model: Any
    task: Any
    channel: Any
    trainer: Any
    batch_fn: Callable
    device: torch.device

    @property
    def n_clients(self) -> int:
        return self.spec.clients

    @property
    def ledger(self):
        """The channel's :class:`~repro_torch.core.ledger.BandwidthLedger`."""
        return self.channel.ledger

    def init(self, gen: Optional[torch.Generator] = None):
        return self.trainer.init(gen, self.spec.seed)

    def step(self, state, round_idx: int) -> tuple:
        """One communication round; returns ``(state, metrics)``.  With
        ``measure_wire`` client 0's upload is packed to SBW1 bytes and
        metered ×C into the ledger, which waits for the device; without
        it the round never waits."""
        return self.trainer.step(state, self.batch_fn(round_idx), round_idx,
                                 n_delay=self.spec.delay, sparsity=self.spec.sparsity,
                                 measure_wire=self.spec.measure_wire)

    def evaluate(self, state) -> dict:
        """Held-out loss: a batch stream no training client draws."""
        batch = self.task.sample(0, self.spec.clients + 1)
        with torch.no_grad():
            return {"loss": float(self.model.loss_fn(state.params, batch))}

    def checkpoint(self, state, path: str) -> None:
        from repro_torch.checkpoint.io import save_train_state

        save_train_state(path, state)

    def run(self, n_rounds: Optional[int] = None, log_every: int = 0) -> tuple:
        """init + :meth:`step` loop; returns ``(state, history)``."""
        from repro_torch.train.trainer import run_rounds

        return run_rounds(self.init(), self.step, log_every=log_every,
                          n_rounds=self.spec.rounds if n_rounds is None else n_rounds)


def _build_local(spec: RunSpec, dev: torch.device) -> LocalRun:
    from repro_torch.data import client_batches
    from repro_torch.optim import get_optimizer
    from repro_torch.train import DSGDTrainer

    cfg, task = build_preset(spec.preset, batch=spec.batch, seq_len=spec.seq_len,
                             seed=spec.seed, device=dev)
    model = build_model(cfg)
    trainer = DSGDTrainer(
        model=model, compressor=policy_from_spec(spec),
        optimizer=get_optimizer(cfg.local_opt), n_clients=spec.clients,
        lr=lr_schedule(spec.lr if spec.lr is not None else cfg.base_lr),
        device=dev, _from_run=True)
    return LocalRun(spec=spec, cfg=cfg, model=model, task=task, channel=trainer.channel,
                    trainer=trainer, batch_fn=client_batches(task, spec.clients, spec.delay),
                    device=dev)


# ------------------------------------------------------------ gspmd backend


@dataclasses.dataclass(eq=False)
class GspmdRun:
    """A built GSPMD backend: the init/step/run surface."""

    spec: RunSpec
    cfg: Any
    model: Any
    task: Any
    channel: Any
    fns: Any  # DistTrainFns
    n_clients: int
    device: torch.device

    def init(self, gen: Optional[torch.Generator] = None) -> dict:
        if gen is None:
            gen = torch.Generator()
            gen.manual_seed(self.spec.seed)
        return self.fns.init_state(gen)

    def _batch(self, round_idx: int) -> dict:
        per = [self.task.sample(round_idx, c) for c in range(self.n_clients)]
        return {k: torch.stack([b[k] for b in per]) for k in per[0]}

    @property
    def ledger(self):
        """The channel's :class:`~repro_torch.core.ledger.BandwidthLedger`."""
        return self.channel.ledger

    def step(self, state: dict, round_idx: int) -> tuple:
        """One communication round; returns ``(state, metrics)``.  With
        ``measure_wire`` the round's uploads are metered into the ledger
        (every client's packed bits with ``device_pack``, else client 0's
        host-encoded ΔW*), which waits for the device."""
        state, m = self.fns.train_step(state, self._batch(round_idx))
        m = dict(m)
        if self.spec.measure_wire:
            own_client0 = m.pop("own_client0")
            packed_nbits = m.pop("packed_nbits", None)
            m.pop("packed_words_client0", None)
            m["measured_bits_per_client"] = self.channel.record_round(
                round_idx, own_client0=own_client0, packed_nbits=packed_nbits
            )
        m["bits_per_client"] = self.fns.bits_per_client
        m["bits_dense"] = self.fns.bits_dense
        return state, m

    def run(self, n_rounds: Optional[int] = None, log_every: int = 0) -> tuple:
        """init + step loop; returns ``(state, history)``."""
        n_rounds = self.spec.rounds if n_rounds is None else n_rounds
        state = self.init()
        hist: dict = {"round": [], "loss": [], "bits_per_client": []}
        for r in range(n_rounds):
            state, m = self.step(state, r)
            hist["round"].append(r)
            hist["loss"].append(float(m["loss"]))
            hist["bits_per_client"].append(float(m["bits_per_client"]))
            if log_every and (r + 1) % log_every == 0:
                print(f"round {r+1:5d}  loss {float(m['loss']):.4f}")
        hist["total_upload_bits"] = float(self.fns.bits_per_client) * n_rounds
        hist["dense_total_bits"] = float(self.fns.bits_dense) * n_rounds
        hist["compression_rate"] = hist["dense_total_bits"] / max(
            hist["total_upload_bits"], 1.0
        )
        return state, hist


def build_run(spec: RunSpec, device=None) -> Union[LocalRun, GspmdRun]:
    """Construct the backend a spec names, on ``device`` (default: the CUDA
    card; an explicit ``"cuda:N"`` picks one of several cards)."""
    _check_slice(spec)
    if spec.backend == "gspmd" and device is None and torch.cuda.device_count() > 1:
        raise NotImplementedError(
            "the reference puts one client on every local device; several "
            "cards need torch.distributed (ROADMAP A9). Pass device='cuda:0' "
            "for a one-card run."
        )
    dev = resolve_device(device)
    # This is a parity port of an f32 reference: keep f32 matmuls and
    # convolutions in full f32 (cuDNN would otherwise run convolutions in
    # TF32, which keeps about three decimal digits).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if spec.backend == "local":
        return _build_local(spec, dev)
    cfg, task = build_preset(spec.preset, batch=spec.batch, seq_len=spec.seq_len,
                             seed=spec.seed, device=dev)
    model = build_model(cfg)
    policy = policy_from_spec(spec)
    fns = build_dist_train(cfg, sparsity=spec.sparsity,
                           policy=None if isinstance(policy, Compressor) else policy,
                           flat_engine=spec.flat_engine,
                           measure=spec.measure_wire, device_pack=spec.device_pack,
                           model=model, device=dev)
    n_clients, _ = client_topology(cfg)
    return GspmdRun(spec=spec, cfg=cfg, model=model, task=task,
                    channel=fns.channel, fns=fns, n_clients=n_clients, device=dev)
