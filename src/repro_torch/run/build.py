"""``build_run(spec) -> GspmdRun``: a declarative spec drives the port.

Counterpart of ``repro.run.build``.  The port carries the GSPMD backend
on one card with either flat engine, the exact one optionally with the
device-packed Golomb wire and its metering:

    build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                      flat_engine="hist", sparsity=0.01))
    build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                      flat_engine="exact", device_pack=True,
                      measure_wire=True, sparsity=0.01))

Either takes per-leaf policy rules (``dense_pattern``, ``skip_pattern``),
built by :func:`policy_from_spec` as in the reference; the hist engine
takes all-SBC policies only and raises ``ValueError`` at its first step
otherwise, as the reference does.  Every other combination raises
``NotImplementedError`` naming the ROADMAP item that brings it; none runs
a different path in silence.  The run is
on the CUDA card unless ``device="cpu"`` is passed; without a card
``build_run`` raises ``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

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
    if spec.backend == "local":
        todo.append("backend='local' (ROADMAP A6)")
    elif spec.backend == "fed":
        todo.append("backend='fed' (ROADMAP A8)")
    if spec.preset not in PORTED_PRESETS:
        todo.append(f"preset {spec.preset!r} (ROADMAP A5/A12)")
    if spec.compressor != "sbc":
        todo.append(f"compressor {spec.compressor!r} (ROADMAP A12)")
    if not spec.fast:
        todo.append("fast=False, the per-leaf exchange (ROADMAP A9)")
    if spec.telemetry:
        todo.append("telemetry (ROADMAP A11)")
    if todo:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(todo) + ". This port carries "
            "preset='lenet5', backend='gspmd', fast=True with "
            "flat_engine='hist' or 'exact' (device_pack, measure_wire, "
            "dense_pattern and skip_pattern included)."
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


def build_run(spec: RunSpec, device=None) -> GspmdRun:
    """Construct the backend a spec names, on ``device`` (default: the CUDA
    card; an explicit ``"cuda:N"`` picks one of several cards)."""
    _check_slice(spec)
    if device is None and torch.cuda.device_count() > 1:
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
