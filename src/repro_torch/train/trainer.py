"""DSGD trainer: paper Alg. 1 with SBC (Alg. 2), the local backend.

Counterpart of ``repro.train.trainer``.  One *communication round*:

  1. every client starts from the master weights W                  (l.7-9)
  2. and runs ``n_delay`` local optimizer steps on its own microbatches
     (l.10), at the real iteration ``it = round · n_delay + d`` with
     ``lr(it)`` (unlike the GSPMD step, which pins Adam at step 0);
  3. ΔW_i = R_i + (W_i' − W);  ΔW*_i = compress(ΔW_i);  R_i ← ΔW_i − ΔW*_i
     (l.10-12, in the policy engine);
  4. exchange: ΔW ← mean_i ΔW*_i;  W ← W + ΔW                        (l.17-19)
  5. momentum masking (supplement A): each client's momentum is zeroed
     where its own ΔW*_i is non-zero.

Steps 3-4 and the bit accounting are one
:class:`~repro_torch.core.channel.LocalVmapChannel` call.  The reference
``vmap``s the clients; here the local steps loop over the clients (one
forward and backward each), and the channel compresses all clients at
once on the flat fast path (``fast=True``) or client by client on the
per-leaf path.  Nothing in a round waits for the device.

``DSGDTrainer`` is the legacy entry point of this backend, as in the
reference: ``repro_torch.run.build_run(RunSpec(backend="local", ...))``
builds the same trainer, and direct construction warns with a
``DeprecationWarning``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.api import Compressor
from repro_torch.core.channel import LocalVmapChannel, mean_over_clients
from repro_torch.core.policy import CompressionPolicy, CompressorState, ResolvedPolicy
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.device import full_f32_math, resolve_device
from repro_torch.obs import NULL_TELEMETRY, Telemetry
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import Optimizer, map_states

PyTree = Any


class TrainState(NamedTuple):
    params: dict  # master weights W (shared by all clients)
    opt_states: Any  # per-client local optimizer state (leading C axis)
    comp_state: CompressorState  # per-client compressor state (leading C axis)
    round: torch.Tensor  # communication-round counter, int32[] on the CPU


@dataclasses.dataclass(eq=False)
class DSGDTrainer:
    model: Model
    compressor: Union[Compressor, CompressionPolicy]
    optimizer: Optimizer
    n_clients: int
    lr: Callable[[int], float]  # lr(iteration) schedule
    # each client's ΔW is cast to it before compression, and its residual
    # kept in it; a residual that is not f32 takes the per-leaf path
    residual_dtype: Any = torch.float32
    # None keeps the policy's own flag; True or False forces the flat fast
    # path (core/flat.py §10, one flat f32 residual a client) on or off
    fast: Optional[bool] = None
    device: Any = None  # the card unless "cpu" is asked for
    # repro_torch.run builds the trainer itself and suppresses the warning
    _from_run: dataclasses.InitVar[bool] = False

    def __post_init__(self, _from_run: bool = False) -> None:
        if not _from_run:
            warnings.warn(
                "constructing DSGDTrainer directly is the legacy local-backend "
                "surface; build it declaratively via repro_torch.run.build_run("
                "RunSpec(backend='local', ...)) (the same trainer and states)",
                DeprecationWarning, stacklevel=2)
        self.device = resolve_device(self.device)
        full_f32_math()
        if isinstance(self.compressor, CompressionPolicy):
            self.compressor = Compressor.from_policy(self.compressor.name, self.compressor)
        if self.fast is not None and self.fast != self.compressor.policy.fast:
            self.compressor = Compressor.from_policy(
                self.compressor.name, dataclasses.replace(self.compressor.policy, fast=self.fast))
        self.channel = LocalVmapChannel(compressor=self.compressor, n_clients=self.n_clients,
                                        residual_dtype=self.residual_dtype)

    @property
    def ledger(self):
        """The channel's bandwidth ledger (one row a round with
        ``measure_wire``)."""
        return self.channel.ledger

    def resolved(self, params: PyTree) -> ResolvedPolicy:
        """The compressor's policy bound to this model's parameters."""
        return self.channel.resolved(params)

    # ------------------------------------------------------------------ init

    def init(self, gen: Optional[torch.Generator] = None, seed: int = 0) -> TrainState:
        """Initial state: parameters drawn from ``gen`` (default: seeded
        ``seed``), zero optimizer and compressor states for every client."""
        if gen is None:
            gen = torch.Generator().manual_seed(seed)
        params = tree_map(lambda v: v.to(self.device), self.model.init(gen))
        C = self.n_clients
        opt_states = map_states(lambda v: v[0].expand((C,) + tuple(v[0].shape)).clone(),
                                [self.optimizer.init(params)])
        comp_state = self.channel.init_state(params, seed)
        return TrainState(params, opt_states, comp_state, torch.zeros((), dtype=torch.int32))

    # ------------------------------------------------------------- one round

    def round_step(self, state: TrainState, batch: dict, *, n_delay: int,
                   sparsity: Union[float, Tuple[float, ...]],
                   return_compressed: bool = False) -> tuple:
        """One communication round; ``batch`` is ``(clients, n_delay,
        per_client_batch, ...)``.  Returns ``(state, metrics)``, and client
        0's compressed tree with ``return_compressed``."""
        params = state.params
        iteration = int(state.round) * n_delay  # forward-backward passes so far
        deltas, opt_states, losses = [], [], []
        with _deterministic_convolutions():
            for c in range(self.n_clients):
                delta, os, loss = local_steps(
                    self.model, self.optimizer, self.lr, params,
                    map_states(lambda v: v[0][c], [state.opt_states]),
                    [tree_map(lambda v: v[c, d], batch) for d in range(n_delay)], iteration)
                deltas.append(tree_map(lambda v: v.to(self.residual_dtype), delta))
                opt_states.append(os)
                losses.append(loss)

        with torch.no_grad():
            stacked = tree_map(lambda *xs: torch.stack(xs), *deltas)
            ex = self.channel.round_exchange(stacked, state.comp_state, sparsity,
                                             return_compressed=return_compressed)
            new_params = tree_map(lambda p, d: (p.to(torch.float32) + d.to(torch.float32)
                                                ).to(p.dtype), params, ex.mean_delta)
            # momentum masking at each client's transmitted coordinates
            transmitted = tree_map(lambda v: (v != 0).to(torch.float32), ex.transmitted)
            opt_state = self.optimizer.mask(map_states(torch.stack, opt_states), transmitted)
            n_params = sum(v.numel() for v in tree_flatten(params)[0])
            metrics = {
                "loss": mean_over_clients(torch.stack(losses)),
                "bits_per_client": ex.bits_per_client,
                "bits_dense": 32.0 * n_params * n_delay,
                "update_norm": _tree_norm(ex.mean_delta),
            }
        new_state = TrainState(new_params, opt_state, ex.state, state.round + 1)
        if return_compressed:
            return new_state, metrics, ex.compressed0
        return new_state, metrics

    def step(self, state: TrainState, batch: dict, round_idx: int, *, n_delay: int,
             sparsity: float, measure_wire: bool = False) -> tuple:
        """One metered round: :meth:`round_step` at the policy's rates for
        ``round_idx`` (the channel's ``exchange`` span); with
        ``measure_wire`` client 0's upload is packed to SBW1 bytes and
        metered ×C into the ledger (its ``encode`` span), which waits for
        the device (without it, and with telemetry off, the round never
        waits).  Returns ``(state, metrics)``."""
        rates = self.resolved(state.params).rates(sparsity, round_idx)
        tel = self.channel.telemetry
        # the local steps, the exchange and the update, traced as one
        # exchange span, as the reference traces its one jitted round
        with tel.span("exchange", round=round_idx, fused=True):
            out = self.round_step(state, batch, n_delay=n_delay, sparsity=rates,
                                  return_compressed=measure_wire)
            tel.fence(out[0].params)
        if not measure_wire:
            return out
        state, m, comp0 = out
        m = dict(m)
        m["measured_bits_per_client"] = self.channel.record_round(
            round_idx, params=state.params, compressed0=comp0, rate=sparsity,
            bits_analytic_per_client=float(m["bits_per_client"]))
        return state, m

    def fit(self, gen: Optional[torch.Generator], batch_fn: Callable[[int], dict], *,
            n_rounds: int, n_delay: int, sparsity: float, seed: int = 0,
            log_every: int = 0, measure_wire: bool = False) -> tuple:
        """Run ``n_rounds`` communication rounds of :meth:`step` from
        :meth:`init`; returns ``(state, history)``."""
        return run_rounds(
            self.init(gen, seed),
            lambda state, r: self.step(state, batch_fn(r), r, n_delay=n_delay,
                                       sparsity=sparsity, measure_wire=measure_wire),
            n_rounds=n_rounds, log_every=log_every)


def local_steps(model: Model, optimizer: Optimizer, lr: Callable[[int], float],
                params: PyTree, opt_state: Any, batches: list, iteration: int) -> tuple:
    """One client's local optimizer steps of a round (Alg. 1 l.10): step
    ``d`` takes ``batches[d]`` at iteration ``iteration + d`` with
    ``lr(iteration + d)``.  Returns ``(ΔW, new optimizer state, loss)``:
    ΔW = W' − W in f32, and the loss the mean over the steps, in XLA's
    order (:func:`~repro_torch.core.channel.mean_over_clients`)."""
    treedef = tree_flatten(params)[1]
    p, os, losses = params, opt_state, []
    for d, batch in enumerate(batches):
        it = iteration + d
        leaves = [v.detach().requires_grad_(True) for v in tree_flatten(p)[0]]
        loss = model.loss_fn(treedef.unflatten(leaves), batch)
        grads = treedef.unflatten(list(torch.autograd.grad(loss, leaves)))
        with torch.no_grad():
            p, os = optimizer.apply(os, grads, p, lr(it), it)
        losses.append(loss.detach())
    with torch.no_grad():
        delta = tree_map(lambda a, b: a.to(torch.float32) - b.to(torch.float32), p, params)
    return delta, os, mean_over_clients(torch.stack(losses))


def run_rounds(state: Any, step: Callable[[Any, int], tuple], *, n_rounds: int,
               log_every: int = 0, telemetry: Telemetry = NULL_TELEMETRY,
               params_of: Callable = lambda s: s.params,
               residual_of: Callable = lambda s: s.comp_state.residual) -> tuple:
    """The round loop of every backend: ``step(state, r)`` for each round,
    its metrics gathered into the reference's history (with
    ``measured_bits_per_client`` and ``measured_total_bits`` where the
    step meters the wire, and the compression totals where it reports
    ``bits_dense``; a step without ``bits_per_client`` counts 0 bits, as
    the reference's traced loop does).  With an enabled ``telemetry`` each
    round is a ``round`` span fenced on ``params_of(state)``, with the
    ``train/*`` gauges (``phase="compile"`` on round 0) and the norm of
    ``residual_of(state)`` unless that is None, and the stage clock
    drained once the round's loss is on the host; with the default no-op
    one nothing waits for the device.  Returns ``(state, history)``."""
    tel = telemetry
    hist: dict = {"round": [], "loss": [], "bits_per_client": []}
    dense_total = None
    for r in range(n_rounds):
        t0 = time.perf_counter()
        with tel.span("round", round=r):
            state, m = step(state, r)
            tel.fence(params_of(state))
        step_ms = (time.perf_counter() - t0) * 1e3
        loss, bits = float(m["loss"]), float(m.get("bits_per_client", 0.0))
        tel.stages.drain()  # the loss has synchronised the round
        if tel.enabled:
            tel.metrics.gauge("train/step_ms", step_ms, round=r,
                              phase="compile" if r == 0 else "steady")
            tel.metrics.gauge("train/loss", loss, round=r)
            if "bits_per_client" in m:
                tel.metrics.gauge("train/bits_per_client", bits, round=r)
            res = residual_of(state)
            if res is not None:
                norm = torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                                      for x in tree_flatten(res)[0]))
                tel.metrics.gauge("train/residual_norm", float(norm), round=r)
        hist["round"].append(r)
        hist["loss"].append(loss)
        hist["bits_per_client"].append(bits)
        if "bits_dense" in m:
            dense_total = (dense_total or 0.0) + float(m["bits_dense"])
        if "measured_bits_per_client" in m:
            hist.setdefault("measured_bits_per_client", []).append(
                float(m["measured_bits_per_client"]))
        if log_every and (r + 1) % log_every == 0:
            print(f"round {r + 1:5d}  loss {loss:.4f}  bits/client {bits:.3e}  "
                  f"step {step_ms:.1f} ms")
    return state, (hist if dense_total is None else finish_history(hist, dense_total))


def finish_history(hist: dict, dense_total: float) -> dict:
    """The history's totals: upload bits (the sum of the rounds' Eq. 1
    bits), ``dense_total`` and their ratio, and the measured total where
    the rounds metered the wire."""
    total_bits = sum(hist["bits_per_client"], 0.0)
    hist["total_upload_bits"] = total_bits
    hist["dense_total_bits"] = dense_total
    hist["compression_rate"] = dense_total / max(total_bits, 1.0)
    if hist.get("measured_bits_per_client"):
        hist["measured_total_bits"] = sum(hist["measured_bits_per_client"])
    return hist


@contextlib.contextmanager
def _deterministic_convolutions():
    """Take cuDNN's deterministic convolution algorithms for the local
    steps, so that a round repeats bit for bit (on the card, the weight
    gradients of a convolution may otherwise add in another order each
    call), as the reference's does."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def _tree_norm(tree) -> torch.Tensor:
    """√Σ x² over the tree's leaves, summed leaf by leaf in leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_flatten(tree)[0]))
