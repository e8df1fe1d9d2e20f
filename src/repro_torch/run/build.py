"""``build_run(spec) -> Run``: a declarative spec drives the port.

Counterpart of ``repro.run.build``.  The port carries the paper's
presets (``lenet5``, ``charlstm``, the reference's reduced ``wordlstm``),
the decoder presets (``tiny``, ``fed-tiny``, ``lm-100m``) and every
assigned architecture's reduced preset (the dense, MoE and recurrent
decoders, ``phi3_vision_4p2b`` and the encoder-decoder
``seamless_m4t_medium``), with ``sbc`` or any of the paper's baseline
compressors, on three backends:

  local   :class:`~repro_torch.train.trainer.DSGDTrainer` over a
          :class:`~repro_torch.core.channel.LocalVmapChannel` (the paper's
          Alg. 1 round, clients as a leading axis), with ``fast`` either
          way and ``measure_wire``:

              build_run(RunSpec(preset="lm-100m", backend="local",
                                sparsity=0.001, measure_wire=True))

  gspmd   one client per process (a :class:`~repro_torch.launch.mesh.
          ClientGroup`: the ranks ``torchrun`` starts, or one client on one
          card), either flat engine, the exact one optionally with the
          device-packed Golomb wire and its metering, or the per-leaf
          exchange (``fast=False``):

              build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                                flat_engine="exact", device_pack=True,
                                measure_wire=True, sparsity=0.01))

          Under ``torchrun`` every rank calls ``build_run`` and takes its
          client from ``repro_torch.launch.mesh.group_from_env``; rank 0
          alone meters the wire into the ledger.  ``mesh_shape=`` (keyword
          only, the counterpart of the reference's ``mesh=``) gives the
          layout, such as ``{"data": 16, "model": 16}``: the pod-mode
          configs (``granite_20b``, ``command_r_35b``, ``mixtral_8x7b``,
          ``llama4_maverick_400b_a17b``, ``jamba_v01_52b``) take one client
          a "pod" coordinate, and every leaf is compressed per shard of
          its spec, all of a client's shards on its rank, or one device's
          shard a rank when the world is the layout's device count:

              build_run(RunSpec(preset="granite_20b", backend="gspmd"),
                        mesh_shape={"data": 16, "model": 16})

  fed     a :class:`~repro_torch.fed.scheduler.RoundScheduler` over a
          :class:`~repro_torch.core.channel.FedWireChannel`: a parameter
          server and a client pool on one card, real SBW1 bytes both
          ways, cohorts, profiles, async rounds, faults and checkpoints;
          ``non_iid`` gives a decoder preset's clients their own chains
          (:func:`~repro_torch.data.make_non_iid_lm_task`), and raises the
          reference's ``ValueError`` for any other family:

              build_run(RunSpec(preset="lenet5", backend="fed", clients=8,
                                cohort=4, sparsity=0.01))

All take per-leaf policy rules (``dense_pattern``, ``skip_pattern``),
built by :func:`policy_from_spec` as in the reference; the GSPMD hist
engine takes all-SBC policies only and raises ``ValueError`` at its first
step otherwise, as the reference does.  On gspmd a compressor other than
``sbc`` without rules takes the dense exchange under its own name (32 bits
a parameter), as the reference's ``build_dist_train`` does; with rules its
codec has no exchange there and raises.  ``preset="resnet32"`` raises the
reference's ``ValueError`` (its preset is an LM task of vocabulary 0).
``telemetry=True`` attaches one
enabled :class:`~repro_torch.obs.Telemetry` to the run and its channel,
and ``run()`` records what the reference's traced loop records (one
``round`` span a round, the ``train/*`` and ``leaf/*`` gauges, the
ledger's ``wire/*``) and, on gspmd, the stage clock's device-timed
``train.*`` and ``exchange.*`` stages (:mod:`repro_torch.obs.stages`).
A world that is neither the layout's clients nor its devices raises
``ValueError``; none runs a different path in silence.  The run is on
the CUDA card unless
``device="cpu"`` is passed; without a card ``build_run`` raises
``RuntimeError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.api import Compressor, make_compressor
from repro_torch.core.policy import CompressionPolicy, PolicyRule
from repro_torch.device import resolve_device
from repro_torch.launch.dist import build_dist_train
from repro_torch.models.model import build_model
from repro_torch.obs import NULL_TELEMETRY, make_telemetry
from repro_torch.run.presets import build_preset
from repro_torch.run.spec import RunSpec

PyTree = Any  # a nested dict of tensors, as the reference's pytrees


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


def lr_schedule(base_lr: float, decay_at: Tuple[int, ...] = (),
                factor: float = 0.1) -> Callable[[int], float]:
    """``lr(iteration)``: ``base_lr``, times ``factor`` for each of
    ``decay_at`` that the iteration has reached.  A host float (the port's
    rounds run on the host); with decay points it is the reference's f32
    product, and without them ``base_lr`` itself, as in the reference."""
    if not decay_at:
        return lambda it: base_lr

    def lr(it: int) -> float:
        mult = 1.0
        for d in decay_at:
            mult = np.float32(mult * factor) if it >= d else np.float32(mult)
        return float(np.float32(base_lr) * mult)

    return lr


# ---------------------------------------------------------------- Run base


class Run:
    """The run surface every backend shares (the reference's ``Run``):

      ``init``        the backend's whole training state
      ``step``        one communication round: ``(state, metrics)``
      ``evaluate``    the held-out loss of the state's master weights
      ``checkpoint``  the state to one npz (:mod:`repro_torch.checkpoint`)
      ``params_of``   the state's master weights
      ``ledger``      the channel's :class:`~repro_torch.core.ledger.BandwidthLedger`
      ``run``         the init + step loop, which records the reference's
                      telemetry when it is on (``build_run`` sets an
                      enabled :attr:`telemetry`; the class default is the
                      no-op ``NULL_TELEMETRY``)

    Each backend is a dataclass with these fields and its own."""

    spec: RunSpec
    cfg: Any
    model: Any
    task: Any
    channel: Any  # the backend's CommChannel
    telemetry = NULL_TELEMETRY

    # ------------------------------------------------------------ protocol

    def init(self, gen: Optional[torch.Generator] = None):
        raise NotImplementedError

    def step(self, state, round_idx: int) -> tuple:
        raise NotImplementedError

    def evaluate(self, state) -> dict:
        """Held-out loss: the batch ``task.sample(0, n_clients + 1)``, a
        stream no training client draws (``n_clients`` is the backend's
        real client count: gspmd's comes from its layout, not from
        ``spec.clients``)."""
        batch = self.task.sample(0, self.n_clients + 1)
        with torch.no_grad():
            return {"loss": float(self._loss(state, batch))}

    def _loss(self, state, batch: dict) -> torch.Tensor:
        return self.model.loss_fn(self.params_of(state), batch)

    def checkpoint(self, state, path: str) -> None:
        raise NotImplementedError

    def params_of(self, state):
        raise NotImplementedError

    @property
    def ledger(self):
        """The channel's :class:`~repro_torch.core.ledger.BandwidthLedger`."""
        return self.channel.ledger

    # ----------------------------------------------------------- telemetry

    def _init_for_run(self):
        """The state :meth:`run` starts from (fed reuses a live scheduler)."""
        return self.init()

    def _leaf_table(self, state) -> list:
        """Per-leaf static compression plan rows ``(path, n, k, rate)``
        for the ``leaf/*`` gauges (``k`` None for dense and skip leaves)."""
        raise NotImplementedError

    def _record_static_gauges(self, state) -> None:
        from repro_torch.core.golomb import expected_position_bits

        metrics = self.telemetry.metrics
        for path, n, k, rate in self._leaf_table(state):
            metrics.gauge("leaf/n", n, leaf=path)
            metrics.gauge("leaf/rate", rate, leaf=path)
            if k is not None:
                metrics.gauge("leaf/k", k, leaf=path)
                if 0.0 < rate < 1.0:
                    metrics.gauge("leaf/golomb_bits_pos", expected_position_bits(rate),
                                  leaf=path)

    def _finalize_hist(self, hist: dict, n_rounds: int) -> dict:
        """Backend-specific derived history fields (compression totals)."""
        return hist

    def run(self, n_rounds: Optional[int] = None, log_every: int = 0) -> tuple:
        """init + :meth:`step` loop; returns ``(state, history)``.  With
        telemetry on: the static ``leaf/*`` gauges, one fenced ``round``
        span a round with the ``train/*`` gauges, and at the end the
        ledger's rows as ``wire/*`` gauges."""
        from repro_torch.train.trainer import run_rounds

        n_rounds = self.spec.rounds if n_rounds is None else n_rounds
        state = self._init_for_run()
        if self.telemetry.enabled:
            self._record_static_gauges(state)
        state, hist = run_rounds(state, self.step, n_rounds=n_rounds, log_every=log_every,
                                 telemetry=self.telemetry, params_of=self.params_of,
                                 residual_of=self._residual_of)
        self.telemetry.metrics.ingest_ledger(self.ledger)
        return state, self._finalize_hist(hist, n_rounds)


# ------------------------------------------------------------ local backend


@dataclasses.dataclass(eq=False)
class LocalRun(Run):
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

    def checkpoint(self, state, path: str) -> None:
        from repro_torch.checkpoint.io import save_train_state

        save_train_state(path, state)

    def params_of(self, state):
        return state.params

    def _residual_of(self, state):
        return state.comp_state.residual

    def _leaf_table(self, state) -> list:
        from repro_torch.core.stages import k_for

        resolved = self.trainer.resolved(state.params)
        rates = resolved.rates(self.spec.sparsity, 0)
        rows = []
        for plan, leaf, p in zip(resolved.plans, resolved._leaves_of(state.params), rates):
            n = leaf.numel()
            sparse = not (plan.codec.skip or plan.codec.selector.dense)
            rows.append((plan.path, n, k_for(n, p) if sparse else None, float(p)))
        return rows


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
class GspmdRun(Run):
    """A built GSPMD backend, seen from one client (one rank of
    :attr:`group`): the init/step/run surface."""

    spec: RunSpec
    cfg: Any
    model: Any
    task: Any
    channel: Any
    fns: Any  # DistTrainFns
    n_clients: int
    device: torch.device
    group: Any  # ClientGroup

    def init(self, gen: Optional[torch.Generator] = None) -> dict:
        if gen is None:
            gen = torch.Generator()
            gen.manual_seed(self.spec.seed)
        return self.fns.init_state(gen)

    def _batch(self, round_idx: int) -> dict:
        """This rank's client's batch (a leading client axis of 1); with one
        rank a device the step takes this rank's "data" share of its rows,
        as the reference's ``batch_shardings`` puts ``P(lead, "data")``."""
        return {k: v[None] for k, v in self.task.sample(round_idx, self.fns.client).items()}

    def params_to_tree(self, state: dict) -> dict:
        """The whole params of ``state``: gathered over the client's ranks
        with one rank a device (a collective of those ranks)."""
        return self.fns.params_to_tree(state["params"])

    def step(self, state: dict, round_idx: int) -> tuple:
        """One communication round; returns ``(state, metrics)``.  With
        ``measure_wire`` rank 0 meters the round's uploads into its ledger
        (every client's packed bits with ``device_pack``, else client 0's
        host-encoded ΔW*), which waits for the device."""
        # the round (local step, compress, exchange, apply) traced as one
        # exchange span, as the reference traces its one jitted call; the
        # host clock, no fence (run_rounds fences the round, and the stage
        # clock times the step's parts on the device)
        with self.telemetry.span("exchange", round=round_idx, fused=True):
            state, m = self.fns.train_step(state, self._batch(round_idx))
        m = dict(m)
        own_client0 = m.pop("own_client0", None)
        packed_nbits = m.pop("packed_nbits", None)
        m.pop("packed_words_client0", None)
        if self.spec.measure_wire and self.group.rank == 0:
            m["measured_bits_per_client"] = self.channel.record_round(
                round_idx, own_client0=own_client0, packed_nbits=packed_nbits
            )
        m["bits_per_client"] = self.fns.bits_per_client
        m["bits_dense"] = self.fns.bits_dense
        return state, m

    def params_of(self, state: dict):
        return state["params"]

    def _loss(self, state: dict, batch: dict) -> torch.Tensor:
        # one rank a device: the leaves gathered at their use, a collective
        return self.fns.eval_loss(state["params"], batch)

    def checkpoint(self, state: dict, path: str) -> None:
        """The file the reference's ``save_pytree`` writes for the same
        global state: the params whole and every client's optimizer and
        residual rows.  A collective: every rank calls it, the leaves are
        gathered one at a time to rank 0's host, and rank 0 alone writes;
        :func:`~repro_torch.checkpoint.io.load_pytree` with ``like=`` a
        one-rank run's state reads it back."""
        from repro_torch.checkpoint.io import save_pytree

        tree = self.fns.state_to_host(state)
        if self.group.rank == 0:
            save_pytree(path, tree)

    def _residual_of(self, state: dict):
        return state["residual"]

    def _leaf_table(self, state) -> list:
        """Per leaf ``(path, n, k, rate)``: a sparse leaf's ``k`` is the
        survivors its shards select, ``k`` a row of each shard."""
        from repro_torch.core.channel import leaf_rows

        rows = []
        for gl in self.channel.leaves:
            L, _, k_loc = leaf_rows(gl)
            rows.append((gl.path, int(torch.Size(gl.global_shape).numel()),
                         L * gl.n_shards * k_loc if gl.mode == "sparse" else None,
                         float(gl.rate)))
        return rows

    def _finalize_hist(self, hist: dict, n_rounds: int) -> dict:
        hist["total_upload_bits"] = float(self.fns.bits_per_client) * n_rounds
        hist["dense_total_bits"] = float(self.fns.bits_dense) * n_rounds
        hist["compression_rate"] = hist["dense_total_bits"] / max(
            hist["total_upload_bits"], 1.0
        )
        return hist


# -------------------------------------------------------------- fed backend


@dataclasses.dataclass(eq=False)
class FedRun(Run):
    """A built fed backend: the stateful
    :class:`~repro_torch.fed.scheduler.RoundScheduler` IS the run state
    (:meth:`init` builds it; :meth:`step` drives one round of it)."""

    spec: RunSpec
    cfg: Any
    model: Any
    task: Any
    device: torch.device
    channel: Any = None  # the scheduler's FedWireChannel, set by init
    scheduler: Any = None

    @property
    def n_clients(self) -> int:
        return self.spec.clients

    def init(self, gen: Optional[torch.Generator] = None):
        """Build the server (parameters drawn from ``gen``, default seeded
        ``spec.seed``), the pool and the scheduler; returns the scheduler."""
        from repro_torch.core.tree import tree_map
        from repro_torch.fed import ClientPool, FaultSchedule, ParameterServer, RoundScheduler
        from repro_torch.optim import get_optimizer
        from repro_torch.run.flags import profiles_from_spec

        spec = self.spec
        if gen is None:
            gen = torch.Generator().manual_seed(spec.seed)
        params = tree_map(lambda v: v.to(self.device), self.model.init(gen))
        policy = as_policy(policy_from_spec(spec))
        agg = spec.agg or ("staleness" if spec.async_rounds else "mean")
        lr = spec.lr if spec.lr is not None else self.cfg.base_lr
        server = ParameterServer(
            params=params, up_policy=policy, down_sparsity=spec.down_sparsity,
            aggregator=agg, staleness_beta=spec.staleness_beta,
            delta_horizon=spec.delta_horizon if spec.broadcast_log else None)
        pool = ClientPool(
            model=self.model, optimizer=get_optimizer(self.cfg.local_opt), policy=policy,
            task=self.task, n_clients=spec.clients, lr=lr_schedule(lr),
            profiles=profiles_from_spec(spec), seed=spec.seed,
            cohort_tile=spec.cohort_tile, store=spec.client_store, device=self.device)
        self.scheduler = RoundScheduler(
            server=server, pool=pool, cohort_size=spec.cohort or spec.clients,
            mode="async" if spec.async_rounds else "sync",
            max_staleness=spec.max_staleness, seed=spec.seed,
            straggler_timeout=spec.straggler_timeout,
            faults=FaultSchedule.parse(spec.faults) if spec.faults else None)
        self.channel = self.scheduler.channel
        # the telemetry handle reaches both wire ends: select_quantize and
        # encode spans in the channel, decode/apply/encode in the server
        self.channel.telemetry = self.telemetry
        server.telemetry = self.telemetry
        return self.scheduler

    def step(self, state, round_idx: int) -> tuple:
        return state, state.step(round_idx)

    def checkpoint(self, state, path: str, rounds_done: Optional[int] = None) -> None:
        """Whole-federation snapshot (server + pool + channel): a restored
        run continues bit for bit, mid-round included."""
        from repro_torch.fed.checkpoint import save_fed_state

        save_fed_state(path, state, rounds_done=rounds_done)

    def restore(self, path: str) -> dict:
        """Restore a :meth:`checkpoint` file into a freshly initialized
        scheduler; returns the checkpoint meta (``rounds_done`` etc.)."""
        from repro_torch.fed.checkpoint import restore_fed_state

        return restore_fed_state(path, self._init_for_run())

    def params_of(self, state):
        return state.server.params

    def _residual_of(self, state):
        return None  # the reference's traced loop records no residual norm here

    def _init_for_run(self):
        return self.init() if self.scheduler is None else self.scheduler

    def _leaf_table(self, state) -> list:
        from repro_torch.core.stages import k_for

        resolved = state.server._up_resolved
        rates = resolved.rates(self.spec.sparsity, 0)
        rows = []
        for plan, leaf, p in zip(resolved.plans, resolved._leaves_of(state.server.params),
                                 rates):
            n = leaf.numel()
            sparse = not (plan.codec.skip or plan.codec.selector.dense)
            rows.append((plan.path, n, k_for(n, p) if sparse else None, float(p)))
        return rows

    def _finalize_hist(self, hist: dict, n_rounds: int) -> dict:
        hist.update({f"wire_{k}": v for k, v in self.ledger.history().items()})
        hist.update(self.ledger.totals())
        return hist

    def run(self, n_rounds: Optional[int] = None, log_every: int = 0) -> tuple:
        """The scheduler's own loop; with telemetry on, the traced loop of
        :meth:`Run.run` over :meth:`step`, as the reference does."""
        if self.telemetry.enabled:
            return super().run(n_rounds, log_every)
        state = self._init_for_run()
        return state, state.run(self.spec.rounds if n_rounds is None else n_rounds,
                                log_every=log_every)


def _build_fed(spec: RunSpec, dev: torch.device) -> FedRun:
    from repro_torch.data import make_non_iid_lm_task

    cfg, task = build_preset(spec.preset, batch=spec.batch, seq_len=spec.seq_len,
                             seed=spec.seed, device=dev)
    if spec.non_iid:
        if cfg.family not in ("decoder",):
            raise ValueError(f"non_iid needs an LM preset; {spec.preset!r} is {cfg.family}")
        task = make_non_iid_lm_task(vocab=cfg.vocab_size, batch=spec.batch,
                                    seq_len=spec.seq_len, n_clients=spec.clients,
                                    skew=spec.skew, temperature=0.5, seed=spec.seed,
                                    device=dev)
    return FedRun(spec=spec, cfg=cfg, model=build_model(cfg), task=task, device=dev)


TORCHRUN = ("torchrun --standalone --nproc-per-node {n} -m repro_torch.run --preset lenet5 "
            "--backend gspmd --fast --flat-engine exact --device-pack --measure-wire")


def build_run(spec: RunSpec, device=None, group=None, *,
              mesh_shape: Optional[dict] = None) -> Union[LocalRun, GspmdRun, FedRun]:
    """Construct the backend a spec names, on ``device`` (default: the CUDA
    card; an explicit ``"cuda:N"`` picks one of several cards).

    On gspmd the clients are the ranks of ``group`` (a
    :class:`~repro_torch.launch.mesh.ClientGroup`); without one, the
    ranks ``torchrun`` started (:func:`~repro_torch.launch.mesh.
    group_from_env`, on ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over
    gloo with ``device="cpu"``), else one client on ``device``.
    ``mesh_shape`` is the gspmd layout (axis name → size; default
    ``{"data": world, "model": 1}``), the reference's ``mesh=``: the
    world is its client count or its device count (one rank a device);
    the other backends take none.
    ``spec.telemetry`` attaches one enabled
    :class:`~repro_torch.obs.Telemetry` to the run and its channel (the
    fed run's channel and server get it when :meth:`FedRun.init` builds
    them); a disabled run keeps the shared no-op ``NULL_TELEMETRY``."""
    if mesh_shape is not None and spec.backend != "gspmd":
        raise ValueError(f"mesh_shape is a layout of the gspmd backend, not of {spec.backend!r}")
    run = _build(spec, device, group, mesh_shape)
    if spec.telemetry:
        run.telemetry = make_telemetry(run.device)
        if run.channel is not None:
            run.channel.telemetry = run.telemetry
    return run


def _build(spec: RunSpec, device, group, mesh_shape) -> Union[LocalRun, GspmdRun, FedRun]:
    from repro_torch.launch.mesh import group_from_env, launched_by_torchrun, make_host_group

    if spec.backend == "gspmd" and group is None:
        if launched_by_torchrun():
            group = group_from_env(device)
        elif device is None and torch.cuda.device_count() > 1:
            n = torch.cuda.device_count()
            raise NotImplementedError(
                f"the reference puts one client on every local device; the port runs "
                f"one client per process: start {n} of them with `"
                f"{TORCHRUN.format(n=n)}`, or pass device='cuda:0' for a one-card run")
    dev = group.device if group is not None else resolve_device(device)
    if spec.backend == "local":
        return _build_local(spec, dev)
    if spec.backend == "fed":
        return _build_fed(spec, dev)
    group = group or make_host_group(dev)
    cfg, task = build_preset(spec.preset, batch=spec.batch, seq_len=spec.seq_len,
                             seed=spec.seed, device=dev)
    model = build_model(cfg)
    policy = policy_from_spec(spec)
    fns = build_dist_train(cfg, group=group, compressor=spec.compressor,
                           sparsity=spec.sparsity,
                           policy=None if isinstance(policy, Compressor) else as_policy(policy),
                           fast=True if spec.fast else None, flat_engine=spec.flat_engine,
                           measure=spec.measure_wire, device_pack=spec.device_pack,
                           model=model, mesh_shape=mesh_shape)
    return GspmdRun(spec=spec, cfg=cfg, model=model, task=task, channel=fns.channel,
                    fns=fns, n_clients=fns.channel.n_clients, device=dev, group=group)
