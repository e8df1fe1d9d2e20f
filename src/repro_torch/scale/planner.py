"""The zoo-wide execution planner (DESIGN.md §15).

Counterpart of ``repro.scale.planner``.  Every config of
``repro_torch/configs/`` gets ONE schema-versioned record, bits a step and
step time, in whichever of three modes its size permits:

``real``
    N measured rounds through :func:`repro_torch.run.build_run` on the
    local backend (the preset's executable variant: the paper's models at
    full size, the assigned archs' ``reduced()`` stand-ins), wire metering
    on, and the analytic cost model reconciled BIT-EXACTLY with the
    measured :class:`~repro_torch.core.ledger.BandwidthLedger` totals.
    On the card each step's clock stops after ``torch.cuda.synchronize``.
``dryrun``
    the FULL config's leaves drawn on the ``meta`` device (no
    allocation), its specs on a device-free
    :class:`~repro_torch.scale.costs.StubMesh`, the exchange priced a
    (leaf, shard, scan row), the step time from the
    :mod:`repro_torch.launch.roofline` peak terms (the H100's datasheet).
``analytic``
    the cost model alone, from ``cfg.param_count()`` (the 400B tier).

Classification is by host memory: ``real`` when the executable variant's
working set (params, and a client's gradient, residual and optimizer
slots) fits ``budget_mb``, ``dryrun`` while the full parameter count
stays under ``DRYRUN_PARAM_CAP``, ``analytic`` beyond; ``mode`` forces
one.  The reasons and modes are the reference's for every config and
budget.
"""
from __future__ import annotations

import functools
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import (ASSIGNED_ARCHS, INPUT_SHAPES, PAPER_ARCHS, ModelConfig,
                                      get_config, reduced)
from repro_torch.core.policy import CompressionPolicy, LeafPlan, moe_rules
from repro_torch.core.tree import tree_flatten
from repro_torch.launch.roofline import HBM_BW, ICI_BW, model_flops_for, peak_flops
from repro_torch.scale import costs
from repro_torch.scale.costs import OPT_SLOTS, StubMesh

SCHEMA = 1
MODES = ("real", "dryrun", "analytic")
ALL_ARCHS = PAPER_ARCHS + ASSIGNED_ARCHS

# real mode's default: the paper's own models (LeNet5 about 82 MB,
# CharLSTM 23 MB, WordLSTM 5 MB of working set at 4 clients) fit, the
# reduced assigned stand-ins (98-226 MB, their vocabularies) stay dryrun
DEFAULT_BUDGET_MB = 96
# past about 60B analytic params even the meta leaves are not worth their
# time: llama4-maverick (400B) is the analytic tier's proof point
DRYRUN_PARAM_CAP = 60e9

# the presets a local run can train (the cnn branch has a task for
# lenet5's 28×28 grayscale preset alone)
_REAL_PRESETS = {"lenet5", "charlstm"}
_REAL_FAMILIES = {"decoder", "encdec", "lstm"}


def policy_for(cfg: ModelConfig, compressor: str = "sbc",
               moe_aware: bool = True) -> CompressionPolicy:
    """The policy a config is priced (and run) under: the compressor's own,
    with the §15 MoE rules in front when the config routes experts."""
    from repro_torch.core.api import make_compressor
    from repro_torch.run.build import as_policy

    pol = as_policy(make_compressor(compressor))
    if moe_aware and cfg.moe_experts:
        return CompressionPolicy(default=pol.default,
                                 rules=moe_rules(cfg.moe_experts, cfg.moe_top_k) + pol.rules,
                                 name=f"{pol.name}+moe", fast=pol.fast)
    return pol


def executable_config(name: str) -> ModelConfig:
    """What a ``real`` run of ``name`` trains (the presets' rule: the
    paper's models at full size, the assigned archs reduced)."""
    cfg = get_config(name)
    return cfg if name in _REAL_PRESETS else reduced(cfg)


def _meta_params(cfg: ModelConfig) -> tuple:
    """``(model, params)``: the model and its leaves on the ``meta`` device."""
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    with torch.device("meta"):
        return model, model.init(torch.Generator())


@functools.lru_cache(maxsize=64)
def executable_param_count(name: str) -> int:
    """The executable variant's EXACT parameter count, from its leaves on
    the ``meta`` device (``cfg.param_count()`` estimates a transformer's)."""
    _, params = _meta_params(executable_config(name))
    return int(sum(math.prod(x.shape) for x in tree_flatten(params)[0]))


def host_working_set_bytes(name: str, clients: int = 4) -> int:
    """The f32 bytes a local run of ``name`` holds: the server's params and
    each client's gradient, residual and optimizer slots."""
    cfg = executable_config(name)
    slots = OPT_SLOTS.get(cfg.local_opt, 1)
    return 4 * executable_param_count(name) * (1 + clients * (2 + slots))


def classify(name: str, *, budget_mb: int = DEFAULT_BUDGET_MB,
             mode: Optional[str] = None) -> tuple[str, str]:
    """(mode, reason) for one config."""
    if mode:
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; have {MODES}")
        return mode, "forced by --mode"
    cfg = get_config(name)
    runnable = name in _REAL_PRESETS or cfg.family in _REAL_FAMILIES
    if runnable:
        ws = host_working_set_bytes(name)
        if ws <= budget_mb * (1 << 20):
            return "real", (f"executable working set {ws / 2**20:.1f} MB ≤ "
                            f"budget {budget_mb} MB")
    if cfg.param_count() <= DRYRUN_PARAM_CAP:
        why = "" if runnable else f"no local preset for family {cfg.family!r}; "
        return "dryrun", (why + f"{cfg.param_count() / 1e9:.1f}B params ≤ "
                          f"{DRYRUN_PARAM_CAP / 1e9:.0f}B dryrun cap")
    return "analytic", f"{cfg.param_count() / 1e9:.0f}B params above the dryrun cap"


# ------------------------------------------------------------------ modes


def _roofline(cfg: ModelConfig, param_bytes: int, exchange_bits: float, n_dev: int) -> dict:
    """Peak-rate step-time terms (no step is run): compute at the peak of
    the config's dtype, the weights' traffic at HBM's rate, the exchange
    at NVLink's; the H100 datasheet terms of
    :mod:`repro_torch.launch.roofline`."""
    shape = INPUT_SHAPES["train_4k"]
    flops = model_flops_for(cfg, shape, "train")
    compute_s = flops / (n_dev * peak_flops(cfg.dtype))
    memory_s = 2.0 * param_bytes / (n_dev * HBM_BW)
    exchange_s = (exchange_bits / 8.0) / (n_dev * ICI_BW)
    return {"compute_s": compute_s, "memory_s": memory_s, "exchange_s": exchange_s,
            "step_s": max(compute_s, memory_s) + exchange_s}


def _base_record(name: str, cfg: ModelConfig, mode: str, reason: str, compressor: str,
                 sparsity: float, clients: int) -> dict:
    return {
        "schema": SCHEMA, "arch": name, "family": cfg.family, "mode": mode, "reason": reason,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "compressor": compressor, "sparsity": sparsity, "clients": clients,
        "mesh": list(StubMesh().devices.shape),
    }


def plan_analytic(name: str, *, compressor: str = "sbc", sparsity: float = 0.001,
                  clients: int = 4, reason: str = "") -> dict:
    """Mode 3: price from the analytic parameter count alone."""
    cfg = get_config(name)
    pol = policy_for(cfg, compressor)
    n = cfg.param_count()
    plan = LeafPlan(path="params", codec=pol.default, sparsity=None, schedule=None)
    up = costs.leaf_bits(plan, n, sparsity)
    rec = _base_record(name, cfg, "analytic", reason, compressor, sparsity, clients)
    rec.update(
        n_leaves=None, up_bits_per_step=up, up_bits_f32_ledger=float(np.float32(up)),
        dense_bits=32.0 * n, compression_rate=32.0 * n / max(up, 1.0), framing_bytes=None,
        param_bytes=4 * n, residual_bytes=4 * n,
        optimizer_bytes=4 * n * OPT_SLOTS.get(cfg.local_opt, 1), exchange_bits_per_step=None,
        roofline_est=_roofline(cfg, 4 * n, up, int(np.prod(StubMesh().devices.shape))),
        reconciles=bool(np.isfinite(up) and up > 0.0),
    )
    return rec


def plan_dryrun(name: str, *, compressor: str = "sbc", sparsity: float = 0.001,
                clients: int = 4, reason: str = "") -> dict:
    """Mode 2: the FULL config's leaves on the ``meta`` device, its specs
    on the stub layout, priced a leaf.  Nothing is allocated."""
    from repro_torch.core.policy import path_str
    from repro_torch.core.tree import tree_flatten_with_path

    cfg = get_config(name)
    model, params = _meta_params(cfg)
    pol = policy_for(cfg, compressor)
    resolved = pol.resolve(params)
    leaves = tree_flatten(params)[0]
    mesh = StubMesh()
    flat, treedef = tree_flatten_with_path(params)
    specs = treedef.flatten_up_to(model.param_specs(params, mesh.shape_map))
    rates = resolved.rates(sparsity)
    report = costs.price(resolved, leaves, rates, opt=cfg.local_opt,
                         paths=[path_str(p) for p, _ in flat], specs=specs, mesh=mesh)
    rec = _base_record(name, cfg, "dryrun", reason, compressor, sparsity, clients)
    rec.update(
        n_leaves=report.n_leaves, up_bits_per_step=report.up_bits_per_client,
        up_bits_f32_ledger=report.up_bits_f32_ledger, dense_bits=report.dense_bits,
        compression_rate=report.compression_rate, framing_bytes=report.framing_bytes,
        param_bytes=report.param_bytes, residual_bytes=report.residual_bytes,
        optimizer_bytes=report.optimizer_bytes, exchange_bits_per_step=report.exchange_bits,
        roofline_est=_roofline(cfg, report.param_bytes, report.exchange_bits,
                               int(np.prod(mesh.devices.shape))),
        # the f32 ledger replay tracks the f64 walk to f32 resolution
        reconciles=bool(abs(report.up_bits_f32_ledger - report.up_bits_per_client)
                        <= 1e-4 * max(report.up_bits_per_client, 1.0)),
    )
    return rec


def plan_real(name: str, *, compressor: str = "sbc", sparsity: float = 0.001,
              clients: int = 4, rounds: int = 8, reason: str = "", telemetry: bool = False,
              seed: int = 0, device=None):
    """Mode 1: N measured rounds on ``device`` (default the card), the cost
    model reconciled BIT-EXACTLY with the ledger.  Returns (record, run):
    the run, so callers can export its telemetry."""
    from repro_torch.run import RunSpec, build_run

    spec = RunSpec(preset=name, backend="local", rounds=rounds, batch=16, seq_len=32,
                   clients=clients, delay=1, sparsity=sparsity, compressor=compressor,
                   fast=False, measure_wire=True, telemetry=telemetry, seed=seed)
    run = build_run(spec, device=device)
    state = run.init()
    step_ms = []
    for r in range(rounds):
        t0 = time.perf_counter()
        state, m = run.step(state, r)
        if run.device.type == "cuda":
            torch.cuda.synchronize(run.device)
        step_ms.append(1e3 * (time.perf_counter() - t0))
    if telemetry:
        run.telemetry.metrics.ingest_ledger(run.ledger)

    # the reconcile: replay the device's f32 sum on the host
    resolved = run.trainer.resolved(state.params)
    leaves = tree_flatten(state.params)[0]
    sizes = [int(math.prod(x.shape)) if x.dim() else 1 for x in leaves]
    predicted = 0.0
    f64_per_client = 0.0
    for r in range(rounds):
        f64, f32 = costs.upstream_bits(resolved, sizes, resolved.rates(sparsity, r))
        predicted += float(f32) * clients  # what record_round stores
        f64_per_client = f64
    totals = run.ledger.totals()
    measured = totals["up_bits_analytic"]

    cfg = executable_config(name)
    full = get_config(name)
    report = costs.price(resolved, leaves, resolved.rates(sparsity, rounds - 1),
                         opt=full.local_opt)
    rec = _base_record(name, full, "real", reason, compressor, sparsity, clients)
    rec.update(
        n_leaves=report.n_leaves, up_bits_per_step=f64_per_client,
        up_bits_f32_ledger=report.up_bits_f32_ledger, dense_bits=report.dense_bits,
        compression_rate=report.compression_rate, framing_bytes=report.framing_bytes,
        param_bytes=report.param_bytes, residual_bytes=report.residual_bytes,
        optimizer_bytes=report.optimizer_bytes, exchange_bits_per_step=None,
        roofline_est=None,
        reconciles=bool(predicted == measured),  # BIT-exact, not approximate
        real={
            "executed_params": int(sum(sizes)), "executed_arch": cfg.name, "rounds": rounds,
            "up_bits_ledger": measured, "up_bits_predicted": predicted,
            "up_bytes_measured": totals.get("up_bytes", 0),
            "measured_ratio": (8.0 * totals.get("up_bytes", 0) / measured
                               if measured else None),
            "step_ms_mean": float(np.mean(step_ms[1:] or step_ms)),
            "step_ms_warm": step_ms[0],
            "device": str(run.device),
        },
    )
    return rec, run


# ------------------------------------------------------------- the zoo


def plan(name: str, *, mode: Optional[str] = None, budget_mb: int = DEFAULT_BUDGET_MB,
         compressor: str = "sbc", sparsity: float = 0.001, clients: int = 4, rounds: int = 8,
         telemetry: bool = False, device=None):
    """One config → (record, run or None); ``device`` is a real run's."""
    picked, reason = classify(name, budget_mb=budget_mb, mode=mode)
    kw = dict(compressor=compressor, sparsity=sparsity, clients=clients, reason=reason)
    if picked == "real":
        return plan_real(name, rounds=rounds, telemetry=telemetry, device=device, **kw)
    if picked == "dryrun":
        return plan_dryrun(name, **kw), None
    return plan_analytic(name, **kw), None


def plan_zoo(names: Optional[Sequence[str]] = None, *, budget_mb: int = DEFAULT_BUDGET_MB,
             mode: Optional[str] = None, compressor: str = "sbc", sparsity: float = 0.001,
             clients: int = 4, rounds: int = 8, device=None) -> list[dict]:
    """Records of the whole zoo (or ``names``), in ``ALL_ARCHS``' order."""
    out = []
    for name in names or ALL_ARCHS:
        rec, _ = plan(name, mode=mode, budget_mb=budget_mb, compressor=compressor,
                      sparsity=sparsity, clients=clients, rounds=rounds, device=device)
        out.append(rec)
    return out
