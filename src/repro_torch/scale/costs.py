"""The analytic cost model of one training step (DESIGN.md §15).

Counterpart of ``repro.scale.costs``: prices one step of any (config,
policy, layout) from leaf shapes, the
:class:`~repro_torch.core.policy.ResolvedPolicy`'s rates and the
layout's sharding, without running it:

* **upstream bits**: the Eq. 1 walk the channels meter, per leaf
  ``encoder.position_bits(n, k, p) + quantizer.value_bits(k)`` with
  ``k = k_for(n, p)``; dense leaves ``value_bits(n)``; skipped leaves 0.
  Two sums: the f64 truth, and an f32 sequential sum in plan order, the
  value the ledger's ``up_bits_analytic`` records (each leaf's ``nbits``
  is an f32 scalar on the device, summed in plan order), bit for bit;
* **SBW1 framing**: the wire container's 8-byte header and 4-byte length
  prefix a leaf (:mod:`repro_torch.core.wire`);
* **residual and optimizer memory** a client;
* **the sharded exchange**: ``L·S·(position_bits(n_loc, k_loc, p) +
  value_bits(k_loc))`` a leaf, the shard count S from the model's spec
  rules on a layout (:class:`StubMesh`, no device).

Every function equals the reference's bit for bit on every config
(``tests/test_torch_scale.py``); only shapes are read, so the leaves may
live on the ``meta`` device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import LeafPlan, ResolvedPolicy
from repro_torch.core.stages import k_for

# SBW1 container framing (repro_torch.core.wire): magic + u32 leaf count,
# then a u32 payload-length prefix a leaf
SBW1_HEADER_BYTES = 8
SBW1_PER_LEAF_BYTES = 4

# optimizer slots a parameter (f32 slots a weight)
OPT_SLOTS = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 2}


def _size(shape) -> int:
    return int(math.prod(tuple(shape))) if tuple(shape) else 1


def leaf_bits(plan: LeafPlan, n: int, rate: float) -> float:
    """Eq. 1 upstream bits of one n-entry leaf at ``rate`` (f64): the
    arithmetic of :func:`repro_torch.core.channel.analytic_bits`."""
    codec = plan.codec
    if codec.skip:
        return 0.0
    if codec.selector.dense:
        return float(codec.quantizer.value_bits(n))
    k = k_for(n, rate)
    return float(codec.encoder.position_bits(n, k, rate) + codec.quantizer.value_bits(k))


def upstream_bits(resolved: ResolvedPolicy, sizes: Sequence[int],
                  rates: Sequence[float]) -> Tuple[float, float]:
    """(f64 bits a client, f32-ledger bits a client): the second replays
    the device's sum, each leaf's bits cast to f32 and added in plan
    order, the ``bits_per_client`` the local channel hands the ledger."""
    f64 = 0.0
    f32 = np.float32(0.0)
    for plan, n, p in zip(resolved.plans, sizes, rates):
        nb = leaf_bits(plan, int(n), float(p))
        f64 += nb
        f32 = f32 + np.float32(nb)
    return f64, float(f32)


def framing_bytes(n_leaves: int) -> int:
    """SBW1 container overhead of one packed client upload."""
    return SBW1_HEADER_BYTES + SBW1_PER_LEAF_BYTES * n_leaves


def memory_bytes(resolved: ResolvedPolicy, sizes: Sequence[int], *,
                 opt: str = "momentum") -> dict:
    """A client's steady-state memory: params, the f32 error-feedback
    residual (leaves whose codec keeps one) and the optimizer's slots."""
    n_params = int(sum(int(s) for s in sizes))
    residual = sum(4 * int(n) for plan, n in zip(resolved.plans, sizes)
                   if plan.codec.use_residual) if resolved.any_residual else 0
    slots = OPT_SLOTS.get(opt, 1)
    return {"param_bytes": 4 * n_params, "residual_bytes": int(residual),
            "optimizer_bytes": 4 * n_params * slots}


# ---------------------------------------------------------------- sharded


class StubMesh:
    """A layout with no devices: the spec rules of
    :func:`repro_torch.models.model.make_param_specs` read only its axis
    sizes (:attr:`shape_map`, the layout dict ``Model.param_specs``
    takes), so a 256-device layout needs nothing allocated."""

    def __init__(self, shape=(16, 16), axis_names=("data", "model")):
        self.axis_names = tuple(axis_names)
        self.devices = np.zeros(tuple(shape), dtype=np.int8)

    @property
    def shape_map(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _n_shards(spec, axis_size: dict) -> int:
    """The shards a spec cuts a leaf into: the product of the sizes of
    every axis it names."""
    total = 1
    for entry in tuple(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for ax in axes:
            total *= int(axis_size.get(ax, 1))
    return total


def sharded_exchange_bits(resolved: ResolvedPolicy, leaves: Sequence, paths: Sequence[str],
                          specs: Sequence, rates: Sequence[float], mesh: StubMesh) -> float:
    """A step's exchange on a layout (f64 bits): each shard compresses its
    local block on its own (its own k and one scalar a row), a scanned
    stack prices one row a superblock; a dense leaf sends its 32-bit
    values once, a skipped leaf nothing."""
    axis_size = mesh.shape_map
    total = 0.0
    for plan, leaf, path, spec, rate in zip(resolved.plans, leaves, paths, specs, rates):
        size = _size(leaf.shape)
        codec = plan.codec
        if codec.skip:
            continue
        if codec.selector.dense:
            total += 32.0 * size
            continue
        scanned = "stack/scan" in path or path.startswith("scan")
        shape = tuple(leaf.shape)
        L = shape[0] if scanned and len(shape) > 1 else 1
        S = _n_shards(spec, axis_size)
        n_loc = max(1, size // (L * S))
        k_loc = max(1, min(n_loc, int(round(rate * n_loc))))
        total += L * S * float(codec.encoder.position_bits(n_loc, k_loc, rate)
                               + codec.quantizer.value_bits(k_loc))
    return total


# ------------------------------------------------------------- full report


@dataclasses.dataclass(frozen=True)
class CostReport:
    """One priced (config, policy, layout)."""

    n_params: int
    n_leaves: int
    up_bits_per_client: float  # f64 Eq. 1 truth
    up_bits_f32_ledger: float  # what the ledger's up_bits_analytic sees
    dense_bits: float  # the 32-bit dense upload
    framing_bytes: int  # SBW1 container overhead an upload
    param_bytes: int
    residual_bytes: int
    optimizer_bytes: int
    exchange_bits: Optional[float] = None  # the sharded exchange a step

    @property
    def compression_rate(self) -> float:
        return self.dense_bits / max(self.up_bits_per_client, 1.0)

    def as_record(self) -> dict:
        d = dataclasses.asdict(self)
        d["compression_rate"] = self.compression_rate
        return d


def price(resolved: ResolvedPolicy, leaves: Sequence, rates: Sequence[float], *,
          opt: str = "momentum", paths: Optional[Sequence[str]] = None,
          specs: Optional[Sequence] = None, mesh: Optional[StubMesh] = None) -> CostReport:
    """Price one step.  Only the shapes of ``leaves`` are read (tensors on
    any device, ``meta`` included); pass ``paths``, ``specs`` and ``mesh``
    for the sharded exchange."""
    sizes = [_size(x.shape) for x in leaves]
    f64, f32 = upstream_bits(resolved, sizes, rates)
    mem = memory_bytes(resolved, sizes, opt=opt)
    exchange = None
    if specs is not None and mesh is not None and paths is not None:
        exchange = sharded_exchange_bits(resolved, leaves, paths, specs, rates, mesh)
    return CostReport(
        n_params=int(sum(sizes)), n_leaves=len(sizes), up_bits_per_client=f64,
        up_bits_f32_ledger=f32, dense_bits=32.0 * float(sum(sizes)),
        framing_bytes=framing_bytes(len(sizes)), exchange_bits=exchange, **mem)
