"""Compressor API for communication-efficient DSGD (paper Alg. 1).

Counterpart of ``repro.core.api``.  The abstraction is the staged codec
pipeline:

  :mod:`repro_torch.core.stages`  Selector → Quantizer → Encoder registry
  :mod:`repro_torch.core.codec`   Codec: one composed per-leaf method
  :mod:`repro_torch.core.policy`  CompressionPolicy: per-leaf codecs by path
  :mod:`repro_torch.core.wire`    pack/unpack: compressed trees ⇄ bytes

:class:`Compressor` is a named policy with the leaf and tree call surface
(``compress_leaf``/``decompress_leaf``/``compress``/``decompress``/
``init_state``); :func:`make_compressor` looks one up by the name a
``RunSpec`` gives.  Importing :mod:`repro_torch.core` registers ``"sbc"``
(:mod:`repro_torch.core.sbc`) and the paper's baselines
(:mod:`repro_torch.core.baselines`), as the reference's package does.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.core.codec import Codec
from repro_torch.core.policy import (
    CompressionPolicy,
    CompressorState,
    PolicyRule,
    ResolvedPolicy,
)
from repro_torch.core.stages import LeafCompressed, decompress_leaf, k_for
from repro_torch.core.tree import tree_flatten

PyTree = Any

__all__ = [
    "Compressor",
    "CompressorState",
    "CompressionPolicy",
    "PolicyRule",
    "LeafCompressed",
    "register",
    "get_compressor",
    "make_compressor",
    "available",
    "k_for",
]

@dataclasses.dataclass(frozen=True)
class Compressor:
    """A named compression method: a policy with the per-leaf and per-tree
    call surface.  ``compress_leaf``/``decompress_leaf`` use the policy's
    default codec; ``compress``/``decompress`` resolve the whole policy."""

    name: str
    policy: CompressionPolicy

    @classmethod
    def from_codec(cls, name: str, codec: Union[str, Codec], **kw: Any) -> "Compressor":
        return cls(name=name, policy=CompressionPolicy.single(codec, name=name, **kw))

    @classmethod
    def from_policy(cls, name: str, policy: CompressionPolicy) -> "Compressor":
        return cls(name=name, policy=policy)

    @property
    def codec(self) -> Codec:
        return self.policy.default

    @property
    def use_residual(self) -> bool:
        return self.codec.use_residual

    @property
    def stochastic(self) -> bool:
        return self.codec.stochastic

    # ------------------------------------------------------------ leaf API

    def compress_leaf(self, flat: torch.Tensor, p: float,
                      rng: Optional[torch.Generator]) -> LeafCompressed:
        return self.codec.compress_leaf(flat, p, rng)

    def decompress_leaf(self, comp: LeafCompressed, n: int) -> torch.Tensor:
        return decompress_leaf(comp, n)

    # ------------------------------------------------------------ tree API

    def resolve(self, tree: PyTree) -> ResolvedPolicy:
        return self.policy.resolve(tree)

    def init_state(self, params: PyTree, rng=None) -> CompressorState:
        return self.policy.resolve(params).init_state(params, rng)

    def compress(self, delta: PyTree, state: CompressorState,
                 sparsity: Union[float, Tuple[float, ...]]) -> tuple:
        """Compress a full update tree with error feedback (Eq. 2).

        ``sparsity``: the global rate (per-leaf rule overrides win), or an
        explicit per-leaf rate tuple from ``ResolvedPolicy.rates``.  A policy
        with per-round schedules needs the tuple: a bare float raises, so a
        schedule is never pinned to its round-0 rate.
        """
        resolved = self.policy.resolve(delta)
        if isinstance(sparsity, tuple):
            rates = sparsity
        else:
            scheduled = [p.path for p in resolved.plans if p.schedule is not None]
            if scheduled:
                raise ValueError(
                    "policy attaches per-round sparsity schedules to "
                    f"{scheduled[:3]}…; pass resolve(delta).rates(p, round) "
                    "instead of a bare float so the schedule advances"
                )
            rates = resolved.rates(float(sparsity))
        return resolved.compress(delta, state, rates)

    def decompress(self, compressed: PyTree, like: PyTree) -> PyTree:
        """Reconstruct a dense update tree through ``like``'s structure."""
        return self.policy.resolve(like).decompress(compressed, like)

    def total_bits(self, compressed: PyTree) -> torch.Tensor:
        """Sum of analytic wire bits across leaves (Eq. 1 inner term)."""
        return sum(c.nbits for c in tree_flatten(compressed)[0])


# --------------------------------------------------------------- registry

_REGISTRY: Dict[str, Callable[..., Compressor]] = {}


def register(name: str) -> Callable:
    def deco(factory: Callable[..., Compressor]) -> Callable[..., Compressor]:
        _REGISTRY[name] = factory
        return factory

    return deco


def make_compressor(name: str, **kwargs: Any) -> Compressor:
    """Instantiate a registered compressor by name (``RunSpec.compressor``)."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown compressor {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def get_compressor(name: str, **kwargs: Any) -> Compressor:
    """Legacy name for :func:`make_compressor` (same registry, same
    Compressor); warns with a ``DeprecationWarning``."""
    warnings.warn(
        "get_compressor() is the legacy seed surface; name the compressor "
        "in a repro_torch.run.RunSpec (spec.compressor) or call "
        "repro_torch.core.api.make_compressor() (same registry, bit-identical)",
        DeprecationWarning,
        stacklevel=2,
    )
    return make_compressor(name, **kwargs)


def available() -> list:
    return sorted(_REGISTRY)
