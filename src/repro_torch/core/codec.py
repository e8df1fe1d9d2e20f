"""Codec = Selector → Quantizer → Encoder composition (DESIGN.md §2).

Counterpart of ``repro.core.codec``.  A :class:`Codec` glues three
registered stages into one per-leaf compression method with the uniform
:class:`~repro_torch.core.stages.LeafCompressed` IR.  The spec string

    "selector|quantizer|encoder"      e.g. "topk_signed|binarize|golomb"

is what policies and the wire use to name a codec.  Named shorthands
("sbc", ...) are registered through :func:`register_codec`
(:mod:`repro_torch.core.sbc`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core import stages
from repro_torch.core.stages import (
    Encoder,
    LeafCompressed,
    Quantizer,
    Selector,
    decompress_leaf,
    get_encoder,
    get_quantizer,
    get_selector,
    k_for,
)

_SEED_MAX = 2 ** 63 - 1


def split_generator(rng: torch.Generator, device, num: int = 2) -> list:
    """``num`` independent generators on ``device``, seeded from ``rng``
    (the counterpart of ``jax.random.split``)."""
    seeds = torch.randint(0, _SEED_MAX, (num,), generator=rng, device=rng.device).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


@dataclasses.dataclass(frozen=True)
class Codec:
    """One composed compression method for one tensor.

    ``use_residual``: whether error feedback (Eq. 2) wraps this codec.
    """

    selector: Selector
    quantizer: Quantizer
    encoder: Encoder
    use_residual: bool = True

    @property
    def spec(self) -> str:
        return f"{self.selector.name}|{self.quantizer.name}|{self.encoder.name}"

    @property
    def stochastic(self) -> bool:
        return self.selector.stochastic or self.quantizer.stochastic

    @property
    def skip(self) -> bool:
        return self.selector.skip

    @property
    def flat_kind(self):
        """Segment kind in the flat-buffer fast path (DESIGN.md §10):
        "sbc" | "dense" | "skip", or None when a stage has no flat form."""
        if not (self.selector.flat_fast and self.quantizer.flat_fast
                and self.encoder.flat_fast):
            return None
        if self.selector.skip:
            return "skip"
        if self.selector.dense and self.quantizer.name == "identity":
            return "dense"
        if self.spec == "topk_signed|binarize|golomb":
            return "sbc"
        return None

    # ------------------------------------------------------------- per leaf

    def compress_leaf(self, flat: torch.Tensor, p: float,
                      rng: Optional[torch.Generator]) -> LeafCompressed:
        """flat f32[n] → LeafCompressed, on ``flat``'s device.  ``p`` is
        this leaf's sparsity rate; ``rng`` (or None for deterministic
        codecs) is split into independent draws for the selector and the
        quantizer."""
        n = flat.shape[0]
        dev = flat.device
        s_rng = q_rng = None
        if rng is not None:
            s_rng, q_rng = split_generator(rng, dev)
        sel = self.selector(flat, p, s_rng)
        vals_q, scalar = self.quantizer(sel, q_rng)
        empty = torch.zeros((0,), dtype=torch.float32, device=dev)
        if self.selector.skip:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            return LeafCompressed(idx=sel.idx, vals=empty, mean=zero, dense=empty,
                                  nbits=zero)
        if self.selector.dense:
            nbits = self.quantizer.value_bits(n)  # positions cost 0 bits
            return LeafCompressed(
                idx=torch.zeros((0,), dtype=torch.int32, device=dev), vals=empty,
                mean=scalar, dense=vals_q,
                nbits=torch.full((), nbits, dtype=torch.float32, device=dev),
            )
        k = sel.idx.shape[0]
        nbits = self.encoder.position_bits(n, k, p) + self.quantizer.value_bits(k)
        return LeafCompressed(
            idx=sel.idx, vals=vals_q, mean=scalar, dense=empty,
            nbits=torch.full((), nbits, dtype=torch.float32, device=dev),
        )

    def decompress_leaf(self, comp: LeafCompressed, n: int) -> torch.Tensor:
        return decompress_leaf(comp, n)


# ------------------------------------------------------------ codec registry


_CODECS: Dict[str, Any] = {}


def register_codec(name: str):
    """Register a named codec factory (kwargs → Codec)."""

    def deco(factory):
        _CODECS[name] = factory
        return factory

    return deco


def make_codec(spec: Union[str, Codec], **kwargs: Any) -> Codec:
    """Build a codec from a named shorthand, a "sel|quant|enc" spec string,
    or pass an already-built Codec through."""
    if isinstance(spec, Codec):
        return spec
    if spec in _CODECS:
        return _CODECS[spec](**kwargs)
    if "|" in spec:
        sel, quant, enc = spec.split("|")
        return Codec(
            selector=get_selector(sel, **kwargs),
            quantizer=get_quantizer(quant, **kwargs),
            encoder=get_encoder(enc, **kwargs),
            use_residual=kwargs.get("use_residual", True),
        )
    raise KeyError(
        f"unknown codec {spec!r}; named codecs: {sorted(_CODECS)}; "
        f"or compose stages as 'selector|quantizer|encoder' from "
        f"{stages.available_stages()}"
    )


def available_codecs() -> list:
    return sorted(_CODECS)


@register_codec("dense32")
def make_dense32(use_residual: bool = True, **_) -> Codec:
    """Dense 32-bit passthrough: the per-leaf dense-fallback codec."""
    return Codec(
        get_selector("dense"), get_quantizer("identity"), get_encoder("none"),
        use_residual=use_residual,
    )


@register_codec("skip")
def make_skip(**_) -> Codec:
    """Transmit nothing for this leaf.  With error feedback the untransmitted
    update accumulates in the residual (§III hybrid schedules)."""
    return Codec(
        get_selector("skip"), get_quantizer("identity"), get_encoder("none"),
        use_residual=True,
    )


def leaf_k(codec: Codec, n: int, p: float) -> int:
    """Survivor count of ``codec`` on an n-entry leaf at rate p."""
    if codec.skip:
        return 0
    if codec.selector.dense:
        return n
    return k_for(n, p)
