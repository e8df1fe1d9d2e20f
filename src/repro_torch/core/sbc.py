"""Sparse Binary Compression: paper Alg. 2 as a staged codec.

Counterpart of ``repro.core.sbc``.  Per flattened tensor ΔW with sparsity
rate p:

  1. val⁺ ← top_{p%}(ΔW),  val⁻ ← top_{p%}(−ΔW)
  2. μ⁺ ← mean(val⁺),  μ⁻ ← mean(val⁻)
  3. if μ⁺ > μ⁻:  ΔW* = μ⁺ at the positions of val⁺   (all else 0)
     else:        ΔW* = −μ⁻ at the positions of val⁻
  4. wire form: k positions (Golomb-coded, Eq. 5) + ONE 32-bit mean.

In the stage pipeline that is ``topk_signed → binarize → golomb``.  Error
feedback (Eq. 2) is applied by
:meth:`repro_torch.core.policy.ResolvedPolicy.compress`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import api
from repro_torch.core.codec import Codec, register_codec
from repro_torch.core.stages import (
    LeafCompressed,
    decompress_leaf,
    get_encoder,
    get_quantizer,
    get_selector,
)


@register_codec("sbc")
def make_sbc_codec(**_: object) -> Codec:
    return Codec(
        selector=get_selector("topk_signed"),
        quantizer=get_quantizer("binarize"),
        encoder=get_encoder("golomb"),
        use_residual=True,
    )


SBC_CODEC = make_sbc_codec()


def sbc_compress_leaf(flat: torch.Tensor, p: float,
                      rng: Optional[torch.Generator]) -> LeafCompressed:
    return SBC_CODEC.compress_leaf(flat, p, rng)


def sbc_decompress_leaf(comp: LeafCompressed, n: int) -> torch.Tensor:
    return decompress_leaf(comp, n)


@api.register("sbc")
def make_sbc(**_: object) -> api.Compressor:
    return api.Compressor.from_codec("sbc", SBC_CODEC)


# The paper's three evaluated configurations (§IV-B): (delay n, sparsity p).
SBC_PRESETS: dict = {
    "sbc1": (1, 0.001),   # no delay, 0.1% gradient sparsity
    "sbc2": (10, 0.01),   # 10-step delay, 1% sparsity
    "sbc3": (100, 0.01),  # 100-step delay, 1% sparsity
}
