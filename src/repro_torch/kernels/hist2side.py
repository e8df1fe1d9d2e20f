"""Bucket geometry of the two-sided log-magnitude histogram.

Counterpart of the plain-array parts of ``repro.kernels.hist2side``: the
coarse pass's dynamic range and the lower magnitude edge of every bucket.
(The per-leaf ``hist2side`` kernel itself is still to be ported.)
"""
from __future__ import annotations

import torch

SPAN_OCTAVES = 30.0  # dynamic range of the coarse pass: [absmax·2⁻³⁰, absmax)


def bucket_lower_edges(lo: torch.Tensor, hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """Lower magnitude edge of every bucket, log₂-spaced.

    ``lo``/``hi`` of shape ``(...,)`` give edges of shape ``(..., nbins)``
    (the reference maps one range at a time with ``jax.vmap``).
    """
    f = torch.arange(nbins, dtype=torch.float32, device=lo.device) / nbins
    log_lo = torch.log2(torch.clamp(lo, min=1e-38))[..., None]
    log_hi = torch.log2(torch.clamp(hi, min=2e-38))[..., None]
    return torch.exp2(log_lo + f * (log_hi - log_lo))
