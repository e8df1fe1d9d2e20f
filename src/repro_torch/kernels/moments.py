"""Masked first moments of one tensor for sparse binarization.

Counterpart of ``repro.kernels.moments``.  Given the thresholds t⁺ and t⁻
(from the histogram passes), one streaming pass computes, per paper
Alg. 2 lines 3-4, ``[[Σx·[x ≥ t⁺], n⁺], [Σx·[x ≤ −t⁻], n⁻]]``, so that
μ⁺ = Σ⁺/n⁺ and μ⁻ = −Σ⁻/n⁻.

The sums are taken over partials of ``bm · lanes`` consecutive entries,
each in f64, and the partials are folded in a fixed order and rounded to
f32 once (:func:`repro_torch.kernels.flat.block_moments` and
:func:`~repro_torch.kernels.flat.fold_moments`, which the segment pass
``seg_moments`` uses too).  So the result is the same from run to run,
the plain version equals the CUDA kernel bit for bit, and at ``bm=8,
lanes=128`` a leaf's result equals ``seg_moments``' for the same values
laid out as one segment of the flat buffer.  The reference sums in f32,
so the sums may differ from its in the last ulps.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flat import block_moments, fold_moments
from repro_torch.kernels.hist2side import (
    DEFAULT_BM,
    DEFAULT_LANES,
    check_tile,
    leaf_operand,
    scalar_operand,
)


def masked_moments_plain(flat: torch.Tensor, t_pos, t_neg, *, bm: int = DEFAULT_BM,
                         lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """(2, 2) f32 ``[[Σ⁺, n⁺], [Σ⁻, n⁻]]`` over the entries ``x ≥ t⁺`` and
    ``x ≤ −t⁻``, in the CUDA kernel's order (see the module docstring)."""
    x = flat.to(torch.float32)
    span = check_tile(bm, lanes)
    tp = scalar_operand(t_pos, x.device, name="t_pos")
    tn = scalar_operand(t_neg, x.device, name="t_neg")
    n = x.numel()
    nparts = max(1, -(-n // span))
    pad = nparts * span - n
    valid = torch.nn.functional.pad(torch.ones_like(x, dtype=torch.bool), (0, pad))
    xp = torch.nn.functional.pad(x, (0, pad))
    sums, counts = block_moments(xp.reshape(nparts, span),
                                 ((xp >= tp) & valid).reshape(nparts, span),
                                 ((xp <= -tn) & valid).reshape(nparts, span))
    seg = torch.zeros((nparts,), dtype=torch.int64, device=x.device)
    return fold_moments(sums, counts, seg, 1)[0]


def masked_moments(flat: torch.Tensor, t_pos, t_neg, *, bm: int = DEFAULT_BM,
                   lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """(2, 2) f32 masked moments; see :func:`masked_moments_plain`.

    Replaces the Pallas ``repro.kernels.moments.masked_moments``.  On the
    card: two launches (per-partial f64 sums, then the fixed-order fold),
    counted as one call of this wrapper.
    """
    x = leaf_operand(flat)
    span = check_tile(bm, lanes)
    tp = scalar_operand(t_pos, x.device, name="t_pos")
    tn = scalar_operand(t_neg, x.device, name="t_neg")
    if not x.is_cuda:
        return masked_moments_plain(x, tp, tn, bm=bm, lanes=lanes)
    dev = x.device
    nparts = -(-x.numel() // span)
    psum = torch.empty((nparts, 2), dtype=torch.float64, device=dev)
    pcnt = torch.empty((nparts, 2), dtype=torch.int32, device=dev)
    out = torch.empty((2, 2), dtype=torch.float32, device=dev)
    _build.launch(_build.library().masked_moments_launch, "masked_moments", x,
                  x.data_ptr(), x.numel(), span, tp.data_ptr(), tn.data_ptr(),
                  psum.data_ptr(), pcnt.data_ptr(), out.data_ptr())
    masked_moments.launches += 1
    return out


masked_moments.launches = 0
