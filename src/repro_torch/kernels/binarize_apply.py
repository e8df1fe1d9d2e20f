"""Fused sparse-binarize apply and residual update of one tensor.

Counterpart of ``repro.kernels.binarize_apply``: the final pass of SBC
compression (paper Alg. 2 lines 5-8 and Eq. 2)::

    mask  = pos_wins ? (x ≥ t⁺) : (x ≤ −t⁻)
    ΔW*   = μ · mask                     (μ already signed: +μ⁺ or −μ⁻)
    R_new = x − ΔW*

One read and two writes.  Elementwise, so the CUDA kernel and the plain
version are equal bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.hist2side import (
    DEFAULT_BM,
    DEFAULT_LANES,
    check_tile,
    leaf_operand,
    scalar_operand,
)


def binarize_apply_plain(flat: torch.Tensor, t_pos, t_neg, mu, pos_wins, *,
                         bm: int = DEFAULT_BM, lanes: int = DEFAULT_LANES
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ΔW*, R_new)``, both f32 of the input's length; ``pos_wins`` > 0.5
    selects the positive side."""
    x = flat.to(torch.float32)
    tp, tn, m, side = (scalar_operand(v, x.device, name=nm) for v, nm in (
        (t_pos, "t_pos"), (t_neg, "t_neg"), (mu, "mu"), (pos_wins, "pos_wins")))
    mask = torch.where(side > 0.5, x >= tp, x <= -tn)
    out = torch.where(mask, m, torch.zeros((), dtype=x.dtype, device=x.device))
    return out, x - out


def binarize_apply(flat: torch.Tensor, t_pos, t_neg, mu, pos_wins, *,
                   bm: int = DEFAULT_BM, lanes: int = DEFAULT_LANES
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ΔW*, R_new)``; see :func:`binarize_apply_plain`.

    Replaces the Pallas ``repro.kernels.binarize_apply.binarize_apply``.
    """
    x = leaf_operand(flat)
    check_tile(bm, lanes)
    tp, tn, m, side = (scalar_operand(v, x.device, name=nm) for v, nm in (
        (t_pos, "t_pos"), (t_neg, "t_neg"), (mu, "mu"), (pos_wins, "pos_wins")))
    if x.is_meta:
        _build.meta_launch("binarize_apply", 4 * (3 * x.numel() + 4))
        return torch.empty_like(x), torch.empty_like(x)
    if not x.is_cuda:
        return binarize_apply_plain(x, tp, tn, m, side)
    out = torch.empty_like(x)
    res = torch.empty_like(x)
    _build.launch(_build.library().binarize_apply_launch, "binarize_apply", x,
                  x.data_ptr(), x.numel(), tp.data_ptr(), tn.data_ptr(), m.data_ptr(),
                  side.data_ptr(), out.data_ptr(), res.data_ptr())
    binarize_apply.launches += 1
    return out, res


binarize_apply.launches = 0
