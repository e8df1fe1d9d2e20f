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


def moments_grid(nparts: int, gpw: int, sms: int) -> int:
    """CTAs of the CUDA ``masked_moments`` launch: one warp a unit of
    ``gpw`` groups of a partial (8 groups a partial), 8 warps a CTA, and
    at least one CTA an SM while there are units (a few units of a large
    span then run on SMs of their own)."""
    units = nparts * (8 // gpw)
    return max(-(-units // 8), min(units, sms))


def masked_moments(flat: torch.Tensor, t_pos, t_neg, *, bm: int = DEFAULT_BM,
                   lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """(2, 2) f32 masked moments; see :func:`masked_moments_plain`.

    Replaces the Pallas ``repro.kernels.moments.masked_moments``.  On the
    card: one launch and one device operation.  A warp sums a partial (or,
    for spans of more than 1,024 entries, a share of its 8 groups of 32
    "threads", added in order by the share that finishes last), and the
    last CTA folds the partials.
    """
    x = leaf_operand(flat)
    span = check_tile(bm, lanes)
    tp = scalar_operand(t_pos, x.device, name="t_pos")
    tn = scalar_operand(t_neg, x.device, name="t_neg")
    if x.is_meta:
        _build.meta_launch("masked_moments", 4 * (x.numel() + 2 + 4))
        return x.new_empty((2, 2))
    if not x.is_cuda:
        return masked_moments_plain(x, tp, tn, bm=bm, lanes=lanes)
    dev = x.device
    lib = _build.library()
    nparts = -(-x.numel() // span)
    gpw = lib.masked_moments_gpw(span)
    split = 8 // gpw
    # f64 words: psum double2, a split partial's group sums double2[8], then
    # pcnt uint2 and a split partial's counts uint2 a unit
    words = 3 * nparts + (0 if split == 1 else 16 * nparts + split * nparts)
    scratch = torch.empty((words,), dtype=torch.float64, device=dev)
    ws = _build.workspace(dev, 1 + (nparts if split > 1 else 0))
    out = torch.empty((2, 2), dtype=torch.float32, device=dev)
    grid = moments_grid(nparts, gpw, _build.sm_count(dev.index))
    _build.launch(lib.masked_moments_launch, "masked_moments", x,
                  x.data_ptr(), x.numel(), span, tp.data_ptr(), tn.data_ptr(),
                  scratch.data_ptr(), ws.data_ptr(), out.data_ptr(), grid)
    masked_moments.launches += 1
    return out


masked_moments.launches = 0
