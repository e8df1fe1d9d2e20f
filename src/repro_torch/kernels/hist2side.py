"""Two-sided log-magnitude range histogram of one tensor.

Counterpart of ``repro.kernels.hist2side``: the streaming pass of the
histogram-threshold SBC (``repro_torch.kernels.ops.threshold_two_pass``).
It bins the positive entries (row 0) and the magnitudes of the negative
entries (row 1) into ``nbins`` log₂-spaced buckets, each side over its
own half-open magnitude range ``[lo, hi)``; out-of-range values are
ignored.

As in :mod:`repro_torch.kernels.flat`, the kernel has three pieces:
:func:`hist2side_plain`, the plain PyTorch version that a CPU tensor runs
and the CUDA kernel is held against; the wrapper :func:`hist2side`, which
launches the hand-written kernel of ``csrc/seg_sbc.cu`` for a CUDA tensor
(there is no fall back); and ``hist2side.launches``.

The per-leaf wrappers of this module, :mod:`.moments` and
:mod:`.binarize_apply` take any contiguous 1-D float tensor of length
n ≥ 1, cast to f32 as the reference's ``_pad_2d`` does.  The reference
pads a copy to whole ``(bm, lanes)`` tiles; the CUDA kernels guard the
tail instead and need no copy, and a view at an offset that is not 16-byte
aligned takes scalar loads.  ``bm`` and ``lanes`` are kept in the
signatures: they set the partials of :func:`.moments.masked_moments`, and
change neither the histogram nor the binarize pass.  Scalars (ranges,
thresholds, μ, side) are accepted as numbers or tensors and handed to the
kernels as device tensors, so a pipeline whose scalars are device tensors
never waits for the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SPAN_OCTAVES = 30.0  # dynamic range of the coarse pass: [absmax·2⁻³⁰, absmax)

DEFAULT_BM = 256
DEFAULT_LANES = 1024
MAX_NBINS = 4096  # the CUDA kernel's shared-memory bins: 2 · nbins · 4 bytes
MAX_N = 2 ** 31 - 2 ** 20  # int32 indexing in the CUDA kernels, grid stride included


def leaf_operand(flat, name: str = "flat") -> torch.Tensor:
    """Validate a per-leaf operand; return it as f32 (no copy when it is)."""
    if not isinstance(flat, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(flat)}")
    if flat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {flat.device}")
    if not flat.is_floating_point():
        raise TypeError(f"{name} must be a float tensor, got {flat.dtype}")
    if flat.dim() != 1 or not 1 <= flat.numel() <= MAX_N:
        raise ValueError(f"{name} must be 1-D with 1 to {MAX_N} entries, got shape "
                         f"{tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return flat.to(torch.float32)


def scalar_operand(value, device: torch.device, shape: tuple = (),
                   name: str = "scalar") -> torch.Tensor:
    """``value`` (a number or a tensor of one value, or of ``shape``) as a
    contiguous f32 tensor of ``shape`` on ``device``."""
    v = torch.as_tensor(value, dtype=torch.float32, device=device)
    if v.numel() == 1:
        v = v.reshape(())
    try:
        return torch.broadcast_to(v, shape).contiguous()
    except RuntimeError as e:
        raise ValueError(f"{name} of shape {tuple(v.shape)} does not broadcast to "
                         f"{shape}") from e


def _side_pair(value, device: torch.device, name: str) -> tuple[torch.Tensor, int]:
    """A per-side range bound as the CUDA kernel reads it: ``(tensor,
    step)``, side s at element ``s · step`` (one value: step 0)."""
    v = torch.as_tensor(value, dtype=torch.float32, device=device)
    if v.numel() == 1:
        return v.reshape(()), 0
    return scalar_operand(v, device, (2,), name), 1


def check_tile(bm: int, lanes: int) -> int:
    """Validate the tile; return its entries ``bm · lanes``."""
    if not (isinstance(bm, int) and isinstance(lanes, int) and bm >= 1 and lanes >= 1
            and bm * lanes <= MAX_N):
        raise ValueError(f"bm and lanes must be positive ints, got ({bm}, {lanes})")
    return bm * lanes


def hist2side_plain(flat: torch.Tensor, lo, hi, *, nbins: int = 128,
                    bm: int = DEFAULT_BM, lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """(2, nbins) f32: row 0 = positive entries, row 1 = |negatives|.

    ``lo``/``hi`` broadcast to shape (2,): per-side magnitude ranges.
    ``bucket = clip(int((log₂ max(|x|, 1e-38) − log₂ lo) / (log₂ hi −
    log₂ lo) · nbins), 0, nbins − 1)`` with ``lo`` clamped to ``1e-38``
    and ``hi`` to ``2e-38`` inside the logs, the bucket rule of
    :func:`repro_torch.kernels.flat.seg_hist2side_plain`.
    """
    x = flat.to(torch.float32)
    lo = scalar_operand(lo, x.device, (2,), "lo")
    hi = scalar_operand(hi, x.device, (2,), "hi")
    absx = x.abs()
    log_abs = torch.log2(torch.clamp(absx, min=1e-38))
    rows = []
    for side, sel in ((0, x > 0.0), (1, x < 0.0)):
        in_range = sel & (absx >= lo[side]) & (absx < hi[side])
        log_lo = torch.log2(torch.clamp(lo[side], min=1e-38))
        log_hi = torch.log2(torch.clamp(hi[side], min=2e-38))
        f = (log_abs - log_lo) / (log_hi - log_lo)
        bucket = torch.clamp((f * nbins).to(torch.int32), 0, nbins - 1)
        rows.append(torch.bincount(bucket[in_range], minlength=nbins))
    return torch.stack(rows).to(torch.float32)


def hist2side(flat: torch.Tensor, lo, hi, *, nbins: int = 128, bm: int = DEFAULT_BM,
              lanes: int = DEFAULT_LANES) -> torch.Tensor:
    """(2, nbins) f32 histogram; see :func:`hist2side_plain`.

    Replaces the Pallas ``repro.kernels.hist2side.hist2side``.  Counts are
    exact up to 2²⁴ per bin (f32).
    """
    x = leaf_operand(flat)
    check_tile(bm, lanes)
    if not x.is_cuda:
        return hist2side_plain(x, lo, hi, nbins=nbins)
    if not 1 <= nbins <= MAX_NBINS:
        raise ValueError(f"nbins must be in [1, {MAX_NBINS}], got {nbins}")
    # one value serves both sides with a step of 0: no copy to broadcast it
    (lo, lo_step), (hi, hi_step) = (_side_pair(v, x.device, nm)
                                    for v, nm in ((lo, "lo"), (hi, "hi")))
    hist = torch.zeros((2, nbins), dtype=torch.int32, device=x.device)
    _build.launch(_build.library().hist2side_launch, "hist2side", x,
                  x.data_ptr(), x.numel(), lo.data_ptr(), lo_step, hi.data_ptr(), hi_step,
                  hist.data_ptr(), nbins)
    hist2side.launches += 1
    return hist.to(torch.float32)


hist2side.launches = 0


def bucket_lower_edges(lo: torch.Tensor, hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """Lower magnitude edge of every bucket, log₂-spaced.

    ``lo``/``hi`` of shape ``(...,)`` give edges of shape ``(..., nbins)``
    (the reference maps one range at a time with ``jax.vmap``).
    """
    f = torch.arange(nbins, dtype=torch.float32, device=lo.device) / nbins
    log_lo = torch.log2(torch.clamp(lo, min=1e-38))[..., None]
    log_hi = torch.log2(torch.clamp(hi, min=2e-38))[..., None]
    return torch.exp2(log_lo + f * (log_hi - log_lo))
