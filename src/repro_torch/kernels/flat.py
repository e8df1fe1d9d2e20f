"""Segment-aware SBC passes over ONE block-padded flat buffer.

Counterpart of ``repro.kernels.flat``.  Each pass has three pieces here:

  * ``*_plain``  the plain PyTorch version of the function — what a CPU
    tensor runs, and what the CUDA kernel is held against on the card;
  * the wrapper (``seg_hist2side``, ``seg_moments``,
    ``seg_binarize_apply``) — checks device, dtype, shape and contiguity;
    a CPU tensor goes to the plain version, a CUDA tensor to the
    hand-written kernel in ``csrc/seg_sbc.cu`` (there is no fall back:
    a CUDA tensor launches the kernel or raises);
  * ``<wrapper>.launches`` — an integer that the wrapper raises by one each
    time it launches its kernel, and nowhere else.

Layout: leaf i occupies whole ``(bm, lanes)`` blocks, its tail zero-padded,
so every block belongs to one segment; block b's scalars ride in row b of
a ``(nblocks, P)`` f32 params array (the segment id, where a pass needs
it, is column 0, stored as f32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# ------------------------------------------------------------------ checks


def _check(xpad: torch.Tensor, params: torch.Tensor, ncols: int, bm: int,
           lanes: int) -> int:
    """Validate the operands; return the number of data blocks."""
    for name, t in (("xpad", xpad), ("params", params)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
    if xpad.device != params.device:
        raise ValueError(f"xpad on {xpad.device} but params on {params.device}")
    if xpad.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {xpad.device}")
    if xpad.shape[1] != lanes or xpad.shape[0] % bm:
        raise ValueError(
            f"xpad shape {tuple(xpad.shape)} is not (nblocks*{bm}, {lanes})"
        )
    nblocks = xpad.shape[0] // bm
    if tuple(params.shape) != (nblocks, ncols):
        raise ValueError(
            f"params shape {tuple(params.shape)} != ({nblocks}, {ncols})"
        )
    if xpad.is_cuda:
        if (bm * lanes) % 4 or xpad.data_ptr() % 16:
            raise ValueError(
                "the CUDA kernels load float4: bm*lanes must be a multiple of "
                "4 and xpad 16-byte aligned"
            )
    return nblocks


# ------------------------------------------------------------- histogram


def seg_hist2side_plain(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                        nbins: int = 128, bm: int = 8,
                        lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, nbins) f32 two-sided log₂-magnitude histograms.

    params rows ``(seg, lo⁺, hi⁺, lo⁻, hi⁻)``.  Side 0 counts positive
    entries, side 1 the magnitudes of negative ones, each within its own
    ``[lo, hi)``; ``bucket = clip(int((log₂ max(|x|, 1e-38) − log₂ lo) /
    (log₂ hi − log₂ lo) · nbins), 0, nbins − 1)`` with ``lo`` clamped to
    ``1e-38`` and ``hi`` to ``2e-38`` inside the logs.
    """
    nblocks = xpad.shape[0] // bm
    x = xpad.reshape(nblocks, bm * lanes)
    absx = x.abs()
    seg = params[:, 0].to(torch.int64)[:, None]
    log_abs = torch.log2(torch.clamp(absx, min=1e-38))
    counts = []
    for side, sel in ((0, x > 0.0), (1, x < 0.0)):
        lo = params[:, 1 + 2 * side, None]
        hi = params[:, 2 + 2 * side, None]
        in_range = sel & (absx >= lo) & (absx < hi)
        log_lo = torch.log2(torch.clamp(lo, min=1e-38))
        log_hi = torch.log2(torch.clamp(hi, min=2e-38))
        f = (log_abs - log_lo) / (log_hi - log_lo)
        bucket = torch.clamp((f * nbins).to(torch.int32), 0, nbins - 1)
        index = (seg * 2 + side) * nbins + bucket
        counts.append(torch.bincount(index[in_range], minlength=nseg * 2 * nbins))
    total = counts[0] + counts[1]
    return total[: nseg * 2 * nbins].reshape(nseg, 2, nbins).to(torch.float32)


def seg_hist2side(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                  nbins: int = 128, bm: int = 8, lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, nbins) f32 histograms; see :func:`seg_hist2side_plain`.

    Replaces the Pallas ``repro.kernels.flat.seg_hist2side``.
    """
    nblocks = _check(xpad, params, 5, bm, lanes)
    if not xpad.is_cuda:
        return seg_hist2side_plain(xpad, params, nseg=nseg, nbins=nbins, bm=bm,
                                   lanes=lanes)
    if not 1 <= nbins <= 4096:
        raise ValueError(f"nbins must be in [1, 4096], got {nbins}")
    hist = torch.zeros((nseg, 2, nbins), dtype=torch.int32, device=xpad.device)
    _build.launch(_build.library().seg_hist2side_launch, "seg_hist2side", xpad,
            xpad.data_ptr(), params.data_ptr(), hist.data_ptr(),
            nblocks, bm * lanes, nbins)
    seg_hist2side.launches += 1
    return hist.to(torch.float32)


seg_hist2side.launches = 0


# --------------------------------------------------------------- moments


_THREADS = 32 * 8  # threads of a CUDA moments CTA: 8 warps


def _warp_fold(v: torch.Tensor) -> torch.Tensor:
    """A warp's ``__shfl_down`` sum over the last axis (32 lanes): lane l
    adds lane l + 16, then l + 8, ... 1; the result is lane 0's."""
    while v.shape[-1] > 1:
        half = v.shape[-1] // 2
        v = v[..., :half] + v[..., half:]
    return v[..., 0]


def block_moments(x: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-partial ``(sums f64[nparts, 2], counts int64[nparts, 2])`` of
    ``x[nparts, span]`` over the masks ``pos`` and ``neg`` (side 0, 1), in
    the CUDA partial kernel's order: thread t of 256 adds the entries of
    its quads t, t + 256, ... in order, each warp folds its 32 threads
    (:func:`_warp_fold`), and the 8 warp sums are added in order.  Every
    step is the same f64 addition as on the card, so the sums are equal
    bit for bit.
    """
    nparts, span = x.shape
    steps = -(-span // (4 * _THREADS))
    pad = steps * 4 * _THREADS - span
    sel = torch.stack([pos, neg])  # (2, nparts, span)
    vals = torch.where(sel, x.to(torch.float64), torch.zeros((), dtype=torch.float64,
                                                            device=x.device))
    vals = torch.nn.functional.pad(vals, (0, pad)).reshape(2, nparts, steps, _THREADS, 4)
    acc = torch.zeros((2, nparts, _THREADS), dtype=torch.float64, device=x.device)
    for r in range(steps):
        for c in range(4):
            acc = acc + vals[:, :, r, :, c]
    warps = _warp_fold(acc.reshape(2, nparts, _THREADS // 32, 32))
    sums = torch.zeros((2, nparts), dtype=torch.float64, device=x.device)
    for w in range(_THREADS // 32):
        sums = sums + warps[:, :, w]
    return sums.T, sel.sum(-1).T


def fold_moments(sums: torch.Tensor, counts: torch.Tensor, seg: torch.Tensor,
                 nseg: int) -> torch.Tensor:
    """``(nseg, 2, 2)`` f32 ``[[Σ⁺, n⁺], [Σ⁻, n⁻]]`` from per-partial sums
    and counts, in the CUDA fold's order: counted from the segment's first
    partial b₀, partial b goes to lane (b − b₀) mod 32, each lane adds its
    partials in index order, then the warp folds the 32 lanes; sums are
    rounded to f32 once.  ``seg`` is the int64 segment id of each partial.
    """
    nparts = sums.shape[0]
    dev = sums.device
    rows = -(-nparts // 32)
    b = torch.arange(nparts, device=dev)
    first = torch.full((nseg,), nparts, dtype=torch.int64, device=dev).scatter_reduce(
        0, seg, b, reduce="amin")
    slots = torch.zeros((nseg, rows * 32, 2), dtype=torch.float64, device=dev)
    slots[seg, b - first[seg]] = sums
    slots = slots.reshape(nseg, rows, 32, 2)
    acc = torch.zeros((nseg, 32, 2), dtype=torch.float64, device=dev)
    for r in range(rows):
        acc = acc + slots[:, r]
    total = _warp_fold(acc.transpose(1, 2))  # (nseg, 2)
    cnt = torch.zeros((nseg, 2), dtype=torch.int64, device=dev).index_add_(0, seg, counts)
    return torch.stack([total.to(torch.float32), cnt.to(torch.float32)], -1)


def seg_moments_plain(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                      bm: int = 8, lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, 2) f32 ``[[Σx·[x ≥ t⁺], n⁺], [Σx·[x ≤ −t⁻], n⁻]]``.

    params rows ``(seg, t⁺, t⁻)``.  Per-block partials first
    (:func:`block_moments`), then each segment's partials
    (:func:`fold_moments`), both in f64 and in the CUDA kernel's order,
    rounded to f32 once: the result equals the kernel's bit for bit and is
    the same from run to run (no atomics).  Pad zeros are never selected
    since t⁺, t⁻ > 0.
    """
    nblocks = xpad.shape[0] // bm
    x = xpad.reshape(nblocks, bm * lanes)
    sums, counts = block_moments(x, x >= params[:, 1, None], x <= -params[:, 2, None])
    return fold_moments(sums, counts, params[:, 0].to(torch.int64), nseg)


def seg_moments(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                bm: int = 8, lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, 2) f32 masked moments; see :func:`seg_moments_plain`.

    Replaces the Pallas ``repro.kernels.flat.seg_moments``.  On the card:
    two launches (per-block f64 partials, then a fixed-order per-segment
    reduction), counted as one call of this wrapper.
    """
    nblocks = _check(xpad, params, 3, bm, lanes)
    if not xpad.is_cuda:
        return seg_moments_plain(xpad, params, nseg=nseg, bm=bm, lanes=lanes)
    dev = xpad.device
    psum = torch.empty((nblocks, 2), dtype=torch.float64, device=dev)
    pcnt = torch.empty((nblocks, 2), dtype=torch.int32, device=dev)
    out = torch.empty((nseg, 2, 2), dtype=torch.float32, device=dev)
    _build.launch(_build.library().seg_moments_launch, "seg_moments", xpad,
            xpad.data_ptr(), params.data_ptr(), psum.data_ptr(), pcnt.data_ptr(),
            out.data_ptr(), nblocks, bm * lanes, nseg)
    seg_moments.launches += 1
    return out


seg_moments.launches = 0


# -------------------------------------------------------------- binarize


def seg_binarize_apply_plain(xpad: torch.Tensor, params: torch.Tensor, *,
                             bm: int = 8, lanes: int = 128
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(ΔW*, R)``: ``mask = pos_wins ? x ≥ t⁺ : x ≤ −t⁻``,
    ``ΔW* = mask ? μ : 0``, ``R = x − ΔW*``.

    params rows ``(t⁺, t⁻, μ, pos_wins)``; pad zeros give ΔW* = R = 0.
    """
    nblocks = xpad.shape[0] // bm
    x = xpad.reshape(nblocks, bm * lanes)
    tpos, tneg, mu = params[:, 0, None], params[:, 1, None], params[:, 2, None]
    pos_wins = params[:, 3, None] > 0.5
    mask = torch.where(pos_wins, x >= tpos, x <= -tneg)
    out = torch.where(mask, mu, torch.zeros((), dtype=x.dtype, device=x.device))
    return out.reshape(xpad.shape), (x - out).reshape(xpad.shape)


def seg_binarize_apply(xpad: torch.Tensor, params: torch.Tensor, *,
                       bm: int = 8, lanes: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(ΔW*, R)`` over the whole flat buffer — 1 read, 2 writes;
    see :func:`seg_binarize_apply_plain`.

    Replaces the Pallas ``repro.kernels.flat.seg_binarize_apply``.
    """
    nblocks = _check(xpad, params, 4, bm, lanes)
    if not xpad.is_cuda:
        return seg_binarize_apply_plain(xpad, params, bm=bm, lanes=lanes)
    out = torch.empty_like(xpad)
    res = torch.empty_like(xpad)
    _build.launch(_build.library().seg_binarize_apply_launch, "seg_binarize_apply", xpad,
            xpad.data_ptr(), params.data_ptr(), out.data_ptr(), res.data_ptr(),
            nblocks, bm * lanes)
    seg_binarize_apply.launches += 1
    return out, res


seg_binarize_apply.launches = 0

WRAPPERS = (seg_hist2side, seg_moments, seg_binarize_apply)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
