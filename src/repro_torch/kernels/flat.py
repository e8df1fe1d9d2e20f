"""Segment-aware SBC passes over ONE block-padded flat buffer.

Counterpart of ``repro.kernels.flat``.  Each pass has three pieces here:

  * ``*_plain``  the plain PyTorch version of the function — what a CPU
    tensor runs, and what the CUDA kernel is held against on the card;
  * the wrapper (``seg_accumulate``, ``seg_hist2side``, ``seg_moments``,
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

On the card ``seg_accumulate``, ``seg_hist2side`` and ``seg_moments`` are
one launch each, on a persistent grid that fits in one wave
(:func:`launch_grid`); their last CTA writes the result and leaves the
workspace it used zeroed (:class:`repro_torch.kernels._build.Workspace`).
``seg_accumulate`` builds the buffer the other passes read: the leaves and
the residual in, ``acc`` and each segment's max ``|acc|`` out.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

# -------------------------------------------------------------- geometry


_HISTOGRAMS = ("seg_hist2side", "hist2side")  # the kernels that take nbins


@functools.lru_cache(maxsize=None)
def _resident(device_index: int, kernel: str, nbins: int) -> int:
    lib = _build.library()
    query = getattr(lib, f"{kernel}_resident")
    with torch.cuda.device(device_index):
        n = query(nbins) if kernel in _HISTOGRAMS else query()
    if n < 1:
        raise RuntimeError(f"{kernel}: occupancy query failed (CUDA error {-n})")
    return n


def launch_grid(kernel: str, device: torch.device, nblocks: int,
                nbins: int = 128) -> tuple[int, int]:
    """``(G, resident CTAs per SM)`` of ``kernel`` (``"seg_hist2side"``,
    the per-leaf ``"hist2side"``, ``"seg_moments"`` or ``"seg_accumulate"``)
    over ``nblocks`` blocks on the CUDA ``device``."""
    resident = _resident(device.index, kernel, nbins if kernel in _HISTOGRAMS else 0)
    return _build.persistent_grid(nblocks, _build.sm_count(device.index),
                                  resident), resident


# word offsets in a workspace: the three kernels' tickets, then the words a
# segment of seg_hist2side's counts or seg_accumulate's maxima (each call
# leaves them zero, and calls on one stream run one after the other)
_HIST_TICKET, _MOMENTS_TICKET, _ACC_TICKET, _SEG_WORDS = 0, 1, 2, 3


# ------------------------------------------------------------------ checks

# The largest flat buffer the engine can index: the exact engine's
# positions and the per-leaf kernels' element counts are 32-bit ints
# (``leaf_blocks(int n)``, ``idx.to(torch.int32)``), so a buffer of 2^31
# entries or more would wrap.  Mixtral at one layer is 1,582,346,240
# entries (74% of it); at two layers 3.0 G.
MAX_FLAT_ENTRIES = 2 ** 31 - 1


def check_flat_size(n_pad: int) -> int:
    """``n_pad``, or ``ValueError`` when a flat buffer of ``n_pad`` entries
    is past what the kernels' integer offsets can index."""
    if n_pad > MAX_FLAT_ENTRIES:
        raise ValueError(
            f"a flat buffer of {n_pad:,} entries is past the {MAX_FLAT_ENTRIES:,} that the "
            "kernels' 32-bit offsets and positions can index; cut the model's depth")
    return n_pad



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
    check_flat_size(xpad.numel())
    if xpad.device != params.device:
        raise ValueError(f"xpad on {xpad.device} but params on {params.device}")
    _build.check_device(xpad)
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


# blocks a plain pass takes at once: its temporaries (an int64 index a
# side, f64 moments) stay near 64 M entries whatever the buffer's size
_RUN_BLOCKS = 1 << 16


def _runs(nblocks: int):
    return [(b, min(b + _RUN_BLOCKS, nblocks)) for b in range(0, nblocks, _RUN_BLOCKS)]


def seg_hist2side_plain(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                        nbins: int = 128, bm: int = 8,
                        lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, nbins) f32 two-sided log₂-magnitude histograms.

    params rows ``(seg, lo⁺, hi⁺, lo⁻, hi⁻)``.  Side 0 counts positive
    entries, side 1 the magnitudes of negative ones, each within its own
    ``[lo, hi)``; ``bucket = clip(int((log₂ max(|x|, 1e-38) − log₂ lo) /
    (log₂ hi − log₂ lo) · nbins), 0, nbins − 1)`` with ``lo`` clamped to
    ``1e-38`` and ``hi`` to ``2e-38`` inside the logs.  Counted in int64
    over runs of blocks and rounded to f32 once.
    """
    nblocks = xpad.shape[0] // bm
    x = xpad.reshape(nblocks, bm * lanes)
    total = torch.zeros(nseg * 2 * nbins, dtype=torch.int64, device=xpad.device)
    for b0, b1 in _runs(nblocks):
        total += _hist_counts(x[b0:b1], params[b0:b1], nseg, nbins)
    return total.reshape(nseg, 2, nbins).to(torch.float32)


def _hist_counts(x: torch.Tensor, params: torch.Tensor, nseg: int, nbins: int) -> torch.Tensor:
    """int64 ``(nseg·2·nbins,)`` counts of the blocks ``x`` (a row each)."""
    absx = x.abs()
    seg = params[:, 0].to(torch.int64)[:, None]
    log_abs = torch.log2(torch.clamp(absx, min=1e-38))
    total = torch.zeros(nseg * 2 * nbins, dtype=torch.int64, device=x.device)
    for side, sel in ((0, x > 0.0), (1, x < 0.0)):
        lo = params[:, 1 + 2 * side, None]
        hi = params[:, 2 + 2 * side, None]
        in_range = sel & (absx >= lo) & (absx < hi)
        log_lo = torch.log2(torch.clamp(lo, min=1e-38))
        log_hi = torch.log2(torch.clamp(hi, min=2e-38))
        f = (log_abs - log_lo) / (log_hi - log_lo)
        bucket = torch.clamp((f * nbins).to(torch.int32), 0, nbins - 1)
        index = (seg * 2 + side) * nbins + bucket
        total += torch.bincount(index[in_range], minlength=nseg * 2 * nbins)
    return total


def seg_hist2side(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                  nbins: int = 128, bm: int = 8, lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, nbins) f32 histograms; see :func:`seg_hist2side_plain`.

    Replaces the Pallas ``repro.kernels.flat.seg_hist2side``.  On the card:
    one launch, which writes the f32 result itself.
    """
    nblocks = _check(xpad, params, 5, bm, lanes)
    if xpad.is_meta:
        _build.meta_launch("seg_hist2side",
                           4 * (xpad.numel() + params.numel() + nseg * 2 * nbins))
        return xpad.new_empty((nseg, 2, nbins))
    if not xpad.is_cuda:
        return seg_hist2side_plain(xpad, params, nseg=nseg, nbins=nbins, bm=bm,
                                   lanes=lanes)
    if not 1 <= nbins <= 4096:
        raise ValueError(f"nbins must be in [1, 4096], got {nbins}")
    dev = xpad.device
    ws = _build.workspace(dev, _SEG_WORDS + nseg * 2 * nbins)
    out = torch.empty((nseg, 2, nbins), dtype=torch.float32, device=dev)
    grid, _ = launch_grid("seg_hist2side", dev, nblocks, nbins)
    _build.launch(_build.library().seg_hist2side_launch, "seg_hist2side", xpad,
                  xpad.data_ptr(), params.data_ptr(), ws.data_ptr() + 4 * _SEG_WORDS,
                  ws.data_ptr() + 4 * _HIST_TICKET, out.data_ptr(), nblocks, bm * lanes,
                  nbins, nseg, grid)
    seg_hist2side.launches += 1
    return out


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
    (:func:`block_moments`, over runs of blocks), then each segment's partials
    (:func:`fold_moments`), both in f64 and in the CUDA kernel's order,
    rounded to f32 once: the result equals the kernel's bit for bit and is
    the same from run to run (no atomics).  Pad zeros are never selected
    since t⁺, t⁻ > 0.
    """
    nblocks = xpad.shape[0] // bm
    x = xpad.reshape(nblocks, bm * lanes)
    parts = [block_moments(x[b0:b1], x[b0:b1] >= params[b0:b1, 1, None],
                           x[b0:b1] <= -params[b0:b1, 2, None]) for b0, b1 in _runs(nblocks)]
    return fold_moments(torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                        params[:, 0].to(torch.int64), nseg)


def seg_moments(xpad: torch.Tensor, params: torch.Tensor, *, nseg: int,
                bm: int = 8, lanes: int = 128) -> torch.Tensor:
    """(nseg, 2, 2) f32 masked moments; see :func:`seg_moments_plain`.

    Replaces the Pallas ``repro.kernels.flat.seg_moments``.  On the card:
    one launch, whose CTAs write per-block f64 partials and whose last CTA
    folds them per segment in a fixed order.
    """
    nblocks = _check(xpad, params, 3, bm, lanes)
    if xpad.is_meta:
        _build.meta_launch("seg_moments", 4 * (xpad.numel() + params.numel() + nseg * 4))
        return xpad.new_empty((nseg, 2, 2))
    if not xpad.is_cuda:
        return seg_moments_plain(xpad, params, nseg=nseg, bm=bm, lanes=lanes)
    dev = xpad.device
    ws = _build.workspace(dev, _SEG_WORDS)
    psum = torch.empty((nblocks, 2), dtype=torch.float64, device=dev)
    pcnt = torch.empty((nblocks, 2), dtype=torch.int32, device=dev)
    out = torch.empty((nseg, 2, 2), dtype=torch.float32, device=dev)
    grid, _ = launch_grid("seg_moments", dev, nblocks)
    _build.launch(_build.library().seg_moments_launch, "seg_moments", xpad,
                  xpad.data_ptr(), params.data_ptr(), psum.data_ptr(), pcnt.data_ptr(),
                  ws.data_ptr() + 4 * _MOMENTS_TICKET, out.data_ptr(), nblocks, bm * lanes,
                  nseg, grid)
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
    if xpad.is_meta:
        _build.meta_launch("seg_binarize_apply", 4 * (3 * xpad.numel() + params.numel()))
        return torch.empty_like(xpad), torch.empty_like(xpad)
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

# ------------------------------------------------------------ accumulate


# leaves one launch carries in its parameters (csrc/seg_sbc.cu kAccLeaves)
ACC_LEAVES_PER_LAUNCH = 224


def _check_accumulate(leaves, res, bounds, n_pad: int, block: int) -> None:
    """Validate :func:`seg_accumulate`'s operands."""
    if not leaves or len(leaves) != len(bounds):
        raise ValueError(f"{len(leaves)} leaves for {len(bounds)} segments")
    check_flat_size(n_pad)
    end = 0
    for i, (leaf, (off, size)) in enumerate(zip(leaves, bounds)):
        if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
            raise TypeError(f"a leaf must be a floating torch.Tensor, got {type(leaf)}")
        if leaf.numel() != size:
            raise ValueError(f"a leaf of {leaf.numel()} entries in a segment of {size}")
        if off % block or off < end or (i == 0 and off != 0):
            raise ValueError(f"segment {i} at {off} is not a {block}-entry block at or past "
                             f"{end}")
        end = off + size
    if n_pad % block or n_pad < end:
        raise ValueError(f"n_pad {n_pad} is not whole blocks of {block} past the last segment")
    device = leaves[0].device
    if any(leaf.device != device for leaf in leaves):
        raise ValueError("the leaves lie on more than one device")
    if res is not None:
        if res.dtype != torch.float32:
            raise TypeError(f"res must be float32, got {res.dtype}")
        if tuple(res.shape) != (n_pad,) or not res.is_contiguous():
            raise ValueError(f"res must be a contiguous ({n_pad},), got {tuple(res.shape)}")
        if res.device != device:
            raise ValueError(f"res on {res.device} but the leaves on {device}")
    _build.check_device(leaves[0])


def seg_absmax(acc_flat: torch.Tensor, bounds) -> torch.Tensor:
    """Each segment's max ``|x|`` over ``acc_flat`` (``(n_pad,)``, or S
    device buffers ``(S, n_pad)``: device d's segment i at ``d · nseg +
    i``), an ``abs`` and an ``amax`` a segment of ``bounds`` (``(offset,
    size)`` each); a max is exact in any order.  What
    :func:`seg_accumulate` gives beside its buffer, and what a buffer
    gathered from shards' blocks takes as tensor ops."""
    S = acc_flat.shape[0] if acc_flat.dim() == 2 else 1
    rows2 = acc_flat.reshape(S, -1)
    return torch.stack([
        torch.amax(torch.abs(rows2[:, off:off + size]), dim=1) for off, size in bounds
    ], dim=1).reshape(-1)


def seg_accumulate_plain(leaves, res, bounds, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(acc f32[n_pad], absmax f32[nseg])``: ``acc = res + flat`` (or
    ``flat`` without ``res``), where ``flat`` holds leaf i (as f32) at
    ``[offset_i, offset_i + size_i)`` of ``bounds`` and zeros in its pad up
    to the next segment (or ``n_pad``), and ``absmax`` is
    :func:`seg_absmax` of ``acc``: segment i's entries, its pad left out.

    The composition the hist exchange ran before the fused pass: a concat,
    the residual add, and ``amax(abs(...))`` a segment.
    """
    ends = [off for off, _ in bounds[1:]] + [n_pad]
    pieces = []
    for leaf, (off, size), end in zip(leaves, bounds, ends):
        pieces.append(leaf.reshape(-1).to(torch.float32))
        if end > off + size:
            pieces.append(torch.zeros(end - off - size, dtype=torch.float32,
                                      device=leaf.device))
    flat = torch.cat(pieces) if len(pieces) > 1 else pieces[0]
    acc = flat if res is None else res + flat
    return acc, seg_absmax(acc, bounds)


def seg_accumulate(leaves, res, bounds, n_pad: int, *, bm: int = 8,
                   lanes: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """``(acc, absmax)`` of :func:`seg_accumulate_plain`, in one pass.

    ``leaves`` fill the segments ``bounds`` (``(offset, size)`` each, in
    order, the first at 0, every offset a multiple of ``bm·lanes``) of an
    ``n_pad``-entry flat buffer; ``res`` is a contiguous f32 ``(n_pad,)``
    or None.  Replaces no Pallas kernel (the JAX package leaves the
    flatten, the residual add and the max to XLA).  On the card: one
    launch per :data:`ACC_LEAVES_PER_LAUNCH` leaves, whose parameters carry
    the leaves' pointers (nothing is copied to the card first); a leaf
    that is not f32 or not contiguous is made so first (``.to``), as the
    composition does.  The same bits as the composition: ``acc`` is the
    same IEEE addition, and a max is exact in any order.
    """
    block = bm * lanes
    _check_accumulate(leaves, res, bounds, n_pad, block)
    device, nseg = leaves[0].device, len(bounds)
    if device.type == "meta":
        moved = sum(size for _, size in bounds) + n_pad * (2 if res is not None else 1) + nseg
        _build.meta_launch("seg_accumulate", 4 * moved)
        return (torch.empty((n_pad,), dtype=torch.float32, device=device),
                torch.empty((nseg,), dtype=torch.float32, device=device))
    if not leaves[0].is_cuda:
        return seg_accumulate_plain(leaves, res, bounds, n_pad)
    if block % 4 or (res is not None and res.data_ptr() % 16):
        raise ValueError("the CUDA kernel moves float4: bm*lanes must be a multiple of 4 and "
                         "res 16-byte aligned")
    flat = [leaf.reshape(-1).to(torch.float32) for leaf in leaves]
    acc = torch.empty((n_pad,), dtype=torch.float32, device=device)
    absmax = torch.empty((nseg,), dtype=torch.float32, device=device)
    ws = _build.workspace(device, _SEG_WORDS + nseg)
    lib = _build.library()
    res_ptr = None if res is None else res.data_ptr()
    for j0 in range(0, nseg, ACC_LEAVES_PER_LAUNCH):
        j1 = min(j0 + ACC_LEAVES_PER_LAUNCH, nseg)
        offs = [off for off, _ in bounds[j0:j1]] + [bounds[j1][0] if j1 < nseg else n_pad]
        grid, _ = launch_grid("seg_accumulate", device, (offs[-1] - offs[0]) // block)
        _build.launch(lib.seg_accumulate_launch, "seg_accumulate", acc,
                      (ctypes.c_void_p * (j1 - j0))(*(x.data_ptr() for x in flat[j0:j1])),
                      (ctypes.c_int * (j1 - j0 + 1))(*offs),
                      (ctypes.c_int * (j1 - j0))(*(size for _, size in bounds[j0:j1])),
                      j1 - j0, j0, res_ptr, acc.data_ptr(),
                      ws.data_ptr() + 4 * _SEG_WORDS, ws.data_ptr() + 4 * _ACC_TICKET,
                      absmax.data_ptr(), block, grid)
        seg_accumulate.launches += 1
    return acc, absmax


seg_accumulate.launches = 0

WRAPPERS = (seg_hist2side, seg_moments, seg_binarize_apply, seg_accumulate)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
