"""Device-side Golomb position packing: the two packers of the wire.

Counterpart of ``repro.kernels.pack``.  The host encoder
(:mod:`repro_torch.core.golomb`) builds the paper's Alg. 3 bitstream with
numpy; this module builds the same bytes on the device:

  * :func:`seg_packbits` folds a 0/1 bit-plane buffer into packed
    ``uint32`` words, one launch over the whole flat set;
    :func:`seg_packbits_stream` does the same from bits in stream order
    (no planes), which is what :func:`pack_bit_rows` and the sharded exact
    engine's wire (:meth:`ShardedFlatParamSpace._pack_local`) call;
  * :func:`seg_select_pack` goes from a selection mask with exactly ``k``
    set slots per row straight to packed words and the exact bit count,
    so the positions never exist as an index array.  On the card one
    launch cuts each row into tiles of :data:`TILE_SLOTS` slots spread
    over a one-wave grid (:func:`select_pack_grid`);
  * :func:`golomb_decode_rows` is the matching decoder (pointer doubling
    over the next-codeword-start map), in torch ops as in the reference.

Each kernel has three pieces, as in :mod:`repro_torch.kernels.flat`: the
plain PyTorch version (``*_plain``), which a CPU tensor runs and the CUDA
kernel is held against; the wrapper, which checks its operands and
launches the hand-written kernel of ``csrc/pack.cu`` for a CUDA tensor
(there is no fall back); and ``<wrapper>.launches``.

Bit layout (what makes the words byte-identical to the host
``encode_positions_packed``): stream bit ``b`` lives in word ``b >> 5`` at
bit position ``31 - (b & 31)``, so a big-endian view of the words,
truncated to ``ceil(nbits/8)`` bytes, is ``np.packbits(bits)``
(``golomb.packed_words_to_bytes``).  A row with ``k`` survivors of ``n``
slots needs at most ``((n - k) >> b*) + k·(1 + b*)`` stream bits, so
every shape is known before the data is.

Types: torch's ``uint32`` has almost no operations (no shifts, ``|`` or
``cumsum``, on the CPU or the card), so the bit work is done in int32 and
int64.  Bit planes and bit rows are int32 0/1 (``uint32`` is accepted and
viewed as int32); packed words come back as ``uint32`` views of int32
results.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build

_U32 = 0xFFFFFFFF


def row_bit_capacity(n: int, k: int, bstar: int) -> int:
    """Worst-case stream bits for k survivors of n slots (static bound)."""
    if k <= 0:
        return 0
    return ((n - k) >> bstar) + k * (1 + bstar)


def row_words(n: int, k: int, bstar: int) -> int:
    """uint32 words needed for one row's packed stream (static bound)."""
    return -(-row_bit_capacity(n, k, bstar) // 32)


def _u32_value(words: torch.Tensor) -> torch.Tensor:
    """int64 holding the unsigned value of each 32-bit word."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    return words.to(torch.int64) & _U32


def _as_u32(value: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2³²)`` → a ``uint32`` tensor of the same bits."""
    wrapped = torch.where(value >= 2 ** 31, value - 2 ** 32, value)
    return wrapped.to(torch.int32).view(torch.uint32)


def _scatter_add_drop(size: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """``zeros(size).at[idx].add(val, mode="drop")`` along the last axis:
    indices outside ``[0, size)`` are dropped (they land in a spare slot
    that is cut off)."""
    buf = torch.zeros(idx.shape[:-1] + (size + 1,), dtype=val.dtype, device=val.device)
    idx = torch.where((idx >= 0) & (idx < size), idx, torch.full_like(idx, size))
    buf.scatter_add_(-1, idx, val)
    return buf[..., :size]


# ------------------------------------------------------ bit-stream builders


def _codeword_bits(dm1: torch.Tensor, *, bstar: int, cap32: int) -> tuple:
    """Golomb codewords for gap-minus-one values ``dm1[..., k]`` → 0/1 bits.

    Per codeword: ``q = dm1 >> b*`` unary ones, a terminating 0, then b*
    big-endian remainder bits — the host encoder's layout.  The unary runs
    are one ±1 scatter + cumsum; the remainder bits one scatter.  Returns
    ``(bits int32[..., cap32], nbits int32[...])`` with every bit past
    ``nbits`` zero.  Leading axes are rows, each encoded on its own.
    """
    lead, k = dm1.shape[:-1], dm1.shape[-1]
    dev = dm1.device
    if k == 0:
        return (torch.zeros(lead + (cap32,), dtype=torch.int32, device=dev),
                torch.zeros(lead, dtype=torch.int32, device=dev))
    dm1 = dm1.to(torch.int64)
    q = dm1 >> bstar
    lens = q + 1 + bstar
    starts = torch.cumsum(lens, -1) - lens  # exclusive
    nbits = starts[..., -1] + lens[..., -1]
    ones = torch.ones_like(starts)
    delta = _scatter_add_drop(cap32 + 1, torch.cat([starts, starts + q], -1),
                              torch.cat([ones, -ones], -1))
    bits = (torch.cumsum(delta, -1)[..., :cap32] > 0).to(torch.int32)
    if bstar:
        r = dm1 & ((1 << bstar) - 1)
        j = torch.arange(bstar, dtype=torch.int64, device=dev)
        rem_pos = (starts + q + 1)[..., None] + j
        rem_val = (r[..., None] >> (bstar - 1 - j)) & 1
        bits = bits + _scatter_add_drop(
            cap32, rem_pos.reshape(lead + (-1,)), rem_val.reshape(lead + (-1,))
        ).to(torch.int32)
    return bits, nbits.to(torch.int32)


def bits_from_positions(pos: torch.Tensor, *, bstar: int, cap32: int) -> tuple:
    """Sorted ascending positions ``[..., k]`` (one row per leading index)
    → Golomb stream bits; see :func:`_codeword_bits`."""
    pos = pos.to(torch.int64)
    first = torch.full(pos.shape[:-1] + (1,), -1, dtype=torch.int64, device=pos.device)
    dm1 = torch.diff(pos, dim=-1, prepend=first) - 1
    return _codeword_bits(dm1, bstar=bstar, cap32=cap32)


def bits_from_mask(mask: torch.Tensor, *, k: int, bstar: int, cap32: int) -> tuple:
    """Selection mask ``[..., n]`` → Golomb stream bits, with no index array.

    ``zb[i]`` counts unselected slots up to and including ``i``; from the
    (r−1)-th selected slot to the r-th, ``zb`` grows by exactly
    ``gap − 1``, so scattering ``zb`` by selection rank gives the
    gap-minus-one sequence directly.  Selected slots past the k-th are
    dropped, as the reference's ``mode="drop"`` scatter drops them.
    """
    m = mask.to(torch.int64)
    zb = torch.cumsum(1 - m, -1)
    rank = torch.cumsum(m, -1)
    tgt = torch.where(m == 1, rank - 1, torch.full_like(rank, k))
    tgt = torch.where((tgt >= 0) & (tgt < k), tgt, torch.full_like(tgt, k))
    z = torch.zeros(m.shape[:-1] + (k + 1,), dtype=torch.int64, device=m.device)
    z.scatter_(-1, tgt, zb)  # collisions only in the spare slot k
    z = z[..., :k]
    prev = torch.cat([torch.zeros_like(z[..., :1]), z[..., :-1]], -1)
    return _codeword_bits(z - prev, bstar=bstar, cap32=cap32)


# ------------------------------------------------------------------ checks


def _check_words_operand(name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Validate an int32/uint32 operand; return its int32 view."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"{name} must be int32 or uint32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    _build.check_device(t)
    return t.view(torch.int32)


# ------------------------------------------------------- seg_packbits pass


def seg_packbits_plain(planes: torch.Tensor, *, lanes: int = 128) -> torch.Tensor:
    """u32[32, nwords] bit planes → u32[nwords] words:
    ``word[w] = OR_j planes[j, w] << (31 − j)`` (bits shifted past bit 31
    are lost, as in 32-bit arithmetic)."""
    del lanes
    p = _u32_value(planes)
    acc = torch.zeros(p.shape[1:], dtype=torch.int64, device=p.device)
    for j in range(32):
        acc |= (p[j] << (31 - j)) & _U32
    return _as_u32(acc)


def seg_packbits(planes: torch.Tensor, *, lanes: int = 128) -> torch.Tensor:
    """One flat launch: bit planes → packed ``uint32`` word buffer.

    ``planes[j, w]`` is stream bit ``32·w + j`` (the row-major bit buffer
    reshaped ``(-1, 32)`` and transposed); ``nwords`` must be a multiple of
    ``lanes``, as the reference's block grid requires.  Returns u32[nwords]
    with stream bit ``b`` at word ``b >> 5``, bit ``31 − (b & 31)``.

    Replaces the Pallas ``repro.kernels.pack.seg_packbits``.
    """
    p32 = _check_words_operand("planes", planes, 2)
    if p32.shape[0] != 32:
        raise ValueError(f"planes must have 32 rows, got shape {tuple(p32.shape)}")
    nwords = p32.shape[1]
    if lanes <= 0 or nwords % lanes:
        raise ValueError(f"nwords {nwords} is not a multiple of lanes {lanes}")
    if p32.is_meta:
        _build.meta_launch("seg_packbits", 4 * (32 * nwords + nwords))
        return p32.new_empty((nwords,)).view(torch.uint32)
    if not p32.is_cuda:
        return seg_packbits_plain(p32, lanes=lanes)
    words = torch.empty((nwords,), dtype=torch.int32, device=p32.device)
    _build.launch(_build.library().seg_packbits_launch, "seg_packbits", p32,
                  p32.data_ptr(), words.data_ptr(), nwords)
    seg_packbits.launches += 1
    return words.view(torch.uint32)


seg_packbits.launches = 0


def seg_packbits_stream_plain(bits: torch.Tensor) -> torch.Tensor:
    """u32[nbits] bits in stream order → u32[ceil(nbits/32)] words: bit
    ``b`` at word ``b >> 5``, bit ``31 − (b & 31)``; the ragged last word
    is zero-filled.  The planes version's arithmetic on the planes view."""
    flat = bits.view(torch.int32) if bits.dtype == torch.uint32 else bits
    pad = -flat.shape[0] % 32
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad,))])
    return seg_packbits_plain(flat.reshape(-1, 32).T)


def seg_packbits_stream(bits: torch.Tensor) -> torch.Tensor:
    """One launch: bits in stream order → packed ``uint32`` words.

    ``bits``: int32 or uint32 ``[nbits]``, any length, each entry placed as
    a u32 value (as :func:`seg_packbits` places a plane entry).  Returns
    u32[ceil(nbits/32)]; see :func:`seg_packbits_stream_plain`.  On the
    card the launch counts as one of ``seg_packbits``, whose Pallas
    function it replaces on the exact path.
    """
    b32 = _check_words_operand("bits", bits, 1)
    nbits = b32.shape[0]
    if nbits >= 2 ** 31 - 32:
        raise ValueError(f"{nbits} bits are past the kernel's 32-bit positions")
    if b32.is_meta:
        _build.meta_launch("seg_packbits", 4 * (nbits + -(-nbits // 32)))
        return b32.new_empty((-(-nbits // 32),)).view(torch.uint32)
    if not b32.is_cuda:
        return seg_packbits_stream_plain(b32)
    words = torch.empty((-(-nbits // 32),), dtype=torch.int32, device=b32.device)
    _build.launch(_build.library().seg_packbits_stream_launch, "seg_packbits_stream", b32,
                  b32.data_ptr(), words.data_ptr(), nbits)
    seg_packbits.launches += 1
    return words.view(torch.uint32)


def pack_bit_rows(bits: torch.Tensor, *, lanes: int = 128) -> torch.Tensor:
    """u32[..., cap32] bit rows → u32[..., cap32/32] words in ONE launch
    over the concatenation (:func:`seg_packbits_stream`: no pad to whole
    ``(32, lanes)`` blocks and no transpose, which only the reference's
    Pallas blocks need; ``lanes`` is kept for its signature)."""
    del lanes
    if bits.dtype == torch.uint32:
        bits = bits.view(torch.int32)
    cap32 = bits.shape[-1]
    if cap32 % 32:
        raise ValueError(f"bit rows of {cap32} bits are not whole words")
    words = seg_packbits_stream(bits.reshape(-1).contiguous())
    return words.reshape(bits.shape[:-1] + (cap32 // 32,))


# ------------------------------------------------- fused select→pack pass


TILE_SLOTS = 8192  # slots of one tile of the CUDA seg_select_pack (kTileSlots)
_WS_HEAD, _TILE_WORDS = 4, 12  # its workspace: counter and ticket, per tile, per row


@functools.lru_cache(maxsize=None)
def _select_resident(device_index: int, bstar: int) -> int:
    lib = _build.library()
    with torch.cuda.device(device_index):
        n = lib.seg_select_pack_resident(bstar)
    if n < 1:
        raise RuntimeError(f"seg_select_pack: occupancy query failed (CUDA error {-n})")
    return n


def select_pack_grid(device: torch.device, rows: int, n: int,
                     bstar: int) -> tuple[int, int, int]:
    """``(G, resident CTAs per SM, tiles)`` of the CUDA ``seg_select_pack``
    on ``rows`` rows of ``n`` slots: ``ceil(n / TILE_SLOTS)`` tiles a row,
    over a persistent grid of one wave."""
    tiles = rows * -(-n // TILE_SLOTS)
    resident = _select_resident(device.index, bstar)
    return (_build.persistent_grid(tiles, _build.sm_count(device.index), resident),
            resident, tiles)


def seg_select_pack_plain(mask: torch.Tensor, *, k: int, bstar: int) -> tuple:
    """int32[rows, n] masks with exactly k set slots per row →
    ``(words u32[rows, W], nbits int32[rows])``, ``W = row_words(n, k, b*)``."""
    rows, n = mask.shape
    nw = row_words(n, k, bstar)
    bits, nbits = bits_from_mask(mask, k=k, bstar=bstar, cap32=32 * nw)
    shifts = 31 - torch.arange(32, dtype=torch.int64, device=mask.device)
    words = (bits.reshape(rows, nw, 32).to(torch.int64) << shifts).sum(-1)
    return _as_u32(words), nbits


def seg_select_pack(mask: torch.Tensor, *, k: int, bstar: int) -> tuple:
    """Fused select→pack: two-sided top-k masks straight to packed words.

    ``mask``: bool or int32 ``[rows, n]`` of 0/1 with exactly ``k`` set
    slots per row (a bool mask is copied to int32, as the reference casts
    it).  Returns ``(words u32[rows, W], nbits int32[rows])``.  On the
    card, a row with fewer than ``k`` set slots gets ``nbits = −1`` (the
    reference's result for such a row is undefined).

    Replaces the Pallas ``repro.kernels.pack.seg_select_pack``.  On the
    card: one launch, tiles of a row scanned across CTAs with a
    look-back, a last CTA that finishes the words (``csrc/pack.cu``).
    """
    if not isinstance(mask, torch.Tensor):
        raise TypeError(f"mask must be a torch.Tensor, got {type(mask)}")
    if mask.dtype == torch.bool:
        mask = mask.to(torch.int32)
    if mask.dtype != torch.int32:
        raise TypeError(f"mask must be bool or int32, got {mask.dtype}")
    if mask.dim() != 2:
        raise ValueError(f"mask must be 2-D, got shape {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError("mask must be contiguous")
    _build.check_device(mask)
    rows, n = mask.shape
    if not 0 <= k <= n:
        raise ValueError(f"k={k} outside [0, n={n}]")
    if not 0 <= bstar <= 30:
        raise ValueError(f"b*={bstar} outside [0, 30]")
    nw = row_words(n, k, bstar)
    if 32 * nw >= 2 ** 31 or n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"a row of {n} slots or {nw} words is past the kernel's "
                         "32-bit positions")
    if mask.is_meta:
        _build.meta_launch("seg_select_pack", 4 * (rows * n + rows * nw + rows))
        return mask.new_empty((rows, nw)).view(torch.uint32), mask.new_empty((rows,))
    if not mask.is_cuda:
        return seg_select_pack_plain(mask, k=k, bstar=bstar)
    dev = mask.device
    words = torch.empty((rows, nw), dtype=torch.int32, device=dev)
    nbits = torch.empty((rows,), dtype=torch.int32, device=dev)
    grid, _, tiles = select_pack_grid(dev, rows, n, bstar)
    ws = _build.workspace(dev, _WS_HEAD + _TILE_WORDS * tiles + rows)
    _build.launch(_build.library().seg_select_pack_launch, "seg_select_pack", mask,
                  mask.data_ptr(), words.data_ptr(), nbits.data_ptr(), ws.data_ptr(), rows,
                  n, k, bstar, nw, -(-n // TILE_SLOTS), grid)
    seg_select_pack.launches += 1
    return words.view(torch.uint32), nbits


seg_select_pack.launches = 0


# ------------------------------------------------------------ device decode


def golomb_decode_rows(words: torch.Tensor, *, k: int, bstar: int) -> torch.Tensor:
    """u32[..., W] packed streams (≥ k codewords each) → int32[..., k]
    ascending positions.

    The cursor recurrence ``c' = nz[c] + 1 + b*`` iterates ONE map, so
    codeword starts are ``f^r(0)`` and pointer doubling gives all k of them
    in ``log2 k`` gather rounds instead of a k-step scan.  Torch ops, as
    the reference's decoder is jnp (no Pallas kernel).
    """
    lead, nw = words.shape[:-1], words.shape[-1]
    w = _u32_value(words).reshape(-1, nw)
    dev = w.device
    shifts = 31 - torch.arange(32, dtype=torch.int64, device=dev)
    bits = ((w[:, :, None] >> shifts) & 1).reshape(w.shape[0], -1)
    nb = bits.shape[1]
    ext = nb + bstar + 2  # zero tail: nz always finds a 0
    bits_e = torch.cat([bits, bits.new_zeros((bits.shape[0], ext + bstar - nb))], 1)
    iota = torch.arange(ext, dtype=torch.int64, device=dev)
    cand = torch.where(bits_e[:, :ext] == 0, iota, ext - 1)
    nz = torch.flip(torch.cummin(torch.flip(cand, [1]), dim=1).values, [1])
    rem = torch.zeros_like(nz)
    for j in range(bstar):
        rem = rem + (bits_e[:, j:j + ext] << (bstar - 1 - j))
    nxt = torch.clamp(nz + 1 + bstar, max=ext - 1)  # next-codeword-start map
    cursors = torch.zeros((w.shape[0], k), dtype=torch.int64, device=dev)
    ranks = torch.arange(k, dtype=torch.int64, device=dev)
    table = nxt
    for j in range(max(1, (k - 1).bit_length())):
        if (k - 1) >> j == 0:
            break
        cursors = torch.where(((ranks >> j) & 1) == 1, torch.gather(table, 1, cursors),
                              cursors)
        table = torch.gather(table, 1, table)  # f^(2^j) → f^(2^(j+1))
    z = torch.gather(nz, 1, cursors)
    q = z - cursors
    dm1 = (q << bstar) + torch.gather(rem, 1, torch.clamp(z + 1, max=ext - 1))
    pos = torch.cumsum(dm1 + 1, 1) - 1
    return pos.to(torch.int32).reshape(lead + (k,))


WRAPPERS = (seg_packbits, seg_select_pack)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """``{wrapper name: launches}`` for every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
