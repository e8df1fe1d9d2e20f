"""Golomb position coding (paper Alg. 3 / Alg. 4 and Eq. 5).

Counterpart of ``repro.core.golomb``.  Under the paper's model the gaps
between surviving positions of a top-p% sparsified tensor are geometric
with success probability p, and Golomb coding with
``b* = 1 + floor(log2(log(phi-1)/log(1-p)))`` is optimal.  Eq. 5 gives the
expected bits per position:

    b̄_pos = b* + 1 / (1 - (1-p)^(2^b*))

This module holds that analytic model and the exact bitstream
encoder/decoder (numpy, host side): the byte oracle that the device
packers of :mod:`repro_torch.kernels.pack` are held against, and the host
metering of ``measure_wire``.

The bitstream layout per position gap d (>=1):  q = (d-1) // 2^b* unary ones,
a terminating 0, then b* binary bits of r = (d-1) % 2^b*.
"""
from __future__ import annotations

import bisect
import math

import numpy as np

PHI = (math.sqrt(5.0) + 1.0) / 2.0


def golomb_bstar(p: float) -> int:
    """Optimal Golomb parameter b* for sparsity rate p (paper Alg. 3 l.4)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"sparsity rate must be in (0,1), got {p}")
    b = 1 + math.floor(math.log2(math.log(PHI - 1.0) / math.log(1.0 - p)))
    return max(0, int(b))


def expected_position_bits(p: float) -> float:
    """Eq. 5: average bits to encode one non-zero position at sparsity p.

    p ≥ 1 means a dense update: positions are predetermined and cost 0
    bits (Eq. 1's dense case).
    """
    if p >= 1.0:
        return 0.0
    b = golomb_bstar(p)
    return b + 1.0 / (1.0 - (1.0 - p) ** (2.0**b))


# ------------------------------------------------------------------ encode


def encode_positions(indices: np.ndarray, p: float) -> np.ndarray:
    """Alg. 3: encode sorted non-zero positions as a Golomb bitstream.

    Returns a uint8 array of BITS (one bit per entry; packing to bytes is
    ``np.packbits`` at the transport layer — bit count is what Eq. 1 meters).

    Vectorized: per gap d the codeword is q unary ones, a 0, then b* binary
    bits of r, with q = (d−1) div 2^b*, r = (d−1) mod 2^b*.  We compute all
    codeword offsets with a cumsum and scatter ones/remainder bits at once.
    """
    indices = np.sort(np.asarray(indices, dtype=np.int64))
    if indices.size == 0:
        return np.zeros((0,), np.uint8)
    bstar = golomb_bstar(p)
    gaps = np.diff(np.concatenate([[-1], indices]))  # ≥ 1
    dm1 = gaps - 1
    q = dm1 >> bstar
    r = dm1 & ((1 << bstar) - 1) if bstar else np.zeros_like(dm1)

    lengths = q + 1 + bstar
    starts = np.concatenate([[0], np.cumsum(lengths[:-1])])
    total = int(starts[-1] + lengths[-1])
    out = np.zeros((total,), np.uint8)

    # unary prefixes: ones on [start, start+q) for every codeword
    if q.sum() > 0:
        ones_idx = np.repeat(starts, q) + _ragged_arange(q)
        out[ones_idx] = 1
    # binary remainders (big-endian), bit j of codeword i at start+q+1+j
    if bstar:
        shifts = np.arange(bstar - 1, -1, -1)
        bits = (r[:, None] >> shifts[None, :]) & 1  # (n, bstar)
        base = (starts + q + 1)[:, None] + np.arange(bstar)[None, :]
        out[base.reshape(-1)] = bits.astype(np.uint8).reshape(-1)
    return out


def _ragged_arange(counts: np.ndarray) -> np.ndarray:
    """concatenate([arange(c) for c in counts]) without a Python loop."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    out = np.arange(total)
    out -= np.repeat(ends - counts, counts)
    return out


def encode_positions_packed(indices: np.ndarray, p: float) -> tuple[bytes, int]:
    """Alg. 3 straight to transport form: (packed bytes, exact bit count).

    One whole-array encode + one ``np.packbits`` — no per-position Python
    round-trip, so ``Wire.pack`` can consume device output (a numpy view of
    the compressed indices) directly.  The bit count is pre-byte-padding,
    i.e. the number Eq. 1 meters.
    """
    bits = encode_positions(indices, p)
    if bits.size == 0:
        return b"", 0
    return np.packbits(bits).tobytes(), int(bits.size)


def packed_words_to_bytes(words: np.ndarray, nbits: int) -> bytes:
    """Device word buffer → transport bytes, byte-identical to
    :func:`encode_positions_packed`.

    The device packers (:mod:`repro_torch.kernels.pack`) put stream bit ``b``
    in word ``b >> 5`` at bit position ``31 - (b & 31)``, so a
    big-endian byte view truncated to ``ceil(nbits/8)`` IS the
    ``np.packbits`` output — this is the whole device-to-bytes copy.
    """
    if nbits <= 0:
        return b""
    return np.ascontiguousarray(
        np.asarray(words, dtype=np.uint32)
    ).astype(">u4").tobytes()[: -(-int(nbits) // 8)]


def decode_positions(msg: np.ndarray, p: float) -> np.ndarray:
    """Alg. 4: decode a Golomb bitstream back to absolute positions.

    Per-codeword parse: a codeword starts with a unary run of ones, so the
    first 0 at/after the cursor is its terminator (zeros inside remainder
    fields are skipped, never scanned).  The remainder value after EVERY
    zero is precomputed with one vectorized matmul, so the sequential scan
    touches only Python ints + ``bisect`` — this is the parameter-server
    hot path (one decode per sparse leaf per client upload).
    """
    bstar = golomb_bstar(p)
    msg = np.asarray(msg, dtype=np.uint8)
    n = msg.shape[0]
    zeros = np.nonzero(msg == 0)[0]
    if zeros.size == 0:
        return np.zeros((0,), dtype=np.int64)
    if bstar:
        # remainder bits following each candidate terminator, vectorized
        idx = zeros[:, None] + 1 + np.arange(bstar)[None, :]
        bits = np.where(idx < n, msg[np.minimum(idx, n - 1)], 0)
        rems = (bits @ (1 << np.arange(bstar - 1, -1, -1))).tolist()
    else:
        rems = [0] * zeros.size
    zlist = zeros.tolist()
    nz = len(zlist)

    out: list[int] = []
    c, j, zi = 0, -1, 0
    while c < n:
        zi = bisect.bisect_left(zlist, c, zi)
        if zi >= nz:
            break  # trailing ones without terminator: not a codeword
        z = zlist[zi]
        if z + bstar >= n and bstar:
            # remainder field runs past the stream: truncated/corrupt buffer
            raise ValueError(
                f"truncated Golomb stream: codeword at bit {c} needs "
                f"{bstar} remainder bits past position {z}"
            )
        j = j + ((z - c) << bstar) + rems[zi] + 1
        out.append(j)
        c = z + 1 + bstar
    return np.asarray(out, dtype=np.int64)


# ------------------------------------------------- full-message wire format


def encode_sbc_message(indices: np.ndarray, mean: float, p: float) -> dict:
    """Wire form of one SBC-compressed tensor: Golomb positions + 1 float.

    Mirrors the paper's "positions + one mean value per tensor" message.
    """
    bits = encode_positions(indices, p)
    return {
        "positions": np.packbits(bits) if bits.size else np.zeros((0,), np.uint8),
        "nbits_positions": int(bits.size),
        "mean": float(mean),
        "p": float(p),
    }


def decode_sbc_message(msg: dict, n: int) -> np.ndarray:
    bits = np.unpackbits(msg["positions"])[: msg["nbits_positions"]]
    idx = decode_positions(bits, msg["p"])
    dense = np.zeros((n,), np.float32)
    dense[idx] = msg["mean"]
    return dense


def message_bits(msg: dict) -> int:
    """Total wire bits of one encoded tensor (positions + 32-bit mean)."""
    return msg["nbits_positions"] + 32
