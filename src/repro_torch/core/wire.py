"""Packed wire format: LeafCompressed trees ⇄ bytes (DESIGN.md §5).

Counterpart of ``repro.core.wire``: the same SBW1 bytes, so a blob packed
by either package unpacks in the other.  ``Wire.pack`` serializes a
compressed update into one byte buffer (Golomb position bitstreams,
sign/ternary/level bitfields and per-tensor scalars as real bytes) and
``Wire.unpack`` decodes it back to the dense tree a receiver needs, as
CPU tensors.  ``measured_bits`` counts exact payload bits, which the
ledger holds against Eq. 1.

Layout (all little-endian scalars, np.packbits big-endian bitfields):

    header:  b"SBW1"  u32 n_leaves
    leaf i:  u32 payload_bytes, then the payload:
      skip                  → (empty)
      sparse positions      → golomb: u32 bit_count + packed bitstream
                              bitmask: ceil(n/8) mask bytes
                              raw16/raw32/seed: k fixed-width indices
      sparse values         → identity: k f32 | binarize: 1 f32 (μ)
                              sign: f32 scale + k sign bits
      dense payloads        → identity: n f32
                              sign: f32 scale + n sign bits
                              two_means: f32 μ⁺, f32 μ⁻ + n side bits
                              ternary: f32 s + n 2-bit codes
                              stochastic: f32 norm + n sign bits
                                          + n ceil(log2(L+1))-bit levels

Sparse values ride in ascending-position order (Golomb decode emits
sorted positions), so pack sorts (idx, vals) jointly.  ``measured_bits``
counts payload bits before byte padding; the framing (magic and lengths)
is transport overhead and is not counted.

Known analytic-vs-wire divergences, as in the reference: ``seed`` ships
explicit raw32 indices (analytic: one shared 32-bit seed); ``ternary``
packs 2 bits an entry (analytic: log2 3); ``stochastic`` packs
sign + ⌈log2(L+1)⌉ bits (analytic: log2(2L+1)); ``raw16`` widens to u32
for leaves over 2^16 entries.

The device pack (``Wire.pack_with_bits(device_pack=True)``,
``Wire.pack_device``): every Golomb position stream is packed on the
leaf's device by :func:`repro_torch.kernels.pack.seg_select_pack` (one
launch per leaf, the hand-written CUDA kernel on a card, its plain
version on the CPU) from a mask built there from ``comp.idx``; the words
and bit counts come to the host once every leaf is launched.  The bytes
equal the host encoder's.
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import golomb
from repro_torch.core.codec import Codec
from repro_torch.core.policy import ResolvedPolicy
from repro_torch.core.stages import LeafCompressed, k_for
from repro_torch.kernels.pack import seg_select_pack

PyTree = Any

MAGIC = b"SBW1"


class LeafSpec(NamedTuple):
    """Static per-leaf decode contract: everything a receiver must already
    know (from the shared policy + model config) to parse the payload."""

    path: str
    shape: Tuple[int, ...]
    selector: str
    quantizer: str
    encoder: str
    p: float
    levels: int = 0  # stochastic-quantizer code range (0 = n/a)

    @property
    def n(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def k(self) -> int:
        if self.selector == "skip":
            return 0
        if self.selector == "dense":
            return self.n
        return k_for(self.n, self.p)


def spec_for(path: str, shape: Tuple[int, ...], codec: Codec, p: float) -> LeafSpec:
    return LeafSpec(
        path=path,
        shape=tuple(shape),
        selector=codec.selector.name,
        quantizer=codec.quantizer.name,
        encoder=codec.encoder.name,
        p=float(p),
        levels=int(codec.quantizer.levels),
    )


# ------------------------------------------------------------- bit plumbing


def _pack_bits(bits: np.ndarray) -> bytes:
    return np.packbits(bits.astype(np.uint8)).tobytes() if bits.size else b""


def _need(payload: bytes, nbytes: int, what: str) -> None:
    """Clean ValueError instead of a struct.error / short-read crash when a
    truncated or corrupted buffer asks for more payload than exists."""
    if len(payload) < nbytes:
        raise ValueError(
            f"truncated SBW1 leaf payload: {what} needs {nbytes} bytes, "
            f"have {len(payload)}"
        )


def _unpack_bits(buf: bytes, count: int) -> np.ndarray:
    if count == 0:
        return np.zeros((0,), np.uint8)
    return np.unpackbits(np.frombuffer(buf, np.uint8))[:count]


def _pack_codes(codes: np.ndarray, width: int) -> bytes:
    """Fixed-width big-endian bitfield of small unsigned ints."""
    if codes.size == 0 or width == 0:
        return b""
    shifts = np.arange(width - 1, -1, -1)
    bits = ((codes[:, None].astype(np.int64) >> shifts[None, :]) & 1).reshape(-1)
    return _pack_bits(bits)


def _unpack_codes(buf: bytes, count: int, width: int) -> np.ndarray:
    if count == 0 or width == 0:
        return np.zeros((count,), np.int64)
    bits = _unpack_bits(buf, count * width).reshape(count, width).astype(np.int64)
    weights = 1 << np.arange(width - 1, -1, -1)
    return bits @ weights


def _f32(x) -> bytes:
    return struct.pack("<f", float(x))


def _code_width(levels: int) -> int:
    return max(1, math.ceil(math.log2(levels + 1)))


def _nbytes(bits: int) -> int:
    return (bits + 7) // 8


# ------------------------------------------------------------ leaf pack side


def pack_leaf(
    comp: LeafCompressed, spec: LeafSpec, golomb_payload=None
) -> Tuple[bytes, int]:
    """Serialize one compressed leaf → (payload bytes, exact payload bits).

    The exact bit count is pre-byte-padding: Golomb bitstream length,
    1 bit per sign/side, ⌈log2⌉ bits per code, 32 per f32 scalar.
    ``golomb_payload`` is an optional precomputed ``(packed bytes, bits)``
    position stream (the device-pack path) used in place of the host
    encoder for golomb leaves.
    """
    if spec.selector == "skip":
        return b"", 0
    comp = _to_numpy(comp)
    if spec.selector == "dense":
        return _pack_dense(comp, spec)
    return _pack_sparse(comp, spec, golomb_payload)


def _pack_sparse(
    comp: LeafCompressed, spec: LeafSpec, golomb_payload=None
) -> Tuple[bytes, int]:
    idx = np.asarray(comp.idx, np.int64)
    order = np.argsort(idx, kind="stable")
    idx = idx[order]
    vals = np.asarray(comp.vals, np.float32)
    if vals.size:
        vals = vals[order]
    k = idx.size

    # ---- positions
    if spec.encoder == "golomb":
        if golomb_payload is not None:
            packed, pos_bits = golomb_payload
        else:
            packed, pos_bits = golomb.encode_positions_packed(idx, spec.p)
        pos = struct.pack("<I", pos_bits) + packed
    elif spec.encoder == "bitmask":
        mask = np.zeros((spec.n,), np.uint8)
        mask[idx] = 1
        pos = _pack_bits(mask)
        pos_bits = spec.n
    elif spec.encoder == "raw16":
        # the paper's naive 16-bit width only addresses 2^16 entries; wider
        # leaves auto-widen to u32 on the wire (analytic stays 16k — the
        # Table I accounting's own blind spot, see module docstring)
        if spec.n <= (1 << 16):
            pos = idx.astype("<u2").tobytes()
            pos_bits = 16 * k
        else:
            pos = idx.astype("<u4").tobytes()
            pos_bits = 32 * k
    elif spec.encoder in ("raw32", "seed"):
        pos = idx.astype("<u4").tobytes()
        pos_bits = 32 * k
    else:
        raise NotImplementedError(f"no wire form for encoder {spec.encoder!r}")

    # ---- values
    if spec.quantizer == "identity":
        val = vals.astype("<f4").tobytes()
        val_bits = 32 * k
    elif spec.quantizer == "binarize":
        val = _f32(comp.mean)
        val_bits = 32
    elif spec.quantizer == "sign":
        val = _f32(comp.mean) + _pack_bits(vals > 0)
        val_bits = 32 + k
    else:
        raise NotImplementedError(
            f"no sparse wire form for quantizer {spec.quantizer!r}"
        )
    return pos + val, pos_bits + val_bits


def _pack_dense(comp: LeafCompressed, spec: LeafSpec) -> Tuple[bytes, int]:
    dense = np.asarray(comp.dense, np.float32)
    n = spec.n
    if spec.quantizer == "identity":
        return dense.astype("<f4").tobytes(), 32 * n
    if spec.quantizer == "sign":
        return _f32(comp.mean) + _pack_bits(dense > 0), 32 + n
    if spec.quantizer == "two_means":
        mu_p, mu_n = np.float32(dense.max()), np.float32(dense.min())
        return _f32(mu_p) + _f32(mu_n) + _pack_bits(dense == mu_p), 64 + n
    if spec.quantizer == "ternary":
        codes = (np.sign(dense) + 1).astype(np.int64)  # {0,1,2}
        return _f32(comp.mean) + _pack_codes(codes, 2), 32 + 2 * n
    if spec.quantizer == "stochastic":
        norm = np.float32(comp.mean)
        w = _code_width(spec.levels)
        q = np.rint(np.abs(dense) * spec.levels / norm).astype(np.int64)
        payload = _f32(norm) + _pack_bits(dense > 0) + _pack_codes(q, w)
        return payload, 32 + n + w * n
    raise NotImplementedError(f"no dense wire form for quantizer {spec.quantizer!r}")


# ---------------------------------------------------------- leaf unpack side


def unpack_leaf(payload: bytes, spec: LeafSpec) -> LeafCompressed:
    """Parse one leaf payload back to a LeafCompressed of CPU tensors (idx
    ascending).

    ``nbits`` carries the exact measured payload bits, so a re-pack of the
    result is byte-identical and the measured size is queryable downstream.
    """
    if spec.selector == "skip":
        comp = LeafCompressed(
            idx=np.zeros((0,), np.int32), vals=np.zeros((0,), np.float32),
            mean=np.float32(0), dense=np.zeros((0,), np.float32),
            nbits=np.float32(0),
        )
    elif spec.selector == "dense":
        comp = _unpack_dense(payload, spec)
    else:
        comp = _unpack_sparse(payload, spec)
    return LeafCompressed(*(torch.from_numpy(np.array(x)) for x in comp))


def _unpack_sparse(payload: bytes, spec: LeafSpec) -> LeafCompressed:
    k, off = spec.k, 0
    if spec.encoder == "golomb":
        _need(payload, 4, "golomb bit count")
        (bit_count,) = struct.unpack_from("<I", payload, 0)
        off = 4 + _nbytes(bit_count)
        _need(payload, off, f"golomb bitstream of {bit_count} bits")
        bits = _unpack_bits(payload[4:off], bit_count)
        idx = golomb.decode_positions(bits, spec.p).astype(np.int32)
        pos_bits = bit_count
    elif spec.encoder == "bitmask":
        off = _nbytes(spec.n)
        _need(payload, off, f"{spec.n}-bit mask")
        mask = _unpack_bits(payload[:off], spec.n)
        idx = np.nonzero(mask)[0].astype(np.int32)
        pos_bits = spec.n
    elif spec.encoder == "raw16":
        if spec.n <= (1 << 16):
            off = 2 * k
            _need(payload, off, f"{k} u16 positions")
            idx = np.frombuffer(payload, "<u2", count=k).astype(np.int32)
            pos_bits = 16 * k
        else:  # auto-widened on pack (see _pack_sparse)
            off = 4 * k
            _need(payload, off, f"{k} u32 positions")
            idx = np.frombuffer(payload, "<u4", count=k).astype(np.int32)
            pos_bits = 32 * k
    elif spec.encoder in ("raw32", "seed"):
        off = 4 * k
        _need(payload, off, f"{k} u32 positions")
        idx = np.frombuffer(payload, "<u4", count=k).astype(np.int32)
        pos_bits = 32 * k
    else:
        raise NotImplementedError(f"no wire form for encoder {spec.encoder!r}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= spec.n):
        # corrupted position stream: decoded indices outside the tensor
        raise ValueError(
            f"corrupt SBW1 positions for {spec.path!r}: index range "
            f"[{int(idx.min())}, {int(idx.max())}] outside [0, {spec.n})"
        )
    k = idx.size  # authoritative once positions are decoded

    mean = np.float32(0)
    vals = np.zeros((0,), np.float32)
    if spec.quantizer == "identity":
        _need(payload, off + 4 * k, f"{k} f32 values")
        vals = np.frombuffer(payload, "<f4", count=k, offset=off).copy()
        val_bits = 32 * k
    elif spec.quantizer == "binarize":
        _need(payload, off + 4, "binarize mean")
        (m,) = struct.unpack_from("<f", payload, off)
        mean = np.float32(m)
        val_bits = 32
    elif spec.quantizer == "sign":
        _need(payload, off + 4 + _nbytes(k), f"sign scale + {k} sign bits")
        (m,) = struct.unpack_from("<f", payload, off)
        mean = np.float32(m)
        signs = _unpack_bits(payload[off + 4:], k).astype(np.float32)
        vals = np.where(signs > 0, mean, -mean).astype(np.float32)
        val_bits = 32 + k
    else:
        raise NotImplementedError(
            f"no sparse wire form for quantizer {spec.quantizer!r}"
        )
    return LeafCompressed(
        idx=idx, vals=vals, mean=mean, dense=np.zeros((0,), np.float32),
        nbits=np.float32(pos_bits + val_bits),
    )


def _unpack_dense(payload: bytes, spec: LeafSpec) -> LeafCompressed:
    n = spec.n
    empty_i = np.zeros((0,), np.int32)
    empty_f = np.zeros((0,), np.float32)
    if spec.quantizer == "identity":
        _need(payload, 4 * n, f"{n} f32 values")
        dense = np.frombuffer(payload, "<f4", count=n).copy()
        return LeafCompressed(empty_i, empty_f, np.float32(0), dense,
                              np.float32(32 * n))
    if spec.quantizer == "sign":
        _need(payload, 4 + _nbytes(n), f"sign scale + {n} sign bits")
        (scale,) = struct.unpack_from("<f", payload, 0)
        scale = np.float32(scale)
        signs = _unpack_bits(payload[4:], n).astype(np.float32)
        dense = np.where(signs > 0, scale, -scale).astype(np.float32)
        return LeafCompressed(empty_i, empty_f, scale, dense,
                              np.float32(32 + n))
    if spec.quantizer == "two_means":
        _need(payload, 8 + _nbytes(n), f"two means + {n} side bits")
        mu_p, mu_n = struct.unpack_from("<ff", payload, 0)
        side = _unpack_bits(payload[8:], n)
        dense = np.where(side > 0, np.float32(mu_p), np.float32(mu_n)).astype(
            np.float32
        )
        return LeafCompressed(empty_i, empty_f, np.float32(mu_p), dense,
                              np.float32(64 + n))
    if spec.quantizer == "ternary":
        _need(payload, 4 + _nbytes(2 * n), f"ternary scale + {n} 2-bit codes")
        (scale,) = struct.unpack_from("<f", payload, 0)
        scale = np.float32(scale)
        codes = _unpack_codes(payload[4:], n, 2) - 1  # {-1,0,1}
        dense = (scale * codes.astype(np.float32)).astype(np.float32)
        return LeafCompressed(empty_i, empty_f, scale, dense,
                              np.float32(32 + 2 * n))
    if spec.quantizer == "stochastic":
        w = _code_width(spec.levels)
        _need(payload, 4 + _nbytes(n) + _nbytes(w * n),
              f"qsgd norm + {n} sign bits + {n} {w}-bit codes")
        (norm,) = struct.unpack_from("<f", payload, 0)
        norm = np.float32(norm)
        sign_bytes = _nbytes(n)
        signs = _unpack_bits(payload[4:4 + sign_bytes], n).astype(np.float32)
        q = _unpack_codes(payload[4 + sign_bytes:], n, w).astype(np.float32)
        sgn = np.where(signs > 0, np.float32(1), np.float32(-1))
        # same op order as the quantizer: ((norm · sign) · q) / levels, all f32
        dense = ((norm * sgn) * q / np.float32(spec.levels)).astype(np.float32)
        return LeafCompressed(empty_i, empty_f, norm, dense,
                              np.float32(32 + n + w * n))
    raise NotImplementedError(f"no dense wire form for quantizer {spec.quantizer!r}")


def leaf_dense(comp: LeafCompressed, spec: LeafSpec) -> torch.Tensor:
    """Dense reconstruction of one unpacked leaf, reshaped to spec.shape
    (an f32 CPU tensor)."""
    comp = _to_numpy(comp)
    if comp.dense.size:
        out = np.asarray(comp.dense, np.float32)
    else:
        out = np.zeros((spec.n,), np.float32)
        if comp.vals.size:
            out[np.asarray(comp.idx)] = comp.vals
        elif comp.idx.size:
            out[np.asarray(comp.idx)] = comp.mean
    return torch.from_numpy(np.array(out.reshape(spec.shape)))


# ------------------------------------------------------------- message level


@dataclasses.dataclass(frozen=True)
class Wire:
    """A pack/unpack contract bound to one pytree structure + policy.

    Both ends build the same Wire from the shared (model config, policy,
    round rates); only payload bytes cross the network.
    """

    specs: Tuple[LeafSpec, ...]
    treedef: Any

    def _leaves(self, tree: PyTree) -> list:
        return self.treedef.flatten_up_to(tree)

    def pack(self, compressed: PyTree) -> bytes:
        """Compressed pytree → one framed byte buffer."""
        return self.pack_with_bits(compressed)[0]

    def pack_with_bits(
        self, compressed: PyTree, *, device_pack: bool = False,
    ) -> Tuple[bytes, int]:
        """Pack and return (buffer, exact payload bits) in one pass: the
        bits are what ``measured_bits`` reports, without re-serializing.

        ``device_pack=True`` packs every Golomb position stream on the
        leaf's device with :func:`~repro_torch.kernels.pack.seg_select_pack`
        (one launch per leaf, all launched before any result is copied to
        the host) instead of the host numpy encoder; the buffer is
        byte-identical.
        """
        leaves = self._leaves(compressed)
        launched = [
            _launch_device_golomb(comp, spec)
            if device_pack and spec.encoder == "golomb" and spec.selector != "skip"
            else None
            for comp, spec in zip(leaves, self.specs)
        ]
        out = [MAGIC, struct.pack("<I", len(leaves))]
        total_bits = 0
        for comp, spec, dev in zip(leaves, self.specs, launched):
            payload_pos = None if dev is None else _fetch_device_golomb(dev)
            payload, bits = pack_leaf(comp, spec, payload_pos)
            total_bits += bits
            out.append(struct.pack("<I", len(payload)))
            out.append(payload)
        return b"".join(out), total_bits

    def pack_device(self, compressed: PyTree) -> bytes:
        """Device-side ``pack``: byte-identical output, Golomb position
        streams packed on the device (one ``seg_select_pack`` per leaf)."""
        return self.pack_with_bits(compressed, device_pack=True)[0]

    def unpack(self, data: bytes) -> PyTree:
        """Byte buffer → dense update tree (f32 CPU tensors)."""
        return self.dense_of(self.unpack_compressed(data))

    def dense_of(self, comps: PyTree) -> PyTree:
        """Dense reconstruction of an already-unpacked compressed pytree
        (lets a server decode once and reuse the parse for bit accounting)."""
        dense = [
            leaf_dense(c, s) for c, s in zip(self._leaves(comps), self.specs)
        ]
        return self.treedef.unflatten(dense)

    def unpack_compressed(self, data: bytes) -> PyTree:
        """Byte buffer → tree of LeafCompressed of CPU tensors (for re-pack
        tests and servers that aggregate in compressed form)."""
        if len(data) < 8:
            raise ValueError(
                f"truncated SBW1 buffer: {len(data)} bytes, header needs 8"
            )
        if data[:4] != MAGIC:
            raise ValueError("bad wire magic; not an SBW1 buffer")
        (n_leaves,) = struct.unpack_from("<I", data, 4)
        if n_leaves != len(self.specs):
            raise ValueError(
                f"buffer has {n_leaves} leaves, spec expects {len(self.specs)}"
            )
        off, comps = 8, []
        for i, spec in enumerate(self.specs):
            if off + 4 > len(data):
                raise ValueError(
                    f"truncated SBW1 buffer: leaf {i} length field at byte "
                    f"{off} past end ({len(data)} bytes)"
                )
            (ln,) = struct.unpack_from("<I", data, off)
            off += 4
            if off + ln > len(data):
                raise ValueError(
                    f"truncated SBW1 buffer: leaf {i} payload of {ln} bytes "
                    f"at byte {off} past end ({len(data)} bytes)"
                )
            try:
                comps.append(unpack_leaf(data[off:off + ln], spec))
            except (ValueError, NotImplementedError):
                raise
            except Exception as e:
                # any residual parse crash on adversarial bytes surfaces as
                # a clean decode error, never an uncaught IndexError etc.
                raise ValueError(
                    f"corrupt SBW1 leaf payload for {spec.path!r}: {e!r}"
                ) from e
            off += ln
        return self.treedef.unflatten(comps)

    def measured_bits(self, compressed: PyTree) -> int:
        """Exact payload bits (pre byte-padding, no framing) — the measured
        counterpart of Eq. 1's analytic ``nbits`` sum."""
        total = 0
        for comp, spec in zip(self._leaves(compressed), self.specs):
            _, bits = pack_leaf(comp, spec)
            total += bits
        return total

    def packed_bytes(self, compressed: PyTree) -> int:
        return len(self.pack(compressed))


def _to_numpy(comp: LeafCompressed) -> LeafCompressed:
    return LeafCompressed(*(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in comp
    ))


def _launch_device_golomb(comp: LeafCompressed, spec: LeafSpec):
    """Launch one leaf's Golomb position packing on ``comp.idx``'s device:
    a one-row int32 mask built there from the surviving indices, then one
    ``seg_select_pack``.  Returns ``(words u32[1, W], nbits int32[1])``,
    or None for a leaf with no survivors."""
    idx = comp.idx
    if not isinstance(idx, torch.Tensor):
        idx = torch.from_numpy(np.asarray(idx, np.int64))
    k = int(idx.numel())
    if k == 0:
        return None
    mask = torch.zeros((1, spec.n), dtype=torch.int32, device=idx.device)
    mask[0, idx.to(torch.int64)] = 1
    return seg_select_pack(mask, k=k, bstar=golomb.golomb_bstar(spec.p))


def _fetch_device_golomb(launched) -> Tuple[bytes, int]:
    """The host bytes of a launched leaf: the big-endian view of its words,
    truncated to ``ceil(bits / 8)`` (``golomb.packed_words_to_bytes``)."""
    if launched is None:
        return b"", 0
    words, nbits = launched
    nb = int(nbits[0])
    return golomb.packed_words_to_bytes(words[0].cpu().numpy(), nb), nb


def wire_for(
    resolved: ResolvedPolicy,
    like: PyTree,
    global_rate: float = 1.0,
    round_idx: int = 0,
) -> Wire:
    """Build the Wire for a resolved policy over a concrete tree."""
    leaves = resolved._leaves_of(like)
    rates = resolved.rates(global_rate, round_idx)
    specs = tuple(
        spec_for(plan.path, tuple(leaf.shape), plan.codec, p)
        for plan, leaf, p in zip(resolved.plans, leaves, rates)
    )
    return Wire(specs=specs, treedef=resolved.treedef)
