"""Flat-buffer compression for the sharded backend: layout and hist engine.

Counterpart of ``repro.core.flat`` (DESIGN.md §10/§11).  The port carries
the block-padded layout helpers, the three-pass hist pipeline, and the
parts of :class:`ShardedFlatParamSpace` that the GSPMD backend runs on one
card: the hist engine and the exact engine with its device-packed wire.

Layout contract (identical to the reference):

  * segment i lives at ``[offset_i, offset_i + size_i)`` where
    ``offset_i`` is block-aligned (blocks of ``bm·lanes`` elements) and
    the tail up to the next block boundary is zero;
  * the error-feedback residual is one f32 array in this layout, of shape
    ``(n_clients, shards_per_client, n_pad)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.golomb import expected_position_bits, golomb_bstar
from repro_torch.core.stages import k_for
from repro_torch.kernels.flat import seg_binarize_apply, seg_hist2side, seg_moments
from repro_torch.kernels.hist2side import SPAN_OCTAVES, bucket_lower_edges
from repro_torch.kernels.ops import _side_threshold
from repro_torch.kernels.pack import bits_from_positions, row_words, seg_packbits
from repro_torch.kernels.topk import _top_k, _two_sided_topk  # noqa: F401  (_top_k re-exported)


def _pad_maps(
    offsets: Sequence[int], sizes: Sequence[int], n_pad: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded-position → raw-concat position map + validity mask: turns
    flatten into ONE gather + ONE select instead of a pad+concat per
    segment (pad slots gather position 0 and are masked to zero)."""
    pad_to_raw = np.zeros((n_pad,), np.int64)
    pad_valid = np.zeros((n_pad,), bool)
    raw = 0
    for off, size in zip(offsets, sizes):
        pad_to_raw[off:off + size] = np.arange(raw, raw + size, dtype=np.int64)
        pad_valid[off:off + size] = True
        raw += size
    return pad_to_raw, pad_valid


def _flatten_padded(leaves: Sequence[torch.Tensor], pad_to_raw: torch.Tensor,
                    pad_valid: torch.Tensor, contiguous: bool) -> torch.Tensor:
    """Flatten ``leaves`` into the block-padded layout described by the
    maps of :func:`_pad_maps` (on the leaves' device)."""
    raw = [leaf.reshape(-1).to(torch.float32) for leaf in leaves]
    raw_flat = torch.cat(raw) if len(raw) > 1 else raw[0]
    if contiguous:
        return raw_flat
    gathered = raw_flat[pad_to_raw]
    return torch.where(pad_valid, gathered, torch.zeros((), dtype=torch.float32,
                                                        device=raw_flat.device))


def _hist_pipeline(
    acc_flat: torch.Tensor,
    bounds: Sequence[Tuple[int, int]],
    ks: Sequence[int],
    rates: Sequence[float],
    seg_of_block: torch.Tensor,
    n_blocks: int,
    bm: int,
    lanes: int,
    nbins: int,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The three segment-aware passes over one flat buffer.

    ``bounds`` is the static per-segment ``(offset, size)`` table and
    ``seg_of_block`` an int64 tensor on ``acc_flat``'s device.  Two
    histogram passes (the second zoomed into each side's chosen bucket)
    pick per-segment thresholds, one moments pass gives μ±, and one fused
    pass writes ΔW* and the residual.  Returns ``(delta_star_flat,
    residual_flat, stats)`` with per-segment ``stats = {mu, count,
    nbits}``.  Everything stays on the device; nothing waits for it.
    """
    nseg = len(bounds)
    dev = acc_flat.device
    xpad = acc_flat.reshape(n_blocks * bm, lanes)
    sob = seg_of_block.to(torch.float32)[:, None]

    # per-segment |x| range for the coarse pass (max is order-independent
    # → exact)
    absmax = torch.stack([
        torch.amax(torch.abs(acc_flat[off:off + size])) for off, size in bounds
    ]) + 1e-30
    lo0 = absmax * 2.0 ** -SPAN_OCTAVES
    hi0 = absmax * 1.0001

    def block_params(*cols, seg: bool = True):
        rows = [c[seg_of_block][:, None] for c in cols]
        if seg:
            rows = [sob] + rows
        return torch.cat(rows, dim=1)

    kf = torch.tensor(ks, dtype=torch.float32, device=dev)

    h1 = seg_hist2side(xpad, block_params(lo0, hi0, lo0, hi0), nseg=nseg,
                       nbins=nbins, bm=bm, lanes=lanes)
    edges0 = bucket_lower_edges(lo0, hi0, nbins)
    lo_p, hi_p, above_p = _side_threshold(h1[:, 0], edges0, kf)
    lo_n, hi_n, above_n = _side_threshold(h1[:, 1], edges0, kf)

    h2 = seg_hist2side(xpad, block_params(lo_p, hi_p, lo_n, hi_n), nseg=nseg,
                       nbins=nbins, bm=bm, lanes=lanes)
    t_pos, _, _ = _side_threshold(h2[:, 0], bucket_lower_edges(lo_p, hi_p, nbins),
                                  kf - above_p)
    t_neg, _, _ = _side_threshold(h2[:, 1], bucket_lower_edges(lo_n, hi_n, nbins),
                                  kf - above_n)

    mom = seg_moments(xpad, block_params(t_pos, t_neg), nseg=nseg, bm=bm,
                      lanes=lanes)
    mu_pos = mom[:, 0, 0] / torch.clamp(mom[:, 0, 1], min=1.0)
    mu_neg = -mom[:, 1, 0] / torch.clamp(mom[:, 1, 1], min=1.0)
    pos_wins = mu_pos > mu_neg
    mu = torch.where(pos_wins, mu_pos, -mu_neg)
    count = torch.where(pos_wins, mom[:, 0, 1], mom[:, 1, 1])

    out_pad, res_pad = seg_binarize_apply(
        xpad,
        block_params(t_pos, t_neg, mu, pos_wins.to(torch.float32), seg=False),
        bm=bm, lanes=lanes,
    )
    ebits = torch.tensor([expected_position_bits(min(p, 1.0)) for p in rates],
                         dtype=torch.float32, device=dev)
    stats = {"mu": mu, "count": count, "nbits": count * ebits + 32.0}
    return out_pad.reshape(-1), res_pad.reshape(-1), stats


# ===================================================================== sharded


class DistSegment(NamedTuple):
    """Static per-(leaf, shard) slot in the per-device local flat buffer.

    ``shape`` is the LOCAL body shape of one shard of the leaf (no client
    dim).  The per-row survivor count ``k`` uses the dist backend's rule
    ``max(1, min(n_loc, round(p · n_loc)))``.
    """

    path: str
    shape: Tuple[int, ...]  # local body shape (one shard)
    rows: int  # L (scan superblock dim; 1 for unscanned leaves)
    n_loc: int  # per-row local length
    offset: int  # block-aligned start in the local flat buffer
    kind: str  # "sparse" | "dense" | "skip"
    rate: float  # per-leaf sparsity rate (static)
    k: int  # per-row survivors (0 for dense/skip)
    n_shards: int  # distinct shards of the GLOBAL leaf (for Eq. 1 bits)
    global_size: int


@dataclasses.dataclass(eq=False)
class ShardedFlatParamSpace:
    """The per-device block-padded flat buffer of the sharded backend
    (DESIGN.md §11), holding every local leaf shard.

    The residual buffer has shape ``(n_clients, shards_per_client,
    n_pad)``; each device owns its ``(1, 1, n_pad)`` slice.  The port runs
    one client on one card, so the exchange across the client axes (the
    hist engine's ``pmean``, the exact engine's ``all_gather``) is the
    identity; more clients need ``torch.distributed`` (ROADMAP A9) and
    raise ``NotImplementedError``.
    """

    segments: Tuple[DistSegment, ...]
    client_axes: Tuple[str, ...]
    shard_axes: Tuple[str, ...]
    n_clients: int
    shards_per_client: int
    bm: int = 8
    lanes: int = 128

    def __post_init__(self) -> None:
        per_block = self.bm * self.lanes
        sizes = [s.rows * s.n_loc for s in self.segments]
        self.n_blocks = sum(max(1, -(-sz // per_block)) for sz in sizes)
        self.n_pad = self.n_blocks * per_block
        self.n_total = sum(sizes)
        seg_of_block = np.zeros((self.n_blocks,), np.int32)
        dense_mask = np.zeros((self.n_pad,), bool)
        for i, (s, sz) in enumerate(zip(self.segments, sizes)):
            blk0 = s.offset // per_block
            nblk = max(1, -(-sz // per_block))
            seg_of_block[blk0:blk0 + nblk] = i
            if s.kind == "dense":
                dense_mask[s.offset:s.offset + sz] = True
        self.seg_of_block = seg_of_block
        self._pad_to_raw, self._pad_valid = _pad_maps(
            [s.offset for s in self.segments], sizes, self.n_pad
        )
        self._dense_idx = np.flatnonzero(dense_mask).astype(np.int32)
        # the exact engine's static maps: every (row, k-slot) of every
        # sparse segment gets one position slot; ``_pos_row`` maps it to
        # its row's slot in the μ stream
        self._sparse = tuple(s for s in self.segments if s.kind == "sparse")
        pos_row: List[np.ndarray] = []
        mu_slot = 0
        for s in self._sparse:
            pos_row.append(
                np.repeat(np.arange(mu_slot, mu_slot + s.rows, dtype=np.int32), s.k)
            )
            mu_slot += s.rows
        self.n_mu = mu_slot
        self._pos_row = (
            np.concatenate(pos_row) if pos_row else np.zeros((0,), np.int32)
        )
        self.n_pos = int(self._pos_row.shape[0])
        # device-pack layout: one packed uint32 Golomb stream per (segment,
        # row), capacity-padded to whole words, so the concatenated word
        # buffer and every row's slice of it are static.  ``(b*, words/row,
        # word offset)`` per sparse segment.
        winfo: List[Tuple[int, int, int]] = []
        woff = 0
        for s in self._sparse:
            b = golomb_bstar(s.rate)
            w = row_words(s.n_loc, s.k, b)
            winfo.append((b, w, woff))
            woff += s.rows * w
        self._pack_info = tuple(winfo)
        self.n_pack_words = woff
        self._maps: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    # ------------------------------------------------------------- building

    @classmethod
    def build(
        cls,
        entries: Sequence[dict],
        *,
        client_axes: Tuple[str, ...],
        shard_axes: Tuple[str, ...],
        n_clients: int,
        shards_per_client: int,
        bm: int = 8,
        lanes: int = 128,
    ) -> "ShardedFlatParamSpace":
        """``entries``: per-leaf dicts with keys ``path``, ``shape``
        (local body shape), ``rows``, ``kind``, ``rate``, ``n_shards``,
        ``global_size``."""
        per_block = bm * lanes
        segs: List[DistSegment] = []
        off = 0
        for e in entries:
            size = int(np.prod(e["shape"])) if e["shape"] else 1
            rows = int(e["rows"])
            n_loc = size // rows
            k = (
                max(1, min(n_loc, int(round(e["rate"] * n_loc))))
                if e["kind"] == "sparse" else 0
            )
            segs.append(DistSegment(
                path=e["path"], shape=tuple(e["shape"]), rows=rows,
                n_loc=n_loc, offset=off, kind=e["kind"],
                rate=float(e["rate"]), k=k, n_shards=int(e["n_shards"]),
                global_size=int(e["global_size"]),
            ))
            off += max(1, -(-size // per_block)) * per_block
        return cls(
            segments=tuple(segs), client_axes=tuple(client_axes),
            shard_axes=tuple(shard_axes), n_clients=int(n_clients),
            shards_per_client=int(shards_per_client), bm=bm, lanes=lanes,
        )

    def _device_maps(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``(pad_to_raw, pad_valid, seg_of_block, pos_row, dense_idx)`` as
        int64/bool tensors on ``device``, copied there once."""
        maps = self._maps.get(device)
        if maps is None:
            maps = tuple(
                torch.from_numpy(a).to(device) for a in (
                    self._pad_to_raw, self._pad_valid,
                    self.seg_of_block.astype(np.int64),
                    self._pos_row.astype(np.int64),
                    self._dense_idx.astype(np.int64),
                )
            )
            self._maps[device] = maps
        return maps

    # --------------------------------------------------------- flat plumbing

    def flatten_local(self, bodies: Sequence[torch.Tensor]) -> torch.Tensor:
        """Local leaf shards (in segment order) → one local flat buffer."""
        pad_to_raw, pad_valid = self._device_maps(bodies[0].device)[:2]
        return _flatten_padded(bodies, pad_to_raw, pad_valid,
                               contiguous=self.n_pad == self.n_total)

    def unflatten_local(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Local flat buffer → list of local body views (segment order)."""
        return [
            flat[s.offset:s.offset + s.rows * s.n_loc].reshape(s.shape)
            for s in self.segments
        ]

    def zeros_residual(self, device) -> torch.Tensor:
        """The flat sharded error-feedback state."""
        return torch.zeros(
            (self.n_clients, self.shards_per_client, self.n_pad),
            dtype=torch.float32, device=device,
        )

    # ------------------------------------------------------- bit accounting

    def bits_per_client(self) -> float:
        """Static Eq. 1 wire bits per client per round: sparse segments pay
        ``rows · n_shards · (k · b̄_pos(p) + 32)``, dense segments 32
        bits/entry, skipped segments 0."""
        total = 0.0
        for s in self.segments:
            if s.kind == "sparse":
                total += s.rows * s.n_shards * (
                    s.k * expected_position_bits(s.rate) + 32.0
                )
            elif s.kind == "dense":
                total += 32.0 * s.global_size
        return total

    # ------------------------------------------------------- exact exchange

    def exchange_local(
        self,
        bodies: Sequence[torch.Tensor],
        res_flat: Optional[torch.Tensor],
        *,
        device_pack: bool = False,
    ) -> tuple:
        """Compress this device's shard of every leaf and exchange.
        Returns ``(mean_flat, own_flat, new_res_flat)``: the aggregated
        update, this client's ΔW*, and the new residual, all in the local
        flat layout.

        Per-(segment, row) exact two-sided top-k (paper Alg. 2,
        :func:`_two_sided_topk`); dense segments send their values, skip
        segments nothing (their update stays in the residual).  With one
        client the exchange is the identity, so the mean is ΔW*.

        ``device_pack=True`` also Golomb-packs every (segment, row)'s
        surviving positions on the device (:meth:`_pack_local`, one
        :func:`~repro_torch.kernels.pack.seg_packbits` launch) and returns
        two more outputs, ``(words u32[n_pack_words], nbits int32[n_mu])``:
        this shard's packed streams and exact per-row bit counts,
        byte-identical to the host ``encode_positions_packed``.
        """
        if self.client_axes and self.n_clients > 1:
            raise NotImplementedError(
                "the exact exchange over more than one client needs "
                "torch.distributed (ROADMAP A9)"
            )
        acc = self.flatten_local(bodies)
        if res_flat is not None:
            acc = res_flat + acc
        _, _, _, pos_row, dense_idx = self._device_maps(acc.device)

        pos_parts, mu_parts, idx_parts = [], [], []
        for s in self._sparse:
            x = acc[s.offset:s.offset + s.rows * s.n_loc].reshape(s.rows, s.n_loc)
            idx, mu = _two_sided_topk(x, s.k)
            base = s.offset + s.n_loc * torch.arange(s.rows, device=acc.device)
            pos_parts.append((idx + base[:, None]).reshape(-1))
            mu_parts.append(mu)
            idx_parts.append(idx)

        own = torch.zeros((self.n_pad,), dtype=torch.float32, device=acc.device)
        if pos_parts:
            own[torch.cat(pos_parts)] = torch.cat(mu_parts)[pos_row]
        if self._dense_idx.size:
            own[dense_idx] = acc[dense_idx]
        # one client: the all_gather of (positions, μ) and the pmean of the
        # dense values are the identity
        mean = own
        new_res = acc - own if res_flat is not None else None
        if device_pack:
            words, nbits = self._pack_local(idx_parts, acc.device)
            return mean, own, new_res, words, nbits
        return mean, own, new_res

    def _pack_local(self, idx_parts: List[torch.Tensor], device: torch.device) -> tuple:
        """This shard's survivors → (packed u32 words, per-row bit counts).

        Builds every (segment, row)'s Golomb bit stream at its static
        offset in one concatenated bit buffer, then folds the bits into
        ``uint32`` words with ONE ``seg_packbits`` launch over the whole
        flat set.
        """
        if not idx_parts:
            return (torch.zeros((0,), dtype=torch.int32, device=device).view(torch.uint32),
                    torch.zeros((0,), dtype=torch.int32, device=device))
        chunks, nb_parts = [], []
        for (b, w, _), idx_s in zip(self._pack_info, idx_parts):
            bits_s, nb_s = bits_from_positions(torch.sort(idx_s, dim=1).values,
                                               bstar=b, cap32=32 * w)
            chunks.append(bits_s.reshape(-1))
            nb_parts.append(nb_s)
        allbits = torch.cat(chunks)
        pad = -allbits.shape[0] % (32 * self.lanes)
        if pad:
            allbits = torch.cat([allbits, allbits.new_zeros((pad,))])
        planes = allbits.reshape(-1, 32).T.contiguous()
        words = seg_packbits(planes, lanes=self.lanes)
        return words[: self.n_pack_words], torch.cat(nb_parts)

    # -------------------------------------------------------- hist exchange

    def exchange_local_hist(
        self,
        bodies: Sequence[torch.Tensor],
        res_flat: Optional[torch.Tensor],
        *,
        nbins: int = 128,
    ) -> tuple:
        """The segment-aware passes (:mod:`repro_torch.kernels.flat`) over
        this device's local flat buffer — one launch per pass.

        Approximate survivor counts (histogram thresholds); the exchange
        is a mean of the binarized ΔW* over the clients.  Requires an
        all-sparse policy.  Returns ``(mean_flat, own_flat,
        new_res_flat)``.
        """
        if any(s.kind != "sparse" for s in self.segments):
            raise ValueError(
                "exchange_local_hist needs an all-SBC policy; dense/skip "
                "leaves belong to the exact engine"
            )
        if self.client_axes and self.n_clients > 1:
            raise NotImplementedError(
                "the hist exchange over more than one client needs "
                "torch.distributed (ROADMAP A9)"
            )
        acc = self.flatten_local(bodies)
        if res_flat is not None:
            acc = res_flat + acc
        own, res, _stats = _hist_pipeline(
            acc,
            bounds=[(s.offset, s.rows * s.n_loc) for s in self.segments],
            ks=[k_for(s.rows * s.n_loc, s.rate) for s in self.segments],
            rates=[s.rate for s in self.segments],
            seg_of_block=self._device_maps(acc.device)[2],
            n_blocks=self.n_blocks,
            bm=self.bm,
            lanes=self.lanes,
            nbins=nbins,
        )
        # one client: the pmean over the client axes is the identity
        mean = own
        new_res = res if res_flat is not None else None
        return mean, own, new_res
