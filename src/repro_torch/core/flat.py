"""Flat-buffer compression: the layout, the exact and hist engines.

Counterpart of ``repro.core.flat`` (DESIGN.md §10/§11).  The port carries
the block-padded layout helpers, the three-pass hist pipeline,
:class:`FlatParamSpace` (the ``fast=True`` path of ``ResolvedPolicy``:
its exact engine ``compress``, which the local backend runs, and its hist
engine ``compress_hist``), and the parts of :class:`ShardedFlatParamSpace`
that the GSPMD backend runs: the hist engine and the exact engine with its
device-packed wire, one client per process, exchanging over a
:class:`~repro_torch.launch.mesh.ClientGroup`.

Layout contract (identical to the reference):

  * segment i lives at ``[offset_i, offset_i + size_i)`` where
    ``offset_i`` is block-aligned (blocks of ``bm·lanes`` elements) and
    the tail up to the next block boundary is zero;
  * the error-feedback residual is one f32 array in this layout: of shape
    ``(n_pad,)`` per client for :class:`FlatParamSpace` (``(C, n_pad)``
    for C clients as rows), ``(n_clients, shards_per_client, n_pad)`` for
    the sharded space.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.golomb import expected_position_bits, golomb_bstar
from repro_torch.core.policy import supports  # noqa: F401  (the reference's name for it here)
from repro_torch.core.stages import LeafCompressed, k_for
from repro_torch.core.tree import tree_map
from repro_torch.kernels.flat import (check_flat_size, seg_absmax, seg_accumulate,
                                      seg_binarize_apply, seg_hist2side, seg_moments)
from repro_torch.kernels.hist2side import SPAN_OCTAVES, bucket_lower_edges
from repro_torch.kernels.ops import _side_threshold
from repro_torch.kernels.pack import (bits_from_positions, golomb_decode_rows, pack_bit_rows,
                                      row_words)
from repro_torch.kernels.reduce import _reciprocal
from repro_torch.kernels.topk import _top_k, _two_sided_topk  # noqa: F401  (_top_k re-exported)
from repro_torch.obs.stages import NULL_STAGES

PyTree = Any  # a nested dict of tensors, as the reference's pytrees


def _pad_maps(
    offsets: Sequence[int], sizes: Sequence[int], n_pad: int
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Padded-position → raw-concat position map + validity mask: turns
    flatten into ONE gather + ONE select instead of a pad+concat per
    segment (pad slots gather position 0 and are masked to zero).  A
    layout without pad (every leaf a whole number of blocks) flattens by a
    concat alone and gets ``(None, None)``: at mixtral's 1.58 G entries
    the int64 map alone would be 12.7 GB on the card."""
    if n_pad == sum(sizes):
        return None, None
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
    stages=NULL_STAGES,
    *,
    absmax: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """The three segment-aware passes over one flat buffer.

    ``bounds`` is the static per-segment ``(offset, size)`` table and
    ``seg_of_block`` an int64 tensor on ``acc_flat``'s device; ``absmax``
    each segment's max ``|x|`` (:func:`~repro_torch.kernels.flat.
    seg_absmax`, or what the fused :func:`~repro_torch.kernels.flat.
    seg_accumulate` gives with the buffer), which the pipeline takes over:
    it adds its 1e-30 in place, so no second vector is held while the
    passes run.  Two histogram passes (the first over ranges set by
    ``absmax``, the second zoomed into each side's chosen bucket) pick
    per-segment thresholds, one moments pass gives μ±, and one fused pass
    writes ΔW* and the residual.  Returns ``(delta_star_flat,
    residual_flat, stats)`` with per-segment ``stats = {mu, count,
    nbits}``.  Everything stays on the device; nothing waits for it.
    ``stages`` opens ``exchange.select``, ``exchange.moments`` and
    ``exchange.binarize`` around the passes.

    ``acc_flat`` of shape ``(S, n_pad)`` holds S devices' buffers of the
    one layout (``bounds``, ``seg_of_block`` and ``n_blocks`` are one
    device's): each pass is still one launch, over S × segments, device
    d's segment i numbered ``d · nseg + i`` (in ``absmax`` too), and the
    outputs keep that shape.
    """
    nseg = len(bounds)
    dev = acc_flat.device
    S = acc_flat.shape[0] if acc_flat.dim() == 2 else 1
    xpad = acc_flat.reshape(S * n_blocks * bm, lanes)
    if S > 1:
        seg_of_block = (seg_of_block[None, :]
                        + nseg * torch.arange(S, device=dev)[:, None]).reshape(-1)
        ks, rates = list(ks) * S, list(rates) * S
    sob = seg_of_block.to(torch.float32)[:, None]

    def block_params(*cols, seg: bool = True):
        rows = [c[seg_of_block][:, None] for c in cols]
        if seg:
            rows = [sob] + rows
        return torch.cat(rows, dim=1)

    with stages.stage("exchange.select"):
        # per-segment |x| range for the coarse pass
        absmax = absmax.add_(1e-30)
        lo0 = absmax * 2.0 ** -SPAN_OCTAVES
        hi0 = absmax * 1.0001
        kf = torch.tensor(ks, dtype=torch.float32, device=dev)

        h1 = seg_hist2side(xpad, block_params(lo0, hi0, lo0, hi0), nseg=S * nseg,
                           nbins=nbins, bm=bm, lanes=lanes)
        edges0 = bucket_lower_edges(lo0, hi0, nbins)
        lo_p, hi_p, above_p = _side_threshold(h1[:, 0], edges0, kf)
        lo_n, hi_n, above_n = _side_threshold(h1[:, 1], edges0, kf)

        h2 = seg_hist2side(xpad, block_params(lo_p, hi_p, lo_n, hi_n), nseg=S * nseg,
                           nbins=nbins, bm=bm, lanes=lanes)
        t_pos, _, _ = _side_threshold(h2[:, 0], bucket_lower_edges(lo_p, hi_p, nbins),
                                      kf - above_p)
        t_neg, _, _ = _side_threshold(h2[:, 1], bucket_lower_edges(lo_n, hi_n, nbins),
                                      kf - above_n)

    with stages.stage("exchange.moments"):
        mom = seg_moments(xpad, block_params(t_pos, t_neg), nseg=S * nseg, bm=bm,
                          lanes=lanes)
        mu_pos = mom[:, 0, 0] / torch.clamp(mom[:, 0, 1], min=1.0)
        mu_neg = -mom[:, 1, 0] / torch.clamp(mom[:, 1, 1], min=1.0)
        pos_wins = mu_pos > mu_neg
        mu = torch.where(pos_wins, mu_pos, -mu_neg)
        count = torch.where(pos_wins, mom[:, 0, 1], mom[:, 1, 1])

    with stages.stage("exchange.binarize"):
        out_pad, res_pad = seg_binarize_apply(
            xpad,
            block_params(t_pos, t_neg, mu, pos_wins.to(torch.float32), seg=False),
            bm=bm, lanes=lanes,
        )
        ebits = torch.tensor([expected_position_bits(min(p, 1.0)) for p in rates],
                             dtype=torch.float32, device=dev)
        stats = {"mu": mu, "count": count, "nbits": count * ebits + 32.0}
    return out_pad.reshape(acc_flat.shape), res_pad.reshape(acc_flat.shape), stats


class Segment(NamedTuple):
    """Static per-leaf slot in the flat buffer."""

    path: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    size: int
    offset: int  # block-aligned start in the padded flat buffer
    kind: str  # "sbc" | "dense" | "skip"
    use_residual: bool


@dataclasses.dataclass(eq=False)
class FlatParamSpace:
    """One resolved policy bound to one tree layout, flattened to a single
    block-padded f32 buffer (the ``fast=True`` path of DESIGN.md §10).

    :meth:`compress` is the exact engine: bit-identical to the per-leaf
    ``ResolvedPolicy.compress`` (indices, μ down to the sign of zero,
    ΔW*, residuals, and so SBW1 bytes), with the residual kept in the
    flat layout.  :meth:`compress_rows` runs it on C clients at once:
    each SBC segment's C rows go through one two-sided top-k and one
    ``f32_mean_xla`` launch, so the launches of a round do not grow with
    C, and each client's result is the one compressing it alone gives.
    :meth:`compress_hist` is the hist engine (the three segment-aware
    passes of :mod:`repro_torch.kernels.flat`).  ``bm``/``lanes`` fix the
    block size; the two engines share the residual, so they must match.
    """

    resolved: Any  # ResolvedPolicy (duck-typed; no import cycle)
    segments: Tuple[Segment, ...]
    bm: int = 8
    lanes: int = 128

    def __post_init__(self) -> None:
        per_block = self.bm * self.lanes
        self.n_blocks = sum(max(1, -(-s.size // per_block)) for s in self.segments)
        self.n_pad = check_flat_size(self.n_blocks * per_block)
        self.n_total = sum(s.size for s in self.segments)
        seg_of_block = np.zeros((self.n_blocks,), np.int32)
        res_mask = np.zeros((self.n_pad,), bool)
        dense_mask = np.zeros((self.n_pad,), bool)
        for i, s in enumerate(self.segments):
            blk0 = s.offset // per_block
            seg_of_block[blk0:blk0 + max(1, -(-s.size // per_block))] = i
            if s.use_residual:
                res_mask[s.offset:s.offset + s.size] = True
            if s.kind == "dense":
                dense_mask[s.offset:s.offset + s.size] = True
        self.seg_of_block = seg_of_block
        self._res_mask = res_mask
        self._dense_mask = dense_mask
        self._pad_to_raw, self._pad_valid = _pad_maps(
            [s.offset for s in self.segments], [s.size for s in self.segments], self.n_pad)
        # pad slots keep their zeros under the acc/dense/residual updates,
        # so the mask-free branch needs only every LEAF to use the residual
        self._all_residual = all(s.use_residual for s in self.segments)
        self._any_dense = any(s.kind == "dense" for s in self.segments)
        self._maps: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    @classmethod
    def for_resolved(cls, resolved, like, *, bm: int = 8,
                     lanes: int = 128) -> "FlatParamSpace":
        """Bind ``resolved`` to the leaf shapes of ``like``."""
        per_block = bm * lanes
        segs: List[Segment] = []
        off = 0
        for plan, leaf in zip(resolved.plans, resolved._leaves_of(like)):
            kind = plan.codec.flat_kind
            if kind is None:
                raise ValueError(
                    f"leaf {plan.path!r} codec {plan.codec.spec!r} has no flat fast "
                    "path; guard with repro_torch.core.flat.supports()")
            shape = tuple(leaf.shape)
            size = int(np.prod(shape)) if shape else 1
            segs.append(Segment(path=plan.path, shape=shape, dtype=leaf.dtype, size=size,
                                offset=off, kind=kind,
                                use_residual=plan.codec.use_residual))
            off += max(1, -(-size // per_block)) * per_block
        return cls(resolved=resolved, segments=tuple(segs), bm=bm, lanes=lanes)

    def _device_maps(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``(pad_to_raw, pad_valid, res_mask, dense_mask, seg_of_block)``
        on ``device``, copied there once."""
        maps = self._maps.get(device)
        if maps is None:
            maps = tuple(None if a is None else torch.from_numpy(a).to(device) for a in (
                self._pad_to_raw, self._pad_valid, self._res_mask, self._dense_mask,
                self.seg_of_block.astype(np.int64)))
            self._maps[device] = maps
        return maps

    # --------------------------------------------------------- flat plumbing

    def flatten(self, tree) -> torch.Tensor:
        """Tree → one block-padded f32 buffer (the §10 layout); leaves with
        a leading client axis give ``(C, n_pad)``."""
        return self._flatten_leaves(self.resolved._leaves_of(tree))

    def _flatten_leaves(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        rows = leaves[0].dim() > len(self.segments[0].shape)
        if not rows:
            return self._flatten_leaves([leaf[None] for leaf in leaves])[0]
        pad_to_raw, pad_valid = self._device_maps(leaves[0].device)[:2]
        raw = torch.cat([leaf.reshape(leaf.shape[0], -1).to(torch.float32)
                         for leaf in leaves], dim=1)
        if self.n_pad == self.n_total:
            return raw
        return torch.where(pad_valid, raw[:, pad_to_raw],
                           torch.zeros((), dtype=torch.float32, device=raw.device))

    def unflatten(self, flat: torch.Tensor, cast: bool = True):
        """Flat buffer → tree (inverse of :meth:`flatten`); a leading
        client axis is kept."""
        lead = tuple(flat.shape[:-1])
        out = []
        for seg in self.segments:
            piece = flat[..., seg.offset:seg.offset + seg.size].reshape(lead + seg.shape)
            out.append(piece.to(seg.dtype) if cast else piece)
        return self.resolved.treedef.unflatten(out)

    def zeros_residual(self, device) -> torch.Tensor:
        """The flat error-feedback state of one client, on ``device``."""
        return torch.zeros((self.n_pad,), dtype=torch.float32, device=device)

    def _check_rates(self, rates) -> Tuple[float, ...]:
        if not isinstance(rates, tuple):
            rates = (float(rates),) * len(self.segments)
        if len(rates) != len(self.segments):
            raise ValueError(f"got {len(rates)} rates for {len(self.segments)} leaves")
        return tuple(float(r) for r in rates)

    def _ks(self, rates: Tuple[float, ...]) -> Tuple[int, ...]:
        return tuple(
            0 if s.kind == "skip" else s.size if s.kind == "dense" else k_for(s.size, p)
            for s, p in zip(self.segments, rates)
        )

    # ------------------------------------------------------------ exact path

    def compress(self, delta, state, rates) -> tuple:
        """Drop-in, bit-identical replacement for the per-leaf
        ``ResolvedPolicy.compress``: the same ``(ctree, dense_tree,
        new_state)``, with ``new_state.residual`` in the flat layout."""
        rows = tree_map(lambda x: x[None], delta)
        st = state._replace(residual=state.residual[None]
                            if self.resolved.any_residual else state.residual)
        ctree, dense, new = self.compress_rows(rows, st, rates)
        one = lambda tree: self.resolved.treedef.unflatten(
            [_map_fields(lambda v: v[0], x) if isinstance(x, LeafCompressed) else x[0]
             for x in self.resolved._leaves_of(tree)])
        res = new.residual[0] if self.resolved.any_residual else new.residual
        return one(ctree), one(dense), new._replace(residual=res)

    def compress_rows(self, deltas, state, rates) -> tuple:
        """:meth:`compress` of C clients at once: every leaf of ``deltas``
        and the flat residual ``(C, n_pad)`` carry a leading client axis,
        as do the outputs (each LeafCompressed field too)."""
        rates = self._check_rates(rates)
        residual = state.residual if self.resolved.any_residual else None
        comp, dense, new_res = self._compress_exact(
            self.resolved._leaves_of(deltas), residual, rates)
        treedef = self.resolved.treedef
        new_state = state._replace(residual=new_res if new_res is not None
                                   else state.residual, step=state.step + 1)
        return treedef.unflatten(comp), treedef.unflatten(dense), new_state

    def _compress_exact(self, leaves, residual, rates):
        segs, ks = self.segments, self._ks(rates)
        delta = self._flatten_leaves(leaves)  # (C, n_pad)
        dev, C = delta.device, delta.shape[0]
        _, _, res_mask, dense_mask, _ = self._device_maps(dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if residual is None:
            acc = delta
        elif self._all_residual:
            acc = delta + residual
        else:
            acc = delta + torch.where(res_mask, residual, zero)

        def empty(dtype=torch.float32):
            return torch.zeros((C, 0), dtype=dtype, device=dev)

        comp: List[Optional[LeafCompressed]] = [None] * len(segs)
        gidx, gmu = [], []
        for i, (seg, k, p) in enumerate(zip(segs, ks, rates)):
            x = acc[:, seg.offset:seg.offset + seg.size]
            codec = self.resolved.plans[i].codec
            if seg.kind == "skip":
                comp[i] = LeafCompressed(idx=empty(torch.int32), vals=empty(),
                                         mean=zero.expand(C), dense=empty(),
                                         nbits=zero.expand(C))
                continue
            if seg.kind == "dense":
                comp[i] = LeafCompressed(
                    idx=empty(torch.int32), vals=empty(), mean=zero.expand(C), dense=x,
                    nbits=torch.full((C,), codec.quantizer.value_bits(k),
                                     dtype=torch.float32, device=dev))
                continue
            idx, mu = _two_sided_topk(x, k)
            # the reference re-gathers the winning side's values and takes
            # their mean, which is never −0.0 (XLA's cascade starts every
            # sum at +0.0); −mean(−v) equals it bit for bit but for the
            # sign of a zero, so a zero μ is +0.0 here too
            mu = torch.where(mu == 0, zero, mu)
            nbits = codec.encoder.position_bits(seg.size, k, p) + codec.quantizer.value_bits(k)
            comp[i] = LeafCompressed(
                idx=idx.to(torch.int32), vals=empty(), mean=mu, dense=empty(),
                nbits=torch.full((C,), nbits, dtype=torch.float32, device=dev))
            gidx.append(idx + seg.offset)
            gmu.append(mu[:, None].expand(C, k))

        # ΔW* of every sparse leaf in one scatter; dense segments pass acc
        # through one static-mask select; skip segments stay zero
        dense_flat = torch.zeros((C, self.n_pad), dtype=torch.float32, device=dev)
        if gidx:
            dense_flat.scatter_(1, torch.cat(gidx, 1), torch.cat(gmu, 1))
        if self._any_dense:
            dense_flat = torch.where(dense_mask, acc, dense_flat)
        new_res = None
        if residual is not None:
            new_res = (acc - dense_flat if self._all_residual
                       else torch.where(res_mask, acc - dense_flat, residual))
        dense_leaves = [
            dense_flat[:, s.offset:s.offset + s.size].reshape((C,) + s.shape).to(s.dtype)
            for s in segs
        ]
        return comp, dense_leaves, new_res

    # ----------------------------------------------------------- hist engine

    def compress_hist(self, delta, state, rates, *, nbins: int = 128) -> tuple:
        """Histogram-threshold SBC over the flat buffer: the three
        segment-aware passes, one launch each over the whole parameter set.

        Per-segment semantics match :func:`repro_torch.kernels.ops.
        sbc_compress_hist` (approximate survivor counts; acc = ΔW* + R
        exactly).  Requires an all-SBC policy.  Returns ``(dense_tree,
        new_state, stats)`` with per-segment ``stats = {mu, count, nbits}``.
        """
        if any(s.kind != "sbc" for s in self.segments):
            raise ValueError("compress_hist needs an all-SBC policy; dense/skip leaves "
                             "belong to the exact engine")
        rates = self._check_rates(rates)
        residual = state.residual if self.resolved.any_residual else None
        bounds = [(s.offset, s.size) for s in self.segments]
        acc, absmax = seg_accumulate(self.resolved._leaves_of(delta), residual, bounds,
                                     self.n_pad, bm=self.bm, lanes=self.lanes)
        dense_flat, res_flat, stats = _hist_pipeline(
            acc, bounds=bounds, ks=self._ks(rates),
            rates=rates, seg_of_block=self._device_maps(acc.device)[4],
            n_blocks=self.n_blocks, bm=self.bm, lanes=self.lanes, nbins=nbins, absmax=absmax)
        new_state = state._replace(residual=res_flat if residual is not None
                                   else state.residual, step=state.step + 1)
        return self.unflatten(dense_flat), new_state, stats


def _map_fields(fn, comp: LeafCompressed) -> LeafCompressed:
    return LeafCompressed(*(fn(v) for v in comp))


# ===================================================================== sharded


def shard_blocks(x: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """The GSPMD equal blocks of ``x`` under a per-dim shard ``grid``,
    stacked in grid order (``itertools.product`` over the dims, the
    reference's ``_iter_shard_blocks``): ``(Π grid, *local shape)``.  A
    copy unless every dim has one shard."""
    grid = tuple(grid) + (1,) * (x.dim() - len(grid))
    if all(g == 1 for g in grid):
        return x[None]
    local = [d // g for d, g in zip(x.shape, grid)]
    split = [v for pair in zip(grid, local) for v in pair]
    n = len(grid)
    perm = list(range(0, 2 * n, 2)) + list(range(1, 2 * n, 2))
    return x.reshape(split).permute(perm).reshape([-1] + local)


def unshard_blocks(blocks: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    """The inverse of :func:`shard_blocks`: grid-order blocks ``(Π grid,
    *local shape)`` → the whole tensor."""
    local = list(blocks.shape[1:])
    grid = tuple(grid) + (1,) * (len(local) - len(grid))
    if all(g == 1 for g in grid):
        return blocks[0]
    n = len(grid)
    perm = [v for i in range(n) for v in (i, n + i)]
    return blocks.reshape(list(grid) + local).permute(perm).reshape(
        [g * d for g, d in zip(grid, local)])


class DistSegment(NamedTuple):
    """Static per-(leaf, shard) slot in the per-device local flat buffer.

    ``shape`` is the LOCAL body shape of one shard of the leaf (no client
    dim).  The per-row survivor count ``k`` uses the dist backend's rule
    ``max(1, min(n_loc, round(p · n_loc)))``.  ``grid`` is the leaf's
    per-dim shard counts and ``dev_block`` the grid-order block each of
    the client's devices holds (device d of ``shards_per_client``, row-major
    over the shard axes).
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
    grid: Tuple[int, ...] = ()  # per-dim shard counts (() : one shard)
    dev_block: Tuple[int, ...] = (0,)  # the block of each device of the client


@dataclasses.dataclass(eq=False)
class ShardedFlatParamSpace:
    """The per-device block-padded flat buffer of the sharded backend
    (DESIGN.md §11), holding every local leaf shard.

    The residual buffer has shape ``(n_clients, shards_per_client,
    n_pad)``.  One client runs per process (:mod:`repro_torch.launch.mesh`)
    and holds its client's row, ``(1, shards_per_client, n_pad)``: the
    buffers of all S = ``shards_per_client`` devices of its client, in the
    reference's device order (row-major over the shard axes), each with
    the leaves' blocks that device holds (``DistSegment.dev_block``).
    ``group`` is the :class:`~repro_torch.launch.mesh.ClientGroup` whose
    ranks are the clients (with one rank a device, the exchange's
    sub-group: the ranks of this device coordinate, one a client, whose
    space holds that one device, ``shards_per_client=1``), and the
    exchange across them (the hist engine's ``pmean``, the exact engine's
    ``all_gather``) goes through it; ``client_grid`` gives the sizes of the client axes, whose order
    the reference's collectives follow (default: one axis).  With one
    client the exchange is the identity and crosses no process.

    The local flat layout of the methods is ``(n_pad,)`` with one device
    a client and ``(S, n_pad)`` with S (:attr:`local_shape`); every pass
    runs over all S devices at once.
    """

    segments: Tuple[DistSegment, ...]
    client_axes: Tuple[str, ...]
    shard_axes: Tuple[str, ...]
    n_clients: int
    shards_per_client: int
    group: Any  # the exchange's ClientGroup, n_clients ranks
    bm: int = 8
    lanes: int = 128
    client_grid: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        per_block = self.bm * self.lanes
        S = self.shards_per_client
        sizes = [s.rows * s.n_loc for s in self.segments]
        self.n_blocks = sum(max(1, -(-sz // per_block)) for sz in sizes)
        self.n_pad = self.n_blocks * per_block
        check_flat_size(S * self.n_pad)
        self.local_shape = (self.n_pad,) if S == 1 else (S, self.n_pad)
        self.n_total = sum(sizes)
        seg_of_block = np.zeros((self.n_blocks,), np.int32)
        dense_mask = np.zeros((self.n_pad,), bool)
        for i, (s, sz) in enumerate(zip(self.segments, sizes)):
            blk0 = s.offset // per_block
            nblk = max(1, -(-sz // per_block))
            seg_of_block[blk0:blk0 + nblk] = i
            if s.kind == "dense":
                dense_mask[s.offset:s.offset + sz] = True
            if len(s.dev_block) != S:
                raise ValueError(f"{s.path}: {len(s.dev_block)} device blocks for {S} devices")
        self.seg_of_block = seg_of_block
        # the pad maps (n_pad entries each) are made at the first use on a
        # device: a plan of a full-depth layout needs none
        self._sizes = sizes
        # the dense slots of all S device buffers of this rank
        dense_one = np.flatnonzero(dense_mask).astype(np.int64)
        self._dense_idx = (np.arange(S, dtype=np.int64)[:, None] * self.n_pad
                           + dense_one[None, :]).reshape(-1)
        # the exact engine's static maps: every (device, row, k-slot) of
        # every sparse segment gets one position slot, segment by segment;
        # ``_pos_row`` maps it to its row's slot in the μ stream.  ``n_mu``
        # counts one device's rows, as in the reference
        self._sparse = tuple(s for s in self.segments if s.kind == "sparse")
        pos_row: List[np.ndarray] = []
        mu_slot = 0
        for s in self._sparse:
            pos_row.append(
                np.repeat(np.arange(mu_slot, mu_slot + S * s.rows, dtype=np.int32), s.k)
            )
            mu_slot += S * s.rows
        self.n_mu = mu_slot // S
        self._pos_row = (
            np.concatenate(pos_row) if pos_row else np.zeros((0,), np.int32)
        )
        self.n_pos = int(self._pos_row.shape[0]) // S
        # device-pack layout: one packed uint32 Golomb stream per (segment,
        # row), capacity-padded to whole words, so the concatenated word
        # buffer of a device and every row's slice of it are static.
        # ``(b*, words/row, word offset)`` per sparse segment.
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
        group: Any,
        bm: int = 8,
        lanes: int = 128,
        client_grid: Tuple[int, ...] = (),
    ) -> "ShardedFlatParamSpace":
        """``entries``: per-leaf dicts with keys ``path``, ``shape``
        (local body shape), ``rows``, ``kind``, ``rate``, ``n_shards``,
        ``global_size``, and with several devices a client ``grid`` and
        ``dev_block`` (:class:`DistSegment`); ``group`` the clients'
        ClientGroup."""
        per_block = bm * lanes
        segs: List[DistSegment] = []
        off = 0
        for e in entries:
            size = int(np.prod(e["shape"])) if e["shape"] else 1
            rows = int(e["rows"])
            n_loc = size // rows
            k = k_for(n_loc, e["rate"]) if e["kind"] == "sparse" else 0
            segs.append(DistSegment(
                path=e["path"], shape=tuple(e["shape"]), rows=rows,
                n_loc=n_loc, offset=off, kind=e["kind"],
                rate=float(e["rate"]), k=k, n_shards=int(e["n_shards"]),
                global_size=int(e["global_size"]),
                grid=tuple(int(g) for g in e.get("grid", ())),
                dev_block=tuple(int(b) for b in e.get("dev_block", (0,) * shards_per_client)),
            ))
            off += max(1, -(-size // per_block)) * per_block
        return cls(
            segments=tuple(segs), client_axes=tuple(client_axes),
            shard_axes=tuple(shard_axes), n_clients=int(n_clients),
            shards_per_client=int(shards_per_client), bm=bm, lanes=lanes,
            group=group, client_grid=tuple(client_grid),
        )

    def _device_maps(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """``(pad_to_raw, pad_valid, seg_of_block, pos_row, dense_idx,
        dev_blocks, rep_devs)`` as int64/bool tensors on ``device``, copied
        there once (the last two: each segment's device → block map and,
        for each of its blocks, the first device holding it)."""
        maps = self._maps.get(device)
        if maps is None:
            to = lambda a: None if a is None else torch.from_numpy(a).to(device)
            pad_to_raw, pad_valid = _pad_maps([s.offset for s in self.segments], self._sizes,
                                              self.n_pad)
            dev_blocks = [np.asarray(s.dev_block, np.int64) for s in self.segments]
            rep_devs = [np.asarray([list(s.dev_block).index(b) for b in range(s.n_shards)],
                                   np.int64) if self.shards_per_client > 1 else None
                        for s in self.segments]
            maps = tuple(
                to(a) for a in (
                    pad_to_raw, pad_valid,
                    self.seg_of_block.astype(np.int64),
                    self._pos_row.astype(np.int64),
                    self._dense_idx.astype(np.int64),
                )
            ) + ([to(a) for a in dev_blocks], [to(a) for a in rep_devs])
            self._maps[device] = maps
        return maps

    # --------------------------------------------------------- flat plumbing

    def flatten_local(self, bodies: Sequence[torch.Tensor]) -> torch.Tensor:
        """This client's leaves (in segment order) → its local flat
        buffer(s), :attr:`local_shape`.  With one device a client a body is
        the leaf; with several it is the whole leaf too, and each device's
        buffer takes the leaf's block that device holds."""
        maps = self._device_maps(bodies[0].device)
        if self.shards_per_client == 1:
            return _flatten_padded(bodies, maps[0], maps[1],
                                   contiguous=self.n_pad == self.n_total)
        S = self.shards_per_client
        out = torch.zeros((S, self.n_pad), dtype=torch.float32, device=bodies[0].device)
        for s, body, dev_block in zip(self.segments, bodies, maps[5]):
            blocks = shard_blocks(body.to(torch.float32), s.grid).reshape(s.n_shards, -1)
            out[:, s.offset:s.offset + s.rows * s.n_loc] = blocks[dev_block]
        return out

    def unflatten_local(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Local flat buffer(s) → this client's leaves (segment order):
        views of the one device's buffer, or with several devices each
        leaf put together from its blocks (each taken from the first
        device that holds it)."""
        if self.shards_per_client == 1:
            return [
                flat[s.offset:s.offset + s.rows * s.n_loc].reshape(s.shape)
                for s in self.segments
            ]
        rep_devs = self._device_maps(flat.device)[6]
        return [
            unshard_blocks(flat[rep, s.offset:s.offset + s.rows * s.n_loc]
                           .reshape((s.n_shards,) + s.shape), s.grid)
            for s, rep in zip(self.segments, rep_devs)
        ]

    def zeros_residual(self, device) -> torch.Tensor:
        """This client's flat sharded error-feedback state: its row
        ``(1, shards_per_client, n_pad)`` of the reference's ``(n_clients,
        shards_per_client, n_pad)`` buffer."""
        return torch.zeros((1, self.shards_per_client, self.n_pad), dtype=torch.float32,
                           device=device)

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
        """Compress this client's shards of every leaf and exchange.
        Returns ``(mean_flat, own_flat, new_res_flat)``: the aggregated
        update, this client's ΔW*, and the new residual, all in the local
        flat layout.

        Per-(segment, device, row) exact two-sided top-k (paper Alg. 2,
        :func:`_two_sided_topk`, one call a segment over all its devices'
        rows); dense segments send their values, skip segments nothing
        (their update stays in the residual).  The exchange gathers every
        client's positions and μ stream over the group, then adds each
        client's ``μ / n_clients`` (as the jitted reference computes it:
        ``μ · (1/n_clients)``) at its positions, one client after the other
        in the order of the reference's gathers (the reference's scan: one
        scatter over every client at once would add colliding positions in
        no fixed order on the card).  Dense segments take the group's
        ``pmean``.  With one client the mean is ΔW*.

        ``device_pack=True`` also Golomb-packs every (segment, device,
        row)'s surviving positions on the device (:meth:`_pack_local`, one
        :func:`~repro_torch.kernels.pack.pack_bit_rows` launch), gathers
        those words in place of the positions and decodes them
        (:meth:`_decode_gathered`); it returns two more outputs, ``(words
        u32[n_pack_words], nbits int32[n_mu])`` a device (with S devices,
        ``(S, ·)``): each device's packed streams and exact per-row bit
        counts, byte-identical to the host ``encode_positions_packed``.
        The mean is the same either way.
        """
        group = self._client_group()
        acc = self.flatten_local(bodies)
        if res_flat is not None:
            acc = res_flat + acc
        S, n_pad = self.shards_per_client, self.n_pad
        maps = self._device_maps(acc.device)
        pos_row, dense_idx = maps[3], maps[4]
        acc2, flat = acc.reshape(S, n_pad), acc.reshape(-1)
        dev_base = n_pad * torch.arange(S, device=acc.device)

        pos_parts, mu_parts, idx_parts = [], [], []
        for s in self._sparse:
            x = acc2[:, s.offset:s.offset + s.rows * s.n_loc].reshape(S * s.rows, s.n_loc)
            idx, mu = _two_sided_topk(x, s.k)
            base = (dev_base[:, None] + s.offset
                    + s.n_loc * torch.arange(s.rows, device=acc.device)[None, :]).reshape(-1)
            pos_parts.append((idx + base[:, None]).reshape(-1))
            mu_parts.append(mu)
            idx_parts.append(idx)

        own = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
        if pos_parts:
            pos, mu = torch.cat(pos_parts), torch.cat(mu_parts)
            own.view(-1)[pos] = mu[pos_row]
        if self._dense_idx.size:
            dvals = flat[dense_idx]
            own.view(-1)[dense_idx] = dvals
        if device_pack:
            words, nbits = self._pack_local(idx_parts, acc.device)

        mean = own
        C = self.n_clients
        if self.client_axes and C > 1 and pos_parts:
            # THE exchange: the (positions, μ) streams of every client,
            # the positions as their packed wire words with device_pack
            gpos = (self._decode_gathered(group.all_gather_rows(words)) if device_pack
                    else group.all_gather_rows(pos))
            gmu = group.all_gather_rows(mu)
            # μ / C, which XLA computes as μ · (1/C) under jit
            inv = _reciprocal(C, acc.device)
            mean = torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
            for c in group.gather_order(self.client_grid):
                mean.view(-1).index_add_(0, gpos[c], gmu[c][pos_row] * inv)
        if self.client_axes and C > 1 and self._dense_idx.size:
            mean = own.clone() if mean is own else mean
            mean.view(-1)[dense_idx] = group.pmean(dvals, self.client_grid)
        new_res = acc - own if res_flat is not None else None
        if device_pack:
            return mean, own, new_res, words, nbits
        return mean, own, new_res

    def _client_group(self):
        """The group the exchange crosses; raises unless its world is
        ``n_clients``."""
        if self.group.world != self.n_clients:
            raise ValueError(
                f"the exchange over {self.n_clients} clients needs a ClientGroup of "
                f"{self.n_clients} ranks (repro_torch.launch.mesh); got world "
                f"{self.group.world}")
        return self.group

    def _pack_local(self, idx_parts: List[torch.Tensor], device: torch.device) -> tuple:
        """This client's survivors → (packed u32 words, per-row bit counts),
        a device's (``(S, ·)`` with S devices).

        Builds every (segment, row)'s Golomb bit stream at its static
        offset in each device's concatenated bit buffer, the devices one
        after the other, then folds the bits into ``uint32`` words with
        ONE launch over the whole set
        (:func:`~repro_torch.kernels.pack.pack_bit_rows`, in stream order:
        no pad and no transpose; every row's stream is whole words, so each
        device's words are its own).
        """
        S = self.shards_per_client
        if not idx_parts:
            shape = (0,) if S == 1 else (S, 0)
            return (torch.zeros(shape, dtype=torch.int32, device=device).view(torch.uint32),
                    torch.zeros(shape, dtype=torch.int32, device=device))
        chunks, nb_parts = [], []
        for (b, w, _), idx_s in zip(self._pack_info, idx_parts):
            bits_s, nb_s = bits_from_positions(torch.sort(idx_s, dim=1).values,
                                               bstar=b, cap32=32 * w)
            chunks.append(bits_s.reshape(S, -1))
            nb_parts.append(nb_s.reshape(S, -1))
        allbits = torch.cat(chunks, dim=1).reshape(-1)
        words, nbits = pack_bit_rows(allbits), torch.cat(nb_parts, dim=1)
        if S == 1:
            return words, nbits.reshape(-1)
        return words.reshape(S, self.n_pack_words), nbits

    def _decode_gathered(self, gw: torch.Tensor) -> torch.Tensor:
        """Gathered word buffers u32[C, (S,) n_pack_words] → positions
        int64[C, n_pos] in this rank's flat layout
        (:func:`~repro_torch.kernels.pack.golomb_decode_rows`, segment by
        segment: each has its own k, b* and row stride).  Each row's
        positions come out ascending; every position of a row takes the
        row's μ, so the mean does not depend on their order."""
        words = gw.view(torch.int32) if gw.dtype == torch.uint32 else gw
        C, S = words.shape[0], self.shards_per_client
        words = words.reshape(C, S, self.n_pack_words)
        dev_base = self.n_pad * torch.arange(S, device=words.device)
        parts = []
        for s, (b, w, off) in zip(self._sparse, self._pack_info):
            seg_w = words[:, :, off:off + s.rows * w].reshape(C, S * s.rows, w)
            ploc = golomb_decode_rows(seg_w, k=s.k, bstar=b).to(torch.int64)
            base = (dev_base[:, None] + s.offset
                    + s.n_loc * torch.arange(s.rows, device=words.device)[None, :]).reshape(-1)
            parts.append((ploc + base[None, :, None]).reshape(C, -1))
        return torch.cat(parts, 1)

    # -------------------------------------------------------- hist exchange

    def exchange_local_hist(
        self,
        bodies: Sequence[torch.Tensor],
        res_flat: Optional[torch.Tensor],
        *,
        nbins: int = 128,
        stages=NULL_STAGES,
    ) -> tuple:
        """The segment-aware passes (:mod:`repro_torch.kernels.flat`) over
        this client's local flat buffer(s) — one launch per pass, over
        every (device, segment).

        Approximate survivor counts (histogram thresholds), one μ a
        (segment, device); the exchange is the group's ``pmean`` of the
        binarized ΔW* (none with one client).  Requires an all-sparse
        policy.  Returns ``(mean_flat, own_flat, new_res_flat)``.
        ``stages`` (a :mod:`repro_torch.obs.stages` clock) times the
        flatten (the buffer and each segment's max ``|x|``), the three
        passes and the mean.

        With one device a client the buffer, the residual add and the
        maxima are one pass (:func:`~repro_torch.kernels.flat.
        seg_accumulate`); with several, each device's buffer is gathered
        from its shards' blocks, then the residual add and the maxima follow
        as tensor ops.
        """
        if any(s.kind != "sparse" for s in self.segments):
            raise ValueError(
                "exchange_local_hist needs an all-SBC policy; dense/skip "
                "leaves belong to the exact engine"
            )
        group = self._client_group()
        bounds = [(s.offset, s.rows * s.n_loc) for s in self.segments]
        with stages.stage("exchange.flatten"):
            if self.shards_per_client == 1:
                acc, absmax = seg_accumulate(bodies, res_flat, bounds, self.n_pad,
                                             bm=self.bm, lanes=self.lanes)
            else:
                acc = self.flatten_local(bodies)
                if res_flat is not None:
                    acc = res_flat + acc
                absmax = seg_absmax(acc, bounds)
        own, res, _stats = _hist_pipeline(
            acc,
            bounds=bounds,
            ks=[k_for(s.rows * s.n_loc, s.rate) for s in self.segments],
            rates=[s.rate for s in self.segments],
            seg_of_block=self._device_maps(acc.device)[2],
            n_blocks=self.n_blocks,
            bm=self.bm,
            lanes=self.lanes,
            nbins=nbins,
            stages=stages,
            absmax=absmax,
        )
        with stages.stage("exchange.mean"):
            mean = (group.pmean(own, self.client_grid)
                    if self.client_axes and self.n_clients > 1 else own)
        new_res = res if res_flat is not None else None
        return mean, own, new_res
