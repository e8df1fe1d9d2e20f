"""The GSPMD backend's communication channel, on one card.

Counterpart of ``repro.core.channel`` (DESIGN.md §12).  The port carries
:class:`ShardedGspmdChannel` on its flat routes: every round, residual add
+ compression (the hist engine's three SBC passes, or the exact engine's
two-sided top-k with its optional device-packed Golomb wire) + the
exchange run on ONE flat buffer per device, and the round's uploads are
metered into a :class:`~repro_torch.core.ledger.BandwidthLedger`.  With
one client the exchange is the identity; clients across cards come with
``torch.distributed`` (ROADMAP A9).

Pytrees are dicts of tensors whose leaves are taken in sorted-key order —
JAX's tree-flatten order — so segments, the flat buffer and the residual
follow the reference's layout.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.golomb import encode_positions
from repro_torch.core.ledger import BandwidthLedger


class ChannelBits(NamedTuple):
    """Static analytic wire accounting for one round (Eq. 1 terms)."""

    per_client: float  # upstream bits one client sends per round
    dense: float  # the 32-bit dense equivalent


class GspmdLeaf(NamedTuple):
    """One leaf's static plan in the GSPMD channel."""

    path: str
    global_shape: Tuple[int, ...]
    dtype: Any
    scanned: bool  # leading scan/stack superblock dim
    mode: str  # "sparse" | "dense" | "skip"
    rate: float  # static per-leaf sparsity rate
    n_shards: int  # distinct shards of the global leaf
    shard_grid: Tuple[int, ...]  # per-dim shard counts


def tree_keys(tree: Dict[str, Any]) -> Tuple[str, ...]:
    """Leaf order of a flat dict pytree: sorted keys, as JAX flattens."""
    return tuple(sorted(tree))


def _iter_shard_blocks(arr: np.ndarray, grid: Tuple[int, ...]):
    """Yield the GSPMD equal-block shards of a global array, in grid order."""
    grid = tuple(grid) + (1,) * (arr.ndim - len(grid))
    sizes = [d // g for d, g in zip(arr.shape, grid)]
    for idx in itertools.product(*[range(g) for g in grid]):
        yield arr[tuple(slice(i * s, (i + 1) * s) for i, s in zip(idx, sizes))]


@dataclasses.dataclass(eq=False)
class ShardedGspmdChannel:
    """Compression + exchange of the GSPMD backend on the §11 flat path
    with an f32 residual.

    ``flat_space`` is the :class:`~repro_torch.core.flat.ShardedFlatParamSpace`
    the channel compresses in; ``flat_engine`` picks its exact or hist
    engine, and ``device_pack`` (exact engine only) packs the Golomb wire
    streams on the device.  The per-leaf exchange (``flat_space=None``)
    is not ported yet.
    """

    leaves: Tuple[GspmdLeaf, ...]
    client_axes: Tuple[str, ...]
    n_clients: int
    flat_space: Any = None  # ShardedFlatParamSpace
    flat_engine: str = "exact"  # "exact" | "hist"
    device_pack: bool = False  # pack Golomb wire streams on the device (§11)

    def __post_init__(self) -> None:
        if self.flat_engine not in ("exact", "hist"):
            raise ValueError(f"unknown flat_engine {self.flat_engine!r}")
        if self.flat_engine == "hist" and self.flat_space is None:
            raise ValueError(
                "flat_engine='hist' needs the sharded flat fast path "
                "(fast=True with all-f32 leaves and an f32 residual_dtype)"
            )
        if self.device_pack and (
            self.flat_space is None or self.flat_engine != "exact"
        ):
            raise ValueError(
                "device_pack needs the sharded flat fast path with the "
                "exact engine (fast=True, flat_engine='exact', all-f32 "
                "leaves) — the hist engine and the per-leaf exchange have "
                "no packed position stream to produce on-device"
            )
        if self.flat_space is None:
            raise NotImplementedError(
                "the per-leaf exchange (no flat space) is not ported yet "
                "(ROADMAP A9)"
            )
        self.ledger = BandwidthLedger()

    # ------------------------------------------------------------- protocol

    def init_state(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The per-client error-feedback residual: ONE flat f32 buffer of
        shape ``(n_clients, shards_per_client, n_pad)``."""
        device = next(iter(params.values())).device
        return self.flat_space.zeros_residual(device)

    def round_exchange(self, residual: torch.Tensor,
                       deltas: Dict[str, torch.Tensor], *,
                       need_own: bool) -> tuple:
        """One round's compress + exchange.

        ``deltas`` is the per-client ΔW dict (leading client axis) and
        ``residual`` this channel's state from :meth:`init_state`; returns
        ``(mean_tree, new_residual, own_tree_or_None)``, and with
        ``device_pack`` a fourth item ``(words, nbits)``: this round's
        packed Golomb word buffers u32[n_clients, shards, n_pack_words] and
        exact per-row bit counts int32[n_clients, shards, n_mu].
        ``need_own`` materializes each client's ΔW*_i (momentum masking,
        metering).
        """
        keys = tree_keys(deltas)
        out = self.exchange_flat(residual, [deltas[k] for k in keys], need_own)
        means, new_residual, owns = out[:3]
        mean_tree = dict(zip(keys, means))
        own_tree = dict(zip(keys, owns)) if need_own else None
        if self.device_pack:
            return mean_tree, new_residual, own_tree, out[3]
        return mean_tree, new_residual, own_tree

    def exchange_flat(self, res: torch.Tensor, leaves: Sequence[torch.Tensor],
                      need_own: bool) -> tuple:
        """Residual add + compression + exchange on ONE flat buffer, one
        launch per pass.  ``leaves`` carry the leading client axis."""
        space = self.flat_space
        bodies = [leaf[0] for leaf in leaves]
        packed = None
        if self.device_pack:
            mean_f, own_f, new_res_f, words, nbits = space.exchange_local(
                bodies, res[0, 0], device_pack=True
            )
            packed = (words[None, None], nbits[None, None])
        else:
            fn = (space.exchange_local if self.flat_engine == "exact"
                  else space.exchange_local_hist)
            mean_f, own_f, new_res_f = fn(bodies, res[0, 0])
        means = tuple(
            m.to(leaf.dtype)[None]
            for m, leaf in zip(space.unflatten_local(mean_f), leaves)
        )
        if need_own:
            owns = tuple(
                o.to(leaf.dtype)[None]
                for o, leaf in zip(space.unflatten_local(own_f), leaves)
            )
        else:
            owns = tuple(
                torch.zeros((1,) * leaf.dim(), dtype=leaf.dtype, device=leaf.device)
                for leaf in leaves
            )
        if self.device_pack:
            return means, new_res_f[None, None], owns, packed
        return means, new_res_f[None, None], owns

    # ------------------------------------------------------- bit accounting

    def bits(self) -> ChannelBits:
        """Static Eq. 1 bits per round per client, summed from the §11
        per-(segment, shard) table (per sparse leaf
        ``L·S_shards·(k_loc·b̄_pos(p_leaf) + 32)``), beside the 32-bit dense
        equivalent."""
        dense = sum(32.0 * int(np.prod(gl.global_shape) or 1) for gl in self.leaves)
        return ChannelBits(per_client=self.flat_space.bits_per_client(), dense=dense)

    # ------------------------------------------------------------ metering

    def measured_bits(self, own_tree: Dict[str, torch.Tensor]) -> float:
        """Real wire bits of ONE client's transmitted update: per (leaf,
        shard, row), Golomb-encode the ACTUAL surviving positions (paper
        Alg. 3's bitstream, one geometric draw vs Eq. 5) plus one 32-bit μ;
        dense leaves pay 32 bits/entry, skip leaves nothing.  Host-side
        numpy over the client's dense ΔW*."""
        total = 0.0
        for gl, key in zip(self.leaves, tree_keys(own_tree)):
            arr = own_tree[key].detach().cpu().numpy()
            if gl.mode == "dense":
                total += 32.0 * arr.size
                continue
            if gl.mode == "skip":
                continue
            for block in _iter_shard_blocks(arr, gl.shard_grid):
                L = block.shape[0] if gl.scanned and block.ndim > 1 else 1
                for row in block.reshape(L, -1):
                    pos = np.flatnonzero(row)
                    total += float(encode_positions(pos, gl.rate).size) + 32.0
        return total

    def measured_bits_per_client(self, packed_nbits: torch.Tensor) -> list:
        """Real wire bits of EVERY client's upload, from the device-packed
        streams' exact bit counts.

        ``packed_nbits`` is the second item of ``round_exchange``'s packed
        output: int32[n_clients, shards_per_client, n_mu] per-(client,
        shard, row) Golomb position bits.  Each client pays its own
        position streams + one 32-bit μ per (shard, row) + 32 bits/entry
        for dense leaves — no host re-encode.  Reading the counts waits
        for the device.
        """
        nb = packed_nbits.detach().cpu().numpy()
        dense = sum(
            32.0 * int(np.prod(gl.global_shape) or 1)
            for gl in self.leaves if gl.mode == "dense"
        )
        # The S axis is DEVICES per client, not distinct shards: a segment
        # replicated over a shard axis (n_shards < S) is packed identically
        # on every replica, so weight each μ-row by n_shards/S to count
        # every distinct stream exactly once.
        S = nb.shape[1]
        sparse = self.flat_space._sparse
        row_w = (
            np.concatenate([np.full((s.rows,), s.n_shards / S) for s in sparse])
            if sparse else np.zeros((0,))
        )
        pos_bits = (nb.astype(np.float64) * row_w[None, None, :]).sum(axis=(1, 2))
        mu_bits = 32.0 * float(row_w.sum()) * S  # one μ per distinct (shard, row)
        return [float(pos_bits[c]) + mu_bits + dense for c in range(nb.shape[0])]

    def record_round(
        self,
        round_idx: int,
        *,
        own_client0: Dict[str, torch.Tensor] = None,
        packed_nbits: torch.Tensor = None,
    ) -> float:
        """Meter the round's uploads into the ledger; returns bits/client.

        With ``packed_nbits`` (device_pack active): EVERY client's real
        packed stream is metered from the device-side bit counts — the
        ledger row is a true cohort sum and the return value the cohort
        mean.  Without it, CLIENT 0's upload is host-encoded and
        extrapolated ×C (one geometric draw, explicitly a sample).
        """
        analytic = self.bits().per_client
        if packed_nbits is not None:
            per_client = self.measured_bits_per_client(packed_nbits)
            total = float(sum(per_client))
            self.ledger.record_up(
                round_idx,
                clients=tuple(range(self.n_clients)),
                up_bytes=sum(int(-(-b // 8)) for b in per_client),
                up_bits_measured=total,
                up_bits_analytic=analytic * self.n_clients,
            )
            return total / self.n_clients
        measured = self.measured_bits(own_client0)
        self.ledger.record_up(
            round_idx,
            clients=tuple(range(self.n_clients)),
            up_bytes=int(-(-measured // 8)) * self.n_clients,
            up_bits_measured=measured * self.n_clients,
            up_bits_analytic=analytic * self.n_clients,
        )
        return measured
