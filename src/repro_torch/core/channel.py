"""The communication channels of the local, GSPMD and fed backends.

Counterpart of ``repro.core.channel`` (DESIGN.md §12).  The port carries

  :class:`LocalVmapChannel`    per-client compression with the clients as
                               a leading axis; the exchange is the mean
                               over that axis (the paper's Alg. 1 round
                               on one card);
  :class:`ShardedGspmdChannel` the GSPMD backend, one client per
                               process: residual add + compression (the
                               hist engine's three SBC passes, or the
                               exact engine's two-sided top-k with its
                               optional device-packed Golomb wire) on ONE
                               flat buffer, or leaf by leaf (``fast=False``),
                               + the exchange across the clients'
                               ``ClientGroup`` (``torch.distributed``);
  :class:`FedWireChannel`      real packed SBW1 bytes both directions
                               through a parameter server (the fed
                               backend).

Each meters a round's traffic into a
:class:`~repro_torch.core.ledger.BandwidthLedger`.  Pytrees are nested
dicts of tensors whose leaves are taken in JAX's tree-flatten order
(sorted keys, :mod:`repro_torch.core.tree`), so segments, the flat
buffer and the residual follow the reference's layout.
"""
from __future__ import annotations

import dataclasses
from typing import (Any, Dict, NamedTuple, Optional, Protocol, Sequence, Tuple, Union,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch.core.api import Compressor
from repro_torch.core.flat import shard_blocks, unshard_blocks
from repro_torch.core.golomb import encode_positions, expected_position_bits
from repro_torch.core.ledger import BandwidthLedger, RoundRecord
from repro_torch.core.policy import CompressionPolicy, CompressorState, ResolvedPolicy
from repro_torch.core.stages import LeafCompressed, k_for
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.core.wire import Wire, wire_for
from repro_torch.kernels.reduce import _reciprocal
from repro_torch.kernels.topk import _two_sided_topk
from repro_torch.obs import NULL_TELEMETRY

PyTree = Any


class ChannelBits(NamedTuple):
    """Static analytic wire accounting for one round (Eq. 1 terms)."""

    per_client: float  # upstream bits one client sends per round
    dense: float  # the 32-bit dense equivalent


@runtime_checkable
class CommChannel(Protocol):
    """The compress → exchange → aggregate → account surface every
    backend's channel shares: where the exchange runs differs (the mean
    over a leading client axis, the collectives of a ``ClientGroup``, real
    bytes through a server), these four members do not."""

    ledger: BandwidthLedger

    def init_state(self, *args: Any, **kw: Any) -> Any:
        """Allocate this backend's per-client compressor state."""
        ...

    def round_exchange(self, *args: Any, **kw: Any) -> Any:
        """One communication round's compress + exchange + aggregate."""
        ...

    def bits(self, *args: Any, **kw: Any) -> ChannelBits:
        """Static Eq. 1/Eq. 5 analytic accounting for one round."""
        ...


# ------------------------------------------------------- policy resolution

# bounded: policies holding fresh closures hash by identity, so unbounded
# growth would pin every ResolvedPolicy (and its flat spaces) for the life
# of the process
_RESOLVE_CACHE: Dict[Any, ResolvedPolicy] = {}
_RESOLVE_CACHE_MAX = 64


def _layout_key(params: PyTree) -> Optional[tuple]:
    try:
        flat, treedef = tree_flatten(params)
        return (treedef, tuple((tuple(x.shape), str(x.dtype)) for x in flat))
    except (TypeError, AttributeError):
        return None


def resolve_cached(policy: CompressionPolicy, params: PyTree) -> ResolvedPolicy:
    """Resolve ``policy`` against ``params``' layout ONCE per topology, so
    every caller shares the bound :class:`ResolvedPolicy` and its flat
    spaces."""
    layout = _layout_key(params)
    try:
        key = (policy, layout) if layout is not None else None
        hash(key)
    except TypeError:
        key = None
    if key is None:
        return policy.resolve(params)
    got = _RESOLVE_CACHE.get(key)
    if got is None:
        got = policy.resolve(params)
        while len(_RESOLVE_CACHE) >= _RESOLVE_CACHE_MAX:  # FIFO eviction
            _RESOLVE_CACHE.pop(next(iter(_RESOLVE_CACHE)))
        _RESOLVE_CACHE[key] = got
    return got


def analytic_bits(resolved: ResolvedPolicy, leaves: Sequence,
                  rates: Sequence[float]) -> ChannelBits:
    """Static Eq. 1 accounting for ONE client's upload at ``rates``: per
    sparse leaf ``position_bits(n, k, p) + value_bits(k)``, dense leaves
    the quantizer's value bits for the whole leaf, skipped leaves
    nothing."""
    per_client = dense = 0.0
    for plan, leaf, p in zip(resolved.plans, leaves, rates):
        n = int(np.prod(tuple(leaf.shape)) or 1)
        dense += 32.0 * n
        codec = plan.codec
        if codec.skip:
            continue
        if codec.selector.dense:
            per_client += float(codec.quantizer.value_bits(n))
            continue
        k = k_for(n, p)
        per_client += float(codec.encoder.position_bits(n, k, p)
                            + codec.quantizer.value_bits(k))
    return ChannelBits(per_client=per_client, dense=dense)


def mean_over_clients(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=0)`` over the leading client axis, bit for bit:
    XLA's CPU reduce adds the C rows in order from +0.0 and multiplies by
    the f32 reciprocal of C; with C = 1 it returns the row itself (−0.0
    kept).  Checked against ``jnp.mean`` under ``jit`` for C = 1 to 8
    (``tests/test_torch_local_run.py``).  A bf16 or f16 ``x`` is summed
    and scaled in f32 and rounded once, as ``jnp.mean`` upcasts it
    (``tests/test_torch_legacy_api.py``)."""
    if x.shape[0] == 1:
        return x[0]
    if x.dtype in (torch.bfloat16, torch.float16):
        return mean_over_clients(x.to(torch.float32)).to(x.dtype)
    acc = torch.zeros_like(x[0])
    for row in x:
        acc = acc + row
    return acc * torch.tensor(1.0 / x.shape[0], dtype=x.dtype, device=x.device)


# ============================================================ local backend


class LocalExchange(NamedTuple):
    """One round's exchange outputs."""

    mean_delta: PyTree  # ΔW = mean_i ΔW*_i (Alg. 1 l.17)
    transmitted: PyTree  # per-client dense ΔW*_i (leading C axis)
    state: CompressorState  # advanced per-client compressor state
    bits_per_client: torch.Tensor  # analytic Eq. 1 bits, mean over clients
    compressed0: Optional[PyTree]  # client 0's LeafCompressed tree, or None


def _stack_comp(comps: Sequence[LeafCompressed]) -> LeafCompressed:
    return LeafCompressed(*(torch.stack(fs) for fs in zip(*comps)))


def _row_comp(comp: LeafCompressed, c: int) -> LeafCompressed:
    return LeafCompressed(*(f[c] for f in comp))


def client_seeds(seed: int, n_clients: int) -> torch.Tensor:
    """Per-client compressor seeds (int64[C], on the CPU) from one seed:
    the port's stand-in for ``jax.random.split(rng, C)`` (only stochastic
    codecs read them; ``sbc`` does not)."""
    ss = np.random.SeedSequence(int(seed) % 2 ** 64).spawn(n_clients)
    return torch.tensor([int(s.generate_state(1, np.uint64)[0]) >> 1 for s in ss],
                        dtype=torch.int64)


def compress_clients(resolved: ResolvedPolicy, deltas: PyTree, state: CompressorState,
                     rates: Tuple[float, ...]) -> tuple:
    """Compress C clients' updates with error feedback, the clients as rows
    (every leaf of ``deltas`` and of ``state`` has a leading C axis).

    On the flat fast path (a ``fast`` policy with a flat space) that is one
    :meth:`FlatParamSpace.compress_rows`: each SBC segment's C rows in one
    top-k and one ``f32_mean_xla`` launch.  Otherwise the per-leaf path
    runs client by client.  Both give the same bits.  Returns ``(ctrees,
    dense, new_state)`` with the leading C axis (each LeafCompressed field
    too)."""
    one = tree_map(lambda x: x[0], deltas)
    space = resolved.flat_space(one) if resolved.policy.fast else None
    if space is not None:
        return space.compress_rows(deltas, state, rates)
    outs = []
    for c in range(tree_flatten(deltas)[0][0].shape[0]):
        st = CompressorState(
            residual=(tree_map(lambda x: x[c], state.residual)
                      if resolved.any_residual else state.residual),
            rng=state.rng[c], step=state.step[c])
        outs.append(resolved.compress(tree_map(lambda x: x[c], deltas), st, rates))
    leaves = [resolved._leaves_of(o[0]) for o in outs]
    ctrees = resolved.treedef.unflatten([_stack_comp(ls) for ls in zip(*leaves)])
    dense = tree_map(lambda *xs: torch.stack(xs), *[o[1] for o in outs])
    new_state = CompressorState(
        residual=(tree_map(lambda *xs: torch.stack(xs), *[o[2].residual for o in outs])
                  if resolved.any_residual else state.residual),
        rng=state.rng, step=state.step + 1)
    return ctrees, dense, new_state


@dataclasses.dataclass(eq=False)
class LocalVmapChannel:
    """Per-client compression with the clients as a leading axis; the
    exchange is the mean over that axis (Alg. 1 l.11-17).

    Where the policy takes the flat fast path (``fast=True``), all clients
    are compressed in one :meth:`FlatParamSpace.compress_rows` call (each
    SBC segment's C rows in one top-k and one ``f32_mean_xla`` launch);
    otherwise the per-leaf path runs client by client.  Both give the
    same bits.

    ``residual_dtype`` is the dtype of each client's residual (the
    trainer casts each ΔW to it before compression): a residual that is
    not f32 takes the per-leaf path whatever the policy's flag, and is
    rounded to its dtype every round, as in the reference."""

    compressor: Compressor
    n_clients: int
    residual_dtype: Any = torch.float32

    def __post_init__(self) -> None:
        self.ledger = BandwidthLedger()
        self.telemetry = NULL_TELEMETRY  # build_run swaps in an enabled one
        self._resolved: Optional[ResolvedPolicy] = None
        self._wires: Dict[tuple, Wire] = {}

    # ------------------------------------------------------------- protocol

    def resolved(self, params: PyTree) -> ResolvedPolicy:
        if self._resolved is None:
            self._resolved = resolve_cached(self.compressor.policy, params)
        return self._resolved

    def init_state(self, params: PyTree, seed: int = 0) -> CompressorState:
        """Per-client state with a leading C axis; the residual is in the
        §10 flat layout ``(C, n_pad)`` when the fast path is taken."""
        comp = self.resolved(params).init_state(
            tree_map(lambda x: x.to(self.residual_dtype), params))
        C = self.n_clients
        residual = tree_map(lambda x: x.expand((C,) + tuple(x.shape)).clone(), comp.residual)
        return CompressorState(residual=residual, rng=client_seeds(seed, C),
                               step=torch.zeros((C,), dtype=torch.int64))

    def round_exchange(self, deltas: PyTree, state: CompressorState,
                       rates: Union[float, Tuple[float, ...]], *,
                       return_compressed: bool = False) -> LocalExchange:
        """Compress every client's update with error feedback and average."""
        resolved = self.resolved(tree_map(lambda x: x[0], deltas))
        if not isinstance(rates, tuple):  # the rules' rates, as Compressor.compress takes them
            rates = resolved.rates(float(rates))
        ctrees, dense, new_state = compress_clients(resolved, deltas, state, rates)
        bits = resolved.total_bits(ctrees)
        mean_delta = tree_map(mean_over_clients, dense)
        comp0 = None
        if return_compressed:
            comp0 = resolved.treedef.unflatten(
                [_row_comp(c, 0) for c in resolved._leaves_of(ctrees)])
        return LocalExchange(mean_delta=mean_delta, transmitted=dense, state=new_state,
                             bits_per_client=mean_over_clients(bits), compressed0=comp0)

    def bits(self, params: PyTree, rates: Tuple[float, ...],
             n_delay: int = 1) -> ChannelBits:
        """Static Eq. 1 accounting at ``rates`` (host-side floats)."""
        resolved = self.resolved(params)
        b = analytic_bits(resolved, resolved._leaves_of(params), rates)
        return ChannelBits(per_client=b.per_client, dense=b.dense * n_delay)

    # ------------------------------------------------------------ metering

    def wire(self, params: PyTree, rate: float, round_idx: int) -> Wire:
        resolved = self.resolved(params)
        key = resolved.rates(rate, round_idx)
        if key not in self._wires:
            self._wires[key] = wire_for(resolved, params, rate, round_idx)
        return self._wires[key]

    def record_round(self, round_idx: int, *, params: PyTree, compressed0: PyTree,
                     rate: float, bits_analytic_per_client: float,
                     device_pack: bool = False) -> float:
        """Meter client 0's real packed upload and extrapolate ×C into the
        ledger (every client's analytic size is the same; measured sizes
        are one geometric draw each).  Returns client 0's measured bits.
        Packing reads the positions on the host, which waits for the
        device."""
        with self.telemetry.span("encode", round=round_idx, client=0):
            blob, bits = self.wire(params, rate, round_idx).pack_with_bits(
                compressed0, device_pack=device_pack)
        measured = float(bits)
        self.ledger.record_up(
            round_idx,
            clients=tuple(range(self.n_clients)),
            up_bytes=len(blob) * self.n_clients,
            up_bits_measured=measured * self.n_clients,
            up_bits_analytic=float(bits_analytic_per_client) * self.n_clients,
        )
        return measured


# ============================================================ gspmd backend


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


def leaf_rows(gl: GspmdLeaf) -> Tuple[int, int, int]:
    """``(L, n_loc, k_loc)`` of a leaf: its rows a shard, each row's length
    and survivors (:func:`~repro_torch.core.stages.k_for`)."""
    size = int(np.prod(gl.global_shape) or 1)
    L = gl.global_shape[0] if gl.scanned and len(gl.global_shape) > 1 else 1
    n_loc = max(1, size // (L * gl.n_shards))
    return L, n_loc, k_for(n_loc, gl.rate)


def _sbc_local(acc_flat: torch.Tensor, k: int, group, out_dtype=torch.float32,
               client_grid: Tuple[int, ...] = ()) -> tuple:
    """Exact per-shard SBC (paper Alg. 2) and the sparse exchange of one
    leaf.

    ``acc_flat`` (rows, n_loc) is this client's residual-accumulated ΔW,
    the L rows of each of the leaf's shards (any float dtype; the math
    runs in f32), ``k`` the survivors a row (:func:`leaf_rows`).  Each
    row's two-sided top-k and μ
    (:func:`~repro_torch.kernels.topk._two_sided_topk`: one
    ``f32_mean_xla`` launch for both sides of every row), then the gather
    of (idx, μ) over the group's C clients and, per row, every client's
    ``μ / C`` (``μ · (1/C)``, as XLA computes it under ``jit``) added at
    its positions one client after the other, in the order of the
    reference's gathers over the client axes of sizes ``client_grid``.
    Returns ``(mean (rows, n_loc), own ΔW* (rows, n_loc))`` in
    ``out_dtype``."""
    L, n_loc = acc_flat.shape
    idx, mu = _two_sided_topk(acc_flat.to(torch.float32), k)
    own = torch.zeros((L, n_loc), dtype=out_dtype, device=acc_flat.device)
    own.scatter_(1, idx, mu.to(out_dtype)[:, None].expand(L, k))
    C = group.world
    if C == 1:
        return own, own
    gidx, gmu = group.all_gather_rows(idx), group.all_gather_rows(mu)
    share = gmu * _reciprocal(C, gmu.device)  # μ / C as the jitted reference takes it
    dense = torch.zeros((L, n_loc), dtype=torch.float32, device=acc_flat.device)
    for c in group.gather_order(client_grid):
        dense.scatter_add_(1, gidx[c], share[c][:, None].expand(L, k))
    return dense.to(out_dtype), own


def _dense_local(acc_flat: torch.Tensor, group, client_grid: Tuple[int, ...] = ()) -> tuple:
    """Dense baseline: the clients' mean of the full ΔW (the group's
    ``pmean``, an axis of ``client_grid`` at a time; ΔW itself with one
    client)."""
    return (group.pmean(acc_flat, client_grid) if group.world > 1 else acc_flat), acc_flat


@dataclasses.dataclass(eq=False)
class ShardedGspmdChannel:
    """Compression + exchange of the GSPMD backend, one client per
    process: the exchange crosses the clients of ``group`` (a
    :class:`~repro_torch.launch.mesh.ClientGroup` of ``n_clients`` ranks;
    one client is :func:`~repro_torch.launch.mesh.make_host_group`) as
    (positions, μ) all-gathers (sparse), a ``pmean`` (dense) or nothing
    (skip).

    ``flat_space`` is the §11
    :class:`~repro_torch.core.flat.ShardedFlatParamSpace` when the flat
    fast path applies: ``flat_engine`` picks its exact or hist engine, and
    ``device_pack`` (exact engine only) packs the Golomb wire streams on
    the device.  Without one (``fast=False``, or a non-f32 residual) the
    per-leaf exchange runs, with the residual stored per leaf in
    ``residual_dtype``.

    Every leaf is compressed per shard: the equal blocks of its
    ``shard_grid`` (the reference's per-device shards), each with its own
    k a row and μ.  A rank holds all of its client's shards, and one call
    covers them all; or, with ``rank_blocks`` (one rank a device), its
    device's block of each leaf, and ``group`` is then the exchange's
    sub-group, the ranks of this device coordinate in every client
    (``repro_torch.launch.mesh.DeviceRanks.exchange``).  ``client_grid``
    gives the sizes of the client axes when there are several ("pod" and
    "data"): the gathers and means follow the reference's order over them.
    """

    leaves: Tuple[GspmdLeaf, ...]
    client_axes: Tuple[str, ...]
    n_clients: int
    group: Any  # ClientGroup of n_clients ranks
    residual_dtype: Any = torch.float32
    flat_space: Any = None  # ShardedFlatParamSpace | None
    flat_engine: str = "exact"  # "exact" | "hist"
    device_pack: bool = False  # pack Golomb wire streams on the device (§11)
    client_grid: Tuple[int, ...] = ()  # sizes of the client axes (() : one)
    rank_blocks: bool = False  # a leaf here is one device's block

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
        if self.group.world != self.n_clients:
            raise ValueError(f"{self.n_clients} clients need a ClientGroup of "
                             f"{self.n_clients} ranks; got world {self.group.world}")
        self.ledger = BandwidthLedger()
        self.telemetry = NULL_TELEMETRY  # build_run swaps in an enabled one

    # ------------------------------------------------------------- protocol

    def init_state(self, params: PyTree):
        """This client's error-feedback residual: ONE flat f32 buffer of
        shape ``(1, shards_per_client, n_pad)`` on the fast path (§11), else
        the params' tree of ``(1,) + shape`` zeros in ``residual_dtype``
        (this client's row of the reference's stacked residual)."""
        device = tree_flatten(params)[0][0].device
        if self.flat_space is not None:
            return self.flat_space.zeros_residual(device)
        return tree_map(lambda x: torch.zeros((1,) + tuple(x.shape), dtype=self.residual_dtype,
                                              device=device), params)

    def round_exchange(self, residual, deltas: PyTree, *, need_own: bool) -> tuple:
        """One round's compress + exchange.

        ``deltas`` is this client's ΔW tree (a leading client axis of 1)
        and ``residual`` this channel's state from :meth:`init_state`;
        returns ``(mean_tree, new_residual, own_tree_or_None)``, and with
        ``device_pack`` a fourth item ``(words, nbits)``: this round's
        packed Golomb word buffers u32[1, shards, n_pack_words] and exact
        per-row bit counts int32[1, shards, n_mu] of this client's devices.
        ``need_own`` materializes the client's ΔW* (momentum masking,
        metering).
        """
        leaves, treedef = tree_flatten(deltas)
        if self.flat_space is None:
            # residual add (Alg. 1 l.10): acc = R + ΔW, stored in residual_dtype
            acc = [(r.to(torch.float32) + d.to(torch.float32)).to(self.residual_dtype)
                   for r, d in zip(tree_flatten(residual)[0], leaves)]
            means, residuals, owns = self.exchange_per_leaf(acc, need_own)
            new_residual = treedef.unflatten(residuals)
        else:
            out = self.exchange_flat(residual, leaves, need_own)
            means, new_residual, owns = out[:3]
        mean_tree = treedef.unflatten(means)
        own_tree = treedef.unflatten(owns) if need_own else None
        if self.device_pack:
            return mean_tree, new_residual, own_tree, out[3]
        return mean_tree, new_residual, own_tree

    def exchange_per_leaf(self, leaves: Sequence[torch.Tensor], need_own: bool) -> tuple:
        """Per-leaf exchange: compress each of this client's shards of each
        leaf with the leaf's mode (the sparse shards of a leaf in one
        call), exchange, and emit (mean ΔW, NEW residual = acc − own,
        own); every output in the leaf's dtype, with the leading client
        axis of 1."""
        means, residuals, owns = [], [], []
        for leaf, gl in zip(leaves, self.leaves):
            body = leaf[0]
            if gl.mode == "sparse":
                L, n_loc, k = leaf_rows(gl)
                grid = () if self.rank_blocks else gl.shard_grid
                blocks = shard_blocks(body, grid)
                dense, own = _sbc_local(blocks.reshape(-1, n_loc), k, self.group,
                                        out_dtype=leaf.dtype, client_grid=self.client_grid)
                dense, own = (unshard_blocks(t.reshape(blocks.shape), grid)
                              for t in (dense, own))
            elif gl.mode == "dense":
                dense, own = _dense_local(body.to(torch.float32), self.group, self.client_grid)
            else:  # skip: no traffic; the residual keeps the full update
                dense = own = torch.zeros_like(body)
            new_res = (body.to(torch.float32) - own.to(torch.float32)).to(self.residual_dtype)
            means.append(dense.reshape(body.shape).to(leaf.dtype)[None])
            residuals.append(new_res.reshape(body.shape).to(leaf.dtype)[None])
            owns.append(own.reshape(body.shape).to(leaf.dtype)[None] if need_own
                        else torch.zeros((1,) * leaf.dim(), dtype=leaf.dtype,
                                         device=leaf.device))
        return tuple(means), tuple(residuals), tuple(owns)

    def exchange_flat(self, res: torch.Tensor, leaves: Sequence[torch.Tensor],
                      need_own: bool) -> tuple:
        """Residual add + compression + exchange on ONE flat buffer a
        device of the client, one launch per pass over all of them.
        ``leaves`` carry the leading client axis of 1.  The hist engine
        opens the ``exchange.*`` stages of :attr:`telemetry`'s clock."""
        space = self.flat_space
        stages = self.telemetry.stages
        bodies = [leaf[0] for leaf in leaves]
        S = space.shards_per_client
        res_local = res[0].reshape(space.local_shape)
        packed = None
        if self.device_pack:
            mean_f, own_f, new_res_f, words, nbits = space.exchange_local(
                bodies, res_local, device_pack=True
            )
            packed = (words.reshape(1, S, -1), nbits.reshape(1, S, -1))
        elif self.flat_engine == "exact":
            mean_f, own_f, new_res_f = space.exchange_local(bodies, res_local)
        else:
            mean_f, own_f, new_res_f = space.exchange_local_hist(bodies, res_local,
                                                                 stages=stages)
        with stages.stage("exchange.unflatten"):
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
            new_res = new_res_f.reshape(1, S, space.n_pad)
        if self.device_pack:
            return means, new_res, owns, packed
        return means, new_res, owns

    # ------------------------------------------------------- bit accounting

    def bits(self) -> ChannelBits:
        """Static Eq. 1 bits per round per client: per sparse leaf
        ``L·S_shards·(k_loc·b̄_pos(p_leaf) + 32)``, dense 32 bits/entry,
        skip 0, beside the 32-bit dense equivalent.  The §11 flat space's
        per-(segment, shard) table gives the same totals, term by term in
        the same order."""
        per_client = dense = 0.0
        for gl in self.leaves:
            size = int(np.prod(gl.global_shape) or 1)
            if gl.mode == "sparse":
                L, _, k_loc = leaf_rows(gl)
                per_client += L * gl.n_shards * (k_loc * expected_position_bits(gl.rate) + 32.0)
            elif gl.mode == "dense":
                per_client += 32.0 * size
            dense += 32.0 * size
        return ChannelBits(per_client=per_client, dense=dense)

    # ------------------------------------------------------------ metering

    def measured_bits(self, own_tree: PyTree) -> float:
        """Real wire bits of ONE client's transmitted update: per (leaf,
        shard, row), Golomb-encode the ACTUAL surviving positions (paper
        Alg. 3's bitstream, one geometric draw vs Eq. 5) plus one 32-bit μ;
        dense leaves pay 32 bits/entry, skip leaves nothing.  Host-side
        numpy over the client's dense ΔW*."""
        total = 0.0
        for gl, leaf in zip(self.leaves, tree_flatten(own_tree)[0]):
            x = leaf.detach().to(torch.float32).cpu()  # numpy has no bf16
            if gl.mode == "dense":
                total += 32.0 * x.numel()
                continue
            if gl.mode == "skip":
                continue
            for block in shard_blocks(x, gl.shard_grid).numpy():
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
        own_client0: PyTree = None,
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
            with self.telemetry.span("encode", round=round_idx):
                per_client = self.measured_bits_per_client(packed_nbits)
            for ci, b in enumerate(per_client):
                self.telemetry.metrics.gauge("wire/client_bits_measured", b,
                                             round=round_idx, client=ci)
            total = float(sum(per_client))
            self.ledger.record_up(
                round_idx,
                clients=tuple(range(self.n_clients)),
                up_bytes=sum(int(-(-b // 8)) for b in per_client),
                up_bits_measured=total,
                up_bits_analytic=analytic * self.n_clients,
            )
            return total / self.n_clients
        with self.telemetry.span("encode", round=round_idx, client=0):
            measured = self.measured_bits(own_client0)
        self.telemetry.metrics.gauge("wire/own_client0_bits_measured", measured,
                                     round=round_idx, client=0)
        self.ledger.record_up(
            round_idx,
            clients=tuple(range(self.n_clients)),
            up_bytes=int(-(-measured // 8)) * self.n_clients,
            up_bits_measured=measured * self.n_clients,
            up_bits_analytic=analytic * self.n_clients,
        )
        return measured


# ============================================================== fed backend


@dataclasses.dataclass(eq=False)
class FedWireChannel:
    """Wire-level channel: real packed SBW1 buffers cross in BOTH
    directions through a :class:`~repro_torch.fed.server.ParameterServer`,
    with a cohort of :class:`~repro_torch.fed.clients.ClientPool` members on
    the other end (DESIGN.md §9).

    The server and the pool share ONE cached :class:`ResolvedPolicy` per
    (policy, topology) through :func:`resolve_cached`.  When the server
    carries a :class:`~repro_torch.serve.deltalog.DeltaLog`
    (``delta_horizon``), each cohort member pulls the cheapest catch-up
    from its last-synced round instead of a fresh per-member broadcast.
    """

    server: Any  # repro_torch.fed.server.ParameterServer
    pool: Any  # repro_torch.fed.clients.ClientPool

    def __post_init__(self) -> None:
        self.ledger = BandwidthLedger()
        self.telemetry = NULL_TELEMETRY  # build_run swaps in an enabled one
        # DeltaLog-backed downstream (server.delta_horizon set): per-client
        # last-synced round + one CatchupPlanner over the server's log
        self._last_sync: Dict[int, int] = {}
        self._planner: Any = None
        # a mid-round kill (ServerKilled at post_aggregate) parks the
        # aggregated-but-unbroadcast round here; checkpointable, finished
        # by _finish_round on resume
        self._pending: Optional[dict] = None

    # ------------------------------------------------------------- protocol

    def init_state(self, params: Optional[PyTree] = None, rng: Optional[int] = None) -> None:
        """Allocate the pool's per-client state from the server replica."""
        self.pool.init(params if params is not None else self.server.estimate, rng)

    def round_exchange(
        self,
        round_idx: int,
        cohort: Sequence[int],
        start_params: PyTree,
        staleness: Optional[np.ndarray] = None,
        faults: Any = None,
        straggler_timeout: Optional[float] = None,
        kill_step: Optional[str] = None,
    ) -> dict:
        """One federated round: run the cohort, pack real uploads, decode and
        aggregate on the server, compress the broadcast, meter both
        directions into the ledger.

        Elasticity (DESIGN.md §14): ``faults`` is a
        :class:`~repro_torch.fed.faults.FaultSchedule` whose slow and
        corrupt entries apply to this round; ``straggler_timeout`` aborts
        uploads whose simulated duration ``profile.delay × slowdown``
        exceeds it.  A failed participation (straggler abort or rejected
        corrupt upload) rolls the member's pool state back to its
        pre-round snapshot and meters the spent bytes as
        ``up_bytes_wasted``; the ``up_*`` columns cover ACCEPTED uploads
        only.  ``kill_step="post_aggregate"`` raises
        :class:`~repro_torch.fed.faults.ServerKilled` after aggregation with
        the unfinished round parked in ``self._pending`` (resumed through
        :meth:`_finish_round`)."""
        from repro_torch.fed.faults import NO_FAULTS, ServerKilled, straggler_ids
        from repro_torch.fed.server import ClientUpdate

        fsched = faults if faults is not None else NO_FAULTS
        if staleness is None:
            staleness = np.zeros((len(cohort),), np.int64)

        log = getattr(self.server, "delta_log", None)
        catchup = None
        if log is not None:
            # the broadcast rides the DeltaLog: each cohort member PULLS
            # the cheapest catch-up (replay / stacked / full) from its
            # last-synced round up to the current head before training —
            # one plan/encode per distinct lag class, bytes shared within
            # the class — instead of paying a fresh per-member broadcast
            from repro_torch.serve.broadcast import CatchupPlanner

            if self._planner is None or self._planner.log is not log:
                self._planner = CatchupPlanner(log, telemetry=self.telemetry)
            plans: Dict[int, Any] = {}
            down_bytes = 0
            down_m = down_a = 0.0
            for cid in cohort:
                frm = self._last_sync.get(int(cid), -1)
                plan = plans.get(frm)
                if plan is None:
                    plan = plans[frm] = self._planner.plan(frm)
                down_bytes += plan.nbytes
                down_m += plan.bits_measured
                down_a += plan.bits_analytic
                self._last_sync[int(cid)] = log.head
            catchup = (down_bytes, down_m, down_a)

        # at-risk members (stragglers to abort, uploads to corrupt) get a
        # pre-round snapshot: a failed participation must leave residual,
        # momentum and seed bit for bit as they were
        delays = {int(c): self.pool.profile_of(int(c)).delay for c in cohort}
        stragglers = straggler_ids(fsched, round_idx, cohort, delays, straggler_timeout)
        corrupts = fsched.corrupts_at(round_idx) & {int(c) for c in cohort}
        at_risk = sorted(stragglers | corrupts)
        snap = self.pool.snapshot_clients(at_risk) if at_risk else None

        tel = self.telemetry
        tel.metrics.gauge("fed/cohort_size", len(cohort), round=round_idx)
        # run_cohort ends on the host copy of its outputs, so the span
        # covers the device work without a fence
        with tel.span("select_quantize", round=round_idx, cohort=len(cohort)):
            result = self.pool.run_cohort(round_idx, cohort, start_params)

        uploads, blob_len, wasted = [], {}, 0
        with tel.span("encode", round=round_idx, cohort=len(cohort)):
            for i, cid in enumerate(result.client_ids):
                wire = self.server.up_wire(result.rates[i], round_idx)
                blob = wire.pack(result.ctrees[i])
                if int(cid) in stragglers:
                    # timed out mid-upload: the work and bytes are spent,
                    # but the server never sees them
                    wasted += len(blob)
                    continue
                if int(cid) in corrupts:
                    blob = fsched.corrupt_blob(blob, round_idx, int(cid))
                blob_len[int(cid)] = len(blob)
                uploads.append(ClientUpdate(
                    client_id=cid, blob=blob, rate=result.rates[i],
                    weight=result.weights[i], staleness=int(staleness[i])))
        info = self.server.receive(uploads, round_idx)
        accepted = [int(c) for c in info["accepted"]]
        rejected = [int(c) for c in info["rejected"]]
        up_bytes = sum(blob_len[c] for c in accepted)
        wasted += sum(blob_len[c] for c in rejected)
        failed = sorted(stragglers | set(rejected))
        if snap is not None and failed:
            self.pool.restore_clients(snap, only=failed)
        acc_set = set(accepted)
        acc_pos = [i for i, c in enumerate(result.client_ids) if int(c) in acc_set]
        pending = {
            "round_idx": int(round_idx),
            "cohort": [int(c) for c in cohort],
            "accepted": accepted,
            "rejected": rejected,
            "stragglers": sorted(stragglers),
            "up_bytes": int(up_bytes),
            "up_bytes_wasted": int(wasted),
            "up_bits_measured": float(info["up_bits_measured"]),
            "up_bits_analytic": float(
                np.sum(np.asarray(result.bits_analytic)[acc_pos])) if acc_pos else 0.0,
            "loss": float(np.mean(np.asarray(result.losses)[acc_pos])) if acc_pos
            else float("nan"),
            "update_norm": float(info["update_norm"]),
            "weights": [float(w) for w in info["weights"]],
            "staleness": [int(s) for s in staleness],
            "catchup": catchup,
        }
        if kill_step == "post_aggregate":
            self._pending = pending
            raise ServerKilled(round_idx, "post_aggregate")
        return self._finish_round(pending)

    def _finish_round(self, pending: dict) -> dict:
        """Broadcast + ledger entry for an aggregated round — the second
        half of :meth:`round_exchange`, callable on its own to resume a
        round interrupted by a ``post_aggregate`` server kill."""
        self._pending = None
        round_idx = pending["round_idx"]
        bc = self.server.broadcast(round_idx)
        recipients = len(pending["cohort"])
        if pending["catchup"] is None:
            down_bytes = len(bc.blob) * recipients
            down_m = bc.bits_measured * recipients
            down_a = bc.bits_analytic * recipients
        else:
            down_bytes, down_m, down_a = pending["catchup"]
        self.ledger.record(RoundRecord(
            round=round_idx,
            cohort=tuple(pending["accepted"]),
            up_bytes=pending["up_bytes"],
            up_bits_measured=pending["up_bits_measured"],
            up_bits_analytic=pending["up_bits_analytic"],
            down_bytes=down_bytes,
            down_bits_measured=down_m,
            down_bits_analytic=down_a,
            down_recipients=recipients,
            up_bytes_wasted=pending["up_bytes_wasted"],
        ))
        return {
            "round": round_idx,
            "loss": pending["loss"],
            "update_norm": pending["update_norm"],
            "staleness": pending["staleness"],
            "weights": pending["weights"],
            "up_bytes": pending["up_bytes"],
            "down_bytes": down_bytes,
            "accepted": pending["accepted"],
            "rejected": pending["rejected"],
            "stragglers": pending["stragglers"],
            "up_bytes_wasted": pending["up_bytes_wasted"],
        }

    def bits(self, rate: Optional[float] = None, round_idx: int = 0) -> ChannelBits:
        """Analytic Eq. 1 upstream bits for ONE client at ``rate`` (default:
        the pool's first profile) against the dense 32-bit equivalent."""
        resolved = self.server._up_resolved
        if rate is None:
            rate = self.pool.profiles[0].sparsity
        return analytic_bits(resolved, resolved._leaves_of(self.server.params),
                             resolved.rates(rate, round_idx))
