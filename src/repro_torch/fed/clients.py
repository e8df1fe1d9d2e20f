"""Client cohorts: partial participation over a heterogeneous client pool
(DESIGN.md §9).

Counterpart of ``repro.fed.clients``.  A :class:`ClientPool` holds the
per-client state of M federated clients — local optimizer state and
compressor state (error-feedback residual, seed, round counter) — stacked
along a leading client axis, the layout of the local backend's
:class:`~repro_torch.train.trainer.DSGDTrainer`.  Each round the scheduler
samples a *cohort* and the pool runs every sampled client's local training
and compression.  The reference does that as one jitted ``vmap``/``scan``
call; here the members' local steps loop on the host
(:func:`~repro_torch.train.trainer.local_steps`, one forward and backward
a step), and a tile's members are compressed as rows through
:func:`~repro_torch.core.channel.compress_clients`, the code path of the
local backend's channel: with ``fast``, one
:meth:`~repro_torch.core.flat.FlatParamSpace.compress_rows` a tile (one
top-k and one ``f32_mean_xla`` a segment for all members), else the
per-leaf path member by member.

Heterogeneity is expressed with :class:`ClientProfile`\\ s: client ``c`` is
bound to ``profiles[c % len(profiles)]``, which pins its communication
delay (temporal sparsity) and upstream gradient sparsity — the two axes of
the paper's §III trade-off.  Members are grouped by profile and each group
runs in tiles of at most ``cohort_tile`` members.

Cohort sampling is deterministic: round ``r`` of a pool seeded ``s`` draws
its cohort (and nothing else) from ``np.random.default_rng([s, r])``, as
the reference does, so the two packages draw the same ids.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import tempfile
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channel import client_seeds, compress_clients, resolve_cached
from repro_torch.core.policy import CompressionPolicy, CompressorState, ResolvedPolicy
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.data.synthetic import Task
from repro_torch.device import full_f32_math, resolve_device
from repro_torch.models.model import Model
from repro_torch.optim.optimizers import AdamState, Optimizer, map_states
from repro_torch.train.trainer import _deterministic_convolutions, local_steps

PyTree = Any


class ClientProfile(NamedTuple):
    """Static per-client hyper-parameters.

    delay:    local optimizer steps per round (communication delay n).
    sparsity: upstream gradient sparsity rate p for this client's uploads.
    weight:   relative dataset size, for sample-weighted aggregation.
    """

    delay: int = 1
    sparsity: float = 0.01
    weight: float = 1.0


class CohortResult(NamedTuple):
    """One sampled cohort's outputs, per member (aligned lists/arrays)."""

    client_ids: Tuple[int, ...]
    ctrees: List[PyTree]  # compressed update trees (LeafCompressed leaves, CPU)
    losses: np.ndarray  # (K,) mean loss over each member's delay window
    bits_analytic: np.ndarray  # (K,) Eq. 1 upstream bits per member
    rates: Tuple[float, ...]  # per-member upstream sparsity rate
    weights: Tuple[float, ...]  # per-member aggregation sample weight


def stack_clients(tree: PyTree, k: int) -> PyTree:
    """Broadcast a single tree to a leading k-member axis (copies)."""
    return tree_map(lambda x: x.expand((k,) + tuple(x.shape)).clone(), tree)


CLIENT_STORES = ("device", "host", "memmap")


def _opt_map(fn: Callable, *states) -> Any:
    """``fn`` leaf by leaf over matching trees: optimizer states (Adam's
    ``(m, v)``, a momentum tree, SGD's ``()``) or residuals (a tree, or
    the flat ``(N, n_pad)`` buffer)."""
    return map_states(lambda xs: fn(*xs), list(states))


def _host(tree: PyTree) -> PyTree:
    """Host numpy copies of a tree's tensors (NamedTuples kept)."""
    return _opt_map(lambda x: x.detach().cpu().numpy().copy(), tree)


def _tensor(x: np.ndarray) -> torch.Tensor:
    """A CPU tensor of a numpy array (copied only when it is not already a
    writable C-ordered array)."""
    return torch.from_numpy(np.require(x, requirements=("C", "W")))


def _to_device(tree: PyTree, device) -> PyTree:
    return _opt_map(lambda x: _tensor(x).to(device), tree)


def host_copy(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """CPU copies of ``tensors`` through ONE device-to-host transfer: their
    bytes are packed into one buffer on the device, copied once, and cut
    into views of their dtypes and shapes again."""
    if not tensors or tensors[0].device.type == "cpu":
        return [t.detach().clone() for t in tensors]
    flat = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        flat.append(b)
        if b.numel() % 8:  # keep every piece 8-byte aligned for its view
            flat.append(b.new_zeros(8 - b.numel() % 8))
    host = torch.cat(flat).cpu()
    out, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        out.append(host[off:off + nb].view(t.dtype).reshape(t.shape))
        off += -(-nb // 8) * 8
    return out


class SpilledClientStore:
    """Per-client pool state spilled OFF the card (DESIGN.md §14).

    A ``device`` pool holds every client's optimizer and compressor state
    as stacked device tensors, O(n_clients · model) device memory.  This
    store keeps the same leading-N layout in host numpy (``kind="host"``)
    or in lazily allocated on-disk ``.npy`` memmaps (``kind="memmap"``):
    the zero state of clients never sampled costs no resident pages, and a
    cohort tile's rows are copied to the card on gather and back on
    scatter.  Zero-initialized leaves (momentum, residual, step) are never
    written at init.
    """

    def __init__(
        self,
        opt_row: PyTree,
        comp_row: CompressorState,
        rng_rows: torch.Tensor,
        *,
        n_clients: int,
        kind: str = "host",
        directory: Optional[str] = None,
    ) -> None:
        if kind not in ("host", "memmap"):
            raise ValueError(f"spilled store kind must be host|memmap, got {kind!r}")
        self.kind = kind
        self.n_clients = int(n_clients)
        if kind == "memmap":
            directory = directory or tempfile.mkdtemp(prefix="repro-clients-")
            os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self._n_files = itertools.count()
        self._opt = _opt_map(self._alloc, opt_row)
        self._residual = tree_map(self._alloc, comp_row.residual)
        rng_np = rng_rows.cpu().numpy()
        self._rng = self._alloc_raw(rng_np.shape, rng_np.dtype)
        self._rng[:] = rng_np  # the one leaf that is never zero
        self._step = self._alloc_raw((self.n_clients,), np.int64)

    def _alloc_raw(self, shape, dtype) -> np.ndarray:
        if self.kind == "host":
            return np.zeros(shape, dtype)
        path = os.path.join(self.directory, f"leaf{next(self._n_files)}.npy")
        return np.lib.format.open_memmap(path, mode="w+", dtype=dtype, shape=shape)

    def _alloc(self, row: torch.Tensor) -> np.ndarray:
        row = row.detach().cpu().numpy()
        arr = self._alloc_raw((self.n_clients,) + row.shape, row.dtype)
        if np.any(row):  # nonzero template → must materialize every row
            arr[:] = row
        return arr

    def _leaves(self) -> list:
        opt = tree_flatten(tuple(self._opt) if isinstance(self._opt, AdamState)
                           else self._opt)[0]
        return opt + tree_flatten(self._residual)[0] + [self._rng, self._step]

    @property
    def nbytes(self) -> int:
        """Logical size of the pooled state (memmaps are sparse: resident
        bytes stay far below this until rows are written)."""
        return int(sum(x.nbytes for x in self._leaves()))

    # ------------------------------------------------------ gather/scatter

    def gather(self, ids: np.ndarray, device) -> Tuple[PyTree, CompressorState]:
        """One tile's rows, host → ``device`` (seeds and counters stay on
        the CPU, as in every compressor state of the port)."""
        opt_g = _opt_map(lambda x: _tensor(x[ids]).to(device), self._opt)
        comp_g = CompressorState(
            residual=tree_map(lambda x: _tensor(x[ids]).to(device), self._residual),
            rng=_tensor(self._rng[ids]),
            step=_tensor(self._step[ids]),
        )
        return opt_g, comp_g

    def scatter(self, ids: np.ndarray, opt_g: PyTree, comp_g: CompressorState) -> None:
        """Write a tile's updated rows back (device → host)."""
        _opt_map(lambda full, upd: full.__setitem__(ids, upd), self._opt, _host(opt_g))
        tree_map(lambda full, upd: full.__setitem__(ids, upd), self._residual,
                 _host(comp_g.residual))
        self._rng[ids] = comp_g.rng.cpu().numpy()
        self._step[ids] = comp_g.step.cpu().numpy()

    # ------------------------------------------------------- checkpointing

    def export(self) -> Dict[str, Any]:
        """Materialized host copies of the full pooled state."""
        return {
            "opt": _opt_map(np.array, self._opt),
            "residual": tree_map(np.array, self._residual),
            "rng": np.array(self._rng),
            "step": np.array(self._step),
        }

    def import_(self, state: Dict[str, Any]) -> None:
        _opt_map(lambda full, v: full.__setitem__(slice(None), v), self._opt, state["opt"])
        tree_map(lambda full, v: full.__setitem__(slice(None), v), self._residual,
                 state["residual"])
        self._rng[:] = state["rng"]
        self._step[:] = state["step"]


@dataclasses.dataclass(eq=False)
class ClientPool:
    model: Model
    optimizer: Optimizer
    policy: CompressionPolicy
    task: Task
    n_clients: int
    lr: Callable[[int], float]  # lr(iteration), a host float
    profiles: Tuple[ClientProfile, ...] = (ClientProfile(),)
    seed: int = 0
    # None → keep the policy's own flag; True/False → force the flat-buffer
    # fast path (core/flat.py §10) for every member's compression; the
    # pooled residual is then (n_clients, n_pad) instead of a stacked tree
    fast: Optional[bool] = None
    # members of one compression call (None → the whole profile group).
    # Short tiles are padded by repeating their last member, as the
    # reference pads them to one compiled shape; the padded members'
    # outputs and rows are discarded.  Peak device state is O(tile).
    cohort_tile: Optional[int] = None
    # where the pooled per-client state lives between rounds: "device"
    # (stacked tensors on the card), "host" (numpy), or "memmap" (on-disk,
    # lazily allocated)
    store: str = "device"
    store_dir: Optional[str] = None  # memmap backing directory
    device: Any = None  # the card unless "cpu" is asked for

    def __post_init__(self) -> None:
        if self.n_clients < 1:
            raise ValueError("need at least one client")
        if self.fast is not None and self.fast != self.policy.fast:
            self.policy = dataclasses.replace(self.policy, fast=self.fast)
        if self.store not in CLIENT_STORES:
            raise ValueError(f"unknown client store {self.store!r}; have {CLIENT_STORES}")
        if self.cohort_tile is not None and self.cohort_tile < 1:
            raise ValueError(f"cohort_tile must be >= 1, got {self.cohort_tile}")
        for prof in self.profiles:
            if prof.delay < 1:
                raise ValueError(
                    f"profile delay must be >= 1, got {prof.delay} "
                    "(delay=0 would upload an untrained zero delta)"
                )
        self.device = resolve_device(self.device)
        full_f32_math()
        self._resolved: Optional[ResolvedPolicy] = None
        self._opt_states: PyTree = None
        self._comp_state: Optional[CompressorState] = None
        self._spill: Optional[SpilledClientStore] = None
        self._ref_leaf_shape: Optional[Tuple[int, ...]] = None

    # ------------------------------------------------------------ lifecycle

    def resolved(self, params: PyTree) -> ResolvedPolicy:
        if self._resolved is None:
            # shared with the server through the once-per-topology cache
            self._resolved = resolve_cached(self.policy, params)
        return self._resolved

    def init(self, params: PyTree, rng: Optional[int] = None) -> None:
        """Allocate per-client optimizer/compressor state (leading N axis):
        stacked device tensors for the "device" store, one
        :class:`SpilledClientStore` otherwise.  ``rng`` seeds the clients'
        compressor seeds (:func:`~repro_torch.core.channel.client_seeds`;
        default ``seed``)."""
        params = tree_map(lambda x: x.to(self.device), params)
        self._ref_leaf_shape = tuple(tree_flatten(params)[0][0].shape)
        resolved = self.resolved(params)
        opt_row = self.optimizer.init(params)
        comp_row = resolved.init_state(params)
        rng_rows = client_seeds(self.seed if rng is None else int(rng), self.n_clients)
        if self.store == "device":
            self._opt_states = _opt_map(
                lambda x: x.expand((self.n_clients,) + tuple(x.shape)).clone(), opt_row)
            self._comp_state = CompressorState(
                residual=stack_clients(comp_row.residual, self.n_clients),
                rng=rng_rows, step=torch.zeros((self.n_clients,), dtype=torch.int64))
            self._spill = None
        else:
            self._spill = SpilledClientStore(
                opt_row, comp_row, rng_rows, n_clients=self.n_clients,
                kind=self.store, directory=self.store_dir)
            self._opt_states = self._comp_state = None

    @property
    def initialized(self) -> bool:
        return self._comp_state is not None or self._spill is not None

    def state_nbytes(self) -> int:
        """Logical bytes of the pooled per-client state, all clients."""
        if self._spill is not None:
            return self._spill.nbytes
        if self._comp_state is None:
            raise RuntimeError("ClientPool.init(params) must run first")
        opt = self._opt_states
        leaves = (tree_flatten(tuple(opt) if isinstance(opt, AdamState) else opt)[0]
                  + tree_flatten(self._comp_state.residual)[0]
                  + [self._comp_state.rng, self._comp_state.step])
        return int(sum(x.numel() * x.element_size() for x in leaves))

    def profile_of(self, client_id: int) -> ClientProfile:
        return self.profiles[client_id % len(self.profiles)]

    # ------------------------------------------------------------- sampling

    def sample_cohort(self, round_idx: int, cohort_size: int) -> np.ndarray:
        """Deterministic partial participation: ``cohort_size`` distinct
        clients drawn from ``default_rng([seed, round])``, ascending ids."""
        k = min(cohort_size, self.n_clients)
        rng = np.random.default_rng([self.seed, round_idx])
        return np.sort(rng.choice(self.n_clients, size=k, replace=False))

    # ----------------------------------------------------------- cohort step

    def run_cohort(self, round_idx: int, cohort_ids: Sequence[int],
                   start_params: PyTree) -> CohortResult:
        """Execute one sampled cohort.

        ``start_params`` is either one shared tree (sync rounds: every
        member trains from the current broadcast replica) or a tree with a
        leading member axis aligned with ``cohort_ids`` (async rounds:
        stale members start from older replicas).

        Members are grouped by profile; each group runs in tiles of at
        most ``cohort_tile`` members.  A tile's optimizer and compressor
        rows are gathered, its members take their ``delay`` local steps on
        the batches ``task.sample(round·delay + d, client)``, the tile is
        compressed as rows, momentum is masked at the transmitted
        coordinates, the rows are scattered back, and the tile's
        compressed trees, losses and Eq. 1 bits come to the host in one
        copy.  A spilled store copies one tile's rows to the card at a
        time."""
        if not self.initialized:
            raise RuntimeError("ClientPool.init(params) must run first")
        ids = np.asarray(cohort_ids, np.int64)
        k_total = ids.size
        stacked_start = self._has_member_axis(start_params, k_total)
        resolved = self._resolved
        ctrees: List[PyTree] = [None] * k_total
        losses = np.zeros((k_total,), np.float64)
        bits = np.zeros((k_total,), np.float64)

        for prof_i, prof in enumerate(self.profiles):
            member_pos = np.nonzero(ids % len(self.profiles) == prof_i)[0]
            if member_pos.size == 0:
                continue
            rates = resolved.rates(prof.sparsity, round_idx)
            tile = (member_pos.size if self.cohort_tile is None
                    else min(self.cohort_tile, member_pos.size))
            for t0 in range(0, member_pos.size, tile):
                pos_t = member_pos[t0:t0 + tile]
                pad = tile - pos_t.size
                # pad a short (final) tile by repeating its last member, as
                # the reference does to keep one compiled shape; the padded
                # members compute duplicates, which are discarded below
                pos_pad = np.concatenate([pos_t, np.repeat(pos_t[-1:], pad)]) if pad else pos_t
                group_ids = ids[pos_pad]
                opt_g, comp_g = self._gather(group_ids)
                with _deterministic_convolutions():
                    deltas, opts, step_losses = self._local(
                        round_idx, group_ids, pos_pad, prof.delay, start_params,
                        stacked_start, opt_g)
                with torch.no_grad():
                    ctree_g, dense_g, comp_g = compress_clients(resolved, deltas, comp_g,
                                                                rates)
                    # momentum masking at transmitted coordinates (supplement A)
                    transmitted = tree_map(lambda d: (d != 0).to(torch.float32), dense_g)
                    opt_g = self.optimizer.mask(opts, transmitted)
                    bits_g = resolved.total_bits(ctree_g)
                real = slice(0, pos_t.size)
                self._scatter(group_ids[real], _opt_map(lambda x: x[real], opt_g),
                              _rows(comp_g, real, resolved.any_residual))
                self._collect(ctree_g, step_losses, bits_g, pos_t, ctrees, losses, bits,
                              resolved)

        profs = [self.profile_of(int(c)) for c in ids]
        return CohortResult(
            client_ids=tuple(int(c) for c in ids),
            ctrees=ctrees,
            losses=losses,
            bits_analytic=bits,
            rates=tuple(p.sparsity for p in profs),
            weights=tuple(p.weight * p.delay for p in profs),
        )

    def _local(self, round_idx: int, group_ids: np.ndarray, pos_pad: np.ndarray,
               delay: int, start_params: PyTree, stacked_start: bool, opt_g) -> tuple:
        """The tile's members' local steps: ``(ΔW rows, optimizer state
        rows, losses (K,))``, each with the tile's leading member axis."""
        deltas, opts, losses = [], [], []
        for j, cid in enumerate(group_ids):
            start = (tree_map(lambda x: x[int(pos_pad[j])], start_params) if stacked_start
                     else start_params)
            batches = [self.task.sample(round_idx * delay + d, int(cid)) for d in range(delay)]
            delta, os, loss = local_steps(
                self.model, self.optimizer, self.lr, start,
                map_states(lambda v: v[0][j], [opt_g]), batches, round_idx * delay)
            deltas.append(delta)
            opts.append(os)
            losses.append(loss)
        stack = lambda xs: torch.stack(list(xs))
        return (tree_map(lambda *xs: stack(xs), *deltas), map_states(stack, opts),
                torch.stack(losses))

    def _collect(self, ctree_g, losses_g, bits_g, pos_t, ctrees, losses, bits,
                 resolved) -> None:
        """The tile's compressed trees, losses and Eq. 1 bits to the host in
        one copy, then one row per real member."""
        comps = resolved._leaves_of(ctree_g)
        fields = [f for c in comps for f in c]
        host = host_copy(fields + [losses_g.to(torch.float32), bits_g.to(torch.float32)])
        nf = len(LeafCompressed._fields)
        comps_h = [LeafCompressed(*host[i * nf:(i + 1) * nf]) for i in range(len(comps))]
        loss_h, bits_h = host[-2].numpy(), host[-1].numpy()
        for j, pos in enumerate(pos_t):
            ctrees[int(pos)] = resolved.treedef.unflatten(
                [LeafCompressed(*(f[j] for f in c)) for c in comps_h])
            losses[int(pos)] = loss_h[j]
            bits[int(pos)] = bits_h[j]

    # ------------------------------------------------------------- plumbing

    def _gather(self, ids: np.ndarray) -> Tuple[PyTree, CompressorState]:
        """One tile's rows on the pool's device (seeds and counters on the
        CPU)."""
        if self._spill is not None:
            return self._spill.gather(ids, self.device)
        gidx = torch.from_numpy(np.asarray(ids, np.int64))
        didx = gidx.to(self.device)
        comp = self._comp_state
        opt_g = _opt_map(lambda x: x.index_select(0, didx), self._opt_states)
        comp_g = CompressorState(
            residual=tree_map(lambda x: x.index_select(0, didx), comp.residual),
            rng=comp.rng.index_select(0, gidx), step=comp.step.index_select(0, gidx))
        return opt_g, comp_g

    def _scatter(self, ids: np.ndarray, opt_g: PyTree, comp_g: CompressorState) -> None:
        if self._spill is not None:
            self._spill.scatter(np.asarray(ids, np.int64), opt_g, comp_g)
            return
        gidx = torch.from_numpy(np.asarray(ids, np.int64))
        didx = gidx.to(self.device)
        comp = self._comp_state
        self._opt_states = _opt_map(lambda full, upd: full.index_copy(0, didx, upd),
                                    self._opt_states, opt_g)
        self._comp_state = CompressorState(
            residual=tree_map(lambda full, upd: full.index_copy(0, didx, upd),
                              comp.residual, comp_g.residual),
            rng=comp.rng.index_copy(0, gidx, comp_g.rng),
            step=comp.step.index_copy(0, gidx, comp_g.step))

    # --------------------------------------------------- rollback/checkpoint

    def snapshot_clients(self, ids: Sequence[int]) -> Dict[str, Any]:
        """Host copies of the named clients' rows, BEFORE a round touches
        them — the elasticity rollback unit: a client whose participation
        fails (straggler abort, corrupt upload) is restored from this, so
        a failed round leaves its residual, momentum and seed bit for bit
        as if it never ran (DESIGN.md §14)."""
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return {"ids": ids, "opt": None, "comp": None}
        opt_g, comp_g = self._gather(ids)
        comp = CompressorState(residual=_host(comp_g.residual), rng=comp_g.rng.numpy().copy(),
                               step=comp_g.step.numpy().copy())
        return {"ids": ids.copy(), "opt": _host(opt_g), "comp": comp}

    def restore_clients(self, snap: Dict[str, Any],
                        only: Optional[Sequence[int]] = None) -> None:
        """Write snapshotted rows back; ``only`` restricts the restore to a
        subset of the snapshot's clients (the ones that actually failed)."""
        ids = np.asarray(snap["ids"], np.int64)
        if ids.size == 0:
            return
        keep = np.arange(ids.size)
        if only is not None:
            only_set = {int(c) for c in only}
            keep = np.asarray([i for i, c in enumerate(ids) if int(c) in only_set], np.int64)
            if keep.size == 0:
                return
        comp = snap["comp"]
        opt_g = _to_device(_opt_map(lambda x: x[keep], snap["opt"]), self.device)
        comp_g = CompressorState(
            residual=_to_device(tree_map(lambda x: x[keep], comp.residual), self.device),
            rng=_tensor(comp.rng[keep]), step=_tensor(comp.step[keep]))
        self._scatter(ids[keep], opt_g, comp_g)

    def export_state(self) -> Dict[str, Any]:
        """The full pooled state as host numpy (the fed checkpoint's
        payload)."""
        if not self.initialized:
            raise RuntimeError("ClientPool.init(params) must run first")
        if self._spill is not None:
            return self._spill.export()
        comp = self._comp_state
        return {"opt": _host(self._opt_states), "residual": _host(comp.residual),
                "rng": comp.rng.numpy().copy(), "step": comp.step.numpy().copy()}

    def import_state(self, state: Dict[str, Any]) -> None:
        """Restore a full pooled state exported by :meth:`export_state`."""
        if not self.initialized:
            raise RuntimeError("ClientPool.init(params) must run first")
        if self._spill is not None:
            self._spill.import_(state)
            return
        self._opt_states = _to_device(state["opt"], self.device)
        self._comp_state = CompressorState(
            residual=_to_device(state["residual"], self.device),
            rng=_tensor(np.asarray(state["rng"], np.int64)),
            step=_tensor(np.asarray(state["step"], np.int64)))

    def _has_member_axis(self, start_params: PyTree, k: int) -> bool:
        """True when ``start_params`` already carries a leading cohort axis."""
        got = tuple(tree_flatten(start_params)[0][0].shape)
        return got == (k,) + self._ref_leaf_shape


def _rows(comp: CompressorState, rows: slice, any_residual: bool) -> CompressorState:
    """The compressor state of ``rows`` of a tile."""
    return CompressorState(
        residual=tree_map(lambda x: x[rows], comp.residual) if any_residual else comp.residual,
        rng=comp.rng[rows], step=comp.step[rows])
