"""Round-indexed log of broadcast deltas + stacked catch-up coding (§13).

Counterpart of ``repro.serve.deltalog``: the same ``SBD1`` bytes, so a
catch-up message encoded by either package applies in the other.

The downstream half of the paper's economics: SBC compresses the
*upstream* by orders of magnitude while the server re-broadcasts a
near-full state.  A :class:`DeltaLog` encodes the server's SBW1 downstream
buffer ONCE per round, appends it here, and every receiver — cohort member
or serving subscriber — shares those bytes instead of triggering a
per-client re-compression.

For a receiver lagging k rounds the log offers three catch-up forms:

  replay    the k stored SBW1 blobs, applied in order (what a live
            receiver would have downloaded anyway);
  stacked   ONE ``SBD1`` message: per leaf, the union of the positions
            transmitted in rounds (a, b] Golomb-coded at the union's own
            density, plus the FINAL replica values at those positions;
  full      the whole replica Ŵ_b as dense f32 — the only option once
            the log has evicted past the horizon.

Where things live: the replica Ŵ and each entry's decoded ``dense`` are
f32 tensors on the log's device (the card on the run paths); the
transmitted position sets ``touched`` are host int64 arrays, because the
Golomb coder (:mod:`repro_torch.core.golomb`) is host code.  A stacked
message gathers ``Ŵ[union]`` on the device and copies it to the host once.

Bit-exactness of ``stacked`` is by construction, not by float luck: the
replica Ŵ_r is deterministic on every receiver (it advances ONLY by
decoded wire content), so the stacked message carries Ŵ_b's bytes at the
union positions and applies them with scatter-SET.  Positions untouched in
(a, b] are bit-identical between Ŵ_a and Ŵ_b up to one ±0.0 subtlety:
sequential application adds a full dense array per round, so a stored
−0.0 flips to +0.0 (−0.0 + 0.0 = +0.0) — the apply path reproduces that
with a single +0.0 add before scattering.  Every touched position is in
the union because the union is computed from the *transmitted* index
sets — not from ``nonzero(dense)``, which would miss a transmitted +0.0
landing on a stored −0.0.  Summing the k sparse values per position
would NOT be exact: f32 addition is non-associative, so shipping the
final bytes sidesteps the reassociation.

``SBD1`` catch-up framing (little-endian, mirrors wire.py's SBW1):

    header:  b"SBD1"  u8 kind (0=stacked, 1=full)
             i32 from_round  i32 to_round  u32 n_leaves
    leaf i:  u8 mode
      0 empty   → (nothing: no position transmitted in the window)
      1 sparse  → u32 k, u32 bit_count, Golomb bitstream at p=k/n,
                  k f32 final replica values (ascending position order)
      2 dense   → n f32 final replica values (n from the shared contract)

Like SBW1, the framing (magic, kind, rounds, k/bit-count fields) is
transport overhead; metered bits are the Golomb stream + 32/value.
"""
from __future__ import annotations

import collections
import struct
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import golomb
from repro_torch.core.tree import tree_flatten
from repro_torch.core.wire import Wire, leaf_dense
from repro_torch.device import resolve_device

PyTree = Any

CATCHUP_MAGIC = b"SBD1"
KIND_STACKED = 0
KIND_FULL = 1
_KINDS = {KIND_STACKED: "stacked", KIND_FULL: "full"}
MODE_EMPTY, MODE_SPARSE, MODE_DENSE = 0, 1, 2
_HEADER = struct.Struct("<Bii")  # kind, from_round, to_round
_HEADER_BYTES = 4 + _HEADER.size + 4  # magic + header + u32 n_leaves


def _need(blob: bytes, nbytes: int, what: str) -> None:
    if len(blob) < nbytes:
        raise ValueError(
            f"truncated SBD1 catch-up message: {what} needs {nbytes} bytes, "
            f"have {len(blob)}"
        )


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor; host arrays are copied (they may be read-only)."""
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))


def _host_f32(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """The tensors as host f32 arrays, in ONE device-to-host copy."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    return np.split(flat, np.cumsum([t.numel() for t in tensors])[:-1])


class LogEntry(NamedTuple):
    """One appended round: the broadcast bytes plus the decoded view of
    them every receiver shares."""

    round: int
    blob: bytes  # the round's framed SBW1 broadcast buffer
    touched: Tuple[Optional[np.ndarray], ...]  # per-leaf transmitted
    # positions (sorted host int64); None = every position (dense-codec leaf)
    dense: Tuple[torch.Tensor, ...]  # per-leaf decoded flat f32 ΔW*, on the log's device
    bits_measured: float
    bits_analytic: float

    @property
    def nbytes(self) -> int:
        return len(self.blob)


class CatchupMessage(NamedTuple):
    """One encoded SBD1 catch-up buffer plus its byte/bit accounting."""

    kind: str  # "stacked" | "full"
    from_round: int
    to_round: int
    blob: bytes
    bits_measured: float
    bits_analytic: float

    @property
    def nbytes(self) -> int:
        return len(self.blob)


class DeltaLog:
    """Horizon-bounded, round-indexed log of the server's broadcasts.

    ``append`` decodes the round's SBW1 blob exactly as a receiver would
    and advances the running replica Ŵ by the decoded content (f32 IEEE
    adds on the log's device, denormals kept — the same trajectory every
    receiver computes), so ``encode_stacked``'s final values are the bytes
    any up-to-date replica holds.  Entries older than ``horizon`` rounds
    are evicted; the replica itself always remains available for a full
    resync.  ``device`` is where the replica lives: the card unless
    ``"cpu"`` is given (:func:`~repro_torch.device.resolve_device`).
    """

    def __init__(self, params: PyTree, horizon: int = 16,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        if horizon < 1:
            raise ValueError(f"delta horizon must be >= 1, got {horizon}")
        self.horizon = int(horizon)
        self.device = resolve_device(device)
        leaves, self.treedef = tree_flatten(params)
        self._shapes: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(np.shape(x)) for x in leaves
        )
        self._replica: List[torch.Tensor] = [
            _tensor(x).to(self.device, torch.float32).reshape(-1).clone() for x in leaves
        ]
        self._entries: collections.deque = collections.deque()
        self._head = -1

    # -------------------------------------------------------------- queries

    @property
    def head(self) -> int:
        """Last appended round (−1 before the first broadcast)."""
        return self._head

    @property
    def oldest(self) -> int:
        """Oldest round still held (head+1 when the log is empty)."""
        return self._entries[0].round if self._entries else self._head + 1

    @property
    def n_params(self) -> int:
        return sum(r.numel() for r in self._replica)

    def replica(self) -> PyTree:
        """The current Ŵ as an f32 tree (copies; safe to mutate)."""
        return self.treedef.unflatten(
            [r.reshape(s).clone() for r, s in zip(self._replica, self._shapes)]
        )

    def replica_flat(self) -> List[torch.Tensor]:
        """Flat f32 leaves of the current Ŵ (copies, on the log's device)."""
        return [r.clone() for r in self._replica]

    def can_stack(self, from_round: int) -> bool:
        """True when every round in (from_round, head] is still held."""
        return self.oldest - 1 <= from_round <= self._head

    def entries_since(self, from_round: int) -> Tuple[LogEntry, ...]:
        """The contiguous entries covering (from_round, head]."""
        if not self.can_stack(from_round):
            raise ValueError(
                f"rounds ({from_round}, {self._head}] not fully held; "
                f"log covers [{self.oldest}, {self._head}]"
            )
        return tuple(e for e in self._entries if e.round > from_round)

    # ------------------------------------------------------------- appending

    def _decode_entry(
        self,
        round_idx: int,
        blob: bytes,
        wire: Wire,
        bits_analytic: Optional[float] = None,
    ) -> LogEntry:
        """Decode one broadcast blob through ``wire`` (the exact receiver
        path) into a :class:`LogEntry` — no replica/log mutation, so
        :meth:`restore` can rebuild the held window's entries from bytes."""
        comps = wire.unpack_compressed(blob)
        leaves = wire.treedef.flatten_up_to(comps)
        if len(leaves) != len(self._replica):
            raise ValueError(
                f"wire has {len(leaves)} leaves, log replica has "
                f"{len(self._replica)}"
            )
        touched, denses = [], []
        bits = 0.0
        for comp, spec, shape in zip(leaves, wire.specs, self._shapes):
            if tuple(spec.shape) != shape:
                raise ValueError(
                    f"leaf {spec.path!r} shape {spec.shape} != replica "
                    f"shape {shape}"
                )
            denses.append(leaf_dense(comp, spec).reshape(-1))
            bits += float(comp.nbits)
            if spec.selector == "dense":
                touched.append(None)  # every position transmitted
            elif spec.selector == "skip":
                touched.append(np.zeros((0,), np.int64))
            else:
                touched.append(np.asarray(comp.idx, np.int64))
        # the decoded leaves cross to the device in one copy
        flat = torch.cat(denses).to(self.device)
        dense = tuple(torch.split(flat, [d.numel() for d in denses]))
        return LogEntry(
            round=round_idx,
            blob=bytes(blob),
            touched=tuple(touched),
            dense=dense,
            bits_measured=bits,
            bits_analytic=float(bits if bits_analytic is None else bits_analytic),
        )

    def append(
        self,
        round_idx: int,
        blob: bytes,
        wire: Wire,
        bits_analytic: Optional[float] = None,
    ) -> LogEntry:
        """Log one round's broadcast: decode ``blob`` through ``wire`` (the
        exact receiver path), record the transmitted position sets, and
        advance the replica by the decoded dense content."""
        if round_idx != self._head + 1:
            raise ValueError(
                f"DeltaLog rounds must be contiguous: got {round_idx}, "
                f"expected {self._head + 1}"
            )
        entry = self._decode_entry(round_idx, blob, wire, bits_analytic)
        for rep, d in zip(self._replica, entry.dense):
            rep.add_(d)  # f32 IEEE add — identical on every receiver
        self._entries.append(entry)
        self._head = round_idx
        while self._entries and self._entries[0].round <= self._head - self.horizon:
            self._entries.popleft()
        return entry

    # --------------------------------------------------------- checkpointing

    def state_dict(self) -> dict:
        """The log's full restorable state: head, flat replica leaves (host
        numpy arrays), and the held window as raw (round, blob,
        bits_analytic) rows — entries re-decode on :meth:`restore`, so only
        bytes persist."""
        return {
            "head": self._head,
            "replica": _host_f32(self._replica),
            "entries": [
                (e.round, e.blob, e.bits_analytic) for e in self._entries
            ],
        }

    def restore(self, state: dict, wire_for_round) -> None:
        """Restore :meth:`state_dict` output.  ``wire_for_round(round)``
        yields the decode contract for each held blob (the server's
        ``down_wire``); the replica is set directly — entry decode must
        NOT advance it a second time."""
        self._head = int(state["head"])
        if len(state["replica"]) != len(self._replica):
            raise ValueError(
                f"checkpoint has {len(state['replica'])} replica leaves, "
                f"log has {len(self._replica)}"
            )
        for rep, saved in zip(self._replica, state["replica"]):
            if rep.numel() != np.size(saved):
                raise ValueError(
                    f"replica leaf size {np.size(saved)} != {rep.numel()}"
                )
            rep.copy_(_tensor(saved).reshape(-1))
        self._entries.clear()
        for round_idx, blob, bits_analytic in state["entries"]:
            self._entries.append(
                self._decode_entry(
                    int(round_idx), bytes(blob), wire_for_round(int(round_idx)),
                    bits_analytic,
                )
            )

    # ------------------------------------------------------------- encoding

    def encode_stacked(self, from_round: int) -> CatchupMessage:
        """ONE message that moves a replica from round ``from_round`` to
        head: per leaf the union of transmitted positions over the window,
        Golomb-coded at the union's own density k/n, plus the final
        replica values there (scatter-SET on apply — see module doc)."""
        if from_round >= self._head:
            raise ValueError(
                f"nothing to stack: from_round {from_round} >= head {self._head}"
            )
        ents = self.entries_since(from_round)
        unions: List[Optional[np.ndarray]] = []
        for i, rep in enumerate(self._replica):
            if any(e.touched[i] is None for e in ents):
                union = None  # a dense round touched everything
            else:
                idxs = [e.touched[i] for e in ents if e.touched[i].size]
                union = (
                    np.unique(np.concatenate(idxs))
                    if idxs else np.zeros((0,), np.int64)
                )
                if union.size >= rep.numel():
                    union = None
            unions.append(union)
        # the final values: gathered on the device, one copy to the host
        values = _host_f32([
            rep if u is None else rep[torch.from_numpy(u).to(self.device)]
            for rep, u in zip(self._replica, unions) if u is None or u.size
        ])
        parts = [
            CATCHUP_MAGIC,
            _HEADER.pack(KIND_STACKED, from_round, self._head),
            struct.pack("<I", len(self._replica)),
        ]
        bits_m = bits_a = 0.0
        held = iter(values)
        for rep, union in zip(self._replica, unions):
            n = rep.numel()
            if union is None:
                parts.append(struct.pack("<B", MODE_DENSE))
                parts.append(next(held).astype("<f4").tobytes())
                bits_m += 32.0 * n
                bits_a += 32.0 * n
            elif union.size == 0:
                parts.append(struct.pack("<B", MODE_EMPTY))
            else:
                k = int(union.size)
                p_eff = k / n  # a Python float: b* follows from it
                packed, pos_bits = golomb.encode_positions_packed(union, p_eff)
                parts.append(struct.pack("<BII", MODE_SPARSE, k, pos_bits))
                parts.append(packed)
                parts.append(next(held).astype("<f4").tobytes())
                bits_m += pos_bits + 32.0 * k
                bits_a += k * (golomb.expected_position_bits(p_eff) + 32.0)
        return CatchupMessage(
            kind="stacked", from_round=from_round, to_round=self._head,
            blob=b"".join(parts), bits_measured=bits_m, bits_analytic=bits_a,
        )

    def encode_full(self) -> CatchupMessage:
        """Full-state resync: the whole replica as dense f32 (applies from
        ANY round — the fallback once the horizon has evicted)."""
        parts = [
            CATCHUP_MAGIC,
            _HEADER.pack(KIND_FULL, -1, self._head),
            struct.pack("<I", len(self._replica)),
        ]
        bits = 0.0
        for rep in _host_f32(self._replica):
            parts.append(struct.pack("<B", MODE_DENSE))
            parts.append(rep.astype("<f4").tobytes())
            bits += 32.0 * rep.size
        return CatchupMessage(
            kind="full", from_round=-1, to_round=self._head,
            blob=b"".join(parts), bits_measured=bits, bits_analytic=bits,
        )

    def full_nbytes(self) -> int:
        """Exact byte size of :meth:`encode_full` without materializing it
        (the planner prices the resync candidate every round)."""
        return _HEADER_BYTES + sum(1 + 4 * r.numel() for r in self._replica)


# ---------------------------------------------------------------- receiving


def apply_catchup_flat(
    flats: Sequence[Union[torch.Tensor, np.ndarray]], blob: bytes
) -> Tuple[List[torch.Tensor], int, int]:
    """Decode one SBD1 message against flat f32 replica leaves (tensors, on
    any device, or host arrays).

    Returns ``(new_flats, from_round, to_round)``, the new leaves as f32
    tensors on the first leaf's device.  Malformed buffers raise
    ``ValueError`` (same hardening contract as ``Wire.unpack``).
    """
    _need(blob, _HEADER_BYTES, "header")
    if blob[:4] != CATCHUP_MAGIC:
        raise ValueError("bad catch-up magic; not an SBD1 buffer")
    kind, from_round, to_round = _HEADER.unpack_from(blob, 4)
    if kind not in _KINDS:
        raise ValueError(f"unknown SBD1 kind {kind}")
    (n_leaves,) = struct.unpack_from("<I", blob, 4 + _HEADER.size)
    if n_leaves != len(flats):
        raise ValueError(
            f"buffer has {n_leaves} leaves, replica has {len(flats)}"
        )
    out = [_tensor(f).to(torch.float32).reshape(-1).clone() for f in flats]
    if kind == KIND_STACKED:
        # sequential application adds a FULL dense array every round, so a
        # stored −0.0 at an untransmitted position flips to +0.0 on the
        # first add (−0.0 + 0.0 = +0.0) and stays; one +0.0 add reproduces
        # k ≥ 1 such adds bit-exactly, keeping the scatter-SET below
        # bit-identical to replay even at untouched positions.  It is not
        # a no-op: do not remove it.
        out = [torch.add(f, 0.0) for f in out]
    off = _HEADER_BYTES
    for i, flat in enumerate(out):
        n = flat.numel()
        _need(blob, off + 1, f"leaf {i} mode")
        mode = blob[off]
        off += 1
        if mode == MODE_EMPTY:
            continue
        if mode == MODE_DENSE:
            _need(blob, off + 4 * n, f"leaf {i}: {n} f32 values")
            vals = np.frombuffer(blob, "<f4", count=n, offset=off).astype(np.float32)
            out[i] = torch.from_numpy(vals).to(flat.device)
            off += 4 * n
        elif mode == MODE_SPARSE:
            _need(blob, off + 8, f"leaf {i} sparse header")
            k, bit_count = struct.unpack_from("<II", blob, off)
            off += 8
            if not 0 < k < n:
                raise ValueError(
                    f"corrupt SBD1 leaf {i}: k={k} outside (0, {n})"
                )
            nb = (bit_count + 7) // 8
            _need(blob, off + nb, f"leaf {i} Golomb stream of {bit_count} bits")
            bits = np.unpackbits(
                np.frombuffer(blob[off:off + nb], np.uint8)
            )[:bit_count]
            idx = golomb.decode_positions(bits, k / n)
            if idx.size != k:
                raise ValueError(
                    f"corrupt SBD1 leaf {i}: decoded {idx.size} positions, "
                    f"header says {k}"
                )
            if int(idx.max()) >= n:
                raise ValueError(
                    f"corrupt SBD1 leaf {i}: position {int(idx.max())} "
                    f"outside [0, {n})"
                )
            off += nb
            _need(blob, off + 4 * k, f"leaf {i}: {k} f32 values")
            vals = np.frombuffer(blob, "<f4", count=k, offset=off).astype(np.float32)
            off += 4 * k
            # scatter-SET: the final replica bytes
            flat[torch.from_numpy(np.asarray(idx, np.int64)).to(flat.device)] = \
                torch.from_numpy(vals).to(flat.device)
        else:
            raise ValueError(f"unknown SBD1 leaf mode {mode}")
    return out, from_round, to_round


def apply_catchup(replica: PyTree, blob: bytes) -> Tuple[PyTree, int, int]:
    """Tree form of :func:`apply_catchup_flat`: move an f32 replica at the
    message's ``from_round`` to its ``to_round`` state, bit-identical to
    applying the window's broadcasts sequentially."""
    leaves, treedef = tree_flatten(replica)
    flats, from_round, to_round = apply_catchup_flat(leaves, blob)
    shaped = [f.reshape(tuple(np.shape(x))) for f, x in zip(flats, leaves)]
    return treedef.unflatten(shaped), from_round, to_round
