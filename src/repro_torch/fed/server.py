"""Parameter server: decode real SBW1 uploads, aggregate, re-compress the
broadcast (DESIGN.md §9).

Counterpart of ``repro.fed.server``.  The server consumes *bytes*: every
client upload is a packed :mod:`repro_torch.core.wire` buffer, decoded
through the shared (model config, policy, rate) contract with the host
Golomb decoder.  The decoded updates are aggregated with a pluggable
strategy and applied to the master weights W, which live on the run's
device with the replica Ŵ.  The downstream direction goes through the
SAME codec machinery:

    ΔW_down = W − Ŵ + (server residual)     Ŵ = the clients' replica
    ΔW*_down = compress(ΔW_down);  residual ← ΔW_down − ΔW*_down
    Ŵ ← Ŵ + ΔW*_down;   broadcast pack(ΔW*_down)

so downstream bytes are metered (measured AND analytic Eq. 1/Eq. 5)
exactly like upstream ones, and clients can rebuild Ŵ from the wire alone.

Aggregation strategies (``AGGREGATORS``):

  mean        ΔW = (1/K) Σ_i ΔW*_i                        (Alg. 1 l.17)
  weighted    ΔW = Σ_i (n_i / Σ_j n_j) ΔW*_i              (FedAvg-style)
  staleness   ΔW = Σ_i w_i ΔW*_i,  w_i ∝ n_i (1+s_i)^−β   (async, stale
              gradients discounted polynomially — ``staleness_weights``)

The weighted sum is taken in f64 in upload order, one multiply and one add
per upload and leaf (separate operations, never a fused multiply-add), so
it is the reference's numpy loop bit for bit on any device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.channel import resolve_cached
from repro_torch.core.policy import CompressionPolicy, CompressorState, ResolvedPolicy
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.core.wire import Wire, wire_for
from repro_torch.obs import NULL_TELEMETRY

PyTree = Any


class ClientUpdate(NamedTuple):
    """One client's round contribution as it arrives at the server."""

    client_id: int
    blob: bytes  # packed SBW1 buffer — the only payload that crosses
    rate: float  # upstream sparsity rate (part of the shared contract)
    weight: float = 1.0  # sample count for weighted aggregation
    staleness: int = 0  # rounds since the weights this update was computed on


class Broadcast(NamedTuple):
    """One round's downstream message plus its byte accounting."""

    blob: bytes
    dense: PyTree  # decoded ΔW*_down (identical to what unpack(blob) yields)
    bits_analytic: float
    bits_measured: float


def staleness_weights(
    staleness: Sequence[int], beta: float, base: Optional[Sequence[float]] = None
) -> np.ndarray:
    """Closed-form async aggregation weights: w_i ∝ base_i · (1+s_i)^−β,
    normalized to sum to 1."""
    s = np.asarray(staleness, np.float64)
    w = (1.0 + s) ** (-float(beta))
    if base is not None:
        w = w * np.asarray(base, np.float64)
    return w / w.sum()


def _mean_weights(ups: Sequence[ClientUpdate], beta: float) -> np.ndarray:
    return np.full((len(ups),), 1.0 / len(ups))


def _sample_weights(ups: Sequence[ClientUpdate], beta: float) -> np.ndarray:
    w = np.asarray([u.weight for u in ups], np.float64)
    return w / w.sum()


def _staleness_weights(ups: Sequence[ClientUpdate], beta: float) -> np.ndarray:
    return staleness_weights(
        [u.staleness for u in ups], beta, [u.weight for u in ups]
    )


AGGREGATORS = {
    "mean": _mean_weights,
    "weighted": _sample_weights,
    "staleness": _staleness_weights,
}


@dataclasses.dataclass(eq=False)
class ParameterServer:
    """Master weights + bidirectional codec endpoints.

    ``params`` is a tree of tensors on the run's device; W and Ŵ stay on
    it.  ``up_policy`` must be the policy the clients compress with (the
    shared wire contract); ``down_policy`` defaults to it, or to a dense
    ``dense32`` policy when ``down_sparsity >= 1`` (the classic FL
    assumption).  ``delta_horizon`` attaches a
    :class:`~repro_torch.serve.deltalog.DeltaLog` on the server's device
    that logs every broadcast once for catch-ups.
    """

    params: PyTree
    up_policy: CompressionPolicy
    down_policy: Optional[CompressionPolicy] = None
    down_sparsity: float = 1.0
    aggregator: str = "mean"
    staleness_beta: float = 0.5
    delta_horizon: Optional[int] = None  # rounds kept in the DeltaLog

    def __post_init__(self) -> None:
        self.telemetry = NULL_TELEMETRY  # the run layer swaps in an enabled one
        if self.aggregator not in AGGREGATORS:
            raise KeyError(
                f"unknown aggregator {self.aggregator!r}; have {sorted(AGGREGATORS)}"
            )
        if self.down_policy is None:
            # a dense broadcast cannot ride a sparse-position codec: at p=1
            # there are no gaps to Golomb-code
            if self.down_sparsity >= 1.0:
                self.down_policy = CompressionPolicy.single("dense32", name="dense-down")
            else:
                self.down_policy = self.up_policy
        # resolved ONCE per (policy, topology), shared with the client pool
        self._up_resolved: ResolvedPolicy = resolve_cached(self.up_policy, self.params)
        self._down_resolved: ResolvedPolicy = resolve_cached(self.down_policy, self.params)
        f32 = tree_map(lambda x: x.to(torch.float32), self.params)
        self._down_state: CompressorState = self._down_resolved.init_state(f32)
        # the clients' replica Ŵ — advanced ONLY by broadcast wire content
        self.estimate: PyTree = f32
        self._wires: Dict[Tuple[Tuple[float, ...], bool], Wire] = {}
        # optional round-indexed broadcast log (serve/deltalog.py): every
        # broadcast is appended so receivers lagging k rounds can pull a
        # stacked catch-up instead of k re-broadcasts or a full resync
        self.delta_log = None
        if self.delta_horizon is not None:
            from repro_torch.serve.deltalog import DeltaLog

            dev = tree_flatten(f32)[0][0].device
            self.delta_log = DeltaLog(f32, horizon=int(self.delta_horizon), device=dev)

    # ------------------------------------------------------------- wiring

    def _wire(self, resolved: ResolvedPolicy, rate: float, round_idx: int) -> Wire:
        rates = resolved.rates(rate, round_idx)
        key = (rates, resolved is self._down_resolved)
        if key not in self._wires:
            self._wires[key] = wire_for(resolved, self.params, rate, round_idx)
        return self._wires[key]

    def up_wire(self, rate: float, round_idx: int = 0) -> Wire:
        """The upstream decode contract for one client rate this round."""
        return self._wire(self._up_resolved, rate, round_idx)

    def down_wire(self, round_idx: int = 0) -> Wire:
        return self._wire(self._down_resolved, self.down_sparsity, round_idx)

    # ------------------------------------------------------------ receiving

    def receive(self, uploads: Sequence[ClientUpdate], round_idx: int) -> dict:
        """Decode every upload from bytes, aggregate the survivors, apply.

        A corrupt or truncated buffer (``Wire.unpack_compressed`` raises
        ``ValueError``) rejects that upload only: the weights are computed
        over the decoded survivors, so a round with rejects is bit for bit
        a round of just the survivors.  A round with no survivor applies no
        update.  Returns the round's upstream accounting:
        ``{"up_bits_measured", "weights", "update_norm", "accepted",
        "rejected"}`` (bits of ACCEPTED uploads only)."""
        measured = 0.0
        decoded: list = []
        rejected: list = []
        tel = self.telemetry
        dev = tree_flatten(self.params)[0][0].device
        with tel.span("decode", round=round_idx, uploads=len(uploads)):
            for u in uploads:
                wire = self.up_wire(u.rate, round_idx)
                try:
                    comps = wire.unpack_compressed(u.blob)
                except ValueError:
                    rejected.append(int(u.client_id))
                    continue
                measured += sum(float(c.nbits) for c in wire._leaves(comps))
                decoded.append((u, wire.dense_of(comps)))
            survivors = [u for u, _ in decoded]
            weights = (
                AGGREGATORS[self.aggregator](survivors, self.staleness_beta)
                if survivors else np.zeros((0,), np.float64)
            )
            agg: Optional[PyTree] = None
            for (u, update), w in zip(decoded, weights):
                # w · x and the running sum as two f64 operations, as numpy
                # takes them (a fused multiply-add would round once); the
                # f32 → f64 widening is exact, so it runs on the device
                scaled = tree_map(lambda x: x.to(dev).to(torch.float64) * float(w), update)
                agg = scaled if agg is None else tree_map(torch.add, agg, scaled)
        with tel.span("apply", round=round_idx):
            if agg is not None:
                self.params = tree_map(
                    lambda p, a: (p.to(torch.float32) + a.to(torch.float32)).to(p.dtype),
                    self.params, agg,
                )
                tel.fence(self.params)
        norm = 0.0 if agg is None else float(np.sqrt(sum(
            float(torch.sum(torch.square(x))) for x in tree_flatten(agg)[0])))
        return {
            "up_bits_measured": measured,
            "weights": weights,
            "update_norm": norm,
            "accepted": [int(u.client_id) for u in survivors],
            "rejected": rejected,
        }

    # ---------------------------------------------------------- broadcasting

    def _down_space(self):
        """The down policy's flat space when its state keeps the residual
        flat (a ``fast`` policy), else None."""
        if not self._down_resolved.policy.fast:
            return None
        return self._down_resolved.flat_space(self.params)

    def broadcast(self, round_idx: int) -> Broadcast:
        """Compress W − Ŵ through the downstream policy and emit bytes.

        The server-side residual (inside ``_down_state``) carries whatever
        a sparse broadcast dropped into the next round; the replica Ŵ
        advances by exactly the decoded wire content, so server and
        clients stay byte-consistent.  The invariant W − Ŵ == residual
        holds bit for bit after every broadcast."""
        gap = tree_map(lambda w, e: w.to(torch.float32) - e, self.params, self.estimate)
        # the gap W − Ŵ already holds every coordinate not yet sent (Ŵ only
        # advances by transmitted content), and compress() adds its stored
        # residual back: feed it the residual-free part, so acc == gap
        if self._down_resolved.any_residual:
            residual = self._down_state.residual
            space = self._down_space()
            if space is not None:
                residual = space.unflatten(residual, cast=False)
            delta = tree_map(lambda g, r: g - r.to(torch.float32), gap, residual)
        else:
            delta = gap
        rates = self._down_resolved.rates(self.down_sparsity, round_idx)
        with self.telemetry.span("select_quantize", round=round_idx, side="down"):
            ctree, dense, self._down_state = self._down_resolved.compress(
                delta, self._down_state, rates)
            self.telemetry.fence(dense)
        with self.telemetry.span("encode", round=round_idx, side="down"):
            wire = self.down_wire(round_idx)
            blob, bits = wire.pack_with_bits(ctree)
        self.estimate = tree_map(torch.add, self.estimate, dense)
        analytic = float(self._down_resolved.total_bits(ctree))
        if self.delta_log is not None:
            # the log decodes the blob through the same wire a receiver
            # uses, so its replica trajectory is the receivers', bit for bit
            self.delta_log.append(round_idx, blob, wire, bits_analytic=analytic)
        return Broadcast(blob=blob, dense=dense, bits_analytic=analytic,
                         bits_measured=float(bits))

    @property
    def down_residual(self) -> PyTree:
        """Server-side error-feedback accumulator (Eq. 2, downstream),
        always viewed as a tree (a fast policy's state stores it flat)."""
        residual = self._down_state.residual
        space = self._down_space()
        if space is not None:
            return space.unflatten(residual, cast=False)
        return residual
