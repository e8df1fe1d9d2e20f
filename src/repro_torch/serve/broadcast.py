"""Delta-broadcast fan-out: one encode per round, shared by 10k+ subscribers.

Counterpart of ``repro.serve.broadcast``.  Three layers over
:class:`~repro_torch.serve.deltalog.DeltaLog` (DESIGN.md §13):

  :class:`CatchupPlanner`   prices the three catch-up forms for a receiver
                            lagging k rounds — replay (the k stored SBW1
                            blobs), stacked (one SBD1 union message), full
                            (dense resync) — and picks the fewest bytes;
                            lag past the horizon forces full.
  :class:`SubscriberPool`   10k–100k simulated subscribers as (S,) int32
                            tensors on the card.  Each round costs one
                            plan/encode per DISTINCT lag class — every
                            subscriber in a class shares the same bytes —
                            and the per-subscriber state advance is a few
                            torch operations on the device.
  :func:`simulate_fanout`   drives the production broadcast path
                            (:class:`~repro_torch.fed.server.ParameterServer`
                            with a log attached) with synthetic updates and
                            fans it out.

Every chosen plan is metered through the core
:class:`~repro_torch.core.ledger.BandwidthLedger` (measured AND analytic
bits), so ``reconcile()`` holds on the broadcast path exactly as it does
for the upstream wire.
"""
from __future__ import annotations

import dataclasses
import time
from typing import (Any, Callable, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.core.ledger import BandwidthLedger, RoundRecord
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.device import resolve_device
from repro_torch.obs import NULL_TELEMETRY
from repro_torch.serve.deltalog import DeltaLog, apply_catchup_flat

PyTree = Any


class CatchupPlan(NamedTuple):
    """One receiver class's chosen catch-up: what crosses and what it costs."""

    kind: str  # "none" | "replay" | "stacked" | "full"
    from_round: int
    to_round: int
    nbytes: int
    bits_measured: float
    bits_analytic: float
    blobs: Tuple[bytes, ...]  # k SBW1 blobs (replay) or one SBD1 message
    candidates: Tuple[Tuple[str, int], ...]  # every (kind, nbytes) priced


@dataclasses.dataclass(eq=False)
class CatchupPlanner:
    """Min-byte catch-up choice against one :class:`DeltaLog`.

    The full-resync candidate is priced arithmetically
    (:meth:`DeltaLog.full_nbytes`) and only materialized when chosen;
    replay is priced off the stored blob lengths; stacked must be encoded
    to be priced (the union's density is data-dependent), and the encoding
    IS the payload when it wins.
    """

    log: DeltaLog
    telemetry: Any = NULL_TELEMETRY

    def plan(self, from_round: int) -> CatchupPlan:
        with self.telemetry.span("plan", from_round=from_round):
            return self._plan(from_round)

    def _plan(self, from_round: int) -> CatchupPlan:
        head = self.log.head
        if from_round >= head:
            return CatchupPlan("none", from_round, head, 0, 0.0, 0.0, (), ())
        costs: Dict[str, int] = {"full": self.log.full_nbytes()}
        stacked = None
        if self.log.can_stack(from_round):
            ents = self.log.entries_since(from_round)
            costs["replay"] = sum(e.nbytes for e in ents)
            with self.telemetry.span("encode_stacked", from_round=from_round):
                stacked = self.log.encode_stacked(from_round)
            costs["stacked"] = stacked.nbytes
        order = ("stacked", "replay", "full")  # tie-break: fewest messages
        kind = min(costs, key=lambda c: (costs[c], order.index(c)))
        candidates = tuple(sorted(costs.items()))
        if kind == "replay":
            return CatchupPlan(
                "replay", from_round, head, costs["replay"],
                sum(e.bits_measured for e in ents),
                sum(e.bits_analytic for e in ents),
                tuple(e.blob for e in ents), candidates,
            )
        if kind == "stacked":
            return CatchupPlan(
                "stacked", from_round, head, stacked.nbytes,
                stacked.bits_measured, stacked.bits_analytic,
                (stacked.blob,), candidates,
            )
        full = self.log.encode_full()
        return CatchupPlan(
            "full", from_round, head, full.nbytes,
            full.bits_measured, full.bits_analytic,
            (full.blob,), candidates,
        )


def apply_plan(
    flats: List[torch.Tensor],
    plan: CatchupPlan,
    replay_dense: Callable[[int, bytes], Sequence[torch.Tensor]],
) -> List[torch.Tensor]:
    """A receiver's flat replica moved by ``plan``.

    A replay adds, in round order, ``replay_dense(round_idx, blob)``: the
    per-leaf flat f32 deltas of the SBW1 blob broadcast in ``round_idx``,
    on the replica's device (a receiver decodes them through its down
    wire).  A stacked or full plan applies its one SBD1 message."""
    if plan.kind == "replay":
        for i, blob in enumerate(plan.blobs):
            dense = replay_dense(plan.from_round + 1 + i, blob)
            flats = [f + d for f, d in zip(flats, dense)]
        return flats
    if plan.kind in ("stacked", "full"):
        out, _, _ = apply_catchup_flat(flats, plan.blobs[0])
        return out
    return flats


@dataclasses.dataclass(eq=False)
class SubscriberPool:
    """Per-subscriber lag state at fan-out scale.

    Subscriber s syncs at rounds where ``round % period[s] == phase[s]``
    (period from ``periods`` round-robin, phase ``s % period``) — a
    deterministic wake pattern that produces a stable spectrum of lag
    classes.  State is (S,) int32 tensors on the log's device; a round
    finds its lag classes with one ``torch.unique`` there, copies only the
    classes to the host, and advances every subscriber with a few device
    operations.

    ``verify_classes`` > 0 maintains a real replica for the first V
    (period, phase) classes and applies each chosen plan to it, checking
    bit-identity with the log's replica — the bit-exactness contract
    checked live at fan-out scale (per class, not per subscriber).
    """

    log: DeltaLog
    n_subscribers: int
    periods: Tuple[int, ...] = (1,)
    verify_classes: int = 0
    telemetry: Any = NULL_TELEMETRY

    def __post_init__(self) -> None:
        if self.n_subscribers < 1:
            raise ValueError("need at least one subscriber")
        if not self.periods or any(int(p) < 1 for p in self.periods):
            raise ValueError(f"periods must be >= 1, got {self.periods}")
        self.periods = tuple(int(p) for p in self.periods)
        self.device = self.log.device
        self.planner = CatchupPlanner(self.log, telemetry=self.telemetry)
        self.ledger = BandwidthLedger()
        s = np.arange(self.n_subscribers)
        period = np.asarray(
            [self.periods[i % len(self.periods)] for i in range(self.n_subscribers)],
            np.int32,
        )
        phase = (s % period).astype(np.int32)
        dev = self.device
        self._period = torch.from_numpy(period).to(dev)
        self._phase = torch.from_numpy(phase).to(dev)
        start = int(self.log.head)
        self._synced = torch.full((self.n_subscribers,), start, dtype=torch.int32, device=dev)
        # exact byte totals live in the ledger (host ints); the per-
        # subscriber counter is for distribution stats at int32 range
        self._bytes = torch.zeros((self.n_subscribers,), dtype=torch.int32, device=dev)
        self._syncs = torch.zeros((self.n_subscribers,), dtype=torch.int32, device=dev)
        self.down_bytes_full_equiv = 0  # if every sync were a full resync
        self._verify: Dict[Tuple[int, int], dict] = {}
        classes = sorted({(int(p), int(ph)) for p, ph in zip(period.tolist(), phase.tolist())})
        for p, ph in classes[: max(0, int(self.verify_classes))]:
            self._verify[(p, ph)] = {
                "flats": self.log.replica_flat(),
                "synced": start,
            }
        self._verify_failures = 0
        self.verified_syncs = 0

    # ------------------------------------------------------------- advance

    def _awake(self, round_idx: int) -> torch.Tensor:
        return (round_idx % self._period) == self._phase

    def _advance(self, round_idx: int, byte_table: torch.Tensor) -> None:
        """Bulk state update on the device: who wakes, what their class's
        plan costs (lag-indexed table built on the host), advance to head."""
        awake = self._awake(round_idx)
        lag = torch.clamp(round_idx - self._synced, 0, byte_table.shape[0] - 1)
        add = torch.where(awake, byte_table[lag.long()], torch.zeros_like(self._bytes))
        self._synced = torch.where(awake, torch.full_like(self._synced, round_idx),
                                   self._synced)
        self._bytes = self._bytes + add
        self._syncs = self._syncs + awake.to(torch.int32)

    def sync_round(self, round_idx: int) -> dict:
        """Fan this round out: one plan per distinct lag class, bytes
        shared across the class, everything metered into the ledger.

        Call AFTER the round's broadcast was appended (head == round_idx).
        """
        if round_idx != self.log.head:
            raise ValueError(
                f"sync_round({round_idx}) but log head is {self.log.head}; "
                "append the round's broadcast first"
            )
        uniq, counts = torch.unique(self._synced[self._awake(round_idx)],
                                    return_counts=True)
        uniq, counts = uniq.cpu().numpy(), counts.cpu().numpy()
        n_awake = int(counts.sum())

        plans: Dict[int, Any] = {}
        down_bytes = 0
        bits_m = bits_a = 0.0
        max_lag = int(round_idx - uniq.min()) if uniq.size else 0
        table = np.zeros((max_lag + 1,), np.int64)
        for frm, cnt in zip(uniq.tolist(), counts.tolist()):
            plan = self.planner.plan(int(frm))
            plans[int(frm)] = plan
            down_bytes += plan.nbytes * int(cnt)
            bits_m += plan.bits_measured * int(cnt)
            bits_a += plan.bits_analytic * int(cnt)
            table[round_idx - int(frm)] = plan.nbytes
            lag = round_idx - int(frm)
            self.telemetry.metrics.gauge(
                "serve/plan_bytes", plan.nbytes,
                round=round_idx, lag=lag, kind=plan.kind,
            )
            self.telemetry.metrics.hist(
                "fed/lag_class", lag, round=round_idx, count=int(cnt),
            )
        self.down_bytes_full_equiv += n_awake * self.log.full_nbytes()

        self._advance(round_idx, torch.from_numpy(
            np.clip(table, 0, 2**31 - 1).astype(np.int32)).to(self.device))
        self.ledger.record(RoundRecord(
            round=round_idx, cohort=(), up_bytes=0,
            up_bits_measured=0.0, up_bits_analytic=0.0,
            down_bytes=int(down_bytes), down_bits_measured=bits_m,
            down_bits_analytic=bits_a, down_recipients=n_awake,
        ))
        self._verify_round(round_idx, plans)
        return {
            "round": round_idx,
            "awake": n_awake,
            "classes": {round_idx - f: p.kind for f, p in plans.items()},
            "down_bytes": int(down_bytes),
        }

    # ---------------------------------------------------------- verification

    def _verify_round(self, round_idx: int, plans: Dict[int, CatchupPlan]):
        if not self._verify:
            return
        # the log's own decode of each held blob stands in for a receiver's
        held = {e.round: e.dense for e in self.log._entries}
        with self.telemetry.span("verify", round=round_idx,
                                 classes=len(self._verify)):
            for (p, ph), state in self._verify.items():
                if round_idx % p != ph:
                    continue
                plan = plans.get(state["synced"])
                if plan is None:  # class empty this round (shouldn't happen)
                    continue
                state["flats"] = apply_plan(state["flats"], plan,
                                            lambda r, _blob: held[r])
                state["synced"] = round_idx
                self.verified_syncs += 1
                # bit patterns, not values: −0.0 and +0.0 must not compare equal
                ok = all(
                    torch.equal(got.view(torch.int32), want.view(torch.int32))
                    for got, want in zip(state["flats"], self.log._replica)
                )
                if not ok:
                    self._verify_failures += 1
                else:
                    self.telemetry.metrics.counter(
                        "serve/verify_ok", 1, round=round_idx, period=p,
                    )

    @property
    def verify_ok(self) -> bool:
        """True iff every verified class sync was bit-identical to the
        log replica (trivially True with verify_classes=0)."""
        return self._verify_failures == 0

    # -------------------------------------------------------------- queries

    @property
    def synced_round(self) -> np.ndarray:
        return self._synced.cpu().numpy()

    @property
    def bytes_down(self) -> np.ndarray:
        return self._bytes.cpu().numpy()

    def totals(self) -> dict:
        t = self.ledger.totals()
        rounds = max(1, t["rounds"])
        t["bytes_per_subscriber_per_round"] = (
            t["down_bytes"] / (self.n_subscribers * rounds)
        )
        t["down_bytes_full_equiv"] = self.down_bytes_full_equiv
        t["bytes_saving_vs_full_resync"] = (
            self.down_bytes_full_equiv / max(1, t["down_bytes"])
        )
        t["syncs"] = int(self._syncs.sum())
        return t


# ------------------------------------------------------------- simulation


def simulate_fanout(
    params: PyTree,
    *,
    n_subscribers: int,
    rounds: int,
    horizon: int = 8,
    down_sparsity: float = 0.02,
    periods: Tuple[int, ...] = (1, 2, 4, 8),
    seed: int = 0,
    update_scale: float = 1e-2,
    verify_classes: int = 3,
    policy: Optional[Any] = None,
    telemetry: Any = NULL_TELEMETRY,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Drive the PRODUCTION broadcast path at fan-out scale.

    Each round applies a synthetic update (Gaussian, from a
    ``torch.Generator`` seeded by ``seed`` on the device) to a
    :class:`~repro_torch.fed.server.ParameterServer` carrying a
    :class:`DeltaLog`, broadcasts (one encode), and fans the log out to
    ``n_subscribers`` through a :class:`SubscriberPool`.  Everything lives
    on ``device`` (the card unless ``"cpu"`` is given).  Returns the
    reference's byte/throughput metrics under its keys; the draws are not
    the reference's (torch cannot draw JAX's threefry numbers).
    """
    from repro_torch.core.api import CompressionPolicy, PolicyRule
    from repro_torch.core.codec import make_codec
    from repro_torch.core.policy import DENSE_SMALL_PATTERN
    from repro_torch.fed.server import ParameterServer

    dev = resolve_device(device)
    if policy is None:
        policy = CompressionPolicy(
            default=make_codec("sbc"),
            rules=(PolicyRule(DENSE_SMALL_PATTERN, codec="dense32"),),
            name="sbc+dense-small",
        )
    f32 = tree_map(lambda x: torch.as_tensor(x).to(dev, torch.float32), params)
    server = ParameterServer(
        params=f32, up_policy=policy, down_sparsity=down_sparsity,
        delta_horizon=horizon,
    )
    server.telemetry = telemetry
    pool = SubscriberPool(
        log=server.delta_log, n_subscribers=n_subscribers,
        periods=periods, verify_classes=verify_classes,
        telemetry=telemetry,
    )
    leaves, treedef = tree_flatten(server.params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    t0 = time.perf_counter()
    for r in range(rounds):
        leaves = [
            x + update_scale * torch.randn(x.shape, generator=gen, device=dev,
                                           dtype=x.dtype)
            for x in leaves
        ]
        server.params = treedef.unflatten(leaves)
        with telemetry.span("round", round=r):
            server.broadcast(r)
            pool.sync_round(r)
    dt = time.perf_counter() - t0

    log = server.delta_log
    planner = pool.planner
    full_cost = log.full_nbytes()
    lag_report = {}
    beats_full = True
    for lag in range(1, min(horizon, log.head + 1) + 1):
        plan = planner.plan(log.head - lag)
        lag_report[str(lag)] = {
            "kind": plan.kind,
            "nbytes": plan.nbytes,
            "candidates": dict(plan.candidates),
        }
        beats_full &= plan.nbytes < full_cost
    pool.ledger.reconcile(rel=0.1)
    telemetry.metrics.ingest_ledger(pool.ledger)

    t = pool.totals()
    return {
        "n_subscribers": n_subscribers,
        "timed_rounds": rounds,
        "horizon": horizon,
        "n_params": log.n_params,
        "down_sparsity": down_sparsity,
        "periods": list(periods),
        "bytes_per_subscriber_per_round": t["bytes_per_subscriber_per_round"],
        "full_resync_bytes": full_cost,
        "bytes_saving_vs_full_resync": t["bytes_saving_vs_full_resync"],
        "down_bytes_total": t["down_bytes"],
        "catchup_beats_full_all_lags": bool(beats_full),
        "stack_bit_exact": bool(pool.verify_ok and pool.verified_syncs > 0),
        "ledger_reconciles": True,  # reconcile(rel=0.1) raised otherwise
        "plan_by_lag": lag_report,
        "rounds_per_sec": rounds / dt,
        "subscriber_syncs_per_sec": t["syncs"] / dt,
    }
