"""Round scheduling: sync and async/stale federated rounds (DESIGN.md §9).

Counterpart of ``repro.fed.scheduler``.  A :class:`RoundScheduler` wires a
:class:`~repro_torch.fed.server.ParameterServer` to a
:class:`~repro_torch.fed.clients.ClientPool` through a
:class:`~repro_torch.core.channel.FedWireChannel` (the channel owns the
compress → pack → decode → aggregate → broadcast → meter loop; the
scheduler owns *time*: cohort sampling and replica staleness) and drives
communication rounds:

  sync    every cohort member trains from the CURRENT broadcast replica Ŵ;
          the server aggregates with ``mean``/``weighted``.
  async   sampled members start from stale replicas Ŵ_{r−s} (s drawn
          uniformly from [0, max_staleness] by ``default_rng([seed, r,
          7])``, as in the reference) — clients whose round trip spans
          several server rounds.  Pair with the server's ``staleness``
          aggregator.

Every round is metered both directions in the channel's
:class:`~repro_torch.core.ledger.BandwidthLedger`.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.channel import FedWireChannel
from repro_torch.core.tree import tree_map
from repro_torch.fed.clients import ClientPool
from repro_torch.fed.faults import FaultSchedule, ServerKilled
from repro_torch.fed.server import ParameterServer

PyTree = Any


@dataclasses.dataclass(eq=False)
class RoundScheduler:
    server: ParameterServer
    pool: ClientPool
    cohort_size: int
    mode: str = "sync"  # "sync" | "async"
    max_staleness: int = 0
    seed: int = 0
    # elasticity (DESIGN.md §14): abort uploads whose simulated duration
    # profile.delay × fault-slowdown exceeds the timeout; inject the
    # seeded fault schedule (None → failure-free)
    straggler_timeout: Optional[float] = None
    faults: Optional[FaultSchedule] = None

    def __post_init__(self) -> None:
        if self.mode not in ("sync", "async"):
            raise ValueError(f"mode must be 'sync' or 'async', got {self.mode!r}")
        if self.mode == "sync":
            self.max_staleness = 0
        self.channel = FedWireChannel(server=self.server, pool=self.pool)
        # ring of past replicas Ŵ_{r−s}; entries are never written in place
        self._snapshots: deque = deque(maxlen=self.max_staleness + 1)
        # rejoin bookkeeping: the round each client last downloaded a
        # replica, and the round of its last FAILED participation (cleared
        # on success) — a rejoining failed client re-enters at staleness
        # round − last_download instead of the random draw
        self._last_download: Dict[int, int] = {}
        self._failed: Dict[int, int] = {}
        # kill_server faults fire ONCE: the fired set is checkpointed, so
        # a resumed run sails past the kill that produced its checkpoint
        self._kills_fired: Set[Tuple[int, str]] = set()
        self.channel.init_state()

    @property
    def ledger(self):
        """The channel's bandwidth ledger."""
        return self.channel.ledger

    # ------------------------------------------------------------ one round

    def step(self, round_idx: int) -> dict:
        """Sample a cohort, pick (possibly stale) starts, and hand the
        round to the wire channel.

        With a fault schedule: dropped clients are excluded before download
        (their pool state stays put); a scheduled server kill raises
        :class:`ServerKilled` at the round boundary (``pre_round``) or
        mid-round after aggregation (``post_aggregate``; finish it with
        :meth:`resume_pending` after restoring a checkpoint)."""
        kill = None
        if self.faults is not None:
            kill = self.faults.kill_at(round_idx)
            if kill is not None:
                if (round_idx, kill) in self._kills_fired:
                    kill = None  # resumed past this kill already
                else:
                    self._kills_fired.add((round_idx, kill))
                    if kill == "pre_round":
                        raise ServerKilled(round_idx, "pre_round")

        self._snapshots.appendleft(self.server.estimate)
        cohort = self.pool.sample_cohort(round_idx, self.cohort_size)
        dropped = (self.faults.drops_at(round_idx) if self.faults is not None
                   else frozenset())
        dropped = sorted(dropped & {int(c) for c in cohort})
        participants = np.asarray([c for c in cohort if int(c) not in set(dropped)], np.int64)
        staleness = self._draw_staleness(round_idx, participants.size)
        if self.mode == "async" and self._failed:
            # rejoin: a client whose LAST attempt failed still holds the
            # replica of its last successful download — its true staleness
            # (capped by the ring) overrides the random draw
            cap = min(self.max_staleness, len(self._snapshots) - 1)
            for j, cid in enumerate(participants):
                if int(cid) in self._failed:
                    last_dl = self._last_download.get(int(cid))
                    s = cap if last_dl is None else min(round_idx - last_dl, cap)
                    staleness[j] = max(0, s)
        # every participant downloads a replica at round start (stragglers
        # and corrupt uploads included: their DOWNLOAD is real)
        for cid in dropped:
            self._failed[int(cid)] = round_idx
        for cid in participants:
            self._last_download[int(cid)] = round_idx

        if self.mode == "sync" or participants.size == 0:
            start = self.server.estimate  # shared: everyone pulls Ŵ_r
        else:
            start = tree_map(lambda *leaves: torch.stack(leaves),
                             *[self._snapshots[s] for s in staleness])

        m = self.channel.round_exchange(
            round_idx, participants, start, staleness,
            faults=self.faults, straggler_timeout=self.straggler_timeout,
            kill_step=kill,
        )
        m["dropped"] = dropped
        self._bookkeep_failures(round_idx, m)
        return m

    def _bookkeep_failures(self, round_idx: int, m: dict) -> None:
        for cid in m.get("stragglers", ()) or ():
            self._failed[int(cid)] = round_idx
        for cid in m.get("rejected", ()) or ():
            self._failed[int(cid)] = round_idx
        for cid in m.get("accepted", ()) or ():
            self._failed.pop(int(cid), None)

    def resume_pending(self) -> Optional[dict]:
        """Finish a round interrupted by a ``post_aggregate`` kill (the
        aggregated-but-unbroadcast half survives checkpoint/restore in
        ``channel._pending``).  Returns the round metrics, or None when
        nothing is pending."""
        pending = self.channel._pending
        if pending is None:
            return None
        m = self.channel._finish_round(pending)
        m["dropped"] = sorted(self.faults.drops_at(m["round"]) if self.faults is not None
                              else ())
        self._bookkeep_failures(m["round"], m)
        return m

    # ------------------------------------------------------------- full run

    def run(self, n_rounds: int, log_every: int = 0, start_round: int = 0) -> dict:
        """Drive rounds ``start_round..n_rounds−1``; returns a column-major
        history merged with the ledger's byte accounting.  A resumed run
        passes ``start_round`` = the next round its checkpoint owes (after
        :meth:`resume_pending` for mid-round checkpoints)."""
        hist: dict = {"round": [], "loss": [], "update_norm": [], "mean_staleness": []}
        for r in range(start_round, n_rounds):
            m = self.step(r)
            hist["round"].append(r)
            hist["loss"].append(m["loss"])
            hist["update_norm"].append(m["update_norm"])
            hist["mean_staleness"].append(float(np.mean(m["staleness"])))
            if log_every and (r + 1) % log_every == 0:
                t = self.ledger.totals()
                print(f"round {r+1:4d}  loss {m['loss']:.4f}  "
                      f"up {t['up_bytes']/1e3:.1f} kB  down {t['down_bytes']/1e3:.1f} kB")
        hist.update({f"wire_{k}": v for k, v in self.ledger.history().items()})
        hist.update(self.ledger.totals())
        return hist

    # ------------------------------------------------------------- plumbing

    def _draw_staleness(self, round_idx: int, k: int) -> np.ndarray:
        if self.mode == "sync" or self.max_staleness == 0:
            return np.zeros((k,), np.int64)
        cap = min(self.max_staleness, len(self._snapshots) - 1)
        rng = np.random.default_rng([self.seed, round_idx, 7])
        return rng.integers(0, cap + 1, size=k)
