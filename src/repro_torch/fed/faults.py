"""Deterministic fault injection for the federated backend (DESIGN.md §14).

A copy of the reference's ``repro.fed.faults`` (numpy only), so one
schedule names the same faults in both packages and
:meth:`FaultSchedule.corrupt_blob` damages an upload to the same bytes.

Elasticity claims are bit-level claims in an error-feedback system: a
client that misses a round must leave its residual/momentum EXACTLY as it
was, partial aggregation must equal the survivors-only aggregation, and a
server resumed mid-round must continue bit-identically.  So faults here
are *data*, not chance: a frozen, seeded :class:`FaultSchedule` names
exactly which client fails how in which round.

Four fault kinds:

  drop      (round, client) — the client is offline for the round: it is
            excluded before download, sends nothing, costs nothing, and
            its pool state is untouched.
  slow      (round, client, slowdown) — the client's simulated round
            duration is ``profile.delay × slowdown`` time units; with a
            scheduler ``straggler_timeout`` set, durations above the
            timeout abort the upload (work done, bytes wasted, state
            rolled back).
  corrupt   (round, client) — the upload is damaged in flight
            (:meth:`FaultSchedule.corrupt_blob`: seeded truncation + byte
            flips); the server's decode rejects it, aggregation proceeds
            over the survivors, and the sender's state is rolled back.
  kill_server  (round, step) — the server process dies at ``step``
            ("pre_round": at the round boundary, before any work;
            "post_aggregate": mid-round, after partial aggregation but
            before the broadcast), raising :class:`ServerKilled` for the
            caller to checkpoint and resume against.

The schedule is JSON round-trippable (``to_json`` / ``from_json`` /
``parse``) so ``--faults`` can take an inline object or a committed file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, FrozenSet, Optional, Tuple

import numpy as np

KILL_STEPS = ("pre_round", "post_aggregate")


class ServerKilled(RuntimeError):
    """Raised when a ``kill_server`` fault fires.  Carries the round and
    step so the caller knows what checkpoint state to expect."""

    def __init__(self, round_idx: int, step: str) -> None:
        super().__init__(
            f"server killed at round {round_idx} ({step}); checkpoint and "
            "resume via repro_torch.fed.checkpoint"
        )
        self.round_idx = int(round_idx)
        self.step = step


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A frozen, seeded schedule of injected faults.

    ``drops``/``corrupt`` are (round, client) pairs, ``slow`` is
    (round, client, slowdown) triples, ``kill_server`` is (round, step)
    pairs with step in :data:`KILL_STEPS`.  ``seed`` feeds
    :meth:`corrupt_blob`'s byte damage (per (seed, round, client), so two
    runs of the same schedule corrupt identically).
    """

    seed: int = 0
    drops: Tuple[Tuple[int, int], ...] = ()
    slow: Tuple[Tuple[int, int, float], ...] = ()
    corrupt: Tuple[Tuple[int, int], ...] = ()
    kill_server: Tuple[Tuple[int, str], ...] = ()

    def __post_init__(self) -> None:
        # normalize JSON-born lists into hashable tuples, validating as we go
        object.__setattr__(self, "drops", tuple(
            (int(r), int(c)) for r, c in self.drops
        ))
        object.__setattr__(self, "slow", tuple(
            (int(r), int(c), float(s)) for r, c, s in self.slow
        ))
        for r, c, s in self.slow:
            if s < 1.0:
                raise ValueError(f"slowdown must be >= 1, got {s} at round {r}")
        object.__setattr__(self, "corrupt", tuple(
            (int(r), int(c)) for r, c in self.corrupt
        ))
        kills = tuple((int(r), str(step)) for r, step in self.kill_server)
        for r, step in kills:
            if step not in KILL_STEPS:
                raise ValueError(
                    f"unknown kill_server step {step!r}; have {KILL_STEPS}"
                )
        rounds = [r for r, _ in kills]
        if len(set(rounds)) != len(rounds):
            raise ValueError("at most one kill_server fault per round")
        object.__setattr__(self, "kill_server", kills)

    # ------------------------------------------------------------- queries

    def drops_at(self, round_idx: int) -> FrozenSet[int]:
        return frozenset(c for r, c in self.drops if r == round_idx)

    def corrupts_at(self, round_idx: int) -> FrozenSet[int]:
        return frozenset(c for r, c in self.corrupt if r == round_idx)

    def slowdown_of(self, round_idx: int, client_id: int) -> float:
        """Simulated duration multiplier for one client this round (1.0
        when no ``slow`` fault names it)."""
        out = 1.0
        for r, c, s in self.slow:
            if r == round_idx and c == client_id:
                out = max(out, s)
        return out

    def kill_at(self, round_idx: int) -> Optional[str]:
        """The kill step scheduled for this round, or None."""
        for r, step in self.kill_server:
            if r == round_idx:
                return step
        return None

    def last_round(self) -> int:
        """Highest round any fault names (−1 for an empty schedule)."""
        rounds = (
            [r for r, _ in self.drops] + [r for r, _, _ in self.slow]
            + [r for r, _ in self.corrupt] + [r for r, _ in self.kill_server]
        )
        return max(rounds) if rounds else -1

    # ------------------------------------------------------ blob corruption

    def corrupt_blob(self, blob: bytes, round_idx: int, client_id: int) -> bytes:
        """Damage one upload buffer deterministically: truncate somewhere
        past the magic (a truncated SBW1 read always trips a length check
        → the server MUST reject it) and flip a few surviving bytes (the
        ``test_wire_fuzz`` hardening surface).  Seeded per
        (schedule seed, round, client)."""
        if len(blob) < 8:
            return b""  # nothing meaningful to keep
        rng = np.random.default_rng([self.seed, round_idx, client_id, 0xFA])
        cut = int(rng.integers(4, len(blob)))  # always loses >= 1 byte
        out = bytearray(blob[:cut])
        for pos in rng.integers(0, max(cut, 1), size=int(rng.integers(1, 4))):
            out[int(pos)] ^= int(rng.integers(1, 256))
        return bytes(out)

    # ------------------------------------------------------------ (de)spec

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(dataclasses.asdict(self), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        data = json.loads(text)
        if not isinstance(data, dict):
            raise ValueError(
                f"FaultSchedule JSON must be an object, got {type(data)}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(
                f"unknown FaultSchedule fields {sorted(unknown)}; "
                f"have {sorted(known)}"
            )
        return cls(**data)

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """``--faults`` surface: an inline JSON object or a path to one."""
        text = spec
        if not spec.lstrip().startswith("{"):
            if not os.path.exists(spec):
                raise ValueError(
                    f"--faults wants inline JSON or a file path; {spec!r} "
                    "is neither"
                )
            with open(spec) as f:
                text = f.read()
        return cls.from_json(text)


#: the schedule that injects nothing — the failure-free reference
NO_FAULTS = FaultSchedule()


def straggler_ids(
    schedule: Optional[FaultSchedule],
    round_idx: int,
    ids,
    delays: Dict[int, int],
    timeout: Optional[float],
) -> FrozenSet[int]:
    """Clients whose simulated duration ``delay × slowdown`` exceeds the
    straggler timeout this round (empty without a timeout)."""
    if timeout is None:
        return frozenset()
    sched = schedule if schedule is not None else NO_FAULTS
    return frozenset(
        int(c) for c in ids
        if delays[int(c)] * sched.slowdown_of(round_idx, int(c)) > timeout
    )
