"""Per-round bandwidth ledger — bidirectional byte accounting.

Counterpart of ``repro.core.ledger``, copied as it is (plain Python).
Every channel backend meters its rounds here (DESIGN.md §12), so
measured-vs-Eq.1/Eq.5 accounting is uniform across backends.  Per
direction of the wire a round records

  * ``bytes``      — framed SBW1 buffer sizes that actually crossed the
                     "network" (transport view),
  * ``bits_measured`` — exact payload bits off the buffers, pre byte-padding
                     (what the reference's ``Wire.measured_bits`` meters;
                     the GSPMD backend Golomb-encodes the real per-shard
                     position streams instead),
  * ``bits_analytic`` — the Eq. 1 sum of per-leaf ``nbits`` from the codecs
                     (Golomb positions priced by Eq. 5's expectation).

The federated backend records real per-client buffers both directions; the
local and GSPMD backends meter client 0's upload and extrapolate ×C (every
client's analytic size is identical — shapes and rates are static — and
their measured sizes are one geometric draw each), and their "downstream"
is the in-process aggregate, so the down direction records zero traffic
and reconciles trivially.

``reconcile`` asserts measured ≈ analytic on every round in both
directions: Eq. 5 is the expectation over geometric position gaps while the
bitstream is one draw, so they agree only within Golomb rounding — the same
tolerance the reference's codec tests use for the upstream wire.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class RoundRecord:
    """One communication round's traffic, both directions.

    Upstream numbers are summed over the participating clients; downstream
    numbers are per-recipient (one broadcast buffer) times
    ``down_recipients``.
    """

    round: int
    cohort: Tuple[int, ...]
    up_bytes: int
    up_bits_measured: float
    up_bits_analytic: float
    down_bytes: int
    down_bits_measured: float
    down_bits_analytic: float
    down_recipients: int
    # bytes clients sent that the server never aggregated — aborted
    # (straggler) uploads and corrupt buffers the decode rejected.  Kept
    # OUT of up_bytes/up_bits_* so measured-vs-Eq.1/Eq.5 reconcile still
    # balances in rounds with dropouts: the accepted-traffic columns
    # account only for accepted traffic, and the waste is metered here.
    up_bytes_wasted: int = 0

    @property
    def total_bytes(self) -> int:
        return self.up_bytes + self.down_bytes


class BandwidthLedger:
    """Accumulates :class:`RoundRecord` rows and reconciles them with the
    analytic Eq. 1/Eq. 5 prediction."""

    def __init__(self) -> None:
        self.records: List[RoundRecord] = []

    def record(self, rec: RoundRecord) -> None:
        self.records.append(rec)

    def record_up(
        self,
        round_idx: int,
        *,
        clients: Tuple[int, ...],
        up_bytes: int,
        up_bits_measured: float,
        up_bits_analytic: float,
    ) -> None:
        """Upload-only round row — how the local and GSPMD channels meter
        (their aggregate never crosses a wire, so down traffic is zero)."""
        self.record(RoundRecord(
            round=round_idx,
            cohort=tuple(clients),
            up_bytes=up_bytes,
            up_bits_measured=up_bits_measured,
            up_bits_analytic=up_bits_analytic,
            down_bytes=0,
            down_bits_measured=0.0,
            down_bits_analytic=0.0,
            down_recipients=0,
        ))

    # ------------------------------------------------------------- queries

    def totals(self) -> dict:
        """Summed traffic over all recorded rounds."""
        out = {
            "rounds": len(self.records),
            "up_bytes": sum(r.up_bytes for r in self.records),
            "down_bytes": sum(r.down_bytes for r in self.records),
            "up_bytes_wasted": sum(r.up_bytes_wasted for r in self.records),
            "up_bits_measured": sum(r.up_bits_measured for r in self.records),
            "up_bits_analytic": sum(r.up_bits_analytic for r in self.records),
            "down_bits_measured": sum(r.down_bits_measured for r in self.records),
            "down_bits_analytic": sum(r.down_bits_analytic for r in self.records),
        }
        out["total_bytes"] = out["up_bytes"] + out["down_bytes"]
        return out

    def reconcile(self, rel: float = 0.1) -> None:
        """Assert measured-vs-analytic parity per round, both directions.

        ``rel`` bounds |measured − analytic| / analytic; Golomb position
        streams are one geometric draw against Eq. 5's expectation, so a few
        percent of slack is expected at paper-scale tensors and more on tiny
        test leaves.  Zero-traffic directions (e.g. dense-free skip rounds)
        reconcile trivially.

        Rounds with dropouts balance because the ``up_*`` columns meter
        ACCEPTED uploads only: bytes from clients that missed the straggler
        deadline or whose buffers failed decode live in ``up_bytes_wasted``
        and are never compared against the Eq. 1 prediction (which, like
        the aggregation itself, covers only the survivors).
        """
        for r in self.records:
            for side in ("up", "down"):
                measured = getattr(r, f"{side}_bits_measured")
                analytic = getattr(r, f"{side}_bits_analytic")
                if analytic == 0 and measured == 0:
                    continue
                err = abs(measured - analytic) / max(abs(analytic), 1e-9)
                if err > rel:
                    raise AssertionError(
                        f"round {r.round} {side}stream: measured "
                        f"{measured:.0f} bits vs analytic {analytic:.0f} "
                        f"(rel err {err:.3f} > {rel})"
                    )

    def history(self) -> dict:
        """Column-major view for JSON dumps / plotting."""
        cols = ("up_bytes", "down_bytes", "up_bytes_wasted",
                "up_bits_measured", "up_bits_analytic",
                "down_bits_measured", "down_bits_analytic")
        out = {c: [getattr(r, c) for r in self.records] for c in cols}
        out["round"] = [r.round for r in self.records]
        out["cohort_size"] = [len(r.cohort) for r in self.records]
        return out
