"""Compression-aware metrics: counters, gauges, histograms.

Counterpart of ``repro.obs.metrics``, the same code.  A
:class:`MetricsRegistry` collects *samples* — ``(kind, name, value,
tags)`` rows — from the channel layer and the run loop, and aggregates
them on demand.  Names are declared up front in :data:`METRIC_NAMES`, a
copy of the reference's whole table (so the files of either package pass
the other's checker; ``tests/test_torch_obs.py`` holds the two equal);
recording an undeclared name raises, so metric names cannot drift
silently.

Bit-exactness contract: :meth:`MetricsRegistry.ingest_ledger` copies the
:class:`~repro_torch.core.ledger.RoundRecord` fields verbatim — the
per-round ``wire/*`` gauges sum to exactly ``ledger.totals()`` (asserted
at ingest time), so the telemetry file can stand in for the ledger in
offline triage.

Like the tracer, the registry is dependency-free; :data:`NULL_METRICS`
is the no-op twin used when telemetry is disabled.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

# name -> (kind, description): the reference's table, whole; the fed
# backend records the fed names, serve/broadcast.py the serve names.
METRIC_NAMES: Dict[str, Tuple[str, str]] = {
    # ---- wire accounting (one sample per round, straight off the ledger)
    "wire/up_bytes": ("gauge", "framed upstream SBW1 bytes this round"),
    "wire/up_bits_measured": ("gauge", "exact upstream payload bits (pre-padding)"),
    "wire/up_bits_analytic": ("gauge", "Eq. 1 upstream bits (Golomb priced by Eq. 5)"),
    "wire/up_bytes_wasted": (
        "gauge",
        "upstream bytes the server never aggregated this round (aborted "
        "straggler uploads + corrupt buffers rejected at decode)",
    ),
    "wire/down_bytes": ("gauge", "framed downstream bytes this round"),
    "wire/down_bits_measured": ("gauge", "exact downstream payload bits"),
    "wire/down_bits_analytic": ("gauge", "Eq. 1/Eq. 5 downstream bits"),
    "wire/own_client0_bits_measured": (
        "gauge",
        "host-metered Golomb bits of client 0's shard streams (gspmd; "
        "a 1-client sample, not the cohort sum — see docs/wire-format.md)",
    ),
    "wire/client_bits_measured": (
        "gauge",
        "exact packed wire bits of one client's upload, from the "
        "device-side select→pack kernels (gspmd with --device-pack; "
        "one sample per client per round, tag: client)",
    ),
    # ---- per-leaf compression plan (static per resolved policy)
    "leaf/n": ("gauge", "leaf parameter count (tag: leaf)"),
    "leaf/k": ("gauge", "selected coordinates k = max(1, round(p*n)) (tag: leaf)"),
    "leaf/rate": ("gauge", "resolved per-leaf sparsity rate p (tag: leaf)"),
    "leaf/golomb_bits_pos": (
        "gauge", "Eq. 5 expected Golomb bits per position at rate p (tag: leaf)",
    ),
    # ---- training trajectory
    "train/loss": ("gauge", "mean client loss this round"),
    "train/bits_per_client": ("gauge", "analytic upstream bits per client"),
    "train/residual_norm": ("gauge", "global L2 norm of the error-feedback residual"),
    "train/step_ms": ("gauge", "wall-clock round time (tag: phase=compile|steady)"),
    # ---- federated cohort structure
    "fed/cohort_size": ("gauge", "participating clients this round"),
    "fed/lag_class": ("hist", "subscriber lag (rounds behind) at sync time"),
    # ---- serve-side catch-up planning
    "serve/plan_bytes": ("gauge", "chosen catch-up plan bytes (tags: lag, kind)"),
    "serve/verify_ok": ("counter", "bit-exactness verifications passed"),
    # ---- meta
    "obs/rounds": ("counter", "rounds ingested into this registry"),
}


class MetricsRegistry:
    """Append-only sample store with declared names and typed aggregation."""

    enabled = True

    def __init__(self) -> None:
        self.samples: List[dict] = []

    # ------------------------------------------------------------ recording

    def _record(self, kind: str, name: str, value: float, tags: dict) -> None:
        declared = METRIC_NAMES.get(name)
        if declared is None:
            raise KeyError(
                f"metric {name!r} not declared in METRIC_NAMES (the "
                "reference's repro-obs-v1 names)"
            )
        if declared[0] != kind:
            raise TypeError(
                f"metric {name!r} is declared as a {declared[0]}, "
                f"recorded as a {kind}"
            )
        self.samples.append(
            {"kind": kind, "name": name, "value": float(value), "tags": tags}
        )

    def counter(self, name: str, value: float = 1.0, **tags: Any) -> None:
        self._record("counter", name, value, tags)

    def gauge(self, name: str, value: float, **tags: Any) -> None:
        self._record("gauge", name, value, tags)

    def hist(self, name: str, value: float, **tags: Any) -> None:
        self._record("hist", name, value, tags)

    def ingest_ledger(self, ledger) -> None:
        """Copy every :class:`RoundRecord` into per-round ``wire/*`` gauges,
        verbatim — then assert the copies sum back to ``ledger.totals()``
        bit-exactly (the telemetry file must be able to stand in for the
        ledger)."""
        for rec in ledger.records:
            t = {"round": rec.round}
            self.gauge("wire/up_bytes", rec.up_bytes, **t)
            self.gauge("wire/up_bits_measured", rec.up_bits_measured, **t)
            self.gauge("wire/up_bits_analytic", rec.up_bits_analytic, **t)
            self.gauge("wire/up_bytes_wasted", rec.up_bytes_wasted, **t)
            self.gauge("wire/down_bytes", rec.down_bytes, **t)
            self.gauge("wire/down_bits_measured", rec.down_bits_measured, **t)
            self.gauge("wire/down_bits_analytic", rec.down_bits_analytic, **t)
            self.counter("obs/rounds")
        totals = ledger.totals()
        for col in ("up_bytes", "up_bits_measured", "up_bits_analytic",
                    "up_bytes_wasted", "down_bytes", "down_bits_measured",
                    "down_bits_analytic"):
            # plain sequential sum, NOT fsum: bit-exact against the
            # ledger's own totals() means same addends, same order, same
            # float summation
            mine = sum(
                s["value"] for s in self.samples if s["name"] == f"wire/{col}"
            )
            if mine != float(totals[col]):
                raise AssertionError(
                    f"telemetry wire/{col} gauges sum to {mine!r} but the "
                    f"ledger total is {totals[col]!r} (not bit-exact)"
                )

    # ----------------------------------------------------------- aggregation

    def series(self, name: str) -> List[dict]:
        return [s for s in self.samples if s["name"] == name]

    def summary(self) -> Dict[str, dict]:
        """Aggregate by metric name: counters sum; gauges keep first/last/
        count; histograms get count/min/max/mean."""
        out: Dict[str, dict] = {}
        for s in self.samples:
            name, kind, v = s["name"], s["kind"], s["value"]
            agg = out.setdefault(
                name, {"kind": kind, "count": 0, "sum": 0.0,
                       "min": math.inf, "max": -math.inf,
                       "first": v, "last": v},
            )
            agg["count"] += 1
            agg["sum"] += v
            agg["min"] = min(agg["min"], v)
            agg["max"] = max(agg["max"], v)
            agg["last"] = v
        for agg in out.values():
            agg["mean"] = agg["sum"] / agg["count"]
        return out

    def events(self) -> List[dict]:
        """The JSONL body (one event dict per sample)."""
        return [dict(type="metric", **s) for s in self.samples]


class NullMetrics:
    """No-op twin of :class:`MetricsRegistry` for disabled telemetry."""

    enabled = False
    samples: tuple = ()

    __slots__ = ()

    def counter(self, name: str, value: float = 1.0, **tags: Any) -> None:
        return None

    def gauge(self, name: str, value: float, **tags: Any) -> None:
        return None

    def hist(self, name: str, value: float, **tags: Any) -> None:
        return None

    def ingest_ledger(self, ledger) -> None:
        return None

    def series(self, name: str) -> list:
        return []

    def summary(self) -> dict:
        return {}

    def events(self) -> list:
        return []


NULL_METRICS = NullMetrics()


def validate_metric_events(events: List[dict]) -> List[str]:
    """Schema checks on exported metric events; returns error strings."""
    errs: List[str] = []
    for i, e in enumerate(events):
        if e.get("type") != "metric":
            errs.append(f"event {i}: unknown metric event type {e.get('type')!r}")
            continue
        name = e.get("name")
        declared = METRIC_NAMES.get(name)
        if declared is None:
            errs.append(f"event {i}: metric name {name!r} not in METRIC_NAMES")
        elif e.get("kind") != declared[0]:
            errs.append(
                f"event {i}: {name} recorded as {e.get('kind')!r}, "
                f"declared {declared[0]!r}"
            )
        if not isinstance(e.get("value"), (int, float)):
            errs.append(f"event {i}: non-numeric value {e.get('value')!r}")
        if not isinstance(e.get("tags"), dict):
            errs.append(f"event {i}: tags must be a dict")
    return errs
