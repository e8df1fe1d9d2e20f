"""repro_torch.obs — the telemetry layer (tracing + metrics + export).

Counterpart of ``repro.obs``.  One :class:`Telemetry` value bundles a
tracer and a metrics registry and travels through the stack:
``build_run`` attaches it to the run and to its channel (every channel
carries ``NULL_TELEMETRY`` until someone enables it), and the exporters
in :mod:`repro_torch.obs.export` turn it into a ``repro-obs-v1`` metrics
JSONL + a Perfetto ``trace.json`` at the end of the run, files that the
reference's ``python -m repro.obs.view --check`` accepts.

Disabled telemetry is the shared :data:`NULL_TELEMETRY` singleton — all
no-ops, identity ``fence`` (no added device synchronization).
"""
from __future__ import annotations

import dataclasses

from repro_torch.obs.export import (
    SCHEMA,
    render_table,
    span_table,
    summary_table,
    write_metrics_jsonl,
    write_trace_json,
)
from repro_torch.obs.metrics import (
    METRIC_NAMES,
    MetricsRegistry,
    NULL_METRICS,
    NullMetrics,
    validate_metric_events,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    NullTracer,
    SPAN_NAMES,
    Tracer,
    validate_span_events,
)


@dataclasses.dataclass(frozen=True)
class Telemetry:
    """Tracer + metrics registry, passed around as one handle."""

    tracer: object = NULL_TRACER
    metrics: object = NULL_METRICS

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics.enabled

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def fence(self, x):
        return self.tracer.fence(x)


NULL_TELEMETRY = Telemetry()


def make_telemetry() -> Telemetry:
    """A fresh enabled bundle (one per run)."""
    return Telemetry(tracer=Tracer(), metrics=MetricsRegistry())


def finish_run(telemetry: Telemetry, trace: str = None,
               metrics_out: str = None, meta: dict = None,
               print_summary: bool = True) -> dict:
    """End-of-run export: write the requested files, print the console
    summary tables (unless ``print_summary`` is False).  The one epilogue
    every launcher shares."""
    out = {}
    if not telemetry.enabled:
        return out
    if print_summary:
        if telemetry.tracer.events:
            print(span_table(telemetry.tracer))
        if telemetry.metrics.samples:
            print(summary_table(telemetry.metrics))
    if trace:
        out["trace"] = write_trace_json(trace, telemetry.tracer, meta=meta)
        print(f"wrote {out['trace']} (load in ui.perfetto.dev)")
    if metrics_out:
        out["metrics"] = write_metrics_jsonl(
            metrics_out, telemetry.metrics, meta=meta
        )
        print(f"wrote {out['metrics']}")
    return out


__all__ = [
    "METRIC_NAMES",
    "MetricsRegistry",
    "NULL_METRICS",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullMetrics",
    "NullTracer",
    "SCHEMA",
    "SPAN_NAMES",
    "Telemetry",
    "Tracer",
    "finish_run",
    "make_telemetry",
    "render_table",
    "span_table",
    "summary_table",
    "validate_metric_events",
    "validate_span_events",
    "write_metrics_jsonl",
    "write_trace_json",
]
