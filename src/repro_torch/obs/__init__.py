"""repro_torch.obs — the telemetry layer (tracing + metrics + export).

Counterpart of ``repro.obs``.  One :class:`Telemetry` value bundles a
tracer, a metrics registry and the port's own stage clock
(:mod:`repro_torch.obs.stages`: device-timed stages of the GSPMD train
step and its flat exchange, which the reference has not) and travels
through the stack:
``build_run`` attaches it to the run and to its channel (every channel
carries ``NULL_TELEMETRY`` until someone enables it), and the exporters
in :mod:`repro_torch.obs.export` turn it into a ``repro-obs-v1`` metrics
JSONL + a Perfetto ``trace.json`` at the end of the run, files that the
reference's ``python -m repro.obs.view --check`` accepts.

Disabled telemetry is the shared :data:`NULL_TELEMETRY` singleton — all
no-ops, identity ``fence`` (no added device synchronization).  The stage
clock never synchronises, on or off.
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
from repro_torch.obs.stages import (
    NULL_STAGES,
    NullStages,
    STAGE_NAMES,
    StageClock,
    stage_table,
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
    """Tracer + metrics registry + stage clock, passed around as one
    handle."""

    tracer: object = NULL_TRACER
    metrics: object = NULL_METRICS
    stages: object = NULL_STAGES

    @property
    def enabled(self) -> bool:
        return self.tracer.enabled or self.metrics.enabled or self.stages.enabled

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def fence(self, x):
        return self.tracer.fence(x)


NULL_TELEMETRY = Telemetry()


def make_telemetry(device=None) -> Telemetry:
    """A fresh enabled bundle (one per run); its stage clock records CUDA
    events on ``device`` when that is a CUDA device."""
    return Telemetry(tracer=Tracer(), metrics=MetricsRegistry(), stages=StageClock(device))


def finish_run(telemetry: Telemetry, trace: str = None,
               metrics_out: str = None, meta: dict = None,
               print_summary: bool = True) -> dict:
    """End-of-run export: write the requested files, print the console
    summary tables (unless ``print_summary`` is False; the stage table
    holds the rounds the clock has drained).  The one epilogue every
    launcher shares."""
    out = {}
    if not telemetry.enabled:
        return out
    if print_summary:
        if telemetry.tracer.events:
            print(span_table(telemetry.tracer))
        if telemetry.metrics.samples:
            print(summary_table(telemetry.metrics))
        if telemetry.stages.summary():
            print(stage_table(telemetry.stages))
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
    "NULL_STAGES",
    "NULL_TELEMETRY",
    "NULL_TRACER",
    "NullMetrics",
    "NullStages",
    "NullTracer",
    "SCHEMA",
    "SPAN_NAMES",
    "STAGE_NAMES",
    "StageClock",
    "Telemetry",
    "Tracer",
    "finish_run",
    "make_telemetry",
    "render_table",
    "span_table",
    "stage_table",
    "summary_table",
    "validate_metric_events",
    "validate_span_events",
    "write_metrics_jsonl",
    "write_trace_json",
]
