"""Exporters: JSONL event logs, Chrome/Perfetto traces, console tables.

Counterpart of ``repro.obs.export``, the same code and the same
``repro-obs-v1`` files.  File formats (both validated by ``python -m
repro_torch.obs.view --check``, and by the reference's checker):

  * **metrics JSONL** — line 1 is the schema header
    ``{"schema": "repro-obs-v1", "kind": "metrics", ...}``; every
    following line is one metric event
    (``{"type": "metric", "kind", "name", "value", "tags"}``).
  * **trace JSON** — a Chrome Trace Event file (``{"traceEvents":
    [...]}``) loadable in ui.perfetto.dev or chrome://tracing; spans are
    complete events (``"ph": "X"``, µs timestamps).

``render_table`` is the one console-table helper every surface shares
(end-of-run summaries, ``repro_torch.obs.view``) — plain text, no
dependencies.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

SCHEMA = "repro-obs-v1"


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    if d:
        os.makedirs(d, exist_ok=True)


def write_metrics_jsonl(path: str, metrics, meta: Optional[dict] = None) -> str:
    """Write a registry's samples as schema-headed JSONL."""
    _ensure_dir(path)
    header = {"schema": SCHEMA, "kind": "metrics", **(meta or {})}
    with open(path, "w") as f:
        f.write(json.dumps(header) + "\n")
        for e in metrics.events():
            f.write(json.dumps(e) + "\n")
    return path


def read_metrics_jsonl(path: str) -> Tuple[dict, List[dict]]:
    """Read back a metrics JSONL; raises ValueError on a bad header."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty metrics file")
    header = json.loads(lines[0])
    if header.get("schema") != SCHEMA or header.get("kind") != "metrics":
        raise ValueError(
            f"{path}: bad header {header!r} (want schema={SCHEMA!r}, "
            "kind='metrics')"
        )
    return header, [json.loads(ln) for ln in lines[1:]]


def write_trace_json(path: str, tracer, meta: Optional[dict] = None) -> str:
    """Write a tracer's spans as a Perfetto-loadable trace.json."""
    _ensure_dir(path)
    with open(path, "w") as f:
        json.dump({
            "traceEvents": tracer.chrome_events(),
            "displayTimeUnit": "ms",
            "otherData": {"schema": SCHEMA, **(meta or {})},
        }, f)
    return path


def read_trace_json(path: str) -> List[dict]:
    """Read back a trace.json's traceEvents list."""
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents)")
    return doc["traceEvents"]


def render_table(headers: Sequence[str], rows: Sequence[Sequence],
                 title: Optional[str] = None) -> str:
    """Plain aligned console table (numbers right-aligned)."""
    cells = [[str(h) for h in headers]]
    numeric = [True] * len(headers)
    for row in rows:
        rendered = []
        for j, v in enumerate(row):
            if isinstance(v, float):
                rendered.append(f"{v:.3f}".rstrip("0").rstrip(".") or "0")
            else:
                rendered.append(str(v))
                if not isinstance(v, int):
                    numeric[j] = False
        cells.append(rendered)
    widths = [max(len(r[j]) for r in cells) for j in range(len(headers))]
    lines = []
    if title:
        lines.append(title)
    for i, r in enumerate(cells):
        line = "  ".join(
            c.rjust(widths[j]) if numeric[j] and i > 0 else c.ljust(widths[j])
            for j, c in enumerate(r)
        )
        lines.append(line.rstrip())
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    return "\n".join(lines)


def summary_table(metrics, top: int = 0) -> str:
    """The end-of-run console summary: one row per metric name."""
    summ = metrics.summary()
    rows = []
    for name in sorted(summ):
        a = summ[name]
        if a["kind"] == "counter":
            shown = a["sum"]
        elif a["kind"] == "hist":
            shown = a["mean"]
        else:
            shown = a["last"]
        rows.append((name, a["kind"], a["count"],
                     round(a["min"], 3), round(a["max"], 3), round(shown, 3)))
    if top:
        rows = rows[:top]
    return render_table(
        ("metric", "kind", "n", "min", "max", "total/last"),
        rows, title="telemetry summary",
    )


def span_table(tracer, max_rows: int = 0) -> str:
    """Aggregate span durations by name for the console summary."""
    agg: Dict[str, List[float]] = {}
    for e in tracer.events:
        if e.get("type") == "span":
            agg.setdefault(e["name"], []).append(e["dur_us"])
    rows = []
    for name in sorted(agg, key=lambda n: -sum(agg[n])):
        durs = agg[name]
        rows.append((name, len(durs),
                     round(sum(durs) / len(durs) / 1e3, 3),
                     round(sum(durs) / 1e3, 3)))
    if max_rows:
        rows = rows[:max_rows]
    return render_table(("span", "n", "mean ms", "total ms"),
                        rows, title="span summary")
