"""``python -m repro_torch.obs.view`` — pretty-print, validate, and diff
telemetry files (the regression-triage tool; counterpart of
``repro.obs.view``, the same logic).

  # summarize a metrics JSONL or a trace.json
  PYTHONPATH=src python -m repro_torch.obs.view run.metrics.jsonl

  # validate schema + span nesting
  PYTHONPATH=src python -m repro_torch.obs.view --check run.metrics.jsonl trace.json

  # diff two metric files (baseline vs fresh)
  PYTHONPATH=src python -m repro_torch.obs.view --diff old.metrics.jsonl new.metrics.jsonl

File kind is sniffed from the content (schema header vs ``traceEvents``),
not the extension.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Tuple

from repro_torch.obs.export import (
    SCHEMA,
    read_metrics_jsonl,
    read_trace_json,
    render_table,
)
from repro_torch.obs.metrics import validate_metric_events
from repro_torch.obs.trace import SPAN_NAMES


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.view",
        description="pretty-print / validate / diff telemetry files",
    )
    ap.add_argument("files", nargs="+", help="metrics JSONL or trace.json files")
    ap.add_argument("--check", action="store_true",
                    help="validate schema + span nesting; exit 1 on errors")
    ap.add_argument("--diff", action="store_true",
                    help="diff two metric files (per-name aggregate deltas)")
    return ap


def sniff(path: str) -> str:
    """'metrics' | 'trace', by content."""
    with open(path) as f:
        first = f.readline()
    try:
        head = json.loads(first)
    except json.JSONDecodeError:
        # trace.json is one JSON document; the first line may be a fragment
        return "trace"
    if isinstance(head, dict) and head.get("kind") == "metrics":
        return "metrics"
    if isinstance(head, dict) and "traceEvents" in head:
        return "trace"
    raise ValueError(f"{path}: neither a {SCHEMA} metrics JSONL nor a trace")


def _check_trace(path: str) -> List[str]:
    """Validate a Chrome trace: spans must nest (each tid's complete
    events form proper intervals) and carry the known span names."""
    events = read_trace_json(path)
    errs = []
    if not events:
        errs.append(f"{path}: empty traceEvents")
    open_stacks: Dict[tuple, list] = {}
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in ("X", "i"):
            errs.append(f"{path}: event {i} has unsupported ph {ph!r}")
            continue
        if "name" not in e or "ts" not in e:
            errs.append(f"{path}: event {i} missing name/ts")
            continue
        if ph == "X":
            if e.get("dur", -1) < 0:
                errs.append(f"{path}: span {e['name']} negative duration")
            if e["name"] not in SPAN_NAMES:
                errs.append(f"{path}: span name {e['name']!r} not in taxonomy")
    # nesting: within one (pid, tid), sorted complete spans must not
    # partially overlap — each pair is either disjoint or contained
    spans = sorted(
        (e for e in events if e.get("ph") == "X"),
        key=lambda e: (e.get("pid", 0), e.get("tid", 0), e["ts"]),
    )
    eps = 1.0
    for a, b in zip(spans, spans[1:]):
        if (a.get("pid"), a.get("tid")) != (b.get("pid"), b.get("tid")):
            continue
        a_end = a["ts"] + a["dur"]
        if b["ts"] < a_end - eps and b["ts"] + b["dur"] > a_end + eps:
            errs.append(
                f"{path}: spans {a['name']!r} and {b['name']!r} partially "
                "overlap (broken nesting)"
            )
    return errs


def _check_metrics(path: str) -> List[str]:
    try:
        _, events = read_metrics_jsonl(path)
    except ValueError as e:
        return [str(e)]
    return [f"{path}: {m}" for m in validate_metric_events(events)]


def check(paths: List[str]) -> int:
    n_errs = 0
    for path in paths:
        kind = sniff(path)
        errs = _check_trace(path) if kind == "trace" else _check_metrics(path)
        status = "OK" if not errs else f"{len(errs)} error(s)"
        print(f"[{kind}] {path}: {status}")
        for e in errs:
            print(f"  {e}")
        n_errs += len(errs)
    return 1 if n_errs else 0


def _aggregate(path: str) -> Dict[str, Tuple[int, float]]:
    """metric name -> (count, sum) for diffing."""
    _, events = read_metrics_jsonl(path)
    out: Dict[str, Tuple[int, float]] = {}
    for e in events:
        c, s = out.get(e["name"], (0, 0.0))
        out[e["name"]] = (c + 1, s + e["value"])
    return out


def diff(a_path: str, b_path: str) -> int:
    a, b = _aggregate(a_path), _aggregate(b_path)
    rows = []
    for name in sorted(set(a) | set(b)):
        ca, sa = a.get(name, (0, math.nan))
        cb, sb = b.get(name, (0, math.nan))
        if math.isnan(sa) or math.isnan(sb):
            delta = "only in " + (b_path if math.isnan(sa) else a_path)
        elif sa == sb:
            delta = "="
        else:
            rel = (sb - sa) / abs(sa) if sa else math.inf
            delta = f"{rel:+.1%}"
        rows.append((name, ca, round(sa, 3), cb, round(sb, 3), delta))
    print(render_table(
        ("metric", "n(a)", "sum(a)", "n(b)", "sum(b)", "delta"),
        rows, title=f"a = {a_path}\nb = {b_path}",
    ))
    return 0


def show(path: str) -> None:
    kind = sniff(path)
    if kind == "metrics":
        header, events = read_metrics_jsonl(path)
        agg: Dict[str, dict] = {}
        for e in events:
            a = agg.setdefault(
                e["name"],
                {"kind": e["kind"], "count": 0, "sum": 0.0,
                 "min": math.inf, "max": -math.inf, "last": e["value"]},
            )
            a["count"] += 1
            a["sum"] += e["value"]
            a["min"] = min(a["min"], e["value"])
            a["max"] = max(a["max"], e["value"])
            a["last"] = e["value"]
        rows = [
            (n, a["kind"], a["count"], round(a["min"], 3), round(a["max"], 3),
             round(a["sum"] if a["kind"] == "counter" else a["last"], 3))
            for n, a in sorted(agg.items())
        ]
        meta = {k: v for k, v in header.items() if k not in ("schema", "kind")}
        print(render_table(
            ("metric", "kind", "n", "min", "max", "total/last"),
            rows, title=f"{path}  {meta if meta else ''}".rstrip(),
        ))
    else:
        events = read_trace_json(path)
        agg2: Dict[str, List[float]] = {}
        for e in events:
            if e.get("ph") == "X":
                agg2.setdefault(e["name"], []).append(e["dur"])
        rows = [
            (n, len(d), round(sum(d) / len(d) / 1e3, 3), round(sum(d) / 1e3, 3))
            for n, d in sorted(agg2.items(), key=lambda kv: -sum(kv[1]))
        ]
        print(render_table(("span", "n", "mean ms", "total ms"),
                           rows, title=path))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.check:
        return check(args.files)
    if args.diff:
        if len(args.files) != 2:
            print("--diff needs exactly two metric files", file=sys.stderr)
            return 2
        return diff(args.files[0], args.files[1])
    for path in args.files:
        show(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
