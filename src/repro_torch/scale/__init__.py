"""repro_torch.scale: the billion-parameter planner (DESIGN.md §15).

Counterpart of ``repro.scale``.  Prices the paper's communication model
at production scale without production hardware: an analytic cost model
reconciled bit for bit with the measured ledger on small configs, and
carried through ``meta``-device leaves to the zoo's 20-400B tier.
``--mode dryrun`` and ``analytic`` need no card; a ``real`` run takes
``--device`` (default the card, ``cpu`` for the plain versions).

  PYTHONPATH=src python -m repro_torch.scale --all --device cpu
  PYTHONPATH=src python -m repro_torch.scale --config gemma3_1b --mode analytic
  PYTHONPATH=src python -m repro_torch.scale --config mixtral_8x7b --policy-grid
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.scale import costs, planner
from repro_torch.scale.costs import CostReport, StubMesh, price
from repro_torch.scale.planner import (ALL_ARCHS, DEFAULT_BUDGET_MB, SCHEMA, classify, plan,
                                       plan_analytic, plan_dryrun, plan_real, plan_zoo,
                                       policy_for)

__all__ = [
    "costs", "planner", "CostReport", "StubMesh", "price", "ALL_ARCHS",
    "DEFAULT_BUDGET_MB", "SCHEMA", "classify", "plan", "plan_analytic",
    "plan_dryrun", "plan_real", "plan_zoo", "policy_for", "build_parser",
    "main",
]

# the --policy-grid sweep: registered compressors the wire supports
GRID = ("sbc", "topk", "variance", "signsgd")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.scale",
        description="zoo-wide bits-per-step × step-time trajectory planner")
    ap.add_argument("--all", action="store_true", help="plan every config in the zoo")
    ap.add_argument("--config", action="append", default=[],
                    help="plan one config (repeatable)")
    ap.add_argument("--mode", choices=planner.MODES, default=None,
                    help="force real | dryrun | analytic (default: classify by "
                         "host-memory budget)")
    ap.add_argument("--policy-grid", action="store_true",
                    help="price each config under the compressor grid instead of "
                         "emitting trajectory records")
    ap.add_argument("--rounds", type=int, default=8, help="measured rounds for real-mode runs")
    ap.add_argument("--budget-mb", type=int, default=DEFAULT_BUDGET_MB,
                    help="host-memory budget for the real tier")
    ap.add_argument("--sparsity", type=float, default=0.001, help="global upload rate p")
    ap.add_argument("--compressor", default="sbc", help="registered compressor to price/run")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--telemetry", action="store_true",
                    help="attach repro_torch.obs to real runs and export trace/metrics "
                         "next to the records")
    ap.add_argument("--out-dir", default=None,
                    help="write scale_zoo.json (+ telemetry artifacts) here; default: "
                         "print only")
    ap.add_argument("--device", default=None,
                    help="where real-mode runs train: cuda (default) or cpu")
    return ap


def _fmt_bits(b: Optional[float]) -> str:
    if b is None:
        return "-"
    for unit, div in (("Gb", 1e9), ("Mb", 1e6), ("kb", 1e3)):
        if b >= div:
            return f"{b / div:.2f} {unit}"
    return f"{b:.0f} b"


def _step_time(rec: dict) -> str:
    if rec.get("real"):
        return f"{rec['real']['step_ms_mean']:.1f} ms*"
    rf = rec.get("roofline_est")
    return f"{1e3 * rf['step_s']:.2f} ms^" if rf else "-"


def _render(records: list[dict]) -> None:
    from repro_torch.obs import render_table

    rows = [[r["arch"], r["mode"], f"{r['params'] / 1e6:,.1f}M",
             _fmt_bits(r["up_bits_per_step"]), f"×{r['compression_rate']:,.0f}",
             _fmt_bits(r.get("exchange_bits_per_step")), _step_time(r),
             "✓" if r["reconciles"] else "✗"] for r in records]
    print(render_table(
        ["arch", "mode", "params", "up bits/step", "rate", "mesh exchange", "step time",
         "recon"], rows,
        title="repro_torch.scale — bits-per-step × step-time (* measured, ^ roofline)"))


def _render_grid(names: list[str], args) -> None:
    from repro_torch.obs import render_table

    rows = []
    for name in names:
        mode, _ = classify(name, budget_mb=args.budget_mb, mode=args.mode)
        if mode == "real":
            mode = "dryrun"  # grid pricing is abstract; it never trains ×|GRID|
        for comp in GRID:
            rec, _ = plan(name, mode=mode, budget_mb=args.budget_mb, compressor=comp,
                          sparsity=args.sparsity, clients=args.clients)
            rows.append([name, comp, _fmt_bits(rec["up_bits_per_step"]),
                         f"×{rec['compression_rate']:,.0f}",
                         _fmt_bits(rec.get("exchange_bits_per_step"))])
    print(render_table(["arch", "policy", "up bits/step", "rate", "mesh exchange"], rows,
                       title=f"repro_torch.scale --policy-grid (p={args.sparsity})"))


def main(argv=None) -> list[dict]:
    args = build_parser().parse_args(argv)
    names = list(args.config) or (ALL_ARCHS if args.all else None)
    if names is None:
        build_parser().error("pass --all or --config <arch>")
    bad = [n for n in names if n not in ALL_ARCHS]
    if bad:
        build_parser().error(f"unknown configs {bad}; have {ALL_ARCHS}")

    if args.policy_grid:
        _render_grid(names, args)
        return []

    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    records = []
    for name in names:
        rec, run = plan(name, mode=args.mode, budget_mb=args.budget_mb,
                        compressor=args.compressor, sparsity=args.sparsity,
                        clients=args.clients, rounds=args.rounds, telemetry=args.telemetry,
                        device=args.device)
        records.append(rec)
        if run is not None and args.telemetry and args.out_dir:
            from repro_torch.obs import finish_run

            finish_run(run.telemetry, trace=os.path.join(args.out_dir, f"{name}.trace.json"),
                       metrics_out=os.path.join(args.out_dir, f"{name}.metrics.jsonl"),
                       meta={"arch": name, "mode": rec["mode"], "rounds": args.rounds},
                       print_summary=False)

    _render(records)
    if args.out_dir:
        path = os.path.join(args.out_dir, "scale_zoo.json")
        with open(path, "w") as f:
            json.dump(records, f, indent=1, sort_keys=True)
        print(f"wrote {len(records)} trajectory records → {path}")
    return records
