"""A cell as the benchmark's files describe it, found by name.

``BENCHMARK.json`` (at the checkout's root) names the cell's
configuration and traffic and lists the metrics; the configuration's
file is the entry's ``file``, the traffic's ``traffic/<name>.json``, the
limits of its comparison ``limits/<cell>.json``, and each metric's
reader ``metrics/<metric>.py``.  A later cell, mix or metric comes with
files and entries of its own; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _for_cell(entries: list, cell: str) -> list:
    return [e for e in entries if cell in e.get("workloads", [cell])]


def load(cell: str, root: Path = ROOT) -> dict:
    """``{cell, config, traffic, limits, end_to_end, per_layer}`` of the
    cell named ``cell`` (``limits`` is None while none is set)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json; have {sorted(cells)}")
    entry = cells[cell]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[entry["config"]]["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    limits_file = BENCH / "limits" / f"{cell}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else None
    return {"cell": entry, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": _for_cell(bench["end_to_end"], cell),
            "per_layer": _for_cell(bench["per_layer"], cell)}


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location("pb_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
