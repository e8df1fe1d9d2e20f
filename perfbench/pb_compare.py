"""The comparison that decides ``correct``: the program's readings against
the reference's, number by number, each against its limit.

Numbers (see ``reference/pb_ref_train.py`` for the readings):

* ``loss_gap``: the largest ``|L_prog − L_ref| / |L_ref|`` over the three
  rounds' losses;
* ``grad1_gap``: the worst leaf's ``|‖g‖_prog − ‖g‖_ref|`` over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``change3_gap``: the same of ‖W₃ − W₀‖, over the leaves whose
  reference gradient is at least a thousandth of the median leaf's (a
  leaf with a gradient nought to rounding moves by round-off alone);
* ``eq1_gap``: ``|bits_prog − bits_ref|`` of Eq. 1, exact.

A number that is not finite is infinite.
"""
from __future__ import annotations

import math
import statistics

FLAT_GRADIENT = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _worst_leaf(prog: dict, ref: dict, leaves: list) -> float:
    med = statistics.median(ref[p] for p in leaves)
    gaps = [abs(prog[p] - ref[p]) / max(ref[p], med, 1e-300) for p in leaves]
    return _finite(max(gaps) if all(map(math.isfinite, gaps)) else math.inf)


def numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``{losses, grad1, change3, eq1}``."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    leaves = list(ref["grad1"])
    med = statistics.median(ref["grad1"].values())
    moving = [p for p in leaves if ref["grad1"][p] >= FLAT_GRADIENT * med]
    return {
        "loss_gap": _finite(loss),
        "grad1_gap": _worst_leaf(prog["grad1"], ref["grad1"], leaves),
        "change3_gap": _worst_leaf(prog["change3"], ref["change3"], moving),
        "eq1_gap": _finite(abs(prog["eq1"] - ref["eq1"])),
    }


def judge(values: dict, limits: dict | None) -> tuple:
    """``(correct, {name: {value, limit}})``: correct when a limit is set
    for the cell and every number it names is within it."""
    if not limits:
        return False, {k: {"value": v, "limit": None} for k, v in values.items()}
    table = {k: {"value": values[k], "limit": spec["limit"]} for k, spec in limits.items()}
    return all(t["value"] <= t["limit"] for t in table.values()), table
