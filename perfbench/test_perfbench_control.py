"""Card tests of the comparison at each cell's own size: on one seed the
program passes the cell's limits, while the control (the reference in
TF32, the precision below the configuration's f32 with TF32 off) and the
planted fault (the program fed half of each batch's rows) fail them.
They skip without a card; on the card (about a minute a cell):

    python -m pytest -q perfbench/test_perfbench_control.py
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
for sub in (BENCH, BENCH / "reference"):
    if str(sub) not in sys.path:
        sys.path.insert(0, str(sub))

import pb_compare  # noqa: E402
import pb_spec  # noqa: E402

CELLS = [w["name"] for w in
         json.loads((BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]
SEED = 3_000_000_019


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_fault_fail_where_the_program_passes(card, cell):
    import pb_limits

    spec = pb_spec.load(cell)
    row = pb_limits.readings(spec, [SEED], card)[0]
    assert pb_compare.judge(row["program"], spec["limits"])[0], row["program"]
    assert not pb_compare.judge(row["control"], spec["limits"])[0], row["control"]
    assert not pb_compare.judge(row["fault"], spec["limits"])[0], row["fault"]
