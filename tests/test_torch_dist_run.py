"""Three DSGD rounds of the GSPMD backend across four clients, against
the JAX package, and the launcher under ``torchrun``.

Four gloo ranks of the port (one client each, on the CPU) and the
reference on four forced host devices (its jitted train step on a
``("data", "model")`` mesh of 4 x 1) start from one carried-across state
(the reference's ``model.init``, and for LeNet5 a warm Adam state drawn
from a seed: ROADMAP C) and take the same per-client batches
(``torch_dist_cases.RUNS``): LeNet5 at ``img_size=12`` on the exact
engine with the device-packed wire and per leaf (``fast=False``, f1b and
f2b dense), CharLSTM at full width on the exact engine with the device
pack.  Every round is metered into the ledger (the port's on rank 0).

Tolerances, as in the one-client run tests (``test_torch_exact.py``,
``test_torch_charlstm_run.py``): loss ``rtol=1e-5`` in round 1 and
``1e-4`` after; the parameters the same on every rank bit for bit, and
within ``rtol=1e-4, atol=1e-6`` of the reference's — for CharLSTM but at
most two entries per client, SBC segment and round (SGD at lr 1.0 makes
the k-th and (k+1)-th |acc| of a segment often one ulp step apart, and
gradient ulps swap them; ROADMAP C), whose measured bits are held to
0.1%.  LeNet5's rounds select what the reference selects, so its ledger
rows are equal.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from torch_dist_cases import RUNS, check_same_on_every_rank, run_both

N = 4
REPO = pathlib.Path(__file__).resolve().parent.parent
CHARLSTM_SBC_LEAVES = 8


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("run4"), N, runs=list(RUNS))


@pytest.mark.parametrize("name", list(RUNS))
def test_losses_match_jax(outputs, name):
    _, ref_info, _, port_info = outputs
    want = ref_info[name]["losses"]
    for info in port_info:
        assert len(info[name]["losses"]) == 3
        np.testing.assert_allclose(info[name]["losses"][0], want[0], rtol=1e-5)
        np.testing.assert_allclose(info[name]["losses"], want, rtol=1e-4)


@pytest.mark.parametrize("name", list(RUNS))
def test_params_match_jax_and_agree_across_ranks(outputs, name):
    ref, _, ports, _ = outputs
    check_same_on_every_rank(f"{name}/params", N, ports)
    swaps = 2 * N * CHARLSTM_SBC_LEAVES * 3 if name.startswith("charlstm") else 0
    off = 0
    for k in (k for k in ref if k.startswith(f"{name}/params/")):
        off += int((~np.isclose(ports[0][k], ref[k], rtol=1e-4, atol=1e-6)).sum())
    assert off <= swaps, f"{off} entries off the reference's"


@pytest.mark.parametrize("name", [n for n in RUNS if n.startswith("lenet5")])
def test_lenet5_selections_and_ledger_equal(outputs, name):
    ref, ref_info, ports, port_info = outputs
    for r in range(3):
        for k in (k for k in ref if k.startswith(f"{name}/{r}/own_client0/")):
            np.testing.assert_array_equal(ports[0][k] != 0, ref[k] != 0, err_msg=k)
    assert port_info[0][name]["ledger"] == ref_info[name]["ledger"]
    assert port_info[0][name]["bits_per_client"] == ref_info[name]["bits_per_client"]


def test_charlstm_ledger_within_its_tolerance(outputs):
    _, ref_info, _, port_info = outputs
    got, want = port_info[0]["charlstm-exact"]["ledger"], ref_info["charlstm-exact"]["ledger"]
    for a, b in zip(got.pop("up_bits_measured"), want.pop("up_bits_measured")):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    got.pop("up_bytes"), want.pop("up_bytes")
    assert got == want and got["cohort_size"] == [N] * 3


def test_torchrun_launcher_ends_with_the_wire_line(tmp_path):
    """``torchrun`` starts two gloo ranks of ``python -m repro_torch.run``
    on the CPU: rank 0 alone prints, and ends with the reference's
    ``wire:`` line."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "repro_torch.run", "--preset", "lenet5", "--backend", "gspmd", "--fast",
           "--flat-engine", "exact", "--device-pack", "--measure-wire", "--sparsity", "0.01",
           "--batch", "8", "--rounds", "2", "--device", "cpu"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len([line for line in lines if line.startswith("run: ")]) == 1
    assert "clients=2" in lines[0] and "device=cpu" in lines[0]
    assert lines[-1].startswith("wire: up ") and "measured/analytic up" in lines[-1]
