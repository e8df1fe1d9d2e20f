"""The GSPMD backend across three clients, against the JAX package.

Five of the six cases of ``test_torch_dist_exchange.py`` (the device
pack only with dense and skip leaves) and one three-round run at three
clients (three gloo ranks of the port, three forced host devices of the
reference), where a division by the client count and a product with
its f32 reciprocal differ, and where no power of two hides an order of
adds.  The same tolerances: the exact engine, its device-packed words and
``nbits`` and the per-leaf exchange (f32 and bf16 residuals) bit for bit;
the hist engine within ``rtol=1e-6``; the ledger rows equal; the run's
loss within ``rtol=1e-5`` in round 1 and ``1e-4`` after, its parameters
within ``rtol=1e-4, atol=1e-6`` and the same on every rank.
"""
import numpy as np
import pytest

from torch_dist_cases import check_hist, check_rows, check_same_on_every_rank, run_both

N = 3
# where a division by 3 or an order of adds could show: the exact engine's
# μ / C on positions and on packed words with the dense pmean, the per-leaf
# exchange's μ / C and pmean (f32 and bf16), the hist engine's pmean
CASES = ("exact", "exact-pack-dense-skip", "leaf-dense-skip", "leaf-bf16", "hist")
RUN = "lenet5-exact-pack"


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("exchange3"), N, exchanges=CASES, runs=[RUN])


@pytest.mark.parametrize("name", [name for name in CASES if name != "hist"])
def test_exchange_is_the_references_bit_for_bit(outputs, name):
    ref, _, ports, _ = outputs
    assert check_rows(name, N, ref, ports) >= N * 2 * 13


def test_hist_exchange_within_its_tolerance(outputs):
    ref, _, ports, _ = outputs
    check_hist("hist", N, ref, ports, rtol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_ledger_rows_equal(outputs, name):
    _, ref_info, _, port_info = outputs
    assert port_info[0][name]["ledger"] == ref_info[name]["ledger"]
    assert port_info[0][name]["ledger"]["cohort_size"] == [N, N]


def test_three_rounds_match_jax(outputs):
    ref, ref_info, ports, port_info = outputs
    for info in port_info:
        np.testing.assert_allclose(info[RUN]["losses"][0], ref_info[RUN]["losses"][0],
                                   rtol=1e-5)
        np.testing.assert_allclose(info[RUN]["losses"], ref_info[RUN]["losses"], rtol=1e-4)
    check_same_on_every_rank(f"{RUN}/params", N, ports)
    for k in (k for k in ref if k.startswith(f"{RUN}/params/")):
        np.testing.assert_allclose(ports[0][k], ref[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert port_info[0][RUN]["ledger"] == ref_info[RUN]["ledger"]
