"""The GSPMD backend's exchange across four clients, against the JAX package.

Four gloo ranks of the port (one client each, on the CPU) and the
reference on four forced host devices (one process, its channel under
``jit`` on a ``("data", "model")`` mesh of 4 x 1) take the same
per-client deltas and residuals (made with numpy from a seed) through
``ShardedGspmdChannel.round_exchange`` for two rounds, each round metered
into the channel's ledger (the port's on rank 0); LeNet5 at
``img_size=12``, p = 0.01 (``torch_dist_cases.EXCHANGES``).

Tolerances:
  * the exact engine (positions, or the device-packed words): every
    client's mean, own ΔW*, residual, words and ``nbits`` equal the
    reference's row of that client bit for bit, with f1b and f2b dense
    and c1 skipped too;
  * the per-leaf exchange (``fast=False``), with the same dense and skip
    leaves and with a bf16 residual: bit for bit;
  * the hist engine: within ``rtol=1e-6`` (its masked-moment sums are
    f64 in the port, f32 in the reference; ROADMAP C): the same survivors,
    each ΔW* within ``rtol``, the mean within ``rtol`` of Σ_c |ΔW*_c| / C
    (the clients' ±μ / C may cancel), the residual within
    ``2 · rtol · max |ΔW*|``;
  * the ledger rows and Eq. 1 bits: equal (full-width LeNet5 102,035.46
    a client, 118,242.81 with f1b and f2b dense, CharLSTM 55,454.65).
"""
import pytest

from torch_dist_cases import EQ1, EXCHANGES, check_hist, check_rows, run_both

N = 4
BITWISE = [name for name in EXCHANGES if name != "hist"]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return run_both(tmp_path_factory.mktemp("exchange4"), N, exchanges=list(EXCHANGES),
                    eq1=list(EQ1))


@pytest.mark.parametrize("name", BITWISE)
def test_exchange_is_the_references_bit_for_bit(outputs, name):
    ref, _, ports, _ = outputs
    assert check_rows(name, N, ref, ports) >= N * 2 * 13  # 6 means, 6 owns, residual


def test_hist_exchange_within_its_tolerance(outputs):
    ref, _, ports, _ = outputs
    check_hist("hist", N, ref, ports, rtol=1e-6)


@pytest.mark.parametrize("name", list(EXCHANGES))
def test_ledger_rows_and_bits_equal(outputs, name):
    _, ref_info, _, port_info = outputs
    assert port_info[0][name]["ledger"] == ref_info[name]["ledger"]
    assert port_info[0][name]["ledger"]["cohort_size"] == [N, N]
    for info in port_info:
        assert info[name]["bits_per_client"] == ref_info[name]["bits_per_client"]
        assert info[name]["bits_dense"] == ref_info[name]["bits_dense"]


@pytest.mark.parametrize("name,want", [
    ("lenet5", 102_035.46), ("lenet5-dense", 118_242.81), ("lenet5-leaf-dense", 118_242.81),
    ("charlstm", 55_454.65)])
def test_eq1_bits_of_the_full_width_presets(outputs, name, want):
    _, ref_info, _, port_info = outputs
    for info in port_info:
        assert info[f"eq1/{name}"] == ref_info[f"eq1/{name}"]
    assert round(port_info[0][f"eq1/{name}"]["bits_per_client"], 2) == want
