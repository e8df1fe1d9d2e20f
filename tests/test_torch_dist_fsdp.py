"""The per-shard exchange with one rank a device, on the (2, 2, 2) layout,
against the JAX package.

The reference runs its ``ShardedGspmdChannel.round_exchange`` under
``jit`` on 8 forced host devices laid out ("pod", "data", "model") = (2,
2, 2), one process a mode; the port runs 8 gloo ranks on the CPU, one a
device, each holding its device's block of every leaf and of its client's
deltas and residual, with ``mesh_shape`` the same layout: its exchange
crosses the ranks of its device coordinate in every client only.  The
inputs, the cases and the checks are ``tests/torch_dist_cases.py``'s
(``SHARDED``, the widened reduced granite-20b): pod mode (2 clients of 4
devices, FSDP: the leaves over "data" and "model": the exact engine with
and without the device pack, hist, the per-leaf exchange in f32 and in
bf16) and data mode (4 clients, over "pod" and "data", of 2 devices over
"model": the exact engine with the device pack), two rounds each,
metered on rank 0.  Each client's outputs are put back together
from its ranks (``client_rows``: a block that several devices hold must
be the same on all of them, bit for bit) and held against the reference's
row of that client, so every rank's block is its device's row.

Tolerances, as ``tests/test_torch_dist_pod.py``'s:
  * the exact engine (positions, or the device-packed words) and the
    per-leaf exchange (f32, and bf16 leaves with a bf16 residual): every
    device's mean, own ΔW*, residual, words and ``nbits`` equal the
    reference's bit for bit;
  * the hist engine: within ``rtol=1e-6`` (``check_hist``);
  * the ledger rows, the Eq. 1 bits and every leaf's shard count: equal.
"""
import pytest

from torch_dist_cases import (DEVICE_CASES, LAYOUT, SHARDED, SHARDED_CLIENTS, check_hist,
                              check_rows, client_rows, run_devices)

MODES = tuple(SHARDED_CLIENTS)


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    refs, ports, infos = run_devices(tmp_path_factory.mktemp("devices"), timeout=300.0)
    return refs, ports, infos


def _cases(hist: bool) -> list:
    return [(mode, name) for mode in MODES for name in DEVICE_CASES[mode]
            if (SHARDED[name].get("flat_engine") == "hist") == hist]


def test_every_rank_is_one_device_of_the_layout(outputs):
    """Rank r is the device at r row-major over ("pod", "data", "model"):
    its client the "pod" coordinate in pod mode and ("pod", "data") in data
    mode, its device inside the client the rest, its exchange group one
    rank a client."""
    _, _, infos = outputs
    for r, info in enumerate(infos):
        pod, data, model = r // 4, (r // 2) % 2, r % 2
        for name in DEVICE_CASES["pod"]:
            assert (info[name]["client"], info[name]["device"]) == (pod, 2 * data + model)
            assert info[name]["exchange_world"] == 2
        for name in DEVICE_CASES["data"]:
            assert (info[name]["client"], info[name]["device"]) == (2 * pod + data, model)
            assert info[name]["exchange_world"] == 4
    assert len(infos) == 8 == LAYOUT["pod"] * LAYOUT["data"] * LAYOUT["model"]


@pytest.mark.parametrize("mode,name", _cases(hist=False))
def test_exact_and_per_leaf_rows_are_the_references_bit_for_bit(outputs, mode, name):
    refs, ports, infos = outputs
    n = SHARDED_CLIENTS[mode]
    rows = client_rows(name, n, ports, infos)
    assert check_rows(name, n, refs[mode][0], rows) >= n * 2 * 2 * 13, name


@pytest.mark.parametrize("mode,name", _cases(hist=True))
def test_hist_rows_within_their_tolerance(outputs, mode, name):
    refs, ports, infos = outputs
    n = SHARDED_CLIENTS[mode]
    check_hist(name, n, refs[mode][0], client_rows(name, n, ports, infos), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_ledger_rows_bits_and_shards_equal(outputs, mode):
    refs, _, infos = outputs
    n = SHARDED_CLIENTS[mode]
    for name in DEVICE_CASES[mode]:
        want = refs[mode][1][name]
        assert infos[0][name]["ledger"] == want["ledger"], name
        assert infos[0][name]["ledger"]["cohort_size"] == [n, n]
        for info in infos:
            for key in ("bits_per_client", "bits_dense", "n_shards"):
                assert info[name][key] == want[key], (name, key)
