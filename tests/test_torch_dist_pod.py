"""The GSPMD backend's per-shard exchange on the (2, 2, 2) layout, against
the JAX package.

The reference runs its ``ShardedGspmdChannel.round_exchange`` under
``jit`` on 8 forced host devices laid out ("pod", "data", "model") = (2,
2, 2), in one process; the port runs one gloo rank a client on the CPU,
each holding all of its client's shards, with ``mesh_shape`` the same
layout.  Both take the same per-client deltas and residuals (numpy, from a
seed) for two rounds, each round metered into the channel's ledger (the
port's on rank 0), on a reduced granite-20b widened so that its embedding
and MLP stacks shard (``torch_dist_cases.WIDE``): in pod mode (2 clients
of 4 shards, FSDP: the leaves over "data" and "model") and in data mode
(4 clients, over "pod" and "data", of 2 shards over "model").  No model
runs: the reference's model does not trace on a mesh of several axes on
this jax, its channel does.

Tolerances:
  * the exact engine (positions, or the device-packed words) and the
    per-leaf exchange (f32, and bf16 leaves with a bf16 residual: the
    five pod configs' own dtypes): every client's mean, own ΔW*, residual
    (the flat ``(1, 4, n_pad)`` buffer of a client's devices, or the
    leaves), words and ``nbits`` equal the reference's row of that client
    bit for bit;
  * the hist engine: within ``rtol=1e-6`` (``torch_dist_cases.check_hist``:
    the same survivors, ΔW* within ``rtol``, the mean within ``rtol`` of
    Σ_c |ΔW*_c| / C, the residual within ``2 · rtol · max |ΔW*|``);
  * the ledger rows, the Eq. 1 bits and every leaf's shard count: equal.
"""
import pytest

from torch_dist_cases import (SHARDED, SHARDED_CLIENTS, check_hist, check_rows,
                              check_same_on_every_rank, run_both, sharded_cases)


@pytest.fixture(scope="module", params=list(SHARDED_CLIENTS))
def outputs(request, tmp_path_factory):
    mode = request.param
    n = SHARDED_CLIENTS[mode]
    return mode, n, run_both(tmp_path_factory.mktemp(f"sharded-{mode}"), n, timeout=420.0,
                             sharded=mode)


def _cases(outputs, hist: bool):
    mode, n, out = outputs
    return [(name, n, out) for name in sharded_cases(mode)
            if (SHARDED[name].get("flat_engine") == "hist") == hist]


def test_exact_and_per_leaf_exchanges_are_the_references_bit_for_bit(outputs):
    cases = _cases(outputs, hist=False)
    assert cases
    for name, n, (ref, _, ports, _) in cases:
        assert check_rows(name, n, ref, ports) >= n * 2 * 2 * 13, name


def test_hist_exchange_within_its_tolerance(outputs):
    cases = _cases(outputs, hist=True)
    assert len(cases) == 1
    for name, n, (ref, _, ports, _) in cases:
        check_hist(name, n, ref, ports, rtol=1e-6)


def test_every_client_applies_the_same_mean(outputs):
    mode, n, (_, _, ports, _) = outputs
    for name in sharded_cases(mode):
        for r in range(2):
            check_same_on_every_rank(f"{name}/{r}/mean", n, ports)


def test_ledger_rows_bits_and_shards_equal(outputs):
    mode, n, (_, ref_info, _, port_info) = outputs
    for name in sharded_cases(mode):
        want = ref_info[name]
        assert port_info[0][name]["ledger"] == want["ledger"], name
        assert port_info[0][name]["ledger"]["cohort_size"] == [n, n]
        assert max(want["n_shards"]) == (4 if mode == "pod" else 2), want["n_shards"]
        for info in port_info:
            for key in ("bits_per_client", "bits_dense", "n_shards"):
                assert info[name][key] == want[key], (name, key)
