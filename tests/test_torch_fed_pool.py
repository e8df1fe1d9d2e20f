"""The port's client pool (``repro_torch.fed.clients``) against the JAX
package's, on the CPU, and the fed backend against itself: stores,
tiles, rollback snapshots, checkpoints and kill → restore → resume.

Against the reference (``tests/torch_fed_cases.py`` hands the parameters,
batches and a seeded pool state across; the reference's cohort step runs
without its ``jit``, because under it XLA may sum μ in another order,
ROADMAP C): two profiles, ``cohort_tile=1``, LeNet5 at lr 0 from a seeded
residual, so ΔW is 0 and the uploads carry the compressed residual, which
no forward or backward pass touches: the cohort ids, each member's blob
bytes, Eq. 1 bits, rate, weight and residual row, bit for bit; each
member's loss (a forward pass) to ``rtol=1e-5``.  The port against itself:
bit for bit.
"""
import json

import numpy as np
import pytest
import torch

from repro.fed.clients import ClientPool as JClientPool
from repro.fed.clients import ClientProfile as JClientProfile
from repro_torch.core.tree import tree_flatten
from repro_torch.fed import CLIENT_STORES, ClientPool, ClientProfile, ServerKilled
from repro_torch.fed.clients import host_copy
from repro_torch.run import RunSpec, build_run
from torch_fed_cases import LENET, bits_equal, paired, trees_bits_equal
from torch_helpers import torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

TWO_PROFILES = ((1, 0.01, 1.0), (2, 0.02, 2.0))


@pytest.mark.parametrize("n_clients, cohort, seed", [(8, 4, 0), (5, 3, 7), (100, 10, 3),
                                                     (3, 5, 1)])
def test_sample_cohort_ids_are_the_references(n_clients, cohort, seed):
    jpool = JClientPool.__new__(JClientPool)
    jpool.n_clients, jpool.seed = n_clients, seed
    tpool = ClientPool.__new__(ClientPool)
    tpool.n_clients, tpool.seed = n_clients, seed
    for r in range(6):
        got = tpool.sample_cohort(r, cohort)
        np.testing.assert_array_equal(got, JClientPool.sample_cohort(jpool, r, cohort))
        assert len(got) == min(cohort, n_clients)


@pytest.mark.parametrize("fast", [True, False], ids=["flat", "per-leaf"])
def test_cohort_members_match_the_reference(fast):
    spec = dict(LENET, batch=4, clients=6, cohort=4, lr=0.0, profiles=TWO_PROFILES,
                cohort_tile=1, fast=fast)
    _, jsched, _, tsched = paired(spec, residual=True)
    ids = tsched.pool.sample_cohort(0, 4)
    jres = jsched.pool.run_cohort(0, ids, jsched.server.estimate)
    tres = tsched.pool.run_cohort(0, ids, tsched.server.estimate)
    assert tres.client_ids == jres.client_ids
    assert {c % 2 for c in tres.client_ids} == {0, 1}  # both profiles
    assert tres.rates == jres.rates and tres.weights == jres.weights
    np.testing.assert_array_equal(tres.bits_analytic, jres.bits_analytic)
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=1e-5)
    for i, c in enumerate(tres.client_ids):
        twire = tsched.server.up_wire(tres.rates[i], 0)
        jwire = jsched.server.up_wire(jres.rates[i], 0)
        assert twire.pack(tres.ctrees[i]) == jwire.pack(jres.ctrees[i]), f"client {c} blob"
    trees_bits_equal(tsched.pool.export_state()["residual"],
                     jsched.pool.export_state()["residual"], "residual rows")
    np.testing.assert_array_equal(tsched.pool.export_state()["step"],
                                  np.asarray(jsched.pool.export_state()["step"]))


def two_rounds(**kw):
    run = build_run(RunSpec(**{**LENET, "batch": 4, "clients": 7, "cohort": 5, "fast": True,
                               "profiles": TWO_PROFILES, **kw}), device="cpu")
    sched = run.init()
    hist = sched.run(2)
    return sched, hist


def assert_same_run(a, b):
    (sa, ha), (sb, hb) = a, b
    assert ha == hb
    for x, y in zip(tree_flatten(sa.server.params)[0], tree_flatten(sb.server.params)[0]):
        bits_equal(x, y, "params")
    ea, eb = sa.pool.export_state(), sb.pool.export_state()
    for key in ("residual", "rng", "step"):
        for x, y in zip(tree_flatten(ea[key])[0], tree_flatten(eb[key])[0]):
            bits_equal(x, y, key)
    for x, y in zip(tree_flatten(tuple(ea["opt"]))[0], tree_flatten(tuple(eb["opt"]))[0]):
        bits_equal(x, y, "optimizer state")


@pytest.fixture(scope="module")
def device_run():
    return two_rounds(cohort_tile=1)


@pytest.mark.parametrize("store", ["host", "memmap"])
def test_stores_give_identical_rows(store, device_run, tmp_path):
    got = two_rounds(cohort_tile=1, client_store=store)
    assert_same_run(got, device_run)
    assert got[0].pool.state_nbytes() == device_run[0].pool.state_nbytes()


@pytest.mark.parametrize("tile", [2, None], ids=["padded", "whole-group"])
def test_tiles_give_the_one_member_tiles_result(tile, device_run):
    """Cohorts of 5 in two profile groups: tiles of 2 pad a group of 3 (its
    last tile repeats its last member); the padded duplicate's outputs and
    row are discarded."""
    assert_same_run(two_rounds(cohort_tile=tile), device_run)


@pytest.mark.parametrize("store", CLIENT_STORES)
def test_snapshot_restore_round_trips_bit_for_bit(store):
    sched, _ = two_rounds(client_store=store)
    pool, ids = sched.pool, [1, 4, 6]
    before = pool.export_state()
    snap = pool.snapshot_clients(ids)
    sched.step(2)  # touches some of them
    pool.restore_clients(snap, only=[4, 6])
    pool.restore_clients(snap, only=[1])
    after = pool.export_state()
    flat = lambda st: tree_flatten((tuple(st["opt"]), st["residual"], st["rng"],
                                    st["step"]))[0]
    touched = [int(c) for c in sched.ledger.records[-1].cohort]
    for x, y in zip(flat(after), flat(before)):
        x, y = np.asarray(x), np.asarray(y)
        bits_equal(x[ids], y[ids], f"restored rows ({store})")
    assert set(touched) - set(ids), "the round touched other clients too"
    assert pool.snapshot_clients([])["opt"] is None


def test_pool_refuses_what_the_reference_refuses():
    kw = dict(model=None, optimizer=None, task=None, lr=lambda it: 0.1)
    policy = build_run(RunSpec(**LENET), device="cpu").init().pool.policy
    from repro.core.api import make_compressor as j_make_compressor

    jpolicy = j_make_compressor("sbc").policy
    for bad in (dict(n_clients=0), dict(n_clients=2, store="disk"),
                dict(n_clients=2, cohort_tile=0),
                dict(n_clients=2, profiles=((0, 0.01, 1.0),))):
        jbad = dict(bad, profiles=tuple(JClientProfile(*p) for p in bad.get("profiles", ())))
        if not jbad["profiles"]:
            jbad.pop("profiles")
        tbad = dict(bad, profiles=tuple(ClientProfile(*p) for p in bad.get("profiles", ())))
        if not tbad["profiles"]:
            tbad.pop("profiles")
        with pytest.raises(ValueError) as want:
            JClientPool(policy=jpolicy, **kw, **jbad)
        with pytest.raises(ValueError) as got:
            ClientPool(policy=policy, device="cpu", **kw, **tbad)
        assert str(got.value) == str(want.value)


def test_host_copy_keeps_dtypes_shapes_and_values():
    xs = [torch.arange(5, dtype=torch.int32), torch.randn(3, 4), torch.zeros(0),
          torch.tensor(2.5), torch.arange(7, dtype=torch.int64)]
    for a, b in zip(host_copy(xs), xs):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_flat_and_per_leaf_fed_runs_are_bit_identical():
    hists, scheds = {}, {}
    for fast in (False, True):
        run = build_run(RunSpec(**{**LENET, "batch": 4}, clients=5, cohort=3, rounds=2,
                                fast=fast, down_sparsity=0.05, cohort_tile=2), device="cpu")
        scheds[fast] = run.init()
        hists[fast] = scheds[fast].run(2)
    assert hists[True] == hists[False]
    for a, b in zip(tree_flatten(scheds[True].server.params)[0],
                    tree_flatten(scheds[False].server.params)[0]):
        bits_equal(a, b, "params")
    for a, b in zip(tree_flatten(scheds[True].server.down_residual)[0],
                    tree_flatten(scheds[False].server.down_residual)[0]):
        bits_equal(a, b, "downstream residual")


# ------------------------------------------------ checkpoints and resumes


KILL = dict(LENET, batch=4, clients=5, cohort=3, rounds=3, fast=True,
            straggler_timeout=2.5, profiles=TWO_PROFILES)


def faults(kill):
    # cohorts {2, 3, 4}, {1, 3, 4}, {0, 1, 2}: round 1 keeps only client 1
    return json.dumps({"corrupt": [[0, 3], [1, 4]], "slow": [[1, 3, 3.0]],
                       "kill_server": [[1, kill]] if kill else []})


@pytest.mark.parametrize("kill", ["post_aggregate", "pre_round"])
def test_kill_checkpoint_restore_resume_equals_the_uninterrupted_run(kill, tmp_path):
    whole = build_run(RunSpec(**KILL, faults=faults(None)), device="cpu")
    ws = whole.init()
    whole_hist = ws.run(KILL["rounds"])
    spec = RunSpec(**KILL, faults=faults(kill))
    run = build_run(spec, device="cpu")
    sched = run.init()
    with pytest.raises(ServerKilled) as e:
        sched.run(KILL["rounds"])
    path = str(tmp_path / "fed.npz")
    run.checkpoint(sched, path, rounds_done=e.value.round_idx)
    fresh = build_run(spec, device="cpu")
    meta = fresh.restore(path)
    assert (meta["pending"] is not None) == (kill == "post_aggregate")
    resumed = fresh.scheduler
    pending = resumed.resume_pending()
    resumed.run(KILL["rounds"], start_round=e.value.round_idx + (pending is not None))
    assert resumed.ledger.totals() == ws.ledger.totals()
    assert resumed.ledger.history() == ws.ledger.history()
    assert whole_hist["wire_cohort_size"] == [2, 1, 3]  # accepted uploads a round
    assert whole_hist["up_bytes_wasted"] > 0  # the straggler's and the corrupt uploads
    for a, b in zip(tree_flatten(resumed.server.params)[0], tree_flatten(ws.server.params)[0]):
        bits_equal(a, b, "params after resume")
    for key in ("residual", "rng", "step"):
        a, b = resumed.pool.export_state()[key], ws.pool.export_state()[key]
        for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
            bits_equal(x, y, f"pool {key}")
