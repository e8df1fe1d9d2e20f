"""The port's parameter server (``repro_torch.fed.server``) against the JAX
package's, across the packages, on the CPU: the reference's client pool
uploads its SBW1 blobs to the port's server, and the port's pool uploads
to the reference's.  Both servers start from the same parameters
(``tests/torch_fed_cases.py``).

Tolerances: the aggregation weights, the measured bits, the accepted and
rejected ids, the applied params, and the downstream broadcast's bytes,
replica and residual, bit for bit (the aggregate is an f64 sum in upload
order, one multiply and one add a term, as numpy takes it); the update
norm to ``rtol=1e-12`` (an f64 sum of squares in another order).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed.checkpoint import save_fed_state as j_save_fed_state
from repro.fed.faults import FaultSchedule as JFaultSchedule
from repro.fed.server import ClientUpdate as JClientUpdate
from repro.fed.server import ParameterServer as JServer
from repro.fed.server import staleness_weights as j_staleness_weights
from repro.run import RunSpec as JRunSpec
from repro.run.build import as_policy as j_as_policy
from repro.run.build import policy_from_spec as j_policy_from_spec
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.fed import ClientUpdate, ParameterServer, staleness_weights
from repro_torch.run import RunSpec
from repro_torch.run.build import as_policy, policy_from_spec
from torch_fed_cases import LENET, bits_equal, paired, trees_bits_equal
from torch_helpers import torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SPEC = dict(LENET, batch=4, clients=6, cohort=4, fast=True,
            profiles=((1, 0.01, 1.0), (2, 0.02, 3.0)))
STALENESS = [0, 2, 1, 3]


@pytest.fixture(scope="module")
def uploads():
    """One round's uploads of each package's pool (four clients, two
    rates), and the parameters both pools started from."""
    _, jsched, _, tsched = paired(SPEC, warm_adam=True)
    params = jax.tree.map(np.asarray, jsched.server.params)
    ids = tsched.pool.sample_cohort(0, SPEC["cohort"])
    out = {}
    for name, sched in (("reference", jsched), ("port", tsched)):
        res = sched.pool.run_cohort(0, ids, sched.server.estimate)
        out[name] = [(int(c), sched.server.up_wire(res.rates[i], 0).pack(res.ctrees[i]),
                      res.rates[i], res.weights[i], STALENESS[i])
                     for i, c in enumerate(res.client_ids)]
    return params, out


def servers(params, **kw):
    jserver = JServer(params=jax.tree.map(jnp.asarray, params),
                      up_policy=j_as_policy(j_policy_from_spec(JRunSpec(**SPEC))), **kw)
    tserver = ParameterServer(params=params_from_jax(params, "cpu"),
                              up_policy=as_policy(policy_from_spec(RunSpec(**SPEC))), **kw)
    return jserver, tserver


def updates(rows):
    return ([JClientUpdate(*r) for r in rows], [ClientUpdate(*r) for r in rows])


def assert_receive_equal(ti, ji):
    assert ti["accepted"] == ji["accepted"] and ti["rejected"] == ji["rejected"]
    assert ti["up_bits_measured"] == ji["up_bits_measured"]
    np.testing.assert_array_equal(ti["weights"], ji["weights"])
    np.testing.assert_allclose(ti["update_norm"], ji["update_norm"], rtol=1e-12)


@pytest.mark.parametrize("source", ["reference", "port"], ids=["jax-clients", "torch-clients"])
@pytest.mark.parametrize("agg", ["mean", "weighted", "staleness"])
def test_aggregate_and_apply_are_the_references(uploads, source, agg):
    params, blobs = uploads
    jserver, tserver = servers(params, aggregator=agg)
    jups, tups = updates(blobs[source])
    for r in range(2):  # the same uploads twice: the second lands on new params
        assert_receive_equal(tserver.receive(tups, r), jserver.receive(jups, r))
        trees_bits_equal(tserver.params, jserver.params, f"params after round {r}")
        tb, jb = tserver.broadcast(r), jserver.broadcast(r)  # dense downstream
        assert tb.blob == jb.blob
        assert (tb.bits_measured, tb.bits_analytic) == (jb.bits_measured, jb.bits_analytic)
        trees_bits_equal(tserver.estimate, jserver.estimate, "replica")
        for w, e in zip(tree_flatten(tserver.params)[0], tree_flatten(tserver.estimate)[0]):
            bits_equal(w, e, "dense broadcast: the replica is W")


def test_corrupt_upload_is_rejected_by_both(uploads):
    params, blobs = uploads
    rows = [list(r) for r in blobs["port"]]
    rows[1][1] = JFaultSchedule(seed=5).corrupt_blob(rows[1][1], 0, rows[1][0])
    jserver, tserver = servers(params)
    jups, tups = updates([tuple(r) for r in rows])
    ti, ji = tserver.receive(tups, 0), jserver.receive(jups, 0)
    assert ti["rejected"] == ji["rejected"] == [rows[1][0]]
    assert_receive_equal(ti, ji)
    trees_bits_equal(tserver.params, jserver.params, "params")
    # partial aggregation is survivors-only aggregation
    _, survivors_only = servers(params)
    survivors_only.receive([u for i, u in enumerate(tups) if i != 1], 0)
    for a, b in zip(tree_flatten(tserver.params)[0], tree_flatten(survivors_only.params)[0]):
        bits_equal(a, b, "survivors only")
    empty = servers(params)[1]
    info = empty.receive([tups[1]], 0)
    assert info["accepted"] == [] and info["update_norm"] == 0.0
    for a, b in zip(tree_flatten(empty.params)[0], tree_flatten(params_from_jax(params, "cpu"))[0]):
        bits_equal(a, b, "no survivor: no update")


def assert_gap_is_residual(server, sent):
    """W − Ŵ == the downstream residual: bit for bit where the broadcast
    sent nothing; where it sent ΔW*, (W − Ŵ_old) − ΔW* and W − (Ŵ_old +
    ΔW*) round differently: three roundings, within two ulps of |W| or
    |Ŵ|."""
    for w, e, res, d in zip(*(tree_flatten(x)[0] for x in (
            server.params, server.estimate, server.down_residual, sent))):
        gap, off = w - e, d != 0
        bits_equal(gap[~off], res[~off], "W - estimate == residual where nothing was sent")
        ulp = 2.0 ** -22 * torch.maximum(w.abs(), e.abs())[off]
        assert bool(((gap[off] - res[off]).abs() <= ulp).all())


@pytest.mark.parametrize("fast", [True, False], ids=["flat", "per-leaf"])
def test_sparse_broadcast_is_the_references(uploads, fast):
    params, blobs = uploads
    jspec = j_as_policy(j_policy_from_spec(JRunSpec(**{**SPEC, "fast": fast})))
    tspec = as_policy(policy_from_spec(RunSpec(**{**SPEC, "fast": fast})))
    jserver = JServer(params=jax.tree.map(jnp.asarray, params), up_policy=jspec,
                      down_sparsity=0.05)
    tserver = ParameterServer(params=params_from_jax(params, "cpu"), up_policy=tspec,
                              down_sparsity=0.05)
    jups, tups = updates(blobs["port"])
    for r in range(2):
        tserver.receive(tups, r)
        jserver.receive(jups, r)
        tb, jb = tserver.broadcast(r), jserver.broadcast(r)
        assert tb.blob == jb.blob, f"round {r}: broadcast bytes"
        assert (tb.bits_measured, tb.bits_analytic) == (jb.bits_measured, jb.bits_analytic)
        trees_bits_equal(tserver.estimate, jserver.estimate, f"round {r} replica")
        trees_bits_equal(tserver.down_residual, jserver.down_residual, f"round {r} residual")
        assert_gap_is_residual(tserver, tb.dense)
    assert len(tb.blob) < 0.1 * len(servers(params)[1].broadcast(0).blob)


@pytest.mark.parametrize("staleness, beta, base", [
    ([0, 1, 2, 3], 0.5, None), ([4, 0], 1.0, [2.0, 1.0]), ([0], 0.0, [3.0]),
])
def test_staleness_weights_are_the_references(staleness, beta, base):
    np.testing.assert_array_equal(staleness_weights(staleness, beta, base),
                                  j_staleness_weights(staleness, beta, base))


def test_server_refuses_what_the_reference_refuses(uploads):
    params, _ = uploads
    with pytest.raises(KeyError) as want:
        servers(params, aggregator="median")
    with pytest.raises(KeyError) as got:
        servers(params)[1].__class__(params=params_from_jax(params, "cpu"),
                                     up_policy=as_policy(policy_from_spec(RunSpec(**SPEC))),
                                     aggregator="median")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("log", [
    dict(), dict(broadcast_log=True, delta_horizon=4, down_sparsity=0.05),
], ids=["no-log", "broadcast-log"])
def test_checkpoint_layout_is_the_references(log, tmp_path):
    """The port's fedckpt-v1 file holds the reference's array keys and meta
    keys for the same spec and rounds, with the broadcast log's too."""
    spec = dict(LENET, batch=4, clients=4, cohort=2, rounds=1, fast=True, async_rounds=True,
                max_staleness=1, **log)
    _, jsched, trun, tsched = paired(spec)
    jsched.step(0)
    tsched.step(0)
    j_save_fed_state(str(tmp_path / "j.npz"), jsched, rounds_done=1)
    trun.checkpoint(tsched, str(tmp_path / "t.npz"), rounds_done=1)
    with np.load(tmp_path / "j.npz") as jz, np.load(tmp_path / "t.npz") as tz:
        assert set(tz.files) == set(jz.files)
        jmeta = json.loads(bytes(jz["__fedmeta__"]).decode())
        tmeta = json.loads(bytes(tz["__fedmeta__"]).decode())
    assert set(tmeta) == set(jmeta)
    assert tmeta["n_snapshots"] == jmeta["n_snapshots"] == 1
    assert [set(r) for r in tmeta["ledger"]] == [set(r) for r in jmeta["ledger"]]
    assert tmeta["last_sync"] == jmeta["last_sync"] and tmeta["log"] == jmeta["log"]
    assert bool(log) == any(k.startswith("log/blob/") for k in tz.files)
