"""The port's CatchupPlanner, SubscriberPool and simulate_fanout against the
JAX package's, on the CPU (the counterpart of ``tests/test_broadcast.py``).

Both packages' parameter servers start from the reference test's
``small_server`` parameters and take the reference's updates (its
``drive``: ``jax.random`` draws), handed across as numpy, so the
broadcasts, the logs and every plan are the same bytes.  Then each
round's plans (kind, bytes, candidates and the bytes of their blobs), the
pool's ``synced_round`` and ``bytes_down``, each round's ``classes``,
``awake`` and ``down_bytes``, and the ledger's rows are the reference's,
exactly.  ``simulate_fanout`` draws its updates from a ``torch.Generator``,
so it is held to its own invariants and to the reference's result keys,
not to the reference's bytes.  No tolerance.
"""
import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch

from repro.obs import view as jview
from repro.serve.broadcast import CatchupPlanner as JPlanner
from repro.serve.broadcast import SubscriberPool as JPool
from repro.serve.broadcast import simulate_fanout as j_simulate_fanout
from repro_torch import obs
from repro_torch.obs import view as tview
from repro_torch.core.policy import CompressionPolicy
from repro_torch.fed.server import ParameterServer
from repro_torch.core.tree import tree_flatten
from repro_torch.serve import (CatchupPlanner, DeltaLog, SubscriberPool, apply_plan,
                               simulate_fanout)
from test_broadcast import small_server
from torch_helpers import n

FANOUT = dict(rounds=8, horizon=4, down_sparsity=0.02, periods=(1, 2, 4), seed=0)


def port_server(jserver) -> ParameterServer:
    """The port's server on the reference server's parameters and settings."""
    params = {k: torch.from_numpy(np.array(v)) for k, v in jserver.params.items()}
    return ParameterServer(params=params, up_policy=CompressionPolicy.single("sbc"),
                           down_sparsity=jserver.down_sparsity,
                           delta_horizon=jserver.delta_horizon)


def recorded_plans(planner, log: list):
    plan = planner.plan

    def observed(from_round):
        got = plan(from_round)
        log.append(got)
        return got

    planner.plan = observed


def drive_both(jserver, jpool, tserver, tpool, rounds: int, seed: int = 0,
               replicas: list = None) -> list:
    """``tests/test_broadcast.py``'s ``drive`` on both: the reference draws
    each round's update, both servers take it, broadcast, and fan out.
    Checks every round's plans, info, pool arrays and ledger row; returns
    the infos, and appends the port's log replica after each round to
    ``replicas`` where given."""
    jplans, tplans = [], []
    recorded_plans(jpool.planner, jplans)
    recorded_plans(tpool.planner, tplans)
    rng = jax.random.PRNGKey(seed)
    infos = []
    for r in range(jserver.delta_log.head + 1, jserver.delta_log.head + 1 + rounds):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, 2)
        leaves, treedef = jax.tree.flatten(jserver.params)
        leaves = [x + 1e-2 * jax.random.normal(k, np.shape(x), x.dtype)
                  for x, k in zip(leaves, keys)]
        jserver.params = jax.tree.unflatten(treedef, leaves)
        tserver.params = {k: torch.from_numpy(np.array(v)) for k, v in jserver.params.items()}
        assert tserver.broadcast(r).blob == jserver.broadcast(r).blob, f"round {r} broadcast"
        jinfo, tinfo = jpool.sync_round(r), tpool.sync_round(r)
        assert tinfo == jinfo, f"round {r}"
        assert [p._replace(blobs=()) for p in tplans] == [p._replace(blobs=()) for p in jplans]
        assert [p.blobs for p in tplans] == [p.blobs for p in jplans], f"round {r} plan bytes"
        jplans.clear(), tplans.clear()
        np.testing.assert_array_equal(tpool.synced_round, jpool.synced_round)
        np.testing.assert_array_equal(tpool.bytes_down, jpool.bytes_down)
        assert tpool.synced_round.dtype == np.int32 and tpool.bytes_down.dtype == np.int32
        infos.append(tinfo)
        if replicas is not None:
            replicas.append(tserver.delta_log.replica_flat())
    assert [dataclasses.asdict(r) for r in tpool.ledger.records] == \
        [dataclasses.asdict(r) for r in jpool.ledger.records]
    return infos


@pytest.fixture(scope="module")
def fanout():
    """12 rounds of 500 subscribers in periods (1, 2, 6), horizon 4, four
    verified classes, in both packages (the reference test's first case)."""
    jserver = small_server(horizon=4)
    tserver = port_server(jserver)
    kw = dict(n_subscribers=500, periods=(1, 2, 6), verify_classes=4)
    jpool, tpool = JPool(log=jserver.delta_log, **kw), SubscriberPool(
        log=tserver.delta_log, **kw)
    infos = drive_both(jserver, jpool, tserver, tpool, rounds=12)
    return jserver, jpool, tserver, tpool, infos


def test_fanout_is_the_references_and_verifies(fanout):
    jserver, jpool, tserver, tpool, infos = fanout
    tpool.ledger.reconcile(rel=0.1)
    assert tpool.verify_ok and tpool.verified_syncs == jpool.verified_syncs > 0
    assert sum(i["awake"] for i in infos) > 12 * 500 / 3
    kinds = {k for i in infos for k in i["classes"].values()}
    assert "full" in kinds and kinds & {"replay", "stacked"}
    assert tpool.totals() == jpool.totals()
    assert tpool.down_bytes_full_equiv == jpool.down_bytes_full_equiv
    log, jlog = tserver.delta_log, jserver.delta_log
    assert (log.head, log.oldest) == (jlog.head, jlog.oldest)
    for got, want in zip(log.replica_flat(), jlog.replica_flat()):
        np.testing.assert_array_equal(n(got).view(np.uint32), want.view(np.uint32))


@pytest.fixture(scope="module")
def horizon6_logs():
    """8 rounds of both servers at horizon 6 under a 10-subscriber pool;
    also the port's server and its log's replica after each round."""
    jserver = small_server(horizon=6)
    tserver = port_server(jserver)
    replicas: list = []
    drive_both(jserver, JPool(log=jserver.delta_log, n_subscribers=10), tserver,
               SubscriberPool(log=tserver.delta_log, n_subscribers=10), rounds=8,
               replicas=replicas)
    return jserver.delta_log, tserver.delta_log, tserver, replicas


@pytest.mark.parametrize("lag", range(1, 7))
def test_plans_beat_full_within_the_horizon(lag, horizon6_logs):
    jlog, tlog, _, _ = horizon6_logs
    got, want = CatchupPlanner(tlog).plan(tlog.head - lag), JPlanner(jlog).plan(jlog.head - lag)
    assert got == want
    assert got.nbytes < tlog.full_nbytes(), got.candidates


def test_apply_plan_moves_a_receiver_to_the_references_log(horizon6_logs):
    """A receiver at every lag within the horizon, moved by its plan (a
    replay decodes each shipped SBW1 blob through the server's down wire,
    as a receiver does) and by the stacked and full messages of the same
    lag, holds the reference's log replica bit for bit."""
    jlog, tlog, tserver, replicas = horizon6_logs

    def decode(round_idx, blob):
        dense = tserver.down_wire(round_idx).unpack(blob)
        return [x.reshape(-1) for x in tree_flatten(dense)[0]]

    kinds = set()
    for lag in range(1, 7):
        frm = tlog.head - lag
        plan = CatchupPlanner(tlog).plan(frm)
        kinds.add(plan.kind)
        for p in (plan, plan._replace(kind="stacked", blobs=(tlog.encode_stacked(frm).blob,)),
                  plan._replace(kind="full", blobs=(tlog.encode_full().blob,))):
            got = apply_plan(replicas[frm], p, decode)
            for a, b in zip(got, jlog.replica_flat()):
                np.testing.assert_array_equal(n(a).view(np.uint32), b.view(np.uint32),
                                              err_msg=f"lag {lag}, {p.kind}")
    assert "replay" in kinds


def test_round_ordering_and_pool_validation_are_the_references():
    jserver = small_server()
    tserver = port_server(jserver)
    calls = [
        lambda P, log, **kw: P(log=log, n_subscribers=5, **kw).sync_round(0),
        lambda P, log, **kw: P(log=log, n_subscribers=0, **kw),
        lambda P, log, **kw: P(log=log, n_subscribers=4, periods=(0,), **kw),
        lambda P, log, **kw: P(log=log, n_subscribers=4, periods=(), **kw),
    ]
    for call in calls:
        with pytest.raises(ValueError) as want:
            call(JPool, jserver.delta_log)
        with pytest.raises(ValueError) as got:
            call(SubscriberPool, tserver.delta_log)
        assert str(got.value) == str(want.value)


def test_pool_and_fanout_need_a_card_unless_cpu(monkeypatch):
    """The log and ``simulate_fanout`` refuse to run without a card unless
    given ``device="cpu"``; the pool keeps its state on its log's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tserver = port_server(small_server())
    assert tserver.delta_log.device.type == "cpu"  # the server's own device
    with pytest.raises(RuntimeError, match="no CUDA card"):
        DeltaLog({"w": torch.zeros(8)}, horizon=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        simulate_fanout({"w": np.zeros(8, np.float32)}, n_subscribers=2, rounds=1)
    pool = SubscriberPool(log=tserver.delta_log, n_subscribers=4)
    assert pool.device == tserver.delta_log.device
    assert pool._synced.device.type == "cpu" and pool._synced.dtype == torch.int32


def test_simulate_fanout_keys_and_invariants():
    """The reference test's settings: the reference's keys and plan lags,
    a bit-exact stack, catch-ups cheaper than a resync, a reconciled
    ledger; the telemetry files pass both packages' checkers."""
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(3000,)).astype(np.float32),
              "b": rng.normal(size=(40,)).astype(np.float32)}
    tel = obs.make_telemetry()
    m = simulate_fanout(params, n_subscribers=300, telemetry=tel, device="cpu", **FANOUT)
    want = j_simulate_fanout({k: jax.numpy.asarray(v) for k, v in params.items()},
                             n_subscribers=300, **FANOUT)
    assert set(m) == set(want)
    assert m["ledger_reconciles"] and m["stack_bit_exact"] and m["catchup_beats_full_all_lags"]
    assert m["bytes_saving_vs_full_resync"] > 1.0 and m["bytes_per_subscriber_per_round"] > 0
    assert set(m["plan_by_lag"]) == set(want["plan_by_lag"]) == {"1", "2", "3", "4"}
    for k in ("n_subscribers", "timed_rounds", "horizon", "n_params", "down_sparsity",
              "periods", "full_resync_bytes"):
        assert m[k] == want[k], k
    names = {e["name"] for e in tel.tracer.events}
    assert {"round", "plan", "encode_stacked", "verify"} <= names
    metrics = {s["name"] for s in tel.metrics.samples}
    assert {"serve/plan_bytes", "fed/lag_class", "serve/verify_ok", "wire/down_bytes"} <= metrics
    assert not obs.validate_span_events(tel.tracer.events)
    assert not obs.validate_metric_events(tel.metrics.events())


def test_simulate_fanout_files_pass_both_checkers(tmp_path):
    tel = obs.make_telemetry()
    params = {"w": np.linspace(-1, 1, 2000, dtype=np.float32), "b": np.ones(10, np.float32)}
    simulate_fanout(params, n_subscribers=50, telemetry=tel, device="cpu",
                    **dict(FANOUT, rounds=4))
    meta = {"backend": "serve", "preset": "synthetic", "rounds": 4}
    with contextlib.redirect_stdout(io.StringIO()):
        paths = obs.finish_run(tel, trace=str(tmp_path / "t.json"),
                               metrics_out=str(tmp_path / "m.jsonl"), meta=meta)
        files = [paths["trace"], paths["metrics"]]
        assert jview.check(files) == 0
        assert tview.check(files) == 0
