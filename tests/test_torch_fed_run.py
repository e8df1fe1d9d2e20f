"""The port's fed backend as a whole — ``build_run(RunSpec(backend="fed",
...))``, its round loop, faults, checkpoints, telemetry and CLIs — against
the JAX package's, on the CPU (``tests/torch_fed_cases.py`` hands the
initial parameters, the batches and the seeded pool state across, and
runs the reference's cohort step without its ``jit``, because under it XLA
may sum μ in another order; ROADMAP C).

Tolerances:
  * LeNet5 at lr 0 from a seeded residual (every ΔW is 0, so each round
    compresses the residual and no forward or backward pass reaches the
    uploads): the uploads' bytes, the aggregation weights, the ledger
    rows, the server's params, replica and downstream residual and the
    pool's residual rows, bit for bit; the loss (a forward pass) to
    ``rtol=1e-5``; ``update_norm`` to ``rtol=1e-12`` (an f64 sum over the
    leaves in another order);
  * LeNet5 trained (the preset's lr, a warm Adam state): every selected
    position, the cohorts and the ledger rows are equal; the loss is held
    to ``rtol=1e-5`` in round 1 and ``1e-4`` after.  The frameworks'
    gradients differ in their last ulps, more where a sum cancels, and
    Adam's m/√v passes that on where v is small, which is where the
    largest updates — the ones top-k keeps — are: μ is held to
    ``rtol=5e-3`` (seen: 1.9e-3) and the params to ``rtol=1e-3,
    atol=1e-6``;
  * CharLSTM (SGD at lr 1.0): as ``tests/test_torch_charlstm_run.py``
    holds it — at most two entries per client, SBC segment and round off
    the reference's params (a k-th/(k+1)-th swap), and measured bits
    within 0.1%;
  * the run surface (telemetry, the CLIs, refusals): the reference's
    span and metric names, history keys, ``wire:`` line and errors.

Kill → checkpoint → restore → resume and the other tests of the port
against itself are in ``tests/test_torch_fed_pool.py``.
"""
import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch.core.tree import tree_flatten
from repro_torch.core.wire import MAGIC
from repro_torch.fed import FaultSchedule, ParameterServer
from repro_torch.run import RunSpec, build_run, policy_from_spec
from repro_torch.run.build import as_policy
from torch_fed_cases import CHARLSTM, LENET, bits_equal, capture_uploads, paired, \
    trees_bits_equal
from torch_helpers import n

TWO_PROFILES = ((1, 0.01, 1.0), (2, 0.02, 2.0))
ROUNDS = 2


def run_both(jsched, tsched, rounds=ROUNDS):
    """``rounds`` rounds of both schedulers; returns both rounds' metrics
    and uploads."""
    jlog, tlog = capture_uploads(jsched), capture_uploads(tsched)
    jms, tms = [], []
    for r in range(rounds):
        jms.append(jsched.step(r))
        tms.append(tsched.step(r))
    return jms, tms, jlog, tlog


@pytest.mark.parametrize("mode", ["sync-flat", "sync-per-leaf", "async-staleness"])
def test_lenet5_rounds_match_the_reference_bit_for_bit(mode):
    # batch 4: at lr 0 the batches reach only the loss
    spec = dict(LENET, batch=4, clients=5, cohort=3, rounds=ROUNDS, lr=0.0,
                profiles=TWO_PROFILES, cohort_tile=1, fast=mode != "sync-per-leaf")
    if mode.startswith("async"):
        spec.update(async_rounds=True, max_staleness=2, agg="staleness")
    _, jsched, _, tsched = paired(spec, residual=True)
    jms, tms, jlog, tlog = run_both(jsched, tsched)
    for r, (jm, tm) in enumerate(zip(jms, tms)):
        assert [c for c, _ in tlog[r]] == [c for c, _ in jlog[r]], f"round {r} cohort"
        for (c, tb), (_, jb) in zip(tlog[r], jlog[r]):
            assert tb == jb, f"round {r} client {c}: upload bytes differ"
        assert tm["staleness"] == [int(s) for s in jm["staleness"]]
        assert tm["weights"] == [float(w) for w in jm["weights"]]
        assert tm["accepted"] == jm["accepted"]
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(tm["update_norm"], jm["update_norm"], rtol=1e-12)
    if mode.startswith("async"):
        assert any(any(m["staleness"]) for m in tms)  # some member started stale
    assert tsched.ledger.history() == jsched.ledger.history()
    trees_bits_equal(tsched.server.params, jsched.server.params, "params")
    trees_bits_equal(tsched.server.estimate, jsched.server.estimate, "replica")
    tres, jres = tsched.pool.export_state()["residual"], jsched.pool.export_state()["residual"]
    trees_bits_equal(tres, jres, "pool residual rows")


def test_lenet5_trained_rounds_match_the_reference():
    spec = dict(LENET, clients=5, cohort=3, rounds=ROUNDS, profiles=TWO_PROFILES, fast=True)
    _, jsched, _, tsched = paired(spec, warm_adam=True)
    jms, tms, jlog, tlog = run_both(jsched, tsched)
    for r, (jm, tm) in enumerate(zip(jms, tms)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5 if r == 0 else 1e-4)
        for (c, tb), (jc, jb) in zip(tlog[r], jlog[r]):
            assert c == jc
            wire = tsched.server.up_wire(tsched.pool.profile_of(c).sparsity, r)
            got = wire._leaves(wire.unpack_compressed(tb))
            want = wire._leaves(wire.unpack_compressed(jb))
            for g, w in zip(got, want):
                bits_equal(g.idx, w.idx, f"round {r} client {c} positions")
                np.testing.assert_allclose(n(g.mean), n(w.mean), rtol=5e-3)
    assert tsched.ledger.history() == jsched.ledger.history()
    for got, want in zip(tree_flatten(tsched.server.params)[0],
                         jax.tree.leaves(jsched.server.params)):
        np.testing.assert_allclose(n(got), np.asarray(want), rtol=1e-3, atol=1e-6)


def test_charlstm_rounds_match_the_reference():
    spec = dict(CHARLSTM, clients=4, cohort=2, rounds=ROUNDS, fast=True)
    _, jsched, _, tsched = paired(spec)
    jms, tms, _, _ = run_both(jsched, tsched)
    for r, (jm, tm) in enumerate(zip(jms, tms)):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5 if r == 0 else 1e-4)
    th, jh = tsched.ledger.history(), jsched.ledger.history()
    for a, b in zip(th.pop("up_bits_measured"), jh.pop("up_bits_measured")):
        assert abs(a - b) <= 1e-3 * b, (a, b)
    th.pop("up_bytes"), jh.pop("up_bytes")
    assert th == jh
    off = sum(int((~np.isclose(n(a), np.asarray(b), rtol=1e-4, atol=1e-6)).sum())
              for a, b in zip(tree_flatten(tsched.server.params)[0],
                              jax.tree.leaves(jsched.server.params)))
    assert off <= 2 * 2 * 8 * ROUNDS, f"{off} entries off the reference's"


# --------------------------------------------------------- the run surface


def test_telemetry_spans_and_gauge_are_written():
    from repro_torch import obs

    spec = dict(LENET, clients=4, cohort=2, rounds=2, fast=True, telemetry=True,
                down_sparsity=0.05)
    trun = build_run(RunSpec(**spec), device="cpu")
    state, hist = trun.run()
    assert trun.channel.telemetry is trun.telemetry is state.server.telemetry
    names = [e["name"] for e in trun.telemetry.tracer.events]
    counts = {k: names.count(k) for k in ("round", "select_quantize", "encode", "decode",
                                          "apply")}
    # per round: the cohort's select_quantize and encode, the server's
    # decode and apply, and the downstream select_quantize and encode
    assert counts == {"round": 2, "select_quantize": 4, "encode": 4, "decode": 2, "apply": 2}
    sizes = [s["value"] for s in trun.telemetry.metrics.series("fed/cohort_size")]
    assert sizes == [2, 2]
    assert not obs.validate_span_events(trun.telemetry.tracer.events)
    assert not obs.validate_metric_events(trun.telemetry.metrics.events())
    assert len(hist["loss"]) == 2 and hist["up_bytes"] > 0
    jrun = j_build_run(JRunSpec(**spec))
    _, jhist = jrun.run()
    jnames = [e["name"] for e in jrun.telemetry.tracer.events]
    assert {k: jnames.count(k) for k in counts} == counts
    assert set(hist) == set(jhist)


def wire_line(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return [ln for ln in out.getvalue().splitlines() if ln.startswith("wire: ")][-1]


def test_cli_prints_the_references_wire_line():
    """The re-anchor's command on both CLIs.  The port cannot draw the
    reference's parameters and batches, so the positions are another
    geometric draw: the kB of both directions are equal as printed, and
    the measured/analytic ratio within 0.005."""
    from repro.run.__main__ import main as j_main
    from repro_torch.run.__main__ import main as t_main

    argv = ["--preset", "lenet5", "--backend", "fed", "--clients", "4", "--cohort", "2",
            "--rounds", "2", "--measure-wire"]
    got = wire_line(t_main, argv + ["--device", "cpu"])
    want = wire_line(j_main, argv)
    assert got.split("(")[0] == want.split("(")[0]
    ratio = lambda line: float(line.split("×")[1].rstrip(")"))
    assert abs(ratio(got) - ratio(want)) <= 0.005, (got, want)


def test_fed_launcher_kills_checkpoints_restores_and_resumes():
    from repro_torch.launch.fed import main

    kill = json.dumps({"kill_server": [[1, "post_aggregate"]]})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        hist = main(["--preset", "lenet5", "--clients", "4", "--cohort", "2", "--rounds", "3",
                     "--delay", "1", "--batch", "4", "--device", "cpu", "--faults", kill])
    text = out.getvalue()
    assert "server killed at round 1 (post_aggregate)" in text
    assert text.strip().splitlines()[-1].startswith("wire: up ")
    assert hist["rounds"] == 3 and len(hist["loss"]) == 1  # round 2 after the resume
    # the launcher's default preset, fed-tiny, runs now
    # (tests/test_torch_decoder_run.py::test_fed_launcher_runs_its_default_preset)


# broadcast_log runs now (tests/test_torch_fed_broadcast.py), and so do the
# decoder presets (tests/test_torch_decoder_run.py) and non_iid on a decoder
# preset (tests/test_torch_noniid.py): a spec with no error builds
@pytest.mark.parametrize("change, error, match", [
    (dict(non_iid=True, preset="fed-tiny"), None, None),
    (dict(non_iid=True), ValueError, "non_iid needs an LM preset"),
    (dict(non_iid=True, preset="charlstm"), ValueError, "non_iid needs an LM preset"),
])
def test_fed_specs_outside_the_port_raise(change, error, match):
    spec = {**LENET, **change}
    if error is None:
        run = build_run(RunSpec(**spec), device="cpu")
        assert run.task.name == f"lm_markov_noniid{run.spec.clients}"
        return
    with pytest.raises(error, match=match) as got:
        build_run(RunSpec(**spec), device="cpu")
    if error is ValueError:  # the reference's own refusal, word for word
        with pytest.raises(ValueError) as want:
            j_build_run(JRunSpec(**spec))
        assert str(got.value) == str(want.value)


def test_fed_entry_points_need_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_run(RunSpec(**LENET))
    run = build_run(RunSpec(**LENET), device="cpu")
    assert run.init().pool.device.type == "cpu"
    params = tree_flatten(run.scheduler.server.params)[0]
    assert all(p.device.type == "cpu" for p in params)
    # the broadcast log lives on the server's device: the CPU here
    server = ParameterServer(params=run.scheduler.server.params,
                             up_policy=as_policy(policy_from_spec(RunSpec(**LENET))),
                             delta_horizon=4)
    assert server.delta_log.device.type == "cpu" and server.delta_log.horizon == 4
    assert FaultSchedule.parse("{}").last_round() == -1 and MAGIC == b"SBW1"
