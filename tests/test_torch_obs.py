"""The port's telemetry (``repro_torch.obs``) against the reference's
``repro.obs``, on the CPU.

The port writes the reference's ``repro-obs-v1`` files: the reference's
checker (``repro.obs.view.check``) accepts them, each package reads the
other's metrics JSONL, and a traced run records the same spans and the
same metric names and tags, in the same order, as the reference's run of
the same spec.  Values: the static ``leaf/*`` gauges,
``train/bits_per_client`` (Eq. 1) and the ledger's analytic and
downstream ``wire/*`` gauges equal the reference's; the measured upload
bits and bytes equal the port's own ledger rows bit for bit, and the
reference's to within 0.1% (the runs' top-k may swap a segment's k-th
entry, see ``tests/test_torch_charlstm_run.py``).  Times are host-clock
times and are compared with nothing.
"""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.obs as jobs
from repro.obs import view as jview
from repro.obs.export import read_metrics_jsonl as j_read_metrics_jsonl
from repro.run import RunSpec as JRunSpec
from repro.run import build_run as j_build_run
from repro_torch import obs
from repro_torch.convert import params_from_jax, state_from_jax
from repro_torch.obs import view as tview
from repro_torch.obs.export import read_metrics_jsonl, render_table
from repro_torch.run import RunSpec, build_run
from repro_torch.train import TrainState
from torch_helpers import t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

LOCAL = dict(preset="charlstm", backend="local", clients=2, batch=2, seq_len=8,
             sparsity=0.01, rounds=2, measure_wire=True, telemetry=True)
GSPMD = dict(preset="charlstm", backend="gspmd", fast=True, flat_engine="exact",
             device_pack=True, batch=2, seq_len=8, sparsity=0.01, rounds=2,
             measure_wire=True, telemetry=True)
# metric values that depend on the selections (boundary swaps, see above)
MEASURED = ("wire/up_bits_measured", "wire/up_bytes", "wire/client_bits_measured",
            "wire/own_client0_bits_measured")
HOST_CLOCK = ("train/step_ms",)
# summed in another order than XLA's reduce (tolerance rtol=1e-5)
FLOAT_SUMS = ("train/loss", "train/residual_norm")


def one_device_mesh():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def _batches(lead, rounds):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(rounds):
        toks = rng.integers(0, 98, lead + (2, 9)).astype(np.int32)
        out.append({"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    return out


def traced_pair(spec: dict):
    """The reference's and the port's runs of ``spec`` with telemetry on,
    from the reference's initial state and batches; returns both runs
    after ``run()``."""
    if spec["backend"] == "local":
        jrun, trun = j_build_run(JRunSpec(**spec)), build_run(RunSpec(**spec), device="cpu")
        jstate = jrun.init()
        params = params_from_jax(jax.tree.map(np.asarray, jstate.params), "cpu")
        tstate = TrainState(params, (), trun.trainer.channel.init_state(params),
                            torch.zeros((), dtype=torch.int32))
        data = _batches((spec["clients"], 1), spec["rounds"])
        jrun.batch_fn = lambda r: jax.tree.map(jnp.asarray, data[r])
        trun.batch_fn = lambda r: {k: t(v).long() for k, v in data[r].items()}
    else:
        jrun = j_build_run(JRunSpec(**spec), mesh=one_device_mesh())
        trun = build_run(RunSpec(**spec), device="cpu")
        np_state = jax.tree.map(np.asarray, jrun.init())
        jstate, tstate = jax.tree.map(jnp.asarray, np_state), state_from_jax(np_state, "cpu")
        data = _batches((1,), spec["rounds"])
        jrun._batch = lambda r: jax.tree.map(jnp.asarray, data[r])
        trun._batch = lambda r: {k: t(v).long() for k, v in data[r].items()}
    jrun.init = lambda rng=None: jstate
    trun.init = lambda gen=None: tstate
    assert jrun.telemetry.enabled and trun.telemetry.enabled
    assert trun.channel.telemetry is trun.telemetry
    jrun.run()
    trun.run()
    return jrun, trun


@pytest.fixture(scope="module", params=["local", "gspmd"])
def pair(request):
    return traced_pair(LOCAL if request.param == "local" else GSPMD)


def test_span_and_metric_names_are_the_references():
    assert obs.SPAN_NAMES == jobs.SPAN_NAMES
    assert obs.METRIC_NAMES == jobs.METRIC_NAMES
    assert obs.SCHEMA == jobs.SCHEMA == "repro-obs-v1"


def test_traced_runs_record_the_references_spans(pair):
    jrun, trun = pair

    def spans(run):
        return [(e["name"], e["depth"], e["args"]) for e in run.telemetry.tracer.events]

    assert spans(trun) == spans(jrun)
    names = [s[0] for s in spans(trun)]
    for name in ("round", "exchange", "encode"):
        assert names.count(name) == trun.spec.rounds
    assert obs.validate_span_events(trun.telemetry.tracer.events) == []
    assert jobs.validate_span_events(trun.telemetry.tracer.events) == []


def test_traced_runs_record_the_references_metrics(pair):
    jrun, trun = pair
    js, ts = jrun.telemetry.metrics.samples, trun.telemetry.metrics.samples
    assert [(s["kind"], s["name"], s["tags"]) for s in ts] == \
        [(s["kind"], s["name"], s["tags"]) for s in js]
    for a, b in zip(ts, js):
        if a["name"] in HOST_CLOCK:
            assert a["value"] > 0
        elif a["name"] in FLOAT_SUMS:
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-5, err_msg=a["name"])
        elif a["name"] in MEASURED:
            assert abs(a["value"] - b["value"]) <= 1e-3 * b["value"], (a, b)
        else:
            assert a["value"] == b["value"], (a, b)
    # the wire/* gauges are the port's own ledger, verbatim
    for col, rows in trun.ledger.history().items():
        if col in ("round", "cohort_size"):
            continue
        got = [s["value"] for s in ts if s["name"] == f"wire/{col}"]
        assert got == [float(v) for v in rows], col
    assert obs.validate_metric_events(trun.telemetry.metrics.events()) == []
    assert jobs.validate_metric_events(trun.telemetry.metrics.events()) == []


def test_files_pass_both_checkers_and_read_across(pair, tmp_path):
    jrun, trun = pair
    meta = {"backend": trun.spec.backend, "preset": "charlstm", "rounds": 2}
    with contextlib.redirect_stdout(io.StringIO()) as out:
        paths = obs.finish_run(trun.telemetry, trace=str(tmp_path / "t.json"),
                               metrics_out=str(tmp_path / "m.jsonl"), meta=meta)
        jpaths = jobs.finish_run(jrun.telemetry, trace=str(tmp_path / "jt.json"),
                                 metrics_out=str(tmp_path / "jm.jsonl"), meta=meta)
        assert jview.check([paths["trace"], paths["metrics"]]) == 0
        assert tview.check([paths["trace"], paths["metrics"]]) == 0
        assert tview.check([jpaths["trace"], jpaths["metrics"]]) == 0
    assert "span summary" in out.getvalue() and "telemetry summary" in out.getvalue()
    header, events = j_read_metrics_jsonl(paths["metrics"])
    assert header == {"schema": "repro-obs-v1", "kind": "metrics", **meta}
    assert events == trun.telemetry.metrics.events()
    header, events = read_metrics_jsonl(jpaths["metrics"])
    assert header["schema"] == "repro-obs-v1" and obs.validate_metric_events(events) == []
    with open(paths["trace"]) as f:
        doc = json.load(f)
    assert doc["otherData"] == {"schema": "repro-obs-v1", **meta}
    assert [e["name"] for e in doc["traceEvents"]] == [
        e["name"] for e in trun.telemetry.tracer.events]


def test_traced_history_is_the_plain_loops():
    """Telemetry records around the one round loop and changes nothing
    it returns: the same history fields as without it, the same numbers."""
    spec = dict(LOCAL, rounds=2)
    traced = build_run(RunSpec(**spec), device="cpu")
    plain = build_run(RunSpec(**{**spec, "telemetry": False}), device="cpu")
    assert not plain.telemetry.enabled and plain.channel.telemetry is obs.NULL_TELEMETRY
    _, th = traced.run()
    _, ph = plain.run()
    assert sorted(th) == sorted(ph)
    for k in th:
        assert th[k] == ph[k], k


def test_cli_writes_files_both_checkers_accept(tmp_path):
    from repro_torch.launch.train import main as train_main
    from repro_torch.run.__main__ import main

    files = []
    for name, entry, extra in (
            ("run", main, ["--backend", "gspmd", "--fast", "--flat-engine", "hist"]),
            ("train", train_main, ["--preset", "paper-lstm", "--measure-wire"])):
        trace, metrics = str(tmp_path / f"{name}.json"), str(tmp_path / f"{name}.jsonl")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            entry(["--preset", "charlstm", "--sparsity", "0.01", "--rounds", "2",
                   "--batch", "2", "--seq-len", "8", "--clients", "2", "--device", "cpu",
                   "--trace", trace, "--metrics-out", metrics, *extra])
        assert f"wrote {trace}" in out.getvalue() and f"wrote {metrics}" in out.getvalue()
        files += [trace, metrics]
    with contextlib.redirect_stdout(io.StringIO()):
        assert jview.check(files) == 0
        assert tview.main(["--check", *files]) == 0
        assert tview.main([files[1]]) == 0
        assert tview.main(["--diff", files[1], files[3]]) == 0


# ------------------------------------------------------------- the pieces


class _FakeCuda:
    """Stands in for a CUDA tensor: the fence reads ``is_cuda`` and
    ``device`` only."""

    is_cuda = True

    def __init__(self, index):
        self.device = torch.device("cuda", index)


def test_fence_synchronizes_each_cuda_device_once(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: calls.append(dev))
    tree = {"a": [_FakeCuda(0), _FakeCuda(0)], "b": (_FakeCuda(1), torch.zeros(3)),
            "c": TrainState(torch.zeros(2), (), None, _FakeCuda(1))}
    tracer = obs.Tracer()
    assert tracer.fence(tree) is tree
    assert sorted(calls, key=str) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    calls.clear()
    assert tracer.fence({"cpu": torch.zeros(4)}) is not None and calls == []
    assert tracer.fence(None) is None and calls == []
    assert obs.NULL_TRACER.fence(tree) is tree and obs.NULL_TELEMETRY.fence(tree) is tree
    assert calls == []


def test_telemetry_off_never_synchronizes(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called with telemetry off")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    for spec in (dict(LOCAL, telemetry=False), dict(GSPMD, telemetry=False)):
        run = build_run(RunSpec(**spec), device="cpu")
        assert run.telemetry is obs.NULL_TELEMETRY and not run.telemetry.enabled
        run.run()
    x = {"w": torch.ones(2)}
    assert obs.NULL_TELEMETRY.fence(x) is x
    assert obs.NULL_TELEMETRY.span("round", round=0) is obs.NULL_TRACER.span("encode")
    assert obs.NULL_TELEMETRY.metrics.events() == [] and obs.NULL_METRICS.summary() == {}


def test_span_validation_matches_the_references():
    tr = obs.Tracer()
    with tr.span("round", round=0):
        with tr.span("exchange", round=0, fused=True):
            pass
        tr.instant("encode", round=0)
    assert obs.validate_span_events(tr.events) == jobs.validate_span_events(tr.events) == []
    bad = [dict(tr.events[0], dur_us=-1.0), dict(tr.events[1], name="nope"),
           {"type": "mystery"}, dict(tr.events[0], id=99, parent=42)]
    assert obs.validate_span_events(bad) == jobs.validate_span_events(bad)
    assert len(obs.validate_span_events(bad)) >= 4
    assert tr.chrome_events()[0]["ph"] == "X"


def test_registry_rules_match_the_references():
    for reg in (obs.MetricsRegistry(), jobs.MetricsRegistry()):
        with pytest.raises(KeyError):
            reg.gauge("train/nope", 1.0)
        with pytest.raises(TypeError):
            reg.counter("train/loss", 1.0)
        reg.gauge("leaf/n", 5, leaf="w")
        reg.counter("obs/rounds")
    bad = [{"type": "metric", "kind": "counter", "name": "leaf/n", "value": "x", "tags": []},
           {"type": "span"}]
    assert obs.validate_metric_events(bad) == jobs.validate_metric_events(bad)
    rows = [("a", 1, 2.5), ("bb", 10, 0.125)]
    assert render_table(("x", "n", "v"), rows, title="t") == jobs.render_table(
        ("x", "n", "v"), rows, title="t")


def test_ingest_ledger_is_bit_exact():
    from repro_torch.core.ledger import BandwidthLedger

    led = BandwidthLedger()
    for r, bits in enumerate((0.1, 0.2, 0.3)):
        led.record_up(r, clients=(0, 1), up_bytes=7 + r, up_bits_measured=bits,
                      up_bits_analytic=bits * 3)
    reg = obs.MetricsRegistry()
    reg.ingest_ledger(led)
    assert [s["value"] for s in reg.series("wire/up_bits_measured")] == [0.1, 0.2, 0.3]
    assert sum(s["value"] for s in reg.series("obs/rounds")) == 3
