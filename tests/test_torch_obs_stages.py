"""The port's stage clock (``repro_torch.obs.stages``): device-timed
stages of the GSPMD train step and its hist exchange.

CPU tests drive CharLSTM on the gspmd backend's hist engine: the stages
each round opens and their nesting, that the clock never waits for the
device (``torch.cuda.synchronize`` patched to raise, and stand-in CUDA
events that record where the clock would launch one), that its stages
are profiler ranges while a profiler is active and only then, that the params
are bitwise the same with the clock on and off, that the disabled clock
opens nothing, and that a traced run's ``repro-obs-v1`` files still pass
both checkers.  The test marked ``cuda`` holds the children of
``train.step`` to at least 97% of its device time on the card; the file
imports no JAX at its top, so there it runs as ``PYTHONPATH=src python
-m pytest --noconftest tests/test_torch_obs_stages.py -k cuda``.
"""
import contextlib
import io
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.core.tree import tree_flatten
from repro_torch.obs import view as tview
from repro_torch.run import RunSpec, build_run
from torch_helpers import cuda, torch_one_thread  # noqa: F401  (fixtures)

HIST = dict(preset="charlstm", backend="gspmd", fast=True, flat_engine="hist", batch=2,
            seq_len=8, sparsity=0.01, rounds=3)
CHILDREN = ["train.forward", "train.backward", "train.optimizer", "train.exchange",
            "train.apply"]
EXCHANGE = ["exchange.flatten", "exchange.select", "exchange.moments", "exchange.binarize",
            "exchange.mean", "exchange.unflatten"]


class _Event:
    """A stand-in ``torch.cuda.Event``: the host's clock at ``record``."""

    made = 0

    def __init__(self, enable_timing: bool = False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter_ns()

    def query(self) -> bool:
        return self.t is not None

    def elapsed_time(self, end: "_Event") -> float:
        return (end.t - self.t) / 1e6


@pytest.fixture
def fake_cuda_events(monkeypatch):
    """A clock that takes the CUDA path on the CPU, with stand-in events
    and ``torch.cuda.synchronize`` raising."""
    def boom(*a, **k):
        raise AssertionError("torch.cuda.synchronize called with the stage clock on")

    _Event.made = 0
    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return obs.StageClock("cuda")


def _run(clock=None, **over):
    run = build_run(RunSpec(**dict(HIST, **over)), device="cpu")
    if clock is not None:
        run.channel.telemetry = obs.Telemetry(stages=clock)
    return run


def _drive(run, rounds: int, drain=None) -> tuple:
    state, drained = run.init(), []
    for r in range(rounds):
        state, m = run.step(state, r)
        float(m["loss"])
        if drain is not None:
            drained += drain()
    return state, drained


@pytest.mark.usefixtures("torch_one_thread")
def test_each_round_records_the_step_and_the_exchange_stages_in_order(fake_cuda_events):
    clock = fake_cuda_events
    _, rounds = _drive(_run(clock), 3, clock.drain)
    assert len(rounds) == 3
    for per in rounds:
        assert list(per) == ["train.step"] + CHILDREN[:4] + EXCHANGE + CHILDREN[4:]
        assert per["train.step"]["parent"] is None
        assert all(per[c]["parent"] == "train.step" for c in CHILDREN)
        assert all(per[c]["parent"] == "train.exchange" for c in EXCHANGE)
        for name, s in per.items():
            assert s["device_ms"] >= 0 and s["host_ms"] >= 0, name
        assert sum(per[c]["device_ms"] for c in CHILDREN) <= per["train.step"]["device_ms"]
    # two events a stage, made once and reused after each drain
    assert _Event.made == 2 * (1 + len(CHILDREN) + len(EXCHANGE))
    summ = clock.summary()
    assert list(summ) == list(rounds[0]) and all(s["rounds"] == 3 for s in summ.values())
    assert clock.drain() == []


@pytest.mark.usefixtures("torch_one_thread")
def test_the_clock_never_synchronizes_and_drain_refuses_work_not_done(fake_cuda_events):
    clock = fake_cuda_events
    run = _run(clock)
    _drive(run, 2)  # torch.cuda.synchronize raises: never called
    first = clock._closed[0][0]
    first._ev1.t = None  # as if the device had not reached it
    with pytest.raises(RuntimeError, match="not done on the device"):
        clock.drain()
    assert len(clock._closed) == 2 and clock.totals == {}


@pytest.mark.usefixtures("torch_one_thread")
def test_params_are_bitwise_the_same_with_the_clock_on_and_off():
    on, off = _drive(_run(obs.StageClock()), 3)[0], _drive(_run(), 3)[0]
    a, b = tree_flatten(on)[0], tree_flatten(off)[0]
    assert len(a) == len(b) > 3 and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.usefixtures("torch_one_thread")
def test_the_disabled_clock_opens_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the disabled clock opened a range or an event")

    assert obs.NULL_STAGES.stage("train.step") is obs.NULL_STAGES.stage("exchange.mean")
    assert obs.NULL_STAGES.stage("train.step") is obs.NULL_TRACER.span("round")
    assert obs.NULL_TELEMETRY.stages is obs.NULL_STAGES and not obs.NULL_STAGES.enabled
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    run = _run()
    assert run.channel.telemetry.stages is obs.NULL_STAGES
    run.run()
    assert obs.NULL_STAGES.drain() == [] and obs.NULL_STAGES.summary() == {}


@pytest.mark.usefixtures("torch_one_thread")
def test_stages_are_profiler_ranges_under_a_profiler_alone(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    clock = obs.StageClock()
    run = _run(clock)
    state = run.init()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = run.step(state, 0)
    names = {e.name for e in prof.events()}
    assert set(obs.STAGE_NAMES) <= names

    def boom(*a, **k):
        raise AssertionError("a range opened with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    run.step(state, 1)
    assert [r["train.step"]["parent"] for r in clock.drain()] == [None, None]


def test_stage_names_are_the_ports_own():
    assert not set(obs.STAGE_NAMES) & set(obs.SPAN_NAMES)
    assert all("." in name for name in obs.STAGE_NAMES)
    assert set(CHILDREN + EXCHANGE + ["train.step"]) == set(obs.STAGE_NAMES)
    with pytest.raises(ValueError, match="not in STAGE_NAMES"):
        obs.StageClock().stage("round")


@pytest.mark.usefixtures("torch_one_thread")
def test_a_traced_run_with_the_clock_passes_both_checkers(tmp_path):
    from repro.obs import view as jview

    run = _run(telemetry=True)
    assert isinstance(run.telemetry.stages, obs.StageClock)
    assert run.channel.telemetry is run.telemetry
    run.run()
    assert run.telemetry.stages.summary()["train.step"]["rounds"] == HIST["rounds"]
    assert not run.telemetry.stages._closed  # run_rounds drained every round
    with contextlib.redirect_stdout(io.StringIO()) as out:
        paths = obs.finish_run(run.telemetry, trace=str(tmp_path / "t.json"),
                               metrics_out=str(tmp_path / "m.jsonl"))
        assert jview.check([paths["trace"], paths["metrics"]]) == 0
        assert tview.check([paths["trace"], paths["metrics"]]) == 0
    table = out.getvalue().split("stage summary (mean a round)")[1]
    for name in ["train.step"] + CHILDREN + EXCHANGE:
        assert name in table
    assert "  exchange.select" in table


@pytest.mark.cuda
def test_the_step_children_cover_its_device_time(cuda):
    """lm-100m at its full width, where the device, not the host, sets
    the round's pace; the rounds after two warm-up rounds."""
    run = build_run(RunSpec(preset="lm-100m", backend="gspmd", fast=True, flat_engine="hist",
                            batch=8, seq_len=256, sparsity=0.001, telemetry=True),
                    device=cuda)
    clock = run.telemetry.stages
    _, rounds = _drive(run, 6, clock.drain)
    for per in rounds[2:]:
        step = per["train.step"]["device_ms"]
        children = sum(per[c]["device_ms"] for c in CHILDREN)
        assert children >= 0.97 * step, (children, step)
        exchange = sum(per[e]["device_ms"] for e in EXCHANGE)
        assert exchange <= per["train.exchange"]["device_ms"], (exchange, per)
