"""The port's sparsity schedules (``repro_torch.core.sparsity``) against
the JAX package's ``repro.core.sparsity``, on the CPU.

Both are plain Python on host floats, so every value must be equal, not
close: each schedule at rounds 0 to 200, the presets, the adaptive
controller under step and smooth LR schedules, and the Fig. 3 grid.
"""
import math

import pytest

from repro.core import sparsity as jsp
from repro_torch.core import sparsity as tsp

ROUNDS = range(201)


def same_schedule(port, ref):
    got = [port(r) for r in ROUNDS]
    want = [ref(r) for r in ROUNDS]
    assert got == want
    assert all(type(d) is int and type(p) is float for d, p in got)


@pytest.mark.parametrize("delay, sparsity", [(1, 0.001), (10, 0.01), (100, 0.01), (3, 1.0)])
def test_constant(delay, sparsity):
    same_schedule(tsp.constant(delay, sparsity), jsp.constant(delay, sparsity))


def test_constant_defaults():
    same_schedule(tsp.constant(), jsp.constant())


@pytest.mark.parametrize("name", ["sbc1", "sbc2", "sbc3"])
def test_preset(name):
    same_schedule(tsp.preset(name), jsp.preset(name))


def test_unknown_preset_raises_as_the_reference():
    with pytest.raises(KeyError):
        jsp.preset("sbc4")
    with pytest.raises(KeyError):
        tsp.preset("sbc4")


@pytest.mark.parametrize("target, warmup, start", [
    (0.001, 4, 0.25), (0.01, 4, 0.25), (0.001, 1, 0.25), (0.001, 10, 0.5), (0.1, 0, 0.25),
    (1e-4, 37, 0.9)])
def test_dgc_warmup(target, warmup, start):
    same_schedule(tsp.dgc_warmup(target, warmup, start), jsp.dgc_warmup(target, warmup, start))


def test_dgc_warmup_defaults():
    same_schedule(tsp.dgc_warmup(), jsp.dgc_warmup())
    assert tsp.dgc_warmup()(0) == (1, math.exp(math.log(0.25) * 0.75 + math.log(0.001) * 0.25))


def step_lr(base):
    return lambda r: base * (0.1 ** (r >= 50)) * (0.1 ** (r >= 120))


def smooth_lr(base):
    return lambda r: base * 0.97 ** r


@pytest.mark.parametrize("lr", ["step", "smooth", "constant"])
@pytest.mark.parametrize("total, max_delay, min_sparsity", [
    (0.001, 100, 1e-4), (1e-4, 100, 1e-4), (0.01, 10, 1e-3), (1e-5, 1000, 1e-6)])
def test_adaptive_total_budget(lr, total, max_delay, min_sparsity):
    base = 0.1
    sched = {"step": step_lr, "smooth": smooth_lr, "constant": lambda b: (lambda r: b)}[lr]
    same_schedule(
        tsp.adaptive_total_budget(total, sched(base), base, max_delay, min_sparsity),
        jsp.adaptive_total_budget(total, sched(base), base, max_delay, min_sparsity))


def test_grid_points():
    assert tsp.grid_points() == jsp.grid_points()
    assert tsp.grid_points((1, 7), (0.5,)) == jsp.grid_points((1, 7), (0.5,))
    assert len(tsp.grid_points()) == 28


def test_schedule_is_a_frozen_dataclass_with_the_reference_fields():
    import dataclasses

    assert [f.name for f in dataclasses.fields(tsp.SparsitySchedule)] == \
        [f.name for f in dataclasses.fields(jsp.SparsitySchedule)]
    with pytest.raises(dataclasses.FrozenInstanceError):
        tsp.constant().delay = None
