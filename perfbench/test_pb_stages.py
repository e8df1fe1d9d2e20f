"""CPU tests of ``pb_stages.stage_breakdown`` on a hand-made profile: each
idle gap goes to the innermost program stage open on the host when it
began, each device operation to the stage open at its launch, and the
stages' device-side records count as no operation.

    python -m pytest -q perfbench/test_pb_stages.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import pb_stages  # noqa: E402

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
NAMES = ("train.step", "train.forward", "train.backward")


class Ev:
    """The fields of a Kineto event that the reduction reads."""

    def __init__(self, name, dev, start, end, corr=0, annotation=False):
        self._name, self._dev, self._s, self._e = name, dev, start, end
        self._corr, self._ann = corr, annotation

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._ann


def _profile():
    """One round, 0–100 ns on the host: ``train.step`` (0–99) over
    ``train.forward`` (10–40) and ``train.backward`` (50–90); three
    kernels launched at 15, 55 and 60; the device idle 0–20 (opened in
    the step, before the forward), 30–58 (in the forward) and 70–75 (in
    the backward)."""
    return [
        Ev("pb.round", CPU, 0, 100),
        Ev("train.step", CPU, 0, 99),
        Ev("train.forward", CPU, 10, 40),
        Ev("train.backward", CPU, 50, 90),
        Ev("cudaLaunchKernel", CPU, 15, 16, corr=1),
        Ev("cudaLaunchKernel", CPU, 55, 56, corr=2),
        Ev("cudaLaunchKernel", CPU, 60, 61, corr=3),
        Ev("gemm", CUDA, 20, 30, corr=1),
        Ev("gemm_bwd", CUDA, 58, 70, corr=2),
        Ev("add", CUDA, 75, 80, corr=3),
        # the device-side shadows of two ranges: no operations
        Ev("train.forward", CUDA, 20, 30, annotation=True),
        Ev("train.backward", CUDA, 58, 80, annotation=True),
    ]


def test_idle_and_operations_go_to_the_innermost_stage():
    out = pb_stages.stage_breakdown(_profile(), NAMES, "pb.round")
    assert out["rounds"] == 1 and out["window_s"] == 80 / 1e9
    assert out["idle_s"] == {"train.forward": 28 / 1e9, "train.step": 20 / 1e9,
                             "train.backward": 5 / 1e9}
    assert out["ops"] == {"train.forward": 1, "train.backward": 2}
    assert out["device_s"] == {"train.forward": 10 / 1e9, "train.backward": 17 / 1e9}
    assert out["shadows"] == out["shadows_flagged"] == 2


def test_what_falls_under_no_stage_is_named_so():
    # a copy launched at 99, after the step closed, runs 110–120: the gap
    # 80–110 began in the backward
    events = _profile() + [Ev("cudaLaunchKernel", CPU, 99, 100, corr=4),
                           Ev("copy", CUDA, 110, 120, corr=4)]
    out = pb_stages.stage_breakdown(events, NAMES, "pb.round")
    assert out["idle_s"]["train.backward"] == 35 / 1e9
    assert out["ops"][pb_stages.NO_STAGE] == 1
    # an operation whose launch the trace lost, after a gap that began with
    # no range open
    events.append(Ev("late", CUDA, 130, 140, corr=5))
    out = pb_stages.stage_breakdown(events, NAMES, "pb.round")
    assert out["idle_s"][pb_stages.NO_STAGE] == 10 / 1e9
    assert out["ops"]["unmatched"] == 1
