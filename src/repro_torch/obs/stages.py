"""Device-timed stages of the GSPMD train step and its flat exchange.

The port's own taxonomy, apart from the reference's ``repro-obs-v1`` span
names (:data:`~repro_torch.obs.trace.SPAN_NAMES`): every name in
:data:`STAGE_NAMES` carries a dot.  ``launch/dist.py``'s step opens one
``train.step`` a round with its five children in order, and the hist
engine (``core/channel.py`` ``exchange_flat``, ``core/flat.py``
``exchange_local_hist``) opens the ``exchange.*`` stages under
``train.exchange``.

:meth:`StageClock.stage` is a context manager that, on entry and on exit,
records a ``torch.cuda.Event(enable_timing=True)`` on the current stream
of the clock's CUDA device (none with no device: the CPU runs each op as
it is issued), reads ``time.perf_counter_ns()``, and, while a profiler
is active, opens or closes a ``torch.profiler.record_function`` range of
the stage's name, so that each stage is a host range in the same Kineto
trace as CUPTI's device records.  Nothing here waits for the device:
:meth:`StageClock.drain` is called by a caller that has synchronised
(``run_rounds`` does, through the round's loss), resolves the closed
rounds' device and host milliseconds, folds them into per-stage running
sums and hands their events back to a pool; an event that is not done
raises.

:data:`NULL_STAGES` is the disabled twin: ``stage()`` returns one shared
no-op context manager, so with telemetry off a stage costs an attribute
lookup and an empty ``with``.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.obs.export import render_table
from repro_torch.obs.trace import _NULL_SPAN

# name -> what the stage covers; the order is the step's
STAGE_NAMES: Dict[str, str] = {
    "train.step": "one round of the GSPMD train step (the root of a round)",
    "train.forward": "model.loss_fn: the forward pass and the loss",
    "train.backward": "torch.autograd.grad of the loss",
    "train.optimizer": "the local optimizer's apply and the ΔW tree",
    "train.exchange": "channel.round_exchange: compression and the exchange",
    "train.apply": "the mean into the params, momentum masking and the loss mean",
    "exchange.flatten": "the ΔW leaves into the flat buffer, plus the residual",
    "exchange.select": "|x| max and both seg_hist2side passes with their thresholds",
    "exchange.moments": "seg_moments and each segment's μ",
    "exchange.binarize": "seg_binarize_apply: ΔW* and the new residual",
    "exchange.mean": "the group's pmean of ΔW* (nothing at one client)",
    "exchange.unflatten": "the flat mean and ΔW* back into leaves",
}


class _Stage:
    """One stage of one round; times itself on exit."""

    __slots__ = ("_clock", "name", "parent", "round", "depth", "_range", "_ev0", "_ev1",
                 "_t0", "_t1")

    def __init__(self, clock: "StageClock", name: str):
        self._clock = clock
        self.name = name

    def __enter__(self) -> "_Stage":
        clock = self._clock
        stack = clock._stack
        if stack:
            parent = stack[-1]
            self.parent, self.round, self.depth = parent.name, parent.round, parent.depth + 1
        else:  # the root opens a new round
            clock._round += 1
            clock._open = []
            self.parent, self.round, self.depth = None, clock._round, 0
        clock._open.append(self)
        stack.append(self)
        self._range = None
        if clock._torch.autograd._profiler_enabled():  # a range costs ~14 µs of host
            self._range = clock._torch.profiler.record_function(self.name)
            self._range.__enter__()
        self._ev0 = clock._record()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._t1 = time.perf_counter_ns()
        clock = self._clock
        self._ev1 = clock._record()
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        if not clock._stack or clock._stack[-1] is not self:
            raise RuntimeError(f"stage {self.name!r} closed out of order")
        clock._stack.pop()
        if not clock._stack:
            clock._closed.append(clock._open)
            clock._open = None
        return False


class StageClock:
    """Records :data:`STAGE_NAMES` stages as CUDA events on ``device``'s
    current stream (host clock only when ``device`` is None or not a CUDA
    device) and host ranges, never synchronising.

    Spans nest; the root (a stage opened with none open) opens a new
    round.  :meth:`drain` resolves the rounds whose root has closed;
    :attr:`totals` holds the running sums of every drained round."""

    enabled = True

    def __init__(self, device=None):
        import torch

        self._torch = torch
        self.device = None if device is None else torch.device(device)
        self.cuda = self.device is not None and self.device.type == "cuda"
        self._stack: List[_Stage] = []
        self._open: Optional[List[_Stage]] = None  # the open round's stages
        self._closed: List[List[_Stage]] = []  # rounds closed, not drained
        self._round = -1
        self._free: list = []  # events handed back by drain
        # stage -> {"rounds", "device_ms", "host_ms", "depth"}, drained rounds
        self.totals: Dict[str, dict] = {}

    def stage(self, name: str) -> _Stage:
        """``with clock.stage("train.forward"): ...``"""
        if name not in STAGE_NAMES:
            raise ValueError(f"stage {name!r} is not in STAGE_NAMES")
        return _Stage(self, name)

    def _record(self):
        if not self.cuda:
            return None
        ev = self._free.pop() if self._free else self._torch.cuda.Event(enable_timing=True)
        ev.record(self._torch.cuda.current_stream(self.device))
        return ev

    def drain(self) -> List[Dict[str, dict]]:
        """The rounds closed since the last drain, in order, each
        ``{stage: {"device_ms", "host_ms", "parent"}}`` in the order the
        stages opened (a stage opened twice in a round sums;
        ``device_ms`` is None without a CUDA device).  Folds them into
        :attr:`totals` and frees their events.  The caller has
        synchronised the device: an event that is not done raises
        ``RuntimeError``, and nothing is drained then."""
        if self.cuda:
            for rnd in self._closed:
                for st in rnd:
                    if not st._ev1.query():
                        raise RuntimeError(
                            f"stage {st.name!r} of round {st.round} is not done on the "
                            "device: drain after a synchronise")
        out = []
        for rnd in self._closed:
            per: Dict[str, dict] = {}
            for st in rnd:
                dev = st._ev0.elapsed_time(st._ev1) if self.cuda else None
                host = (st._t1 - st._t0) / 1e6
                got = per.get(st.name)
                if got is None:
                    per[st.name] = {"device_ms": dev, "host_ms": host, "parent": st.parent}
                    tot = self.totals.setdefault(
                        st.name, {"rounds": 0, "device_ms": None if dev is None else 0.0,
                                  "host_ms": 0.0, "depth": st.depth})
                    tot["rounds"] += 1
                else:
                    got["host_ms"] += host
                    if dev is not None:
                        got["device_ms"] += dev
                    tot = self.totals[st.name]
                tot["host_ms"] += host
                if dev is not None:
                    tot["device_ms"] += dev
                if self.cuda:
                    self._free += (st._ev0, st._ev1)
                st._ev0 = st._ev1 = None
            out.append(per)
        self._closed = []
        return out

    def summary(self) -> Dict[str, dict]:
        """``{stage: {"rounds", "device_ms", "host_ms"}}``, each the mean a
        round over the drained rounds that opened it."""
        def mean(v, n):
            return None if v is None else v / n

        return {name: {"rounds": t["rounds"], "device_ms": mean(t["device_ms"], t["rounds"]),
                       "host_ms": mean(t["host_ms"], t["rounds"])}
                for name, t in self.totals.items()}


class NullStages:
    """The disabled clock: every stage is the shared no-op context."""

    enabled = False

    __slots__ = ()

    def stage(self, name: str):
        return _NULL_SPAN

    def drain(self) -> list:
        return []

    def summary(self) -> dict:
        return {}


NULL_STAGES = NullStages()


def stage_table(clock) -> str:
    """The console table of ``clock``'s drained rounds: the mean device ms
    and host ms a round of each stage, children indented under their
    parent, in :data:`STAGE_NAMES` order."""
    summ = clock.summary()
    rows = []
    for name in sorted(summ, key=list(STAGE_NAMES).index):
        s = summ[name]
        dev = "-" if s["device_ms"] is None else round(s["device_ms"], 3)
        rows.append(("  " * clock.totals[name]["depth"] + name, s["rounds"], dev,
                     round(s["host_ms"], 3)))
    return render_table(("stage", "rounds", "device ms", "host ms"), rows,
                        title="stage summary (mean a round)")
