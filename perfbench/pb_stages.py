"""The program's stage clock (``repro_torch.obs.stages``) read in a cell,
beside the harness's own timings of the same intervals.

    python3 perfbench/pb_stages.py --workload <cell> --seed <n> --seconds <s>

Sets the cell up as ``run.py`` does (its hooks on the built objects), then
attaches an enabled stage clock to the program's channel and measures:

  * ``agree``: one traced window of ``--seconds`` (``run.window``), the
    clock drained after its closing synchronise: each stage's mean device
    and host ms a round beside ``models.forward_ms``,
    ``train.backward_update_ms`` and ``channel.exchange_ms``, and the
    share of ``train.step`` its five children cover;
  * ``cost``: tokens/s in windows of ``--cost-seconds`` with the clock
    off, on, on, off, ``--cost-repeats`` times (the hooks idle in all),
    one process, and the host µs one stage costs;
  * ``device``: a device-only profile of the traffic's ``trace_rounds``
    rounds with the clock on: ``pb_cupti.device_summary``'s operations a
    round, and the device-side records named after a stage;
  * ``stages``: a host-and-device profile of as many rounds reduced by
    :func:`stage_breakdown`.

The last line of standard output is the result's JSON.  It exits with 3
when there is no card, or when the program has no stage clock.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import statistics
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for sub in (BENCH, BENCH / "reference"):
    if str(sub) not in sys.path:
        sys.path.insert(0, str(sub))

import torch  # noqa: E402

import pb_cupti  # noqa: E402
import pb_spec  # noqa: E402
import pb_traffic  # noqa: E402

NO_STAGE = "no stage"


def stage_breakdown(events: list, names, round_range: str) -> dict:
    """A profile of rounds (each inside a ``round_range`` range) by program
    stage (the host ranges named in ``names``): each idle gap of the
    stretch (from the first round's start on the host to the last device
    operation's end) put down to the innermost stage open on the host
    when it began, and each device operation to the innermost stage open
    at its launch (the runtime call of its correlation id).  Returns
    ``{"idle_s": {stage: s}, "ops": {stage: n}, "device_s": {stage: s},
    "window_s", "rounds", "shadows", "shadows_flagged"}``; ``NO_STAGE``
    holds what falls under none.  The device-side records named after a
    stage are no device operations: ``shadows`` counts them, and
    ``shadows_flagged`` those ``is_user_annotation()`` marks."""
    names = set(names)
    cuda = torch.autograd.DeviceType.CUDA
    shadows = [e for e in events if e.device_type() == cuda and e.name() in names]
    device = [e for e in events if pb_cupti._is_device(e) and e.name() not in names]
    host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    rounds = sorted(e.start_ns() for e in host if e.name() == round_range)
    if not device or not rounds:
        return {}
    ranges = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host if e.name() in names)
    starts = [r[0] for r in ranges]

    def innermost(at: int) -> str:
        # nested ranges of one thread: the latest-starting one still open
        for j in range(bisect.bisect_right(starts, at) - 1, -1, -1):
            if ranges[j][1] > at:
                return ranges[j][2]
        return NO_STAGE

    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    ops, device_ns = collections.Counter(), collections.Counter()
    for e in device:
        at = launch.get(e.correlation_id())
        name = innermost(at) if at is not None else "unmatched"
        ops[name] += 1
        device_ns[name] += e.duration_ns()
    t0, t1 = rounds[0], max(e.end_ns() for e in device)
    busy = pb_cupti._union([(max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in device
                            if e.end_ns() > t0 and min(e.end_ns(), t1) > max(e.start_ns(), t0)])
    idle = collections.Counter()
    edges = [[t0, t0]] + busy
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            idle[innermost(a)] += b - a
    return {"window_s": (t1 - t0) / 1e9, "rounds": len(rounds),
            "idle_s": {k: v / 1e9 for k, v in idle.most_common()},
            "ops": dict(ops.most_common()),
            "device_s": {k: v / 1e9 for k, v in device_ns.most_common()},
            "shadows": len(shadows),
            "shadows_flagged": sum(1 for e in shadows if e.is_user_annotation())}


def _mean_stages(drained: list) -> dict:
    """``{stage: {"device_ms", "host_ms"}}``, the means over the rounds."""
    out = {}
    for name in drained[0]:
        out[name] = {k: statistics.fmean(per[name][k] for per in drained)
                     for k in ("device_ms", "host_ms")}
    return out


class Cell:
    """The built cell and its one live state: each phase hands the state on
    through :attr:`state`, so no caller's frame keeps an older one alive
    (``run.py``'s ``run_cell`` holds one state across its window; so does
    this)."""

    def __init__(self, bench, run, state, r: int, device, hooks, clock):
        self.bench, self.run, self.state, self.r = bench, run, state, r
        self.device, self.hooks, self.clock = device, hooks, clock

    def window(self, seconds: float, trace: bool) -> dict:
        self.state, self.r, ctx = self.bench.window(self.run, self.state, self.r, seconds,
                                                    self.device, self.hooks, trace)
        return ctx

    def rounds(self, n: int) -> None:
        for _ in range(n):
            with torch.profiler.record_function(self.bench.ROUND_RANGE):
                self.state, _ = self.run.step(self.state, self.r)
            self.r += 1


def agree(cell: Cell, seconds: float) -> dict:
    """One traced window; the stages beside the hooks' spans."""
    ctx = cell.window(seconds, True)
    drained = cell.clock.drain()
    means = _mean_stages(drained)
    outside = {k: statistics.fmean(v) for k, v in ctx["spans"].items()}
    children = ("train.forward", "train.backward", "train.optimizer", "train.exchange",
                "train.apply")
    covered = [sum(per[c]["device_ms"] for c in children) / per["train.step"]["device_ms"]
               for per in drained]
    return {
        "rounds": ctx["rounds"], "stages": means, "outside": outside,
        "host_issue_ms": statistics.fmean(ctx["host_issue_ms"]),
        "forward_vs": means["train.forward"]["device_ms"] / outside["forward"] - 1,
        "exchange_vs": means["train.exchange"]["device_ms"] / outside["exchange"] - 1,
        "backward_optimizer_vs": (means["train.backward"]["device_ms"]
                                  + means["train.optimizer"]["device_ms"])
        / outside["backward_update"] - 1,
        "children_cover_min": min(covered), "children_cover_mean": statistics.fmean(covered),
    }


def cost(cell: Cell, seconds: float, repeats: int, tokens: int) -> dict:
    """tokens/s in windows with the clock off, on, on, off, ``repeats``
    times; and the host µs a stage costs (its two events and its range,
    10,000 stages with no work inside, on events made before)."""
    from repro_torch.obs import NULL_TELEMETRY

    tel = cell.run.channel.telemetry
    windows = []
    for on in (False, True, True, False) * repeats:
        cell.run.channel.telemetry = tel if on else NULL_TELEMETRY
        ctx = cell.window(seconds, False)
        cell.clock.drain()
        windows.append({"clock": on, "rounds": ctx["rounds"],
                        "tokens_per_s": ctx["rounds"] * tokens / ctx["window_s"]})
    cell.run.channel.telemetry = tel
    n = 10_000
    for timed in (False, True):  # the first pass makes the events the second reuses
        t = time.perf_counter()
        for _ in range(n):
            with cell.clock.stage("train.step"):
                pass
        stage_us = (time.perf_counter() - t) / n * 1e6
        torch.cuda.synchronize(cell.device)
        cell.clock.drain()
    on = [w["tokens_per_s"] for w in windows if w["clock"]]
    off = [w["tokens_per_s"] for w in windows if not w["clock"]]
    return {"windows": windows, "on_over_off": statistics.fmean(on) / statistics.fmean(off) - 1,
            "stage_host_us": stage_us}


def profiles(cell: Cell, n: int, names) -> dict:
    """A device-only, then a host-and-device, profile of ``n`` rounds."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            pb_cupti.lead_in()
            cell.rounds(n)
            pb_cupti.lead_out()
            torch.cuda.synchronize()
        cell.clock.drain()
        events = prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        shadows = [e for e in events if e.device_type() == cuda and e.name() in names]
        if len(activities) == 1:
            summ = pb_cupti.device_summary(events, n)
            out["device"] = dict(summ, ops_per_round=summ["ops"] / n,
                                 idle_pct=100.0 * (1 - summ["busy_s"] / summ["window_s"]),
                                 shadows=len(shadows),
                                 shadows_flagged=sum(e.is_user_annotation() for e in shadows))
        else:
            out["stages"] = stage_breakdown(events, names, cell.bench.ROUND_RANGE)
            out["harness"] = pb_cupti.reduce_trace(events, "pb.exchange", cell.bench.ROUND_RANGE)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost-seconds", type=float, default=0.0)
    ap.add_argument("--cost-repeats", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pb_stages: needs a CUDA card", file=sys.stderr)
        return 3
    try:
        import pb_program  # noqa: F401  (puts the program's src/ on the path)
        from repro_torch.obs import STAGE_NAMES, StageClock, Telemetry
    except ImportError as exc:
        print(f"pb_stages: the program has no stage clock: {exc}", file=sys.stderr)
        return 3
    import run as bench

    device = torch.device("cuda", 0)
    spec = pb_spec.load(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    hooks = bench.Hooks(device)
    built = bench.set_up(spec, args.seed, device, hooks)
    clock = StageClock(device)
    cell = Cell(bench, built[0], built[1], built[2], device, hooks, clock)
    del built
    cell.run.channel.telemetry = Telemetry(stages=clock)
    cell.rounds(2)  # the clock's events made, outside every window
    bench.sync(device)
    clock.drain()
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(device)}
    t = time.perf_counter()
    out["agree"] = agree(cell, args.seconds)
    if args.cost_seconds:
        out["cost"] = cost(cell, args.cost_seconds, args.cost_repeats,
                           pb_traffic.tokens_per_round(spec["traffic"]))
    out.update(profiles(cell, spec["traffic"]["trace_rounds"], STAGE_NAMES))
    out["measured_s"] = time.perf_counter() - t
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
