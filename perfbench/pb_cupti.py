"""The reduction of a profiled stretch of rounds to what the per-layer
metrics read, with CUPTI's device records taken through ``torch.profiler``.

The spin lead-in is a frozen copy of ``chip_smoke.py``'s (the repository
root's card script): the trace loses its first records, so a window
opens with ``LEAD_IN`` spin kernels that are not counted and closes with
``LEAD_OUT``.

:func:`device_summary` reduces a profile of the device alone to its
busy and idle time and its operations.  :func:`reduce_trace` takes the
raw Kineto events of a profile of host and device: the device
operations (kernels, copies, sets) and their union over the traced
window, each operation's launch on the host
(the runtime call of the same correlation id), the device time of the
operations launched inside the ``pb.exchange`` ranges, the operations
that took most time, and the idle gaps by the host op that was running
when each began.
"""
from __future__ import annotations

import bisect
import collections

import torch

SPIN_KERNEL = "spin_kernel"
LEAD_IN, LEAD_OUT, SPIN_CYCLES = 32, 8, 1000


def lead_in() -> None:
    for _ in range(LEAD_IN):
        torch.cuda._sleep(SPIN_CYCLES)


def lead_out() -> None:
    for _ in range(LEAD_OUT):
        torch.cuda._sleep(SPIN_CYCLES)


def _is_device(e) -> bool:
    """A device operation: not a spin kernel, and not the device-side
    shadow of a host range (whose name is the range's)."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()
            and SPIN_KERNEL not in e.name() and not e.name().startswith("pb."))


def _innermost(starts: list, hostops: list, at: int, reach: int = 400) -> str:
    """The name of the latest-starting host op running at ``at``."""
    i = bisect.bisect_right(starts, at)
    for j in range(i - 1, max(-1, i - 1 - reach), -1):
        if hostops[j][1] > at:
            return hostops[j][2]
    return "host idle"


def _union(intervals: list) -> list:
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def device_summary(events: list, rounds: int) -> dict:
    """``{window_s, busy_s, ops, rounds}`` of a profile of the device alone
    (no host events recorded, so the host issues as it does untraced):
    the window from the first device operation's start to the last one's
    end, busy the union of the operations in it."""
    device = [e for e in events if _is_device(e)]
    if not device:
        return {}
    t0 = min(e.start_ns() for e in device)
    t1 = max(e.end_ns() for e in device)
    busy = _union([(e.start_ns(), e.end_ns()) for e in device])
    return {"window_s": (t1 - t0) / 1e9, "busy_s": sum(b - a for a, b in busy) / 1e9,
            "ops": len(device), "rounds": rounds}


def reduce_trace(events: list, range_name: str, round_range: str, top: int = 10) -> dict:
    """What a profile of rounds (each inside a ``round_range`` range)
    holds: ``window_s`` (from the first round's start on the host to the
    last device operation's end), ``busy_s`` (the union of the device
    operations in it), ``ops`` (device operations), ``rounds``,
    ``range_s`` (device time of the operations launched inside
    ``range_name``), ``range_ops``, ``matched`` (operations whose launch
    was found), ``device_ops`` and ``idle_gaps`` (the ``top`` largest,
    ``[name, seconds]``)."""
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if e.device_type() == torch.autograd.DeviceType.CPU]
    rounds = sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == round_range)
    ranges = sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == range_name)
    if not device or not rounds:
        return {}
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    t0 = rounds[0][0]
    t1 = max(e.end_ns() for e in device)
    spans = [(max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in device
             if e.end_ns() > t0]
    busy = _union([s for s in spans if s[1] > s[0]])
    range_ns, range_ops, matched = 0, 0, 0
    for e in device:
        at = launch.get(e.correlation_id())
        if at is None:
            continue
        matched += 1
        if any(a <= at <= b for a, b in ranges):
            range_ns += e.duration_ns()
            range_ops += 1
    by_name = collections.Counter()
    for e in device:
        by_name[e.name()] += e.duration_ns()
    gaps = collections.Counter()
    hostops = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                     if not e.name().startswith(("cuda", "cu")))
    starts = [h[0] for h in hostops]
    edges = [[t0, t0]] + busy
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            gaps[_innermost(starts, hostops, a)] += b - a
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(b - a for a, b in busy) / 1e9,
        "ops": len(device),
        "rounds": len(rounds),
        "range_s": range_ns / 1e9,
        "range_ops": range_ops,
        "matched": matched,
        "device_ops": [[n[:120], ns / 1e9] for n, ns in by_name.most_common(top)],
        "idle_gaps": [[n[:120], ns / 1e9] for n, ns in gaps.most_common(top)],
    }
