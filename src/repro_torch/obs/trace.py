"""Round-structured tracing: nested spans with device-timing fences.

Counterpart of ``repro.obs.trace``.  The :class:`Tracer` records
*complete spans* — named, nested intervals with microsecond wall-clock
timestamps on the host clock — plus point-in-time instants.  One
communication round produces one ``round`` span whose children are the
stage spans of that backend (the taxonomy lives in ``SPAN_NAMES``, the
reference's, whole).

Device timing is only meaningful if the traced interval actually waits
for the device: a CUDA launch returns before the kernel finishes, so
every span that closes over device work calls :meth:`Tracer.fence` on
the outputs before exiting, which synchronizes each CUDA device that
holds a tensor of the tree (``torch.cuda.synchronize``) and nothing for
CPU tensors.  The fence is the identity on the disabled tracer — tracing
off means *no* added synchronization, not just no recorded events.

Zero-overhead-by-default: :data:`NULL_TRACER` is a singleton whose
``span()`` returns one shared no-op context manager and whose ``fence``
is identity.  Instrumented call sites hold a tracer unconditionally
(never ``if tracer:`` branches around device calls), so the disabled
cost is one attribute lookup and an empty ``with`` per stage per round.

No dependencies beyond the standard library (torch is imported lazily
and only by an *enabled* fence).
"""
from __future__ import annotations

import json
import time
from typing import Any, Dict, List

# The span taxonomy: the reference's, whole (tests/test_torch_obs.py holds
# the two equal), so either package's checker reads the other's traces.
SPAN_NAMES: Dict[str, str] = {
    "round": "one communication round (parent of all stage spans)",
    "select_quantize": "client-side selection + quantization compute",
    "encode": "host-side wire encoding (SBW1 pack / Golomb streams)",
    "exchange": "the exchange itself (jitted collective or wire transfer)",
    "decode": "server-side unpack of client uploads",
    "apply": "aggregate + apply the round update to the master weights",
    "plan": "serve-side catch-up planning for one lag class",
    "encode_stacked": "serve-side SBD1 stacked catch-up encode",
    "verify": "serve-side bit-exactness verification of applied plans",
}


class _Span:
    """One open span; records a complete-span event on exit."""

    __slots__ = ("_tracer", "name", "args", "id", "parent_id", "depth", "t0")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        tr = self._tracer
        self.id = tr._next_id
        tr._next_id += 1
        self.parent_id = tr._stack[-1].id if tr._stack else None
        self.depth = len(tr._stack)
        tr._stack.append(self)
        self.t0 = tr._now_us()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        t1 = tr._now_us()
        assert tr._stack and tr._stack[-1] is self, "span closed out of order"
        tr._stack.pop()
        tr.events.append({
            "type": "span",
            "name": self.name,
            "id": self.id,
            "parent": self.parent_id,
            "depth": self.depth,
            "ts_us": self.t0,
            "dur_us": t1 - self.t0,
            "args": self.args,
        })
        return False


class _NullSpan:
    """The shared no-op context manager the disabled tracer hands out."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class Tracer:
    """Collects nested spans + instants as JSONL-able event dicts."""

    enabled = True

    def __init__(self) -> None:
        self.events: List[dict] = []
        self._stack: List[_Span] = []
        self._next_id = 0
        self._epoch_ns = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._epoch_ns) / 1e3

    # -------------------------------------------------------------- recording

    def span(self, name: str, **args: Any) -> _Span:
        """Open a nested span: ``with tracer.span("encode", leaf=path): ...``"""
        return _Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        self.events.append({
            "type": "instant",
            "name": name,
            "ts_us": self._now_us(),
            "args": args,
        })

    def fence(self, x: Any) -> Any:
        """Block until ``x``'s device computation finished, so the
        enclosing span's duration covers the work it names: one
        ``torch.cuda.synchronize`` per CUDA device holding a tensor of the
        tree ``x``; none for CPU tensors.  Returns ``x``."""
        if x is not None:
            devices: set = set()
            _cuda_devices(x, devices)
            if devices:
                import torch

                for dev in devices:
                    torch.cuda.synchronize(dev)
        return x

    # -------------------------------------------------------------- exporting

    def chrome_events(self) -> List[dict]:
        """Chrome/Perfetto ``traceEvents`` (complete-span ``ph: "X"``)."""
        out = []
        for e in self.events:
            if e["type"] == "span":
                out.append({
                    "ph": "X", "name": e["name"], "cat": "repro",
                    "ts": e["ts_us"], "dur": e["dur_us"],
                    "pid": 0, "tid": 0, "args": e["args"],
                })
            elif e["type"] == "instant":
                out.append({
                    "ph": "i", "name": e["name"], "cat": "repro",
                    "ts": e["ts_us"], "pid": 0, "tid": 0, "s": "t",
                    "args": e["args"],
                })
        return out

    def write_chrome(self, path: str) -> str:
        """Write a Perfetto-loadable ``trace.json`` (ui.perfetto.dev and
        chrome://tracing both open it); returns ``path``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}, f)
        return path


class NullTracer:
    """All no-ops; ``fence`` is identity (adds NO synchronization)."""

    enabled = False
    events: tuple = ()

    __slots__ = ()

    def span(self, name: str, **args: Any) -> _NullSpan:
        return _NULL_SPAN

    def instant(self, name: str, **args: Any) -> None:
        return None

    def fence(self, x: Any) -> Any:
        return x


NULL_TRACER = NullTracer()


def _cuda_devices(x: Any, out: set) -> None:
    """Collect the CUDA devices of the tensors in the tree ``x`` (dicts,
    lists, tuples and NamedTuples of tensors)."""
    if isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif getattr(x, "is_cuda", False):
        out.add(x.device)


def validate_span_events(events: List[dict]) -> List[str]:
    """Structural checks on recorded span events: every span closed with a
    non-negative duration, parents exist, children nest inside the parent's
    interval, names come from the taxonomy.  Returns error strings."""
    errs: List[str] = []
    spans: Dict[int, dict] = {}
    for i, e in enumerate(events):
        t = e.get("type")
        if t == "span":
            for field in ("name", "id", "depth", "ts_us", "dur_us", "args"):
                if field not in e:
                    errs.append(f"event {i}: span missing {field!r}")
            if e.get("dur_us", -1) < 0:
                errs.append(f"span {e.get('name')}: negative duration")
            if e.get("name") not in SPAN_NAMES:
                errs.append(f"span name {e.get('name')!r} not in SPAN_NAMES")
            if "id" in e:
                spans[e["id"]] = e
        elif t == "instant":
            if "name" not in e or "ts_us" not in e:
                errs.append(f"event {i}: malformed instant")
        else:
            errs.append(f"event {i}: unknown trace event type {t!r}")
    for e in spans.values():
        pid = e.get("parent")
        if pid is None:
            continue
        p = spans.get(pid)
        if p is None:
            errs.append(f"span {e['name']} (id {e['id']}): parent {pid} "
                        "never closed")
            continue
        eps = 1.0  # µs of clock slack
        if e["ts_us"] < p["ts_us"] - eps or (
            e["ts_us"] + e["dur_us"] > p["ts_us"] + p["dur_us"] + eps
        ):
            errs.append(
                f"span {e['name']} (id {e['id']}) escapes its parent "
                f"{p['name']}'s interval"
            )
        if e["depth"] != p["depth"] + 1:
            errs.append(f"span {e['name']}: depth {e['depth']} under parent "
                        f"depth {p['depth']}")
    return errs
