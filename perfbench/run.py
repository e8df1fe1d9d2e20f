"""The benchmark of the PyTorch and CUDA port: SBC training rounds of one
client on one card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the cell's weights and a pool of batches on the card from
the seed, builds the program (``pb_program``), drives its first three
rounds and keeps what they read, and warms up.  The window then issues
round after round for ``--seconds`` seconds with no synchronise, CUDA
events at each round's start, and one synchronise at its end.  With
``--trace 1`` the harness's hooks mark the forward's end and the
exchange's entry and exit in every round of the window, and two
profiled stretches of the traffic's ``trace_rounds`` rounds follow it.  Then the
program is freed and the plain reference (``reference/``) runs the three
rounds again from the seed; the comparison (``pb_compare``) decides
``correct``.  The last line of standard output is the result's JSON;
the numbers compared, each with its limit, end standard error.

The run exits with 3 and prints no result when the card or the program
is missing, and with 4 when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for sub in (BENCH, BENCH / "reference"):
    if str(sub) not in sys.path:
        sys.path.insert(0, str(sub))
# fixed cache directories inside the checkout (the port builds its kernels
# into build/repro_torch/ itself)
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "perfbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")

import torch  # noqa: E402

import pb_compare  # noqa: E402
import pb_flops  # noqa: E402
import pb_spec  # noqa: E402
import pb_traffic  # noqa: E402
import pb_ref_eq1  # noqa: E402
import pb_ref_train  # noqa: E402
import pb_ref_weights  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FIRST_ROUNDS = pb_ref_train.ROUNDS  # the rounds the reference follows
WARM_ROUNDS = 2  # more rounds before the window, so it starts steady
ROUND_RANGE = "pb.round"


class Hooks:
    """CUDA events (or, on the CPU, host times) marked by the program's
    hooks into the current round's dict."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.current = None

    def now(self):
        if not self.cuda:
            return time.perf_counter() * 1e3
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, name: str) -> None:
        if self.current is not None:
            self.current[name] = self.now()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else b - a


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def program_readings(run, state_after, m: dict, specs: list, seed: int, device) -> dict:
    import pb_program

    if m["local_opt"] == "adam":
        return pb_ref_train.grad1_norms(m, specs, seed, device, v1=pb_program.adam_v_of(state_after))
    return pb_ref_train.grad1_norms(m, specs, seed, device, w1=pb_program.params_of(state_after),
                                    r1=pb_program.residual_of(run, state_after))


def first_rounds(run, spec: dict, seed: int, device) -> tuple:
    """The seed's weights into a fresh state of ``run``, its first rounds
    driven through ``run.step``: ``(state, the program's readings)``."""
    import pb_program

    m = spec["config"]["model"]
    specs = pb_ref_weights.leaf_specs(m)
    state = pb_program.init_state(run, pb_ref_weights.draw_weights(m, seed, device))
    losses, grad1 = [], None
    for r in range(FIRST_ROUNDS):
        state, met = run.step(state, r)
        losses.append(float(met["loss"]))
        if r == 0:
            grad1 = program_readings(run, state, m, specs, seed, device)
    return state, {"losses": losses, "grad1": grad1, "eq1": float(run.fns.bits_per_client),
                   "change3": pb_ref_train.change_norms(specs, seed, device,
                                                        pb_program.params_of(state))}


def set_up(spec: dict, seed: int, device, hooks):
    """The program built, its first rounds driven and read, warmed up:
    ``(run, state, next round, prog readings, pool)``."""
    import pb_program

    pool = pb_traffic.make_pool(spec["traffic"], spec["config"]["model"], seed, device)
    run = pb_program.build(spec["config"], pool, seed, device, hooks)
    state, prog = first_rounds(run, spec, seed, device)
    for r in range(FIRST_ROUNDS, FIRST_ROUNDS + WARM_ROUNDS):
        state, _ = run.step(state, r)
    sync(device)
    return run, state, FIRST_ROUNDS + WARM_ROUNDS, prog, pool


def window(run, state, r: int, seconds: float, device, hooks: Hooks, trace: bool) -> tuple:
    """Rounds for ``seconds`` of the host's clock, one synchronise at the
    end: ``(state, next round, ctx)``."""
    clock = hooks if trace else Hooks(device)
    sync(device)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(device)
    marks, host_ms, losses = [], [], []
    t0 = time.perf_counter()
    while True:
        marks.append({"start": clock.now()})
        hooks.current = marks[-1] if trace else None
        h0 = time.perf_counter()
        state, met = run.step(state, r)
        host_ms.append((time.perf_counter() - h0) * 1e3)
        losses.append(met["loss"])
        r += 1
        if time.perf_counter() - t0 >= seconds:
            break
    hooks.current = None
    end = clock.now()
    sync(device)
    window_s = time.perf_counter() - t0
    starts = [mk["start"] for mk in marks] + [end]
    ctx = {
        "window_s": window_s,
        "rounds": len(marks),
        "round_ms": [clock.ms(a, b) for a, b in zip(starts, starts[1:])],
        "failed": int((~torch.isfinite(torch.stack(losses))).sum()),
        "peak_bytes": torch.cuda.max_memory_allocated(device) if clock.cuda else 0,
    }
    if trace:
        ctx["host_issue_ms"] = host_ms
        ctx["spans"] = {
            "forward": [clock.ms(mk["start"], mk["forward_end"]) for mk in marks],
            "backward_update": [clock.ms(mk["forward_end"], mk["exchange_start"]) for mk in marks],
            "exchange": [clock.ms(mk["exchange_start"], mk["exchange_end"]) for mk in marks],
        }
    return state, r, ctx


def profiled_stretch(run, state, r: int, n: int) -> dict:
    """Two stretches of ``n`` rounds under ``torch.profiler``: the device
    alone (busy, idle, operations a round: recording host events would
    slow the host's issue), then host and device (the operations launched
    inside the exchange, the idle gaps by host op, the top operations)."""
    import pb_cupti
    import pb_program
    from torch.profiler import ProfilerActivity, profile, record_function

    out = {}
    for activities in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            pb_cupti.lead_in()
            for _ in range(n):
                with record_function(ROUND_RANGE):
                    state, _ = run.step(state, r)
                r += 1
            pb_cupti.lead_out()
            torch.cuda.synchronize()
        events = prof.profiler.kineto_results.events()
        if len(activities) == 1:
            device = pb_cupti.device_summary(events, n)
        else:
            out = pb_cupti.reduce_trace(events, pb_program.EXCHANGE_RANGE, ROUND_RANGE)
    host_traced = {k: out.get(k) for k in ("window_s", "busy_s", "ops")}
    out.update(device)
    print(f"perfbench: profiled {n} rounds twice; device alone {json.dumps(device)}; with host "
          f"events {json.dumps(host_traced)}, exchange {out.get('range_s')} s in "
          f"{out.get('range_ops')} ops, {out.get('matched')} launches matched", file=sys.stderr)
    return out


def reference_readings(spec: dict, seed: int, pool: list, device, tf32: bool = False) -> dict:
    """The reference's three rounds and Eq. 1 (``tf32``: its matmuls in
    TF32, the control)."""
    m, run_cfg = spec["config"]["model"], spec["config"]["run"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        ref = pb_ref_train.run_rounds(m, run_cfg["sparsity"], seed, pool[:FIRST_ROUNDS], device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    ref["eq1"] = pb_ref_eq1.bits_per_client(pb_ref_weights.leaf_specs(m), run_cfg["sparsity"])
    return ref


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of the cell ``spec`` (:func:`pb_spec.load`): the result
    line's dict."""
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    hooks = Hooks(device)
    run, state, r, prog, pool = set_up(spec, seed, device, hooks if trace else None)
    setup_s = time.time() - t_start
    state, r, ctx = window(run, state, r, seconds, device, hooks, trace)
    m = spec["config"]["model"]
    ctx.update(setup_s=setup_s, tokens_per_round=pb_traffic.tokens_per_round(spec["traffic"]),
               flops_per_round=pb_flops.round_flops(m, spec["traffic"]),
               entries=pb_flops.entries(pb_ref_weights.leaf_specs(m)))
    if trace and torch.device(device).type == "cuda":
        ctx["trace"] = profiled_stretch(run, state, r, spec["traffic"]["trace_rounds"])
    del run, state
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    values = pb_compare.numbers(prog, reference_readings(spec, seed, pool, device))
    correct, compared = pb_compare.judge(values, spec["limits"])
    metrics = {}
    for entry in spec["per_layer" if trace else "end_to_end"]:
        value = pb_spec.reader(entry["name"])(ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": ctx["peak_bytes"]}
    out = {"correct": bool(correct and ctx["failed"] == 0), "attempted": ctx["rounds"],
           "failed": ctx["failed"], "metrics": metrics, "device": dev}
    if trace and ctx.get("trace"):
        dev.update(busy_s=ctx["trace"]["busy_s"], window_s=ctx["trace"]["window_s"])
        out["breakdown"] = {"device_ops": ctx["trace"]["device_ops"],
                            "idle_gaps": ctx["trace"]["idle_gaps"]}
    out["compared"] = compared
    return out


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = pb_spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"perfbench: the cell needs {spec['cell']['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    try:
        import pb_program  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the program is not in this checkout: {exc}", file=sys.stderr)
        return 3
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                   T_START)
    found = loaded_forbidden()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in out["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
