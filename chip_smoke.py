#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and fails (exit code 1,
no result printed) without a CUDA card or without ``src/repro_torch``
beside it.  Phases, each of which fails the run:

  1. print the card's name and power limit (``nvidia-smi``); build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
     ``sm_90a`` and print the build time;
  2. the main path: ``repro_torch.run.build_run`` for LeNet5 (1,256,010
     parameters, batch 128, p = 0.01) on the GSPMD backend's flat hist
     engine, 5 rounds.  The kernels' launch counts are set to 0 just
     before and read just after; every round must launch
     ``seg_hist2side`` twice and ``seg_moments`` and
     ``seg_binarize_apply`` once, every loss must be finite, and the last
     round's residual must be ``acc − ΔW*`` bit for bit with each
     segment's ΔW* holding only 0 and that segment's μ;
  3. the last round's accumulator goes through the hist pipeline once
     more, with each kernel's operands captured: each kernel is held
     against its plain PyTorch version on the same operands (counts
     equal, binarize bit-equal, moment sums to ``rtol=1e-6``, with the
     largest relative error printed), the whole kernel pipeline against
     the whole plain pipeline, and both are timed;
  4. print one ``{"kernels": [...]}`` line, then the card line, then the
     last line ``{"ok": true, "device": {...}}``.

After the five rounds one more round runs under ``torch.profiler`` and
the script prints its device-busy share and its costliest device
operations.

``ms`` and ``plain_ms`` are device time per call of the wrapper and of
the plain version, from CUPTI (``torch.profiler``): the sum over all the
device work one call launches (for the histogram also its output memset
and int→f32 copy), averaged over many calls after a warm-up.  The calls
rotate over copies of the operands that together exceed the 50 MB L2
cache, so every call reads device memory, as ``bound_ms`` assumes.  Time
between CUDA events would include the host's cost of a launch through
the Python wrapper, several times the kernels' own; so the script fails
if the profiler sees no device time, and has no other timing.  The bound
is the larger of bytes moved (each input read once, each output written
once) over 3.35 TB/s and operations over 67 TFLOP/s (an H100 SXM's
published f32 rates).
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
ROUNDS = 5
PER_ROUND = {"seg_hist2side": 2, "seg_moments": 1, "seg_binarize_apply": 1}
SOURCE = "src/repro_torch/kernels/csrc/seg_sbc.cu"
REPLACES = {
    "seg_hist2side": "src/repro/kernels/flat.py:71",
    "seg_moments": "src/repro/kernels/flat.py:126",
    "seg_binarize_apply": "src/repro/kernels/flat.py:168",
}
# operations per element of the buffer, counted from each kernel's body
OPS_PER_ELEMENT = {"seg_hist2side": 12, "seg_moments": 4, "seg_binarize_apply": 3}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _run(fn, operands, iters: int) -> None:
    for i in range(iters):
        fn(*operands[i % len(operands)])


def _self_device_us(event) -> float:
    return getattr(event, "self_device_time_total", None) or getattr(
        event, "self_cuda_time_total", 0.0)


def device_ms(fn, operands, iters: int) -> float:
    """Mean device ms per call of ``fn(*operands[i % len(operands)])``,
    summed over the kernels, memsets and copies that the call launches,
    from CUPTI (``torch.profiler``).  Fails if the profiler saw no device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _run(fn, operands, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _run(fn, operands, iters)
        torch.cuda.synchronize()
    total_us = sum(_self_device_us(e) for e in prof.key_averages())
    check(total_us > 0, "torch.profiler saw no device time")
    return total_us / iters / 1e3


def recording(module, names, log):
    """Stand-ins for ``module.<name>`` that append ``(name, args, kwargs)``
    to ``log`` and call through."""
    def recorder(name, fn):
        def call(*args, **kwargs):
            log.append((name, args, kwargs))
            return fn(*args, **kwargs)
        return call

    return {name: recorder(name, getattr(module, name)) for name in names}


@contextlib.contextmanager
def swapped(module, replacements):
    """Replace module attributes for the duration of the block."""
    saved = {name: getattr(module, name) for name in replacements}
    try:
        for name, fn in replacements.items():
            setattr(module, name, fn)
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    check((ROOT / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import _build
    from repro_torch.kernels import flat as kflat
    from repro_torch.run import RunSpec, build_run

    # a parity port of an f32 reference: full f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card and build
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")

    # ---- 2. the main path
    spec = RunSpec(preset="lenet5", backend="gspmd", fast=True, flat_engine="hist",
                   sparsity=0.01, batch=128, rounds=ROUNDS)
    run = build_run(spec, device="cuda:0")
    space = run.fns.flat_space
    n_params = sum(s.global_size for s in space.segments)
    print(f"lenet5: {n_params} params in {len(space.segments)} segments, "
          f"{space.n_blocks} blocks, n_pad {space.n_pad}; "
          f"bits_per_client {run.fns.bits_per_client:.1f}")
    check(n_params == 1_256_010 and space.n_pad == 1_259_520, "LeNet5 layout")

    last = {}
    exchange = space.exchange_local_hist

    def observed_exchange(bodies, res_flat, **kw):
        out = exchange(bodies, res_flat, **kw)
        last.update(bodies=[b.clone() for b in bodies], res=res_flat.clone(), out=out)
        return out

    space.exchange_local_hist = observed_exchange
    state = run.init()
    torch.cuda.synchronize()
    kflat.reset_launches()
    losses, per_round = [], []
    for r in range(ROUNDS):
        before = kflat.launch_counts()
        t0 = time.perf_counter()
        state, m = run.step(state, r)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        after = kflat.launch_counts()
        per_round.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
        print(f"round {r + 1}: loss {loss:.6f}  step {step_ms:.3f} ms  launches {per_round[-1]}")
    launches = kflat.launch_counts()
    del space.exchange_local_hist
    check(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    check(all(p == PER_ROUND for p in per_round), f"launches per round {per_round}")

    acc = last["res"] + space.flatten_local(last["bodies"])
    mean, own, new_res = last["out"]
    check(torch.equal(new_res.view(torch.int32), (acc - own).view(torch.int32)),
          "residual != acc - dW* bit for bit")
    check(mean is own, "one client: the mean is the client's own dW*")
    for i, s in enumerate(space.segments):
        vals = torch.unique(own[s.offset:s.offset + s.rows * s.n_loc])
        nonzero = vals[vals != 0]
        check(nonzero.numel() <= 1, f"segment {s.path}: dW* holds {nonzero.numel()} values")
    print(f"last round: residual == acc - dW* bit for bit; dW* per segment is 0 or its mu; "
          f"{int((own != 0).sum())} entries sent")

    # one more round under the profiler: where a round's time goes
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = run.step(state, ROUNDS)
        float(m["loss"])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    events = sorted(prof.key_averages(), key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in events) / 1e3
    check(busy_ms > 0, "torch.profiler saw no device time in the profiled round")
    print(f"profiled round {ROUNDS + 1}: step {step_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}% of the step), {sum(e.count for e in events)} "
          f"device operations; top by device time:")
    for e in events[:10]:
        print(f"  {_self_device_us(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:100]}")

    # ---- 3. each kernel against its plain version, on the path's operands
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    ks = [s.k for s in space.segments]
    rates = [s.rate for s in space.segments]
    sob = torch.from_numpy(space.seg_of_block.astype("int64")).to(dev)

    def pipeline():
        return core_flat._hist_pipeline(acc, bounds, ks, rates, sob, space.n_blocks,
                                        space.bm, space.lanes, 128)

    calls: list = []
    with swapped(core_flat, recording(core_flat, PER_ROUND, calls)):
        k_out, k_res, k_stats = pipeline()
    plain = {"seg_hist2side": kflat.seg_hist2side_plain,
             "seg_moments": kflat.seg_moments_plain,
             "seg_binarize_apply": kflat.seg_binarize_apply_plain}
    with swapped(core_flat, plain):
        p_out, p_res, p_stats = pipeline()
    torch.cuda.synchronize()
    check(torch.equal(k_out != 0, p_out != 0), "kernel and plain pipelines select differently")
    check(torch.equal(k_res, acc - k_out), "kernel pipeline residual")
    check(torch.allclose(k_stats["mu"], p_stats["mu"], rtol=1e-6, atol=0), "pipeline mu")
    print("kernel pipeline == plain pipeline on the last round's accumulator "
          "(same selection, mu to rtol 1e-6)")

    rows, moments_rel = {}, 0.0
    for name, args, kwargs in calls:
        xpad, params = args
        got = getattr(kflat, name)(xpad, params, **kwargs)
        want = plain[name](xpad, params, **kwargs)
        torch.cuda.synchronize()
        if name == "seg_hist2side":
            check(torch.equal(got, want), f"{name}: counts differ")
            err = float((got - want).abs().max())
        elif name == "seg_moments":
            check(torch.equal(got[:, :, 1], want[:, :, 1]), f"{name}: counts differ")
            check(torch.allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6, atol=0),
                  f"{name}: sums beyond rtol 1e-6")
            err = float((got - want).abs().max())
            sums = want[:, :, 0] != 0
            rel = (got[:, :, 0] - want[:, :, 0]).abs()[sums] / want[:, :, 0].abs()[sums]
            moments_rel = max(moments_rel, float(rel.max()) if rel.numel() else 0.0)
        else:
            check(all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                      for g, w in zip(got, want)), f"{name}: not bit-equal")
            err = 0.0
        if name in rows:  # time the first call of each kernel on the path
            continue
        copies = [(xpad.clone(), params.clone()) for _ in range(12)]  # > 50 MB
        fn_k = lambda x, p, f=getattr(kflat, name), kw=kwargs: f(x, p, **kw)
        fn_p = lambda x, p, f=plain[name], kw=kwargs: f(x, p, **kw)
        out_bytes = {"seg_hist2side": 4 * kwargs.get("nseg", 0) * 2 * kwargs.get("nbins", 128),
                     "seg_moments": 4 * kwargs.get("nseg", 0) * 4,
                     "seg_binarize_apply": 2 * 4 * xpad.numel()}[name]
        nbytes = 4 * (xpad.numel() + params.numel()) + out_bytes
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ELEMENT[name] * xpad.numel() / F32_OPS_PER_S * 1e3
        rows[name] = {
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": err,
            "ms": device_ms(fn_k, copies, 240), "plain_ms": device_ms(fn_p, copies, 48),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
        }
        del copies
        r = rows[name]
        print(f"{name}: {r['ms'] * 1e3:.2f} us device per call, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']}, {nbytes} bytes), {r['launches']} launches on the path")
    check(set(rows) == set(PER_ROUND), f"kernels compared: {sorted(rows)}")
    print(f"seg_moments: sums' largest relative error {moments_rel:.3e} over "
          f"{sum(1 for c in calls if c[0] == 'seg_moments')} calls (limit 1e-6)")

    # ---- 4. results
    print(json.dumps({"kernels": [rows[k] for k in PER_ROUND]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
