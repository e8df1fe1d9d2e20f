#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and fails (exit code 1,
no result printed) without a CUDA card or without ``src/repro_torch``
beside it.  Phases, each of which fails the run:

  1. print the card's name and power limit (``nvidia-smi``); build the
     CUDA kernels from ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
     ``sm_90a`` (one ``nvcc`` per source, all at once) and print the build
     time;
  2. the hist path: ``repro_torch.run.build_run`` for LeNet5 (1,256,010
     parameters, batch 128, p = 0.01) on the GSPMD backend's flat hist
     engine, 5 rounds.  Every kernel's launch count is set to 0 just
     before and read just after; every round must launch
     ``seg_hist2side`` twice, ``seg_moments`` and ``seg_binarize_apply``
     once and no packer, every loss must be finite, and the last round's
     residual must be ``acc − ΔW*`` bit for bit with each segment's ΔW*
     holding only 0 and that segment's μ.  The last round's accumulator
     goes through the hist pipeline once more with each kernel's operands
     captured: each kernel is held against its plain PyTorch version on
     the same operands (counts equal, binarize bit-equal, moment sums to
     ``rtol=1e-6``, with the largest relative error printed), the kernel
     pipeline against the plain pipeline, and both are timed;
  3. the exact path: ``build_run`` for the same model on the exact engine
     with the device-packed Golomb wire and wire metering
     (``flat_engine="exact", device_pack=True, measure_wire=True``), 5
     rounds.  Every round must launch ``seg_packbits`` once and nothing
     else; every loss must be finite; on the last round the residual must
     be ``acc − ΔW*`` bit for bit, and each (segment, row) of ΔW* must
     hold one value ±μ in exactly k slots; every (segment, row)'s slice of
     the packed words and its bit count must equal the host Golomb
     encoder's bytes of the row's positions (``encode_positions_packed``),
     byte for byte; ``seg_select_pack`` on the same rows' masks must give
     the same words and bit counts; and the ledger's measured bits must be
     Σ nbits + 32 · n_mu for every round.  ``seg_packbits`` is held
     against its plain version on the path's own bit planes and
     ``seg_select_pack`` on the path's masks (both exactly), and both are
     timed (``seg_select_pack`` on the largest row, f1);
  4. the per-leaf path: ``repro_torch.kernels.ops.sbc_compress_hist(leaf,
     p=0.01, bm=8, lanes=128)`` on each of LeNet5's 6 leaves, as views
     into the hist path's last accumulator, with the launch counts set to
     0 just before and read just after: 12 ``hist2side``, 6
     ``masked_moments``, 6 ``binarize_apply`` and nothing else.  Each
     leaf's ΔW*, residual, μ and count must equal the flat hist engine's
     on the same buffer bit for bit, and its residual ``acc − ΔW*``; the
     six calls run again under ``torch.cuda.set_sync_debug_mode("error")``
     (a host sync fails the run).  Each kernel is held against its plain
     version on every call's operands (counts equal, binarize bit-equal,
     moment sums to ``rtol=1e-6``) and timed on f1 (n 1,225,000).  The
     survivor count of each leaf is printed against k; the reference's
     ±2% band (on k, and on μ against the exact top-k's) is checked on
     seeded Gaussian data of f1's size, the data it is asserted on;
  5. print one ``{"kernels": [...]}`` line with all eight kernels, then
     the card line, then the last line ``{"ok": true, "device": {...}}``.

After each path's five rounds one more round runs under ``torch.profiler``
and the script prints its device-busy share and its costliest device
operations; the exact path also prints the host-clock time of its
exchange with and without the device pack, on the last round's operands.

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
once) over 3.35 TB/s and operations over 67 T/s (an H100 SXM's published
f32 rate outside the tensor cores, used for the packers' integer
operations too).
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
OPS_PER_S = 67e12
ROUNDS = 5
KERNELS = ("seg_hist2side", "seg_moments", "seg_binarize_apply", "seg_packbits",
           "seg_select_pack", "hist2side", "masked_moments", "binarize_apply")
LEAF_KERNELS = ("hist2side", "masked_moments", "binarize_apply")


def per_call(**counts) -> dict:
    """Launches of every kernel: ``counts``, and 0 for the others."""
    return {name: counts.get(name, 0) for name in KERNELS}


HIST_PER_ROUND = per_call(seg_hist2side=2, seg_moments=1, seg_binarize_apply=1)
EXACT_PER_ROUND = per_call(seg_packbits=1)
LEAF_PER_LEAF = per_call(hist2side=2, masked_moments=1, binarize_apply=1)
SEG_SBC = "src/repro_torch/kernels/csrc/seg_sbc.cu"
SOURCE = {name: SEG_SBC for name in KERNELS}
SOURCE.update(seg_packbits="src/repro_torch/kernels/csrc/pack.cu",
              seg_select_pack="src/repro_torch/kernels/csrc/pack.cu")
REPLACES = {
    "seg_hist2side": "src/repro/kernels/flat.py:71",
    "seg_moments": "src/repro/kernels/flat.py:126",
    "seg_binarize_apply": "src/repro/kernels/flat.py:168",
    "seg_packbits": "src/repro/kernels/pack.py:128",
    "seg_select_pack": "src/repro/kernels/pack.py:183",
    "hist2side": "src/repro/kernels/hist2side.py:70",
    "masked_moments": "src/repro/kernels/moments.py:45",
    "binarize_apply": "src/repro/kernels/binarize_apply.py:40",
}
# operations per element of the buffer, counted from each SBC kernel's body
OPS_PER_ELEMENT = {"seg_hist2side": 12, "seg_moments": 4, "seg_binarize_apply": 3,
                   "hist2side": 12, "masked_moments": 4, "binarize_apply": 3}
SPEC = dict(preset="lenet5", backend="gspmd", fast=True, sparsity=0.01, batch=128,
            rounds=ROUNDS)


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


def device_ms(fn, operands, iters: int, label: str = "") -> float:
    """Mean device ms per call of ``fn(*operands[i % len(operands)])``,
    summed over the kernels, memsets and copies that the call launches,
    from CUPTI (``torch.profiler``).  Fails if the profiler saw no device
    time.  With a ``label``, prints each device operation's share of a
    call.

    Every call launches the same device operations, so each one's count
    must be a whole multiple of ``iters``.  A trace that lost records (seen
    on the card: a kernel counted 0.70 times a call) is taken again, up to
    three times in all, and then fails the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    _run(fn, operands, 5)
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _run(fn, operands, iters)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if _self_device_us(e) > 0]
        if all(e.count % iters == 0 for e in events):
            break
        print(f"  {label or 'plain'}: the trace lost records "
              f"({[e.count for e in events]} for {iters} calls); timing again")
    else:
        raise SmokeFailure(f"{label or 'plain'}: the profiler lost records three times")
    total_us = sum(_self_device_us(e) for e in events)
    check(total_us > 0, "torch.profiler saw no device time")
    if label:
        for e in sorted(events, key=_self_device_us, reverse=True):
            print(f"  {label}: {_self_device_us(e) / iters:.2f} us per call, "
                  f"{e.count / iters:g} per call: {e.key[:80]}")
    return total_us / iters / 1e3


def copies_past_l2(nbytes: int) -> int:
    """How many copies of ``nbytes`` of operands exceed the 50 MB L2."""
    return max(2, -(-60_000_000 // max(nbytes, 1)))


def kernel_row(name, launches, err, ms, plain_ms, nbytes, ops) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS_PER_S * 1e3
    row = {
        "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    print(f"{name}: {ms * 1e3:.2f} us device per call, plain {plain_ms * 1e3:.2f} us, "
          f"bound {row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, {nbytes} bytes), "
          f"{launches} launches on the path")
    return row


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


def drive(run, exchange_name: str, per_round: dict, label: str) -> dict:
    """Five rounds of ``run`` with the launch counts set to 0 just before
    and read just after; the space's ``exchange_name`` method is observed
    so the last round's operands and outputs are kept.  Returns the
    capture: ``launches`` (counts of the run), ``last`` (bodies, res, out
    of the last exchange), ``metrics`` (each round's train-step metrics,
    before the run's metering consumes them) and the run's ``state``."""
    import torch
    from repro_torch import kernels

    space = run.fns.flat_space
    exchange = getattr(space, exchange_name)
    last, metrics = {}, []

    def observed_exchange(bodies, res_flat, **kw):
        out = exchange(bodies, res_flat, **kw)
        last.update(bodies=[b.clone() for b in bodies], res=res_flat.clone(), out=out)
        return out

    step = run.fns.train_step

    def observed_step(state, batch):
        state, m = step(state, batch)
        metrics.append(dict(m))
        return state, m

    setattr(space, exchange_name, observed_exchange)
    run.fns = run.fns._replace(train_step=observed_step)
    try:
        state = run.init()
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses, counts = [], []
        for r in range(ROUNDS):
            before = kernels.launch_counts()
            t0 = time.perf_counter()
            state, m = run.step(state, r)
            loss = float(m["loss"])
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after})
            losses.append(loss)
            print(f"{label} round {r + 1}: loss {loss:.6f}  step {step_ms:.3f} ms  "
                  f"launches {counts[-1]}")
        launches = kernels.launch_counts()
    finally:
        delattr(space, exchange_name)
        run.fns = run.fns._replace(train_step=step)
    check(all(math.isfinite(x) for x in losses), f"{label}: non-finite loss: {losses}")
    check(all(c == per_round for c in counts), f"{label}: launches per round {counts}")
    acc = last["res"] + space.flatten_local(last["bodies"])
    mean, own, new_res = last["out"][:3]
    check(torch.equal(new_res.view(torch.int32), (acc - own).view(torch.int32)),
          f"{label}: residual != acc - dW* bit for bit")
    check(mean is own, f"{label}: one client: the mean is the client's own dW*")
    return {"launches": launches, "last": last, "acc": acc, "metrics": metrics,
            "state": state}


def profiled_round(run, state, label: str) -> None:
    """One more round under the profiler: where a round's time goes."""
    import torch
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
    check(busy_ms > 0, f"{label}: torch.profiler saw no device time in the profiled round")
    print(f"{label} profiled round {ROUNDS + 1}: step {step_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / step_ms:.1f}% of the step), "
          f"{sum(e.count for e in events)} device operations; top by device time:")
    for e in events[:12]:
        print(f"  {_self_device_us(e) / 1e3:9.4f} ms  x{e.count:<4d} {e.key[:100]}")


# --------------------------------------------------------------- hist path


def hist_path(dev) -> tuple:
    """Phase 2; returns the three SBC kernels' rows of the kernels line,
    and the last round's accumulator with the flat engine's results on it
    (``acc``, ``space``, ``out``, ``res``, ``stats``) for phase 4."""
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.kernels import flat as kflat
    from repro_torch.run import RunSpec, build_run

    run = build_run(RunSpec(**SPEC, flat_engine="hist"), device=dev)
    space = run.fns.flat_space
    n_params = sum(s.global_size for s in space.segments)
    print(f"lenet5: {n_params} params in {len(space.segments)} segments, "
          f"{space.n_blocks} blocks, n_pad {space.n_pad}; "
          f"bits_per_client {run.fns.bits_per_client:.1f}")
    check(n_params == 1_256_010 and space.n_pad == 1_259_520, "LeNet5 layout")

    cap = drive(run, "exchange_local_hist", HIST_PER_ROUND, "hist")
    acc, own = cap["acc"], cap["last"]["out"][1]
    for s in space.segments:
        vals = torch.unique(own[s.offset:s.offset + s.rows * s.n_loc])
        nonzero = vals[vals != 0]
        check(nonzero.numel() <= 1, f"segment {s.path}: dW* holds {nonzero.numel()} values")
    print(f"hist last round: residual == acc - dW* bit for bit; dW* per segment is 0 or "
          f"its mu; {int((own != 0).sum())} entries sent")
    profiled_round(run, cap["state"], "hist")

    # each kernel against its plain version, on the path's operands
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    ks = [s.k for s in space.segments]
    rates = [s.rate for s in space.segments]
    sob = torch.from_numpy(space.seg_of_block.astype("int64")).to(dev)

    def pipeline():
        return core_flat._hist_pipeline(acc, bounds, ks, rates, sob, space.n_blocks,
                                        space.bm, space.lanes, 128)

    names = ("seg_hist2side", "seg_moments", "seg_binarize_apply")
    calls: list = []
    with swapped(core_flat, recording(core_flat, names, calls)):
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
        rows[name] = kernel_row(
            name, cap["launches"][name], err, device_ms(fn_k, copies, 240, name),
            device_ms(fn_p, copies, 48), 4 * (xpad.numel() + params.numel()) + out_bytes,
            OPS_PER_ELEMENT[name] * xpad.numel())
        del copies
    check(set(rows) == set(names), f"kernels compared: {sorted(rows)}")
    print(f"seg_moments: sums' largest relative error {moments_rel:.3e} over "
          f"{sum(1 for c in calls if c[0] == 'seg_moments')} calls (limit 1e-6)")
    return rows, {"acc": acc, "space": space, "out": k_out, "res": k_res,
                  "stats": k_stats}


# -------------------------------------------------------------- exact path


def exact_path(dev) -> dict:
    """Phase 3; returns the two packers' rows of the kernels line."""
    import numpy as np
    import torch
    from repro_torch.core import flat as core_flat
    from repro_torch.core.golomb import encode_positions_packed, packed_words_to_bytes
    from repro_torch.kernels import pack as kpack
    from repro_torch.run import RunSpec, build_run

    run = build_run(RunSpec(**SPEC, flat_engine="exact", device_pack=True,
                            measure_wire=True), device=dev)
    space = run.fns.flat_space
    print(f"exact: n_mu {space.n_mu}, n_pos {space.n_pos}, n_pack_words "
          f"{space.n_pack_words}; (b*, words/row, word offset) per segment "
          f"{list(space._pack_info)}")
    check((space.n_mu, space.n_pos, space.n_pack_words) == (6, 12_561, 3_358),
          "LeNet5 exact layout")
    cap = drive(run, "exchange_local", EXACT_PER_ROUND, "exact")

    # the last round: ΔW* per (segment, row) is ±μ in exactly k slots, and
    # its packed stream is the host encoder's bytes
    _, own, _, words, nbits = cap["last"]["out"]
    m_last = cap["metrics"][-1]
    check(torch.equal(m_last["packed_words_client0"][0].view(torch.int32),
                      words.view(torch.int32)), "packed_words_client0 != the exchange's words")
    own_np, words_np, nbits_np = own.cpu().numpy(), words.cpu().numpy(), nbits.cpu().numpy()
    masks, mu_row = [], 0
    for s, (b, w, off) in zip(space._sparse, space._pack_info):
        x = own_np[s.offset:s.offset + s.rows * s.n_loc].reshape(s.rows, s.n_loc)
        for r in range(s.rows):
            pos = np.flatnonzero(x[r])
            vals = np.unique(x[r][pos])
            check(pos.size == s.k and vals.size == 1,
                  f"{s.path} row {r}: dW* holds {vals.size} values in {pos.size} slots, "
                  f"not one in k={s.k}")
            host, host_nb = encode_positions_packed(pos, s.rate)
            nb = int(nbits_np[mu_row])
            check(nb == host_nb and packed_words_to_bytes(
                words_np[off + r * w:off + (r + 1) * w], nb) == host,
                f"{s.path} row {r}: packed words are not the host encoder's bytes")
            mu_row += 1
        masks.append((s, b, w, off, torch.from_numpy((x != 0).astype(np.int32)).to(dev)))
    print(f"exact last round: residual == acc - dW* bit for bit; each of {space.n_mu} "
          f"rows holds one +-mu in exactly k slots; its packed words are the host "
          f"encoder's bytes ({int(nbits_np.sum())} bits)")

    # the ledger meters Σ nbits + 32 bits per μ every round
    led = run.ledger.history()["up_bits_measured"]
    want = [float(m["packed_nbits"].sum()) + 32.0 * space.n_mu for m in cap["metrics"]]
    check(led == want, f"ledger measured bits {led} != sum(nbits) + 32 n_mu {want}")
    print(f"ledger: up_bits_measured per round {led} (analytic "
          f"{run.ledger.records[0].up_bits_analytic}); up bytes "
          f"{run.ledger.totals()['up_bytes']}")
    profiled_round(run, cap["state"], "exact")

    # where the exchange's time goes: with and without the device pack
    last = cap["last"]
    for pack in (False, True):
        for _ in range(2):
            space.exchange_local(last["bodies"], last["res"], device_pack=pack)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            space.exchange_local(last["bodies"], last["res"], device_pack=pack)
        torch.cuda.synchronize()
        print(f"exact exchange_local (device_pack={pack}): "
              f"{(time.perf_counter() - t0) * 100:.3f} ms host clock per call")

    rows = {}
    # seg_packbits on the path's own bit planes
    calls: list = []
    with swapped(core_flat, recording(core_flat, ("seg_packbits",), calls)):
        space.exchange_local(last["bodies"], last["res"], device_pack=True)
    check(len(calls) == 1, f"one seg_packbits call per exchange, saw {len(calls)}")
    planes, kw = calls[0][1][0], calls[0][2]
    got = kpack.seg_packbits(planes, **kw)
    want = kpack.seg_packbits_plain(planes, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "seg_packbits: kernel words != plain words")
    check(torch.equal(got[:space.n_pack_words].view(torch.int32), words.view(torch.int32)),
          "seg_packbits: words != the path's words")
    nwords = planes.shape[1]
    print(f"seg_packbits: {nwords} words ({nwords // space.lanes} blocks of "
          f"{space.lanes}) bit-equal to the plain version and the path")
    copies = [(planes.clone(),) for _ in range(copies_past_l2(4 * planes.numel()))]
    rows["seg_packbits"] = kernel_row(
        "seg_packbits", cap["launches"]["seg_packbits"], 0.0,
        device_ms(lambda p: kpack.seg_packbits(p, **kw), copies, 240, "seg_packbits"),
        device_ms(lambda p: kpack.seg_packbits_plain(p, **kw), copies, 48),
        4 * (planes.numel() + nwords), 64 * nwords)
    del copies

    # seg_select_pack on the path's masks: the same words and bit counts
    mu_row = 0
    for s, b, w, off, mask in masks:
        sw, snb = kpack.seg_select_pack(mask, k=s.k, bstar=b)
        pw, pnb = kpack.seg_select_pack_plain(mask, k=s.k, bstar=b)
        torch.cuda.synchronize()
        seg_words = words[off:off + s.rows * w].view(torch.int32).reshape(s.rows, w)
        check(torch.equal(sw.view(torch.int32), pw.view(torch.int32))
              and torch.equal(snb, pnb), f"seg_select_pack {s.path}: kernel != plain")
        check(torch.equal(sw.view(torch.int32), seg_words)
              and torch.equal(snb, nbits[mu_row:mu_row + s.rows]),
              f"seg_select_pack {s.path}: words != seg_packbits' words")
        mu_row += s.rows
    print("seg_select_pack: every segment's words and bit counts equal to its plain "
          "version and to seg_packbits'")
    s, b, w, off, mask = max(masks, key=lambda e: e[4].numel())
    copies = [(mask.clone(),) for _ in range(copies_past_l2(4 * mask.numel()))]
    nrows, n = mask.shape
    rows["seg_select_pack"] = kernel_row(
        "seg_select_pack", cap["launches"]["seg_select_pack"], 0.0,
        device_ms(lambda m: kpack.seg_select_pack(m, k=s.k, bstar=b), copies, 60,
                  "seg_select_pack"),
        device_ms(lambda m: kpack.seg_select_pack_plain(m, k=s.k, bstar=b), copies, 12),
        4 * (nrows * n + nrows * w + nrows), 2 * nrows * n + 8 * nrows * s.k)
    print(f"seg_select_pack timed on {s.path}: n {n}, k {s.k}, {w} words")
    del copies
    return rows


# ----------------------------------------------------------- per-leaf path


def bit_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def leaf_path(dev, hist: dict) -> dict:
    """Phase 4; returns the three per-leaf kernels' rows of the kernels line."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import binarize_apply as kbin
    from repro_torch.kernels import hist2side as khist
    from repro_torch.kernels import moments as kmom
    from repro_torch.kernels import ops

    acc, space = hist["acc"], hist["space"]
    segs = [(s, s.offset, s.rows * s.n_loc) for s in space.segments]
    leaves = [acc[off:off + size] for _, off, size in segs]  # views into the flat buffer

    def compress_all():
        return [ops.sbc_compress_hist(leaf, p=s.rate, bm=space.bm, lanes=space.lanes)
                for leaf, (s, _, _) in zip(leaves, segs)]

    torch.cuda.synchronize()
    kernels.reset_launches()
    outs = compress_all()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {name: c * len(leaves) for name, c in LEAF_PER_LEAF.items()}
    check(launches == want, f"per-leaf launches {launches} != {want}")
    print(f"per-leaf: sbc_compress_hist on {len(leaves)} leaves (views into the hist "
          f"path's last accumulator, bm={space.bm}, lanes={space.lanes}): launches "
          f"{ {k: v for k, v in launches.items() if v} }, no other kernel")
    for i, ((s, off, size), leaf, out) in enumerate(zip(segs, leaves, outs)):
        check(bit_equal(out.delta_star, hist["out"][off:off + size])
              and bit_equal(out.residual, hist["res"][off:off + size])
              and bit_equal(out.mean, hist["stats"]["mu"][i])
              and bit_equal(out.count, hist["stats"]["count"][i]),
              f"{s.path}: per-leaf dW*, residual, mu or count != the flat engine's")
        check(bit_equal(out.residual, leaf - out.delta_star),
              f"{s.path}: residual != acc - dW* bit for bit")
        print(f"  {s.path}: n {size}, k {s.k}, survivors {int(out.count)} "
              f"({float(out.count) / s.k - 1:+.2%}), mu {float(out.mean):.6e}")
    print("per-leaf == flat hist engine bit for bit on every leaf (dW*, residual, mu, "
          "count); residual == acc - dW* bit for bit")

    torch.cuda.set_sync_debug_mode("error")
    try:
        again = compress_all()
    except RuntimeError as e:
        raise SmokeFailure(f"per-leaf path waited for the card: {e}") from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    check(all(bit_equal(a.delta_star, b.delta_star) for a, b in zip(again, outs)),
          "per-leaf: a second run differs")
    print("per-leaf: the six calls ran again under set_sync_debug_mode('error'): "
          "no host sync, same results")

    # each kernel against its plain version, on the path's own operands
    wrap = {"hist2side": khist.hist2side, "masked_moments": kmom.masked_moments,
            "binarize_apply": kbin.binarize_apply}
    plain = {"hist2side": khist.hist2side_plain,
             "masked_moments": kmom.masked_moments_plain,
             "binarize_apply": kbin.binarize_apply_plain}
    calls: list = []
    with swapped(ops, recording(ops, LEAF_KERNELS, calls)):
        compress_all()
    check([c[0] for c in calls] == list(LEAF_KERNELS[:1] + LEAF_KERNELS) * len(leaves),
          f"per-leaf calls {[c[0] for c in calls]}")
    errs = {name: 0.0 for name in LEAF_KERNELS}
    for name, args, kwargs in calls:
        got, want_ = wrap[name](*args, **kwargs), plain[name](*args, **kwargs)
        torch.cuda.synchronize()
        if name == "hist2side":
            check(torch.equal(got, want_), f"{name}: counts differ")
        elif name == "masked_moments":
            check(torch.equal(got[:, 1], want_[:, 1]), f"{name}: counts differ")
            check(torch.allclose(got[:, 0], want_[:, 0], rtol=1e-6, atol=0),
                  f"{name}: sums beyond rtol 1e-6")
        else:
            check(all(bit_equal(g, w) for g, w in zip(got, want_)), f"{name}: not bit-equal")
        err = 0.0 if name == "binarize_apply" else float((got - want_).abs().max())
        errs[name] = max(errs[name], err)
    print(f"per-leaf kernels == plain versions on all {len(calls)} calls of the path "
          f"(counts equal, binarize bit-equal, moment sums to rtol 1e-6); largest "
          f"absolute differences {errs}")

    # timed on the largest leaf (f1), operands rotated past the L2 cache
    f1 = max(range(len(leaves)), key=lambda i: leaves[i].numel())
    rows, nbins = {}, 128
    for name, args, kwargs in calls:
        x = args[0]
        if name in rows or x.numel() != leaves[f1].numel():
            continue
        nel = x.numel()
        copies = [(x.clone(), *args[1:]) for _ in range(copies_past_l2(4 * nel))]
        out_bytes = {"hist2side": 4 * 2 * nbins, "masked_moments": 16,
                     "binarize_apply": 8 * nel}[name]
        scalar_bytes = {"hist2side": 16, "masked_moments": 8, "binarize_apply": 16}[name]
        rows[name] = kernel_row(
            name, launches[name], errs[name],
            device_ms(lambda *a, f=wrap[name], kw=kwargs: f(*a, **kw), copies, 240, name),
            device_ms(lambda *a, f=plain[name], kw=kwargs: f(*a, **kw), copies, 24),
            4 * nel + scalar_bytes + out_bytes, OPS_PER_ELEMENT[name] * nel)
        del copies
    check(set(rows) == set(LEAF_KERNELS), f"per-leaf kernels timed: {sorted(rows)}")
    print(f"per-leaf kernels timed on {segs[f1][0].path}: n {leaves[f1].numel()}, "
          f"k {segs[f1][0].k}")

    # the survivor band of the reference's own test, on seeded Gaussian data
    n_f1, p = leaves[f1].numel(), segs[f1][0].rate
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(n_f1).astype(np.float32)
                         ).to(dev)
    gh, ge = ops.sbc_compress_hist(g, p=p), ops.sbc_compress_exact(g, p=p)
    k = max(1, round(p * n_f1))
    count, mean, exact_mean = float(gh.count), float(gh.mean), float(ge.mean)
    check(abs(count - k) <= max(2, 0.02 * k)
          and abs(mean - exact_mean) <= 0.02 * abs(exact_mean),
          f"Gaussian n {n_f1}: survivors {count} against k {k}, mu {mean} against the "
          f"exact {exact_mean}: outside the +-2% band")
    print(f"Gaussian n {n_f1}, p {p}: survivors {int(count)} against k {k} "
          f"({count / k - 1:+.2%}), mu {mean:.6e} against the exact top-k's "
          f"{exact_mean:.6e}: inside the +-2% band")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA card")
    check((ROOT / "src" / "repro_torch").is_dir(),
          f"no src/repro_torch beside {Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    # a parity port of an f32 reference: full f32 matmuls and convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # ---- 1. card and build
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    libs = _build.build()
    _build.library()
    print(f"built {[str(p.relative_to(ROOT)) for p in libs]} in "
          f"{time.perf_counter() - t0:.2f} s")

    # ---- 2., 3. and 4. the three paths
    rows, hist = hist_path(dev)
    rows.update(exact_path(dev))
    rows.update(leaf_path(dev, hist))
    check(set(rows) == set(KERNELS), f"kernels compared: {sorted(rows)}")

    # ---- 5. results
    print(json.dumps({"kernels": [rows[k] for k in KERNELS]}))
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
