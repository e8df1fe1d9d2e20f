"""Federated orchestration launcher — a thin parser over ``repro_torch.run``.

Counterpart of ``repro.launch.fed``: the paper's §I parameter-server
deployment end to end on :mod:`repro_torch.fed` through a
:class:`~repro_torch.core.channel.FedWireChannel` — M heterogeneous
clients, partial participation, real packed SBW1 buffers in BOTH
directions, pluggable aggregation, and per-round bidirectional byte
accounting reconciled against Eq. 1/Eq. 5.  All flags are the shared
:func:`repro_torch.run.flags.add_run_flags` surface with the reference's
defaults for this launcher pinned on top (the ``fed-tiny`` preset, 16
clients, 20 rounds, delay 3, lr 0.05, the DGC-style dense-small rule), so
one command line names the same run in both packages:

  PYTHONPATH=src python -m repro_torch.launch.fed --rounds 2 --clients 4 \\
      --cohort 2                                            # fed-tiny
  PYTHONPATH=src python -m repro_torch.launch.fed --preset lenet5 --rounds 2 \\
      --clients 4 --cohort 2
  PYTHONPATH=src python -m repro_torch.launch.fed --preset lenet5 --clients 8 \\
      --cohort 4 --rounds 5 --sparsity 0.01 --down-sparsity 0.05 --fast
  PYTHONPATH=src python -m repro_torch.launch.fed --preset lenet5 --async \\
      --max-staleness 2 --agg staleness --clients 8 --cohort 4 --rounds 5
  PYTHONPATH=src python -m repro_torch.launch.fed --preset charlstm \\
      --profiles 1:0.001,2:0.01 --clients 4 --cohort 2 --rounds 3 --fast

``--profiles d:p[:w],...`` assigns client c the (delay, sparsity[, weight])
triple at index ``c % len(profiles)`` — the paper's temporal-vs-gradient
sparsity trade-off swept *within one run*.  A ``--faults`` schedule with a
``kill_server`` fault checkpoints the whole federation when it fires,
rebuilds the run, restores it and resumes.  The run is on the CUDA card
unless ``--device cpu`` is passed.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

from repro_torch.core.policy import DENSE_SMALL_PATTERN
from repro_torch.core.tree import tree_flatten
from repro_torch.run.build import build_run
from repro_torch.run.flags import add_run_flags, spec_from_args
from repro_torch.run.presets import fed_tiny_config  # noqa: F401 (re-export)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_run_flags(
        ap,
        preset="fed-tiny",
        backend="fed",
        clients=16,
        rounds=20,
        delay=3,
        sparsity=0.01,
        lr=0.05,
        log_every=5,
        # the DGC-style recipe: tiny leaves (biases, norm scales) ride
        # dense, matrices get the chosen codec
        dense_pattern=DENSE_SMALL_PATTERN,
    )
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the plain versions")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args, backend="fed")
    run = build_run(spec, device=args.device)
    sched = run.init()
    pool, server = sched.pool, sched.server

    params = server.params
    n_params = sum(x.numel() for x in tree_flatten(params)[0])
    print(
        f"fed: {spec.clients} clients (cohort {sched.cohort_size}), "
        f"{len(pool.profiles)} profile(s), agg={server.aggregator}, "
        f"mode={sched.mode}, {'non-IID' if spec.non_iid else 'IID'}, "
        f"params={n_params/1e6:.2f}M, device={run.device}"
    )
    print(pool.resolved(params).describe())

    t0 = time.time()
    if spec.telemetry:
        # through Run.run: the traced loop wraps every round in a span and
        # ingests the ledger into round-tagged gauges at the end
        _, hist = run.run(spec.rounds, log_every=args.log_every)
    else:
        from repro_torch.fed.checkpoint import restore_fed_state
        from repro_torch.fed.faults import ServerKilled

        hist, start = None, 0
        while hist is None:
            try:
                hist = sched.run(spec.rounds, log_every=args.log_every, start_round=start)
            except ServerKilled as e:
                # a scheduled --faults kill fired: checkpoint the whole
                # federation, rebuild from scratch, restore, and continue
                fd, ckpt = tempfile.mkstemp(suffix=".fedckpt.npz")
                os.close(fd)
                print(f"server killed at round {e.round_idx} ({e.step}); "
                      f"checkpoint → restore → resume")
                run.checkpoint(sched, ckpt, rounds_done=e.round_idx)
                run = build_run(spec, device=args.device)
                sched = run.init()
                restore_fed_state(ckpt, sched)
                os.unlink(ckpt)
                pool, server = sched.pool, sched.server
                pending = sched.resume_pending()
                start = e.round_idx + (1 if pending is not None else 0)
    dt = time.time() - t0
    sched.ledger.reconcile(rel=0.1)
    t = sched.ledger.totals()
    # dense DSGD uploads 32·n_params bits per LOCAL STEP, i.e. ×delay per
    # member per round (delay varies per profile)
    dense_up_bits = sum(32.0 * n_params * pool.profile_of(c).delay
                        for rec in sched.ledger.records for c in rec.cohort)
    loss_arc = (f"loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}" if hist["loss"]
                else "loss n/a (every round predates the resume)")
    print(f"done in {dt:.1f}s ({spec.rounds / dt:.2f} rounds/s): {loss_arc}")
    print(
        f"wire: up {t['up_bytes']/1e3:.1f} kB, down {t['down_bytes']/1e3:.1f} kB "
        f"(measured/analytic up ×{t['up_bits_measured']/max(t['up_bits_analytic'],1):.3f}, "
        f"down ×{t['down_bits_measured']/max(t['down_bits_analytic'],1):.3f}); "
        f"dense up would be {dense_up_bits / 8e6:.1f} MB "
        f"(×{dense_up_bits / max(t['up_bytes'] * 8, 1):.0f})"
    )
    if t["up_bytes_wasted"]:
        print(f"elasticity: {t['up_bytes_wasted']/1e3:.1f} kB of uploads "
              "wasted (straggler aborts + corrupt rejects)")
    if spec.telemetry:
        from repro_torch.obs import finish_run

        finish_run(run.telemetry, trace=args.trace, metrics_out=args.metrics_out,
                   meta={"backend": "fed", "preset": spec.preset, "rounds": spec.rounds})
    if args.history:
        os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
        with open(args.history, "w") as f:
            json.dump(hist, f, default=float)
        print(f"wrote {args.history}")
    return hist


if __name__ == "__main__":
    main()
