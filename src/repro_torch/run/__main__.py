"""``python -m repro_torch.run``: the declarative launcher of the port.

Same flags as ``python -m repro.run``; the port runs

  PYTHONPATH=src python -m repro_torch.run --preset lenet5 --backend local \\
      --sparsity 0.01 --rounds 5 --measure-wire [--fast]
  PYTHONPATH=src python -m repro_torch.run --preset charlstm --backend local \\
      --sparsity 0.01 --rounds 5 --measure-wire --trace t.json --metrics-out m.jsonl
  PYTHONPATH=src python -m repro_torch.run --preset lenet5 --backend gspmd \\
      --fast --flat-engine hist --sparsity 0.01 --batch 128 --rounds 5
  PYTHONPATH=src python -m repro_torch.run --preset lenet5 --backend gspmd \\
      --fast --flat-engine exact --device-pack --measure-wire --sparsity 0.01
  PYTHONPATH=src python -m repro_torch.run --preset lenet5 --backend fed \\
      --clients 8 --cohort 4 --rounds 5 --sparsity 0.01 --measure-wire [--fast]

on the CUDA card (``--device cpu`` runs the kernels' plain versions).  The
GSPMD backend runs one client per process; ``torchrun`` starts them, one
per card over NCCL, or on the CPU over gloo with ``--device cpu``:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 -m repro_torch.run \\
      --preset lenet5 --backend gspmd --fast --flat-engine exact --device-pack \\
      --measure-wire [--device cpu]

Rank 0 alone prints, meters the wire into its ledger and writes
``--trace``/``--metrics-out``/``--history``.
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.core.tree import tree_flatten
from repro_torch.run.build import build_run
from repro_torch.run.flags import build_parser, spec_from_args


def main(argv=None):
    ap = build_parser()
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the plain versions")
    args = ap.parse_args(argv)
    spec = spec_from_args(args)
    run = build_run(spec, device=args.device)
    group = getattr(run, "group", None)
    try:
        if group is None or group.rank == 0:
            return _report(run, spec, args)
        run.run()
        return None
    finally:
        if group is not None:
            group.close()


def _report(run, spec, args) -> dict:
    """Run, and print and write what the reference's launcher does."""
    with torch.device("meta"):  # shapes only
        n_params = sum(v.numel() for v in tree_flatten(run.model.init(torch.Generator()))[0])
    engine = (f"engine={spec.flat_engine} device_pack={spec.device_pack} "
              if spec.backend == "gspmd" else "")
    print(
        f"run: backend={spec.backend} preset={spec.preset} "
        f"arch={run.cfg.name} params={n_params/1e6:.2f}M "
        f"compressor={spec.compressor} clients={run.n_clients} "
        f"delay={spec.delay} p={spec.sparsity} fast={spec.fast} "
        f"{engine}device={run.device}"
    )
    t0 = time.time()
    state, hist = run.run(log_every=args.log_every)
    dt = time.time() - t0
    print(
        f"done in {dt:.1f}s: loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}"
    )
    if "compression_rate" in hist:
        print(
            f"upload {hist['total_upload_bits']/8e6:.2f} MB/client  "
            f"compression ×{hist['compression_rate']:.0f}"
        )
    if run.ledger.records:
        t = run.ledger.totals()
        print(
            f"wire: up {t['up_bytes']/1e3:.1f} kB, down {t['down_bytes']/1e3:.1f} kB "
            f"(measured/analytic up "
            f"×{t['up_bits_measured']/max(t['up_bits_analytic'],1):.3f})"
        )
    if spec.telemetry:
        from repro_torch.obs import finish_run

        finish_run(run.telemetry, trace=args.trace, metrics_out=args.metrics_out,
                   meta={"backend": spec.backend, "preset": spec.preset,
                         "rounds": spec.rounds})
    if args.history:
        os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
        with open(args.history, "w") as f:
            json.dump({k: v for k, v in hist.items() if k != "eval"}, f, default=float)
        print(f"wrote {args.history}")
    return hist


if __name__ == "__main__":
    main()
