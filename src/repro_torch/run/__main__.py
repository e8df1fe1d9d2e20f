"""``python -m repro_torch.run``: the declarative launcher of the port.

Same flags as ``python -m repro.run``; this slice runs

  PYTHONPATH=src python -m repro_torch.run --preset lenet5 --backend gspmd \\
      --fast --flat-engine hist --sparsity 0.01 --batch 128 --rounds 5

on the CUDA card (``--device cpu`` runs the kernels' plain versions).
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.run.build import build_run
from repro_torch.run.flags import build_parser, spec_from_args


def main(argv=None):
    ap = build_parser()
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the plain versions")
    args = ap.parse_args(argv)
    spec = spec_from_args(args)
    run = build_run(spec, device=args.device)

    n_params = sum(s.global_size for s in run.fns.flat_space.segments)
    print(
        f"run: backend={spec.backend} preset={spec.preset} "
        f"arch={run.cfg.name} params={n_params/1e6:.2f}M "
        f"compressor={spec.compressor} clients={run.n_clients} "
        f"delay={spec.delay} p={spec.sparsity} fast={spec.fast} "
        f"engine={spec.flat_engine} device={run.device}"
    )
    t0 = time.time()
    state, hist = run.run(log_every=args.log_every)
    dt = time.time() - t0
    print(
        f"done in {dt:.1f}s: loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}"
    )
    print(
        f"upload {hist['total_upload_bits']/8e6:.2f} MB/client  "
        f"compression ×{hist['compression_rate']:.0f}"
    )
    if args.history:
        os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
        with open(args.history, "w") as f:
            json.dump(hist, f, default=float)
        print(f"wrote {args.history}")
    return hist


if __name__ == "__main__":
    main()
