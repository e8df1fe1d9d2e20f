"""End-to-end DSGD training launcher: a thin parser over ``repro_torch.run``.

Counterpart of ``repro.launch.train``: the paper's training setting (M
clients, communication delay n, sparsity p, any registered compressor) on
a synthetic task sized by ``--preset``, with the backend pinned to
"local".  The flags are the shared run flags
(:func:`repro_torch.run.flags.add_run_flags`) plus ``--save``,
``--print-policy`` and ``--device``.  The default preset is the
reference's, ``lm-100m`` (137,841,408 parameters, seq 256); the paper's
presets (``lenet5``/``paper-lenet``, ``charlstm``/``paper-lstm``,
``wordlstm``), ``tiny``, ``fed-tiny`` and the reduced dense decoders
run too, with any registered compressor.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --clients 4 --batch 8 \\
      --sparsity 0.001 --rounds 3 --log-every 1            # lm-100m, the card
  PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --rounds 3 \\
      --batch 4 --seq-len 16 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --preset lenet5 \\
      --sparsity 0.01 --rounds 5 --clients 4 --batch 128 --measure-wire
  PYTHONPATH=src python -m repro_torch.launch.train --preset paper-lenet \\
      --compressor topk --sparsity 0.001 --rounds 100
  PYTHONPATH=src python -m repro_torch.launch.train --preset paper-lstm \\
      --compressor sbc --sparsity 0.01 --rounds 3 --clients 2 --batch 4 \\
      --seq-len 32 --log-every 1
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.checkpoint import save_pytree
from repro_torch.core.baselines import dgc_policy  # noqa: F401 (registration)
from repro_torch.core.tree import tree_flatten
from repro_torch.run.build import build_run, lr_schedule  # noqa: F401 (re-export)
from repro_torch.run.flags import add_run_flags, spec_from_args
from repro_torch.run.presets import build_preset, lm_100m_config  # noqa: F401 (re-export)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_run_flags(ap, preset="lm-100m", backend="local", rounds=200, seq_len=256,
                  log_every=10)
    ap.add_argument("--save", default=None, help="checkpoint path (.npz)")
    ap.add_argument("--print-policy", action="store_true",
                    help="print the per-leaf codec resolution and exit")
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu for the plain versions")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args, backend="local")
    run = build_run(spec, device=args.device)
    with torch.device("meta"):  # shapes only
        params = run.model.init(torch.Generator())

    if args.print_policy:
        print(run.trainer.resolved(params).describe())
        return {}

    n_params = sum(v.numel() for v in tree_flatten(params)[0])
    print(
        f"preset={spec.preset} arch={run.cfg.name} params={n_params/1e6:.1f}M "
        f"compressor={spec.compressor} clients={spec.clients} "
        f"delay={spec.delay} p={spec.sparsity} device={run.device}"
    )
    t0 = time.time()
    state, hist = run.run(log_every=args.log_every)
    dt = time.time() - t0
    print(
        f"done in {dt:.1f}s: loss {hist['loss'][0]:.4f} → {hist['loss'][-1]:.4f}  "
        f"upload {hist['total_upload_bits']/8e6:.2f} MB/client  "
        f"compression ×{hist['compression_rate']:.0f}"
    )
    if spec.measure_wire:
        print(
            f"measured wire: {hist['measured_total_bits']/8e6:.2f} MB/client "
            f"(analytic {hist['total_upload_bits']/8e6:.2f} MB)"
        )
    if spec.telemetry:
        from repro_torch.obs import finish_run

        finish_run(run.telemetry, trace=args.trace, metrics_out=args.metrics_out,
                   meta={"backend": "local", "preset": spec.preset, "rounds": spec.rounds})
    if args.save:
        save_pytree(args.save, state.params)
        print(f"saved params to {args.save}")
    if args.history:
        os.makedirs(os.path.dirname(os.path.abspath(args.history)), exist_ok=True)
        with open(args.history, "w") as f:
            json.dump({k: v for k, v in hist.items() if k != "eval"}, f)
    return hist


if __name__ == "__main__":
    main()
