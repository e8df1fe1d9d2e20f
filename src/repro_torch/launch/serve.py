"""Serving launcher: prefill a batch of prompts, decode new tokens.

Counterpart of ``repro.launch.serve``, with its flags and output lines,
plus ``--device``.  The model's parameters are drawn from a generator
seeded 0 on the run's device (on the card, a 1 B-parameter model is drawn
there, each leaf in its dtype), and the prompts from a second one.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 4 --prompt-len 64 --new-tokens 32            # the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --batch 2 --prompt-len 64 --new-tokens 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --full-size --batch 4 --prompt-len 2048 --new-tokens 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --batch 2 --prompt-len 64 --new-tokens 8 --device cpu

``--subscribers N`` also runs the delta-broadcast fan-out
(:func:`repro_torch.serve.simulate_fanout`) on the same architecture's
parameters: a DeltaLog-backed server broadcasting compressed deltas to N
subscribers with heterogeneous sync periods.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --subscribers 10000 --broadcast-rounds 12

Without ``--full-size`` the architecture is the reference's ``reduced``
variant (f32).  Every architecture serves: the dense, MoE (mixtral-8x7b,
llama4) and recurrent decoders (jamba-v0.1, rwkv6-1.6b, whose decode
carries Mamba's ``{h, conv}`` and RWKV6's ``{s, tm_prev, cm_prev}``
states), phi-3-vision (the prompt's first ``n_prefix`` positions are
patch embeddings) and the encoder-decoder seamless-m4t (the encoder reads
``--prompt-len`` frames; the decoder's caches carry its memory):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch seamless-m4t-medium \
      --batch 2 --prompt-len 16 --new-tokens 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi-3-vision-4.2b \
      --batch 2 --prompt-len 16 --new-tokens 4 --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.run.flags import add_telemetry_flags, telemetry_requested
from repro_torch.serve import ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced smoke variant)")
    g = ap.add_argument_group("delta broadcast (docs/broadcast.md)")
    g.add_argument("--subscribers", type=int, default=0,
                   help="also fan the model's deltas out to N subscribers "
                        "through a DeltaLog (0 = skip)")
    g.add_argument("--broadcast-rounds", type=int, default=12,
                   help="broadcast rounds to simulate")
    g.add_argument("--broadcast-sparsity", type=float, default=0.02,
                   help="downstream sparsity of the logged broadcasts")
    g.add_argument("--delta-horizon", type=int, default=8,
                   help="rounds the DeltaLog keeps before forcing full resync")
    add_telemetry_flags(ap)
    ap.add_argument("--device", default=None,
                    help="cuda (default), cuda:N, or cpu")
    return ap


def build_engine(args: argparse.Namespace):
    """``(cfg, engine, params, batch)`` for the parsed flags: the config
    (reduced unless ``--full-size``), its parameters drawn on the device
    from a generator seeded 0, and a batch of prompts drawn from a second
    generator seeded 0, then from it the modality stub's input as the
    reference builds it: an audio encoder-decoder's ``enc_frames`` (batch,
    prompt length, d), a text one's ``enc_tokens`` (the prompts), a vision
    config's ``prefix`` (batch, n_prefix, d), each 0.1 × a normal draw."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(0)
    B, S = args.batch, args.prompt_len
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)}
    if cfg.family == "encdec":
        if cfg.modality == "audio":
            batch["enc_frames"] = 0.1 * torch.randn((B, S, cfg.d_model), generator=g,
                                                    device=dev)
        else:
            batch["enc_tokens"] = batch["tokens"]
    elif cfg.modality == "vision":
        batch["prefix"] = 0.1 * torch.randn((B, cfg.n_prefix, cfg.d_model), generator=g,
                                            device=dev)
    return cfg, ServeEngine(model), params, batch


def main(argv=None):
    args = build_parser().parse_args(argv)
    cfg, engine, params, batch = build_engine(args)

    t0 = time.time()
    out = engine.generate(params, batch, max_new_tokens=args.new_tokens,
                          temperature=args.temperature)
    out.cpu()  # waits for the device
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"arch={cfg.name} generated {tuple(out.shape)} in {dt:.2f}s "
          f"({total/dt:.1f} tok/s incl. first-call setup)")
    print("sample token ids:", out[0, :16].tolist())

    if args.subscribers > 0:
        from repro_torch.obs import NULL_TELEMETRY, finish_run, make_telemetry, render_table
        from repro_torch.serve import simulate_fanout

        telemetry = make_telemetry() if telemetry_requested(args) else NULL_TELEMETRY
        m = simulate_fanout(
            params,
            n_subscribers=args.subscribers,
            rounds=args.broadcast_rounds,
            horizon=args.delta_horizon,
            down_sparsity=args.broadcast_sparsity,
            seed=0,
            telemetry=telemetry,
            device=out.device,
        )
        print(
            f"broadcast: {m['n_subscribers']} subscribers x "
            f"{m['timed_rounds']} rounds  "
            f"{m['bytes_per_subscriber_per_round']:.1f} B/sub/round  "
            f"{m['bytes_saving_vs_full_resync']:.1f}x vs full resync  "
            f"{m['rounds_per_sec']:.2f} rounds/s"
        )
        print(render_table(
            ["lag", "plan", "bytes", "vs full resync"],
            [(lag, p["kind"], p["nbytes"],
              f"x{m['full_resync_bytes'] / max(p['nbytes'], 1):.1f}")
             for lag, p in sorted(m["plan_by_lag"].items(), key=lambda kv: int(kv[0]))],
            title="catch-up plan by lag class",
        ))
        if telemetry.enabled:
            finish_run(telemetry, trace=args.trace, metrics_out=args.metrics_out,
                       meta={"backend": "serve", "subscribers": args.subscribers,
                             "rounds": args.broadcast_rounds})
    return out


if __name__ == "__main__":
    main()
