"""Batched serving demo on the PyTorch port: prefill a batch of prompts on
a reduced gemma3 (5:1 local:global attention) and a reduced jamba (mamba
hybrid), then decode with the one-token serve step the decode_32k /
long_500k dry-run shapes exercise at production scale (the port's
``examples/serve_batched.py``).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
(the CUDA card by default)
"""
import argparse
import time

import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default), cuda:N, or cpu")
dev = resolve_device(ap.parse_args().device)

for arch in ("gemma3-1b", "jamba-v0.1-52b"):
    cfg = reduced(get_config(arch))
    model = build_model(cfg)
    engine = ServeEngine(model)
    params = tree_map(lambda v: v.to(dev), model.init(torch.Generator().manual_seed(0)))

    B, PROMPT, NEW = 4, 48, 24
    gen = torch.Generator(dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                                     device=dev)}

    t0 = time.time()
    out = engine.generate(params, batch, max_new_tokens=NEW, temperature=0.8, gen=gen)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    print(f"{arch:>16} (reduced): {B} prompts × {NEW} new tokens "
          f"in {dt:.2f}s — cache kinds: "
          f"{sorted(set(cfg.layer_kinds))}")
    print(f"{'':>16}  sample: {out[0, :12].tolist()}")
    assert tuple(out.shape) == (B, NEW) and 0 <= int(out.min()) <= int(out.max()) < cfg.vocab_size
    print(f"{'':>16}  {B} × {NEW} tokens in the vocabulary ✓")
