"""§III demo on the PyTorch port: the temporal-vs-gradient sparsity
trade-off and the adaptive controller (the paper's §V "future work", a
beyond-paper feature in core/sparsity.py; the port's
``examples/sparsity_tradeoff.py``).

Trains the same model three ways under an IDENTICAL total-sparsity budget:
  A. purely temporal   (delay 16, dense updates)    — Federated Averaging
  B. purely gradient   (delay 1, p = 1/16)          — Gradient Dropping line
  C. adaptive schedule (temporal early, gradient after the LR drop)

Run:  PYTHONPATH=src python examples/torch_sparsity_tradeoff.py [--device cpu]
(the CUDA card by default)
"""
import argparse
import math
import warnings

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import make_compressor
from repro_torch.core.sparsity import adaptive_total_budget
from repro_torch.data import client_batches, make_lm_task
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer
from repro_torch.train import DSGDTrainer

BUDGET = 1.0 / 16.0  # total sparsity = (1/delay)·p
ITERS = 64

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default), cuda:N, or cpu")
dev = resolve_device(ap.parse_args().device)

cfg = ModelConfig(name="tradeoff", family="decoder", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
                  dtype=torch.float32)
model = build_model(cfg)
task = make_lm_task(vocab=256, batch=8, seq_len=64, temperature=0.5, device=dev)


def run(tag, schedule):
    # dense rounds (p = 1) exchange full updates (FedAvg semantics);
    # sparse rounds go through SBC — both share the same model state.
    # Per-round adaptive schedules need the trainer layer directly (a
    # RunSpec pins one static schedule), so the legacy warning is muted.
    def mk(name):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return DSGDTrainer(
                model=model, compressor=make_compressor(name),
                optimizer=get_optimizer("momentum"), n_clients=4,
                lr=lambda it: 0.05, device=dev,
            )
    tr_sbc, tr_dense = mk("sbc"), mk("none")
    state = tr_sbc.init(torch.Generator().manual_seed(0))
    total_bits, it, r, last = 0.0, 0, 0, 0.0
    while it < ITERS:
        delay, p = schedule(r)
        delay = min(delay, ITERS - it)
        tr = tr_dense if p >= 1.0 else tr_sbc
        bf = client_batches(task, 4, delay)
        state, m = tr.round_step(state, bf(r), n_delay=delay, sparsity=p)
        total_bits += float(m["bits_per_client"])
        it += delay
        r += 1
        last = float(m["loss"])
    print(f"{tag:>22}: loss {last:.4f} after {ITERS} iters, "
          f"{total_bits:.3e} bits/client")
    return last


losses = [run("temporal (fedavg-ish)", lambda r: (16, 1.0)),
          run("gradient (GD-ish)", lambda r: (1, BUDGET))]
sched = adaptive_total_budget(BUDGET, lr_schedule=lambda r: 0.05 if r < 2 else 0.005,
                              base_lr=0.05, max_delay=16)
losses.append(run("adaptive (§V)", sched))
assert all(math.isfinite(x) and x < math.log(256) for x in losses)
print("each schedule trained below the uniform loss ln 256 ✓")
