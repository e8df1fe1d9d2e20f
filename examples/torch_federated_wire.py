"""Federated-learning wire demo on the PyTorch port, the paper's
privacy-preserving setting (§I): clients exchange ONLY packed SBW1 byte
buffers with a parameter server, in BOTH directions (the port's
``examples/federated_wire.py``).

A thin wrapper over the port's federated subsystem (:mod:`repro_torch.fed`):

  * :class:`ParameterServer` unpacks every client's framed buffer (Alg. 4),
    aggregates, keeps a server-side error-feedback residual, and compresses
    the downstream broadcast through the same per-leaf policy machinery,
  * :class:`ClientPool` runs each sampled cohort's local steps with
    per-client residuals, on the card,
  * :class:`RoundScheduler` drives the rounds and meters every byte both
    ways against the analytic Eq. 1/Eq. 5 prediction.

Richer knobs (async staleness, non-IID shards, heterogeneous client
profiles, weighted aggregation) live in the CLI:

  PYTHONPATH=src python -m repro_torch.launch.fed --help

Run:  PYTHONPATH=src python examples/torch_federated_wire.py [--device cpu]
[--rounds 10] (the CUDA card by default)
"""
import argparse

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import CompressionPolicy, PolicyRule
from repro_torch.core.codec import make_codec
from repro_torch.core.policy import DENSE_SMALL_PATTERN
from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.data import make_lm_task
from repro_torch.device import resolve_device
from repro_torch.fed import ClientPool, ClientProfile, ParameterServer, RoundScheduler
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer

N_CLIENTS, COHORT, DELAY, SPARSITY, DOWN_SPARSITY, ROUNDS = 4, 4, 5, 0.01, 0.05, 10

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default=None, help="cuda (default), cuda:N, or cpu")
ap.add_argument("--rounds", type=int, default=ROUNDS)
args = ap.parse_args()
dev, ROUNDS = resolve_device(args.device), args.rounds

cfg = ModelConfig(name="fed-tiny", family="decoder", n_layers=2, d_model=128,
                  n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=256,
                  dtype=torch.float32)
model = build_model(cfg)
task = make_lm_task(vocab=256, batch=8, seq_len=64, temperature=0.5, device=dev)

policy = CompressionPolicy(
    default=make_codec("sbc"),
    rules=(PolicyRule(DENSE_SMALL_PATTERN, codec="dense32"),),
    name="sbc+dense-small",
)

server = ParameterServer(
    params=tree_map(lambda v: v.to(dev), model.init(torch.Generator().manual_seed(0))),
    up_policy=policy,             # shared wire contract with the clients
    down_sparsity=DOWN_SPARSITY,  # the broadcast is compressed too
)
pool = ClientPool(
    model=model, optimizer=get_optimizer("momentum"), policy=policy,
    task=task, n_clients=N_CLIENTS, lr=lambda it: 0.05,
    profiles=(ClientProfile(delay=DELAY, sparsity=SPARSITY),), device=dev,
)
sched = RoundScheduler(server=server, pool=pool, cohort_size=COHORT)

print(pool.resolved(server.params).describe())
hist = sched.run(ROUNDS, log_every=1)
sched.ledger.reconcile(rel=0.1)
print("the ledger's measured bytes reconcile with Eq. 1/Eq. 5 ✓")

n_params = sum(v.numel() for v in tree_flatten(server.params)[0])
t = sched.ledger.totals()
dense_up = 4 * n_params * N_CLIENTS * ROUNDS * DELAY  # dense DSGD, per step
assert 0 < t["up_bytes"] < dense_up and t["down_bytes"] > 0
print(
    f"\nwire totals: up {t['up_bytes']/1e3:.1f} kB, down {t['down_bytes']/1e3:.1f} kB "
    f"(dense DSGD upload would be {dense_up/1e6:.1f} MB → "
    f"×{dense_up/max(t['up_bytes'],1):.0f})"
)
print("every byte that crossed the 'network' was a real packed SBW1 buffer, "
      "both directions, and the ledger reconciles with Eq. 1/Eq. 5 ✓")
