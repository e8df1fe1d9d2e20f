"""Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

Dense decoder with GQA (64 q heads / 8 kv), no biases anywhere, 256k vocab
(the largest in the pool — exercises the chunked-xent path hard).  Pure full
attention → long_500k skipped.  ≥20B: FSDP + pod-mode clients.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="decoder",
    source="hf:CohereForAI/c4ai-command-r-v01",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    gated_mlp=True,
    qkv_bias=False,
    fsdp=True,
    client_mode="pod",
    local_opt="sgd",
    base_lr=3e-4,
    residual_dtype=torch.bfloat16,
)
