"""Mixtral 8x7B [arXiv:2401.04088].

Sparse MoE: 8 experts, top-2 routing on every layer; sliding-window
attention (W=4096) bounds the KV cache → long_500k runs.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="decoder",
    source="arXiv:2401.04088",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    moe_experts=8,
    moe_top_k=2,
    moe_every=1,
    window=4096,  # SWA
    moe_dispatch="grouped",
    fsdp=True,
    client_mode="pod",
    local_opt="sgd",
    base_lr=3e-4,
    residual_dtype=torch.bfloat16,
)
