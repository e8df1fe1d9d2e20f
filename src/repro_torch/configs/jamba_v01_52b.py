"""Jamba v0.1 (52B total / 12B active) [arXiv:2403.19887].

Hybrid Mamba+attention 1:7 interleave (one attention layer per 8), MoE with
16 experts top-2 on every second layer.  The Mamba state makes long_500k
viable (attention layers are an O(L) cache read at decode).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="decoder",
    source="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    ssm_kind="mamba",
    ssm_ffn=True,  # every Jamba layer = (attn|mamba) mixer + (MLP|MoE) FFN
    attn_every=8,  # 1 attention : 7 mamba
    moe_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_dispatch="grouped",
    fsdp=True,
    client_mode="pod",
    local_opt="sgd",
    base_lr=3e-4,
    residual_dtype=torch.bfloat16,
)
