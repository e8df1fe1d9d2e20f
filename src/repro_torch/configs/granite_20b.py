"""Granite-20B-Code [arXiv:2405.04324].

Dense decoder, 52L, d=6144, 48 heads with ONE kv head (MQA, kv=1) — the
extreme GQA point in the pool; pure full attention (long_500k skipped).
≥20B: FSDP over 'data', pod-mode clients, bf16 residual.
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="decoder",
    source="arXiv:2405.04324",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,  # gpt_bigcode-style 2-matrix MLP (20B total)
    norm="layernorm",
    fsdp=True,
    client_mode="pod",
    local_opt="sgd",
    base_lr=3e-4,
    residual_dtype=torch.bfloat16,
)
