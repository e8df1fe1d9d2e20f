"""RWKV6 "Finch" 1.6B [arXiv:2404.05892].

Attention-free linear-recurrence LM with data-dependent decay (the defining
Finch feature, kept as a LoRA in our implementation).  O(1) state per token →
runs every decode shape including long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="decoder",
    source="arXiv:2404.05892",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # rwkv heads = d_model / 64 (used for state bookkeeping)
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    ssm_kind="rwkv6",
    norm="layernorm",
    client_mode="data",
    local_opt="adam",
    base_lr=3e-4,
)
