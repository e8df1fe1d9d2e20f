"""Gemma 3 1B [hf:google/gemma-3-1b-pt].

5:1 local:global attention interleave (local sliding window 512), MQA
(kv=1), head_dim 256 ≠ d_model/heads, 262144 vocab (largest embedding
table relative to model size in the pool).  The 5:1 pattern bounds most of
the KV cache → long_500k runs (global layers are O(L) decode reads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="decoder",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    local_global_ratio=5,
    local_window=512,
    rope_theta=1_000_000.0,
    gated_mlp=True,
    client_mode="data",
    local_opt="adam",
    base_lr=3e-4,
)
