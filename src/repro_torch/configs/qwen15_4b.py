"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family].

Dense decoder, MHA-equal GQA (kv=heads=20), QKV *biases* (the family's
signature), 151936 vocab.  Pure full attention → long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="decoder",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151936,
    qkv_bias=True,
    gated_mlp=True,
    tie_embeddings=False,
    client_mode="data",
    local_opt="adam",
    base_lr=3e-4,
)
