"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family].

The scale ceiling of the pool: 128-expert top-1 MoE on alternating layers
(dense MLP between), chunked-local attention (8k chunks) with a global
layer every 4th → long_500k viable.  Early-fusion multimodal in the source
model; the assignment pins the text backbone (vision tower would be a stub,
but the 400B config is exercised text-only).

Distribution: experts shard over 'data' (expert parallelism) AND ff over
'model'; pod-mode clients with bf16 residual — per-data-coordinate client
state is physically impossible at 400B (DESIGN.md §4).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="decoder",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    moe_experts=128,
    moe_top_k=1,
    moe_every=2,  # alternating dense / MoE (Maverick interleave)
    moe_dispatch="flat_ep",
    chunk_attn=8192,
    global_every=4,
    fsdp=True,
    client_mode="pod",
    local_opt="sgd",
    base_lr=3e-4,
    residual_dtype=torch.bfloat16,
)
