"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct].

phi3-mini text backbone + CLIP vision encoder.  The vision tower/projector
is the assignment's stub: ``input_specs`` provides 576 precomputed patch
embeddings (CLIP ViT-L/14 @ 336px) as an early-fusion prefix.  Full
attention (long_500k skipped — LongRoPE extends range but stays quadratic).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="decoder",
    source="hf:microsoft/Phi-3-vision-128k-instruct",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    modality="vision",
    n_prefix=576,
    gated_mlp=True,
    client_mode="data",
    local_opt="adam",
    base_lr=1e-4,
)
