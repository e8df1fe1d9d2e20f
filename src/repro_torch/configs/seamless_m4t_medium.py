"""SeamlessM4T-medium backbone [arXiv:2308.11596].

Encoder-decoder, multimodal (speech→text).  Per the assignment carve-out the
conformer/mel frontend is a stub: ``input_specs`` provides precomputed frame
embeddings (``enc_frames``) consumed directly by the text-decoder-facing
transformer encoder.  12L refers to each stack; 16 heads with kv=16 (MHA),
LayerNorm + non-gated MLP (standard seq2seq transformer block).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    source="arXiv:2308.11596",
    n_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    gated_mlp=False,
    modality="audio",
    tie_embeddings=True,
    client_mode="data",
    local_opt="adam",
    base_lr=1e-4,
)
