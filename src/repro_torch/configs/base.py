"""Model / training configuration.

Counterpart of ``repro.configs.base``: every field of the reference's
:class:`ModelConfig`, with its defaults (``dtype`` is ``torch.bfloat16``,
as the reference's ``jnp.bfloat16``), its derived properties
(``layer_kinds``, ``layer_moe``, ``sub_quadratic``, ``skip_reason``,
``param_count``, ``active_param_count``), :func:`reduced`,
``INPUT_SHAPES``, ``ASSIGNED_ARCHS`` and :func:`input_specs`.

The port carries the paper's four models and all ten assigned
architectures: the dense text decoders (gemma3-1b, qwen1.5-4b,
granite-20b, command-r-35b), the MoE decoders (mixtral-8x7b,
llama4-maverick), the recurrent ones (jamba-v0.1, rwkv6-1.6b), the
vision-prefix decoder (phi-3-vision) and the encoder-decoder
(seamless-m4t).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Optional

import torch

# ------------------------------------------------------------- input shapes

INPUT_SHAPES: dict[str, dict[str, int]] = {
    # name: seq_len, global_batch, kind
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture, the reference's fields and defaults.  The
    width fields default to 0 so the paper configs name only theirs.

    ``residual_dtype`` is the dtype of the GSPMD backend's error-feedback
    residual, its ΔW and its optimizer state (bf16 for the reference's
    largest architectures).  The flat fast path keeps f32; any other dtype
    takes the per-leaf exchange, as in the reference.
    """

    name: str
    family: str  # 'decoder' | 'encdec' | 'lstm' | 'cnn'
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0  # 0 → d_model // n_heads
    source: str = ""  # paper / model-card citation

    # --- MoE
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_every: int = 1
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "grouped"

    # --- attention pattern
    window: int = 0  # sliding-window size (mixtral); 0 = full
    chunk_attn: int = 0  # chunked-local attention size (llama4)
    local_window: int = 0  # window of "local" layers in local:global mix
    local_global_ratio: int = 0  # gemma3: N local layers per 1 global
    global_every: int = 0  # llama4: full-attn layer every k-th (others chunked)

    # --- hybrid / SSM
    attn_every: int = 1
    ssm_kind: str = ""  # 'mamba' | 'rwkv6' ('' = attention everywhere)
    ssm_ffn: bool = False
    ssm_state: int = 16
    ssm_expand: int = 2
    ssm_conv: int = 4

    # --- misc transformer knobs
    qkv_bias: bool = False  # qwen1.5
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"  # 'rmsnorm' | 'layernorm'
    tie_embeddings: bool = True
    gated_mlp: bool = True  # SwiGLU-style
    dropout: float = 0.0

    # --- encoder-decoder
    enc_layers: int = 0
    bidirectional: bool = False

    # --- modality frontend stub (audio/vision)
    modality: str = "text"  # 'text' | 'audio' | 'vision'
    n_prefix: int = 0

    # --- cnn / lstm (paper's own models)
    img_size: int = 0
    img_channels: int = 3
    n_classes: int = 10
    lstm_hidden: int = 0

    # --- distribution
    fsdp: bool = False
    client_mode: str = "data"  # one client per data coordinate (DESIGN.md §4)
    local_opt: str = "momentum"  # client-side optimizer for this arch
    base_lr: float = 0.01
    residual_dtype: Any = torch.float32
    remat: bool = True  # the reference's jax.checkpoint; changes no number
    scan_layers: bool = True
    dtype: Any = torch.bfloat16

    # --- which input shapes apply ('' reason = runs)
    skip_shapes: tuple[tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------- helpers

    @property
    def layer_kinds(self) -> list[str]:
        """Per-layer block kind: 'attn' | 'attn_local' | 'attn_chunk' | ssm."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm_kind and self.attn_every > 1:
                kind = "attn" if (i % self.attn_every) == self.attn_every // 2 else self.ssm_kind
            elif self.ssm_kind:
                kind = self.ssm_kind
            elif self.local_global_ratio:
                r = self.local_global_ratio
                kind = "attn" if (i % (r + 1)) == r else "attn_local"
            elif self.global_every:
                kind = "attn" if (i % self.global_every) == self.global_every - 1 else "attn_chunk"
            elif self.window:
                kind = "attn_window"
            else:
                kind = "attn"
            if self.bidirectional and kind == "attn":
                kind = "attn_bidir"
            kinds.append(kind)
        return kinds

    @property
    def layer_moe(self) -> list[bool]:
        if not self.moe_experts:
            return [False] * self.n_layers
        return [(i % self.moe_every) == self.moe_every - 1 for i in range(self.n_layers)]

    @property
    def sub_quadratic(self) -> bool:
        """Bounded or recurrent context per token → long_500k applies."""
        if self.family in ("lstm",):
            return True
        if self.ssm_kind:
            return True
        return bool(self.window or self.chunk_attn or self.local_global_ratio)

    def skip_reason(self, shape_name: str) -> Optional[str]:
        for s, reason in self.skip_shapes:
            if s == shape_name:
                return reason
        shape = INPUT_SHAPES[shape_name]
        if shape["kind"] == "decode" and self.family == "cnn":
            return "encoder-only CNN: no autoregressive decode step"
        if shape_name == "long_500k" and not self.sub_quadratic:
            return "pure full attention: long-context decode requires sub-quadratic attention"
        return None

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        total = V * d * (1 if self.tie_embeddings else 2)
        for kind, moe in zip(self.layer_kinds, self.layer_moe):
            if kind.startswith("attn"):
                total += d * n_q + 2 * d * n_kv + n_q * d
            else:  # ssm block
                di = self.ssm_expand * d
                if kind == "mamba":
                    total += d * 2 * di + di * d + di * (2 * self.ssm_state + 2)
                else:  # rwkv6
                    total += 6 * d * d + 2 * d * self.d_ff + 2 * d * 64
            mlp = 3 * d * ff if self.gated_mlp else 2 * d * ff
            if moe:
                total += self.moe_experts * mlp + d * self.moe_experts
            elif not kind.startswith("rwkv"):
                total += mlp
            total += 2 * d  # norms
        if self.enc_layers:
            total += self.enc_layers * (2 * (d * n_q + 2 * d * n_kv + n_q * d) + 3 * d * ff)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mlp = 3 * d * ff if self.gated_mlp else 2 * d * ff
        inactive = sum((self.moe_experts - self.moe_top_k) * mlp for m in self.layer_moe if m)
        return int(self.param_count() - inactive)


# ------------------------------------------------------------- input specs


def input_specs(cfg: ModelConfig, shape_name: str, n_clients: int = 1) -> dict:
    """Stand-ins for every input of (cfg, shape): tensors on torch's
    ``meta`` device (no allocation) with the reference's shapes and
    dtypes (token ids int32, as the reference's).

    train:    tokens/labels (clients, per_client_batch, seq) int32
              (+ prefix embeddings for audio/vision stubs)
    prefill:  tokens (batch, seq)
    decode:   tokens (batch, 1)
    """
    shape = INPUT_SHAPES[shape_name]
    S, B, kind = shape["seq_len"], shape["global_batch"], shape["kind"]

    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "cnn":
        img = (B, cfg.img_size, cfg.img_size, cfg.img_channels)
        if kind == "train":
            per = max(1, B // n_clients)
            return {
                "images": f((n_clients, per) + img[1:], torch.float32),
                "labels": f((n_clients, per), torch.int32),
            }
        return {"images": f(img, torch.float32)}

    def _extras(lead: tuple[int, ...]) -> dict:
        ex = {}
        if cfg.family == "encdec":
            if cfg.modality == "audio":
                ex["enc_frames"] = f(lead + (S, cfg.d_model), cfg.dtype)
            else:
                ex["enc_tokens"] = f(lead + (S,), torch.int32)
        elif cfg.modality in ("audio", "vision"):
            ex["prefix"] = f(lead + (cfg.n_prefix, cfg.d_model), cfg.dtype)
        return ex

    if kind == "train":
        per = max(1, B // n_clients)
        specs = {
            "tokens": f((n_clients, per, S), torch.int32),
            "labels": f((n_clients, per, S), torch.int32),
        }
        specs.update(_extras((n_clients, per)))
        return specs

    if kind == "prefill":
        specs = {"tokens": f((B, S), torch.int32)}
        specs.update(_extras((B,)))
        return specs

    return {"tokens": f((B, 1), torch.int32)}


# ---------------------------------------------------------------- registry

ASSIGNED_ARCHS = [
    "seamless_m4t_medium",
    "granite_20b",
    "rwkv6_1p6b",
    "jamba_v01_52b",
    "mixtral_8x7b",
    "phi3_vision_4p2b",
    "command_r_35b",
    "qwen15_4b",
    "gemma3_1b",
    "llama4_maverick_400b_a17b",
]
PAPER_ARCHS = ["lenet5", "resnet32", "charlstm", "wordlstm"]
# the dense text decoders of the pool (ROADMAP A12, part 2)
DENSE_ARCHS = ["gemma3_1b", "qwen15_4b", "granite_20b", "command_r_35b"]
# the MoE and recurrent decoders (ROADMAP A12, part 3, items 1 and 2)
MOE_SSM_ARCHS = ["mixtral_8x7b", "llama4_maverick_400b_a17b", "jamba_v01_52b", "rwkv6_1p6b"]


def get_config(name: str, **overrides: Any) -> ModelConfig:
    """Load ``repro_torch/configs/<name>.py`` and return its CONFIG.

    Accepts the module key (``qwen15_4b``) or the display id
    (``qwen1.5-4b``), with the reference's aliases and dot/dash
    normalisations; an unknown name raises ``KeyError``."""
    aliases = {
        "phi-3-vision-4.2b": "phi3_vision_4p2b",
        "qwen1.5-4b": "qwen15_4b",
        "jamba-v0.1-52b": "jamba_v01_52b",
        "rwkv6-1.6b": "rwkv6_1p6b",
    }
    base = aliases.get(name, name).replace("-", "_")
    candidates = [name, base, base.replace(".", "p"), base.replace(".", ""),
                  base.replace(".", "_")]
    key = next((c for c in candidates if c in PAPER_ARCHS + ASSIGNED_ARCHS), None)
    if key is None:
        raise KeyError(f"no config module found for {name!r} (tried {candidates})")
    cfg = importlib.import_module(f"repro_torch.configs.{key}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduced(cfg: ModelConfig, **extra: Any) -> ModelConfig:
    """Smoke-test variant: ≤2 layers (or one layer-pattern period), d_model
    ≤ 256, ≤4 heads, ≤4 experts, windows ≤ 64, a vocabulary ≤ 512,
    ``fsdp=False`` and f32, as the reference's.  Keeps the family (layer
    pattern, GQA ratio) so smoke tests run the full config's code paths."""
    d = min(cfg.d_model, 256)
    heads = max(1, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    hd = max(8, d // heads)
    period = max(cfg.attn_every, (cfg.local_global_ratio + 1) if cfg.local_global_ratio else 1,
                 cfg.global_every or 1, cfg.moe_every)
    n_layers = min(cfg.n_layers, max(2, period))
    changes: dict[str, Any] = dict(
        n_layers=n_layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 512),
        moe_experts=min(cfg.moe_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_experts else cfg.moe_top_k,
        moe_capacity_factor=8.0,
        window=min(cfg.window, 64) if cfg.window else 0,
        chunk_attn=min(cfg.chunk_attn, 64) if cfg.chunk_attn else 0,
        local_window=min(cfg.local_window, 64) if cfg.local_window else 0,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
        n_prefix=min(cfg.n_prefix, 8) if cfg.n_prefix else 0,
        ssm_state=min(cfg.ssm_state, 8),
        lstm_hidden=min(cfg.lstm_hidden, 64) if cfg.lstm_hidden else 0,
        fsdp=False,
        dtype=torch.float32,
    )
    changes.update(extra)
    return dataclasses.replace(cfg, **changes)
