"""Shared layers (counterpart of ``repro.models.layers``): dense, norms,
the token embedding, rotary embeddings and the MLP.

Params are nested dicts of tensors; every ``init_*`` returns a dict and
draws from a ``torch.Generator`` on that generator's device, so a CUDA
generator draws a large model on the card (a CPU generator draws on
torch's default device: the CPU, or ``meta`` for shapes alone).  Each weight is drawn in f32
and cast to its dtype as it is drawn, as the reference's.  Norms, rope
and softmax run in f32 and cast back to ``x.dtype`` at the reference's
cast points.

The reference multiplies a Python scalar into a bf16 array as JAX's weak
type does: the scalar is rounded to bf16 first.  torch keeps it in f32,
so :func:`scale_by` rounds it to the tensor's dtype before the product.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def gen_device(gen: torch.Generator):
    """Where ``gen`` draws: its device, or ``None`` (torch's default device)
    for a CPU generator, so ``with torch.device("meta")`` around an init
    gives the parameters' shapes and dtypes without drawing them."""
    return None if gen.device.type == "cpu" else gen.device


def _randn(gen: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=dtype, device=gen_device(gen))


def scale_by(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x * s`` with ``s`` rounded to ``x.dtype`` first, as JAX multiplies
    a weakly typed Python scalar (√1152 is 34.0 in bf16)."""
    return x * float(torch.tensor(s, dtype=x.dtype))


def init_dense(gen: torch.Generator, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.bfloat16, scale: Optional[float] = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": (_randn(gen, (d_in, d_out)) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen_device(gen))
    return p


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_norm(d: int, kind: str = "rmsnorm", dtype=torch.bfloat16, device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: dict, x: torch.Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def init_embed(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> dict:
    """``{"embedding": (vocab, d)}`` drawn from ``gen`` on its device,
    normal with standard deviation ``1/√d``, cast to ``dtype``."""
    return {"embedding": (_randn(gen, (vocab, d)) * (1.0 / math.sqrt(d))).to(dtype)}


def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(embedding, tokens, axis=0)``.  ``F.embedding``, not
    advanced indexing or ``index_select``, whose backward on the card may
    add a repeated token's rows with atomics: with it a CharLSTM round repeats
    bit for bit on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
    return F.embedding(tokens, p["embedding"])


# ----------------------------------------------------------------- rotary


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions: (seq,)
    or broadcastable to x's seq dim."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device), -ar / half)
    angles = positions.to(torch.float32)[..., None] * freqs  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# -------------------------------------------------------------------- MLP


def init_mlp(gen: torch.Generator, d: int, ff: int, *, gated: bool = True,
             dtype=torch.bfloat16) -> dict:
    p = {"up": init_dense(gen, d, ff, dtype=dtype), "down": init_dense(gen, ff, d, dtype=dtype)}
    if gated:
        p["gate"] = init_dense(gen, d, ff, dtype=dtype)
    return p


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU (``x·sigmoid(x)``, each op rounded to the dtype, as
    ``jax.nn.silu``) or, without a gate, GELU's tanh approximation
    (``jax.nn.gelu``'s default)."""
    h = dense(p["up"], x)
    if "gate" in p:
        g = dense(p["gate"], x)
        h = g * torch.sigmoid(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(p["down"], h)
