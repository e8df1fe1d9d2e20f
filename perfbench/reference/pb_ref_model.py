"""Plain PyTorch forward pass and loss of the benchmark's models, in f32.

Written from the published descriptions as the port configures them (the
configuration file's ``model``): a pre-norm decoder (RMSNorm, grouped
query attention with rotary positions, a causal mask and a sliding
window, a top-k MoE with a capacity per batch row) and an
encoder-decoder (LayerNorm, a bidirectional encoder over frame
embeddings, a causal decoder with cross attention, GELU MLPs), the head
tied to the embedding.  No kernel, cache or batching trick: every layer
is a few lines of tensor algebra on a ``{path: tensor}`` dict of
weights.

The MoE keeps the port's capacity rule, since it decides which
(token, expert) pairs count: per batch row, ``C = ceil(S·k/E · cf)``,
pairs numbered in token-major order, a pair kept while its expert has
taken fewer than C; the top k of the router's softmax, ties to the lower
expert, gates renormalised over the k; the load-balance term
``E · Σ_e mean(p_e) · mean(1[top-1 = e])`` weighted 0.01.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NORM_EPS = 1e-6
AUX_WEIGHT = 0.01
NEG_INF = -1e30


def rms_norm(x, scale):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + NORM_EPS) * scale


def layer_norm(x, scale, bias):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + NORM_EPS) * scale + bias


def norm(W, prefix: str, x, m: dict):
    if m["norm"] == "layernorm":
        return layer_norm(x, W[f"{prefix}/scale"], W[f"{prefix}/bias"])
    return rms_norm(x, W[f"{prefix}/scale"])


def rotary(x, theta: float):
    """x (B, S, H, hd): each head's halves rotated by position · θ^(-2i/hd)."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def attention(W, prefix: str, x, mem, m: dict, *, causal: bool, rope: bool):
    """Multi-head attention of ``x`` over ``mem`` (x itself for self
    attention); query head h reads key/value head h // (H / H_kv)."""
    B, S, _ = x.shape
    H, Hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = (x @ W[f"{prefix}/wq/w"]).reshape(B, S, H, hd)
    k = (mem @ W[f"{prefix}/wk/w"]).reshape(B, mem.shape[1], Hkv, hd)
    v = (mem @ W[f"{prefix}/wv/w"]).reshape(B, mem.shape[1], Hkv, hd)
    if rope:
        q, k = rotary(q, m["rope_theta"]), rotary(k, m["rope_theta"])
    k = k.repeat_interleave(H // Hkv, dim=2)
    v = v.repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if causal:
        qi = torch.arange(S, device=x.device)[:, None]
        kj = torch.arange(mem.shape[1], device=x.device)[None, :]
        allowed = kj <= qi
        if m.get("window", 0):
            allowed = allowed & (kj > qi - m["window"])
        scores = scores.masked_fill(~allowed, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.reshape(B, S, H * hd) @ W[f"{prefix}/wo/w"]


def mlp(W, prefix: str, x, m: dict):
    h = x @ W[f"{prefix}/up/w"]
    if m["gated_mlp"]:
        g = x @ W[f"{prefix}/gate/w"]
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ W[f"{prefix}/down/w"]


def moe(W, prefix: str, x, m: dict):
    """(B, S, d) → (out, aux).  Each expert runs once on every pair kept
    for it across the batch."""
    B, S, d = x.shape
    E, k = m["moe_experts"], m["moe_top_k"]
    C = max(1, math.ceil(S * k / E * m["moe_capacity_factor"]))
    probs = torch.softmax(x @ W[f"{prefix}/router"], dim=-1)  # (B, S, E)
    top, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = top[..., :k] / torch.clamp_min(top[..., :k].sum(-1, keepdim=True), 1e-9)
    experts = experts[..., :k]
    pairs = experts.reshape(B, S * k)  # token-major: token 0's choices first
    onehot = F.one_hot(pairs, E)
    position = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    kept = position < C
    token = torch.arange(B * S, device=x.device).reshape(B, S).repeat_interleave(k, dim=1)
    xf = x.reshape(B * S, d)
    out = torch.zeros_like(xf)
    for e in range(E):
        sel = kept & (pairs == e)
        tok = token[sel]
        h = xf[tok] @ W[f"{prefix}/up"][e]
        if m["gated_mlp"]:
            h = F.silu(xf[tok] @ W[f"{prefix}/gate"][e]) * h
        else:
            h = F.gelu(h, approximate="tanh")
        y = h @ W[f"{prefix}/down"][e]
        out = out.index_add(0, tok, y * gates.reshape(B, S * k)[sel][:, None])
    me = probs.mean(dim=1).mean(dim=0)
    ce = F.one_hot(experts[..., 0], E).to(torch.float32).mean(dim=1).mean(dim=0)
    return out.reshape(B, S, d), E * torch.sum(me * ce)


def _layer(W, name: str):
    """Layer ``i``'s weights of the stack ``name``: ``{suffix: tensor}``
    read through a view of the stacked leaves."""
    return {p[len(name) + 1:]: v for p, v in W.items() if p.startswith(name + "/")}


def decoder_stack(W, x, m: dict, mem=None):
    """The decoder's layers over ``x``: (hidden, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    stack = _layer(W, "stack/scan/b0")
    for i in range(m["n_layers"]):
        L = {p: v[i] for p, v in stack.items()}
        h = norm(L, "norm1", x, m)
        x = x + attention(L, "inner", h, h, m, causal=True, rope=True)
        if mem is not None:
            h = norm(L, "norm_x", x, m)
            x = x + attention(L, "cross", h, mem, m, causal=False, rope=False)
        h = norm(L, "norm2", x, m)
        if m.get("moe_experts", 0):
            y, a = moe(L, "moe", h, m)
            aux = aux + a
        else:
            y = mlp(L, "mlp", h, m)
        x = x + y
    return x, aux


def encoder(W, frames, m: dict):
    """The bidirectional encoder over frame embeddings, then its norm."""
    x = frames
    stack = _layer(W, "encoder/stack/scan/b0")
    for i in range(m["enc_layers"]):
        L = {p: v[i] for p, v in stack.items()}
        h = norm(L, "norm1", x, m)
        x = x + attention(L, "inner", h, h, m, causal=False, rope=True)
        x = x + mlp(L, "mlp", norm(L, "norm2", x, m), m)
    return norm(W, "encoder/final_norm", x, m)


def loss(W, batch: dict, m: dict):
    """Mean next-token cross entropy (+ the weighted MoE term) of a batch
    ``{tokens, labels[, enc_frames]}``."""
    mem = encoder(W, batch["enc_frames"], m) if m["family"] == "encdec" else None
    emb = W["embed/embedding"]
    x = emb[batch["tokens"]] * math.sqrt(m["d_model"])
    x, aux = decoder_stack(W, x, m, mem)
    x = norm(W, "final_norm", x, m)
    head = W.get("head/embedding", emb)
    logits = x @ head.T
    xent = torch.mean(torch.logsumexp(logits, dim=-1)
                      - torch.gather(logits, -1, batch["labels"][..., None])[..., 0])
    return xent + AUX_WEIGHT * aux
