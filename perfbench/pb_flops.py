"""The work of a round, counted from the configuration's widths alone, so
the yardstick does not move with the implementation.

Model FLOPs (for ``mfu``): 6 × the matmul parameters a token touches ×
tokens (2 for the forward, 4 for the backward), plus attention's
12 · T · d a layer and query token, T the keys it reads.  A decoder
token touches its layer's attention projections, the top-k experts'
(or the MLP's) weights, the router and the head; an encoder frame its
layer's attention and MLP, and, in every decoder layer, the cross
attention's key and value projections.  Recomputation, capacity padding
and dropped pairs are not counted.

Exchange bytes (for the kernels' roofline): 16 bytes an entry — ΔW and
the residual read once, the new residual and the mean written once, in
f32 — times the client's entries.

Peaks: one H100 SXM's data sheet, f32 outside the tensor cores (the port
turns TF32 off) and HBM3.
"""
from __future__ import annotations

import math

F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
EXCHANGE_BYTES_PER_ENTRY = 16


def _attn_params(m: dict) -> tuple:
    """(q and o projections, k and v projections) of one attention."""
    d, hd = m["d_model"], m["head_dim"]
    return 2 * d * m["n_heads"] * hd, 2 * d * m["n_kv_heads"] * hd


def _ffn_params(m: dict) -> int:
    mats = 3 if m["gated_mlp"] else 2
    per = mats * m["d_model"] * m["d_ff"]
    if m.get("moe_experts", 0):
        return m["moe_top_k"] * per + m["d_model"] * m["moe_experts"]
    return per


def round_flops(m: dict, traffic: dict) -> float:
    """Model FLOPs of one round of ``traffic`` on the model ``m``."""
    B, S = traffic["batch"], traffic["seq_len"]
    qo, kv = _attn_params(m)
    d, L = m["d_model"], m["n_layers"]
    dec_tokens = B * S
    per_dec = L * (qo + kv + _ffn_params(m)) + m["vocab_size"] * d
    attn = L * 12 * S * d * dec_tokens
    total = 6 * per_dec * dec_tokens
    frames = traffic.get("frames")
    if m["family"] == "encdec":
        T = frames["len"]
        enc_tokens = B * T
        enc = dict(m, moe_experts=0)
        per_enc = m["enc_layers"] * (qo + kv + _ffn_params(enc)) + L * kv
        total += 6 * per_enc * enc_tokens + 6 * L * qo * dec_tokens
        attn += m["enc_layers"] * 12 * T * d * enc_tokens + L * 12 * T * d * dec_tokens
    return float(total + attn)


def entries(specs: list) -> int:
    """The client's entries: every leaf of the tree."""
    return sum(math.prod(s[1]) for s in specs)


def exchange_bound_s(n_entries: int) -> float:
    """The exchange's least time on one H100: its bytes over HBM's rate."""
    return EXCHANGE_BYTES_PER_ENTRY * n_entries / HBM_BYTES_PER_S
