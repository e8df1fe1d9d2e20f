"""Mixture-of-Experts MLP (counterpart of ``repro.models.moe``): a top-k
router and capacity-based gather dispatch.

  1. router logits → the top-k experts of each token, gates renormalised;
  2. each (token, choice) pair's position in its expert is the running
     count of the one-hot over the pairs in token-major order; pairs past
     the expert's capacity ``C = max(1, ceil(S·k/E · capacity_factor))``
     are DROPPED (no gate: the residual stream passes through);
  3. an ``(E, C)`` token-index buffer gathers the tokens into ``(E, C, d)``,
     the experts run as one batched product against weights stacked on a
     leading E axis, and the results scatter-add back weighted by gates.

``"grouped"`` routes, ranks, gathers and combines per batch row (``C``
from the row's S); ``"flat"`` and ``"flat_ep"`` route all ``T = B·S``
tokens at once (``C`` from T).  Decode passes ``full_capacity=True``:
``C = S`` (or T), nothing dropped.  In a rank-sharded step a rank holds
its "data" share of the pod's rows, and flat dispatch routes the pod's
whole batch as the reference does: ``C`` from the pod's T, and each
expert's positions on this rank start after the pairs the lower "data"
ranks send it (:func:`repro_torch.models.hints.data_before`), so a rank
keeps and drops the pairs the pod's buffer would.

The combine runs in f32 at the config's (or the caller's) capacity
factor, unless :func:`repro_torch.models.hints.lean_moe` is on (the GSPMD
backend's launch option ``"lean_moe"``, installed around its step by
``build_dist_train(..., opts={"lean_moe"})``): then it runs in the
activations' dtype and the capacity factor is at most 1.0, where the
reference reads the same hint.  The reference's layout hints
(``expert_grouped``, ``expert_flat``, ``act``) are identities in the port.

Ties: ``lax.top_k`` breaks them by the lower index, which a stable
descending sort reproduces (``torch.topk`` promises no order).  Dropped
pairs write one slot past the buffer, which is cut, so no index leaves
its tensor.  The combine adds at most k ≤ 2 gated rows into a zero (f32,
or bf16 under ``lean_moe``) for every real token, which rounds the same
in any order, so ``index_add_``
gives the reference's bits (the many adds into the discarded pad row
aside).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import hints
from repro_torch.models.layers import _randn, gen_device


def _stacked_normal(gen: torch.Generator, shape: tuple, scale: float, dtype) -> torch.Tensor:
    """``(normal(shape) · scale)`` cast to ``dtype``, drawn one expert (the
    leading index) at a time into a preallocated tensor: the f32 draw of
    one expert is the only temporary, not the whole stack's."""
    out = torch.empty(shape, dtype=dtype, device=gen_device(gen))
    for e in range(shape[0]):
        out[e] = (_randn(gen, shape[1:]) * scale).to(dtype)
    return out


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    s = 1.0 / math.sqrt(d)
    p = {
        "router": _randn(gen, (d, E)) * s,
        "up": _stacked_normal(gen, (E, d, ff), s, cfg.dtype),
        "down": _stacked_normal(gen, (E, ff, d), 1.0 / math.sqrt(ff), cfg.dtype),
    }
    if cfg.gated_mlp:
        p["gate"] = _stacked_normal(gen, (E, d, ff), s, cfg.dtype)
    return p


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(xt: torch.Tensor, router: torch.Tensor, k: int):
    """(…, d) tokens → (probs, renormalised gates, expert ids), each (…, ·)."""
    logits = xt.to(torch.float32) @ router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = _top_k(probs, k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gates, experts


def _positions(flat_e: torch.Tensor, E: int) -> torch.Tensor:
    """Each (token, choice) pair's position in its expert: the running
    count of the one-hot over the pairs, (G, n) in token-major order."""
    one_hot = F.one_hot(flat_e, E).to(torch.int32)
    return ((torch.cumsum(one_hot, dim=1) - 1) * one_hot).sum(dim=-1)


def _dispatch(experts: torch.Tensor, gates: torch.Tensor, E: int, C: int, n_tok: int,
              acc_dtype=torch.float32, before: Optional[torch.Tensor] = None):
    """Per group (leading axis G) of ``n_tok`` tokens with k choices each:
    ``(buf (G, E·C) token ids, n_tok for an empty slot; gate_buf (G, E·C)
    in acc_dtype)``.  A pair's address is ``expert·C + position``; a dropped pair's
    is ``E·C``, the slot past the end, which is cut.  ``before`` (E,): the
    pairs each expert took ahead of this group's (on lower "data" ranks), so
    a pair is kept while ``before + position < C``."""
    G = experts.shape[0]
    k = experts.shape[-1]
    dev = experts.device
    flat_e = experts.reshape(G, -1)  # token-major: token 0's k choices, then token 1's
    flat_g = gates.reshape(G, -1)
    flat_tok = torch.arange(n_tok, device=dev).repeat_interleave(k).expand(G, -1)
    pos = _positions(flat_e, E)
    keep = pos < C if before is None else pos + before[flat_e] < C
    addr = torch.where(keep, flat_e * C + pos, torch.full_like(pos, E * C))
    buf = torch.full((G, E * C + 1), n_tok, dtype=torch.int64, device=dev)
    buf.scatter_(1, addr, flat_tok)
    gate_buf = torch.zeros((G, E * C + 1), dtype=acc_dtype, device=dev)
    gate_buf.scatter_(1, addr, torch.where(keep, flat_g, torch.zeros_like(flat_g)).to(acc_dtype))
    return buf[:, :E * C], gate_buf[:, :E * C]


def _experts(params: dict, gathered: torch.Tensor, lead: str) -> torch.Tensor:
    """The stacked experts on ``gathered`` (``lead + "ecd"``): gated SiLU
    (the f32 SiLU rounded to the activations' dtype, then the product) or
    GELU's tanh form, then ``down``."""
    h = torch.einsum(f"{lead}ecd,edf->{lead}ecf", gathered, params["up"])
    if "gate" in params:
        g = torch.einsum(f"{lead}ecd,edf->{lead}ecf", gathered, params["gate"]).to(torch.float32)
        h = (g * torch.sigmoid(g)).to(h.dtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(h.dtype)
    return torch.einsum(f"{lead}ecf,efd->{lead}ecd", h, params["down"])


def _combine(expert_out: torch.Tensor, buf: torch.Tensor, gate_buf: torch.Tensor,
             n_tok: int) -> torch.Tensor:
    """Scatter-add each group's gated expert rows back to its tokens, in
    ``gate_buf``'s dtype: ``(G, E·C, d)`` → ``(G, n_tok, d)`` (row
    ``n_tok`` of each group, the empty slots' pad row, is cut)."""
    G, EC, d = expert_out.shape
    acc_dtype = gate_buf.dtype
    contrib = expert_out.to(acc_dtype) * gate_buf[..., None]
    index = (buf + torch.arange(G, device=buf.device)[:, None] * (n_tok + 1)).reshape(-1)
    out = torch.zeros((G * (n_tok + 1), d), dtype=acc_dtype, device=buf.device)
    out.index_add_(0, index, contrib.reshape(-1, d))
    return out.reshape(G, n_tok + 1, d)[:, :n_tok]


def _gather(x: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """``concat([x, 0])[buf]`` per group: (G, n, d), (G, E·C) → (G, E·C, d)."""
    xpad = torch.cat([x, torch.zeros_like(x[:, :1])], dim=1)
    return xpad[torch.arange(x.shape[0], device=x.device)[:, None], buf]


def _capacity(n_tok: int, k: int, E: int, capacity_factor: float, full_capacity: bool) -> int:
    if full_capacity:
        return n_tok
    if hints.lean_moe():
        capacity_factor = min(capacity_factor, 1.0)
    return max(1, int(math.ceil(n_tok * k / E * capacity_factor)))


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The combine's dtype: the activations' under ``lean_moe``, else f32."""
    return x.dtype if hints.lean_moe() else torch.float32


def moe_apply(params: dict, x: torch.Tensor, cfg, *, capacity_factor: float = 0.0,
              full_capacity: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out (B, S, d), aux load-balance loss, f32 scalar).

    ``cfg.moe_dispatch`` ``"grouped"`` routes per batch row; ``"flat"``
    and ``"flat_ep"`` (whose expert-parallel hint is an identity here)
    route every token at once.  ``full_capacity=True`` drops nothing."""
    mode = getattr(cfg, "moe_dispatch", "grouped")
    if mode == "grouped":
        return _moe_grouped(params, x, cfg, capacity_factor, full_capacity)
    return _moe_flat(params, x, cfg, capacity_factor, full_capacity)


def _moe_grouped(params, x, cfg, capacity_factor, full_capacity):
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    C = _capacity(S, k, E, capacity_factor or cfg.moe_capacity_factor, full_capacity)
    probs, gates, experts = _route(x, params["router"], k)  # (B, S, ·)
    buf, gate_buf = _dispatch(experts, gates, E, C, S, _acc_dtype(x))
    gathered = _gather(x, buf).reshape(B, E, C, d)
    # the aux terms (Switch/Mixtral form): per row, then averaged over rows
    me = probs.mean(dim=1)
    ce = F.one_hot(experts[..., 0], E).to(torch.float32).mean(dim=1)
    # over the pod's rows: a rank-sharded step averages over its "data" ranks
    aux = E * torch.sum(hints.data_mean(me.mean(dim=0)) * hints.data_mean(ce.mean(dim=0)))
    expert_out = _experts(params, gathered, "b").reshape(B, E * C, d)
    out = _combine(expert_out, buf, gate_buf, S)
    return out.to(x.dtype), aux


def _moe_flat(params, x, cfg, capacity_factor, full_capacity):
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(1, T, d)
    n_data = hints.data_ranks()  # the pod's batch: this rank's rows n_data times
    C = _capacity(T * n_data, k, E, capacity_factor or cfg.moe_capacity_factor, full_capacity)
    probs, gates, experts = _route(xt, params["router"], k)  # (1, T, ·)
    me = hints.data_mean(probs[0].mean(dim=0))
    ce = hints.data_mean(F.one_hot(experts[0, :, 0], E).to(torch.float32).mean(dim=0))
    aux = E * torch.sum(me * ce)
    before = None
    if n_data > 1:  # the lower "data" ranks' tokens come first in the pod's order
        ids = experts.reshape(-1)  # the count of each expert: bincount's, with a meta kernel
        counts = torch.zeros(E, dtype=torch.int64, device=ids.device).index_add_(
            0, ids, torch.ones_like(ids, dtype=torch.int64))
        before = hints.data_before(counts)
    buf, gate_buf = _dispatch(experts, gates, E, C, T, _acc_dtype(x), before)
    gathered = _gather(xt, buf)[0].reshape(E, C, d)
    expert_out = _experts(params, gathered, "").reshape(1, E * C, d)
    out = _combine(expert_out, buf, gate_buf, T)
    return out.reshape(B, S, d).to(x.dtype), aux


def dropped_share(params: dict, x: torch.Tensor, cfg, *, capacity_factor: float = 0.0) -> float:
    """The share of (token, expert) pairs that :func:`moe_apply` drops on
    ``x`` at ``capacity_factor`` (default: the config's; at most 1.0 under
    ``lean_moe``)."""
    B, S, d = x.shape
    E, k = cfg.moe_experts, cfg.moe_top_k
    grouped = getattr(cfg, "moe_dispatch", "grouped") == "grouped"
    xt = x if grouped else x.reshape(1, B * S, d)
    n_tok = xt.shape[1]
    C = _capacity(n_tok, k, E, capacity_factor or cfg.moe_capacity_factor, False)
    _, _, experts = _route(xt, params["router"], k)
    pos = _positions(experts.reshape(xt.shape[0], -1), E)
    return float((pos >= C).to(torch.float32).mean())
