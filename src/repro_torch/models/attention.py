"""Attention: MHA/GQA/MQA, causal / sliding-window / chunked-local /
bidirectional (counterpart of ``repro.models.attention``).

Entry points:
  * :func:`attn_train`  — full-sequence training/prefill forward
                          (optionally returning the roped K/V for a decode
                          cache), q-chunked so scores never materialize at
                          (S, S) past the reference's tile bound;
  * :func:`attn_decode` — one-token step against a cache;
  * :func:`init_cache`  — per-layer cache ``{k, v, pos}``.

GQA is computed in grouped form (no repeat of KV heads), with the
reference's einsums in f32, its ``NEG_INF`` mask and the zeroing of fully
masked rows.  ``scaled_dot_product_attention`` is not used: its masked-row
semantics and accumulation order are not the reference's.

Kinds (``cfg.layer_kinds``): ``attn`` (full causal), ``attn_window``
(``cfg.window``), ``attn_local`` (``cfg.local_window``), ``attn_chunk``
(chunked-local, ``cfg.chunk_attn``), ``attn_bidir`` (no causal mask; the
encoder's, roped) and ``cross`` (the decoder over the encoder's memory:
no mask, no RoPE on q or k).

Inside a rank-sharded decode step (:func:`~repro_torch.models.hints.
cache_cut`, ``repro_torch.launch.dist.make_dist_serve``) a cache may hold
this rank's share of the KV heads or of the slots, as ``cache_specs`` cuts
it over the "model" ranks.  Heads cut: the rank attends with its KV heads
and their query heads, and the heads' outputs are gathered before ``wo``.
Slots cut (flash-decoding): the rank attends over its slots alone and
keeps the f32 row max, the sum of the exponentials and their weighted V;
the "model" ranks' partials are merged (each rescaled to the largest max),
only the slot's owner writes the new K/V, and every rank writes the
replicated ``pos``.  The encoder memory of ``cross`` is cut the same ways,
with no write.  With no cut the step is the one-rank step.

Two of the reference's behaviours are kept as they are:

  * a rolling prefill fill scatters duplicate slots when the prompt is
    longer than the cache and relies on in-order writes; the port writes
    only each slot's last position, which is the same result without
    duplicate indices (whose winner is undefined on the card);
  * a decode step writes its slot with ``lax.dynamic_update_slice``,
    which clamps a slot past the cache to its last one (ROADMAP C): the
    port clamps the same way.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models import hints
from repro_torch.models.layers import dense, init_dense, rope

NEG_INF = -1e30


def window_for(kind: str, cfg) -> int:
    if kind == "attn_window":
        return cfg.window
    if kind == "attn_local":
        return cfg.local_window or cfg.window
    return 0


def _round128(n: int) -> int:
    return ((n + 127) // 128) * 128


def cache_len_for(kind: str, cfg, seq_len: int, margin: int = 8) -> int:
    """Decode-cache depth for a layer of this kind (a multiple of 128 for
    the full layers, as the reference's)."""
    if kind in ("attn_window", "attn_local"):
        return min(window_for(kind, cfg), _round128(seq_len + margin))
    if kind == "attn_chunk":
        return min(cfg.chunk_attn, _round128(seq_len + margin))
    return _round128(seq_len + margin)  # full / global


def init_attention(gen: torch.Generator, cfg, *, cross: bool = False) -> dict:
    """q, k, v and output projections; a ``cross`` layer's are the same
    leaves (its k and v read the encoder's memory)."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    bias = cfg.qkv_bias
    return {
        "wq": init_dense(gen, d, nq, bias=bias, dtype=cfg.dtype),
        "wk": init_dense(gen, d, nkv, bias=bias, dtype=cfg.dtype),
        "wv": init_dense(gen, d, nkv, bias=bias, dtype=cfg.dtype),
        "wo": init_dense(gen, nq, d, dtype=cfg.dtype),
    }


def _split_heads(x: torch.Tensor, n_heads: int, hd: int) -> torch.Tensor:
    return x.reshape(x.shape[:-1] + (n_heads, hd))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,Hkv,G,hd)  k: (B,Sk,Hkv,hd) → (B,Hkv,G,Sq,Sk) f32."""
    return torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32), k.to(torch.float32))


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,Hkv,G,Sq,Sk)  v: (B,Sk,Hkv,hd) → (B,Sq,Hkv,G,hd)."""
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))


def _masked_attention(q, k, v, mask, scale: float) -> torch.Tensor:
    """Grouped attention core.  mask broadcastable to (B,1,1,Sq,Sk)."""
    scores = _gqa_scores(q, k) * scale
    scores = torch.where(mask, scores, torch.full((), NEG_INF, dtype=scores.dtype,
                                                  device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    # fully masked rows (empty cache slots) give uniform probs over
    # NEG_INF: zero them so they contribute nothing
    probs = torch.where(torch.any(mask, dim=-1, keepdim=True), probs,
                        torch.zeros((), dtype=probs.dtype, device=probs.device))
    return _gqa_out(probs, v)


def _partial_attention(q, k, v, mask, scale: float) -> tuple:
    """One rank's share of :func:`_masked_attention` over its keys: the f32
    row max ``(B,Hkv,G,Sq,1)``, the sum of the exponentials (the same
    shape) and their product with V ``(B,Sq,Hkv,G,hd)``; masked keys add
    nothing."""
    scores = _gqa_scores(q, k) * scale
    scores = torch.where(mask, scores, torch.full((), NEG_INF, dtype=scores.dtype,
                                                  device=scores.device))
    mx = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - mx), torch.zeros((), dtype=scores.dtype,
                                                              device=scores.device))
    return mx, e.sum(dim=-1, keepdim=True), _gqa_out(e, v)


def _merge_partials(cut, mx: torch.Tensor, s: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """The attention over every "model" rank's keys from their
    :func:`_partial_attention` partials (one gather of the three): each
    rescaled to the largest max, added in rank order; a row no rank has a
    key for is zero, as :func:`_masked_attention` makes it."""
    n_mx, n_s = mx.numel(), s.numel()
    rows = cut.group.gather_list(torch.cat([mx.reshape(-1), s.reshape(-1), o.reshape(-1)]))
    mxs = [r[:n_mx].view(mx.shape) for r in rows]
    top = torch.stack(mxs).amax(dim=0)
    total = out = None
    for r, m in zip(rows, mxs):
        w = torch.exp(m - top)  # (B,Hkv,G,Sq,1)
        s_r = w * r[n_mx:n_mx + n_s].view(s.shape)
        o_r = w.permute(0, 3, 1, 2, 4) * r[n_mx + n_s:].view(o.shape)
        total, out = (s_r, o_r) if total is None else (total + s_r, out + o_r)
    total = total.permute(0, 3, 1, 2, 4)  # (B,Sq,Hkv,G,1)
    keyed = total > 0
    return torch.where(keyed, out / torch.where(keyed, total, torch.ones_like(total)),
                       torch.zeros((), dtype=out.dtype, device=out.device))


def attn_train(params: dict, x: torch.Tensor, cfg, kind: str, *,
               positions: Optional[torch.Tensor] = None,
               kv_x: Optional[torch.Tensor] = None, q_chunk: int = 0,
               return_cache_seq: bool = False):
    """Full-sequence attention.  x: (B, S, d); ``kv_x`` (B, Sk, d) is the
    encoder's memory of a ``cross`` layer, whose keys sit at ``arange(Sk)``
    with no mask and no RoPE.

    Returns ``(out, (k, v))`` with the K/V (roped but for ``cross``) when
    ``return_cache_seq`` (the serving engine builds a decode cache from
    them), else ``(out, None)``.  ``q_chunk`` 0 takes the reference's
    rule, ``max(128, min(1024, 2²² // Sk))``, from the keys' length; a
    sequence longer than the chunk must be a multiple of it (the
    reference's assertion).
    """
    B, S, _ = x.shape
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    scale = 1.0 / math.sqrt(hd)
    cross = kind == "cross"
    causal = kind not in ("cross", "attn_bidir")

    if positions is None:
        positions = torch.arange(S, device=x.device)

    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)
    src = kv_x if cross else x
    Sk = src.shape[1]
    if q_chunk == 0:
        # the reference's bound on the (B, H, q_chunk, Sk) f32 score tile
        q_chunk = max(128, min(1024, (1 << 22) // max(Sk, 1)))
    k = _split_heads(dense(params["wk"], src), Hkv, hd)
    v = _split_heads(dense(params["wv"], src), Hkv, hd)
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, Hkv, G, hd)
    kj = torch.arange(Sk, device=x.device) if cross else positions

    window = window_for(kind, cfg)
    chunk = cfg.chunk_attn if kind == "attn_chunk" else 0

    def mask_fn(qi: torch.Tensor, kj: torch.Tensor) -> torch.Tensor:
        """qi: (Sq,) global query positions; kj: (Sk,) key positions."""
        m = torch.ones((qi.shape[0], kj.shape[0]), dtype=torch.bool, device=qi.device)
        if causal:
            m &= kj[None, :] <= qi[:, None]
        if window:
            m &= kj[None, :] > qi[:, None] - window
        if chunk:
            m &= torch.div(kj[None, :], chunk, rounding_mode="floor") == \
                torch.div(qi[:, None], chunk, rounding_mode="floor")
        m &= kj[None, :] >= 0
        return m

    if S <= q_chunk:
        mask = mask_fn(positions, kj)
        out = _masked_attention(q, k, v, mask[None, None, None], scale)
    else:
        n_chunks = S // q_chunk
        assert S % q_chunk == 0, f"seq {S} not divisible by q_chunk {q_chunk}"
        outs = []
        for i in hints.steps(n_chunks):  # every chunk attends over all Sk keys
            qch = q[:, i * q_chunk:(i + 1) * q_chunk]
            qi = positions[0] + i * q_chunk + torch.arange(q_chunk, device=x.device)
            mask = mask_fn(qi, kj)
            outs.append(_masked_attention(qch, k, v, mask[None, None, None], scale))
        out = torch.cat(hints.every_step(outs, n_chunks), dim=1)

    out = out.reshape(B, S, cfg.n_heads * hd).to(x.dtype)
    out = dense(params["wo"], out)
    return (out, (k, v)) if return_cache_seq else (out, None)


# ------------------------------------------------------------------ decode


def init_cache(cfg, kind: str, batch: int, seq_len: int, dtype, device=None) -> dict:
    L = cache_len_for(kind, cfg, seq_len)
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    return {
        "k": torch.zeros((batch, L, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def cache_slot(kind: str, cfg, pos):
    """The cache slot of position ``pos`` (a host int or a tensor)."""
    window = window_for(kind, cfg)
    if window:
        return pos % window
    if kind == "attn_chunk":
        return pos % cfg.chunk_attn
    return pos


def fill_cache_from_prefill(cache: dict, kind: str, cfg, k: torch.Tensor,
                            v: torch.Tensor) -> dict:
    """Scatter prefill K/V (already roped) into the rolling decode cache.

    The reference scatters every position in order, so each slot keeps
    the last position that maps to it.  Only the last ``L`` positions can
    be those (``L`` the cache depth: a window's slots are ``pos % window``
    and ``L`` is the window once the prompt is longer), so the port writes
    just them, with no duplicate slot."""
    S, L = k.shape[1], cache["k"].shape[1]
    first = max(0, S - L)
    pos = torch.arange(first, S, device=k.device)
    slots = cache_slot(kind, cfg, pos)
    new_k, new_v, new_pos = cache["k"].clone(), cache["v"].clone(), cache["pos"].clone()
    new_k[:, slots] = k[:, pos].to(new_k.dtype)
    new_v[:, slots] = v[:, pos].to(new_v.dtype)
    new_pos[slots] = pos.to(torch.int32)
    return {"k": new_k, "v": new_v, "pos": new_pos}


def attn_decode(params: dict, x: torch.Tensor, cfg, kind: str, cache: Optional[dict],
                pos: int, *, cross_memory: Optional[tuple] = None):
    """One-token attention.  x: (B, 1, d); ``pos`` the current position (a
    host int).  Returns ``(out (B,1,d), new_cache)``; the cache passed in
    is left as it is.  A slot past the cache is clamped to its last one,
    as ``lax.dynamic_update_slice`` does.  For ``kind == "cross"``,
    ``cross_memory`` is the ``(k, v)`` of the encoder's output, every slot
    of it is attended and ``cache`` is returned as it came in.  A cache
    cut over the "model" ranks (:func:`~repro_torch.models.hints.cache_cut`)
    is attended as the module's docstring says."""
    B = x.shape[0]
    hd, Hkv = cfg.head_dim, cfg.n_kv_heads
    G = cfg.n_heads // Hkv
    scale = 1.0 / math.sqrt(hd)
    cut = hints.cache_cut()
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, hd)

    if kind == "cross":
        k, v = cross_memory
        q = q.reshape(B, 1, Hkv, G, hd)
        heads = k.shape[2] < Hkv  # this rank's KV heads
        if heads:
            q = cut.part(q, 2)
        mask = torch.ones((1, k.shape[1]), dtype=torch.bool, device=x.device)[None, None, None]
        if cut is not None and cut.cross_seq and not heads:  # this rank's memory slots
            out = _merge_partials(cut, *_partial_attention(q, k, v, mask, scale))
        else:
            out = _masked_attention(q, k, v, mask, scale)
        if heads:
            out = cut.gather(out, 2)
        out = dense(params["wo"], out.reshape(B, 1, cfg.n_heads * hd).to(x.dtype))
        return out, cache

    pos = int(pos)
    p_t = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = rope(q, p_t, cfg.rope_theta).reshape(B, 1, Hkv, G, hd)
    k_new = rope(_split_heads(dense(params["wk"], x), Hkv, hd), p_t, cfg.rope_theta)
    v_new = _split_heads(dense(params["wv"], x), Hkv, hd)
    heads = cache["k"].shape[2] < Hkv  # this rank's KV heads
    if heads:
        q, k_new, v_new = cut.part(q, 2), cut.part(k_new, 2), cut.part(v_new, 2)

    L, L_own = cache["pos"].shape[0], cache["k"].shape[1]
    first = cut.rank * L_own if L_own < L else 0  # this rank's slots: first + [0, L_own)
    slot = min(max(cache_slot(kind, cfg, pos), 0), L - 1)
    new_cache = {"k": cache["k"].clone(), "v": cache["v"].clone(), "pos": cache["pos"].clone()}
    if first <= slot < first + L_own:  # the slot's owner writes it
        at = slot - first
        new_cache["k"][:, at:at + 1] = k_new.to(new_cache["k"].dtype)
        new_cache["v"][:, at:at + 1] = v_new.to(new_cache["v"].dtype)
    new_cache["pos"][slot] = pos

    cpos = new_cache["pos"]
    valid = (cpos >= 0) & (cpos <= pos)
    window = window_for(kind, cfg)
    if window:
        valid &= cpos > pos - window
    if kind == "attn_chunk":
        valid &= cpos >= (pos // cfg.chunk_attn) * cfg.chunk_attn

    mask = valid[first:first + L_own][None, None, None, None, :]
    if L_own < L:
        out = _merge_partials(cut, *_partial_attention(q, new_cache["k"], new_cache["v"], mask,
                                                       scale))
    else:
        out = _masked_attention(q, new_cache["k"], new_cache["v"], mask, scale)
    if heads:
        out = cut.gather(out, 2)
    out = dense(params["wo"], out.reshape(B, 1, cfg.n_heads * hd).to(x.dtype))
    return out, new_cache
