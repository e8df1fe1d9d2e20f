"""Decoder and encoder-decoder assembly (counterpart of
``repro.models.transformer``) for every architecture of the zoo: tiny,
fed-tiny, lm-100m, gemma3, qwen1.5, granite, command-r, mixtral, llama4,
jamba, rwkv6, phi-3-vision and seamless-m4t.

The parameter tree is the reference's, leaf for leaf::

    {"embed": {"embedding"}, "encoder"?: {"stack", "final_norm"},
     "stack": {"scan": {"b0", …}, "rem": {…}}, "final_norm": {…},
     "head"?: {"embedding"}}

(the keys sorted, as JAX flattens them: ``encoder`` between ``embed`` and
``final_norm``).

One superblock is the smallest repeating layer pattern (jamba: 7 Mamba
+ 1 attention with MoE every second layer, period 8; gemma3: 5 local + 1
global, period 6; homogeneous stacks: period 1).  The scanned
superblocks are stacked on a leading axis of every leaf under
``stack/scan``; the remainder layers (26 = 4·6 + 2 for gemma3) sit
unstacked under ``stack/rem``.  SBC's segments, its k a leaf, the SBW1
bytes and ``params_from_jax`` all depend on that layout.  The reference's
``lax.scan`` over superblocks is a loop over the leading index here; its
``jax.checkpoint`` changes no number, and runs (``torch.utils.checkpoint``)
only in a rank-sharded step, where it keeps one superblock's gathered
weights at a time (:func:`~repro_torch.models.hints.params`).

Block kinds come from ``cfg.layer_kinds``: the attention kinds (an
attention block and its MLP or MoE), ``mamba`` (a Mamba mixer, with an
MLP or MoE after it where ``cfg.ssm_ffn``, as jamba) and ``rwkv6`` (a
time-mix and channel-mix pair).  ``cfg.layer_moe`` says which layers'
FFN is an MoE; the load-balance ``aux`` of every layer is summed from an
f32 zero in layer order.

Three modes share the block code: train (full sequence, no caches),
prefill (full sequence, returns caches), decode (one token, carries
caches).

The encoder-decoder (``family="encdec"``, seamless-m4t) adds an encoder
of ``enc_layers`` bidirectional, roped attention blocks, and each decoder
block a ``cross`` attention over the encoder's output (``norm_x`` and
``cross`` between the self-attention and the FFN).  Its input is frames
(float ``(B, S_enc, d)``, the audio frontend's stub: cast to the model's
dtype, no embedding, no √d) or tokens (int, embedded as the decoder's).
The modality prefix (phi-3-vision's 576 patch embeddings) replaces the
first ``n_prefix`` token embeddings; the sequence keeps its length and
the loss covers every position.  Decode steps carry no prefix.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import tree_flatten, tree_map
from repro_torch.models import attention as attn
from repro_torch.models import hints
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm
from repro_torch.models.layers import (embed_lookup, gen_device, init_embed, init_mlp,
                                       init_norm, mlp_apply, norm_apply, scale_by)

PyTree = Any


# ------------------------------------------------------------------ blocks


def init_block(gen: torch.Generator, cfg, kind: str, use_moe: bool, *,
               cross: bool = False) -> dict:
    """One block of ``kind``, its FFN an MoE where ``use_moe``; an
    attention block with ``cross`` also attends over the encoder's memory
    (``norm_x``, ``cross``)."""
    dev = gen_device(gen)
    p: dict = {"norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev)}

    def ffn() -> None:
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev)
        if use_moe:
            p["moe"] = moe_lib.init_moe(gen, cfg)
        else:
            p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp,
                                dtype=cfg.dtype)

    if kind == "mamba":
        p["inner"] = ssm.init_mamba(gen, cfg)
        if cfg.ssm_ffn:  # jamba: a Mamba mixer + an FFN or MoE (arXiv:2403.19887)
            ffn()
        return p
    if kind == "rwkv6":
        p["inner"] = ssm.init_rwkv6(gen, cfg)
        p["norm2"] = init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev)
        return p  # the channel-mix lives inside the rwkv params
    p["inner"] = attn.init_attention(gen, cfg)
    if cross:
        p["norm_x"] = init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev)
        p["cross"] = attn.init_attention(gen, cfg, cross=True)
    ffn()
    return p


def _ffn(params, x, cfg, use_moe, full_capacity=False):
    """The block's FFN on the residual ``x``: ``(x + ffn(norm2(x)), aux)``."""
    h2 = norm_apply(params["norm2"], x, cfg.norm)
    if use_moe:
        y2, aux = moe_lib.moe_apply(params["moe"], h2, cfg, full_capacity=full_capacity)
    else:
        y2, aux = mlp_apply(params["mlp"], h2), _zero(x)
    return x + y2, aux


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _block_train(params, x, cfg, kind, use_moe, positions, want_cache=False, q_chunk=0,
                 enc_out=None):
    """Returns (x, aux, cache_or_None); a block with ``cross`` attends over
    ``enc_out`` and its cache carries that memory's ``cross_k``/``cross_v``."""
    aux = _zero(x)
    cache = None
    h = norm_apply(params["norm1"], x, cfg.norm)
    if kind == "mamba":
        y, h_final, conv_tail = ssm.mamba_train(params["inner"], h, cfg)
        x = x + y
        if "norm2" in params:  # jamba's FFN or MoE
            x, aux = _ffn(params, x, cfg, use_moe)
        if want_cache:  # decode carries on from the exact state and conv window
            cache = {"h": h_final, "conv": conv_tail}
        return x, aux, cache
    if kind == "rwkv6":
        st = ssm.rwkv6_init_state(cfg, x.shape[0], x.device)
        y, s_final, tm_prev = ssm.rwkv6_time_mix(params["inner"], h, cfg, st["s"],
                                                 st["tm_prev"])
        x = x + y
        h2 = norm_apply(params["norm2"], x, cfg.norm)
        y2, cm_prev = ssm.rwkv6_channel_mix(params["inner"], h2, cfg, st["cm_prev"])
        x = x + y2
        if want_cache:
            cache = {"s": s_final, "tm_prev": tm_prev, "cm_prev": cm_prev}
        return x, aux, cache
    y, kv = attn.attn_train(params["inner"], h, cfg, kind, positions=positions,
                            q_chunk=q_chunk, return_cache_seq=want_cache)
    x = x + y
    if "cross" in params:
        hx = norm_apply(params["norm_x"], x, cfg.norm)
        yx, cross_kv = attn.attn_train(params["cross"], hx, cfg, "cross", kv_x=enc_out,
                                       q_chunk=q_chunk, return_cache_seq=want_cache)
        x = x + yx
    x, aux = _ffn(params, x, cfg, use_moe)
    if want_cache:
        c = attn.init_cache(cfg, kind, x.shape[0], x.shape[1], cfg.dtype, x.device)
        cache = attn.fill_cache_from_prefill(c, kind, cfg, kv[0], kv[1])
        if "cross" in params:
            cache["cross_k"], cache["cross_v"] = cross_kv
    return x, aux, cache


def _block_decode(params, x, cfg, kind, use_moe, cache, pos):
    """One-token step.  Returns (x, new_cache).  An MoE runs at full
    capacity (nothing dropped), as the reference's decode does."""
    h = norm_apply(params["norm1"], x, cfg.norm)
    if kind == "mamba":
        y, new_cache = ssm.mamba_decode(params["inner"], h, cfg, cache)
        x = x + y
        if "norm2" in params:
            x, _ = _ffn(params, x, cfg, use_moe, full_capacity=True)
        return x, new_cache
    if kind == "rwkv6":
        y, s_final, tm_prev = ssm.rwkv6_time_mix(params["inner"], h, cfg, cache["s"],
                                                 cache["tm_prev"])
        x = x + y
        h2 = norm_apply(params["norm2"], x, cfg.norm)
        y2, cm_prev = ssm.rwkv6_channel_mix(params["inner"], h2, cfg, cache["cm_prev"])
        return x + y2, {"s": s_final, "tm_prev": tm_prev, "cm_prev": cm_prev}
    y, new_cache = attn.attn_decode(params["inner"], h, cfg, kind, cache, pos)
    x = x + y
    if "cross" in params:
        hx = norm_apply(params["norm_x"], x, cfg.norm)
        yx, _ = attn.attn_decode(params["cross"], hx, cfg, "cross", None, pos,
                                 cross_memory=(cache["cross_k"], cache["cross_v"]))
        x = x + yx
        new_cache["cross_k"], new_cache["cross_v"] = cache["cross_k"], cache["cross_v"]
    x, _ = _ffn(params, x, cfg, use_moe, full_capacity=True)
    return x, new_cache


# ------------------------------------------------------- stack organization


def stack_pattern(cfg) -> tuple[int, int, int]:
    """(period, n_scan_superblocks, n_remainder_layers)."""
    def lcm(a, b):
        return a * b // math.gcd(a, b)

    period = 1
    if cfg.ssm_kind and cfg.attn_every > 1:
        period = lcm(period, cfg.attn_every)
    if cfg.local_global_ratio:
        period = lcm(period, cfg.local_global_ratio + 1)
    if cfg.global_every:
        period = lcm(period, cfg.global_every)
    if cfg.moe_experts:
        period = lcm(period, cfg.moe_every)
    if not cfg.scan_layers:
        return cfg.n_layers, 1 if cfg.n_layers else 0, cfg.n_layers % max(cfg.n_layers, 1)
    n_scan = cfg.n_layers // period
    rem = cfg.n_layers - n_scan * period
    return period, n_scan, rem


def _stack_trees(trees: list) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def layer_desc(cfg, i: int) -> tuple[str, bool]:
    return cfg.layer_kinds[i], cfg.layer_moe[i]


def init_stack(gen: torch.Generator, cfg, *, cross: bool = False, at: str = "stack") -> dict:
    """Stacked superblock params (+ remainder):
    ``{'scan': {bj: stacked over superblocks}, 'rem': {bj: params}}``,
    every attention block with ``cross`` attention where ``cross``; ``at``
    is the stack's path in the params' tree.

    Each superblock is drawn and copied into its slot of the preallocated
    stacked leaves before the next is drawn, so the peak is the model and
    one superblock, not two copies of the stack (one superblock, as
    jamba's 8 layers, is only given its leading axis).  Each superblock and
    remainder block passes :func:`hints.drawn` as it is drawn (a
    rank-sharded init keeps its blocks of them alone)."""
    period, n_scan, rem = stack_pattern(cfg)
    out: dict = {}
    if n_scan:
        def superblock(sb: int) -> dict:
            return hints.drawn({f"b{j}": init_block(gen, cfg, *layer_desc(cfg, sb * period + j),
                                                    cross=cross)
                                for j in range(period)}, f"{at}/scan", scanned=True)

        first = superblock(0)
        if n_scan == 1:
            out["scan"] = tree_map(lambda v: v[None], first)
        else:
            stacked = tree_map(lambda v: v.new_empty((n_scan,) + tuple(v.shape)), first)
            for sb in range(n_scan):
                block = first if sb == 0 else superblock(sb)
                for dst, src in zip(tree_flatten(stacked)[0], tree_flatten(block)[0]):
                    dst[sb].copy_(src)
                del block
                first = None
            out["scan"] = stacked
    if rem:
        out["rem"] = {f"b{j}": hints.drawn(
            init_block(gen, cfg, *layer_desc(cfg, n_scan * period + j), cross=cross),
            f"{at}/rem/b{j}") for j in range(rem)}
    return out


def _index(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda v: v[i], tree)


def _run_blocks(params_of, descs, x, aux_total, cfg, positions, want_cache, q_chunk,
                enc_out):
    """The blocks ``descs`` (``(name, kind, use_moe)`` each) in order on
    ``x``, their params ``params_of()``; returns (x, aux_total, caches),
    each block's aux added to ``aux_total`` in order."""
    p = params_of()
    caches = {}
    for name, kind, use_moe in descs:
        x, a, caches[name] = _block_train(p[name], x, cfg, kind, use_moe, positions,
                                          want_cache, q_chunk, enc_out)
        aux_total = aux_total + a
    return x, aux_total, caches


def _apply_stack_train(stack, x, cfg, positions, want_cache=False, q_chunk=0, enc_out=None):
    """Run all layers (a decoder's ``cross`` blocks over ``enc_out``).
    Returns (x, aux_total, caches); ``aux_total`` sums every layer's aux
    from an f32 zero in layer order, as the reference's scan carry does.

    Each superblock and each remainder block takes its params through
    :func:`~repro_torch.models.hints.params`; where
    :func:`~repro_torch.models.hints.remat` holds (a rank-sharded step),
    each runs under ``torch.utils.checkpoint``, so its gathered weights
    are dropped after its forward and gathered again in the backward."""
    period, n_scan, rem = stack_pattern(cfg)
    aux_total = _zero(x)
    caches: dict = {}
    units = []
    if n_scan:
        descs = [(f"b{j}", *layer_desc(cfg, j)) for j in range(period)]  # period-invariant
        units += [(lambda sb=sb: hints.params(stack["scan"], sb), descs) for sb in range(n_scan)]
    for j in range(rem):
        name = f"b{j}"
        units.append((lambda name=name: hints.params({name: stack["rem"][name]}),
                      [(name, *layer_desc(cfg, n_scan * period + j))]))
    per_unit = []
    for params_of, descs in units:
        fn = functools.partial(_run_blocks, params_of, descs, cfg=cfg, positions=positions,
                               want_cache=want_cache, q_chunk=q_chunk, enc_out=enc_out)
        if hints.remat():
            x, aux_total, cs = checkpoint(fn, x, aux_total, use_reentrant=False)
        else:
            x, aux_total, cs = fn(x, aux_total)
        per_unit.append(cs)
    if want_cache:
        if n_scan:
            caches["scan"] = _stack_trees(per_unit[:n_scan])
        if rem:
            caches["rem"] = {k: v for cs in per_unit[n_scan:] for k, v in cs.items()}
    return x, aux_total, caches


def _apply_stack_decode(stack, x, cfg, caches, pos):
    """One token through every layer; each superblock and remainder block
    takes its params through :func:`~repro_torch.models.hints.params`."""
    period, n_scan, rem = stack_pattern(cfg)
    new_caches: dict = {}
    if n_scan:
        per_sb = []
        for sb in range(n_scan):
            sb_params = hints.params(stack["scan"], sb)
            sb_caches = _index(caches["scan"], sb)
            new_cs = {}
            for j in range(period):
                kind, use_moe = layer_desc(cfg, j)
                x, new_cs[f"b{j}"] = _block_decode(sb_params[f"b{j}"], x, cfg, kind, use_moe,
                                                   sb_caches[f"b{j}"], pos)
            per_sb.append(new_cs)
        new_caches["scan"] = _stack_trees(per_sb)
    if rem:
        new_caches["rem"] = {}
        for j in range(rem):
            kind, use_moe = layer_desc(cfg, n_scan * period + j)
            x, new_caches["rem"][f"b{j}"] = _block_decode(
                hints.params(stack["rem"][f"b{j}"]), x, cfg, kind, use_moe,
                caches["rem"][f"b{j}"], pos)
    return x, new_caches


# ------------------------------------------------------------ full models


def init_decoder_lm(gen: torch.Generator, cfg) -> dict:
    """The model's parameters drawn from ``gen`` on its device (a CUDA
    generator draws on the card), each leaf in ``cfg.dtype``.  The
    reference draws an encoder-decoder's stack twice and keeps the one with
    cross attention; the port draws it once (the tree is the same)."""
    encdec = cfg.family == "encdec"
    dev = gen_device(gen)
    p = {
        "embed": hints.drawn(init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype), "embed"),
        "stack": init_stack(gen, cfg, cross=encdec),
        "final_norm": hints.drawn(init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev),
                                  "final_norm"),
    }
    if not cfg.tie_embeddings:
        p["head"] = hints.drawn(init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype), "head")
    if encdec:
        # the reference's init-time encoder config leaves family,
        # bidirectional and local_window as they are; its tree is
        # _enc_cfg's (period 1, attention blocks with an MLP)
        p["encoder"] = {"stack": init_stack(gen, _enc_cfg(cfg), at="encoder/stack"),
                        "final_norm": hints.drawn(init_norm(cfg.d_model, cfg.norm, cfg.dtype,
                                                            dev), "encoder/final_norm")}
    return p


def _embed_inputs(params, tokens, cfg, prefix=None):
    # √d is rounded to the embedding's dtype first, as JAX's weak type does
    x = scale_by(embed_lookup(hints.params(params["embed"]), tokens), math.sqrt(cfg.d_model))
    x = x.to(cfg.dtype)
    if prefix is not None:
        # the modality stub: precomputed patch embeddings take the first
        # n_prefix positions (early fusion)
        npre = prefix.shape[-2]
        if tokens.shape[-1] < npre:
            raise ValueError(f"a prompt of {tokens.shape[-1]} tokens is shorter than its "
                             f"{npre}-position prefix")
        x = torch.cat([prefix.to(cfg.dtype), x[..., npre:, :]], dim=-2)
    return x


def _enc_cfg(cfg):
    """The encoder's config: ``enc_layers`` bidirectional attention blocks."""
    return dataclasses.replace(
        cfg, n_layers=cfg.enc_layers, ssm_kind="", moe_experts=0, family="decoder",
        local_window=0, local_global_ratio=0, global_every=0, window=0,
        bidirectional=True, attn_every=1)


def _encode(params, enc_inp, cfg):
    """Encoder forward.  ``enc_inp`` is int token ids (B, S) or, for the
    audio stub, precomputed frame embeddings (B, S, d) taken as they are
    (cast to ``cfg.dtype``: no embedding, no √d)."""
    if enc_inp.is_floating_point():
        x = enc_inp.to(cfg.dtype)
    else:
        x = _embed_inputs(params, enc_inp, cfg)
    positions = torch.arange(x.shape[-2], dtype=torch.int32, device=x.device)
    x, _, _ = _apply_stack_train(params["encoder"]["stack"], x, _enc_cfg(cfg), positions)
    return norm_apply(hints.params(params["encoder"]["final_norm"]), x, cfg.norm)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[-1], dtype=torch.int32, device=tokens.device)


def _memory(params, cfg, enc_tokens, enc_frames):
    """The encoder's output for an encoder-decoder (frames before tokens,
    as the reference picks), else None."""
    if cfg.family != "encdec":
        return None
    return _encode(params, enc_frames if enc_frames is not None else enc_tokens, cfg)


def decoder_hidden(params, tokens, cfg, *, prefix=None, enc_tokens=None, enc_frames=None):
    """(B,S) tokens → (final hidden (B,S,d), aux), running the encoder first
    for an encoder-decoder.  ``aux`` is the sum of the MoE layers'
    load-balance terms (zero without MoE layers)."""
    enc_out = _memory(params, cfg, enc_tokens, enc_frames)
    x = _embed_inputs(params, tokens, cfg, prefix)
    x, aux, _ = _apply_stack_train(params["stack"], x, cfg, _positions(tokens),
                                   enc_out=enc_out)
    return norm_apply(hints.params(params["final_norm"]), x, cfg.norm), aux


def output_embedding(params, cfg) -> torch.Tensor:
    head = params["head"] if "head" in params else params["embed"]
    return hints.params(head)["embedding"]


def decoder_prefill(params, tokens, cfg, *, q_chunk: int = 0, prefix=None, enc_tokens=None,
                    enc_frames=None):
    """Full-sequence forward that also returns decode caches (an
    encoder-decoder's carry the encoder's length in ``cross_k``/
    ``cross_v``).  ``q_chunk`` 0 is the reference's rule (:func:`~repro_torch.
    models.attention.attn_train`); another value lets a sequence the
    rule's chunk does not divide run chunked."""
    enc_out = _memory(params, cfg, enc_tokens, enc_frames)
    x = _embed_inputs(params, tokens, cfg, prefix)
    x, _, caches = _apply_stack_train(params["stack"], x, cfg, _positions(tokens),
                                      want_cache=True, q_chunk=q_chunk, enc_out=enc_out)
    x = norm_apply(hints.params(params["final_norm"]), x, cfg.norm)
    return x, caches


def decoder_decode_step(params, tokens, cfg, caches, pos):
    """tokens: (B,1) new token ids; ``pos`` its position.  → (logits
    (B,1,V) f32, caches)."""
    x = _embed_inputs(params, tokens, cfg)
    x, new_caches = _apply_stack_decode(params["stack"], x, cfg, caches, pos)
    x = norm_apply(hints.params(params["final_norm"]), x, cfg.norm)
    logits = x.to(torch.float32) @ output_embedding(params, cfg).to(torch.float32).T
    return logits, new_caches


def init_decode_caches(params, cfg, batch: int, seq_len: int):
    """Zero caches shaped for a ``seq_len``-deep decode session, on the
    parameters' device; an encoder-decoder's ``cross_k``/``cross_v`` are
    ``(batch, seq_len, Hkv, hd)``, sized by the session as the reference
    sizes them."""
    period, n_scan, rem = stack_pattern(cfg)
    dev = output_embedding(params, cfg).device

    def one(kind: str) -> dict:
        if kind == "mamba":
            return ssm.mamba_init_state(cfg, batch, dev)
        if kind == "rwkv6":
            return ssm.rwkv6_init_state(cfg, batch, dev)
        c = attn.init_cache(cfg, kind, batch, seq_len, cfg.dtype, dev)
        if cfg.family == "encdec":
            shape = (batch, seq_len, cfg.n_kv_heads, cfg.head_dim)
            c["cross_k"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
            c["cross_v"] = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        return c

    caches: dict = {}
    if n_scan:
        per = {f"b{j}": one(cfg.layer_kinds[j]) for j in range(period)}
        caches["scan"] = tree_map(lambda x: x.expand((n_scan,) + x.shape).clone(), per)
    if rem:
        caches["rem"] = {f"b{j}": one(cfg.layer_kinds[n_scan * period + j])
                         for j in range(rem)}
    return caches
