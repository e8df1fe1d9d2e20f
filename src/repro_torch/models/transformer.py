"""Decoder assembly (counterpart of ``repro.models.transformer``) for the
dense text decoders: tiny, fed-tiny, lm-100m, gemma3, qwen1.5, granite
and command-r.

The parameter tree is the reference's, leaf for leaf::

    {"embed": {"embedding"}, "stack": {"scan": {"b0", …}, "rem": {…}},
     "final_norm": {…}, "head"?: {"embedding"}}

One superblock is the smallest repeating layer pattern (gemma3: 5 local
+ 1 global, period 6; homogeneous stacks: period 1).  The scanned
superblocks are stacked on a leading axis of every leaf under
``stack/scan``; the remainder layers (26 = 4·6 + 2 for gemma3) sit
unstacked under ``stack/rem``.  SBC's segments, its k a leaf, the SBW1
bytes and ``params_from_jax`` all depend on that layout.  The reference's
``lax.scan`` over superblocks is a loop over the leading index here; its
``jax.checkpoint`` changes no number and is not ported.

Three modes share the block code: train (full sequence, no caches),
prefill (full sequence, returns caches), decode (one token, carries
caches).  Mamba, RWKV6, MoE and cross-attention blocks, the
encoder-decoder and the modality prefix come with ROADMAP A12, part 3,
and raise ``NotImplementedError`` until then.
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.core.tree import tree_map
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_lookup, gen_device, init_embed, init_mlp,
                                       init_norm, mlp_apply, norm_apply, scale_by)

PyTree = Any


def _part3(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; it comes with ROADMAP A12, part 3")


def check_dense(cfg) -> None:
    """Raise for the parts of the zoo this port does not carry yet."""
    if cfg.family == "encdec" or cfg.enc_layers:
        raise _part3("the encoder-decoder (seamless-m4t)")
    if cfg.ssm_kind:
        raise _part3(f"the {cfg.ssm_kind} block (models/ssm.py)")
    if cfg.moe_experts:
        raise _part3("the MoE MLP (models/moe.py)")
    if cfg.modality != "text":
        raise _part3(f"the {cfg.modality} prefix")


# ------------------------------------------------------------------ blocks


def init_block(gen: torch.Generator, cfg, kind: str) -> dict:
    """One attention block of ``kind`` (``cfg`` passed :func:`check_dense`)."""
    dev = gen_device(gen)
    return {
        "norm1": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev),
        "inner": attn.init_attention(gen, cfg),
        "norm2": init_norm(cfg.d_model, cfg.norm, cfg.dtype, dev),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, gated=cfg.gated_mlp, dtype=cfg.dtype),
    }


def _block_train(params, x, cfg, kind, positions, want_cache=False, q_chunk=0):
    """Returns (x, cache_or_None)."""
    h = norm_apply(params["norm1"], x, cfg.norm)
    y, kv = attn.attn_train(params["inner"], h, cfg, kind, positions=positions,
                            q_chunk=q_chunk, return_cache_seq=want_cache)
    x = x + y
    h2 = norm_apply(params["norm2"], x, cfg.norm)
    x = x + mlp_apply(params["mlp"], h2)
    cache = None
    if want_cache:
        c = attn.init_cache(cfg, kind, x.shape[0], x.shape[1], cfg.dtype, x.device)
        cache = attn.fill_cache_from_prefill(c, kind, cfg, kv[0], kv[1])
    return x, cache


def _block_decode(params, x, cfg, kind, cache, pos):
    """One-token step.  Returns (x, new_cache)."""
    h = norm_apply(params["norm1"], x, cfg.norm)
    y, new_cache = attn.attn_decode(params["inner"], h, cfg, kind, cache, pos)
    x = x + y
    h2 = norm_apply(params["norm2"], x, cfg.norm)
    return x + mlp_apply(params["mlp"], h2), new_cache


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


def init_stack(gen: torch.Generator, cfg) -> dict:
    """Stacked superblock params (+ remainder):
    ``{'scan': {bj: stacked over superblocks}, 'rem': {bj: params}}``."""
    period, n_scan, rem = stack_pattern(cfg)
    out: dict = {}
    if n_scan:
        kinds = cfg.layer_kinds
        blocks = [{f"b{j}": init_block(gen, cfg, kinds[sb * period + j])
                   for j in range(period)} for sb in range(n_scan)]
        out["scan"] = _stack_trees(blocks)
        del blocks
    if rem:
        out["rem"] = {f"b{j}": init_block(gen, cfg, cfg.layer_kinds[n_scan * period + j])
                      for j in range(rem)}
    return out


def _index(tree: PyTree, i: int) -> PyTree:
    return tree_map(lambda v: v[i], tree)


def _apply_stack_train(stack, x, cfg, positions, want_cache=False, q_chunk=0):
    """Run all layers.  Returns (x, caches)."""
    period, n_scan, rem = stack_pattern(cfg)
    caches: dict = {}
    if n_scan:
        per_sb = []
        for sb in range(n_scan):
            sb_params = _index(stack["scan"], sb)
            cs = {}
            for j in range(period):
                kind = cfg.layer_kinds[j]  # the pattern is period-invariant
                x, cs[f"b{j}"] = _block_train(sb_params[f"b{j}"], x, cfg, kind, positions,
                                              want_cache, q_chunk)
            per_sb.append(cs)
        if want_cache:
            caches["scan"] = _stack_trees(per_sb)
    if rem:
        rem_caches = {}
        for j in range(rem):
            kind = cfg.layer_kinds[n_scan * period + j]
            x, rem_caches[f"b{j}"] = _block_train(stack["rem"][f"b{j}"], x, cfg, kind,
                                                  positions, want_cache, q_chunk)
        if want_cache:
            caches["rem"] = rem_caches
    return x, caches


def _apply_stack_decode(stack, x, cfg, caches, pos):
    period, n_scan, rem = stack_pattern(cfg)
    new_caches: dict = {}
    if n_scan:
        per_sb = []
        for sb in range(n_scan):
            sb_params, sb_caches = _index(stack["scan"], sb), _index(caches["scan"], sb)
            new_cs = {}
            for j in range(period):
                kind = cfg.layer_kinds[j]
                x, new_cs[f"b{j}"] = _block_decode(sb_params[f"b{j}"], x, cfg, kind,
                                                   sb_caches[f"b{j}"], pos)
            per_sb.append(new_cs)
        new_caches["scan"] = _stack_trees(per_sb)
    if rem:
        new_caches["rem"] = {}
        for j in range(rem):
            kind = cfg.layer_kinds[n_scan * period + j]
            x, new_caches["rem"][f"b{j}"] = _block_decode(
                stack["rem"][f"b{j}"], x, cfg, kind, caches["rem"][f"b{j}"], pos)
    return x, new_caches


# ------------------------------------------------------------ full models


def init_decoder_lm(gen: torch.Generator, cfg) -> dict:
    """The decoder's parameters drawn from ``gen`` on its device (a CUDA
    generator draws on the card), each leaf in ``cfg.dtype``."""
    check_dense(cfg)
    p = {
        "embed": init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype),
        "stack": init_stack(gen, cfg),
        "final_norm": init_norm(cfg.d_model, cfg.norm, cfg.dtype, gen_device(gen)),
    }
    if not cfg.tie_embeddings:
        p["head"] = init_embed(gen, cfg.vocab_size, cfg.d_model, cfg.dtype)
    return p


def _embed_inputs(params, tokens, cfg):
    # √d is rounded to the embedding's dtype first, as JAX's weak type does
    x = scale_by(embed_lookup(params["embed"], tokens), math.sqrt(cfg.d_model))
    return x.to(cfg.dtype)


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    return torch.arange(tokens.shape[-1], dtype=torch.int32, device=tokens.device)


def decoder_hidden(params, tokens, cfg):
    """(B,S) tokens → (final hidden (B,S,d), aux).  ``aux`` is the MoE
    load-balance term, zero for the dense stacks."""
    x = _embed_inputs(params, tokens, cfg)
    x, _ = _apply_stack_train(params["stack"], x, cfg, _positions(tokens))
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def output_embedding(params, cfg) -> torch.Tensor:
    head = params["head"] if "head" in params else params["embed"]
    return head["embedding"]


def decoder_prefill(params, tokens, cfg, *, q_chunk: int = 0):
    """Full-sequence forward that also returns decode caches.  ``q_chunk``
    0 is the reference's rule (:func:`~repro_torch.models.attention.
    attn_train`); another value lets a sequence the rule's chunk does not
    divide run chunked."""
    x = _embed_inputs(params, tokens, cfg)
    x, caches = _apply_stack_train(params["stack"], x, cfg, _positions(tokens),
                                   want_cache=True, q_chunk=q_chunk)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    return x, caches


def decoder_decode_step(params, tokens, cfg, caches, pos):
    """tokens: (B,1) new token ids; ``pos`` its position.  → (logits
    (B,1,V) f32, caches)."""
    x = _embed_inputs(params, tokens, cfg)
    x, new_caches = _apply_stack_decode(params["stack"], x, cfg, caches, pos)
    x = norm_apply(params["final_norm"], x, cfg.norm)
    logits = x.to(torch.float32) @ output_embedding(params, cfg).to(torch.float32).T
    return logits, new_caches


def init_decode_caches(params, cfg, batch: int, seq_len: int):
    """Zero caches shaped for a ``seq_len``-deep decode session, on the
    parameters' device."""
    period, n_scan, rem = stack_pattern(cfg)
    dev = output_embedding(params, cfg).device

    def one(kind: str) -> dict:
        return attn.init_cache(cfg, kind, batch, seq_len, cfg.dtype, dev)

    caches: dict = {}
    if n_scan:
        per = {f"b{j}": one(cfg.layer_kinds[j]) for j in range(period)}
        caches["scan"] = tree_map(lambda x: x.expand((n_scan,) + x.shape).clone(), per)
    if rem:
        caches["rem"] = {f"b{j}": one(cfg.layer_kinds[n_scan * period + j])
                         for j in range(rem)}
    return caches
