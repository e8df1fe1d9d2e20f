"""The benchmark's weights: every leaf of a configuration's parameter tree,
drawn on the device from the seed.

Both sides get these weights: the harness copies them into the program's
state, and the reference draws them again after the window.  Each leaf
has a generator of its own, seeded from the run's seed and the leaf's
place in the tree, so a leaf can be drawn again alone; each is one
``torch.randn`` call on the device (norm scales are ones, biases zeros).

The tree is the port's layout (the keys sorted, as JAX flattens a
dict): ``embed/embedding``, an encoder-decoder's ``encoder/stack/scan``
and ``encoder/final_norm``, ``final_norm``, ``stack/scan`` with the
layers stacked on a leading axis.  Scales: a dense weight and the router
``N(0, 1/d_in)``, an expert's ``up``/``gate`` ``N(0, 1/d)`` and ``down``
``N(0, 1/d_ff)``, the embedding ``N(0, 1/d)``.
"""
from __future__ import annotations

import math

import torch


def _norm_leaves(prefix: str, m: dict, lead: tuple) -> list:
    out = [(f"{prefix}/scale", lead + (m["d_model"],), "ones", 0.0)]
    if m["norm"] == "layernorm":
        out.append((f"{prefix}/bias", lead + (m["d_model"],), "zeros", 0.0))
    return out


def _attn_leaves(prefix: str, m: dict, lead: tuple) -> list:
    d, hd = m["d_model"], m["head_dim"]
    nq, nkv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    return [(f"{prefix}/wk/w", lead + (d, nkv), "normal", 1 / math.sqrt(d)),
            (f"{prefix}/wo/w", lead + (nq, d), "normal", 1 / math.sqrt(nq)),
            (f"{prefix}/wq/w", lead + (d, nq), "normal", 1 / math.sqrt(d)),
            (f"{prefix}/wv/w", lead + (d, nkv), "normal", 1 / math.sqrt(d))]


def _ffn_leaves(prefix: str, m: dict, lead: tuple) -> list:
    d, ff = m["d_model"], m["d_ff"]
    if m.get("moe_experts", 0):
        E = m["moe_experts"]
        out = [(f"{prefix}/moe/down", lead + (E, ff, d), "normal", 1 / math.sqrt(ff))]
        if m["gated_mlp"]:
            out.append((f"{prefix}/moe/gate", lead + (E, d, ff), "normal", 1 / math.sqrt(d)))
        out += [(f"{prefix}/moe/router", lead + (d, E), "normal", 1 / math.sqrt(d)),
                (f"{prefix}/moe/up", lead + (E, d, ff), "normal", 1 / math.sqrt(d))]
        return out
    out = [(f"{prefix}/mlp/down/w", lead + (ff, d), "normal", 1 / math.sqrt(ff))]
    if m["gated_mlp"]:
        out.append((f"{prefix}/mlp/gate/w", lead + (d, ff), "normal", 1 / math.sqrt(d)))
    out.append((f"{prefix}/mlp/up/w", lead + (d, ff), "normal", 1 / math.sqrt(d)))
    return out


def _block_leaves(prefix: str, m: dict, lead: tuple, cross: bool) -> list:
    """One block's leaves, sorted by path: ``cross``, ``inner``, ``mlp``
    or ``moe``, ``norm1``, ``norm2``, ``norm_x``."""
    leaves = _attn_leaves(f"{prefix}/inner", m, lead)
    if cross:
        leaves += _attn_leaves(f"{prefix}/cross", m, lead)
        leaves += _norm_leaves(f"{prefix}/norm_x", m, lead)
    leaves += _ffn_leaves(prefix, m, lead)
    leaves += _norm_leaves(f"{prefix}/norm1", m, lead)
    leaves += _norm_leaves(f"{prefix}/norm2", m, lead)
    return sorted(leaves)


def leaf_specs(m: dict) -> list:
    """``[(path, shape, kind, scale)]`` of the model ``m`` (a configuration
    file's ``model``), in the tree's leaf order.  Every layer of a stack
    is one period (dense or all-MoE stacks), stacked on a leading axis."""
    if m.get("moe_experts", 0) and m.get("moe_every", 1) != 1:
        raise ValueError("the reference stacks one layer a period: moe_every must be 1")
    d, V = m["d_model"], m["vocab_size"]
    encdec = m["family"] == "encdec"
    leaves = [("embed/embedding", (V, d), "normal", 1 / math.sqrt(d))]
    leaves += _norm_leaves("final_norm", m, ())
    leaves += _block_leaves("stack/scan/b0", m, (m["n_layers"],), cross=encdec)
    if not m.get("tie_embeddings", True):
        leaves.append(("head/embedding", (V, d), "normal", 1 / math.sqrt(d)))
    if encdec:
        enc = dict(m, moe_experts=0)
        leaves += _block_leaves("encoder/stack/scan/b0", enc, (m["enc_layers"],), cross=False)
        leaves += _norm_leaves("encoder/final_norm", m, ())
    return sorted(leaves)


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index`` of a run with ``seed`` (any
    whole number; 63 bits kept)."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63 - 1)


def draw_leaf(spec: tuple, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` (its ``spec`` from :func:`leaf_specs`), f32, on
    ``device``."""
    _, shape, kind, scale = spec
    if kind == "ones":
        return torch.ones(shape, dtype=torch.float32, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(scale)


def draw_weights(m: dict, seed: int, device) -> dict:
    """Every leaf of ``m`` drawn from ``seed``: ``{path: tensor}``."""
    return {spec[0]: draw_leaf(spec, seed, i, device) for i, spec in enumerate(leaf_specs(m))}
