"""Shared layers (counterpart of ``repro.models.layers``).

The port carries what the paper's CharLSTM reads: the token embedding.
Rotary embeddings, norms and MLPs come with the model zoo (ROADMAP A12, part 2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_embed(gen: torch.Generator, vocab: int, d: int) -> dict:
    """``{"embedding": (vocab, d)}`` in f32 drawn from ``gen`` (on the CPU),
    normal with standard deviation ``1/√d``, as the reference's."""
    return {"embedding": torch.randn((vocab, d), generator=gen) * (1.0 / math.sqrt(d))}


def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """``jnp.take(embedding, tokens, axis=0)``.  ``F.embedding``, not
    advanced indexing or ``index_select``, whose backward on the card may
    add a repeated token's rows with atomics: with it a CharLSTM round repeats
    bit for bit on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""
    return F.embedding(tokens, p["embedding"])
