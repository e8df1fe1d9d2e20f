"""Losses (counterpart of ``repro.models.losses``).

``chunked_softmax_xent`` never materializes (B, S, V) logits past one
slab of ``chunk`` positions, as the reference's scan; the reference's
``jax.checkpoint`` of a slab changes no number, so the port runs without
it.
"""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - gold)


def chunked_softmax_xent(hidden: torch.Tensor, embedding: torch.Tensor,
                         labels: torch.Tensor, *, chunk: int = 512) -> torch.Tensor:
    """Cross-entropy from final hidden states and the (V, d) output
    embedding.  hidden: (B, S, d); labels: (B, S).  Sums slab by slab of
    ``chunk`` positions (one slab when ``S % chunk != 0``), then divides
    by ``B·S``."""
    B, S, d = hidden.shape
    if S % chunk != 0:
        chunk = S  # small sequences: single slab
    emb_t = embedding.to(torch.float32).T
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // chunk):
        hc = hidden[:, i * chunk:(i + 1) * chunk]
        yc = labels[:, i * chunk:(i + 1) * chunk]
        logits = hc.to(torch.float32) @ emb_t
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, yc[..., None].to(torch.int64))[..., 0]
        total = total + torch.sum(lse - gold)
    return total / (B * S)
