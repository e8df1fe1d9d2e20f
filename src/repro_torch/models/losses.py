"""Losses (counterpart of ``repro.models.losses``)."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy.  logits (..., V), labels (...) int."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return torch.mean(lse - gold)
