"""Codec stage helpers.

Counterpart of ``repro.core.stages``; this slice needs only the survivor
count rule.  (Selectors, quantizers and encoders are still to be ported.)
"""
from __future__ import annotations


def k_for(n: int, p: float) -> int:
    """Number of surviving entries at sparsity rate p (at least 1)."""
    return max(1, min(n, int(round(p * n))))
