"""Exact two-sided top-k with ``lax.top_k``'s tie order.

Counterpart of the ``jax.lax.top_k`` calls of the JAX package's exact
paths (``repro.kernels.ops.sbc_compress_exact`` and the flat spaces'
exact engines).  ``lax.top_k`` orders floats totally (+0 above −0) and
takes the lower index first among equal values; ``torch.topk`` breaks
ties arbitrarily, so these helpers rank a stable sort of total-order
integer keys instead.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.reduce import f32_mean_xla


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 → int32 keys that order as the floats' total order does (−0
    below +0): the bits, with the magnitude bits flipped for negatives."""
    b = x.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` along the last axis: the k largest entries under the
    float total order, largest first, the lower index first among equal
    values.  ``torch.topk`` orders ties arbitrarily and a float sort takes
    ±0 as equal, so rank a stable sort of the total-order integer keys."""
    idx = torch.sort(_total_order_key(x), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx


def _two_sided_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per row of ``x[rows, n]``: paper Alg. 2's exact two-sided top-k.
    Returns ``(idx int64[rows, k], mu f32[rows])``: the k largest entries
    or the k most negative, whichever side's mean magnitude is larger, and
    that side's signed mean.  Each side's mean is ``jnp.mean``'s, bit for
    bit: XLA's f32 cascade over the values in top-k order
    (:func:`~repro_torch.kernels.reduce.f32_mean_xla`, one launch for both
    sides of every row), so μ, the side chosen and the selection all equal
    the reference's."""
    val_pos, idx_pos = _top_k(x, k)
    val_neg, idx_neg = _top_k(-x, k)
    rows = x.shape[0]
    mu_pos, mu_neg = f32_mean_xla(torch.cat([val_pos, val_neg])).split(rows)
    pos_wins = mu_pos > mu_neg
    idx = torch.where(pos_wins[:, None], idx_pos, idx_neg)
    mu = torch.where(pos_wins, mu_pos, -mu_neg)
    return idx, mu
