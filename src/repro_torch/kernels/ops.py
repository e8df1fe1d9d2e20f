"""Threshold selection from histogram survival counts.

Counterpart of ``repro.kernels.ops._side_threshold``, written for a batch
of segments at once (the reference maps it over segments with
``jax.vmap``).  The per-leaf compositions of ``repro.kernels.ops``
(``threshold_two_pass``, ``sbc_compress_hist``) are still to be ported.
"""
from __future__ import annotations

import torch


def _side_threshold(hist_rows: torch.Tensor, edges: torch.Tensor, k: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the bucket of the k-th largest entry from survival counts.

    ``hist_rows`` and ``edges`` are ``(nseg, nbins)``, ``k`` is ``(nseg,)``.
    Returns ``(bucket_lo_edge, bucket_hi_edge, count_above_bucket)``, each
    ``(nseg,)``.  If a side has fewer than k entries the threshold
    collapses to the lowest edge (select everything on that side).
    """
    nbins = hist_rows.shape[-1]
    # survival[b] = number of entries in bucket >= b (integer-valued f32
    # counts, so the cumulative sum is exact in any order)
    survival = torch.flip(torch.cumsum(torch.flip(hist_rows, [-1]), -1), [-1])
    feasible = survival >= k[:, None]
    any_feasible = feasible.any(-1)
    # largest feasible bucket index (survival is non-increasing)
    bstar = torch.where(any_feasible, feasible.sum(-1) - 1, torch.zeros_like(any_feasible, dtype=torch.int64))
    inner = bstar + 1 < nbins

    def at(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return torch.gather(t, -1, idx[:, None])[:, 0]

    lo_edge = torch.where(any_feasible, at(edges, bstar), edges[:, 0])
    hi_edge = torch.where(
        inner, at(edges, torch.clamp(bstar + 1, max=nbins - 1)), edges[:, -1] * 2.0
    )
    shifted = torch.cat([survival[:, 1:], torch.zeros_like(survival[:, :1])], -1)
    above = torch.where(inner, at(shifted, bstar), torch.zeros_like(lo_edge))
    return lo_edge, hi_edge, above
