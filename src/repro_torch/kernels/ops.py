"""The composed SBC pipelines over one tensor.

Counterpart of ``repro.kernels.ops``.  The histogram-threshold pipeline
(the replacement for the paper's top-p% sort):

  1. :func:`threshold_two_pass`: a coarse (2, nbins) log-magnitude
     histogram over ``[absmax·2⁻³⁰, absmax)``; survival counts pick the
     bucket holding the k-th largest entry per side, and a second
     histogram zoomed into that bucket refines the threshold to nbins²
     buckets (two ``hist2side`` calls);
  2. ``masked_moments``: μ⁺/μ⁻ over the selected entries (Alg. 2 l.4);
  3. ``binarize_apply``: the fused ΔW* write and residual update (Eq. 2).

:func:`sbc_compress_hist` composes them.  On a CUDA tensor every pass is a
hand-written kernel and every scalar between the passes stays on the
card, so the pipeline never waits for it.  :func:`sbc_compress_exact` is
the faithful top-k path, with ``lax.top_k``'s tie order
(:mod:`repro_torch.kernels.topk`).  The reference's ``interpret=``
argument has no counterpart: the tensor's device decides.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.golomb import expected_position_bits
from repro_torch.core.stages import k_for
from repro_torch.kernels.binarize_apply import binarize_apply
from repro_torch.kernels.hist2side import (
    DEFAULT_BM,
    DEFAULT_LANES,
    SPAN_OCTAVES,
    bucket_lower_edges,
    hist2side,
)
from repro_torch.kernels.moments import masked_moments
from repro_torch.kernels.topk import _two_sided_topk


def _side_threshold(hist_rows: torch.Tensor, edges: torch.Tensor, k: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick the bucket of the k-th largest entry from survival counts.

    Written for a batch of segments at once (the reference maps it over
    segments with ``jax.vmap``; a single tensor is a batch of one).
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


def threshold_two_pass(flat: torch.Tensor, k: int, *, nbins: int = 128
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t⁺, t⁻)``, 0-d f32: approximate k-th-largest thresholds for each
    side of ``flat``."""
    x = flat.to(torch.float32)
    scale = torch.amax(torch.abs(x)) + 1e-30
    lo0 = scale * 2.0 ** -SPAN_OCTAVES
    hi0 = scale * 1.0001

    h1 = hist2side(x, lo0, hi0, nbins=nbins)
    edges0 = bucket_lower_edges(lo0, hi0, nbins)[None]
    kf = torch.full((1,), float(k), dtype=torch.float32, device=x.device)
    lo_p, hi_p, above_p = _side_threshold(h1[None, 0], edges0, kf)
    lo_n, hi_n, above_n = _side_threshold(h1[None, 1], edges0, kf)

    # pass 2: zoom into the winning bucket per side
    h2 = hist2side(x, torch.cat([lo_p, lo_n]), torch.cat([hi_p, hi_n]), nbins=nbins)
    t_pos, _, _ = _side_threshold(h2[None, 0], bucket_lower_edges(lo_p, hi_p, nbins),
                                  kf - above_p)
    t_neg, _, _ = _side_threshold(h2[None, 1], bucket_lower_edges(lo_n, hi_n, nbins),
                                  kf - above_n)
    return t_pos[0], t_neg[0]


class SBCCompressed(NamedTuple):
    """Everything one SBC compression of a flat tensor produces."""

    delta_star: torch.Tensor  # dense ΔW* (f32[n])
    residual: torch.Tensor  # new residual = acc − ΔW* (f32[n])
    mean: torch.Tensor  # signed μ (f32[])
    count: torch.Tensor  # number of surviving entries m (f32[])
    nbits: torch.Tensor  # analytic wire bits: m·b̄_pos(p) + 32


def sbc_compress_hist(acc: torch.Tensor, *, p: float, nbins: int = 128,
                      bm: int = DEFAULT_BM, lanes: int = DEFAULT_LANES) -> SBCCompressed:
    """Histogram-threshold SBC over a residual-accumulated flat update.

    ``bm``/``lanes`` set the partials of the moments pass; at ``bm=8,
    lanes=128`` the result equals the flat hist engine's for the same
    values as one segment, bit for bit.
    """
    k = k_for(acc.shape[0], p)
    x = acc.to(torch.float32)

    t_pos, t_neg = threshold_two_pass(x, k, nbins=nbins)
    mom = masked_moments(x, t_pos, t_neg, bm=bm, lanes=lanes)
    mu_pos = mom[0, 0] / torch.clamp(mom[0, 1], min=1.0)
    mu_neg = -mom[1, 0] / torch.clamp(mom[1, 1], min=1.0)  # positive magnitude

    pos_wins = mu_pos > mu_neg
    mu = torch.where(pos_wins, mu_pos, -mu_neg)
    count = torch.where(pos_wins, mom[0, 1], mom[1, 1])

    out, res = binarize_apply(x, t_pos, t_neg, mu, pos_wins.to(torch.float32), bm=bm,
                              lanes=lanes)
    nbits = count * expected_position_bits(p) + 32.0
    return SBCCompressed(out, res, mu, count, nbits)


def sbc_compress_exact(acc: torch.Tensor, *, p: float) -> SBCCompressed:
    """Faithful Alg. 2 by exact top-k (exactly k survivors).

    μ is the winning side's mean in XLA's f32 order
    (:func:`~repro_torch.kernels.topk._two_sided_topk`), so μ, ΔW*, the
    residual and the side chosen equal the reference's bit for bit.
    """
    n = acc.shape[0]
    k = k_for(n, p)
    x = acc.to(torch.float32)

    idx, mu = _two_sided_topk(x[None], k)
    out = torch.zeros_like(x)
    out[idx[0]] = mu[0]
    count = torch.full((), float(k), dtype=torch.float32, device=x.device)
    nbits = torch.full((), k * expected_position_bits(p) + 32.0, dtype=torch.float32,
                       device=x.device)
    return SBCCompressed(out, x - out, mu[0], count, nbits)


def dense_to_sparse(dense: torch.Tensor, k_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx int32[k_cap], valid f32[k_cap])`` from a dense masked tensor.

    The first ``k_cap`` non-zero positions in ascending order, padded with
    0 where there are fewer, and ``valid`` 1 on the slots that hold one
    (the reference's ``jnp.nonzero(..., size=k_cap, fill_value=0)``).
    Fixed-size, so the host never waits for the count: each non-zero
    entry's rank (a cumulative sum) is its slot, and a scatter writes the
    positions.
    """
    nz = dense.reshape(-1) != 0
    rank = torch.cumsum(nz, 0) - 1
    slot = torch.where(nz & (rank < k_cap), rank, k_cap)  # slot k_cap: dropped
    idx = torch.zeros((k_cap + 1,), dtype=torch.int64, device=dense.device)
    idx.scatter_(0, slot, torch.arange(nz.numel(), device=dense.device))
    valid = torch.arange(k_cap, device=dense.device) < nz.sum()
    return idx[:k_cap].to(torch.int32), valid.to(torch.float32)
