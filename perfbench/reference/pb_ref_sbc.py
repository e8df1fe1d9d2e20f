"""Sparse Binary Compression with histogram thresholds, in plain PyTorch,
one leaf at a time: the semantics of the port's hist engine, worked out
again from the accumulated update alone.

For a leaf ``x`` (its whole flattened update, one segment) and
``k = max(1, min(n, round(p·n)))``:

1. a coarse pass: each side's magnitudes (``x > 0``; ``-x`` for
   ``x < 0``) in 128 log₂-spaced buckets over ``[max|x|·2⁻³⁰,
   max|x|·1.0001)``; the bucket holding the k-th largest entry of the
   side, and the count above it;
2. a zoomed pass: the same over that bucket's range, for the k-th less
   the count above; the side's threshold is that bucket's lower edge;
3. the means ``μ⁺`` of the entries ``≥ t⁺`` and ``μ⁻`` of the
   magnitudes of those ``≤ −t⁻`` (sums and counts in f64); the side
   whose mean is larger wins (``μ⁺ > μ⁻``);
4. ``ΔW* = μ·sign`` on the winning side's selected entries, else 0, and
   the new residual ``x − ΔW*``.

A bucket is ``clip(int((log₂|x| − log₂ lo) / (log₂ hi − log₂ lo) ·
128), 0, 127)``, counted where ``lo ≤ |x| < hi``.  A side with fewer than
k entries in range selects down to its lowest edge.
"""
from __future__ import annotations

import torch

NBINS = 128
SPAN_OCTAVES = 30.0
CHUNK = 1 << 26  # entries a pass takes at once, to bound its temporaries


def k_for(n: int, p: float) -> int:
    return max(1, min(n, int(round(p * n))))


def _edges(lo, hi):
    f = torch.arange(NBINS, dtype=torch.float32, device=lo.device) / NBINS
    log_lo = torch.log2(torch.clamp(lo, min=1e-38))
    log_hi = torch.log2(torch.clamp(hi, min=2e-38))
    return torch.exp2(log_lo + f * (log_hi - log_lo))


def _histograms(x, ranges):
    """int64 (2, NBINS): side 0 counts ``x > 0``, side 1 ``x < 0``, each by
    magnitude within its ``(lo, hi)`` of ``ranges``."""
    counts = torch.zeros((2, NBINS), dtype=torch.int64, device=x.device)
    for start in range(0, x.numel(), CHUNK):
        c = x[start:start + CHUNK]
        a = c.abs()
        log_a = torch.log2(torch.clamp(a, min=1e-38))
        for side, sel in ((0, c > 0), (1, c < 0)):
            lo, hi = ranges[side]
            inside = sel & (a >= lo) & (a < hi)
            log_lo = torch.log2(torch.clamp(lo, min=1e-38))
            log_hi = torch.log2(torch.clamp(hi, min=2e-38))
            f = (log_a[inside] - log_lo) / (log_hi - log_lo)
            bucket = torch.clamp((f * NBINS).to(torch.int32), 0, NBINS - 1)
            counts[side] += torch.bincount(bucket, minlength=NBINS)
    return counts


def _threshold(hist, edges, k):
    """``(lower edge, upper edge, count above)`` of the bucket holding the
    k-th largest entry of one side's ``hist``."""
    survival = torch.flip(torch.cumsum(torch.flip(hist, [0]), 0), [0]).to(torch.float32)
    feasible = survival >= k
    b = int(feasible.sum()) - 1 if bool(feasible.any()) else 0
    if b + 1 < NBINS:
        return edges[b], edges[b + 1], survival[b + 1]
    return edges[b], edges[-1] * 2.0, torch.zeros((), dtype=torch.float32, device=hist.device)


def compress(x: torch.Tensor, p: float):
    """``(ΔW*, residual)`` of one leaf's flattened f32 update ``x``."""
    k = torch.tensor(float(k_for(x.numel(), p)), dtype=torch.float32, device=x.device)
    absmax = torch.amax(torch.abs(x)) + 1e-30
    lo0, hi0 = absmax * 2.0 ** -SPAN_OCTAVES, absmax * 1.0001
    h1 = _histograms(x, ((lo0, hi0), (lo0, hi0)))
    e0 = _edges(lo0, hi0)
    lo_p, hi_p, above_p = _threshold(h1[0], e0, k)
    lo_n, hi_n, above_n = _threshold(h1[1], e0, k)
    h2 = _histograms(x, ((lo_p, hi_p), (lo_n, hi_n)))
    t_pos = _threshold(h2[0], _edges(lo_p, hi_p), k - above_p)[0]
    t_neg = _threshold(h2[1], _edges(lo_n, hi_n), k - above_n)[0]
    pos, neg = x >= t_pos, x <= -t_neg
    s_pos, n_pos = x[pos].double().sum(), pos.sum()
    s_neg, n_neg = x[neg].double().sum(), neg.sum()
    mu_pos = s_pos.float() / torch.clamp(n_pos.float(), min=1.0)
    mu_neg = -s_neg.float() / torch.clamp(n_neg.float(), min=1.0)
    if bool(mu_pos > mu_neg):
        out = torch.where(pos, mu_pos, torch.zeros((), device=x.device))
    else:
        out = torch.where(neg, -mu_neg, torch.zeros((), device=x.device))
    return out, x - out
