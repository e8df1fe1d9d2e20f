"""Plain-torch oracles for the per-leaf kernels and the exact SBC.

Counterpart of ``repro.kernels.ref``: straightforward versions that the
tests hold the kernels' wrappers and plain versions against.  They are
written independently of the kernels' own plain versions (no partials,
no fixed fold), and nothing on a run path calls them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.reduce import f32_mean_xla_plain
from repro_torch.kernels.topk import _top_k


def _pair(v, device) -> torch.Tensor:
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=device), (2,))


def hist2side_ref(flat: torch.Tensor, lo, hi, nbins: int = 128) -> torch.Tensor:
    """Oracle for ``hist2side`` (identical binning rule): ``lo``/``hi``
    broadcast to (2,), per-side magnitude ranges."""
    x = flat.to(torch.float32)
    absx = x.abs()
    lo, hi = _pair(lo, x.device), _pair(hi, x.device)
    rows = []
    for side, sel in ((0, x > 0.0), (1, x < 0.0)):
        in_range = sel & (absx >= lo[side]) & (absx < hi[side])
        log_lo = torch.log2(torch.clamp(lo[side], min=1e-38))
        log_hi = torch.log2(torch.clamp(hi[side], min=2e-38))
        f = (torch.log2(torch.clamp(absx, min=1e-38)) - log_lo) / (log_hi - log_lo)
        bucket = torch.clamp((f * nbins).to(torch.int64), 0, nbins - 1)
        rows.append(torch.zeros((nbins,), dtype=torch.float32, device=x.device)
                    .index_add_(0, bucket, in_range.to(torch.float32)))
    return torch.stack(rows)


def masked_moments_ref(flat: torch.Tensor, t_pos, t_neg) -> torch.Tensor:
    """``[[Σ⁺, n⁺], [Σ⁻, n⁻]]``, each sum in f64 rounded to f32 once."""
    x = flat.to(torch.float32)
    x64 = x.to(torch.float64)
    rows = [torch.stack([x64[m].sum(), m.sum().to(torch.float64)])
            for m in (x >= t_pos, x <= -torch.as_tensor(t_neg))]
    return torch.stack(rows).to(torch.float32)


def binarize_apply_ref(flat: torch.Tensor, t_pos, t_neg, mu, pos_wins
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    x = flat.to(torch.float32)
    mask = (x >= t_pos) if float(pos_wins) > 0.5 else (x <= -torch.as_tensor(t_neg))
    out = torch.where(mask, torch.as_tensor(mu, dtype=torch.float32), 0.0)
    return out, x - out


def sbc_exact_ref(flat: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k SBC (paper Alg. 2), the oracle the histogram pipeline
    approximates; means in XLA's f32 order, as ``jnp.mean`` takes them
    (the plain cascade).  Returns the dense ΔW*."""
    val_pos, idx_pos = _top_k(flat, k)
    val_neg, idx_neg = _top_k(-flat, k)
    mu_pos, mu_neg = f32_mean_xla_plain(val_pos), f32_mean_xla_plain(val_neg)
    idx, mean = (idx_pos, mu_pos) if mu_pos > mu_neg else (idx_neg, -mu_neg)
    return torch.zeros_like(flat).index_fill_(0, idx, float(mean))
