"""Residual accumulation (error feedback): paper Eq. 2 and Theorem II.1.

Counterpart of ``repro.core.residual``::

    R_τ = R_{τ-1} + ΔW_τ − ΔW*_τ

Theorem II.1: if transferred updates are restricted to a subspace S, then
ΔW*_T = Proj_S(R_{T-1} + ΔW_T) uniquely minimizes the accumulated error
‖Σ_t (ΔW_t − ΔW*_t)‖ over S.  The mechanics live in
:meth:`repro_torch.core.policy.ResolvedPolicy.compress`; this module keeps
the standalone primitives and the projections the theorem's tests use.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels.topk import _top_k

PyTree = Any


def residual_update(residual: PyTree, delta: PyTree, transferred: PyTree) -> PyTree:
    """Eq. 2: R ← R + ΔW − ΔW*."""
    return tree_map(lambda r, d, t: r + d - t, residual, delta, transferred)


def accumulated_error(deltas: torch.Tensor, transferred: torch.Tensor) -> torch.Tensor:
    """‖Σ_t (ΔW_t − ΔW*_t)‖ for stacked (T, n) histories (Eq. 4)."""
    return torch.linalg.vector_norm(torch.sum(deltas - transferred, dim=0))


def project_fixed_support(vec: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Orthogonal projection onto S = {x : x_i = 0 for i ∉ support}."""
    return torch.where(support, vec, torch.zeros_like(vec))


def topk_projection(vec: torch.Tensor, k: int) -> torch.Tensor:
    """Best k-sparse approximation: the k largest magnitudes with their
    true values (``lax.top_k``'s tie order)."""
    _, idx = _top_k(torch.abs(vec), k)
    return torch.zeros_like(vec).index_put_((idx,), vec[idx])
