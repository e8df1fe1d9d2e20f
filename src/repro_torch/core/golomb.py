"""Golomb position coding: the analytic model of paper Eq. 5.

Counterpart of the analytic half of ``repro.core.golomb``.  Under the
paper's model the gaps between surviving positions of a top-p% sparsified
tensor are geometric with success probability p, and Golomb coding with
``b* = 1 + floor(log2(log(phi-1)/log(1-p)))`` is optimal.  Eq. 5 gives the
expected bits per position:

    b̄_pos = b* + 1 / (1 - (1-p)^(2^b*))

(The bitstream encoder and decoder are still to be ported.)
"""
from __future__ import annotations

import math

PHI = (math.sqrt(5.0) + 1.0) / 2.0


def golomb_bstar(p: float) -> int:
    """Optimal Golomb parameter b* for sparsity rate p (paper Alg. 3 l.4)."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"sparsity rate must be in (0,1), got {p}")
    b = 1 + math.floor(math.log2(math.log(PHI - 1.0) / math.log(1.0 - p)))
    return max(0, int(b))


def expected_position_bits(p: float) -> float:
    """Eq. 5: average bits to encode one non-zero position at sparsity p.

    p ≥ 1 means a dense update: positions are predetermined and cost 0
    bits (Eq. 1's dense case).
    """
    if p >= 1.0:
        return 0.0
    b = golomb_bstar(p)
    return b + 1.0 / (1.0 - (1.0 - p) ** (2.0**b))
