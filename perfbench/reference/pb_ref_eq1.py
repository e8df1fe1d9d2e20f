"""Eq. 1 of the paper: the upload bits of one client a round.

A frozen copy of the arithmetic of ``repro_torch.scale.costs``
(``sharded_exchange_bits``) and ``repro_torch.core.golomb``
(``golomb_bstar``, ``expected_position_bits``, Eq. 5), for one client of
one device: every leaf is SBC-compressed, a stacked leaf pays one row a
layer, each row ``k · b̄_pos(p) + 32`` bits (the positions, Golomb coded
at the optimal b*, and one 32-bit mean).
"""
from __future__ import annotations

import math

PHI = (math.sqrt(5.0) + 1.0) / 2.0


def golomb_bstar(p: float) -> int:
    """The optimal Golomb parameter b* at sparsity p (the paper's Alg. 3)."""
    return max(0, int(1 + math.floor(math.log2(math.log(PHI - 1.0) / math.log(1.0 - p)))))


def expected_position_bits(p: float) -> float:
    """Eq. 5: the mean bits of one position at sparsity p."""
    b = golomb_bstar(p)
    return b + 1.0 / (1.0 - (1.0 - p) ** (2.0 ** b))


def bits_per_client(specs: list, p: float) -> float:
    """Eq. 1 bits of one client a round for the leaves ``specs``
    (``(path, shape, ...)`` in the tree's leaf order)."""
    total = 0.0
    for path, shape, *_ in specs:
        size = math.prod(shape)
        rows = shape[0] if "stack/scan" in path and len(shape) > 1 else 1
        n = size // rows
        k = max(1, min(n, int(round(p * n))))
        total += rows * (k * expected_position_bits(p) + 32.0)
    return total
