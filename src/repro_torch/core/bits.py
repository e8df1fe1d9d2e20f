"""Bit accounting: paper Eq. 1 and Table I.

Counterpart of ``repro.core.bits``; analytic, so equal to the reference's
bit for bit.

    b_total = O( N_iter · f  ·  |ΔW≠0| · (b̄_pos + b̄_val)  ·  K )

``f`` is the communication frequency (1/n for delay n), ``|ΔW≠0|`` the number
of surviving entries, and K the receiving-node count (1 for a server upload,
M−1 for all-to-all; we report per-upload bits like the paper and expose K).

These analytic numbers are held against the exact Golomb bitstream and
against the LeafCompressed ``nbits`` fields.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.golomb import expected_position_bits

DENSE_VALUE_BITS = 32.0
NAIVE_POS_BITS = 16.0


@dataclasses.dataclass(frozen=True)
class MethodBits:
    """Asymptotic per-method accounting (one Table I column)."""

    name: str
    temporal_sparsity: float  # f, fraction of iterations that communicate
    gradient_sparsity: float  # fraction of entries that survive
    value_bits: float  # b̄_val per surviving entry
    position_bits: float  # b̄_pos per surviving entry

    def bits_per_iteration(self, n_params: int) -> float:
        """Expected uplink bits per forward-backward pass (Eq. 1 / N_iter)."""
        per_comm = (
            self.gradient_sparsity * n_params * (self.value_bits + self.position_bits)
        )
        # per-tensor scalar overheads (means/norms) are O(#tensors) and
        # negligible at the asymptotic level of Table I.
        return self.temporal_sparsity * per_comm

    def compression_rate(self, n_params: int) -> float:
        base = DENSE_VALUE_BITS * n_params
        return base / self.bits_per_iteration(n_params)


def table1_row(
    name: str,
    *,
    delay: int = 1,
    sparsity: float = 1.0,
    value_bits: float = DENSE_VALUE_BITS,
    golomb: bool = False,
) -> MethodBits:
    if golomb:
        pos = expected_position_bits(sparsity)
    elif sparsity < 1.0:
        pos = NAIVE_POS_BITS
    else:
        pos = 0.0
    return MethodBits(
        name=name,
        temporal_sparsity=1.0 / delay,
        gradient_sparsity=sparsity,
        value_bits=value_bits,
        position_bits=pos,
    )


def paper_table1() -> list[MethodBits]:
    """The columns of Table I with the paper's representative settings."""
    return [
        table1_row("baseline"),
        table1_row("signsgd", value_bits=1.0),
        table1_row("qsgd", value_bits=4.0),
        table1_row("terngrad", value_bits=math.log2(3.0)),
        table1_row("gradient_dropping", sparsity=0.001),
        table1_row("dgc", sparsity=0.001),
        table1_row("federated_averaging", delay=100),
        table1_row("sbc1", delay=1, sparsity=0.001, value_bits=0.0, golomb=True),
        table1_row("sbc2", delay=10, sparsity=0.01, value_bits=0.0, golomb=True),
        table1_row("sbc3", delay=100, sparsity=0.01, value_bits=0.0, golomb=True),
    ]


def sbc_bits_per_round(n_params: int, p: float) -> float:
    """Exact expected wire bits for one SBC message over n_params entries."""
    k = max(1, min(n_params, round(p * n_params)))
    return k * expected_position_bits(p) + 32.0


def total_upload_bits(
    *, n_params: int, n_iterations: int, delay: int, bits_per_comm: float
) -> float:
    """Eq. 1 total for one client over a training run (K = 1 server)."""
    rounds = n_iterations / delay
    return rounds * bits_per_comm
