"""Temporal-vs-gradient sparsity scheduling: paper §III (and §V's future
work).

Counterpart of ``repro.core.sparsity``, plain Python whose values equal
the reference's.  Communication delay (temporal sparsity 1/n) and
gradient sparsity p multiply into one total-sparsity budget, and the
validation error stays about constant along iso-total-sparsity diagonals
(Fig. 3); early in training (high LR) temporal sparsity is preferred,
after the LR drops gradient sparsity wins (Fig. 4).

A schedule returns ``(delay_n, sparsity_p)`` for a round.  The adaptive
controller is the reference's §V heuristic: it follows the LR schedule
and shifts a fixed total-sparsity budget from temporal to gradient
sparsity as the LR decays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from repro_torch.core.sbc import SBC_PRESETS


@dataclasses.dataclass(frozen=True)
class SparsitySchedule:
    """delay(round) and sparsity(round), plus the DGC warm-up option."""

    delay: Callable[[int], int]
    sparsity: Callable[[int], float]

    def __call__(self, round_idx: int) -> tuple[int, float]:
        return int(self.delay(round_idx)), float(self.sparsity(round_idx))


def constant(delay: int = 1, sparsity: float = 0.001) -> SparsitySchedule:
    return SparsitySchedule(lambda r: delay, lambda r: sparsity)


def preset(name: str) -> SparsitySchedule:
    """The paper's SBC(1)/(2)/(3) operating points."""
    n, p = SBC_PRESETS[name]
    return constant(delay=n, sparsity=p)


def dgc_warmup(
    target_sparsity: float = 0.001,
    warmup_rounds: int = 4,
    start_sparsity: float = 0.25,
) -> SparsitySchedule:
    """DGC's exponential sparsity warm-up (its supplement A): 25% → target,
    interpolated in log space."""

    def sparsity(r: int) -> float:
        if r >= warmup_rounds:
            return target_sparsity
        frac = (r + 1) / warmup_rounds
        return float(
            math.exp(
                math.log(start_sparsity) * (1 - frac) + math.log(target_sparsity) * frac
            )
        )

    return SparsitySchedule(lambda r: 1, sparsity)


def adaptive_total_budget(
    total_sparsity: float,
    lr_schedule: Callable[[int], float],
    base_lr: float,
    max_delay: int = 100,
    min_sparsity: float = 1e-4,
) -> SparsitySchedule:
    """§III/§V adaptive controller under a fixed total-sparsity budget
    ``(1/delay) · p``: at the base LR the budget goes into temporal
    sparsity (a large delay); after each LR decay it shifts toward
    gradient sparsity (delay → 1, smaller p), as in Fig. 4."""

    def split(r: int) -> tuple[int, float]:
        decay = lr_schedule(r) / base_lr  # 1.0 early, < 1 after drops
        # the share of the (log) budget that goes to temporal sparsity:
        # 1.0 at the base LR, 0 after a 100x decay
        temporal_frac = max(0.0, min(1.0, math.log10(max(decay, 1e-8)) / -2.0))
        temporal_frac = 1.0 - temporal_frac
        log_budget = -math.log10(total_sparsity)  # e.g. 1e-3 → 3 decades
        delay = int(round(10 ** (log_budget * temporal_frac)))
        delay = max(1, min(max_delay, delay))
        p = max(min_sparsity, min(1.0, total_sparsity * delay))
        return delay, p

    return SparsitySchedule(lambda r: split(r)[0], lambda r: split(r)[1])


def grid_points(
    delays: tuple[int, ...] = (1, 2, 5, 10, 25, 50, 100),
    sparsities: tuple[float, ...] = (1.0, 0.1, 0.01, 0.001),
) -> list[tuple[int, float]]:
    """The 2-D sweep grid of Fig. 3 (temporal × gradient sparsity)."""
    return [(n, p) for n in delays for p in sparsities]
