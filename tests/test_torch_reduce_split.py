"""How ``repro_torch.kernels.reduce.f32_mean_xla`` splits a row over the
CTAs of its CUDA kernel, checked on the host.

The kernel (``csrc/reduce.cu``) gives each warp one level-1 window (32
level-0 windows of 32 values) at a time.  A row whose level-0 windows fit
in one CTA takes the one-CTA route; a longer row is split over
``ctas_per_row`` CTAs, and ``cta_windows`` below walks a row as the kernel
does and says which level-0 windows each CTA sums.  Whatever the split,
every level-0 window must be summed exactly once: then the kernel's bits
equal the plain cascade's (``test_torch_cuda.py`` holds them equal on the
card).
"""
import numpy as np
import pytest

from repro_torch.kernels import reduce as treduce

WINDOW = treduce.WINDOW
ONE_CTA_MAX = WINDOW * WINDOW * treduce.CTA_WARPS  # values of the longest one-CTA row
BUDGETS = (1056, 7, 1)  # a full H100 wave, a few CTAs, one


def cta_windows(n, cpr, cta):
    """The level-0 windows CTA ``cta`` of a row split over ``cpr`` CTAs
    sums, as ``csrc/reduce.cu`` walks them: its warp w takes the level-1
    windows ``cta · CTA_WARPS + w``, then every ``cpr · CTA_WARPS``-th
    after it, and level-1 window u holds the level-0 windows ``32u − f1
    .. 32u − f1 + 31`` that exist (f1: the level's front pad)."""
    m0, m1 = -(-n // WINDOW), treduce.level1_windows(n)
    f1 = (m1 * WINDOW - m0) // 2
    out = []
    for first in range(cta * treduce.CTA_WARPS, m1, cpr * treduce.CTA_WARPS):
        for u in range(first, min(first + treduce.CTA_WARPS, m1)):
            out.extend(range(max(0, WINDOW * u - f1), min(m0, WINDOW * u - f1 + WINDOW)))
    return out


def _sample_sizes():
    rng = np.random.default_rng(0)
    edges = [e + d for e in (WINDOW, WINDOW ** 2, ONE_CTA_MAX, 2 * ONE_CTA_MAX, WINDOW ** 3,
                             WINDOW ** 4) for d in (-1, 0, 1)]
    logs = np.unique(np.exp(rng.uniform(0, np.log(1e6), 150)).astype(int))
    return sorted(set(range(1, 70)) | set(edges) | {12_250, 12_561, 1_000_000}
                  | {int(v) for v in logs})


SIZES = _sample_sizes()


def test_level1_windows_tile_every_row_up_to_a_million():
    """For every n from 1 to 10⁶: level-1 window u holds the level-0
    windows [32u − f1, 32u − f1 + 32) ∩ [0, m0); consecutive windows abut,
    so they cover [0, m0) exactly once when the first starts at or before
    0, the last ends at or after m0, and none of them is empty."""
    n = np.arange(1, 10 ** 6 + 1)
    m0 = -(-n // WINDOW)
    m1 = np.array([treduce.level1_windows(int(v)) for v in n])
    np.testing.assert_array_equal(m1, -(-m0 // WINDOW))
    f1 = (WINDOW * m1 - m0) // 2
    assert (f1 >= 0).all() and (f1 < WINDOW).all()     # the first starts ≤ 0, holds one
    assert (WINDOW * m1 - f1 >= m0).all()               # the last ends ≥ m0
    assert (WINDOW * (m1 - 1) - f1 < m0).all()          # ... and holds one


def test_one_cta_route_exactly_when_the_row_fits_one_cta():
    """For every n from 1 to 10⁶: the one-CTA route is taken exactly when
    the row's level-0 windows fit in one CTA, i.e. its level-1 windows are
    at most the CTA's warps (the kernel refuses anything else)."""
    for v in range(1, 10 ** 6 + 1):
        fits = -(-v // WINDOW) <= WINDOW * treduce.CTA_WARPS
        assert treduce.one_cta(v) == fits == (treduce.level1_windows(v) <= treduce.CTA_WARPS)
    assert treduce.one_cta(ONE_CTA_MAX) and not treduce.one_cta(ONE_CTA_MAX + 1)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("rows", [1, 2, 8])
def test_split_sums_every_window_exactly_once(rows, budget):
    for size in SIZES:
        cpr = treduce.ctas_per_row(rows, size, budget)
        m0 = -(-size // WINDOW)
        got = np.concatenate([np.asarray(cta_windows(size, cpr, c), np.int64)
                              for c in range(cpr)])
        np.testing.assert_array_equal(np.bincount(got, minlength=m0), np.ones(m0),
                                      err_msg=f"n {size}, {cpr} CTAs a row")
        if cpr > 1:  # every CTA of a split row has a window
            assert all(cta_windows(size, cpr, c) for c in range(cpr))


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("rows", [1, 2, 8, 5000])
def test_ctas_per_row_fills_one_wave_at_most(rows, budget):
    for size in SIZES:
        cpr = treduce.ctas_per_row(rows, size, budget)
        m1 = treduce.level1_windows(size)
        assert cpr >= 1
        if treduce.one_cta(size):
            assert cpr == 1
            continue
        assert (cpr - 1) * treduce.CTA_WARPS < m1  # no CTA without a level-1 window
        assert rows * cpr <= max(rows, budget)      # one wave, or one CTA a row


@pytest.mark.parametrize("rows, size, ctas", [
    (2, 12_250, 6),      # f1's top-k values: 12 level-1 windows a row, 4 a CTA
    (1, 12_250, 3),
    (2, 250, 2),         # one CTA a row
    (2, 5, 2),
    (2, 4_000_000, 1056),  # 3,907 level-1 windows a row: the wave is the limit
])
def test_f1_and_the_card_tests_rows_on_an_h100_wave(rows, size, ctas):
    assert rows * treduce.ctas_per_row(rows, size, 1056) == ctas
