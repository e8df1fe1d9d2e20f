"""The port's per-leaf SBC path (repro_torch.kernels.ops and its three
kernels) against the JAX package's ``repro.kernels``, run in interpret
mode on the CPU.  The cases mirror ``tests/test_kernels.py``.

On the CPU the port's wrappers run their plain PyTorch versions;
``test_torch_cuda.py`` holds the CUDA kernels against those on the card.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * ``hist2side`` counts are equal except next to a bucket edge, where
    XLA's and torch's CPU ``log2`` (one ulp apart on about a quarter of
    f32 inputs) may put an entry in the neighbouring bucket
    (``torch_helpers.assert_hist_close``).  Against the port's own oracle
    ``hist2side_ref``: equal.
  * ``masked_moments`` counts are integers: equal.  Sums: the reference
    adds in f32, the port in f64 rounded once: ``rtol=1e-6``.
  * ``binarize_apply`` is compare/select/subtract: bit-equal.
  * ``threshold_two_pass``: the thresholds are bucket edges, ``2**y``
    with ``y`` a few ulps of ``|y| ≤ 31`` apart between the two CPU
    ``log2``s, so ``rtol=2e-5`` (31 · 2⁻²³ · ln 2 · 4 ≈ 1e-5, and slack).
  * ``sbc_compress_hist``: the same selection and count; μ to ``rtol=1e-5``
    (the thresholds' tolerance does not move a selection here, the sums'
    does move μ); the residual is ``acc − ΔW*`` bit for bit.
  * ``sbc_compress_exact``: positions, count, bits, μ, ΔW* and the
    residual bit-equal (both take each side's mean in XLA's f32 order),
    and so is the oracle ``sbc_exact_ref``.
  * ``dense_to_sparse``: equal.
  * The per-leaf pipeline against the port's flat hist engine
    (``core.flat._hist_pipeline``) at ``bm=8, lanes=128``: bit for bit
    (the JAX package's ``TestHistEngine`` invariant).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.binarize_apply import binarize_apply as j_binarize_apply
from repro.kernels.hist2side import DEFAULT_BM as J_DEFAULT_BM
from repro.kernels.hist2side import DEFAULT_LANES as J_DEFAULT_LANES
from repro.kernels.hist2side import SPAN_OCTAVES
from repro.kernels.hist2side import hist2side as j_hist2side
from repro.kernels.moments import masked_moments as j_masked_moments
from repro_torch import kernels
from repro_torch.core.flat import _hist_pipeline
from repro_torch.kernels import ops, ref
from repro_torch.kernels.binarize_apply import binarize_apply, binarize_apply_plain
from repro_torch.kernels.flat import seg_absmax
from repro_torch.kernels.hist2side import (
    DEFAULT_BM,
    DEFAULT_LANES,
    LEAF_BLOCK,
    hist2side,
    hist2side_plain,
    leaf_grid_blocks,
)
from repro_torch.kernels.moments import masked_moments, masked_moments_plain
from torch_helpers import (BM, LANES, assert_hist_close, n, segment_layout, t,  # noqa: F401
                           torch_one_thread)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SHAPES = [63, 1024, 4096, 100_000, 262_145]


def _x(seed, size):
    return (np.random.default_rng(seed).standard_normal(size) * 2.0).astype(np.float32)


def _both(x, dtype):
    """The same values in both packages: f32, or rounded to bf16 by each
    (both round to nearest even); also the f32 values of what they hold."""
    if dtype == "float32":
        return jnp.asarray(x), t(x), x
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, t(x).to(torch.bfloat16), np.asarray(jx.astype(jnp.float32))


# ----------------------------------------------------------------- hist2side


@pytest.mark.parametrize("size", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hist2side_matches_jax_and_ref(size, dtype):
    jx, tx, x = _both(_x(0, size), dtype)
    absmax = float(np.abs(x).max()) + 1e-30
    lo, hi = absmax * 2.0 ** -SPAN_OCTAVES, absmax * 1.0001
    got = hist2side(tx, lo, hi, nbins=64, bm=32, lanes=128)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64)
    want = j_hist2side(jx, lo, hi, nbins=64, bm=32, lanes=128)
    f32 = np.float32
    assert_hist_close(n(got)[None], n(want)[None], [(0, size, x)],
                      np.array([[f32(lo), f32(lo)]]), np.array([[f32(hi), f32(hi)]]), 64)
    np.testing.assert_array_equal(n(got), n(ref.hist2side_ref(tx, lo, hi, nbins=64)))
    assert n(got).sum() == (x != 0).sum()


def test_hist2side_total_count():
    x = _x(1, 10_000)
    absmax = float(np.abs(x).max()) + 1e-30
    h = hist2side(t(x), absmax * 2.0 ** -SPAN_OCTAVES, absmax * 1.0001)
    assert float(h.sum()) == float((x != 0).sum())  # every non-zero lands in a bucket


def test_hist2side_per_side_ranges():
    x = np.array([0.5, -0.5, 2.0, -2.0, 0.01, -0.01], np.float32)
    lo, hi = np.array([0.4, 1.0], np.float32), np.array([1.0, 4.0], np.float32)
    got = n(hist2side(t(x), t(lo), t(hi), nbins=8, bm=8, lanes=128))
    np.testing.assert_array_equal(
        got, n(j_hist2side(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), nbins=8,
                           bm=8, lanes=128)))
    np.testing.assert_array_equal(got, n(ref.hist2side_ref(t(x), t(lo), t(hi), nbins=8)))
    assert got[0].sum() == 1 and got[1].sum() == 1  # only +0.5, only -2.0


# ------------------------------------------------------------------ moments


@pytest.mark.parametrize("size", SHAPES)
def test_masked_moments_matches_jax(size):
    x = _x(2, size)
    got = n(masked_moments(t(x), 0.7, 0.9, bm=32, lanes=128))
    want = n(j_masked_moments(jnp.asarray(x), 0.7, 0.9, bm=32, lanes=128))
    np.testing.assert_array_equal(got[:, 1], want[:, 1])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
    np.testing.assert_allclose(got, n(ref.masked_moments_ref(t(x), 0.7, 0.9)), rtol=1e-6)
    assert got[:, 1].min() > 0


def test_masked_moments_partials_change_only_the_order():
    """Other tiles give other partials and the same sums to rounding."""
    x = t(_x(3, 100_000))
    a = n(masked_moments(x, 0.7, 0.9, bm=8, lanes=128))
    b = n(masked_moments(x, 0.7, 0.9))  # the default tile, as the reference's: one partial
    np.testing.assert_array_equal(a[:, 1], b[:, 1])
    np.testing.assert_allclose(a[:, 0], b[:, 0], rtol=1e-6)
    assert (DEFAULT_BM, DEFAULT_LANES) == (J_DEFAULT_BM, J_DEFAULT_LANES)


# ----------------------------------------------------------------- binarize


@pytest.mark.parametrize("size", SHAPES)
def test_binarize_apply_is_bit_equal_to_jax(size):
    x = _x(4, size)
    for pos_wins in (1.0, 0.0):
        got = binarize_apply(t(x), 0.5, 0.6, 0.55, pos_wins, bm=32, lanes=128)
        want = j_binarize_apply(jnp.asarray(x), 0.5, 0.6, 0.55, pos_wins, bm=32, lanes=128)
        oracle = ref.binarize_apply_ref(t(x), 0.5, 0.6, 0.55, pos_wins)
        for g, w, o in zip(got, want, oracle):
            assert tuple(g.shape) == (size,)
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))
            np.testing.assert_array_equal(n(g).view(np.uint32), n(o).view(np.uint32))


def test_binarize_apply_residual_identity():
    x = t(_x(5, 5000))
    out, res = binarize_apply(x, 0.5, 0.5, 1.0, 1.0)
    assert torch.equal(res, x - out)
    np.testing.assert_allclose(n(out + res), n(x), rtol=1e-6)


# --------------------------------------------------------- the composition


@pytest.mark.parametrize("size,k", [(4096, 41), (50_000, 500), (2 ** 14 + 5, 3)])
def test_threshold_two_pass_matches_jax(size, k):
    x = _x(6, size)
    got = ops.threshold_two_pass(t(x), k)
    want = jops.threshold_two_pass(jnp.asarray(x), k)
    for g, w in zip(got, want):
        assert g.shape == () and g.dtype == torch.float32
        np.testing.assert_allclose(n(g), n(w), rtol=2e-5)


def _assert_compressed_match(got, want, x):
    np.testing.assert_array_equal(n(got.delta_star) != 0, n(want.delta_star) != 0)
    assert float(got.count) == float(want.count)
    np.testing.assert_allclose(n(got.mean), n(want.mean), rtol=1e-5)
    np.testing.assert_allclose(n(got.delta_star), n(want.delta_star), rtol=1e-5)
    np.testing.assert_allclose(n(got.nbits), n(want.nbits), rtol=1e-6)
    assert torch.equal(got.residual, t(x) - got.delta_star)  # bit for bit
    assert got.delta_star.dtype == got.residual.dtype == torch.float32


@pytest.mark.parametrize("size", [4096, 50_000])
@pytest.mark.parametrize("p", [0.05, 0.01])
def test_sbc_compress_hist_matches_jax(size, p):
    """The JAX package's test_hist_close_to_exact, on both packages: the
    same selection, and a survivor count within ±2% of k and μ within 2%
    of the exact top-k's (its band holds on Gaussian data)."""
    x = _x(7, size)
    got = ops.sbc_compress_hist(t(x), p=p)
    _assert_compressed_match(got, jops.sbc_compress_hist(jnp.asarray(x), p=p), x)
    exact = ops.sbc_compress_exact(t(x), p=p)
    k = max(1, round(p * size))
    assert abs(float(got.count) - k) <= max(2, 0.02 * k)
    assert abs(float(got.mean) - float(exact.mean)) <= 0.02 * abs(float(exact.mean))


@pytest.mark.parametrize("seed,logn", [(0, 8), (3, 10), (5, 11), (13, 12), (20, 13),
                                       (40, 14)])
def test_sbc_compress_hist_off_aligned_sizes(seed, logn):
    size = 2 ** logn + seed % 7  # off-aligned sizes exercise the guarded tail
    x = _x(seed, size)
    got = ops.sbc_compress_hist(t(x), p=0.02)
    np.testing.assert_allclose(n(got.delta_star + got.residual), x, rtol=1e-5, atol=1e-6)
    if logn <= 11:  # the JAX pipeline compiles once per size; hold a few
        _assert_compressed_match(got, jops.sbc_compress_hist(jnp.asarray(x), p=0.02), x)


@pytest.mark.parametrize("fill", ["zeros", "ones"])
def test_sbc_compress_hist_degenerate_leaves(fill):
    """All-zero (scale 1e-30, a denormal lo₀ that XLA flushes and the port
    keeps; the 1e-38 clamp makes them agree) and all-equal leaves."""
    x = np.zeros(1000, np.float32) if fill == "zeros" else np.ones(1000, np.float32)
    got = ops.sbc_compress_hist(t(x), p=0.01)
    want = jops.sbc_compress_hist(jnp.asarray(x), p=0.01)
    assert torch.isfinite(got.delta_star).all() and torch.isfinite(got.mean)
    np.testing.assert_array_equal(n(got.delta_star), n(want.delta_star))
    np.testing.assert_array_equal(n(got.residual), n(want.residual))
    assert float(got.mean) == float(want.mean) and float(got.count) == float(want.count)
    assert float(got.count) == (0.0 if fill == "zeros" else 1000.0)


def _exact_case(name):
    rng = np.random.default_rng(8)
    if name == "gaussian":
        return _x(9, 8192), 0.01
    if name == "ties":  # few distinct values: ties at the k-th value
        return rng.choice(np.array([1.0, -1.0, 0.5, -0.5, 0.25], np.float32), 5000), 0.1
    x = np.where(rng.uniform(size=400) < 0.5, np.float32(0.0), np.float32(-0.0))
    x[[7, 100, 333]] = 2.0  # signed zeros: +0 ranks above -0, lower index first
    return x.astype(np.float32), 0.025


@pytest.mark.parametrize("case", ["gaussian", "ties", "signed-zeros"])
def test_sbc_compress_exact_matches_jax_and_ref(case):
    x, p = _exact_case(case)
    got = ops.sbc_compress_exact(t(x), p=p)
    want = jops.sbc_compress_exact(jnp.asarray(x), p=p)
    np.testing.assert_array_equal(n(got.delta_star) != 0, n(want.delta_star) != 0)
    np.testing.assert_array_equal(n(got.delta_star).view(np.uint32),
                                  n(want.delta_star).view(np.uint32))
    np.testing.assert_array_equal(n(got.residual).view(np.uint32),
                                  n(want.residual).view(np.uint32))
    assert n(got.mean).view(np.uint32) == n(want.mean).view(np.uint32)
    assert float(got.count) == float(want.count) == max(1, round(p * x.size))
    assert float(got.nbits) == float(want.nbits)
    assert torch.equal(got.residual, t(x) - got.delta_star)
    k = int(got.count)
    oracle = n(ref.sbc_exact_ref(t(x), k))
    np.testing.assert_array_equal(oracle.view(np.uint32), n(got.delta_star).view(np.uint32))
    np.testing.assert_array_equal(oracle.view(np.uint32),
                                  n(jref.sbc_exact_ref(jnp.asarray(x), k)).view(np.uint32))


@pytest.mark.parametrize("positions,k_cap", [([3, 50, 99], 8), (list(range(0, 100, 9)), 5),
                                             ([], 4)], ids=["padded", "truncated", "empty"])
def test_dense_to_sparse_matches_jax(positions, k_cap):
    x = np.zeros(100, np.float32)
    x[positions] = 2.5
    idx, valid = ops.dense_to_sparse(t(x), k_cap=k_cap)
    j_idx, j_valid = jops.dense_to_sparse(jnp.asarray(x), k_cap=k_cap)
    assert idx.dtype == torch.int32 and valid.dtype == torch.float32
    np.testing.assert_array_equal(n(idx), n(j_idx))
    np.testing.assert_array_equal(n(valid), n(j_valid))


# ----------------------------------------------- the port's own invariants


def test_per_leaf_pipeline_equals_the_flat_hist_engine():
    """Per segment, ``sbc_compress_hist`` at ``bm=8, lanes=128`` equals the
    flat hist engine's ΔW*, residual, μ and count bit for bit: the same
    partials in the same fold order (the JAX package's TestHistEngine)."""
    sizes, rate, nbins = (5600, 2 * BM * LANES + 5, 333, 17, 50, 40_000), 0.05, 32
    segs, xpad, sob = segment_layout(sizes, seed=11, zero_segments=(4,))
    acc = t(xpad).reshape(-1)
    ks = [max(1, min(s, int(round(rate * s)))) for s in sizes]
    bounds = [(o, s) for o, s, _ in segs]
    out, res, stats = _hist_pipeline(acc, bounds, ks, [rate] * len(sizes),
                                     t(sob.astype(np.int64)), len(sob), BM, LANES, nbins,
                                     absmax=seg_absmax(acc, bounds))
    for i, (o, s, _) in enumerate(segs):
        got = ops.sbc_compress_hist(acc[o:o + s], p=rate, nbins=nbins, bm=BM, lanes=LANES)
        for g, w in ((got.delta_star, out[o:o + s]), (got.residual, res[o:o + s]),
                     (got.mean, stats["mu"][i]), (got.count, stats["count"][i])):
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32),
                                          err_msg=f"segment {i}")


def test_plain_versions_follow_the_wrappers_rules():
    """The plain versions are what a CPU tensor runs: the wrappers return
    their results, take bf16 as f32, and leave the launch counts at 0."""
    kernels.reset_launches()
    x = t(_x(12, 3000))
    lo, hi = t(np.array([0.1, 0.2], np.float32)), t(np.array([4.0, 5.0], np.float32))
    np.testing.assert_array_equal(n(hist2side(x, lo, hi)), n(hist2side_plain(x, lo, hi)))
    assert torch.equal(masked_moments(x, 0.7, 0.9), masked_moments_plain(x, 0.7, 0.9))
    for g, w in zip(binarize_apply(x, 0.5, 0.6, -0.7, 0.0),
                    binarize_apply_plain(x, 0.5, 0.6, -0.7, 0.0)):
        assert torch.equal(g, w)
    xb = x.to(torch.bfloat16)
    assert torch.equal(masked_moments(xb, 0.7, 0.9), masked_moments(xb.float(), 0.7, 0.9))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("bad", ["int", "2-D", "strided", "empty", "lo-shape"])
def test_wrappers_reject_bad_operands(bad):
    x = t(_x(13, 64))
    args = {"int": (x.to(torch.int32), 0.1, 1.0), "2-D": (x.reshape(8, 8), 0.1, 1.0),
            "strided": (x[::2], 0.1, 1.0), "empty": (x[:0], 0.1, 1.0),
            "lo-shape": (x, torch.zeros(3), 1.0)}[bad]
    error = TypeError if bad == "int" else ValueError
    with pytest.raises(error):
        hist2side(*args)
    with pytest.raises(error):
        masked_moments(*args)
    with pytest.raises(error):
        binarize_apply(*args, 0.5, 1.0)


@pytest.mark.parametrize("size, blocks", [(1, 1), (1024, 1), (2048, 1), (2049, 2),
                                          (1_225_000, 599), (2 ** 31 - 2 ** 20, 1_048_064)])
def test_leaf_grid_gives_each_cta_about_two_blocks(size, blocks):
    """The CUDA histogram's grid over a leaf is sized for half its blocks of
    LEAF_BLOCK entries (f1: 1,197 blocks, 599 CTAs where the card holds
    them): no CTA is without a block, and none has more than two."""
    nblocks = -(-size // LEAF_BLOCK)
    grid = leaf_grid_blocks(size)
    assert grid == blocks
    per_cta = [(c + 1) * nblocks // grid - c * nblocks // grid for c in range(min(grid, 5000))]
    assert 1 <= min(per_cta) and max(per_cta) <= 2
