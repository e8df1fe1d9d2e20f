"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the ``cuda`` fixture and skips on a machine without
a card.  The file imports torch and numpy only (no JAX), so it runs on a
machine that has no JAX; ``tests/conftest.py`` imports JAX, so there run
it as ``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances, on the same device and inputs:
  * histogram and moment counts are integers: equal;
  * ``seg_binarize_apply`` is elementwise: bit-equal;
  * moment sums: the kernel and the plain version both sum in f64, in
    other orders, and round to f32 once, so they differ by at most one
    f32 ulp (2⁻²³ relative); held to ``rtol=1e-6``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flat as tflat
from repro_torch.run import RunSpec, build_run
from torch_helpers import (
    BM,
    LANES,
    coarse_ranges,
    cuda,  # noqa: F401  (fixture)
    hist_params,
    n,
    segment_layout,
    t,
    zoomed_ranges,
)

# ragged tails + an all-zero segment; and LeNet5's six segments (c1, c2,
# f1, f1b, f2, f2b in sorted-key order: 1 + 25 + 1197 + 1 + 5 + 1 blocks)
LAYOUTS = {
    "ragged": ((1000, 2 * BM * LANES + 5, 65, 3000, 17), (2,)),
    "lenet5": ((500, 25000, 1225000, 500, 5000, 10), ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("ranges", ["coarse", "zoomed"])
def test_seg_hist2side_kernel_matches_plain(cuda, layout, ranges):
    sizes, zero = LAYOUTS[layout]
    segs, xpad, sob = segment_layout(sizes, seed=10, zero_segments=zero)
    los, his = coarse_ranges(segs) if ranges == "coarse" else zoomed_ranges(segs, 11)
    x, p = t(xpad, cuda), t(hist_params(sob, los, his), cuda)
    before = tflat.seg_hist2side.launches
    got = tflat.seg_hist2side(x, p, nseg=len(segs), nbins=128)
    torch.cuda.synchronize()
    assert tflat.seg_hist2side.launches == before + 1
    want = tflat.seg_hist2side_plain(x, p, nseg=len(segs), nbins=128)
    np.testing.assert_array_equal(n(got), n(want))
    assert n(got).sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_seg_moments_kernel_matches_plain(cuda, layout):
    sizes, zero = LAYOUTS[layout]
    segs, xpad, sob = segment_layout(sizes, seed=12, zero_segments=zero)
    rng = np.random.default_rng(13)
    tp = rng.uniform(0.2, 2.0, len(segs)).astype(np.float32)
    tn = rng.uniform(0.2, 2.0, len(segs)).astype(np.float32)
    x = t(xpad, cuda)
    p = t(np.stack([sob.astype(np.float32), tp[sob], tn[sob]], axis=1), cuda)
    before = tflat.seg_moments.launches
    got = n(tflat.seg_moments(x, p, nseg=len(segs)))
    assert tflat.seg_moments.launches == before + 1
    want = n(tflat.seg_moments_plain(x, p, nseg=len(segs)))
    np.testing.assert_array_equal(got[:, :, 1], want[:, :, 1])
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6)
    # the same inputs give the same bits from run to run (no float atomics)
    again = n(tflat.seg_moments(x, p, nseg=len(segs)))
    np.testing.assert_array_equal(again.view(np.uint32), got.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_seg_binarize_apply_kernel_is_bit_equal_to_plain(cuda, layout):
    sizes, zero = LAYOUTS[layout]
    segs, xpad, sob = segment_layout(sizes, seed=14, zero_segments=zero)
    rng = np.random.default_rng(15)
    k = len(segs)
    params = np.stack([
        rng.uniform(0.2, 2.0, k)[sob], rng.uniform(0.2, 2.0, k)[sob],
        rng.standard_normal(k)[sob], (rng.uniform(size=k) > 0.5)[sob],
    ], axis=1).astype(np.float32)
    x, p = t(xpad, cuda), t(params, cuda)
    before = tflat.seg_binarize_apply.launches
    got = tflat.seg_binarize_apply(x, p)
    torch.cuda.synchronize()
    assert tflat.seg_binarize_apply.launches == before + 1
    want = tflat.seg_binarize_apply_plain(x, p)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    segs, xpad, sob = segment_layout((300, 1500), seed=16)
    x = t(xpad, cuda)
    p5 = t(hist_params(sob, *coarse_ranges(segs)), cuda)
    with pytest.raises(TypeError):
        tflat.seg_hist2side(x.double(), p5.double(), nseg=2)
    with pytest.raises(ValueError):
        tflat.seg_hist2side(x, p5.cpu(), nseg=2)  # operands on two devices
    misaligned = x.reshape(-1)[1:1 + x.numel() - LANES].reshape(-1, LANES)[:x.shape[0] - BM]
    with pytest.raises(ValueError):
        tflat.seg_binarize_apply(misaligned, t(np.zeros((p5.shape[0] - 1, 4), np.float32), cuda))


@pytest.mark.cuda
def test_wrappers_launch_on_the_operands_card(cuda):
    """Operands on the last card while card 0 is current: every kernel
    runs on the operands' card (on a one-card machine both are card 0)."""
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    sizes, zero = LAYOUTS["ragged"]
    segs, xpad, sob = segment_layout(sizes, seed=17, zero_segments=zero)
    x = t(xpad, dev)
    p5 = t(hist_params(sob, *coarse_ranges(segs)), dev)
    p3 = p5[:, [0, 1, 3]].contiguous()  # (seg, t+ = lo+, t- = lo-)
    p4 = torch.cat([p5[:, [1, 3]], p5[:, 2:3], (p5[:, :1] % 2)], 1).contiguous()
    with torch.cuda.device(0):
        got = [tflat.seg_hist2side(x, p5, nseg=len(segs)),
               tflat.seg_moments(x, p3, nseg=len(segs)),
               *tflat.seg_binarize_apply(x, p4)]
    torch.cuda.synchronize(dev)
    want = [tflat.seg_hist2side_plain(x, p5, nseg=len(segs)),
            tflat.seg_moments_plain(x, p3, nseg=len(segs)),
            *tflat.seg_binarize_apply_plain(x, p4)]
    assert all(g.device == dev for g in got)
    np.testing.assert_array_equal(n(got[0]), n(want[0]))
    np.testing.assert_array_equal(n(got[1])[:, :, 1], n(want[1])[:, :, 1])
    np.testing.assert_allclose(n(got[1])[:, :, 0], n(want[1])[:, :, 0], rtol=1e-6)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
def test_lenet5_rounds_run_through_the_kernels(cuda):
    run = build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                            flat_engine="hist", sparsity=0.01, batch=32,
                            rounds=2), device="cuda")
    state = run.init()
    tflat.reset_launches()
    for r in range(2):
        state, m = run.step(state, r)
        assert np.isfinite(float(m["loss"]))
    assert tflat.launch_counts() == {
        "seg_hist2side": 4, "seg_moments": 2, "seg_binarize_apply": 2}
    res = state["residual"]
    assert res.is_cuda and tuple(res.shape) == (1, 1, 1_259_520)
