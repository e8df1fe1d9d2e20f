"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here takes the ``cuda`` fixture and skips on a machine without
a card.  The file imports torch and numpy only (no JAX), so it runs on a
machine that has no JAX; ``tests/conftest.py`` imports JAX, so there run
it as ``PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances, on the same device and inputs:
  * histogram and moment counts are integers: equal;
  * ``seg_binarize_apply`` is elementwise: bit-equal;
  * the wire packers ``seg_packbits`` and ``seg_select_pack`` are integer
    bit work: words and bit counts equal, and equal to the host Golomb
    encoder's bytes;
  * moment sums: the kernel and the plain version both sum in f64 and
    round to f32 once, so any two f64 orders differ by at most one f32
    ulp (2⁻²³ relative): held to ``rtol=1e-6``.  The plain versions
    repeat the kernels' order step by step, so they also agree bit for
    bit (``test_moment_kernels_are_bit_equal_to_plain``).

The per-leaf kernels (``hist2side``, ``masked_moments``,
``binarize_apply``) are held the same way, on unpadded leaves of any
length, at offsets that are not 16-byte aligned, and on all-zero,
all-equal and bf16 leaves; ``sbc_compress_hist`` must not wait for the
card (``torch.cuda.set_sync_debug_mode("error")``).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.flat import _top_k
from repro_torch.core.golomb import encode_positions_packed, golomb_bstar, packed_words_to_bytes
from repro_torch.core.flat import _hist_pipeline
from repro_torch.kernels import binarize_apply as tbin
from repro_torch.kernels import flat as tflat
from repro_torch.kernels import hist2side as thist
from repro_torch.kernels import moments as tmom
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
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


# --------------------------------------------------------------- packers


@pytest.mark.cuda
@pytest.mark.parametrize("planes", ["bits", "full-words", "exact-path-shape"])
def test_seg_packbits_kernel_matches_plain(cuda, planes):
    rng = np.random.default_rng(20)
    if planes == "full-words":  # any u32 value: bits shifted past bit 31 are lost
        x = rng.integers(0, 2 ** 32, (32, 1024), dtype=np.uint64).astype(np.uint32)
    else:  # 0/1 planes; LeNet5's exact path folds 3,456 words
        x = rng.integers(0, 2, (32, 3456 if planes == "exact-path-shape" else 1024)
                         ).astype(np.uint32)
    p = t(x.view(np.int32), cuda)
    before = tpack.seg_packbits.launches
    got = tpack.seg_packbits(p)
    torch.cuda.synchronize()
    assert tpack.seg_packbits.launches == before + 1
    assert got.is_cuda and got.dtype == torch.uint32
    np.testing.assert_array_equal(n(got), n(tpack.seg_packbits_plain(p)))


def _pack_rows():
    """``(id, n, k, p, masks int32[rows, n])``: adversarial rows and one
    row at the size of LeNet5's f1 segment."""
    rng = np.random.default_rng(21)
    cases = []
    for p in (0.01, 0.05, 0.5):  # b* = 6, 4, 0
        step = 1 << golomb_bstar(p)
        rows = {
            "first": [[0]], "last": [[999]], "all": [list(range(1000))],
            "gap-multiple": [list(range(2 * step, 1000, 2 * step + 1))],
            "gap-pow2": [list(range(step - 1, 1000, step))],
            "random": [sorted(rng.choice(1000, 37, replace=False)) for _ in range(5)],
        }
        for name, pos in rows.items():
            m = np.zeros((len(pos), 1000), np.int32)
            for r, row in enumerate(pos):
                m[r, row] = 1
            cases.append((f"{name}-p{p}", len(pos[0]), p, m))
    m = np.zeros((1, 1_225_000), np.int32)
    m[0, rng.choice(1_225_000, 12_250, replace=False)] = 1
    cases.append(("lenet5-f1", 12_250, 0.01, m))
    return cases


PACK_ROWS = _pack_rows()


@pytest.mark.cuda
@pytest.mark.parametrize("case", PACK_ROWS, ids=[c[0] for c in PACK_ROWS])
def test_seg_select_pack_kernel_matches_plain_and_the_host_bytes(cuda, case):
    _, k, p, masks = case
    b = golomb_bstar(p)
    m = t(masks, cuda)
    before = tpack.seg_select_pack.launches
    words, nbits = tpack.seg_select_pack(m, k=k, bstar=b)
    torch.cuda.synchronize()
    assert tpack.seg_select_pack.launches == before + 1
    want_w, want_nb = tpack.seg_select_pack_plain(m, k=k, bstar=b)
    np.testing.assert_array_equal(n(words), n(want_w))
    np.testing.assert_array_equal(n(nbits), n(want_nb))
    for r in range(masks.shape[0]):
        host, host_nb = encode_positions_packed(np.flatnonzero(masks[r]), p)
        assert int(nbits[r]) == host_nb
        assert packed_words_to_bytes(n(words)[r], host_nb) == host
    # the same words from run to run (atomicOr is order-free)
    again, _ = tpack.seg_select_pack(m, k=k, bstar=b)
    np.testing.assert_array_equal(n(again), n(words))


@pytest.mark.cuda
def test_seg_select_pack_kernel_rows_with_other_counts(cuda):
    """More than k set slots: the first k are packed, as the plain version
    (and the reference's dropping scatter) does.  Fewer than k: nbits is
    −1, since the reference's result is undefined there."""
    rng = np.random.default_rng(22)
    masks = (rng.uniform(size=(3, 500)) < 0.05).astype(np.int32)
    counts = masks.sum(1)
    k = int(counts.min())
    m = t(masks, cuda)
    words, nbits = tpack.seg_select_pack(m, k=k, bstar=4)
    want_w, want_nb = tpack.seg_select_pack_plain(m, k=k, bstar=4)
    np.testing.assert_array_equal(n(words), n(want_w))
    np.testing.assert_array_equal(n(nbits), n(want_nb))
    _, short = tpack.seg_select_pack(m, k=int(counts.max()) + 1, bstar=4)
    assert n(short).tolist() == [-1, -1, -1]


@pytest.mark.cuda
def test_pack_wrappers_raise_instead_of_falling_back(cuda):
    with pytest.raises(TypeError):
        tpack.seg_packbits(torch.zeros((32, 128), device=cuda))
    with pytest.raises(ValueError):
        tpack.seg_packbits(torch.zeros((32, 100), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        tpack.seg_select_pack(torch.ones((2, 10), dtype=torch.int32, device=cuda), k=11,
                              bstar=0)
    with pytest.raises(TypeError):
        tpack.seg_select_pack(torch.ones((2, 10), device=cuda), k=1, bstar=0)


@pytest.mark.cuda
def test_pack_wrappers_launch_on_the_operands_card(cuda):
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    rng = np.random.default_rng(23)
    planes = t(rng.integers(0, 2, (32, 256)).astype(np.int32), dev)
    masks = np.zeros((2, 700), np.int32)
    masks[:, rng.choice(700, 7, replace=False)] = 1
    m = t(masks, dev)
    with torch.cuda.device(0):
        words = tpack.seg_packbits(planes)
        sw, snb = tpack.seg_select_pack(m, k=7, bstar=6)
    torch.cuda.synchronize(dev)
    assert words.device == sw.device == snb.device == dev
    np.testing.assert_array_equal(n(words), n(tpack.seg_packbits_plain(planes)))
    want_w, want_nb = tpack.seg_select_pack_plain(m, k=7, bstar=6)
    np.testing.assert_array_equal(n(sw), n(want_w))
    np.testing.assert_array_equal(n(snb), n(want_nb))


@pytest.mark.cuda
def test_exact_top_k_on_the_card_orders_as_on_the_cpu(cuda):
    """The stable sort of total-order keys gives the same tie order (lower
    index first, +0 above −0) on the card as on the CPU."""
    rng = np.random.default_rng(24)
    x = rng.choice(np.array([0.0, -0.0, 1.0, -1.0, 0.5], np.float32), size=(3, 200_000))
    for sign in (1, -1):
        for k in (1, 2000):
            got = _top_k(t(sign * x, cuda), k)[1]
            want = _top_k(t(sign * x), k)[1]
            np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.cuda
def test_exact_rounds_run_through_the_packer(cuda):
    run = build_run(RunSpec(preset="lenet5", backend="gspmd", fast=True,
                            flat_engine="exact", device_pack=True, measure_wire=True,
                            sparsity=0.01, batch=32, rounds=2), device="cuda")
    state = run.init()
    kernels.reset_launches()
    nbits = []
    step = run.fns.train_step

    def observed(state, batch):
        state, m = step(state, batch)
        nbits.append(int(m["packed_nbits"].sum()))
        return state, m

    run.fns = run.fns._replace(train_step=observed)
    for r in range(2):
        state, m = run.step(state, r)
        assert np.isfinite(float(m["loss"]))
    assert kernels.launch_counts() == {
        "seg_hist2side": 0, "seg_moments": 0, "seg_binarize_apply": 0,
        "seg_packbits": 2, "seg_select_pack": 0, "hist2side": 0, "masked_moments": 0,
        "binarize_apply": 0}
    n_mu = run.fns.flat_space.n_mu
    assert [r.up_bits_measured for r in run.ledger.records] == [b + 32.0 * n_mu for b in nbits]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_moment_kernels_are_bit_equal_to_plain(cuda, layout):
    """The plain versions add in the kernels' order: the same f64 sums."""
    sizes, zero = LAYOUTS[layout]
    segs, xpad, sob = segment_layout(sizes, seed=25, zero_segments=zero)
    x = t(xpad, cuda)
    p = t(np.stack([sob.astype(np.float32), np.full(sob.shape, 0.3, np.float32),
                    np.full(sob.shape, 0.4, np.float32)], axis=1), cuda)
    got = n(tflat.seg_moments(x, p, nseg=len(segs)))
    want = n(tflat.seg_moments_plain(x, p, nseg=len(segs)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    leaf = x.reshape(-1)[segs[-1][0]:segs[-1][0] + segs[-1][1]]
    for bm, lanes in ((8, 128), (256, 1024)):
        got = n(tmom.masked_moments(leaf, 0.3, 0.4, bm=bm, lanes=lanes))
        want = n(tmom.masked_moments_plain(leaf, 0.3, 0.4, bm=bm, lanes=lanes))
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ------------------------------------------------------- per-leaf kernels

LEAF_CASES = ("63", "1024", "4096", "100000", "262145", "offset", "zeros", "ones", "bf16")


def _leaf(case, dev):
    """A leaf for ``case``: a Gaussian of that size, a view one element
    into a buffer (not 16-byte aligned), an all-zero or all-equal leaf,
    or bf16 values."""
    rng = np.random.default_rng(26)
    if case == "offset":
        base = t((rng.standard_normal(100_002) * 2.0).astype(np.float32), dev)
        x = base[1:]
        assert x.data_ptr() % 16 != 0
        return x
    if case in ("zeros", "ones"):
        return torch.full((5000,), 0.0 if case == "zeros" else 1.0, device=dev)
    if case == "bf16":
        return t((rng.standard_normal(70_001) * 2.0).astype(np.float32), dev).to(torch.bfloat16)
    return t((rng.standard_normal(int(case)) * 2.0).astype(np.float32), dev)


def _leaf_ranges(x):
    """The coarse pass's ranges and a zoomed per-side pair, as the
    pipeline computes them."""
    scale = x.float().abs().amax() + 1e-30
    zoom_lo = torch.stack([scale * 0.25, scale * 0.3])
    return (scale * 2.0 ** -30, scale * 1.0001), (zoom_lo, zoom_lo * 1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEAF_CASES)
def test_hist2side_kernel_matches_plain(cuda, case):
    x = _leaf(case, cuda)
    for lo, hi in _leaf_ranges(x):
        before = thist.hist2side.launches
        got = thist.hist2side(x, lo, hi, nbins=128)
        torch.cuda.synchronize()
        assert thist.hist2side.launches == before + 1
        want = thist.hist2side_plain(x, lo, hi, nbins=128)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 128)
        np.testing.assert_array_equal(n(got), n(want))
    lo, hi = (float(v) for v in _leaf_ranges(x)[0])  # numbers, not tensors
    coarse = n(thist.hist2side(x, lo, hi))
    np.testing.assert_array_equal(coarse, n(thist.hist2side_plain(x, lo, hi)))
    assert coarse.sum() == int((x != 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEAF_CASES)
def test_masked_moments_kernel_matches_plain(cuda, case):
    x = _leaf(case, cuda)
    for bm, lanes in ((8, 128), (256, 1024)):
        before = tmom.masked_moments.launches
        got = n(tmom.masked_moments(x, 0.7, 0.5, bm=bm, lanes=lanes))
        assert tmom.masked_moments.launches == before + 1
        want = n(tmom.masked_moments_plain(x, 0.7, 0.5, bm=bm, lanes=lanes))
        np.testing.assert_array_equal(got[:, 1], want[:, 1])
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-6)
        again = n(tmom.masked_moments(x, 0.7, 0.5, bm=bm, lanes=lanes))
        np.testing.assert_array_equal(again.view(np.uint32), got.view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEAF_CASES)
def test_binarize_apply_kernel_is_bit_equal_to_plain(cuda, case):
    x = _leaf(case, cuda)
    for mu, side in ((0.55, 1.0), (-0.8, 0.0)):
        before = tbin.binarize_apply.launches
        got = tbin.binarize_apply(x, 0.5, 0.6, mu, side)
        torch.cuda.synchronize()
        assert tbin.binarize_apply.launches == before + 1
        want = tbin.binarize_apply_plain(x, 0.5, 0.6, mu, side)
        for g, w in zip(got, want):
            assert tuple(g.shape) == (x.numel(),) and g.dtype == torch.float32
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
def test_leaf_wrappers_raise_instead_of_falling_back(cuda):
    x = torch.randn(4096, device=cuda)
    for bad, error in ((x.to(torch.int32), TypeError), (x.reshape(64, 64), ValueError),
                       (x[::2], ValueError), (x[:0], ValueError)):
        with pytest.raises(error):
            thist.hist2side(bad, 0.1, 1.0)
        with pytest.raises(error):
            tmom.masked_moments(bad, 0.1, 1.0)
        with pytest.raises(error):
            tbin.binarize_apply(bad, 0.1, 1.0, 0.5, 1.0)
    with pytest.raises(ValueError):
        thist.hist2side(x, torch.zeros(3, device=cuda), 1.0)
    with pytest.raises(ValueError):
        thist.hist2side(x, 0.1, 1.0, nbins=5000)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["100000", "offset", "zeros", "ones"])
def test_sbc_compress_hist_runs_the_kernels_without_a_host_sync(cuda, case, monkeypatch):
    x = _leaf(case, cuda)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tops.sbc_compress_hist(x, p=0.01, bm=8, lanes=128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = kernels.launch_counts()
    assert (counts["hist2side"], counts["masked_moments"], counts["binarize_apply"]) == (2, 1, 1)
    assert sum(counts.values()) == 4
    for name, fn in (("hist2side", thist.hist2side_plain),
                     ("masked_moments", tmom.masked_moments_plain),
                     ("binarize_apply", tbin.binarize_apply_plain)):
        monkeypatch.setattr(tops, name, fn)
    want = tops.sbc_compress_hist(x, p=0.01, bm=8, lanes=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))
    assert torch.equal(got.residual, x - got.delta_star)


@pytest.mark.cuda
def test_per_leaf_pipeline_equals_the_flat_hist_engine(cuda):
    sizes, zero = LAYOUTS["lenet5"]
    segs, xpad, sob = segment_layout(sizes, seed=27, zero_segments=zero)
    acc = t(xpad, cuda).reshape(-1)
    ks = [max(1, min(s, int(round(0.01 * s)))) for s in sizes]
    out, res, stats = _hist_pipeline(acc, [(o, s) for o, s, _ in segs], ks,
                                     [0.01] * len(sizes), t(sob.astype(np.int64), cuda),
                                     len(sob), BM, LANES, 128)
    for i, (o, s, _) in enumerate(segs):
        got = tops.sbc_compress_hist(acc[o:o + s], p=0.01, bm=BM, lanes=LANES)
        for g, w in ((got.delta_star, out[o:o + s]), (got.residual, res[o:o + s]),
                     (got.mean, stats["mu"][i]), (got.count, stats["count"][i])):
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))
