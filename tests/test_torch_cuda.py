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

``f32_mean_xla`` (XLA's f32 reduce order) is a chain of f32 adds in a
fixed order, built with ``-fmad=false``: bit-equal to its plain version,
and the device-packed SBW1 wire (``Wire.pack_device``, one
``seg_select_pack`` per Golomb leaf) gives the host pack's bytes.

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
from repro_torch.kernels import _build
from repro_torch.kernels import flat as tflat
from repro_torch.kernels import hist2side as thist
from repro_torch.kernels import moments as tmom
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pack as tpack
from repro_torch.kernels import reduce as treduce
from repro_torch.run import RunSpec, build_run
from torch_helpers import (
    BM,
    LANES,
    coarse_ranges,
    cuda,  # noqa: F401  (fixture)
    hist_params,
    load_chip_smoke,
    n,
    segment_layout,
    t,
    zoomed_ranges,
)

# ragged tails + an all-zero segment; LeNet5's six segments (c1, c2, f1,
# f1b, f2, f2b in sorted-key order: 1 + 25 + 1197 + 1 + 5 + 1 blocks); and
# ResNet-32's 97
def _resnet32_sizes() -> tuple:
    """ResNet-32's 97 leaf sizes in leaf order (66 under 1,024 entries)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.tree import tree_flatten
    from repro_torch.models.model import build_model

    tree = build_model(get_config("resnet32")).init(torch.Generator().manual_seed(0))
    return tuple(v.numel() for v in tree_flatten(tree)[0])


LAYOUTS = {
    "ragged": ((1000, 2 * BM * LANES + 5, 65, 3000, 17), (2,)),
    "lenet5": ((500, 25000, 1225000, 500, 5000, 10), ()),
    # ResNet-32's 97 segments, most of 16-64 entries, each in a block of its own
    "resnet32": (_resnet32_sizes(), ()),
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
        "seg_hist2side": 4, "seg_moments": 2, "seg_binarize_apply": 2, "seg_accumulate": 2}
    res = state["residual"]
    assert res.is_cuda and tuple(res.shape) == (1, 1, 1_259_520)


def _accumulate_case(case: str, dev):
    """``(leaves, res, bounds, n_pad, bm, lanes)`` of a seg_accumulate case:
    LeNet5's six odd sizes, a leaf at an offset that is not 16-byte
    aligned, no residual, NaN/inf/-0.0/denormals, bf16 leaves, 500
    segments (past one launch's 224), and blocks of 256 and 2,048 entries
    (fewer quads than a CTA's threads, and more)."""
    rng = np.random.default_rng(40)
    bm, lanes = {"small-blocks": (2, 128), "large-blocks": (16, 128)}.get(case, (BM, LANES))
    sizes = {"segments-500": tuple(int(v) for v in rng.integers(1, 3000, 500)),
             "offset": (1000, 77777, 3)}.get(case, LAYOUTS["lenet5"][0])
    block, bounds, off = bm * lanes, [], 0
    for size in sizes:
        bounds.append((off, size))
        off += max(1, -(-size // block)) * block
    leaves = [t((rng.standard_normal(s) * np.exp(rng.standard_normal(s))).astype(np.float32), dev)
              for s in sizes]
    if case == "offset":  # the middle leaf a view one entry into a buffer
        whole = t(rng.standard_normal(sizes[1] + 1).astype(np.float32), dev)
        leaves[1] = whole[1:]
        assert leaves[1].data_ptr() % 16
    if case == "specials":
        leaves[0][:6] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 1e-40,
                                      -3e-39])
        leaves[3][:] = torch.where(leaves[3] > 0, -0.0, 2e-41)
        leaves[4][7] = float("-inf")
    if case == "bf16":
        leaves = [x.to(torch.bfloat16) for x in leaves]
    res = None
    if case != "no-residual":
        res = t((rng.standard_normal(off) * 1e-2).astype(np.float32), dev)
        if case == "specials":
            res[bounds[3][0]:bounds[3][0] + bounds[3][1]] = 0.0
            res[1:3] = torch.tensor([-0.0, 1e-39])
    return leaves, res, bounds, off, bm, lanes


ACCUMULATE_CASES = ("lenet5", "offset", "no-residual", "specials", "bf16", "segments-500",
                    "small-blocks", "large-blocks")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ACCUMULATE_CASES)
def test_seg_accumulate_kernel_is_bit_equal_to_plain(cuda, case):
    """``acc`` and each segment's max bit for bit against the plain version
    on the card, one launch per 224 leaves, no host sync, and the
    workspace left zero (a second call gives the same bits)."""
    leaves, res, bounds, n_pad, bm, lanes = _accumulate_case(case, cuda)
    torch.cuda.synchronize()
    tflat.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [tflat.seg_accumulate(leaves, res, bounds, n_pad, bm=bm, lanes=lanes)
               for _ in range(2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tflat.seg_accumulate.launches == 2 * -(-len(bounds) // tflat.ACC_LEAVES_PER_LAUNCH)
    want = tflat.seg_accumulate_plain(leaves, res, bounds, n_pad)
    for acc, absmax in got:
        for g, w in ((acc, want[0]), (absmax, want[1])):
            assert g.is_cuda and g.dtype == torch.float32 and g.shape == w.shape
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))
    if case == "specials":
        assert np.isnan(n(want[1])[0]) and 0 < n(want[1])[3] < np.finfo(np.float32).tiny


def _lm100m_space(dev):
    """lm-100m's leaves at full width (137,841,408 entries) as one
    client's sharded flat space, one device a client, p 0.001."""
    from repro_torch.core.flat import ShardedFlatParamSpace
    from repro_torch.core.tree import tree_flatten
    from repro_torch.launch.mesh import make_host_group
    from repro_torch.models.model import build_model
    from repro_torch.run.presets import lm_100m_config

    with torch.device("meta"):
        shapes = [tuple(v.shape) for v in tree_flatten(
            build_model(lm_100m_config()).init(torch.Generator()))[0]]
    entries = [dict(path=str(i), shape=s, rows=1, kind="sparse", rate=0.001, n_shards=1,
                    global_size=int(np.prod(s))) for i, s in enumerate(shapes)]
    return ShardedFlatParamSpace.build(
        entries, client_axes=("data",), shard_axes=("model",), n_clients=1,
        shards_per_client=1, group=make_host_group(dev))


def _two_device_space(dev):
    from repro_torch.core.flat import ShardedFlatParamSpace
    from repro_torch.launch.mesh import make_host_group

    return ShardedFlatParamSpace.build(
        [dict(path="w", shape=(64, 1000), rows=1, kind="sparse", rate=0.01, n_shards=2,
              global_size=128_000, grid=(2,), dev_block=(0, 1)),
         dict(path="b", shape=(300,), rows=1, kind="sparse", rate=0.05, n_shards=2,
              global_size=600, grid=(2,), dev_block=(0, 1))],
        client_axes=("data",), shard_axes=("model",), n_clients=1, shards_per_client=2,
        group=make_host_group(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["lm-100m", "two-devices"])
def test_exchange_local_hist_front_is_bit_identical_to_the_composition(cuda, layout):
    """The hist exchange's mean, own and residual against the composition
    it ran before the fused front (flatten, ``res +``, ``seg_absmax``,
    then the pipeline), bit for bit: at lm-100m's full width through one
    ``seg_accumulate``, and on two devices a client without it."""
    space = _lm100m_space(cuda) if layout == "lm-100m" else _two_device_space(cuda)
    S = space.shards_per_client
    gen = torch.Generator(device=cuda).manual_seed(41)
    whole = lambda s: tuple(g * d for g, d in zip(s.grid + (1,) * len(s.shape), s.shape))
    bodies = [torch.randn(whole(s), generator=gen, device=cuda) * 1e-3 for s in space.segments]
    res = torch.randn(space.local_shape, generator=gen, device=cuda) * 1e-4
    torch.cuda.synchronize()
    kernels.reset_launches()
    mean, own, new_res = space.exchange_local_hist(bodies, res)
    counts = kernels.launch_counts()
    assert (counts["seg_accumulate"], counts["seg_hist2side"]) == ((1, 2) if S == 1 else (0, 2))
    acc = res + space.flatten_local(bodies)
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    want_own, want_res, _ = _hist_pipeline(
        acc, bounds, [s.k for s in space.segments], [s.rate for s in space.segments],
        torch.from_numpy(space.seg_of_block.astype(np.int64)).to(cuda), space.n_blocks,
        space.bm, space.lanes, 128, absmax=tflat.seg_absmax(acc, bounds))
    assert mean is own and bool((own != 0).any())
    for g, w in ((own, want_own), (new_res, want_res)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
def test_nccl_group_of_one_returns_its_input(cuda, tmp_path):
    """A real NCCL process group of one rank: its gather and mean return
    their input bit for bit, and a LeNet5 round through it equals one
    without a group."""
    from repro_torch.launch.mesh import ClientGroup

    group = ClientGroup.connect(rank=0, world=1, device=cuda, backend="nccl",
                                init_method=f"file://{tmp_path}/store")
    try:
        x = torch.randn(1000, device=cuda)
        w = torch.arange(77, dtype=torch.int32, device=cuda).view(torch.uint32)
        assert torch.equal(group.all_gather_rows(x)[0].view(torch.int32), x.view(torch.int32))
        assert torch.equal(group.pmean(x).view(torch.int32), x.view(torch.int32))
        assert torch.equal(group.all_gather_rows(w).view(torch.int32)[0], w.view(torch.int32))
        spec = RunSpec(preset="lenet5", backend="gspmd", fast=True, flat_engine="exact",
                       device_pack=True, measure_wire=True, sparsity=0.01, batch=32)
        saved, torch.backends.cudnn.deterministic = torch.backends.cudnn.deterministic, True
        try:
            states = []
            for g in (None, group):
                run = build_run(spec, device="cuda", group=g)
                state, _ = run.step(run.init(), 0)
                states.append(state)
        finally:
            torch.backends.cudnn.deterministic = saved
        for k, v in states[0]["params"].items():
            assert torch.equal(v.view(torch.int32), states[1]["params"][k].view(torch.int32))
        assert torch.equal(states[0]["residual"], states[1]["residual"])
    finally:
        group.close()


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
    # rows split over tiles of T slots (the kernel's tiles)
    T = tpack.TILE_SLOTS
    for p in (0.01, 0.05, 0.5):
        n_slots = 10 * T + 123
        m = np.zeros((2, n_slots), np.int32)
        m[0, [3, 2 * T + 7, 6 * T + 1, 9 * T + 5, n_slots - 1]] = 1  # runs over empty tiles
        m[1, [T - 1, T, 2 * T - 1, 2 * T, 8 * T]] = 1  # each side of tile edges
        cases.append((f"tiles-empty-stretch-and-edges-p{p}", 5, p, m))
        m = np.zeros((4, 5 * T + 17), np.int32)  # several multi-tile rows in one call
        for r in range(4):
            m[r, rng.choice(5 * T + 17, 400, replace=False)] = 1
        cases.append((f"tiles-four-rows-p{p}", 400, p, m))
    cases.append(("tiles-k-eq-n-b0", 3 * T + 5, 0.5, np.ones((2, 3 * T + 5), np.int32)))
    m = np.zeros((1, 3 * T), np.int32)
    m[0, -1] = 1
    cases.append(("tiles-k1-last-slot", 1, 0.01, m))
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
@pytest.mark.parametrize("tiles", [1, 7])
def test_seg_select_pack_split_rows_with_other_counts(cuda, tiles):
    """Rows over one and over several tiles, with more and fewer than k
    set slots spread across the tiles: the first k are packed; fewer than
    k give nbits −1 and words zero past the slots there are."""
    rng = np.random.default_rng(25)
    n_slots = tiles * tpack.TILE_SLOTS - 3
    masks = (rng.uniform(size=(3, n_slots)) < 0.01).astype(np.int32)
    counts = masks.sum(1)
    k = int(counts.min()) - 1
    m = t(masks, cuda)
    words, nbits = tpack.seg_select_pack(m, k=k, bstar=6)
    want_w, want_nb = tpack.seg_select_pack_plain(m, k=k, bstar=6)
    np.testing.assert_array_equal(n(words), n(want_w))
    np.testing.assert_array_equal(n(nbits), n(want_nb))
    masks[1, : n_slots // 2] = 0  # row 1 now holds fewer than k
    m = t(masks, cuda)
    words, nbits = tpack.seg_select_pack(m, k=k, bstar=6)
    short = int(masks[1].sum())
    assert short < k and int(nbits[1]) == -1
    assert n(nbits)[[0, 2]].tolist() == n(want_nb)[[0, 2]].tolist()
    alone, _ = tpack.seg_select_pack_plain(m[1:2], k=short, bstar=6)
    row = np.zeros(words.shape[1], np.uint32)
    row[:alone.shape[1]] = n(alone)[0]
    np.testing.assert_array_equal(n(words)[1], row)


def _select_pack_calls():
    """Masks of several shapes and b*: ``(mask, k, b*)``."""
    rng = np.random.default_rng(26)
    out = []
    for rows, n_slots, k, b in ((1, 1_225_000, 12_250, 6), (3, 1000, 37, 4),
                                (2, 5 * tpack.TILE_SLOTS + 9, 300, 0), (1, 50, 0, 6)):
        m = np.zeros((rows, n_slots), np.int32)
        for r in range(rows):
            m[r, rng.choice(n_slots, k, replace=False)] = 1
        out.append((m, k, b))
    return out


def _assert_select_pack_equals_plain(m, k, b):
    words, nbits = tpack.seg_select_pack(m, k=k, bstar=b)
    want_w, want_nb = tpack.seg_select_pack_plain(m, k=k, bstar=b)
    np.testing.assert_array_equal(n(words), n(want_w))
    np.testing.assert_array_equal(n(nbits), n(want_nb))
    return words, nbits


@pytest.mark.cuda
def test_seg_select_pack_leaves_nothing_behind(cuda):
    """Calls of other shapes in a row and again: every call equals the plain
    version, so no tile state, piece or counter carries over."""
    calls = [(t(m, cuda), k, b) for m, k, b in _select_pack_calls()]
    for _ in range(2):
        for m, k, b in calls:
            _assert_select_pack_equals_plain(m, k, b)
    for m, k, b in reversed(calls):
        _assert_select_pack_equals_plain(m, k, b)


@pytest.mark.cuda
def test_seg_select_pack_on_a_second_stream(cuda):
    m, k, b = _select_pack_calls()[0]
    m = t(m, cuda)
    want = _assert_select_pack_equals_plain(m, k, b)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = _assert_select_pack_equals_plain(m, k, b)
    side.synchronize()
    assert (cuda.type, torch.cuda.current_device(), side.cuda_stream) in _build.WORKSPACE.buffers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
def test_seg_select_pack_under_cuda_graph_capture(cuda):
    """Captured once, replayed on new masks: each replay gives the plain
    version's words and bit counts on the masks it saw."""
    rng = np.random.default_rng(27)
    n_slots, k, b = 3 * tpack.TILE_SLOTS + 11, 250, 4

    def masks():
        m = np.zeros((2, n_slots), np.int32)
        for r in range(2):
            m[r, rng.choice(n_slots, k, replace=False)] = 1
        return t(m, cuda)

    m = masks()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        _assert_select_pack_equals_plain(m, k, b)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        words, nbits = tpack.seg_select_pack(m, k=k, bstar=b)
    for _ in range(2):
        m.copy_(masks())
        graph.replay()
        torch.cuda.synchronize()
        want_w, want_nb = tpack.seg_select_pack_plain(m, k=k, bstar=b)
        np.testing.assert_array_equal(n(words), n(want_w))
        np.testing.assert_array_equal(n(nbits), n(want_nb))
    with torch.cuda.stream(side):  # the stream's own workspace is still zero
        _assert_select_pack_equals_plain(m, k, b)
    side.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact-path-shape", "ragged", "one-bit", "full-words"])
def test_seg_packbits_stream_kernel_matches_plain(cuda, case):
    """The stream-order entry: LeNet5's exact path packs 107,456 bits
    (3,358 words); ragged lengths end inside a word and inside a warp's 32
    words; any u32 value is placed as the planes entry places it."""
    rng = np.random.default_rng(28)
    nbits = {"exact-path-shape": 32 * 3358, "ragged": 32 * 1000 * 3 + 17, "one-bit": 1,
             "full-words": 32 * 333}[case]
    if case == "full-words":
        x = rng.integers(0, 2 ** 32, nbits, dtype=np.uint64).astype(np.uint32).view(np.int32)
    else:
        x = rng.integers(0, 2, nbits).astype(np.int32)
    bits = t(x, cuda)
    before = tpack.seg_packbits.launches
    got = tpack.seg_packbits_stream(bits)
    torch.cuda.synchronize()
    assert tpack.seg_packbits.launches == before + 1
    assert got.is_cuda and got.dtype == torch.uint32 and got.shape == (-(-nbits // 32),)
    np.testing.assert_array_equal(n(got), n(tpack.seg_packbits_stream_plain(bits)))
    if case != "full-words":
        want = np.packbits(np.concatenate([x, np.zeros(-nbits % 32, np.int32)]).astype(np.uint8))
        assert n(got).astype(">u4").tobytes() == want.tobytes()
    if nbits % 32 == 0:  # pack_bit_rows is the same launch on rows of whole words
        rows = tpack.pack_bit_rows(bits.reshape(-1, 32))
        np.testing.assert_array_equal(n(rows).reshape(-1), n(got))


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
    with pytest.raises(TypeError):
        tpack.seg_packbits_stream(torch.zeros((64,), device=cuda))
    with pytest.raises(ValueError):
        tpack.seg_packbits_stream(torch.zeros((2, 32), dtype=torch.int32, device=cuda))


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
        "seg_hist2side": 0, "seg_moments": 0, "seg_binarize_apply": 0, "seg_accumulate": 0,
        "seg_packbits": 2, "seg_select_pack": 0, "hist2side": 0, "masked_moments": 0,
        "binarize_apply": 0, "f32_mean_xla": 2 * (run.fns.flat_space.n_mu + 1)}  # + the loss
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
    bounds = [(o, s) for o, s, _ in segs]
    out, res, stats = _hist_pipeline(acc, bounds, ks, [0.01] * len(sizes),
                                     t(sob.astype(np.int64), cuda), len(sob), BM, LANES, 128,
                                     absmax=tflat.seg_absmax(acc, bounds))
    for i, (o, s, _) in enumerate(segs):
        got = tops.sbc_compress_hist(acc[o:o + s], p=0.01, bm=BM, lanes=LANES)
        for g, w in ((got.delta_star, out[o:o + s]), (got.residual, res[o:o + s]),
                     (got.mean, stats["mu"][i]), (got.count, stats["count"][i])):
            np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


def _device_ops_per_call(fn, calls=20):
    """Device operations (kernels, memsets, copies) per call of ``fn()``,
    from the profiler's trace after a warm-up: each operation's count over
    the calls, rounded (the trace loses a record now and then).  The trace
    loses the first records of a window, more of them the longer the
    process has run, so the window opens and closes with spin kernels
    (``torch.cuda._sleep``) that are not counted, as ``chip_smoke.py``'s
    ``device_ms`` does."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(32):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        for _ in range(8):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0)) > 0
              and "spin_kernel" not in e.key]
    assert events, "the profiler saw no device time"
    return sum(round(e.count / calls) for e in events)


def _hist2side_calls(cuda):
    """``(leaf, lo, hi, nbins)``: both passes on an aligned leaf and on a
    view that is not 16-byte aligned, and a wider histogram; the ranges
    are device tensors, as the pipeline passes them."""
    out = []
    for case in ("262145", "offset"):
        x = _leaf(case, cuda)
        for lo, hi in _leaf_ranges(x):
            out.append((x, lo, hi, 128))
    x = _leaf("100000", cuda)
    lo, hi = _leaf_ranges(x)[0]
    out.append((x, lo, hi, 1000))
    return out


def _assert_hist2side_equals_plain(x, lo, hi, nbins):
    got = thist.hist2side(x, lo, hi, nbins=nbins)
    np.testing.assert_array_equal(n(got), n(thist.hist2side_plain(x, lo, hi, nbins=nbins)))
    return got


def _workspace_is_zero(cuda, stream=None):
    stream = torch.cuda.current_stream(cuda) if stream is None else stream
    buf = _build.WORKSPACE.buffers[(cuda.type, torch.cuda.current_device(), stream.cuda_stream)]
    return not bool(buf.any())


@pytest.mark.cuda
def test_hist2side_leaves_nothing_behind(cuda):
    """Both passes, aligned and not, and a larger nbins (the workspace
    grows), in a row and again: every call equals the plain version and
    the workspace is zero after each."""
    calls = _hist2side_calls(cuda)
    for _ in range(2):
        for x, lo, hi, nbins in calls + calls[::-1]:
            _assert_hist2side_equals_plain(x, lo, hi, nbins)
            torch.cuda.synchronize()
            assert _workspace_is_zero(cuda)


@pytest.mark.cuda
def test_hist2side_on_a_second_stream(cuda):
    calls = _hist2side_calls(cuda)
    want = [_assert_hist2side_equals_plain(*c) for c in calls]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = [_assert_hist2side_equals_plain(*c) for c in calls]
    side.synchronize()
    assert _workspace_is_zero(cuda, side)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["262145", "offset"])
def test_hist2side_under_cuda_graph_capture(cuda, case):
    """Both passes captured once, replayed on new values: each replay gives
    the plain version's counts on the values it saw."""
    rng = np.random.default_rng(61)
    x = _leaf(case, cuda)
    (lo0, hi0), (lo1, hi1) = _leaf_ranges(x)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        _assert_hist2side_equals_plain(x, lo0, hi0, 128)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        coarse = thist.hist2side(x, lo0, hi0)
        zoomed = thist.hist2side(x, lo1, hi1)
    for _ in range(2):
        x.copy_(t((rng.standard_normal(x.numel()) * 2.0).astype(np.float32), cuda))
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(n(coarse), n(thist.hist2side_plain(x, lo0, hi0)))
        np.testing.assert_array_equal(n(zoomed), n(thist.hist2side_plain(x, lo1, hi1)))
    with torch.cuda.stream(side):  # the stream's own workspace is still zero
        _assert_hist2side_equals_plain(x, lo0, hi0, 128)
    side.synchronize()
    assert _workspace_is_zero(cuda, side)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["262145", "offset"])
def test_hist2side_is_one_device_operation(cuda, case):
    """No fill before the kernel and no int→f32 copy after it."""
    x = _leaf(case, cuda)
    for lo, hi in _leaf_ranges(x):
        assert _device_ops_per_call(lambda: thist.hist2side(x, lo, hi)) == 1


# -------------------------------------------- the one-launch masked_moments

MOMENT_SIZES = (1, 1023, 1025, 1_225_000)
# the two tiles the callers use, and spans whose units take 4, 2 and 1 of a
# partial's 8 groups, and one that is not a whole number of quads
MOMENT_TILES = ((8, 128), (256, 1024), (8, 256), (16, 256), (64, 128), (1, 3))


def _moments_leaf(size, aligned, cuda, seed=62):
    """A Gaussian leaf of ``size`` entries, 16-byte aligned or a view one
    entry into its buffer."""
    rng = np.random.default_rng(seed + size)
    base = t((rng.standard_normal(size + 1) * 2.0).astype(np.float32), cuda)
    x = base[:size] if aligned else base[1:]
    assert (x.data_ptr() % 16 == 0) == aligned
    return x


def _assert_moments_equal_plain(x, tp, tn, bm, lanes):
    before = tmom.masked_moments.launches
    got = tmom.masked_moments(x, tp, tn, bm=bm, lanes=lanes)
    assert tmom.masked_moments.launches == before + 1
    want = tmom.masked_moments_plain(x, tp, tn, bm=bm, lanes=lanes)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 2)
    np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("size", MOMENT_SIZES)
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_masked_moments_one_launch_is_bit_equal_to_plain(cuda, size, aligned):
    """Every tile, and thresholds as numbers and as device tensors (a
    threshold of 0 counts zeros, never an entry past the leaf)."""
    x = _moments_leaf(size, aligned, cuda)
    for bm, lanes in MOMENT_TILES:
        _assert_moments_equal_plain(x, 0.7, 0.5, bm, lanes)
        tp, tn = torch.tensor(0.0, device=cuda), torch.tensor(1e-3, device=cuda)
        got = _assert_moments_equal_plain(x, tp, tn, bm, lanes)
        assert n(got)[0, 1] == int((x >= 0).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("bm, lanes", [(8, 128), (256, 1024)])
def test_masked_moments_leaves_nothing_behind(cuda, bm, lanes):
    """In a row and again, on leaves whose partials take more and fewer
    tickets: the workspace (ticket and per-partial tickets) is zero after
    each call."""
    leaves = [_moments_leaf(s, a, cuda) for s in MOMENT_SIZES for a in (True, False)]
    for _ in range(2):
        for x in leaves + leaves[::-1]:
            _assert_moments_equal_plain(x, 0.7, 0.5, bm, lanes)
            torch.cuda.synchronize()
            assert _workspace_is_zero(cuda)


@pytest.mark.cuda
def test_masked_moments_on_a_second_stream(cuda):
    calls = [(_moments_leaf(s, a, cuda), bm, lanes) for s in (1025, 1_225_000)
             for a in (True, False) for bm, lanes in ((8, 128), (256, 1024))]
    want = [_assert_moments_equal_plain(x, 0.7, 0.5, bm, lanes) for x, bm, lanes in calls]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = [_assert_moments_equal_plain(x, 0.7, 0.5, bm, lanes) for x, bm, lanes in calls]
    side.synchronize()
    assert _workspace_is_zero(cuda, side)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_masked_moments_under_cuda_graph_capture(cuda, aligned):
    """Both tiles captured once, replayed on new values and thresholds:
    each replay gives the plain version's bits on the values it saw."""
    rng = np.random.default_rng(63)
    x = _moments_leaf(1_225_000, aligned, cuda)
    tp, tn = torch.tensor(0.7, device=cuda), torch.tensor(0.5, device=cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        _assert_moments_equal_plain(x, tp, tn, 8, 128)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        small = tmom.masked_moments(x, tp, tn, bm=8, lanes=128)
        large = tmom.masked_moments(x, tp, tn, bm=256, lanes=1024)
    for r in range(2):
        x.copy_(t((rng.standard_normal(x.numel()) * 2.0).astype(np.float32), cuda))
        tp.fill_(0.6 + 0.1 * r)
        graph.replay()
        torch.cuda.synchronize()
        for got, (bm, lanes) in ((small, (8, 128)), (large, (256, 1024))):
            want = tmom.masked_moments_plain(x, tp, tn, bm=bm, lanes=lanes)
            np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    with torch.cuda.stream(side):  # the stream's own workspace is still zero
        _assert_moments_equal_plain(x, tp, tn, 256, 1024)
    side.synchronize()
    assert _workspace_is_zero(cuda, side)


@pytest.mark.cuda
@pytest.mark.parametrize("bm, lanes", [(8, 128), (256, 1024)])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
def test_masked_moments_is_one_device_operation(cuda, bm, lanes, aligned):
    x = _moments_leaf(1_225_000, aligned, cuda)
    tp, tn = torch.tensor(0.7, device=cuda), torch.tensor(0.5, device=cuda)
    assert _device_ops_per_call(
        lambda: tmom.masked_moments(x, tp, tn, bm=bm, lanes=lanes)) == 1


@pytest.mark.cuda
def test_local_run_flat_path_equals_per_leaf_path_on_the_card(cuda):
    """The local backend (four clients) on the card: three rounds with
    fast=True (one f32_mean_xla a segment a round) and with fast=False (two
    per SBC leaf and client) give bit-identical params, residuals, Adam
    states and ledger rows; no other kernel is launched."""
    runs, states, counts = {}, {}, {}
    for fast in (False, True):
        run = build_run(RunSpec(preset="lenet5", backend="local", clients=4, batch=32,
                                sparsity=0.01, measure_wire=True, fast=fast), device=cuda)
        state = run.init()
        torch.cuda.synchronize()
        kernels.reset_launches()
        for r in range(3):
            state, m = run.step(state, r)
            assert np.isfinite(float(m["loss"]))
        runs[fast], states[fast], counts[fast] = run, state, kernels.launch_counts()
    for fast, per_round in ((True, 6), (False, 48)):
        assert counts[fast] == {**{k: 0 for k in counts[fast]}, "f32_mean_xla": 3 * per_round}
    slow, quick = states[False], states[True]
    space = runs[True].trainer.resolved(quick.params).flat_space(quick.params)
    residual = space.unflatten(quick.comp_state.residual)
    for k in slow.params:
        for a, b in ((quick.params[k], slow.params[k]), (residual[k], slow.comp_state.residual[k]),
                     (quick.opt_states.m[k], slow.opt_states.m[k])):
            np.testing.assert_array_equal(n(a).view(np.uint32), n(b).view(np.uint32))
    assert runs[True].ledger.history() == runs[False].ledger.history()


# ------------------------- the one-launch seg_hist2side and seg_moments


def _one_launch_operands(sob, nseg, seed, cuda, zero_segments=()):
    """xpad for the blocks' segment ids ``sob`` (any order), with the hist
    params of random per-side ranges and the moments params of random
    thresholds."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((len(sob), BM * LANES))
         * np.exp(2.0 * rng.standard_normal((len(sob), BM * LANES)))).astype(np.float32)
    for z in zero_segments:
        x[sob == z] = 0.0
    absmax = np.float32(np.abs(x).max())
    lo = (absmax * rng.uniform(2.0 ** -30, 2.0 ** -20, (nseg, 2))).astype(np.float32)
    hi = (absmax * rng.uniform(0.5, 1.0001, (nseg, 2))).astype(np.float32)
    tp = rng.uniform(0.2, 2.0, nseg).astype(np.float32)
    tn = rng.uniform(0.2, 2.0, nseg).astype(np.float32)
    p5 = hist_params(sob, lo, hi)
    p3 = np.stack([sob.astype(np.float32), tp[sob], tn[sob]], axis=1)
    return t(x.reshape(-1, LANES), cuda), t(p5, cuda), t(p3, cuda)


def _assert_one_launch_equals_plain(x, p5, p3, nseg, nbins=128):
    """One launch each; counts equal to the plain versions', moment sums
    bit-equal."""
    before = (tflat.seg_hist2side.launches, tflat.seg_moments.launches)
    hist = tflat.seg_hist2side(x, p5, nseg=nseg, nbins=nbins)
    mom = tflat.seg_moments(x, p3, nseg=nseg)
    assert (tflat.seg_hist2side.launches, tflat.seg_moments.launches) == (
        before[0] + 1, before[1] + 1)
    assert hist.dtype == torch.float32 and tuple(hist.shape) == (nseg, 2, nbins)
    np.testing.assert_array_equal(n(hist), n(tflat.seg_hist2side_plain(x, p5, nseg=nseg,
                                                                       nbins=nbins)))
    np.testing.assert_array_equal(n(mom).view(np.uint32),
                                  n(tflat.seg_moments_plain(x, p3, nseg=nseg)).view(np.uint32))
    return hist, mom


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["interleaved", "zero-segment", "empty-segment", "one-block"])
def test_one_launch_kernels_match_plain(cuda, case):
    """Segment ids in any order: one id per block at random (interleaved),
    a segment of zeros, a segment id with no block, a single block."""
    rng = np.random.default_rng(40)
    nseg, nblocks = {"interleaved": (7, 613), "zero-segment": (4, 300),
                     "empty-segment": (5, 200), "one-block": (1, 1)}[case]
    if case == "interleaved":
        sob = rng.integers(0, nseg, nblocks).astype(np.int32)
    else:
        sob = np.sort(rng.integers(0, nseg, nblocks)).astype(np.int32)
        if case == "empty-segment":
            sob[sob == 3] = 2
    x, p5, p3 = _one_launch_operands(sob, nseg, 41, cuda,
                                     zero_segments=(1,) if case == "zero-segment" else ())
    hist, mom = _assert_one_launch_equals_plain(x, p5, p3, nseg)
    if case == "zero-segment":
        assert not n(hist)[1].any() and not n(mom)[1].any()
    if case == "empty-segment":
        assert not n(hist)[3].any() and not n(mom)[3].any()


@pytest.mark.cuda
def test_one_launch_kernels_leave_no_counts_behind(cuda):
    """Three calls in a row, then a larger nseg * nbins (the workspace
    grows), then the smaller one again: every call equals the plain
    versions, so no count carries over from an earlier call."""
    sizes, zero = LAYOUTS["lenet5"]
    segs, xpad, sob = segment_layout(sizes, seed=42, zero_segments=zero)
    small = _one_launch_operands(sob, len(segs), 43, cuda)
    for _ in range(3):
        _assert_one_launch_equals_plain(*small, len(segs))
    rng = np.random.default_rng(44)
    big_sob = np.sort(rng.integers(0, 40, 2000)).astype(np.int32)
    big = _one_launch_operands(big_sob, 40, 45, cuda)
    _assert_one_launch_equals_plain(*big, 40, nbins=512)
    _assert_one_launch_equals_plain(*small, len(segs))
    _assert_one_launch_equals_plain(*big, 40, nbins=512)


@pytest.mark.cuda
def test_one_launch_kernels_on_a_second_stream(cuda):
    sizes, zero = LAYOUTS["ragged"]
    segs, xpad, sob = segment_layout(sizes, seed=46, zero_segments=zero)
    ops = _one_launch_operands(sob, len(segs), 47, cuda)
    want = _assert_one_launch_equals_plain(*ops, len(segs))
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = _assert_one_launch_equals_plain(*ops, len(segs))
    side.synchronize()
    assert (cuda.type, torch.cuda.current_device(), side.cuda_stream) in _build.WORKSPACE.buffers
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
def test_one_launch_kernels_under_cuda_graph_capture(cuda):
    """Captured once, replayed twice on new values each time: each replay
    gives the plain versions' results on the values it saw."""
    sizes, zero = LAYOUTS["lenet5"]
    segs, xpad, sob = segment_layout(sizes, seed=48, zero_segments=zero)
    nseg = len(segs)
    x, p5, p3 = _one_launch_operands(sob, nseg, 49, cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        _assert_one_launch_equals_plain(x, p5, p3, nseg)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        hist = tflat.seg_hist2side(x, p5, nseg=nseg)
        mom = tflat.seg_moments(x, p3, nseg=nseg)
    for seed in (50, 51):
        new = _one_launch_operands(sob, nseg, seed, cuda)
        for dst, src in zip((x, p5, p3), new):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        np.testing.assert_array_equal(n(hist), n(tflat.seg_hist2side_plain(x, p5, nseg=nseg)))
        np.testing.assert_array_equal(n(mom).view(np.uint32),
                                      n(tflat.seg_moments_plain(x, p3, nseg=nseg)).view(np.uint32))
    with torch.cuda.stream(side):  # the stream's own workspace is still zero
        _assert_one_launch_equals_plain(x, p5, p3, nseg)
    side.synchronize()


# ------------------------------------------------------------ f32_mean_xla

MEAN_SIZES = (1, 5, 13, 32, 33, 50, 250, 1_000, 12_250, 12_561, 100_000, 500_000, 4_000_000)
# the one-CTA route ends at 4 warps x 32 windows x 32 values
ONE_CTA_MAX = 32 * 32 * treduce.CTA_WARPS
SPLIT_SIZES = (1, 31, 32, 33, 1_023, 1_024, 1_025, ONE_CTA_MAX - 1, ONE_CTA_MAX,
               ONE_CTA_MAX + 1, 12_250, 100_000, 4_000_000)


@pytest.mark.cuda
@pytest.mark.parametrize("size", MEAN_SIZES)
def test_f32_mean_xla_kernel_is_bit_equal_to_plain(cuda, size):
    """Every size of the CPU tests against ``jnp.mean``, plus rows split
    over many CTAs with several upper levels (500,000 and 4,000,000)."""
    rng = np.random.default_rng(size)
    rows = 3 if size < 200_000 else 2
    x = (rng.standard_normal((rows, size)) * np.exp(rng.standard_normal((rows, size)))
         ).astype(np.float32)
    xd = t(x, cuda)
    for sum_only in (False, True):
        before = treduce.f32_mean_xla.launches
        got = treduce.f32_mean_xla(xd, sum_only=sum_only)
        torch.cuda.synchronize()
        assert treduce.f32_mean_xla.launches == before + 1
        want = treduce.f32_mean_xla_plain(t(x), sum_only=sum_only)
        np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))


def _mean_rows(rows, size, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, size)) * np.exp(rng.standard_normal((rows, size)))
            ).astype(np.float32)


def _assert_mean_equals_plain(xd, sum_only=False):
    got = treduce.f32_mean_xla(xd, sum_only=sum_only)
    want = treduce.f32_mean_xla_plain(xd, sum_only=sum_only)
    np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 2, 8])
@pytest.mark.parametrize("size", SPLIT_SIZES)
def test_f32_mean_xla_routes_are_bit_equal_to_plain(cuda, size, rows):
    """Both routes and their boundary, window edges, and rows of up to 4
    upper levels, with 1, 2 and 8 rows a call: bit-equal to the plain
    cascade, means and sums, one launch each."""
    xd = t(_mean_rows(rows, size, size + rows), cuda)
    assert treduce.one_cta(size) == (size <= ONE_CTA_MAX)
    for sum_only in (False, True):
        before = treduce.f32_mean_xla.launches
        _assert_mean_equals_plain(xd, sum_only)
        assert treduce.f32_mean_xla.launches == before + 1


@pytest.mark.cuda
def test_f32_mean_xla_leaves_no_ticket_behind(cuda):
    """Split rows of other shapes in a row: every call equals the plain
    cascade and leaves the workspace zero, so no ticket carries over."""
    shapes = ((2, 12_250), (8, 100_000), (1, ONE_CTA_MAX + 1), (3, 4_000_000), (2, 12_250))
    for i, (rows, size) in enumerate(shapes):
        _assert_mean_equals_plain(t(_mean_rows(rows, size, 70 + i), cuda))
        torch.cuda.synchronize()
        assert _workspace_is_zero(cuda)


@pytest.mark.cuda
def test_f32_mean_xla_on_a_second_stream(cuda):
    calls = [t(_mean_rows(rows, size, 80 + rows), cuda)
             for rows, size in ((2, 12_250), (1, 250), (8, 100_000))]
    want = [_assert_mean_equals_plain(x) for x in calls]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        got = [_assert_mean_equals_plain(x) for x in calls]
    side.synchronize()
    assert _workspace_is_zero(cuda, side)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.cuda
def test_f32_mean_xla_under_cuda_graph_capture(cuda):
    """A split call and a one-CTA call captured once, replayed on new
    values: each replay gives the plain cascade's bits on what it saw."""
    rng = np.random.default_rng(90)
    big, small = t(_mean_rows(2, 12_250, 91), cuda), t(_mean_rows(2, 250, 92), cuda)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        _assert_mean_equals_plain(big)
        _assert_mean_equals_plain(small)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        mean_big = treduce.f32_mean_xla(big)
        sum_small = treduce.f32_mean_xla(small, sum_only=True)
    for _ in range(2):
        big.copy_(t(rng.standard_normal(big.shape).astype(np.float32), cuda))
        small.copy_(t(rng.standard_normal(small.shape).astype(np.float32), cuda))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in ((mean_big, treduce.f32_mean_xla_plain(big)),
                          (sum_small, treduce.f32_mean_xla_plain(small, sum_only=True))):
            np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    with torch.cuda.stream(side):  # the stream's own workspace is still zero
        _assert_mean_equals_plain(big)
    side.synchronize()
    assert _workspace_is_zero(cuda, side)


@pytest.mark.cuda
@pytest.mark.parametrize("rows, size", [(2, 5), (1, 250), (2, 12_250), (8, 100_000)])
def test_f32_mean_xla_is_one_device_operation(cuda, rows, size):
    xd = t(_mean_rows(rows, size, 95), cuda)
    assert _device_ops_per_call(lambda: treduce.f32_mean_xla(xd)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 250, 12_250])
def test_f32_mean_xla_on_stacked_two_sided_top_k(cuda, k):
    """The exact engine's call: ``[2·rows, k]`` top-k values of both sides,
    one launch, the same μ and selection as on the CPU."""
    from repro_torch.kernels.topk import _two_sided_topk

    rng = np.random.default_rng(k)
    x = rng.standard_normal((3, 100 * k)).astype(np.float32)
    vals = np.concatenate([np.sort(x, -1)[:, ::-1][:, :k], np.sort(-x, -1)[:, ::-1][:, :k]])
    got = treduce.f32_mean_xla(t(np.ascontiguousarray(vals), cuda))
    want = treduce.f32_mean_xla_plain(t(np.ascontiguousarray(vals)))
    np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    idx_d, mu_d = _two_sided_topk(t(x, cuda), k)
    idx_h, mu_h = _two_sided_topk(t(x), k)
    np.testing.assert_array_equal(n(idx_d), n(idx_h))
    np.testing.assert_array_equal(n(mu_d).view(np.uint32), n(mu_h).view(np.uint32))


@pytest.mark.cuda
def test_f32_mean_xla_raises_instead_of_falling_back(cuda):
    with pytest.raises(TypeError):
        treduce.f32_mean_xla(torch.zeros(4, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):
        treduce.f32_mean_xla(torch.zeros((2, 0), device=cuda))


# ------------------------------------------------- the device-packed wire

WIRE_POLICIES = {
    "sbc": lambda pol, mk: pol.CompressionPolicy.single(mk("sbc")),
    "dense-small": lambda pol, mk: pol.CompressionPolicy(
        default=mk("sbc"), rules=(pol.PolicyRule(pol.DENSE_SMALL_PATTERN, codec="dense32"),)),
    "mixed": lambda pol, mk: pol.CompressionPolicy(
        default=mk("sbc"), rules=(pol.PolicyRule(r"bias", codec="dense32"),
                                  pol.PolicyRule(r"skipme", codec="skip"))),
    "variance": lambda pol, mk: pol.CompressionPolicy.single(mk("variance|identity|golomb")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WIRE_POLICIES))
def test_wire_pack_device_on_the_card_equals_the_host_pack(cuda, name):
    """``ResolvedPolicy.compress`` on the card, then ``Wire.pack_device``:
    one ``seg_select_pack`` launch per Golomb leaf, the host pack's bytes,
    and the same blob as the whole path on the CPU."""
    from repro_torch.core import policy as tpol
    from repro_torch.core.codec import make_codec
    from repro_torch.core.wire import wire_for

    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal(40_960).astype(np.float32),
            "v": rng.standard_normal((64, 8)).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32),
            "skipme": rng.standard_normal(32).astype(np.float32)}
    blobs = []
    for dev in (cuda, torch.device("cpu")):
        delta = {k: t(v, dev) for k, v in tree.items()}
        resolved = WIRE_POLICIES[name](tpol, make_codec).resolve(delta)
        comp, dense, _ = resolved.compress(delta, resolved.init_state(delta),
                                           resolved.rates(0.02))
        wire = wire_for(resolved, delta, 0.02)
        golomb = sum(s.encoder == "golomb" and s.selector != "skip" for s in wire.specs)
        before = tpack.seg_select_pack.launches
        dev_blob, dev_bits = wire.pack_with_bits(comp, device_pack=True)
        torch.cuda.synchronize()
        assert tpack.seg_select_pack.launches == before + (golomb if dev.type == "cuda" else 0)
        assert (dev_blob, dev_bits) == wire.pack_with_bits(comp)
        assert wire.pack_device(comp) == dev_blob
        rec = wire.unpack(dev_blob)
        for k in tree:
            np.testing.assert_array_equal(n(rec[k]).view(np.uint32),
                                          n(dense[k]).view(np.uint32))
        blobs.append(dev_blob)
    assert blobs[0] == blobs[1]


# ------------------------------------------- CharLSTM and telemetry on the card


@pytest.mark.cuda
def test_charlstm_local_paths_are_bit_identical_and_repeat_on_the_card(cuda):
    """CharLSTM on the card: the flat and the per-leaf local paths give
    bit-identical params, residuals and ledger rows, and a second run of
    the flat path repeats the first bit for bit (the embedding's backward
    adds repeated tokens' rows in a fixed order)."""
    from repro_torch.core.tree import tree_flatten

    spec = dict(preset="charlstm", backend="local", clients=2, batch=4, seq_len=16,
                sparsity=0.01, measure_wire=True)
    finals = []
    for fast in (False, True, True):
        run = build_run(RunSpec(**spec, fast=fast), device=cuda)
        state = run.init()
        for r in range(2):
            state, m = run.step(state, r)
            assert np.isfinite(float(m["loss"]))
        res = state.comp_state.residual
        if fast:
            res = run.trainer.resolved(state.params).flat_space(state.params).unflatten(res)
        finals.append((tree_flatten(state.params)[0] + tree_flatten(res)[0],
                       run.ledger.history()))
    for leaves, hist in finals[1:]:
        for a, b in zip(leaves, finals[0][0]):
            np.testing.assert_array_equal(n(a).view(np.uint32), n(b).view(np.uint32))
        assert hist == finals[0][1]


@pytest.mark.cuda
def test_tracer_fence_synchronizes_the_card(cuda, monkeypatch):
    from repro_torch import obs

    real, calls = torch.cuda.synchronize, []

    def counted(device=None):
        calls.append(device)
        return real(device)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    x = torch.randn((4096, 4096), device=cuda)
    y = {"w": x @ x, "b": torch.zeros(3)}
    assert obs.Tracer().fence(y) is y
    assert calls == [y["w"].device] and torch.cuda.current_stream(cuda).query()
    assert obs.NULL_TELEMETRY.fence(y) is y and len(calls) == 1


# ------------------------------------------------------------ the fed backend


@pytest.mark.cuda
@pytest.mark.parametrize("fast, per_round", [(True, 6), (False, 2 * 6 * 4)],
                         ids=["flat", "per-leaf"])
def test_fed_round_holds_each_mean_against_plain_on_the_card(cuda, monkeypatch, fast,
                                                             per_round):
    """One LeNet5 fed round on the card (four clients in one tile, the
    dense downstream): ``f32_mean_xla`` is the only kernel launched (one a
    segment on the flat path, two per SBC leaf and member per leaf), each
    call equals its plain cascade on its own operands bit for bit, the
    uploads decode on the server, and the dense broadcast leaves the
    replica equal to W."""
    from repro_torch.core import stages as core_stages
    from repro_torch.core.tree import tree_flatten
    from repro_torch.kernels import topk as ktopk

    calls = []
    for mod in (ktopk, core_stages):
        real = mod.f32_mean_xla
        monkeypatch.setattr(mod, "f32_mean_xla", lambda x, *a, real=real, **kw:
                            calls.append((x, a, kw)) or real(x, *a, **kw))
    run = build_run(RunSpec(preset="lenet5", backend="fed", clients=4, batch=32,
                            sparsity=0.01, fast=fast), device=cuda)
    sched = run.init()
    torch.cuda.synchronize()
    kernels.reset_launches()
    m = sched.step(0)
    assert np.isfinite(m["loss"]) and m["accepted"] == [0, 1, 2, 3] and not m["rejected"]
    counts = kernels.launch_counts()
    assert counts == {**{k: 0 for k in counts}, "f32_mean_xla": per_round}
    assert len(calls) == per_round
    for x, a, kw in calls:
        got, want = treduce.f32_mean_xla(x, *a, **kw), treduce.f32_mean_xla_plain(x, *a, **kw)
        assert got.is_cuda
        np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    for w, e in zip(tree_flatten(sched.server.params)[0], tree_flatten(sched.server.estimate)[0]):
        assert w.is_cuda
        np.testing.assert_array_equal(n(w).view(np.uint32), n(e).view(np.uint32))


COMPRESSORS = ("dgc", "dgc_policy", "fedavg", "none", "onebit", "qsgd", "randomk", "sbc",
               "signsgd", "terngrad", "topk", "variance")


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPRESSORS)
def test_baseline_local_round_on_the_card(cuda, name):
    """One LeNet5 local round of every registered compressor on the card
    (two clients, per leaf): a finite loss, ``f32_mean_xla`` launches as
    counted from the stages and no other kernel, every call bit-equal to
    its plain cascade, and the ledger's measured bits equal to client 0's
    packed upload (``Wire.measured_bits``) times the clients."""
    from repro_torch.core import stages as core_stages
    from repro_torch.kernels import topk as ktopk

    run = build_run(RunSpec(preset="lenet5", backend="local", compressor=name, clients=2,
                            batch=32, sparsity=0.01, measure_wire=True), device=cuda)
    state = run.init()
    uploads, calls = [], []
    record = run.channel.record_round
    run.channel.record_round = lambda r, **kw: uploads.append(kw) or record(r, **kw)
    means = {}
    for mod in (ktopk, core_stages):
        real = mod.f32_mean_xla
        means[mod] = real
        mod.f32_mean_xla = lambda x, *a, real=real, **k: calls.append((x, a, k)) or real(
            x, *a, **k)
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        state, m = run.step(state, 0)
        assert np.isfinite(float(m["loss"]))
        counts = kernels.launch_counts()
    finally:
        for mod, real in means.items():
            mod.f32_mean_xla = real
    # chip_smoke.py's table of f32_mean_xla calls a leaf, by compressor
    means = len(load_chip_smoke().leaf_mean_shapes(name, 1, 1))
    assert counts == {**{k: 0 for k in counts}, "f32_mean_xla": means * 6 * 2}
    for x, a, k in calls:
        got, want = treduce.f32_mean_xla(x, *a, **k), treduce.f32_mean_xla_plain(x, *a, **k)
        np.testing.assert_array_equal(n(got).view(np.uint32), n(want).view(np.uint32))
    up = uploads[0]
    bits = run.channel.wire(up["params"], up["rate"], 0).measured_bits(up["compressed0"])
    assert run.ledger.records[0].up_bits_measured == 2 * float(bits)


def test_broadcast_log_and_pool_on_the_card_equal_the_cpu(cuda):
    """The fed server's broadcast log and a subscriber pool on the card
    against the same on the CPU, fed the same seeded updates: every
    broadcast, the log's replica, every stacked and full message, each
    round's fan-out and the pool's arrays are equal; the card's log never
    falls back to the host."""
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.fed.server import ParameterServer
    from repro_torch.serve import SubscriberPool, apply_catchup_flat

    rng = np.random.default_rng(42)
    base = {"w": rng.normal(size=(20_000,)).astype(np.float32),
            "b": rng.normal(size=(50,)).astype(np.float32)}
    ends = {}
    for dev in ("cpu", "cuda"):
        server = ParameterServer(params={k: torch.from_numpy(v).to(dev) for k, v in base.items()},
                                 up_policy=CompressionPolicy.single("sbc"), down_sparsity=0.05,
                                 delta_horizon=4)
        pool = SubscriberPool(log=server.delta_log, n_subscribers=2_000, periods=(1, 2, 3, 6),
                              verify_classes=4)
        draws = np.random.default_rng(7)
        blobs, infos, msgs = [], [], []
        for r in range(8):
            server.params = {k: v + torch.from_numpy(
                (1e-2 * draws.standard_normal(v.shape)).astype(np.float32)).to(dev)
                for k, v in server.params.items()}
            blobs.append(server.broadcast(r).blob)
            infos.append(pool.sync_round(r))
            log = server.delta_log
            msgs.append([log.encode_stacked(f).blob for f in range(log.oldest - 1, log.head)]
                        + [log.encode_full().blob])
        assert all(x.device.type == dev for x in server.delta_log._replica + [pool._synced])
        assert pool.verify_ok and pool.verified_syncs > 0
        flats = [torch.zeros_like(x) for x in server.delta_log._replica]
        got, _, _ = apply_catchup_flat(flats, msgs[-1][-1])
        assert all(torch.equal(a, b) for a, b in zip(got, server.delta_log._replica))
        ends[dev] = (blobs, infos, msgs, [n(x) for x in server.delta_log._replica],
                     pool.synced_round, pool.bytes_down, pool.totals())
    cpu, card = ends["cpu"], ends["cuda"]
    assert card[:3] == cpu[:3]
    for a, b in zip(card[3], cpu[3]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    np.testing.assert_array_equal(card[4], cpu[4])
    np.testing.assert_array_equal(card[5], cpu[5])
    assert card[6] == cpu[6]


def test_decoder_forward_and_greedy_tokens_on_the_card_equal_the_cpu(cuda):
    """The dense decoder (tiny and a reduced gemma3, whose 64-token local
    window a 72-token prompt rolls) on the card against the same port on
    the CPU: the loss and its gradients within ``rtol=1e-4`` (cuBLAS and
    the CPU order a GEMM's adds differently; TF32 is off), and the greedy
    tokens of the serving engine equal (each step's top logit leads by far
    more than that)."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_flatten, tree_map
    from repro_torch.device import full_f32_math
    from repro_torch.models.model import build_model
    from repro_torch.run.presets import tiny_config
    from repro_torch.serve import ServeEngine

    full_f32_math()
    for cfg in (tiny_config(), reduced(get_config("gemma3_1b"))):
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 73))).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        grads = {}
        for dev in ("cpu", "cuda"):
            leaves, treedef = tree_flatten(tree_map(lambda v: v.to(dev), params))
            leaves = [v.requires_grad_(True) for v in leaves]
            loss = model.loss_fn(treedef.unflatten(leaves),
                                 tree_map(lambda v: v.to(dev), batch))
            grads[dev] = (float(loss), [g.cpu() for g in torch.autograd.grad(loss, leaves)])
        np.testing.assert_allclose(grads["cuda"][0], grads["cpu"][0], rtol=1e-5)
        for a, b in zip(grads["cuda"][1], grads["cpu"][1]):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()) + 1e-12)
        engine = ServeEngine(model)
        out = {dev: engine.generate(tree_map(lambda v: v.to(dev), params),
                                    {"tokens": batch["tokens"].to(dev)},
                                    max_new_tokens=8).cpu()
               for dev in ("cpu", "cuda")}
        assert torch.equal(out["cuda"], out["cpu"]), cfg.name


def test_moe_and_recurrent_decoders_on_the_card_equal_the_cpu(cuda):
    """The reduced mixtral (grouped MoE, top-2), jamba (Mamba + attention +
    MoE) and rwkv6 on the card against the same port on the CPU: the loss
    (with the MoE aux) within ``rtol=1e-5`` and the final hidden state
    within ``rtol=1e-4`` beside ``atol`` of 1e-5 of its scale (cuBLAS and
    the CPU order a GEMM's adds differently; TF32 is off), and the greedy
    tokens of the serving engine equal."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.device import full_f32_math
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    full_f32_math()
    for name in ("mixtral_8x7b", "jamba_v01_52b", "rwkv6_1p6b"):
        cfg = reduced(get_config(name))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33))).long()
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_map(lambda v: v.to(dev), params)
            b = tree_map(lambda v: v.to(dev), batch)
            with torch.no_grad():
                hidden, _ = transformer.decoder_hidden(p, b["tokens"], cfg)
                loss = model.loss_fn(p, b)
            gen = ServeEngine(model).generate(p, {"tokens": b["tokens"][:, :12]},
                                              max_new_tokens=6)
            out[dev] = (float(loss), hidden.cpu(), gen.cpu())
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, err_msg=name)
        ref = out["cpu"][1]
        np.testing.assert_allclose(n(out["cuda"][1]), n(ref), rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()), err_msg=name)
        assert torch.equal(out["cuda"][2], out["cpu"][2]), name


def test_encoder_decoder_and_vision_prefix_on_the_card_equal_the_cpu(cuda):
    """The reduced seamless-m4t (an encoder over 24 frames, cross
    attention) and phi-3-vision (8 prefix positions) on the card against
    the same port on the CPU: the loss within ``rtol=1e-5``, the final
    hidden state within ``rtol=1e-4`` beside ``atol`` of 1e-5 of its scale
    (cuBLAS and the CPU order a GEMM's adds differently; TF32 is off), and
    the greedy tokens of the serving engine equal."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.core.tree import tree_map
    from repro_torch.device import full_f32_math
    from repro_torch.models import transformer
    from repro_torch.models.model import build_model
    from repro_torch.serve import ServeEngine

    full_f32_math()
    for name in ("seamless_m4t_medium", "phi3_vision_4p2b"):
        cfg = reduced(get_config(name))
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33))).long()
        key, rows = ("enc_frames", 24) if cfg.family == "encdec" else ("prefix", cfg.n_prefix)
        stub = torch.from_numpy((0.1 * rng.standard_normal((2, rows, cfg.d_model)))
                                .astype(np.float32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], key: stub}
        out = {}
        for dev in ("cpu", "cuda"):
            b = tree_map(lambda v: v.to(dev), batch)
            p = tree_map(lambda v: v.to(dev), params)
            with torch.no_grad():
                hidden, _ = transformer.decoder_hidden(p, b["tokens"], cfg, **{key: b[key]})
                loss = model.loss_fn(p, b)
            gen = ServeEngine(model).generate(p, {"tokens": b["tokens"][:, :12], key: b[key]},
                                              max_new_tokens=6)
            out[dev] = (float(loss), hidden.cpu(), gen.cpu())
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5, err_msg=name)
        ref = out["cpu"][1]
        np.testing.assert_allclose(n(out["cuda"][1]), n(ref), rtol=1e-4,
                                   atol=1e-5 * float(ref.abs().max()), err_msg=name)
        assert torch.equal(out["cuda"][2], out["cpu"][2]), name
