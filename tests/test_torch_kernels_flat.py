"""The port's segment kernels (repro_torch.kernels.flat) against the JAX
package's Pallas ``seg_*`` kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions;
``test_torch_cuda.py`` holds the hand-written CUDA kernels against those
plain versions on the card.

Tolerances:
  * ``seg_binarize_apply`` is elementwise compare/select/subtract: bit-equal.
  * ``seg_moments`` counts are integers: equal.  Sums over up to a few
    thousand entries, in f32 by the JAX kernel and in f64 rounded once by
    the port: ``rtol=1e-6``.
  * ``seg_hist2side`` counts are equal except next to a bucket edge: XLA's
    and torch's CPU ``log2`` differ by one ulp on about 25% of inputs, so
    an entry whose bucket coordinate (in float64) lies within ``1e-4`` of
    an integer may land in the neighbouring bucket
    (``torch_helpers.assert_hist_close`` bounds the difference by that
    count).  Below ``|x| = 1e-38`` the two also differ because XLA on the
    CPU flushes denormals to zero and the port keeps them; no input here
    is that small.
  * ``_side_threshold`` given the same edges: ``rtol=1e-6``.
  * ``bucket_lower_edges``: ``rtol=1e-6`` while ``|log₂ x| ≤ 4``; beyond,
    the one-ulp ``log2`` difference grows with ``|log₂ x|`` (see the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flat as jflat
from repro.kernels.hist2side import SPAN_OCTAVES as J_SPAN_OCTAVES
from repro.kernels.hist2side import bucket_lower_edges as j_bucket_lower_edges
from repro.kernels.ops import _side_threshold as j_side_threshold
from repro_torch.kernels import _build
from repro_torch.kernels import flat as tflat
from repro_torch.kernels.hist2side import SPAN_OCTAVES, bucket_lower_edges
from repro_torch.kernels.ops import _side_threshold
from torch_helpers import (
    BM,
    LANES,
    assert_hist_close,
    coarse_ranges,
    hist_params,
    n,
    segment_layout,
    t,
    zoomed_ranges,
)

# ragged tails, a two-block segment, an all-zero segment (index 2)
SIZES = (1000, 2 * BM * LANES + 5, 65, 3000, 17)
ZERO = (2,)
NBINS = 64


@pytest.mark.parametrize("ranges", ["coarse", "zoomed"])
def test_seg_hist2side_plain_matches_jax(ranges):
    segs, xpad, sob = segment_layout(SIZES, seed=0, zero_segments=ZERO)
    los, his = coarse_ranges(segs) if ranges == "coarse" else zoomed_ranges(segs, 1)
    params = hist_params(sob, los, his)
    want = jflat.seg_hist2side(jnp.asarray(xpad), jnp.asarray(params),
                               nseg=len(segs), nbins=NBINS, bm=BM, lanes=LANES)
    got = tflat.seg_hist2side(t(xpad), t(params), nseg=len(segs), nbins=NBINS,
                              bm=BM, lanes=LANES)
    assert got.dtype == torch.float32 and tuple(got.shape) == (len(segs), 2, NBINS)
    assert_hist_close(n(got), n(want), segs, los, his, NBINS)
    assert not n(got)[ZERO[0]].any()


def test_seg_moments_plain_matches_jax():
    segs, xpad, sob = segment_layout(SIZES, seed=2, zero_segments=ZERO)
    rng = np.random.default_rng(3)
    tp = rng.uniform(0.2, 2.0, len(segs)).astype(np.float32)
    tn = rng.uniform(0.2, 2.0, len(segs)).astype(np.float32)
    params = np.stack([sob.astype(np.float32), tp[sob], tn[sob]], axis=1)
    want = n(jflat.seg_moments(jnp.asarray(xpad), jnp.asarray(params),
                               nseg=len(segs), bm=BM, lanes=LANES))
    got = n(tflat.seg_moments(t(xpad), t(params), nseg=len(segs), bm=BM,
                              lanes=LANES))
    np.testing.assert_array_equal(got[:, :, 1], want[:, :, 1])
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6)
    assert want[:, :, 1].sum() > 0 and not got[ZERO[0]].any()


def test_seg_binarize_apply_plain_is_bit_equal_to_jax():
    segs, xpad, sob = segment_layout(SIZES, seed=4, zero_segments=ZERO)
    rng = np.random.default_rng(5)
    k = len(segs)
    params = np.stack([
        rng.uniform(0.2, 2.0, k)[sob], rng.uniform(0.2, 2.0, k)[sob],
        rng.standard_normal(k)[sob], (rng.uniform(size=k) > 0.5)[sob],
    ], axis=1).astype(np.float32)
    want_out, want_res = jflat.seg_binarize_apply(
        jnp.asarray(xpad), jnp.asarray(params), bm=BM, lanes=LANES)
    got_out, got_res = tflat.seg_binarize_apply(t(xpad), t(params), bm=BM,
                                                lanes=LANES)
    for g, w in ((got_out, want_out), (got_res, want_res)):
        assert tuple(g.shape) == xpad.shape
        np.testing.assert_array_equal(n(g).view(np.uint32), n(w).view(np.uint32))


@pytest.mark.parametrize("octaves", [4, 100])
def test_bucket_lower_edges_matches_jax(octaves):
    """Edges are ``2**y`` with ``y = log₂lo + f·(log₂hi − log₂lo)``.  A
    one-ulp difference in the two CPU ``log2``s (and XLA's fused
    multiply-add) moves ``y`` by a few ulps of ``|y|``, which moves the
    edge by ``ulp(|y|)·ln 2`` relative: within ``rtol=1e-6`` while
    ``|y| ≤ 4``; over ranges reaching ``2**±100`` the bound is four ulps
    of ``|y|`` on top."""
    rng = np.random.default_rng(6)
    hi = (2.0 ** rng.uniform(-octaves + 2, octaves, 64)).astype(np.float32)
    lo = (hi * 2.0 ** -rng.uniform(0.01, min(30, octaves - 2), 64)).astype(np.float32)
    lo = np.maximum(lo, np.float32(2.0 ** -octaves))
    want = jax.vmap(lambda a, b: j_bucket_lower_edges(a, b, 128))(
        jnp.asarray(lo), jnp.asarray(hi))
    got = bucket_lower_edges(t(lo), t(hi), 128)
    rtol = 1e-6 if octaves <= 4 else 1e-6 + 4 * np.spacing(np.float32(octaves)) * np.log(2)
    np.testing.assert_allclose(n(got), n(want), rtol=rtol)
    assert SPAN_OCTAVES == J_SPAN_OCTAVES


def test_side_threshold_matches_jax():
    rng = np.random.default_rng(7)
    nseg, nbins = 24, 128
    hist = rng.poisson(rng.uniform(0, 40, (nseg, 1)), (nseg, nbins)).astype(np.float32)
    hist[3] = 0.0  # empty side: nothing feasible
    hist[4, :-1] = 0.0  # everything in the top bucket
    totals = hist.sum(1)
    k = np.maximum(1, (totals * rng.uniform(0.001, 0.5, nseg))).astype(np.float32)
    k[5] = totals[5] + 10  # fewer entries than k: select everything
    k[6] = 1.0
    hi = (10.0 ** rng.uniform(-4, 1, nseg)).astype(np.float32)
    lo = hi * np.float32(2.0 ** -30)
    edges = n(bucket_lower_edges(t(lo), t(hi), nbins))
    want = jax.vmap(j_side_threshold)(jnp.asarray(hist), jnp.asarray(edges),
                                      jnp.asarray(k))
    got = _side_threshold(t(hist), t(edges), t(k))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (nseg,)
        np.testing.assert_allclose(n(g), n(w), rtol=1e-6)


# ------------------------------------------------------------ wrapper rules


def _operands():
    segs, xpad, sob = segment_layout((300, 1500), seed=8)
    return t(xpad), t(hist_params(sob, *coarse_ranges(segs))), sob


@pytest.mark.parametrize("which", ["hist", "moments", "apply"])
def test_wrappers_reject_bad_operands(which):
    x, p5, sob = _operands()
    params = {"hist": p5, "moments": p5[:, :3].contiguous(),
              "apply": p5[:, 1:].contiguous()}[which]
    call = {
        "hist": lambda x, p: tflat.seg_hist2side(x, p, nseg=2, nbins=16),
        "moments": lambda x, p: tflat.seg_moments(x, p, nseg=2),
        "apply": lambda x, p: tflat.seg_binarize_apply(x, p),
    }[which]
    call(x, params)  # well-formed operands pass
    with pytest.raises(TypeError):
        call(x.double(), params)
    with pytest.raises(TypeError):
        call(x, params.double())
    with pytest.raises(ValueError):
        call(x.t().contiguous().t(), params)  # non-contiguous
    with pytest.raises(ValueError):
        call(x, params[:-1])  # one params row short
    with pytest.raises(ValueError):
        call(x[:-1], params)  # not a whole number of blocks


def _accumulate_operands():
    """Two leaves in segments at blocks 0 and 1 of a 3-block buffer (the
    second with a 2-block pad), and a residual."""
    leaves = [torch.ones(BM * LANES - 3), torch.full((7,), -2.0)]
    bounds = [(0, BM * LANES - 3), (BM * LANES, 7)]
    return leaves, torch.zeros(3 * BM * LANES), bounds, 3 * BM * LANES


@pytest.mark.parametrize("bad, error", [
    ("one leaf short", ValueError), ("a leaf's size", ValueError),
    ("offset off a block", ValueError), ("first offset", ValueError),
    ("overlap", ValueError), ("n_pad short", ValueError), ("n_pad off a block", ValueError),
    ("integer leaf", TypeError), ("f64 residual", TypeError), ("residual shape", ValueError),
])
def test_seg_accumulate_rejects_bad_operands(bad, error):
    leaves, res, bounds, n_pad = _accumulate_operands()
    acc, absmax = tflat.seg_accumulate(leaves, res, bounds, n_pad)  # well-formed: pass
    assert tuple(acc.shape) == (n_pad,) and absmax.tolist() == [1.0, 2.0]
    block = BM * LANES
    args = {
        "one leaf short": (leaves[:1], res, bounds, n_pad),
        "a leaf's size": ([leaves[0], torch.ones(8)], res, bounds, n_pad),
        "offset off a block": (leaves, res, [bounds[0], (block + 4, 7)], n_pad),
        "first offset": (leaves, res, [(block, block - 3), (2 * block, 7)], n_pad),
        "overlap": ([leaves[0], torch.ones(block - 3)], res, [bounds[0], (0, block - 3)],
                    n_pad),
        "n_pad short": (leaves, res[:block], bounds, block),
        "n_pad off a block": (leaves, res[:-4], bounds, n_pad - 4),
        "integer leaf": ([leaves[0].int(), leaves[1]], res, bounds, n_pad),
        "f64 residual": (leaves, res.double(), bounds, n_pad),
        "residual shape": (leaves, res[None], bounds, n_pad),
    }[bad]
    with pytest.raises(error):
        tflat.seg_accumulate(*args)


def test_cpu_tensors_leave_the_launch_counters_at_zero():
    tflat.reset_launches()
    x, p5, _ = _operands()
    tflat.seg_hist2side(x, p5, nseg=2, nbins=16)
    tflat.seg_moments(x, p5[:, :3].contiguous(), nseg=2)
    tflat.seg_binarize_apply(x, p5[:, 1:].contiguous())
    tflat.seg_accumulate(*_accumulate_operands())
    assert tflat.launch_counts() == {
        "seg_hist2side": 0, "seg_moments": 0, "seg_binarize_apply": 0, "seg_accumulate": 0}


# ------------------------------------------- one-launch kernels' geometry


@pytest.mark.parametrize("nblocks, sms, resident, grid", [
    (1230, 132, 8, 1056),  # LeNet5 on an H100: one full wave
    (1230, 132, 6, 792),
    (100, 132, 8, 100),    # fewer blocks than a wave: one CTA per block
    (1, 132, 8, 1),
    (0, 132, 8, 1),        # no block: one CTA still writes the result
])
def test_persistent_grid_fills_one_wave_at_most(nblocks, sms, resident, grid):
    assert _build.persistent_grid(nblocks, sms, resident) == grid


def test_workspace_is_one_zeroed_buffer_per_device_and_stream():
    ws = _build.Workspace()
    cpu = torch.device("cpu")
    a = ws.get(cpu, 7, 10)
    assert a.dtype == torch.int32 and a.numel() == 10 and not a.any()
    a[3] = 5  # what a kernel leaves is kept: only a new buffer is zeroed
    assert ws.get(cpu, 7, 10) is a and ws.get(cpu, 7, 4) is a
    b = ws.get(cpu, 8, 10)  # another stream: another buffer
    assert b is not a and not b.any()
    assert set(ws.buffers) == {("cpu", None, 7), ("cpu", None, 8)}


def test_workspace_grows_to_at_least_twice_its_size():
    ws = _build.Workspace()
    cpu = torch.device("cpu")
    a = ws.get(cpu, 0, 100)
    bigger = ws.get(cpu, 0, 101)
    assert bigger is not a and bigger.numel() == 200 and not bigger.any()
    assert ws.get(cpu, 0, 150) is bigger  # a smaller call keeps the larger buffer
    assert ws.get(cpu, 0, 1000).numel() == 1000
    assert ws.buffers[("cpu", None, 0)].numel() == 1000


def test_workspace_gives_a_captured_call_a_buffer_of_its_own():
    """A buffer zeroed inside a CUDA graph is zero only as the graph
    replays, and a graph may replay beside other calls: a captured call
    neither takes a kept buffer nor keeps its own."""
    ws = _build.Workspace()
    cpu = torch.device("cpu")
    captured = ws.get(cpu, 3, 10, capturing=True)
    assert not captured.any() and ws.buffers == {}
    kept = ws.get(cpu, 3, 10)
    assert kept is not captured
    again = ws.get(cpu, 3, 8, capturing=True)
    assert again is not kept and again.numel() == 8
    assert ws.buffers == {("cpu", None, 3): kept}
