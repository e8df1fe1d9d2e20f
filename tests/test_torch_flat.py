"""The port's sharded flat space (repro_torch.core.flat) against the JAX
package's ``ShardedFlatParamSpace``.

The layout is integer bookkeeping and must be equal: block counts,
padded length, the per-block segment ids, segment offsets and the Eq. 1
bit count.  Flatten/unflatten move f32 values and must be bit-exact.  The
hist exchange is held to the tolerances of ``test_torch_kernels_flat.py``:
its selection may differ only at entries next to a threshold.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flat import ShardedFlatParamSpace as JSpace
from repro.core.flat import _hist_pipeline as j_hist_pipeline
from repro.core.stages import k_for as j_k_for
from repro_torch.core.flat import ShardedFlatParamSpace as TSpace
from repro_torch.core.flat import _hist_pipeline as t_hist_pipeline
from repro_torch.core.stages import k_for
from repro_torch.kernels import flat as tflat
from repro_torch.launch.mesh import make_host_group
from torch_helpers import n, t

# LeNet5's leaves in JAX's tree-flatten order (sorted keys)
LENET5 = (("c1", (5, 5, 1, 20)), ("c2", (5, 5, 20, 50)), ("f1", (2450, 500)),
          ("f1b", (500,)), ("f2", (500, 10)), ("f2b", (10,)))


# the same net at img_size=12 (f1 takes 3·3·50 features): the hist tests
# run the JAX kernels in interpret mode, so they use this smaller layout
LENET5_12 = tuple((p, (450, 500) if p == "f1" else s) for p, s in LENET5)


def lenet5_entries(rate=0.01, leaves=LENET5):
    return [dict(path=p, shape=s, rows=1, kind="sparse", rate=rate, n_shards=1,
                 global_size=int(np.prod(s))) for p, s in leaves]


def mixed_entries():
    """Ragged leaves, a scanned (rows > 1) leaf, per-leaf rates, and the
    dense/skip kinds the bit count must price."""
    return [
        dict(path="a", shape=(70, 80), rows=1, kind="sparse", rate=0.01,
             n_shards=2, global_size=11200),
        dict(path="stack/scan/w", shape=(3, 40, 33), rows=3, kind="sparse",
             rate=0.05, n_shards=1, global_size=3960),
        dict(path="b", shape=(333,), rows=1, kind="dense", rate=1.0,
             n_shards=1, global_size=333),
        dict(path="z", shape=(17,), rows=1, kind="skip", rate=0.0,
             n_shards=1, global_size=17),
    ]


def both(entries, **kw):
    axes = dict(client_axes=("data",), shard_axes=("model",), n_clients=1,
                shards_per_client=1)
    axes.update(kw)
    return JSpace.build(entries, **axes), TSpace.build(entries, **axes, group=make_host_group("cpu"))


@pytest.mark.parametrize("which", ["lenet5", "mixed"])
def test_layout_and_bits_equal_the_jax_space(which):
    entries = lenet5_entries() if which == "lenet5" else mixed_entries()
    js, ts = both(entries)
    assert ts.n_blocks == js.n_blocks and ts.n_pad == js.n_pad
    assert ts.n_total == js.n_total
    np.testing.assert_array_equal(ts.seg_of_block, js.seg_of_block)
    assert [s.offset for s in ts.segments] == [s.offset for s in js.segments]
    assert [s.k for s in ts.segments] == [s.k for s in js.segments]
    assert ts.bits_per_client() == js.bits_per_client()
    assert tuple(ts.zeros_residual("cpu").shape) == tuple(js.zeros_residual().shape)
    if which == "lenet5":
        assert ts.n_blocks == 1230 and ts.n_pad == 1_259_520
        per_seg = np.bincount(ts.seg_of_block)
        assert per_seg.tolist() == [1, 25, 1197, 1, 5, 1]


def test_flatten_matches_jax_and_round_trips_bitwise():
    js, ts = both(mixed_entries())
    rng = np.random.default_rng(0)
    bodies = [rng.standard_normal(s.shape).astype(np.float32) for s in js.segments]
    bodies[0][0, :3] = [-0.0, np.inf, np.float32(1e-40)]  # sign, inf, denormal
    want = n(js.flatten_local([jnp.asarray(b) for b in bodies]))
    got = ts.flatten_local([t(b) for b in bodies])
    np.testing.assert_array_equal(n(got).view(np.uint32), want.view(np.uint32))
    for b, u in zip(bodies, ts.unflatten_local(got)):
        assert tuple(u.shape) == b.shape
        np.testing.assert_array_equal(n(u).view(np.uint32), b.view(np.uint32))
    pad = np.ones(ts.n_pad, bool)
    for s in ts.segments:
        pad[s.offset:s.offset + s.rows * s.n_loc] = False
    assert not n(got)[pad].any()


def _warm_like_bodies(shapes, seed):
    """Accumulators with a real spread of magnitudes on both sides (what a
    warm optimizer state produces), so μ⁺ and μ⁻ are well apart."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * np.exp(rng.standard_normal(s))
             * 10.0 ** rng.uniform(-4, -2)).astype(np.float32) for s in shapes]


def test_hist_pipeline_stats_match_jax():
    js, ts = both(lenet5_entries(leaves=LENET5_12))
    bodies = _warm_like_bodies([s for _, s in LENET5_12], seed=1)
    acc = js.flatten_local([jnp.asarray(b) for b in bodies])
    bounds = [(s.offset, s.n_loc) for s in js.segments]
    rates = [s.rate for s in js.segments]
    ks = [j_k_for(s.n_loc, s.rate) for s in js.segments]
    assert ks == [k_for(s.n_loc, s.rate) for s in ts.segments]
    j_out, j_res, j_stats = j_hist_pipeline(
        acc, bounds, ks, rates, js.seg_of_block, js.n_blocks, 8, 128, 128, True)
    t_out, t_res, t_stats = t_hist_pipeline(
        t(acc), bounds, ks, rates, torch.from_numpy(ts.seg_of_block.astype(np.int64)),
        ts.n_blocks, 8, 128, 128, absmax=tflat.seg_absmax(t(acc), bounds))
    np.testing.assert_allclose(n(t_stats["mu"]), n(j_stats["mu"]), rtol=1e-5)
    np.testing.assert_array_equal(n(t_stats["count"]), n(j_stats["count"]))
    np.testing.assert_allclose(n(t_stats["nbits"]), n(j_stats["nbits"]), rtol=1e-6)
    np.testing.assert_array_equal(n(t_out) != 0, n(j_out) != 0)
    # the residual is acc − ΔW*, exactly, in both packages
    np.testing.assert_array_equal(n(t_res), n(acc) - n(t_out))


def test_exchange_local_hist_matches_jax():
    """One client: the exchange's mean is this client's own ΔW*.  (The JAX
    space runs with no client axis here: its ``pmean`` needs a mesh, and
    over one client it is the identity.)"""
    js, ts = both(lenet5_entries(leaves=LENET5_12))
    js = dataclasses.replace(js, client_axes=())
    bodies = _warm_like_bodies([s for _, s in LENET5_12], seed=2)
    res = (np.random.default_rng(3).standard_normal(ts.n_pad) * 1e-4).astype(np.float32)
    for s in ts.segments:  # pad tails stay zero
        res[s.offset + s.n_loc:s.offset + -(-s.n_loc // 1024) * 1024] = 0.0
    j_mean, j_own, j_res = js.exchange_local_hist(
        [jnp.asarray(b) for b in bodies], jnp.asarray(res))
    t_mean, t_own, t_res = ts.exchange_local_hist([t(b) for b in bodies], t(res))
    assert t_mean is t_own
    np.testing.assert_array_equal(n(t_own) != 0, n(j_own) != 0)
    np.testing.assert_allclose(n(t_own), n(j_own), rtol=1e-5)
    acc = res + n(ts.flatten_local([t(b) for b in bodies]))
    np.testing.assert_array_equal(n(t_res), acc - n(t_own))
    # unselected entries keep acc exactly; selected ones differ by ΔW*'s μ
    kept = n(t_own) == 0
    np.testing.assert_array_equal(n(t_res)[kept], n(j_res)[kept])
    assert ts.exchange_local_hist([t(b) for b in bodies], None)[2] is None


def test_exchange_local_hist_refuses_what_the_slice_lacks():
    _, ts = both(mixed_entries())
    bodies = [torch.zeros(s.shape) for s in ts.segments]
    with pytest.raises(ValueError, match="all-SBC"):
        ts.exchange_local_hist(bodies, None)
    _, ts2 = both(lenet5_entries(), n_clients=4)
    bodies = [torch.zeros(s) for _, s in LENET5]
    with pytest.raises(ValueError, match="needs a ClientGroup of 4 ranks"):
        ts2.exchange_local_hist(bodies, None)


# ----------------------------------------- the fused front of the exchange

# every leaf whole blocks (the flatten is a concat), and ragged leaves
# whose blocks end in pad
ACC_LAYOUTS = {
    "contiguous": (("w", (4, 1024)), ("b", (1024,)), ("v", (2, 8, 128)), ("u", (3, 1024))),
    "padded": (("a", (70, 80)), ("b", (333,)), ("c", (3, 40, 33)), ("d", (17,))),
}


def acc_space(layout: str) -> TSpace:
    return both(lenet5_entries(leaves=ACC_LAYOUTS[layout]))[1]


def acc_operands(space: TSpace, dtype, residual: bool, seed: int):
    """Leaves in ``dtype`` with NaN, ±inf, −0.0 and denormals in segment 0,
    only −0.0, zeros and denormals in segment 1 (its max a denormal), −inf
    in segment 2; an f32 residual with −0.0 and denormals (segment 1's
    entries zero but one denormal) and a nonzero pad entry (in no
    segment's max), or None."""
    rng = np.random.default_rng(seed)
    bodies = [(rng.standard_normal(s.shape) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
              for s in space.segments]
    b0, b1, b2 = (b.reshape(-1) for b in bodies[:3])
    b0[:6] = [np.nan, np.inf, -np.inf, -0.0, np.float32(1e-40), np.float32(-3e-39)]
    b1[:] = 0.0
    b1[::3] = -0.0
    b1[1::7] = np.float32(-2e-41)
    b1[5] = np.float32(7e-41)
    b2[4] = -np.inf
    res = None
    if residual:
        res = (rng.standard_normal(space.n_pad) * 1e-3).astype(np.float32)
        res[3], res[4] = -0.0, np.float32(1e-39)
        s1 = space.segments[1]
        res[s1.offset:s1.offset + s1.n_loc] = 0.0  # segment 1 stays denormal
        res[s1.offset + 2] = np.float32(1e-39)
        s = space.segments[-1]
        res[s.offset + s.n_loc:] = 0.0
        if space.n_pad > space.n_total:
            res[s.offset + s.n_loc] = 5.0  # a pad entry: acc there, but in no max
        res = t(res)
    return [t(b).to(dtype) for b in bodies], res


def bits(x: torch.Tensor) -> np.ndarray:
    return n(x).view(np.uint32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64],
                         ids=lambda d: str(d).split(".")[1])
@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no-residual"])
@pytest.mark.parametrize("layout", sorted(ACC_LAYOUTS))
def test_seg_accumulate_plain_is_the_exchange_front(layout, residual, dtype):
    """``seg_accumulate_plain`` (and the wrapper's CPU route) give the bits
    of the composition the exchange ran: ``flatten_local``, ``res +``, and
    an ``amax(abs(...))`` a segment."""
    space = acc_space(layout)
    assert (space.n_pad == space.n_total) == (layout == "contiguous")
    bodies, res = acc_operands(space, dtype, residual, seed=4)
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    want = space.flatten_local(bodies)
    if res is not None:
        want = res + want
    want_max = torch.stack([torch.amax(torch.abs(want[off:off + size])) for off, size in bounds])
    for fn in (tflat.seg_accumulate_plain, tflat.seg_accumulate):
        acc, absmax = fn(bodies, res, bounds, space.n_pad)
        assert acc.dtype == absmax.dtype == torch.float32
        assert tuple(acc.shape) == (space.n_pad,) and tuple(absmax.shape) == (len(bounds),)
        np.testing.assert_array_equal(bits(acc), bits(want))
        np.testing.assert_array_equal(bits(absmax), bits(want_max))
    got = n(absmax)
    assert np.isnan(got[0]) and got[2] == np.inf
    assert 0.0 < got[1] < np.finfo(np.float32).tiny or dtype == torch.float16


@pytest.mark.parametrize("shards", [1, 2])
def test_exchange_local_hist_takes_the_fused_front_on_one_device(shards, monkeypatch):
    """One device a client: the exchange builds its buffer and maxima with
    one ``seg_accumulate`` call; several: the flatten from the shards'
    blocks and ``seg_absmax``, no call.  Either way its outputs are the
    bits of the composition run through the pipeline."""
    from repro_torch.core import flat as core_flat

    if shards == 1:
        space = acc_space("padded")
    else:
        space = TSpace.build(
            [dict(path="w", shape=(64,), rows=1, kind="sparse", rate=0.1, n_shards=2,
                  global_size=128, grid=(2,), dev_block=(0, 1)),
             dict(path="v", shape=(4, 300), rows=1, kind="sparse", rate=0.05, n_shards=2,
                  global_size=2400, grid=(2, 1), dev_block=(0, 1))],
            client_axes=("data",), shard_axes=("model",), n_clients=1, shards_per_client=2,
            group=make_host_group("cpu"))
    rng = np.random.default_rng(5)
    shape = lambda s: tuple(g * d for g, d in zip(s.grid + (1,) * len(s.shape), s.shape))
    bodies = [t(rng.standard_normal(shape(s)).astype(np.float32)) for s in space.segments]
    res = t((rng.standard_normal(space.local_shape) * 1e-3).astype(np.float32))
    calls = []
    real = core_flat.seg_accumulate
    monkeypatch.setattr(core_flat, "seg_accumulate",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    tflat.reset_launches()
    mean, own, new_res = space.exchange_local_hist(bodies, res)
    assert len(calls) == (1 if shards == 1 else 0)
    assert tflat.launch_counts()["seg_accumulate"] == 0
    acc = res + space.flatten_local(bodies)
    bounds = [(s.offset, s.rows * s.n_loc) for s in space.segments]
    want_own, want_res, _ = core_flat._hist_pipeline(
        acc, bounds, [k_for(b, s.rate) for (_, b), s in zip(bounds, space.segments)],
        [s.rate for s in space.segments], torch.from_numpy(space.seg_of_block.astype(np.int64)),
        space.n_blocks, space.bm, space.lanes, 128, absmax=tflat.seg_absmax(acc, bounds))
    assert mean is own and (own != 0).any()
    np.testing.assert_array_equal(bits(own), bits(want_own))
    np.testing.assert_array_equal(bits(new_res), bits(want_res))
