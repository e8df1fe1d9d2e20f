"""The port's codec stages (``repro_torch.core.stages``) against the JAX
package's ``repro.core.stages``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * deterministic selectors (``dense``, ``skip``, ``topk``,
    ``topk_signed``, ``threshold``, ``variance``, ``expert_topk``):
    positions and values bit-exact, in the reference's order (ties and
    ±0 included: the port ranks as ``lax.top_k`` does);
  * deterministic quantizers (``identity``, ``binarize``, ``sign``,
    ``two_means``): values and scalar bit-exact, the scalars summed in
    XLA's f32 order;
  * ``ternary`` and ``stochastic``: the scalar (max |v| + 1e-12, the
    norm) bit-exact; the random part has the reference's structure and
    statistics only (torch cannot draw JAX's threefry bits): values on
    the reference's grid, and unbiased over 4,000 draws (the entries'
    errors in standard errors have mean 0 within 4 standard errors of
    their mean, and mean square in [0.8, 1.25]);
  * ``randomk``: k distinct positions, values ``flat[idx]``, every slot
    drawn with frequency k/n within 4 standard errors;
  * ``Codec.compress_leaf`` and ``decompress_leaf`` of every
    deterministic codec: every ``LeafCompressed`` field and the dense
    reconstruction bit-exact; ``nbits`` equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as jcodec
from repro.core import stages as jst
from repro_torch.core import codec as tcodec
from repro_torch.core import stages as tst
from torch_helpers import n, t


def draw(size, seed, kind="random"):
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.standard_normal(size) * np.exp(rng.standard_normal(size))
    elif kind == "ties":  # few distinct values, zeros of both signs
        x = rng.choice(np.array([0.0, -0.0, 1.0, 1.0, 0.5, -0.5, -1.0]), size=size)
    else:  # "experts": 4 experts, two of them unrouted (all zero)
        x = rng.standard_normal(size)
        q = size // 4
        x[q:2 * q] = 0.0
        x[3 * q:] = 0.0
    return np.asarray(x, np.float32)


def bits_equal(a, b):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a, b)


SELECTORS = [
    ("dense", {}), ("skip", {}), ("topk", {}), ("topk_signed", {}),
    ("threshold", {"tau": 0.3}), ("variance", {}), ("variance", {"block": 16}),
    ("expert_topk", {"experts": 4}), ("expert_topk", {"experts": 3}),
]


@pytest.mark.parametrize("name,kw", SELECTORS,
                         ids=[f"{s}{'-' + str(k) if k else ''}" for s, k in SELECTORS])
@pytest.mark.parametrize("size,p,kind", [(1000, 0.01, "random"), (4096, 0.02, "random"),
                                         (700, 0.05, "ties"), (1024, 0.03, "experts"),
                                         (7, 0.5, "random")],
                         ids=["n1000", "n4096", "ties", "experts", "n7"])
def test_deterministic_selectors_match_jax(name, kw, size, p, kind):
    x = draw(size, 3, kind)
    want = jst.get_selector(name, **kw)(jnp.asarray(x), p, None)
    got = tst.get_selector(name, **kw)(t(x), p, None)
    assert got.idx.dtype == torch.int32
    bits_equal(got.idx, want.idx)
    bits_equal(got.vals, want.vals)


def _selection(size, seed, kind="random"):
    x = draw(size, seed, kind)
    return jst.Selection(jnp.arange(size, dtype=jnp.int32), jnp.asarray(x)), \
        tst.Selection(torch.arange(size, dtype=torch.int32), t(x))


@pytest.mark.parametrize("name", ["identity", "binarize", "sign", "two_means"])
@pytest.mark.parametrize("size,kind", [(5, "random"), (250, "random"), (12_250, "random"),
                                       (1000, "ties")])
def test_deterministic_quantizers_match_jax(name, size, kind):
    jsel, tsel = _selection(size, 5, kind)
    want_v, want_s = jst.get_quantizer(name)(jsel, None)
    got_v, got_s = tst.get_quantizer(name)(tsel, None)
    bits_equal(got_v, want_v)
    bits_equal(got_s, want_s)


@pytest.mark.parametrize("name,analytic", [
    ("identity", 32.0 * 37), ("binarize", 32.0), ("sign", 37 + 32.0),
    ("two_means", 37 + 64.0), ("ternary", np.log2(3.0) * 37 + 32.0),
    ("stochastic", np.log2(31.0) * 37 + 32.0)])
def test_value_bits_and_flags_match_jax(name, analytic):
    jq, tq = jst.get_quantizer(name), tst.get_quantizer(name)
    assert tq.value_bits(37) == jq.value_bits(37) == pytest.approx(analytic)
    assert (tq.stochastic, tq.levels, tq.flat_fast) == (jq.stochastic, jq.levels, jq.flat_fast)


def test_registries_and_encoders_match_jax():
    assert tst.available_stages() == jst.available_stages()
    for name in jst.available_stages()["encoders"]:
        je, te = jst.get_encoder(name), tst.get_encoder(name)
        for args in ((1000, 10, 0.01), (50, 50, 1.0), (70000, 700, 0.01)):
            assert te.position_bits(*args) == je.position_bits(*args), name
        assert te.flat_fast == je.flat_fast
    for name in jst.available_stages()["selectors"]:
        js, ts = jst.get_selector(name), tst.get_selector(name)
        assert (ts.dense, ts.skip, ts.stochastic, ts.flat_fast) == (
            js.dense, js.skip, js.stochastic, js.flat_fast), name
    with pytest.raises(KeyError):
        tst.get_selector("nope")


# ------------------------------------------------------------ stochastic


def gen(seed):
    return torch.Generator().manual_seed(seed)


def test_randomk_structure_and_frequency():
    x = draw(200, 1)
    sel = tst.get_selector("randomk")
    k = tst.k_for(200, 0.1)
    counts = np.zeros(200)
    draws = 2000
    for s in range(draws):
        got = sel(t(x), 0.1, gen(s))
        idx = n(got.idx)
        assert got.idx.dtype == torch.int32 and idx.size == k
        assert len(set(idx.tolist())) == k and idx.min() >= 0 and idx.max() < 200
        bits_equal(got.vals, x[idx])
        counts[idx] += 1
    # each slot is drawn with probability k/n
    q = k / 200
    assert np.abs(counts / draws - q).max() <= 4 * np.sqrt(q * (1 - q) / draws) + 1e-12
    # the same generator seed gives the same draw; the global generator is untouched
    state = torch.random.get_rng_state()
    a, b = sel(t(x), 0.1, gen(7)), sel(t(x), 0.1, gen(7))
    assert torch.equal(a.idx, b.idx)
    assert torch.equal(state, torch.random.get_rng_state())


@pytest.mark.parametrize("name", ["ternary", "stochastic"])
def test_stochastic_quantizers_scalar_grid_and_unbiased(name):
    jsel, tsel = _selection(300, 9)
    v = n(tsel.vals)
    _, want_s = jst.get_quantizer(name)(jsel, __import__("jax").random.PRNGKey(0))
    q = tst.get_quantizer(name)
    outs = []
    for s in range(4000):
        got_v, got_s = q(tsel, gen(s))
        bits_equal(got_s, want_s)
        outs.append(n(got_v))
    outs = np.stack(outs)
    scale = float(want_s)
    if name == "ternary":
        assert set(np.unique(np.abs(outs))) <= {0.0, np.float32(scale)}
    else:  # norm · sign · level / 15 with integer levels 0..15
        levels = np.abs(outs) * 15 / scale
        assert np.allclose(levels, np.round(levels), atol=1e-3) and levels.max() <= 15.001
    # unbiased: E[out] = v.  Each entry's mean over the draws, in units of
    # its standard error (from the Bernoulli draw each entry makes), has
    # mean 0 and mean square 1 over the entries.
    if name == "ternary":
        f = np.abs(v) / scale
        step = scale
    else:
        scaled = np.abs(v) / scale * 15
        f = scaled - np.floor(scaled)
        step = scale / 15
    se = step * np.sqrt(f * (1 - f) / len(outs))
    live = se > 0
    z = (outs.mean(0) - v)[live] / se[live]
    assert abs(z.mean()) < 4 / np.sqrt(live.sum()) and 0.8 < (z ** 2).mean() < 1.25


# --------------------------------------------------- codecs end to end

CODECS = ["sbc", "dense32", "skip", "topk|identity|raw16", "topk|identity|golomb",
          "topk_signed|identity|bitmask", "threshold|sign|raw32",
          "variance|identity|golomb", "expert_topk|identity|golomb",
          "dense|sign|none", "dense|two_means|none", "topk|binarize|golomb"]


@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("size,p", [(4096, 0.02), (500, 0.01), (33, 0.3)])
def test_compress_leaf_and_decompress_match_jax(spec, size, p):
    import repro.core  # noqa: F401  (registers the reference's "sbc")
    import repro_torch.core  # noqa: F401

    x = draw(size, 21)
    jc, tc = jcodec.make_codec(spec), tcodec.make_codec(spec)
    assert tc.spec == jc.spec and tc.flat_kind == jc.flat_kind
    assert tcodec.leaf_k(tc, size, p) == jcodec.leaf_k(jc, size, p)
    want = jc.compress_leaf(jnp.asarray(x), p, None)
    got = tc.compress_leaf(t(x), p, None)
    for field in tst.LeafCompressed._fields:
        bits_equal(getattr(got, field), getattr(want, field))
    bits_equal(tst.decompress_leaf(got, size), jst.decompress_leaf(want, size))


def test_stochastic_codec_is_reproducible_from_its_generator():
    import repro_torch.core  # noqa: F401

    c = tcodec.make_codec("randomk|stochastic|raw32")
    x = t(draw(1000, 2))
    a, b = c.compress_leaf(x, 0.05, gen(3)), c.compress_leaf(x, 0.05, gen(3))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    other = c.compress_leaf(x, 0.05, gen(4))
    assert not torch.equal(a.idx, other.idx)


def test_decompress_leaf_handles_reference_drawn_leaves():
    """``decompress_leaf`` of a ``LeafCompressed`` drawn by the reference's
    stochastic codecs, handed across as numpy, rebuilds the reference's
    dense update bit for bit."""
    import jax

    x = jnp.asarray(draw(800, 4))
    for spec in ("randomk|identity|raw32", "topk|ternary|raw32", "dense|stochastic|none"):
        want = jcodec.make_codec(spec).compress_leaf(x, 0.05, jax.random.PRNGKey(1))
        got = tst.LeafCompressed(*(torch.from_numpy(np.array(f)) for f in want))
        bits_equal(tst.decompress_leaf(got, 800), jst.decompress_leaf(want, 800))
