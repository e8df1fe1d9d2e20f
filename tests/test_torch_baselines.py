"""The paper's baseline compressors in the port
(``repro_torch.core.baselines``) against the JAX package's
``repro.core.baselines``, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.

Tolerances:
  * the registry, every compressor's codec spec, residual and stochastic
    flags, the named codecs and ``NAIVE_POS_BITS``: equal;
  * the deterministic compressors (``none``, ``fedavg``, ``topk``,
    ``dgc``, ``dgc_policy``, ``signsgd``, ``onebit``, ``variance``):
    ``compress_leaf`` gives the reference's positions, values, scalar,
    dense payload and ``nbits`` bit for bit, and ``decompress_leaf`` its
    ΔW*; a tree compressed with error feedback gives the reference's
    compressed leaves, ΔW* and residual bit for bit over three rounds,
    and its SBW1 bytes;
  * the stochastic compressors (``terngrad``, ``qsgd``, ``randomk``):
    torch cannot draw threefry bits, so their structure is held exactly
    (``nbits``, the scalar s or the norm, the value grid, k distinct
    positions carrying the input's values) and their statistics as the
    reference's ``tests/test_compressors.py`` holds its own: the mean
    over 3,000 draws is the input (``terngrad`` to ``atol=0.03``,
    ``qsgd`` to ``0.02``, ``randomk`` rescaled by n/k to ``0.03``);
  * ``dgc_policy``: its per-leaf codecs and its warm-up rates at rounds
    0-9 on the paper's models equal the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core import api as japi
from repro.core import baselines as jbase
from repro.core import codec as jcodec
from repro.core import wire as jwire
from repro_torch.core import api as tapi
from repro_torch.core import baselines as tbase
from repro_torch.core import codec as tcodec
from repro_torch.core import wire as twire
from repro_torch.core.stages import LeafCompressed, k_for
from torch_helpers import n, t

BASELINES = ["none", "fedavg", "topk", "dgc", "dgc_policy", "signsgd", "onebit", "terngrad",
             "qsgd", "randomk", "variance"]
DETERMINISTIC = ["none", "fedavg", "topk", "dgc", "dgc_policy", "signsgd", "onebit",
                 "variance"]
STOCHASTIC = ["terngrad", "qsgd", "randomk"]


def bits_equal(a, b, what=""):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    view = np.uint32 if a.dtype.kind == "f" else a.dtype
    np.testing.assert_array_equal(a.view(view), b.view(view), err_msg=what)


def leaf(seed, size):
    """Heavy-tailed values of both signs with exact zeros, a -0.0 and ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(size) * np.exp(rng.standard_normal(size))).astype(np.float32)
    x[: size // 50] = 0.0
    x[size // 50] = -0.0
    if size > 16:
        x[-8:] = x[-9]  # a run of equal magnitudes, at the top-k boundary or not
    return x


# ------------------------------------------------------------- the registry


def test_registry_and_codecs_equal_the_reference():
    assert tapi.available() == japi.available()
    assert set(BASELINES) | {"sbc"} == set(tapi.available())
    assert tcodec.available_codecs() == jcodec.available_codecs()
    assert tbase.NAIVE_POS_BITS == jbase.NAIVE_POS_BITS == 16.0


@pytest.mark.parametrize("name", BASELINES)
def test_compressor_codec_and_flags(name):
    tc, jc = tapi.make_compressor(name), japi.make_compressor(name)
    assert tc.name == jc.name == name
    assert tc.codec.spec == jc.codec.spec
    assert (tc.use_residual, tc.stochastic) == (jc.use_residual, jc.stochastic)
    assert tc.codec.flat_kind == jc.codec.flat_kind
    assert tc.policy.name == jc.policy.name and tc.policy.fast == jc.policy.fast
    assert len(tc.policy.rules) == len(jc.policy.rules)
    for a, b in zip(tc.policy.rules, jc.policy.rules):
        assert (a.pattern, a.codec, a.sparsity, a.rate_scale) == \
            (b.pattern, b.codec, b.sparsity, b.rate_scale)
        assert (a.schedule is None) == (b.schedule is None)


@pytest.mark.parametrize("levels", [1, 4, 15, 127])
def test_qsgd_levels_reach_the_quantizer(levels):
    tc = tapi.make_compressor("qsgd", levels=levels)
    jc = japi.make_compressor("qsgd", levels=levels)
    assert tc.codec.quantizer.levels == jc.codec.quantizer.levels == levels
    for k in (1, 100, 4096):
        assert tc.codec.quantizer.value_bits(k) == jc.codec.quantizer.value_bits(k)


# ---------------------------------------------------- deterministic leaves


@pytest.mark.parametrize("name", DETERMINISTIC)
@pytest.mark.parametrize("size, p", [(4096, 0.01), (1000, 0.1), (70_001, 0.001), (257, 1.0),
                                     (5, 0.5)])
def test_deterministic_leaf_is_the_reference_bit_for_bit(name, size, p):
    x = leaf(size, size)
    tc, jc = tapi.make_compressor(name), japi.make_compressor(name)
    got = tc.compress_leaf(t(x), p, None)
    want = jc.compress_leaf(jnp.asarray(x), p, None)
    for field in LeafCompressed._fields:
        bits_equal(getattr(got, field), getattr(want, field), f"{name} {field}")
    bits_equal(tc.decompress_leaf(got, size), jc.decompress_leaf(want, size), f"{name} dW*")


@pytest.mark.parametrize("block", [16, 256, 1000])
def test_variance_block_is_the_reference_bit_for_bit(block):
    x = leaf(block, 3000)
    got = tapi.make_compressor("variance", block=block).compress_leaf(t(x), 0.02, None)
    want = japi.make_compressor("variance", block=block).compress_leaf(jnp.asarray(x), 0.02,
                                                                        None)
    for field in LeafCompressed._fields:
        bits_equal(getattr(got, field), getattr(want, field), f"block {block} {field}")


def tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((64, 48)) * 0.01).astype(np.float32),
            "b": (rng.standard_normal(48) * 0.01).astype(np.float32),
            "cell0": {"wx": (rng.standard_normal((40, 80)) * 0.01).astype(np.float32),
                      "bias": (rng.standard_normal(80) * 0.01).astype(np.float32)}}


@pytest.mark.parametrize("name", DETERMINISTIC)
@pytest.mark.parametrize("fast", [False, True], ids=["per-leaf", "fast"])
def test_tree_rounds_with_error_feedback_are_the_reference(name, fast):
    """Three rounds of ``ResolvedPolicy.compress`` with the residual carried,
    then the round's SBW1 bytes, in both packages."""
    import dataclasses

    tp, jp = tapi.make_compressor(name).policy, japi.make_compressor(name).policy
    tp, jp = dataclasses.replace(tp, fast=fast), dataclasses.replace(jp, fast=fast)
    like = tree(0)
    tr = tp.resolve({k: t(v) if not isinstance(v, dict) else {a: t(b) for a, b in v.items()}
                     for k, v in like.items()})
    jr = jp.resolve(jax.tree.map(jnp.asarray, like))
    tlike = jax.tree.map(t, like)
    tstate, jstate = tr.init_state(tlike), jr.init_state(jax.tree.map(jnp.asarray, like))
    for r in range(3):
        d = tree(r + 1)
        rates = tr.rates(0.05, r)
        assert rates == jr.rates(0.05, r)
        tcomp, tdense, tstate = tr.compress(jax.tree.map(t, d), tstate, rates)
        jcomp, jdense, jstate = jr.compress(jax.tree.map(jnp.asarray, d), jstate, rates)
        for a, b in zip(jax.tree.leaves(tdense), jax.tree.leaves(jdense)):
            bits_equal(a, b, f"round {r + 1} dW*")
        if tr.any_residual:  # a tree, or one flat buffer on the fast path in both
            tres, jres = jax.tree.leaves(tstate.residual), jax.tree.leaves(jstate.residual)
            assert len(tres) == len(jres)
            for a, b in zip(tres, jres):
                bits_equal(n(a).reshape(np.shape(b)), b, f"round {r + 1} residual")
        tw, jw = twire.wire_for(tr, tlike, 0.05, r), jwire.wire_for(
            jr, jax.tree.map(jnp.asarray, like), 0.05, r)
        assert tw.pack_with_bits(tcomp) == jw.pack_with_bits(jcomp)


# ------------------------------------------------------ stochastic leaves


def draws(comp, x, p, n_trials=3000):
    """``n_trials`` decompressed draws of ``comp`` on ``x``, one seeded
    generator each, and the leaves."""
    leaves = [comp.compress_leaf(t(x), p, torch.Generator().manual_seed(i))
              for i in range(n_trials)]
    dense = np.stack([n(comp.decompress_leaf(c, x.shape[0])) for c in leaves])
    return dense, leaves


@pytest.mark.parametrize("name", STOCHASTIC)
@pytest.mark.parametrize("size, p", [(4096, 0.01), (1000, 0.1), (7, 1.0)])
def test_stochastic_structure_is_the_reference(name, size, p):
    x = leaf(size, size)
    tc, jc = tapi.make_compressor(name), japi.make_compressor(name)
    got = tc.compress_leaf(t(x), p, torch.Generator().manual_seed(0))
    want = jc.compress_leaf(jnp.asarray(x), p, jax.random.PRNGKey(0))
    bits_equal(got.nbits, want.nbits, "nbits")
    for field in ("idx", "vals", "dense"):
        assert tuple(getattr(got, field).shape) == tuple(np.shape(getattr(want, field))), field
        assert n(getattr(got, field)).dtype == np.asarray(getattr(want, field)).dtype, field
    dense = n(tc.decompress_leaf(got, size))
    if name == "randomk":
        idx = n(got.idx).astype(np.int64)
        assert len(set(idx.tolist())) == idx.size == k_for(size, p)
        bits_equal(got.vals, x[idx], "randomk values are the input's")
        return
    # the scalar is deterministic: s = max|x| + 1e-12, or the norm
    bits_equal(got.mean, want.mean, f"{name} scale")
    s = float(n(got.mean))
    if name == "terngrad":
        assert set(np.unique(np.abs(dense)).tolist()) <= {0.0, np.float32(s)}
        assert np.all((dense == 0) | (np.sign(dense) == np.sign(x)))
    else:
        levels = tc.codec.quantizer.levels
        q = np.abs(dense) * levels / np.float32(s)
        scaled = np.abs(x) / np.float32(s) * levels
        assert np.all((np.abs(q - np.floor(scaled)) < 1e-3) | (np.abs(q - np.floor(scaled) - 1)
                                                               < 1e-3))


X4 = np.array([0.5, -0.25, 0.1, 0.0], np.float32)


@pytest.mark.parametrize("name, atol", [("terngrad", 0.03), ("qsgd", 0.02)])
def test_quantizers_are_unbiased(name, atol):
    dense, _ = draws(tapi.make_compressor(name), X4, 1.0)
    np.testing.assert_allclose(dense.mean(0), X4, atol=atol)


def test_randomk_is_unbiased_after_rescaling():
    size, p = 8, 0.25
    x = np.array([0.5, -0.25, 0.1, 0.0, 0.3, -0.7, 0.05, 0.2], np.float32)
    dense, leaves = draws(tapi.make_compressor("randomk"), x, p)
    k = k_for(size, p)
    np.testing.assert_allclose(dense.mean(0) * size / k, x, atol=0.03)
    # every position is drawn about k/n of the time
    freq = np.bincount(np.concatenate([n(c.idx) for c in leaves]), minlength=size) / 3000
    np.testing.assert_allclose(freq, k / size, atol=0.03)


def test_stochastic_draws_follow_the_generator():
    x = leaf(3, 4096)
    for name in STOCHASTIC:
        comp = tapi.make_compressor(name)
        a = comp.compress_leaf(t(x), 0.01, torch.Generator().manual_seed(5))
        b = comp.compress_leaf(t(x), 0.01, torch.Generator().manual_seed(5))
        c = comp.compress_leaf(t(x), 0.01, torch.Generator().manual_seed(6))
        assert all(torch.equal(u, v) for u, v in zip(a, b)), name
        assert not all(torch.equal(u, v) for u, v in zip(a, c)), name


# ---------------------------------------------------------------- DGC


def model_tree(name):
    from repro.configs.base import get_config as jget
    from repro.models.model import build_model as jbuild

    cfg = jget(name)
    return jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("model", ["lenet5", "charlstm", "resnet32"])
@pytest.mark.parametrize("kw", [{}, dict(target_sparsity=0.01, warmup_rounds=2)])
def test_dgc_policy_resolves_and_warms_up_as_the_reference(model, kw):
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model

    like = build_model(get_config(model)).init(torch.Generator().manual_seed(0))
    tr = tbase.dgc_policy(**kw).resolve(like)
    jr = jbase.dgc_policy(**kw).resolve(model_tree(model))
    assert [(p.path, p.codec.spec) for p in tr.plans] == \
        [(p.path, p.codec.spec) for p in jr.plans]
    assert tr.describe() == jr.describe()
    for r in range(10):
        assert tr.rates(0.5, r) == jr.rates(0.5, r)
    with pytest.raises(ValueError, match="schedule"):
        tapi.make_compressor("dgc_policy", **kw).compress(
            like, tr.init_state(like), 0.01)
