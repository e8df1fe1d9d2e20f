"""The port's codec, policy and compressor API (``repro_torch.core.codec``,
``policy``, ``api``, ``sbc``, ``residual``, ``tree``) against the JAX
package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Every comparison here is exact: plans, rates, ``describe`` text, leaf
order and paths equal; ``ResolvedPolicy.compress`` over three rounds of
error feedback gives every ``LeafCompressed`` field, ΔW* and the
residuals bit for bit (deterministic codecs only: the stochastic stages'
parity is statistical, ``test_torch_stages.py``).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core import api as japi
from repro.core import policy as jpol
from repro.core import residual as jres
from repro.core import sbc as jsbc
from repro.core.codec import make_codec as j_make_codec
from repro_torch.core import api as tapi
from repro_torch.core import policy as tpol
from repro_torch.core import residual as tres
from repro_torch.core import sbc as tsbc
from repro_torch.core.codec import make_codec as t_make_codec
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from torch_helpers import n, t


def bits_equal(a, b, what=""):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32), err_msg=what)
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


# the tree and policies of tests/test_channel_parity.py's device-pack oracle
def channel_tree(seed=3):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal(4096).astype(np.float32),
            "v": rng.standard_normal((64, 8)).astype(np.float32),
            "bias": rng.standard_normal(16).astype(np.float32),
            "skipme": rng.standard_normal(32).astype(np.float32)}


def lenet_tree(seed=0):
    """A LeNet5-shaped tree (narrow widths): the leaves of the preset."""
    rng = np.random.default_rng(seed)
    shapes = {"c1": (5, 5, 1, 4), "c2": (5, 5, 4, 8), "f1": (128, 50), "f1b": (50,),
              "f2": (50, 10), "f2b": (10,)}
    return {k: (0.01 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}


def policies(pkg):
    make, pol = (j_make_codec, jpol) if pkg == "jax" else (t_make_codec, tpol)
    return {
        "local-sbc": pol.CompressionPolicy.single(make("sbc")),
        "fed-dense-small": pol.CompressionPolicy(
            default=make("sbc"),
            rules=(pol.PolicyRule(pol.DENSE_SMALL_PATTERN, codec="dense32"),)),
        "gspmd-mixed": pol.CompressionPolicy(
            default=make("sbc"),
            rules=(pol.PolicyRule(r"bias", codec="dense32"),
                   pol.PolicyRule(r"skipme", codec="skip"))),
        "lenet-dense-biases": pol.CompressionPolicy(
            default=make("sbc"), rules=(pol.PolicyRule(r"^f[12]b$", codec="dense32"),),
            name="sbc+rules"),
        "mixed-codecs": pol.CompressionPolicy(
            default=make("sbc"),
            rules=(pol.PolicyRule(r"^v$", codec="topk|identity|raw16", sparsity=0.05),
                   pol.PolicyRule(r"bias", codec="dense|sign|none"),
                   pol.PolicyRule(r"skipme", codec=make("dense32", use_residual=False)))),
    }


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree):
    return {k: t(v) for k, v in tree.items()}


# ------------------------------------------------------------------ tree


def test_tree_flatten_order_and_paths_match_jax():
    tree = {"b": [np.zeros(2), {"z": np.ones(1), "a": np.ones(3)}], "a": (np.ones(4),),
            "c": {"w": np.zeros(5)}}
    jflat, _ = jax.tree_util.tree_flatten_with_path(tree)
    tflat, treedef = tree_flatten_with_path(tree)
    assert [jpol.path_str(p) for p, _ in jflat] == [tpol.path_str(p) for p, _ in tflat] \
        == ["a/0", "b/0", "b/1/a", "b/1/z", "c/w"]
    assert all(a is b for (_, a), (_, b) in zip(jflat, tflat))
    leaves, _ = tree_flatten(tree)
    rebuilt = treedef.unflatten(leaves)
    assert tree_flatten(rebuilt)[1] == treedef
    assert treedef.flatten_up_to(tree_map(lambda x: x.size, tree)) == [4, 2, 3, 1, 5]
    with pytest.raises(ValueError, match="structure mismatch"):
        treedef.flatten_up_to({"a": (1,), "b": [1, {"z": 1}], "c": {"w": 1}})


# -------------------------------------------------------- codecs, rules


@pytest.mark.parametrize("spec", ["sbc", "dense32", "skip", "topk_signed|binarize|golomb",
                                  "topk|sign|bitmask", "dense|two_means|none",
                                  "expert_topk|identity|golomb"])
def test_make_codec_specs_match_jax(spec):
    jc, tc = j_make_codec(spec), t_make_codec(spec)
    assert (tc.spec, tc.use_residual, tc.stochastic, tc.skip, tc.flat_kind) == (
        jc.spec, jc.use_residual, jc.stochastic, jc.skip, jc.flat_kind)
    assert t_make_codec(tc) is tc
    assert t_make_codec("dense32", use_residual=False).use_residual is False


def test_unknown_and_baseline_names():
    with pytest.raises(KeyError):
        t_make_codec("nope")
    # the paper's baselines are registered, as in the reference
    assert tapi.make_compressor("signsgd").codec.spec == \
        japi.make_compressor("signsgd").codec.spec
    with pytest.raises(KeyError):
        tapi.make_compressor("nope")
    assert "sbc" in tapi.available()
    with pytest.warns(DeprecationWarning):
        assert tapi.get_compressor("sbc").codec.spec == japi.make_compressor("sbc").codec.spec


@pytest.mark.parametrize("name", ["local-sbc", "fed-dense-small", "gspmd-mixed",
                                  "lenet-dense-biases", "mixed-codecs"])
def test_resolve_plans_and_describe_match_jax(name):
    tree = lenet_tree() if name == "lenet-dense-biases" else channel_tree()
    jres_ = policies("jax")[name].resolve(to_jax(tree))
    tres_ = policies("torch")[name].resolve(to_torch(tree))
    assert [p.path for p in tres_.plans] == [p.path for p in jres_.plans]
    assert [p.codec.spec for p in tres_.plans] == [p.codec.spec for p in jres_.plans]
    assert tres_.describe() == jres_.describe()
    assert tres_.rates(0.02) == jres_.rates(0.02)
    assert (tres_.any_residual, tres_.any_stochastic, tres_.fast_compatible) == (
        jres_.any_residual, jres_.any_stochastic, jres_.fast_compatible)


def test_rates_schedules_and_rate_scale_match_jax():
    def build(pol, make):
        return pol.CompressionPolicy(
            default=make("sbc"),
            rules=(pol.PolicyRule(r"^w$", schedule=lambda r: 0.25 / (r + 1)),
                   pol.PolicyRule(r"^v$", sparsity=0.3, rate_scale=0.5),
                   pol.PolicyRule(r"bias", rate_scale=0.25),
                   pol.PolicyRule(r"skipme", sparsity=2.0)),
            name="sched")

    tree = channel_tree()
    jr = build(jpol, j_make_codec).resolve(to_jax(tree))
    tr = build(tpol, t_make_codec).resolve(to_torch(tree))
    for r in range(4):
        assert tr.rates(0.01, r) == jr.rates(0.01, r)
    assert tr.describe() == jr.describe()
    # a scheduled policy needs an explicit per-round rate tuple
    comp = tapi.Compressor.from_policy("sched", build(tpol, t_make_codec))
    with pytest.raises(ValueError, match="schedules"):
        comp.compress(to_torch(tree), comp.init_state(to_torch(tree)), 0.01)


def test_moe_rules_match_jax():
    jr, tr = jpol.moe_rules(8, 2), tpol.moe_rules(8, 2)
    assert [(r.pattern, r.rate_scale) for r in tr] == [(r.pattern, r.rate_scale) for r in jr]
    assert [t_make_codec(r.codec).spec for r in tr] == [j_make_codec(r.codec).spec for r in jr]
    tree = {"moe": {"up": np.zeros((8, 16), np.float32), "router": np.zeros((4, 8), np.float32)},
            "w": np.zeros(32, np.float32)}
    jp = jpol.CompressionPolicy(default=j_make_codec("sbc"), rules=jr, name="moe")
    tp = tpol.CompressionPolicy(default=t_make_codec("sbc"), rules=tr, name="moe")
    jt = jax.tree.map(jnp.asarray, tree)
    tt = tree_map(t, tree)
    assert tp.resolve(tt).describe() == jp.resolve(jt).describe()
    assert tp.resolve(tt).rates(0.1) == jp.resolve(jt).rates(0.1)


def test_fast_policy_raises_naming_a4():
    """A4 is ported: a fast policy no longer raises naming it, but takes
    the flat path, with its residual in the flat layout (the parity of that
    path is tests/test_torch_flat_space.py)."""
    tree = to_torch(channel_tree())
    fast = tpol.CompressionPolicy(default=t_make_codec("sbc"), fast=True)
    resolved = fast.resolve(tree)
    state = resolved.init_state(tree)
    assert tuple(state.residual.shape) == (resolved.flat_space(tree).n_pad,)
    _, _, state = resolved.compress(tree, state, 0.02)
    assert tuple(state.residual.shape) == (resolved.flat_space(tree).n_pad,)
    # the reference runs such a policy per leaf too when a codec has no
    # flat form: so does the port
    per_leaf = tpol.CompressionPolicy(
        default=t_make_codec("sbc"), rules=(tpol.PolicyRule("bias", codec="topk|sign|raw32"),),
        fast=True)
    resolved = per_leaf.resolve(tree)
    assert not resolved.fast_compatible
    resolved.compress(tree, resolved.init_state(tree), 0.02)


# ------------------------------------------------ compress with feedback


def assert_round_equal(jout, tout, what):
    jcomp, jdense, jstate = jout
    tcomp, tdense, tstate = tout
    for key in jcomp:
        for field in LeafCompressed._fields:
            bits_equal(getattr(tcomp[key], field), getattr(jcomp[key], field),
                       f"{what} {key}.{field}")
        bits_equal(tdense[key], jdense[key], f"{what} dense {key}")
    if jstate.residual == ():
        assert tstate.residual == ()
    else:
        for key in jstate.residual:
            bits_equal(tstate.residual[key], jstate.residual[key], f"{what} residual {key}")


@pytest.mark.parametrize("name", ["local-sbc", "fed-dense-small", "gspmd-mixed",
                                  "lenet-dense-biases", "mixed-codecs"])
def test_three_rounds_of_error_feedback_match_jax(name):
    tree_fn = lenet_tree if name == "lenet-dense-biases" else channel_tree
    like = tree_fn(0)
    jr = policies("jax")[name].resolve(to_jax(like))
    tr = policies("torch")[name].resolve(to_torch(like))
    jstate, tstate = jr.init_state(to_jax(like)), tr.init_state(to_torch(like))
    rates = jr.rates(0.02)
    for r in range(3):
        delta = tree_fn(10 + r)
        jout = jr.compress(to_jax(delta), jstate, rates)
        tout = tr.compress(to_torch(delta), tstate, rates)
        assert_round_equal(jout, tout, f"{name} round {r + 1}")
        assert float(tr.total_bits(tout[0])) == float(jr.total_bits(jout[0]))
        recon = tr.decompress(tout[0], to_torch(like))
        for key in recon:
            bits_equal(recon[key], tout[1][key], f"decompress {key}")
        jstate, tstate = jout[2], tout[2]
        assert int(tstate.step) == r + 1


def test_compressor_surface_matches_jax():
    like = lenet_tree(0)
    jc, tc = japi.make_compressor("sbc"), tapi.make_compressor("sbc")
    assert tc.name == jc.name and tc.codec.spec == jc.codec.spec and tc.use_residual
    jstate, tstate = jc.init_state(to_jax(like)), tc.init_state(to_torch(like))
    for r in range(2):
        delta = lenet_tree(5 + r)
        jout = jc.compress(to_jax(delta), jstate, 0.05)
        tout = tc.compress(to_torch(delta), tstate, 0.05)
        assert_round_equal(jout, tout, f"Compressor round {r + 1}")
        assert float(tc.total_bits(tout[0])) == float(jc.total_bits(jout[0]))
        jstate, tstate = jout[2], tout[2]
    x = lenet_tree(9)["f1"].reshape(-1)
    got = tsbc.sbc_compress_leaf(t(x), 0.01, None)
    want = jsbc.sbc_compress_leaf(jnp.asarray(x), 0.01, None)
    for field in LeafCompressed._fields:
        bits_equal(getattr(got, field), getattr(want, field), field)
    bits_equal(tsbc.sbc_decompress_leaf(got, x.size), jsbc.sbc_decompress_leaf(want, x.size))
    bits_equal(tc.decompress_leaf(got, x.size), jc.decompress_leaf(want, x.size))
    assert tsbc.SBC_PRESETS == jsbc.SBC_PRESETS


def test_stochastic_policy_rounds_are_reproducible_from_the_state():
    tree = to_torch(channel_tree())
    pol = tpol.CompressionPolicy(default=t_make_codec("randomk|identity|raw32"))
    resolved = pol.resolve(tree)
    s0 = resolved.init_state(tree, rng=5)
    a1, _, s1 = resolved.compress(tree, s0, 0.05)
    b1, _, _ = resolved.compress(tree, s0, 0.05)
    a2, _, _ = resolved.compress(tree, s1, 0.05)
    assert torch.equal(a1["w"].idx, b1["w"].idx)  # same (seed, step): same draw
    assert not torch.equal(a1["w"].idx, a2["w"].idx)  # the next round draws anew
    assert not torch.equal(a1["w"].idx[:20], a1["bias"].idx[:20])


# --------------------------------------------------------------- residual


def test_residual_primitives_match_jax():
    rng = np.random.default_rng(1)
    r, d, x = (rng.standard_normal(50).astype(np.float32) for _ in range(3))
    got = tres.residual_update({"a": t(r)}, {"a": t(d)}, {"a": t(x)})
    want = jres.residual_update({"a": jnp.asarray(r)}, {"a": jnp.asarray(d)},
                                {"a": jnp.asarray(x)})
    bits_equal(got["a"], want["a"])
    bits_equal(tres.topk_projection(t(r), 7), jres.topk_projection(jnp.asarray(r), 7))
    support = r > 0
    bits_equal(tres.project_fixed_support(t(r), t(support)),
               jres.project_fixed_support(jnp.asarray(r), jnp.asarray(support)))
    hist = rng.standard_normal((4, 50)).astype(np.float32)
    sent = rng.standard_normal((4, 50)).astype(np.float32)
    np.testing.assert_allclose(float(tres.accumulated_error(t(hist), t(sent))),
                               float(jres.accumulated_error(jnp.asarray(hist),
                                                            jnp.asarray(sent))), rtol=1e-6)


def test_init_state_shapes_and_residual_free_codecs():
    tree = to_torch(channel_tree())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pol = tpol.CompressionPolicy(default=t_make_codec("dense32", use_residual=False))
        state = pol.resolve(tree).init_state(tree)
    assert state.residual == () and int(state.step) == 0 and int(state.rng) == 0
    state = tpol.CompressionPolicy(default=t_make_codec("sbc")).resolve(tree).init_state(tree)
    assert {k: tuple(v.shape) for k, v in state.residual.items()} == {
        k: tuple(v.shape) for k, v in tree.items()}
