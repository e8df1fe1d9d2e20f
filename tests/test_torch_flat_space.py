"""The port's ``FlatParamSpace`` (the ``fast=True`` path of
``ResolvedPolicy``) against the JAX package's and against the port's own
per-leaf path, on the CPU.

The trees hold every segment kind and edge case of the reference's
oracle (``tests/test_flat_fast_path.py``): 2-D matrices, a dense bias, a
skipped leaf, a tail that is not a whole block, an all-zero leaf, and
ties with zeros of both signs.  Inputs are made with numpy from a seed and
handed to both packages; C clients are the leading axis (the reference
``vmap``s its compress over it, the port compresses the C rows at once).

Tolerances:
  * the exact engine (``compress``, ``compress_rows``): bit-exact.  Every
    ``LeafCompressed`` field (indices, μ down to the sign of zero, nbits),
    ΔW*, the flat residual and the SBW1 bytes of ``Wire.pack`` equal the
    reference's and the port's per-leaf path's, over three rounds of
    error feedback;
  * the hist engine (``compress_hist``): counts and ΔW*'s support equal,
    μ and the residual to ``rtol=1e-6`` (the masked moments are summed in
    f64 and rounded once, the reference sums in f32; ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.core import policy as jpol
from repro.core.codec import make_codec as j_make_codec
from repro.core.wire import wire_for as j_wire_for
from repro_torch.core import policy as tpol
from repro_torch.core.codec import make_codec as t_make_codec
from repro_torch.core.flat import FlatParamSpace
from repro_torch.core.stages import LeafCompressed
from repro_torch.core.tree import tree_map
from repro_torch.core.wire import wire_for as t_wire_for
from torch_helpers import n, t

SHAPES = {"layer0/w": (50, 40), "layer0/bias": (40,), "layer1/w": (123,),
          "layer1/frozen": (7, 3), "tail": (17,), "zero": (65,)}


def nest(flat):
    out = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def tree_values(seed, kind="random"):
    rng = np.random.default_rng(seed)
    out = {}
    for path, shape in SHAPES.items():
        if kind == "random":
            x = 0.1 * rng.standard_normal(shape)
        else:  # ties and ±0: few distinct values
            x = rng.choice(np.array([0.0, -0.0, 0.5, 0.5, -0.25, -0.0]), size=shape)
        out[path] = x.astype(np.float32)
    out["zero"][:] = 0.0
    return nest(out)


def policy(pkg, fast, all_sbc=False):
    make, pol = (j_make_codec, jpol) if pkg == "jax" else (t_make_codec, tpol)
    rules = () if all_sbc else (pol.PolicyRule(r"frozen", codec="skip"),
                                pol.PolicyRule(pol.DENSE_SMALL_PATTERN, codec="dense32"))
    return pol.CompressionPolicy(default=make("sbc"), rules=rules, name="sbc+rules",
                                 fast=fast)


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def ttree(tree):
    return tree_map(t, tree)


def stack(trees):
    return jax.tree.map(lambda *xs: np.stack(xs), *trees)


def bits_equal(a, b, what=""):
    a, b = np.asarray(n(a)), np.asarray(n(b))
    assert a.shape == b.shape, (what, a.shape, b.shape)
    view = np.uint32 if a.dtype.kind == "f" else a.dtype
    np.testing.assert_array_equal(a.view(view), b.view(view), err_msg=what)


def comp_leaves(ctree, resolved):
    return resolved._leaves_of(ctree)


@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("clients", [1, 3])
def test_exact_engine_matches_jax_and_the_per_leaf_path(kind, clients):
    like = tree_values(0)
    jres = policy("jax", True).resolve(jtree(like))
    tres = policy("torch", True).resolve(ttree(like))
    leaf = policy("torch", False).resolve(ttree(like))
    space = tres.flat_space(ttree(like))
    assert isinstance(space, FlatParamSpace)
    assert space.n_pad == jres.flat_space(jtree(like)).n_pad
    rates = jres.rates(0.05)
    assert rates == tres.rates(0.05)

    def vmapped(d, s):
        return jres.compress(d, s, rates)

    j_state = jax.vmap(lambda k: jres.init_state(jtree(like), k))(
        jax.random.split(jax.random.PRNGKey(0), clients))
    t_state = tres.init_state(ttree(like))
    t_state = t_state._replace(residual=t_state.residual.expand(clients, -1).clone(),
                               step=torch.zeros(clients, dtype=torch.int64))
    leaf_states = [leaf.init_state(ttree(like)) for _ in range(clients)]
    j_wire, t_wire = j_wire_for(jres, jtree(like), 0.05), t_wire_for(tres, ttree(like), 0.05)
    for r in range(3):
        deltas = [tree_values(10 * r + c + 1, kind) for c in range(clients)]
        jc, jd, j_state = jax.vmap(vmapped)(jtree(stack(deltas)), j_state)
        tc, td, t_state = space.compress_rows(ttree(stack(deltas)), t_state, rates)
        for c in range(clients):
            lc, ld, leaf_states[c] = leaf.compress(ttree(deltas[c]), leaf_states[c], rates)
            jcl = comp_leaves(jax.tree.map(lambda x: x[c], jc), jres)
            tcl = [LeafCompressed(*(f[c] for f in x)) for x in comp_leaves(tc, tres)]
            for plan, j, tt, ll in zip(tres.plans, jcl, tcl, comp_leaves(lc, leaf)):
                for field in LeafCompressed._fields:
                    what = f"round {r + 1} client {c} {plan.path}.{field}"
                    bits_equal(getattr(tt, field), getattr(j, field), what)
                    bits_equal(getattr(tt, field), getattr(ll, field), what + " (per leaf)")
            for key, j, tt, ll in zip(range(6), jax.tree.leaves(jax.tree.map(lambda x: x[c], jd)),
                                      tres._leaves_of(tree_map(lambda x: x[c], td)),
                                      leaf._leaves_of(ld)):
                bits_equal(tt, j, f"round {r + 1} client {c} dW* {key}")
                bits_equal(tt, ll, f"round {r + 1} client {c} dW* {key} (per leaf)")
            bits_equal(t_state.residual[c], j_state.residual[c], f"round {r + 1} residual")
            for tt, ll in zip(tres._leaves_of(space.unflatten(t_state.residual[c])),
                              leaf._leaves_of(leaf_states[c].residual)):
                bits_equal(tt, ll, f"round {r + 1} residual (per leaf)")
            j_blob = j_wire.pack(jax.tree.map(lambda x: x[c], jc))
            t_blob = t_wire.pack(tres.treedef.unflatten(tcl))
            assert t_blob == j_blob
        assert [int(s) for s in t_state.step] == [r + 1] * clients


def test_a_zero_mean_is_positive_zero_as_in_the_reference():
    """An all-zero leaf and a leaf whose two sides cancel: the negative side
    wins with a zero mean, which the reference's re-gathered mean gives as
    +0.0 (the port's −mean(−v) would be −0.0)."""
    like = {"zero": np.zeros(64, np.float32), "cancel": np.array([1, -1], np.float32),
            "negzero": np.full(64, -0.0, np.float32)}
    jres, tres = (
        pol.CompressionPolicy(default=make("sbc"), fast=True,
                              rules=(pol.PolicyRule("cancel", sparsity=1.0),)).resolve(tree)
        for pol, make, tree in ((jpol, j_make_codec, jtree(like)),
                                (tpol, t_make_codec, ttree(like))))
    rates = jres.rates(0.05)
    jc, _, _ = jres.compress(jtree(like), jres.init_state(jtree(like)), rates)
    tc, _, _ = tres.compress(ttree(like), tres.init_state(ttree(like)), rates)
    for key in like:
        bits_equal(tc[key].mean, jc[key].mean, key)
        bits_equal(tc[key].idx, jc[key].idx, key)
        bits_equal(tc[key].mean, np.float32(0.0), key)


def test_flatten_and_unflatten_match_jax():
    like = tree_values(4)
    jres = policy("jax", True).resolve(jtree(like))
    tres = policy("torch", True).resolve(ttree(like))
    js, ts = jres.flat_space(jtree(like)), tres.flat_space(ttree(like))
    assert [tuple(s[:2]) + tuple(s[3:]) for s in ts.segments] == \
        [tuple(s[:2]) + tuple(s[3:]) for s in js.segments]
    bits_equal(ts.flatten(ttree(like)), js.flatten(jtree(like)))
    rows = ts.flatten(ttree(stack([like, tree_values(5)])))
    bits_equal(rows[0], js.flatten(jtree(like)))
    for a, b in zip(tres._leaves_of(ts.unflatten(ts.flatten(ttree(like)))),
                    jax.tree.leaves(like)):
        bits_equal(a, b)


def test_flat_space_is_none_where_the_reference_runs_per_leaf():
    like = ttree(tree_values(0))
    mixed = tpol.CompressionPolicy(
        default=t_make_codec("sbc"), rules=(tpol.PolicyRule("tail", codec="topk|sign|raw32"),),
        fast=True).resolve(like)
    assert mixed.flat_space(like) is None
    bf16 = tree_map(lambda x: x.to(torch.bfloat16), like)
    assert policy("torch", True).resolve(bf16).flat_space(bf16) is None
    with pytest.raises(ValueError, match="rates"):
        policy("torch", True).resolve(like).flat_space(like)._check_rates((0.1, 0.2))


def test_compress_hist_matches_jax():
    like = tree_values(0)
    jres = policy("jax", True, all_sbc=True).resolve(jtree(like))
    tres = policy("torch", True, all_sbc=True).resolve(ttree(like))
    js, ts = jres.flat_space(jtree(like)), tres.flat_space(ttree(like))
    rates = jres.rates(0.05)
    jstate, tstate = jres.init_state(jtree(like)), tres.init_state(ttree(like))
    for r in range(2):
        delta = tree_values(20 + r)
        jd, jstate, jstats = js.compress_hist(jtree(delta), jstate, rates)
        td, tstate, tstats = ts.compress_hist(ttree(delta), tstate, rates)
        bits_equal(tstats["count"], jstats["count"], "count")
        np.testing.assert_allclose(n(tstats["mu"]), n(jstats["mu"]), rtol=1e-6)
        np.testing.assert_allclose(n(tstats["nbits"]), n(jstats["nbits"]), rtol=1e-6)
        for a, b in zip(tres._leaves_of(td), jax.tree.leaves(jd)):
            np.testing.assert_array_equal(n(a) != 0, n(b) != 0)
            np.testing.assert_allclose(n(a), n(b), rtol=1e-6)
        np.testing.assert_allclose(n(tstate.residual), n(jstate.residual), rtol=1e-6,
                                   atol=1e-7)
        assert int(tstate.step) == r + 1
    with pytest.raises(ValueError, match="all-SBC"):
        policy("torch", True).resolve(ttree(like)).flat_space(ttree(like)).compress_hist(
            ttree(like), tres.init_state(ttree(like)), rates)
