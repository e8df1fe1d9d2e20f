"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe``, on the CPU.

The configs are the reference's ``reduced`` mixtral-8x7b (grouped, top-2),
llama4-maverick (``flat_ep``, top-1) and jamba-v0.1 (grouped, top-2), and
mixtral without the gate (GELU's tanh form).  Inputs come from numpy
seeds; the reference's parameters cross with ``params_from_jax``.
Tolerances:
  * f32 outputs and aux: ``rtol=1e-5`` beside ``atol=1e-5``;
  * gradients (``jax.grad`` against autograd): ``rtol=1e-4`` beside
    ``atol`` of 1e-5 of the leaf's largest gradient;
  * bf16: within 2 bf16 ulps of the output's scale
    (``atol=2·2⁻⁸·max|out|``);
  * exact: the tree's paths, shapes and dtypes, the expert ids, every
    pair's capacity position and keep mask, the dispatch buffers, and the
    combine at k = 2 (at most two adds into an f32 zero a real token, exact
    in either order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import moe as jmoe
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.models import moe as tmoe
from test_torch_decoder import close, port_cfg
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _reduced(arch, **kw):
    return dataclasses.replace(jbase.reduced(jbase.get_config(arch)), **kw)


CONFIGS = {
    "mixtral-grouped-k2": lambda: _reduced("mixtral_8x7b"),
    "llama4-flat_ep-k1": lambda: _reduced("llama4_maverick_400b_a17b"),
    "jamba-grouped-k2": lambda: _reduced("jamba_v01_52b"),
    "mixtral-gelu": lambda: _reduced("mixtral_8x7b", gated_mlp=False),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def setup(request):
    jcfg = CONFIGS[request.param]()
    jp = jmoe.init_moe(jax.random.PRNGKey(7), jcfg)
    return request.param, jcfg, port_cfg(jcfg), jp, params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


def xs(B=2, S=32, d=256, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32)


def jpaths(tree):
    return [("/".join(k.key for k in p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def tpaths(tree):
    return [(path_str(p), tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for p, v in tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_tree_is_the_references(dtype):
    """Router in f32, the stacked experts on a leading E axis in the
    config's dtype, leaf for leaf; each expert drawn with the reference's
    scale (1/√d up and gate, 1/√ff down)."""
    jcfg = _reduced("mixtral_8x7b", dtype=getattr(jnp, dtype))
    jtree = jmoe.init_moe(jax.random.PRNGKey(0), jcfg)
    ttree = tmoe.init_moe(torch.Generator().manual_seed(0), port_cfg(jcfg))
    assert tpaths(ttree) == jpaths(jtree)
    d, ff = jcfg.d_model, jcfg.d_ff
    for name, want in (("up", d ** -0.5), ("down", ff ** -0.5), ("router", d ** -0.5)):
        assert float(ttree[name].float().std()) == pytest.approx(want, rel=0.05)
    with torch.device("meta"):
        meta = tmoe.init_moe(torch.Generator(), port_cfg(jcfg))
    assert all(v.is_meta for v in tree_flatten(meta)[0])
    assert tpaths(meta) == jpaths(jtree)


def ref_route(jp, x, jcfg):
    """The reference's routing, step by step: (probs, gates, experts) per
    group, as ``_moe_grouped``'s ``route_group`` and ``_moe_flat`` do."""
    xt = x if jcfg.moe_dispatch == "grouped" else x.reshape(1, -1, x.shape[-1])
    logits = jnp.asarray(xt) @ jp["router"]
    probs = jax.nn.softmax(logits, axis=-1)
    gates, experts = jax.lax.top_k(probs, jcfg.moe_top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True), 1e-9)
    return np.asarray(gates), np.asarray(experts)


def np_dispatch(experts, gates, E, C, n_tok):
    """Positions, keep masks and buffers from the reference's expert ids,
    one pair at a time in token-major order."""
    G, _, k = experts.shape
    buf = np.full((G, E * C), n_tok, np.int64)
    gbuf = np.zeros((G, E * C), np.float32)
    pos = np.zeros((G, n_tok * k), np.int64)
    for g in range(G):
        seen = np.zeros(E, np.int64)
        for i, e in enumerate(experts[g].reshape(-1)):
            pos[g, i] = seen[e]
            seen[e] += 1
            if pos[g, i] < C:
                buf[g, e * C + pos[g, i]] = i // k
                gbuf[g, e * C + pos[g, i]] = gates[g].reshape(-1)[i]
    return pos, pos < C, buf, gbuf


@pytest.mark.parametrize("cf", [8.0, 0.5], ids=["reduced-cf8", "cf0.5-drops"])
def test_moe_apply_matches(setup, cf):
    """At ``reduced``'s capacity factor 8.0 nothing drops; at 0.5 tokens
    do.  Expert ids, positions, keep masks and buffers exact; out and aux
    to f32 tolerance."""
    name, jcfg, tcfg, jp, tp = setup
    x = xs(seed=1)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    tout, taux = tmoe.moe_apply(tp, t(x), tcfg, capacity_factor=cf)
    close(tout, jout, what=f"{name} out")
    close(taux, jaux, what=f"{name} aux")
    assert tout.dtype == torch.float32 and taux.shape == ()
    # the routing and the dispatch, exact
    jg, je = ref_route(jp, x, jcfg)
    xt = t(x) if jcfg.moe_dispatch == "grouped" else t(x).reshape(1, -1, x.shape[-1])
    _, tg, te = tmoe._route(xt, tp["router"], jcfg.moe_top_k)
    np.testing.assert_array_equal(n(te), je)
    close(tg, jg, what="gates")
    E, k, n_tok = jcfg.moe_experts, jcfg.moe_top_k, xt.shape[1]
    C = tmoe._capacity(n_tok, k, E, cf, False)
    assert C == max(1, int(np.ceil(n_tok * k / E * cf)))
    pos, keep, buf, gbuf = np_dispatch(je, jg, E, C, n_tok)
    tbuf, tgbuf = tmoe._dispatch(te, tg, E, C, n_tok)
    np.testing.assert_array_equal(n(tbuf), buf)
    np.testing.assert_array_equal(n(tgbuf) != 0, gbuf != 0)
    drops = tmoe.dropped_share(tp, t(x), tcfg, capacity_factor=cf)
    assert drops == pytest.approx(float((~keep).mean()))
    assert (drops > 0) == (cf == 0.5), drops


def test_full_capacity_drops_nothing(setup):
    """``full_capacity=True`` (the decode path): C = S (grouped) or T
    (flat), the same out as any capacity that drops nothing."""
    name, jcfg, tcfg, jp, tp = setup
    x = xs(S=9, seed=2)
    jout, _ = jmoe.moe_apply(jp, jnp.asarray(x), jcfg, capacity_factor=0.25,
                             full_capacity=True)
    tout, _ = tmoe.moe_apply(tp, t(x), tcfg, capacity_factor=0.25, full_capacity=True)
    close(tout, jout, what=f"{name} full capacity")
    big, _ = tmoe.moe_apply(tp, t(x), tcfg, capacity_factor=float(jcfg.moe_experts))
    close(tout, n(big), what="full capacity == a capacity that drops nothing")


def test_combine_is_bit_for_bit_at_k2():
    """The scatter-add of the gated expert rows: the port's ``index_add_``
    equals the reference's ``.at[buf].add`` bit for bit at k = 2 (every
    real token gets at most two adds into an f32 zero), with drops."""
    jcfg = _reduced("mixtral_8x7b")
    rng = np.random.default_rng(3)
    B, S, d, E, k = 2, 32, 256, jcfg.moe_experts, 2
    C = tmoe._capacity(S, k, E, 0.75, False)
    experts = np.stack([np.argsort(rng.random((B, S, E)), axis=-1)[..., i] for i in range(k)],
                       axis=-1)
    gates = rng.random((B, S, k)).astype(np.float32)
    _, keep, buf, gbuf = np_dispatch(experts, gates, E, C, S)
    assert not keep.all()
    eo = rng.standard_normal((B, E * C, d)).astype(np.float32)

    def jcombine(eo_g, buf_g, gate_g):
        contrib = jnp.asarray(eo_g) * jnp.asarray(gate_g)[:, None]
        return jnp.zeros((S + 1, d), jnp.float32).at[jnp.asarray(buf_g)].add(contrib)[:S]

    want = np.stack([np.asarray(jcombine(eo[b], buf[b], gbuf[b])) for b in range(B)])
    got = tmoe._combine(t(eo), t(buf), t(gbuf), S)
    np.testing.assert_array_equal(n(got).view(np.int32), want.view(np.int32))


def _grads(jcfg, tcfg, jp, tp, x, w):
    """(reference, port) loss and gradients of ``Σ out·w + aux`` (``w``
    None: of ``aux`` alone) with respect to every parameter and the input."""
    def jloss(p, xx):
        out, aux = jmoe.moe_apply(p, xx, jcfg)
        return aux if w is None else jnp.sum(out * w) + aux

    jl, (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tx = t(x).requires_grad_(True)
    out, aux = tmoe.moe_apply(treedef.unflatten(leaves), tx, tcfg)
    tl = aux if w is None else torch.sum(out * t(w)) + aux
    grads = torch.autograd.grad(tl, leaves + [tx], allow_unused=True)
    jflat = dict((p, np.asarray(v)) for (p, _, _), v in
                 zip(jpaths(jgp), jax.tree.leaves(jgp)))
    tflat = {p: g for (p, _, _), g in zip(tpaths(tp), grads[:-1])}
    return (jl, jflat, np.asarray(jgx)), (tl, tflat, grads[-1])


def test_aux_and_gradients_match(setup):
    """Gradients of ``Σ out·w + aux`` with respect to every parameter and
    the input.  At k = 1 (llama4) the renormalised gate g/g is 1, and its
    gradient, 1/g − g/g², is rounding noise in both frameworks; the
    router's gradient there is the aux's alone, so the router is held to
    the gradient of ``aux`` (the other leaves to the whole loss's)."""
    name, jcfg, tcfg, jp, tp = setup
    x = xs(seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    (jl, jg, jgx), (tl, tg, tgx) = _grads(jcfg, tcfg, jp, tp, x, w)
    close(tl, jl, rtol=1e-5, atol=1e-4, what=f"{name} loss")
    routers = {}
    if jcfg.moe_top_k == 1:
        (_, jga, _), (_, tga, _) = _grads(jcfg, tcfg, jp, tp, x, None)
        routers = {"router": (tga["router"], jga["router"])}
    for p, g in tg.items():
        got, ref = routers.get(p, (g, jg[p]))
        close(got, ref, rtol=1e-4, atol=1e-5 * (float(np.abs(ref).max()) or 1.0),
              what=f"{name} grad {p}")
    close(tgx, jgx, rtol=1e-4, atol=1e-5 * float(np.abs(jgx).max()), what=f"{name} grad x")


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "llama4_maverick_400b_a17b"])
def test_bf16_moe_matches(arch):
    """A bf16 MoE (its router f32): the SiLU in f32 rounded to bf16 before
    the product, the combine in f32, the out cast back to bf16."""
    jcfg = _reduced(arch, dtype=jnp.bfloat16)
    jp = jmoe.init_moe(jax.random.PRNGKey(9), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["router"].dtype == torch.float32 and tp["up"].dtype == torch.bfloat16
    x = xs(seed=6)
    jout, jaux = jmoe.moe_apply(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, taux = tmoe.moe_apply(tp, t(x).to(torch.bfloat16), port_cfg(jcfg))
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout).astype(np.float32)
    close(tout.float(), want, rtol=0, atol=2 * 2 ** -8 * float(np.abs(want).max()),
          what=f"{arch} bf16 out")
    close(taux, jaux, what="bf16 aux")


def test_top_k_breaks_ties_by_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    _, idx = tmoe._top_k(probs, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(n(probs)), 2)
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    assert n(idx).tolist() == [[0, 1], [1, 3]]
