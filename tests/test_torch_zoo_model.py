"""The MoE and recurrent decoders (mixtral-8x7b, llama4-maverick,
jamba-v0.1, rwkv6-1.6b; ROADMAP A12, part 3, items 1 and 2) as models,
against the JAX package, on the CPU: the configs and trees, the loss and
its gradients, decode against prefill, and the MoE compression policy.
Their greedy serving is ``tests/test_torch_zoo_serve.py``, their runs on
the three backends ``tests/test_torch_zoo_run.py``.

The sizes are the reference's ``reduced`` configs at the shapes of its
``tests/test_arch_smoke.py`` (batch 2, S = 32); each reference model is
built once for the module, its parameters cross with
``params_from_jax``, and tokens come from numpy seeds.  Tolerances:
  * the configs field for field, ``param_count``; the trees' paths,
    shapes and dtypes, on the ``meta`` device at two superblocks of the
    full widths and at the reduced sizes: exact;
  * the loss (with the MoE ``aux``): ``rtol=1e-5``;
  * gradients: ``rtol=1e-4`` beside ``atol`` of 1e-4 of the leaf's
    largest gradient.  Through the recurrences and the norms f32 noise
    grows: rwkv6's embedding gradient differs from an f64 evaluation of
    the same model by 1.6e-5 of its largest entry in the reference and
    3.1e-5 in the port (measured), so 1e-5 of it (the dense decoders'
    bound) would hold the frameworks to less than their own error.  At
    top-1 (llama4) the router is held to the gradient of ``aux`` alone:
    the renormalised gate g/g is 1 and its gradient rounding noise in both
    frameworks (``tests/test_torch_moe.py``);
  * decode at position S against a prefill of S + 1 tokens: the
    reference's own bound, 5% of the largest logit; the port's decode
    logits against the reference's: ``rtol=1e-4``, ``atol=1e-4``;
  * the MoE policy on the reduced mixtral tree (the claims of the
    reference's ``tests/test_moe_policy.py``): plans, Eq. 1 bits and SBW1
    bytes equal; ``fast=True`` equal to the per-leaf path bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (registers the reference's codecs)
from repro.configs import base as jbase
from repro.core import channel as jchannel
from repro.core import policy as jpol
from repro.core.codec import make_codec as j_make_codec
from repro.core.wire import wire_for as j_wire_for
from repro.models import transformer as jtf
from repro.models.model import build_model as j_build_model
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core import channel as tchannel
from repro_torch.core import policy as tpol
from repro_torch.core.codec import make_codec as t_make_codec
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path, tree_map
from repro_torch.core.wire import wire_for as t_wire_for
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine
from test_torch_decoder import close, port_cfg
from test_torch_moe import jpaths, tpaths
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCHS = ["mixtral_8x7b", "llama4_maverick_400b_a17b", "jamba_v01_52b", "rwkv6_1p6b"]
SEQ, BATCH = 32, 2


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, reference model and params, the port's model and params),
    one reference model a module per arch."""
    jcfg = jbase.reduced(jbase.get_config(request.param))
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(port_cfg(jcfg))
    return request.param, jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_configs_and_trees_are_the_references(arch):
    """The full config field for field (``param_count`` and the layer
    pattern too); the tree of two superblocks at the full widths on
    ``meta``, and the reduced tree drawn on the CPU, leaf for leaf."""
    name, jm, jp, tm, _ = arch
    jcfg, tcfg = jbase.get_config(name), tbase.get_config(name)
    assert port_cfg(jcfg) == tcfg
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert (tcfg.layer_kinds, tcfg.layer_moe) == (jcfg.layer_kinds, jcfg.layer_moe)
    assert ttf.stack_pattern(tcfg) == jtf.stack_pattern(jcfg)
    assert port_cfg(jbase.reduced(jcfg)) == tbase.reduced(tcfg)
    layers = 2 * jtf.stack_pattern(jcfg)[0]
    with torch.device("meta"):
        meta = build_model(dataclasses.replace(tcfg, n_layers=layers)).init(torch.Generator())
    shapes = jax.eval_shape(j_build_model(dataclasses.replace(jcfg, n_layers=layers)).init,
                            jax.random.PRNGKey(0))
    assert tpaths(meta) == jpaths(shapes)
    assert tpaths(tm.init(torch.Generator().manual_seed(0))) == jpaths(jp)


def grads_close(tg, jg, what):
    jflat = {"/".join(k.key for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for p, v in tree_flatten_with_path(tg)[0]:
        ref = jflat[path_str(p)]
        close(v, ref, rtol=1e-4, atol=1e-4 * (float(np.abs(ref).max()) or 1.0),
              what=f"{what} grad {path_str(p)}")


def test_loss_and_gradients_match(arch):
    name, jm, jp, tm, tp = arch
    tok = tokens(tm.cfg.vocab_size, (BATCH, SEQ + 1), 1)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:])}
    tbatch = {"tokens": t(tok[:, :-1]).long(), "labels": t(tok[:, 1:]).long()}
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jbatch)
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tl = tm.loss_fn(treedef.unflatten(leaves), tbatch)
    tg = list(torch.autograd.grad(tl, leaves))
    close(tl, jl, what=f"{name} loss")
    if tm.cfg.moe_experts and tm.cfg.moe_top_k == 1:
        ja = jax.grad(lambda p: jtf.decoder_hidden(p, jbatch["tokens"], jm.cfg)[1])(jp)
        ta = torch.autograd.grad(ttf.decoder_hidden(treedef.unflatten(leaves),
                                                    tbatch["tokens"], tm.cfg)[1],
                                 leaves, allow_unused=True)
        jg = jax.tree_util.tree_map_with_path(
            lambda p, g, a: a if p[-1].key == "router" else g, jg, ja)
        tg = [a if path_str(p).endswith("router") else g
              for (p, _), g, a in zip(tree_flatten_with_path(tp)[0], tg, ta)]
    grads_close(treedef.unflatten(tg), jg, name)


def test_decode_matches_prefill_and_the_reference(arch):
    """The reference's ``test_decode_matches_prefill``: the decode step at
    position S within 5% of the largest logit of a prefill of S + 1
    tokens (caches: attention K/V, Mamba's {h, conv}, RWKV6's {s, tm_prev,
    cm_prev}; an MoE decodes at full capacity); and the port's decode
    logits against the reference's."""
    name, jm, jp, tm, tp = arch
    tok = tokens(tm.cfg.vocab_size, (BATCH, SEQ), 3)
    nxt = np.ones((BATCH, 1), np.int32)
    _, caches = tm.prefill(tp, {"tokens": t(tok).long()})
    logits, _ = tm.decode_step(tp, t(nxt).long(), caches, SEQ)
    assert logits.shape == (BATCH, 1, tm.cfg.vocab_size) and bool(torch.isfinite(logits).all())
    ref, _ = ServeEngine(tm).prefill(tp, {"tokens": t(np.concatenate([tok, nxt], 1)).long()})
    err = float((logits - ref).abs().max()) / (float(ref.abs().max()) + 1e-6)
    assert err < 0.05, f"{name}: decode/prefill {err}"
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok)})
    jlog, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(SEQ))
    close(logits, jlog, rtol=1e-4, atol=1e-4, what=f"{name} decode vs the reference's")


# ------------------------------------------------- the MoE policy (A12, part 3)


@pytest.fixture(scope="module")
def mixtral_delta():
    """A gradient-shaped tree of the reduced mixtral (E = 4), the same
    numbers for both packages."""
    with torch.device("meta"):
        meta = build_model(tbase.reduced(tbase.get_config("mixtral_8x7b"))).init(
            torch.Generator())
    rng = np.random.default_rng(1)
    return tree_map(lambda v: rng.standard_normal(tuple(v.shape)).astype(np.float32), meta)


def moe_policies(fast=False):
    E, k = 4, 2
    return (jpol.CompressionPolicy(default=j_make_codec("sbc"), rules=jpol.moe_rules(E, top_k=k),
                                   name="sbc+moe", fast=fast),
            tpol.CompressionPolicy(default=t_make_codec("sbc"), rules=tpol.moe_rules(E, top_k=k),
                                   name="sbc+moe", fast=fast))


def test_moe_policy_on_the_reduced_mixtral_tree(mixtral_delta):
    """``moe_rules`` resolves ``moe/up|gate|down`` to ``expert_topk`` at
    ``rate_scale`` top_k/E and the router to ``dense32``; the plans, Eq. 1
    bits and SBW1 bytes are the reference's, and ``fast=True`` (which has
    no flat form for ``expert_topk`` and runs per leaf) equals the per-leaf
    path bit for bit."""
    jpolicy, tpolicy = moe_policies()
    jtree = jax.tree.map(jnp.asarray, mixtral_delta)
    ttree = tree_map(t, mixtral_delta)
    jres, tres = jpolicy.resolve(jtree), tpolicy.resolve(ttree)
    assert tres.describe() == jres.describe()
    saw = set()
    for plan in tres.plans:
        if plan.path.endswith("moe/router"):
            assert plan.codec.selector.dense
            saw.add("router")
        elif any(plan.path.endswith(f"moe/{w}") for w in ("up", "gate", "down")):
            assert plan.codec.selector.name == "expert_topk"
            assert plan.rate_scale == pytest.approx(2 / 4)
            saw.add("expert")
    assert saw == {"router", "expert"}
    rates = tres.rates(0.05)
    assert rates == jres.rates(0.05)
    tb = tchannel.analytic_bits(tres, tres._leaves_of(ttree), rates)
    jb = jchannel.analytic_bits(jres, jres._leaves_of(jtree), rates)
    assert (tb.per_client, tb.dense) == (jb.per_client, jb.dense)
    tcomp, tdense, _ = tres.compress(ttree, tres.init_state(ttree), rates)
    jcomp, _, _ = jres.compress(jtree, jres.init_state(jtree), rates)
    jblob = j_wire_for(jres, jtree, 0.05).pack(jax.tree.map(np.asarray, jcomp))
    tblob = t_wire_for(tres, ttree, 0.05).pack(tcomp)
    assert tblob == jblob
    rec = t_wire_for(tres, ttree, 0.05).unpack(tblob)
    for a, b in zip(tree_flatten(tdense)[0], tree_flatten(rec)[0]):
        np.testing.assert_array_equal(n(a).reshape(-1), n(b).reshape(-1))
    fast = moe_policies(fast=True)[1].resolve(ttree)
    assert not fast.fast_compatible
    fcomp, fdense, _ = fast.compress(ttree, fast.init_state(ttree), rates)
    for a, b in zip(tree_flatten(tdense)[0], tree_flatten(fdense)[0]):
        np.testing.assert_array_equal(n(a).view(np.int32), n(b).view(np.int32))
    assert float(fast.total_bits(fcomp)) == float(tres.total_bits(tcomp))
