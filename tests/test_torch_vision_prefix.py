"""The vision prefix (phi-3-vision-4.2b; ROADMAP A12, part 3, item 4)
against the JAX package, on the CPU: the prefix in ``_embed_inputs``, the
model's hidden state, loss and gradients, prefill and decode, greedy
serving through ``repro_torch.launch.serve``'s engine, one local DSGD
round, and the reduced preset on the GSPMD and fed backends.

The sizes are the reference's ``reduced`` config (2 layers, d = 256, 4
heads, vocabulary 512, ``n_prefix`` 8, f32) at batch 2, S = 16; the
reference model is built once for the module, its parameters cross with
``params_from_jax``, and tokens and patch embeddings come from numpy
seeds.  Tolerances are ``tests/test_torch_encdec.py``'s: configs, trees
and shapes exact; embeddings, hidden states, the loss and decode logits
``rtol=1e-5`` beside ``atol=1e-5``; gradients ``rtol=1e-4`` beside 1e-5 of
the leaf's largest; decode against a prefill of one more token within 5%
of the largest logit; greedy tokens equal; the local round
``tests/test_torch_zoo_run.py``'s, with the parameters where the
survivors agree also within 1e-4 of the leaf's largest |ΔW*| (its test
says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import transformer as jtf
from repro.models.model import build_model as j_build_model
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine
from test_torch_decoder import close, grads_close, np_tree, port_cfg
from test_torch_encdec import preset_round
from test_torch_moe import jpaths, tpaths
from test_torch_zoo_run import one_round
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "phi3_vision_4p2b"
B, S, NPRE = 2, 16, 8


@pytest.fixture(scope="module")
def model():
    """(reference model and params, the port's model and params)."""
    jcfg = jbase.reduced(jbase.get_config(ARCH))
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(port_cfg(jcfg)), params_from_jax(np_tree(jp), "cpu")


def patches(seed=1):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, NPRE, 256))).astype(np.float32)


def tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_config_and_tree_are_the_references(model):
    """The full config (32 layers, d = 3,072, 576 patch embeddings) field
    for field; two of its layers at full width on ``meta`` leaf for leaf;
    the reduced tree drawn on the CPU."""
    import dataclasses

    jm, jp, tm, _ = model
    jcfg, tcfg = jbase.get_config(ARCH), tbase.get_config("phi-3-vision-4.2b")
    assert port_cfg(jcfg) == tcfg and tcfg.param_count() == jcfg.param_count()
    assert (tcfg.modality, tcfg.n_prefix) == ("vision", 576)
    assert port_cfg(jbase.reduced(jcfg)) == tbase.reduced(tcfg)
    with torch.device("meta"):
        meta = build_model(dataclasses.replace(tcfg, n_layers=2)).init(torch.Generator())
    want = jax.eval_shape(j_build_model(dataclasses.replace(jcfg, n_layers=2)).init,
                          jax.random.PRNGKey(0))
    assert tpaths(meta) == jpaths(want)
    assert tpaths(tm.init(torch.Generator().manual_seed(0))) == jpaths(jp)


def test_the_prefix_replaces_the_first_embeddings(model):
    """The first ``n_prefix`` embeddings are the prefix in the model's
    dtype, the rest the scaled token embeddings; the length is kept.  A
    prompt shorter than the prefix raises ``ValueError`` (the reference's
    concatenation would lengthen the sequence)."""
    jm, jp, tm, tp = model
    tok, pre = tokens((B, S), 2), patches(2)
    want = jtf._embed_inputs(jp, jnp.asarray(tok), jm.cfg, jnp.asarray(pre))
    got = ttf._embed_inputs(tp, t(tok).long(), tm.cfg, t(pre))
    assert got.shape == (B, S, 256)
    close(got, want, what="embed with prefix")
    assert torch.equal(got[:, :NPRE], t(pre))
    assert torch.equal(got[:, NPRE:], ttf._embed_inputs(tp, t(tok).long(), tm.cfg)[:, NPRE:])
    with pytest.raises(ValueError, match="shorter than its 8-position prefix"):
        ttf._embed_inputs(tp, t(tok[:, :5]).long(), tm.cfg, t(pre))
    assert jtf._embed_inputs(jp, jnp.asarray(tok[:, :5]), jm.cfg,
                             jnp.asarray(pre)).shape[1] == NPRE


def test_hidden_loss_and_gradients_match(model):
    """The loss covers every position, the prefix's too (labels (B, S))."""
    jm, jp, tm, tp = model
    tok, pre = tokens((B, S + 1), 3), patches(3)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:]),
              "prefix": jnp.asarray(pre)}
    tbatch = {"tokens": t(tok[:, :-1]).long(), "labels": t(tok[:, 1:]).long(), "prefix": t(pre)}
    jh, _ = jtf.decoder_hidden(jp, jbatch["tokens"], jm.cfg, prefix=jbatch["prefix"])
    th, _ = ttf.decoder_hidden(tp, tbatch["tokens"], tm.cfg, prefix=tbatch["prefix"])
    close(th, jh, what="hidden")
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jbatch)
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tl = tm.loss_fn(treedef.unflatten(leaves), tbatch)
    close(tl, jl, what="loss")
    grads_close(treedef.unflatten(list(torch.autograd.grad(tl, leaves))), jg, "phi-3-vision")


def test_prefill_then_decode_and_greedy_tokens_match(model):
    """Prefill with the prefix, then decode position S (no prefix): the
    logits against the reference's decode on its own caches, and within 5%
    of a prefill of S + 1 tokens; greedy ``ServeEngine`` tokens equal the
    reference's."""
    jm, jp, tm, tp = model
    tok, pre = tokens((B, S), 4), patches(4)
    nxt = np.full((B, 1), 7, np.int32)
    jh, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok), "prefix": jnp.asarray(pre)})
    th, tc = tm.prefill(tp, {"tokens": t(tok).long(), "prefix": t(pre)})
    close(th, jh, what="prefill hidden")
    jl, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(S))
    tl, _ = tm.decode_step(tp, t(nxt).long(), tc, S)
    close(tl, jl, rtol=1e-4, atol=1e-4, what="decode logits")
    ref, _ = ServeEngine(tm).prefill(tp, {"tokens": t(np.concatenate([tok, nxt], 1)).long(),
                                          "prefix": t(pre)})
    assert float((tl - ref).abs().max()) / float(ref.abs().max()) < 0.05
    want = JServeEngine(jm).generate(jp, {"tokens": jnp.asarray(tok), "prefix": jnp.asarray(pre)},
                                     max_new_tokens=5)
    got = ServeEngine(tm).generate(tp, {"tokens": t(tok).long(), "prefix": t(pre)},
                                   max_new_tokens=5)
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_one_local_dsgd_round_matches():
    """One local round of the reduced preset (2 clients, p = 0.02, the wire
    metered, Adam warm) from the reference's parameters and the same
    tokens and prefix: loss, Eq. 1 and measured bits, survivors.  Where
    the survivors agree the parameters are held to ``rtol=1e-5`` beside
    1e-4 of the leaf's largest |ΔW*|: μ is a mean of Adam steps whose
    gradients the two frameworks give to ``rtol=1e-4`` (the gradient
    test's bound); here wq, wk and the gate's μ differ by 1.9e-5, 1.7e-5
    and 2.0e-5 of it (measured), which moves entries that the update
    brings near zero by more than 1e-5 of their value."""
    pre = (0.1 * np.random.default_rng(9).standard_normal((2, 1, B, NPRE, 256))).astype(np.float32)
    one_round(ARCH, extra={"prefix": pre}, mu_rtol=1e-4)


@pytest.mark.parametrize("backend", ["gspmd", "fed"])
def test_the_preset_runs_on_the_gspmd_and_fed_backends(backend):
    """The reduced preset (``client_mode="data"``) on the GSPMD hist engine
    (the reference's Eq. 1 bits) and the fed backend (a reconciled
    ledger), one round each, the task's samples carrying ``prefix``."""
    preset_round(ARCH, backend, "prefix", (2, NPRE, 256))
