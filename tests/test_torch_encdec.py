"""The encoder-decoder (seamless-m4t-medium; ROADMAP A12, part 3, item 3)
against the JAX package, on the CPU: cross attention and the encoder's
bidirectional attention, the encoder on frames and on tokens, the model's
loss and gradients, prefill and decode, one local DSGD round, and the
reduced preset on the GSPMD and fed backends.

The sizes are the reference's ``reduced`` config (2 + 2 layers, d = 256,
4 heads, vocabulary 512, f32) at batch 2, S = 16 decoder tokens over 24
encoder frames; the reference model is built once for the module, its
parameters cross with ``params_from_jax``, and tokens and frames come
from numpy seeds.  Tolerances:
  * the config field for field, ``param_count``, the tree's paths, shapes
    and dtypes (at full width on the ``meta`` device, and reduced), the
    decode caches' shapes: exact;
  * attention outputs and K/V, the encoder's output, hidden states, the
    loss and the decode logits: ``rtol=1e-5`` beside ``atol=1e-5`` (the
    frameworks order a GEMM's adds differently, nothing else);
  * gradients: ``rtol=1e-4`` beside ``atol`` of 1e-5 of the leaf's
    largest gradient (``tests/test_torch_decoder.py``'s bound);
  * decode at position S against a prefill of S + 1 tokens: the
    reference's own bound, 5% of the largest logit;
  * one local round: ``tests/test_torch_zoo_run.py``'s (Eq. 1 and measured
    bits equal; survivors equal but for at most 2 entries a leaf).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.models.model import build_model as j_build_model
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.run import RunSpec, build_run
from repro_torch.serve import ServeEngine
from test_torch_decoder import close, grads_close, np_tree, port_cfg
from test_torch_moe import jpaths, tpaths
from test_torch_zoo_run import one_round
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

ARCH = "seamless_m4t_medium"
B, S, S_ENC = 2, 16, 24


@pytest.fixture(scope="module")
def model():
    """(reference model and params, the port's model and params)."""
    jcfg = jbase.reduced(jbase.get_config(ARCH))
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(port_cfg(jcfg)), params_from_jax(np_tree(jp), "cpu")


def frames(seed=1, S_enc=S_ENC, d=256):
    return (0.1 * np.random.default_rng(seed).standard_normal((B, S_enc, d))).astype(np.float32)


def tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_config_and_tree_are_the_references(model):
    """The full config (2 × 12 layers, tied 256,206 vocabulary) field for
    field; its tree at full width on ``meta`` leaf for leaf (31 leaves,
    614,803,456 entries: ``encoder`` sorts between ``embed`` and
    ``final_norm``); the reduced tree drawn on the CPU."""
    jm, jp, tm, _ = model
    jcfg, tcfg = jbase.get_config(ARCH), tbase.get_config("seamless-m4t-medium")
    assert port_cfg(jcfg) == tcfg and tcfg.param_count() == jcfg.param_count()
    assert port_cfg(jbase.reduced(jcfg)) == tbase.reduced(tcfg)
    with torch.device("meta"):
        meta = build_model(tcfg).init(torch.Generator())
    want = jpaths(jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0)))
    assert tpaths(meta) == want
    assert (len(want), sum(int(np.prod(s)) for _, s, _ in want)) == (31, 614_803_456)
    assert [p for p, _, _ in want[:2]] == ["embed/embedding", "encoder/final_norm/bias"]
    assert tpaths(tm.init(torch.Generator().manual_seed(0))) == jpaths(jp)


def attn_params(jcfg, seed):
    jp = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, cross=True)
    return jp, params_from_jax(np_tree(jp), "cpu")


@pytest.mark.parametrize("q_chunk", [0, 8], ids=["rule", "two-chunks"])
def test_cross_attention_train_and_decode_match(model, q_chunk):
    """The ``cross`` kind over an encoder memory of 24 positions: no mask,
    no RoPE, K/V from the memory (returned unroped for the cache); with the
    rule's chunk (from Sk: one slab) and with two explicit chunks of 8.
    Then one decode step over that memory as ``cross_memory``: the cache
    comes back as it went in."""
    jm, _, tm, _ = model
    jp, tp = attn_params(jm.cfg, 5)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    mem = rng.standard_normal((B, S_ENC, 256)).astype(np.float32)
    jout, (jk, jv) = jattn.attn_train(jp, jnp.asarray(x), jm.cfg, "cross", kv_x=jnp.asarray(mem),
                                      q_chunk=q_chunk, return_cache_seq=True)
    tout, (tk, tv) = tattn.attn_train(tp, t(x), tm.cfg, "cross", kv_x=t(mem), q_chunk=q_chunk,
                                      return_cache_seq=True)
    close(tout, jout, what="cross out")
    close(tk, jk, what="cross k")
    close(tv, jv, what="cross v")
    close(tk, n(t(mem) @ tp["wk"]["w"]).reshape(B, S_ENC, 4, 64), what="k unroped")
    jd, jc = jattn.attn_decode(jp, jnp.asarray(x[:, :1]), jm.cfg, "cross", None, jnp.asarray(3),
                               cross_memory=(jk, jv))
    sentinel = {"k": torch.zeros(1)}
    td, tc = tattn.attn_decode(tp, t(x[:, :1]), tm.cfg, "cross", sentinel, 3,
                               cross_memory=(tk, tv))
    close(td, jd, what="cross decode")
    assert jc is None and tc is sentinel
    close(td, n(tout)[:, :1], what="cross decode == the train row")


def test_encoder_bidirectional_attention_matches(model):
    """The encoder's ``attn_bidir`` layer: roped at ``arange(S_enc)``, no
    causal mask."""
    jm, _, tm, _ = model
    ecfg = jtf._enc_cfg(jm.cfg)
    assert set(ecfg.layer_kinds) == {"attn_bidir"}
    assert ttf._enc_cfg(tm.cfg) == port_cfg(ecfg)
    jp, tp = attn_params(ecfg, 6)
    x = np.random.default_rng(6).standard_normal((B, S_ENC, 256)).astype(np.float32)
    jout, (jk, _) = jattn.attn_train(jp, jnp.asarray(x), ecfg, "attn_bidir", return_cache_seq=True)
    tout, (tk, _) = tattn.attn_train(tp, t(x), ttf._enc_cfg(tm.cfg), "attn_bidir",
                                     return_cache_seq=True)
    close(tout, jout, what="bidir out")
    close(tk, jk, what="bidir k (roped)")


@pytest.mark.parametrize("inp", ["frames", "tokens"])
def test_encode_matches(model, inp):
    """``_encode`` on float frames (cast, no embedding, no √d) and on int
    tokens (the decoder's embedding, √d)."""
    jm, jp, tm, tp = model
    x = frames() if inp == "frames" else tokens(512, (B, S_ENC), 2)
    want = jtf._encode(jp, jnp.asarray(x), jm.cfg)
    got = ttf._encode(tp, t(x) if inp == "frames" else t(x).long(), tm.cfg)
    assert got.shape == (B, S_ENC, 256)
    close(got, want, what=f"encode {inp}")


def test_hidden_loss_and_gradients_match(model):
    jm, jp, tm, tp = model
    tok = tokens(512, (B, S + 1), 3)
    fr = frames(4)
    jbatch = {"tokens": jnp.asarray(tok[:, :-1]), "labels": jnp.asarray(tok[:, 1:]),
              "enc_frames": jnp.asarray(fr)}
    tbatch = {"tokens": t(tok[:, :-1]).long(), "labels": t(tok[:, 1:]).long(),
              "enc_frames": t(fr)}
    jh, _ = jtf.decoder_hidden(jp, jbatch["tokens"], jm.cfg, enc_frames=jbatch["enc_frames"])
    th, _ = ttf.decoder_hidden(tp, tbatch["tokens"], tm.cfg, enc_frames=tbatch["enc_frames"])
    close(th, jh, what="hidden")
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jbatch)
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tl = tm.loss_fn(treedef.unflatten(leaves), tbatch)
    close(tl, jl, what="loss")
    grads_close(treedef.unflatten(list(torch.autograd.grad(tl, leaves))), jg, "seamless")


def test_prefill_then_decode_match(model):
    """Prefill 16 tokens over 24 frames (the caches carry the encoder's
    length in ``cross_k``/``cross_v``), then decode position 16: the logits
    against the reference's ``decoder_decode_step`` on its own caches, and
    against a prefill of 17 tokens within the reference's 5%.  A fresh
    session's zero caches are sized by the session, as the reference's."""
    jm, jp, tm, tp = model
    tok, fr = tokens(512, (B, S), 7), frames(8)
    nxt = np.full((B, 1), 5, np.int32)
    jh, jc = jm.prefill(jp, {"tokens": jnp.asarray(tok), "enc_frames": jnp.asarray(fr)})
    th, tc = tm.prefill(tp, {"tokens": t(tok).long(), "enc_frames": t(fr)})
    close(th, jh, what="prefill hidden")
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc["scan"]["b0"][key].shape) == tuple(jc["scan"]["b0"][key].shape)
        close(tc["scan"]["b0"][key], jc["scan"]["b0"][key], what=f"cache {key}")
    assert tc["scan"]["b0"]["cross_k"].shape == (2, B, S_ENC, 4, 64)
    jl, _ = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(S))
    tl, tc2 = tm.decode_step(tp, t(nxt).long(), tc, S)
    close(tl, jl, rtol=1e-4, atol=1e-4, what="decode logits")
    assert torch.equal(tc2["scan"]["b0"]["cross_k"], tc["scan"]["b0"]["cross_k"])
    ref, _ = ServeEngine(tm).prefill(tp, {"tokens": t(np.concatenate([tok, nxt], 1)).long(),
                                          "enc_frames": t(fr)})
    assert float((tl - ref).abs().max()) / float(ref.abs().max()) < 0.05
    fresh = tm.init_caches(tp, B, 40)
    want = jax.eval_shape(lambda: jm.init_caches(jp, B, 40))
    assert tpaths(fresh) == jpaths(want)


def test_one_local_dsgd_round_matches():
    """One local round of the reduced preset (2 clients, p = 0.02, the wire
    metered, Adam warm) from the reference's parameters and the same
    tokens and frames: loss, Eq. 1 and measured bits, survivors."""
    fr = (0.1 * np.random.default_rng(9).standard_normal((2, 1, B, 32, 256))).astype(np.float32)
    one_round(ARCH, extra={"enc_frames": fr})


@pytest.mark.parametrize("backend", ["gspmd", "fed"])
def test_the_preset_runs_on_the_gspmd_and_fed_backends(backend):
    """The reduced preset (``client_mode="data"``) on the GSPMD hist engine
    (the reference's Eq. 1 bits) and the fed backend (a reconciled
    ledger), one round each, the task's samples carrying ``enc_frames``."""
    preset_round(ARCH, backend, "enc_frames", (2, 16, 256))


def preset_round(arch: str, backend: str, field: str, shape: tuple) -> None:
    """One round of ``arch``'s reduced preset on ``backend`` (batch 2 x 16,
    p = 0.05), its samples carrying ``field`` of ``shape`` drawn the same for
    one (step, client) and anew for another: a finite loss, and the
    reference's Eq. 1 bits on the GSPMD hist engine or a reconciled ledger
    on fed."""
    extra = (dict(fast=True, flat_engine="hist", clients=1) if backend == "gspmd"
             else dict(clients=2, cohort=2))
    run = build_run(RunSpec(preset=arch, backend=backend, rounds=1, sparsity=0.05, batch=2,
                            seq_len=16, **extra), device="cpu")
    sample = run.task.sample(0, 0)[field]
    assert sample.shape == shape
    assert torch.equal(sample, run.task.sample(0, 0)[field])
    assert not torch.equal(sample, run.task.sample(1, 0)[field])
    _, hist = run.run()
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"][0])
    if backend == "fed":
        run.ledger.reconcile(rel=0.25)
        return
    from jax.sharding import Mesh
    from repro.launch.dist import build_dist_train as j_build_dist_train

    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jfns = j_build_dist_train(jbase.reduced(jbase.get_config(arch)), mesh, compressor="sbc",
                              sparsity=0.05, fast=True, flat_engine="hist")
    assert run.fns.bits_per_client == jfns.bits_per_client


def test_chip_smoke_pins_are_the_references():
    """``chip_smoke.py`` phase 14's pins from shapes alone (``jax.eval_shape``
    and the ``meta`` device, never drawing a parameter): seamless at full
    width and depth and phi-3-vision at 8 layers, in ``STUB_VARIANT``:
    their parameter counts, leaves, largest segments and Eq. 1 bits a client
    of the GSPMD backend (``SEAMLESS_PINS``, ``PHI3V_PINS``), the configs
    the reference's; and ``SERVE_STUBS``'s parameter counts."""
    import dataclasses

    from test_torch_zoo_run import _gspmd_bits
    from torch_helpers import load_chip_smoke

    smoke = load_chip_smoke()
    jvariant = {k: getattr(jnp, v) for k, v in smoke.STUB_VARIANT.items()}
    for name, spec, pins, layers in (
            ("seamless_m4t_medium", smoke.SEAMLESS, smoke.SEAMLESS_PINS, {}),
            ("phi3_vision_4p2b", smoke.PHI3V, smoke.PHI3V_PINS,
             {"n_layers": smoke.PHI3V_LAYERS})):
        jcfg = dataclasses.replace(jbase.get_config(name), **jvariant, **layers)
        tcfg = smoke.stub_variant(name, **layers)
        assert port_cfg(jcfg) == tcfg and tcfg.client_mode == "data"
        shapes = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
        sizes = [int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)]
        assert (sum(sizes), len(sizes), max(sizes)) == (
            pins["params"], pins["leaves"], pins["segment"]), name
        p = spec["sparsity"]
        assert _gspmd_bits("jax", jcfg, p) == _gspmd_bits("torch", tcfg, p) == pins["eq1"], name
    for name, layers, _, _, count in smoke.SERVE_STUBS:
        cfg = dataclasses.replace(jbase.get_config(name), n_layers=layers)
        shapes = jax.eval_shape(j_build_model(cfg).init, jax.random.PRNGKey(0))
        assert sum(int(np.prod(v.shape)) for v in jax.tree.leaves(shapes)) == count, name
