"""The port's dense decoder (``repro_torch.models`` layers, attention,
losses, transformer and model; ``repro_torch.configs``) against the JAX
package, on the CPU.

Inputs are made with numpy from a seed; the reference's parameters cross
with ``params_from_jax``.  Tolerances (the two frameworks order a GEMM's
and a reduction's adds differently, nothing else):
  * layers, attention outputs and caches, logits and the loss in f32:
    ``rtol=1e-5`` beside ``atol=1e-5`` (``atol`` where a value can cross
    zero); cache positions and every shape, dtype and tree path: exact;
  * gradients (``jax.grad`` against autograd): ``rtol=1e-4`` beside
    ``atol`` of 1e-5 of the leaf's largest gradient;
  * bf16: the scaled embedding (``√d`` rounded to bf16 first, as JAX's
    weak type does) bit for bit, and the whole forward within 2 bf16 ulps
    of the logits' scale (``atol=2·2⁻⁸·max|logits|``);
  * configs (``param_count``, ``layer_kinds``, ``reduced``, aliases,
    ``input_specs``) and the bf16 convert: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import losses as jlosses
from repro.models import transformer as jtf
from repro.models.model import build_model as j_build_model
from repro.run.presets import fed_tiny_config as j_fed_tiny
from repro.run.presets import lm_100m_config as j_lm_100m
from repro.run.presets import tiny_config as j_tiny
from repro_torch.configs import base as tbase
from repro_torch.convert import params_from_jax
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten, tree_flatten_with_path
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import losses as tlosses
from repro_torch.models import transformer as ttf
from repro_torch.models.model import build_model
from repro_torch.run.presets import fed_tiny_config, lm_100m_config, tiny_config
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
DENSE = ["gemma3_1b", "qwen15_4b", "granite_20b", "command_r_35b"]


def port_cfg(jcfg) -> tbase.ModelConfig:
    """The port's ModelConfig with every field of the reference's."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for k in ("dtype", "residual_dtype"):
        kw[k] = DTYPES[jnp.dtype(kw[k]).type]
    return tbase.ModelConfig(**kw)


def close(a, b, rtol=1e-5, atol=1e-5, what=""):
    np.testing.assert_allclose(n(a).astype(np.float64), np.asarray(b).astype(np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def grads_close(tg, jg, what=""):
    jflat = {"/".join(k.key for k in p): np.asarray(v)
             for p, v in jax.tree_util.tree_flatten_with_path(jg)[0]}
    for p, v in tree_flatten_with_path(tg)[0]:
        ref = jflat[path_str(p)]
        scale = float(np.max(np.abs(ref))) or 1.0
        close(v, ref, rtol=1e-4, atol=1e-5 * scale, what=f"{what} grad {path_str(p)}")


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(1)
    x = (3.0 * rng.standard_normal((2, 5, 48)) + 0.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(48)).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = (0.1 * rng.standard_normal(48)).astype(np.float32)
    want = jlayers.norm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind)
    got = tlayers.norm_apply({k: t(v) for k, v in p.items()}, t(x), kind)
    close(got, want, what=kind)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(7, 47, dtype=np.int32)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    close(tlayers.rope(t(x), t(pos), theta), want, atol=1e-4, what="rope")


@pytest.mark.parametrize("gated", [True, False], ids=["silu-gated", "gelu"])
def test_mlp_matches(gated):
    jp = jlayers.init_mlp(jax.random.PRNGKey(3), 32, 64, gated=gated, dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((2, 6, 32)).astype(np.float32)
    want = jlayers.mlp_apply(jp, jnp.asarray(x))
    got = tlayers.mlp_apply(params_from_jax(np_tree(jp), "cpu"), t(x))
    close(got, want, what="mlp")


# --------------------------------------------------------------- attention

KINDS = {
    "attn": {},
    "attn_window": dict(window=5),
    "attn_local": dict(local_window=5, local_global_ratio=1),
    "attn_chunk": dict(chunk_attn=4, global_every=2),
    "attn_bidir": dict(bidirectional=True),
}


def attn_setup(kind, S=12, qkv_bias=False, **extra):
    jcfg = jbase.ModelConfig(name="a", family="decoder", n_layers=2, d_model=32, n_heads=4,
                             n_kv_heads=2, d_ff=64, vocab_size=50, dtype=jnp.float32,
                             qkv_bias=qkv_bias, **{**KINDS[kind], **extra})
    jp = jattn.init_attention(jax.random.PRNGKey(4), jcfg)
    if qkv_bias:  # non-zero biases, so the test sees them
        jp = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 if p[-1].key == "b" else v, jp)
    x = np.random.default_rng(4).standard_normal((2, S, 32)).astype(np.float32)
    return jcfg, port_cfg(jcfg), jp, params_from_jax(np_tree(jp), "cpu"), x


@pytest.mark.parametrize("kind", list(KINDS))
def test_attn_train_matches(kind):
    jcfg, tcfg, jp, tp, x = attn_setup(kind, qkv_bias=kind == "attn")
    jout, (jk, jv) = jattn.attn_train(jp, jnp.asarray(x), jcfg, kind, return_cache_seq=True)
    tout, (tk, tv) = tattn.attn_train(tp, t(x), tcfg, kind, return_cache_seq=True)
    close(tout, jout, what=f"{kind} out")
    close(tk, jk, what=f"{kind} k")
    close(tv, jv, what=f"{kind} v")


@pytest.mark.parametrize("kind", ["attn", "attn_window"])
def test_attn_q_chunked_path_matches(kind):
    """S = 256 with an explicit q_chunk of 128: two chunks, the window
    crossing their border."""
    jcfg, tcfg, jp, tp, x = attn_setup(kind, S=256, window=100)
    jout, _ = jattn.attn_train(jp, jnp.asarray(x), jcfg, kind, q_chunk=128)
    tout, _ = tattn.attn_train(tp, t(x), tcfg, kind, q_chunk=128)
    close(tout, jout, what=kind)
    whole, _ = tattn.attn_train(tp, t(x), tcfg, kind, q_chunk=256)
    close(tout, n(whole), what="chunked == one slab")
    with pytest.raises(AssertionError, match="not divisible by q_chunk"):
        tattn.attn_train(tp, t(x[:, :200]), tcfg, kind, q_chunk=128)


@pytest.mark.parametrize("kind", [k for k in KINDS if k != "attn_bidir"])
@pytest.mark.parametrize("S", [12, 3])
def test_attn_decode_matches(kind, S):
    """Prefill S positions into the cache (rolling past the window at S =
    12), then decode position S: outputs and caches equal, pos exact."""
    jcfg, tcfg, jp, tp, x = attn_setup(kind, S=S + 1)
    _, (jk, jv) = jattn.attn_train(jp, jnp.asarray(x[:, :S]), jcfg, kind, return_cache_seq=True)
    _, (tk, tv) = tattn.attn_train(tp, t(x[:, :S]), tcfg, kind, return_cache_seq=True)
    jc = jattn.fill_cache_from_prefill(jattn.init_cache(jcfg, kind, 2, S, jnp.float32),
                                       kind, jcfg, jk, jv)
    tc = tattn.fill_cache_from_prefill(tattn.init_cache(tcfg, kind, 2, S, torch.float32),
                                       kind, tcfg, tk, tv)
    np.testing.assert_array_equal(n(tc["pos"]), np.asarray(jc["pos"]))
    close(tc["k"], jc["k"], what="prefill k")
    jout, jc2 = jattn.attn_decode(jp, jnp.asarray(x[:, S:]), jcfg, kind, jc, jnp.asarray(S))
    tout, tc2 = tattn.attn_decode(tp, t(x[:, S:]), tcfg, kind, tc, S)
    close(tout, jout, what=f"{kind} decode out")
    np.testing.assert_array_equal(n(tc2["pos"]), np.asarray(jc2["pos"]))
    for key in ("k", "v"):
        close(tc2[key], jc2[key], what=f"decode {key}")
    assert int(tc["pos"].max()) == S - 1  # the cache passed in is left as it was


def test_decode_past_the_cache_clamps_to_its_last_slot():
    """``lax.dynamic_update_slice`` clamps the slot: a full layer's cache
    of depth 128 written at position 130 changes slot 127, in both."""
    jcfg, tcfg, jp, tp, x = attn_setup("attn", S=1)
    jc = jattn.init_cache(jcfg, "attn", 2, 4, jnp.float32)
    tc = tattn.init_cache(tcfg, "attn", 2, 4, torch.float32)
    assert tc["k"].shape[1] == 128
    jout, jc2 = jattn.attn_decode(jp, jnp.asarray(x), jcfg, "attn", jc, jnp.asarray(130))
    tout, tc2 = tattn.attn_decode(tp, t(x), tcfg, "attn", tc, 130)
    np.testing.assert_array_equal(n(tc2["pos"]), np.asarray(jc2["pos"]))
    assert int(tc2["pos"][127]) == 130 and int((tc2["pos"] >= 0).sum()) == 1
    close(tout, jout, what="clamped decode")


def test_cross_attention_belongs_to_part_3():
    """Cross attention (ROADMAP A12, part 3, item 3) runs now: over a
    memory of 7 positions (GQA, 4 heads over 2), train and one decode step
    equal the reference's; tests/test_torch_encdec.py holds the rest."""
    jcfg, tcfg, jp, tp, x = attn_setup("attn")
    mem = np.random.default_rng(8).standard_normal((2, 7, 32)).astype(np.float32)
    jout, (jk, jv) = jattn.attn_train(jp, jnp.asarray(x), jcfg, "cross", kv_x=jnp.asarray(mem),
                                      return_cache_seq=True)
    tout, (tk, tv) = tattn.attn_train(tp, t(x), tcfg, "cross", kv_x=t(mem), return_cache_seq=True)
    close(tout, jout, what="cross out")
    cache = tattn.init_cache(tcfg, "attn", 2, 4, torch.float32)
    jd, _ = jattn.attn_decode(jp, jnp.asarray(x[:, :1]), jcfg, "cross", None, jnp.asarray(0),
                              cross_memory=(jk, jv))
    td, same = tattn.attn_decode(tp, t(x[:, :1]), tcfg, "cross", cache, 0, cross_memory=(tk, tv))
    close(td, jd, what="cross decode")
    assert same is cache


# -------------------------------------------------------------------- loss


@pytest.mark.parametrize("S, chunk", [(32, 8), (12, 8)], ids=["4-slabs", "one-slab"])
def test_chunked_softmax_xent_matches(S, chunk):
    rng = np.random.default_rng(5)
    h = rng.standard_normal((2, S, 16)).astype(np.float32)
    emb = rng.standard_normal((40, 16)).astype(np.float32)
    y = rng.integers(0, 40, (2, S)).astype(np.int32)
    want = jlosses.chunked_softmax_xent(jnp.asarray(h), jnp.asarray(emb), jnp.asarray(y),
                                        chunk=chunk)
    got = tlosses.chunked_softmax_xent(t(h), t(emb), t(y).long(), chunk=chunk)
    close(got, want, what="xent")
    plain = jlosses.softmax_xent(jnp.asarray(h) @ jnp.asarray(emb).T, jnp.asarray(y))
    close(got, plain, what="xent == one-shot")


# ------------------------------------------------------------------ models


def model_setup(jcfg, S=16, seed=0):
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tcfg = port_cfg(jcfg)
    tp = params_from_jax(np_tree(jp), "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (2, S + 1)).astype(np.int32)
    return jm, jp, build_model(tcfg), tp, toks[:, :-1], toks[:, 1:]


MODELS = {"tiny": j_tiny, "fed-tiny": j_fed_tiny,
          **{a: (lambda a=a: jbase.reduced(jbase.get_config(a))) for a in DENSE}}


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_loss_and_grads_match(name):
    jcfg = MODELS[name]()
    jm, jp, tm, tp, tok, lab = model_setup(jcfg)
    assert [path_str(p) for p, _ in tree_flatten_with_path(tm.init(torch.Generator()))[0]] == \
        ["/".join(k.key for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    jh, _ = jtf.decoder_hidden(jp, jnp.asarray(tok), jcfg)
    th, aux = ttf.decoder_hidden(tp, t(tok).long(), tm.cfg)
    close(th, jh, rtol=1e-4, atol=1e-4, what="hidden")
    assert float(aux) == 0.0
    jbatch = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)}
    tbatch = {"tokens": t(tok).long(), "labels": t(lab).long()}
    jl, jg = jax.value_and_grad(jm.loss_fn)(jp, jbatch)
    leaves, treedef = tree_flatten(tp)
    leaves = [v.requires_grad_(True) for v in leaves]
    tl = tm.loss_fn(treedef.unflatten(leaves), tbatch)
    tg = treedef.unflatten(list(torch.autograd.grad(tl, leaves)))
    close(tl, jl, what="loss")
    grads_close(tg, jg, name)


def test_bf16_forward_rounds_the_embedding_scale_as_jax_does():
    """``embed · √d`` on a bf16 table: JAX rounds √d to bf16 first (√64 is
    exact; d = 48 gives √48 = 6.928… → 6.9375).  The scaled embedding is
    bit for bit the reference's, and the forward within 2 bf16 ulps."""
    jcfg = dataclasses.replace(j_tiny(), dtype=jnp.bfloat16, d_model=48, head_dim=12)
    jm, jp, tm, tp, tok, _ = model_setup(jcfg)
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    np.testing.assert_array_equal(n(tp["embed"]["embedding"].view(torch.int16)),
                                  np.asarray(jp["embed"]["embedding"]).view(np.int16))
    jx = jtf._embed_inputs(jp, jnp.asarray(tok), jcfg)
    tx = ttf._embed_inputs(tp, t(tok).long(), tm.cfg)
    assert tx.dtype == torch.bfloat16
    np.testing.assert_array_equal(n(tx.view(torch.int16)), np.asarray(jx).view(np.int16))
    unrounded = (tlayers.embed_lookup(tp["embed"], t(tok).long()) * (48 ** 0.5))
    assert not torch.equal(unrounded, tx)  # the trap this guards against
    jh, _ = jtf.decoder_hidden(jp, jnp.asarray(tok), jcfg)
    th, _ = ttf.decoder_hidden(tp, t(tok).long(), tm.cfg)
    emb = np.asarray(jp["embed"]["embedding"]).astype(np.float32)
    jlog = np.asarray(jh).astype(np.float32) @ emb.T
    tlog = n(th.float()) @ emb.T
    close(tlog, jlog, rtol=0, atol=2 * 2 ** -8 * float(np.abs(jlog).max()), what="bf16 logits")


def test_decoder_init_draws_on_the_generators_device_in_its_dtype():
    cfg = dataclasses.replace(tiny_config(), dtype=torch.bfloat16)
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert {v.dtype for v in tree_flatten(p)[0]} == {torch.bfloat16}
    with torch.device("meta"):
        meta = build_model(cfg).init(torch.Generator())
    assert all(v.is_meta for v in tree_flatten(meta)[0])
    assert [tuple(v.shape) for v in tree_flatten(meta)[0]] == \
        [tuple(v.shape) for v in tree_flatten(p)[0]]


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "llama4_maverick_400b_a17b", "jamba_v01_52b",
                                  "rwkv6_1p6b", "seamless_m4t_medium", "phi3_vision_4p2b"])
def test_the_rest_of_the_zoo_belongs_to_part_3(arch):
    """The MoE and recurrent decoders (ROADMAP A12, part 3, items 1 and 2),
    seamless-m4t (item 3, over 8 frames) and phi-3-vision (item 4, its 8
    prefix positions) build and run a forward: the config the reference's,
    a finite hidden state (held against the reference in
    tests/test_torch_zoo_run.py, test_torch_encdec.py and
    test_torch_vision_prefix.py)."""
    assert tbase.get_config(arch) == port_cfg(jbase.get_config(arch))
    cfg = tbase.reduced(tbase.get_config(arch))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tok = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)))
    stub = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 8, cfg.d_model))
                            .astype(np.float32))
    extra = ({"enc_frames": stub} if cfg.family == "encdec"
             else {"prefix": stub} if cfg.modality == "vision" else {})
    hidden, aux = ttf.decoder_hidden(params, tok, cfg, **extra)
    assert hidden.shape == (2, 8, cfg.d_model) and bool(torch.isfinite(hidden).all())
    assert (float(aux) > 0) == bool(cfg.moe_experts)


# ----------------------------------------------------------------- configs


@pytest.mark.parametrize("arch", DENSE + tbase.PAPER_ARCHS)
def test_configs_are_the_references(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    assert port_cfg(jcfg) == tcfg
    assert tcfg.layer_kinds == jcfg.layer_kinds and tcfg.layer_moe == jcfg.layer_moe
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tcfg.sub_quadratic == jcfg.sub_quadratic
    for shape in tbase.INPUT_SHAPES:
        assert tcfg.skip_reason(shape) == jcfg.skip_reason(shape)
    assert port_cfg(jbase.reduced(jcfg)) == tbase.reduced(tcfg)
    assert ttf.stack_pattern(tcfg) == jtf.stack_pattern(jcfg)


@pytest.mark.parametrize("preset, jfn, tfn", [
    ("tiny", j_tiny, tiny_config), ("fed-tiny", j_fed_tiny, fed_tiny_config),
    ("lm-100m", j_lm_100m, lm_100m_config)])
def test_preset_configs_are_the_references(preset, jfn, tfn):
    assert port_cfg(jfn()) == tfn()
    if preset == "lm-100m":
        assert tfn().param_count() == jfn().param_count()
        with torch.device("meta"):
            p = build_model(tfn()).init(torch.Generator())
        shapes = jax.eval_shape(j_build_model(jfn()).init, jax.random.PRNGKey(0))
        assert [tuple(v.shape) for v in tree_flatten(p)[0]] == \
            [v.shape for v in jax.tree.leaves(shapes)]
        assert sum(v.numel() for v in tree_flatten(p)[0]) == 137_841_408


@pytest.mark.parametrize("name", ["qwen1.5-4b", "qwen15_4b", "gemma3-1b", "granite-20b",
                                  "command-r-35b", "lenet5"])
def test_get_config_aliases(name):
    assert tbase.get_config(name) == port_cfg(jbase.get_config(name))
    with pytest.raises(KeyError, match="no config module"):
        tbase.get_config("no-such-arch")
    assert tbase.get_config(name, base_lr=0.5).base_lr == 0.5


@pytest.mark.parametrize("arch", ["gemma3_1b", "qwen15_4b", "lenet5"])
@pytest.mark.parametrize("shape", list(tbase.INPUT_SHAPES))
def test_input_specs_are_the_references(arch, shape):
    jspecs = jbase.input_specs(jbase.get_config(arch), shape, n_clients=4)
    tspecs = tbase.input_specs(tbase.get_config(arch), shape, n_clients=4)
    assert sorted(jspecs) == sorted(tspecs)
    for k, v in tspecs.items():
        assert v.is_meta and tuple(v.shape) == jspecs[k].shape
        assert v.dtype == DTYPES[jnp.dtype(jspecs[k].dtype).type] if jnp.dtype(
            jspecs[k].dtype).kind == "f" else v.dtype == torch.int32
    assert tbase.ASSIGNED_ARCHS == jbase.ASSIGNED_ARCHS
    assert tbase.INPUT_SHAPES == jbase.INPUT_SHAPES


# ----------------------------------------------------------------- convert


def test_bf16_tree_crosses_params_from_jax_bit_for_bit():
    rng = np.random.default_rng(6)
    vals = (rng.standard_normal((3, 70)) * np.exp(4 * rng.standard_normal((3, 70))))
    jtree = {"a": {"w": jnp.asarray(vals, jnp.bfloat16)},
             "b": jnp.asarray([0.0, -0.0, np.inf, -np.inf, 1e-40], jnp.bfloat16),
             "f": jnp.asarray(vals[0], jnp.float32)}
    got = params_from_jax(np_tree(jtree), "cpu")
    assert got["a"]["w"].dtype == torch.bfloat16 and got["f"].dtype == torch.float32
    for tv, jv in ((got["a"]["w"], jtree["a"]["w"]), (got["b"], jtree["b"])):
        np.testing.assert_array_equal(n(tv.view(torch.int16)), np.asarray(jv).view(np.int16))
    np.testing.assert_array_equal(n(got["f"]), np.asarray(jtree["f"]))
