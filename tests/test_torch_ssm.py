"""The port's Mamba and RWKV6 blocks (``repro_torch.models.ssm``) against
the JAX package's ``repro.models.ssm``, on the CPU.

The configs are the reference's ``reduced`` jamba-v0.1 (Mamba: d 256,
di 512, N 8, conv width 4) and rwkv6-1.6b (d 256, 4 heads of 64).
Inputs and carried states come from numpy seeds; the reference's
parameters cross with ``params_from_jax``.  Tolerances:
  * f32 outputs and states: ``rtol=1e-5`` beside ``atol=1e-5``;
  * gradients (``jax.grad`` through ``lax.scan`` against autograd through
    the loop): ``rtol=1e-4`` beside ``atol`` of 1e-5 of the leaf's largest
    gradient;
  * bf16: within 2 bf16 ulps of the output's scale;
  * exact: the trees' paths, shapes and dtypes, and the deterministic
    leaves (``D``, ``conv_b``, the mixes, ``bonus``, ``ln_x``); within one
    f32 ulp: ``A_log`` (XLA's f32 log of 7 is one ulp off the correctly
    rounded value that torch gives) and ``w0`` (``jnp.linspace``'s formula);
  * ``softplus`` (``logaddexp(x, 0)`` in both): within 2 f32 ulps of
    ``jax.nn.softplus`` (3,229 of 200,001 points on [−30, 30] differ).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import ssm as jssm
from repro_torch.convert import params_from_jax
from repro_torch.core.tree import tree_flatten
from repro_torch.models import ssm as tssm
from test_torch_decoder import close, port_cfg
from test_torch_moe import jpaths, tpaths
from torch_helpers import n, t, torch_one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _cfgs(arch, **kw):
    jcfg = dataclasses.replace(jbase.reduced(jbase.get_config(arch)), **kw)
    return jcfg, port_cfg(jcfg)


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = _cfgs("jamba_v01_52b")
    jp = jssm.init_mamba(jax.random.PRNGKey(1), jcfg)
    # a non-zero conv bias and dt bias, so the test sees them
    jp = {**jp, "conv_b": jnp.linspace(-0.1, 0.1, jp["conv_b"].shape[0]),
          "dt_proj": {**jp["dt_proj"], "b": jnp.full_like(jp["dt_proj"]["b"], -1.0)}}
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def rwkv():
    jcfg, tcfg = _cfgs("rwkv6_1p6b")
    jp = jssm.init_rwkv6(jax.random.PRNGKey(2), jcfg)
    rng = np.random.default_rng(2)
    # mixes, bonus and ln_x away from their init, so the test sees each
    for k in ("mix", "mix_w", "cmix_k", "cmix_r"):
        jp[k] = jnp.asarray(rng.uniform(0.1, 0.9, jp[k].shape), jnp.float32)
    jp["bonus"] = jnp.asarray(0.3 * rng.standard_normal(jp["bonus"].shape), jnp.float32)
    jp["ln_x"] = jnp.asarray(1 + 0.1 * rng.standard_normal(jp["ln_x"].shape), jnp.float32)
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def xs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------ inits


@pytest.mark.parametrize("arch, jinit, tinit", [
    ("jamba_v01_52b", jssm.init_mamba, tssm.init_mamba),
    ("rwkv6_1p6b", jssm.init_rwkv6, tssm.init_rwkv6)], ids=["mamba", "rwkv6"])
def test_inits_are_the_references(arch, jinit, tinit):
    """In a bf16 model: the tree leaf for leaf (the f32 leaves stay f32),
    the deterministic leaves equal, ``w0`` within one ulp; the drawn ones
    on ``meta`` give the same shapes."""
    jcfg, tcfg = _cfgs(arch, dtype=jnp.bfloat16)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    tp = tinit(torch.Generator().manual_seed(0), tcfg)
    assert tpaths(tp) == jpaths(jp)
    fixed = ["D", "conv_b", "mix", "mix_w", "bonus", "ln_x", "cmix_k", "cmix_r"]
    for k in fixed:
        if k in jp:
            want = np.asarray(jp[k]).astype(np.float32)
            np.testing.assert_array_equal(n(tp[k].float()), want, err_msg=k)
    for k in ("A_log", "w0"):
        if k in jp:
            np.testing.assert_array_max_ulp(n(tp[k]), np.asarray(jp[k]), maxulp=1)
    if "w0" in jp:  # and at rwkv6-1.6b's full width
        np.testing.assert_array_max_ulp(n(tssm._linspace(-6.0, -1.0, 2048, None)),
                                        np.asarray(jnp.linspace(-6.0, -1.0, 2048)), maxulp=1)
    with torch.device("meta"):
        meta = tinit(torch.Generator(), tcfg)
    assert all(v.is_meta for v in tree_flatten(meta)[0]) and tpaths(meta) == jpaths(jp)


# ------------------------------------------------------------------ Mamba


def test_causal_conv_matches(mamba):
    """The shifted multiply-adds against ``conv_general_dilated``."""
    jcfg, _, jp, tp = mamba
    x = xs((2, 10, jp["conv_b"].shape[0]), 3)
    want = jssm._causal_conv(jnp.asarray(x), jp["conv_w"], jp["conv_b"])
    close(tssm._causal_conv(t(x), tp["conv_w"], tp["conv_b"]), want, what="conv")


@pytest.mark.parametrize("S", [12, 2], ids=["S>=w-1", "S<w-1"])
def test_mamba_train_then_decode_match(mamba, S):
    """``mamba_train``'s out, final state and pre-conv tail (zero-padded in
    front when S < w − 1), then two decode steps carried on from that
    state: outs and states equal."""
    jcfg, tcfg, jp, tp = mamba
    x = xs((2, S + 2, jcfg.d_model), 4)
    jout, jh, jtail = jssm.mamba_train(jp, jnp.asarray(x[:, :S]), jcfg)
    tout, th, ttail = tssm.mamba_train(tp, t(x[:, :S]), tcfg)
    close(tout, jout, what="out")
    close(th, jh, what="h_final")
    close(ttail, jtail, what="conv_tail")
    assert ttail.shape == (2, jcfg.ssm_conv - 1, 2 * jcfg.d_model)
    if S < jcfg.ssm_conv - 1:
        assert not ttail[:, : jcfg.ssm_conv - 1 - S].any()
    jst, tst = {"h": jh, "conv": jtail}, {"h": th, "conv": ttail}
    for i in range(S, S + 2):
        jo, jst = jssm.mamba_decode(jp, jnp.asarray(x[:, i:i + 1]), jcfg, jst)
        to, tst = tssm.mamba_decode(tp, t(x[:, i:i + 1]), tcfg, tst)
        close(to, jo, what=f"decode out at {i}")
        for k in ("h", "conv"):
            close(tst[k], jst[k], what=f"decode {k} at {i}")
    st0 = tssm.mamba_init_state(tcfg, 3)
    jst0 = jssm.mamba_init_state(jcfg, 3)
    assert {k: (tuple(v.shape), v.dtype) for k, v in st0.items()} == \
        {k: (v.shape, torch.float32) for k, v in jst0.items()}


def test_mamba_gradients_match(mamba):
    jcfg, tcfg, jp, tp = mamba
    x = xs((2, 8, jcfg.d_model), 5)
    w = xs((2, 8, jcfg.d_model), 6)

    def jloss(p, xx):
        out, h, _ = jssm.mamba_train(p, xx, jcfg)
        return jnp.sum(out * w) + jnp.sum(h)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tx = t(x).requires_grad_(True)
    out, h, _ = tssm.mamba_train(treedef.unflatten(leaves), tx, tcfg)
    grads = torch.autograd.grad(torch.sum(out * t(w)) + torch.sum(h), leaves + [tx],
                                allow_unused=True)
    _check_grads(jg, jgx, tp, grads, "mamba")


def _check_grads(jg, jgx, tp, grads, what):
    jflat = {p: np.asarray(v) for (p, _, _), v in zip(jpaths(jg), jax.tree.leaves(jg))}
    for (p, _, _), g in zip(tpaths(tp), grads[:-1]):
        ref = jflat[p]
        got = torch.zeros_like(torch.from_numpy(ref)) if g is None else g
        close(got, ref, rtol=1e-4, atol=1e-5 * (float(np.abs(ref).max()) or 1.0),
              what=f"{what} grad {p}")
    jgx = np.asarray(jgx)
    close(grads[-1], jgx, rtol=1e-4, atol=1e-5 * float(np.abs(jgx).max()), what=f"{what} grad x")


def test_bf16_mamba_matches():
    jcfg, tcfg = _cfgs("jamba_v01_52b", dtype=jnp.bfloat16)
    jp = jssm.init_mamba(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = xs((2, 8, jcfg.d_model), 7)
    jout, _, _ = jssm.mamba_train(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    tout, _, _ = tssm.mamba_train(tp, t(x).to(torch.bfloat16), tcfg)
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout).astype(np.float32)
    close(tout.float(), want, rtol=0, atol=2 * 2 ** -8 * float(np.abs(want).max()),
          what="bf16 mamba")


# ------------------------------------------------------------------ RWKV6


def test_rwkv6_time_and_channel_mix_match(rwkv):
    """From a carried (non-zero) wkv state and previous tokens: a 10-token
    slab, then one token carried on from the slab's states."""
    jcfg, tcfg, jp, tp = rwkv
    H, hs = tssm.rwkv_dims(tcfg)
    d = jcfg.d_model
    x = xs((2, 11, d), 8)
    s0 = 0.1 * xs((2, H, hs, hs), 9)
    prev = xs((2, 1, d), 10)
    jst, tst = (jnp.asarray(s0), jnp.asarray(prev)), (t(s0), t(prev))
    for sl in (slice(0, 10), slice(10, 11)):
        jo, js, jprev = jssm.rwkv6_time_mix(jp, jnp.asarray(x[:, sl]), jcfg, *jst)
        to, ts, tprev = tssm.rwkv6_time_mix(tp, t(x[:, sl]), tcfg, *tst)
        close(to, jo, what=f"time-mix out {sl}")
        close(ts, js, what=f"wkv state {sl}")
        close(tprev, jprev, rtol=0, atol=0, what="tm_prev")
        jst, tst = (js, jprev), (ts, tprev)
        jc, jcp = jssm.rwkv6_channel_mix(jp, jnp.asarray(x[:, sl]), jcfg, jnp.asarray(prev))
        tc, tcp = tssm.rwkv6_channel_mix(tp, t(x[:, sl]), tcfg, t(prev))
        close(tc, jc, what=f"channel-mix out {sl}")
        close(tcp, jcp, rtol=0, atol=0, what="cm_prev")
    st = tssm.rwkv6_init_state(tcfg, 3)
    jst0 = jssm.rwkv6_init_state(jcfg, 3)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in jst0.items()}
    assert st["s"].dtype == torch.float32 and st["tm_prev"].dtype == tcfg.dtype


def test_rwkv6_gradients_match(rwkv):
    jcfg, tcfg, jp, tp = rwkv
    H, hs = tssm.rwkv_dims(tcfg)
    x = xs((2, 6, jcfg.d_model), 11)
    w = xs((2, 6, jcfg.d_model), 12)
    s0 = 0.1 * xs((2, H, hs, hs), 13)
    prev = xs((2, 1, jcfg.d_model), 14)

    def jloss(p, xx):
        o, s, _ = jssm.rwkv6_time_mix(p, xx, jcfg, jnp.asarray(s0), jnp.asarray(prev))
        c, _ = jssm.rwkv6_channel_mix(p, xx, jcfg, jnp.asarray(prev))
        return jnp.sum((o + c) * w) + jnp.sum(s)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves, treedef = tree_flatten(tp)
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    tx = t(x).requires_grad_(True)
    p = treedef.unflatten(leaves)
    o, s, _ = tssm.rwkv6_time_mix(p, tx, tcfg, t(s0), t(prev))
    c, _ = tssm.rwkv6_channel_mix(p, tx, tcfg, t(prev))
    grads = torch.autograd.grad(torch.sum((o + c) * t(w)) + torch.sum(s), leaves + [tx],
                                allow_unused=True)
    _check_grads(jg, jgx, tp, grads, "rwkv6")


def test_bf16_rwkv6_matches():
    jcfg, tcfg = _cfgs("rwkv6_1p6b", dtype=jnp.bfloat16)
    jp = jssm.init_rwkv6(jax.random.PRNGKey(4), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = xs((2, 8, jcfg.d_model), 15)
    jst = jssm.rwkv6_init_state(jcfg, 2)
    tst = tssm.rwkv6_init_state(tcfg, 2)
    jout, _, _ = jssm.rwkv6_time_mix(jp, jnp.asarray(x, jnp.bfloat16), jcfg, jst["s"],
                                     jst["tm_prev"])
    tout, _, _ = tssm.rwkv6_time_mix(tp, t(x).to(torch.bfloat16), tcfg, tst["s"],
                                     tst["tm_prev"])
    assert tout.dtype == torch.bfloat16
    want = np.asarray(jout).astype(np.float32)
    close(tout.float(), want, rtol=0, atol=2 * 2 ** -8 * float(np.abs(want).max()),
          what="bf16 time-mix")


def test_softplus_is_logaddexp():
    """``jax.nn.softplus`` is ``logaddexp(x, 0)``; the port's (torch's
    ``logaddexp``) equals it on [−30, 30] to 2 f32 ulps."""
    x = np.linspace(-30, 30, 200_001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_array_max_ulp(n(tssm._softplus(t(x))), want, maxulp=2)
