"""State-space and linear-recurrence blocks (counterpart of
``repro.models.ssm``): Mamba (jamba) and RWKV6 (finch).

Both are exact sequential recurrences in an f32 state: each of the
reference's ``lax.scan``s is a loop over the sequence here.  Decode is one
step of the same recurrence carrying the state dict.

The reference's simplifications are kept: Mamba's discretisation is
Ā = exp(ΔA), B̄ = Δ·B; RWKV6's token-shift mixes are static per channel
except the decay ``w``, which keeps its data-dependent LoRA.

Mamba's causal depthwise convolution (the reference's
``conv_general_dilated`` with ``feature_group_count=di``) is written as
``width`` shifted multiply-adds in f32, as its decode step's window sum,
so no library convolution (and no TF32 or nondeterministic algorithm on
the card) is involved.  ``softplus`` is ``logaddexp(x, 0)``, as
``jax.nn.softplus``.

Inside a rank-sharded decode step (:func:`~repro_torch.models.hints.
cache_cut`) a state may hold this rank's share over the "model" ranks, as
``cache_specs`` cuts it: Mamba's ``h`` and ``conv`` their channels of
``di`` (the conv output is gathered whole for ``x_proj``, which contracts
over ``di``, and ``y`` before ``out_proj``); RWKV6's ``s`` its heads (the
heads' outputs are gathered before the output projection) and
``tm_prev``/``cm_prev`` their channels (gathered whole for the token
shift; the rank keeps its channels of the new ones).  The projections
run whole on every rank.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models import hints
from repro_torch.models.layers import dense, gen_device, init_dense

# ===================================================================== Mamba


def mamba_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return di, dt_rank, cfg.ssm_state


def init_mamba(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    di, dt_rank, N = mamba_dims(cfg)
    dt, dev = cfg.dtype, gen_device(gen)
    ar = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": init_dense(gen, d, 2 * di, dtype=dt),
        "conv_w": (torch.randn((cfg.ssm_conv, 1, di), generator=gen, dtype=torch.float32,
                               device=dev) * 0.2).to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": init_dense(gen, di, dt_rank + 2 * N, dtype=dt),
        "dt_proj": init_dense(gen, dt_rank, di, bias=True, dtype=dt),
        "A_log": torch.log(ar[None, :].repeat(di, 1)),
        "D": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": init_dense(gen, di, d, dtype=dt),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution.  x: (B, S, di), w: (width, 1, di):
    ``y[t] = Σ_j x[t − width + 1 + j] · w[j] + b`` in f32 (zeros before
    the sequence), cast back to ``x.dtype``."""
    width = w.shape[0]
    S = x.shape[1]
    xf = x.to(torch.float32)
    xpad = torch.cat([xf.new_zeros((x.shape[0], width - 1, x.shape[2])), xf], dim=1)
    wf = w.to(torch.float32)[:, 0, :]
    y = xpad[:, 0:S] * wf[0]
    for j in range(1, width):
        y = y + xpad[:, j:j + S] * wf[j]
    return (y + b.to(torch.float32)).to(x.dtype)


def mamba_ssm_params(params, x_in, cfg):
    """Shared projection math.  x_in: (..., di) post-conv activations.

    Returns (dt, Bs, Cs, A): dt (..., di), Bs/Cs (..., N), A (di, N)."""
    di, dt_rank, N = mamba_dims(cfg)
    proj = dense(params["x_proj"], x_in).to(torch.float32)
    dt_in, Bs, Cs = torch.split(proj, [dt_rank, N, N], dim=-1)
    dt = _softplus(dt_in @ params["dt_proj"]["w"].to(torch.float32)
                   + params["dt_proj"]["b"].to(torch.float32))
    A = -torch.exp(params["A_log"])  # (di, N), negative
    return dt, Bs, Cs, A


def _mamba_step(h, xt, dtt, Bt, Ct, A):
    """One recurrence step: (B, di, N) state, (B, di) input and Δ, (B, N)
    B and C → (new state, (B, di) output)."""
    a = torch.exp(dtt[..., None] * A[None])
    u = (dtt * xt)[..., None] * Bt[:, None, :]
    h = a * h + u
    return h, torch.einsum("bdn,bn->bd", h, Ct)


def mamba_train(params, x, cfg):
    """x: (B, S, d) → (out, final state (B, di, N), conv_tail (B, w−1, di)).

    ``conv_tail`` is the last w−1 PRE-conv activations (zeros in front when
    S < w − 1): the conv state a following decode step needs."""
    B, S, d = x.shape
    di, dt_rank, N = mamba_dims(cfg)
    x_raw, z = torch.chunk(dense(params["in_proj"], x), 2, dim=-1)
    w = cfg.ssm_conv
    if S >= w - 1:
        conv_tail = x_raw[:, S - (w - 1):, :].to(torch.float32)
    else:
        conv_tail = torch.cat([x_raw.new_zeros((B, w - 1 - S, di), dtype=torch.float32),
                               x_raw.to(torch.float32)], dim=1)
    x_in = _silu(_causal_conv(x_raw, params["conv_w"], params["conv_b"]).to(torch.float32))
    dt, Bs, Cs, A = mamba_ssm_params(params, x_in.to(x.dtype), cfg)
    h = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in hints.steps(S):
        h, y = _mamba_step(h, x_in[:, t], dt[:, t], Bs[:, t], Cs[:, t], A)
        ys.append(y)
    y = torch.stack(hints.every_step(ys, S, h), dim=1) + x_in * params["D"][None, None, :]
    y = y * _silu(z.to(torch.float32))
    out = dense(params["out_proj"], y.to(x.dtype))
    return out, h, conv_tail


def mamba_init_state(cfg, batch: int, device=None) -> dict:
    di, _, N = mamba_dims(cfg)
    return {
        "h": torch.zeros((batch, di, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, di), dtype=torch.float32, device=device),
    }


def mamba_decode(params, x, cfg, state):
    """x: (B, 1, d) one token.  state: {'h': (B, di, N), 'conv': (B, w−1, di)},
    or this rank's channels of ``di`` of both (the module's docstring)."""
    cut = hints.cache_cut()
    own = state["h"].shape[1] < mamba_dims(cfg)[0]  # this rank's channels of di

    def part(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return cut.part(t, dim) if own else t

    x_in, z = torch.chunk(dense(params["in_proj"], x), 2, dim=-1)  # (B, 1, di)
    # the causal conv over the carried window
    win = torch.cat([state["conv"], part(x_in).to(torch.float32)], dim=1)  # (B, w, di)
    w = part(params["conv_w"].to(torch.float32))  # (w, 1, di)
    y = torch.sum(win * w[:, 0, :][None], dim=1) + part(params["conv_b"].to(torch.float32))
    x_c = _silu(y)[:, None, :]  # (B, 1, di)
    dt, Bs, Cs, A = mamba_ssm_params(params, (cut.gather(x_c, -1) if own else x_c).to(x.dtype),
                                     cfg)
    xc0 = x_c[:, 0].to(torch.float32)
    h, yt = _mamba_step(state["h"], xc0, part(dt[:, 0]), Bs[:, 0], Cs[:, 0], part(A, 0))
    yt = yt + xc0 * part(params["D"])[None]
    yt = yt * _silu(part(z[:, 0]).to(torch.float32))
    if own:
        yt = cut.gather(yt, -1)
    out = dense(params["out_proj"], yt[:, None, :].to(x.dtype))
    return out, {"h": h, "conv": win[:, 1:]}


# ===================================================================== RWKV6

RWKV_HEAD = 64  # Finch head size


def rwkv_dims(cfg):
    H = cfg.d_model // RWKV_HEAD
    return H, RWKV_HEAD


def init_rwkv6(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    H, hs = rwkv_dims(cfg)
    dt, dev = cfg.dtype, gen_device(gen)
    lora = 64

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=dev)

    return {
        # time-mix
        "mix": full((4, d), 0.5),  # static shift mixes r, k, v, g
        "mix_w": full((d,), 0.5),
        "wr": init_dense(gen, d, d, dtype=dt),
        "wk": init_dense(gen, d, d, dtype=dt),
        "wv": init_dense(gen, d, d, dtype=dt),
        "wg": init_dense(gen, d, d, dtype=dt),
        "w0": _linspace(-6.0, -1.0, d, dev),  # base decay logits
        "w_lora_a": init_dense(gen, d, lora, dtype=dt),
        "w_lora_b": init_dense(gen, lora, d, dtype=dt),
        "bonus": full((H, hs), 0.0),  # u
        "ln_x": full((d,), 1.0),  # per-head group-norm scale
        "wo": init_dense(gen, d, d, dtype=dt),
        # channel-mix
        "cmix_k": full((d,), 0.5),
        "cmix_r": full((d,), 0.5),
        "ck": init_dense(gen, d, cfg.d_ff, dtype=dt),
        "cv": init_dense(gen, cfg.d_ff, d, dtype=dt),
        "cr": init_dense(gen, d, d, dtype=dt),
    }


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 by its own formula,
    ``start·(1 − s) + stop·s`` with ``s = i · (1/(num − 1))`` (XLA turns
    the division by the constant into that product) and the endpoint
    appended: within one ulp of the reference's at d = 256 and 2,048,
    where ``torch.linspace`` is up to 4 ulps off."""
    div = num - 1
    step = torch.arange(div, dtype=torch.float32, device=device) * float(
        np.float32(1) / np.float32(div))
    out = (torch.full_like(step, start) * (1 - step) + torch.full_like(step, stop) * step)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t−1}, with ``prev`` (B, 1, d) before t = 0."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, xprev: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    m = m[None, None].to(torch.float32)
    return (x.to(torch.float32) * m + xprev.to(torch.float32) * (1 - m)).to(x.dtype)


def _rwkv_projections(params, x, xprev, cfg):
    """r, k, v, g, w of a (B, S, d) slab given its shifted predecessors."""
    mix = params["mix"]
    r = dense(params["wr"], _lerp(x, xprev, mix[0]))
    k = dense(params["wk"], _lerp(x, xprev, mix[1]))
    v = dense(params["wv"], _lerp(x, xprev, mix[2]))
    g = dense(params["wg"], _lerp(x, xprev, mix[3]))
    xw = _lerp(x, xprev, params["mix_w"])
    # the data-dependent decay (the Finch contribution): w = exp(−exp(w0 + lora))
    lora = dense(params["w_lora_b"],
                 torch.tanh(dense(params["w_lora_a"], xw).to(torch.float32)).to(x.dtype))
    wlog = params["w0"][None, None] + lora.to(torch.float32)
    w = torch.exp(-torch.exp(wlog))  # (B, S, d) in (0, 1)
    return r, k, v, g, w


def _heads(x, H, hs):
    return x.reshape(x.shape[:-1] + (H, hs))


def _shared_prev(prev_tok: torch.Tensor, d: int) -> tuple:
    """``(the whole (B, 1, d) predecessor, whether this rank holds its
    channels alone)``: a cut ``tm_prev``/``cm_prev`` gathered whole."""
    own = prev_tok.shape[-1] < d
    return (hints.cache_cut().gather(prev_tok, -1) if own else prev_tok), own


def rwkv6_time_mix(params, x, cfg, state_s, prev_tok):
    """x: (B, S, d); state_s: (B, H, hs, hs) wkv state; prev_tok: (B, 1, d),
    or this rank's heads and channels of them (the module's docstring).

    Returns (out, new state_s, new prev_tok)."""
    B, S, d = x.shape
    H, hs = rwkv_dims(cfg)
    cut = hints.cache_cut()
    prev_tok, own_prev = _shared_prev(prev_tok, d)
    r, k, v, g, w = _rwkv_projections(params, x, _shift(x, prev_tok), cfg)
    heads = state_s.shape[1]
    own = heads < H  # this rank's heads, and their channels

    def part(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return cut.part(t, dim) if own else t

    rh = _heads(part(r).to(torch.float32), heads, hs)
    kh = _heads(part(k).to(torch.float32), heads, hs)
    vh = _heads(part(v).to(torch.float32), heads, hs)
    wh = _heads(part(w), heads, hs)
    u = part(params["bonus"], 0)[None]  # (1, H, hs)
    s = state_s
    os = []
    for t in hints.steps(S):
        rt, kt, vt, wt = rh[:, t], kh[:, t], vh[:, t], wh[:, t]  # (B, H, hs) each
        # o_j = Σ_i r_i s_ij + (Σ_i r_i u_i k_i) v_j
        o = (torch.einsum("bhi,bhij->bhj", rt, s)
             + torch.einsum("bhi,bhi->bh", rt, u * kt)[..., None] * vt)
        s = wt[..., None] * s + kt[..., None] * vt[..., None, :]
        os.append(o)
    oh = torch.stack(hints.every_step(os, S, s), dim=1)  # (B, S, H, hs) f32
    # per-head group norm, then the gate
    oh = oh * torch.rsqrt(torch.mean(torch.square(oh), dim=-1, keepdim=True) + 1e-6)
    o = oh.reshape(B, S, heads * hs) * part(params["ln_x"])[None, None]
    o = o * _silu(part(g).to(torch.float32))
    if own:
        o = cut.gather(o, -1)
    out = dense(params["wo"], o.to(x.dtype))
    last = x[:, -1:, :]
    return out, s, (cut.part(last, -1) if own_prev else last)


def rwkv6_channel_mix(params, x, cfg, prev_tok):
    """The RWKV FFN with token shift.  Returns (out, new prev_tok); a cut
    ``prev_tok`` (this rank's channels) is gathered whole, and the rank
    keeps its channels of the new one."""
    prev_tok, own_prev = _shared_prev(prev_tok, x.shape[-1])
    xprev = _shift(x, prev_tok)
    xk = _lerp(x, xprev, params["cmix_k"])
    xr = _lerp(x, xprev, params["cmix_r"])
    k = dense(params["ck"], xk).to(torch.float32)
    k = torch.square(torch.relu(k)).to(x.dtype)
    r = torch.sigmoid(dense(params["cr"], xr).to(torch.float32))
    out = r * dense(params["cv"], k).to(torch.float32)
    last = x[:, -1:, :]
    return out.to(x.dtype), (hints.cache_cut().part(last, -1) if own_prev else last)


def rwkv6_init_state(cfg, batch: int, device=None) -> dict:
    H, hs = rwkv_dims(cfg)
    return {
        "s": torch.zeros((batch, H, hs, hs), dtype=torch.float32, device=device),
        "tm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.dtype, device=device),
        "cm_prev": torch.zeros((batch, 1, cfg.d_model), dtype=cfg.dtype, device=device),
    }
