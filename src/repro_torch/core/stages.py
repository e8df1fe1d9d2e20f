"""Codec stages: Selector → Quantizer → Encoder (DESIGN.md §2).

Counterpart of ``repro.core.stages``.  A compression method for one
tensor is three choices:

  *which* entries survive            → :class:`Selector`
  *how* surviving values are coded   → :class:`Quantizer`
  *how* surviving positions are coded→ :class:`Encoder`

SBC (Alg. 2) is ``topk_signed → binarize → golomb``.  Every stage of the
reference is registered here under the same name, with the same fields
and the same analytic bit model, so a codec spec means the same thing in
both packages and SBW1 blobs cross between them.

Stages work on flat f32 tensors on any device; nothing waits for the
device.  What the port keeps equal to the reference:

  * **Order of ties.** Every top-k goes through
    :func:`repro_torch.kernels.topk._top_k`, which returns
    ``lax.top_k``'s order (total order on floats, lower index first);
    ``torch.topk`` does not.
  * **Scalars on the wire.** ``jnp.mean``/``jnp.sum``/``jnp.linalg.norm``
    of f32 values are taken in XLA's f32 order through
    :func:`repro_torch.kernels.reduce.f32_mean_xla` (one launch of its
    CUDA kernel on the card), so μ, the sign scale, the two means, the
    variance selector's block RMS and the QSGD norm are the reference's
    bit for bit.
  * **Randomness.** ``randomk``, ``ternary`` and ``stochastic`` draw from
    the ``torch.Generator`` they are given (on the tensor's device),
    never from the global generator.  Torch cannot reproduce JAX's
    threefry bits, so only their structure and statistics match.

The shared intermediate representation is :class:`LeafCompressed`, one
per flattened tensor, decompressed by the one generic rule of
:func:`decompress_leaf`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.golomb import expected_position_bits
from repro_torch.kernels.reduce import f32_mean_xla
from repro_torch.kernels.topk import _top_k, _two_sided_topk


class LeafCompressed(NamedTuple):
    """Compressed form of ONE flattened tensor (the stage IR).

    Exactly one value encoding is live per codec; the others are
    zero-size tensors.

    idx:  int32[k]   positions of surviving entries (empty for dense/skip)
    vals: f32[k] | f32[0]   per-entry values (identity-quantized codecs)
    mean: f32[]      per-tensor scalar (SBC ±μ, sign/ternary/qsgd scale)
    dense: f32[n] | f32[0]  dense payload (dense-selector codecs)
    nbits: f32[]     analytic wire size of this leaf for this round (Eq. 1)
    """

    idx: torch.Tensor
    vals: torch.Tensor
    mean: torch.Tensor
    dense: torch.Tensor
    nbits: torch.Tensor


class Selection(NamedTuple):
    """Selector output: surviving positions and their raw values.

    Dense selectors return ``idx`` empty and ``vals`` of length n (the
    position stream costs 0 bits and the encoder is bypassed).
    """

    idx: torch.Tensor  # int32[k] (int32[0] when dense or skip)
    vals: torch.Tensor  # f32[k]  (f32[n] when dense, f32[0] when skip)


def k_for(n: int, p: float) -> int:
    """Number of surviving entries at sparsity rate p (at least 1)."""
    return max(1, min(n, int(round(p * n))))


def _empty(dtype, device) -> torch.Tensor:
    return torch.zeros((0,), dtype=dtype, device=device)


def _gather(flat: torch.Tensor, idx: torch.Tensor) -> Selection:
    """``Selection(idx int32, flat[idx])`` from int64 positions."""
    return Selection(idx=idx.to(torch.int32), vals=flat[idx])


# ------------------------------------------------------------------ selectors


@dataclasses.dataclass(frozen=True)
class Selector:
    """Picks which coordinates of a flat f32[n] tensor survive.

    fn(flat, p, rng) -> Selection with a k that depends on (n, p) only;
    ``rng`` is a ``torch.Generator`` on ``flat``'s device, or None.
    ``dense``: every coordinate survives (positions are free).
    ``skip``:  nothing survives, nothing is transmitted.
    """

    name: str
    fn: Callable[[torch.Tensor, float, Optional[torch.Generator]], Selection]
    dense: bool = False
    skip: bool = False
    stochastic: bool = False
    # stage is expressible in the flat-buffer fast path (DESIGN.md §10)
    flat_fast: bool = False

    def __call__(self, flat: torch.Tensor, p: float, rng) -> Selection:
        return self.fn(flat, p, rng)


_SELECTORS: Dict[str, Callable[..., Selector]] = {}


def register_selector(name: str):
    def deco(factory):
        _SELECTORS[name] = factory
        return factory

    return deco


def get_selector(name: str, **kw) -> Selector:
    if name not in _SELECTORS:
        raise KeyError(f"unknown selector {name!r}; have {sorted(_SELECTORS)}")
    return _SELECTORS[name](**kw)


@register_selector("dense")
def make_dense_selector(**_) -> Selector:
    def fn(flat, p, rng):
        return Selection(idx=_empty(torch.int32, flat.device), vals=flat)

    return Selector("dense", fn, dense=True, flat_fast=True)


@register_selector("skip")
def make_skip_selector(**_) -> Selector:
    def fn(flat, p, rng):
        return Selection(idx=_empty(torch.int32, flat.device),
                         vals=_empty(torch.float32, flat.device))

    return Selector("skip", fn, skip=True, flat_fast=True)


@register_selector("topk")
def make_topk_selector(**_) -> Selector:
    """Magnitude top-k (Gradient Dropping / DGC selection)."""

    def fn(flat, p, rng):
        _, idx = _top_k(torch.abs(flat), k_for(flat.shape[0], p))
        return _gather(flat, idx)

    return Selector("topk", fn)


@register_selector("topk_signed")
def make_topk_signed_selector(**_) -> Selector:
    """SBC's one-sided selection (Alg. 2 l.1-5): top-k of ΔW and of −ΔW,
    keep whichever side has the larger mean magnitude (means in XLA's f32
    order, so the side is the reference's).  With ``binarize`` this is
    exactly Sparse Binary Compression."""

    def fn(flat, p, rng):
        idx, _ = _two_sided_topk(flat[None], k_for(flat.shape[0], p))
        return _gather(flat, idx[0])

    return Selector("topk_signed", fn, flat_fast=True)


@register_selector("threshold")
def make_threshold_selector(tau: float = 0.0, **_) -> Selector:
    """Fixed-threshold selection (Strom '15 family): k slots, but entries
    with |ΔW| < τ transmit an explicit zero.  With τ = 0 this is plain
    top-k."""

    def fn(flat, p, rng):
        _, idx = _top_k(torch.abs(flat), k_for(flat.shape[0], p))
        vals = flat[idx]
        vals = torch.where(torch.abs(vals) >= tau, vals, torch.zeros_like(vals))
        return Selection(idx=idx.to(torch.int32), vals=vals)

    return Selector("threshold", fn)


@register_selector("randomk")
def make_randomk_selector(**_) -> Selector:
    """Random-k mask (sketched updates, Konečný et al. '16): k distinct
    positions drawn from ``rng``."""

    def fn(flat, p, rng):
        n = flat.shape[0]
        idx = torch.randperm(n, generator=rng, device=flat.device)[:k_for(n, p)]
        return _gather(flat, idx)

    return Selector("randomk", fn, stochastic=True)


@register_selector("variance")
def make_variance_selector(block: int = 256, **_) -> Selector:
    """Approximated variance-based selection (Tsuzuku et al. '18): each
    entry's score is |ΔW| over the RMS of its ``block``-sized neighbourhood
    (block means in XLA's f32 order), then the top-k scores survive."""

    def fn(flat, p, rng):
        n = flat.shape[0]
        b = min(block, n)
        nb = -(-n // b)
        x = torch.nn.functional.pad(flat, (0, nb * b - n)).reshape(nb, b)
        rms = torch.sqrt(f32_mean_xla(x * x)[:, None] + 1e-24)
        score = (torch.abs(x) / rms).reshape(-1)[:n]
        _, idx = _top_k(score, k_for(n, p))
        return _gather(flat, idx)

    return Selector("variance", fn)


@register_selector("expert_topk")
def make_expert_topk_selector(experts: int = 8, **_) -> Selector:
    """Per-expert balanced top-k for MoE leaves shaped ``(E, …)``.

    Candidates rank in three tiers: (1) each expert's local top-⌈k/E⌉,
    (2) the other non-zero coordinates of routed experts, (3) exact zeros
    (unrouted experts); the global top-k is taken in tier order, so every
    routed expert keeps its quota and exactly ``k_for(n, p)`` survive.
    Leaves whose length is not divisible by ``experts`` take plain top-k.
    """

    def fn(flat, p, rng):
        n = flat.shape[0]
        k = k_for(n, p)
        e = experts if (experts > 1 and n % experts == 0) else 1
        if e == 1:
            _, idx = _top_k(torch.abs(flat), k)
            return _gather(flat, idx)
        n_loc = n // e
        q = min(n_loc, k)  # candidates per expert (enough to redistribute)
        quota = -(-k // e)
        bscore, bidx = _top_k(torch.abs(flat).reshape(e, n_loc), q)
        # tiered score bands, non-overlapping since span > max score
        span = torch.amax(bscore) + 1.0
        nz = bscore > 0.0
        in_quota = (torch.arange(q, device=flat.device) < quota)[None, :]
        adj = (bscore + 2.0 * span * (nz & in_quota).to(torch.float32)
               + span * (nz & ~in_quota).to(torch.float32))
        base = torch.arange(e, device=flat.device)[:, None] * n_loc
        cand = (bidx + base).reshape(-1)
        _, sel = _top_k(adj.reshape(-1), k)  # e·q ≥ k always
        return _gather(flat, cand[sel])

    return Selector("expert_topk", fn)


# ----------------------------------------------------------------- quantizers


@dataclasses.dataclass(frozen=True)
class Quantizer:
    """Codes the surviving values.

    fn(selection, rng) -> (vals_q, scalar):
      vals_q: f32 tensor shaped like selection.vals, or f32[0] when the
              quantizer collapses all values into the per-tensor scalar;
      scalar: f32[] per-tensor constant (μ, scale, norm; 0 when unused).

    value_bits(k) -> analytic wire bits for k surviving values, including
    any per-tensor scalar overhead.
    """

    name: str
    fn: Callable[[Selection, Optional[torch.Generator]], tuple]
    value_bits: Callable[[int], float]
    stochastic: bool = False
    levels: int = 0  # quantization-level count (wire code width); 0 = n/a
    flat_fast: bool = False  # expressible in the flat fast path (§10)

    def __call__(self, sel: Selection, rng) -> tuple:
        return self.fn(sel, rng)


_QUANTIZERS: Dict[str, Callable[..., Quantizer]] = {}


def register_quantizer(name: str):
    def deco(factory):
        _QUANTIZERS[name] = factory
        return factory

    return deco


def get_quantizer(name: str, **kw) -> Quantizer:
    if name not in _QUANTIZERS:
        raise KeyError(f"unknown quantizer {name!r}; have {sorted(_QUANTIZERS)}")
    return _QUANTIZERS[name](**kw)


def _zero(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=device)


def _mean(v: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(v)`` of a 1-D f32 tensor, bit for bit (0-d)."""
    return f32_mean_xla(v[None])[0]


@register_quantizer("identity")
def make_identity_quantizer(**_) -> Quantizer:
    """Values pass through at full 32-bit precision."""

    def fn(sel, rng):
        return sel.vals.to(torch.float32), _zero(sel.vals.device)

    return Quantizer("identity", fn, value_bits=lambda k: 32.0 * k, flat_fast=True)


@register_quantizer("binarize")
def make_binarize_quantizer(**_) -> Quantizer:
    """±μ binarization (SBC Alg. 2 l.4-6): every surviving value collapses
    to their signed mean, in XLA's f32 order over the values in selection
    order: 0 value bits per entry, one 32-bit scalar."""

    def fn(sel, rng):
        return _empty(torch.float32, sel.vals.device), _mean(sel.vals)

    return Quantizer("binarize", fn, value_bits=lambda k: 32.0, flat_fast=True)


@register_quantizer("sign")
def make_sign_quantizer(**_) -> Quantizer:
    """Scaled sign (signSGD/SIGNUM): 1 bit per entry + one 32-bit scale,
    mean(|Δ|).  Exact zeros quantize to +scale (a 1-bit symbol has no
    zero)."""

    def fn(sel, rng):
        v = sel.vals
        scale = _mean(torch.abs(v))
        return torch.where(v >= 0, scale, -scale), scale

    return Quantizer("sign", fn, value_bits=lambda k: 1.0 * k + 32.0)


@register_quantizer("two_means")
def make_two_means_quantizer(**_) -> Quantizer:
    """1-bit SGD (Seide et al. '14): per-tensor μ⁺/μ⁻ column means,
    1 bit per entry + two 32-bit scalars."""

    def fn(sel, rng):
        v = sel.vals
        pos = v >= 0
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        npos = pos.sum()
        nneg = torch.clamp(v.shape[0] - npos, min=1).to(torch.float32)
        npos = torch.clamp(npos, min=1).to(torch.float32)
        sums = f32_mean_xla(torch.stack([torch.where(pos, v, zero),
                                         torch.where(pos, zero, v)]), sum_only=True)
        mu_pos = sums[0] / npos
        mu_neg = sums[1] / nneg  # negative number
        return torch.where(pos, mu_pos, mu_neg), mu_pos

    return Quantizer("two_means", fn, value_bits=lambda k: 1.0 * k + 64.0)


@register_quantizer("ternary")
def make_ternary_quantizer(**_) -> Quantizer:
    """TernGrad (Wen et al. '17): stochastic ternary {−s, 0, +s} with
    s = max|v| + 1e-12; an entry survives with probability |v|/s."""

    def fn(sel, rng):
        v = sel.vals
        s = torch.amax(torch.abs(v)) + 1e-12
        u = torch.rand(v.shape, generator=rng, device=v.device, dtype=torch.float32)
        keep = (u < torch.abs(v) / s).to(torch.float32)
        return s * torch.sign(v) * keep, s

    return Quantizer(
        "ternary", fn, value_bits=lambda k: math.log2(3.0) * k + 32.0, stochastic=True
    )


@register_quantizer("stochastic")
def make_stochastic_quantizer(levels: int = 15, **_) -> Quantizer:
    """QSGD (Alistarh et al. '17): stochastic uniform quantization on the
    L2 ball with ``levels`` levels; the norm (XLA's f32 sum of squares,
    then sqrt, + 1e-12) rides in the scalar."""

    def fn(sel, rng):
        v = sel.vals
        norm = torch.sqrt(f32_mean_xla((v * v)[None], sum_only=True)[0]) + 1e-12
        scaled = torch.abs(v) / norm * levels
        floor = torch.floor(scaled)
        u = torch.rand(v.shape, generator=rng, device=v.device, dtype=torch.float32)
        quant = floor + (u < scaled - floor).to(torch.float32)
        return norm * torch.sign(v) * quant / levels, norm

    bits_per = math.log2(2.0 * levels + 1.0)
    return Quantizer(
        "stochastic", fn, value_bits=lambda k: bits_per * k + 32.0,
        stochastic=True, levels=levels,
    )


# ------------------------------------------------------------------- encoders


@dataclasses.dataclass(frozen=True)
class Encoder:
    """Position stream coding.  Only the analytic model lives here; the
    byte serialization is in :mod:`repro_torch.core.wire`, keyed by
    ``name``.  position_bits(n, k, p) -> analytic wire bits."""

    name: str
    position_bits: Callable[[int, int, float], float]
    flat_fast: bool = False  # expressible in the flat fast path (§10)


_ENCODERS: Dict[str, Callable[..., Encoder]] = {}


def register_encoder(name: str):
    def deco(factory):
        _ENCODERS[name] = factory
        return factory

    return deco


def get_encoder(name: str, **kw) -> Encoder:
    if name not in _ENCODERS:
        raise KeyError(f"unknown encoder {name!r}; have {sorted(_ENCODERS)}")
    return _ENCODERS[name](**kw)


@register_encoder("none")
def make_none_encoder(**_) -> Encoder:
    """Dense / skip codecs: positions are predetermined, 0 bits."""
    return Encoder("none", lambda n, k, p: 0.0, flat_fast=True)


@register_encoder("golomb")
def make_golomb_encoder(**_) -> Encoder:
    """Optimal Golomb position coding (paper Alg. 3, Eq. 5)."""
    return Encoder(
        "golomb", lambda n, k, p: k * expected_position_bits(min(p, 1.0)),
        flat_fast=True,
    )


@register_encoder("bitmask")
def make_bitmask_encoder(**_) -> Encoder:
    """One bit per coordinate; beats Golomb only when p ≳ 0.3."""
    return Encoder("bitmask", lambda n, k, p: 1.0 * n)


@register_encoder("raw16")
def make_raw16_encoder(**_) -> Encoder:
    """The paper's naive fixed-width 16-bit positions (Table I baselines)."""
    return Encoder("raw16", lambda n, k, p: 16.0 * k)


@register_encoder("raw32")
def make_raw32_encoder(**_) -> Encoder:
    return Encoder("raw32", lambda n, k, p: 32.0 * k)


@register_encoder("seed")
def make_seed_encoder(**_) -> Encoder:
    """Random-k positions derivable from a shared 32-bit seed: one scalar
    whatever k is.  The packed wire (:mod:`repro_torch.core.wire`) still
    ships explicit raw32 indices; the analytic model is the shared-seed
    exchange."""
    return Encoder("seed", lambda n, k, p: 32.0)


# ---------------------------------------------------------------- decompress


def decompress_leaf(comp: LeafCompressed, n: int) -> torch.Tensor:
    """Generic, codec-independent reconstruction of one flat tensor:
    the dense payload if there is one, else the values scattered at
    ``idx``, else the per-tensor scalar at ``idx`` (a skip leaf has no
    positions: zeros)."""
    if comp.dense.shape[0]:
        return comp.dense
    device = comp.idx.device
    out = torch.zeros((n,), dtype=torch.float32, device=device)
    idx = comp.idx.to(torch.int64)
    if comp.vals.shape[0]:
        return out.index_put_((idx,), comp.vals.to(torch.float32))
    return out.index_fill_(0, idx, comp.mean.to(device=device, dtype=torch.float32))


def available_stages() -> dict:
    return {
        "selectors": sorted(_SELECTORS),
        "quantizers": sorted(_QUANTIZERS),
        "encoders": sorted(_ENCODERS),
    }
