"""Baseline compressors the paper compares against (Table I / Table II),
as stage compositions.

Counterpart of ``repro.core.baselines``; every name, codec and bit model
is the reference's:

  none        dense|identity|none     32-bit DSGD (the x1 baseline)
  fedavg      dense|identity|none     dense, no residual (the delay does
                                      the saving: temporal sparsity)
  topk        topk|identity|raw16     Gradient Dropping [Aji & Heafield '17]
  dgc         topk|identity|raw16     DGC [Lin et al. '18]: topk on the
                                      wire; the DGC extras (dense biases
                                      and norms, the warm-up schedule)
                                      live in :func:`dgc_policy`
  signsgd     dense|sign|none         signSGD [Bernstein et al. '18], no
                                      residual
  onebit      dense|two_means|none    1-bit SGD [Seide et al. '14]
  terngrad    dense|ternary|none      TernGrad [Wen et al. '17]
  qsgd        dense|stochastic|none   QSGD [Alistarh et al. '17]
  randomk     randomk|identity|seed   sketched updates [Konečný et al. '16]
  variance    variance|identity|golomb  Tsuzuku et al. '18's selection

The stages are :mod:`repro_torch.core.stages`'; the byte serialization
of every composition is :mod:`repro_torch.core.wire`'s.
"""
from __future__ import annotations

from repro_torch.core import api
from repro_torch.core.codec import Codec, register_codec
from repro_torch.core.policy import CompressionPolicy, PolicyRule
from repro_torch.core.sparsity import dgc_warmup
from repro_torch.core.stages import get_encoder, get_quantizer, get_selector

NAIVE_POS_BITS = 16.0  # the paper's naive fixed-width position encoding


def _codec(sel: str, quant: str, enc: str, *, use_residual: bool = True,
           **kw) -> Codec:
    return Codec(
        selector=get_selector(sel, **kw),
        quantizer=get_quantizer(quant, **kw),
        encoder=get_encoder(enc, **kw),
        use_residual=use_residual,
    )


# ------------------------------------------------------------------- dense


@register_codec("dense")
def make_dense_codec(**_) -> Codec:
    # with error feedback a dense round sends ΔW plus any pending residual
    # in full and leaves R = 0: plain DSGD alone, and the flush of a hybrid
    # sparsity schedule
    return _codec("dense", "identity", "none", use_residual=True)


@api.register("none")
def make_none(**_) -> api.Compressor:
    return api.Compressor.from_codec("none", make_dense_codec())


@api.register("fedavg")
def make_fedavg(**_) -> api.Compressor:
    # Federated Averaging is dense; its saving is the delay (temporal
    # sparsity), which the trainer applies
    return api.Compressor.from_codec(
        "fedavg", _codec("dense", "identity", "none", use_residual=False)
    )


# ---------------------------------------------------- top-k (Grad Dropping)


@register_codec("topk")
def make_topk_codec(**_) -> Codec:
    return _codec("topk", "identity", "raw16")


@api.register("topk")
def make_topk(**_) -> api.Compressor:
    return api.Compressor.from_codec("topk", make_topk_codec())


@api.register("dgc")
def make_dgc(**_) -> api.Compressor:
    return api.Compressor.from_codec("dgc", make_topk_codec())


def dgc_policy(
    target_sparsity: float = 0.001,
    warmup_rounds: int = 4,
    dense_pattern: str = r"(^|/)(bias|b|scale|norm|ln[^/]*|gamma|beta)$",
) -> CompressionPolicy:
    """The full DGC recipe as a per-leaf policy (Lin et al. '18 §3):
    biases and norm parameters ride dense, the other leaves take top-k
    with the exponential sparsity warm-up."""
    warm = dgc_warmup(target_sparsity=target_sparsity,
                      warmup_rounds=warmup_rounds)
    return CompressionPolicy(
        default=make_topk_codec(),
        rules=(
            PolicyRule(dense_pattern, codec="dense32"),
            PolicyRule(r".", schedule=lambda r: warm.sparsity(r)),
        ),
        name="dgc",
    )


@api.register("dgc_policy")
def make_dgc_policy(**kw) -> api.Compressor:
    return api.Compressor.from_policy("dgc_policy", dgc_policy(**kw))


# ----------------------------------------------------------------- signSGD


@register_codec("signsgd")
def make_signsgd_codec(**_) -> Codec:
    return _codec("dense", "sign", "none", use_residual=False)


@api.register("signsgd")
def make_signsgd(**_) -> api.Compressor:
    return api.Compressor.from_codec("signsgd", make_signsgd_codec())


# ----------------------------------------------------------------- 1-bit SGD


@register_codec("onebit")
def make_onebit_codec(**_) -> Codec:
    return _codec("dense", "two_means", "none", use_residual=True)


@api.register("onebit")
def make_onebit(**_) -> api.Compressor:
    return api.Compressor.from_codec("onebit", make_onebit_codec())


# ----------------------------------------------------------------- TernGrad


@register_codec("terngrad")
def make_terngrad_codec(**_) -> Codec:
    return _codec("dense", "ternary", "none", use_residual=False)


@api.register("terngrad")
def make_terngrad(**_) -> api.Compressor:
    return api.Compressor.from_codec("terngrad", make_terngrad_codec())


# --------------------------------------------------------------------- QSGD


@register_codec("qsgd")
def make_qsgd_codec(levels: int = 15, **_) -> Codec:
    return _codec("dense", "stochastic", "none", use_residual=False,
                  levels=levels)


@api.register("qsgd")
def make_qsgd(levels: int = 15, **_) -> api.Compressor:
    return api.Compressor.from_codec("qsgd", make_qsgd_codec(levels=levels))


# ------------------------------------------------------------------ randomk


@register_codec("randomk")
def make_randomk_codec(**_) -> Codec:
    # positions follow from a shared 32-bit seed, so the analytic model
    # meters the values only (the stages' 'seed' encoder)
    return _codec("randomk", "identity", "seed")


@api.register("randomk")
def make_randomk(**_) -> api.Compressor:
    return api.Compressor.from_codec("randomk", make_randomk_codec())


# ------------------------------------------- variance selection (Tsuzuku '18)


@register_codec("variance")
def make_variance_codec(**kw) -> Codec:
    # the approximated variance criterion over the accumulated update,
    # full 32-bit values, optimal Golomb positions
    return _codec("variance", "identity", "golomb", **kw)


@api.register("variance")
def make_variance(**kw) -> api.Compressor:
    return api.Compressor.from_codec("variance", make_variance_codec(**kw))
