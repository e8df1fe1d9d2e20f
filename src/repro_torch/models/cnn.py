"""CNN classifiers: the paper's LeNet5-Caffe (MNIST) and its ResNet-32
(CIFAR-10; He et al. '16: 3 stages x 5 basic blocks, widths 16/32/64).

Counterpart of ``repro.models.cnn``.  Parameters keep the reference's
layouts — conv kernels HWIO, dense layers ``(in, out)``, images NHWC — so
parameters cross between the packages as they are.  The forward passes
permute the images to NCHW once for ``F.conv2d``; LeNet5 permutes back to
NHWC before its flatten, so the rows of ``f1`` meet the features they
were trained on.

:func:`conv` pads as XLA's ``SAME`` does: ``total = max((⌈H/s⌉ − 1)·s + k
− H, 0)``, ``total // 2`` before and the rest after.  At stride 2 that is
asymmetric (a 3 x 3 kernel on a 32-wide map pads 0 before and 1 after),
which ``F.conv2d``'s symmetric ``padding`` cannot express, so such a
convolution pads with ``F.pad`` first.  :func:`batchnorm` normalizes
with the batch's own statistics, train and eval alike, as the reference
does (no running statistics): the mean and the population variance
(``jnp.var``) over N, H and W.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """He-normal HWIO kernel."""
    return _normal(gen, (kh, kw, cin, cout), math.sqrt(2.0 / (kh * kw * cin)))


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's SAME padding ``(before, after)`` of one spatial dimension."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(w_hwio: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """NCHW ``x`` with an HWIO kernel at ``stride``, XLA's SAME padding."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    (top, bottom), (left, right) = (_same_pads(x.shape[2], kh, stride),
                                    _same_pads(x.shape[3], kw, stride))
    w = w_hwio.permute(3, 2, 0, 1)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def batchnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """NCHW ``x`` normalized with its batch statistics over (N, H, W), then
    ``p["scale"]`` and ``p["bias"]`` per channel."""
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, correction=0)
    return ((x - mu) * torch.rsqrt(var + eps) * p["scale"][None, :, None, None]
            + p["bias"][None, :, None, None])


def _bn_init(c: int) -> dict:
    return {"scale": torch.ones((c,), dtype=torch.float32),
            "bias": torch.zeros((c,), dtype=torch.float32)}


# ------------------------------------------------------------------- LeNet5


def init_lenet5(gen: torch.Generator, cfg) -> dict:
    """He-normal LeNet5 parameters drawn from ``gen`` (on the CPU).

    Same shapes and scales as the reference; the numbers differ (torch
    cannot reproduce JAX's threefry), so parity tests carry parameters
    across with :mod:`repro_torch.convert`.
    """
    n_feat = (cfg.img_size // 4) ** 2 * 50
    return {
        "c1": _conv_init(gen, 5, 5, cfg.img_channels, 20),
        "c2": _conv_init(gen, 5, 5, 20, 50),
        "f1": _normal(gen, (n_feat, 500), math.sqrt(2.0 / n_feat)),
        "f1b": torch.zeros((500,), dtype=torch.float32),
        "f2": _normal(gen, (500, cfg.n_classes), math.sqrt(2.0 / 500)),
        "f2b": torch.zeros((cfg.n_classes,), dtype=torch.float32),
    }


def lenet5_apply(params: dict, images: torch.Tensor, cfg) -> torch.Tensor:
    """Logits ``(B, n_classes)`` for NHWC ``images``."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(conv(params["c1"], x), 2)
    x = F.max_pool2d(conv(params["c2"], x), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["f1"] + params["f1b"])
    return x @ params["f2"] + params["f2b"]


# ------------------------------------------------------------------ ResNet32


def init_resnet32(gen: torch.Generator, cfg, blocks_per_stage: int = 5,
                  widths=(16, 32, 64)) -> dict:
    """He-normal ResNet-32 parameters drawn from ``gen`` (on the CPU): the
    reference's tree (``stem``, ``stem_bn``, ``s{stage}b{block}`` with
    ``c1``, ``bn1``, ``c2``, ``bn2`` and, where the width changes, a 1 x 1
    ``proj``; ``head``, ``head_b``), shapes and scales."""
    p = {"stem": _conv_init(gen, 3, 3, cfg.img_channels, widths[0]),
         "stem_bn": _bn_init(widths[0])}
    cin = widths[0]
    for s, w in enumerate(widths):
        for b in range(blocks_per_stage):
            blk = {"c1": _conv_init(gen, 3, 3, cin, w), "bn1": _bn_init(w),
                   "c2": _conv_init(gen, 3, 3, w, w), "bn2": _bn_init(w)}
            if cin != w:
                blk["proj"] = _conv_init(gen, 1, 1, cin, w)
            p[f"s{s}b{b}"] = blk
            cin = w
    p["head"] = _normal(gen, (widths[-1], cfg.n_classes), math.sqrt(2.0 / widths[-1]))
    p["head_b"] = torch.zeros((cfg.n_classes,), dtype=torch.float32)
    return p


def resnet32_apply(params: dict, images: torch.Tensor, cfg, blocks_per_stage: int = 5,
                   widths=(16, 32, 64)) -> torch.Tensor:
    """Logits ``(B, n_classes)`` for NHWC ``images``; the first block of
    stages 1 and 2 takes stride 2 (and its ``proj`` shortcut)."""
    x = torch.relu(batchnorm(params["stem_bn"], conv(params["stem"], images.permute(0, 3, 1, 2))))
    for s in range(len(widths)):
        for b in range(blocks_per_stage):
            blk = params[f"s{s}b{b}"]
            stride = 2 if (s > 0 and b == 0) else 1
            h = torch.relu(batchnorm(blk["bn1"], conv(blk["c1"], x, stride)))
            h = batchnorm(blk["bn2"], conv(blk["c2"], h))
            sc = x if "proj" not in blk else conv(blk["proj"], x, stride)
            x = torch.relu(h + sc)
    return x.mean(dim=(2, 3)) @ params["head"] + params["head_b"]
