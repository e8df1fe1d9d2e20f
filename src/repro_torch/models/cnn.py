"""The paper's LeNet5-Caffe (MNIST).

Counterpart of the LeNet5 half of ``repro.models.cnn``.  Parameters keep
the reference's layouts — conv kernels HWIO, dense layers ``(in, out)``,
images NHWC — so parameters cross between the packages as they are.
``lenet5_apply`` permutes to NCHW/OIHW for ``F.conv2d`` and back to NHWC
before the flatten, so the rows of ``f1`` meet the features they were
trained on.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def init_lenet5(gen: torch.Generator, cfg) -> dict:
    """He-normal LeNet5 parameters drawn from ``gen`` (on the CPU).

    Same shapes and scales as the reference; the numbers differ (torch
    cannot reproduce JAX's threefry), so parity tests carry parameters
    across with :mod:`repro_torch.convert`.
    """
    n_feat = (cfg.img_size // 4) ** 2 * 50
    return {
        "c1": _normal(gen, (5, 5, cfg.img_channels, 20),
                      math.sqrt(2.0 / (25 * cfg.img_channels))),
        "c2": _normal(gen, (5, 5, 20, 50), math.sqrt(2.0 / (25 * 20))),
        "f1": _normal(gen, (n_feat, 500), math.sqrt(2.0 / n_feat)),
        "f1b": torch.zeros((500,), dtype=torch.float32),
        "f2": _normal(gen, (500, cfg.n_classes), math.sqrt(2.0 / 500)),
        "f2b": torch.zeros((cfg.n_classes,), dtype=torch.float32),
    }


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """NCHW ``x`` with an HWIO kernel, stride 1, SAME padding (odd kernels)."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2))


def lenet5_apply(params: dict, images: torch.Tensor, cfg) -> torch.Tensor:
    """Logits ``(B, n_classes)`` for NHWC ``images``."""
    x = images.permute(0, 3, 1, 2)
    x = F.max_pool2d(_conv_same(x, params["c1"]), 2)
    x = F.max_pool2d(_conv_same(x, params["c2"]), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = torch.relu(x @ params["f1"] + params["f1b"])
    return x @ params["f2"] + params["f2b"]
