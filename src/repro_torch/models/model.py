"""``build_model(cfg) → Model``: init and loss of one architecture.

Counterpart of ``repro.models.model``; this slice builds the CNN family's
LeNet5.  The other families come with ROADMAP A5 and A12.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn
from repro_torch.models.losses import softmax_xent


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], dict]  # generator → params (CPU)
    loss_fn: Callable[[dict, dict], torch.Tensor]  # (params, batch) → scalar


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family != "cnn" or cfg.name != "lenet5":
        raise NotImplementedError(
            f"model {cfg.name!r} ({cfg.family}) is not ported yet; this slice "
            "has lenet5 (the paper presets come with ROADMAP A5, the zoo with A12)"
        )

    def init(gen: torch.Generator) -> dict:
        return cnn.init_lenet5(gen, cfg)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        logits = cnn.lenet5_apply(params, batch["images"], cfg)
        return softmax_xent(logits, batch["labels"])

    return Model(cfg, init, loss_fn)
