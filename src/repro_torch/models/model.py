"""``build_model(cfg) → Model``: init and loss of one architecture.

Counterpart of ``repro.models.model``; the port builds the paper's four
models: the CNN family's LeNet5 and ResNet-32, and the LSTM family's
CharLSTM and WordLSTM.  The other families come with ROADMAP A12, part 2.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, lstm
from repro_torch.models.losses import softmax_xent


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], dict]  # generator → params (CPU)
    loss_fn: Callable[[dict, dict], torch.Tensor]  # (params, batch) → scalar


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "lstm":
        return _build_lstm(cfg)
    if cfg.family == "cnn":
        return _build_cnn(cfg)
    raise NotImplementedError(
        f"model {cfg.name!r} ({cfg.family}) is not ported yet; the port has the "
        "cnn and lstm families (the zoo comes with ROADMAP A12, part 2)"
    )


def _build_cnn(cfg: ModelConfig) -> Model:
    is_lenet = cfg.name == "lenet5"

    def init(gen: torch.Generator) -> dict:
        return cnn.init_lenet5(gen, cfg) if is_lenet else cnn.init_resnet32(gen, cfg)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        apply = cnn.lenet5_apply if is_lenet else cnn.resnet32_apply
        return softmax_xent(apply(params, batch["images"], cfg), batch["labels"])

    return Model(cfg, init, loss_fn)


def _build_lstm(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator) -> dict:
        return lstm.init_lstm_lm(gen, cfg)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        logits = lstm.lstm_lm_apply(params, batch["tokens"], cfg)
        return softmax_xent(logits, batch["labels"])

    return Model(cfg, init, loss_fn)
