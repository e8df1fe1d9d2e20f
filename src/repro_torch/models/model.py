"""``build_model(cfg) → Model``: init, loss, prefill and decode of one
architecture.

Counterpart of ``repro.models.model``; the port builds the paper's four
models (the CNN family's LeNet5 and ResNet-32, the LSTM family's CharLSTM
and WordLSTM) and the transformers: the decoders (dense, MoE, recurrent,
with a vision prefix) and the encoder-decoder.  A batch's ``prefix``,
``enc_tokens`` and ``enc_frames`` reach the loss and the prefill.
``make_param_specs`` (the reference's sharding rules) comes with the
"model" axis, ROADMAP A12, part 3, item 6.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import cnn, lstm, transformer
from repro_torch.models.losses import chunked_softmax_xent, softmax_xent


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], dict]  # generator → params (on its device)
    loss_fn: Callable[[dict, dict], torch.Tensor]  # (params, batch) → scalar
    prefill: Optional[Callable] = None  # (params, batch) → (hidden, caches)
    decode_step: Optional[Callable] = None  # (params, tokens, caches, pos) → (logits, caches)
    init_caches: Optional[Callable] = None  # (params, batch, seq_len) → caches


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "lstm":
        return _build_lstm(cfg)
    if cfg.family == "cnn":
        return _build_cnn(cfg)
    return _build_transformer(cfg)


AUX_WEIGHT = 0.01  # MoE load-balance loss coefficient


def _build_transformer(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator) -> dict:
        return transformer.init_decoder_lm(gen, cfg)

    def _kwargs(batch: dict) -> dict:
        return {k: batch[k] for k in ("prefix", "enc_tokens", "enc_frames") if k in batch}

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        hidden, aux = transformer.decoder_hidden(params, batch["tokens"], cfg, **_kwargs(batch))
        emb = transformer.output_embedding(params, cfg)
        loss = chunked_softmax_xent(hidden, emb, batch["labels"])
        return loss + AUX_WEIGHT * aux

    def prefill(params: dict, batch: dict, q_chunk: int = 0):
        return transformer.decoder_prefill(params, batch["tokens"], cfg, q_chunk=q_chunk,
                                           **_kwargs(batch))

    def decode_step(params: dict, tokens, caches, pos):
        return transformer.decoder_decode_step(params, tokens, cfg, caches, pos)

    def init_caches(params: dict, batch: int, seq_len: int):
        return transformer.init_decode_caches(params, cfg, batch, seq_len)

    return Model(cfg, init, loss_fn, prefill, decode_step, init_caches)


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
