"""``build_model(cfg) → Model``: init, loss, prefill and decode of one
architecture.

Counterpart of ``repro.models.model``; the port builds the paper's four
models (the CNN family's LeNet5 and ResNet-32, the LSTM family's CharLSTM
and WordLSTM) and the transformers: the decoders (dense, MoE, recurrent,
with a vision prefix) and the encoder-decoder.  A batch's ``prefix``,
``enc_tokens`` and ``enc_frames`` reach the loss and the prefill.

:func:`make_param_specs` is the reference's path-rule sharding
(Megatron-style tensor parallelism over "model", FSDP over "data" for the
≥20B configs, the expert-parallel rules for the MoE dispatch modes
``"flat_ep"`` and ``"grouped"``).  A spec is a tuple with one entry a
dimension, an axis name or ``None`` (the reference's ``PartitionSpec``
entries, trailing ``None`` kept), or ``()`` for a replicated leaf; a
layout is a dict of axis sizes.  A rule falls back to replication where
a dimension does not divide its axis, and leaves under 1 MiB replicate.
The GSPMD backend cuts each leaf into the equal blocks its spec gives,
and compresses each block on its own (``repro_torch.launch.dist``).
"""
from __future__ import annotations

import re
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import path_str
from repro_torch.core.tree import tree_flatten_with_path
from repro_torch.models import cnn, hints, lstm, transformer
from repro_torch.models.losses import chunked_softmax_xent, softmax_xent

PyTree = Any  # a nested dict of tensors, as the reference's pytrees


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[[torch.Generator], dict]  # generator → params (on its device)
    loss_fn: Callable[[dict, dict], torch.Tensor]  # (params, batch) → scalar
    prefill: Optional[Callable] = None  # (params, batch) → (hidden, caches)
    decode_step: Optional[Callable] = None  # (params, tokens, caches, pos) → (logits, caches)
    init_caches: Optional[Callable] = None  # (params, batch, seq_len) → caches
    param_specs: Optional[Callable] = None  # (params, layout) → specs


# -------------------------------------------------------------- spec rules
# (regex over the "/"-joined path, an axis a dimension, the dimension that
# also takes "data" under FSDP)

_RULES: list[tuple[str, tuple[Optional[str], ...], Optional[int]]] = [
    (r"embedding$", ("model", None), 1),
    (r"(wq|wk|wv|wg|wr)/w$", (None, "model"), 0),
    (r"(wq|wk|wv|wg|wr)/b$", ("model",), None),
    (r"wo/w$", ("model", None), 1),
    (r"(up|gate)/w$", (None, "model"), 0),
    (r"down/w$", ("model", None), 1),
    (r"moe/router$", (None, None), None),
    (r"moe/(up|gate)$", (None, None, "model"), 1),
    (r"moe/down$", (None, "model", None), 2),
]

# the expert-parallel variant: experts over "data", the contraction dims
# not over "data"; where E does not divide the data axis (mixtral's 8 on
# 16) the expert dim stays replicated and the baseline rule's model axis
# applies
_EP_RULES: list[tuple[str, tuple[Optional[str], ...], Optional[int]]] = [
    (r"moe/(up|gate)$", ("data", None, "model"), None),
    (r"moe/down$", ("data", "model", None), None),
    (r"in_proj/w$", (None, "model"), 0),
    (r"conv_w$", (None, None, "model"), None),
    (r"(conv_b|D)$", ("model",), None),
    (r"x_proj/w$", ("model", None), None),
    (r"dt_proj/w$", (None, "model"), None),
    (r"dt_proj/b$", ("model",), None),
    (r"A_log$", ("model", None), None),
    (r"out_proj/w$", ("model", None), 1),
    (r"(ck|cr)/w$", (None, "model"), 0),
    (r"cv/w$", ("model", None), 1),
    (r"(w0|ln_x|cmix_k|cmix_r|mix_w)$", ("model",), None),
]

_MIN_SHARD_BYTES = 1 << 20

Spec = tuple


def _spec_for(path: str, shape: tuple, nbytes: int, sizes: dict, fsdp: bool,
              scan_prefix: bool, expert_parallel: bool = False) -> Spec:
    """The reference's ``_spec_for`` on a leaf's path, shape and bytes."""
    if nbytes < _MIN_SHARD_BYTES:
        return ()
    rules = (_EP_RULES + _RULES) if expert_parallel else _RULES
    for pat, axes, fsdp_dim in rules:
        if re.search(pat, path):
            offset = 1 if scan_prefix else 0  # a scanned stack's leading dim
            ndim = len(shape)
            dims: list[Any] = [None] * ndim
            for i, ax in enumerate(axes):
                j = i + offset
                if ax is None or j >= ndim:
                    continue
                if shape[j] % sizes.get(ax, 1) == 0:
                    dims[j] = ax
            if expert_parallel and "data" in dims:
                fsdp_dim = None  # the expert dim took the data axis
            if fsdp and fsdp_dim is not None and "data" not in dims:
                j = fsdp_dim + offset
                if j < ndim and dims[j] is None and shape[j] % sizes.get("data", 1) == 0:
                    dims[j] = "data"
            return tuple(dims)
    return ()


def make_param_specs(params, layout: dict, *, fsdp: bool = False,
                     expert_parallel: bool = False):
    """The params' tree of specs on ``layout`` (axis name → size).  The
    leaves may live on the ``meta`` device: only shapes and dtypes are
    read."""
    flat, treedef = tree_flatten_with_path(params)
    specs = []
    for path, leaf in flat:
        pstr = path_str(path)
        scan_prefix = "stack/scan" in pstr or pstr.startswith("scan")
        specs.append(_spec_for(pstr, tuple(leaf.shape), leaf.numel() * leaf.element_size(),
                               dict(layout), fsdp, scan_prefix, expert_parallel))
    return treedef.unflatten(specs)


def _replicated(params, layout) -> Any:
    flat, treedef = tree_flatten_with_path(params)
    return treedef.unflatten([() for _ in flat])


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

    def param_specs(params: dict, layout: dict):
        return make_param_specs(params, layout, fsdp=cfg.fsdp,
                                expert_parallel=cfg.moe_dispatch in ("flat_ep", "grouped"))

    return Model(cfg, init, loss_fn, prefill, decode_step, init_caches, param_specs)


def _build_cnn(cfg: ModelConfig) -> Model:
    is_lenet = cfg.name == "lenet5"

    def init(gen: torch.Generator) -> dict:
        return cnn.init_lenet5(gen, cfg) if is_lenet else cnn.init_resnet32(gen, cfg)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        apply = cnn.lenet5_apply if is_lenet else cnn.resnet32_apply
        return softmax_xent(apply(hints.params(params), batch["images"], cfg), batch["labels"])

    return Model(cfg, init, loss_fn, param_specs=_replicated)


def _build_lstm(cfg: ModelConfig) -> Model:
    def init(gen: torch.Generator) -> dict:
        return lstm.init_lstm_lm(gen, cfg)

    def loss_fn(params: dict, batch: dict) -> torch.Tensor:
        logits = lstm.lstm_lm_apply(hints.params(params), batch["tokens"], cfg)
        return softmax_xent(logits, batch["labels"])

    return Model(cfg, init, loss_fn, param_specs=_replicated)
