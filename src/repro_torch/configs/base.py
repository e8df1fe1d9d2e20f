"""Model / training configuration.

Counterpart of ``repro.configs.base``.  The port carries the
:class:`ModelConfig` fields that the paper's four models read (LeNet5,
ResNet-32, CharLSTM, WordLSTM) and :func:`reduced` over them; the
transformer, MoE and SSM fields come with the model zoo (ROADMAP A12,
part 2).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (the CNN and LSTM fields of the reference's config).

    ``residual_dtype`` is the dtype of the GSPMD backend's error-feedback
    residual, its ΔW and its optimizer state (bf16 for the reference's
    largest architectures).  The flat fast path keeps f32; any other dtype
    takes the per-leaf exchange, as in the reference.
    """

    name: str
    family: str  # 'cnn' | 'lstm' in the port
    n_layers: int = 0
    vocab_size: int = 0
    source: str = ""  # paper / model-card citation

    # --- cnn / lstm (paper's own models)
    img_size: int = 0
    img_channels: int = 3
    n_classes: int = 10
    lstm_hidden: int = 0

    # --- distribution / local training
    client_mode: str = "data"  # one client per data coordinate (DESIGN.md §4)
    local_opt: str = "momentum"  # client-side optimizer for this arch
    base_lr: float = 0.01
    residual_dtype: Any = torch.float32


# the paper's own models (§IV-A), the configs the port carries
PAPER_ARCHS = ["lenet5", "resnet32", "charlstm", "wordlstm"]


def get_config(name: str, **overrides: Any) -> ModelConfig:
    """Load ``repro_torch/configs/<name>.py`` and return its CONFIG."""
    if name not in PAPER_ARCHS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; have {PAPER_ARCHS} "
            "(the zoo comes with ROADMAP A12, part 2)"
        )
    cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduced(cfg: ModelConfig, **extra: Any) -> ModelConfig:
    """Smoke-test variant of ``cfg``, as the reference's ``reduced``: at
    most 2 layers, a vocabulary of at most 512 and an LSTM at most 64
    wide.  The reference also caps the zoo's widths, heads, experts,
    windows and SSM state and sets ``fsdp=False`` and ``dtype=f32``; the
    port's configs carry none of those fields (they come with ROADMAP
    A12, part 2), and the layer-pattern period that bounds ``n_layers``
    from below is 1 on every config here (no ``attn_every``,
    ``local_global_ratio``, ``global_every`` or ``moe_every``)."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 2),
        vocab_size=min(cfg.vocab_size, 512),
        lstm_hidden=min(cfg.lstm_hidden, 64) if cfg.lstm_hidden else 0,
    )
    changes.update(extra)
    return dataclasses.replace(cfg, **changes)
