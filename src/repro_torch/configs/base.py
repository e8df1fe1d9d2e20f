"""Model / training configuration.

Counterpart of ``repro.configs.base``.  The port carries the
:class:`ModelConfig` fields that the paper's two presets read, LeNet5 and
CharLSTM; the transformer, MoE and SSM fields come with the model zoo
(ROADMAP A12).
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


PORTED_CONFIGS = ("lenet5", "charlstm")


def get_config(name: str, **overrides: Any) -> ModelConfig:
    """Load ``repro_torch/configs/<name>.py`` and return its CONFIG."""
    if name not in PORTED_CONFIGS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; have {PORTED_CONFIGS} "
            "(the zoo comes with ROADMAP A12)"
        )
    cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
