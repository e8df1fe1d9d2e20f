"""Model / training configuration.

Counterpart of ``repro.configs.base``.  This slice carries the
:class:`ModelConfig` fields that the paper's LeNet5 reads; the transformer,
MoE, SSM and LSTM fields come with the model zoo (ROADMAP A5, A12).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One architecture (the CNN fields of the reference's config).

    The reference's ``residual_dtype`` is not carried: the flat hist route
    keeps an f32 residual, and the bf16 residual of its largest
    architectures takes the per-leaf exchange (ROADMAP A9).
    """

    name: str
    family: str  # 'cnn' in this slice
    source: str = ""  # paper / model-card citation

    # --- cnn (paper's own models)
    img_size: int = 0
    img_channels: int = 3
    n_classes: int = 10

    # --- distribution / local training
    client_mode: str = "data"  # one client per data coordinate (DESIGN.md §4)
    local_opt: str = "momentum"  # client-side optimizer for this arch
    base_lr: float = 0.01


PORTED_CONFIGS = ("lenet5",)


def get_config(name: str, **overrides: Any) -> ModelConfig:
    """Load ``repro_torch/configs/<name>.py`` and return its CONFIG."""
    if name not in PORTED_CONFIGS:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; have {PORTED_CONFIGS} "
            "(the paper presets come with ROADMAP A5, the zoo with A12)"
        )
    cfg = importlib.import_module(f"repro_torch.configs.{name}").CONFIG
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
