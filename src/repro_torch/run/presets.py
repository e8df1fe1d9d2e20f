"""Named presets: one string → (ModelConfig, synthetic Task).

Counterpart of ``repro.run.presets``; this slice carries

  lenet5 / paper-lenet   LeNet5 on blob-MNIST (Adam, the paper's smallest)

The other presets come with ROADMAP A5 (charlstm) and A12 (the zoo).
"""
from __future__ import annotations

from repro_torch.configs.base import get_config
from repro_torch.data import make_classification_task
from repro_torch.device import resolve_device

PORTED_PRESETS = ("lenet5", "paper-lenet")


def build_preset(name: str, *, batch: int, seq_len: int, seed: int = 0,
                 device=None):
    """Resolve a preset name to ``(cfg, task)``; the task draws on ``device``
    (default: the CUDA card; raises ``RuntimeError`` without one)."""
    if name not in PORTED_PRESETS:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet; have {PORTED_PRESETS} "
            "(charlstm comes with ROADMAP A5, the zoo with A12)"
        )
    device = resolve_device(device)
    cfg = get_config("lenet5")
    # as in the reference, the blob task keeps its own default seed
    task = make_classification_task(n_classes=10, img_size=28, channels=1,
                                    batch=batch, device=device)
    return cfg, task
