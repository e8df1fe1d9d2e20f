"""ResNet-32 on CIFAR-10 — paper §IV-A (He et al. '16, 3 x 5 basic blocks,
widths 16/32/64).

Momentum SGD at lr 0.01, batch 128 x 4 clients (paper Table III).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="resnet32",
    family="cnn",
    source="paper §IV-A / He et al. 2016",
    n_layers=0,
    vocab_size=0,
    img_size=32,
    img_channels=3,
    n_classes=10,
    local_opt="momentum",
    base_lr=0.01,
    dtype=torch.float32,
    scan_layers=False,
    remat=False,
)
