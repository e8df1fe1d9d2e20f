"""LeNet5-Caffe on MNIST — the paper's smallest benchmark (§IV-A).

Trained with Adam @ 1e-3, batch 128×4 clients (paper Table III).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="lenet5",
    family="cnn",
    source="paper §IV-A / Caffe MNIST tutorial",
    img_size=28,
    img_channels=1,
    n_classes=10,
    local_opt="adam",
    base_lr=1e-3,
)
