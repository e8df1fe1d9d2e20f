"""CharLSTM on Shakespeare — paper §IV-A (2×200 LSTM over a 98-character
vocabulary, plain SGD @ 1.0).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="charlstm",
    family="lstm",
    source="paper §IV-A",
    n_layers=2,
    vocab_size=98,
    lstm_hidden=200,
    local_opt="sgd",
    base_lr=1.0,
    dtype=torch.float32,
    scan_layers=False,
    remat=False,
)
