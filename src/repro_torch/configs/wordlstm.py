"""WordLSTM on PTB — paper §IV-A (Zaremba et al. "medium": 2 x 650 LSTM,
10,000-word vocabulary, plain SGD at lr 1.0).
"""
import torch

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="wordlstm",
    family="lstm",
    source="paper §IV-A / Zaremba et al. 2014",
    n_layers=2,
    vocab_size=10_000,
    lstm_hidden=650,
    local_opt="sgd",
    base_lr=1.0,
    dtype=torch.float32,
    scan_layers=False,
    remat=False,
)
