"""Named presets: one string → (ModelConfig, synthetic Task).

Counterpart of ``repro.run.presets``:

  lenet5 / paper-lenet   LeNet5 on blob-MNIST (Adam, the paper's smallest)
  charlstm / paper-lstm  CharLSTM on a markov stream (SGD @ 1.0)
  lm-100m                ~100M-param decoder LM (12L, d=768, tied 32k vocab)
  fed-tiny               2-layer decoder sized for CI smoke rounds
  tiny                   2-layer d=64 decoder (test/parity-matrix scale)
  <arch id>              the reference's generic arm: ``reduced(cfg)`` on
                         the markov LM task of the config's vocabulary
                         (wordlstm, resnet32, every assigned
                         architecture); an audio encoder-decoder's samples
                         carry ``enc_frames`` (batch, seq_len, d) and a
                         vision config's ``prefix`` (batch, n_prefix, d),
                         both 0.1 × a standard normal draw
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, get_config, reduced
from repro_torch.data import make_classification_task, make_lm_task
from repro_torch.device import resolve_device


def lm_100m_config() -> ModelConfig:
    """~100M decoder: 12L, d=768, 12H, tied 32k vocab."""
    return ModelConfig(
        name="lm-100m", family="decoder", n_layers=12, d_model=768, n_heads=12,
        n_kv_heads=12, d_ff=3072, vocab_size=32_000, dtype=torch.float32,
        local_opt="adam", base_lr=3e-4,
    )


def fed_tiny_config() -> ModelConfig:
    """The reduced federated preset — small enough for CI smoke rounds."""
    return ModelConfig(
        name="fed-tiny", family="decoder", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=256, dtype=torch.float32,
    )


def tiny_config() -> ModelConfig:
    """Sub-CI decoder for parity matrices and unit tests."""
    return ModelConfig(
        name="tiny", family="decoder", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab_size=97, dtype=torch.float32,
    )


DECODER_PRESETS = {"lm-100m": lm_100m_config, "fed-tiny": fed_tiny_config,
                   "tiny": tiny_config}


def build_preset(name: str, *, batch: int, seq_len: int, seed: int = 0,
                 device=None):
    """Resolve a preset name to ``(cfg, task)``; the task draws on ``device``
    (default: the CUDA card; raises ``RuntimeError`` without one)."""
    if name in ("charlstm", "paper-lstm"):
        cfg = get_config("charlstm")
        task = make_lm_task(vocab=98, batch=batch, seq_len=seq_len, temperature=0.5,
                            seed=seed, device=resolve_device(device))
        return cfg, task
    if name in ("lenet5", "paper-lenet"):
        cfg = get_config("lenet5")
        # as in the reference, the blob task keeps its own default seed
        task = make_classification_task(n_classes=10, img_size=28, channels=1,
                                        batch=batch, device=resolve_device(device))
        return cfg, task
    if name in DECODER_PRESETS:
        cfg = DECODER_PRESETS[name]()
    else:  # the reference's generic arm: a reduced config on the LM task
        cfg = reduced(get_config(name))
    device = resolve_device(device)
    if cfg.vocab_size < 1:
        # resnet32 has no vocabulary: the reference builds an LM task of
        # vocabulary 0 for it and fails in numpy's argmax of an empty
        # sequence (ValueError); it has no image task for the preset
        raise ValueError(f"preset {name!r}: an LM task of vocabulary {cfg.vocab_size} "
                         f"for a {cfg.family} config has no tokens to draw")
    task = make_lm_task(vocab=cfg.vocab_size, batch=batch, seq_len=seq_len,
                        temperature=0.5, seed=seed, device=device,
                        extra_fields=modality_fields(cfg, batch, seq_len))
    return cfg, task


def modality_fields(cfg: ModelConfig, batch: int, seq_len: int):
    """``make_lm_task``'s ``extra_fields`` for ``cfg``'s modality stub, as
    the reference's generic arm draws it (``g`` the sample's generator):
    an audio encoder-decoder's ``enc_frames`` (batch, seq_len, d), a vision
    config's ``prefix`` (batch, n_prefix, d), both 0.1 × a standard
    normal; None for a text config."""
    if cfg.family == "encdec":
        if cfg.modality != "audio":
            return lambda g: {}  # the reference's arm draws nothing for text
        key, shape = "enc_frames", (batch, seq_len, cfg.d_model)
    elif cfg.modality == "vision":
        key, shape = "prefix", (batch, cfg.n_prefix, cfg.d_model)
    else:
        return None
    return lambda g: {key: 0.1 * torch.randn(shape, generator=g)}
