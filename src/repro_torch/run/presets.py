"""Named presets: one string → (ModelConfig, synthetic Task).

Counterpart of ``repro.run.presets``; the port carries the paper's

  lenet5 / paper-lenet   LeNet5 on blob-MNIST (Adam, the paper's smallest)
  charlstm / paper-lstm  CharLSTM on a markov stream (SGD @ 1.0)
  wordlstm, resnet32     the reference's generic arm: ``reduced(cfg)`` on
                         the markov LM task of the config's vocabulary

The zoo's presets (``tiny``, ``fed-tiny``, ``lm-100m`` and the assigned
architectures) come with ROADMAP A12, part 2.
"""
from __future__ import annotations

from repro_torch.configs.base import get_config, reduced
from repro_torch.data import make_classification_task, make_lm_task
from repro_torch.device import resolve_device

PORTED_PRESETS = ("lenet5", "paper-lenet", "charlstm", "paper-lstm", "wordlstm", "resnet32")


def build_preset(name: str, *, batch: int, seq_len: int, seed: int = 0,
                 device=None):
    """Resolve a preset name to ``(cfg, task)``; the task draws on ``device``
    (default: the CUDA card; raises ``RuntimeError`` without one)."""
    if name not in PORTED_PRESETS:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet; have {PORTED_PRESETS} "
            "(the zoo comes with ROADMAP A12, part 2)"
        )
    device = resolve_device(device)
    if name in ("charlstm", "paper-lstm"):
        cfg = get_config("charlstm")
        task = make_lm_task(vocab=98, batch=batch, seq_len=seq_len, temperature=0.5,
                            seed=seed, device=device)
        return cfg, task
    if name in ("lenet5", "paper-lenet"):
        cfg = get_config("lenet5")
        # as in the reference, the blob task keeps its own default seed
        task = make_classification_task(n_classes=10, img_size=28, channels=1,
                                        batch=batch, device=device)
        return cfg, task
    # the reference's generic arm: a reduced config on the LM task
    cfg = reduced(get_config(name))
    if cfg.vocab_size < 1:
        # resnet32 has no vocabulary: the reference builds an LM task of
        # vocabulary 0 for it and fails in numpy's argmax of an empty
        # sequence (ValueError); it has no image task for the preset
        raise ValueError(f"preset {name!r}: an LM task of vocabulary {cfg.vocab_size} "
                         f"for a {cfg.family} config has no tokens to draw")
    task = make_lm_task(vocab=cfg.vocab_size, batch=batch, seq_len=seq_len,
                        temperature=0.5, seed=seed, device=device)
    return cfg, task
