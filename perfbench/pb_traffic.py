"""The one traffic generator: a pool of training batches drawn on the
device from the seed, as a traffic file describes them.

A traffic file (``traffic/<name>.json``) gives ``batch`` rows of
``seq_len`` tokens a round (one local step), token ids drawn i.i.d. from a Zipf law of
exponent ``zipf_s`` over the configuration's vocabulary (id i with
weight ``(i + 1)^-s``), the next token as each position's label; a
``pool`` of distinct batches, cycled round after round; and, where
``frames`` is given, ``(batch, frames.len, d_model)`` encoder frame
embeddings of ``frames.std`` times a standard normal.  ``trace_rounds``
is the stretch of rounds a ``--trace 1`` run profiles.  Every seed
draws batches of the same sizes, so the work of a round is the seed's
only in its values.
"""
from __future__ import annotations

import torch

SEED_SALT = 0x5EED


def tokens_per_round(traffic: dict) -> int:
    """Token positions trained a round: the decoder's tokens, plus the
    encoder's frames where the traffic has them."""
    n = traffic["batch"] * traffic["seq_len"]
    if traffic.get("frames"):
        n += traffic["batch"] * traffic["frames"]["len"]
    return n


def make_pool(traffic: dict, model: dict, seed: int, device) -> list:
    """``traffic["pool"]`` batches ``{tokens, labels[, enc_frames]}``."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + SEED_SALT) % (2 ** 63 - 1))
    B, S, P = traffic["batch"], traffic["seq_len"], traffic["pool"]
    V = model["vocab_size"]
    weights = torch.arange(1, V + 1, dtype=torch.float64, device=device) ** -traffic["zipf_s"]
    ids = torch.multinomial(weights.float(), P * B * (S + 1), replacement=True,
                            generator=gen).reshape(P, B, S + 1)
    pool = [{"tokens": ids[i, :, :-1].contiguous(), "labels": ids[i, :, 1:].contiguous()}
            for i in range(P)]
    frames = traffic.get("frames")
    if frames:
        for batch in pool:
            batch["enc_frames"] = frames["std"] * torch.randn(
                (B, frames["len"], model["d_model"]), generator=gen, device=device)
    return pool
