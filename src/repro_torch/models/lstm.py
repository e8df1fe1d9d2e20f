"""Multi-layer LSTM language models — the paper's CharLSTM (§IV-A):
embedding → n-layer LSTM → untied head.

Counterpart of ``repro.models.lstm``, with the same parameter tree, leaf
names and shapes (``embed/embedding (V, d)``; per layer ``cell{i}/wx (d,
4d)``, ``wh (d, 4d)``, ``b (4d,)``; ``head/w (d, V)``) and the same
cell: gates in the order i, f, g, o, computed in f32, and the forget
gate's ``+1.0`` inside ``sigmoid(f + 1.0)``, not folded into ``b``.

The reference scans time with the layers interleaved inside each step.
:func:`lstm_lm_apply` runs layer by layer, which is the same function:
one ``x @ wx`` GEMM over every time step of a layer, then the time loop
of ``h @ wh`` and the gates.  Every product is a plain ``torch.matmul``
(the reference has no Pallas kernel on the model); it differs from XLA's
in the order of a GEMM's adds only, which the parity tests bound.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import embed_lookup, init_embed


def init_lstm_cell(gen: torch.Generator, d_in: int, d_hidden: int) -> dict:
    """One cell's ``{"b", "wh", "wx"}`` in f32 drawn from ``gen`` (on the
    CPU): normal weights with standard deviation ``1/√d_hidden``, zero bias."""
    s = 1.0 / math.sqrt(d_hidden)
    return {
        "wx": torch.randn((d_in, 4 * d_hidden), generator=gen) * s,
        "wh": torch.randn((d_hidden, 4 * d_hidden), generator=gen) * s,
        "b": torch.zeros((4 * d_hidden,)),
    }


def _gates_to_state(gates: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h, c)`` from the pre-activation gates ``(…, 4d)``, in f32."""
    i, f, g, o = torch.chunk(gates.to(torch.float32), 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_cell(p: dict, x: torch.Tensor, h: torch.Tensor,
              c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of one cell: ``(h, c)`` from input ``x``, state ``(h, c)``."""
    h, c = _gates_to_state(x @ p["wx"] + h @ p["wh"] + p["b"], c)
    return h.to(x.dtype), c


def init_lstm_lm(gen: torch.Generator, cfg) -> dict:
    """CharLSTM parameters drawn from ``gen`` (on the CPU): the
    reference's tree, shapes and scales; the numbers differ (torch cannot
    reproduce threefry), so parity tests carry parameters across with
    :mod:`repro_torch.convert`."""
    d = cfg.lstm_hidden
    p = {"embed": init_embed(gen, cfg.vocab_size, d)}
    for i in range(cfg.n_layers):
        p[f"cell{i}"] = init_lstm_cell(gen, d, d)
    p["head"] = {"w": torch.randn((d, cfg.vocab_size), generator=gen) / math.sqrt(d)}
    return p


def lstm_lm_apply(params: dict, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """tokens ``(B, S)`` → logits ``(B, S, V)``."""
    B, S = tokens.shape
    d = cfg.lstm_hidden
    x = embed_lookup(params["embed"], tokens)  # (B, S, d)
    for i in range(cfg.n_layers):
        p = params[f"cell{i}"]
        xw = x @ p["wx"]  # (B, S, 4d): the input's share of every step's gates
        h = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        c = torch.zeros((B, d), dtype=torch.float32, device=x.device)
        hs = []
        for t in range(S):
            h, c = _gates_to_state(xw[:, t] + h @ p["wh"] + p["b"], c)
            h = h.to(x.dtype)
            hs.append(h)
        x = torch.stack(hs, dim=1)  # (B, S, d)
    return x @ params["head"]["w"]
