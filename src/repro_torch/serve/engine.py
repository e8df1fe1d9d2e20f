"""Batched serving engine: prefill → iterative one-token decode.

Counterpart of ``repro.serve.engine``.  ``serve_step`` is one new token
for the whole batch against the caches; ``generate`` drives it.
Sampling is greedy or temperature-categorical (Gumbel-max, as
``jax.random.categorical`` draws).

The engine is stateless — caches are explicit trees — so the same step
serves any number of concurrent batched sessions.  The reference splits
its PRNG key before every sample; the port keeps that structure with
``torch.Generator``s: a split draws two seeds from the caller's generator
(a CPU one by default, so a split never waits for the card) and seeds a
fresh generator with each, one to carry on and one to sample with.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.model import Model

PyTree = Any


def _split(gen: torch.Generator, device=None) -> Tuple[torch.Generator, torch.Generator]:
    """``jax.random.split`` for a generator: ``(carry on, use)``, the
    second on ``device`` (default: ``gen``'s)."""
    seeds = torch.randint(0, 2 ** 62, (2,), generator=gen, device=gen.device).tolist()
    carry = torch.Generator(device=gen.device).manual_seed(seeds[0])
    use = torch.Generator(device=device or gen.device).manual_seed(seeds[1])
    return carry, use


@dataclasses.dataclass(eq=False)
class ServeEngine:
    model: Model

    def prefill(self, params: PyTree, batch: dict) -> tuple:
        """Run the full-sequence forward; returns (next_token_logits
        (B, 1, V) f32, caches)."""
        hidden, caches = self.model.prefill(params, batch)
        emb = transformer.output_embedding(params, self.model.cfg)
        logits = hidden[:, -1:, :].to(torch.float32) @ emb.to(torch.float32).T
        return logits, caches

    def serve_step(self, params: PyTree, tokens: torch.Tensor, caches: PyTree,
                   pos: int) -> tuple:
        """ONE new token for the whole batch.  tokens: (B, 1) int."""
        return self.model.decode_step(params, tokens, caches, pos)

    @torch.no_grad()
    def generate(self, params: PyTree, batch: dict, *, max_new_tokens: int,
                 gen: Optional[torch.Generator] = None,
                 temperature: float = 0.0) -> torch.Tensor:
        """Prefill then decode ``max_new_tokens``; returns (B,
        max_new_tokens) int64 token ids on the parameters' device.  A
        decode past the caches' depth writes their last slot, as the
        reference does (ROADMAP C)."""
        logits, caches = self.prefill(params, batch)
        prompt_len = batch["tokens"].shape[1]
        dev = logits.device

        def pick(lg: torch.Tensor, r: torch.Generator) -> torch.Tensor:
            if temperature <= 0.0:
                return torch.argmax(lg[:, -1, :], dim=-1)
            u = torch.rand(lg[:, -1, :].shape, generator=r, device=dev,
                           dtype=torch.float32)
            tiny = torch.finfo(torch.float32).tiny
            gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
            return torch.argmax(lg[:, -1, :] / temperature + gumbel, dim=-1)

        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        toks = []
        # split BEFORE the first sample: consuming the caller's generator
        # raw would correlate the first step with any other use of it
        gen, r = _split(gen, dev)
        tok = pick(logits, r)
        toks.append(tok)
        for i in range(1, max_new_tokens):
            gen, r = _split(gen, dev)
            logits, caches = self.serve_step(params, tok[:, None], caches,
                                             prompt_len + i - 1)
            tok = pick(logits, r)
            toks.append(tok)
        return torch.stack(toks, dim=1)
