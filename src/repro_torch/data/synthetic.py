"""Deterministic synthetic data with per-client streams.

Counterpart of the classification half of ``repro.data.synthetic`` and of
its :func:`client_batches`: the
paper's MNIST stand-in, Gaussian class blobs in pixel space ("blob-MNIST")
with fixed class means and additive noise.  Batches are drawn on the fly
from a ``torch.Generator`` seeded by ``(seed, client, step)``, so the
stream is stateless, reproducible and infinite.  torch cannot reproduce
JAX's threefry draws: the numbers differ from the reference's, the
distribution is the same, and parity tests hand both packages the same
numpy batches instead.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device

_MASK64 = (1 << 64) - 1


def _seed_of(*parts: int) -> int:
    """A 63-bit generator seed mixed from integers (splitmix64 steps)."""
    z = 0x9E3779B97F4A7C15
    for p in parts:
        z = (z + (int(p) & _MASK64) + 0x9E3779B97F4A7C15) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        z ^= z >> 31
    return z >> 1


@dataclasses.dataclass(frozen=True)
class Task:
    """A data source: ``sample(step, client) -> dict`` plus metadata."""

    name: str
    sample: Callable[[int, int], dict]  # (step, client) -> batch dict
    n_classes: int = 0


def make_classification_task(
    *,
    n_classes: int,
    img_size: int,
    channels: int,
    batch: int,
    noise: float = 0.35,
    seed: int = 0,
    device=None,
) -> Task:
    """Gaussian class-blob images (NHWC f32) with int64 labels: class c has
    a fixed mean image; samples add isotropic noise.  Drawn on ``device``
    (default: the CUDA card; raises ``RuntimeError`` without one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed_of(seed, 23))
    means = torch.randn((n_classes, img_size, img_size, channels),
                        generator=gen, device=dev) * 0.5

    def sample(step: int, client: int) -> dict:
        g = torch.Generator(device=dev)
        g.manual_seed(_seed_of(seed, 2000 + client, step))
        labels = torch.randint(0, n_classes, (batch,), generator=g, device=dev)
        imgs = means[labels] + noise * torch.randn(
            (batch, img_size, img_size, channels), generator=g, device=dev
        )
        return {"images": imgs, "labels": labels}

    return Task(name="blobs", sample=sample, n_classes=n_classes)


def client_batches(task: Task, n_clients: int, n_delay: int) -> Callable[[int], dict]:
    """``batch_fn(round) -> dict`` of ``(clients, n_delay, batch, ...)``
    tensors on the task's device: client c's local step d of round r
    draws ``task.sample(r * n_delay + d, c)``, the reference's stream
    layout (each client a disjoint stream)."""

    def batch_fn(round_idx: int) -> dict:
        grid = [[task.sample(round_idx * n_delay + d, c) for d in range(n_delay)]
                for c in range(n_clients)]
        return {k: torch.stack([torch.stack([b[k] for b in row]) for row in grid])
                for k in grid[0][0]}

    return batch_fn
