"""Deterministic synthetic data with per-client streams.

Counterpart of ``repro.data.synthetic``:

  * classification ("blobs"): the paper's MNIST stand-in, Gaussian class
    blobs in pixel space ("blob-MNIST") with fixed class means and
    additive noise;
  * LM ("markov"): a fixed random first-order Markov chain over the
    vocabulary with temperature-controlled entropy, the CharLSTM preset's
    stand-in for Shakespeare; ("affine"): ``x_{t+1} = (3·x_t + 7) mod V``,
    near-zero achievable loss, for smoke tests;
  * non-IID LM shards (:func:`make_non_iid_lm_task`): each client walks
    its own chain, between a shared one and a private one;
  * the client-sharded views :func:`split_among_clients` and
    :func:`client_batches`.

Batches are drawn on the fly from a ``torch.Generator`` seeded by
``(seed, client, step)``, so the stream is stateless, reproducible and
infinite.  torch cannot reproduce JAX's threefry draws: the numbers
differ from the reference's, the formulas and the distributions are the
same, and parity tests hand both packages the same numpy draws instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.device import resolve_device

PyTree = Any  # a nested dict of tensors, as the reference's pytrees

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
    """A data source: ``sample(step, client) -> dict`` plus metadata.

    ``sample_many(steps, clients)``, where set, gives the batches of many
    (step, client) pairs with a leading pair axis, equal to per-pair
    ``sample`` calls (:func:`stacked_sampler`; the reference's draws them
    in one dispatch)."""

    name: str
    sample: Callable[[int, int], dict]  # (step, client) -> batch dict
    vocab_size: int = 0
    n_classes: int = 0
    entropy_floor: float = 0.0  # achievable loss (nats/token) for LM tasks
    sample_many: Optional[Callable] = None  # (steps[N], clients[N]) -> dict


def stacked_sampler(sample: Callable[[int, int], dict]) -> Callable:
    """``sample_many(steps, clients)`` over ``sample``: each pair's batch
    stacked along a new leading axis.  Every pair draws from its own
    generator, so this is one draw a pair, not one dispatch."""
    def sample_many(steps, clients) -> dict:
        per = [sample(int(s), int(c)) for s, c in zip(steps, clients)]
        return {k: torch.stack([b[k] for b in per]) for k in per[0]}

    return sample_many


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

    return Task(name="blobs", sample=sample, n_classes=n_classes,
                sample_many=stacked_sampler(sample))


def markov_transition(vocab: int, temperature: float = 1.0, seed: int = 0,
                      device=None) -> torch.Tensor:
    """The LM task's transition matrix ``(vocab, vocab)``: row ``a`` is
    the distribution of the token after ``a``, a softmax of standard
    normal logits over ``max(temperature, 1e-3)``, drawn on ``device``
    (default: the CUDA card; raises ``RuntimeError`` without one)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed_of(seed, 17))
    logits = torch.randn((vocab, vocab), generator=gen, device=dev)
    return torch.softmax(logits / max(temperature, 1e-3), dim=-1)


def make_lm_task(
    *,
    vocab: int,
    batch: int,
    seq_len: int,
    kind: str = "markov",
    temperature: float = 1.0,
    seed: int = 0,
    extra_fields: Optional[Callable] = None,
    device=None,
) -> Task:
    """Next-token prediction, ``labels[t] = tokens[t+1]`` at every
    position: int64 ``tokens`` and ``labels`` of shape ``(batch,
    seq_len)`` on ``device`` (default: the CUDA card; raises
    ``RuntimeError`` without one).  The walk is sequential in ``t``, a
    few tiny operations a token, so each sample is walked on the host
    and reaches the device in one copy.

    ``kind="markov"`` walks :func:`markov_transition` from a uniform start
    token (``entropy_floor`` is the mean row entropy, about what a model
    that learned the table reaches; an untrained one sits at ln V);
    ``kind="affine"`` iterates ``(3x + 7) mod vocab``.

    ``extra_fields(g)`` (the encoder-decoder's frames, the vision prefix)
    returns more fields of the sample, drawn from the sample's own host
    generator ``g`` after its tokens, so one ``(step, client)`` gives the
    same fields every time; they reach ``device`` with the tokens.
    """
    dev = resolve_device(device)
    floor = 0.0
    if kind == "markov":
        probs = markov_transition(vocab, temperature, seed, dev)
        floor = _entropy_floor(probs)
        walk = _markov_walk(torch.cumsum(probs, dim=-1).cpu(), batch, seq_len)
    elif kind == "affine":
        a, b = 3, 7

        def walk(start: torch.Tensor, g: torch.Generator) -> list:
            toks = [start]
            for _ in range(seq_len):
                toks.append((a * toks[-1] + b) % vocab)
            return toks
    else:
        raise ValueError(f"unknown LM task kind {kind!r}")

    def sample(step: int, client: int) -> dict:
        g = torch.Generator()
        g.manual_seed(_seed_of(seed, 1000 + client, step))
        start = torch.randint(0, vocab, (batch,), generator=g)
        toks = torch.stack(walk(start, g), dim=1).to(dev)  # (B, S+1)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if extra_fields is not None:
            out.update({k: v.to(dev) for k, v in extra_fields(g).items()})
        return out

    return Task(name=f"lm_{kind}", sample=sample, vocab_size=vocab, entropy_floor=floor,
                sample_many=stacked_sampler(sample))


def _entropy_floor(probs: torch.Tensor) -> float:
    """The mean row entropy of transition tables (nats a token)."""
    return float(torch.mean(-torch.sum(probs * torch.log(probs + 1e-12), dim=-1)))


def _markov_walk(cdf: torch.Tensor, batch: int, seq_len: int) -> Callable:
    """``walk(start, g)``: ``seq_len`` steps of the chain whose rows'
    running sums are ``cdf`` (host, ``(V, V)``), by inverse-CDF sampling:
    token t+1 is the first entry of row tokens[t]'s running sum that
    reaches a uniform draw.  Returns the list of ``seq_len + 1`` (batch,)
    token tensors, the start first."""
    vocab = cdf.shape[-1]

    def walk(start: torch.Tensor, g: torch.Generator) -> list:
        u = torch.rand((seq_len, batch, 1), generator=g)
        toks, tok = [start], start
        for t in range(seq_len):
            tok = torch.searchsorted(cdf[tok], u[t]).squeeze(1).clamp_(max=vocab - 1)
            toks.append(tok)
        return toks

    return walk


def non_iid_transition(g: torch.Tensor, priv: torch.Tensor, skew: float,
                       temperature: float = 1.0) -> torch.Tensor:
    """The clients' transition tables ``(C, V, V)``: row softmaxes of
    ``((1 − λ)·g + λ·priv_c) / max(T, 1e-3)`` with ``λ = skew / (1 +
    skew)``, from the shared logits ``g`` (V, V) and the private ones
    ``priv`` (C, V, V)."""
    lam = float(skew) / (1.0 + float(skew))
    logits = ((1.0 - lam) * g[None] + lam * priv) / max(temperature, 1e-3)
    return torch.softmax(logits, dim=-1)


def make_non_iid_lm_task(
    *,
    vocab: int,
    batch: int,
    seq_len: int,
    n_clients: int,
    skew: float = 2.0,
    temperature: float = 1.0,
    seed: int = 0,
    device=None,
) -> Task:
    """Non-IID client shards for federated runs: client ``c`` walks its own
    first-order Markov chain, table ``c % n_clients`` of
    :func:`non_iid_transition`, whose shared and private logits are
    standard normal draws.  ``skew=0`` is the IID split of
    :func:`make_lm_task`'s kind of chain; a larger skew pushes the clients
    toward disjoint transition structure.  ``entropy_floor`` is the tables'
    mean row entropy.  The ``(n_clients, V, V)`` f32 table is drawn on
    ``device`` (default: the CUDA card; raises ``RuntimeError`` without
    one), meant for the small-vocabulary federated presets; each sample
    is walked on the host from a generator seeded by ``(seed, 3000 +
    client, step)`` and reaches the device in one copy."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(_seed_of(seed, 17))
    g = torch.randn((vocab, vocab), generator=gen, device=dev)
    gen.manual_seed(_seed_of(seed, 29))
    priv = torch.randn((n_clients, vocab, vocab), generator=gen, device=dev)
    probs = non_iid_transition(g, priv, skew, temperature)
    floor = _entropy_floor(probs)
    walks = [_markov_walk(cdf, batch, seq_len)
             for cdf in torch.cumsum(probs, dim=-1).cpu()]
    del g, priv, probs

    def sample(step: int, client: int) -> dict:
        g = torch.Generator()
        g.manual_seed(_seed_of(seed, 3000 + client, step))
        start = torch.randint(0, vocab, (batch,), generator=g)
        toks = torch.stack(walks[client % n_clients](start, g), dim=1).to(dev)  # (B, S+1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return Task(name=f"lm_markov_noniid{n_clients}", sample=sample, vocab_size=vocab,
                entropy_floor=floor, sample_many=stacked_sampler(sample))


def _stack(samples: list) -> dict:
    return {k: torch.stack([b[k] for b in samples]) for k in samples[0]}


def split_among_clients(task: Task, n_clients: int) -> Callable[[int], dict]:
    """``batch_fn(round) -> dict`` with a leading client axis: client c
    draws ``task.sample(round, c)``, a disjoint stream (the paper's
    balanced shard split)."""

    def batch_fn(round_idx: int) -> dict:
        return _stack([task.sample(round_idx, c) for c in range(n_clients)])

    return batch_fn


def client_batches(task: Task, n_clients: int, n_delay: int) -> Callable[[int], dict]:
    """``batch_fn(round) -> dict`` of ``(clients, n_delay, batch, ...)``
    tensors on the task's device: client c's local step d of round r
    draws ``task.sample(r * n_delay + d, c)``, the reference's stream
    layout (each client a disjoint stream)."""

    def batch_fn(round_idx: int) -> dict:
        return _stack([_stack([task.sample(round_idx * n_delay + d, c)
                               for d in range(n_delay)]) for c in range(n_clients)])

    return batch_fn
