"""Client-side optimizers of paper Alg. 1 (``SGD_n(W_i, D_i)``).

Counterpart of ``repro.optim.optimizers``.  Pytrees are dicts of tensors;
every function is pure (returns new dicts, never updates in place), as in
the reference, so a test can hand both packages the same state.

Momentum masking (paper supplement A / DGC): after a round the trainer
calls :meth:`Optimizer.mask` with a 0/1 dict marking the coordinates just
transmitted; momentum there is zeroed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

Tree = dict


def _map(fn, *trees: Tree) -> Tree:
    return {k: fn(*(t[k] for t in trees)) for k in trees[0]}


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Tree], Any]
    # (state, grads, params, lr, step) -> (new_params, new_state)
    apply: Callable[..., tuple]
    # (state, transmitted_mask) -> state with momentum zeroed where mask==1
    mask: Callable[[Any, Tree], Any]


def _keep_where_untransmitted(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return m * (1.0 - t.to(torch.float32)).to(m.dtype)


def sgd() -> Optimizer:
    def init(params):
        return ()

    def apply(state, grads, params, lr, step):
        return _map(lambda p, g: p - lr * g.to(p.dtype), params, grads), state

    return Optimizer("sgd", init, apply, lambda s, m: s)


def momentum(beta: float = 0.9, state_dtype=torch.float32) -> Optimizer:
    def init(params):
        return _map(lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device),
                    params)

    def apply(state, grads, params, lr, step):
        new_m = _map(
            lambda m, g: (beta * m.to(torch.float32) + g.to(torch.float32)).to(state_dtype),
            state, grads,
        )
        new_p = _map(lambda p, m: p - (lr * m.to(torch.float32)).to(p.dtype),
                     params, new_m)
        return new_p, new_m

    def mask(state, transmitted):
        return _map(_keep_where_untransmitted, state, transmitted)

    return Optimizer("momentum", init, apply, mask)


class AdamState(NamedTuple):
    m: Tree
    v: Tree


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         state_dtype=torch.float32) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=state_dtype, device=p.device)
        return AdamState(_map(z, params), _map(z, params))

    def apply(state, grads, params, lr, step):
        dev = next(iter(params.values())).device
        # bias corrections in f32, as the reference computes b**t on arrays
        t = torch.as_tensor(step, dtype=torch.float32, device=dev) + 1.0
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), t)
        new_m = _map(
            lambda m, g: (b1 * m.to(torch.float32)
                          + (1 - b1) * g.to(torch.float32)).to(state_dtype),
            state.m, grads,
        )
        new_v = _map(
            lambda v, g: (b2 * v.to(torch.float32)
                          + (1 - b2) * torch.square(g.to(torch.float32))).to(state_dtype),
            state.v, grads,
        )

        def upd(p, m, v):
            mh = m.to(torch.float32) / bc1
            vh = v.to(torch.float32) / bc2
            return p - (lr * mh / (torch.sqrt(vh) + eps)).to(p.dtype)

        return _map(upd, params, new_m, new_v), AdamState(new_m, new_v)

    def mask(state, transmitted):
        return AdamState(_map(_keep_where_untransmitted, state.m, transmitted), state.v)

    return Optimizer("adam", init, apply, mask)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](**kw)
