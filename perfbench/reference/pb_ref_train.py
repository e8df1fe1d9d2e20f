"""Three SBC training rounds of one client, in plain PyTorch and f32, and
the readings that the comparison takes from a run's state.

A round (the paper's Alg. 1 for one client): the loss and its gradient
at W; the configuration's optimizer step W' (SGD: ``W − lr·g``; Adam at
step 0 every round, as the port calls it: ``W − lr·m̂/(√v̂ + ε)``) and
ΔW = W' − W in f32; the accumulator R + ΔW compressed leaf by leaf
(:mod:`pb_ref_sbc`); W += ΔW*; R the accumulator less ΔW*; under Adam,
momentum zeroed where ΔW* is not (momentum masking).

Readings, per leaf:

* ``grad1``: the norm of the first round's gradient as the optimizer got
  it, worked out from the state after that round: under SGD ‖R₁ + W₁ −
  W₀‖ / lr (ΔW of round 1, which R₁ and ΔW*₁ = W₁ − W₀ share out);
  under Adam √(Σ v₁ / (1 − β₂)), v not being masked;
* ``change3``: ‖W₃ − W₀‖ after the three rounds;

and ``losses``, each round's loss.  ``W₀`` is drawn again from the seed
(:mod:`pb_ref_weights`), one leaf at a time.
"""
from __future__ import annotations

import torch

import pb_ref_model
import pb_ref_sbc
import pb_ref_weights

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ROUNDS = 3
CHUNK = 1 << 26


def sq_norm(x: torch.Tensor) -> float:
    """Σ x² in f64, a chunk at a time."""
    flat = x.reshape(-1)
    return float(sum(torch.sum(flat[i:i + CHUNK].double() ** 2)
                     for i in range(0, flat.numel(), CHUNK)))


def grad1_norms(m: dict, specs: list, seed: int, device, *, w1=None, r1=None, v1=None) -> dict:
    """Per leaf, the first gradient's norm from the state after round 1:
    ``w1``, ``r1`` (SGD) or ``v1`` (Adam), each ``{path: tensor}``."""
    out = {}
    for i, spec in enumerate(specs):
        path = spec[0]
        if m["local_opt"] == "adam":
            out[path] = (sq_norm(v1[path]) / (1.0 - ADAM_B2)) ** 0.5
        else:
            w0 = pb_ref_weights.draw_leaf(spec, seed, i, device)
            out[path] = sq_norm(r1[path] + (w1[path] - w0)) ** 0.5 / m["base_lr"]
            del w0
    return out


def change_norms(specs: list, seed: int, device, w3: dict) -> dict:
    """Per leaf, ‖W₃ − W₀‖."""
    out = {}
    for i, spec in enumerate(specs):
        w0 = pb_ref_weights.draw_leaf(spec, seed, i, device)
        out[spec[0]] = sq_norm(w3[spec[0]] - w0) ** 0.5
        del w0
    return out


def _adam_update(W, g, mom, var, lr):
    dev = W.device
    t = torch.ones((), dtype=torch.float32, device=dev)
    bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=dev), t)
    bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=dev), t)
    mom = ADAM_B1 * mom + (1 - ADAM_B1) * g
    var = ADAM_B2 * var + (1 - ADAM_B2) * torch.square(g)
    return W - lr * (mom / bc1) / (torch.sqrt(var / bc2) + ADAM_EPS), mom, var


def run_rounds(m: dict, sparsity: float, seed: int, batches: list, device) -> dict:
    """The reference's three rounds from the seed's weights on
    ``batches`` (one a round, no client axis): ``{losses, grad1,
    change3}``."""
    specs = pb_ref_weights.leaf_specs(m)
    W = pb_ref_weights.draw_weights(m, seed, device)
    paths = list(W)
    R = {p: torch.zeros_like(v) for p, v in W.items()}
    adam = m["local_opt"] == "adam"
    mom = {p: torch.zeros_like(v) for p, v in W.items()} if adam else None
    var = {p: torch.zeros_like(v) for p, v in W.items()} if adam else None
    lr = m["base_lr"]
    losses, grad1 = [], None
    for r in range(ROUNDS):
        leaves = {p: W[p].detach().requires_grad_(True) for p in paths}
        loss = pb_ref_model.loss(leaves, batches[r], m)
        grads = dict(zip(paths, torch.autograd.grad(loss, [leaves[p] for p in paths])))
        losses.append(float(loss.detach()))
        del leaves, loss
        with torch.no_grad():
            for p in paths:
                if adam:
                    w2, mom[p], var[p] = _adam_update(W[p], grads[p], mom[p], var[p], lr)
                else:
                    w2 = W[p] - lr * grads[p]
                grads[p] = None
                delta = w2 - W[p]
                del w2
                out, res = pb_ref_sbc.compress((R[p] + delta).reshape(-1), sparsity)
                out, R[p] = out.reshape(W[p].shape), res.reshape(W[p].shape)
                W[p] = W[p] + out
                if adam:
                    mom[p] = mom[p] * (1.0 - (out != 0).to(torch.float32))
                del out, res, delta
        if r == 0:
            grad1 = grad1_norms(m, specs, seed, device, w1=W, r1=R, v1=var)
    return {"losses": losses, "grad1": grad1, "change3": change_norms(specs, seed, device, W)}
