"""Carry the JAX package's arrays into the port.

torch cannot reproduce JAX's threefry draws, so anything the reference
draws at random — initial parameters above all — is handed across as
numpy.  Both packages store parameters in the same layouts (conv kernels
HWIO, dense ``(in, out)``), so a leaf crosses as it is.  This module takes
numpy only; it never imports ``jax``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import AdamState


def _tensor(a: Any, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX parameter dict (leaves as numpy arrays) → the port's dict on
    ``device`` (default: the CUDA card; raises ``RuntimeError`` without one)."""
    device = resolve_device(device)
    return {k: _tensor(v, device) for k, v in np_tree.items()}


def state_from_jax(np_state: Dict[str, Any], device=None) -> dict:
    """A GSPMD train state ``{'params', 'opt', 'residual'}`` (leaves as
    numpy arrays) → the port's state on ``device`` (default: the CUDA
    card; raises ``RuntimeError`` without one).

    ``opt`` is Adam's ``(m, v)`` pair (anything with ``.m`` and ``.v``),
    a momentum dict, or ``()`` for SGD; every optimizer leaf keeps its
    leading client axis.  ``residual`` is the flat ``(n_clients, shards,
    n_pad)`` buffer.
    """
    device = resolve_device(device)
    opt = np_state["opt"]
    if hasattr(opt, "m") and hasattr(opt, "v"):
        opt_t = AdamState(params_from_jax(opt.m, device), params_from_jax(opt.v, device))
    elif isinstance(opt, dict):
        opt_t = params_from_jax(opt, device)
    else:
        opt_t = ()
    return {
        "params": params_from_jax(np_state["params"], device),
        "opt": opt_t,
        "residual": _tensor(np_state["residual"], device),
    }
