"""Carry the JAX package's arrays into the port.

torch cannot reproduce JAX's threefry draws, so anything the reference
draws at random — initial parameters above all — is handed across as
numpy.  Both packages store parameters in the same layouts (conv kernels
HWIO, dense ``(in, out)``) and the same nested trees (CharLSTM's
``{"cell0": {"b", "wh", "wx"}, …}``), so a tree crosses as it is, leaf by
leaf, bf16 leaves bit for bit.  This module takes numpy only; it never
imports ``jax``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import AdamState


def _tensor(a: Any, device) -> torch.Tensor:
    """One leaf as a tensor on ``device``.  numpy has no bf16 of its own
    (JAX's is ``ml_dtypes.bfloat16``, which torch cannot read), so a bf16
    leaf crosses as its bit pattern, as ``checkpoint/io.py`` stores it."""
    arr = np.array(a, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(np_tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """A JAX parameter tree (nested dicts, leaves as numpy arrays) → the
    port's tree of tensors, the same structure, on ``device`` (default:
    the CUDA card; raises ``RuntimeError`` without one)."""
    device = resolve_device(device)
    return tree_map(lambda v: _tensor(v, device), np_tree)


def state_from_jax(np_state: Dict[str, Any], device=None, client=None) -> dict:
    """A GSPMD train state ``{'params', 'opt', 'residual'}`` (leaves as
    numpy arrays) → the port's state on ``device`` (default: the CUDA
    card; raises ``RuntimeError`` without one).

    ``opt`` is Adam's ``(m, v)`` pair (anything with ``.m`` and ``.v``),
    a momentum tree, or ``()`` for SGD; every optimizer leaf keeps its
    leading client axis.  ``residual`` is the flat ``(n_clients, shards,
    n_pad)`` buffer, or the per-leaf exchange's tree of ``(n_clients,) +
    shape`` leaves.  With ``client=r`` the optimizer state and the residual
    keep only client r's row (a leading axis of 1): the state of rank r of
    a :class:`~repro_torch.launch.mesh.ClientGroup`, which holds its own
    client's row of the reference's state.
    """
    device = resolve_device(device)
    row = (lambda v: v) if client is None else (lambda v: np.asarray(v)[client:client + 1])
    opt = np_state["opt"]
    if hasattr(opt, "m") and hasattr(opt, "v"):
        opt_t = AdamState(params_from_jax(tree_map(row, opt.m), device),
                          params_from_jax(tree_map(row, opt.v), device))
    elif isinstance(opt, dict):
        opt_t = params_from_jax(tree_map(row, opt), device)
    else:
        opt_t = ()
    residual = np_state["residual"]
    return {
        "params": params_from_jax(np_state["params"], device),
        "opt": opt_t,
        "residual": (params_from_jax(tree_map(row, residual), device)
                     if isinstance(residual, dict) else _tensor(row(residual), device)),
    }
