"""Activation-sharding hints of the launch layer.

Counterpart of ``repro.models.hints``.  The reference's launch layer
installs an ambient (mesh, batch axes, sequence axis, expert axis) context
around its jitted step, and the model calls :func:`act`,
:func:`expert_flat` and :func:`expert_grouped` on its activations: each
is a ``jax.lax.with_sharding_constraint`` that tells GSPMD how to lay the
activation out over the mesh.  PyTorch has no GSPMD, and the port holds a
client's whole model on one rank (a shard axis never crosses ranks), so
those three hints are identities here, and the model does not call them.
The layout (a dict of axis sizes, the port's mesh) still decides
:func:`expert_mode`.

One hint is not about layout: :func:`lean_moe` (the launch option
``"lean_moe"``) makes the MoE layer combine in the activations' dtype
and cap its capacity factor at 1.0 (``repro_torch.models.moe``), which
changes the numbers.  Without a context every hint is a no-op and
:func:`lean_moe` is False.
"""
from __future__ import annotations

import contextlib
from typing import Any, Optional

_CTX: dict[str, Any] = {"mesh": None, "batch": None, "seq": None, "expert": None,
                        "seq_every": 1, "lean_moe": False}


def lean_moe() -> bool:
    """True inside a context installed with ``lean_moe=True``: bf16 MoE
    combine and a capacity factor of at most 1.0."""
    return bool(_CTX["lean_moe"])


@contextlib.contextmanager
def activation_sharding(mesh, *, batch_axes=None, seq_axis: Optional[str] = "model",
                        expert_axis: Optional[str] = None, seq_every: int = 1,
                        lean_moe: bool = False):
    """Install the hints for the duration of a step.

    ``mesh`` is a layout, a dict of axis sizes (``{"data": 16, "model":
    16}``).  ``batch_axes``, ``seq_axis``, ``expert_axis`` and
    ``seq_every`` are the reference's (they place activations, which the
    port does not shard); ``lean_moe`` turns on the lean MoE combine."""
    old = dict(_CTX)
    _CTX.update(mesh=mesh, batch=batch_axes, seq=seq_axis, expert=expert_axis,
                seq_every=max(1, seq_every), lean_moe=lean_moe)
    try:
        yield
    finally:
        _CTX.update(old)


def _fits(mesh: dict, axes, dim) -> bool:
    if not axes:
        return False
    total = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        total *= mesh.get(a, 1)
    return dim % total == 0


def act(x):
    """A ``(B, S, d)`` residual-stream activation between blocks: the
    identity."""
    return x


def expert_mode(n_experts: int) -> str:
    """``"ep"`` when the experts divide the expert axis (flat dispatch with
    expert parallelism), ``"group"`` otherwise or without a context."""
    mesh, ax = _CTX["mesh"], _CTX["expert"]
    if mesh is None or ax is None:
        return "group"
    return "ep" if _fits(mesh, ax, n_experts) else "group"


def expert_flat(x):
    """A flat-dispatch ``(E, C, d)`` buffer: the identity."""
    return x


def expert_grouped(x):
    """A grouped-dispatch ``(B, E, C, d)`` buffer: the identity."""
    return x
