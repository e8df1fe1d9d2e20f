"""The GSPMD backend's communication channel, on one card.

Counterpart of ``repro.core.channel`` (DESIGN.md §12).  This slice ports
:class:`ShardedGspmdChannel` on its flat hist route: every round, residual
add + the three SBC passes + the exchange run on ONE flat buffer per
device.  With one client the exchange is the identity; clients across
cards come with ``torch.distributed`` (ROADMAP A9).

Pytrees are dicts of tensors whose leaves are taken in sorted-key order —
JAX's tree-flatten order — so segments, the flat buffer and the residual
follow the reference's layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch


class ChannelBits(NamedTuple):
    """Static analytic wire accounting for one round (Eq. 1 terms)."""

    per_client: float  # upstream bits one client sends per round
    dense: float  # the 32-bit dense equivalent


class GspmdLeaf(NamedTuple):
    """One leaf's static plan in the GSPMD channel."""

    path: str
    global_shape: Tuple[int, ...]
    dtype: Any
    scanned: bool  # leading scan/stack superblock dim
    mode: str  # "sparse" | "dense" | "skip"
    rate: float  # static per-leaf sparsity rate
    n_shards: int  # distinct shards of the global leaf
    shard_grid: Tuple[int, ...]  # per-dim shard counts


def tree_keys(tree: Dict[str, Any]) -> Tuple[str, ...]:
    """Leaf order of a flat dict pytree: sorted keys, as JAX flattens."""
    return tuple(sorted(tree))


@dataclasses.dataclass(eq=False)
class ShardedGspmdChannel:
    """Compression + exchange of the GSPMD backend on the §11 flat path
    with the hist engine and an f32 residual (the only route of this slice).

    ``flat_space`` is the :class:`~repro_torch.core.flat.ShardedFlatParamSpace`
    the channel compresses in.
    """

    leaves: Tuple[GspmdLeaf, ...]
    client_axes: Tuple[str, ...]
    n_clients: int
    flat_space: Any

    # ------------------------------------------------------------- protocol

    def init_state(self, params: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The per-client error-feedback residual: ONE flat f32 buffer of
        shape ``(n_clients, shards_per_client, n_pad)``."""
        device = next(iter(params.values())).device
        return self.flat_space.zeros_residual(device)

    def round_exchange(self, residual: torch.Tensor,
                       deltas: Dict[str, torch.Tensor], *,
                       need_own: bool) -> tuple:
        """One round's compress + exchange.

        ``deltas`` is the per-client ΔW dict (leading client axis) and
        ``residual`` this channel's state from :meth:`init_state`; returns
        ``(mean_tree, new_residual, own_tree_or_None)``.  ``need_own``
        materializes each client's ΔW*_i (momentum masking).
        """
        keys = tree_keys(deltas)
        means, new_residual, owns = self.exchange_flat(
            residual, [deltas[k] for k in keys], need_own
        )
        mean_tree = dict(zip(keys, means))
        own_tree = dict(zip(keys, owns)) if need_own else None
        return mean_tree, new_residual, own_tree

    def exchange_flat(self, res: torch.Tensor, leaves: Sequence[torch.Tensor],
                      need_own: bool) -> tuple:
        """Residual add + compression + exchange on ONE flat buffer, one
        launch per pass.  ``leaves`` carry the leading client axis."""
        space = self.flat_space
        bodies = [leaf[0] for leaf in leaves]
        mean_f, own_f, new_res_f = space.exchange_local_hist(bodies, res[0, 0])
        means = tuple(
            m.to(leaf.dtype)[None]
            for m, leaf in zip(space.unflatten_local(mean_f), leaves)
        )
        if need_own:
            owns = tuple(
                o.to(leaf.dtype)[None]
                for o, leaf in zip(space.unflatten_local(own_f), leaves)
            )
        else:
            owns = tuple(
                torch.zeros((1,) * leaf.dim(), dtype=leaf.dtype, device=leaf.device)
                for leaf in leaves
            )
        return means, new_res_f[None, None], owns

    # ------------------------------------------------------- bit accounting

    def bits(self) -> ChannelBits:
        """Static Eq. 1 bits per round per client, summed from the §11
        per-(segment, shard) table (per sparse leaf
        ``L·S_shards·(k_loc·b̄_pos(p_leaf) + 32)``), beside the 32-bit dense
        equivalent."""
        dense = sum(32.0 * int(np.prod(gl.global_shape) or 1) for gl in self.leaves)
        return ChannelBits(per_client=self.flat_space.bits_per_client(), dense=dense)
