"""Per-leaf compression policies (DESIGN.md §3).

Counterpart of ``repro.core.policy``.  A :class:`CompressionPolicy`
gives every leaf of a parameter tree its own codec, sparsity rate or
schedule, and skip/dense fallback, by matching the leaf's path
("decoder/layer0/attn/wq", "embed/bias", …) against ordered regex rules.
``CompressionPolicy.resolve(tree)`` binds the rules to a concrete tree,
giving a :class:`ResolvedPolicy`: the engine that threads error feedback
(Eq. 2) leaf by leaf.

Trees are nested dicts, lists and tuples of tensors, flattened in JAX's
leaf order (:mod:`repro_torch.core.tree`), so plans, SBW1 leaves and
residuals are in the reference's order.

Randomness: :class:`CompressorState` carries a seed and a round counter,
both 0-d int64 tensors on the CPU, instead of a JAX key.  The generator
of leaf ``i`` in round ``step`` is seeded from ``(seed, step, i)``
(:func:`leaf_generator`), so a round is reproducible from the state and
never touches the global generator.  Deterministic codecs get no
generator.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.codec import Codec, make_codec
from repro_torch.core.stages import decompress_leaf
from repro_torch.core.tree import tree_flatten_with_path, tree_map

PyTree = Any

# The DGC recipe's "small leaves ride dense" path pattern (biases, norm
# scales), shared by every launcher and example.
DENSE_SMALL_PATTERN = r"(^|/)(bias|scale|norm[^/]*)(/|$)"

# MoE leaf paths as the reference's models/moe.py lays them out: stacked
# expert weights ("moe/up", "moe/gate", "moe/down", leading E axis) and the
# dense router.
MOE_EXPERT_PATTERN = r"(^|/)moe/(up|gate|down)(/|$)"
MOE_ROUTER_PATTERN = r"(^|/)moe/router(/|$)"


class CompressorState(NamedTuple):
    """Per-client compressor state threaded through training.

    residual: tree like params, the error-feedback accumulator (Eq. 2);
              ``()`` when no leaf's codec uses error feedback.
    rng:      the seed of the stochastic stages' generators (int64[]).
    step:     round counter (int64[]); rates and schedules are evaluated
              on the host per round (``ResolvedPolicy.rates``).
    """

    residual: PyTree
    rng: torch.Tensor
    step: torch.Tensor


def leaf_generator(seed: int, step: int, leaf: int) -> torch.Generator:
    """The CPU generator of leaf ``leaf`` in round ``step`` of a state
    seeded ``seed``: seeded by numpy's ``SeedSequence`` of the three, so
    neighbouring rounds and leaves draw unrelated streams."""
    words = [int(v) % 2 ** 64 for v in (seed, step, leaf)]
    s = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator().manual_seed(s)


def path_str(path: Sequence) -> str:
    """Render a path (keys and indices, or JAX key entries) as the
    "a/b/0/w" strings rules match against."""
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        elif hasattr(k, "name"):
            parts.append(str(k.name))
        else:
            parts.append(str(k))
    return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """First matching rule wins (``re.search`` against the leaf path).

    codec:    named codec / "sel|quant|enc" spec / Codec; None keeps the
              policy default codec ("skip" and "dense32" are the skip and
              dense-fallback shortcuts).
    sparsity: fixed per-leaf rate override (None → schedule / global rate).
    schedule: round → rate callable (e.g. DGC warm-up); overrides the
              global rate but loses to a fixed ``sparsity``.
    rate_scale: multiplier applied to whichever rate wins above (the MoE
              "reduced-k" knob).
    """

    pattern: str
    codec: Union[str, Codec, None] = None
    sparsity: Optional[float] = None
    schedule: Optional[Callable[[int], float]] = None
    rate_scale: float = 1.0


class LeafPlan(NamedTuple):
    """One leaf's bound compression plan."""

    path: str
    codec: Codec
    sparsity: Optional[float]
    schedule: Optional[Callable[[int], float]]
    rate_scale: float = 1.0

    def rate(self, global_rate: float, round_idx: int = 0) -> float:
        if self.sparsity is not None:
            base = float(self.sparsity)
        elif self.schedule is not None:
            base = float(self.schedule(round_idx))
        else:
            base = float(global_rate)
        return min(1.0, base * float(self.rate_scale))


@dataclasses.dataclass(frozen=True)
class CompressionPolicy:
    """Ordered regex rules over a default codec.

    ``fast=True`` asks for the flat-buffer fast path of DESIGN.md §10
    (:class:`~repro_torch.core.flat.FlatParamSpace`), taken wherever the
    reference takes it: every codec has a flat form and every leaf is f32.
    """

    default: Codec
    rules: Tuple[PolicyRule, ...] = ()
    name: str = "policy"
    fast: bool = False

    def plan_for(self, path: str) -> LeafPlan:
        for rule in self.rules:
            if re.search(rule.pattern, path):
                codec = self.default if rule.codec is None else make_codec(rule.codec)
                return LeafPlan(path, codec, rule.sparsity, rule.schedule, rule.rate_scale)
        return LeafPlan(path, self.default, None, None)

    def resolve(self, tree: PyTree) -> "ResolvedPolicy":
        """Bind rules to a concrete tree structure (paths + treedef)."""
        flat, treedef = tree_flatten_with_path(tree)
        plans = tuple(self.plan_for(path_str(path)) for path, _ in flat)
        return ResolvedPolicy(policy=self, treedef=treedef, plans=plans)

    @classmethod
    def single(cls, codec: Union[str, Codec], name: str = "", **kw) -> "CompressionPolicy":
        c = make_codec(codec, **kw)
        return cls(default=c, rules=(), name=name or c.spec)


def moe_rules(
    experts: int,
    top_k: int = 2,
    *,
    pattern: str = MOE_EXPERT_PATTERN,
    encoder: str = "golomb",
    use_residual: bool = True,
) -> Tuple[PolicyRule, ...]:
    """MoE-aware policy rules (prepend to any policy's rule tuple): expert
    stacks select with the per-expert quota of ``expert_topk`` at
    ``rate_scale = top_k / experts``; the router rides dense."""
    scale = min(1.0, float(top_k) / float(max(1, experts)))
    codec = make_codec(f"expert_topk|identity|{encoder}", experts=experts,
                       use_residual=use_residual)
    return (
        PolicyRule(MOE_ROUTER_PATTERN, codec="dense32"),
        PolicyRule(pattern, codec=codec, rate_scale=scale),
    )


def supports(resolved: "ResolvedPolicy") -> bool:
    """True when every leaf's codec has a flat-buffer form."""
    return all(p.codec.flat_kind is not None for p in resolved.plans)


@dataclasses.dataclass(frozen=True)
class ResolvedPolicy:
    """A policy bound to one tree structure: the compression engine.
    Per-leaf rates are Python floats, evaluated on the host."""

    policy: CompressionPolicy
    treedef: Any
    plans: Tuple[LeafPlan, ...]

    @property
    def any_residual(self) -> bool:
        return any(p.codec.use_residual for p in self.plans)

    @property
    def any_stochastic(self) -> bool:
        return any(p.codec.stochastic for p in self.plans)

    @property
    def fast_compatible(self) -> bool:
        """True when every leaf's codec has a flat-buffer form, i.e. a
        ``fast=True`` policy takes the fast path in the reference."""
        return supports(self)

    def flat_space(self, like: PyTree):
        """The :class:`~repro_torch.core.flat.FlatParamSpace` binding this
        policy to ``like``'s leaf layout (cached per layout), or None where
        the reference runs the per-leaf path: a codec with no flat form, or
        a leaf that is not f32 (the flat residual is f32, while the
        per-leaf path keeps it in the leaf's dtype)."""
        from repro_torch.core.flat import FlatParamSpace

        if not supports(self):
            return None
        leaves = self._leaves_of(like)
        if any(x.dtype != torch.float32 for x in leaves):
            return None
        key = tuple((tuple(x.shape), x.dtype) for x in leaves)
        cache = getattr(self, "_flat_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_flat_cache", cache)
        space = cache.get(key)
        if space is None:
            space = FlatParamSpace.for_resolved(self, like)
            cache[key] = space
        return space

    def rates(self, global_rate: float, round_idx: int = 0) -> Tuple[float, ...]:
        """Per-leaf sparsity rates for this round (memoized when no plan
        has a schedule)."""
        scheduled = any(p.schedule is not None for p in self.plans)
        key = (float(global_rate), round_idx if scheduled else 0)
        cache = getattr(self, "_rates_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_rates_cache", cache)
        got = cache.get(key)
        if got is None:
            got = tuple(p.rate(global_rate, round_idx) for p in self.plans)
            cache[key] = got
        return got

    # ----------------------------------------------------------- lifecycle

    def init_state(self, params: PyTree,
                   rng: Union[int, torch.Tensor, None] = None) -> CompressorState:
        """Zero residuals like ``params`` (when a codec uses error
        feedback; in the flat §10 layout when the fast path is taken), the
        seed ``rng`` (default 0) and step 0."""
        residual = ()
        if self.any_residual:
            space = self.flat_space(params) if self.policy.fast else None
            device = self._leaves_of(params)[0].device
            residual = (space.zeros_residual(device) if space is not None
                        else tree_map(torch.zeros_like, params))
        seed = torch.as_tensor(0 if rng is None else rng, dtype=torch.int64)
        return CompressorState(residual=residual, rng=seed,
                               step=torch.zeros((), dtype=torch.int64))

    def _leaves_of(self, tree: PyTree) -> list:
        """Flatten ``tree`` through OUR treedef; raises on a structure
        mismatch instead of pairing leaves wrongly."""
        return self.treedef.flatten_up_to(tree)

    def compress(self, delta: PyTree, state: CompressorState,
                 rates: Union[float, Tuple[float, ...]]) -> tuple:
        """Compress a full update tree with per-leaf error feedback.

        Returns ``(compressed_tree, dense_tree, new_state)``:
        ``compressed_tree`` has a LeafCompressed at every leaf;
        ``dense_tree`` is the locally decompressed ΔW* (what the residual
        subtracts; a receiver rebuilds the same from the wire form).
        Everything stays on the leaves' device.
        """
        leaves = self._leaves_of(delta)
        if not isinstance(rates, tuple):
            rates = (float(rates),) * len(leaves)
        if len(rates) != len(self.plans):
            raise ValueError(f"got {len(rates)} rates for {len(self.plans)} leaves")
        if self.policy.fast:
            space = self.flat_space(delta)
            if space is not None:
                # the flat-buffer fast path (§10): bit-identical output
                return space.compress(delta, state, rates)
        res_leaves = (self._leaves_of(state.residual) if self.any_residual
                      else [None] * len(leaves))
        seed, step = (int(state.rng), int(state.step)) if self.any_stochastic else (0, 0)

        comp_leaves, dense_leaves, new_res = [], [], []
        for i, (plan, leaf, res, p) in enumerate(zip(self.plans, leaves, res_leaves, rates)):
            flat = leaf.reshape(-1).to(torch.float32)
            use_res = plan.codec.use_residual and res is not None
            acc = flat + res.reshape(-1).to(torch.float32) if use_res else flat
            gen = leaf_generator(seed, step, i) if plan.codec.stochastic else None
            comp = plan.codec.compress_leaf(acc, p, gen)
            dense = decompress_leaf(comp, flat.shape[0])
            comp_leaves.append(comp)
            dense_leaves.append(dense.reshape(leaf.shape).to(leaf.dtype))
            if res is not None:
                new_res.append((acc - dense).reshape(leaf.shape).to(res.dtype)
                               if use_res else res)

        residual = self.treedef.unflatten(new_res) if self.any_residual else state.residual
        new_state = CompressorState(residual=residual, rng=state.rng, step=state.step + 1)
        return (self.treedef.unflatten(comp_leaves), self.treedef.unflatten(dense_leaves),
                new_state)

    def decompress(self, compressed: PyTree, like: PyTree) -> PyTree:
        """Reconstruct a dense update tree from the compressed form, through
        the resolved treedef."""
        comp_leaves = self._leaves_of(compressed)
        ref_leaves = self._leaves_of(like)
        out = [decompress_leaf(c, r.numel()).reshape(r.shape).to(r.dtype)
               for c, r in zip(comp_leaves, ref_leaves)]
        return self.treedef.unflatten(out)

    def total_bits(self, compressed: PyTree) -> torch.Tensor:
        """Sum of analytic wire bits across leaves (Eq. 1 inner term)."""
        return sum(c.nbits for c in self._leaves_of(compressed))

    # ------------------------------------------------------------ summaries

    def describe(self) -> str:
        """Human-readable per-leaf codec table (launchers print this)."""
        lines = [f"policy {self.policy.name!r}: {len(self.plans)} leaves"]
        for p in self.plans:
            extra = ""
            if p.sparsity is not None:
                extra = f"  p={p.sparsity}"
            elif p.schedule is not None:
                extra = "  p=schedule"
            if p.rate_scale != 1.0:
                extra += f"  rate×{p.rate_scale:g}"
            lines.append(f"  {p.path:<48s} {p.codec.spec}{extra}")
        return "\n".join(lines)
