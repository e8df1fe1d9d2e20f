"""Nested parameter trees: flatten and unflatten in JAX's leaf order.

The port's pytrees are nested dicts, lists and tuples of tensors.  Leaves
are taken in the order ``jax.tree_util`` flattens them — dict keys
sorted, lists and tuples in order — so a policy's plans, an SBW1 blob's
leaves and the residual follow the reference's layout.  A path is the
tuple of keys and indices down to a leaf (``policy.path_str`` renders it
as ``"a/b/0/w"``).  Anything that is not a dict, list or plain tuple is
a leaf; a ``NamedTuple`` such as ``LeafCompressed`` is one leaf here
(JAX would open it, but the policy engine only ever flattens down to the
structure of the parameter tree, as ``flatten_up_to`` does).
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

Path = Tuple[Any, ...]


class TreeDef:
    """The structure of a tree: ``kind`` is ``"leaf"``, ``"dict"``,
    ``"list"`` or ``"tuple"``; ``keys`` the sorted dict keys; ``children``
    the sub-structures, in leaf order."""

    __slots__ = ("kind", "keys", "children", "num_leaves")

    def __init__(self, kind: str, keys: Tuple = (), children: Tuple["TreeDef", ...] = ()):
        self.kind = kind
        self.keys = keys
        self.children = children
        self.num_leaves = 1 if kind == "leaf" else sum(c.num_leaves for c in children)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TreeDef) and self.kind == other.kind
                and self.keys == other.keys and self.children == other.children)

    def __hash__(self) -> int:  # a ResolvedPolicy (frozen dataclass) hashes it
        return hash((self.kind, self.keys, self.children))

    def flatten_up_to(self, tree) -> list:
        """The values of ``tree`` at this structure's leaves, in leaf order.
        Raises ``ValueError`` when ``tree`` does not have this structure
        (above the leaves), instead of pairing leaves wrongly."""
        out: list = []
        self._flatten_up_to(tree, out, ())
        return out

    def _flatten_up_to(self, tree, out: list, path: Path) -> None:
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or tuple(sorted(tree)) != self.keys:
                raise ValueError(f"tree structure mismatch at {'/'.join(map(str, path))!r}: "
                                 f"expected a dict with keys {list(self.keys)}, got "
                                 f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
            for k, c in zip(self.keys, self.children):
                c._flatten_up_to(tree[k], out, path + (k,))
            return
        want = list if self.kind == "list" else tuple
        if type(tree) is not want or len(tree) != len(self.children):
            raise ValueError(f"tree structure mismatch at {'/'.join(map(str, path))!r}: "
                             f"expected a {self.kind} of {len(self.children)}, got "
                             f"{type(tree).__name__}")
        for i, (x, c) in enumerate(zip(tree, self.children)):
            c._flatten_up_to(x, out, path + (i,))

    def unflatten(self, leaves: Sequence) -> Any:
        """A tree of this structure with ``leaves`` in leaf order."""
        leaves = list(leaves)
        if len(leaves) != self.num_leaves:
            raise ValueError(f"got {len(leaves)} leaves for a structure of "
                             f"{self.num_leaves}")
        it = iter(leaves)
        return self._build(it)

    def _build(self, it):
        if self.kind == "leaf":
            return next(it)
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.keys, kids))
        return kids if self.kind == "list" else tuple(kids)


def _structure(tree) -> TreeDef:
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_structure(tree[k]) for k in keys))
    if isinstance(tree, list) or type(tree) is tuple:
        return TreeDef("list" if isinstance(tree, list) else "tuple", (),
                       tuple(_structure(x) for x in tree))
    return TreeDef("leaf")


def _paths(tree, prefix: Path, out: List[Tuple[Path, Any]]) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _paths(tree[k], prefix + (k,), out)
    elif isinstance(tree, list) or type(tree) is tuple:
        for i, x in enumerate(tree):
            _paths(x, prefix + (i,), out)
    else:
        out.append((prefix, tree))


def tree_flatten_with_path(tree) -> Tuple[List[Tuple[Path, Any]], TreeDef]:
    """``([(path, leaf), ...], treedef)`` in JAX's leaf order."""
    out: List[Tuple[Path, Any]] = []
    _paths(tree, (), out)
    return out, _structure(tree)


def tree_flatten(tree) -> Tuple[list, TreeDef]:
    """``(leaves, treedef)`` in JAX's leaf order."""
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    leaves, treedef = tree_flatten(tree)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten([fn(*xs) for xs in zip(leaves, *others)])
