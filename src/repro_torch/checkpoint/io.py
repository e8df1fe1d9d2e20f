"""Tree checkpoints on npz, in the reference's layout.

Counterpart of ``repro.checkpoint.io``.  Leaves are stored flat under
'/'-joined key paths inside one ``.npz`` of deflate members, with the reference's
key paths (dict keys; ``.name`` for a NamedTuple field, as JAX renders
its attribute keys; the index for a list or tuple entry), bf16 stored as
uint16 bit patterns under the same ``__meta__`` tag.  So the reference's
``load_pytree`` reads the port's parameters and optimizer state, and the
port's :func:`load_pytree` reads the reference's.  Restoring into a
structure (``like=``) checks the key set and every shape.
"""
from __future__ import annotations

import json
import os
import zipfile
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any

_BF16_TAG = "__bf16__"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree):
    """``(key, child)`` pairs of a tree node in JAX's leaf order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten_with_paths(tree: PyTree, prefix: str = "") -> dict:
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16)
        return leaf.numpy()
    return np.asarray(leaf)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez_compressed``'s file (a zip of one deflate member
    ``<key>.npy`` a key; ``.npz`` appended to a path without it) with its
    deflate blocks stored (level 0).  Parameters and optimizer states are
    f32 that deflate's default level shrinks by about 9% at about 16 MB/s
    (lm-100m's GSPMD state, 2.2 GB: 2.01 GB in 140 s on an H100 machine's
    host); level 0 writes at the speed of a copy.  ``np.load``, and so
    both packages' ``load_pytree``, reads either."""
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=0,
                         allowZip64=True) as zf:
        for k, v in arrays.items():
            with zf.open(k + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(v), allow_pickle=False)


def save_pytree(path: str, tree: PyTree) -> None:
    """Write ``tree`` (dicts, NamedTuples, lists and tuples of tensors or
    numbers) to ``path`` as one npz (:func:`_savez`); reading the tensors
    waits for the device."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arrays, meta = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        arrays[k] = _numpy(v)
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            meta[k] = _BF16_TAG
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    _savez(os.fspath(path), arrays)


def _rebuild(like, flat: dict, prefix: str = ""):
    items = _items(like)
    if items is None:
        arr = flat[prefix]
        if not isinstance(like, torch.Tensor):
            return arr
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch at {prefix}: {arr.shape} vs {tuple(like.shape)}")
        if like.dtype == torch.bfloat16:
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(like.dtype)
        return t.to(like.device)
    children = [_rebuild(v, flat, f"{prefix}/{k}" if prefix else k) for k, v in items]
    if isinstance(like, dict):
        return dict(zip([k for k, _ in items], children))
    if _is_namedtuple(like):
        return type(like)(*children)
    return type(like)(children)


def load_pytree(path: str, like: Optional[PyTree] = None) -> PyTree:
    """Load a checkpoint.  With ``like``, the same structure as ``like``
    with its values replaced (tensors on ``like``'s devices, in its
    dtypes); without, a flat ``{path: numpy array}`` (a bf16 leaf as a
    torch tensor: numpy has no bf16)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        flat = {}
        for k in z.files:
            if k == "__meta__":
                continue
            arr = z[k]
            if meta.get(k) == _BF16_TAG and like is None:
                arr = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            flat[k] = arr
    if like is None:
        return flat
    want = _flatten_with_paths(like)
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise ValueError(f"checkpoint/structure mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    return _rebuild(like, flat)


def save_train_state(path: str, state) -> None:
    save_pytree(path, state._asdict() if hasattr(state, "_asdict") else state)


def restore_train_state(path: str, like) -> Any:
    loaded = load_pytree(path, like._asdict() if hasattr(like, "_asdict") else like)
    return type(like)(**loaded) if hasattr(like, "_asdict") else loaded
