"""npz checkpoints of nested trees of tensors, keyed by tree paths and
dtype-preserving (counterpart of ``repro.checkpoint.io``, in the same file
format, so a checkpoint written by either package loads into the other).

A tree is nested dicts, lists, tuples and NamedTuples (e.g.
:class:`repro_torch.core.cache.CacheState`) whose leaves are torch
tensors, numpy arrays or Python scalars; ``None`` holds no leaf.  Dicts
are walked in sorted key order, as ``jax.tree_util`` walks them.  Each
leaf's npz key joins one component per path entry with ``/``, each
**type-tagged and percent-escaped**:

- ``d:<key>``  a dict key, with ``%`` -> ``%25`` and ``/`` -> ``%2F``;
- ``i:<idx>``  a list or tuple index;
- ``a:<name>`` a NamedTuple field;
- ``f:<key>``  any other path entry, escaped like dict keys (the
  reference's flattened-index keys; no tree of this package has one).

So the path -> key map is injective: ``{"a/b": x}`` and
``{"a": {"b": y}}``, or the dict key ``"0"`` and the index ``0``, get
different keys.  :func:`load_pytree` falls back to the legacy untagged
key (the components' plain values joined by ``/``) for a leaf whose
tagged key is absent, so checkpoints of the old scheme keep loading.
bfloat16 leaves are stored as their uint16 bits under a ``BF16::``
prefix.

Validation raises typed errors, never ``assert``:
:class:`CheckpointKeyError` for a leaf with no stored array, stored
arrays the template never consumed, or two paths that map to one key on
save; :class:`CheckpointShapeError` and :class:`CheckpointDtypeError`
for a leaf that does not match the template (no silent casts).
"""
from __future__ import annotations

import os
from typing import Any, List, NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["CheckpointError", "CheckpointKeyError", "CheckpointShapeError",
           "CheckpointDtypeError", "save_pytree", "load_pytree"]


class CheckpointError(Exception):
    """Base class for checkpoint load/save validation failures."""


class CheckpointKeyError(CheckpointError):
    """A tree leaf has no stored array, or stored arrays went unused."""


class CheckpointShapeError(CheckpointError):
    """Stored array shape does not match the template leaf."""


class CheckpointDtypeError(CheckpointError):
    """Stored array dtype does not match the template leaf."""


_BF16 = "BF16::"


# path entries, one per level of the tree
class DictKey(NamedTuple):
    key: Any


class SequenceKey(NamedTuple):
    idx: int


class GetAttrKey(NamedTuple):
    name: str


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node) -> List[Tuple[Any, Any]]:
    """(path entry, child) pairs of an inner node; [] for a leaf."""
    if isinstance(node, dict):
        return [(DictKey(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(GetAttrKey(f), getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(SequenceKey(i), v) for i, v in enumerate(node)]
    raise AssertionError("a leaf has no children")


def _flatten(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs of ``tree`` in its walking order."""
    if tree is None:
        return []
    if isinstance(tree, (dict, list, tuple)):
        return [pl for entry, child in _children(tree)
                for pl in _flatten(child, path + (entry,))]
    return [(path, tree)]


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, f), leaves) for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _escape(s: str) -> str:
    return s.replace("%", "%25").replace("/", "%2F")


def _component(p) -> str:
    if isinstance(p, DictKey):
        return "d:" + _escape(str(p.key))
    if isinstance(p, SequenceKey):
        return "i:" + str(p.idx)
    if isinstance(p, GetAttrKey):
        return "a:" + _escape(str(p.name))
    return "f:" + _escape(str(p))


def _key(path) -> str:
    return "/".join(_component(p) for p in path)


def _legacy_component(p) -> str:
    # a NamedTuple field prints as ".name", as the reference's path key does
    return "." + p.name if isinstance(p, GetAttrKey) else str(p[0])


def _legacy_key(path) -> str:
    # the pre-tagging scheme (collision-prone); a load fallback only
    return "/".join(_legacy_component(p) for p in path)


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(array, is_bfloat16); a bfloat16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree``'s leaves to the npz file ``path`` (atomically: a
    temporary file, then a rename)."""
    arrays = {}
    for kp, leaf in _flatten(tree):
        arr, bf16 = _to_numpy(leaf)
        k = (_BF16 + _key(kp)) if bf16 else _key(kp)
        if k in arrays:
            raise CheckpointKeyError(
                f"duplicate npz key {k!r} — two tree paths flattened to the "
                "same key, which would silently drop a leaf")
        arrays[k] = arr
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _lookup(data, kp) -> Tuple[str, np.ndarray, bool]:
    """(npz key, stored array, is_bfloat16) of one leaf path, the tagged
    key first, then the legacy one; the array as stored, so the dtype
    check sees the file's dtype."""
    for key in (_key(kp), _legacy_key(kp)):
        if _BF16 + key in data:
            return _BF16 + key, data[_BF16 + key], True
        if key in data:
            return key, data[key], False
    raise CheckpointKeyError(
        f"no stored array for leaf {_key(kp)!r} "
        f"(legacy key {_legacy_key(kp)!r} also absent) in checkpoint")


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.result_type(leaf))


def load_pytree(path: str, like: Any) -> Any:
    """The tree stored at ``path``, in the structure of ``like``: each
    leaf checked against ``like``'s (shape and dtype), a tensor on the
    device of ``like``'s leaf, or a numpy array where ``like`` has a
    numpy array or a Python scalar."""
    with np.load(path) as data:
        leaves = []
        consumed = set()
        for kp, leaf in _flatten(like):
            key, arr, bf16 = _lookup(data, kp)
            consumed.add(key)
            stored = "bfloat16" if bf16 else str(arr.dtype)
            leaf_shape = tuple(leaf.shape if isinstance(leaf, torch.Tensor)
                               else np.shape(leaf))
            if arr.shape != leaf_shape:
                raise CheckpointShapeError(
                    f"leaf {_key(kp)!r}: stored shape {tuple(arr.shape)} != "
                    f"template shape {leaf_shape}")
            if stored != _dtype_name(leaf):
                raise CheckpointDtypeError(
                    f"leaf {_key(kp)!r}: stored dtype {stored} != "
                    f"template dtype {_dtype_name(leaf)} (refusing to cast)")
            if isinstance(leaf, torch.Tensor):
                t = torch.from_numpy(arr.copy())
                if bf16:
                    t = t.view(torch.int16).view(torch.bfloat16)
                leaves.append(t.to(leaf.device))
            else:
                leaves.append(arr)
        extra = sorted(set(data.files) - consumed)
        if extra:
            raise CheckpointKeyError(
                f"checkpoint holds {len(extra)} array(s) the template tree "
                f"never consumed: {extra[:5]}{'...' if len(extra) > 5 else ''}")
    return _rebuild(like, iter(leaves))
